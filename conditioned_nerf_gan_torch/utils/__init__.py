"""Small host-side utilities: image grids (port copy of
conditioned_nerf_gan_tpu/utils/image.py), and the PNG codec and cv2 resize
rules the port uses in cv2's place (`png.py`, `resize.py`)."""

from .image import save_image_grid, to_uint8
from .png import read_png, write_png
from .resize import resize

__all__ = ["read_png", "resize", "save_image_grid", "to_uint8", "write_png"]
