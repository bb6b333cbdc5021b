"""Small host-side utilities (port copy of conditioned_nerf_gan_tpu/utils/image.py)."""

from .image import save_image_grid, to_uint8

__all__ = ["save_image_grid", "to_uint8"]
