"""Image grid writing (torchvision.utils.save_image equivalent).

The reference dumps sample grids with torchvision (reference utils.py:910-915);
here grids are assembled in numpy and written as 8-bit RGB PNGs by the
port's own encoder (`utils/png.py`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .png import write_png


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float HWC → uint8."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def save_image_grid(
    images: list[np.ndarray] | np.ndarray,
    path: str | Path,
    nrow: int = 8,
    padding: int = 2,
) -> None:
    """Tile (N, H, W, 3) float[0,1] images into a grid png, nrow per row."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.ones(
        (nrows * h + (nrows + 1) * padding, ncol * w + (ncol + 1) * padding, c),
        dtype=np.float32,
    )
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = images[idx]
    write_png(path, to_uint8(grid))
