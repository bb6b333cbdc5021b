"""Host-side data pipeline (port copy of conditioned_nerf_gan_tpu/data): the
ShapeNet reader and loaders, the EXR depth decoder, the native fastload
bindings and the synthetic fixture writer (its views rendered with the
port's own ops)."""

from .exr import read_exr_depth
from .shapenet import DataLoader, ShapeNetDataset, get_dataloader, sample_cond
from .synthetic import make_synthetic_shapenet

__all__ = [
    "ShapeNetDataset",
    "DataLoader",
    "get_dataloader",
    "sample_cond",
    "read_exr_depth",
    "make_synthetic_shapenet",
]
