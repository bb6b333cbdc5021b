"""Host-side data pipeline (port copy of conditioned_nerf_gan_tpu/data): the
ShapeNet reader and loaders, the EXR depth decoder and the native fastload
bindings. The synthetic fixtures stay in the JAX package (they use jax)."""

from .exr import read_exr_depth
from .shapenet import DataLoader, ShapeNetDataset, get_dataloader, sample_cond

__all__ = [
    "ShapeNetDataset",
    "DataLoader",
    "get_dataloader",
    "sample_cond",
    "read_exr_depth",
]
