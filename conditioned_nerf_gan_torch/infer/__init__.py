"""Inference runtime of the port (image grids, orbit videos, colored point
clouds, density voxels, metrics, latent interpolation; the CLI is `python -m
conditioned_nerf_gan_torch.infer`)."""

from .inference import Inferencer, build_models, load_metadata, save_checkpoint, voxel_to_ndhwc

__all__ = ["Inferencer", "build_models", "load_metadata", "save_checkpoint",
           "voxel_to_ndhwc"]
