"""Rendering ops (port of conditioned_nerf_gan_tpu/ops): plain torch, the
trilinear feature-volume sampler, and `ops/kernels/` for the hand-written
CUDA kernels' wrappers."""

from .grid_sample import border_trilerp_reference, trilinear_point_features
from .integration import volume_integrate
from .rays import (
    create_cam2world_matrix,
    distance2depth,
    get_initial_rays,
    normalize_vecs,
    perturb_points,
    pixel_rays,
    sample_camera_positions,
    transform_rays,
)
from .sampling import merge_sorted_samples, sample_pdf

__all__ = [
    "border_trilerp_reference",
    "create_cam2world_matrix",
    "distance2depth",
    "get_initial_rays",
    "merge_sorted_samples",
    "normalize_vecs",
    "perturb_points",
    "pixel_rays",
    "sample_camera_positions",
    "sample_pdf",
    "transform_rays",
    "trilinear_point_features",
    "volume_integrate",
]
