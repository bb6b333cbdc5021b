"""Multi-process data parallelism and the ray-sharded render (port of
conditioned_nerf_gan_tpu/parallel/)."""

from .distributed import (
    DistributedContext,
    distributed_requested,
    initialize_distributed,
    shutdown_distributed,
    sync_processes,
)
from .mesh import average_gradients, replicate
from .render import render_ray_sharded

__all__ = [
    "DistributedContext",
    "average_gradients",
    "distributed_requested",
    "initialize_distributed",
    "render_ray_sharded",
    "replicate",
    "shutdown_distributed",
    "sync_processes",
]
