"""Dense density-grid extraction from the conditioned SIREN (port of
conditioned_nerf_gan_tpu/infer/extract_shapes.py).

An N³ grid of sigma values over a `cube_length` cube centered at the
origin, evaluated in fixed-size chunks, the last one zero-padded. The grid
axis order is the reference's create_samples (the sample index decomposes
as x-major / z-minor), so exported .mrc volumes orient identically.
"""

from __future__ import annotations

import numpy as np
import torch


def create_samples(n: int = 256, voxel_origin=(0, 0, 0), cube_length: float = 2.0):
    """(1, N³, 3) float32 sample coordinates, the origin and the voxel size."""
    origin = np.asarray(voxel_origin, np.float64) - cube_length / 2
    voxel_size = cube_length / (n - 1)
    idx = np.arange(n ** 3, dtype=np.int64)
    samples = np.empty((n ** 3, 3), np.float32)
    samples[:, 2] = idx % n
    samples[:, 1] = (idx // n) % n
    samples[:, 0] = (idx // (n * n)) % n
    samples[:, 0] = samples[:, 0] * voxel_size + origin[2]
    samples[:, 1] = samples[:, 1] * voxel_size + origin[1]
    samples[:, 2] = samples[:, 2] * voxel_size + origin[0]
    return samples[None], origin, voxel_size


@torch.no_grad()
def sample_sigma_grid(eval_points, z, voxel_resolution: int = 256, voxel_origin=(0, 0, 0),
                      cube_length: float = 1.2, max_points: int = 64 ** 3,
                      device: str | torch.device = "cpu") -> np.ndarray:
    """(N, N, N) numpy sigma grid: `eval_points(points (1, n, 3), z) ->
    (1, n, 4)` at `max_points` points a call (fewer when the grid is
    smaller), on `device`."""
    samples, _, _ = create_samples(voxel_resolution, voxel_origin, cube_length)
    total = samples.shape[1]
    chunk = min(max_points, total)
    n_chunks = -(-total // chunk)
    padded = torch.zeros((1, n_chunks * chunk, 3), dtype=torch.float32, device=device)
    padded[:, :total] = torch.from_numpy(samples).to(device)
    sigmas = torch.empty(n_chunks * chunk, dtype=torch.float32, device=device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        sigmas[sl] = eval_points(padded[:, sl].contiguous(), z)[0, :, -1]
    return sigmas[:total].cpu().numpy().reshape(
        voxel_resolution, voxel_resolution, voxel_resolution)
