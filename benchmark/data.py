"""Seeded synthetic conditioning, made on the device in a few large calls:
colored box clouds (the program's `bench_setup.make_pcl` rule, batched) and
their voxel grids (its `voxelize` rule: clip into the 1.2 cube, floor to a
cell, occupancy and mean color), and training images and cameras."""

from __future__ import annotations

import torch

from .reference.plain import create_cam2world_matrix, sample_camera_positions


def box_clouds(gen: torch.Generator, n: int, points: int, device, boxes: int = 3):
    """(n, points, 6) [xyz, rgb]: points on the faces of `boxes` colored
    boxes inside the +-0.35 cube."""
    per = -(-points // boxes)
    kw = dict(generator=gen, device=device)
    center = torch.rand((n, boxes, 1, 3), **kw) * 0.4 - 0.2
    half = torch.rand((n, boxes, 1, 3), **kw) * 0.12 + 0.06
    color = torch.rand((n, boxes, 1, 3), **kw) * 0.9 + 0.1
    u = torch.rand((n, boxes, per, 3), **kw) * 2.0 - 1.0
    face = torch.randint(0, 6, (n, boxes, per, 1), **kw)
    axis = torch.arange(3, device=device) == (face // 2)
    u = torch.where(axis, torch.where(face % 2 == 0, 1.0, -1.0), u)
    xyz = center + u * half
    rgb = color.expand(n, boxes, per, 3)
    return torch.cat([xyz, rgb], -1).reshape(n, boxes * per, 6)[:, :points].contiguous()


def voxelize(clouds: torch.Tensor, resolution: int, length: float = 1.2) -> torch.Tensor:
    """(n, P, 6) clouds -> (n, R, R, R, 4) [occupancy, r, g, b] grids in the
    encoder's NDHWC layout (z, y, x), fp32."""
    n, P, _ = clouds.shape
    R = resolution
    pts = clouds[..., :3].clamp(-length / 2 + 1e-4, length / 2 - 1e-4)
    idx = torch.floor((pts + length / 2) / (length / R)).long().clamp(0, R - 1)
    flat = ((idx[..., 2] * R + idx[..., 1]) * R + idx[..., 0])  # z-major: (z, y, x)
    flat = flat + torch.arange(n, device=clouds.device)[:, None] * R ** 3
    flat = flat.reshape(-1)
    sums = torch.zeros(n * R ** 3, 4, device=clouds.device)
    ones = torch.ones(n * P, 1, device=clouds.device)
    sums.index_add_(0, flat, torch.cat([ones, clouds[..., 3:].reshape(-1, 3).clamp(0, 1)], 1))
    count = sums[:, :1]
    occupied = count > 0
    grid = torch.where(occupied, torch.cat([torch.ones_like(count),
                                            sums[:, 1:] / count.clamp_min(1)], 1), 0.0)
    return grid.reshape(n, R, R, R, 4)


def images(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) 'real' images in [-1, 1]: a color of each image's
    own, U(-1, 1) a channel, with U(-0.25, 0.25) noise a pixel. Images of
    different objects differ as a whole, so a step's means depend on which
    images it takes (white noise on every image would not: a step on half
    the batch would read the same losses)."""
    color = torch.rand((n, 1, 1, 3), generator=gen, device=device) * 2.0 - 1.0
    noise = torch.rand((n, size, size, 3), generator=gen, device=device) * 2.0 - 1.0
    return (color + 0.25 * noise).clamp(-1.0, 1.0)


def cameras(gen: torch.Generator, n: int, cam_r_start: float, cam_r_end: float, device):
    """(n, 4, 4) look-at cameras on the shell, as the program's sampler draws them."""
    origins = sample_camera_positions(n, gen, cam_r_start, cam_r_end, device)
    return create_cam2world_matrix(origins)
