"""Camera / ray generation (port of conditioned_nerf_gan_tpu/ops/rays.py).

Layouts follow the JAX package: rays (B, R, S, C) with R = W*H in
row-major pixel order, cameras (B, 4, 4). Randomness comes from an explicit
`torch.Generator` or from injected `uniforms=` (the tests feed both packages
the same numbers).
"""

from __future__ import annotations

import math

import torch

from ..utils import tracing


def normalize_vecs(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unit-normalize along `dim`."""
    return v / torch.linalg.vector_norm(v, dim=dim, keepdim=True)


def pixel_rays(fov, width: int, height: int, dtype=torch.float32,
               row_offset: int | None = None, full_height: int | None = None,
               device=None) -> torch.Tensor:
    """Per-pixel unit ray directions in camera space, (W*H, 3).

    Pixel (row j, col i) is flat index j*W + i with x = linspace(-1,1,W)[i],
    y = linspace(-1,1,H)[j], z = 1/tan(fov/2), fov in degrees.
    `row_offset`/`full_height` give rows [row_offset, row_offset+height) of a
    full_height-tall grid: those rows of its linspace, so a slab's rays are
    bit-equal to the whole image's (`parallel.render_ray_sharded`). A (B,)
    tensor `fov` gives per-image focal lengths and returns (B, W*H, 3).
    """
    x = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device)
    if row_offset is not None:
        fh = full_height if full_height is not None else height
        y = torch.linspace(-1.0, 1.0, fh, dtype=dtype,
                           device=device)[row_offset:row_offset + height]
    else:
        y = torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device)
    xx = x[None, :].expand(height, width).reshape(-1)
    yy = y[:, None].expand(height, width).reshape(-1)
    # a number's copy to the device waits for the stream (a render's host
    # wait; the `infer.h2d` span under a profiler)
    with tracing.h2d_span(fov):
        fov_t = torch.as_tensor(fov, dtype=dtype, device=device)
    inv_tan = 1.0 / torch.tan(fov_t * (math.pi / 360.0))
    if fov_t.ndim == 0:
        z = inv_tan.expand(xx.shape)
        return normalize_vecs(torch.stack([xx, yy, z], dim=-1))
    B, n = fov_t.shape[0], xx.shape[0]
    zb = inv_tan[:, None].expand(B, n)
    return normalize_vecs(torch.stack(
        [xx[None].expand(B, n), yy[None].expand(B, n), zb], dim=-1))


def get_initial_rays(batch_size: int, num_steps: int, fov,
                     resolution: tuple[int, int], ray_start: float,
                     ray_end: float, dtype=torch.float32,
                     row_offset: int | None = None,
                     full_height: int | None = None, device=None):
    """Stratified sample points along each pixel ray, in camera space.

    Returns points (B, W*H, S, 3), z_vals (B, W*H, S, 1) and unit ray
    directions rays_d_cam (B, W*H, 3).
    """
    width, height = resolution
    rays_d = pixel_rays(fov, width, height, dtype, row_offset=row_offset,
                        full_height=full_height, device=device)
    z = torch.linspace(ray_start, ray_end, num_steps, dtype=dtype, device=device)
    z_vals = z[None, :, None].expand(width * height, num_steps, 1)
    if rays_d.ndim == 3:  # batched per-image fov
        points = rays_d[:, :, None, :] * z_vals[None]
    else:
        points = rays_d[:, None, :] * z_vals
        points = points[None].expand(batch_size, *points.shape)
        rays_d = rays_d[None].expand(batch_size, *rays_d.shape)
    z_vals = z_vals[None].expand(batch_size, *z_vals.shape)
    return points, z_vals, rays_d


def perturb_points(points: torch.Tensor, z_vals: torch.Tensor,
                   rays_d: torch.Tensor, *,
                   generator: torch.Generator | None = None,
                   uniforms: torch.Tensor | None = None):
    """Jitter each sample within its stratum: offset = (U - 0.5) * (z1 - z0)."""
    if uniforms is None:
        if generator is None:
            raise ValueError("perturb_points needs a generator or explicit uniforms")
        uniforms = torch.rand(z_vals.shape, generator=generator,
                              dtype=z_vals.dtype, device=z_vals.device)
    spacing = z_vals[:, :, 1:2, :] - z_vals[:, :, 0:1, :]
    offset = (uniforms - 0.5) * spacing
    return points + offset * rays_d[:, :, None, :], z_vals + offset


def transform_rays(points: torch.Tensor, z_vals: torch.Tensor,
                   rays_d: torch.Tensor, cam2world: torch.Tensor):
    """Camera-space samples/directions to world space.

    Returns (world_points (B,R,S,3), z_vals, world_dirs (B,R,3),
    origins (B,R,3)). The 3x3 rotation is applied as elementwise
    multiply-adds, so it stays full fp32 whatever the TF32 settings.
    """
    rot = cam2world[:, :3, :3]
    t = cam2world[:, :3, 3]

    def rotate(v, lead):  # v (B, *lead, 3) -> rot @ v
        r = rot.reshape(rot.shape[0], *([1] * lead), 3, 3)
        return (r[..., 0] * v[..., 0:1] + r[..., 1] * v[..., 1:2]
                + r[..., 2] * v[..., 2:3])

    world_points = rotate(points, 2) + t[:, None, None, :]
    world_dirs = rotate(rays_d, 1)
    origins = t[:, None, :].expand(world_dirs.shape)
    return world_points, z_vals, world_dirs, origins


def sample_camera_positions(n: int, *, generator: torch.Generator | None = None,
                            up_direction: str = "y", cam_r_start: float = 0.0,
                            cam_r_end: float = 1.0,
                            uniforms: torch.Tensor | None = None,
                            dtype=torch.float32, device=None) -> torch.Tensor:
    """n camera origins uniform over a half-sphere shell, (n, 3).

    theta = arccos(1 - u), phi ~ U(0, 2pi), r ~ U(r_start, r_end); pass
    `uniforms` (n, 3) to fix the draw.
    """
    if up_direction not in ("y", "z"):
        raise ValueError("up_direction must be 'y' or 'z'")
    if uniforms is None:
        uniforms = torch.rand((n, 3), generator=generator, dtype=dtype, device=device)
    theta = torch.arccos(1.0 - uniforms[:, 0]).clamp(1e-5, math.pi - 1e-5)
    phi = uniforms[:, 1] * 2.0 * math.pi
    r = uniforms[:, 2] * (cam_r_end - cam_r_start) + cam_r_start
    x = r * torch.sin(theta) * torch.cos(phi)
    lateral = r * torch.sin(theta) * torch.sin(phi)
    vertical = r * torch.cos(theta)
    if up_direction == "z":
        return torch.stack([x, lateral, vertical], dim=-1)
    return torch.stack([x, vertical, lateral], dim=-1)


def create_cam2world_matrix(origin: torch.Tensor,
                            up_direction: str = "y") -> torch.Tensor:
    """Look-at-the-origin cam2world matrices, (B, 4, 4).

    R columns = (-left, -true_up, forward) with forward = normalize(-origin),
    left = normalize(up x forward), true_up = normalize(forward x left).
    """
    if up_direction not in ("y", "z"):
        raise ValueError("up_direction must be 'y' or 'z'")
    forward = normalize_vecs(-origin)
    up = torch.zeros_like(forward)
    up[:, 1 if up_direction == "y" else 2] = 1.0
    left = normalize_vecs(torch.linalg.cross(up, forward, dim=-1))
    true_up = normalize_vecs(torch.linalg.cross(forward, left, dim=-1))
    mat = torch.eye(4, dtype=origin.dtype, device=origin.device).repeat(
        origin.shape[0], 1, 1)
    mat[:, :3, :3] = torch.stack([-left, -true_up, forward], dim=-1)
    mat[:, :3, 3] = origin
    return mat


def distance2depth(distance: torch.Tensor, rays_d_cam: torch.Tensor) -> torch.Tensor:
    """Ray distance to camera-z depth: depth = d * dir_z (camera space)."""
    return rays_d_cam[..., -1:] * distance
