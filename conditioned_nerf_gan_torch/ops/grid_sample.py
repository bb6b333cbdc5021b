"""Trilinear feature-volume sampling (port of
conditioned_nerf_gan_tpu/ops/grid_sample.py).

The parity target is `F.grid_sample(volume_ncdhw, grid, mode="bilinear",
align_corners=False, padding_mode="border")`; volumes are channel-last
(B, D, H, W, C) as in the JAX package, and coordinates follow the grid
convention: coords[..., 0] = x -> W, 1 = y -> H, 2 = z -> D.

  * `border_trilerp_reference`: the JAX border-mode math in plain torch
    (`_unnormalize`, `_anchor_fractions` with the anchor clamped to
    size - 2, the 8 corners combined in `_lerp_blocks`' order). What the
    wrapper takes for CPU tensors, and the comparator for the kernel.
  * `trilinear_point_features`: the wrapper. On CUDA tensors it launches
    `csrc/trilinear_fwd.cu` (sm_90a) or raises; it never falls back.
    `trilinear_point_features.launches` counts kernel launches.

The JAX package's two gather strategies (the (z, y)-expanded slab and the
(2, 2, 2, C) block gather) and its one-hot-matmul VJP work around the TPU's
gather segments and its lack of atomic scatter; neither is ported. The
zeros-padding and align_corners=True variant (`EmbeddingPiGAN`, ROADMAP
A13) and the backward (voxel training, ROADMAP A12) are not ported yet.
"""

from __future__ import annotations

import torch

from .kernels.trilinear import trilinear_fwd


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    return ((coord + 1.0) * size - 1.0) / 2.0  # align_corners=False


def _anchor_fractions(f: torch.Tensor, size: int):
    """Border clamp, block anchor <= size - 2 and its fraction in [0, 1]: at
    the high border the anchor shifts down one cell and t = 1 selects the
    border voxel, as grid_sample's clipped x1 with t = 0 does."""
    f = f.clamp(0.0, size - 1)
    i = torch.floor(f).long().clamp(max=size - 2)
    return i, f - i


def _lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return a * (1 - t) + b * t


def border_trilerp_reference(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain torch border-mode trilerp: volume (B, D, H, W, C), coords
    (B, N, 3) normalized -> (B, N, C), the JAX `_border_trilerp` forward."""
    B, D, H, W, C = volume.shape
    ix, tx = _anchor_fractions(_unnormalize(coords[..., 0], W), W)
    iy, ty = _anchor_fractions(_unnormalize(coords[..., 1], H), H)
    iz, tz = _anchor_fractions(_unnormalize(coords[..., 2], D), D)
    flat = volume.reshape(B, D * H * W, C)
    rows = torch.arange(B, device=volume.device)[:, None]

    def corner(dz, dy, dx):
        return flat[rows, ((iz + dz) * H + iy + dy) * W + ix + dx]  # (B, N, C)

    tx, ty, tz = tx[..., None], ty[..., None], tz[..., None]
    # x first, for each (z, y) in the order z0y0, z0y1, z1y0, z1y1; then y; then z
    g00 = _lerp(corner(0, 0, 0), corner(0, 0, 1), tx)
    g01 = _lerp(corner(0, 1, 0), corner(0, 1, 1), tx)
    g10 = _lerp(corner(1, 0, 0), corner(1, 0, 1), tx)
    g11 = _lerp(corner(1, 1, 0), corner(1, 1, 1), tx)
    return _lerp(_lerp(g00, g01, ty), _lerp(g10, g11, ty), tz)


def trilinear_point_features(volume: torch.Tensor, coords: torch.Tensor, *,
                             align_corners: bool = False,
                             padding_mode: str = "border") -> torch.Tensor:
    """Sample per-point features from a dense 3-D feature volume.

    volume (B, D, H, W, C) channel-last; coords (B, N, 3) normalized to
    [-1, 1] in the grid convention (x -> W, y -> H, z -> D) -> (B, N, C).
    Border padding with align_corners=False, sides >= 2: the voxel family's
    lookup. CUDA tensors go to the hand-written kernel (fp32, C % 4 == 0,
    contiguous); CPU tensors take `border_trilerp_reference`.
    """
    if padding_mode != "border" or align_corners:
        raise NotImplementedError(
            f"padding_mode={padding_mode!r}, align_corners={align_corners} is not "
            "ported yet (the EmbeddingPiGAN lookup, ROADMAP A13)")
    if volume.ndim != 5 or min(volume.shape[1:4]) < 2:
        raise NotImplementedError(
            f"volume of shape {tuple(volume.shape)}: the port samples (B, D, H, W, C) "
            "volumes with every side >= 2 (ROADMAP A12)")
    if volume.device.type == "cpu":
        return border_trilerp_reference(volume, coords)
    if volume.device.type != "cuda":
        raise ValueError(f"trilinear_point_features: no kernel for device {volume.device}")
    out = trilinear_fwd(volume, coords)
    trilinear_point_features.launches += 1
    return out


trilinear_point_features.launches = 0
