"""Trilinear feature-volume sampling (port of
conditioned_nerf_gan_tpu/ops/grid_sample.py).

The parity target is `F.grid_sample(volume_ncdhw, grid, mode="bilinear",
align_corners=False, padding_mode="border")`; volumes are channel-last
(B, D, H, W, C) as in the JAX package, and coordinates follow the grid
convention: coords[..., 0] = x -> W, 1 = y -> H, 2 = z -> D.

  * `border_trilerp_reference`: the JAX border-mode math in plain torch
    (`_unnormalize`, `_anchor_fractions` with the anchor clamped to
    size - 2, the 8 corners combined in `_lerp_blocks`' order; on a side of
    1 both corners of that axis are its one voxel, as the JAX generic
    path's clamped corners are). What the wrapper takes for CPU tensors,
    and the comparator for the kernel.
  * `border_trilerp_vjp_reference`: its VJP in plain torch: dcoords as the
    JAX `_expanded_bwd` computes them, dV as an fp32 `index_add_` of the
    weighted corner rows. What the backward takes for CPU tensors, and the
    comparator for the backward kernel.
  * `trilinear_point_features`: the wrapper. On CUDA tensors it launches
    `csrc/trilinear_fwd.cu` (sm_90a) or raises; it never falls back. When
    an input needs grad it goes through `TrilinearSample`, whose backward
    launches `csrc/trilinear_bwd.cu` into the one dV of the volume's
    `VolumeGrad` node: a render puts its volume through `one_volume_grad`
    once, so all its lookups add into one buffer, zeroed once.
    `trilinear_point_features.launches` counts forward launches,
    `ops.kernels.trilinear.trilinear_bwd.launches` backward ones. CPU
    tensors take the plain version under plain autograd.

The JAX package's two gather strategies (the (z, y)-expanded slab and the
(2, 2, 2, C) block gather) and its one-hot-matmul VJP work around the TPU's
gather segments and its lack of atomic scatter; none is ported: the port's
dV is a scatter into one buffer a render.

  * `masked_trilerp`: the JAX zeros-padding lookup
    (conditioned_nerf_gan_tpu/ops/grid_sample.py:264-336), each of the 8
    corners gathered at its clamped index and weighed by its trilinear
    weight, zero where the corner lies outside the volume. Plain torch
    under autograd on every device: in JAX it is plain XLA, with no custom
    VJP and no Pallas kernel, so no kernel is owed. The wrapper takes it
    for zeros padding: EmbeddingPiGAN's align_corners=True lookup and the
    fixture writer's align_corners=False one. Border padding takes
    align_corners=False alone: no model of either package samples a border
    volume otherwise.
"""

from __future__ import annotations

import torch

from .kernels.trilinear import trilinear_bwd, trilinear_fwd


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool = False) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _anchor_fractions(f: torch.Tensor, size: int):
    """Border clamp, block anchor <= size - 2 and its fraction in [0, 1]: at
    the high border the anchor shifts down one cell and t = 1 selects the
    border voxel, as grid_sample's clipped x1 with t = 0 does. On a side of
    1 the anchor and the fraction are 0."""
    f = f.clamp(0.0, size - 1)
    i = torch.floor(f).long().clamp(0, max(size - 2, 0))
    return i, f - i


def _lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return a * (1 - t) + b * t


def _corner_rows(volume: torch.Tensor, coords: torch.Tensor):
    """Per axis (x, y, z) the unnormalized position, the anchor and the
    fraction (B, N); and the flat row (B, N) of each corner (dz, dy, dx) of a
    (B * D * H * W, C) view of the volume (on a side of 1 both corners of
    the axis are its one voxel)."""
    B, D, H, W, _ = volume.shape
    axes = []
    for k, size in enumerate((W, H, D)):
        f = _unnormalize(coords[..., k], size)
        axes.append((f, *_anchor_fractions(f, size)))
    (_, ix, _), (_, iy, _), (_, iz, _) = axes
    base = ((torch.arange(B, device=volume.device)[:, None] * D + iz) * H + iy) * W + ix
    sz, sy, sx = (H * W if D > 1 else 0), (W if H > 1 else 0), (1 if W > 1 else 0)

    def row(dz, dy, dx):
        return base + dz * sz + dy * sy + dx * sx

    return axes, row


def border_trilerp_reference(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain torch border-mode trilerp: volume (B, D, H, W, C), coords
    (B, N, 3) normalized -> (B, N, C), the JAX `_border_trilerp` forward."""
    C = volume.shape[-1]
    ((_, _, tx), (_, _, ty), (_, _, tz)), row = _corner_rows(volume, coords)
    flat = volume.reshape(-1, C)

    def corner(dz, dy, dx):
        return flat[row(dz, dy, dx)]  # (B, N, C)

    tx, ty, tz = tx[..., None], ty[..., None], tz[..., None]
    # x first, for each (z, y) in the order z0y0, z0y1, z1y0, z1y1; then y; then z
    g00 = _lerp(corner(0, 0, 0), corner(0, 0, 1), tx)
    g01 = _lerp(corner(0, 1, 0), corner(0, 1, 1), tx)
    g10 = _lerp(corner(1, 0, 0), corner(1, 0, 1), tx)
    g11 = _lerp(corner(1, 1, 0), corner(1, 1, 1), tx)
    return _lerp(_lerp(g00, g01, ty), _lerp(g10, g11, ty), tz)


def corner_contributions(volume: torch.Tensor, coords: torch.Tensor, g: torch.Tensor):
    """The scatter of the forward's VJP: (rows (8 B N,), parts (8 B N, C)),
    corner (dz, dy, dx) of every point as a row of a (B * D * H * W, C)
    view of dV and its contribution ((g (1 - tz)) (1 - ty)) (1 - tx) and
    likewise, each product rounded as torch autograd of the forward rounds
    it; dV is their sum."""
    C = volume.shape[-1]
    ((_, _, tx), (_, _, ty), (_, _, tz)), row = _corner_rows(volume, coords)
    tx, ty, tz = tx[..., None], ty[..., None], tz[..., None]
    wx, wy, wz = (1 - tx, tx), (1 - ty, ty), (1 - tz, tz)
    rows, parts = [], []
    for dz in (0, 1):
        gz = g * wz[dz]
        for dy in (0, 1):
            gzy = gz * wy[dy]
            for dx in (0, 1):
                rows.append(row(dz, dy, dx).reshape(-1))
                parts.append((gzy * wx[dx]).reshape(-1, C))
    return torch.cat(rows), torch.cat(parts)


def border_trilerp_vjp_reference(volume: torch.Tensor, coords: torch.Tensor,
                                 g: torch.Tensor, need_coords: bool = True):
    """VJP of `border_trilerp_reference` -> (dvolume (B, D, H, W, C), dcoords
    (B, N, 3) or None).

    dvolume: `corner_contributions` summed into zeros by an fp32
    `index_add_`. dcoords: the JAX `_expanded_bwd`
    cotangents of the fractions from the re-gathered corners (d_tx from the
    x-differences weighted by u = [(1-ty)(1-tz), ty(1-tz), (1-ty)tz, ty tz];
    d_ty, d_tz from the x-lerps), passed where the unclamped position lies
    in [0, size - 1] (the inclusive clip) and scaled by size / 2 (the
    unnormalization), each summed over channels last.
    """
    B, D, H, W, C = volume.shape
    rows, parts = corner_contributions(volume, coords, g)
    dvol = torch.zeros(B * D * H * W, C, dtype=volume.dtype, device=volume.device)
    dvol.index_add_(0, rows, parts)
    dvol = dvol.view(B, D, H, W, C)
    if not need_coords:
        return dvol, None

    ((fx, _, tx), (fy, _, ty), (fz, _, tz)), row = _corner_rows(volume, coords)
    tx, ty, tz = tx[..., None], ty[..., None], tz[..., None]
    flat = volume.reshape(-1, C)
    # (x0, x1) corners of each (z, y) pair in the order z0y0, z0y1, z1y0, z1y1
    pairs = [(flat[row(dz, dy, 0)], flat[row(dz, dy, 1)]) for dz in (0, 1) for dy in (0, 1)]
    u = ((1 - ty) * (1 - tz), ty * (1 - tz), (1 - ty) * tz, ty * tz)
    ex = sum((x1 - x0) * uk for (x0, x1), uk in zip(pairs, u))
    gx = [_lerp(x0, x1, tx) for x0, x1 in pairs]
    ey = (1 - tz) * (gx[1] - gx[0]) + tz * (gx[3] - gx[2])
    ez = (gx[2] * (1 - ty) + gx[3] * ty) - (gx[0] * (1 - ty) + gx[1] * ty)
    dcoords = []
    for e, f, size in ((ex, fx, W), (ey, fy, H), (ez, fz, D)):
        inside = (f >= 0) & (f <= size - 1)
        dcoords.append(torch.where(inside, (e * g).sum(-1), 0.0) * (size / 2.0))
    return dvol, torch.stack(dcoords, dim=-1)


def masked_trilerp(volume: torch.Tensor, coords: torch.Tensor, *,
                   align_corners: bool = False) -> torch.Tensor:
    """The zeros-padding lookup: volume (B, D, H, W, C), coords (B, N, 3)
    normalized -> (B, N, C), positions unnormalized by `align_corners`, a
    corner outside the volume weighing 0. Corners in the order z, y, x
    (outer to inner), each weight ((wx wy) wz), summed in that order, as
    the JAX generic path computes them."""
    B, D, H, W, C = volume.shape
    flat = volume.reshape(B, D * H * W, C)
    f = [_unnormalize(coords[..., i], size, align_corners) for i, size in enumerate((W, H, D))]
    lo = [torch.floor(v) for v in f]
    t = [v - l for v, l in zip(f, lo)]
    lo = [l.long() for l in lo]
    out = torch.zeros((B, coords.shape[1], C), dtype=volume.dtype, device=volume.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix, iy, iz = lo[0] + dx, lo[1] + dy, lo[2] + dz
                w = ((t[0] if dx else 1.0 - t[0]) * (t[1] if dy else 1.0 - t[1])
                     * (t[2] if dz else 1.0 - t[2]))
                valid = ((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0)
                         & (iz < D))
                index = ((iz.clamp(0, D - 1) * H + iy.clamp(0, H - 1)) * W
                         + ix.clamp(0, W - 1))
                corner = torch.gather(flat, 1, index[..., None].expand(-1, -1, C))
                out = out + corner * torch.where(valid, w, 0.0)[..., None]
    return out


def _takes_kernels(t: torch.Tensor) -> bool:
    """CUDA tensors go to the kernels, CPU tensors to the plain versions;
    there is no kernel for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"trilinear_point_features: no kernel for device {t.device}")
    return t.device.type == "cuda"


class VolumeGrad(torch.autograd.Function):
    """One dV for every lookup of a volume in a render. Applied once to the
    volume, before the render's ray-chunk loop; the render samples its
    output. Each lookup's backward (`TrilinearSample`) adds its VJP into the
    one buffer this node owns, zeroed at the first lookup's backward, and
    passes no grad of its own, so autograd sums nothing; this node's
    backward, which autograd runs after all of theirs, hands the buffer to
    the volume's grad_fn. A checkpointed chunk's recompute re-runs only the
    lookup's forward, which neither zeroes nor scatters."""

    @staticmethod
    def forward(ctx, volume):
        ctx.set_materialize_grads(False)  # no full-size zero grad for the lookups' None
        ctx.dvolume = None
        return volume.detach()

    @staticmethod
    def backward(ctx, g):
        dvolume, ctx.dvolume = ctx.dvolume, None
        if g is not None:  # a use of the output other than a lookup
            dvolume = g if dvolume is None else dvolume.add_(g)
        return dvolume


def _volume_grad_node(volume: torch.Tensor):
    """The `VolumeGrad` node that made `volume`, or None."""
    node = volume.grad_fn
    return node if type(node) is VolumeGrad._backward_cls else None


def one_volume_grad(volume: torch.Tensor) -> torch.Tensor:
    """The volume as a render's lookups take it: on the kernel route (a CUDA
    volume that needs grad, grad enabled) through `VolumeGrad`, so that the
    render's lookups add into one dV; else, or if it went through already,
    the volume itself."""
    if (torch.is_grad_enabled() and volume.requires_grad and _takes_kernels(volume)
            and _volume_grad_node(volume) is None):
        return VolumeGrad.apply(volume)
    return volume


class TrilinearSample(torch.autograd.Function):
    """The kernels as one differentiable op: the forward launches the
    trilinear kernel and saves the volume and coordinates; the backward
    launches the backward kernel for what `needs_input_grad` asks. dV goes
    into the buffer of the `VolumeGrad` node the volume came from (on the
    main path dV alone: its points never need grad), and the volume gets no
    grad here."""

    @staticmethod
    def forward(ctx, volume, coords):
        ctx.save_for_backward(volume, coords)
        ctx.volume_grad = _volume_grad_node(volume)
        return _forward_kernel(volume, coords)

    @staticmethod
    def backward(ctx, g):
        volume, coords = ctx.saved_tensors
        need_volume, need_coords = ctx.needs_input_grad
        node = ctx.volume_grad
        dvol = None
        if need_volume:
            if node is None:
                raise RuntimeError("TrilinearSample: a volume that needs grad must come "
                                   "through one_volume_grad")
            if node.dvolume is None:
                node.dvolume = torch.zeros(volume.shape, dtype=volume.dtype,
                                           device=volume.device)
            dvol = node.dvolume
        return None, trilinear_bwd(volume, coords, g, dvol, need_coords)


def _forward_kernel(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    out = trilinear_fwd(volume, coords)
    trilinear_point_features.launches += 1
    return out


def trilinear_point_features(volume: torch.Tensor, coords: torch.Tensor, *,
                             align_corners: bool = False,
                             padding_mode: str = "border") -> torch.Tensor:
    """Sample per-point features from a dense 3-D feature volume.

    volume (B, D, H, W, C) channel-last; coords (B, N, 3) normalized to
    [-1, 1] in the grid convention (x -> W, y -> H, z -> D) -> (B, N, C).
    Border padding with align_corners=False, the voxel family's lookup:
    CUDA tensors go to the hand-written kernel (fp32, C % 4 == 0,
    contiguous), through `TrilinearSample` when an input needs grad (a
    volume that needs grad through `one_volume_grad` first, unless the
    caller's render put it through once for all its lookups); CPU tensors
    take `border_trilerp_reference` under plain autograd. Zeros padding is
    `masked_trilerp` under plain autograd on any device, as the JAX
    package's is plain XLA.
    """
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"Unsupported padding_mode {padding_mode!r}")
    if volume.ndim != 5 or min(volume.shape[1:4]) < 1:
        raise ValueError(f"volume of shape {tuple(volume.shape)}: the lookup samples "
                         "(B, D, H, W, C) volumes")
    if padding_mode == "zeros":
        return masked_trilerp(volume, coords, align_corners=align_corners)
    if align_corners:
        raise ValueError("border padding samples with align_corners=False (the voxel "
                         "family's lookup); no model samples a border volume otherwise")
    if not _takes_kernels(volume):
        return border_trilerp_reference(volume, coords)
    if torch.is_grad_enabled() and (volume.requires_grad or coords.requires_grad):
        return TrilinearSample.apply(one_volume_grad(volume), coords)
    return _forward_kernel(volume, coords)


trilinear_point_features.launches = 0
