"""Operations and bytes the algorithm needs, from shapes alone.

FLOPs count the multiply-adds of matmuls and convolutions, two FLOPs each.
A backward pass counts twice its forward; checkpoint recomputation is not
counted. Bytes count each input read once and each output written once at
a function's boundary: the points, freq and phase, the fp32 parameters as
the model holds them, the outputs and grads. Nothing here follows a choice
of the program's kernels (no folded weight copies, no sin instruction
counts), so a redesign can never read above 100% of its own bound.
"""

from __future__ import annotations

F32 = 4


# ---------------------------------------------------------------------------
# the FiLM-SIREN (K1 forward, K2 VJP)
# ---------------------------------------------------------------------------


def siren_macs(din: int, layers: int, hidden: int, out: int) -> int:
    """Multiply-adds a point: the first layer, the trunk, the head."""
    return din * hidden + (layers - 1) * hidden * hidden + hidden * out


def siren_param_floats(din: int, layers: int, hidden: int, out: int) -> int:
    return (din * hidden + hidden + (layers - 1) * (hidden * hidden + hidden)
            + hidden * out + out)


def film_fwd(B: int, N: int, din: int, layers: int, hidden: int, out: int):
    """(FLOPs, bytes) of one forward call on B x N points."""
    flops = 2 * B * N * siren_macs(din, layers, hidden, out)
    nbytes = F32 * (B * N * din + 2 * B * layers * hidden
                    + siren_param_floats(din, layers, hidden, out) + B * N * out)
    return flops, nbytes


def film_bwd(B: int, N: int, din: int, layers: int, hidden: int, out: int):
    """(FLOPs, bytes) of one VJP call: dX and dW of every layer (twice the
    forward's products), no recompute; reads the forward's inputs and the
    cotangent, writes dpoints, dfreq, dphase and the parameter grads."""
    flops = 4 * B * N * siren_macs(din, layers, hidden, out)
    params = siren_param_floats(din, layers, hidden, out)
    reads = B * N * din + 2 * B * layers * hidden + params + B * N * out
    writes = B * N * din + 2 * B * layers * hidden + params
    return flops, F32 * (reads + writes)


# ---------------------------------------------------------------------------
# the trilinear gather (K5) and its scatter
# ---------------------------------------------------------------------------


def trilinear_fwd(B: int, N: int, C: int, rows: int):
    """(FLOPs, bytes) of one lookup of B x N points into a C-channel volume
    whose `rows` distinct voxels these points touch: no matmul FLOPs; the
    coordinates, the touched rows and the features out."""
    return 0, F32 * (B * N * 3 + rows * C + B * N * C)


def trilinear_bwd(B: int, N: int, C: int, rows: int, need_coords: bool = False):
    """(FLOPs, bytes) of one VJP: reads the coordinates and the cotangent,
    writes the touched rows of dV (and reads them of the volume, and writes
    dcoords, where dcoords are asked)."""
    reads = B * N * 3 + B * N * C + (rows * C if need_coords else 0)
    writes = rows * C + (B * N * 3 if need_coords else 0)
    return 0, F32 * (reads + writes)


def touched_rows(shape, coords) -> int:
    """Distinct voxels (of B volumes of D x H x W) that the border lookup
    at normalized `coords` (B, N, 3) reads: each point's 8 corners, the
    anchor clamped as the lookup clamps it."""
    import torch

    B, D, H, W = shape[:4]
    idx = []
    for k, size in enumerate((W, H, D)):
        f = (((coords[..., k] + 1.0) * size - 1.0) / 2.0).clamp(0.0, size - 1)
        idx.append(torch.floor(f).long().clamp(0, max(size - 2, 0)))
    ix, iy, iz = idx
    base = ((torch.arange(B, device=coords.device)[:, None] * D + iz) * H + iy) * W + ix
    sz, sy, sx = (H * W if D > 1 else 0), (W if H > 1 else 0), (1 if W > 1 else 0)
    corners = torch.stack([base + dz * sz + dy * sy + dx * sx
                           for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)])
    return int(torch.unique(corners).numel())


# ---------------------------------------------------------------------------
# whole networks, forward FLOPs
# ---------------------------------------------------------------------------


def mlp_flops(rows: int, dims: list) -> int:
    """rows through linear layers dims[0] -> dims[1] -> ..."""
    return 2 * rows * sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def pointnet_flops(clouds: int, points: int, dim: int = 6, hidden: int = 512,
                   c_dim: int = 512) -> int:
    """ResnetPointnet forward: fc_pos, block 0 on 2h-wide points, blocks 1-4
    on [x, max-pool(x)], whose pooled half is one product a cloud, fc_c."""
    h, n = hidden, clouds * points
    per_point = dim * 2 * h + (2 * h * h + h * h + 2 * h * h) + 4 * (3 * h * h)
    per_cloud = 4 * (2 * h * h) + h * c_dim
    return 2 * (n * per_point + clouds * per_cloud)


def unet3d_flops(batch: int, side: int, in_channels: int, f_maps: int, levels: int,
                 out_channels: int) -> int:
    """UNet3D ('gcr', DoubleConv blocks, 3^3 convs, nearest up, concat
    skips, a 1^3 final conv) forward."""
    f = [f_maps * 2 ** k for k in range(levels)]
    macs = 0
    c_in = in_channels
    for lvl, c_out in enumerate(f):
        vox = (side >> lvl) ** 3
        mid = max(c_out // 2, c_in)
        macs += vox * 27 * (c_in * mid + mid * c_out)
        c_in = c_out
    ups = list(reversed(f))
    for i, (x, skip) in enumerate(zip(ups[:-1], ups[1:])):
        vox = (side >> (levels - 2 - i)) ** 3
        macs += vox * 27 * ((skip + x) * skip + skip * skip)
    macs += side ** 3 * f[0] * out_channels
    return 2 * batch * macs


D_LAYER = {2: 8, 4: 7, 8: 6, 16: 5, 32: 4, 64: 3, 128: 2, 256: 1, 512: 0}
D_CHANNELS = (32, 64, 128, 256, 400, 400, 400, 400)
D_ADAPTERS = (16, 32, 64, 128, 256, 400, 400, 400, 400)


def progressive_d_flops(batch: int, img: int) -> int:
    """The progressive discriminator forward at img^2: the entry adapter,
    the faded adapter at half size, each residual CoordConv block (two 3^3
    convs on 2 more channels, a 1^1 projection after the pool where the
    width changes), the final 2^2 conv."""
    start = D_LAYER[img]
    macs = img * img * 3 * D_ADAPTERS[start]
    half = img // 2
    macs += half * half * 3 * D_ADAPTERS[start + 1]
    side = img
    for i in range(start, len(D_CHANNELS)):
        c_in, c = D_ADAPTERS[i], D_CHANNELS[i]
        macs += side * side * 9 * ((c_in + 2) * c + (c + 2) * c)
        side //= 2
        if c_in != c:
            macs += side * side * c_in * c
    macs += (side - 1) ** 2 * D_CHANNELS[-1] * 4  # the final 2^2 conv, one logit
    return 2 * batch * macs


# ---------------------------------------------------------------------------
# a train step and a render request
# ---------------------------------------------------------------------------


def render_points(views: int, img: int, samples: int, hierarchical: bool = True) -> int:
    """SIREN points of one render: coarse, and as many fine."""
    return views * img * img * samples * (2 if hierarchical else 1)


def generator_flops(shapes: dict, views: int) -> int:
    """Mapping network once a view, the SIREN at every point of the render."""
    s = shapes["siren"]
    pts = render_points(views, shapes["img"], shapes["samples"], shapes["hierarchical"])
    return (mlp_flops(views, s["mapping"])
            + 2 * pts * siren_macs(s["din"], s["layers"], s["hidden"], s["out"]))


def train_step_flops(shapes: dict) -> int:
    """One D-then-G step at `shapes` (what the harness logs at set-up):
    the D step's encode and render without grad, D on real and fake, R1's
    gradient pass and the backward of all three (R1's is its double
    backward); the G step's encode and render, D on the fakes, and their
    backward. The encoder's and D's forward FLOPs at the step's shapes come
    from the configuration's reference module (`encoder_flops`,
    `discriminator_flops`: 0 without D)."""
    B = shapes["batch"]
    enc, gen = shapes["encoder_flops"], generator_flops(shapes, B)
    total = 3 * (enc + gen)  # G step: forward + backward
    d = shapes["discriminator_flops"]
    if d:
        # D step: render (no grad), D(real) + D(fake), R1's pass (a
        # backward), backward of both forwards, double backward of R1's pass
        total += enc + gen + 2 * d + 2 * d + 2 * (2 * d) + 2 * (2 * d)
        total += 3 * d  # G step: D on the fakes, and its backward
    return total


def request_flops(shapes: dict) -> int:
    """One render request: encode `views` inputs, render a view of each."""
    return shapes["encoder_flops"] + generator_flops(shapes, shapes["views"])
