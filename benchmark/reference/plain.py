"""The plain reference: a frozen copy of the fp32 paths of the thesis model
and the `dg` model, in plain PyTorch, importing nothing of the program.

Everything here is float32 with no kernel, no fold and no fast sin: the
rays, stratified and importance sampling, the stable sort-merge, the
integration, the FiLM-SIREN (exact `torch.sin`), the mapping networks, the
border trilinear lookup, ResnetPointnet, UNet3D, the progressive
discriminator with R1, the losses, the clipped Adam chains and the D-then-G
train step. Parameter names are the program's, so one state dict loads
into either.

Every product (linear, conv) goes through `q`, the precision of its
operands: `exact` for the reference, `Fp8()` for the control, which rounds
each operand to float8 e4m3 with a per-tensor scale and each incoming
cotangent to e5m2, the step below the bf16 policy the configurations
state. Each layer records how its parameters are drawn (`inits`), so that
the benchmark can make every weight from the seed in one draw.

Memory: the encoders run under a per-sample checkpoint when grad is on
(the fp32 PointNet on 12 clouds of 65,536 points would hold ~57 GB of
activations at once), and the render under a per-chunk checkpoint, as the
program's does.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# ---------------------------------------------------------------------------
# operand precision
# ---------------------------------------------------------------------------


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def _round_scaled(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = amax / torch.finfo(dtype).max
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round_scaled(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2)


class Fp8:
    """Operands rounded to float8 e4m3 (per-tensor scale), cotangents to e5m2."""

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8Round.apply(t)


# ---------------------------------------------------------------------------
# layers: each records how its parameters are drawn
# ---------------------------------------------------------------------------


def uniform(bound: float):
    return ("uniform", float(bound))


def normal(std: float):
    return ("normal", float(std))


class Linear(nn.Module):
    """y = q(x) q(W)^T + b; W (out, in). `w_init` defaults to torch's
    U(+-1/sqrt(fan_in)), the bias always."""

    def __init__(self, fan_in: int, fan_out: int, q=exact, w_init=None, bias=True):
        super().__init__()
        self.q = q
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out)) if bias else None
        bound = 1.0 / math.sqrt(fan_in)
        self.inits = {"weight": w_init or uniform(bound)}
        if bias:
            self.inits["bias"] = uniform(bound)

    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class Conv(nn.Module):
    """2-D or 3-D convolution (NCHW / NCDHW), torch-default init."""

    def __init__(self, dims: int, c_in: int, c_out: int, k: int, padding: int = 0,
                 q=exact, bias: bool = True):
        super().__init__()
        self.q, self.padding = q, padding
        self.conv = F.conv2d if dims == 2 else F.conv3d
        self.weight = nn.Parameter(torch.empty(c_out, c_in, *([k] * dims)))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None
        bound = 1.0 / math.sqrt(c_in * k ** dims)
        self.inits = {"weight": uniform(bound)}
        if bias:
            self.inits["bias"] = uniform(bound)

    def forward(self, x):
        return self.conv(self.q(x), self.q(self.weight), self.bias, padding=self.padding)


class GroupNorm(nn.GroupNorm):
    def __init__(self, groups: int, channels: int):
        super().__init__(groups, channels, eps=1e-5)
        self.inits = {"weight": ("const", 1.0), "bias": ("const", 0.0)}


def init_specs(module: nn.Module) -> dict:
    """{parameter name: (kind, scale)} over `module`, in named_parameters order."""
    specs = {}
    for prefix, sub in module.named_modules():
        for name, spec in getattr(sub, "inits", {}).items():
            specs[f"{prefix}.{name}" if prefix else name] = spec
    names = [n for n, _ in module.named_parameters()]
    missing = set(names) ^ set(specs)
    if missing:
        raise ValueError(f"parameters without an init rule: {sorted(missing)}")
    return {n: specs[n] for n in names}


# ---------------------------------------------------------------------------
# rays, sampling, integration (fp32)
# ---------------------------------------------------------------------------


def normalize_vecs(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def get_initial_rays(B, S, fov, size, ray_start, ray_end, device):
    x = torch.linspace(-1.0, 1.0, size, device=device)
    y = torch.linspace(-1.0, 1.0, size, device=device)
    xx = x[None, :].expand(size, size).reshape(-1)
    yy = y[:, None].expand(size, size).reshape(-1)
    inv_tan = 1.0 / torch.tan(torch.as_tensor(fov, device=device) * (math.pi / 360.0))
    rays_d = normalize_vecs(torch.stack([xx, yy, inv_tan.expand(xx.shape)], dim=-1))
    z = torch.linspace(ray_start, ray_end, S, device=device)
    z_vals = z[None, :, None].expand(size * size, S, 1)
    points = (rays_d[:, None, :] * z_vals)[None].expand(B, size * size, S, 3)
    return points, z_vals[None].expand(B, *z_vals.shape), rays_d[None].expand(B, -1, -1)


def perturb_points(points, z_vals, rays_d, generator):
    u = torch.rand(z_vals.shape, generator=generator, device=z_vals.device)
    offset = (u - 0.5) * (z_vals[:, :, 1:2, :] - z_vals[:, :, 0:1, :])
    return points + offset * rays_d[:, :, None, :], z_vals + offset


def transform_rays(points, z_vals, rays_d, cam2world):
    rot, t = cam2world[:, :3, :3], cam2world[:, :3, 3]

    def rotate(v, lead):
        r = rot.reshape(rot.shape[0], *([1] * lead), 3, 3)
        return r[..., 0] * v[..., 0:1] + r[..., 1] * v[..., 1:2] + r[..., 2] * v[..., 2:3]

    dirs = rotate(rays_d, 1)
    return rotate(points, 2) + t[:, None, None, :], z_vals, dirs, t[:, None, :].expand(dirs.shape)


def sample_camera_positions(n, generator, cam_r_start, cam_r_end, device=None, up="y"):
    u = torch.rand((n, 3), generator=generator, device=device)
    theta = torch.arccos(1.0 - u[:, 0]).clamp(1e-5, math.pi - 1e-5)
    phi = u[:, 1] * 2.0 * math.pi
    r = u[:, 2] * (cam_r_end - cam_r_start) + cam_r_start
    x = r * torch.sin(theta) * torch.cos(phi)
    lateral, vertical = r * torch.sin(theta) * torch.sin(phi), r * torch.cos(theta)
    if up == "z":
        return torch.stack([x, lateral, vertical], dim=-1)
    return torch.stack([x, vertical, lateral], dim=-1)


def create_cam2world_matrix(origin, up="y"):
    forward = normalize_vecs(-origin)
    upv = torch.zeros_like(forward)
    upv[:, 1 if up == "y" else 2] = 1.0
    left = normalize_vecs(torch.linalg.cross(upv, forward, dim=-1))
    true_up = normalize_vecs(torch.linalg.cross(forward, left, dim=-1))
    mat = torch.eye(4, dtype=origin.dtype, device=origin.device).repeat(origin.shape[0], 1, 1)
    mat[:, :3, :3] = torch.stack([-left, -true_up, forward], dim=-1)
    mat[:, :3, 3] = origin
    return mat


def sample_pdf(bins, weights, n, uniforms=None, eps=1e-5):
    """Inverse-CDF samples; `uniforms` None: the deterministic linspace."""
    n_rays, n_bins = weights.shape
    weights = weights + eps
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1).contiguous()
    if uniforms is None:
        u = torch.linspace(0.0, 1.0, n, device=cdf.device).expand(n_rays, n)
    else:
        u = uniforms
    u = u.contiguous()
    above_raw = torch.searchsorted(cdf, u)
    below = (above_raw - 1).clamp_min(0)
    above = above_raw.clamp_max(n_bins)
    cdf_lo, cdf_hi = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bin_lo, bin_hi = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def merge_sorted_samples(out_a, z_a, out_b, z_b):
    outs, zs = torch.cat([out_a, out_b], dim=-2), torch.cat([z_a, z_b], dim=-2)
    z_sorted, order = torch.sort(zs[..., 0], dim=-1, stable=True)
    gathered = torch.gather(outs, -2, order[..., None].expand(*order.shape, outs.shape[-1]))
    return gathered, z_sorted[..., None]


def volume_integrate(rgb_sigma, z_vals, white_back=False, clamp_mode="relu", noise=None):
    """`noise`, where given, is the density noise already scaled to its std."""
    rgbs, sigmas = rgb_sigma[..., :3], rgb_sigma[..., 3:]
    if noise is not None:
        sigmas = sigmas + noise
    deltas = z_vals[:, :, 1:] - z_vals[:, :, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :, :1], 1e10)], dim=-2)
    density = F.softplus(sigmas) if clamp_mode == "softplus" else F.relu(sigmas)
    alphas = 1.0 - torch.exp(-deltas * density)
    shifted = torch.cat([torch.ones_like(alphas[:, :, :1]), 1.0 - alphas + 1e-10], dim=-2)
    weights = alphas * torch.cumprod(shifted, dim=-2)[:, :, :-1]
    weights_sum = weights.sum(dim=2)
    rgb = torch.sum(weights * rgbs, dim=-2)
    depth = torch.sum(weights * z_vals, dim=-2)
    if white_back:
        rgb = rgb + 1.0 - weights_sum
    return rgb, depth, weights


# ---------------------------------------------------------------------------
# the border trilinear lookup (align_corners=False)
# ---------------------------------------------------------------------------


def border_trilerp(volume, coords):
    """volume (B, D, H, W, C), coords (B, N, 3) in [-1, 1] (x -> W, y -> H,
    z -> D) -> (B, N, C); border clamp, x lerped first, then y, then z."""
    B, D, H, W, C = volume.shape
    axes = []
    for k, size in enumerate((W, H, D)):
        f = (((coords[..., k] + 1.0) * size - 1.0) / 2.0).clamp(0.0, size - 1)
        i = torch.floor(f).long().clamp(0, max(size - 2, 0))
        axes.append((i, f - i))
    (ix, tx), (iy, ty), (iz, tz) = axes
    base = ((torch.arange(B, device=volume.device)[:, None] * D + iz) * H + iy) * W + ix
    sz, sy, sx = (H * W if D > 1 else 0), (W if H > 1 else 0), (1 if W > 1 else 0)
    flat = volume.reshape(-1, C)

    def corner(dz, dy, dx):
        return flat[base + dz * sz + dy * sy + dx * sx]

    def lerp(a, b, t):
        return a * (1 - t) + b * t

    tx, ty, tz = tx[..., None], ty[..., None], tz[..., None]
    g00 = lerp(corner(0, 0, 0), corner(0, 0, 1), tx)
    g01 = lerp(corner(0, 1, 0), corner(0, 1, 1), tx)
    g10 = lerp(corner(1, 0, 0), corner(1, 0, 1), tx)
    g11 = lerp(corner(1, 1, 0), corner(1, 1, 1), tx)
    return lerp(lerp(g00, g01, ty), lerp(g10, g11, ty), tz)


# ---------------------------------------------------------------------------
# the FiLM-SIREN and its mappings
# ---------------------------------------------------------------------------


def kaiming_leaky(fan_in: int, scale: float = 1.0):
    return normal(math.sqrt(2.0 / (1.0 + 0.2 ** 2)) / math.sqrt(fan_in) * scale)


class MLPMapping(nn.Module):
    """z -> (freq, phase): LeakyReLU(0.2) hidden layers, kaiming-leaky
    init, the last layer scaled by 0.25 (`CustomMappingNetwork`: 3 hidden)."""

    def __init__(self, z_dim, hidden, out_dim, num_hidden=3, q=exact):
        super().__init__()
        dims = [z_dim] + [hidden] * num_hidden
        self.layers = nn.ModuleList(
            [Linear(i, o, q, kaiming_leaky(i)) for i, o in zip(dims[:-1], dims[1:])]
            + [Linear(hidden, out_dim, q, kaiming_leaky(hidden, 0.25))])

    def forward(self, z):
        x = z
        for layer in self.layers[:-1]:
            x = F.leaky_relu(layer(x), 0.2)
        return self.layers[-1](x).chunk(2, dim=-1)


class LinearMapping(nn.Module):
    """The FG variants' mapping: one torch-default linear layer."""

    def __init__(self, in_dim, out_dim, q=exact):
        super().__init__()
        self.layers = nn.ModuleList([Linear(in_dim, out_dim, q)])

    def forward(self, z):
        return self.layers[0](z).chunk(2, dim=-1)


class FiLMLayer(nn.Module):
    """sin(freq * (W x + b) + phase), freq and phase per batch element."""

    def __init__(self, fan_in, hidden, w_init, q=exact):
        super().__init__()
        self.linear = Linear(fan_in, hidden, q, w_init)

    def forward(self, x, freq, phase):
        return torch.sin(freq[:, None, :] * self.linear(x) + phase[:, None, :])


class FilmSiren(nn.Module):
    """An all-FiLM SIREN with a sigmoid on rgb: SHORTSIREN (points, a latent
    through `MLPMapping`) or TALLSIREN_FG (features sampled from the U-Net's
    volume at points / 0.6, its global feature through `LinearMapping`)."""

    def __init__(self, n_layers, input_dim, hidden, mapping, features_input, q=exact,
                 freq_init=25.0, out_dim=4):
        super().__init__()
        self.hidden, self.features_input = hidden, features_input
        self.mapping_network = mapping
        freq_bound = lambda fan_in: uniform(math.sqrt(6.0 / fan_in) / freq_init)  # noqa: E731
        self.film_layers = nn.ModuleList([
            FiLMLayer(input_dim if i == 0 else hidden, hidden,
                      uniform(1.0 / input_dim) if i == 0 else freq_bound(hidden), q)
            for i in range(n_layers)])
        self.final_layer = Linear(hidden, out_dim, q, freq_bound(hidden))

    def forward(self, points, z):
        if self.features_input:
            volume, source = z
            x = border_trilerp(volume, points / 0.6)
        else:
            x, source = points, z
        freq, phase = self.mapping_network(source)
        freq = freq * 15.0 + 30.0
        H = self.hidden
        for i, layer in enumerate(self.film_layers):
            x = layer(x, freq[..., i * H:(i + 1) * H], phase[..., i * H:(i + 1) * H])
        out = self.final_layer(x)
        return torch.cat([torch.sigmoid(out[..., :3]), out[..., 3:]], dim=-1)


class Generator(nn.Module):
    """The NeRF render around a SIREN: rays, stratified samples, coarse
    SIREN, importance samples (detached), fine SIREN, stable merge,
    integration; pixels in [-1, 1] NHWC and z-depth. `render` holds
    img_size, num_steps, fov, ray_start, ray_end, white_back, clamp_mode,
    ray_chunks, perturb and, optionally, nerf_noise. A `generator` draws the
    perturbation, the fine uniforms and, where nerf_noise is above 0, the
    density noise of both integrations (coarse, then merged) up front for
    the whole image, in that order (None: deterministic, no noise)."""

    def __init__(self, siren: nn.Module):
        super().__init__()
        self.siren = siren

    def _pipeline(self, z, points, z_vals, dirs, origins, fine_u, noise1, noise2, render):
        B, R, S, _ = points.shape
        coarse = self.siren(points.reshape(B, R * S, 3), z).reshape(B, R, S, 4)
        with torch.no_grad():
            _, _, w = volume_integrate(coarse, z_vals, clamp_mode=render["clamp_mode"],
                                       noise=noise1)
            w = w.reshape(B * R, S) + 1e-5
            zf = z_vals.reshape(B * R, S)
            fine_z = sample_pdf(0.5 * (zf[:, :-1] + zf[:, 1:]), w[:, 1:-1], S,
                                None if fine_u is None else fine_u.reshape(B * R, S))
            fine_z = fine_z.reshape(B, R, S, 1)
            fine_points = origins[:, :, None, :] + dirs[:, :, None, :] * fine_z
        fine = self.siren(fine_points.reshape(B, R * S, 3), z).reshape(B, R, S, 4)
        outs, zs = merge_sorted_samples(fine, fine_z, coarse, z_vals)
        rgb, dist, _ = volume_integrate(outs, zs, white_back=render["white_back"],
                                        clamp_mode=render["clamp_mode"], noise=noise2)
        return rgb, dist

    def forward(self, z, cam2world, render, generator=None):
        B, S, size = cam2world.shape[0], render["num_steps"], render["img_size"]
        dev = cam2world.device
        points, z_vals, rays_d_cam = get_initial_rays(B, S, render["fov"], size,
                                                      render["ray_start"], render["ray_end"], dev)
        if render["perturb"] and generator is not None:
            points, z_vals = perturb_points(points, z_vals, rays_d_cam, generator)
        points, z_vals, dirs, origins = transform_rays(points, z_vals, rays_d_cam, cam2world)
        R = size * size
        fine_u = noise1 = noise2 = None
        std = render.get("nerf_noise", 0.0)
        if generator is not None:
            fine_u = torch.rand((B, R, S), generator=generator, device=dev)
            if std > 0:
                noise1 = torch.randn((B, R, S, 1), generator=generator, device=dev) * std
                noise2 = torch.randn((B, R, 2 * S, 1), generator=generator, device=dev) * std
        rays = [points, z_vals, dirs, origins, fine_u, noise1, noise2]
        k = max(render["ray_chunks"] or 1, 1)
        r = R // k
        pix, dists = [], []
        for i in range(k):
            part = [None if t is None else t[:, i * r:(i + 1) * r] for t in rays]

            def run(*part):
                return self._pipeline(z, *part, render)

            if torch.is_grad_enabled():
                p, d = checkpoint(run, *part, use_reentrant=False)
            else:
                p, d = run(*part)
            pix.append(p)
            dists.append(d)
        pixels = torch.cat(pix, dim=1).reshape(B, size, size, 3) * 2.0 - 1.0
        depth = (rays_d_cam[..., -1:] * torch.cat(dists, dim=1)).reshape(B, size, size)
        return pixels, depth


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


class ResnetBlockFC(nn.Module):
    def __init__(self, size_in, size_out, q=exact):
        super().__init__()
        size_h = min(size_in, size_out)
        self.fc_0 = Linear(size_in, size_h, q)
        self.fc_1 = Linear(size_h, size_out, q)
        self.shortcut = Linear(size_in, size_out, q, bias=False) if size_in != size_out else None

    def forward(self, x):
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + self.fc_1(F.relu(self.fc_0(F.relu(x))))


class ResnetPointnet(nn.Module):
    """(B, T, 6) -> (B, c_dim): fc_pos, 5 blocks, the max-pool of a block's
    input concatenated onto every point after the first block, fc_c."""

    def __init__(self, c_dim=512, dim=6, hidden=512, q=exact):
        super().__init__()
        self.fc_pos = Linear(dim, 2 * hidden, q)
        self.blocks = nn.ModuleList([ResnetBlockFC(2 * hidden, hidden, q) for _ in range(5)])
        self.fc_c = Linear(hidden, c_dim, q)

    def _one(self, p):
        net = self.blocks[0](self.fc_pos(p))
        for block in self.blocks[1:]:
            pooled = net.amax(dim=1, keepdim=True).expand(net.shape)
            net = block(torch.cat([net, pooled], dim=-1))
        return self.fc_c(F.relu(net.amax(dim=1)))

    def forward(self, p):
        if not torch.is_grad_enabled():
            return torch.cat([self._one(p[i:i + 1]) for i in range(p.shape[0])])
        return torch.cat([checkpoint(self._one, p[i:i + 1], use_reentrant=False)
                          for i in range(p.shape[0])])


def encode_pcl(encoder, pcl):
    """The whitened latent (unbiased std over channels) and the mean L2 norm
    of the raw latents."""
    enc = encoder(pcl)
    l_reg = torch.linalg.vector_norm(enc, dim=1).mean()
    enc = enc - enc.mean(dim=1, keepdim=True)
    return enc / enc.std(dim=1, keepdim=True, unbiased=True), l_reg


class SingleConv(nn.Sequential):
    """'gcr': GroupNorm (8 groups, 1 under 8 channels), a bias-free 3^3 conv, ReLU."""

    def __init__(self, c_in, c_out, q=exact):
        super().__init__()
        self.add_module("norm", GroupNorm(8 if c_in >= 8 else 1, c_in))
        self.add_module("conv", Conv(3, c_in, c_out, 3, 1, q, bias=False))
        self.add_module("relu", nn.ReLU())


class DoubleConv(nn.Module):
    def __init__(self, c_in, c_out, encoder, q=exact):
        super().__init__()
        mid = max(c_out // 2, c_in) if encoder else c_out
        self.conv1 = SingleConv(c_in, mid, q)
        self.conv2 = SingleConv(mid, c_out, q)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class UNet3D(nn.Module):
    """(B, D, H, W, C_in) NDHWC -> ((B, D, H, W, C_out) volume, (B, f_maps[-1])
    global): max-pool down, nearest 2x up, concat [skip, x] skips, a 1^3
    final conv, the bottleneck's mean."""

    def __init__(self, in_channels=4, out_channels=32, f_maps=32, num_levels=4, q=exact):
        super().__init__()
        f = [f_maps * 2 ** k for k in range(num_levels)]
        ins = [in_channels] + f[:-1]
        ups = list(reversed(f))
        self.encoders = nn.ModuleList([DoubleConv(i, o, True, q) for i, o in zip(ins, f)])
        self.decoders = nn.ModuleList([DoubleConv(s + x, s, False, q)
                                       for x, s in zip(ups[:-1], ups[1:])])
        self.final_conv = Conv(3, f[0], out_channels, 1, 0, q)

    def _one(self, x):
        x = x.permute(0, 4, 1, 2, 3)
        skips = []
        for i, encoder in enumerate(self.encoders):
            if i > 0:
                x = F.max_pool3d(x, 2, 2)
            x = encoder(x)
            skips.insert(0, x)
        glob = x.mean(dim=(2, 3, 4))
        for decoder, skip in zip(self.decoders, skips[1:]):
            x = decoder(torch.cat([skip, F.interpolate(x, scale_factor=2, mode="nearest")], 1))
        return self.final_conv(x).permute(0, 2, 3, 4, 1).contiguous(), glob

    def forward(self, voxel):
        run = (self._one if not torch.is_grad_enabled() else
               lambda v: checkpoint(self._one, v, use_reentrant=False))
        parts = [run(voxel[i:i + 1]) for i in range(voxel.shape[0])]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


# ---------------------------------------------------------------------------
# the progressive discriminator
# ---------------------------------------------------------------------------

IMG_SIZE_TO_LAYER = {2: 8, 4: 7, 8: 6, 16: 5, 32: 4, 64: 3, 128: 2, 256: 1, 512: 0}
PROG_CHANNELS = (32, 64, 128, 256, 400, 400, 400, 400)
ADAPTER_CHANNELS = (16, 32, 64, 128, 256, 400, 400, 400, 400)


def add_coords(x):
    B, _, H, W = x.shape
    rows = torch.linspace(-1.0, 1.0, H, device=x.device)
    cols = torch.linspace(-1.0, 1.0, W, device=x.device)
    return torch.cat([x, rows[None, None, :, None].expand(B, 1, H, W),
                      cols[None, None, None, :].expand(B, 1, H, W)], dim=1)


class AdapterBlock(nn.Module):
    def __init__(self, c_in, c_out, q=exact):
        super().__init__()
        self.conv = Conv(2, c_in, c_out, 1, 0, q)

    def forward(self, x):
        return F.leaky_relu(self.conv(x), 0.2)


class ResidualCoordConvBlock(nn.Module):
    def __init__(self, c_in, c_out, q=exact):
        super().__init__()
        self.conv1 = Conv(2, c_in + 2, c_out, 3, 1, q)
        self.conv2 = Conv(2, c_out + 2, c_out, 3, 1, q)
        self.proj = Conv(2, c_in, c_out, 1, 0, q) if c_in != c_out else None

    def forward(self, x):
        y = F.leaky_relu(self.conv1(add_coords(x)), 0.2)
        y = F.avg_pool2d(F.leaky_relu(self.conv2(add_coords(y)), 0.2), 2)
        identity = F.avg_pool2d(x, 2)
        if self.proj is not None:
            identity = self.proj(identity)
        return (y + identity) / math.sqrt(2.0)


class ProgressiveDiscriminator(nn.Module):
    """NHWC images and the fade-in alpha -> logits (B, 1)."""

    def __init__(self, q=exact):
        super().__init__()
        self.fromRGB = nn.ModuleList([AdapterBlock(3, c, q) for c in ADAPTER_CHANNELS])
        self.layers = nn.ModuleList([ResidualCoordConvBlock(ADAPTER_CHANNELS[i], c, q)
                                     for i, c in enumerate(PROG_CHANNELS)])
        self.final_layer = Conv(2, PROG_CHANNELS[-1], 1, 2, 0, q)

    def forward(self, img, alpha):
        img = img.permute(0, 3, 1, 2)
        start = IMG_SIZE_TO_LAYER[img.shape[-1]]
        x = self.fromRGB[start](img)
        for i, layer in enumerate(self.layers[start:]):
            if i == 1:
                x = alpha * x + (1.0 - alpha) * self.fromRGB[start + 1](img[:, :, ::2, ::2])
            x = layer(x)
        x = self.final_layer(x)
        return x.reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# losses, optimizer, the train step
# ---------------------------------------------------------------------------


class ClippedAdam(torch.optim.Adam):
    """Global-norm clip, then Adam (eps 1e-8); a parameter without a grad
    takes a zero grad."""

    def __init__(self, params, *, lr, betas, grad_clip):
        super().__init__(params, lr=lr, betas=tuple(float(b) for b in betas), eps=1e-8)
        self.grad_clip = grad_clip

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = torch.sqrt(sum((p.grad ** 2).sum() for p in params))
        keep = norm < self.grad_clip
        for p in params:
            p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * self.grad_clip))
        return super().step(closure)


def make_optimizer(module, lr, betas, grad_clip):
    scaled, rest = [], []
    for name, p in module.named_parameters():
        (scaled if "mapping_network" in name.split(".") else rest).append(p)
    groups = [{"params": rest}] + ([{"params": scaled, "lr": lr}] if scaled else [])
    return ClippedAdam(groups, lr=lr, betas=betas, grad_clip=grad_clip)


class TrainStep:
    """One D step (with a discriminator: softplus losses plus R1 on the real
    images) then one G/E step (softplus G loss with a discriminator, the
    photometric MSE, z_reg), each optimizer clipped to its global norm; the
    G/E step takes the batch in `batch_split` equal parts, one after the
    other, summing their gradients, then scales them by grad_accum_scale /
    batch_split. `step` holds the step's settings: the render dict,
    r1_lambda, z_reg_weight, batch_split, grad_accum_scale, lrs, betas,
    grad_clip, cam_r_start, cam_r_end, random_gen_img, photo_loss, encoder
    ("pcl" or "voxel")."""

    def __init__(self, G, E, D, step: dict):
        self.G, self.E, self.D, self.s = G, E, D, step
        opt = dict(betas=step["betas"], grad_clip=step["grad_clip"])
        self.opt_G = make_optimizer(G, step["gen_lr"], **opt)
        self.opt_E = make_optimizer(E, step["enc_lr"], **opt)
        self.opt_D = make_optimizer(D, step["disc_lr"], **opt) if D is not None else None

    def encode(self, batch):
        if self.s["encoder"] == "pcl":
            return encode_pcl(self.E, batch["pcl"])
        return self.E(batch["voxel"]), torch.zeros((), device=batch["voxel"].device)

    def __call__(self, batch, generator, alpha):
        s, render = self.s, self.s["render"]
        metrics = {}
        real = batch["img"]
        B = real.shape[0]
        if self.D is not None:
            if s["random_gen_img"]:
                origins = sample_camera_positions(B, generator, s["cam_r_start"],
                                                  s["cam_r_end"], real.device)
                cams = create_cam2world_matrix(origins)
            else:
                cams = batch["cam2world"]
            with torch.no_grad():
                z, _ = self.encode(batch)
                fake, _ = self.G(z, cams, render, generator)
            real = real.detach().requires_grad_(True)
            r_logits = self.D(real, alpha)
            loss = F.softplus(self.D(fake, alpha)).mean() + F.softplus(-r_logits).mean()
            (g,) = torch.autograd.grad(r_logits.sum(), real, create_graph=True)
            loss = loss + s["r1_lambda"] * (0.5 * g.reshape(B, -1).pow(2).sum(1).mean())
            self.opt_D.zero_grad(set_to_none=True)
            loss.backward()
            self.opt_D.step()
            metrics["d_loss"] = loss.detach()
        self.opt_G.zero_grad(set_to_none=True)
        self.opt_E.zero_grad(set_to_none=True)
        k = s["batch_split"]
        b = B // k
        zero = torch.zeros((), device=real.device)
        sums = {"g_loss": zero, "photo_loss": zero, "z_reg": zero}
        for i in range(k):
            part = {key: v[i * b:(i + 1) * b] for key, v in batch.items()}
            z, z_reg = self.encode(part)
            imgs, _ = self.G(z, part["cam2world"], render, generator)
            if self.D is not None:
                self.D.requires_grad_(False)
                g_loss = F.softplus(-self.D(imgs, alpha)).mean()
                self.D.requires_grad_(True)
            else:
                g_loss = zero
            photo = ((part["img"] - imgs) ** 2).mean() if s["photo_loss"] else zero
            (g_loss + photo + z_reg * s["z_reg_weight"]).backward()
            for name, value in (("g_loss", g_loss), ("photo_loss", photo), ("z_reg", z_reg)):
                sums[name] = sums[name] + value.detach()
        scale = s["grad_accum_scale"] / k
        if scale != 1:
            for p in (*self.G.parameters(), *self.E.parameters()):
                if p.grad is not None:
                    p.grad.mul_(scale)
        self.opt_G.step()
        self.opt_E.step()
        metrics.update({name: v / k for name, v in sums.items()})
        return metrics
