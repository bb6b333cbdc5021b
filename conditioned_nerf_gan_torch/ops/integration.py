"""Volume rendering integrator (port of conditioned_nerf_gan_tpu/ops/integration.py).

Keeps the 1e10 tail delta, density noise (`noise=` injection or a
`torch.Generator`), relu/softplus clamping, the +1e-10 exclusive
transmittance cumprod, and the last_back / white_back / fill_mode options.
The cumprod's factors are never zero, so its backward skips torch's test
for zeros, a wait on the device (`cumprod_of_nonzeros`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _CumprodOfNonzeros(torch.autograd.Function):
    """`torch.cumprod` whose backward is torch's own for an input without
    zeros, `flip(cumsum(flip(out * g))) / x`, less its test of the input
    for zeros, which reads a device flag on the host and so waits for the
    stream in every ray chunk's backward."""

    @staticmethod
    def forward(ctx, x, dim):
        out = torch.cumprod(x, dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        w = out * g
        return w.flip(ctx.dim).cumsum(ctx.dim).flip(ctx.dim).div(x), None


def cumprod_of_nonzeros(x: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.cumprod(x, dim) for an x without zeros (the transmittance's
    factors, each at least 1e-10), differentiated without a wait."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CumprodOfNonzeros.apply(x, dim)
    return torch.cumprod(x, dim)


def volume_integrate(rgb_sigma: torch.Tensor, z_vals: torch.Tensor, *,
                     noise_std: float = 0.0,
                     generator: torch.Generator | None = None,
                     noise: torch.Tensor | None = None,
                     last_back: bool = False, white_back: bool = False,
                     clamp_mode: str = "relu", fill_mode: str | None = None):
    """Composite per-sample (rgb, sigma) into pixel colors and expected depth.

    rgb_sigma (B, R, S, 4), z_vals (B, R, S, 1) sorted. Density noise of
    `noise_std` is added whenever a source (generator or `noise` with
    sigma's shape) is given. Returns rgb (B, R, 3), depth (B, R, 1),
    weights (B, R, S, 1).
    """
    rgbs = rgb_sigma[..., :3]
    sigmas = rgb_sigma[..., 3:]

    deltas = z_vals[:, :, 1:] - z_vals[:, :, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :, :1], 1e10)], dim=-2)

    if noise is None and generator is not None:
        noise = torch.randn(sigmas.shape, generator=generator,
                            dtype=sigmas.dtype, device=sigmas.device)
    if noise is not None:
        sigmas = sigmas + noise * noise_std

    if clamp_mode == "softplus":
        density = F.softplus(sigmas)
    elif clamp_mode == "relu":
        density = F.relu(sigmas)
    else:
        raise ValueError(f"Unknown clamp_mode {clamp_mode!r}")

    alphas = 1.0 - torch.exp(-deltas * density)
    shifted = torch.cat([torch.ones_like(alphas[:, :, :1]), 1.0 - alphas + 1e-10],
                        dim=-2)
    transmittance = cumprod_of_nonzeros(shifted, -2)[:, :, :-1]
    weights = alphas * transmittance
    weights_sum = weights.sum(dim=2)

    if last_back:
        weights = weights.clone()
        weights[:, :, -1] += 1.0 - weights_sum

    rgb_final = torch.sum(weights * rgbs, dim=-2)
    depth_final = torch.sum(weights * z_vals, dim=-2)

    if white_back:
        rgb_final = rgb_final + 1.0 - weights_sum

    if fill_mode == "debug":
        low = weights_sum[..., -1] < 0.9
        red = torch.tensor([1.0, 0.0, 0.0], dtype=rgb_final.dtype,
                           device=rgb_final.device)
        rgb_final = torch.where(low[..., None], red, rgb_final)
    elif fill_mode == "weight":
        rgb_final = weights_sum.expand(rgb_final.shape)

    return rgb_final, depth_final, weights
