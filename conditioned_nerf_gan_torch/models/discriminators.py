"""Progressive-growing GAN discriminator (port of
conditioned_nerf_gan_tpu/models/discriminators.py:35-237).

Images are NHWC at the public boundary, as in the JAX package; the module
permutes to NCHW once and runs torch's convolutions there. Convolutions keep
the torch-default init U(+-1/sqrt(fan_in)) for kernel and bias. Every
adapter and layer holds parameters, so one parameter set serves every stage;
the entry layer follows the input resolution, and the fade-in blend is
applied unconditionally (identical at alpha 1).

`compute_dtype` is the JAX D's `dtype`, the presets' bf16 policy (the
reference's autocast D step): each convolution casts its input and kernel
to it and adds the bias in it, so the activations, coordinate channels,
pools, residual adds and the fade-in blend stay bf16; the logits come back
in fp32. Params stay fp32. `None` is the fp32 path.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

IMG_SIZE_TO_LAYER = {2: 8, 4: 7, 8: 6, 16: 5, 32: 4, 64: 3, 128: 2, 256: 1, 512: 0}
_PROG_CHANNELS = (32, 64, 128, 256, 400, 400, 400, 400)
_ADAPTER_CHANNELS = (16, 32, 64, 128, 256, 400, 400, 400, 400)


class Conv2d(nn.Module):
    """NCHW convolution; weight (out, in, k, k) and bias both drawn from
    U(+-1/sqrt(in * k * k)), torch's default. Under a `compute_dtype` the
    input and kernel are cast to it and the bias is added in it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 0, *, compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.padding = padding
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return F.conv2d(x, self.weight, self.bias, padding=self.padding)
        y = F.conv2d(x.to(dt), self.weight.to(dt), padding=self.padding)
        return y + self.bias.to(dt)[:, None, None]


def in_dtype(value: float, x: torch.Tensor) -> float:
    """`value` rounded to x's dtype: a Python scalar in a JAX expression
    with a bf16 array is a bf16 operand (0.2 -> 0.2001953125)."""
    if x.dtype == torch.float32:
        return value
    return float(torch.tensor(value, dtype=x.dtype))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, in_dtype(0.2, x))


def linspace(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """n points from -1 to 1 in `dtype`: `torch.linspace` in fp32, else
    `jnp.linspace`'s formula, each operation rounded to `dtype` (in bf16
    `torch.linspace` rounds 25 of 64 points otherwise)."""
    if dtype == torch.float32 or n < 2:
        return torch.linspace(-1.0, 1.0, n, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    step = torch.arange(n - 1, dtype=dtype, device=device) / (one * (n - 1))
    return torch.cat([-one * (one - step) + one * step, one[None]])


def add_coords(x: torch.Tensor) -> torch.Tensor:
    """Append two coordinate channels in [-1, 1] to NCHW x, in x's dtype:
    the first varies along H, the second along W."""
    B, _, H, W = x.shape
    rows = linspace(H, x.dtype, x.device)
    cols = linspace(W, x.dtype, x.device)
    xx = rows[None, None, :, None].expand(B, 1, H, W)
    yy = cols[None, None, None, :].expand(B, 1, H, W)
    return torch.cat([x, xx, yy], dim=1)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


def downsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=0.5, mode='nearest') == stride-2 slice."""
    return x[:, :, ::2, ::2]


class AdapterBlock(nn.Module):
    """1x1 conv + LeakyReLU(0.2) fromRGB adapter."""

    def __init__(self, in_channels: int, features: int, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 1, compute_dtype=compute_dtype,
                           generator=generator)

    def forward(self, x):
        return leaky_relu(self.conv(x))


class ResidualCoordConvBlock(nn.Module):
    """Two CoordConvs + optional avg-pool downsample + residual / sqrt(2)."""

    def __init__(self, in_channels: int, features: int, downsample: bool = False, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.downsample = downsample
        conv = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv1 = Conv2d(in_channels + 2, features, 3, padding=1, **conv)
        self.conv2 = Conv2d(features + 2, features, 3, padding=1, **conv)
        self.proj = (Conv2d(in_channels, features, 1, **conv)
                     if in_channels != features else None)

    def forward(self, x):
        y = leaky_relu(self.conv1(add_coords(x)))
        y = leaky_relu(self.conv2(add_coords(y)))
        identity = x
        if self.downsample:
            y = avg_pool_2x(y)
            identity = avg_pool_2x(identity)
        if self.proj is not None:
            identity = self.proj(identity)
        return (y + identity.to(y.dtype)) / in_dtype(math.sqrt(2.0), y)


class ProgressiveDiscriminator(nn.Module):
    """Scalar-logit progressive discriminator: NHWC images (B, S, S, C) and
    the fade-in alpha -> fp32 logits (B, 1)."""

    def __init__(self, input_channels: int = 3, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        conv = dict(compute_dtype=compute_dtype, generator=generator)
        self.fromRGB = nn.ModuleList(
            [AdapterBlock(input_channels, c, **conv) for c in _ADAPTER_CHANNELS])
        self.layers = nn.ModuleList(
            [ResidualCoordConvBlock(_ADAPTER_CHANNELS[i], c, downsample=True, **conv)
             for i, c in enumerate(_PROG_CHANNELS)])
        self.final_layer = Conv2d(_PROG_CHANNELS[-1], 1, 2, **conv)

    def forward(self, img: torch.Tensor, alpha, cond=None) -> torch.Tensor:
        img = img.permute(0, 3, 1, 2)
        start = IMG_SIZE_TO_LAYER[img.shape[-1]]
        if self.compute_dtype is not None:
            # the blend in the policy dtype: an fp32 alpha would upcast it
            alpha = torch.as_tensor(alpha, dtype=self.compute_dtype, device=img.device)
        x = self.fromRGB[start](img)
        for i, layer in enumerate(self.layers[start:]):
            if i == 1:
                x = alpha * x + (1.0 - alpha) * self.fromRGB[start + 1](
                    downsample_nearest_2x(img))
            x = layer(x)
        return self.final_layer(x).reshape(x.shape[0], 1).float()


_NOT_PORTED = (
    "ProgressiveEncoderDiscriminator",
    "ProgressiveDiscriminator_inputCat",
    "ProgressiveDiscriminator_projection",
    "StridedDiscriminator",
    "CCSDiscriminator",
    "CCSEncoderDiscriminator",
)


def make_discriminator(name: str, **kwargs) -> nn.Module:
    """Build a discriminator by reference class name."""
    if name == "ProgressiveDiscriminator":
        return ProgressiveDiscriminator(**kwargs)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP A13)")
    raise ValueError(f"Unknown discriminator {name!r}")
