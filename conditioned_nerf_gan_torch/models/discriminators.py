"""Progressive-growing GAN discriminator (port of
conditioned_nerf_gan_tpu/models/discriminators.py:35-237).

Images are NHWC at the public boundary, as in the JAX package; the module
permutes to NCHW once and runs torch's convolutions there. Convolutions keep
the torch-default init U(+-1/sqrt(fan_in)) for kernel and bias. Every
adapter and layer holds parameters, so one parameter set serves every stage;
the entry layer follows the input resolution, and the fade-in blend is
applied unconditionally (identical at alpha 1). fp32: the JAX package's bf16
D policy is not ported (ROADMAP A).
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
    U(+-1/sqrt(in * k * k)), torch's default."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 0, *, generator: torch.Generator | None = None):
        super().__init__()
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, padding=self.padding)


def add_coords(x: torch.Tensor) -> torch.Tensor:
    """Append two coordinate channels in [-1, 1] to NCHW x: the first varies
    along H, the second along W."""
    B, _, H, W = x.shape
    rows = torch.linspace(-1.0, 1.0, H, dtype=x.dtype, device=x.device)
    cols = torch.linspace(-1.0, 1.0, W, dtype=x.dtype, device=x.device)
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
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 1, generator=generator)

    def forward(self, x):
        return F.leaky_relu(self.conv(x), 0.2)


class ResidualCoordConvBlock(nn.Module):
    """Two CoordConvs + optional avg-pool downsample + residual / sqrt(2)."""

    def __init__(self, in_channels: int, features: int, downsample: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.downsample = downsample
        self.conv1 = Conv2d(in_channels + 2, features, 3, padding=1, generator=generator)
        self.conv2 = Conv2d(features + 2, features, 3, padding=1, generator=generator)
        self.proj = (Conv2d(in_channels, features, 1, generator=generator)
                     if in_channels != features else None)

    def forward(self, x):
        y = F.leaky_relu(self.conv1(add_coords(x)), 0.2)
        y = F.leaky_relu(self.conv2(add_coords(y)), 0.2)
        identity = x
        if self.downsample:
            y = avg_pool_2x(y)
            identity = avg_pool_2x(identity)
        if self.proj is not None:
            identity = self.proj(identity)
        return (y + identity) / math.sqrt(2.0)


class ProgressiveDiscriminator(nn.Module):
    """Scalar-logit progressive discriminator: NHWC images (B, S, S, C) and
    the fade-in alpha -> logits (B, 1)."""

    def __init__(self, input_channels: int = 3, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fromRGB = nn.ModuleList(
            [AdapterBlock(input_channels, c, generator=generator)
             for c in _ADAPTER_CHANNELS])
        self.layers = nn.ModuleList(
            [ResidualCoordConvBlock(_ADAPTER_CHANNELS[i], c, downsample=True,
                                    generator=generator)
             for i, c in enumerate(_PROG_CHANNELS)])
        self.final_layer = Conv2d(_PROG_CHANNELS[-1], 1, 2, generator=generator)

    def forward(self, img: torch.Tensor, alpha, cond=None) -> torch.Tensor:
        img = img.permute(0, 3, 1, 2)
        start = IMG_SIZE_TO_LAYER[img.shape[-1]]
        x = self.fromRGB[start](img)
        for i, layer in enumerate(self.layers[start:]):
            if i == 1:
                x = alpha * x + (1.0 - alpha) * self.fromRGB[start + 1](
                    downsample_nearest_2x(img))
            x = layer(x)
        return self.final_layer(x).reshape(x.shape[0], 1)


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
