"""3-D U-Net voxel encoder (port of conditioned_nerf_gan_tpu/models/unet3d.py).

`UNet3D`: DoubleConv blocks, max-pool down, nearest-neighbour 2x up and a
skip concat, the `return_global` bottleneck mean and an fp32 1x1 final conv.
The voxel grid and the feature volume are channel-last (B, D, H, W, C) at
the module's boundary, as in the JAX package; inside, the convolutions run
channel-first with `F.conv3d` (cuDNN on the card: the JAX package leaves
these convs to XLA too, outside any Pallas kernel). Whether cuDNN may use
TF32 for fp32 convs is the process's `torch.backends.cudnn.allow_tf32`
(PyTorch's default is on; chip_smoke.py turns it off). `PyramidUNet3D` and
`ResidualUNet3D` (ExtResNetBlock, ConvTranspose3d) are ROADMAP A12.

`compute_dtype` is the JAX U-Net's `dtype`, the presets' bf16 policy: each
block conv casts its input and kernel to it and adds its bias in it, so the
ReLUs, max-pools, upsampling and skips run in it; GroupNorm takes its input
in fp32 and returns fp32, as flax's does with fp32 params (`F.group_norm`
on a bf16 tensor would return bf16), so with order 'gcr' each SingleConv
goes fp32 -> bf16. The `return_global` mean is taken in fp32 and the 1x1
`final_conv` runs in fp32, so the feature volume handed to the trilinear
lookup is fp32. Params stay fp32. `None` is the fp32 path.

Module names follow the flax tree (`bridge.py` maps encoder_i -> encoders.i,
decoder_i -> decoders.i, SingleConv1/2 -> conv1/2, groupnorm -> norm).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def number_of_features_per_level(init_channels: int, num_levels: int) -> list[int]:
    return [init_channels * 2 ** k for k in range(num_levels)]


class Conv3d(nn.Module):
    """3-D convolution with torch-default init: W, b ~ U(+-1/sqrt(fan_in)),
    fan_in = C_in * k^3 (the JAX `_torch_conv_init`). NCDHW inside. Under a
    `compute_dtype` the input and kernel are cast to it and the bias is
    added in it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 1, use_bias: bool = True,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = kernel_size
        self.padding = padding
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        bound = 1.0 / math.sqrt(in_channels * k ** 3)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return F.conv3d(x, self.weight, self.bias, padding=self.padding)
        y = F.conv3d(x.to(dt), self.weight.to(dt), padding=self.padding)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None, None]


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32 if it is narrower (bf16), else as it is."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` on its input promoted to at least fp32, returning
    that dtype: flax's GroupNorm with fp32 params promotes a bf16 input so."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(at_least_fp32(x))


class SingleConv(nn.Sequential):
    """One conv with norm and non-linearity in the order DSL ('gcr' =
    GroupNorm -> Conv -> ReLU); the conv drops its bias under a norm.
    GroupNorm takes `num_groups` groups, or 1 where the channels are fewer.
    The presets use 'gcr' only; the DSL's other letters (l, e, b) are not
    ported."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "gcr",
                 num_groups: int = 8, kernel_size: int = 3, padding: int = 1,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        channels = in_channels
        for char in order:
            if char == "r":
                self.add_module("relu", nn.ReLU())
            elif char == "c":
                self.add_module("conv", Conv3d(channels, out_channels, kernel_size, padding,
                                               use_bias="g" not in order,
                                               compute_dtype=compute_dtype,
                                               generator=generator))
                channels = out_channels
            elif char == "g":
                groups = num_groups if channels >= num_groups else 1
                self.add_module("norm", GroupNorm(groups, channels, eps=1e-5))
            else:
                raise NotImplementedError(
                    f"layer order {order!r}: {char!r} is not ported yet (ROADMAP A12)")


class DoubleConv(nn.Module):
    """Two SingleConvs; an encoder block's first conv goes to
    max(out_channels // 2, in_channels)."""

    def __init__(self, in_channels: int, out_channels: int, encoder: bool,
                 order: str = "gcr", num_groups: int = 8, kernel_size: int = 3,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        mid = max(out_channels // 2, in_channels) if encoder else out_channels
        conv = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv1 = SingleConv(in_channels, mid, order, num_groups, kernel_size, **conv)
        self.conv2 = SingleConv(mid, out_channels, order, num_groups, kernel_size, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


def max_pool_3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.max_pool3d(x, window, window)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class AbstractUNet3D(nn.Module):
    """Encoder (max-pool + DoubleConv per level), decoder (nearest 2x up,
    concat [skip, x], DoubleConv), fp32 1x1 final conv. Takes a (B, D, H, W,
    in_channels) grid; returns the fp32 (B, D, H, W, out_channels) feature
    volume (contiguous), and with `return_global` the (B, f_maps[-1]) fp32
    mean of the bottleneck as well."""

    def __init__(self, in_channels: int, out_channels: int, f_maps=64,
                 layer_order: str = "gcr", num_groups: int = 8, num_levels: int = 4,
                 return_global: bool = False, compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels)
        self.return_global = return_global
        block = dict(order=layer_order, num_groups=num_groups, compute_dtype=compute_dtype,
                     generator=generator)
        ins = [in_channels] + list(f_maps[:-1])
        self.encoders = nn.ModuleList([
            DoubleConv(c_in, c_out, True, **block) for c_in, c_out in zip(ins, f_maps)])
        ups = list(reversed(f_maps))
        self.decoders = nn.ModuleList([
            DoubleConv(skip + x, skip, False, **block)
            for x, skip in zip(ups[:-1], ups[1:])])
        self.final_conv = Conv3d(f_maps[0], out_channels, kernel_size=1, padding=0,
                                 generator=generator)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 4, 1, 2, 3)  # NDHWC -> NCDHW
        skips = []
        for i, encoder in enumerate(self.encoders):
            if i > 0:
                x = max_pool_3d(x)
            x = encoder(x)
            skips.insert(0, x)
        if self.return_global:
            global_features = at_least_fp32(x).mean(dim=(2, 3, 4))
        for decoder, skip in zip(self.decoders, skips[1:]):
            x = decoder(torch.cat([skip.to(x.dtype), upsample_nearest_2x(x)], dim=1))
        volume = self.final_conv(at_least_fp32(x)).permute(0, 2, 3, 4, 1).contiguous()  # NDHWC
        if self.return_global:
            return volume, global_features
        return volume


def make_unet(type: str = "UNet3D", *, in_channels: int, out_channels: int,
              f_maps=64, layer_order: str = "gcr", num_groups: int = 8,
              num_levels: int = 4, return_global: bool = False,
              compute_dtype: torch.dtype | None = None,
              generator: torch.Generator | None = None,
              **_unused) -> AbstractUNet3D:
    """Build a U-Net by reference class name (`metadata['unet']['type']`).
    The segmentation head (`is_segmentation` with `testing`), which no
    preset turns on, is not ported."""
    if type in ("PyramidUNet3D", "ResidualUNet3D"):
        raise NotImplementedError(f"{type} is not ported yet (ROADMAP A12)")
    if type != "UNet3D":
        raise ValueError(f"Unknown unet type {type!r}")
    return AbstractUNet3D(in_channels, out_channels, f_maps, layer_order, num_groups,
                          num_levels, return_global, compute_dtype=compute_dtype,
                          generator=generator)
