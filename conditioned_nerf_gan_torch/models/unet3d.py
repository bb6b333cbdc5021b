"""3-D U-Net voxel encoders (port of conditioned_nerf_gan_tpu/models/unet3d.py).

  * `UNet3D`: DoubleConv blocks, max-pool down, nearest-neighbour 2x up and
    a skip concat, an fp32 1x1 final conv;
  * `PyramidUNet3D`: the same, returning every decoder level (coarse first,
    fp32, no final conv) instead of the final volume: at f_maps 32 and 4
    levels on 64^3 grids, 16^3 x 128, 32^3 x 64 and 64^3 x 32;
  * `ResidualUNet3D` (5 levels by default): ExtResNetBlocks, a transposed
    conv (k 3, stride 2, padding 1, output_padding 1) up and a skip sum.
Each takes the `return_global` bottleneck mean, and `is_segmentation` with
`testing` puts a sigmoid (`final_sigmoid`) or a softmax over the channels on
the final conv. The voxel grid and the feature volumes are channel-last
(B, D, H, W, C) at the module's boundary, as in the JAX package; inside, the
convolutions run channel-first with `F.conv3d` / `F.conv_transpose3d`
(cuDNN on the card: the JAX package leaves these convs to XLA too, outside
any Pallas kernel). Whether cuDNN may use TF32 for fp32 convs is the
process's `torch.backends.cudnn.allow_tf32` (PyTorch's default is on;
chip_smoke.py turns it off).

`compute_dtype` is the JAX U-Net's `dtype`, the presets' bf16 policy: each
block conv casts its input and kernel to it and adds its bias in it, so the
ReLUs, max-pools, upsampling and skips run in it; GroupNorm takes its input
in fp32 and returns fp32, as flax's does with fp32 params (`F.group_norm`
on a bf16 tensor would return bf16), so with order 'gcr' each SingleConv
goes fp32 -> bf16. The `return_global` mean is taken in fp32 and the 1x1
`final_conv` runs in fp32, so the feature volume handed to the trilinear
lookup is fp32. Params stay fp32. `None` is the fp32 path.

Module names follow the flax tree (`bridge.py` maps encoder_i -> encoders.i,
decoder_i -> decoders.i, upconv_i -> upconvs.i, SingleConv1/2 -> conv1/2,
groupnorm -> norm; an ExtResNetBlock's conv1/2/3 and a SingleConv's
`batchnorm` keep their names).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .discriminators import in_dtype


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


class ConvTranspose3d(nn.Module):
    """torch ConvTranspose3d(k, stride 2, padding 1, output_padding 1): an
    exact 2x upsampling, with the JAX layer's init W, b ~ U(+-1/sqrt(C_out
    k^3)). The weight is (C_in, C_out, k, k, k); the JAX kernel (k, k, k,
    C_in, C_out) maps onto it by a transpose alone (its spatial flip inside
    the call is what conv_transpose3d does). Under a `compute_dtype` the
    input and kernel are cast to it and the bias is added in it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = kernel_size
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))
        bound = 1.0 / math.sqrt(out_channels * k ** 3)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        y = F.conv_transpose3d(x.to(dt), self.weight.to(dt), stride=2, padding=1,
                               output_padding=1)
        return y + self.bias.to(y.dtype)[:, None, None, None]


def activation(char: str, x: torch.Tensor) -> torch.Tensor:
    """The order DSL's non-linearities: r ReLU, l LeakyReLU(0.1) (its slope
    rounded to x's dtype, as a Python scalar in a JAX bf16 expression is),
    e ELU."""
    if char == "l":
        return F.leaky_relu(x, in_dtype(0.1, x))
    if char == "e":
        return F.elu(x)
    return F.relu(x)


class Activation(nn.Module):
    def __init__(self, char: str):
        super().__init__()
        self.char = char

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return activation(self.char, x)


class SingleConv(nn.Sequential):
    """One conv with norm and non-linearity in the order DSL ('gcr' =
    GroupNorm -> Conv -> ReLU): c conv, g GroupNorm of `num_groups` groups
    (1 where the channels are fewer), b a GroupNorm of one group a channel
    (the JAX `batchnorm`: statistics per sample and channel, no running
    stats), r ReLU, l LeakyReLU(0.1), e ELU; the conv drops its bias under
    a norm."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "gcr",
                 num_groups: int = 8, kernel_size: int = 3, padding: int = 1,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        names = {"r": "relu", "l": "leaky_relu", "e": "elu"}
        has_norm = "g" in order or "b" in order
        channels = in_channels
        for char in order:
            if char in names:
                self.add_module(names[char], Activation(char))
            elif char == "c":
                self.add_module("conv", Conv3d(channels, out_channels, kernel_size, padding,
                                               use_bias=not has_norm,
                                               compute_dtype=compute_dtype,
                                               generator=generator))
                channels = out_channels
            elif char == "g":
                groups = num_groups if channels >= num_groups else 1
                self.add_module("norm", GroupNorm(groups, channels, eps=1e-5))
            elif char == "b":
                self.add_module("batchnorm", GroupNorm(channels, channels, eps=1e-5))
            else:
                raise ValueError(f"Unsupported layer char {char!r}")


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


class ExtResNetBlock(nn.Module):
    """conv1, then conv2 and conv3 (conv3's order without r, e and l) on its
    output, conv1's output added back, then the order's activation (l, else
    e, else ReLU)."""

    def __init__(self, in_channels: int, out_channels: int, order: str = "cge",
                 num_groups: int = 8, kernel_size: int = 3,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        conv = dict(compute_dtype=compute_dtype, generator=generator)
        self.order = order
        self.conv1 = SingleConv(in_channels, out_channels, order, num_groups, kernel_size,
                                **conv)
        self.conv2 = SingleConv(out_channels, out_channels, order, num_groups, kernel_size,
                                **conv)
        plain = "".join(c for c in order if c not in "rel")
        self.conv3 = SingleConv(out_channels, out_channels, plain, num_groups, kernel_size,
                                **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.conv1(x)
        out = self.conv3(self.conv2(residual))
        out = out + residual.to(out.dtype)
        return activation("l" if "l" in self.order else "e" if "e" in self.order else "r",
                          out)


def max_pool_3d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    return F.max_pool3d(x, window, window)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


class AbstractUNet3D(nn.Module):
    """Encoder (max-pool + block per level), decoder (up, skip, block) and
    the fp32 1x1 final conv; the block is a DoubleConv (up: nearest 2x and
    a concat [skip, x]) or, `residual`, an ExtResNetBlock (up: a transposed
    conv and a sum skip + x). Takes a (B, D, H, W, in_channels) grid;
    returns the fp32 (B, D, H, W, out_channels) feature volume (contiguous)
    or, `pyramid`, the list of every decoder level's output, coarse first,
    each fp32 (B, d, h, w, c) contiguous (no final conv is made); with
    `return_global` the (B, f_maps[-1]) fp32 mean of the bottleneck as
    well."""

    def __init__(self, in_channels: int, out_channels: int, f_maps=64,
                 layer_order: str = "gcr", num_groups: int = 8, num_levels: int = 4,
                 residual: bool = False, pyramid: bool = False,
                 return_global: bool = False, is_segmentation: bool = False,
                 final_sigmoid: bool = False, testing: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if isinstance(f_maps, int):
            f_maps = number_of_features_per_level(f_maps, num_levels)
        self.residual, self.pyramid = residual, pyramid
        self.return_global = return_global
        self.head = None
        if is_segmentation and testing:
            self.head = "sigmoid" if final_sigmoid else "softmax"
        conv = dict(compute_dtype=compute_dtype, generator=generator)
        block = dict(order=layer_order, num_groups=num_groups, **conv)
        ins = [in_channels] + list(f_maps[:-1])
        ups = list(reversed(f_maps))
        if residual:
            # the reference forwards its layer_order to ExtResNetBlock, over
            # that class's "cge" default
            self.encoders = nn.ModuleList([
                ExtResNetBlock(c_in, c_out, **block) for c_in, c_out in zip(ins, f_maps)])
            self.upconvs = nn.ModuleList([
                ConvTranspose3d(x, skip, **conv) for x, skip in zip(ups[:-1], ups[1:])])
            self.decoders = nn.ModuleList([ExtResNetBlock(skip, skip, **block)
                                           for skip in ups[1:]])
        else:
            self.encoders = nn.ModuleList([
                DoubleConv(c_in, c_out, True, **block) for c_in, c_out in zip(ins, f_maps)])
            self.decoders = nn.ModuleList([
                DoubleConv(skip + x, skip, False, **block)
                for x, skip in zip(ups[:-1], ups[1:])])
        if not pyramid:
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
        levels = []
        for i, (decoder, skip) in enumerate(zip(self.decoders, skips[1:])):
            if self.residual:
                x = self.upconvs[i](x)
                x = skip.to(x.dtype) + x
            else:
                x = torch.cat([skip.to(x.dtype), upsample_nearest_2x(x)], dim=1)
            x = decoder(x)
            if self.pyramid:
                levels.append(_ndhwc(at_least_fp32(x)))
        if self.pyramid:
            return (levels, global_features) if self.return_global else levels
        x = self.final_conv(at_least_fp32(x))
        if self.head == "sigmoid":
            x = torch.sigmoid(x)
        elif self.head == "softmax":
            x = torch.softmax(x, dim=1)  # over the channels (NCDHW here)
        volume = _ndhwc(x)
        if self.return_global:
            return volume, global_features
        return volume


UNET_TYPES = ("UNet3D", "PyramidUNet3D", "ResidualUNet3D")


def make_unet(type: str = "UNet3D", *, in_channels: int, out_channels: int,
              f_maps=64, layer_order: str = "gcr", num_groups: int = 8,
              num_levels: int | None = None, return_global: bool = False,
              is_segmentation: bool = False, final_sigmoid: bool = False,
              testing: bool = False, compute_dtype: torch.dtype | None = None,
              generator: torch.Generator | None = None,
              **_unused) -> AbstractUNet3D:
    """Build a U-Net by reference class name (`metadata['unet']['type']`):
    UNet3D and PyramidUNet3D default to 4 levels, ResidualUNet3D to 5."""
    if type not in UNET_TYPES:
        raise ValueError(f"Unknown unet type {type!r}")
    residual = type == "ResidualUNet3D"
    if num_levels is None:
        num_levels = 5 if residual else 4
    return AbstractUNet3D(in_channels, out_channels, f_maps, layer_order, num_groups,
                          num_levels, residual=residual, pyramid=type == "PyramidUNet3D",
                          return_global=return_global, is_segmentation=is_segmentation,
                          final_sigmoid=final_sigmoid, testing=testing,
                          compute_dtype=compute_dtype, generator=generator)
