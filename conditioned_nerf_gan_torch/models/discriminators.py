"""The GAN discriminators (port of
conditioned_nerf_gan_tpu/models/discriminators.py).

  * `ProgressiveDiscriminator` (`:193-201`): CoordConv residual blocks with
    avg-pool downsampling, a fade-in blend at the second block, a final
    2x2 conv to one logit;
  * `ProgressiveEncoderDiscriminator` (`:240-252`): the same trunk with a
    (1 + 256 + 2)-channel head split into (logit, latent, position), and
    optional instance noise from an explicit generator;
  * `ProgressiveDiscriminatorInputCat` (`:255-271`): the conditioning view
    concatenated on the channel axis (6 input channels);
  * `ProgressiveDiscriminatorProjection` (`:386-412`): the logit is the
    trunk's features, flattened in NCHW order (`:401`), dotted with a
    ResNet18 (train-mode BatchNorm, `:274-383`) of the conditioning view,
    L2-normalised;
  * the legacy strided pi-GAN discriminators (`:415-483`):
    `StridedDiscriminator`, `CCSDiscriminator` (CoordConv) and
    `CCSEncoderDiscriminator`, whose blocks take the kaiming conv init
    (`:42-47`) and which return (pred, latent or None, position or None).

Images are NHWC at the public boundary, as in the JAX package; each module
permutes to NCHW once and runs torch's convolutions there. Convolutions
keep the torch-default init U(+-1/sqrt(fan_in)) for kernel and bias unless
`kaiming`. Every adapter and layer holds parameters, so one parameter set
serves every stage; the entry layer follows the input resolution, and the
fade-in blend is applied unconditionally (identical at alpha 1). The JAX
modules infer their input channels at init; here they are constructor
arguments (3, or 6 for InputCat).

`compute_dtype` is the JAX D's `dtype`, the presets' bf16 policy (the
reference's autocast D step): each convolution casts its input and kernel
to it and adds the bias in it, so the activations, coordinate channels,
pools, residual adds and the fade-in blend stay bf16; the logits come back
in fp32. The ResNet18's BatchNorm takes its statistics in fp32 and casts
back to the input's dtype, and its pooled features and fc head are fp32.
Params stay fp32. `None` is the fp32 path.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

IMG_SIZE_TO_LAYER = {2: 8, 4: 7, 8: 6, 16: 5, 32: 4, 64: 3, 128: 2, 256: 1, 512: 0}
SG_IMG_SIZE_TO_LAYER = {2: 7, 4: 6, 8: 5, 16: 4, 32: 3, 64: 2, 128: 1, 256: 0}
_PROG_CHANNELS = (32, 64, 128, 256, 400, 400, 400, 400)
_ADAPTER_CHANNELS = (16, 32, 64, 128, 256, 400, 400, 400, 400)
_SG_CHANNELS = (64, 128, 256, 400, 400, 400, 400)
_SG_ADAPTERS = (32, 64, 128, 256, 400, 400, 400, 400)
_LEAKY_GAIN = math.sqrt(2.0 / (1.0 + 0.2 ** 2))


class Conv2d(nn.Module):
    """NCHW convolution; weight (out, in, k, k) drawn from U(+-1/sqrt(in * k
    * k)), torch's default, or with `kaiming` from kaiming_normal(a=0.2,
    fan_in, leaky_relu) (the JAX `_kaiming_conv2d_init`); the bias from
    U(+-1/sqrt(in * k * k)) either way. Under a `compute_dtype` the input
    and kernel are cast to it and the bias is added in it."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 0, *, stride: int = 1, kaiming: bool = False,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.padding = padding
        self.stride = stride
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        fan_in = in_channels * kernel_size * kernel_size
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            if kaiming:
                self.weight.normal_(0.0, _LEAKY_GAIN / math.sqrt(fan_in), generator=generator)
            else:
                self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        conv = dict(stride=self.stride, padding=self.padding)
        if dt is None:
            return F.conv2d(x, self.weight, self.bias, **conv)
        y = F.conv2d(x.to(dt), self.weight.to(dt), **conv)
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


class StridedResidualConvBlock(nn.Module):
    """The legacy strided block (conditioned_nerf_gan_tpu/models/
    discriminators.py:157-185): a 3x3 conv, a 3x3 stride-2 conv (both
    kaiming, each after coordinate channels with `coord`), a 1x1 stride-2
    projection of the input, the sum / sqrt(2)."""

    def __init__(self, in_channels: int, features: int, coord: bool = False, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.coord = coord
        conv = dict(compute_dtype=compute_dtype, generator=generator)
        extra = 2 if coord else 0
        self.conv1 = Conv2d(in_channels + extra, features, 3, padding=1, kaiming=True, **conv)
        self.conv2 = Conv2d(features + extra, features, 3, padding=1, stride=2, kaiming=True,
                            **conv)
        self.proj = Conv2d(in_channels, features, 1, stride=2, **conv)

    def forward(self, x):
        y = leaky_relu(self.conv1(add_coords(x) if self.coord else x))
        y = leaky_relu(self.conv2(add_coords(y) if self.coord else y))
        identity = self.proj(x)
        return (y + identity.to(y.dtype)) / in_dtype(math.sqrt(2.0), y)


class _ProgressiveBase(nn.Module):
    """The shared progressive trunk (conditioned_nerf_gan_tpu/models/
    discriminators.py:188-228): fromRGB adapters and blocks for every
    resolution, the entry chosen by the image side, the fade-in blend at
    the second block; `_trunk` takes NCHW images and returns NCHW features
    (B, 400, 2, 2). The final 2x2 conv puts out `final_features` (none
    where that is 0)."""

    size_to_layer = IMG_SIZE_TO_LAYER
    adapter_channels = _ADAPTER_CHANNELS
    layer_channels = _PROG_CHANNELS
    final_features = 1

    def __init__(self, input_channels: int = 3, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        conv = dict(compute_dtype=compute_dtype, generator=generator)
        self.fromRGB = nn.ModuleList(
            [AdapterBlock(input_channels, c, **conv) for c in self.adapter_channels])
        self.layers = nn.ModuleList(
            [self._block(self.adapter_channels[i], c, **conv)
             for i, c in enumerate(self.layer_channels)])
        if self.final_features:
            self.final_layer = Conv2d(self.layer_channels[-1], self.final_features, 2, **conv)

    def _block(self, in_channels, features, **conv) -> nn.Module:
        return ResidualCoordConvBlock(in_channels, features, downsample=True, **conv)

    def _trunk(self, img: torch.Tensor, alpha) -> torch.Tensor:
        start = self.size_to_layer[img.shape[-1]]
        if self.compute_dtype is not None:
            # the blend in the policy dtype: an fp32 alpha would upcast it;
            # a fill on the device, where a copy of the number would wait
            alpha = torch.full((), float(alpha), dtype=self.compute_dtype, device=img.device)
        x = self.fromRGB[start](img)
        for i, layer in enumerate(self.layers[start:]):
            if i == 1:
                x = alpha * x + (1.0 - alpha) * self.fromRGB[start + 1](
                    downsample_nearest_2x(img))
            x = layer(x)
        return x

    def _head(self, img: torch.Tensor, alpha) -> torch.Tensor:
        """NHWC images -> the final conv's fp32 output flattened (B, F)."""
        x = self.final_layer(self._trunk(img.permute(0, 3, 1, 2), alpha))
        return x.reshape(x.shape[0], -1).float()


def _split_heads(x: torch.Tensor) -> tuple:
    """(logit, 256-d latent, 2-d position) of a (B, 259) head."""
    return x[..., 0:1], x[..., 1:257], x[..., 257:259]


class ProgressiveDiscriminator(_ProgressiveBase):
    """Scalar-logit progressive discriminator: NHWC images (B, S, S, C) and
    the fade-in alpha -> fp32 logits (B, 1)."""

    def forward(self, img: torch.Tensor, alpha, cond=None) -> torch.Tensor:
        return self._head(img, alpha)


class ProgressiveEncoderDiscriminator(_ProgressiveBase):
    """The progressive trunk with a (1 + 256 + 2)-channel head split into
    (logit (B, 1), latent (B, 256), position (B, 2)). With `instance_noise`
    > 0 and a `generator`, N(0, instance_noise^2) noise is added to the
    images first (the JAX module's `noise_key`)."""

    final_features = 1 + 256 + 2

    def forward(self, img: torch.Tensor, alpha, cond=None, instance_noise: float = 0.0,
                generator: torch.Generator | None = None) -> tuple:
        if instance_noise > 0 and generator is not None:
            noise = torch.randn(img.shape, generator=generator, dtype=img.dtype,
                                device=img.device)
            img = img + noise * instance_noise
        return _split_heads(self._head(img, alpha))


class ProgressiveDiscriminatorInputCat(_ProgressiveBase):
    """The conditioning view (NHWC, the image's size) concatenated to the
    image on the channel axis: 6 input channels."""

    def __init__(self, input_channels: int = 6, **kwargs):
        super().__init__(input_channels, **kwargs)

    def forward(self, img: torch.Tensor, alpha, cond=None) -> torch.Tensor:
        if cond is None:
            raise ValueError("inputCat discriminator requires a conditioning image")
        return self._head(torch.cat([img, cond], dim=-1), alpha)


class _BatchNorm(nn.Module):
    """Stateless train-mode batch normalization (conditioned_nerf_gan_tpu/
    models/discriminators.py:274-293): the batch's mean and population
    variance per channel in fp32, eps 1e-5, scale and shift, the result
    cast back to the input's dtype. No running statistics: the reference's
    projection head never leaves train mode."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3), keepdim=True)
        var = (xf - mean).pow(2).mean(dim=(0, 2, 3), keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + 1e-5) * self.weight[:, None, None]
             + self.bias[:, None, None])
        return y.to(x.dtype)


class _ResNetConv(nn.Module):
    """A bias-free NCHW conv with torchvision's ResNet init,
    kaiming_normal(fan_out, relu): N(0, 2 / (out * k * k))."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.compute_dtype = stride, padding, compute_dtype
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size,
                                               kernel_size))
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / (features * kernel_size ** 2)),
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, dt = self.weight, self.compute_dtype
        if dt is not None:
            x, w = x.to(dt), w.to(dt)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)


class _BasicBlock(nn.Module):
    """torchvision's BasicBlock: two 3x3 convs with BatchNorm, a 1x1
    projection with BatchNorm where the stride or width changes."""

    def __init__(self, in_channels: int, features: int, stride: int = 1, **conv):
        super().__init__()
        self.conv1 = _ResNetConv(in_channels, features, 3, stride, 1, **conv)
        self.bn1 = _BatchNorm(features)
        self.conv2 = _ResNetConv(features, features, 3, 1, 1, **conv)
        self.bn2 = _BatchNorm(features)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or in_channels != features:
            self.downsample_conv = _ResNetConv(in_channels, features, 1, stride, 0, **conv)
            self.downsample_bn = _BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity.to(out.dtype))


class ResNet18(nn.Module):
    """torchvision's ResNet18 architecture (NCHW) with a custom fc head
    (conditioned_nerf_gan_tpu/models/discriminators.py:345-383): a 7x7/2
    conv, BatchNorm, relu, a 3x3/2 max pool over -inf padding, four stages
    of two BasicBlocks, the fp32 mean over space and `fc` (512 ->
    `num_outputs`) in fp32, weight and bias from U(+-1/sqrt(512))."""

    def __init__(self, num_outputs: int = 1600, in_channels: int = 3, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        conv = dict(compute_dtype=compute_dtype, generator=generator)
        self.conv1 = _ResNetConv(in_channels, 64, 7, 2, 3, **conv)
        self.bn1 = _BatchNorm(64)
        width = 64
        for stage, (features, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
            setattr(self, f"layer{stage + 1}_0", _BasicBlock(width, features, stride, **conv))
            setattr(self, f"layer{stage + 1}_1", _BasicBlock(features, features, 1, **conv))
            width = features
        self.fc = nn.Linear(512, num_outputs)
        bound = 1.0 / math.sqrt(512)
        with torch.no_grad():
            self.fc.weight.uniform_(-bound, bound, generator=generator)
            self.fc.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=-math.inf), 3, 2)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}_1")(getattr(self, f"layer{stage}_0")(x))
        x = x.float().mean(dim=(2, 3))
        return x @ self.fc.weight.t() + self.fc.bias


class ProgressiveDiscriminatorProjection(_ProgressiveBase):
    """Projection conditioning: the logit (B, 1) is the inner product of the
    trunk's features, flattened in NCHW order to 1600 (the order the
    ResNet's outputs are dotted against, conditioned_nerf_gan_tpu/models/
    discriminators.py:401), with `mapping` (ResNet18) of the NHWC
    conditioning view, L2-normalised (eps 1e-12). No final conv, as in the
    JAX module."""

    final_features = 0

    def __init__(self, input_channels: int = 3, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__(input_channels, compute_dtype=compute_dtype, generator=generator)
        self.mapping = ResNet18(1600, compute_dtype=compute_dtype, generator=generator)

    def forward(self, img: torch.Tensor, alpha, cond=None) -> torch.Tensor:
        if cond is None:
            raise ValueError("projection discriminator requires a conditioning image")
        x = self._trunk(img.permute(0, 3, 1, 2), alpha)
        x = x.reshape(x.shape[0], -1).float()  # NCHW is torch's order already
        cmap = self.mapping(cond.permute(0, 3, 1, 2))
        cmap = cmap / cmap.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return (x * cmap).sum(dim=1, keepdim=True)


class _StridedBase(_ProgressiveBase):
    """The legacy strided trunk (conditioned_nerf_gan_tpu/models/
    discriminators.py:415-447): `_SG_ADAPTERS` adapters, `_SG_CHANNELS`
    strided blocks (CoordConv with `coord`), entered by
    `SG_IMG_SIZE_TO_LAYER`, with the progressive trunk's fade-in."""

    size_to_layer = SG_IMG_SIZE_TO_LAYER
    adapter_channels = _SG_ADAPTERS
    layer_channels = _SG_CHANNELS
    coord = False

    def _block(self, in_channels, features, **conv) -> nn.Module:
        return StridedResidualConvBlock(in_channels, features, self.coord, **conv)


class StridedDiscriminator(_StridedBase):
    """(pred (B, 1), None, None)."""

    def forward(self, img: torch.Tensor, alpha, cond=None) -> tuple:
        return self._head(img, alpha), None, None


class CCSDiscriminator(StridedDiscriminator):
    """The CoordConv strided variant: (pred (B, 1), None, None)."""

    coord = True


class CCSEncoderDiscriminator(_StridedBase):
    """The CoordConv strided trunk with the (logit, latent, position) head."""

    coord = True
    final_features = 1 + 256 + 2

    def forward(self, img: torch.Tensor, alpha, cond=None) -> tuple:
        return _split_heads(self._head(img, alpha))


DISCRIMINATOR_REGISTRY = {
    "ProgressiveDiscriminator": ProgressiveDiscriminator,
    "ProgressiveEncoderDiscriminator": ProgressiveEncoderDiscriminator,
    "ProgressiveDiscriminator_inputCat": ProgressiveDiscriminatorInputCat,
    "ProgressiveDiscriminator_projection": ProgressiveDiscriminatorProjection,
    "StridedDiscriminator": StridedDiscriminator,
    "CCSDiscriminator": CCSDiscriminator,
    "CCSEncoderDiscriminator": CCSEncoderDiscriminator,
}


def make_discriminator(name: str, **kwargs) -> nn.Module:
    """Build a discriminator by reference class name."""
    if name not in DISCRIMINATOR_REGISTRY:
        raise ValueError(f"Unknown discriminator {name!r}")
    return DISCRIMINATOR_REGISTRY[name](**kwargs)
