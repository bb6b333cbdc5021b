"""InceptionV3 feature extractor for FID and oFID (port of
conditioned_nerf_gan_tpu/eval/inception.py).

The FID-standard InceptionV3 (pytorch_fid's): inputs (B, H, W, 3) in [0, 1]
are resized to 299^2 (bilinear, half-pixel centres, as `jax.image.resize`),
mapped to [-1, 1], and tapped at
  * Mixed_6e: the (B, 17, 17, 768) map oFID uses;
  * the global mean of Mixed_7c: the (B, 2048) vector FID uses.
Each conv is bias-free with a frozen BatchNorm (running statistics, eps
1e-3) and a ReLU; the branch average pools exclude the padding, and
Mixed_7c's pool branch is a max pool, as in pytorch_fid. Module and state
names are pytorch_fid's (`Mixed_5b.branch1x1.conv.weight`,
`...bn.running_mean`); `flax_paths` maps them to the JAX package's .npz
keys.

Weights: the .npz named by CNG_INCEPTION_WEIGHTS, else a fixed-seed random
init (variance-preserving, so random features stay O(1) through the stack)
with a warning: such FID/oFID values compare within this framework only.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .weights import load_flat_weights, warn_random_init, weights_path

_BN_LEAVES = {"bn.weight": "bn_scale", "bn.bias": "bn_bias",
              "bn.running_mean": "bn_mean", "bn.running_var": "bn_var"}


class BasicConv2d(nn.Module):
    """Bias-free conv + frozen BatchNorm (running statistics) + ReLU."""

    def __init__(self, c_in: int, c_out: int, kernel_size=3, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean, bn.running_var,
                                   bn.weight, bn.bias, training=False, eps=bn.eps))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, 1)
        self.branch5x5_1 = BasicConv2d(c_in, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(c_in, pool_features, 1)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), b, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, c_in: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool  # pytorch_fid's last block (Mixed_7c) max-pools
        self.branch1x1 = BasicConv2d(c_in, 320, 1)
        self.branch3x3_1 = BasicConv2d(c_in, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max" else _avg_pool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """(B, H, W, 3) in [0, 1] -> (features_768 (B, 17, 17, 768),
    features_2048 (B, 2048))."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, pool="max")

    def flax_paths(self) -> dict[str, str]:
        """{state-dict name: the JAX package's .npz key}."""
        paths = {}
        for key in self.state_dict():
            if key.endswith(".conv.weight"):
                paths[key] = f"params/{key[:-len('.conv.weight')].replace('.', '/')}/kernel"
            elif not key.endswith("num_batches_tracked"):
                prefix, leaf = key.rsplit(".bn.", 1)
                paths[key] = f"params/{prefix.replace('.', '/')}/{_BN_LEAVES['bn.' + leaf]}"
        return paths

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        # jax.image.resize's bilinear: half-pixel centres, a triangle filter
        # widened by the scale when it shrinks (antialiased), plain lerps
        # when it enlarges (the eval's 128 -> 299)
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                          antialias=max(x.shape[-2:]) > 299)
        x = x * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                     "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        feat_768 = x.permute(0, 2, 3, 1)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        return feat_768, x.mean(dim=(2, 3))


def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fixed-seed init: conv kernels from a normal of variance 2 / fan_in
    truncated at two standard deviations (flax's he_normal), BatchNorm the
    identity (mean 0, var 1, scale 1, bias 0)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = float(np.sqrt(2.0 / fan_in)) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


_cached: dict = {}


def get_inception(seed: int = 0, device: str | torch.device = "cuda") -> InceptionV3Features:
    """The feature net in eval mode on `device`, with the weights of
    CNG_INCEPTION_WEIGHTS or the fixed-seed init; built once a device and
    process."""
    device = torch.device(device)
    if device not in _cached:
        model = InceptionV3Features()
        path = weights_path("CNG_INCEPTION_WEIGHTS")
        if path:
            load_flat_weights(model, dict(np.load(path)), name="CNG_INCEPTION_WEIGHTS")
        else:
            warn_random_init("CNG_INCEPTION_WEIGHTS", "InceptionV3 (FID/oFID)")
            random_init_(model, seed)
        _cached[device] = model.eval().to(device)
    return _cached[device]
