"""LPIPS perceptual distance with the AlexNet backbone (port of
conditioned_nerf_gan_tpu/eval/lpips.py).

The reference's `lpips.LPIPS(net="alex", spatial=False)`: images in [-1, 1]
are shifted and scaled, run through AlexNet's five convs (ReLU after each,
a 3x3 stride-2 max pool after the first two), each layer's features are
unit-normalised over the channels (+1e-10), their squared difference is
weighted by that layer's linear head (`lin{i}`), averaged over the pixels
and summed over the layers. Images are NHWC at the boundary.

Weights: the .npz named by CNG_LPIPS_WEIGHTS, else a fixed-seed random init
with a warning (values compare within this framework only).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .inception import random_init_
from .weights import load_flat_weights, warn_random_init, weights_path

# AlexNet's features: (out channels, kernel, stride, padding), in from 3
_ALEX_LAYERS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class AlexFeatures(nn.Module):
    def __init__(self):
        super().__init__()
        c_in = 3
        for i, (c, k, s, p) in enumerate(_ALEX_LAYERS):
            setattr(self, f"conv{i}", nn.Conv2d(c_in, c, k, s, p))
            c_in = c

    def forward(self, x):
        feats = []
        for i in range(len(_ALEX_LAYERS)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if i in (0, 1):
                x = F.max_pool2d(x, 3, 2)
        return feats


class LPIPS(nn.Module):
    """lpips(a, b) -> (B,) for NHWC images in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.alex = AlexFeatures()
        for i, (c, *_rest) in enumerate(_ALEX_LAYERS):
            setattr(self, f"lin{i}", nn.Parameter(torch.zeros(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def flax_paths(self) -> dict[str, str]:
        """{state-dict name: the JAX package's .npz key}."""
        paths = {}
        for i in range(len(_ALEX_LAYERS)):
            paths[f"alex.conv{i}.weight"] = f"params/alex/conv{i}_kernel"
            paths[f"alex.conv{i}.bias"] = f"params/alex/conv{i}_bias"
            paths[f"lin{i}"] = f"params/lin{i}"
        return paths

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = torch.cat([a, b]).permute(0, 3, 1, 2)
        feats = self.alex((x - self.shift) / self.scale)
        total = 0.0
        for i, f in enumerate(feats):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            fa, fb = f.chunk(2)
            w = getattr(self, f"lin{i}")
            total = total + ((fa - fb) ** 2 * w[:, None, None]).sum(1).mean(dim=(1, 2))
        return total


_cached: dict = {}


def get_lpips(seed: int = 0, device: str | torch.device = "cuda") -> LPIPS:
    """The LPIPS net on `device`, with the weights of CNG_LPIPS_WEIGHTS or a
    fixed-seed init (convs as the Inception's, heads |N(0, 1)| x 0.1);
    built once a device and process."""
    device = torch.device(device)
    if device not in _cached:
        model = LPIPS()
        path = weights_path("CNG_LPIPS_WEIGHTS")
        if path:
            load_flat_weights(model, dict(np.load(path)), name="CNG_LPIPS_WEIGHTS")
        else:
            warn_random_init("CNG_LPIPS_WEIGHTS", "LPIPS (AlexNet)")
            random_init_(model, seed)
            gen = torch.Generator().manual_seed(seed + 1)
            with torch.no_grad():
                for i in range(len(_ALEX_LAYERS)):
                    lin = getattr(model, f"lin{i}")
                    lin.copy_(torch.randn(lin.shape, generator=gen).abs() * 0.1)
        _cached[device] = model.eval().to(device)
    return _cached[device]
