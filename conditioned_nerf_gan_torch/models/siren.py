"""Conditioned FiLM-SIREN decoders (port of conditioned_nerf_gan_tpu/models/siren.py).

The JAX package collapses the reference's 14 SIREN classes into one
`ConditionedSiren` driven by the `SIREN_SPECS` table. This port carries the
table and builds the all-FiLM, points-input, z-conditioned spec
(`SHORTSIREN`, the thesis model); every other variant raises
`NotImplementedError` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from conditioned_nerf_gan_tpu.config.presets import resolve_siren_alias

from ..ops.kernels.film_siren import film_siren_mlp
from .layers import (
    CustomMappingNetwork,
    FiLMLayer,
    TorchLinear,
    first_layer_film_sine_init,
    frequency_init,
)


def sigmoid_rgb(rgb_sigma: torch.Tensor) -> torch.Tensor:
    """Sigmoid on the rgb channels only."""
    return torch.cat([torch.sigmoid(rgb_sigma[..., :3]), rgb_sigma[..., -1:]], dim=-1)


@dataclasses.dataclass(frozen=True)
class SirenSpec:
    """Declarative description of one SIREN variant."""

    layers: tuple[str, ...]  # 'film' | 'siren' | 'res'
    input: str  # 'points' | 'features' | 'features_points' | 'pyramid'
    mapping: str | None  # 'linear' | 'pointfeat' | 'selectable' | None
    mapping_source: str | None  # 'global' | 'sampled_features' | 'z'
    freq_init: float = 25.0
    output: str = "raw"  # 'raw' | 'sigmoid_rgb'


SIREN_SPECS: dict[str, SirenSpec] = {
    "TALLSIREN": SirenSpec(("film",) * 8, "points", "pointfeat", "sampled_features"),
    "TALLSIREN_dRes": SirenSpec(("siren", "res", "res", "siren"), "features", None, None),
    "TALLSIREN_dResLong": SirenSpec(
        ("siren", "res", "res", "res", "res", "siren"), "features", None, None
    ),
    "TALLSIREN_FG": SirenSpec(
        ("film",) * 8, "features", "linear", "global", 25.0, "sigmoid_rgb"
    ),
    "SHORTSIREN_FG": SirenSpec(
        ("film",) * 4, "features", "linear", "global", 12.0, "sigmoid_rgb"
    ),
    "SHORTSIREN_FG_Pyrmd": SirenSpec(
        ("film",) * 4, "pyramid", "linear", "global", 12.0, "sigmoid_rgb"
    ),
    "DOUBLESIREN_FG": SirenSpec(
        ("film",) * 2, "features", "linear", "global", 12.0, "sigmoid_rgb"
    ),
    "SHORTSIREN_F": SirenSpec(
        ("siren",) * 4, "features", None, None, 12.0, "sigmoid_rgb"
    ),
    "SHORTSIREN_FRes": SirenSpec(
        ("siren", "res", "siren"), "features", None, None, 12.0, "sigmoid_rgb"
    ),
    "SingleSIREN_dg": SirenSpec(("film",), "features", "linear", "global", 25.0, "raw"),
    "TALLSIREN_dgx": SirenSpec(
        ("film",) * 8, "features_points", "linear", "global", 25.0, "raw"
    ),
    "SHORTSIREN": SirenSpec(
        ("film",) * 4, "points", "selectable", "z", 25.0, "sigmoid_rgb"
    ),
}

SIREN_REGISTRY = tuple(SIREN_SPECS) + (
    "SPATIALSIRENBASELINE",
    "EmbeddingPiGAN128",
    "EmbeddingPiGAN256",
)


class ConditionedSiren(nn.Module):
    """All-FiLM, points-input SIREN conditioned on a global latent z."""

    def __init__(self, spec: SirenSpec, *, z_dim: int = 100, input_dim: int = 3,
                 hidden_dim: int = 256, output_dim: int = 4, drop_out: float = 0.0,
                 mapping_network: str = "CustomMappingNetwork",
                 compute_dtype: torch.dtype | None = None,
                 use_fast_sin: bool = False, use_kernel: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not (all(k == "film" for k in spec.layers) and spec.input == "points"
                and spec.mapping == "selectable"):
            raise NotImplementedError(
                f"{spec} is not ported yet (ROADMAP A12/A13)")
        if mapping_network != "CustomMappingNetwork":
            raise NotImplementedError(
                f"mapping network {mapping_network!r} is not ported yet (ROADMAP A13)")
        self.spec = spec
        self.hidden_dim = hidden_dim
        self.drop_out = drop_out
        self.compute_dtype = compute_dtype
        self.use_fast_sin = use_fast_sin
        self.use_kernel = use_kernel
        n_film = len(spec.layers)
        self.mapping_network = CustomMappingNetwork(
            z_dim, 256, n_film * hidden_dim * 2, generator=generator)
        finit = frequency_init(spec.freq_init)
        self.film_layers = nn.ModuleList([
            FiLMLayer(input_dim if i == 0 else hidden_dim, hidden_dim,
                      kernel_init=first_layer_film_sine_init if i == 0 else finit,
                      generator=generator)
            for i in range(n_film)
        ])
        self.final_layer = TorchLinear(hidden_dim, output_dim, kernel_init=finit,
                                       generator=generator)

    def routes_to_kernel(self, freq: torch.Tensor) -> bool:
        """The JAX package's gate (models/siren.py:222-239): the fused kernel
        serves only the bf16 + fast-sin policy it was written for."""
        return (self.use_kernel
                and len(self.spec.layers) >= 2
                and freq.ndim == 2
                and self.drop_out == 0
                and self.use_fast_sin
                and self.compute_dtype == torch.bfloat16)

    def forward(self, points: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """points (B, N, 3) world points, z (B, z_dim) -> (B, N, 4). Past
        the gate, CUDA inputs go to the forward kernel, and with grad
        enabled its backward is the backward kernel (`FilmSirenMLP`)."""
        freq, phase = self.mapping_network(z)
        freq = freq * 15.0 + 30.0
        if self.routes_to_kernel(freq):
            lins = [layer.linear for layer in self.film_layers]
            rgb_sigma = film_siren_mlp(
                points, freq, phase,
                lins[0].weight.t(), lins[0].bias,
                torch.stack([l.weight.t() for l in lins[1:]]),
                torch.stack([l.bias for l in lins[1:]]),
                self.final_layer.weight.t(), self.final_layer.bias,
            )
        else:
            x = points
            H = self.hidden_dim
            for i, layer in enumerate(self.film_layers):
                x = layer(x, freq[..., i * H:(i + 1) * H], phase[..., i * H:(i + 1) * H])
            rgb_sigma = self.final_layer(x)
        if self.spec.output == "sigmoid_rgb":
            rgb_sigma = sigmoid_rgb(rgb_sigma)
        return rgb_sigma


def make_siren(siren_type: str, *, z_dim: int = 100, input_dim: int = 3,
               output_dim: int = 4, hidden_dim: int = 256, drop_out: float = 0.0,
               mapping_network: str = "CustomMappingNetwork",
               compute_dtype: torch.dtype | None = None, use_fast_sin: bool = False,
               use_kernel: bool = False, generator: torch.Generator | None = None,
               **_unused) -> nn.Module:
    """Build a SIREN variant by reference class name."""
    siren_type = resolve_siren_alias(siren_type)
    if siren_type == "SHORTSIREN":
        return ConditionedSiren(
            SIREN_SPECS[siren_type], z_dim=z_dim, input_dim=input_dim,
            hidden_dim=hidden_dim, output_dim=output_dim, drop_out=drop_out,
            mapping_network=mapping_network, compute_dtype=compute_dtype,
            use_fast_sin=use_fast_sin, use_kernel=use_kernel, generator=generator)
    if siren_type in SIREN_SPECS and SIREN_SPECS[siren_type].input != "points":
        raise NotImplementedError(
            f"{siren_type} (feature-volume input) is not ported yet (ROADMAP A12)")
    if siren_type in SIREN_REGISTRY:
        raise NotImplementedError(f"{siren_type} is not ported yet (ROADMAP A13)")
    raise ValueError(f"Unknown siren_type {siren_type!r}")
