"""Conditioned FiLM-SIREN decoders (port of conditioned_nerf_gan_tpu/models/siren.py).

The JAX package collapses the reference's 14 SIREN classes into one
`ConditionedSiren` driven by the `SIREN_SPECS` table. This port carries the
table and builds every spec but `TALLSIREN`:
  * points input, conditioned on a global latent z: `SHORTSIREN`, the
    thesis model;
  * features input (per-point features sampled from the U-Net's feature
    volume, border-mode trilinear, points normalized by 0.6; from a feature
    pyramid, every level's features concatenated), FiLM from a linear
    mapping of the U-Net's global feature: `TALLSIREN_FG`, `SHORTSIREN_FG`,
    `DOUBLESIREN_FG` and `SingleSIREN_dg` (the voxel family; the presets'
    `*_dg` names are aliases), `TALLSIREN_dgx` (features and xyz) and
    `SHORTSIREN_FG_Pyrmd` (a pyramid's features);
  * features input without FiLM: plain SIREN and residual SIREN layers on
    a bare feature volume, `TALLSIREN_dRes`, `TALLSIREN_dResLong`,
    `SHORTSIREN_F` and `SHORTSIREN_FRes`.
All-FiLM stacks of 2 or more layers go to the fused kernels under the
presets' policy (`routes_to_kernel`); the rest run layer by layer. The
per-point `pointfeat` mapping of `TALLSIREN` and the legacy variants raise
`NotImplementedError` naming ROADMAP A13.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..config.presets import resolve_siren_alias
from ..ops.grid_sample import trilinear_point_features
from ..ops.kernels.film_siren import film_siren_mlp
from .layers import (
    CustomMappingNetwork,
    FiLMLayer,
    LinearMapping,
    ResSirenBlock,
    SirenLayer,
    TorchLinear,
    first_layer_film_sine_init,
    frequency_init,
)

VOXEL_LENGTH = 1.2  # the voxel grids are sampled within a 1.2^3 cube


def sigmoid_rgb(rgb_sigma: torch.Tensor) -> torch.Tensor:
    """Sigmoid on the rgb channels only."""
    return torch.cat([torch.sigmoid(rgb_sigma[..., :3]), rgb_sigma[..., -1:]], dim=-1)


def sample_volume_features(points: torch.Tensor, volume: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup of per-point features: points (B, N, 3) world
    coordinates inside the +-0.6 cube, volume (B, D, H, W, C) -> (B, N, C).
    In a render the volume comes through `one_volume_grad` (the generator
    puts it through once, before its ray chunks), so the backward of every
    lookup adds into the render's one dV."""
    coords = points / (VOXEL_LENGTH / 2.0)
    return trilinear_point_features(volume, coords, align_corners=False,
                                    padding_mode="border")


def sample_pyramid_features(points: torch.Tensor, pyramid) -> torch.Tensor:
    """The features input's lookup: every level of a feature pyramid (a list
    of volumes, PyramidUNet3D's, coarse first) sampled at the points and
    concatenated in order -> (B, N, sum of C); a single volume is a pyramid
    of one level. A level's dX is its column slice of the concatenation's."""
    if not isinstance(pyramid, (list, tuple)):
        pyramid = [pyramid]
    feats = [sample_volume_features(points, level) for level in pyramid]
    return feats[0] if len(feats) == 1 else torch.cat(feats, dim=-1)


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


def is_ported(spec: SirenSpec) -> bool:
    """Every spec but the per-point `pointfeat` mapping's (TALLSIREN)."""
    return spec.mapping != "pointfeat"


class ConditionedSiren(nn.Module):
    """The SIREN of a spec: points input conditioned on a global latent z,
    or sampled-features input (a volume's, a pyramid's, or a volume's and
    the points) conditioned on the U-Net's global feature or on nothing.
    Layers of each kind keep the flax numbering: `film_layers.i` is
    FiLMLayer_i, `siren_layers.i` SirenLayer_i, `res_blocks.i`
    ResSirenBlock_i. `input_dim` is the sampled features' width (the
    pyramid's summed); `features_points` adds the 3 coordinates."""

    def __init__(self, spec: SirenSpec, *, z_dim: int = 100, input_dim: int = 3,
                 hidden_dim: int = 256, output_dim: int = 4, drop_out: float = 0.0,
                 mapping_network: str = "CustomMappingNetwork",
                 compute_dtype: torch.dtype | None = None,
                 use_fast_sin: bool = False, use_kernel: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not is_ported(spec):
            raise NotImplementedError(f"{spec} is not ported yet (ROADMAP A13)")
        if spec.mapping == "selectable" and mapping_network != "CustomMappingNetwork":
            raise NotImplementedError(
                f"mapping network {mapping_network!r} is not ported yet (ROADMAP A13)")
        self.spec = spec
        self.hidden_dim = hidden_dim
        self.drop_out = drop_out
        self.compute_dtype = compute_dtype
        self.use_fast_sin = use_fast_sin
        self.use_kernel = use_kernel
        if spec.mapping is not None:
            out_dim = len(spec.layers) * hidden_dim * 2
            if spec.mapping == "linear":
                self.mapping_network = LinearMapping(z_dim, out_dim, generator=generator)
            else:
                self.mapping_network = CustomMappingNetwork(z_dim, 256, out_dim,
                                                            generator=generator)
        finit = frequency_init(spec.freq_init)
        first_in = input_dim + 3 if spec.input == "features_points" else input_dim
        layer = dict(compute_dtype=compute_dtype, use_fast_sin=use_fast_sin,
                     generator=generator)
        film, siren, res = [], [], []
        for i, kind in enumerate(spec.layers):
            width = first_in if i == 0 else hidden_dim
            kinit = first_layer_film_sine_init if i == 0 else finit
            if kind == "film":
                film.append(FiLMLayer(width, hidden_dim, kernel_init=kinit, **layer))
            elif kind == "siren":
                siren.append(SirenLayer(width, hidden_dim, kernel_init=kinit, **layer))
            elif kind == "res":
                res.append(ResSirenBlock(hidden_dim, kernel_init=finit, **layer))
            else:
                raise ValueError(kind)
        self.film_layers = nn.ModuleList(film)
        self.siren_layers = nn.ModuleList(siren)
        self.res_blocks = nn.ModuleList(res)
        self.final_layer = TorchLinear(hidden_dim, output_dim, kernel_init=finit,
                                       generator=generator)

    def routes_to_kernel(self, freq: torch.Tensor | None) -> bool:
        """The JAX package's gate (models/siren.py:222-239): an all-FiLM stack
        of 2 or more layers, and the fused kernel serves only the bf16 +
        fast-sin policy it was written for."""
        return (self.use_kernel
                and all(k == "film" for k in self.spec.layers)
                and len(self.spec.layers) >= 2
                and freq is not None
                and freq.ndim == 2
                and self.drop_out == 0
                and self.use_fast_sin
                and self.compute_dtype == torch.bfloat16)

    def _inputs(self, points: torch.Tensor, z):
        """The first layer's input and the mapping's source, as the JAX
        package resolves z (models/siren.py:161-191): a (volume or pyramid,
        global) pair or a bare volume for features input, a (pyramid,
        global) pair for pyramid input, a latent (or a pair's second member)
        for points input."""
        spec = self.spec
        pair = isinstance(z, (tuple, list))
        if spec.input in ("features", "features_points"):
            volume, global_feature = (z[0], z[1]) if pair else (z, None)
            x = sample_pyramid_features(points, volume)
            if spec.input == "features_points":
                x = torch.cat([x, points], dim=-1)
        elif spec.input == "pyramid":
            pyramid, global_feature = z
            x = sample_pyramid_features(points, pyramid)
        else:
            x, global_feature = points, (z[1] if pair else z)
        if spec.mapping is not None and global_feature is None:
            raise ValueError(f"{spec} is conditioned on a (volume, global) pair")
        return x, global_feature

    def forward(self, points: torch.Tensor, z) -> torch.Tensor:
        """points (B, N, 3) world points; z the conditioning: a latent
        (B, z_dim) for points input; for features input a (volume (B, D, H,
        W, C) or pyramid [levels], global (B, z_dim)) pair, or a bare volume
        where the spec has no mapping; a (pyramid, global) pair for pyramid
        input -> (B, N, 4). Past the gate, CUDA inputs go to the forward
        kernel, and with grad enabled its backward is the backward kernel
        (`FilmSirenMLP`)."""
        x, global_feature = self._inputs(points, z)
        freq = phase = None
        if self.spec.mapping is not None:
            freq, phase = self.mapping_network(global_feature)
            freq = freq * 15.0 + 30.0
        if self.routes_to_kernel(freq):
            lins = [layer.linear for layer in self.film_layers]
            rgb_sigma = film_siren_mlp(
                x, freq, phase,
                lins[0].weight.t(), lins[0].bias,
                torch.stack([l.weight.t() for l in lins[1:]]),
                torch.stack([l.bias for l in lins[1:]]),
                self.final_layer.weight.t(), self.final_layer.bias,
            )
        else:
            H = self.hidden_dim
            layers = {"film": iter(self.film_layers), "siren": iter(self.siren_layers),
                      "res": iter(self.res_blocks)}
            for i, kind in enumerate(self.spec.layers):
                layer = next(layers[kind])
                if kind == "film":
                    x = layer(x, freq[..., i * H:(i + 1) * H], phase[..., i * H:(i + 1) * H])
                else:
                    x = layer(x)
            # the head is fp32, as in JAX, on the compute_dtype activations
            rgb_sigma = self.final_layer(x.float())
        if self.spec.output == "sigmoid_rgb":
            rgb_sigma = sigmoid_rgb(rgb_sigma)
        return rgb_sigma


def make_siren(siren_type: str, *, z_dim: int = 100, input_dim: int = 3,
               output_dim: int = 4, hidden_dim: int = 256, drop_out: float = 0.0,
               mapping_network: str = "CustomMappingNetwork",
               compute_dtype: torch.dtype | None = None, use_fast_sin: bool = False,
               use_kernel: bool = False, generator: torch.Generator | None = None,
               **_unused) -> nn.Module:
    """Build a SIREN variant by reference class name (aliases resolved).
    `z_dim` is the mapping's input: the latent, or the U-Net's global
    feature; `input_dim` the sampled features' width: 3 for points input,
    the feature volume's C, or the pyramid's summed C."""
    siren_type = resolve_siren_alias(siren_type)
    if siren_type in SIREN_SPECS:
        return ConditionedSiren(
            SIREN_SPECS[siren_type], z_dim=z_dim, input_dim=input_dim,
            hidden_dim=hidden_dim, output_dim=output_dim, drop_out=drop_out,
            mapping_network=mapping_network, compute_dtype=compute_dtype,
            use_fast_sin=use_fast_sin, use_kernel=use_kernel, generator=generator)
    if siren_type in SIREN_REGISTRY:
        raise NotImplementedError(f"{siren_type} is not ported yet (ROADMAP A13)")
    raise ValueError(f"Unknown siren_type {siren_type!r}")
