"""Conditioned FiLM-SIREN decoders (port of conditioned_nerf_gan_tpu/models/siren.py).

The JAX package collapses the reference's 14 SIREN classes into one
`ConditionedSiren` driven by the `SIREN_SPECS` table, plus the legacy
pi-GAN variants. This port builds every name of `SIREN_REGISTRY`:
  * points input, conditioned on a global latent z: `SHORTSIREN`, the
    thesis model (its mapping `CustomMappingNetwork` or
    `LongMappingNetwork`);
  * points input, FiLM per point from a mapping of the features sampled
    at the points (`PointFeaturesMappingNetwork`): `TALLSIREN`
    (siren.py:205-211);
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
  * the legacy pi-GAN variants (siren.py:291-425): `SPATIALSIRENBASELINE`
    (8 FiLM layers on box-warped points, a view-dependent colour head) and
    `EmbeddingPiGAN128`/`256` (the same with features from a learned
    (1, E, E, E, 32) embedding cube, zeros padding, align_corners=True).
All-FiLM stacks of 2 or more layers with freq per batch element go to the
fused kernels under the presets' policy (`routes_to_kernel`); the rest run
layer by layer. TALLSIREN's freq is per point (ndim 3), so the JAX gate
(siren.py:222-239, `freq.ndim == 2`) keeps it off the fused kernel, and so
does this one; its lookups still go through the trilinear kernels. The
legacy variants never route to a kernel, as in JAX.
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
    LongMappingNetwork,
    PointFeaturesMappingNetwork,
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


_MAPPINGS = {
    "CustomMappingNetwork": CustomMappingNetwork,
    "LongMappingNetwork": LongMappingNetwork,
    "PointFeaturesMappingNetwork": PointFeaturesMappingNetwork,
}


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
    """The SIREN of a spec: points input conditioned on a global latent z or
    per point on the features sampled there (`pointfeat`), or
    sampled-features input (a volume's, a pyramid's, or a volume's and the
    points) conditioned on the U-Net's global feature or on nothing.
    Layers of each kind keep the flax numbering: `film_layers.i` is
    FiLMLayer_i, `siren_layers.i` SirenLayer_i, `res_blocks.i`
    ResSirenBlock_i. `input_dim` is the sampled features' width (the
    pyramid's summed); `features_points` adds the 3 coordinates. `z_dim` is
    the mapping's input: the latent's width, the global feature's, or for
    `pointfeat` the sampled features'."""

    def __init__(self, spec: SirenSpec, *, z_dim: int = 100, input_dim: int = 3,
                 hidden_dim: int = 256, output_dim: int = 4, drop_out: float = 0.0,
                 mapping_network: str = "CustomMappingNetwork",
                 compute_dtype: torch.dtype | None = None,
                 use_fast_sin: bool = False, use_kernel: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
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
                name = ("PointFeaturesMappingNetwork" if spec.mapping == "pointfeat"
                        else mapping_network)
                self.mapping_network = _MAPPINGS[name](z_dim, 256, out_dim,
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
        of 2 or more layers with freq per batch element (not TALLSIREN's per
        point), and the fused kernel serves only the bf16 + fast-sin policy
        it was written for."""
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
        package resolves z (models/siren.py:161-211): a (volume or pyramid,
        global) pair or a bare volume for features input, and for TALLSIREN's
        points input, whose mapping reads the features sampled at the
        points; a (pyramid, global) pair for pyramid input; a latent (or a
        pair's second member) for points input conditioned on z."""
        spec = self.spec
        pair = isinstance(z, (tuple, list))
        if spec.input in ("features", "features_points") or spec.mapping == "pointfeat":
            volume, source = (z[0], z[1]) if pair else (z, None)
            if spec.mapping == "pointfeat":
                x, source = points, sample_pyramid_features(points, volume)
            else:
                x = sample_pyramid_features(points, volume)
            if spec.input == "features_points":
                x = torch.cat([x, points], dim=-1)
        elif spec.input == "pyramid":
            pyramid, source = z
            x = sample_pyramid_features(points, pyramid)
        else:
            x, source = points, (z[1] if pair else z)
        if spec.mapping is not None and source is None:
            raise ValueError(f"{spec} is conditioned on a (volume, global) pair")
        return x, source

    def forward(self, points: torch.Tensor, z) -> torch.Tensor:
        """points (B, N, 3) world points; z the conditioning: a latent
        (B, z_dim) for points input; for features input a (volume (B, D, H,
        W, C) or pyramid [levels], global (B, z_dim)) pair, or a bare volume
        where the spec has no mapping; for TALLSIREN a volume of C = z_dim
        (or a pair, whose second member goes unused); a (pyramid, global)
        pair for pyramid input -> (B, N, 4). Past the gate, CUDA inputs go
        to the forward kernel, and with grad enabled its backward is the
        backward kernel (`FilmSirenMLP`)."""
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


class UniformBoxWarp(nn.Module):
    """coordinates * 2 / sidelength (siren.py:291-297)."""

    def __init__(self, sidelength: float):
        super().__init__()
        self.scale = 2.0 / sidelength

    def forward(self, coordinates: torch.Tensor) -> torch.Tensor:
        return coordinates * self.scale


def _modified_first_init(weight: torch.Tensor, generator=None) -> None:
    """EmbeddingPiGAN's first layer: U(+-1/3) whatever the fan-in (the
    reference's `modified_first_sine_init` takes num_input 3)."""
    weight.uniform_(-1.0 / 3.0, 1.0 / 3.0, generator=generator)


class SpatialSirenBaseline(nn.Module):
    """The unconditional pi-GAN baseline (siren.py:300-351): z through
    `CustomMappingNetwork` to 9 layers of freq/phase, 8 FiLM layers on the
    points warped by a box of side 0.24, a sigma head, and a colour head,
    sigmoid(linear(FiLM([ray directions, x]))) on the last freq/phase
    slice. The generator passes no ray directions (zeros), as in JAX. Under
    a `compute_dtype` the layers take the JAX policy (FiLM folded, the heads
    `_MixedLinear`). `color_layer_sine` is the flax `color_layer_sine`,
    `film_layers.i` FiLMLayer_i."""

    n_layers = 8
    first_in = 3

    def __init__(self, *, z_dim: int = 100, hidden_dim: int = 256, output_dim: int = 4,
                 drop_out: float = 0.0, compute_dtype: torch.dtype | None = None,
                 use_fast_sin: bool = False, generator: torch.Generator | None = None,
                 first_init=first_layer_film_sine_init):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.drop_out = drop_out
        self.mapping_network = CustomMappingNetwork(
            z_dim, 256, (self.n_layers + 1) * hidden_dim * 2, generator=generator)
        self.warp = UniformBoxWarp(0.24)
        finit = frequency_init(25)
        layer = dict(compute_dtype=compute_dtype, use_fast_sin=use_fast_sin,
                     generator=generator)
        self.film_layers = nn.ModuleList([
            FiLMLayer(self.first_in if i == 0 else hidden_dim, hidden_dim,
                      kernel_init=first_init if i == 0 else finit, **layer)
            for i in range(self.n_layers)])
        self.final_layer = TorchLinear(hidden_dim, 1, kernel_init=finit,
                                       compute_dtype=compute_dtype, generator=generator)
        self.color_layer_sine = FiLMLayer(hidden_dim + 3, hidden_dim, kernel_init=finit,
                                          **layer)
        self.color_layer_linear = TorchLinear(hidden_dim, 3, kernel_init=finit,
                                              compute_dtype=compute_dtype,
                                              generator=generator)

    def _features(self, warped: torch.Tensor) -> torch.Tensor:
        return warped

    def forward(self, points: torch.Tensor, z: torch.Tensor,
                ray_directions: torch.Tensor | None = None) -> torch.Tensor:
        """points (B, N, 3), z (B, z_dim) -> rgb + sigma (B, N, 4)."""
        H = self.hidden_dim
        freq, phase = self.mapping_network(z)
        freq = freq * 15.0 + 30.0
        x = self._features(self.warp(points))
        for i, layer in enumerate(self.film_layers):
            x = layer(x, freq[..., i * H:(i + 1) * H], phase[..., i * H:(i + 1) * H])
        sigma = self.final_layer(x)
        if ray_directions is None:
            ray_directions = torch.zeros_like(points)
        rgb = self.color_layer_sine(torch.cat([ray_directions.to(x.dtype), x], dim=-1),
                                    freq[..., -H:], phase[..., -H:])
        rgb = torch.sigmoid(self.color_layer_linear(rgb))
        return torch.cat([rgb, sigma.to(rgb.dtype)], dim=-1)


class EmbeddingPiGAN(SpatialSirenBaseline):
    """pi-GAN with a learned spatial embedding cube (siren.py:354-425): the
    first layer reads [the 32 features of `spatial_embeddings` (1, E, E, E,
    32), N(0, embedding_scale^2), sampled at the warped points with zeros
    padding and align_corners=True (plain torch, `ops/grid_sample.py`),
    the warped points], its init U(+-1/3). The cube is sampled as one
    volume for the whole batch's points, as the JAX module's broadcast of
    it does."""

    first_in = 32 + 3

    def __init__(self, *, embedding_res: int = 96, embedding_scale: float = 0.01,
                 hidden_dim: int = 128, generator: torch.Generator | None = None, **kwargs):
        super().__init__(hidden_dim=hidden_dim, generator=generator,
                         first_init=_modified_first_init, **kwargs)
        self.spatial_embeddings = nn.Parameter(
            torch.empty(1, embedding_res, embedding_res, embedding_res, 32))
        with torch.no_grad():
            self.spatial_embeddings.normal_(0.0, embedding_scale, generator=generator)

    def _features(self, warped: torch.Tensor) -> torch.Tensor:
        B, N, _ = warped.shape
        shared = trilinear_point_features(self.spatial_embeddings, warped.reshape(1, B * N, 3),
                                          align_corners=True, padding_mode="zeros")
        return torch.cat([shared.reshape(B, N, -1), warped], dim=-1)


def make_siren(siren_type: str, *, z_dim: int = 100, input_dim: int = 3,
               output_dim: int = 4, hidden_dim: int = 256, drop_out: float = 0.0,
               mapping_network: str = "CustomMappingNetwork",
               compute_dtype: torch.dtype | None = None, use_fast_sin: bool = False,
               use_kernel: bool = False, generator: torch.Generator | None = None,
               **_unused) -> nn.Module:
    """Build a SIREN variant by reference class name (aliases resolved),
    as siren.py:428-474 does. `z_dim` is the mapping's input: the latent,
    the U-Net's global feature, or TALLSIREN's sampled features; `input_dim`
    the sampled features' width: 3 for points input, the feature volume's
    C, or the pyramid's summed C. The legacy variants take z_dim,
    output_dim and their own widths (EmbeddingPiGAN128: hidden 128, a 96^3
    cube at scale 0.01; 256: hidden 256, 64^3 at 0.1)."""
    siren_type = resolve_siren_alias(siren_type)
    if siren_type in SIREN_SPECS:
        return ConditionedSiren(
            SIREN_SPECS[siren_type], z_dim=z_dim, input_dim=input_dim,
            hidden_dim=hidden_dim, output_dim=output_dim, drop_out=drop_out,
            mapping_network=mapping_network, compute_dtype=compute_dtype,
            use_fast_sin=use_fast_sin, use_kernel=use_kernel, generator=generator)
    legacy = dict(z_dim=z_dim, output_dim=output_dim, drop_out=drop_out,
                  compute_dtype=compute_dtype, use_fast_sin=use_fast_sin, generator=generator)
    if siren_type == "SPATIALSIRENBASELINE":
        return SpatialSirenBaseline(hidden_dim=hidden_dim, **legacy)
    if siren_type == "EmbeddingPiGAN128":
        return EmbeddingPiGAN(hidden_dim=128, embedding_res=96, embedding_scale=0.01,
                              **legacy)
    if siren_type == "EmbeddingPiGAN256":
        return EmbeddingPiGAN(hidden_dim=256, embedding_res=64, embedding_scale=0.1,
                              **legacy)
    raise ValueError(f"Unknown siren_type {siren_type!r}")
