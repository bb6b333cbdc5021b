"""The `dg` model in plain fp32: UNet3D (4 -> f_maps 32, 4 levels, the
bottleneck's mean as the global feature) on 64^3 grids, TALLSIREN_FG (8 FiLM
layers of 256 on the 32 features sampled from the volume, FiLM from a linear
mapping of the 256-d global feature). No discriminator."""

from __future__ import annotations

from .. import counts
from .plain import FilmSiren, Generator, LinearMapping, UNet3D, exact

ENCODER = "voxel"


def build(config: dict, q=exact) -> dict:
    """The configuration's modules, their operands through `q`."""
    m = config["model"]
    H, L = m["siren_hidden"], m["siren_layers"]
    siren = FilmSiren(L, m["siren_input_dim"], H, LinearMapping(m["z_dim"], L * H * 2, q),
                      features_input=True, q=q, freq_init=m["freq_init"])
    u = m["unet"]
    return {"generator": Generator(siren),
            "encoder": UNet3D(u["in_channels"], u["out_channels"], u["f_maps"],
                              u["num_levels"], q),
            "discriminator": None}


# the shapes and forward FLOPs of this configuration's nets, for counts.py


def encoder_shapes(config: dict, meta: dict, overrides: dict) -> dict:
    u = config["model"]["unet"]
    return {"kind": "voxel", "side": meta["voxel_resolution"], "levels": u["num_levels"],
            **{k: u[k] for k in ("in_channels", "out_channels", "f_maps")}}


def encoder_flops(enc: dict, clouds: int) -> int:
    return counts.unet3d_flops(clouds, enc["side"], enc["in_channels"], enc["f_maps"],
                               enc["levels"], enc["out_channels"])


def mapping_dims(config: dict) -> list:
    m = config["model"]
    return [m["z_dim"], 2 * m["siren_layers"] * m["siren_hidden"]]


def discriminator_flops(batch: int, img: int) -> int:
    return 0
