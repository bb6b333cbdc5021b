"""The thesis model in plain fp32: ResnetPointnet 512/512 on colored point
clouds, SHORTSIREN (4 FiLM layers of 256, CustomMappingNetwork from the
512-d latent), the progressive discriminator."""

from __future__ import annotations

from .. import counts
from .plain import (Generator, MLPMapping, FilmSiren, ProgressiveDiscriminator,
                    ResnetPointnet, exact)

ENCODER = "pcl"


def build(config: dict, q=exact) -> dict:
    """The configuration's modules, their operands through `q`."""
    m = config["model"]
    H, L = m["siren_hidden"], m["siren_layers"]
    mapping = MLPMapping(m["z_dim"], m["mapping_hidden"], L * H * 2, m["mapping_layers"] - 1, q)
    siren = FilmSiren(L, m["siren_input_dim"], H, mapping, features_input=False, q=q,
                      freq_init=m["freq_init"])
    return {"generator": Generator(siren),
            "encoder": ResnetPointnet(m["z_dim"], m["point_dim"], m["pointnet_hidden"], q),
            "discriminator": ProgressiveDiscriminator(q)}


# the shapes and forward FLOPs of this configuration's nets, for counts.py


def encoder_shapes(config: dict, meta: dict, overrides: dict) -> dict:
    m = config["model"]
    return {"kind": "pcl", "points": overrides.get("points", config["points_per_cloud"]),
            "dim": m["point_dim"], "hidden": m["pointnet_hidden"], "c_dim": m["z_dim"]}


def encoder_flops(enc: dict, clouds: int) -> int:
    return counts.pointnet_flops(clouds, enc["points"], enc["dim"], enc["hidden"], enc["c_dim"])


def mapping_dims(config: dict) -> list:
    m = config["model"]
    return ([m["z_dim"]] + [m["mapping_hidden"]] * (m["mapping_layers"] - 1)
            + [2 * m["siren_layers"] * m["siren_hidden"]])


def discriminator_flops(batch: int, img: int) -> int:
    return counts.progressive_d_flops(batch, img)
