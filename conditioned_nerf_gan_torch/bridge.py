"""Weight bridge: flax param trees and JAX checkpoints -> torch state_dicts.

A flax Dense kernel is (in, out); the torch weight is (out, in). A flax
Conv2d kernel is HWIO and a Conv3d kernel DHWIO; the torch weights are OIHW
and OIDHW. Module names map onto the port's attribute names:
    params.siren.mapping_network.TorchLinear_i -> siren.mapping_network.layers.i
    params.siren.FiLMLayer_i.TorchLinear_0     -> siren.film_layers.i.linear
    params.block_i                             -> blocks.i
    params.fromRGB_i.conv                      -> fromRGB.i.conv
    params.layer_i.conv1|conv2|proj            -> layers.i.conv1|conv2|proj
    params.encoder_i|decoder_i                 -> encoders.i|decoders.i
    ....SingleConv1|SingleConv2.conv|groupnorm -> ....conv1|conv2.conv|norm
and `kernel` -> `weight`, `bias` -> `bias`, a GroupNorm's `scale` ->
`weight` (`final_layer` and `final_conv` keep their names). This is the
inverse of the `t2j_*` helpers of tests/test_models_golden.py.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

_RENAMES = (
    (re.compile(r"mapping_network\.TorchLinear_(\d+)"), r"mapping_network.layers.\1"),
    (re.compile(r"FiLMLayer_(\d+)\.TorchLinear_0"), r"film_layers.\1.linear"),
    (re.compile(r"(^|\.)block_(\d+)"), r"\1blocks.\2"),
    (re.compile(r"(^|\.)fromRGB_(\d+)"), r"\1fromRGB.\2"),
    (re.compile(r"(^|\.)layer_(\d+)"), r"\1layers.\2"),
    (re.compile(r"(^|\.)encoder_(\d+)"), r"\1encoders.\2"),
    (re.compile(r"(^|\.)decoder_(\d+)"), r"\1decoders.\2"),
    (re.compile(r"\.SingleConv([12])\."), r".conv\1."),
    (re.compile(r"\.groupnorm$"), r".norm"),
)


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(_flatten(value, name))
        else:
            flat[name] = np.asarray(value)
    return flat


def params_to_state_dict(flax_tree: dict) -> dict[str, torch.Tensor]:
    """Map a flax param tree of numpy arrays ({"params": ...} or the bare
    tree) to a torch state_dict for the port's generator, PointNet, U-Net
    or discriminator."""
    tree = flax_tree.get("params", flax_tree)
    state = {}
    for name, value in _flatten(tree).items():
        module, leaf = name.rsplit(".", 1)
        for pattern, repl in _RENAMES:
            module = pattern.sub(repl, module)
        if leaf == "kernel":
            if value.ndim == 2:
                weight = value.T
            elif value.ndim == 4:  # HWIO -> OIHW
                weight = value.transpose(3, 2, 0, 1)
            elif value.ndim == 5:  # DHWIO -> OIDHW
                weight = value.transpose(4, 3, 0, 1, 2)
            else:
                raise ValueError(f"{name}: {value.ndim}-D kernels are not bridged")
            state[f"{module}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
        elif leaf == "scale":  # GroupNorm
            state[f"{module}.weight"] = torch.from_numpy(np.array(value))
        elif leaf == "bias":
            state[f"{module}.bias"] = torch.from_numpy(np.array(value))
        else:
            raise ValueError(f"{name}: unknown flax leaf {leaf!r}")
    return state


def convert_checkpoint(path: str | Path) -> Path:
    """Convert a JAX `{step}.ckpt` (flax msgpack) into `{step}.pt` beside it,
    holding {"step", "params_G", "params_E"} as torch state_dicts.
    Needs flax installed; the rest of the port never imports it."""
    from flax import serialization

    path = Path(path)
    raw = serialization.msgpack_restore(path.read_bytes())
    out = path.with_suffix(".pt")
    torch.save({
        "step": int(np.asarray(raw["step"])) if "step" in raw else int(path.stem),
        "params_G": params_to_state_dict(raw["params_G"]),
        "params_E": params_to_state_dict(raw["params_E"]),
    }, out)
    return out
