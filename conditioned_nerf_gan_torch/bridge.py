"""Weight bridge: flax param trees and JAX checkpoints -> torch state_dicts.

A flax Dense kernel is (in, out); the torch weight is (out, in). A flax
Conv2d kernel is HWIO and a Conv3d kernel DHWIO; the torch weights are OIHW
and OIDHW. Module names map onto the port's attribute names:
    params.siren.mapping_network.TorchLinear_i -> siren.mapping_network.layers.i
    params.siren.FiLMLayer_i.TorchLinear_0     -> siren.film_layers.i.linear
    params.siren.SirenLayer_i.TorchLinear_0    -> siren.siren_layers.i.linear
    params.siren.ResSirenBlock_i.TorchLinear_j -> siren.res_blocks.i.linears.j
    params.block_i                             -> blocks.i
    params.fromRGB_i.conv                      -> fromRGB.i.conv
    params.layer_i.conv1|conv2|proj            -> layers.i.conv1|conv2|proj
    params.encoder_i|decoder_i|upconv_i        -> encoders.i|decoders.i|upconvs.i
    ....SingleConv1|SingleConv2.conv|groupnorm -> ....conv1|conv2.conv|norm
    params.siren.color_layer_sine.TorchLinear_0 -> siren.color_layer_sine.linear
and `kernel` -> `weight`, `bias` -> `bias`, a GroupNorm's or a BatchNorm's
`scale` -> `weight` (`final_layer`, `final_conv`, an ExtResNetBlock's
conv1/2/3, a SingleConv's `batchnorm`, a strided block's conv1/conv2/proj,
`color_layer_linear` and the projection D's ResNet18, `mapping.conv1`,
`mapping.bn1` and `mapping.layer{s}_{b}.conv1|bn1|conv2|bn2|downsample_conv|
downsample_bn`, keep their names). The ResNet18's `fc_kernel` (512, 1600)
becomes `fc.weight` (1600, 512) and `fc_bias` `fc.bias`; EmbeddingPiGAN's
`spatial_embeddings` (1, E, E, E, 32) stays channel-last. Any other leaf
raises. A transposed conv's kernel
(k, k, k, C_in, C_out) becomes the (C_in, C_out, k, k, k) weight of
`F.conv_transpose3d` by a transpose alone: the JAX layer flips it inside
its call, as conv_transpose3d does. This is the inverse of the `t2j_*`
helpers of tests/test_models_golden.py.

Optimizer state crosses with the same names: an optax chain's
`ScaleByAdamState` gives each torch parameter's Adam state, `mu` ->
`exp_avg`, `nu` -> `exp_avg_sq` and `count` -> `step`
(`load_optax_state`); `convert_train_checkpoint` turns a JAX trainer's
`{step}.ckpt` into the port's trainer checkpoint. Both read the flax
msgpack file with the port's own reader (`utils/flax_msgpack.py`): nothing
here imports flax or jax.

The metric nets' weights (the JAX package's flat `.npz` of FID-Inception
and LPIPS-AlexNet, keyed by flax path) load with `load_flat_weights`
(`eval/weights.py`), re-exported here.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from .eval.weights import load_flat_weights  # noqa: F401  (re-exported)
from .utils.flax_msgpack import msgpack_restore

_RENAMES = (
    (re.compile(r"mapping_network\.TorchLinear_(\d+)"), r"mapping_network.layers.\1"),
    (re.compile(r"FiLMLayer_(\d+)\.TorchLinear_0"), r"film_layers.\1.linear"),
    (re.compile(r"SirenLayer_(\d+)\.TorchLinear_0"), r"siren_layers.\1.linear"),
    (re.compile(r"ResSirenBlock_(\d+)\.TorchLinear_(\d+)"), r"res_blocks.\1.linears.\2"),
    (re.compile(r"(^|\.)upconv_(\d+)"), r"\1upconvs.\2"),
    (re.compile(r"(^|\.)block_(\d+)"), r"\1blocks.\2"),
    (re.compile(r"(^|\.)fromRGB_(\d+)"), r"\1fromRGB.\2"),
    (re.compile(r"(^|\.)layer_(\d+)"), r"\1layers.\2"),
    (re.compile(r"(^|\.)encoder_(\d+)"), r"\1encoders.\2"),
    (re.compile(r"(^|\.)decoder_(\d+)"), r"\1decoders.\2"),
    (re.compile(r"\.SingleConv([12])\."), r".conv\1."),
    (re.compile(r"\.groupnorm$"), r".norm"),
    (re.compile(r"color_layer_sine\.TorchLinear_0"), r"color_layer_sine.linear"),
)


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(_flatten(value, name))
        else:
            flat[name] = value if isinstance(value, torch.Tensor) else np.asarray(value)
    return flat


def _tensor(value, *dims) -> torch.Tensor:
    """A leaf (numpy, or a torch tensor where numpy has no dtype for it) as a
    contiguous torch tensor, its axes permuted to `dims` if given."""
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
    return t.permute(*dims).contiguous() if dims else t.clone()


def params_to_state_dict(flax_tree: dict) -> dict[str, torch.Tensor]:
    """Map a flax param tree of numpy arrays ({"params": ...} or the bare
    tree) to a torch state_dict for the port's generator, PointNet, U-Net
    or discriminator."""
    tree = flax_tree.get("params", flax_tree)
    state = {}
    for name, value in _flatten(tree).items():
        module, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        for pattern, repl in _RENAMES:
            module = pattern.sub(repl, module)
        prefix = f"{module}." if module else ""
        if leaf == "kernel":
            if value.ndim == 2:
                weight = _tensor(value, 1, 0)
            elif value.ndim == 4:  # HWIO -> OIHW
                weight = _tensor(value, 3, 2, 0, 1)
            elif value.ndim == 5 and ".upconvs." in f".{module}.":
                weight = _tensor(value, 3, 4, 0, 1, 2)  # DHWIO -> IODHW (transposed conv)
            elif value.ndim == 5:  # DHWIO -> OIDHW
                weight = _tensor(value, 4, 3, 0, 1, 2)
            else:
                raise ValueError(f"{name}: {value.ndim}-D kernels are not bridged")
            state[f"{prefix}weight"] = weight
        elif leaf == "scale":  # GroupNorm, BatchNorm
            state[f"{prefix}weight"] = _tensor(value)
        elif leaf == "bias":
            state[f"{prefix}bias"] = _tensor(value)
        elif leaf == "fc_kernel":  # the ResNet18's head, x @ kernel
            state[f"{prefix}fc.weight"] = _tensor(value, 1, 0)
        elif leaf == "fc_bias":
            state[f"{prefix}fc.bias"] = _tensor(value)
        elif leaf == "spatial_embeddings":  # (1, E, E, E, 32), channel-last in both
            state[f"{prefix}spatial_embeddings"] = _tensor(value)
        else:
            raise ValueError(f"{name}: unknown flax leaf {leaf!r}")
    return state


def convert_checkpoint(path: str | Path) -> Path:
    """Convert a JAX `{step}.ckpt` (flax msgpack) into `{step}.pt` beside it,
    holding {"step", "params_G", "params_E"} as torch state_dicts. The
    file is read by the port's own msgpack reader (`utils/flax_msgpack.py`)."""
    path = Path(path)
    raw = msgpack_restore(path.read_bytes())
    out = path.with_suffix(".pt")
    torch.save({
        "step": int(np.asarray(raw["step"])) if "step" in raw else int(path.stem),
        "params_G": params_to_state_dict(raw["params_G"]),
        "params_E": params_to_state_dict(raw["params_E"]),
    }, out)
    return out


def _adam_state(tree):
    """The (count, mu, nu) of the first ScaleByAdamState in an optax chain
    state: a live pytree (namedtuples) or its msgpack restore (dicts)."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree["count"], tree["mu"], tree["nu"]
        children = tree.values()
    elif all(hasattr(tree, name) for name in ("count", "mu", "nu")):
        return tree.count, tree.mu, tree.nu
    elif isinstance(tree, (tuple, list)):
        children = tree
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def load_optax_state(opt_state, module: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> None:
    """Carry a JAX optax chain's Adam moments into `optimizer`, whose
    parameters are `module`'s (with the params already bridged): each
    parameter's exp_avg, exp_avg_sq and step."""
    found = _adam_state(opt_state)
    if found is None:
        raise ValueError("the optax state holds no ScaleByAdamState")
    count, mu, nu = found
    mu = params_to_state_dict(_numpy_tree(mu))
    nu = params_to_state_dict(_numpy_tree(nu))
    params = dict(module.named_parameters())
    if set(mu) != set(params):
        raise ValueError(f"the optax moments name {sorted(set(mu) ^ set(params))} "
                         "that the module lacks, or the other way round")
    owned = {id(p) for group in optimizer.param_groups for p in group["params"]}
    step = float(np.asarray(count))
    for name, p in params.items():
        if id(p) not in owned:
            raise ValueError(f"{name} is not one of the optimizer's parameters")
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).clone(),
        }


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def convert_train_checkpoint(path: str | Path) -> Path:
    """Convert a JAX trainer's `{step}.ckpt` (its whole TrainState) into the
    port's trainer checkpoint `{step}.pt` beside it, which shares the JAX
    sidecar `{step}.json` (histories and loader position, one format in
    both packages): the three nets' params and the three
    optimizers' Adam state, for the models and learning rates of the run's
    curriculum (`{run}/curriculum.json`, else the thousand preset) at that
    step. Runs on the CPU."""
    from .infer.inference import build_models, load_metadata
    from .models.discriminators import make_discriminator
    from .training.checkpoints import save_checkpoint
    from .training.train_step import TrainStepConfig, create_train_state

    path = Path(path)
    raw = msgpack_restore(path.read_bytes())
    step = int(np.asarray(raw["step"])) if "step" in raw else int(path.stem) + 1
    meta = load_metadata(int(path.stem), path.parent.parent)
    G, E = build_models(meta)
    D = (make_discriminator(meta["discriminator"]) if raw.get("params_D") is not None
         else None)
    if D is None:
        meta = dict(meta, enable_discriminator=False)
    state = create_train_state(G, E, D, TrainStepConfig.from_metadata(meta))
    state.step = step
    for net, module, opt in (("G", G, state.opt_G), ("E", E, state.opt_E),
                             ("D", D, state.opt_D)):
        if module is None:
            continue
        module.load_state_dict(params_to_state_dict(_numpy_tree(raw[f"params_{net}"])))
        load_optax_state(raw[f"opt_{net}"], module, opt)
    return save_checkpoint(path.parent, int(path.stem), state)
