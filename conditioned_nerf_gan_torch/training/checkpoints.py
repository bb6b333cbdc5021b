"""Checkpoint save/restore with newest-checkpoint auto-resume (port of
conditioned_nerf_gan_tpu/training/checkpoints.py).

Format: `{step}.pt` (torch.save) holding `step`, the three nets' state_dicts
`params_G`, `params_E`, `params_D` (None without a discriminator) and the
three optimizers' state_dicts `opt_G`, `opt_E`, `opt_D`, plus a sidecar
`{step}.json` with the loss histories and the loader position. `params_G`
and `params_E` are the keys `infer.save_checkpoint` writes, so the
Inferencer loads a trainer checkpoint unchanged. A JAX `{step}.ckpt`
becomes one through `bridge.convert_train_checkpoint`.

The resume precedence (newest checkpoint in the run's `checkpoints/`, then
an explicit load path, then a fresh init) is the Trainer's.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import torch

from .train_step import TrainState

_NETS = (("params_G", "generator"), ("params_E", "encoder"), ("params_D", "discriminator"))
_OPTS = ("opt_G", "opt_E", "opt_D")


def find_newest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    """Highest-step `*.pt` in the directory (utils.py:85-93)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    candidates = [p for p in ckpt_dir.glob("*.pt") if p.stem.isdigit()]
    if not candidates:
        return None
    return max(candidates, key=lambda p: int(p.stem))


def _cpu(state: dict):
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in state.items()}


def save_checkpoint(ckpt_dir: str | Path, step: int, state: TrainState,
                    histories: dict | None = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"{step}.pt"
    payload = {"step": state.step}
    for key, attr in _NETS:
        module = getattr(state, attr)
        payload[key] = None if module is None else _cpu(module.state_dict())
    for key in _OPTS:
        opt = getattr(state, key)
        payload[key] = None if opt is None else opt.state_dict()
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
    if histories is not None:
        (ckpt_dir / f"{step}.json").write_text(json.dumps(histories))
    return path


def restore_checkpoint(path: str | Path, state: TrainState,
                       params_only: bool = False) -> tuple[TrainState, dict]:
    """Load a checkpoint into `state`'s modules and optimizers in place.

    `params_only=True` loads just the nets' params (and the step), keeping
    the optimizers' fresh state; a net the state has but the checkpoint
    lacks keeps its fresh params, with a warning. Returns (state,
    histories): histories {} without a sidecar."""
    path = Path(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    for key, attr in _NETS:
        module = getattr(state, attr)
        if module is None:
            continue
        if raw.get(key) is None:
            if not params_only:
                raise KeyError(f"{path}: checkpoint has no {key!r}")
            warnings.warn(f"{path}: checkpoint has no '{key}' subtree; keeping the "
                          "freshly-initialized params for it", stacklevel=2)
            continue
        module.load_state_dict(raw[key])
    if not params_only:
        for key in _OPTS:
            opt = getattr(state, key)
            if opt is None:
                continue
            if raw.get(key) is None:
                raise KeyError(f"{path}: checkpoint has no {key!r}")
            opt.load_state_dict(raw[key])
    if "step" in raw:
        state.step = int(raw["step"])
    sidecar = path.with_suffix(".json")
    histories = json.loads(sidecar.read_text()) if sidecar.exists() else {}
    return state, histories
