"""Metric-net weights (port of conditioned_nerf_gan_tpu/eval/weights.py).

The JAX package's metric weights are flat `.npz` files {flax path: array},
keyed like "params/Mixed_5b/branch1x1/kernel" (its
`tools/port_metric_weights.py` writes them from the reference's pytorch_fid
InceptionV3 and lpips AlexNet checkpoints). `load_flat_weights` copies such
a file into the port's nets: each net names, for every entry of its state
dict, the flax path it comes from (`flax_paths()`); conv kernels arrive
transposed HWIO -> OIHW.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn


def load_flat_weights(module: nn.Module, flat: dict, *, name: str = "weights") -> nn.Module:
    """Copy `flat` into `module`'s params and buffers, in place; returns it.

    Strict, as the JAX loader is: a flax path of the module that `flat`
    lacks, or a shape that differs, raises (KeyError, ValueError). A
    half-loaded metric net gives numbers that look plausible and compare
    to nothing. Entries of `flat` the module does not use are ignored."""
    paths = module.flax_paths()
    missing = sorted(p for p in paths.values() if p not in flat)
    if missing:
        raise KeyError(f"{name}: missing {len(missing)} keys, e.g. {missing[:4]}")
    state = module.state_dict()
    with torch.no_grad():
        for key, path in paths.items():
            arr = np.asarray(flat[path], np.float32)
            target = state[key]
            expected = tuple(target.shape)
            if arr.ndim == 4:  # conv kernel: flax HWIO -> torch OIHW
                expected = (expected[2], expected[3], expected[1], expected[0])
            if arr.shape != expected:
                raise ValueError(f"{name}: shape mismatch at {path}: got {arr.shape}, "
                                 f"expected {expected}")
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            target.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return module


def warn_random_init(env_var: str, what: str) -> None:
    warnings.warn(
        f"{what} is using fixed-seed RANDOM weights ({env_var} not set): "
        "metric values are self-consistent across this framework's runs but "
        "NOT comparable to published numbers. Port real weights with "
        "conditioned_nerf_gan_tpu/tools/port_metric_weights.py and export the env var.",
        stacklevel=3,
    )


def weights_path(env_var: str) -> str | None:
    """The .npz named by `env_var` when it exists, else None."""
    path = os.environ.get(env_var)
    return path if path and os.path.exists(path) else None


def inception_calibrated() -> bool:
    """FID/oFID use real ported InceptionV3 weights (CNG_INCEPTION_WEIGHTS)."""
    return weights_path("CNG_INCEPTION_WEIGHTS") is not None


def lpips_calibrated() -> bool:
    """LPIPS uses real ported AlexNet weights (CNG_LPIPS_WEIGHTS)."""
    return weights_path("CNG_LPIPS_WEIGHTS") is not None


def metrics_calibrated() -> bool:
    """True when every metric net will load real pretrained weights; else
    the missing net's features are fixed-seed random: self-consistent within
    this framework, NOT comparable to published numbers."""
    return inception_calibrated() and lpips_calibrated()


RANDOM_INIT_STAMP_PREFIX = "# RANDOM-INIT FEATURES: "


def stamp_metric_log(path) -> None:
    """Mark a fid.txt-style metric log as uncalibrated before its first
    uncalibrated line: a comment line (the plot parsers skip '#' lines)
    naming the columns whose net has random weights. Added once, also to a
    calibrated log resumed without the weight env vars."""
    path = Path(path)
    uncalibrated = []
    if not inception_calibrated():
        uncalibrated.append("FID/oFID (CNG_INCEPTION_WEIGHTS unset)")
    if not lpips_calibrated():
        uncalibrated.append("LPIPS (CNG_LPIPS_WEIGHTS unset)")
    if not uncalibrated:
        return
    stamp = (
        RANDOM_INIT_STAMP_PREFIX + "; ".join(uncalibrated)
        + " — these columns are self-consistent within this framework only,"
        " NOT comparable to published numbers\n"
    )
    if path.exists():
        if stamp in path.read_text():
            return
        with path.open("a") as f:
            f.write(stamp)
    else:
        path.write_text(stamp)
