"""The FiLM-SIREN kernel study: the CUDA study kernels' wrapper and their
plain versions.

Port of the Pallas study kernels of scripts/bench_film_kernel.py, which
ablate the FiLM-SIREN forward (`film_siren.py`'s network at the study shape:
xyz points, L layers of 256, 4 outputs) to split its time between the
products and the sin epilogues:
  * "v3" (K3, `_kernel_v3`): point-major, one chain per tile. Modes:
    `single` (fast_sin everywhere), `nosin` (layer 0 keeps fast_sin, the
    trunk layers are 0.9 * (product + c)), `nodot` (layer 0 as in single,
    the trunk layers fast_sin(h + c) on the fp32 h, no product), `jnpsin`
    (accurate sin everywhere).
  * "v4" (K4, `_kernel_v4`): feature-major, activations (H, T) with the
    folded weights the left operand. The mode's activation applies at every
    layer: `full` (fast_sin), `sin7` (K1's function), `nosin` (0.9 * v at
    layer 0 too: not K3's nosin), `nodot` (as K3's nodot).
  * "v5" (K4, `_kernel_v5`): v4 with sin7 and two interleaved half-tile
    chains; mode `interleave`, the function of v4 `sin7`.
The head is bf16(h) . bf16(Wf) + bf in every mode.

  * `film_study_reference(..., kernel, mode)`: the plain version of each
    (kernel, mode): the fold (`fold_film`), bf16 operands summed in
    `accum_dtype`, the mode's activations. The CPU tests hold it against the
    JAX bodies run in interpret mode; chip_smoke.py holds the kernels
    against it on the card.
  * `film_siren_study(..., kernel, mode, tile)`: the wrapper. On CUDA tensors it
    launches `csrc/film_siren_study.cu` (sm_90a) or raises; it never falls
    back. CPU tensors take `film_study_reference`.
    `film_siren_study.launches[kernel]` counts launches.

Tiles: a TPU tile of 512 / 1,024 / 2,048 points is a VMEM block; on the H100
a consumer thread holds T fp32 accumulators for a tile of T points (128 at
T 128, past 240 registers at 256), so the study's tiles map by 1/16 to 32 /
64 / 128 points per CTA. Point-major (K3) tiles are wgmma's M, 64 points a
warpgroup: 128 (two warpgroups taking turns, K1's arrangement) or 64 (both
warpgroups splitting the units); K4 v4 takes 32, 64 and 128, v5 64 and 128
(half a tile a warpgroup). The library compiles the instances the study
launches (its list is in the .cu file) and the wrapper raises for any other.
"""

from __future__ import annotations

import torch

from ..fastmath import fast_sin
from .film_siren import (
    KERNEL_IN,
    KERNEL_OUT,
    _c_function,
    _check_kernel_inputs,
    _fold_for_kernel,
    fold_film,
    sin7,
)

# activation names -> functions; each mode is (layer-0 activation, trunk
# activation, whether the trunk layers take their product)
_ACTS = {"fast_sin": fast_sin, "sin7": sin7, "affine": lambda v: v * 0.9, "sin": torch.sin}
STUDY_MODES = {
    "v3": {"single": ("fast_sin", "fast_sin", True),
           "nosin": ("fast_sin", "affine", True),
           "nodot": ("fast_sin", "fast_sin", False),
           "jnpsin": ("sin", "sin", True)},
    "v4": {"full": ("fast_sin", "fast_sin", True),
           "sin7": ("sin7", "sin7", True),
           "nosin": ("affine", "affine", True),
           "nodot": ("fast_sin", "fast_sin", False)},
    "v5": {"interleave": ("sin7", "sin7", True)},
}
# the values of csrc/film_siren_study.cu's `enum Layout` and `enum Act`, and
# its return for a combination it has no instance of
LAYOUT_IDS = {"v3": 0, "v4": 1, "v5": 2}
ACT_IDS = {"fast_sin": 0, "sin7": 1, "affine": 2, "sin": 3}
_NO_INSTANCE = -1


def film_study_reference(points, freq, phase, w0, b0, ws, bs, wf, bf, kernel="v3",
                         mode="single", accum_dtype=torch.float32):
    """The (kernel, mode) study function in plain torch -> (B, N, 4) fp32.

    Folded weights and every activation operand rounded to bf16, products
    summed in `accum_dtype` (float64: the same roundings with near-exact
    sums, the yardstick for summation-order noise)."""
    act0, act, dot = _mode(kernel, mode)
    L = 1 + ws.shape[0]
    w0f, c0, wsf, cs = fold_film(freq, phase, w0, b0, ws, bs, torch.bfloat16)

    def rnd(t):
        return t.to(torch.bfloat16).to(accum_dtype)

    c0, cs = c0.to(accum_dtype), cs.to(accum_dtype)
    h = act0(torch.bmm(rnd(points), w0f.to(accum_dtype)) + c0[:, None])
    for l in range(L - 1):
        pre = torch.bmm(rnd(h), wsf[:, l].to(accum_dtype)) if dot else h
        h = act(pre + cs[:, l][:, None])
    return (rnd(h) @ rnd(wf) + bf.to(accum_dtype)).float()


def _mode(kernel: str, mode: str):
    if kernel not in STUDY_MODES or mode not in STUDY_MODES[kernel]:
        raise ValueError(f"film_siren_study: no mode {mode!r} of kernel {kernel!r}; the "
                         f"study has {STUDY_MODES}")
    act0, act, dot = STUDY_MODES[kernel][mode]
    return _ACTS[act0], _ACTS[act], dot


def film_siren_study(points, freq, phase, w0, b0, ws, bs, wf, bf, kernel="v3", mode="single",
                     tile=128):
    """One study kernel's forward -> (B, N, 4) fp32.

    CUDA tensors go to the hand-written kernel `kernel` ("v3", "v4", "v5")
    in `mode` with `tile` points per CTA; anything it does not take, an
    uncompiled (kernel, mode, tile) included, raises. CPU tensors take
    `film_study_reference` (the tile does not change the function)."""
    _mode(kernel, mode)
    args = (points, freq, phase, w0, b0, ws, bs, wf, bf)
    if points.device.type == "cpu":
        return film_study_reference(*args, kernel=kernel, mode=mode)
    if points.device.type != "cuda":
        raise ValueError(f"film_siren_study: no kernel for device {points.device}")
    _check_kernel_inputs(*args, name="film_siren_study", widths=(KERNEL_IN,))
    fn = _c_function("film_siren_study", "film_siren_study", 7, 8)
    w0f, c, wsf = _fold_for_kernel(freq, phase, w0, b0, ws, bs)
    # the trunk's weights are K-major, (B, L-1, H_out, H_in), as K1's
    wsf_t = wsf.transpose(-1, -2).contiguous()
    wf16 = wf.to(torch.bfloat16).contiguous()
    bf = bf.contiguous()
    B, N, _ = points.shape
    act0, act, dot = STUDY_MODES[kernel][mode]
    out = torch.empty(B, N, KERNEL_OUT, dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):  # launch on the tensors' card
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = fn(points.data_ptr(), w0f.data_ptr(), c.data_ptr(), wsf_t.data_ptr(),
                 wf16.data_ptr(), bf.data_ptr(), out.data_ptr(), LAYOUT_IDS[kernel],
                 ACT_IDS[act0], ACT_IDS[act], int(dot), tile, B, N, c.shape[1], stream)
    if err == _NO_INSTANCE:
        raise ValueError(f"film_siren_study: csrc/film_siren_study.cu has no instance of "
                         f"{kernel} {mode} at {tile} points per CTA")
    if err != 0:
        raise RuntimeError(f"film_siren_study launch failed: cudaError {err}")
    film_siren_study.launches[kernel] += 1
    return out


film_siren_study.launches = {"v3": 0, "v4": 0, "v5": 0}
