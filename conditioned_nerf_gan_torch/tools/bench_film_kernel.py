"""FiLM-SIREN kernel study on the H100 (port of scripts/bench_film_kernel.py).

    python -m conditioned_nerf_gan_torch.tools.bench_film_kernel [variants...]
        [--device cuda|cpu] [--n N]

Times the FiLM-SIREN forward at the study shape (B 2 x N 786,432 xyz points,
SHORTSIREN's 4 layers of 256, 4 outputs) in the JAX script's variants, to
split K1's time between the tensor-core products and the sin epilogues:
    xla            the plain folded version: bf16 products with fp32
                   outputs (torch.bmm out_dtype on the card), fast_sin
    xla_unfolded   film_siren_mlp_reference (fp32, exact sin)
    v2             K1, the serving kernel (csrc/film_siren_fwd.cu)
    single*        K3 (point-major) with fast_sin, tile sweep
    nosin          K3 with the trunk sins replaced by 0.9 v (the product rate)
    nodot          K3 with the trunk products dropped (the sin rate)
    jnpsin         K3 with accurate sinf
    v4*            K4 (feature-major): full (fast_sin) tile sweep, nosin,
                   nodot, sin7 (K1's function)
    v5*            K4 v5: two interleaved half-tile chains, sin7
    vjp_xla        forward and backward: autograd through the plain version
    vjp_kernel     forward and backward: K1 and K2 (`FilmSirenMLP`)
The default set is `xla v2 single nosin nodot`.

Tiles: the JAX names carry the TPU tile (points per VMEM block: 512, 1,024,
2,048). On the H100 a consumer thread of the study kernels holds T fp32
accumulators for a tile of T points per CTA, so the tiles map by 1/16 to
32, 64 and 128 points per CTA, and each line is named by that Hopper tile
(e.g. `single` prints `v3_single_64`). Point-major (K3) tiles are wgmma's
M, 64 points a warpgroup: 128 (K1's arrangement, two warpgroups taking
turns) or 64 (both warpgroups splitting the units of one tile, in turn
with h staged in shared memory); K4 v4 runs at 32, 64 and 128 points (the
N of its products), v5 at 64 and 128 (half a tile a warpgroup). The JAX
script's other names are refused (exit 2) with the reason (`REFUSED`):
`single512` (32 points is half a warpgroup's M), its 4,096-point tiles
(`single4096`, `v4_4096`) and its backward-tile sweep (`vjp_kernel_512`,
`vjp_kernel_2048`).

Protocol, as the JAX script's: the inputs from `make_inputs(seed)` (the same
numpy draws in the same order), 20 chained iterations per trial, each
feeding points + 1e-6 * out[..., :3] into the next, the minimum over seeds
0, 1, 2; timed with CUDA events after one warm-up iteration, and printed as
`label: ms (Mpts/s)` under a header with the card's name and power limit.
With `--device cpu` it runs the plain versions only (each wrapper takes its
plain version for CPU tensors), timed with the host clock, at the `--n` the
caller picks; without a card, `--device cuda` exits 2.
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops.fastmath import fast_sin
from ..ops.kernels.film_siren import film_siren_mlp, film_siren_mlp_reference, fold_film
from ..ops.kernels.film_study import STUDY_MODES, film_siren_study, film_study_reference

B, N, DIN, H, L, C = 2, 786432, 3, 256, 4, 4
ITERS = 20
SEEDS = (0, 1, 2)
DEFAULT_VARIANTS = ("xla", "v2", "single", "nosin", "nodot")
ARGS = ("points", "freq", "phase", "w0", "b0", "ws", "bs", "wf", "bf")


def make_inputs(seed: int, n: int = N) -> dict[str, np.ndarray]:
    """The JAX script's study inputs (the same draws in the same order)."""
    rng = np.random.default_rng(seed)
    return dict(
        points=rng.uniform(-0.3, 0.3, (B, n, DIN)).astype(np.float32),
        freq=rng.uniform(25, 45, (B, L * H)).astype(np.float32),
        phase=rng.uniform(-1, 1, (B, L * H)).astype(np.float32),
        w0=rng.normal(0, 0.5, (DIN, H)).astype(np.float32),
        b0=rng.normal(0, 0.1, (H,)).astype(np.float32),
        ws=rng.normal(0, 0.1, (L - 1, H, H)).astype(np.float32),
        bs=rng.normal(0, 0.1, (L - 1, H)).astype(np.float32),
        wf=rng.normal(0, 0.1, (H, C)).astype(np.float32),
        bf=rng.normal(0, 0.1, (C,)).astype(np.float32),
    )


def xla_prod(points, freq, phase, w0, b0, ws, bs, wf, bf):
    """The plain folded version of K3's `single` mode, as the JAX script's
    unfused production analogue: bf16 operands with fp32 accumulation and
    outputs (torch.bmm's out_dtype on the card; fp32 products of the rounded
    operands on the CPU), fast_sin."""
    if points.device.type != "cuda":
        return film_study_reference(points, freq, phase, w0, b0, ws, bs, wf, bf,
                                    kernel="v3", mode="single")
    bf16, f32 = torch.bfloat16, torch.float32
    w0f, c0, wsf, cs = fold_film(freq, phase, w0, b0, ws, bs, bf16)
    h = fast_sin(torch.bmm(points.to(bf16), w0f, out_dtype=f32) + c0[:, None])
    for l in range(ws.shape[0]):
        h = fast_sin(torch.bmm(h.to(bf16), wsf[:, l], out_dtype=f32) + cs[:, l][:, None])
    head = wf.to(bf16).expand(points.shape[0], *wf.shape)
    return torch.bmm(h.to(bf16), head, out_dtype=f32) + bf


def _study(kernel: str, mode: str, tile: int):
    return functools.partial(film_siren_study, kernel=kernel, mode=mode, tile=tile)


# name -> (printed label, forward function); labels carry the Hopper tile
VARIANTS = {
    "xla": ("xla_prod", xla_prod),
    "xla_unfolded": ("xla_unfolded", film_siren_mlp_reference),
    "v2": ("k1_fwd_128", film_siren_mlp),
    "single": ("v3_single_64", _study("v3", "single", 64)),
    "single2048": ("v3_single_128", _study("v3", "single", 128)),
    "nosin": ("v3_nosin_64", _study("v3", "nosin", 64)),
    "nodot": ("v3_nodot_64", _study("v3", "nodot", 64)),
    "jnpsin": ("v3_jnpsin_64", _study("v3", "jnpsin", 64)),
    "v4": ("v4_full_64", _study("v4", "full", 64)),
    "v4_512": ("v4_full_32", _study("v4", "full", 32)),
    "v4_2048": ("v4_full_128", _study("v4", "full", 128)),
    "v4_nosin": ("v4_nosin_128", _study("v4", "nosin", 128)),
    "v4_nodot": ("v4_nodot_128", _study("v4", "nodot", 128)),
    "v4_sin7": ("v4_sin7_128", _study("v4", "sin7", 128)),
    "v5": ("v5_interleave_128", _study("v5", "interleave", 128)),
    "v5_sin7_1024": ("v5_interleave_64", _study("v5", "interleave", 64)),
}
# the JAX script's tile sweeps
SWEEPS = ("single2048", "v4", "v4_512", "v4_2048", "v5", "v5_sin7_1024")
_TILE_32 = ("a 512-point TPU tile would be 32 points per CTA, but a point-major tile is "
            "wgmma's M, 64 points a warpgroup: K3 runs at 64 and 128 points "
            "(ROADMAP.md B)")
_TILE_256 = ("a 4,096-point TPU tile would be 256 points per CTA: 256 fp32 accumulators a "
             "consumer thread, past the 240 registers it gets, and 256 KB of "
             "double-buffered h in shared memory (ROADMAP.md B)")
_BWD_TILE = ("the TPU backward-tile sweep has no counterpart: K2's tile is fixed at 128 "
             "points and its 4,096-point weight-grad segment is not a setting "
             "(ROADMAP.md B); `vjp_kernel` runs K1 + K2")
# names of the JAX script the port does not run, and why
REFUSED = {"single512": _TILE_32, "single4096": _TILE_256, "v4_4096": _TILE_256,
           "vjp_kernel_512": _BWD_TILE, "vjp_kernel_2048": _BWD_TILE}


def kernel_instances() -> list[tuple[str, str, int]]:
    """(kernel, mode, points per CTA) of every study-kernel instance the
    variants launch, and of every mode at K1's 128 points per CTA (the tile
    at which chip_smoke.py times the modes side by side)."""
    launched = {(f.keywords["kernel"], f.keywords["mode"], f.keywords["tile"])
                for _, f in VARIANTS.values() if isinstance(f, functools.partial)}
    at_128 = {(k, m, 128) for k, modes in STUDY_MODES.items() for m in modes}
    return sorted(launched | at_128)


def _autograd_vjp(fn):
    """out and the nine input grads of fn by autograd, for the cotangent
    ones + 1e-6 * out (the JAX script's)."""
    def run(args):
        args = [a.detach().requires_grad_() for a in args]
        with torch.enable_grad():
            out = fn(*args)
            grads = torch.autograd.grad(out, args, torch.ones_like(out) + 1e-6 * out.detach())
        return out.detach(), grads
    return run


VJP_VARIANTS = {
    "vjp_xla": ("vjp_xla_prod", _autograd_vjp(functools.partial(
        film_study_reference, kernel="v3", mode="single"))),
    "vjp_kernel": ("vjp_k1_k2", _autograd_vjp(film_siren_mlp)),
}


def _chain(name: str, inp: dict[str, torch.Tensor], iters: int) -> torch.Tensor:
    """`iters` chained evaluations of variant `name` (the data dependence of
    the JAX script's fori_loop); returns the accumulator."""
    pts, rest = inp["points"], [inp[k] for k in ARGS[1:]]
    acc = torch.zeros((), device=pts.device)
    for _ in range(iters):
        if name in VJP_VARIANTS:
            _, grads = VJP_VARIANTS[name][1]([pts, *rest])
            pts = pts + 1e-6 * grads[0]
            acc = acc + grads[3][0, 0]
        else:
            with torch.no_grad():
                out = VARIANTS[name][1](pts, *rest)
            pts = pts + 1e-6 * out[..., :3]
            acc = acc + out[0, 0, 0]
    return acc


def time_variant(name: str, device: str = "cuda", n: int = N, seeds=SEEDS,
                 iters: int = ITERS) -> float:
    """Milliseconds per evaluation of variant `name`: the minimum over seeds
    of `iters` chained evaluations (CUDA events on the card, the host clock
    on the CPU), each after one warm-up evaluation."""
    best = float("inf")
    for seed in seeds:
        inp = {k: torch.from_numpy(v).to(device) for k, v in make_inputs(seed, n).items()}
        _chain(name, inp, 1)
        if device == "cpu":
            t0 = time.perf_counter()
            _chain(name, inp, iters)
            ms = (time.perf_counter() - t0) * 1e3 / iters
        else:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _chain(name, inp, iters)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        best = min(best, ms)
    return best


def label(name: str) -> str:
    return (VJP_VARIANTS if name in VJP_VARIANTS else VARIANTS)[name][0]


def result_line(name: str, ms: float, n: int = N) -> str:
    unit = "Mpts/s fwd+bwd" if name in VJP_VARIANTS else "Mpts/s"
    return f"{label(name):>22}: {ms:8.4f} ms  ({B * n / ms / 1e3:7.1f} {unit})"


def header(device: str, n: int = N, seeds=SEEDS, iters: int = ITERS) -> str:
    if device == "cpu":
        where = "cpu (plain versions only; host clock)"
    else:
        where = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], check=True, capture_output=True,
                               text=True).stdout.strip().splitlines()[0]
    return (f"device: {where}; {B}x{n} points, {L}x{H} SHORTSIREN, {iters} chained "
            f"iters/trial, min over seeds {tuple(seeds)}")


def run_study(names, device: str = "cuda", n: int = N, seeds=SEEDS,
              iters: int = ITERS) -> list[tuple[str, float]]:
    """Time and print each variant; returns [(name, ms)]."""
    results = []
    for name in names:
        ms = time_variant(name, device, n, seeds, iters)
        print(result_line(name, ms, n), flush=True)
        results.append((name, ms))
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", default=list(DEFAULT_VARIANTS))
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--n", type=int, default=N, help="points per batch element")
    opt = parser.parse_args(argv)
    refused = [v for v in opt.variants if v in REFUSED]
    for name in refused:
        print(f"{name}: not run: {REFUSED[name]}", file=sys.stderr)
    unknown = [v for v in opt.variants
               if v not in VARIANTS and v not in VJP_VARIANTS and v not in REFUSED]
    if unknown:
        print(f"unknown variants {unknown}; the study has "
              f"{sorted(VARIANTS) + sorted(VJP_VARIANTS)}", file=sys.stderr)
    if refused or unknown:
        return 2
    if opt.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA GPU is available; pass --device cpu to run the "
              "plain versions", file=sys.stderr)
        return 2
    if opt.device == "cuda":
        # the plain versions' fp32 products in full fp32
        torch.backends.cuda.matmul.allow_tf32 = False
    print(header(opt.device, opt.n), flush=True)
    run_study(opt.variants, opt.device, opt.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
