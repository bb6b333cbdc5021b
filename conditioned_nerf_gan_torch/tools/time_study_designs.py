"""Time the study kernels against an earlier design of them, on one card.

    python -m conditioned_nerf_gan_torch.tools.time_study_designs EARLIER_CU
        [--n N] [--iters I]

Builds `EARLIER_CU`, an earlier `csrc/film_siren_study.cu` (for instance
from `git archive <commit> conditioned_nerf_gan_torch/csrc/film_siren_study.cu`
unpacked into a directory that .gitignore lists), with the library's own
nvcc flags, beside the current study library, and times every (kernel,
mode) of the study at 128 points per CTA at the study shape (B 2 x N
786,432, 4 x 256) in both, in turns (earlier, current, current, earlier;
each the minimum of its two readings), with K1 (`film_siren_mlp`) at the
same inputs. Each is first held against `film_study_reference` at freq/30,
and the largest difference printed. The earlier library takes the trunk
weights as (B, L-1, H_in, H_out), the current one K-major, (B, L-1, H_out,
H_in); both have the same C entry. Prints the card's name and power limit
first. Needs a CUDA card (exit 2 without one).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..ops.kernels import build
from ..ops.kernels.film_siren import (
    KERNEL_OUT,
    _fold_for_kernel,
    film_siren_mlp,
)
from ..ops.kernels.film_study import (
    ACT_IDS,
    LAYOUT_IDS,
    STUDY_MODES,
    film_siren_study,
    film_study_reference,
)
from .bench_film_kernel import ARGS, B, N, make_inputs

TILE = 128


def build_earlier(source: Path):
    """The earlier study library, compiled from `source` into the build
    directory (named by its hash); returns its C entry."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(build.NVCC_FLAGS).encode())
    out = build.BUILD_DIR / f"film_siren_study_earlier-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(tmp), str(source)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
        print(f"built the earlier study library in {time.perf_counter() - t0:.2f} s")
    fn = ctypes.CDLL(str(out)).film_siren_study
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def earlier_call(fn, inp: dict, kernel: str, mode: str):
    """A closure launching the earlier design on `inp` (folded once)."""
    args = [inp[k] for k in ARGS]
    w0f, c, wsf = _fold_for_kernel(*args[1:7])
    wf16 = args[7].to(torch.bfloat16).contiguous()
    bf = args[8].contiguous()
    pts = args[0]
    Bb, Nn, _ = pts.shape
    act0, act, dot = STUDY_MODES[kernel][mode]
    out = torch.empty(Bb, Nn, KERNEL_OUT, dtype=torch.float32, device=pts.device)

    def run():
        err = fn(pts.data_ptr(), w0f.data_ptr(), c.data_ptr(), wsf.data_ptr(), wf16.data_ptr(),
                 bf.data_ptr(), out.data_ptr(), LAYOUT_IDS[kernel], ACT_IDS[act0],
                 ACT_IDS[act], int(dot), TILE, Bb, Nn, c.shape[1],
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier study library: {kernel} {mode}: error {err}")
        return out
    return run


def events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("earlier", type=Path, help="an earlier csrc/film_siren_study.cu")
    parser.add_argument("--n", type=int, default=N, help="points per batch element")
    parser.add_argument("--iters", type=int, default=20)
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_study_designs: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    earlier = build_earlier(opt.earlier)
    inp = {k: torch.from_numpy(v).cuda() for k, v in make_inputs(0, opt.n).items()}
    args = [inp[k] for k in ARGS]
    # the check's inputs: freq/30, where no flipped bf16 rounding grows (at
    # the study's freq 25-45 and N(0, 0.1) weights, any two fp32 summation
    # orders already differ by O(1e-2) on average)
    low = dict(inp, freq=inp["freq"] / 30)

    def check(kernel, mode, at, design):
        plain = film_study_reference(*(at[k] for k in ARGS), kernel=kernel, mode=mode)
        run = (earlier_call(earlier, at, kernel, mode) if design == "earlier" else
               lambda: film_siren_study(*(at[k] for k in ARGS), kernel=kernel, mode=mode,
                                        tile=TILE))
        return ((run() - plain).abs().max() / max(1.0, plain.abs().max().item())).item()

    with torch.no_grad():
        k1 = min(events_ms(lambda: film_siren_mlp(*args), opt.iters) for _ in range(2))
        print(f"K1 at {B} x {opt.n}: {k1:.4f} ms")
        for kernel, modes in STUDY_MODES.items():
            for mode in modes:
                old = earlier_call(earlier, inp, kernel, mode)
                new = lambda: film_siren_study(*args, kernel=kernel, mode=mode, tile=TILE)
                errs = [check(kernel, mode, low, design) for design in ("earlier", "current")]
                times = [events_ms(f, opt.iters) for f in (old, new, new, old)]
                t_old, t_new = min(times[0], times[3]), min(times[1], times[2])
                print(f"{kernel} {mode} T={TILE}: earlier {t_old:.4f} ms, current {t_new:.4f} "
                      f"ms (earlier / current {t_old / t_new:.3f}; readings "
                      f"{', '.join(f'{t:.4f}' for t in times)}); at freq/30 max|kernel - "
                      f"plain| / max(1, max|plain|): earlier {errs[0]:.3e}, current "
                      f"{errs[1]:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
