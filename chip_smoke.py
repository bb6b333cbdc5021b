#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Refuses to run without CUDA (exit 1). Otherwise:
  0. reports the card (nvidia-smi name and power limit), torch, CUDA, nvcc
     and triton, and builds the CUDA kernels from `conditioned_nerf_gan_torch/csrc`;
  1. holds the FiLM-SIREN kernel against its plain torch version
     (`film_siren_mlp_folded`, same bf16-operand math) at the thesis render
     shape, at the training chunk (12 x 49,152, where most of its main-path
     launches run), at the serving ray chunk and at a ragged N, and times
     both with CUDA events, each time beside its bound and kernel / bound;
 1b. the same at the voxel family's shape (Din 32, 8 layers) at 2 x 786,432,
     at the `dg` serving ray chunk (2 x 49,152) and a ragged 2 x 1,000;
  2. drives the port's serving path: the thesis model (`thousand` preset +
     special.py: PointNet 512/512, SHORTSIREN z 512, 4 x 256) with seeded
     random weights is saved as a port checkpoint, loaded by `Inferencer`,
     and answers 4 requests (2 colored point clouds each) through
     `encode` -> `render_batched` at 128^2 with 48 + 48 samples. It checks
     finite output in range, that every render went through the kernel,
     and one render against the same render with the plain version in the
     kernel's place;
  3. profiles the last request once more: device busy time and share of
     the request's wall time, and the kernels that take the most of it;
  4. holds the FiLM-SIREN backward kernel against its plain torch version
     (`film_siren_mlp_folded_vjp`, same bf16 roundings) at the 1.57M-point
     study shape, at the training chunk the main path gives it and at a
     ragged N: norm-relative error, a low-frequency max, distance to fp64
     sums against the plain version's, bitwise-equal repeats; and times both,
     beside the bound;
  5. drives the port's training path: the thesis model at stage 2 (step
     16000, fade-in alpha 0.5) at full width, the discriminator with R1,
     batch 12 at 128^2, 48 + 48 samples, ray_chunks 16, through
     `make_train_step`: one warm-up and three timed steps (s/step, peak
     memory, kernel launches per step against the design's count), finite
     losses, all three nets moved, one step against the same step with the
     plain versions in both kernels' places, and one profiled step;
  6. holds the trilinear-sampling kernel against its plain torch version
     (`border_trilerp_reference`, the same fp32 lerps) on a 2 x 64^3 x 32
     feature volume at 2 x 786,432 points, at a ragged 2 x 1,000 and on
     points outside the cube and on its faces, and times both (with
     `F.grid_sample` beside them as a yardstick);
  7. drives the voxel-conditioned serving path: the `dg` preset (UNet3D
     4 -> 32, f_maps 32, 4 levels; TALLSIREN_FG, 8 x 256 on 32 sampled
     features) at step 30000 with seeded random weights, saved as a port
     run, loaded by `Inferencer`, answers 4 requests (2 voxelised point
     clouds at 64^3 each) through `encode` -> `render_batched` at 128^2 with
     48 + 48 samples: launches of both kernels per request against the
     design's count, finite output in range, one render against the same
     render with both plain versions in the kernels' places, and one
     profiled request;
  8. the FiLM-SIREN kernel study: holds each study kernel (K3 point-major,
     K4 v4 feature-major, K4 v5 interleaved) in each of its modes, at every
     tile the study tool launches it with and at T 128, against its plain
     version (`film_study_reference`) at the study shape (2 x 786,432, 4 x
     256) and a ragged 2 x 1,000, times each mode and its plain version at
     T 128, prints K1's phase-1 time at 2 x 786,432 beside K4 v4 `sin7`'s
     (K1's function in its earlier mma.sync design, the same run), then runs the
     study tool's variants (the default set, the tile sweeps, the other
     modes and K1 + K2's VJP) through `run_study`, counting launches.
Prints one JSON line of kernel results (each kernel's time beside its plain
version's, the least time the card could take for the same work, and the
one PyTorch call that computes the same function where there is one; K1 and
K2 at the training chunk, the `dg` K1 at its serving chunk, the other shapes
under `ms_by_shape`), then
the last line {"ok": true, "device": {...}}. Any failed check raises
(non-zero exit); checks of phases 1b and 4-8 raise after phase 8, so one run
reports them all.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Phase 1 bounds, each about twice the sound kernel's reading on the H100
# (in brackets: the largest over the three shapes), far below the O(0.1-1)
# error of a layout or indexing fault. The plain comparator
# `film_siren_mlp_folded` has the same bf16-operand math and sums in fp32 in
# another order.
# freq/30, max|kernel - folded|: nothing amplifies a rounding flip [1.37e-3]
KERNEL_LOW_TOL = 3e-3
# freq 25-45 (the model's range): a summation-order difference that flips a
# bf16 rounding of h grows ~2x per layer, so the max is set by the plain
# version's own fp32 noise (3.4e-2 from fp64 sums at the thesis shape, as
# far as the kernel's 3.5e-2); held instead:
KERNEL_MEAN_TOL = 3e-4  # mean|kernel - folded| [1.21e-4]
KERNEL_Q999_TOL = 1.5e-2  # 99.9th percentile of |kernel - folded| [7.92e-3]
KERNEL_VS_PLAIN = 1.25  # max|kernel - fp64 sums| / max|folded - fp64 sums| [1.040]
# one 128^2 render, kernel vs plain folded in its place. With random weights
# sigma sits near 0, and the last sample's 1e10 delta turns any sign flip of
# relu(sigma) there into a whole-pixel change, so the bound is on the mean
# and on the share of pixels off by more than RENDER_TOL, not on the max.
RENDER_TOL = 2e-2
RENDER_MEAN_TOL = 2e-4  # [5.2e-7; 3.2e-5 with one flipped pixel]
RENDER_OVER_SHARE = 3e-4  # [0; 3.1e-5 = 1 pixel of 32,768]
THESIS_STEP = 30000  # a step in the last curriculum stage: ray_chunks 16
# Phase 1b bounds: K1 at Din 32 and L 8 against `film_siren_mlp_folded`
# (inputs at TALLSIREN_FG's init, whose head is 10x smaller than phase 1's),
# in phase 1's style, each about twice the kernel's H100 reading [in
# brackets: the larger of the two shapes]. As in phase 1 the max at freq
# 25-45 is set by the plain version's own fp32 noise (3.1e-3 from fp64 sums
# at 2 x 786,432, as far as the kernel's).
DIN32_LOW_TOL = 5e-5  # freq/30, max|kernel - folded| [2.21e-5]
DIN32_MEAN_TOL = 5e-5  # freq 25-45, mean|kernel - folded| [2.36e-5]
DIN32_Q999_TOL = 2e-3  # 99.9th percentile of |kernel - folded| [9.36e-4]
DIN32_VS_PLAIN = 1.25  # max|kernel - fp64 sums| / max|folded - fp64 sums| [1.000]
# Phase 6: the kernel and `border_trilerp_reference` round the same fp32
# lerps in the same order, so they should agree to the bit; the bound is
# relative to the volume's largest value.
TRILERP_TOL = 1e-5  # max|kernel - plain| / max|volume|
VOXEL_RES = 64
VOXEL_PCL_POINTS = 16384
DG_STEP = 30000  # stage 3 of the dg curriculum: ray_chunks 16
# Phase 4 bounds for each of the nine grads of the backward kernel against
# `film_siren_mlp_folded_vjp` (same bf16 roundings of h, cos7, g and dpre;
# fp32 sums in another order), each about twice the sound kernel's H100
# reading or above it by a fifth [in brackets: the largest over the nine
# grads and three shapes]. As in phase 1, a summation-order difference flips
# a bf16 rounding, which grows through the layers at freq 25-45; a layout or
# indexing fault reads O(0.1-1).
BWD_NORM_TOL = 3e-3  # |K2 - plain|_2 / |plain|_2 at freq 25-45 [1.39e-3]
BWD_LOW_TOL = 7e-3  # max|K2 - plain| / max|plain| at freq/30 [3.57e-3]
# Distance to the same math with fp64 sums, against the plain version's:
# |K2 - fp64|_2 <= BWD_VS_PLAIN * |plain - fp64|_2 [1.182], and the max,
# whose ratio swings with the few points that dominate it, <= BWD_VS_PLAIN_MAX
# times [1.380]; each plus BWD_ULPS roundings of the grad's largest value (an
# fp32 result is that far from the fp64 sums whatever the order of its sums).
BWD_VS_PLAIN = 1.25
BWD_VS_PLAIN_MAX = 1.6
BWD_ULPS = 8 * 2.0 ** -24
# Phase 5: one train step with the kernels against the same step with the
# plain versions in their places (same state, batch and random numbers). A
# flipped pixel (sign of relu(sigma) at the last sample) moves a loss by
# ~2e-5 and the grads by ~1e-3.
STEP_LOSS_TOL = 1e-4  # |kernel - plain| / |plain| for each loss [1.06e-6]
STEP_GRAD_TOL = 5e-3  # |kernel - plain|_2 / |plain|_2 over a net's grads [8.75e-5]
TRAIN_STEP = 16000  # stage 2 of the thesis curriculum, fade-in alpha 0.5
TRAIN_TIMED_STEPS = 3
# Phase 8 bounds for each study kernel against its plain version
# `film_study_reference` (same bf16 operands, fp32 sums in another order),
# on phase 1's inputs, in phase 1's style; relative to max(1, max|plain|)
# (the `nosin` modes' outputs reach ~900). Each is about twice the largest
# H100 reading over the nine (kernel, mode) pairs, their tiles and both
# shapes [in brackets], far below the O(0.1-1) of a layout or masking fault.
STUDY_LOW_TOL = 2e-3  # freq/30: max|kernel - plain| [9.65e-4, v3 nosin]
STUDY_MEAN_TOL = 7e-5  # freq 25-45: mean|kernel - plain| [3.34e-5, v3/v4 single ragged]
STUDY_Q999_TOL = 4e-3  # 99.9th percentile of |kernel - plain| [2.03e-3, the same]
# max|kernel - fp64 sums| <= STUDY_VS_PLAIN x max|plain - fp64 sums| + 8
# fp32 roundings of max|fp64 sums|, as in phase 1 [1.112, v3 nosin ragged]
STUDY_VS_PLAIN = 1.25
STUDY_TILE = 128  # points per CTA of the timed modes: K1's tile
# peaks of an H100 SXM (NVIDIA's data sheet) for the bounds: dense bf16 on
# the tensor cores, FP32 instructions on the CUDA cores (67 TFLOP/s counts
# an FMA as two), HBM3
H100_BF16_FLOPS = 989e12
H100_FP32_INSTRUCTIONS = 33.5e12
H100_HBM_BYTES = 3.35e12
# FP32 instructions per activation element, the bias add included:
# fast_sin (range reduction 4, square 1, 5 FMAs, 1 multiply), sin7 (4, 1, 3,
# 1), accurate sinf (its fast path, about 20), 0.9 v (2)
ACT_INSTRUCTIONS = {"fast_sin": 12, "sin7": 10, "sin": 20, "affine": 2}
REQUESTS = 4
BATCH = 2
IMAGE_SIZE = 128
PCL_POINTS = 2048


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def print_code_size(library) -> None:
    """Each kernel's SASS instruction count in a built library (cuobjdump):
    a kernel whose code outgrows the instruction cache runs at the rate its
    code is fetched."""
    import re
    from pathlib import Path

    from conditioned_nerf_gan_torch.ops.kernels import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        print(f"  SASS: {tool} not found; code size not measured")
        return
    sass = run([str(tool), "-sass", str(library)])
    for body in sass.split("Function : ")[1:]:
        mangled = body.split()[0]
        name = re.search(r"\d(film_siren_[a-z0-9_]+?)(?:E|I)", mangled)
        din = re.search(r"ILi(\d+)E", mangled)
        label = (name.group(1) if name else mangled[:60]) + (f"<{din.group(1)}>" if din else "")
        count = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", body))
        print(f"  SASS: {label}: {count} instructions")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, bf16_flop: float, fp32_instructions: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: the
    bytes over HBM's rate, or the operations over their units' peaks (the
    tensor cores and the FP32 pipes overlapping perfectly)."""
    t_bytes = n_bytes / H100_HBM_BYTES * 1e3
    t_ops = max(bf16_flop / H100_BF16_FLOPS, fp32_instructions / H100_FP32_INSTRUCTIONS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def film_bound(B: int, N: int, L: int, din: int, act0: str = "sin7", act: str = "sin7",
               dot: bool = True, backward: bool = False) -> tuple[float, str]:
    """`bound` of a FiLM-SIREN forward (or its VJP, `backward`) of B x N
    points, H 256, 4 outputs: every product a bf16 product (layer 0, the
    trunk unless `dot` is off, the head; the VJP recomputes the trunk, and
    takes dX and dW of every layer), every activation element on the FP32
    pipes (the VJP's sin7, cos7 and dpre: 20 instructions); the bytes of
    each input read once and each output written once (points, cotangent,
    folded weights; outputs, dX, weight grads)."""
    H, C = 256, 4
    weights = B * ((din * H + (L - 1) * H * H) * 2 + L * H * 4) + H * C * 2 + C * 4
    trunk = (L - 1) * H * H if dot else 0
    if backward:
        macs = din * H + trunk + 2 * H * C + 2 * trunk + 2 * din * H
        instructions = L * H * 20
        grads = 2 * B * L * H + din * H + (L - 1) * H * H + L * H + H * C + C
        n_bytes = B * N * (2 * din + C) * 4 + weights + 4 * grads
    else:
        macs = din * H + trunk + H * C
        instructions = H * (ACT_INSTRUCTIONS[act0] + (L - 1) * ACT_INSTRUCTIONS[act])
        n_bytes = B * N * (din + C) * 4 + weights
    return bound(n_bytes, 2.0 * B * N * macs, float(B * N * instructions))


def kernel_inputs(B: int, N: int, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded inputs as in scripts/check_kernel_tpu_parity.py (H 256, L 4)."""
    H, L, C, DIN = 256, 4, 4, 3
    rng = np.random.default_rng(seed)
    arrays = dict(
        points=rng.uniform(-0.3, 0.3, (B, N, DIN)),
        freq=rng.uniform(25, 45, (B, L * H)),
        phase=rng.uniform(-1, 1, (B, L * H)),
        w0=rng.normal(0, 0.5, (DIN, H)),
        b0=rng.normal(0, 0.1, (H,)),
        ws=rng.normal(0, 1.0, (L - 1, H, H)) * np.sqrt(6 / H) / 30,
        bs=rng.normal(0, 0.1, (L - 1, H)),
        wf=rng.normal(0, 0.1, (H, C)),
        bf=rng.normal(0, 0.1, (C,)),
    )
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in arrays.items()}


def voxel_kernel_inputs(B: int, N: int, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded inputs at the voxel family's shape and init (TALLSIREN_FG: 32
    sampled features in, 8 layers of 256; first layer U(+-1/32), the rest
    U(+-sqrt(6/256)/25), the head likewise), features in [-1, 1]."""
    H, L, C, DIN = 256, 8, 4, 32
    trunk = np.sqrt(6 / H) / 25
    rng = np.random.default_rng(seed)
    arrays = dict(
        points=rng.uniform(-1, 1, (B, N, DIN)),
        freq=rng.uniform(25, 45, (B, L * H)),
        phase=rng.uniform(-1, 1, (B, L * H)),
        w0=rng.uniform(-1 / DIN, 1 / DIN, (DIN, H)),
        b0=rng.uniform(-1 / np.sqrt(DIN), 1 / np.sqrt(DIN), (H,)),
        ws=rng.uniform(-trunk, trunk, (L - 1, H, H)),
        bs=rng.uniform(-1 / 16, 1 / 16, (L - 1, H)),
        wf=rng.uniform(-trunk, trunk, (H, C)),
        bf=rng.uniform(-1 / 16, 1 / 16, (C,)),
    )
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in arrays.items()}


def check_kernel(label: str, inp: dict[str, torch.Tensor], phase: str = "phase 1",
                 bounds=(KERNEL_LOW_TOL, KERNEL_MEAN_TOL, KERNEL_Q999_TOL,
                         KERNEL_VS_PLAIN)) -> tuple[float, str | None]:
    """Hold the kernel against `film_siren_mlp_folded` (same bf16 operands,
    fp32 sums in another order); returns max|kernel - folded| at freq 25-45
    and a failure message (None when every bound holds).

    At freq 25-45 the max over ~1e6 points is set by the plain version's
    own summation noise, so the script also sums the same bf16-rounded math
    in fp64 and holds the kernel no further from it than the fp32 plain
    version is (see the bounds at the top).
    """
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
        film_siren_mlp_reference,
    )

    out = film_siren_mlp(*inp.values())
    plain = film_siren_mlp_folded(*inp.values())
    exact = film_siren_mlp_folded(*inp.values(), accum_dtype=torch.float64)
    err = (out - plain).abs().flatten()
    q999 = torch.quantile(err[:16_000_000], 0.999).item()
    k64 = (out - exact).abs().max().item()
    p64 = (plain - exact).abs().max().item()
    err_ref = (out - film_siren_mlp_reference(*inp.values())).abs().max().item()
    low = dict(inp, freq=inp["freq"] / 30.0)
    err_low = (film_siren_mlp(*low.values())
               - film_siren_mlp_folded(*low.values())).abs().max().item()
    B, N, din = inp["points"].shape
    low_tol, mean_tol, q999_tol, vs_plain = bounds
    print(f"{phase} [{label}] B={B} N={N} Din={din} L={inp['freq'].shape[1] // 256}: "
          f"freq/30: max|kernel - folded| "
          f"{err_low:.3e} (bound {low_tol}); freq 25-45: max|kernel - folded| "
          f"{err.max().item():.3e}, mean {err.mean().item():.3e} (bound "
          f"{mean_tol}), p99.9 {q999:.3e} (bound {q999_tol}), "
          f"max|kernel - fp64-sum| {k64:.3e} vs max|folded - fp64-sum| {p64:.3e} "
          f"(ratio {k64 / p64:.3f}, bound {vs_plain}), "
          f"max|kernel - fp32 exact-sin ref| {err_ref:.3e}")
    failure = None
    if not (torch.isfinite(out).all() and err_low < low_tol
            and err.mean().item() < mean_tol and q999 < q999_tol
            and k64 <= vs_plain * p64):
        failure = f"{phase}: kernel disagrees with its plain version at {label}"
    return err.max().item(), failure


def timed_row(phase: str, label: str, B: int, N: int, fn, plain_fn, bound_ms: float,
              bound_by: str, iters: int) -> dict:
    """Time a kernel and its plain version at one shape (CUDA events) and
    print both beside the bound; returns the shape's numbers."""
    ms = cuda_ms(fn, iters)
    plain_ms = cuda_ms(plain_fn, max(3, iters // 5))
    print(f"{phase} [{label}] time at {B} x {N}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), kernel / bound {ms / bound_ms:.2f} "
          f"({B * N / ms / 1e3:.1f} Mpoints/s kernel)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def shape_row(timed: dict, main: str) -> dict:
    """The JSON row's numbers at the main path's shape `main`, the other
    shapes' under ms_by_shape."""
    row = dict(timed[main], library_ms=None, shape=main)
    row["ms_by_shape"] = {label: t for label, t in timed.items() if label != main}
    return row


def phase1_kernel(device) -> dict:
    """Kernel vs plain folded at the main path's shapes; returns the JSON row
    (times at the training chunk, where most of K1's launches run)."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
    )

    chunk_n = IMAGE_SIZE * IMAGE_SIZE // 16 * 48
    shapes = [("thesis render", 2, IMAGE_SIZE * IMAGE_SIZE * 48),
              ("training chunk", 12, chunk_n), ("main-path ray chunk", 2, chunk_n),
              ("ragged", 2, 1000)]
    worst, timed = 0.0, {}
    with torch.no_grad():
        for label, B, N in shapes:
            inp = kernel_inputs(B, N, seed=0, device=device)
            err, failure = check_kernel(label, inp)
            if failure:
                raise AssertionError(failure)
            worst = max(worst, err)
            timed[label] = timed_row(
                "phase 1", label, B, N, lambda: film_siren_mlp(*inp.values()),
                lambda: film_siren_mlp_folded(*inp.values()), *film_bound(B, N, 4, 3),
                20 if B * N > 100_000 else 50)
            del inp
    return dict(name="film_siren_fwd", route="cuda",
                source="conditioned_nerf_gan_torch/csrc/film_siren_fwd.cu",
                replaces="conditioned_nerf_gan_tpu/ops/pallas/film_siren.py:156",
                launches=0, max_abs_err=worst, **shape_row(timed, "training chunk"))


def phase1b_kernel_din32(device, failures: list) -> dict:
    """K1 at the voxel family's shape (32 sampled features, 8 layers) vs
    plain folded, at the study size, the `dg` serving ray chunk and a ragged
    N; returns the JSON row (times at the ray chunk, the main path's shape)."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
    )

    shapes = [("study", 2, IMAGE_SIZE * IMAGE_SIZE * 48),
              ("dg ray chunk", 2, IMAGE_SIZE * IMAGE_SIZE // 16 * 48), ("ragged", 2, 1000)]
    bounds = (DIN32_LOW_TOL, DIN32_MEAN_TOL, DIN32_Q999_TOL, DIN32_VS_PLAIN)
    worst, timed = 0.0, {}
    with torch.no_grad():
        for label, B, N in shapes:
            inp = voxel_kernel_inputs(B, N, seed=1, device=device)
            err, failure = check_kernel(label, inp, "phase 1b", bounds)
            if failure:
                failures.append(failure)
            worst = max(worst, err)
            timed[label] = timed_row(
                "phase 1b", label, B, N, lambda: film_siren_mlp(*inp.values()),
                lambda: film_siren_mlp_folded(*inp.values()), *film_bound(B, N, 8, 32),
                10 if B * N > 100_000 else 50)
            flop = 2 * B * N * 256 * (32 + 7 * 256 + 4)
            print(f"phase 1b [{label}] {flop / timed[label]['ms'] / 1e9:.1f} TFLOP/s kernel")
            del inp
            torch.cuda.empty_cache()
    return dict(name="film_siren_fwd_din32", route="cuda",
                source="conditioned_nerf_gan_torch/csrc/film_siren_fwd.cu",
                replaces="conditioned_nerf_gan_tpu/ops/pallas/film_siren.py:156",
                launches=0, max_abs_err=worst, **shape_row(timed, "dg ray chunk"))


def make_pcl(rng: np.random.Generator, n_boxes: int = 3,
             n_points: int = PCL_POINTS) -> np.ndarray:
    """One colored point cloud (n_points, 6) [xyz, rgb]: points on the
    faces of a few colored boxes inside the +-0.35 cube, a car-like
    stand-in for a ShapeNet cloud."""
    per_box = -(-n_points // n_boxes)
    parts = []
    for _ in range(n_boxes):
        center, half = rng.uniform(-0.2, 0.2, 3), rng.uniform(0.06, 0.18, 3)
        u = rng.uniform(-1, 1, (per_box, 3))
        face = rng.integers(0, 6, per_box)
        u[np.arange(per_box), face // 2] = np.where(face % 2 == 0, 1.0, -1.0)
        color = np.broadcast_to(rng.uniform(0.1, 1.0, 3), (per_box, 3))
        parts.append(np.concatenate([center + u * half, color], axis=1))
    return np.concatenate(parts)[:n_points].astype(np.float32)


def make_requests(meta: dict, n: int, seed: int):
    """n requests of BATCH colored point clouds (numpy, from the seed) with
    cameras from the port's sampler."""
    from conditioned_nerf_gan_torch.ops.rays import (
        create_cam2world_matrix,
        sample_camera_positions,
    )

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    requests = []
    for _ in range(n):
        pcl = np.stack([make_pcl(rng) for _ in range(BATCH)])
        origins = sample_camera_positions(BATCH, generator=gen,
                                          cam_r_start=meta["cam_r_start"],
                                          cam_r_end=meta["cam_r_end"])
        requests.append(({"pcl": pcl}, create_cam2world_matrix(origins).numpy()))
    return requests


def serve(inf, cond, cams):
    """One request through the main path: encode the conditioning ({"pcl"}
    or {"voxel"}), then render; returns the encode and render seconds (host
    clock to a device sync), the conditioning and the render."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = inf.encode(cond)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rgb, depth = inf.render_batched(z, cams, z_batched=True)
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1, z, rgb, depth


def phase2_serve(device, build_dir):
    """Serve REQUESTS requests through the port's Inferencer; returns the
    kernel launches the main path made, the Inferencer, and the last request
    with its seconds."""
    import conditioned_nerf_gan_torch.models.siren as siren_module
    from conditioned_nerf_gan_torch.infer import (
        Inferencer,
        build_models,
        load_metadata,
        save_checkpoint,
    )
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
    )

    meta = load_metadata(THESIS_STEP)
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        G, E = build_models(meta, generator=torch.Generator().manual_seed(0))
        ckpt = save_checkpoint(f"{tmp}/run/checkpoints/{THESIS_STEP}.pt",
                               THESIS_STEP, G, E)
        inf = Inferencer(ckpt, num_imgs=BATCH, image_size=IMAGE_SIZE,
                         load_dataset=False, seed=0, device=device)
    chunks = inf.curriculum.get("ray_chunks", 0)
    print(f"phase 2: thesis model, step {THESIS_STEP}: {IMAGE_SIZE}^2, "
          f"{inf.curriculum['num_steps']}+{inf.curriculum['num_steps']} samples, "
          f"ray_chunks {chunks}, white_back {inf.curriculum['white_back']}, "
          f"fov {inf.curriculum['fov']}")
    requests = make_requests(inf.curriculum, REQUESTS, seed=0)

    torch.cuda.reset_peak_memory_stats()
    outputs = []
    film_siren_mlp.launches = 0
    for i, (cond, cams) in enumerate(requests):
        t_enc, t_render, z, rgb, depth = serve(inf, cond, cams)
        dt = t_enc + t_render
        print(f"phase 2 request {i}: {dt:.4f} s (encode {t_enc * 1e3:.3f} ms, "
              f"render {t_render * 1e3:.3f} ms), "
              f"{BATCH * IMAGE_SIZE * IMAGE_SIZE / dt:.1f} rays/s, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        outputs.append((z, cams, rgb, depth))
    launches = film_siren_mlp.launches

    expected = REQUESTS * 2 * max(chunks, 1)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    for z, cams, rgb, depth in outputs:
        if rgb.shape != (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3) or depth.shape != (
                BATCH, IMAGE_SIZE, IMAGE_SIZE):
            raise AssertionError(f"output shapes {rgb.shape}, {depth.shape}")
        if not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
            raise AssertionError("non-finite render output")
        if rgb.min() < -1 - 1e-5 or rgb.max() > 1 + 1e-5:
            raise AssertionError(f"pixels outside [-1, 1]: {rgb.min()}, {rgb.max()}")
    print(f"phase 2: pixels in [{min(o[2].min() for o in outputs):.4f}, "
          f"{max(o[2].max() for o in outputs):.4f}], depth in "
          f"[{min(o[3].min() for o in outputs):.4f}, {max(o[3].max() for o in outputs):.4f}]")

    # the same first render with the plain version in the kernel's place
    z, cams, rgb, depth = outputs[0]
    siren_module.film_siren_mlp = film_siren_mlp_folded
    try:
        rgb_plain, depth_plain = inf.render_batched(z, cams, z_batched=True)
    finally:
        siren_module.film_siren_mlp = film_siren_mlp
    diff = np.abs(rgb - rgb_plain).max(axis=-1)
    over = float((diff > RENDER_TOL).mean())
    print(f"phase 2: render vs plain-folded render: mean|pixel| {diff.mean():.3e} "
          f"(bound {RENDER_MEAN_TOL}), share of pixels off by > {RENDER_TOL}: "
          f"{over:.3e} (bound {RENDER_OVER_SHARE}), max|pixel| {diff.max():.3e}, "
          f"max|depth| {np.abs(depth - depth_plain).max():.3e}")
    if diff.mean() > RENDER_MEAN_TOL or over > RENDER_OVER_SHARE:
        raise AssertionError("kernel render disagrees with the plain render")
    return launches, inf, requests[-1], dt


def profile_device(fn):
    """Run fn under torch.profiler (device activity only); returns the
    number of device activities, device busy ms (union of their intervals)
    and {name: [us, count]}, or None when the profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return None
    busy_us, end = 0.0, -float("inf")
    by_name: dict[str, list[float]] = {}
    for e in sorted(device, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy_us += max(0.0, t - max(s, end))  # union of the device intervals
        end = max(end, t)
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += t - s
        entry[1] += 1
    return len(device), busy_us / 1e3, by_name


def print_top(phase: str, by_name: dict, n: int = 8) -> None:
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]:
        print(f"{phase}:   {us / 1e3:9.3f} ms in {count:4d} x {name[:90]}")


def phase3_profile(inf, request, unprofiled_s: float, phase: str = "phase 3") -> None:
    """The last request once more under torch.profiler (device activity
    only): device busy time, its share of that request's wall time with and
    without the profiler (the serving phase's run of it), and the largest
    kernels. The profiler slows the host, not the device, so the share
    against the unprofiled wall time is the estimate; the other bounds it
    from below."""
    times = []
    profiled = profile_device(lambda: times.append(serve(inf, *request)))
    if profiled is None:
        print(f"{phase}: the profiler recorded no device activity; busy share "
              "not measured")
        return
    n_events, busy_ms, by_name = profiled
    t_enc, t_render, *_ = times[0]
    wall_ms = (t_enc + t_render) * 1e3
    print(f"{phase}: {n_events} device activities, device busy {busy_ms:.3f} ms; "
          f"busy share {busy_ms / (unprofiled_s * 1e3):.4f} of the unprofiled "
          f"{unprofiled_s * 1e3:.3f} ms (idle {1 - busy_ms / (unprofiled_s * 1e3):.4f}), "
          f"{busy_ms / wall_ms:.4f} of the profiled {wall_ms:.3f} ms "
          f"(encode {t_enc * 1e3:.3f} ms)")
    print_top(phase, by_name, n=12)


def bwd_inputs(B: int, N: int, seed: int, device):
    """kernel_inputs and a cotangent g (B, N, 4) ~ N(0, 1), from the seed."""
    inp = kernel_inputs(B, N, seed, device)
    rng = np.random.default_rng(seed + 1)
    g = torch.from_numpy(rng.normal(0, 1, (B, N, 4)).astype(np.float32)).to(device)
    return inp, g


def vjp_fp64(inp: dict, g: torch.Tensor, chunk: int = 131072):
    """`film_siren_mlp_folded_vjp` with fp64 sums, over chunks of N: the
    folded grads are sums over points, so the chunks' grads add."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_folded_grads,
        unfold_film_grads,
    )

    args = list(inp.values())
    N = args[0].shape[1]
    parts = []
    for lo in range(0, N, chunk):
        sl = slice(lo, lo + chunk)
        parts.append(film_siren_folded_grads(args[0][:, sl], *args[1:], g[:, sl],
                                             accum_dtype=torch.float64))
    dpoints = torch.cat([p[0] for p in parts], dim=1)
    dw0f, dc0, dwsf, dcs, dwf_b, dbf_b = (sum(p[i] for p in parts) for i in range(1, 7))
    rest = unfold_film_grads(dw0f, dc0, dwsf, dcs, *[args[i] for i in (1, 3, 4, 5, 6)])
    grads = (dpoints, *rest, dwf_b.sum(0), dbf_b.sum(0))
    return tuple(t.float() for t in grads)


GRAD_NAMES = ("dpoints", "dfreq", "dphase", "dw0", "db0", "dws", "dbs", "dwf", "dbf")


def check_bwd(label: str, inp: dict, g: torch.Tensor, failures: list) -> float:
    """Hold the backward kernel against the plain VJP at one shape; returns
    the largest max|K2 - plain| over the nine grads at freq 25-45."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp_bwd,
        film_siren_mlp_folded_vjp,
    )

    B, N, _ = inp["points"].shape
    out = film_siren_mlp_bwd(*inp.values(), g)
    again = film_siren_mlp_bwd(*inp.values(), g)
    equal = all(torch.equal(a, b) for a, b in zip(out, again))
    del again
    plain = film_siren_mlp_folded_vjp(*inp.values(), g)
    exact = vjp_fp64(inp, g)
    low = dict(inp, freq=inp["freq"] / 30.0)
    out_low = film_siren_mlp_bwd(*low.values(), g)
    plain_low = film_siren_mlp_folded_vjp(*low.values(), g)
    print(f"phase 4 [{label}] B={B} N={N}: two launches bitwise equal: {equal}")
    if not equal:
        failures.append(f"phase 4 [{label}]: two launches differ")
    worst = 0.0
    for name, k, p, e, kl, pl in zip(GRAD_NAMES, out, plain, exact, out_low, plain_low):
        if not torch.isfinite(k).all():
            failures.append(f"phase 4 [{label}] {name}: non-finite")
        err = (k - p).abs().max().item()
        worst = max(worst, err)
        norm = ((k - p).norm() / p.norm()).item()
        low_max = ((kl - pl).abs().max() / pl.abs().max()).item()
        k64 = (k - e).abs().max().item()
        p64 = (p - e).abs().max().item()
        k64_2 = (k - e).norm().item()
        p64_2 = (p - e).norm().item()
        floor = BWD_ULPS * e.abs().max().item()
        floor_2 = BWD_ULPS * e.norm().item()
        print(f"phase 4 [{label}] {name:7s} max|plain| {p.abs().max().item():.3e}: "
              f"|K2-plain|_2/|plain|_2 {norm:.3e} (bound {BWD_NORM_TOL}); freq/30 "
              f"max|K2-plain|/max|plain| {low_max:.3e} (bound {BWD_LOW_TOL}); "
              f"|K2-fp64|_2 {k64_2:.3e} vs |plain-fp64|_2 {p64_2:.3e} (ratio "
              f"{k64_2 / max(p64_2, 1e-30):.3f}, bound {BWD_VS_PLAIN} + {floor_2:.1e}); "
              f"max|K2-fp64| {k64:.3e} vs max|plain-fp64| {p64:.3e} (ratio "
              f"{k64 / max(p64, 1e-30):.3f}, bound {BWD_VS_PLAIN_MAX} + {floor:.1e}); "
              f"max|K2-plain| {err:.3e}")
        if not (norm < BWD_NORM_TOL and low_max < BWD_LOW_TOL
                and k64_2 <= BWD_VS_PLAIN * p64_2 + floor_2
                and k64 <= BWD_VS_PLAIN_MAX * p64 + floor):
            failures.append(f"phase 4 [{label}] {name}: K2 disagrees with the plain VJP")
    return worst


def phase4_bwd(device, failures: list) -> dict:
    """Backward kernel vs the plain VJP at the three shapes; returns the
    JSON row (times at the training chunk, the main path's shape)."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp_bwd,
        film_siren_mlp_folded_vjp,
    )

    shapes = [("study", 2, IMAGE_SIZE * IMAGE_SIZE * 48),
              ("training chunk", 12, IMAGE_SIZE * IMAGE_SIZE // 16 * 48),
              ("ragged", 2, 1000)]
    worst, timed = 0.0, {}
    for label, B, N in shapes:
        inp, g = bwd_inputs(B, N, seed=0, device=device)
        worst = max(worst, check_bwd(label, inp, g, failures))
        timed[label] = timed_row(
            "phase 4", label, B, N, lambda: film_siren_mlp_bwd(*inp.values(), g),
            lambda: film_siren_mlp_folded_vjp(*inp.values(), g),
            *film_bound(B, N, 4, 3, backward=True), 10 if B * N > 100_000 else 50)
        del inp, g
        torch.cuda.empty_cache()
    return dict(name="film_siren_bwd", route="cuda",
                source="conditioned_nerf_gan_torch/csrc/film_siren_bwd.cu",
                replaces="conditioned_nerf_gan_tpu/ops/pallas/film_siren.py:232",
                launches=0, max_abs_err=worst, **shape_row(timed, "training chunk"))


class PlainFilmSiren(torch.autograd.Function):
    """Both kernels' plain versions as one differentiable op: the forward is
    `film_siren_mlp_folded`, the backward `film_siren_mlp_folded_vjp`."""

    @staticmethod
    def forward(ctx, *args):
        from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
            film_siren_mlp_folded,
        )

        ctx.save_for_backward(*args)
        return film_siren_mlp_folded(*args)

    @staticmethod
    def backward(ctx, g):
        from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
            film_siren_mlp_folded_vjp,
        )

        return film_siren_mlp_folded_vjp(*ctx.saved_tensors, g)


def record_grads(state) -> dict:
    """Wrap the three optimizers' step to keep each net's grads as they
    arrive (before the clip); returns {net: flat grads}, filled per step."""
    grads = {}
    for net in ("G", "E", "D"):
        opt = getattr(state, f"opt_{net}")
        step = opt.step

        def recording(*args, _net=net, _opt=opt, _step=step, **kwargs):
            grads[_net] = torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
                for group in _opt.param_groups for p in group["params"]])
            return _step(*args, **kwargs)

        opt.step = recording
    return grads


def phase5_train(device, failures: list) -> tuple[int, int]:
    """The stage-2 train step at full width; returns the two kernels'
    launches over the warm-up and timed steps (the main path's run; the
    comparison and profiled steps after it are not counted)."""
    import conditioned_nerf_gan_torch.models.siren as siren_module
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_bwd,
    )
    from conditioned_nerf_gan_torch.training import (
        build_stage_bench,
        create_train_state,
        make_train_step,
    )

    t0 = time.perf_counter()
    bench = build_stage_bench(stage=2, step=TRAIN_STEP)
    cfg, meta = bench.config, bench.meta
    nets = dict(G=bench.generator, E=bench.encoder, D=bench.discriminator)
    for net in nets.values():
        net.to(device)
    state = create_train_state(nets["G"], nets["E"], nets["D"], cfg)
    train_step = make_train_step(cfg)
    batch = {k: torch.from_numpy(v).to(device) for k, v in bench.batch.items()}
    rng = torch.Generator(device=device).manual_seed(0)
    r = cfg.render
    chunks = max(r.ray_chunks, 1)
    evals = 2 if r.hierarchical_sample else 1
    # per step: D render, G render and the G backward's recompute, each
    # `evals` SIREN calls per ray chunk; one backward per G-render call
    expect_fwd, expect_bwd = 3 * evals * chunks, evals * chunks
    print(f"phase 5: thesis model, step {TRAIN_STEP}: batch {meta['batch_size']}, "
          f"{r.img_size}^2, {r.num_steps}+{r.num_steps} samples, ray_chunks "
          f"{r.ray_chunks}, {meta['discriminator']} R1 {cfg.r1_lambda}, alpha "
          f"{bench.alpha}, nerf_noise {bench.nerf_noise}, pcl "
          f"{tuple(batch['pcl'].shape)}; set-up {time.perf_counter() - t0:.2f} s")
    before = {name: [p.detach().clone() for p in net.parameters()]
              for name, net in nets.items()}

    torch.cuda.reset_peak_memory_stats()
    film_siren_mlp.launches = film_siren_mlp_bwd.launches = 0
    fwd_total = bwd_total = 0
    step_s = []
    for i in range(1 + TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, rng, bench.alpha, bench.nerf_noise)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        fwd, bwd = film_siren_mlp.launches, film_siren_mlp_bwd.launches
        fwd_total, bwd_total = fwd_total + fwd, bwd_total + bwd
        film_siren_mlp.launches = film_siren_mlp_bwd.launches = 0
        losses = {k: float(v) for k, v in metrics.items()}
        print(f"phase 5 step {i}{' (warm-up)' if i == 0 else ''}: {step_s[-1]:.4f} s, "
              f"launches K1 {fwd} (design {expect_fwd}), K2 {bwd} (design "
              f"{expect_bwd}), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              + ", ".join(f"{k} {v:.6f}" for k, v in losses.items()))
        if (fwd, bwd) != (expect_fwd, expect_bwd):
            failures.append(f"phase 5 step {i}: launches {fwd}/{bwd}, design "
                            f"{expect_fwd}/{expect_bwd}")
        if not all(np.isfinite(v) for v in losses.values()):
            failures.append(f"phase 5 step {i}: non-finite losses {losses}")
    timed = step_s[1:]
    print(f"phase 5: {np.mean(timed):.4f} s/step (steps {', '.join(f'{t:.4f}' for t in timed)}), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for name, net in nets.items():
        moved = max((p.detach() - q).abs().max().item()
                    for p, q in zip(net.parameters(), before[name]))
        print(f"phase 5: {name} params moved by up to {moved:.3e}")
        if not moved > 0:
            failures.append(f"phase 5: {name} did not move")
    del before

    # one more step with the kernels, and the same step (state, batch, random
    # numbers) with the plain versions in both kernels' places
    snapshot, rng_state = copy.deepcopy(state), rng.get_state()
    runs = {}
    for label in ("kernels", "plain"):
        trial = copy.deepcopy(snapshot)
        grads = record_grads(trial)
        rng.set_state(rng_state)
        if label == "plain":
            siren_module.film_siren_mlp = PlainFilmSiren.apply
        try:
            _, metrics = train_step(trial, batch, rng, bench.alpha, bench.nerf_noise)
        finally:
            siren_module.film_siren_mlp = film_siren_mlp
        runs[label] = ({k: float(v) for k, v in metrics.items()}, grads)
        del trial
    (loss_k, grad_k), (loss_p, grad_p) = runs["kernels"], runs["plain"]
    for k in loss_k:
        rel = abs(loss_k[k] - loss_p[k]) / max(abs(loss_p[k]), 1e-30)
        print(f"phase 5: {k} kernels {loss_k[k]:.7f} plain {loss_p[k]:.7f} "
              f"(rel {rel:.3e}, bound {STEP_LOSS_TOL})")
        if not rel <= STEP_LOSS_TOL:
            failures.append(f"phase 5: {k} differs from the plain step")
    for net in ("G", "E", "D"):
        rel = ((grad_k[net] - grad_p[net]).norm() / grad_p[net].norm()).item()
        print(f"phase 5: {net} grads |kernels - plain|_2/|plain|_2 {rel:.3e} "
              f"(bound {STEP_GRAD_TOL}), |plain|_2 {grad_p[net].norm().item():.3e}")
        if not rel <= STEP_GRAD_TOL:
            failures.append(f"phase 5: {net} grads differ from the plain step")
    del runs, snapshot

    # one profiled step: device busy share against the timed steps' mean
    profiled = profile_device(
        lambda: train_step(state, batch, rng, bench.alpha, bench.nerf_noise))
    if profiled is None:
        print("phase 5: the profiler recorded no device activity; busy share "
              "not measured")
    else:
        n_events, busy_ms, by_name = profiled
        mean_ms = np.mean(timed) * 1e3
        print(f"phase 5: profiled step: {n_events} device activities, device busy "
              f"{busy_ms:.3f} ms; busy share {busy_ms / mean_ms:.4f} of the timed "
              f"steps' mean {mean_ms:.3f} ms (idle {1 - busy_ms / mean_ms:.4f})")
        print_top("phase 5", by_name, n=12)
    return fwd_total, bwd_total


def trilerp_points(B: int, N: int, seed: int, device, border: bool = False):
    """(B, N, 3) world points, uniform in the +-0.6 cube from the seed; with
    `border`, a third of them as far as +-0.9 (outside the cube: the border
    clamp) and a third with one coordinate exactly on a face (+-0.6)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.6, 0.6, (B, N, 3))
    if border:
        third = N // 3
        pts[:, :third] = rng.uniform(-0.9, 0.9, (B, third, 3))
        axis = rng.integers(0, 3, (B, third))
        face = rng.choice([-0.6, 0.6], (B, third))
        rows = pts[:, third:2 * third]
        np.put_along_axis(rows, axis[..., None], face[..., None], axis=-1)
    return torch.from_numpy(pts.astype(np.float32)).to(device)


def phase6_trilinear(device, failures: list) -> dict:
    """The trilinear kernel vs `border_trilerp_reference` on a 2 x 64^3 x 32
    volume (the dg feature volume's shape) at three point sets; returns the
    JSON row (times at the study size)."""
    import torch.nn.functional as F

    from conditioned_nerf_gan_torch.models.siren import VOXEL_LENGTH
    from conditioned_nerf_gan_torch.ops.grid_sample import (
        border_trilerp_reference,
        trilinear_point_features,
    )

    B, C = 2, 32
    rng = np.random.default_rng(2)
    volume = torch.from_numpy(rng.normal(0, 1, (B, VOXEL_RES, VOXEL_RES, VOXEL_RES, C))
                              .astype(np.float32)).to(device)
    vol_max = volume.abs().max().item()
    volume_ncdhw = volume.permute(0, 4, 1, 2, 3).contiguous()
    sets = [("study", IMAGE_SIZE * IMAGE_SIZE * 48, False), ("ragged", 1000, False),
            ("border", 300_000, True)]
    worst, row = 0.0, {}
    with torch.no_grad():
        for label, N, border in sets:
            coords = trilerp_points(B, N, seed=3, device=device, border=border) / (
                VOXEL_LENGTH / 2.0)
            out = trilinear_point_features(volume, coords)
            plain = border_trilerp_reference(volume, coords)
            err = (out - plain).abs().max().item()
            worst = max(worst, err)
            grid = coords[:, None, None]  # (B, 1, 1, N, 3)
            gs = F.grid_sample(volume_ncdhw, grid, mode="bilinear", padding_mode="border",
                               align_corners=False)[:, :, 0, 0].transpose(1, 2)
            gs_err = (out - gs).abs().max().item()
            outside = (coords.abs() > 1).any(-1).float().mean().item()
            print(f"phase 6 [{label}] B={B} N={N} volume {VOXEL_RES}^3 x {C}: "
                  f"max|kernel - plain| {err:.3e} (bound {TRILERP_TOL} x max|volume| "
                  f"{vol_max:.3f}), max|kernel - F.grid_sample| {gs_err:.3e}, share of "
                  f"points outside the cube {outside:.3f}")
            if not (torch.isfinite(out).all() and err <= TRILERP_TOL * vol_max):
                failures.append(f"phase 6 [{label}]: kernel disagrees with its plain version")
            iters = 20 if N > 100_000 else 50
            ms = cuda_ms(lambda: trilinear_point_features(volume, coords), iters)
            plain_ms = cuda_ms(lambda: border_trilerp_reference(volume, coords),
                               max(3, iters // 5))
            gs_ms = cuda_ms(lambda: F.grid_sample(volume_ncdhw, grid, mode="bilinear",
                                                  padding_mode="border",
                                                  align_corners=False), iters)
            gathered = B * N * 8 * C * 4
            # each input read once (volume, coords), the output written once;
            # per point 7 lerps of C channels (a subtract and an FMA each)
            # and ~30 instructions of anchors and weights
            bound_ms, bound_by = bound(volume.numel() * 4 + B * N * (3 + C) * 4, 0.0,
                                       float(B * N * (14 * C + 30)))
            print(f"phase 6 [{label}] time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.grid_sample (NCDHW, yardstick) {gs_ms:.4f} ms; kernel "
                  f"{B * N / ms / 1e3:.1f} Mpoints/s, {gathered / ms / 1e6:.1f} GB/s of "
                  f"corner reads; bound {bound_ms:.4f} ms ({bound_by})")
            if label == "study":
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=gs_ms)
            del coords, out, plain, gs
    del volume, volume_ncdhw
    torch.cuda.empty_cache()
    return dict(name="trilinear_fwd", route="cuda",
                source="conditioned_nerf_gan_torch/csrc/trilinear_fwd.cu",
                replaces="scripts/bench_pallas_gather.py:42",
                launches=0, max_abs_err=worst, **row)


def voxelize(pcl: np.ndarray, resolution: int, length: float = 1.2) -> np.ndarray:
    """(P, 6) colored points -> (R, R, R, 4) [occupancy, r, g, b] in (x, y,
    z) order: the rule of the repo's voxelize_pcl (clip into the cube, floor
    to a cell, mean color per occupied cell)."""
    points = np.clip(pcl[:, :3].astype(np.float64), -length / 2 + 1e-4, length / 2 - 1e-4)
    colors = np.clip(pcl[:, 3:].astype(np.float64), 0.0, 1.0)
    idx = np.clip(np.floor((points + length / 2) / (length / resolution)).astype(np.int64),
                  0, resolution - 1)
    flat = (idx[:, 0] * resolution + idx[:, 1]) * resolution + idx[:, 2]
    color_sum = np.zeros((resolution ** 3, 3))
    count = np.zeros(resolution ** 3)
    np.add.at(color_sum, flat, colors)
    np.add.at(count, flat, 1.0)
    voxel = np.zeros((resolution ** 3, 4))
    occupied = count > 0
    voxel[occupied, 0] = 1.0
    voxel[occupied, 1:] = color_sum[occupied] / count[occupied, None]
    return voxel.reshape(resolution, resolution, resolution, 4)


def make_voxel_requests(meta: dict, n: int, seed: int):
    """n requests of BATCH voxel grids (seeded `make_pcl` clouds voxelised
    at VOXEL_RES, put in NDHWC by the port's helper) with cameras."""
    from conditioned_nerf_gan_torch.infer import voxel_to_ndhwc
    from conditioned_nerf_gan_torch.ops.rays import (
        create_cam2world_matrix,
        sample_camera_positions,
    )

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    requests = []
    for _ in range(n):
        voxel = np.stack([voxel_to_ndhwc(voxelize(make_pcl(rng, n_points=VOXEL_PCL_POINTS),
                                                  VOXEL_RES)) for _ in range(BATCH)])
        origins = sample_camera_positions(BATCH, generator=gen,
                                          cam_r_start=meta["cam_r_start"],
                                          cam_r_end=meta["cam_r_end"])
        requests.append(({"voxel": voxel}, create_cam2world_matrix(origins).numpy()))
    return requests


def phase7_dg_serve(device, build_dir, failures: list):
    """Serve REQUESTS requests of the dg preset through the port's
    Inferencer; returns the two kernels' launches in the main path's run,
    the Inferencer, and the last request with its seconds."""
    import conditioned_nerf_gan_torch.models.siren as siren_module
    from conditioned_nerf_gan_torch.infer import (
        Inferencer,
        build_models,
        load_metadata,
        save_checkpoint,
    )
    from conditioned_nerf_gan_torch.ops.grid_sample import (
        border_trilerp_reference,
        trilinear_point_features,
    )
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
    )

    meta = load_metadata(DG_STEP, config="dg")
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        G, E = build_models(meta, generator=torch.Generator().manual_seed(0))
        ckpt = save_checkpoint(f"{tmp}/run/checkpoints/{DG_STEP}.pt", DG_STEP, G, E,
                               config="dg")
        inf = Inferencer(ckpt, num_imgs=BATCH, image_size=IMAGE_SIZE,
                         input_voxel_resolution=VOXEL_RES, load_dataset=False, seed=0,
                         device=device)
    cur = inf.curriculum
    chunks = cur.get("ray_chunks", 0)
    print(f"phase 7: dg preset, step {DG_STEP}: {cur['unet']} -> "
          f"{cur['generator']}, {IMAGE_SIZE}^2, {cur['num_steps']}+{cur['num_steps']} "
          f"samples, ray_chunks {chunks}, white_back {cur['white_back']}, fov "
          f"{cur['fov']}, cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")
    requests = make_voxel_requests(cur, REQUESTS, seed=0)
    occupancy = [float(c["voxel"][..., 0].mean()) for c, _ in requests]
    print(f"phase 7: {REQUESTS} requests of {BATCH} grids {VOXEL_RES}^3 x 4 "
          f"(occupied share {min(occupancy):.4f}-{max(occupancy):.4f})")

    expected = 2 * max(chunks, 1)  # coarse + fine per ray chunk
    torch.cuda.reset_peak_memory_stats()
    outputs = []
    film_siren_mlp.launches = trilinear_point_features.launches = 0
    for i, (cond, cams) in enumerate(requests):
        before = film_siren_mlp.launches, trilinear_point_features.launches
        t_enc, t_render, z, rgb, depth = serve(inf, cond, cams)
        k1 = film_siren_mlp.launches - before[0]
        tri = trilinear_point_features.launches - before[1]
        dt = t_enc + t_render
        print(f"phase 7 request {i}: {dt:.4f} s (encode {t_enc * 1e3:.3f} ms, "
              f"render {t_render * 1e3:.3f} ms), "
              f"{BATCH * IMAGE_SIZE * IMAGE_SIZE / dt:.1f} rays/s, launches K1 {k1} "
              f"and trilinear {tri} (design {expected} each), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if (k1, tri) != (expected, expected):
            failures.append(f"phase 7 request {i}: launches K1 {k1}, trilinear {tri}, "
                            f"design {expected} each")
        outputs.append((z, cams, rgb, depth))
    launches = film_siren_mlp.launches, trilinear_point_features.launches

    for z, cams, rgb, depth in outputs:
        if rgb.shape != (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3) or depth.shape != (
                BATCH, IMAGE_SIZE, IMAGE_SIZE):
            failures.append(f"phase 7: output shapes {rgb.shape}, {depth.shape}")
        elif not (np.isfinite(rgb).all() and np.isfinite(depth).all()):
            failures.append("phase 7: non-finite render output")
        elif rgb.min() < -1 - 1e-5 or rgb.max() > 1 + 1e-5:
            failures.append(f"phase 7: pixels outside [-1, 1]: {rgb.min()}, {rgb.max()}")
    volume, global_feature = outputs[0][0]
    print(f"phase 7: feature volume {tuple(volume.shape)} contiguous "
          f"{volume.is_contiguous()}, |volume| max {volume.abs().max().item():.4f}, "
          f"global {tuple(global_feature.shape)}; pixels in "
          f"[{min(o[2].min() for o in outputs):.4f}, {max(o[2].max() for o in outputs):.4f}]"
          f" (std {np.std([o[2] for o in outputs]):.4f}), depth in "
          f"[{min(o[3].min() for o in outputs):.4f}, {max(o[3].max() for o in outputs):.4f}]")

    # the same first render with both plain versions in the kernels' places
    z, cams, rgb, depth = outputs[0]
    siren_module.film_siren_mlp = film_siren_mlp_folded
    siren_module.trilinear_point_features = (
        lambda volume, coords, **_: border_trilerp_reference(volume, coords))
    try:
        rgb_plain, depth_plain = inf.render_batched(z, cams, z_batched=True)
    finally:
        siren_module.film_siren_mlp = film_siren_mlp
        siren_module.trilinear_point_features = trilinear_point_features
    diff = np.abs(rgb - rgb_plain).max(axis=-1)
    over = float((diff > RENDER_TOL).mean())
    print(f"phase 7: render vs plain render: mean|pixel| {diff.mean():.3e} "
          f"(bound {RENDER_MEAN_TOL}), share of pixels off by > {RENDER_TOL}: "
          f"{over:.3e} (bound {RENDER_OVER_SHARE}), max|pixel| {diff.max():.3e}, "
          f"max|depth| {np.abs(depth - depth_plain).max():.3e}")
    if diff.mean() > RENDER_MEAN_TOL or over > RENDER_OVER_SHARE:
        failures.append("phase 7: kernel render disagrees with the plain render")
    return launches, inf, requests[-1], dt


def check_study(kernel: str, mode: str, tiles: list[int], label: str, inp: dict,
                failures: list) -> float:
    """Hold one study kernel in one mode, at each of its tiles (points per
    CTA), against `film_study_reference` in phase 1's style (freq/30 max; at
    freq 25-45 mean, p99.9 and distance to fp64 sums against the plain
    version's), each relative to max(1, max|plain|); returns the largest
    max|kernel - plain| at freq 25-45."""
    from conditioned_nerf_gan_torch.ops.kernels.film_study import (
        film_siren_study,
        film_study_reference,
    )

    low_inp = dict(inp, freq=inp["freq"] / 30.0)
    plain = film_study_reference(*inp.values(), kernel=kernel, mode=mode)
    exact = film_study_reference(*inp.values(), kernel=kernel, mode=mode,
                                 accum_dtype=torch.float64)
    plain_low = film_study_reference(*low_inp.values(), kernel=kernel, mode=mode)
    scale = max(1.0, plain.abs().max().item())
    p64 = (plain - exact).abs().max().item()
    floor = BWD_ULPS * exact.abs().max().item()
    B, N, _ = inp["points"].shape
    worst = 0.0
    for tile in tiles:
        out = film_siren_study(*inp.values(), kernel=kernel, mode=mode, tile=tile)
        out_low = film_siren_study(*low_inp.values(), kernel=kernel, mode=mode, tile=tile)
        err = (out - plain).abs().flatten()
        worst = max(worst, err.max().item())
        mean = err.mean().item() / scale
        q999 = torch.quantile(err[:16_000_000], 0.999).item() / scale
        k64 = (out - exact).abs().max().item()
        low = ((out_low - plain_low).abs().max()
               / max(1.0, plain_low.abs().max().item())).item()
        print(f"phase 8 [{kernel} {mode} T={tile}, {label}] B={B} N={N}: max|plain| "
              f"{plain.abs().max().item():.3e}; relative to max(1, max|plain|): freq/30 "
              f"max {low:.3e} (bound {STUDY_LOW_TOL}); freq 25-45 mean {mean:.3e} (bound "
              f"{STUDY_MEAN_TOL}), p99.9 {q999:.3e} (bound {STUDY_Q999_TOL}); max|kernel "
              f"- fp64-sum| {k64:.3e} vs max|plain - fp64-sum| {p64:.3e} (ratio "
              f"{k64 / max(p64, 1e-30):.3f}, bound {STUDY_VS_PLAIN} + {floor:.1e})")
        if not (torch.isfinite(out).all() and low < STUDY_LOW_TOL and mean < STUDY_MEAN_TOL
                and q999 < STUDY_Q999_TOL and k64 <= STUDY_VS_PLAIN * p64 + floor):
            failures.append(f"phase 8 [{kernel} {mode} T={tile}, {label}]: kernel "
                            "disagrees with its plain version")
        del out, out_low, err
    return worst


def phase8_study(device, failures: list, k1_ms: float) -> tuple[list, dict]:
    """The kernel study: every instance the study tool launches (and every
    mode at T 128) checked at the study shape and a ragged N, each mode timed
    at T 128, K1's phase-1 time `k1_ms` at the study shape beside K4 v4
    sin7's (K1's function in its earlier mma.sync design), then the study tool's variants
    through its own function; returns the JSON rows of K3, K4 v4 and K4 v5
    and the launches of every kernel counter in the tool's run."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_bwd,
    )
    from conditioned_nerf_gan_torch.ops.kernels.film_study import (
        STUDY_MODES,
        film_siren_study,
        film_study_reference,
    )
    from conditioned_nerf_gan_torch.tools import bench_film_kernel as study

    sources = dict(v3=("film_siren_study_v3", "scripts/bench_film_kernel.py:75"),
                   v4=("film_siren_study_v4", "scripts/bench_film_kernel.py:135"),
                   v5=("film_siren_study_v5", "scripts/bench_film_kernel.py:164"))
    tiles: dict[tuple[str, str], list[int]] = {}
    for kernel, mode, tile in study.kernel_instances():
        tiles.setdefault((kernel, mode), []).append(tile)
    rows = []
    with torch.no_grad():
        for kernel, modes in STUDY_MODES.items():
            worst, timed = 0.0, {}
            for mode, (act0, act, dot) in modes.items():
                for label, N in (("study", IMAGE_SIZE * IMAGE_SIZE * 48), ("ragged", 1000)):
                    inp = kernel_inputs(2, N, seed=0, device=device)
                    worst = max(worst, check_study(kernel, mode, tiles[(kernel, mode)],
                                                   label, inp, failures))
                    if label == "study":
                        ms = cuda_ms(lambda: film_siren_study(
                            *inp.values(), kernel=kernel, mode=mode, tile=STUDY_TILE), 20)
                        plain_ms = cuda_ms(lambda: film_study_reference(
                            *inp.values(), kernel=kernel, mode=mode), 4)
                        bound_ms, bound_by = film_bound(2, N, 4, 3, act0, act, dot)
                        timed[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                           bound_by=bound_by)
                        print(f"phase 8 [{kernel} {mode}] time at 2 x {N}, T={STUDY_TILE}: "
                              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                              f"{bound_ms:.4f} ms ({bound_by}; kernel at "
                              f"{bound_ms / ms:.3f} of it)")
                    del inp
                    torch.cuda.empty_cache()
            name, replaces = sources[kernel]
            first = timed[next(iter(modes))]
            rows.append(dict(name=name, route="cuda",
                             source="conditioned_nerf_gan_torch/csrc/film_siren_study.cu",
                             replaces=replaces, launches=0, max_abs_err=worst,
                             ms=first["ms"], plain_ms=first["plain_ms"],
                             bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                             library_ms=None, mode=next(iter(modes)), modes=timed))

    old = next(r for r in rows if r["name"] == "film_siren_study_v4")["modes"]["sin7"]["ms"]
    print(f"phase 8: K1's function at 2 x {IMAGE_SIZE * IMAGE_SIZE * 48}, the same run: "
          f"K1 (wgmma + TMA trunk) {k1_ms:.4f} ms (phase 1), K4 v4 sin7 at T "
          f"{STUDY_TILE} (the earlier mma.sync design) {old:.4f} ms; K1 / v4 sin7 "
          f"{k1_ms / old:.3f}")

    # the main path: the study tool's variants, through its own function
    names = (list(study.DEFAULT_VARIANTS) + list(study.SWEEPS)
             + ["jnpsin", "v4_nosin", "v4_nodot", "v4_sin7", "vjp_kernel"])
    print("phase 8: " + study.header("cuda"))
    for kernel in film_siren_study.launches:
        film_siren_study.launches[kernel] = 0
    film_siren_mlp.launches = film_siren_mlp_bwd.launches = 0
    t0 = time.perf_counter()
    study.run_study(names, "cuda")
    launches = dict(film_siren_study.launches, k1=film_siren_mlp.launches,
                    k2=film_siren_mlp_bwd.launches)
    print(f"phase 8: {len(names)} variants in {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    for kernel in STUDY_MODES:
        if not launches[kernel]:
            failures.append(f"phase 8: the study launched no {kernel} kernel")
    torch.cuda.empty_cache()
    return rows, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    from pathlib import Path

    from conditioned_nerf_gan_torch.ops.kernels import build

    # the plain versions are the comparators: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    # the card's name and power limit, on a line of their own as nvidia-smi prints them
    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print("nvcc:", run([build._nvcc(), "--version"]).splitlines()[-1])
    try:
        import triton
        print("triton:", triton.__version__)
    except ImportError as exc:
        print("triton: not importable:", exc)

    t0 = time.perf_counter()
    libs = build.load_libraries("film_siren_fwd", "film_siren_bwd", "trilinear_fwd",
                                "film_siren_study")
    print(f"built {len(libs)} kernel libraries in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"built {lib.path.name} in {lib.build_seconds:.2f} s")
        for line in lib.log.splitlines():
            if (("Used" in line and "registers" in line) or "spill" in line
                    or "bytes stack" in line or "C7520" in line or "C7512" in line):
                print("  ptxas:", line.strip()[:240])
        if lib.name in ("film_siren_fwd", "film_siren_bwd"):
            print_code_size(lib.path)

    failures: list[str] = []
    fwd = phase1_kernel(device)
    fwd32 = phase1b_kernel_din32(device, failures)
    serve_launches, inf, last_request, last_s = phase2_serve(device, Path(build.BUILD_DIR))
    phase3_profile(inf, last_request, last_s)
    del inf
    torch.cuda.empty_cache()
    bwd = phase4_bwd(device, failures)
    train_fwd, train_bwd = phase5_train(device, failures)
    torch.cuda.empty_cache()
    tri = phase6_trilinear(device, failures)
    (dg_k1, dg_tri), inf, last_request, last_s = phase7_dg_serve(
        device, Path(build.BUILD_DIR), failures)
    phase3_profile(inf, last_request, last_s, phase="phase 7 profile")
    del inf
    torch.cuda.empty_cache()
    study_rows, study = phase8_study(device, failures,
                                     fwd["ms_by_shape"]["thesis render"]["ms"])
    if failures:
        raise AssertionError("failed checks:\n  " + "\n  ".join(failures))
    fwd["launches"] = serve_launches + train_fwd + study["k1"]
    fwd["launches_by_path"] = {"serve": serve_launches, "train": train_fwd,
                               "film_study": study["k1"]}
    fwd32["launches"] = dg_k1
    fwd32["launches_by_path"] = {"dg_serve": dg_k1}
    bwd["launches"] = train_bwd + study["k2"]
    bwd["launches_by_path"] = {"train": train_bwd, "film_study": study["k2"]}
    tri["launches"] = dg_tri
    tri["launches_by_path"] = {"dg_serve": dg_tri}
    for row, kernel in zip(study_rows, ("v3", "v4", "v5")):
        row["launches"] = study[kernel]
        row["launches_by_path"] = {"film_study": study[kernel]}
    print(json.dumps({"kernels": [fwd, fwd32, bwd, tri, *study_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
