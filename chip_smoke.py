#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Refuses to run without CUDA (exit 1). Otherwise:
  0. reports the card (nvidia-smi name and power limit), torch, CUDA, nvcc
     and triton, and builds the CUDA kernels from `conditioned_nerf_gan_torch/csrc`;
  1. holds the FiLM-SIREN kernel against its plain torch version
     (`film_siren_mlp_folded`, same bf16-operand math) at the thesis render
     shape, at the ray-chunk shape the main path gives it, and at a ragged N,
     and times both with CUDA events;
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
     sums against the plain version's, bitwise-equal repeats; and times both;
  5. drives the port's training path: the thesis model at stage 2 (step
     16000, fade-in alpha 0.5) at full width, the discriminator with R1,
     batch 12 at 128^2, 48 + 48 samples, ray_chunks 16, through
     `make_train_step`: one warm-up and three timed steps (s/step, peak
     memory, kernel launches per step against the design's count), finite
     losses, all three nets moved, one step against the same step with the
     plain versions in both kernels' places, and one profiled step.
Prints one JSON line of kernel results, then the last line
{"ok": true, "device": {...}}. Any failed check raises (non-zero exit);
checks of phases 4 and 5 raise after phase 5, so one run reports them all.
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
REQUESTS = 4
BATCH = 2
IMAGE_SIZE = 128
PCL_POINTS = 2048


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


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


def check_kernel(label: str, inp: dict[str, torch.Tensor]) -> float:
    """Hold the kernel against `film_siren_mlp_folded` (same bf16 operands,
    fp32 sums in another order); returns max|kernel - folded| at freq 25-45.

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
    B, N, _ = inp["points"].shape
    print(f"phase 1 [{label}] B={B} N={N}: freq/30: max|kernel - folded| "
          f"{err_low:.3e} (bound {KERNEL_LOW_TOL}); freq 25-45: max|kernel - folded| "
          f"{err.max().item():.3e}, mean {err.mean().item():.3e} (bound "
          f"{KERNEL_MEAN_TOL}), p99.9 {q999:.3e} (bound {KERNEL_Q999_TOL}), "
          f"max|kernel - fp64-sum| {k64:.3e} vs max|folded - fp64-sum| {p64:.3e} "
          f"(ratio {k64 / p64:.3f}, bound {KERNEL_VS_PLAIN}), "
          f"max|kernel - fp32 exact-sin ref| {err_ref:.3e}")
    if not (torch.isfinite(out).all() and err_low < KERNEL_LOW_TOL
            and err.mean().item() < KERNEL_MEAN_TOL and q999 < KERNEL_Q999_TOL
            and k64 <= KERNEL_VS_PLAIN * p64):
        raise AssertionError(f"kernel disagrees with its plain version at {label}")
    return err.max().item()


def phase1_kernel(device) -> dict:
    """Kernel vs plain folded at the main path's shapes; returns the JSON row."""
    from conditioned_nerf_gan_torch.ops.kernels.film_siren import (
        film_siren_mlp,
        film_siren_mlp_folded,
    )

    chunk_n = IMAGE_SIZE * IMAGE_SIZE // 16 * 48
    shapes = [("thesis render", 2, IMAGE_SIZE * IMAGE_SIZE * 48),
              ("main-path ray chunk", 2, chunk_n), ("ragged", 2, 1000)]
    worst, row = 0.0, {}
    with torch.no_grad():
        for label, B, N in shapes:
            inp = kernel_inputs(B, N, seed=0, device=device)
            worst = max(worst, check_kernel(label, inp))
            iters = 20 if N > 100_000 else 50
            ms = cuda_ms(lambda: film_siren_mlp(*inp.values()), iters)
            plain_ms = cuda_ms(lambda: film_siren_mlp_folded(*inp.values()),
                               max(3, iters // 5))
            print(f"phase 1 [{label}] time: kernel {ms:.4f} ms, plain folded "
                  f"{plain_ms:.4f} ms ({B * N / ms / 1e3:.1f} Mpoints/s kernel)")
            if label == "thesis render":
                row = dict(ms=ms, plain_ms=plain_ms)
            del inp
    return dict(name="film_siren_fwd", route="cuda",
                source="conditioned_nerf_gan_torch/csrc/film_siren_fwd.cu",
                replaces="conditioned_nerf_gan_tpu/ops/pallas/film_siren.py:156",
                launches=0, max_abs_err=worst, **row)


def make_pcl(rng: np.random.Generator, n_boxes: int = 3) -> np.ndarray:
    """One colored point cloud (PCL_POINTS, 6) [xyz, rgb]: points on the
    faces of a few colored boxes inside the +-0.35 cube, a car-like
    stand-in for a ShapeNet cloud."""
    per_box = -(-PCL_POINTS // n_boxes)
    parts = []
    for _ in range(n_boxes):
        center, half = rng.uniform(-0.2, 0.2, 3), rng.uniform(0.06, 0.18, 3)
        u = rng.uniform(-1, 1, (per_box, 3))
        face = rng.integers(0, 6, per_box)
        u[np.arange(per_box), face // 2] = np.where(face % 2 == 0, 1.0, -1.0)
        color = np.broadcast_to(rng.uniform(0.1, 1.0, 3), (per_box, 3))
        parts.append(np.concatenate([center + u * half, color], axis=1))
    return np.concatenate(parts)[:PCL_POINTS].astype(np.float32)


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
        requests.append((pcl, create_cam2world_matrix(origins).numpy()))
    return requests


def serve(inf, pcl, cams):
    """One request through the main path: encode, then render; returns the
    encode and render seconds (host clock to a device sync) and the render."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = inf.encode({"pcl": pcl})
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
    for i, (pcl, cams) in enumerate(requests):
        t_enc, t_render, z, rgb, depth = serve(inf, pcl, cams)
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


def phase3_profile(inf, request, unprofiled_s: float) -> None:
    """The last request once more under torch.profiler (device activity
    only): device busy time, its share of that request's wall time with and
    without the profiler (phase 2's run of it), and the largest kernels.
    The profiler slows the host, not the device, so the share against the
    unprofiled wall time is the estimate; the other bounds it from below."""
    times = []
    profiled = profile_device(lambda: times.append(serve(inf, *request)))
    if profiled is None:
        print("phase 3: the profiler recorded no device activity; busy share "
              "not measured")
        return
    n_events, busy_ms, by_name = profiled
    t_enc, t_render, *_ = times[0]
    wall_ms = (t_enc + t_render) * 1e3
    print(f"phase 3: {n_events} device activities, device busy {busy_ms:.3f} ms; "
          f"busy share {busy_ms / (unprofiled_s * 1e3):.4f} of the unprofiled "
          f"{unprofiled_s * 1e3:.3f} ms (idle {1 - busy_ms / (unprofiled_s * 1e3):.4f}), "
          f"{busy_ms / wall_ms:.4f} of the profiled {wall_ms:.3f} ms "
          f"(encode {t_enc * 1e3:.3f} ms)")
    print_top("phase 3", by_name)


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
    worst, row = 0.0, {}
    for label, B, N in shapes:
        inp, g = bwd_inputs(B, N, seed=0, device=device)
        worst = max(worst, check_bwd(label, inp, g, failures))
        iters = 10 if B * N > 100_000 else 50
        ms = cuda_ms(lambda: film_siren_mlp_bwd(*inp.values(), g), iters)
        plain_ms = cuda_ms(lambda: film_siren_mlp_folded_vjp(*inp.values(), g),
                           max(3, iters // 5))
        print(f"phase 4 [{label}] time: K2 {ms:.4f} ms, plain VJP {plain_ms:.4f} ms "
              f"({B * N / ms / 1e3:.1f} Mpoints/s K2)")
        if label == "training chunk":
            row = dict(ms=ms, plain_ms=plain_ms)
        del inp, g
        torch.cuda.empty_cache()
    return dict(name="film_siren_bwd", route="cuda",
                source="conditioned_nerf_gan_torch/csrc/film_siren_bwd.cu",
                replaces="conditioned_nerf_gan_tpu/ops/pallas/film_siren.py:232",
                launches=0, max_abs_err=worst, **row)


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
    libs = build.load_libraries("film_siren_fwd", "film_siren_bwd")
    print(f"built {len(libs)} kernel libraries in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(f"built {lib.path.name} in {lib.build_seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "bytes stack" in line:
                print("  ptxas:", line.strip())

    fwd = phase1_kernel(device)
    serve_launches, inf, last_request, last_s = phase2_serve(device, Path(build.BUILD_DIR))
    phase3_profile(inf, last_request, last_s)
    del inf
    torch.cuda.empty_cache()
    failures: list[str] = []
    bwd = phase4_bwd(device, failures)
    train_fwd, train_bwd = phase5_train(device, failures)
    if failures:
        raise AssertionError("failed checks:\n  " + "\n  ".join(failures))
    fwd["launches"] = serve_launches + train_fwd
    fwd["launches_by_path"] = {"serve": serve_launches, "train": train_fwd}
    bwd["launches"] = train_bwd
    bwd["launches_by_path"] = {"train": train_bwd}
    print(json.dumps({"kernels": [fwd, bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
