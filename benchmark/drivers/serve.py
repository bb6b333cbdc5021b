"""Serve traffic: a closed loop of render requests through the program's
Inferencer, one client.

Set-up writes the seed's weights as a checkpoint of the program's format
under TMPDIR, builds the Inferencer from it (no dataset) and deletes it,
makes a pool of conditioning inputs on the card and brings it to the host
as numpy, and runs `warm_requests` requests. A request is what the infer
CLI's default render does: `views` inputs from the pool (numpy) through
`Inferencer.encode` in one batch, then `render_batched(z, cams,
z_batched=True)`, one view of each at the checkpoint's render settings,
numpy back; its latency is host time from the first call to the arrays in
hand. After the window, `checked_requests` of the finished requests, drawn
from the seed, are rendered again by the plain reference and compared.
A traced run adds a window with the encode and the render timed apart (each
ending in a sync), then `profiled_requests` requests under the profiler.

Traffic keys: driver "serve", checkpoint_step, views, input_pool,
warm_requests, checked_requests, profiled_requests.
"""

from __future__ import annotations

import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import counts, data, harness
from ..reference import plain
from . import common
from .common import free, precise


class Setup:
    def __init__(self, cell):
        t = cell.traffic
        self.cell, self.device = cell, cell.device
        self.meta = meta = common.metadata(cell, t["checkpoint_step"])
        # the Inferencer's eval overrides (its _get_curriculum)
        meta.update(num_steps=cell.overrides.get("num_steps", 48),
                    img_size=cell.overrides.get("img_size", 128))
        self.views = t["views"]
        # a depth that moves by 1% of the ray interval has moved (compare)
        self.depth_tol = 0.01 * (meta["ray_end"] - meta["ray_start"])
        self.ref = harness.reference(cell)
        self.key = self.ref.ENCODER
        self.weights = harness.model_weights(self.ref, cell.config, cell.seed, self.device)
        self.shapes = common.shapes(cell, meta, self.views)
        m = cell.config["model"]
        gen = torch.Generator(device=self.device).manual_seed(cell.seed + 1)
        n = t["input_pool"]
        if self.key == "pcl":
            inputs = data.box_clouds(gen, n, self.shapes["encoder"]["points"], self.device)
        else:
            clouds = data.box_clouds(gen, n, cell.config["voxel_cloud_points"], self.device)
            inputs = data.voxelize(clouds, meta["voxel_resolution"])
        self.inputs = inputs.cpu().numpy()
        rng = np.random.default_rng(cell.seed)
        self.order = [rng.choice(n, self.views, replace=False) for _ in range(256)]
        cam_gen = torch.Generator().manual_seed(cell.seed + 2)
        self.cams = data.cameras(cam_gen, 256 * self.views, meta["cam_r_start"],
                                 meta["cam_r_end"], "cpu").reshape(256, self.views, 4, 4).numpy()

    def request(self, i: int):
        """Request i's (inputs, cams): numpy, as a client sends them."""
        k = i % len(self.order)
        return self.inputs[self.order[k]], self.cams[k]


def inferencer(setup: Setup):
    """The program's Inferencer on a checkpoint of the seed's weights, which
    is deleted once loaded."""
    from conditioned_nerf_gan_torch.infer.inference import Inferencer, save_checkpoint

    cell, meta = setup.cell, setup.meta
    run_dir = Path(tempfile.gettempdir()) / "benchmark" / cell.name
    shutil.rmtree(run_dir, ignore_errors=True)
    ckpt = run_dir / "checkpoints" / f"{cell.traffic['checkpoint_step']}.pt"
    G, E, _ = common.program_models(meta, setup.weights, setup.device, False)
    save_checkpoint(ckpt, cell.traffic["checkpoint_step"], G, E,
                    config=cell.config["preset"]["config"])
    del G, E
    try:
        inf = Inferencer(ckpt, load_dataset=False, device=setup.device,
                         num_imgs=setup.views, image_size=meta["img_size"])
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    for key in ("ray_chunks", "num_steps", "img_size"):  # the CPU tests' sizes
        if key in cell.overrides:
            inf.curriculum[key] = cell.overrides[key]
    return inf


def serve_one(inf, key, inputs, cams):
    z = inf.encode({key: inputs})
    return inf.render_batched(z, cams, z_batched=True)


def reference_outputs(setup: Setup, requests: list, q=plain.exact) -> list:
    """The plain reference's (rgb, depth) numpy of each request index."""
    render = common.render_settings(setup.meta, perturb=False)
    outs = []
    with precise(), torch.no_grad():
        with torch.device(setup.device):
            mods = setup.ref.build(setup.cell.config, q)
        for part in ("generator", "encoder"):
            mods[part].load_state_dict(setup.weights[part])
        G, E = mods["generator"], mods["encoder"]
        for i in requests:
            inputs, cams = setup.request(i)
            x = torch.as_tensor(inputs, device=setup.device)
            z = plain.encode_pcl(E, x)[0] if setup.key == "pcl" else E(x)
            rgb, depth = G(z, torch.as_tensor(cams, device=setup.device), render)
            outs.append((rgb.cpu().numpy(), depth.cpu().numpy()))
    del mods, G, E
    free(setup.device)
    return outs


def compare(prog: list, ref: list, depth_tol: float) -> dict:
    """rgb_gap, depth_gap: the worst checked view's RMS difference of its
    pixels (rgb in [-1, 1]) and of its depth map. Over the pixels the
    reference covers (not white background to 1e-3) in all checked views
    together: rgb_moved_share, the share of them whose rgb moved by more
    than 0.02 (1% of its range) in a channel; depth_moved_share, the share
    whose depth moved by more than `depth_tol` (the setup's: 1% of the ray
    interval); rgb_rel_gap, depth_rel_gap, the RMS difference over the RMS
    deviation of the reference's pixels from their mean."""
    rms_rgb = rms_depth = 0.0
    d_rgb, d_depth, dev_rgb, dev_depth = [], [], [], []
    for (pr, pd), (rr, rd) in zip(prog, ref, strict=True):
        rms_rgb = max(rms_rgb, float(np.sqrt(np.mean((pr - rr) ** 2, axis=(1, 2, 3))).max()))
        rms_depth = max(rms_depth, float(np.sqrt(np.mean((pd - rd) ** 2, axis=(1, 2))).max()))
        covered = np.abs(rr - 1.0).max(-1) > 1e-3
        d_rgb.append(np.abs(pr - rr)[covered])
        d_depth.append(np.abs(pd - rd)[covered])
        dev_rgb.append(rr[covered] - rr[covered].mean(0))
        dev_depth.append(rd[covered] - rd[covered].mean())
    d_rgb, d_depth = np.concatenate(d_rgb), np.concatenate(d_depth)
    gaps = {"rgb_gap": rms_rgb, "depth_gap": rms_depth}
    if d_rgb.size:
        dev_rgb, dev_depth = np.concatenate(dev_rgb), np.concatenate(dev_depth)
        gaps.update(
            rgb_moved_share=float(np.mean(d_rgb.max(-1) > 0.02)),
            depth_moved_share=float(np.mean(d_depth > depth_tol)),
            rgb_rel_gap=float(np.sqrt(np.mean(d_rgb ** 2) / max(np.mean(dev_rgb ** 2), 1e-12))),
            depth_rel_gap=float(np.sqrt(np.mean(d_depth ** 2)
                                        / max(np.mean(dev_depth ** 2), 1e-12))))
    return gaps


def run(cell, t0: float) -> dict:
    dev, t = cell.device, cell.traffic
    setup = Setup(cell)
    print(f"at {time.perf_counter() - t0:.3f} s: weights and inputs made", file=sys.stderr)
    inf = inferencer(setup)
    print(f"at {time.perf_counter() - t0:.3f} s: Inferencer built", file=sys.stderr)
    for i in range(t["warm_requests"]):
        serve_one(inf, setup.key, *setup.request(i))
    common.sync(dev)
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s; shapes {setup.shapes}", file=sys.stderr)

    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    latencies, outputs = [], []
    common.sync(dev)
    start = time.perf_counter()
    while time.perf_counter() - start < cell.seconds:
        a = time.perf_counter()
        outputs.append(serve_one(inf, setup.key, *setup.request(len(outputs))))
        latencies.append(time.perf_counter() - a)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    n = len(latencies)
    p95 = statistics.quantiles(latencies, n=20, method="inclusive")[-1] if n > 1 else latencies[0]
    out = {"attempted": n, "failed": 0, "peak": peak,
           "e2e": {"serve_views_per_s": setup.views * n / window_s,
                   "serve_p95_ms": 1e3 * p95, "setup_s": setup_s},
           "trace": None}
    print(f"window {window_s:.3f} s: {n} requests, median "
          f"{1e3 * statistics.median(latencies):.2f} ms", file=sys.stderr)

    if cell.trace:
        enc_ms, ren_ms = [], []
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < cell.seconds:
            inputs, cams = setup.request(i)
            a = time.perf_counter()
            z = inf.encode({setup.key: inputs})
            common.sync(dev)
            b = time.perf_counter()
            inf.render_batched(z, cams, z_batched=True)
            c = time.perf_counter()
            enc_ms.append(1e3 * (b - a))
            ren_ms.append(1e3 * (c - b))
            i += 1
        calls: dict = {}
        n_prof = t["profiled_requests"]

        def traced():
            for k in range(n_prof):
                serve_one(inf, setup.key, *setup.request(k))

        with common.kernel_ranges(calls):
            prof = harness.profile_window(traced, common.RANGES, calls.clear)
        trace = harness.Trace("serve", prof["busy_s"], prof["window_s"],
                              device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
        for name, rows in common.range_calls(calls).items():
            trace.ranges[name] = (rows, prof["range_s"].get(name))
        calls.clear()
        req_flops = counts.request_flops(setup.shapes)
        trace.values.update(
            request_flops=req_flops,
            mfu=100.0 * req_flops * n / window_s / harness.PEAK_BF16_FLOPS,
            peak_gib=peak / 2 ** 30,
            encode_ms=statistics.median(enc_ms), render_ms=statistics.median(ren_ms))
        out["trace"] = trace
        print(f"traced {n_prof} requests: busy {prof['busy_s']:.4f} of "
              f"{prof['window_s']:.4f} s; ranges {prof['range_s']}; request FLOPs "
              f"{req_flops:.4e}", file=sys.stderr)

    del inf
    free(dev)
    rng = np.random.default_rng(cell.seed + 7)
    k = min(t["checked_requests"], n)
    checked = sorted(rng.choice(n, k, replace=False).tolist())
    t_ref = time.perf_counter()
    ref = reference_outputs(setup, checked)
    out["readings"] = compare([outputs[i] for i in checked], ref, setup.depth_tol)
    print(f"reference {time.perf_counter() - t_ref:.3f} s; readings {out['readings']}",
          file=sys.stderr)
    return out

