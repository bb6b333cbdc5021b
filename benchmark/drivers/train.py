"""Train traffic: a closed loop of the program's train step
(`training.make_train_step`) at one curriculum step.

Set-up builds one TrainState from the seed's weights and drives it
through the traffic's first `checked_steps` steps on a pool of distinct
batches made on the card; those steps warm every shape up, and their losses,
the first gradient (each leaf's clipped gradient, worked out from Adam's
`exp_avg` before and after the step) and each leaf's change after the last
of them are what `correct` compares with the plain reference. The window
then cycles the pool for `--seconds`, from a `torch.cuda.synchronize()` to
one. A traced run adds a window of `profiled_steps` steps under the
profiler, with the kernel entry points wrapped in ranges. After the windows
the program's state (parameters and Adam's moments) is copied and the
program takes one more step from it, through the window's own step; the
reference, loaded with that copy, takes the same step on the same batch and
random stream, and that step's losses, gradients and change are compared
too (the `late_` numbers), so that a step which behaves otherwise once
warmed up is checked as well.

Traffic keys: driver "train", step, pool_batches, checked_steps,
profiled_steps.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from .. import counts, data, harness
from ..reference import plain
from . import common
from .common import free, precise


class Setup:
    """The cell's settings, the seed's weights and batch pool."""

    def __init__(self, cell):
        from conditioned_nerf_gan_torch.training import fade_alpha, nerf_noise_schedule

        t = cell.traffic
        self.cell, self.device = cell, cell.device
        self.meta = meta = common.metadata(cell, t["step"])
        self.nerf_noise = nerf_noise_schedule(t["step"])
        starts = sorted(k for k in _curriculum_starts(cell))
        start = max(s for s in starts if s <= t["step"])
        self.alpha = fade_alpha(t["step"], start, meta["fade_steps"])
        self.ref = harness.reference(cell)
        self.weights = harness.model_weights(self.ref, cell.config, cell.seed, self.device)
        self.shapes = common.shapes(cell, meta, meta["batch_size"])
        self.pool = self._pool(t["pool_batches"])
        self.step_settings = {
            "render": common.render_settings(meta, perturb=True) | {
                "nerf_noise": self.nerf_noise},
            "r1_lambda": meta["r1_lambda"], "z_reg_weight": meta["z_reg_weight"],
            "batch_split": meta.get("batch_split", 1),
            "grad_accum_scale": meta.get("grad_accum_scale") or meta.get("batch_split", 1),
            "gen_lr": meta["gen_lr"], "enc_lr": meta.get("enc_lr", meta["gen_lr"]),
            "disc_lr": meta.get("disc_lr", meta["gen_lr"]), "betas": meta["betas"],
            "grad_clip": meta["grad_clip"], "cam_r_start": meta["cam_r_start"],
            "cam_r_end": meta["cam_r_end"], "random_gen_img": meta["random_gen_img"],
            "photo_loss": meta["photo_loss"], "encoder": self.ref.ENCODER}
        if meta.get("weight_decay", 0) or meta.get("mapping_lr_mult", 1.0) != 1.0 or \
                meta.get("depth_loss") or meta.get("noise_weight", 0):
            raise harness.CellError("the reference step takes no weight decay, no mapping "
                                    "lr multiplier, no depth loss, no latent noise")

    def _pool(self, n: int) -> list:
        """n batches of distinct rows, made on the card from the seed."""
        m, meta, dev = self.cell.config["model"], self.meta, self.device
        B, img = meta["batch_size"], meta["img_size"]
        gen = torch.Generator(device=dev).manual_seed(self.cell.seed + 1)
        pool = []
        for _ in range(n):
            batch = {"img": data.images(gen, B, img, dev),
                     "cam2world": data.cameras(gen, B, meta["cam_r_start"],
                                               meta["cam_r_end"], dev)}
            if m["encoder_input"] == "pcl":
                batch["pcl"] = data.box_clouds(gen, B, self.shapes["encoder"]["points"], dev)
            else:
                clouds = data.box_clouds(gen, B, self.cell.config["voxel_cloud_points"], dev)
                batch["voxel"] = data.voxelize(clouds, meta["voxel_resolution"])
            pool.append(batch)
        return pool

    def generator(self) -> torch.Generator:
        """The step's randomness, the same stream for program and reference."""
        return torch.Generator(device=self.device).manual_seed(self.cell.seed + 2)


def _curriculum_starts(cell):
    from conditioned_nerf_gan_torch.config import load_curriculum

    p = cell.config["preset"]
    return [k for k in load_curriculum(config_base=p["config_base"], config=p["config"])
            if isinstance(k, int)]


class Program:
    """The program's TrainState and step, built from the seed's weights."""

    def __init__(self, setup: Setup):
        import dataclasses

        from conditioned_nerf_gan_torch import training

        meta = setup.meta
        self.G, self.E, self.D = common.program_models(
            meta, setup.weights, setup.device, bool(setup.cell.config["model"]["discriminator"]))
        cfg = training.TrainStepConfig.from_metadata(meta)
        self.cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, density_noise=setup.nerf_noise > 0.0))
        self.state = training.create_train_state(self.G, self.E, self.D, self.cfg)
        self.setup = setup
        self.rebuild()

    def rebuild(self) -> None:
        """The step function anew (a fault that replaces the program's
        `make_train_step` takes hold here)."""
        from conditioned_nerf_gan_torch import training

        self.step_fn = training.make_train_step(self.cfg)

    def nets(self) -> dict:
        return {"generator": self.G, "encoder": self.E, "discriminator": self.D}

    def optimizers(self) -> dict:
        s = self.state
        return {"generator": s.opt_G, "encoder": s.opt_E, "discriminator": s.opt_D}

    def step(self, batch, gen):
        self.state, metrics = self.step_fn(self.state, batch, gen, self.setup.alpha,
                                           self.setup.nerf_noise)
        return metrics


class Reference:
    """The plain reference's nets and step, in the precision `q`."""

    def __init__(self, setup: Setup, q=plain.exact):
        with torch.device(setup.device):
            mods = setup.ref.build(setup.cell.config, q)
        for part, module in mods.items():
            if module is not None:
                module.load_state_dict(setup.weights[part])
        self.mods = mods
        self.train = plain.TrainStep(mods["generator"], mods["encoder"],
                                     mods["discriminator"], setup.step_settings)
        self.setup = setup

    def nets(self) -> dict:
        return self.mods

    def optimizers(self) -> dict:
        t = self.train
        return {"generator": t.opt_G, "encoder": t.opt_E, "discriminator": t.opt_D}

    def step(self, batch, gen):
        return self.train(batch, gen, self.setup.alpha)


def _leaves(side):
    """(part, name, parameter, its optimizer) of each leaf `side` trains."""
    for part, opt in side.optimizers().items():
        if opt is not None:
            for name, p in side.nets()[part].named_parameters():
                yield part, name, p, opt


def _exp_avgs(side) -> dict:
    """A copy of each leaf's Adam first moment (Adam updates it in place)."""
    out = {}
    for part, name, p, opt in _leaves(side):
        m = opt.state.get(p, {}).get("exp_avg")
        out[(part, name)] = None if m is None else m.clone()
    return out


def _gradients(side, before: dict) -> dict:
    """Each leaf's clipped gradient norm in the step just taken, from Adam's
    first moment before (`before`, None before the first step) and after:
    g = (m_after - beta1 m_before) / (1 - beta1)."""
    out = {}
    for part, name, p, opt in _leaves(side):
        m = opt.state.get(p, {}).get("exp_avg")
        if m is None:
            out[f"{part}/{name}"] = 0.0
            continue
        b1 = opt.param_groups[0]["betas"][0]
        m0 = before.get((part, name))
        g = m if m0 is None else m - b1 * m0
        out[f"{part}/{name}"] = float(g.norm()) / (1.0 - b1)
    return out


def _changes(side, start: dict) -> dict:
    """Each leaf's change from `start` ({part: state dict})."""
    return {f"{part}/{name}": float((p.detach() - start[part][name]).norm())
            for part, net in side.nets().items() if net is not None
            for name, p in net.named_parameters()}


def checked_steps(setup: Setup, side, n: int) -> dict:
    """Drive `side` (Program or Reference) through the first n steps of the
    pool; return the losses of each step, each leaf's first gradient and
    each leaf's change after the n."""
    gen = setup.generator()
    losses, grads = [], {}
    for t in range(n):
        metrics = side.step(setup.pool[t], gen)
        losses.append({k: float(v) for k, v in metrics.items()})
        if t == 0:
            grads = _gradients(side, {})
    return {"losses": losses, "grads": grads, "change": _changes(side, setup.weights)}


def snapshot(side) -> dict:
    """A copy of `side`'s state: each net's state dict and each leaf's Adam
    state, by the leaf's name."""
    return {"weights": {part: {k: v.detach().clone() for k, v in net.state_dict().items()}
                        for part, net in side.nets().items() if net is not None},
            "adam": {(part, name): {k: v.clone() for k, v in opt.state.get(p, {}).items()}
                     for part, name, p, opt in _leaves(side)}}


def restore(side, snap: dict) -> None:
    """Load `snapshot(...)`'s copy into `side` (Program or Reference)."""
    for part, net in side.nets().items():
        if net is not None:
            net.load_state_dict(snap["weights"][part])
    for part, name, p, opt in _leaves(side):
        opt.state[p] = {k: v.clone() for k, v in snap["adam"][(part, name)].items()}


def late_step(setup: Setup, side, snap: dict, index: int) -> dict:
    """One step of `side` from the state `snap` on pool batch `index` with
    the late stream: its losses, each leaf's gradient and change."""
    restore(side, snap)
    gen = torch.Generator(device=setup.device).manual_seed(setup.cell.seed + 4)
    before = _exp_avgs(side)
    metrics = side.step(setup.pool[index % len(setup.pool)], gen)
    return {"losses": [{k: float(v) for k, v in metrics.items()}],
            "grads": _gradients(side, before), "change": _changes(side, snap["weights"])}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers `correct` may hold to limits:
    loss_gap: the largest |program - reference| / |reference| over the
      checked steps' losses (terms both sides put at 0 left out);
      loss1_gap: the same over the first step's alone;
    grad_gap: over the leaves, the gap of the first gradient's norms over
      the larger of the reference leaf's norm and the median leaf's;
    change_gap: the same of each leaf's change after the steps, leaving out
      leaves whose reference gradient is under 1e-3 of the median leaf's
      (round-off alone moves them under Adam);
    grad_p50_gap and change_p50_gap: the median leaf's gaps;
    grad_worst and change_worst name the worst leaves."""

    def loss_gap(steps):
        gap = 0.0
        for lp, lr in steps:
            for k, r in lr.items():
                if r == 0.0 and lp[k] == 0.0:
                    continue
                gap = max(gap, abs(lp[k] - r) / max(abs(r), 1e-12))
        return gap

    steps = list(zip(prog["losses"], ref["losses"], strict=True))
    if set(prog["grads"]) != set(ref["grads"]):
        raise RuntimeError("the program's leaves are not the reference's")
    g_ref = ref["grads"]
    g_med = statistics.median(g_ref.values())
    grad = {k: abs(prog["grads"][k] - v) / max(v, g_med) for k, v in g_ref.items()}
    moving = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    c_ref = ref["change"]
    c_med = statistics.median(c_ref[k] for k in moving)
    change = {k: abs(prog["change"][k] - c_ref[k]) / max(c_ref[k], c_med) for k in moving}
    return {"loss_gap": loss_gap(steps), "loss1_gap": loss_gap(steps[:1]),
            "grad_gap": max(grad.values()), "grad_p50_gap": statistics.median(grad.values()),
            "change_gap": max(change.values()),
            "change_p50_gap": statistics.median(change.values()),
            "grad_worst": max(grad, key=grad.get), "change_worst": max(change, key=change.get)}


def reference_readings(setup: Setup, q=plain.exact) -> dict:
    """The reference's readings over the checked steps, TF32 off."""
    n = setup.cell.traffic["checked_steps"]
    with precise():
        ref = Reference(setup, q)
        readings = checked_steps(setup, ref, n)
    del ref
    free(setup.device)
    return readings


def late_reference_readings(setup: Setup, snap: dict, index: int, q=plain.exact) -> dict:
    """The reference's readings of the late step from the program's state
    `snap`, TF32 off."""
    with precise():
        ref = Reference(setup, q)
        readings = late_step(setup, ref, snap, index)
    del ref
    free(setup.device)
    return readings


def late(gaps: dict) -> dict:
    """The late step's numbers under their own names (one step: its loss
    gap is step 1's)."""
    return {f"late_{k}": v for k, v in gaps.items() if k != "loss1_gap"}


def run(cell, t0: float) -> dict:
    """One run of the cell: set-up and the checked steps, the window, the
    traced window (with --trace 1), the reference's check."""
    dev = cell.device
    setup = Setup(cell)
    common.sync(dev)
    print(f"at {time.perf_counter() - t0:.3f} s: weights and batch pool made", file=sys.stderr)
    prog = Program(setup)
    print(f"at {time.perf_counter() - t0:.3f} s: program built", file=sys.stderr)
    n_checked = cell.traffic["checked_steps"]
    readings = checked_steps(setup, prog, n_checked)
    common.sync(dev)
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s; shapes {setup.shapes}", file=sys.stderr)

    gen = torch.Generator(device=dev).manual_seed(cell.seed + 3)
    pool, P = setup.pool, len(setup.pool)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    common.sync(dev)
    start = time.perf_counter()
    steps = 0
    while time.perf_counter() - start < cell.seconds:
        prog.step(pool[(n_checked + steps) % P], gen)
        steps += 1
    common.sync(dev)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    B = setup.meta["batch_size"]
    out = {"attempted": steps, "failed": 0, "peak": peak,
           "e2e": {"train_images_per_s": B * steps / window_s, "setup_s": setup_s},
           "trace": None}

    if cell.trace:
        calls: dict = {}
        n_prof = cell.traffic["profiled_steps"]

        def traced():
            for i in range(n_prof):
                prog.step(pool[i % P], gen)

        with common.kernel_ranges(calls):
            prof = harness.profile_window(traced, common.RANGES, calls.clear)
        trace = harness.Trace("train", prof["busy_s"], prof["window_s"],
                              device_ops=prof["device_ops"], idle_gaps=prof["idle_gaps"])
        for name, rows in common.range_calls(calls).items():
            trace.ranges[name] = (rows, prof["range_s"].get(name))
        calls.clear()
        step_flops = counts.train_step_flops(setup.shapes)
        trace.values.update(
            step_flops=step_flops,
            mfu=100.0 * step_flops * steps / window_s / harness.PEAK_BF16_FLOPS,
            peak_gib=peak / 2 ** 30)
        out["trace"] = trace
        print(f"traced {n_prof} steps: busy {prof['busy_s']:.4f} of {prof['window_s']:.4f} s; "
              f"ranges {prof['range_s']}; step FLOPs {step_flops:.4e}",
              file=sys.stderr)

    late_index = n_checked + steps
    snap = snapshot(prog)
    late_prog = late_step(setup, prog, snap, late_index)
    del prog, pool
    free(dev)
    t_ref = time.perf_counter()
    ref = reference_readings(setup)
    late_ref = late_reference_readings(setup, snap, late_index)
    out["readings"] = compare(readings, ref) | late(compare(late_prog, late_ref))
    print(f"reference {time.perf_counter() - t_ref:.3f} s; readings {out['readings']}",
          file=sys.stderr)
    out["detail"] = {"program": readings["losses"], "reference": ref["losses"],
                     "late_program": late_prog["losses"], "late_reference": late_ref["losses"]}
    return out

