"""The plain references against the program's fp32 path (compute_dtype
None: no bf16 policy, exact sin; on the CPU the program takes no kernel) at
a small size, fed the same seeded weights and inputs.

The first train step is held tight: the same weights, batch and random
stream give the same losses and first gradients to fp32 rounding. The later
steps are not held: Adam's first steps move every element by about lr times
the sign of its gradient, so a rounding-sized gradient flips its element's
step on either side."""

import pytest
import torch

from benchmark.drivers import common, serve, train


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("workload", ["thesis_train_s2", "dg_train_s2"])
def test_train_reference_is_the_programs_fp32_step(tiny_cell, workload):
    setup = train.Setup(tiny_cell(workload))
    setup.meta["compute_dtype"] = None
    prog = train.checked_steps(setup, train.Program(setup), 1)
    ref = train.checked_steps(setup, train.Reference(setup), 1)
    for k, r in ref["losses"][0].items():
        assert prog["losses"][0][k] == pytest.approx(r, rel=1e-5, abs=1e-7), k
    med = sorted(ref["grads"].values())[len(ref["grads"]) // 2]
    for k, r in ref["grads"].items():
        assert abs(prog["grads"][k] - r) <= 1e-3 * max(r, med), k


@pytest.mark.parametrize("workload", ["thesis_train_s2", "dg_train_s2"])
def test_train_reference_at_stage_0_is_the_programs_fp32_step(tiny_cell, workload):
    """At step 0 the render adds density noise (std 1) and `dg` splits its
    G/E step in two: the reference draws the noise in the program's order
    and sums the parts' gradients as the program does."""
    cell = tiny_cell(workload)
    cell.traffic = dict(cell.traffic, step=0)
    setup = train.Setup(cell)
    assert setup.nerf_noise == 1.0
    assert setup.step_settings["batch_split"] == (2 if workload == "dg_train_s2" else 1)
    setup.meta["compute_dtype"] = None
    prog = train.checked_steps(setup, train.Program(setup), 1)
    ref = train.checked_steps(setup, train.Reference(setup), 1)
    for k, r in ref["losses"][0].items():
        assert prog["losses"][0][k] == pytest.approx(r, rel=1e-5, abs=1e-7), k
    med = sorted(ref["grads"].values())[len(ref["grads"]) // 2]
    for k, r in ref["grads"].items():
        assert abs(prog["grads"][k] - r) <= 1e-3 * max(r, med), k


@pytest.mark.parametrize("workload", ["thesis_serve", "dg_serve"])
def test_serve_reference_is_the_programs_fp32_render(tiny_cell, workload):
    setup = serve.Setup(tiny_cell(workload))
    inf = serve.inferencer(setup)
    meta = dict(setup.meta, compute_dtype=None)
    G, E, _ = common.program_models(meta, setup.weights, "cpu", False)
    inf.generator, inf.encoder = G.eval(), E.eval()
    outs = [serve.serve_one(inf, setup.key, *setup.request(i)) for i in range(2)]
    ref = serve.reference_outputs(setup, [0, 1])
    gaps = serve.compare(outs, ref, setup.depth_tol)
    # fp32 on both sides; the U-Net's convs sum in another order batched (the
    # program) than a sample at a time (the reference), ~1e-6 of the volume,
    # which the SIREN's freq ~30-45 carries to a few pixels' 1e-4
    assert gaps["rgb_gap"] < 1e-3 and gaps["depth_gap"] < 1e-3, gaps
    assert gaps["rgb_moved_share"] == 0.0 and gaps["rgb_rel_gap"] < 1e-3, gaps
    assert gaps["depth_moved_share"] == 0.0 and gaps["depth_rel_gap"] < 1e-3, gaps


@pytest.mark.parametrize("workload", ["thesis_train_s2", "dg_train_s2"])
def test_late_reference_step_follows_the_programs_state(tiny_cell, workload):
    """The late step: the reference loaded with a copy of the program's
    state (weights and Adam's moments, after steps that stand in for the
    window) takes the program's step to fp32 rounding, and the copy is
    restored exactly."""
    setup = train.Setup(tiny_cell(workload))
    setup.meta["compute_dtype"] = None
    prog = train.Program(setup)
    train.checked_steps(setup, prog, 2)
    snap = train.snapshot(prog)
    late_prog = train.late_step(setup, prog, snap, 2)
    assert train.late_step(setup, prog, snap, 2) == late_prog
    late_ref = train.late_reference_readings(setup, snap, 2)
    for k, r in late_ref["losses"][0].items():
        assert late_prog["losses"][0][k] == pytest.approx(r, rel=1e-5, abs=1e-7), k
    med = sorted(late_ref["grads"].values())[len(late_ref["grads"]) // 2]
    for k, r in late_ref["grads"].items():
        assert abs(late_prog["grads"][k] - r) <= 1e-3 * max(r, med), k
    gaps = train.late(train.compare(late_prog, late_ref))
    assert gaps["late_loss_gap"] < 1e-4 and gaps["late_grad_p50_gap"] < 1e-4, gaps
