"""The port's ranks on the CPU without JAX, each a process of its own
(tests/torch_parallel_worker.py), over gloo: the voxel family's `dg` step
against a one-process average of the two half-batch grads, with the ranks'
params bit-equal after every step; the barrier; the start-up from
torchrun's environment. ~30 s of CPU alone (each two-rank run ~5-15 s)."""

import numpy as np
import torch

import torch_parallel_worker as worker
from conditioned_nerf_gan_torch.parallel import distributed
from conditioned_nerf_gan_torch.training import build_stage_bench, create_train_state
from conditioned_nerf_gan_torch.training import make_train_step


def _half_batch_reference(bench, batch, world, steps):
    """One process: each step, the G and E grads of every rank's shard taken
    on a copy of the state (its optimizers' step records the grads and does
    not step), summed in rank order and divided by the world size, then the
    same ClippedAdam steps on the state itself. For a step without a
    discriminator."""
    import copy

    nets = (("G", "generator"), ("E", "encoder"))
    state = create_train_state(bench.generator, bench.encoder, None, bench.config)
    step = make_train_step(bench.config)
    b = batch["img"].shape[0] // world
    for _ in range(steps):
        grads = []
        for r in range(world):
            twin, seen = copy.deepcopy(state), {}
            for net, attr in nets:
                getattr(twin, f"opt_{net}").step = (
                    lambda _m=getattr(twin, attr), _n=net: seen.__setitem__(
                        _n, {n: p.grad.clone() for n, p in _m.named_parameters()}))
            step(twin, {k: v[r * b:(r + 1) * b] for k, v in batch.items()}, None,
                 bench.alpha, 0.0)
            grads.append(seen)
        for net, attr in nets:
            for name, p in getattr(state, attr).named_parameters():
                total = grads[0][net][name]
                for g in grads[1:]:
                    total = total + g[net][name]
                p.grad = total / world
        state.opt_G.step()
        state.opt_E.step()
    return state


def test_two_rank_dg_step_matches_the_half_batch_average(tmp_path):
    """Two steps of the voxel family (`dg`: UNet3D + TALLSIREN_FG at full
    width, 16^3 grids, 16^2, 6 + 6 samples, 4 ray chunks) on two gloo ranks
    against one process that averages the two half-batch grads and takes
    the same ClippedAdam steps: params within fp32 roundings (the one
    all-reduce sums in another order than the reference's), bit-equal
    across ranks, one all-reduce per optimizer step."""
    small = dict(batch_size=4, img_size=16, num_steps=6, ray_chunks=4, voxel_resolution=16)
    bench = build_stage_bench("dg", stage=2, meta_overrides=small)
    assert bench.discriminator is None
    batch = {k: torch.from_numpy(v) for k, v in bench.batch.items()}
    torch.save({"nets": [bench.generator, bench.encoder, None], "config": bench.config,
                "alpha": bench.alpha, "seed": None, "batch": batch}, tmp_path / "inputs.pt")
    worker.spawn(worker.step_rank, 2, str(tmp_path), 2)
    ranks = worker.assert_replicas_equal(tmp_path)
    assert ranks[0]["all_reduce_calls"] == 2 * 2  # G (with the metrics) and E, two steps

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the CPU's conv backward sums by threads
    try:
        ref = _half_batch_reference(bench, batch, 2, steps=2)
    finally:
        torch.set_num_threads(threads)
    for net, module in (("G", ref.generator), ("E", ref.encoder)):
        for name, p in module.named_parameters():
            got = ranks[0]["params"][net][name]
            scale = max(p.detach().abs().max().item(), 1e-3)
            np.testing.assert_allclose(got.numpy(), p.detach().numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=f"{net} {name}")


def test_barrier_waits_for_rank_0(tmp_path):
    """`sync_processes`: no rank passes before rank 0 arrives."""
    worker.spawn(worker.barrier_rank, 2, str(tmp_path))
    assert [(tmp_path / f"seen{r}").read_text() for r in range(2)] == ["True", "True"]
    distributed.sync_processes("alone")  # one process: a no-op


def test_start_up_from_the_torchrun_environment(tmp_path):
    """With no coordinator, the ranks start from torchrun's variables
    (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
    LOCAL_WORLD_SIZE): each gets its rank, the world size, the CPU and
    gloo, and an all-reduce sums over both."""
    import json

    worker.spawn(worker.torchrun_rank, 2, str(tmp_path))
    got = [json.loads((tmp_path / f"context{r}.json").read_text()) for r in range(2)]
    assert got == [[r, 2, "cpu", "gloo", 3.0] for r in range(2)]
