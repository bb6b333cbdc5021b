"""Rank processes for tests/test_torch_parallel*.py: each function runs in a
process of its own, started by `spawn` (torch.multiprocessing, the spawn
start method, a free localhost port), joins a gloo group on the CPU and
writes what the test reads into the work directory. Imports only torch and
the port."""

from __future__ import annotations

import socket
from pathlib import Path

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, *args) -> None:
    """Run fn(rank, world, port, *args) in `world` processes; raises if any
    rank fails."""
    mp.spawn(fn, args=(world, free_port(), *args), nprocs=world, join=True)


def assert_replicas_equal(work, world: int = 2) -> list:
    """Every rank's saved params (work/rank{r}.pt, `step_rank`) bit-equal to
    rank 0's; returns what the ranks saved."""
    ranks = [torch.load(Path(work) / f"rank{r}.pt", weights_only=False) for r in range(world)]
    for other in ranks[1:]:
        for net, params in ranks[0]["params"].items():
            for name, p in params.items():
                assert torch.equal(p, other["params"][net][name]), f"{net} {name}"
    return ranks


def _init(rank: int, world: int, port: int):
    from conditioned_nerf_gan_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    return initialize_distributed(f"localhost:{port}", world, rank, device="cpu")


def record_grads(state) -> dict:
    """Wrap the three optimizers' step to keep the grads each steps with
    (after the ranks' average, before the clip)."""
    recorded = {}
    for net in "GED":
        opt = getattr(state, f"opt_{net}")
        if opt is None:
            continue
        module = {"G": state.generator, "E": state.encoder, "D": state.discriminator}[net]
        step = opt.step

        def recording(*args, _net=net, _module=module, _step=step, **kwargs):
            recorded[_net] = {n: (p.grad.clone() if p.grad is not None
                                  else torch.zeros_like(p))
                              for n, p in _module.named_parameters()}
            return _step(*args, **kwargs)

        opt.step = recording
    return recorded


def step_rank(rank: int, world: int, port: int, work: str, steps: int = 1) -> None:
    """Load work/inputs.pt (the nets, the step config, the global batch and
    the rng seed or None), take rank 1's params off rank 0's to show the
    broadcast, replicate, run `steps` data-parallel steps on this rank's
    shard and save the params, the recorded grads, the metrics and the
    all-reduce count to work/rank{rank}.pt."""
    from conditioned_nerf_gan_torch.parallel import average_gradients, replicate
    from conditioned_nerf_gan_torch.parallel import shutdown_distributed
    from conditioned_nerf_gan_torch.training import create_train_state, make_train_step
    from conditioned_nerf_gan_torch.training.trainer import step_seed

    _init(rank, world, port)
    inputs = torch.load(Path(work) / "inputs.pt", weights_only=False)
    nets = inputs["nets"]
    if rank:
        with torch.no_grad():
            for net in nets:
                if net is not None:
                    for p in net.parameters():
                        p.add_(0.5)
    state = create_train_state(*nets, inputs["config"])
    replicate(state, torch.distributed.group.WORLD)
    recorded = record_grads(state)
    step = make_train_step(inputs["config"], group=torch.distributed.group.WORLD)
    b = inputs["batch"]["img"].shape[0] // world
    shard = {k: v[rank * b:(rank + 1) * b] for k, v in inputs["batch"].items()}
    history = []
    calls = average_gradients.calls
    for i in range(steps):
        rng = None
        if inputs.get("seed") is not None:
            rng = torch.Generator().manual_seed(step_seed(inputs["seed"], i, rank))
        state, metrics = step(state, shard, rng, inputs["alpha"], 0.0)
        history.append({k: v.item() for k, v in metrics.items()})
    torch.save({"params": {net: {n: p.detach().clone() for n, p in m.named_parameters()}
                           for net, m in zip("GED", nets) if m is not None},
                "grads": recorded, "metrics": history,
                "all_reduce_calls": average_gradients.calls - calls},
               Path(work) / f"rank{rank}.pt")
    shutdown_distributed()


def barrier_rank(rank: int, world: int, port: int, work: str) -> None:
    """Rank 0 writes a file after a pause; the others must find it after
    the barrier."""
    import time

    from conditioned_nerf_gan_torch.parallel import shutdown_distributed, sync_processes

    _init(rank, world, port)
    flag = Path(work) / "written"
    if rank == 0:
        time.sleep(1.0)
        flag.write_text("rank 0")
    sync_processes("written", timeout_ms=60_000)
    (Path(work) / f"seen{rank}").write_text(str(flag.exists()))
    shutdown_distributed()


def torchrun_rank(rank: int, world: int, port: int, work: str) -> None:
    """Start as under torchrun (its variables set, no coordinator), sum the
    ranks' rank + 1 and write the context and the sum to
    work/context{rank}.json."""
    import json
    import os

    from conditioned_nerf_gan_torch.parallel import initialize_distributed, shutdown_distributed

    for name in ("CNG_COORDINATOR", "CNG_NUM_PROCESSES", "CNG_PROCESS_ID"):
        os.environ.pop(name, None)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    context = initialize_distributed(device="cpu")
    total = torch.tensor([rank + 1.0])
    torch.distributed.all_reduce(total)
    (Path(work) / f"context{rank}.json").write_text(json.dumps(
        [context.rank, context.world_size, str(context.device), context.backend, total.item()]))
    shutdown_distributed()


def train_cli_rank(rank: int, world: int, port: int, argv: list[str]) -> None:
    """One rank of the train CLI (`--smoke --device cpu`), with the eval's
    scoring stood in for (it reads the generated directory and returns its
    image count as the FID, so fid.txt shows what every shard wrote) and
    its renders at the smoke preset's 12 samples a ray (the eval's 96 take
    ~150 s of one CPU thread)."""
    from conditioned_nerf_gan_torch import train
    from conditioned_nerf_gan_torch.eval import fid_evaluation
    from conditioned_nerf_gan_torch.training.trainer import Trainer

    eval_metadata = Trainer._eval_metadata
    Trainer._eval_metadata = lambda self, img_size=None, num_steps=None: eval_metadata(
        self, img_size, 12)

    def count_images(real_dir, fake_dir, *args, **kwargs):
        return (float(len(list(Path(fake_dir).glob("*.png")))), float("nan"), float("nan"),
                float("nan"))

    fid_evaluation.compute_metrics_from_dirs = count_images
    fid_evaluation.compute_fid_from_dirs = lambda real, fake, **kw: count_images(real, fake)[0]
    torch.set_num_threads(1)
    code = train.main([*argv, "--coordinator", f"localhost:{port}", "--num_processes",
                       str(world), "--process_id", str(rank)])
    if code != 0:
        raise SystemExit(code)
