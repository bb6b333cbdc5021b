"""Multi-process wiring (port of conditioned_nerf_gan_tpu/parallel/distributed.py).

One process a card, the `torchrun` idiom: every process runs the whole
train CLI on its own shard of the data, and the ranks meet in
`torch.distributed` collectives (the grads' average, `parallel/mesh.py`)
and in `sync_processes` barriers around what rank 0 alone writes.

  * `initialize_distributed` takes the coordinator, the process count and
    this process's id, each falling back to CNG_COORDINATOR /
    CNG_NUM_PROCESSES / CNG_PROCESS_ID, and with no coordinator at all to
    `torchrun`'s environment (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK). It sets this rank's card first, then starts the process
    group.
  * The backend follows from the devices and is printed at start: NCCL
    where each rank has a card of its own; gloo on the CPU, or where ranks
    may share a card (more ranks on a host than it has cards, or a card
    named by `--device cuda:N`), since NCCL refuses two ranks on one
    device. The ranks on this host are torchrun's LOCAL_WORLD_SIZE, else
    counted from the host names every rank posts to the rendezvous store;
    this rank's index among them picks its card. A failure is raised; the
    backend is never switched after one.
  * `sync_processes` is the barrier, with a timeout of its own: the eval's
    barriers wait out minutes of rank 0's FID. It runs on a gloo group
    (`monitored_barrier` takes a per-call timeout); no-op in one process.

Not ported: `compile_aligned` and the gloo warm-up after the start. Both
work around XLA's 30 s rendezvous window at the first collective of a
compiled program (the JAX module's `:52-98`); nothing here is compiled
ahead, and every collective takes the process group's timeout.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_MS = 600_000


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """This process's place in the run: its rank, the world size, its
    torch device and the backend of the process group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


_CONTROL_GROUP = None  # the gloo group of the barriers when the backend is NCCL


def resolve_arguments(coordinator: str | None = None, num_processes: int | None = None,
                      process_id: int | None = None) -> tuple:
    """The three arguments with the CNG_* environment as their fallback."""
    coordinator = coordinator or os.environ.get("CNG_COORDINATOR") or None
    if num_processes is None and os.environ.get("CNG_NUM_PROCESSES"):
        num_processes = int(os.environ["CNG_NUM_PROCESSES"])
    if process_id is None and os.environ.get("CNG_PROCESS_ID"):
        process_id = int(os.environ["CNG_PROCESS_ID"])
    return coordinator, num_processes, process_id


def choose_backend(device: str | torch.device, local_world_size: int) -> str:
    """"nccl" where each rank takes a card of its own (an unnumbered cuda
    device and no more ranks on this host than it has cards), else "gloo":
    on the CPU, or where ranks may share a card. Every rank of a host
    decides alike."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def local_ranks(hosts: list[str], rank: int) -> tuple[int, int]:
    """This rank's index among the ranks whose host name is its own, and
    their number (`hosts[r]` is rank r's)."""
    same = [r for r, host in enumerate(hosts) if host == hosts[rank]]
    return same.index(rank), len(same)


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """This rank's device: `device` as given, or for an unnumbered cuda
    device card `local_rank % torch.cuda.device_count()`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, *, device: str = "cuda",
                           timeout_ms: int = DEFAULT_TIMEOUT_MS) -> DistributedContext:
    """Start the process group (call before any collective); returns the
    context. `coordinator` is host:port of rank 0's store."""
    global _CONTROL_GROUP
    coordinator, num_processes, process_id = resolve_arguments(coordinator, num_processes,
                                                               process_id)
    if coordinator is None:  # torchrun's environment
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise ValueError("initialize_distributed: no coordinator (--coordinator or "
                             "CNG_COORDINATOR) and no torchrun environment (WORLD_SIZE, RANK)")
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize_distributed: a coordinator needs num_processes and "
                             "process_id (flags or CNG_NUM_PROCESSES / CNG_PROCESS_ID)")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if not 0 <= process_id < num_processes:
        raise ValueError(f"initialize_distributed: process_id {process_id} is not a rank of "
                         f"{num_processes} processes")
    timeout = timedelta(milliseconds=timeout_ms)
    store, _, _ = next(dist.rendezvous(init_method, process_id, num_processes, timeout=timeout))
    store.set_timeout(timeout)
    if "LOCAL_WORLD_SIZE" in os.environ and "LOCAL_RANK" in os.environ:  # torchrun
        local_rank = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ["LOCAL_WORLD_SIZE"])
    else:
        store.set(f"cng_host/{process_id}", socket.gethostname())
        hosts = [store.get(f"cng_host/{r}").decode() for r in range(num_processes)]
        local_rank, local_world = local_ranks(hosts, process_id)
    backend = choose_backend(device, local_world)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # before the group: NCCL binds to the current card
    dist.init_process_group(backend=backend, store=dist.PrefixStore("default_pg", store),
                            world_size=num_processes, rank=process_id, timeout=timeout)
    _CONTROL_GROUP = dist.new_group(backend="gloo", timeout=timeout) if backend != "gloo" else None
    print(f"Distributed: rank {process_id} of {num_processes} ({local_rank} of {local_world} "
          f"on this host), backend {backend}, device {dev}", flush=True)
    return DistributedContext(process_id, num_processes, dev, backend)


def shutdown_distributed() -> None:
    """Destroy the process groups, if any."""
    global _CONTROL_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _CONTROL_GROUP = None


def distributed_requested(args=None) -> bool:
    """True if CLI flags or env vars ask for multi-process execution."""
    if args is not None and (getattr(args, "distributed", False)
                             or getattr(args, "coordinator", None)):
        return True
    return bool(os.environ.get("CNG_COORDINATOR"))


def sync_processes(name: str, timeout_ms: int = DEFAULT_TIMEOUT_MS) -> None:
    """Barrier of every rank, waiting up to `timeout_ms` (named for the
    error it raises when a rank does not arrive); no-op in one process."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return
    try:
        dist.monitored_barrier(group=_CONTROL_GROUP, timeout=timedelta(milliseconds=timeout_ms),
                               wait_all_ranks=True)
    except RuntimeError as exc:
        raise RuntimeError(f"barrier {name!r}: {exc}") from exc
