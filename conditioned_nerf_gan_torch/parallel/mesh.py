"""Data parallelism over ranks (port of what torch needs of
conditioned_nerf_gan_tpu/parallel/mesh.py).

The JAX package runs a step that holds a Pallas kernel over a device mesh
under `shard_map` (the manual path): each device trains on its shard of the
batch, and the grads are `pmean`ed before the optimizer chains. Here each
rank is a process with its own card, so:

  * `replicate` is a broadcast from rank 0 of the modules' params and
    buffers and of the optimizers' state, after the build and after a
    resume;
  * the pmean is `average_gradients`: one all-reduce per optimizer step,
    of its grads in one flat bucket (with any metrics to average riding
    along), then a division by the world size;
  * `shard_batch` is the loader's rank shard
    (`data.DataLoader(process_index=, process_count=)`).

`make_mesh`, `data_sharding` and `compile_train_step`'s GSPMD path have no
counterpart: there is no compiled SPMD program to place arrays for.
`DistributedDataParallel` is not used: its reducer does not support the R1
penalty's `torch.autograd.grad(..., create_graph=True)`, and the explicit
all-reduce keeps a rank's launches those of one process.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _flat_broadcast(tensors: list[torch.Tensor], group, device: torch.device) -> None:
    """Broadcast `tensors` from rank 0 in place, one bucket a dtype, staged
    on `device` (NCCL takes no CPU tensor)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in ts])
        dist.broadcast(flat, src=0 if group is None else dist.get_global_rank(group, 0),
                       group=group)
        offset = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


@torch.no_grad()
def replicate(state, group=None) -> None:
    """Give every rank rank 0's train state: the generator's, encoder's and
    discriminator's params and buffers and the three optimizers' state
    (Adam's moments and step counts), in place. Every rank must hold the
    same structure (the same build, the same checkpoint restored)."""
    nets = [m for m in (state.generator, state.encoder, state.discriminator) if m is not None]
    device = next(nets[0].parameters()).device
    tensors = [t for m in nets for t in (*m.parameters(), *m.buffers())]
    for opt in (state.opt_G, state.opt_E, state.opt_D):
        if opt is None:
            continue
        for group_ in opt.param_groups:
            for p in group_["params"]:
                per_param = opt.state.get(p, {})
                tensors += [per_param[k] for k in sorted(per_param)
                            if isinstance(per_param[k], torch.Tensor)]
    _flat_broadcast(tensors, group, device)


@torch.no_grad()
def average_gradients(optimizer: torch.optim.Optimizer, group=None,
                      extras: list[torch.Tensor] = ()) -> list[torch.Tensor]:
    """Average the grads of `optimizer`'s params over the ranks of `group`
    (a missing grad counts as zeros, as the optimizer steps it), in one
    all-reduce of one flat bucket that also carries `extras` (scalars:
    losses, metrics); returns the averaged extras. Each call adds one to
    `average_gradients.calls`."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    parts = [p.grad.reshape(-1) if p.grad is not None else torch.zeros(p.numel(),
                                                                         device=p.device)
             for p in params]
    parts += [e.detach().reshape(-1).to(parts[0].device, torch.float32) for e in extras]
    flat = torch.cat(parts)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    average_gradients.calls += 1
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n
    return list(flat[offset:].clone().unbind())


average_gradients.calls = 0
