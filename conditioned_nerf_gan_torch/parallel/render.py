"""Ray-sharded rendering (port of conditioned_nerf_gan_tpu/parallel/render.py).

Training splits the batch over ranks (`parallel/mesh.py`). One render at a
high resolution has batch 1 but img_size^2 x num_steps x 2 sample points,
so inference splits the *rays*: one image's pixel rows are cut into slabs,
one slab a device, each rendered by a replica of the generator through its
`row_offset` / `render_rows` hook (`models/generator.py`), and the slabs are
concatenated on the first device. On the card every slab goes through the
kernels the whole render would. A list may name one device more than once:
its slabs then run one after another there.
"""

from __future__ import annotations

import copy
import weakref

import torch

_REPLICAS: dict = {}  # (id(generator), device) -> (weakref, replica, versions)
_REPLICAS_MAX = 16


def _normal(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@torch.no_grad()
def _replica(generator: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """`generator` itself on its own device, else a cached copy on `device`
    whose params are refreshed whenever the generator's have changed."""
    if _normal(next(generator.parameters()).device) == device:
        return generator
    key = (id(generator), str(device))
    versions = tuple(p._version for p in generator.parameters())
    entry = _REPLICAS.pop(key, None)
    if entry is None or entry[0]() is not generator:
        while len(_REPLICAS) >= _REPLICAS_MAX:
            _REPLICAS.pop(next(iter(_REPLICAS)))
        replica = copy.deepcopy(generator).to(device)
    else:
        replica = entry[1]
        if entry[2] != versions:
            for r, p in zip(replica.parameters(), generator.parameters()):
                r.copy_(p)
    _REPLICAS[key] = (weakref.ref(generator), replica, versions)
    return replica


def _to(z, device):
    if isinstance(z, (tuple, list)):
        return type(z)(_to(part, device) for part in z)
    return z.to(device)


def render_ray_sharded(generator, z, cam2world: torch.Tensor, config, devices, *,
                       generator_rng: torch.Generator | None = None, nerf_noise: float = 0.0,
                       fov=None):
    """Render one batch of images, pixel rows split over `devices`.

    The same as `generator(z, cam2world, config, ...)`, but device i renders
    rows [i * H / n, (i + 1) * H / n); img_size must divide over the n
    devices. With `generator_rng` each slab draws from a generator of its
    own, seeded from generator_rng's seed and the slab's index (so a noisy
    render differs from the unsharded one); deterministic renders
    (generator_rng None) are bit-equal to it. Returns (pixels, depth) on
    the first device."""
    devices = [_normal(d) for d in devices]
    n, H = len(devices), config.img_size
    if H % n:
        raise ValueError(f"img_size {H} must divide over {n} devices")
    rows = H // n
    parts = []
    for idx, device in enumerate(devices):
        rng = None
        if generator_rng is not None:  # fold the slab's index into the seed
            seed = generator_rng.initial_seed() + (idx + 1) * 0x9E3779B97F4A7C15
            rng = torch.Generator(device=device).manual_seed(seed % (1 << 64))
        fov_d = fov.to(device) if isinstance(fov, torch.Tensor) else fov
        parts.append(_replica(generator, device)(
            _to(z, device), cam2world.to(device), config, generator=rng,
            nerf_noise=nerf_noise, fov=fov_d, row_offset=idx * rows, render_rows=rows))
    first = devices[0]
    pixels = torch.cat([p.to(first) for p, _ in parts], dim=1)
    depth = torch.cat([d.to(first) for _, d in parts], dim=1)
    return pixels, depth
