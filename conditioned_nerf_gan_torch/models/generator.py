"""Generator composition (port of conditioned_nerf_gan_tpu/models/generator.py).

Conditioning latent + cameras -> rendered images: ray generation, coarse
SIREN evaluation, hierarchical fine resampling (detached), stable sort-merge,
final integration, pixels scaled to [-1, 1], a z-depth map. Images are NHWC.

With grad enabled and `ray_chunks` > 1, a render keeps every chunk's
activations for the backward when they fit, and replays nothing. The first
chunk runs as it is; its retained bytes are the rise of the allocator's
`memory_allocated` across it. If the other chunks' share, that many bytes
each, fits in half of what the device still has available
(`activation_room`; the other half is for the backward's transients: K2's
scratch, R1's double backward, the optimizers), they run as it is too;
otherwise each runs under `torch.utils.checkpoint`, as the JAX package's
`chunk_fn` remat does, and its forward is replayed in the backward. A
device without allocator stats (the CPU) keeps every chunk.
`utils.tracing.chunks_kept` and `chunks_replayed` count the two. The JAX
package's `save_siren_outputs` (a lever that saved the SIREN outputs across
its remat, measured neutral) has no port: a chunk that fits keeps all of
its activations, and one that does not saves nothing but its inputs.

Every random number of a render (perturbation, fine-sample uniforms,
density noise) is drawn up front for the whole image: a replayed chunk
sees the same fine samples and noise, and chunked, unchunked, kept and
replayed renders draw the same numbers. The conditioning `z` is whatever
the SIREN takes: a latent, or the voxel family's (feature volume, global)
pair, (pyramid, global) pair or bare volume, which every chunk (and its
replay) reads whole; with grad on the kernel route each volume, a
pyramid's every level, goes through `ops.grid_sample.one_volume_grad` once
a render (`one_grad_per_volume`), so the backward of every chunk's lookups
adds into one dV a volume.
Under a torch profiler a render records the span `gen.render`, and each ray
chunk `gen.chunk`, a replayed chunk's replay in the backward too
(`utils/tracing.py`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.grid_sample import one_volume_grad
from ..ops.integration import volume_integrate
from ..ops.rays import distance2depth, get_initial_rays, perturb_points, transform_rays
from ..ops.sampling import merge_sorted_samples, sample_pdf
from ..utils import tracing
from .siren import SIREN_SPECS, make_siren


def one_grad_per_volume(z):
    """z with every feature volume in it (a 5-D tensor: a bare volume, a
    pair's volume, each level of a pyramid) through `one_volume_grad`; a
    latent or a global feature as it is."""
    if isinstance(z, torch.Tensor):
        return one_volume_grad(z) if z.ndim == 5 else z
    if isinstance(z, (tuple, list)):
        return type(z)(one_grad_per_volume(part) for part in z)
    return z


def allocated_bytes(device: torch.device) -> int:
    """The bytes the allocator has handed out on `device` (a host-side
    counter: no wait); 0 on a device without allocator stats."""
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def activation_room(device: torch.device) -> int | None:
    """Bytes that a render under grad may keep of its chunks' activations on
    `device`: half of what is still available there, the free memory
    `cudaMemGetInfo` reports plus what torch's allocator has reserved and
    not handed out. `cudaMemGetInfo` returns without waiting for the
    device's queued work.
    None on a device without allocator stats (the CPU): keep every chunk."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    unused = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return (free + unused) // 2


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering options."""

    img_size: int = 64
    num_steps: int = 48
    fov: float = 30.0
    ray_start: float = 0.7
    ray_end: float = 1.3
    hierarchical_sample: bool = True
    clamp_mode: str = "relu"
    white_back: bool = False
    last_back: bool = False
    fill_mode: str | None = None
    perturb: bool = True
    ray_chunks: int = 0  # >1: render the rays in this many chunks, one at a time
    # static density-noise gate: `nerf_noise` is added only where this is set
    # and the render is stochastic (the trainer clears it once the schedule
    # reaches 0)
    density_noise: bool = True

    @classmethod
    def from_metadata(cls, metadata: dict, **overrides) -> "RenderConfig":
        """Build from a curriculum metadata dict (ignores unrelated keys)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in metadata.items() if k in fields}
        kwargs.update(overrides)
        return cls(**kwargs)


class ImplicitGenerator3d(nn.Module):
    """NeRF generator around a SIREN decoder."""

    def __init__(self, siren_type: str = "SHORTSIREN", z_dim: int = 512,
                 input_dim: int = 3, output_dim: int = 4, hidden_dim: int = 256,
                 drop_out: float = 0.0, mapping_network: str = "CustomMappingNetwork",
                 compute_dtype: torch.dtype | None = None, use_fast_sin: bool = False,
                 use_kernel: bool = False, *, generator: torch.Generator | None = None):
        super().__init__()
        self.siren_type = siren_type
        self.z_dim = z_dim
        self.siren = make_siren(
            siren_type, z_dim=z_dim, input_dim=input_dim, output_dim=output_dim,
            hidden_dim=hidden_dim, drop_out=drop_out, mapping_network=mapping_network,
            compute_dtype=compute_dtype, use_fast_sin=use_fast_sin,
            use_kernel=use_kernel, generator=generator)

    def eval_points(self, points: torch.Tensor, z) -> torch.Tensor:
        """The SIREN field at world points (B, N, 3), contiguous -> (B, N, 4)
        rgb + sigma (shape extraction). z is whatever `forward` takes; on
        the card the points go through the kernels the render uses."""
        return self.siren(points, z)

    def _ray_pipeline(self, z, points, z_vals, rays_d_world, origins,
                      config: RenderConfig, fine_u, noise1, noise2, nerf_noise):
        """SIREN evals + hierarchical resample + integrate for one set of
        rays: points (B, R, S, 3) -> pixels (B, R, 3), distances (B, R, 1).
        fine_u (B, R, S) are the fine-sample uniforms (None: deterministic
        linspace); noise1 (B, R, S, 1) and noise2 the density noise of the
        two integrations (None: none)."""
        B, R, S, _ = points.shape
        # a ray-chunk slice reshapes to a strided view; the kernel takes
        # contiguous points
        coarse = self.siren(points.reshape(B, R * S, 3).contiguous(), z)
        coarse = coarse.reshape(B, R, S, 4)
        if config.hierarchical_sample:
            with torch.no_grad():
                _, _, weights = volume_integrate(
                    coarse, z_vals, noise_std=nerf_noise, noise=noise1,
                    clamp_mode=config.clamp_mode)
                weights = weights.reshape(B * R, S) + 1e-5
                z_flat = z_vals.reshape(B * R, S)
                z_mid = 0.5 * (z_flat[:, :-1] + z_flat[:, 1:])
                fine_z = sample_pdf(
                    z_mid, weights[:, 1:-1], S, det=fine_u is None,
                    uniforms=None if fine_u is None else fine_u.reshape(B * R, S),
                ).reshape(B, R, S, 1)
                fine_points = (origins[:, :, None, :]
                               + rays_d_world[:, :, None, :] * fine_z)
            fine = self.siren(fine_points.reshape(B, R * S, 3), z).reshape(B, R, S, 4)
            all_outputs, all_z = merge_sorted_samples(fine, fine_z, coarse, z_vals)
        else:
            all_outputs, all_z = coarse, z_vals
        pixels, distances, _ = volume_integrate(
            all_outputs, all_z, noise_std=nerf_noise, noise=noise2,
            white_back=config.white_back, last_back=config.last_back,
            clamp_mode=config.clamp_mode, fill_mode=config.fill_mode)
        return pixels, distances

    def forward(self, z, cam2world: torch.Tensor, config: RenderConfig,
                *, generator: torch.Generator | None = None, nerf_noise: float = 0.0,
                fov=None, row_offset: int | None = None,
                render_rows: int | None = None):
        """Render a batch of images.

        z (B, z_dim), a (volume (B, D, H, W, C) or pyramid [levels],
        global (B, z_dim)) pair, or a bare volume; cam2world (B, 4, 4). `generator` drives stratified
        perturbation, stochastic fine sampling and, where
        `config.density_noise` is set, density noise of std `nerf_noise`;
        None renders deterministically. `fov` overrides config.fov (scalar
        or per-image (B,)). `row_offset`/`render_rows` render rows
        [row_offset, row_offset + render_rows) of the img_size-tall grid.
        Returns pixels (B, H, W, 3) in [-1, 1] and depth (B, H, W).
        """
        with tracing.span("gen.render"):
            return self._render(z, cam2world, config, generator, nerf_noise, fov,
                                row_offset, render_rows)

    def _render(self, z, cam2world, config, generator, nerf_noise, fov, row_offset,
                render_rows):
        B = cam2world.shape[0]
        S = config.num_steps
        W = H = config.img_size
        if render_rows is not None:
            H = render_rows
            if row_offset is None:
                row_offset = 0
        device = cam2world.device

        points, z_vals, rays_d_cam = get_initial_rays(
            B, S, config.fov if fov is None else fov, (W, H),
            config.ray_start, config.ray_end, row_offset=row_offset,
            full_height=config.img_size, device=device)
        if config.perturb and generator is not None:
            points, z_vals = perturb_points(points, z_vals, rays_d_cam,
                                            generator=generator)
        points, z_vals, rays_d_world, origins = transform_rays(
            points, z_vals, rays_d_cam, cam2world)

        # the render's remaining random numbers, for the whole image at once
        R = W * H
        fine_u = noise1 = noise2 = None
        if generator is not None:
            draw = dict(generator=generator, dtype=z_vals.dtype, device=device)
            if config.hierarchical_sample:
                fine_u = torch.rand((B, R, S), **draw)
            if config.density_noise:
                noise1 = torch.randn((B, R, S, 1), **draw)
                n_all = 2 * S if config.hierarchical_sample else S
                noise2 = torch.randn((B, R, n_all, 1), **draw)
        rays = [points, z_vals, rays_d_world, origins, fine_u, noise1, noise2]
        # every lookup of a feature volume, in every chunk, adds into one dV
        # a volume (on the kernel route with grad)
        z = one_grad_per_volume(z)

        chunks = config.ray_chunks
        if chunks > 1:
            if R % chunks:
                raise ValueError(f"ray_chunks={chunks} must divide {R} rays")
            r = R // chunks

            def run_chunk(*chunk_rays):
                with tracing.span("gen.chunk"):
                    return self._ray_pipeline(z, *chunk_rays[:4], config,
                                              *chunk_rays[4:], nerf_noise)

            grad = torch.is_grad_enabled()
            replay = False
            pixels, distances = [], []
            for i in range(chunks):
                sl = slice(i * r, (i + 1) * r)
                chunk_rays = [None if t is None else t[:, sl] for t in rays]
                if replay:  # keep only the chunk's inputs for the backward
                    pix, dist = checkpoint(run_chunk, *chunk_rays,
                                           use_reentrant=False)
                    tracing.chunks_replayed += 1
                elif grad and i == 0:  # the rest keep theirs too if they fit
                    before = allocated_bytes(device)
                    pix, dist = run_chunk(*chunk_rays)
                    kept = max(allocated_bytes(device) - before, 0)
                    room = activation_room(device)
                    replay = room is not None and (chunks - 1) * kept > room
                    tracing.chunks_kept += 1
                else:
                    pix, dist = run_chunk(*chunk_rays)
                    if grad:
                        tracing.chunks_kept += 1
                pixels.append(pix)
                distances.append(dist)
            pixels = torch.cat(pixels, dim=1)
            distances = torch.cat(distances, dim=1)
        else:
            pixels, distances = self._ray_pipeline(z, *rays[:4], config,
                                                   *rays[4:], nerf_noise)

        pixels = pixels.reshape(B, H, W, 3) * 2.0 - 1.0
        depth = distance2depth(distances, rays_d_cam).reshape(B, H, W)
        return pixels, depth


@torch.no_grad()
def generate_avg_frequencies(generator_model: ImplicitGenerator3d, n_samples: int = 10000,
                             *, generator: torch.Generator | None = None):
    """The SIREN's mapping-network frequencies and phases averaged over
    n_samples latents N(0, 1) of width z_dim, drawn from `generator` on the
    model's device -> ((1, F), (1, F)): the truncation-trick statistic
    (conditioned_nerf_gan_tpu/models/generator.py:340-364). The siren type
    is looked up in `SIREN_SPECS` by the name the model was built with, as
    in JAX: a name without a spec or a spec without a mapping raises."""
    spec = SIREN_SPECS.get(generator_model.siren_type)
    if spec is None or spec.mapping is None:
        raise ValueError(f"{generator_model.siren_type} has no mapping network")
    device = next(generator_model.parameters()).device
    z = torch.randn((n_samples, generator_model.z_dim), generator=generator, device=device)
    freq, phase = generator_model.siren.mapping_network(z)
    return freq.mean(0, keepdim=True), phase.mean(0, keepdim=True)
