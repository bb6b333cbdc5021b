"""The GAN train step: D update, then G/E update (port of
conditioned_nerf_gan_tpu/training/train_step.py:155-458).

  * D step: encoder and generator render without gradients; softplus D loss
    plus the R1 penalty on the real images (a double backward through D);
    global-norm clip; Adam.
  * G step: the encoder's gradients flow through the render; softplus G loss
    (with the discriminator on) + photometric MSE + weighted foreground depth
    MSE + the latent-norm regularizer. With `batch_split` k the per-split means are summed (their
    gradients accumulate), then rescaled by grad_accum_scale / k; one clip +
    Adam step for G and for E.
  * Three optimizer chains, each: clip its own global norm (optax
    `clip_by_global_norm`), coupled weight decay, Adam betas (0, 0.9),
    eps 1e-8; the mapping network is its own parameter group at
    `mapping_lr_mult` x lr.

With `cond_mode` the discriminator is a conditional one (InputCat,
Projection): the D step hands it `batch["cond"]`, the conditioning views,
on the real and the fake images and through R1 (whose gradient is taken
of the real images alone), and the G step each split's `cond`
(train_step.py:229-230, 320-347, 375-377). A discriminator that returns a
tuple (the Encoder and legacy ones) gives its first member, the logits
(`disc_logits`, train_step.py:295-297).

The encoder is the PointNet of a point cloud (`load_pcl`) or the 3-D U-Net
of a voxel grid (the voxel family, `dg`), whose (feature volume, global
feature) pair conditions the render unchanged; its grads come back through
the trilinear sampler, the volume's as the render's one dV buffer (the
generator's `one_volume_grad`). Modules and optimizers update in place. Randomness comes from one explicit
`torch.Generator` on the batch's device (None: deterministic renders, which
needs `random_gen_img` and `noise_weight` off).

Under a torch profiler the step records the spans `train.step` (its root),
`train.d_step`, `train.g_step`, one `train.optim` an optimizer step and
`train.encode` (`utils/tracing.py`); with none running each costs a flag
read.

Data parallelism is the JAX step's `axis_name` (shard_map) path: given a
process `group`, each rank trains on its shard of the batch and, before
each optimizer's `step()`, averages that optimizer's grads over the ranks
in one all-reduce (`parallel.average_gradients`), so each clip sees the
mean grads as optax's chain does after the pmean; d_loss rides in D's
all-reduce and the G/E metrics in G's. The caller folds the rank into the
step's `torch.Generator` (the JAX step's `fold_in(axis_index)`). Not
ported: the chained multi-step dispatch (a TPU dispatch workaround,
ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn as nn

from ..models.generator import RenderConfig
from ..models.pointnet import encode_pcl
from ..ops.rays import create_cam2world_matrix, sample_camera_positions
from ..parallel.mesh import average_gradients
from ..utils import tracing
from .losses import depth_loss as fg_depth_loss
from .losses import gan_d_loss, gan_g_loss, photometric_loss, r1_penalty


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """Per-stage options of the train step (the JAX package's, less `remat`:
    here the generator checkpoints per ray chunk whenever grad is on)."""

    render: RenderConfig
    batch_split: int = 1
    enable_discriminator: bool = True
    photo_loss: bool = True
    use_depth_loss: bool = False
    depth_loss_weight: float = 1.0
    load_voxel: bool = False
    load_pcl: bool = True
    cond_mode: bool = False
    random_gen_img: bool = True
    noise_weight: float = 0.0
    r1_lambda: float = 10.0
    grad_clip: float = 1.0
    z_reg_weight: float = 0.01
    cam_r_start: float = 0.7
    cam_r_end: float = 1.5
    up_direction: str = "y"
    # effective G/E gradient = grad_accum_scale x the full-batch mean
    # (None: batch_split, the reference's summed per-split means)
    grad_accum_scale: float | None = None
    gen_lr: float = 2e-4
    disc_lr: float = 2e-4
    enc_lr: float = 2e-4
    betas: tuple = (0.0, 0.9)
    weight_decay: float = 0.0
    mapping_lr_mult: float = 1.0

    @classmethod
    def from_metadata(cls, metadata: dict, **overrides) -> "TrainStepConfig":
        kwargs = dict(
            render=RenderConfig.from_metadata(metadata),
            batch_split=metadata.get("batch_split", 1),
            enable_discriminator=metadata.get("enable_discriminator", True),
            photo_loss=metadata.get("photo_loss", False),
            use_depth_loss=metadata.get("depth_loss", False),
            depth_loss_weight=metadata.get("depth_loss_weight", 1.0),
            load_voxel=metadata["dataset"].get("load_voxel", False),
            load_pcl=metadata["dataset"].get("load_pcl", False),
            cond_mode=bool(metadata["dataset"].get("cond_mode", False)),
            random_gen_img=metadata.get("random_gen_img", True),
            noise_weight=metadata.get("noise_weight", 0.0),
            r1_lambda=metadata.get("r1_lambda", 10.0),
            grad_clip=metadata.get("grad_clip", 1.0),
            z_reg_weight=metadata.get("z_reg_weight", 0.0),
            cam_r_start=metadata.get("cam_r_start", 0.7),
            cam_r_end=metadata.get("cam_r_end", 1.5),
            grad_accum_scale=metadata.get("grad_accum_scale"),
            gen_lr=metadata["gen_lr"],
            disc_lr=metadata.get("disc_lr", metadata["gen_lr"]),
            enc_lr=metadata.get("enc_lr", metadata["gen_lr"]),
            betas=tuple(metadata.get("betas", (0.0, 0.9))),
            weight_decay=metadata.get("weight_decay", 0.0),
            mapping_lr_mult=metadata.get("mapping_lr_mult", 1.0),
        )
        kwargs.update(overrides)
        return cls(**kwargs)


class ClippedAdam(torch.optim.Adam):
    """clip_by_global_norm -> coupled L2 -> Adam: optax's chain in the JAX
    package. A parameter without a grad takes a zero grad (JAX's grads are
    dense), so every parameter steps every time."""

    def __init__(self, params, *, lr: float, betas=(0.0, 0.9),
                 weight_decay: float = 0.0, grad_clip: float = 1.0):
        super().__init__(params, lr=lr, betas=tuple(float(b) for b in betas),
                         eps=1e-8, weight_decay=weight_decay)
        self.defaults["grad_clip"] = grad_clip  # defaults survive copy and pickle

    @torch.no_grad()
    def step(self, closure=None):
        with tracing.span("train.optim", device_time=True):
            params = [p for group in self.param_groups for p in group["params"]]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            norm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params))
            clip = self.defaults["grad_clip"]
            keep = norm < clip
            for p in params:
                p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * clip))
            return super().step(closure)


def make_optimizer(module: nn.Module, lr: float, betas=(0.0, 0.9),
                   weight_decay: float = 0.0, grad_clip: float = 1.0,
                   lr_mult: float = 1.0) -> ClippedAdam:
    """One optimizer chain over `module`'s parameters; those under a
    `mapping_network` module form a group at lr * lr_mult."""
    scaled, rest = [], []
    for name, p in module.named_parameters():
        (scaled if "mapping_network" in name.split(".") else rest).append(p)
    groups = [{"params": rest}]
    if scaled:
        groups.append({"params": scaled, "lr": lr * lr_mult})
    return ClippedAdam(groups, lr=lr, betas=betas, weight_decay=weight_decay,
                       grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    step: int
    generator: nn.Module
    encoder: nn.Module
    discriminator: nn.Module | None
    opt_G: ClippedAdam
    opt_E: ClippedAdam
    opt_D: ClippedAdam | None


def create_train_state(generator: nn.Module, encoder: nn.Module,
                       discriminator: nn.Module | None,
                       config: TrainStepConfig) -> TrainState:
    """The three optimizer chains around already-initialised modules."""
    opt = dict(betas=config.betas, weight_decay=config.weight_decay,
               grad_clip=config.grad_clip)
    opt_D = None
    if config.enable_discriminator:
        opt_D = make_optimizer(discriminator, config.disc_lr, **opt)
    return TrainState(
        step=0, generator=generator, encoder=encoder, discriminator=discriminator,
        opt_G=make_optimizer(generator, config.gen_lr, lr_mult=config.mapping_lr_mult,
                             **opt),
        opt_E=make_optimizer(encoder, config.enc_lr, **opt),
        opt_D=opt_D)


def make_train_step(config: TrainStepConfig, group=None) -> Callable:
    """Build `train_step(state, batch, generator, alpha, nerf_noise) ->
    (state, metrics)`: one D step (with the discriminator on) then one G/E
    step. With a `torch.distributed` process `group` (`dist.group.WORLD`:
    every rank) `batch` is this rank's shard, and the grads and metrics are
    averaged over the group's ranks before each optimizer steps. `batch`
    holds tensors on the models' device: img (B, S, S, 3) in
    [-1, 1], cam2world (B, 4, 4), the conditioning (pcl (B, T, 6), or with
    `load_voxel` and not `load_pcl` voxel (B, R, R, R, 4) NDHWC) and, with
    the depth loss, depth (B, S, S), and with `cond_mode` the conditioning
    views cond (B, S', S', 3) at the discriminator's size."""
    if not (config.load_pcl or config.load_voxel):
        raise ValueError("the train step needs load_pcl or load_voxel")
    render = config.render

    def disc_logits(D, imgs, alpha, chunk):
        """D's logits on `imgs`, conditioned on the chunk's views in
        `cond_mode`; a tuple output gives its first member."""
        cond = chunk.get("cond") if config.cond_mode else None
        out = D(imgs, alpha, cond=cond)
        return out[0] if isinstance(out, tuple) else out

    def encode(encoder, chunk, generator):
        """Encoder forward -> (z, z_reg): the PointNet's latent and its
        norm, or the U-Net's (volume, global) pair and a zero."""
        with tracing.span("train.encode"):
            if config.load_pcl:
                if config.noise_weight and generator is None:
                    raise ValueError("noise_weight needs a generator")
                return encode_pcl(encoder, chunk["pcl"], noise_weight=config.noise_weight,
                                  generator=generator)
            return encoder(chunk["voxel"]), torch.zeros((), device=chunk["voxel"].device)

    def discriminator_step(state, batch, generator, alpha, nerf_noise):
        real = batch["img"]
        B = real.shape[0]
        if config.random_gen_img:
            if generator is None:
                raise ValueError("random_gen_img needs a generator")
            origins = sample_camera_positions(
                B, generator=generator, up_direction=config.up_direction,
                cam_r_start=config.cam_r_start, cam_r_end=config.cam_r_end,
                device=real.device)
            cams = create_cam2world_matrix(origins, config.up_direction)
        else:
            cams = batch["cam2world"]
        with torch.no_grad():  # generation is gradient-free
            z, _ = encode(state.encoder, batch, generator)
            gen_imgs, _ = state.generator(z, cams, render, generator=generator,
                                          nerf_noise=nerf_noise)

        D = state.discriminator
        real = real.detach().requires_grad_(config.r1_lambda > 0)
        r_logits = disc_logits(D, real, alpha, batch)
        loss = gan_d_loss(r_logits, disc_logits(D, gen_imgs, alpha, batch))
        if config.r1_lambda > 0:
            loss = loss + config.r1_lambda * r1_penalty(r_logits, real)
        state.opt_D.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if group is not None:
            (loss,) = average_gradients(state.opt_D, group, [loss])
        state.opt_D.step()
        return loss

    def generator_step(state, batch, generator, alpha, nerf_noise):
        k = config.batch_split
        B = batch["img"].shape[0]
        if B % k:
            raise ValueError(f"batch_split={k} must divide the "
                             f"{'per-rank ' if group is not None else ''}batch {B}")
        b = B // k
        G, E, D = state.generator, state.encoder, state.discriminator
        state.opt_G.zero_grad(set_to_none=True)
        state.opt_E.zero_grad(set_to_none=True)
        zero = torch.zeros((), device=batch["img"].device)
        names = ("g_loss", "photo_loss", "depth_loss", "z_reg")
        metrics = dict.fromkeys(names, zero)
        if D is not None:
            D.requires_grad_(False)  # D only passes gradients to the images
        try:
            for i in range(k):
                chunk = {key: v[i * b:(i + 1) * b] for key, v in batch.items()}
                z, z_reg = encode(E, chunk, generator)
                gen_imgs, gen_depths = G(z, chunk["cam2world"], render,
                                         generator=generator, nerf_noise=nerf_noise)
                loss_G = (gan_g_loss(disc_logits(D, gen_imgs, alpha, chunk))
                          if config.enable_discriminator else zero)
                photo = (photometric_loss(chunk["img"], gen_imgs)
                         if config.photo_loss else zero)
                dloss = (fg_depth_loss(chunk["depth"], gen_depths)
                         if config.use_depth_loss else zero)
                total = (loss_G + photo + dloss * config.depth_loss_weight
                         + z_reg * config.z_reg_weight)
                total.backward()
                for name, value in zip(names, (loss_G, photo, dloss, z_reg)):
                    metrics[name] = metrics[name] + value.detach()
        finally:
            if D is not None:
                D.requires_grad_(True)
        # the grads hold k x the full-batch mean; rescale to the configured
        # effective gradient
        scale = config.grad_accum_scale if config.grad_accum_scale is not None else k
        if scale != k:
            for p in (*G.parameters(), *E.parameters()):
                if p.grad is not None:
                    p.grad.mul_(scale / k)
        if group is not None:
            metrics = dict(zip(names, average_gradients(state.opt_G, group,
                                                        [metrics[n] for n in names])))
            average_gradients(state.opt_E, group)
        state.opt_G.step()
        state.opt_E.step()
        return {name: m / k for name, m in metrics.items()}

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None,
                   alpha: float, nerf_noise: float):
        """One D-then-G iteration; returns (state, metrics)."""
        with tracing.span("train.step", device_time=True):
            batch = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
            metrics = {}
            if config.enable_discriminator:
                with tracing.span("train.d_step", device_time=True):
                    metrics["d_loss"] = discriminator_step(state, batch, generator, alpha,
                                                           nerf_noise)
            with tracing.span("train.g_step", device_time=True):
                metrics.update(generator_step(state, batch, generator, alpha, nerf_noise))
            state.step += 1
            return state, metrics

    return train_step
