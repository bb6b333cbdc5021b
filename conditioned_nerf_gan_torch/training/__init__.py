"""Training (port of conditioned_nerf_gan_tpu/training): losses, schedules,
the GAN train step, the stage workload setup, checkpoints and the Trainer
(its CLI is `python -m conditioned_nerf_gan_torch.train`)."""

from .bench_setup import StageBench, build_stage_bench
from .checkpoints import find_newest_checkpoint, restore_checkpoint, save_checkpoint
from .losses import (
    depth_loss,
    gan_d_loss,
    gan_g_loss,
    geometry_loss,
    photometric_loss,
    r1_penalty,
    z_sampler,
)
from .schedules import fade_alpha, nerf_noise_schedule
from .train_step import (
    ClippedAdam,
    TrainState,
    TrainStepConfig,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from .trainer import Trainer

__all__ = [
    "ClippedAdam",
    "StageBench",
    "TrainState",
    "TrainStepConfig",
    "Trainer",
    "build_stage_bench",
    "create_train_state",
    "depth_loss",
    "fade_alpha",
    "find_newest_checkpoint",
    "gan_d_loss",
    "gan_g_loss",
    "geometry_loss",
    "make_optimizer",
    "make_train_step",
    "nerf_noise_schedule",
    "photometric_loss",
    "r1_penalty",
    "restore_checkpoint",
    "save_checkpoint",
    "z_sampler",
]
