"""Training (port of conditioned_nerf_gan_tpu/training): losses, schedules,
the GAN train step and the stage workload setup. The Trainer and its CLI are
ROADMAP A8."""

from .bench_setup import StageBench, build_stage_bench
from .losses import depth_loss, gan_d_loss, gan_g_loss, photometric_loss, r1_penalty
from .schedules import fade_alpha, nerf_noise_schedule
from .train_step import (
    ClippedAdam,
    TrainState,
    TrainStepConfig,
    create_train_state,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "ClippedAdam",
    "StageBench",
    "TrainState",
    "TrainStepConfig",
    "build_stage_bench",
    "create_train_state",
    "depth_loss",
    "fade_alpha",
    "gan_d_loss",
    "gan_g_loss",
    "make_optimizer",
    "make_train_step",
    "nerf_noise_schedule",
    "photometric_loss",
    "r1_penalty",
]
