"""Step schedules (port of conditioned_nerf_gan_tpu/training/schedules.py):
plain Python floats of the step counter."""

from __future__ import annotations


def fade_alpha(step: int, step_last_upsample: int, fade_steps: int) -> float:
    """ProGAN fade-in alpha in [0, 1]."""
    return min(1.0, (step - step_last_upsample) / fade_steps)


def nerf_noise_schedule(step: int) -> float:
    """Density-noise stddev: max(0, 1 - step/5000)."""
    return max(0.0, 1.0 - step / 5000.0)
