"""Train-step workload setup (port of
conditioned_nerf_gan_tpu/utils/bench_setup.py::build_stage_bench).

Builds the models, the step config (with the trainer's static density-noise
gate) and a synthetic numpy batch shaped like a curriculum stage's batch,
for `chip_smoke.py` and the tests. The batch's cameras are drawn on the
camera shell from the seed (the JAX bench puts every camera at the origin).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from conditioned_nerf_gan_tpu.config import extract_metadata, load_curriculum

from ..infer.inference import build_models
from ..models.discriminators import make_discriminator
from ..ops.rays import create_cam2world_matrix, sample_camera_positions
from .schedules import fade_alpha, nerf_noise_schedule
from .train_step import TrainStepConfig

PCL_POINTS = 65536  # points per cloud before num_points_ratio (the JAX bench's)


@dataclasses.dataclass
class StageBench:
    generator: nn.Module
    encoder: nn.Module
    discriminator: nn.Module | None
    config: TrainStepConfig
    batch: dict[str, np.ndarray]
    meta: dict
    alpha: float
    nerf_noise: float


def build_stage_bench(stage: int = 2, step: int | None = None,
                      meta_overrides: dict | None = None) -> StageBench:
    """The train-step workload of the thesis curriculum (`thousand`) at
    `step` (default: the stage's first step): fp32 models with weights drawn
    from seed 0, the stage's TrainStepConfig, fade-in alpha and density-noise
    std, and a batch of `batch_size` random images in [-1, 1], cameras on
    the shell and point clouds of 65,536 x num_points_ratio points.
    `meta_overrides` replaces metadata keys (a smaller run on the CPU)."""
    cur = load_curriculum(config_base="thousand")
    starts = sorted(k for k in cur if isinstance(k, int))
    start = starts[stage]
    step = start if step is None else step
    if step < start or (stage + 1 < len(starts) and step >= starts[stage + 1]):
        raise ValueError(f"step {step} is outside stage {stage}")
    meta = extract_metadata(cur, step)
    if meta_overrides:
        meta.update(meta_overrides)
    nerf_noise = nerf_noise_schedule(step)

    init = torch.Generator().manual_seed(0)
    G, E = build_models(meta, generator=init)
    D = (make_discriminator(meta["discriminator"], generator=init)
         if meta["enable_discriminator"] else None)
    cfg = TrainStepConfig.from_metadata(meta)
    # the trainer's static gate: no density noise once the schedule is 0
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, density_noise=nerf_noise > 0.0))

    B, img = meta["batch_size"], meta["img_size"]
    rng = np.random.default_rng(0)
    origins = sample_camera_positions(
        B, cam_r_start=cfg.cam_r_start, cam_r_end=cfg.cam_r_end,
        up_direction=cfg.up_direction,
        uniforms=torch.from_numpy(rng.uniform(0, 1, (B, 3)).astype(np.float32)))
    n_pts = max(1, int(PCL_POINTS * meta.get("num_points_ratio", 1.0)))
    batch = {
        "img": rng.uniform(-1, 1, (B, img, img, 3)).astype(np.float32),
        "cam2world": create_cam2world_matrix(origins, cfg.up_direction).numpy(),
        "pcl": rng.uniform(-0.4, 0.4, (B, n_pts, 6)).astype(np.float32),
    }
    return StageBench(G, E, D, cfg, batch, meta,
                      fade_alpha(step, start, meta["fade_steps"]), nerf_noise)
