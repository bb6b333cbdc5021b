"""Train-step workload setup (port of
conditioned_nerf_gan_tpu/utils/bench_setup.py::build_stage_bench).

Builds the models, the step config (with the trainer's static density-noise
gate) and a synthetic numpy batch shaped like a curriculum stage's batch,
for `chip_smoke.py` and the tests: the thesis model's point clouds, or for
a voxel preset (`dg`) voxel grids of seeded box clouds, voxelised by the
repo's `voxelize_pcl` rule; with a conditional discriminator (`cond_mode`)
seeded conditioning views at the size the loader gives them (256 for the
projection D, else the image size). The batch's cameras are drawn on the
camera shell from the seed (the JAX bench puts every camera at the origin).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn

from ..config import extract_metadata, load_curriculum
from ..data.shapenet import cond_view_size
from ..infer.inference import build_models, compute_dtype, voxel_to_ndhwc
from ..models.discriminators import make_discriminator
from ..ops.rays import create_cam2world_matrix, sample_camera_positions
from .schedules import fade_alpha, nerf_noise_schedule
from .train_step import TrainStepConfig

PCL_POINTS = 65536  # points per cloud before num_points_ratio (the JAX bench's)
VOXEL_RES = 64  # the voxel family's grids (the U-Net's input side)
VOXEL_PCL_POINTS = 16384  # points of the cloud each grid is voxelised from


def make_pcl(rng: np.random.Generator, n_boxes: int = 3, n_points: int = 2048) -> np.ndarray:
    """One colored point cloud (n_points, 6) [xyz, rgb]: points on the
    faces of a few colored boxes inside the +-0.35 cube, a car-like
    stand-in for a ShapeNet cloud."""
    per_box = -(-n_points // n_boxes)
    parts = []
    for _ in range(n_boxes):
        center, half = rng.uniform(-0.2, 0.2, 3), rng.uniform(0.06, 0.18, 3)
        u = rng.uniform(-1, 1, (per_box, 3))
        face = rng.integers(0, 6, per_box)
        u[np.arange(per_box), face // 2] = np.where(face % 2 == 0, 1.0, -1.0)
        color = np.broadcast_to(rng.uniform(0.1, 1.0, 3), (per_box, 3))
        parts.append(np.concatenate([center + u * half, color], axis=1))
    return np.concatenate(parts)[:n_points].astype(np.float32)


def voxelize(pcl: np.ndarray, resolution: int, length: float = 1.2) -> np.ndarray:
    """(P, 6) colored points -> (R, R, R, 4) [occupancy, r, g, b] in (x, y,
    z) order: the rule of the repo's voxelize_pcl (clip into the cube, floor
    to a cell, mean color per occupied cell)."""
    points = np.clip(pcl[:, :3].astype(np.float64), -length / 2 + 1e-4, length / 2 - 1e-4)
    colors = np.clip(pcl[:, 3:].astype(np.float64), 0.0, 1.0)
    idx = np.clip(np.floor((points + length / 2) / (length / resolution)).astype(np.int64),
                  0, resolution - 1)
    flat = (idx[:, 0] * resolution + idx[:, 1]) * resolution + idx[:, 2]
    color_sum = np.zeros((resolution ** 3, 3))
    count = np.zeros(resolution ** 3)
    np.add.at(color_sum, flat, colors)
    np.add.at(count, flat, 1.0)
    voxel = np.zeros((resolution ** 3, 4))
    occupied = count > 0
    voxel[occupied, 0] = 1.0
    voxel[occupied, 1:] = color_sum[occupied] / count[occupied, None]
    return voxel.reshape(resolution, resolution, resolution, 4)


def make_voxel_grids(rng: np.random.Generator, n: int, resolution: int = VOXEL_RES,
                     n_points: int = VOXEL_PCL_POINTS) -> np.ndarray:
    """n voxel grids of seeded box clouds, (n, R, R, R, 4) fp32 in the
    U-Net's NDHWC layout."""
    return np.stack([voxel_to_ndhwc(voxelize(make_pcl(rng, n_points=n_points), resolution))
                     for _ in range(n)])


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


def build_stage_bench(preset: str = "thousand", stage: int = 2, step: int | None = None,
                      meta_overrides: dict | None = None) -> StageBench:
    """The train-step workload of a curriculum at `step` (default: the
    stage's first step): the thesis model (`thousand`) or an experiment of
    its chain (`dg`, `dg_dis`, ...). Models under the metadata's
    `compute_dtype` policy (fp32 params) with weights drawn from seed 0,
    the stage's TrainStepConfig, fade-in alpha and density-noise std, and a
    batch of `batch_size` random images in [-1, 1], cameras on
    the shell and the conditioning: point clouds of 65,536 x
    num_points_ratio points, or, for a voxel preset, voxel grids of side
    `voxel_resolution` (64). `meta_overrides` replaces metadata keys (a
    smaller run on the CPU)."""
    cur = load_curriculum(config_base="thousand",
                          config=None if preset == "thousand" else preset)
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
    D = (make_discriminator(meta["discriminator"], compute_dtype=compute_dtype(meta),
                            generator=init)
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
    batch = {
        "img": rng.uniform(-1, 1, (B, img, img, 3)).astype(np.float32),
        "cam2world": create_cam2world_matrix(origins, cfg.up_direction).numpy(),
    }
    if cfg.load_pcl:
        n_pts = max(1, int(PCL_POINTS * meta.get("num_points_ratio", 1.0)))
        batch["pcl"] = rng.uniform(-0.4, 0.4, (B, n_pts, 6)).astype(np.float32)
    else:
        batch["voxel"] = make_voxel_grids(rng, B, meta.get("voxel_resolution", VOXEL_RES))
    if cfg.cond_mode:
        side = cond_view_size(meta, img)
        batch["cond"] = rng.uniform(-1, 1, (B, side, side, 3)).astype(np.float32)
    return StageBench(G, E, D, cfg, batch, meta,
                      fade_alpha(step, start, meta["fade_steps"]), nerf_noise)
