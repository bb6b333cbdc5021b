"""Geometry-loss replay (port of conditioned_nerf_gan_tpu/tools/geoloss.py):
the legacy geometry loss of a checkpoint's SIREN sigma at points on the GT
surface and at KD-tree filtered points away from it (the reference's
misc/geoloss_plot.py; `training.losses.geometry_loss`). The sigma comes
from `ImplicitGenerator3d.eval_points`, so on the card through the
FiLM-SIREN kernel.

    python -m conditioned_nerf_gan_torch.tools.geoloss <run>/checkpoints/<step>.pt

Runs on `cuda` unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..training.losses import geometry_loss
from .geometry import kdtree_negative_samples


@torch.no_grad()
def replay_geometry_loss(checkpoint: str | Path, car_index: int = 0, n_points: int = 1024,
                         radius: float = 0.05, device: str | torch.device = "cuda") -> float:
    """The geometry loss of the checkpoint's sigma at `n_points` points of
    val car `car_index`'s cloud and as many negatives."""
    from ..infer import Inferencer

    inferencer = Inferencer(checkpoint, load_dataset=True, device=device)
    sample = inferencer.valset[car_index]
    pcl = np.load(Path(sample["img_path"]).parent.parent / "pcl_color.npy")
    rng = np.random.default_rng(0)
    pos = pcl[rng.permutation(len(pcl))[:n_points], :3]
    neg = kdtree_negative_samples(pcl, n_points, radius=radius)
    z = inferencer.encode(inferencer._cond_batch(sample))
    pts = torch.as_tensor(np.concatenate([pos, neg]).astype(np.float32),
                          device=inferencer.device)[None]
    sigma = inferencer.generator.eval_points(pts, z)[..., -1]
    return float(geometry_loss(sigma.float(), n_points))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Replay the geometry loss")
    parser.add_argument("checkpoint")
    parser.add_argument("--car_index", type=int, default=0)
    parser.add_argument("--n_points", type=int, default=1024)
    parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA GPU is available; pass --device cpu",
              file=sys.stderr)
        return 2
    loss = replay_geometry_loss(args.checkpoint, args.car_index, args.n_points,
                                device=args.device)
    print(f"geometry loss: {loss:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
