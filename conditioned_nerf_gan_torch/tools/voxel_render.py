"""Nearest-neighbour voxel raycast renderer, the input-geometry baseline
(port of conditioned_nerf_gan_tpu/tools/voxel_render.py).

Rays are sampled as the NeRF renderer samples them, the voxels are looked
up with *nearest* interpolation (border clamp), and each pixel takes the
colour of the first sample whose occupancy is nonzero, white where none is
(the reference's feature_volume/voxel2img.py:24-101). Plain torch, on the
device of its inputs: the first hit is one argmax over the sample axis.

    python -m conditioned_nerf_gan_torch.tools.voxel_render --dataset_path D --out_dir O

writes one PNG a view (the port's `utils/png.py`), on `cuda` unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.rays import get_initial_rays, transform_rays

VOXEL_LENGTH = 1.2


def nearest_point_features(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid_sample(mode="nearest", padding_mode="border") on a channel-last
    volume (B, D, H, W, C) at coords (B, N, 3) in [-1, 1], (x, y, z) ->
    (W, H, D); halves round to even, as jnp.round does."""
    B, D, H, W, C = volume.shape

    def index(c, size):
        return torch.round((((c + 1.0) * size - 1.0) / 2.0).clamp(0, size - 1)).long()

    flat = (index(coords[..., 2], D) * H + index(coords[..., 1], H)) * W + index(
        coords[..., 0], W)
    return torch.gather(volume.reshape(B, D * H * W, C), 1,
                        flat[..., None].expand(*flat.shape, C))


@torch.no_grad()
def voxel_surface_render(voxels: torch.Tensor, cam2worlds: torch.Tensor, img_size: int,
                         fov: float, ray_start: float = 0.2, ray_end: float = 2.0,
                         num_steps: int = 256) -> torch.Tensor:
    """(B, H, W, 3) first-hit voxel colours over a white background.
    voxels (B, R, R, R, 4) NDHWC: channel 0 occupancy, 1:4 rgb (the
    voxel.npz layout)."""
    B = cam2worlds.shape[0]
    pts, z_vals, dirs = get_initial_rays(B, num_steps, fov, (img_size, img_size), ray_start,
                                         ray_end, device=voxels.device)
    wpts, _, _, _ = transform_rays(pts, z_vals, dirs, cam2worlds)
    coords = wpts.reshape(B, -1, 3) / (VOXEL_LENGTH / 2.0)
    feats = nearest_point_features(voxels, coords).reshape(B, img_size * img_size,
                                                           num_steps, 4)
    occupied = feats[..., 0] != 0
    first_hit = occupied.to(torch.uint8).argmax(dim=-1)  # the first True along the ray
    hit_rgb = torch.gather(feats[..., 1:4], 2,
                           first_hit[..., None, None].expand(B, img_size * img_size, 1, 3))
    rgb = torch.where(occupied.any(dim=-1)[..., None], hit_rgb[:, :, 0], 1.0)
    return rgb.reshape(B, img_size, img_size, 3)


def main(argv=None) -> int:
    from ..data import DataLoader, ShapeNetDataset
    from ..utils.image import to_uint8
    from ..utils.png import write_png

    parser = argparse.ArgumentParser(description="Voxel baseline renderer")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--subset", default="val")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--img_size", type=int, default=128)
    parser.add_argument("--voxel_resolution", type=int, default=32)
    parser.add_argument("--fov", type=float, default=49.134342641202636)
    parser.add_argument("--ray_start", type=float, default=0.2)
    parser.add_argument("--ray_end", type=float, default=2.0)
    parser.add_argument("--num_steps", type=int, default=256)
    parser.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA GPU is available; pass --device cpu",
              file=sys.stderr)
        return 2

    meta = {"num_points_ratio": 1.0, "dataset": {}}
    dataset = ShapeNetDataset(args.dataset_path, args.img_size, args.subset, meta,
                              load_voxel=True, load_pcl=False, dataset_mode="test",
                              load_img=False, load_depth=False, load_cam=True, shuffle=False,
                              voxel_resolution=args.voxel_resolution)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for batch in DataLoader(dataset, 1, shuffle=False, drop_last=False):
        rgb = voxel_surface_render(
            torch.as_tensor(batch["voxel"], device=args.device),
            torch.as_tensor(batch["cam2world"], device=args.device), args.img_size,
            args.fov, args.ray_start, args.ray_end, args.num_steps).cpu().numpy()
        for idx, img in enumerate(rgb):
            p = Path(batch["img_path"][idx])
            write_png(out_dir / f"{p.parent.parent.stem}_{p.name}", to_uint8(img))
    print("Wrote voxel baseline renders to", out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
