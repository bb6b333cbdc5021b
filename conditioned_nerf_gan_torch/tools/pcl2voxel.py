"""Colored point cloud -> occupancy + RGB voxel grid, with orbit videos and
MRC export (port of conditioned_nerf_gan_tpu/tools/pcl2voxel.py).

  * `voxelize_pcl` (numpy, a copy of the JAX tool's): clip the points into
    the length^3 cube (optional xyz/colour gaussian noise), voxelise at
    `resolution`, channel 0 the occupancy and 1:4 the mean colour of the
    voxel's points; `save_voxel_npz` writes voxel[_32|_128].npz;
  * `voxel_orbit_video`: an orbit of the grid rendered by the first-hit
    renderer (`tools/voxel_render.py`) on `device`, written as the port's
    uncompressed AVI (`utils/video.py`) where the JAX tool writes mp4v
    through cv2;
  * `voxel_to_mrc`: the occupancy as an .mrc.

    python -m conditioned_nerf_gan_torch.tools.pcl2voxel --dataset_path D [--video] [--mrc]
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch


def voxelize_pcl(pcl: np.ndarray, resolution: int, length: float = 1.2,
                 noise_color: float = 0.0, noise_xyz: float = 0.0,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    """(N, 6) colored points -> (R, R, R, 4) grid [occupancy, r, g, b]."""
    rng = rng or np.random.default_rng()
    points = pcl[:, :3].astype(np.float64).copy()
    colors = pcl[:, 3:].astype(np.float64).copy()
    if noise_xyz:
        points += rng.normal(size=points.shape) * noise_xyz
    if noise_color:
        colors += rng.normal(size=colors.shape) * noise_color
    points = np.clip(points, -length / 2 + 1e-4, length / 2 - 1e-4)
    colors = np.clip(colors, 0.0, 1.0)

    idx = np.floor((points + length / 2) / (length / resolution)).astype(np.int64)
    idx = np.clip(idx, 0, resolution - 1)
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


def save_voxel_npz(car_dir: Path, resolution: int, length: float = 1.2,
                   voxel_name: str | None = None, noise_color: float = 0.0,
                   noise_xyz: float = 0.0, rng=None) -> Path:
    pcl = np.load(car_dir / "pcl_color.npy")
    voxel = voxelize_pcl(pcl, resolution, length, noise_color, noise_xyz, rng)
    if voxel_name is None:
        voxel_name = {64: "voxel.npz", 32: "voxel_32.npz", 128: "voxel_128.npz"}.get(
            resolution, f"voxel_{resolution}.npz")
    out = car_dir / voxel_name
    np.savez(out, voxel=voxel, length=length, resolution=resolution,
             noise_color=noise_color, noise_xyz=noise_xyz)
    return out


def orbit_cameras(num_frames: int, cam_r: float = 1.2) -> np.ndarray:
    """(num_frames, 4, 4) cam2world matrices circling the y axis at polar
    angle pi/3, looking at the origin."""
    from ..ops.rays import create_cam2world_matrix

    theta = np.full(num_frames, math.pi / 3)
    phi = np.linspace(0, 2 * math.pi, num_frames, endpoint=False)
    origin = np.stack([cam_r * np.sin(theta) * np.cos(phi), cam_r * np.cos(theta),
                       cam_r * np.sin(theta) * np.sin(phi)], axis=-1).astype(np.float32)
    return create_cam2world_matrix(torch.from_numpy(origin), "y").numpy()


@torch.no_grad()
def voxel_orbit_frames(voxel: np.ndarray, img_size: int = 256, num_frames: int = 96,
                       fov: float = 49.134342641202636, cam_r: float = 1.2,
                       device: str | torch.device = "cuda") -> np.ndarray:
    """The orbit's frames, (num_frames, H, W, 3) rgb in [0, 1], each
    rendered by `voxel_surface_render` on `device`."""
    from .voxel_render import voxel_surface_render

    cams = torch.as_tensor(orbit_cameras(num_frames, cam_r), device=device)
    vol = torch.as_tensor(np.ascontiguousarray(voxel.transpose(2, 1, 0, 3)),
                          dtype=torch.float32, device=device)[None]  # NDHWC
    return np.stack([voxel_surface_render(vol, cams[i:i + 1], img_size, fov)[0].cpu().numpy()
                     for i in range(num_frames)])


def voxel_orbit_video(voxel: np.ndarray, out_path: Path, img_size: int = 256,
                      num_frames: int = 96, fps: int = 24, fov: float = 49.134342641202636,
                      cam_r: float = 1.2, device: str | torch.device = "cuda") -> Path:
    """Orbit the voxel grid and write the frames as an uncompressed AVI."""
    from ..utils.image import to_uint8
    from ..utils.video import write_avi

    frames = voxel_orbit_frames(voxel, img_size, num_frames, fov, cam_r, device)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    return write_avi(out_path, to_uint8(frames)[..., ::-1], fps)


def voxel_to_mrc(voxel: np.ndarray, out_path: Path) -> Path:
    from ..infer.mrc import write_mrc

    write_mrc(out_path, voxel[..., 0].astype(np.float32))
    return out_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Voxelize colored point clouds")
    parser.add_argument("--dataset_path", required=True,
                        help="ShapeNet renders root (contains {car}/pcl_color.npy)")
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--length", type=float, default=1.2)
    parser.add_argument("--noise_color", type=float, default=0.0)
    parser.add_argument("--noise_xyz", type=float, default=0.0)
    parser.add_argument("--video", action="store_true",
                        help="also write an orbit video (.avi) per car")
    parser.add_argument("--mrc", action="store_true")
    parser.add_argument("--cars", nargs="*", default=None,
                        help="subset of car ids (default: all)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the video's renders (cuda or cpu)")
    args = parser.parse_args(argv)
    if (args.video and torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print(f"--device {args.device}: no CUDA GPU is available; pass --device cpu",
              file=sys.stderr)
        return 2

    root = Path(args.dataset_path)
    cars = args.cars or sorted(p.name for p in root.iterdir() if (p / "pcl_color.npy").exists())
    rng = np.random.default_rng(0)
    for car in cars:
        out = save_voxel_npz(root / car, args.resolution, args.length,
                             noise_color=args.noise_color, noise_xyz=args.noise_xyz, rng=rng)
        print("Saved", out)
        if args.video or args.mrc:
            voxel = np.load(out)["voxel"]
            if args.video:
                voxel_orbit_video(voxel, root / car / f"voxel_{args.resolution}.avi",
                                  device=args.device)
            if args.mrc:
                voxel_to_mrc(voxel, root / car / f"voxel_{args.resolution}.mrc")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
