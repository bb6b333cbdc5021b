"""Synthetic ShapeNet-format fixture data (port of
conditioned_nerf_gan_tpu/data/synthetic.py).

Writes a small dataset in the on-disk layout of the reference's Blender
pipeline, the same files from the same seed as the JAX package's writer:

    {root}/{car}/image/{i:04}.png        16-bit RGBA renders
    {root}/{car}/depth/{i:04}.npy        z-depth maps (EXR stand-in)
    {root}/{car}/cameras.npz             world_mat_{i} / world_mat_inv_{i} / camera_mat_{i}
    {root}/{car}/pcl_color.npy           (N, 6) colored surface point cloud
    {root}/{car}/voxel.npz, voxel_32.npz (X, Y, Z, 4) occupancy+RGB grids
    {root_parent}/{mode}.lst             split lists (twenty/thousand/single/val)

Each "car" is a randomized compound of colored boxes. Its views are rendered
with the port's own ray and integration ops and the plain zeros-padded
trilinear lookup (`ops.grid_sample.masked_trilerp`: data preparation, not
the main path),
on `device`; the PNGs are written by the port's encoder (`utils/png.py`).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..ops.grid_sample import masked_trilerp
from ..ops.integration import volume_integrate
from ..ops.rays import create_cam2world_matrix, distance2depth, get_initial_rays, transform_rays
from ..utils.png import write_png

_VOXEL_FILES = {64: "voxel.npz", 32: "voxel_32.npz", 128: "voxel_128.npz"}


def _make_car(rng: np.random.Generator, n_boxes: int = 3):
    """Random compound of colored axis-aligned boxes inside the ±0.35 cube."""
    boxes = []
    for _ in range(n_boxes):
        center = rng.uniform(-0.2, 0.2, 3)
        half = rng.uniform(0.06, 0.18, 3)
        color = rng.uniform(0.1, 1.0, 3)
        boxes.append((center, half, color))
    return boxes


def _voxelize(boxes, resolution: int) -> np.ndarray:
    """Rasterize boxes into an (X, Y, Z, 4) grid in the 1.2³ cube: channel 0
    occupancy, 1:4 rgb (the reference's pcl2voxel layout)."""
    coords = (np.arange(resolution) + 0.5) / resolution * 1.2 - 0.6
    gx, gy, gz = np.meshgrid(coords, coords, coords, indexing="ij")
    vox = np.zeros((resolution, resolution, resolution, 4), dtype=np.float32)
    for center, half, color in boxes:
        inside = (
            (np.abs(gx - center[0]) < half[0])
            & (np.abs(gy - center[1]) < half[1])
            & (np.abs(gz - center[2]) < half[2])
        )
        vox[inside, 0] = 1.0
        vox[inside, 1:4] = color
    return vox


def _surface_pcl(boxes, n_points: int, rng: np.random.Generator) -> np.ndarray:
    """Sample colored points on box surfaces → (N, 6) [xyz, rgb]."""
    pts = []
    per_box = n_points // len(boxes) + 1
    for center, half, color in boxes:
        face = rng.integers(0, 6, per_box)
        u = rng.uniform(-1, 1, (per_box, 3))
        axis = face // 2
        sign = np.where(face % 2 == 0, 1.0, -1.0)
        u[np.arange(per_box), axis] = sign
        xyz = center + u * half
        rgb = np.tile(color, (per_box, 1))
        pts.append(np.concatenate([xyz, rgb], axis=1))
    return np.concatenate(pts)[:n_points].astype(np.float32)


def zeros_trilerp(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """`F.grid_sample(..., align_corners=False, padding_mode="zeros")` on a
    channel-last (B, D, H, W, C) volume at (B, N, 3) coordinates in [-1, 1]
    (x -> W, y -> H, z -> D): corners outside the volume weigh zero. The
    port's one plain zeros lookup, `ops.grid_sample.masked_trilerp`."""
    return masked_trilerp(volume, coords, align_corners=False)


@torch.no_grad()
def _render_views(vox, cam2worlds, img_size, fov, ray_start, ray_end, device,
                  num_steps=64):
    """Render one car's box voxels from each camera: occupancy as a density
    of +-800, rgb from the grid, white background."""
    cams = torch.as_tensor(cam2worlds, device=device)
    B = cams.shape[0]
    vol = torch.as_tensor(np.ascontiguousarray(vox.transpose(2, 1, 0, 3)), device=device)
    vol = vol[None].expand(B, *vol.shape).contiguous()  # (B, z, y, x, 4) NDHWC
    pts, z_vals, dirs = get_initial_rays(B, num_steps, fov, (img_size, img_size),
                                         ray_start, ray_end, device=device)
    wpts, z_vals, _, _ = transform_rays(pts, z_vals, dirs, cams)
    feats = zeros_trilerp(vol, wpts.reshape(B, -1, 3) / 0.6)
    feats = feats.reshape(B, img_size * img_size, num_steps, 4)
    sigma = torch.where(feats[..., 0:1] > 0.5, 800.0, -800.0)
    pix, dist, _ = volume_integrate(torch.cat([feats[..., 1:4], sigma], -1), z_vals,
                                    clamp_mode="relu", white_back=True)
    depth = distance2depth(dist, dirs)
    return (pix.reshape(B, img_size, img_size, 3).cpu().numpy(),
            depth.reshape(B, img_size, img_size).cpu().numpy())


def make_synthetic_shapenet(
    root: str | Path,
    n_cars: int = 8,
    n_views: int = 12,
    img_size: int = 64,
    n_points: int = 2048,
    voxel_resolutions=(64, 32),
    fov: float = 49.134342641202636,
    ray_start: float = 0.25,
    ray_end: float = 1.95,
    cam_r: float = 1.1,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> Path:
    """Write a synthetic dataset, rendering on `device` (pass "cpu" where
    there is no card); returns the dataset root (…/ShapeNetCar)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_synthetic_shapenet: no CUDA GPU is available; pass "
                           "device=\"cpu\"")
    root = Path(root)
    dataset_root = root / "ShapeNetCar"
    dataset_root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    car_ids = [f"car{idx:04d}" for idx in range(n_cars)]
    focal = 1.0 / math.tan(math.radians(fov) / 2.0)
    K = np.array([[focal, 0, 0, 0], [0, focal, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 dtype=np.float32)

    for car_id in car_ids:
        car_dir = dataset_root / car_id
        (car_dir / "image").mkdir(parents=True, exist_ok=True)
        (car_dir / "depth").mkdir(exist_ok=True)

        boxes = _make_car(rng)
        for res in voxel_resolutions:
            np.savez_compressed(car_dir / _VOXEL_FILES[res], voxel=_voxelize(boxes, res))
        np.save(car_dir / "pcl_color.npy", _surface_pcl(boxes, n_points, rng))

        # cameras uniformly on the upper hemisphere at radius cam_r
        theta = np.arccos(1 - rng.uniform(0.05, 0.95, n_views))
        phi = rng.uniform(0, 2 * math.pi, n_views)
        origins = np.stack([cam_r * np.sin(theta) * np.cos(phi), cam_r * np.cos(theta),
                            cam_r * np.sin(theta) * np.sin(phi)], axis=-1).astype(np.float32)
        cam2worlds = create_cam2world_matrix(torch.from_numpy(origins), "y").numpy()
        cam_dict = {}
        for i in range(n_views):
            cam_dict[f"world_mat_inv_{i}"] = cam2worlds[i]
            cam_dict[f"world_mat_{i}"] = np.linalg.inv(cam2worlds[i])
            cam_dict[f"camera_mat_{i}"] = K
        np.savez(car_dir / "cameras.npz", **cam_dict)

        pix, depth = _render_views(_voxelize(boxes, voxel_resolutions[0]), cam2worlds,
                                   img_size, fov, ray_start, ray_end, device)
        for i in range(n_views):
            rgb = np.clip(pix[i], 0, 1)
            rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
            write_png(car_dir / "image" / f"{i:04}.png",
                      (rgba * (2 ** 16 - 1)).astype(np.uint16))
            np.save(car_dir / "depth" / f"{i:04}.npy", depth[i].astype(np.float32))

    # split lists live next to the dataset root (datasets.py:53-57)
    for mode in ("twenty", "thousand", "train"):
        (root / f"{mode}.lst").write_text("\n".join(car_ids) + "\n")
    (root / "single.lst").write_text(car_ids[0] + "\n")
    (root / "val.lst").write_text("\n".join(car_ids) + "\n")
    return dataset_root
