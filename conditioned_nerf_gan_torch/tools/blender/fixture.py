"""The exporter fixture's render, bpy-free (port of the render half of
conditioned_nerf_gan_tpu/tools/blender/fixture.py).

`render_views` is the "Blender stand-in": a car's box scene rendered at the
exporter's cameras with the port's ray and integration ops and the plain
zeros-padded trilinear lookup (`data.synthetic.zeros_trilerp`, plain torch
as the JAX one is plain XLA), on `device`; background depth is inf, as
Blender writes it. `export_car` drives the exporter flow for one car on it
(camera sampling, the Blender pose, cameras.npz, 16-bit RGBA PNGs through
the port's `utils/png.py`, half-float RLE EXR depths, the surface point
cloud). The JAX module's `make_exporter_fixture` finishes the tree with
the numpy tools `write_pcl_color`, `pcl2voxel` and `prepare_data`; those
run on the card's machine as they are (`conditioned_nerf_gan_tpu.tools`
imports no jax), so it is not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .camera_utils import (
    BLENDER_CAM_FLIP,
    blender_cam_pose,
    intrinsics,
    sample_cam,
    sample_points_on_triangles,
)

_BOX_FACES = (
    # 12 triangles over the 8 corners of a unit box (corner bit order xyz)
    (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),  # x faces
    (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),  # y faces
    (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3),  # z faces
)


def _box_mesh(center, half):
    corners = np.array(
        [[center[0] + (1 if b & 4 else -1) * half[0],
          center[1] + (1 if b & 2 else -1) * half[1],
          center[2] + (1 if b & 1 else -1) * half[2]] for b in range(8)],
        dtype=np.float32)
    return corners, np.array(_BOX_FACES, dtype=np.int64)


def _compound_mesh(boxes):
    verts, tris = [], []
    offset = 0
    for center, half, _color in boxes:
        v, t = _box_mesh(center, half)
        verts.append(v)
        tris.append(t + offset)
        offset += len(v)
    return np.concatenate(verts), np.concatenate(tris)


@torch.no_grad()
def render_views(boxes, cam2worlds: np.ndarray, img_size: int, fov: float, ray_start: float,
                 ray_end: float, voxel_resolution: int = 64, num_steps: int = 64,
                 device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """The box scene at each camera -> (pixels (B, S, S, 3) in [0, 1] over
    white, depth (B, S, S) with inf where the coverage is under a half)."""
    from ...data.synthetic import _voxelize, zeros_trilerp
    from ...ops.integration import volume_integrate
    from ...ops.rays import distance2depth, get_initial_rays, transform_rays

    vox = _voxelize(boxes, voxel_resolution)
    cams = torch.as_tensor(np.asarray(cam2worlds, np.float32), device=device)
    B = cams.shape[0]
    vol = torch.as_tensor(np.ascontiguousarray(vox.transpose(2, 1, 0, 3)), device=device)
    vol = vol[None].expand(B, *vol.shape).contiguous()
    pts, z_vals, dirs = get_initial_rays(B, num_steps, fov, (img_size, img_size), ray_start,
                                         ray_end, device=device)
    wpts, z_vals, _, _ = transform_rays(pts, z_vals, dirs, cams)
    feats = zeros_trilerp(vol, wpts.reshape(B, -1, 3) / 0.6)
    feats = feats.reshape(B, img_size * img_size, num_steps, 4)
    sigma = torch.where(feats[..., 0:1] > 0.5, 800.0, -800.0)
    pix, dist, weights = volume_integrate(torch.cat([feats[..., 1:4], sigma], -1), z_vals,
                                          clamp_mode="relu", white_back=True)
    depth = distance2depth(dist, dirs).reshape(B, img_size, img_size).cpu().numpy().copy()
    coverage = weights.sum(-2)[..., 0].reshape(B, img_size, img_size).cpu().numpy()
    depth[coverage < 0.5] = np.inf  # Blender: no hit -> inf
    return pix.reshape(B, img_size, img_size, 3).cpu().numpy(), depth


def export_car(car_dir: Path, boxes, n_views: int, img_size: int, fov: float, cam_r: float,
               ray_start: float, ray_end: float, n_surface_points: int, seed: int,
               device: str | torch.device = "cuda") -> None:
    """One car through the exporter flow (render_shapenet.py:158-205 without
    bpy): cameras.npz, image/{i:04}.png, depth/{i:04}0001.exr and
    pointcloud.npz."""
    from ...data.exr import write_exr_depth
    from ...utils.png import write_png

    (car_dir / "image").mkdir(parents=True, exist_ok=True)
    (car_dir / "depth").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    origins = sample_cam(n_views, cam_r, cam_r, seed)
    K = intrinsics(fov)
    cam_dict, cam2worlds = {}, []
    for i, origin in enumerate(origins):
        # the exporter sets matrix_world = blender_cam_pose(origin), then
        # extracts cam2world = matrix_world @ FLIP
        cam2world = blender_cam_pose(origin) @ BLENDER_CAM_FLIP
        cam_dict[f"camera_mat_{i}"] = K
        cam_dict[f"world_mat_{i}"] = np.linalg.inv(cam2world)
        cam_dict[f"world_mat_inv_{i}"] = cam2world
        cam2worlds.append(cam2world)
    np.savez(car_dir / "cameras.npz", **cam_dict)

    pix, depth = render_views(boxes, np.stack(cam2worlds), img_size, fov, ray_start, ray_end,
                              device=device)
    for i in range(n_views):
        rgba = np.concatenate([np.clip(pix[i], 0, 1), np.ones_like(pix[i][..., :1])], axis=-1)
        write_png(car_dir / "image" / f"{i:04}.png", (rgba * (2 ** 16 - 1)).astype(np.uint16))
        # Blender's depth file-output slot names frames {i:04}0001.exr
        write_exr_depth(car_dir / "depth" / f"{i:04}0001.exr", depth[i])
    verts, tris = _compound_mesh(boxes)
    points = sample_points_on_triangles(verts, tris, n_surface_points, rng)
    np.savez(car_dir / "pointcloud.npz", points=points)
