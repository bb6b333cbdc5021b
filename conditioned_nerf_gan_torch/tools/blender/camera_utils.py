"""Camera math of the offline Blender data pipeline, bpy-free (a copy of
conditioned_nerf_gan_tpu/tools/blender/camera_utils.py, which imports only
numpy, less its matplotlib plot): spherical camera sampling, the y-up
look-at pose and its Blender form, area-weighted surface samples and the
normalised intrinsics and projection (the reference's
blender_renderer/utils.py and project.py)."""

from __future__ import annotations

import math

import numpy as np


def sample_cam(n: int, r_min: float = 1.1, r_max: float = 1.1,
               seed: int | None = None) -> np.ndarray:
    """n camera origins uniform over the upper hemisphere shell (y-up)."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(1 - rng.uniform(0, 1, n))
    theta = np.clip(theta, 1e-5, math.pi - 1e-5)
    phi = rng.uniform(0, 2 * math.pi, n)
    r = rng.uniform(r_min, r_max, n)
    return np.stack(
        [r * np.sin(theta) * np.cos(phi),
         r * np.cos(theta),
         r * np.sin(theta) * np.sin(phi)], axis=-1,
    )


def look_at_world_origin(origin: np.ndarray) -> np.ndarray:
    """cam2world matrix looking at the world origin, y-up (matches
    ops.rays.create_cam2world_matrix so rendered data and the NeRF renderer
    share one convention)."""
    forward = -origin / np.linalg.norm(origin)
    up = np.array([0.0, 1.0, 0.0])
    left = np.cross(up, forward)
    left /= np.linalg.norm(left)
    true_up = np.cross(forward, left)
    true_up /= np.linalg.norm(true_up)
    mat = np.eye(4)
    mat[:3, :3] = np.stack([-left, -true_up, forward], axis=-1)
    mat[:3, 3] = origin
    return mat


# Blender cameras look down local -Z with +Y up; the dataset convention is
# cv-style (+Z forward, +Y down). flip² = I, so it converts either way.
BLENDER_CAM_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def blender_cam_pose(origin: np.ndarray) -> np.ndarray:
    """Blender `matrix_world` for a camera at `origin` looking at the world
    origin with the dataset's y-up roll convention.

    Deliberately NOT `to_track_quat("-Z", "Y")`: mathutils orients the up axis
    toward world **+Z** (reference blender_renderer/render_blender.py:259-260
    renders a z-up world, where that is correct), but this pipeline produces
    y-up data matching `ops.rays.create_cam2world_matrix` — the convention the
    trainer's random cameras use (reference utils.py:765) — so the pose is
    built from the same look-at and converted to Blender's camera axes.
    """
    return look_at_world_origin(origin) @ BLENDER_CAM_FLIP


def sample_points_on_triangles(verts: np.ndarray, tris: np.ndarray,
                               n_points: int, rng) -> np.ndarray:
    """Area-weighted uniform surface samples from a triangle soup
    (reference blender_renderer/render_blender.py pointcloud.npz production).

    verts: (V, 3) float vertices; tris: (T, 3) int vertex indices.
    """
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    choice = rng.choice(len(tris), n_points, p=probs)
    u, v = rng.uniform(size=(2, n_points))
    flip_mask = u + v > 1
    u[flip_mask], v[flip_mask] = 1 - u[flip_mask], 1 - v[flip_mask]
    pts = v0[choice] + u[:, None] * (v1[choice] - v0[choice]) + \
        v[:, None] * (v2[choice] - v0[choice])
    return pts.astype(np.float32)


def intrinsics(fov_deg: float) -> np.ndarray:
    """Normalized 4×4 K with focal = 1/tan(fov/2) (cameras.npz camera_mat_i)."""
    focal = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = focal
    return K


def projection_matrix(K: np.ndarray, cam2world: np.ndarray) -> np.ndarray:
    """3×4 P = K [R|t] from normalized intrinsics + cam2world
    (reference blender_renderer/utils.py `get_3x4_P_matrix_from_blender`)."""
    world2cam = np.linalg.inv(cam2world)
    return (K @ world2cam)[:3]


def project_points(points: np.ndarray, K: np.ndarray,
                   cam2world: np.ndarray) -> np.ndarray:
    """World points → normalized image coords (u, v, depth)
    (reference blender_renderer/project.py depth-backprojection check)."""
    P = projection_matrix(K, cam2world)
    homo = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    uvz = homo @ P.T
    uv = uvz[:, :2] / uvz[:, 2:3]
    return np.concatenate([uv, uvz[:, 2:3]], axis=1)
