"""Rotation-vector <-> rotation-matrix conversion (OpenCV's `cv2.Rodrigues`,
in numpy: the port does not use cv2) and the inference cameras' Rodrigues
perturbation.

`rodrigues` follows OpenCV's cvRodrigues2 branch for branch: a matrix is
first made orthogonal by its SVD (U V^T); near theta = 0 the vector is 0; near
theta = pi (sin theta under 1e-5) the axis comes from the diagonal, its
signs from the off-diagonal terms.
"""

from __future__ import annotations

import numpy as np


def _matrix_to_vector(R: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = np.clip((np.trace(R) - 1) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros((3, 1))
        r = np.array([
            np.sqrt(max((R[0, 0] + 1) * 0.5, 0.0)),
            np.sqrt(max((R[1, 1] + 1) * 0.5, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0),
            np.sqrt(max((R[2, 2] + 1) * 0.5, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0),
        ])
        if (abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2])
                and (R[1, 2] > 0) != (r[1] * r[2] > 0)):
            r[2] = -r[2]
        return (r * (theta / np.linalg.norm(r)))[:, None]
    return (r * (theta / (2 * s)))[:, None]


def _vector_to_matrix(rvec: np.ndarray) -> np.ndarray:
    r = rvec.reshape(3)
    theta = np.linalg.norm(r)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    r = r / theta
    r_x = np.array([[0.0, -r[2], r[1]], [r[2], 0.0, -r[0]], [-r[1], r[0], 0.0]])
    return c * np.eye(3) + (1 - c) * np.outer(r, r) + s * r_x


def rodrigues(x: np.ndarray) -> np.ndarray:
    """A 3x3 rotation matrix -> its (3, 1) rotation vector, or a rotation
    vector ((3,), (3, 1) or (1, 3)) -> its 3x3 matrix; float64, as
    `cv2.Rodrigues(x)[0]` returns them."""
    x = np.asarray(x, np.float64)
    if x.shape == (3, 3):
        return _matrix_to_vector(x)
    if x.size == 3:
        return _vector_to_matrix(x)
    raise ValueError(f"rodrigues takes a 3x3 matrix or a 3-vector, not {x.shape}")


def clip_norm(x: np.ndarray, lower: float = 0.7, upper: float = 1.5) -> np.ndarray:
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / norm * np.clip(norm, lower, upper)


def perturb_extrinsics(cams: np.ndarray, noise_weight: float,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Rodrigues-perturb camera rotations and origins, re-aimed at the world
    origin (reference inference.py:65-87). Draws from `rng` in the JAX
    package's order: the rotation vector's (3, 1) noise, then the origin's
    (3,), a camera at a time."""
    rng = rng or np.random.default_rng()
    out = []
    for P in cams:
        R = P[:3, :3].astype(np.float64)
        t = P[:3, -1].astype(np.float64)
        rvec = rodrigues(R)
        new_R = rodrigues(rvec + rng.normal(size=rvec.shape) * noise_weight)
        new_t = clip_norm(t + rng.normal(size=t.shape) * noise_weight)
        new_t = -new_R[:, -1] * np.linalg.norm(new_t)
        newP = np.eye(4)
        newP[:3, :3] = new_R
        newP[:3, -1] = new_t
        out.append(newP)
    return np.stack(out).astype(np.float32)
