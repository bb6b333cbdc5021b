"""Geometry diagnostics (port of conditioned_nerf_gan_tpu/tools/geometry.py):
the chamfer distance, the camera-convention check, KD-tree negative
samples and PointNet's critical points.

  * `chamfer_distance`: brute-force pairwise squared distances on the
    device, a chunk of the first set against the whole second set at a
    time (the reference's misc/chamfer.py CUDA extension, exact);
  * `backproject_depth` / `check_camera_convention`: a GT depth map
    backprojected with its camera against the GT point cloud (numpy and
    the port's EXR reader);
  * `kdtree_negative_samples`: cube samples away from the surface (scipy);
  * `pointnet_critical_points`: the input points that attain the PointNet's
    final max-pool, from its pre-pool features in fp32.

    python -m conditioned_nerf_gan_torch.tools.geometry chamfer a.npy b.npy
    python -m conditioned_nerf_gan_torch.tools.geometry checkpos <car dir>

Both run on `cuda` unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


@torch.no_grad()
def chamfer_distance(a: np.ndarray, b: np.ndarray, chunk: int = 4096,
                     device: str | torch.device = "cuda") -> float:
    """Symmetric chamfer distance between (N, 3) and (M, 3) point sets:
    the mean over each set of the squared distance to the other set's
    nearest point, summed over both directions, in fp32 on `device`."""
    a = torch.as_tensor(np.asarray(a, np.float32), device=device)
    b = torch.as_tensor(np.asarray(b, np.float32), device=device)

    def side(x, y):
        mins = []
        for start in range(0, x.shape[0], chunk):
            xc = x[start:start + chunk]
            d = ((xc[:, None, 0] - y[None, :, 0]) ** 2 + (xc[:, None, 1] - y[None, :, 1]) ** 2
                 + (xc[:, None, 2] - y[None, :, 2]) ** 2)
            mins.append(d.amin(dim=1))
        return torch.cat(mins).sum() / x.shape[0]

    return float(side(a, b) + side(b, a))


def backproject_depth(depth: np.ndarray, cam2world: np.ndarray, fov: float) -> np.ndarray:
    """A GT depth map and its camera -> the world points of its pixels with
    a depth (the reference's checkpos reprojection)."""
    img_size = depth.shape[0]
    focal = 1.0 / math.tan(math.radians(fov) / 2.0)
    ys, xs = np.nonzero(depth > 0)
    d = depth[ys, xs]
    x_cam = (2 * xs - (img_size - 1)) / (img_size - 1) / focal * d
    y_cam = (2 * ys - (img_size - 1)) / (img_size - 1) / focal * d
    pts = np.stack([x_cam, y_cam, d, np.ones_like(d)], axis=1)
    return (pts @ cam2world.T)[:, :3]


def check_camera_convention(car_dir: str | Path, view: int = 0,
                            fov: float = 49.134342641202636, img_size: int | None = None,
                            device: str | torch.device = "cuda") -> float:
    """Chamfer distance between view `view`'s backprojected GT depth (its
    .npy, else its EXR) and the car's GT point cloud; about a voxel's size
    when the camera convention holds end to end."""
    from ..data.exr import read_exr_depth

    car_dir = Path(car_dir)
    cam = np.load(car_dir / "cameras.npz")[f"world_mat_inv_{view}"]
    depth_npy = car_dir / "depth" / f"{view:04}.npy"
    if depth_npy.exists():
        depth = np.load(depth_npy)
    else:
        depth = read_exr_depth(car_dir / "depth" / f"{view:04}0001.exr", img_size)
    pts = backproject_depth(depth, cam, fov)
    pcl = np.load(car_dir / "pcl_color.npy")[:, :3]
    return chamfer_distance(pts, pcl, device=device)


def kdtree_negative_samples(pcl: np.ndarray, n_samples: int, radius: float = 0.05,
                            seed: int = 0) -> np.ndarray:
    """Uniform samples of the +-0.6 cube farther than `radius` from the
    cloud (the reference's misc/kdt.py negative sampling)."""
    from scipy.spatial import KDTree

    rng = np.random.default_rng(seed)
    tree = KDTree(pcl[:, :3])
    out = []
    while sum(len(o) for o in out) < n_samples:
        cand = rng.uniform(-0.6, 0.6, (n_samples * 2, 3))
        dist, _ = tree.query(cand)
        out.append(cand[dist > radius])
    return np.concatenate(out)[:n_samples]


@torch.no_grad()
def pointnet_critical_points(encoder, pcl: np.ndarray) -> np.ndarray:
    """Indices of the points of `pcl` (T, 6) that attain the final max-pool
    of `encoder` (a `ResnetPointnet`): each channel's argmax over its
    pre-pool features, computed in fp32 from the encoder's weights as the
    JAX tool mirrors its module (the reference's extract_critical_pts.py)."""
    param = next(encoder.parameters())
    p = torch.as_tensor(np.asarray(pcl, np.float32), device=param.device)[None]

    def dense(layer, x):
        return F.linear(x, layer.weight.float(),
                        None if layer.bias is None else layer.bias.float())

    def block(blk, x):
        h = dense(blk.fc_0, F.relu(x))
        dx = dense(blk.fc_1, F.relu(h))
        if blk.shortcut is not None:
            x = dense(blk.shortcut, x)
        return x + dx

    net = block(encoder.blocks[0], dense(encoder.fc_pos, p))
    for blk in encoder.blocks[1:]:
        pooled = net.amax(dim=1, keepdim=True)
        net = block(blk, torch.cat([net, pooled.expand_as(net)], dim=2))
    return np.unique(net[0].argmax(dim=0).cpu().numpy())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Geometry diagnostics")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the chamfer distance (cuda or cpu)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("chamfer", help="chamfer distance between two point files")
    c.add_argument("a")
    c.add_argument("b")
    k = sub.add_parser("checkpos", help="camera-convention check for a car dir")
    k.add_argument("car_dir")
    k.add_argument("--view", type=int, default=0)
    k.add_argument("--fov", type=float, default=49.134342641202636)
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA GPU is available; pass --device cpu",
              file=sys.stderr)
        return 2
    if args.cmd == "chamfer":
        a = np.load(args.a)[:, :3]
        b = np.load(args.b)[:, :3]
        print("chamfer:", chamfer_distance(a, b, device=args.device))
    else:
        d = check_camera_convention(args.car_dir, args.view, args.fov, device=args.device)
        print(f"backprojection chamfer vs GT pcl: {d:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
