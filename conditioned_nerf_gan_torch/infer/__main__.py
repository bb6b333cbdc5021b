"""Inference CLI of the port: `python -m conditioned_nerf_gan_torch.infer`.

Takes a port checkpoint `{run}/checkpoints/{step}.pt` (see
`conditioned_nerf_gan_torch.bridge.convert_checkpoint` for JAX checkpoints)
and keeps the flag names and the order of the JAX CLI (inference.py):
image grids, the orbit video (an uncompressed .avi where the JAX CLI writes
.mp4), colored point clouds, the density voxel, metrics and latent
interpolation. `--shard_rays` splits each render's pixel rows over the
visible cards when there is more than one and `--image_size` divides by
their count (else it renders as without); `--platform` (a JAX backend; the
port takes `--device`) exits 2 naming why.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

# flag -> why it is refused
_NOT_PORTED = {
    "platform": "--platform picks a JAX backend; the port takes --device",
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Inference conditioned NeRF-GAN (PyTorch port)")
    parser.add_argument("path", type=str, help="path to the port checkpoint .pt")
    parser.add_argument("--sampling_mode", type=str, default="val",
                        help="which ShapeNet split list to sample from")
    parser.add_argument("--image_size", type=int, default=128)
    parser.add_argument("--ray_step_multiplier", type=int, default=1)
    parser.add_argument("--z_up", action="store_true")
    parser.add_argument("--colored_pcl", action="store_true",
                        help="kept for reference CLI parity; inert")
    parser.add_argument("--images", action="store_true")
    parser.add_argument("--num_imgs", type=int, default=8)
    parser.add_argument("--cam_fixed", action="store_true")
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--num_frames", type=int, default=240)
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--pcl", action="store_true")
    parser.add_argument("--pcl_masked", action="store_true")
    parser.add_argument("--pcl_views", type=int, default=20)
    parser.add_argument("--voxel", action="store_true")
    parser.add_argument("--cube_size", type=float, default=1.2)
    parser.add_argument("--voxel_resolution", type=int, default=48)
    parser.add_argument("--input_voxel_resolution", type=int, default=64)
    parser.add_argument("--metrics", action="store_true")
    parser.add_argument("--shard_rays", action="store_true")
    parser.add_argument("--interpolate", action="store_true")
    parser.add_argument("--interpolate_src", type=str, default=None)
    parser.add_argument("--interpolate_tgt", type=str, default=None)
    parser.add_argument("--seeds", nargs="+", default=[0])
    parser.add_argument("--platform", type=str, default=None)
    parser.add_argument("--native_loader", action="store_true",
                        help="decode dataset PNGs/EXRs through the C++ "
                             "thread-pool loader (env: CNG_NATIVE_LOADER=1)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (cuda, cuda:1, ..., or cpu "
                             "for the fp32 plain path without the kernel)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    opt = parse_args(argv)
    print(opt)
    refused = [f"--{flag}: {why}" for flag, why in _NOT_PORTED.items()
               if getattr(opt, flag)]
    if refused:
        print("not ported yet:\n  " + "\n  ".join(refused), file=sys.stderr)
        return 2
    if opt.interpolate and not (opt.interpolate_src and opt.interpolate_tgt):
        print("--interpolate requires --interpolate_src and --interpolate_tgt", file=sys.stderr)
        return 2
    if opt.native_loader:
        os.environ["CNG_NATIVE_LOADER"] = "1"

    import torch

    from .inference import Inferencer

    if torch.device(opt.device).type == "cuda" and not torch.cuda.is_available():
        print(f"--device {opt.device}: no CUDA GPU is available; pass --device cpu "
              "to render with the fp32 plain path instead", file=sys.stderr)
        return 2

    for seed in opt.seeds:
        seed = int(seed)
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
        inferencer = Inferencer(
            opt.path, sampling_mode=opt.sampling_mode,
            input_voxel_resolution=opt.input_voxel_resolution, z_up=opt.z_up,
            num_imgs=opt.num_imgs, image_size=opt.image_size,
            ray_step_multiplier=opt.ray_step_multiplier, load_dataset=not opt.interpolate,
            seed=seed, device=opt.device, shard_rays=opt.shard_rays,
        )
        if opt.images:
            inferencer.render_imgs(opt.cam_fixed)
        if opt.video:
            for idx in range(min(opt.num_imgs, 1)):
                inferencer.render_video(idx, opt.num_frames, opt.fps)
        if opt.pcl:
            inferencer.render_pcl(0, opt.pcl_views)
        if opt.pcl_masked:
            inferencer.render_pcl_masked(0, opt.pcl_views)
        if opt.voxel:
            inferencer.save_voxel(0, opt.cube_size, opt.voxel_resolution)
        if opt.metrics:
            inferencer.compute_metrics()
        if opt.interpolate:
            inferencer.interpolate_latent_codes(opt.interpolate_src, opt.interpolate_tgt,
                                                inferencer.run_dir / "inference")
    return 0


if __name__ == "__main__":
    sys.exit(main())
