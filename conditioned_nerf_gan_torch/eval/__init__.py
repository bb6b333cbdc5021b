"""Evaluation (port of conditioned_nerf_gan_tpu/eval): FID, oFID, LPIPS and
PSNR, their feature nets and weights, and the in-training eval loop."""

from .fid_evaluation import evaluate_trainer, output_images, setup_evaluation
from .inception import InceptionV3Features
from .lpips import LPIPS
from .metrics import (
    compute_fid_from_dirs,
    compute_metrics_from_dirs,
    compute_psnr,
    frechet_distance,
    newton_schulz_sqrt_trace,
)

__all__ = [
    "frechet_distance",
    "newton_schulz_sqrt_trace",
    "compute_psnr",
    "compute_fid_from_dirs",
    "compute_metrics_from_dirs",
    "InceptionV3Features",
    "LPIPS",
    "setup_evaluation",
    "output_images",
    "evaluate_trainer",
]
