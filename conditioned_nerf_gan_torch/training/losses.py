"""Loss functions (port of conditioned_nerf_gan_tpu/training/losses.py).

Non-saturating softplus GAN losses, the R1 penalty, photometric MSE and the
foreground-masked depth MSE. `geometry_loss` and `z_sampler` (unconditional
runs) are not ported (ROADMAP A).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gan_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating generator loss: softplus(-D(G(z)))."""
    return F.softplus(-fake_logits).mean()


def gan_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """Discriminator loss: softplus(D(fake)) + softplus(-D(real))."""
    return F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()


def r1_penalty(real_logits: torch.Tensor, real_imgs: torch.Tensor) -> torch.Tensor:
    """0.5 * E[|grad_x D(x)|^2] on real images (sans lambda).

    `real_logits` must come from `real_imgs` with `requires_grad` set. The
    gradient is taken with create_graph=True, so the penalty differentiates
    w.r.t. D's parameters (a double backward through D only: the generator's
    kernels never see it)."""
    (grad_real,) = torch.autograd.grad(real_logits.sum(), real_imgs, create_graph=True)
    return 0.5 * grad_real.reshape(grad_real.shape[0], -1).pow(2).sum(1).mean()


def photometric_loss(real: torch.Tensor, generated: torch.Tensor) -> torch.Tensor:
    return ((real - generated) ** 2).mean()


def depth_loss(gt_depth: torch.Tensor, pred_depth: torch.Tensor) -> torch.Tensor:
    """MSE over ground-truth foreground (nonzero-depth) pixels only."""
    mask = gt_depth != 0
    sq = torch.where(mask, (gt_depth - pred_depth) ** 2, torch.zeros_like(pred_depth))
    return sq.sum() / mask.sum().clamp_min(1)
