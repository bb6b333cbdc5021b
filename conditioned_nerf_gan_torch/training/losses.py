"""Loss functions (port of conditioned_nerf_gan_tpu/training/losses.py).

Non-saturating softplus GAN losses, the R1 penalty, photometric MSE, the
foreground-masked depth MSE, the legacy geometry loss and the latent sampler
of unconditional runs (on an explicit `torch.Generator`: its stream is not
JAX's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def z_sampler(shape, dist: str = "gaussian", *, generator: torch.Generator | None = None,
              device=None) -> torch.Tensor:
    """Latent sampler for unconditional runs (conditioned_nerf_gan_tpu/
    training/losses.py:24-30): N(0, 1), or U(-1, 1) for `uniform`."""
    if dist == "gaussian":
        return torch.randn(shape, generator=generator, device=device)
    if dist == "uniform":
        return torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0
    raise ValueError(f"Unknown z_dist {dist!r}")


def gan_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating generator loss: softplus(-D(G(z)))."""
    return F.softplus(-fake_logits).mean()


def gan_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """Discriminator loss: softplus(D(fake)) + softplus(-D(real))."""
    return F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()


def r1_penalty(real_logits, real_imgs: torch.Tensor) -> torch.Tensor:
    """0.5 * E[|grad_x D(x)|^2] on real images (sans lambda)
    (conditioned_nerf_gan_tpu/training/losses.py:43-57).

    `real_logits` must come from `real_imgs` with `requires_grad` set; a
    discriminator's tuple output gives its first member, the logits. The
    gradient is taken with create_graph=True, so the penalty differentiates
    w.r.t. D's parameters (a double backward through D only: the generator's
    kernels never see it)."""
    if isinstance(real_logits, tuple):
        real_logits = real_logits[0]
    (grad_real,) = torch.autograd.grad(real_logits.sum(), real_imgs, create_graph=True)
    return 0.5 * grad_real.reshape(grad_real.shape[0], -1).pow(2).sum(1).mean()


def photometric_loss(real: torch.Tensor, generated: torch.Tensor) -> torch.Tensor:
    return ((real - generated) ** 2).mean()


def depth_loss(gt_depth: torch.Tensor, pred_depth: torch.Tensor) -> torch.Tensor:
    """MSE over ground-truth foreground (nonzero-depth) pixels only."""
    mask = gt_depth != 0
    sq = torch.where(mask, (gt_depth - pred_depth) ** 2, torch.zeros_like(pred_depth))
    return sq.sum() / mask.sum().clamp_min(1)


def geometry_loss(sigma_preds: torch.Tensor, num_pos_points: int) -> torch.Tensor:
    """Penalize low sigma at positive points, high sigma at negatives
    (conditioned_nerf_gan_tpu/training/losses.py:71-75)."""
    pos = F.softplus(-sigma_preds[:, :num_pos_points]).mean()
    neg = F.softplus(sigma_preds[:, num_pos_points:]).mean()
    return pos + neg
