"""ResNet-PointNet encoder (port of conditioned_nerf_gan_tpu/models/pointnet.py).

Colored point cloud (B, T, 6) -> global latent (B, c_dim), fp32. Each block
after the first also sees the max-pool of its input over the points: in fp32
concatenated onto every point once (`_PooledConcat`), under a compute_dtype as
the `extra=` operand of its `fc_0` and `shortcut` (`TorchLinear`).

`compute_dtype` is the JAX encoder's `dtype`: the presets' bf16 policy.
Under it the products run with bf16 operands and bf16 outputs (fc_pos and
the blocks, `fp32_out=False`), the activations, max-pools and shortcut adds
stay bf16, the pooled half of a block's input is a once-per-batch product,
and `fc_c` sums in fp32 and returns the latent in fp32, so `encode_pcl`'s
whitening stays fp32. Params stay fp32. `None` is the fp32 path.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import TorchLinear, zeros_init


class _PooledConcat(torch.autograd.Function):
    """(x (B, T, K), pooled (B, 1, F)) -> (s, relu(s)), s = concat([x,
    broadcast(pooled)], -1): the fp32 block's one concat, feeding `shortcut`
    (s) and `fc_0` (relu(s)). Only relu(s) is kept here, and the linears keep
    s and relu(s), so a block saves two (B, T, K + F) tensors for the
    backward and no relu(x) beside them. The backward sums each consumer's
    cotangent over the points on its own before adding the two, as autograd
    does for two concats of broadcast operands, so the grads are bit-equal
    to that formulation's."""

    @staticmethod
    def forward(ctx, x, pooled):
        s = torch.cat([x, pooled.expand(*x.shape[:-1], -1)], dim=-1)
        r = F.relu(s)
        ctx.width = x.shape[-1]
        ctx.save_for_backward(r)
        return s, r

    @staticmethod
    def backward(ctx, g_s, g_r):
        (r,) = ctx.saved_tensors
        k = ctx.width
        relu_bwd = torch.ops.aten.threshold_backward
        dx = relu_bwd(g_r[..., :k], r[..., :k], 0) + g_s[..., :k]
        dpooled = (relu_bwd(g_r[..., k:].sum(1, keepdim=True), r[:, :1, k:], 0)
                   + g_s[..., k:].sum(1, keepdim=True))
        return dx, dpooled


class ResnetBlockFC(nn.Module):
    """x_s + fc_1(relu(fc_0(relu(x)))); bias-free linear shortcut on a
    dimension change; fc_1's weight starts at zero."""

    def __init__(self, size_in: int, size_out: int, size_h: int | None = None, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        size_h = size_h or min(size_in, size_out)
        amp = dict(compute_dtype=compute_dtype, fp32_out=False, generator=generator)
        self.fc_0 = TorchLinear(size_in, size_h, **amp)
        self.fc_1 = TorchLinear(size_h, size_out, kernel_init=zeros_init, **amp)
        self.shortcut = (None if size_in == size_out else
                         TorchLinear(size_in, size_out, use_bias=False, **amp))

    def forward(self, x: torch.Tensor, pooled: torch.Tensor | None = None):
        """pooled: optional (B, 1, F) context, the tail of every point's input."""
        if pooled is not None and self.fc_0.compute_dtype is None:
            s, relu_s = _PooledConcat.apply(x, pooled)
            x_s = s if self.shortcut is None else self.shortcut(s)
            return x_s + self.fc_1(F.relu(self.fc_0(relu_s)))
        relu_pooled = F.relu(pooled) if pooled is not None else None
        dx = self.fc_1(F.relu(self.fc_0(F.relu(x), extra=relu_pooled)))
        x_s = x if self.shortcut is None else self.shortcut(x, extra=pooled)
        return x_s.to(dx.dtype) + dx


class ResnetPointnet(nn.Module):
    """(B, T, dim) points -> (B, c_dim) via 5 ResNet blocks and max-pooling."""

    def __init__(self, c_dim: int = 512, dim: int = 6, hidden_dim: int = 512, *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        h = hidden_dim
        self.fc_pos = TorchLinear(dim, 2 * h, compute_dtype=compute_dtype, fp32_out=False,
                                  generator=generator)
        self.blocks = nn.ModuleList(
            [ResnetBlockFC(2 * h, h, compute_dtype=compute_dtype, generator=generator)
             for _ in range(5)])
        self.fc_c = TorchLinear(h, c_dim, compute_dtype=compute_dtype, generator=generator)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        net = self.blocks[0](self.fc_pos(p))
        for block in self.blocks[1:]:
            net = block(net, pooled=net.amax(dim=1, keepdim=True))
        return self.fc_c(F.relu(net.amax(dim=1))).float()


def encode_pcl(encoder: nn.Module, pcl: torch.Tensor, *, noise_weight: float = 0.0,
               generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None):
    """Encode a point cloud, whiten the latent over its channels (unbiased
    std, ddof=1) and blend in gaussian noise by `noise_weight`.

    Returns (z, l_reg) with l_reg the mean L2 norm of the raw latents.
    """
    encodes = encoder(pcl)
    l_reg = torch.linalg.vector_norm(encodes, dim=1).mean()
    encodes = encodes - encodes.mean(dim=1, keepdim=True)
    encodes = encodes / encodes.std(dim=1, keepdim=True, unbiased=True)
    if noise_weight:
        if noise is None:
            if generator is None:
                raise ValueError("encode_pcl with noise_weight needs a generator")
            noise = torch.randn(encodes.shape, generator=generator,
                                dtype=encodes.dtype, device=encodes.device)
        encodes = noise_weight * noise + (1.0 - noise_weight) * encodes
    return encodes, l_reg
