"""What the fp32 PointNet keeps for its backward, and its grads.

A block after the first concatenates the pooled context onto every point
once (`_PooledConcat`): `fc_0` takes the relu of that concat, `shortcut` the
concat itself. The formulation it replaced concatenated twice (the relu'd
input for `fc_0`, the raw one for `shortcut`) and kept relu(x) on top: one
more (B, T, 512) fp32 tensor a block, 8 KiB a point over the 4 blocks.
Both are replicated here against the port's encoder.

About 10 s of CPU.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conditioned_nerf_gan_torch.models.pointnet import ResnetBlockFC, ResnetPointnet, encode_pcl

POINTS = (2, 4096)
# unique storages the saved-tensor hooks see for one fp32 encode_pcl with
# grad at 2 x 4096 points, widths 512/512, on the earlier one-concat
# PointNet (plain autograd: relu of the concat): 506.22 MiB
PR9_SAVED_BYTES = 530_808_848
# the two-concat formulation keeps relu(x) (and relu(pooled)) on top: 4
# blocks x (8192 points + 2 pooled rows) x 512 fp32
TWO_CONCAT_EXTRA_BYTES = 4 * (POINTS[0] * POINTS[1] + POINTS[0]) * 512 * 4


BLOCK_FORWARD = ResnetBlockFC.forward


def two_concat_forward(self, x, pooled=None):
    """The two-concat block: in fp32 one concat for `fc_0` (of relu(x) and
    relu(pooled)) and one for `shortcut`, relu(x) kept; under the policy
    the `extra=` operand, as the block itself runs it."""
    if pooled is None or self.fc_0.compute_dtype is not None:
        return BLOCK_FORWARD(self, x, pooled)

    def cat(a, b):
        return torch.cat([a, b.expand(*a.shape[:-1], -1)], dim=-1)

    dx = self.fc_1(F.relu(self.fc_0(cat(F.relu(x), F.relu(pooled)))))
    return self.shortcut(cat(x, pooled)) + dx


def _encoder(dtype=None, jitter=True):
    enc = ResnetPointnet(c_dim=512, compute_dtype=dtype,
                         generator=torch.Generator().manual_seed(1))
    if jitter:  # fc_1 starts at zero: give every path a non-zero cotangent
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for p in enc.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return enc


def _pcl():
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.uniform(-0.5, 0.5, (*POINTS, 6)).astype(np.float32))


def _saved_bytes(enc, pcl) -> int:
    seen = {}

    def pack(t):
        storage = t.untyped_storage()
        seen[storage.data_ptr()] = storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        encode_pcl(enc, pcl)
    return sum(seen.values())


def _encode_with_grads(enc, pcl):
    enc.zero_grad(set_to_none=True)
    z, z_reg = encode_pcl(enc, pcl)
    (z.square().sum() + z_reg).backward()
    return z.detach(), z_reg.detach(), {k: p.grad.clone() for k, p in enc.named_parameters()}


def test_fp32_pointnet_saves_pr9_bytes(monkeypatch):
    enc, pcl = _encoder(), _pcl()
    saved = _saved_bytes(enc, pcl)
    monkeypatch.setattr(ResnetBlockFC, "forward", two_concat_forward)
    two_concat = _saved_bytes(enc, pcl)
    assert saved <= PR9_SAVED_BYTES, saved / 2 ** 20
    assert two_concat - saved == TWO_CONCAT_EXTRA_BYTES, (two_concat - saved) / 2 ** 20


@pytest.mark.parametrize("dtype,jitter", [(None, False), (None, True), (torch.bfloat16, True)],
                         ids=["fp32_init", "fp32_jittered", "bf16_policy"])
def test_pointnet_grads_bitwise_the_two_concat_formulation(dtype, jitter, monkeypatch):
    """Latent, z_reg and every param grad are bit-equal to the two-concat
    block's: the one concat regroups no sum (the pooled cotangent of each
    consumer is summed over the points on its own). The bf16 policy does
    not take the concat at all."""
    enc, pcl = _encoder(dtype, jitter), _pcl()
    z, z_reg, grads = _encode_with_grads(enc, pcl)
    monkeypatch.setattr(ResnetBlockFC, "forward", two_concat_forward)
    z_ref, z_reg_ref, grads_ref = _encode_with_grads(enc, pcl)
    assert torch.equal(z, z_ref) and torch.equal(z_reg, z_reg_ref)
    assert grads.keys() == grads_ref.keys()
    differ = [k for k in grads if not torch.equal(grads[k], grads_ref[k])]
    assert not differ, differ
    if jitter:  # every path carries a cotangent
        assert all(g.abs().sum() > 0 for g in grads.values())
