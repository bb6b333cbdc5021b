"""Card-only tests of the hand-written CUDA kernels (marker `cuda`): the
FiLM-SIREN forward (K1) and backward (K2) against their plain versions.

They skip without a CUDA card. This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from conditioned_nerf_gan_torch.ops.kernels import film_siren as tfs

pytestmark = pytest.mark.cuda


@pytest.fixture
def kernel_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full fp32
    rng = np.random.default_rng(0)
    B, N, H, L = 2, 1000, tfs.KERNEL_HIDDEN, 4
    arrays = (
        rng.uniform(-0.3, 0.3, (B, N, 3)),
        rng.uniform(25, 45, (B, L * H)),
        rng.uniform(-1, 1, (B, L * H)),
        rng.normal(0, 0.5, (3, H)),
        rng.normal(0, 0.1, (H,)),
        rng.normal(0, 1.0, (L - 1, H, H)) * np.sqrt(6 / H) / 30,
        rng.normal(0, 0.1, (L - 1, H)),
        rng.normal(0, 0.1, (H, 4)),
        rng.normal(0, 0.1, (4,)),
    )
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]


@pytest.mark.parametrize("freq_scale,atol", [
    # freq/30: no rounding flip can grow, so any layout fault is O(1)
    # (max seen on an H100 at N=1000: 8.9e-4)
    (1.0 / 30.0, 2e-3),
    # freq 25-45: a flipped bf16 rounding of h grows ~2x per layer; at
    # N=1000 the max stays inside 2e-2 (seen on an H100: 1.03e-2), while
    # at 1.57M points chip_smoke.py bounds mean, p99.9 and fp64 distance
    (1.0, 2e-2),
])
def test_kernel_matches_folded(kernel_inputs, freq_scale, atol):
    kernel_inputs[1] = kernel_inputs[1] * freq_scale
    before = tfs.film_siren_mlp.launches
    with torch.no_grad():
        out = tfs.film_siren_mlp(*kernel_inputs)
        plain = tfs.film_siren_mlp_folded(*kernel_inputs)
    torch.cuda.synchronize()
    assert tfs.film_siren_mlp.launches == before + 1
    assert torch.isfinite(out).all()
    assert (out - plain).abs().max().item() < atol


def test_kernel_refuses_what_it_does_not_take(kernel_inputs):
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            tfs.film_siren_mlp(kernel_inputs[0].transpose(0, 1).contiguous()
                               .transpose(0, 1), *kernel_inputs[1:])
        with pytest.raises(TypeError, match="float32"):
            tfs.film_siren_mlp(kernel_inputs[0].double(), *kernel_inputs[1:])
        narrow = [t[:, :128] if i == 3 else t for i, t in enumerate(kernel_inputs)]
        with pytest.raises(ValueError, match="the kernel takes"):
            tfs.film_siren_mlp(*narrow)


@pytest.fixture
def cotangent(kernel_inputs):
    B, N, _ = kernel_inputs[0].shape
    g = np.random.default_rng(1).normal(0, 1, (B, N, 4)).astype(np.float32)
    return torch.from_numpy(g).cuda()


@pytest.mark.parametrize("freq_scale,norm_tol", [
    # freq/30: no rounding flip can grow (seen on an H100 at N=1000 in
    # chip_smoke's ragged shape: 3.4e-4 at most over the nine grads)
    (1.0 / 30.0, 2e-3),
    # freq 25-45: flipped bf16 roundings grow through the layers (seen:
    # 1.39e-3); a layout fault reads O(0.1-1)
    (1.0, 3e-3),
])
def test_bwd_kernel_matches_plain_vjp(kernel_inputs, cotangent, freq_scale, norm_tol):
    kernel_inputs[1] = kernel_inputs[1] * freq_scale
    before = tfs.film_siren_mlp_bwd.launches
    out = tfs.film_siren_mlp_bwd(*kernel_inputs, cotangent)
    plain = tfs.film_siren_mlp_folded_vjp(*kernel_inputs, cotangent)
    torch.cuda.synchronize()
    assert tfs.film_siren_mlp_bwd.launches == before + 1
    for k, p in zip(out, plain):
        assert k.shape == p.shape and torch.isfinite(k).all()
        assert ((k - p).norm() / p.norm()).item() < norm_tol


def test_bwd_kernel_is_deterministic(kernel_inputs, cotangent):
    """The weight grads are summed in a fixed order: two launches agree to
    the bit, at a shape with several point segments."""
    big = [t.repeat(1, 9, 1) if i == 0 else t for i, t in enumerate(kernel_inputs)]
    g = cotangent.repeat(1, 9, 1)
    first = tfs.film_siren_mlp_bwd(*big, g)
    second = tfs.film_siren_mlp_bwd(*big, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_function_grads_through_both_kernels(kernel_inputs, cotangent):
    """Autograd through `film_siren_mlp`: K1 forward, K2 backward, with a
    strided cotangent (the grad of a slice)."""
    args = [t.clone().requires_grad_(i > 0) for i, t in enumerate(kernel_inputs)]
    fwd, bwd = tfs.film_siren_mlp.launches, tfs.film_siren_mlp_bwd.launches
    out = tfs.film_siren_mlp(*args)
    (out[..., :3] * cotangent[..., :3]).sum().backward()
    torch.cuda.synchronize()
    assert (tfs.film_siren_mlp.launches, tfs.film_siren_mlp_bwd.launches) == (fwd + 1,
                                                                              bwd + 1)
    g = cotangent.clone()
    g[..., 3] = 0.0
    ref = tfs.film_siren_mlp_bwd(*kernel_inputs, g)
    assert args[0].grad is None
    for t, r in zip(args[1:], ref[1:]):
        assert torch.equal(t.grad, r)


def test_bwd_kernel_refuses_what_it_does_not_take(kernel_inputs, cotangent):
    with pytest.raises(ValueError, match="contiguous"):
        tfs.film_siren_mlp_bwd(kernel_inputs[0].transpose(0, 1).contiguous()
                               .transpose(0, 1), *kernel_inputs[1:], cotangent)
    with pytest.raises(TypeError, match="float32"):
        tfs.film_siren_mlp_bwd(*kernel_inputs, cotangent.double())
    with pytest.raises(TypeError, match="float32"):
        tfs.film_siren_mlp_bwd(*kernel_inputs, cotangent.cpu())
    with pytest.raises(ValueError, match="the kernel takes"):
        tfs.film_siren_mlp_bwd(*kernel_inputs, cotangent[..., :3])
    narrow = [t[:, :128] if i == 3 else t for i, t in enumerate(kernel_inputs)]
    with pytest.raises(ValueError, match="the kernel takes"):
        tfs.film_siren_mlp_bwd(*narrow, cotangent)
    with pytest.raises(ValueError, match="points on"):
        tfs.film_siren_mlp_bwd(*kernel_inputs[:-1], kernel_inputs[-1].cpu(), cotangent)
