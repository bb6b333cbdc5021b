"""The port's FiLM-SIREN gradient vs the JAX package's, on the CPU.

`film_siren_mlp_folded_vjp` (the plain version of the backward kernel) is
held against the JAX `_backward_pallas` run in interpret mode, and against
torch autograd of the folded forward. The CUDA kernel itself runs only on a
card: tests/test_torch_cuda.py (marker `cuda`) skips here, and
`python3 chip_smoke.py` holds it against the plain VJP at the main path's
shapes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.ops.pallas import film_siren as jfs
from conditioned_nerf_gan_torch.ops.kernels import film_siren as tfs

NAMES = ("dpoints", "dfreq", "dphase", "dw0", "db0", "dws", "dbs", "dwf", "dbf")


def _inputs(B=2, N=100, Din=3, H=32, L=4, seed=0, freq_scale=1.0):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.uniform(-1, 1, (B, N, Din)),
        (rng.normal(size=(B, L * H)) * 15 + 30) * freq_scale,
        rng.normal(size=(B, L * H)),
        rng.normal(size=(Din, H)) * 0.3,
        rng.normal(size=(H,)) * 0.1,
        rng.normal(size=(L - 1, H, H)) * 0.05,
        rng.normal(size=(L - 1, H)) * 0.1,
        rng.normal(size=(H, 4)) * 0.05,
        rng.normal(size=(4,)) * 0.1,
    )
    g = rng.normal(size=(B, N, 4))
    return [a.astype(np.float32) for a in arrays], g.astype(np.float32)


def _assert_grads_close(port, ref, rtol):
    """Each grad within rtol of its own largest value."""
    for name, a, b in zip(NAMES, port, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("freq_scale,rtol,din,L", [
    # fp32 sums in another order (observed 5.4e-7 of each grad's max)
    (1.0 / 30.0, 1e-5, 3, 4),
    # freq 30 +- 15: a 1e-7 difference in pre grows ~8x per layer through
    # the recompute and again through the backward (observed 1.4e-4)
    (1.0, 5e-4, 3, 4),
    # the voxel family's width and depth, Din 32 and L 8 (observed 4.4e-7)
    (1.0 / 30.0, 1e-5, 32, 8),
], ids=["freq_1", "freq_30", "din32_l8_freq_1"])
def test_folded_vjp_fp32_matches_pallas_interpret(freq_scale, rtol, din, L):
    """fp32 operands: the plain VJP against the real Pallas backward kernel in
    interpret mode, at a ragged N (100 points, 32-point tiles: the padded
    lanes' ones row must not count in the bias grads)."""
    arrays, g = _inputs(freq_scale=freq_scale, Din=din, L=L)
    j = jfs._backward_pallas(*map(jnp.asarray, arrays), jnp.asarray(g), tile=32,
                             matmul_dtype=jnp.float32, interpret=True)
    t = tfs.film_siren_mlp_folded_vjp(*map(torch.from_numpy, arrays),
                                      torch.from_numpy(g), matmul_dtype=torch.float32)
    _assert_grads_close([x.numpy() for x in t], j, rtol=rtol)


def test_folded_vjp_bf16_matches_pallas_interpret():
    """bf16 operands, the kernel's policy: the same roundings of h, cos7(pre),
    g and every dpre on both sides."""
    arrays, g = _inputs(freq_scale=1.0 / 30.0)
    j = jfs._backward_pallas(*map(jnp.asarray, arrays), jnp.asarray(g), tile=32,
                             matmul_dtype=jnp.bfloat16, interpret=True)
    t = tfs.film_siren_mlp_folded_vjp(*map(torch.from_numpy, arrays),
                                      torch.from_numpy(g), matmul_dtype=torch.bfloat16)
    # fp32 sums in another order flip a bf16 rounding now and then; at
    # freq ~1 a flip moves a grad by ~one bf16 step of one term (observed
    # 7.8e-5 of each grad's max)
    _assert_grads_close([x.numpy() for x in t], j, rtol=5e-4)


def test_folded_vjp_bf16_din32_l8_matches_pallas_interpret():
    """bf16 operands at the voxel family's width and depth (Din 32, L 8):
    the dpoints the trilinear backward scatters, and every weight grad."""
    arrays, g = _inputs(Din=32, L=8, freq_scale=1.0 / 30.0, seed=11)
    j = jfs._backward_pallas(*map(jnp.asarray, arrays), jnp.asarray(g), tile=32,
                             matmul_dtype=jnp.bfloat16, interpret=True)
    t = tfs.film_siren_mlp_folded_vjp(*map(torch.from_numpy, arrays),
                                      torch.from_numpy(g), matmul_dtype=torch.bfloat16)
    assert t[0].shape == (2, 100, 32)
    # as at Din 3: a flipped bf16 rounding moves a grad by ~one bf16 step of
    # one term (observed 2.3e-4 of each grad's max)
    _assert_grads_close([x.numpy() for x in t], j, rtol=1e-3)


def test_folded_vjp_fp32_matches_autograd_of_folded_forward():
    arrays, g = _inputs(N=37, seed=3)
    t_in = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = tfs.film_siren_mlp_folded(*t_in, matmul_dtype=torch.float32)
    ref = torch.autograd.grad(out, t_in, torch.from_numpy(g))
    vjp = tfs.film_siren_mlp_folded_vjp(*[t.detach() for t in t_in],
                                        torch.from_numpy(g), matmul_dtype=torch.float32)
    # same fp32 math at freq 30 +- 15, sums grouped differently (observed
    # 1.0e-6 of each grad's max)
    _assert_grads_close([x.numpy() for x in vjp], [x.numpy() for x in ref], rtol=1e-5)


def test_unfold_matches_jax_epilogue():
    """The fold unwind alone: folded-space grads from the plain version,
    unwound by the port and by the JAX formulas of `_backward_pallas`."""
    arrays, g = _inputs(B=3, N=20, H=16, L=3)
    t_in = [torch.from_numpy(a) for a in arrays]
    _, dw0f, dc0, dwsf, dcs, _, _ = tfs.film_siren_folded_grads(
        *t_in, torch.from_numpy(g), matmul_dtype=torch.float32)
    port = tfs.unfold_film_grads(dw0f, dc0, dwsf, dcs, t_in[1], *t_in[3:7])
    B, L, H = 3, 3, 16
    freq, w0, b0, ws, bs = (jnp.asarray(arrays[i]) for i in (1, 3, 4, 5, 6))
    dw0f, dc0, dwsf, dcs = (jnp.asarray(x.numpy()) for x in (dw0f, dc0, dwsf, dcs))
    f = freq.reshape(B, L, H)
    ref = (
        jnp.concatenate([((dw0f * w0[None]).sum(1) + dc0 * b0[None])[:, None],
                         (dwsf * ws[None]).sum(2) + dcs * bs[None]], 1).reshape(B, -1),
        jnp.concatenate([dc0[:, None], dcs], 1).reshape(B, -1),
        (dw0f * f[:, 0][:, None, :]).sum(0),
        (dc0 * f[:, 0]).sum(0),
        (dwsf * f[:, 1:][:, :, None, :]).sum(0),
        (dcs * f[:, 1:]).sum(0),
    )
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_folded_vjp_chunks_over_points_add_up():
    """Every folded grad is a sum over points: chip_smoke.py computes the
    fp64 yardstick chunk by chunk over N."""
    arrays, g = _inputs(N=64, seed=5)
    t_in = [torch.from_numpy(a).double() for a in arrays]
    g = torch.from_numpy(g).double()
    whole = tfs.film_siren_folded_grads(*t_in, g, accum_dtype=torch.float64)
    halves = [tfs.film_siren_folded_grads(t_in[0][:, sl], *t_in[1:], g[:, sl],
                                          accum_dtype=torch.float64)
              for sl in (slice(0, 40), slice(40, 64))]
    torch.testing.assert_close(torch.cat([h[0] for h in halves], 1), whole[0])
    for i in range(1, 7):
        torch.testing.assert_close(halves[0][i] + halves[1][i], whole[i])


def test_cos7_is_the_derivative_of_sin7():
    x = torch.linspace(-45.0, 45.0, 200_001, dtype=torch.float64, requires_grad=True)
    (dx,) = torch.autograd.grad(tfs.sin7(x).sum(), x)  # torch.round: no gradient
    torch.testing.assert_close(tfs.cos7(x.detach()), dx, rtol=0, atol=1e-12)
    xf = np.linspace(-45.0, 45.0, 100_001, dtype=np.float32)
    np.testing.assert_allclose(tfs.cos7(torch.from_numpy(xf)).numpy(),
                               np.asarray(jfs._cos7(jnp.asarray(xf))), atol=1e-6)


def test_cpu_autograd_matches_jax_reference_grad():
    """CPU tensors take the fp32 reference under plain autograd, as the JAX
    custom VJP takes the reference's VJP off the TPU."""
    arrays, g = _inputs(N=50, seed=7)
    t_in = [torch.from_numpy(a).requires_grad_() for a in arrays]
    before = (tfs.film_siren_mlp.launches, tfs.film_siren_mlp_bwd.launches)
    out = tfs.film_siren_mlp(*t_in)
    t_grads = torch.autograd.grad(out, t_in, torch.from_numpy(g))
    assert (tfs.film_siren_mlp.launches, tfs.film_siren_mlp_bwd.launches) == before
    _, vjp = jax.vjp(jfs.film_siren_mlp, *map(jnp.asarray, arrays))
    j_grads = vjp(jnp.asarray(g))
    # fp32 exact-sin math on both sides at freq 30 +- 15, where summation
    # order differences grow through the layers (observed 1.7e-4 of each max)
    _assert_grads_close([x.numpy() for x in t_grads], j_grads, rtol=5e-4)


def test_function_routes_forward_and_backward(monkeypatch):
    """`FilmSirenMLP` with its two kernel launches stood in for by their
    plain versions: the forward saves the nine inputs, the backward hands the
    (strided) cotangent to the backward wrapper and returns a grad only where
    one is needed."""
    seen = {}

    def fwd(*args):
        seen["fwd"] = len(args)
        return tfs.film_siren_mlp_folded(*args)

    def bwd(*args):
        seen["g"] = args[-1]
        return tfs.film_siren_mlp_folded_vjp(*args)

    monkeypatch.setattr(tfs, "_forward_kernel", fwd)
    monkeypatch.setattr(tfs, "film_siren_mlp_bwd", bwd)
    arrays, _ = _inputs(N=30, seed=9)
    t_in = [torch.from_numpy(a) for a in arrays]
    for i in (1, 2, 3, 5):  # freq, phase, w0, ws need grad; points does not
        t_in[i].requires_grad_()
    out = tfs.FilmSirenMLP.apply(*t_in)
    out[..., 3].sum().backward()  # the cotangent is an expanded, strided view
    assert seen["fwd"] == 9 and seen["g"].shape == out.shape
    g = torch.zeros_like(out)
    g[..., 3] = 1.0
    ref = tfs.film_siren_mlp_folded_vjp(*[t.detach() for t in t_in], g)
    for i, t in enumerate(t_in):
        if i in (1, 2, 3, 5):
            torch.testing.assert_close(t.grad, ref[i], rtol=0, atol=0)
        else:
            assert t.grad is None


def test_bwd_wrapper_on_cpu_takes_plain_vjp_without_launch():
    arrays, g = _inputs(N=20)
    t_in = [torch.from_numpy(a) for a in arrays]
    before = tfs.film_siren_mlp_bwd.launches
    out = tfs.film_siren_mlp_bwd(*t_in, torch.from_numpy(g))
    assert tfs.film_siren_mlp_bwd.launches == before
    ref = tfs.film_siren_mlp_folded_vjp(*t_in, torch.from_numpy(g))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bwd_wrapper_refuses_other_devices():
    arrays, g = _inputs(N=20)
    t_in = [torch.from_numpy(a).to("meta") for a in arrays]
    with pytest.raises(ValueError, match="no kernel"):
        tfs.film_siren_mlp_bwd(*t_in, torch.from_numpy(g).to("meta"))
