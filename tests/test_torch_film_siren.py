"""The port's FiLM-SIREN module vs the JAX package's Pallas module, on the CPU.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py (marker
`cuda`) skips here, and `python3 chip_smoke.py` holds the kernel against
`film_siren_mlp_folded` at the main path's shapes.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.ops.pallas import film_siren as jfs
from conditioned_nerf_gan_torch.ops.kernels import film_siren as tfs

def _inputs(B=2, N=100, Din=3, H=32, L=4, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.uniform(-1, 1, (B, N, Din)),
        rng.normal(size=(B, L * H)) * 15 + 30,
        rng.normal(size=(B, L * H)),
        rng.normal(size=(Din, H)) * 0.3,
        rng.normal(size=(H,)) * 0.1,
        rng.normal(size=(L - 1, H, H)) * 0.05,
        rng.normal(size=(L - 1, H)) * 0.1,
        rng.normal(size=(H, 4)) * 0.05,
        rng.normal(size=(4,)) * 0.1,
    )
    return [a.astype(np.float32) for a in arrays]


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("freq_scale,atol", [
    # freq ~1: any formula or layout error is O(1); fp32 sums in another
    # order stay ~1e-7 (observed 7.5e-8)
    (1.0 / 30.0, 1e-5),
    # freq 30 +- 15 (the model's range): the same ~1e-7 rounding grows by
    # ~freq x per layer over 4 layers (observed 4.8e-5)
    (1.0, 1e-4),
])
def test_reference_matches_jax(freq_scale, atol):
    arrays = _inputs()
    arrays[1] = arrays[1] * np.float32(freq_scale)
    j_in, t_in = _both(arrays)
    j = jfs.film_siren_mlp_reference(*j_in)
    t = tfs.film_siren_mlp_reference(*t_in)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


def test_folded_fp32_matches_pallas_interpret():
    """Port folded math (fp32 operands, sin7) vs the real Pallas kernel in
    interpret mode, ragged N (100 points, 32-point tiles)."""
    j_in, t_in = _both(_inputs(N=100))
    j = jfs._forward_pallas(*j_in, tile=32, matmul_dtype=jnp.float32, interpret=True)
    t = tfs.film_siren_mlp_folded(*t_in, matmul_dtype=torch.float32)
    # the 2e-4 of tests/test_pallas.py (kernel vs folded fp32 comparator);
    # observed 6.3e-5
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-4)


def _voxel_inputs(freq_scale, B=2, N=100, Din=32, H=32, L=8, seed=0):
    """The voxel family's shape (32 sampled features, 8 layers), at the
    model's init scales so that 8 layers neither vanish nor explode."""
    rng = np.random.default_rng(seed)
    arrays = (
        rng.uniform(-0.5, 0.5, (B, N, Din)),
        rng.uniform(25, 45, (B, L * H)) * freq_scale,
        rng.uniform(-1, 1, (B, L * H)),
        rng.uniform(-1, 1, (Din, H)) / Din,
        rng.normal(size=(H,)) * 0.1,
        rng.uniform(-1, 1, (L - 1, H, H)) * np.sqrt(6 / H) / 25,
        rng.normal(size=(L - 1, H)) * 0.1,
        rng.uniform(-1, 1, (H, 4)) * np.sqrt(6 / H) / 25,
        rng.normal(size=(4,)) * 0.1,
    )
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("freq_scale", [1.0 / 30.0, 1.0], ids=["freq_over_30", "freq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_din32_l8_matches_pallas_interpret(freq_scale, dtype):
    """K1 at the voxel family's shape: the port's folded math vs the real
    Pallas kernel in interpret mode (100 points, 32-point tiles)."""
    j_in, t_in = _both(_voxel_inputs(freq_scale))
    j = jfs._forward_pallas(*j_in, tile=32, matmul_dtype=getattr(jnp, dtype),
                            interpret=True)
    t = tfs.film_siren_mlp_folded(*t_in, matmul_dtype=getattr(torch, dtype))
    # the same roundings, fp32 sums in another order (observed 5.7e-7 in
    # fp32, 7.5e-9 in bf16, where no rounding of h flips at these points;
    # one flip would move the output by ~1e-3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def test_kernel_checks_take_din32_for_the_forward_only():
    """The checks the wrappers run on a card: the forward and the backward
    take Din 3 or 32 and 2 to 8 layers; a wrapper of xyz points only (the
    study kernels') refuses 32."""
    t_in = [torch.from_numpy(a) for a in _voxel_inputs(1.0, H=tfs.KERNEL_HIDDEN)]
    tfs._check_kernel_inputs(*t_in)
    tfs._check_kernel_inputs(*t_in, name="film_siren_mlp_bwd")
    with pytest.raises(ValueError, match="32 features, the kernel takes 3$"):
        tfs._check_kernel_inputs(*t_in, name="film_siren_study", widths=(tfs.KERNEL_IN,))
    narrow = [t[..., :5] if i == 0 else t[:5] if i == 3 else t for i, t in enumerate(t_in)]
    with pytest.raises(ValueError, match="3 or 32"):
        tfs._check_kernel_inputs(*narrow)
    H = tfs.KERNEL_HIDDEN
    deep = [torch.zeros(2, 9 * H) if i in (1, 2) else torch.zeros(8, H, H) if i == 5
            else torch.zeros(8, H) if i == 6 else t for i, t in enumerate(t_in)]
    with pytest.raises(ValueError, match="2 to 8"):
        tfs._check_kernel_inputs(*deep)


def test_folded_bf16_matches_jax_folded():
    j_in, t_in = _both(_inputs(N=100))
    j = jfs._folded_forward_jnp(*j_in, sin_fn=jfs._sin7, matmul_dtype=jnp.bfloat16)
    t = tfs.film_siren_mlp_folded(*t_in, matmul_dtype=torch.bfloat16)
    # same bf16-rounded operands, fp32 sums in another order (observed
    # 3.0e-8: no bf16 rounding of h flips at these points; one flip would
    # move the output by ~1e-3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def test_folded_fp64_sums_match_fp32_at_low_freq():
    """accum_dtype=float64 (chip_smoke's yardstick for summation-order
    noise) keeps every rounding of the bf16 math and changes only the sums."""
    _, t_in = _both(_inputs(N=100))
    t_in[1] = t_in[1] / 30.0
    a = tfs.film_siren_mlp_folded(*t_in)
    b = tfs.film_siren_mlp_folded(*t_in, accum_dtype=torch.float64)
    assert b.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)  # observed 1.5e-8


def test_fold_matches_jax():
    j_in, t_in = _both(_inputs(B=3, N=8, H=16, L=3))
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        for a, b in zip(tfs.fold_film(*t_in[1:7], dt_t), jfs._fold_film(*j_in[1:7], dt_j)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b.astype(jnp.float32)), atol=1e-5)


def test_sin7_accuracy_and_parity():
    x = np.linspace(-45.0, 45.0, 1_000_001, dtype=np.float32)
    t = tfs.sin7(torch.from_numpy(x)).numpy()
    assert np.abs(t.astype(np.float64) - np.sin(x.astype(np.float64))).max() < 3e-4
    np.testing.assert_allclose(t, np.asarray(jfs._sin7(jnp.asarray(x))), atol=1e-6)


def test_wrapper_on_cpu_takes_reference_without_launch():
    _, t_in = _both(_inputs())
    before = tfs.film_siren_mlp.launches
    out = tfs.film_siren_mlp(*t_in)
    assert tfs.film_siren_mlp.launches == before
    torch.testing.assert_close(out, tfs.film_siren_mlp_reference(*t_in), rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    t_in = [torch.from_numpy(a).to("meta") for a in _inputs()]
    with pytest.raises(ValueError, match="no kernel"):
        tfs.film_siren_mlp(*t_in)
