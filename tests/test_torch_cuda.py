"""Card-only tests of the hand-written CUDA kernels (marker `cuda`): the
FiLM-SIREN forward (K1, at Din 3 and 32) and backward (K2), the trilinear
sampler and the study kernels (K3, K4 v4 and v5), against their plain
versions.

They skip without a CUDA card. This file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import conditioned_nerf_gan_torch.ops.kernels.film_study as tstudy
from conditioned_nerf_gan_torch.ops import grid_sample as tgs
from conditioned_nerf_gan_torch.ops.kernels import film_siren as tfs
from conditioned_nerf_gan_torch.tools.bench_film_kernel import (
    ARGS,
    kernel_instances,
    make_inputs,
)

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


@pytest.fixture
def voxel_inputs():
    """K1's inputs at the voxel family's shape and init (TALLSIREN_FG: 32
    sampled features, 8 layers, the trunk U(+-sqrt(6/256)/25))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    B, N, H, L, DIN = 2, 1000, tfs.KERNEL_HIDDEN, 8, 32
    trunk = np.sqrt(6 / H) / 25
    arrays = (
        rng.uniform(-1, 1, (B, N, DIN)),
        rng.uniform(25, 45, (B, L * H)),
        rng.uniform(-1, 1, (B, L * H)),
        rng.uniform(-1 / DIN, 1 / DIN, (DIN, H)),
        rng.uniform(-0.2, 0.2, (H,)),
        rng.uniform(-trunk, trunk, (L - 1, H, H)),
        rng.uniform(-1 / 16, 1 / 16, (L - 1, H)),
        rng.uniform(-trunk, trunk, (H, 4)),
        rng.uniform(-1 / 16, 1 / 16, (4,)),
    )
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]


@pytest.mark.parametrize("freq_scale,atol", [
    # freq/30: no rounding flip can grow, so any layout fault is O(0.1)
    # (chip_smoke.py's ragged shape on an H100: 2.2e-5)
    (1.0 / 30.0, 1e-4),
    # freq 25-45 over 8 layers: a flipped bf16 rounding of h grows per layer
    # (chip_smoke.py's ragged shape: 1.5e-3); chip_smoke.py bounds mean,
    # p99.9 and fp64 distance at 1.57M points
    (1.0, 5e-3),
])
def test_kernel_din32_matches_folded(voxel_inputs, freq_scale, atol):
    voxel_inputs[1] = voxel_inputs[1] * freq_scale
    before = tfs.film_siren_mlp.launches
    with torch.no_grad():
        out = tfs.film_siren_mlp(*voxel_inputs)
        plain = tfs.film_siren_mlp_folded(*voxel_inputs)
    torch.cuda.synchronize()
    assert tfs.film_siren_mlp.launches == before + 1
    assert torch.isfinite(out).all()
    assert (out - plain).abs().max().item() < atol


def test_bwd_kernel_refuses_din32(voxel_inputs):
    g = torch.zeros(*voxel_inputs[0].shape[:2], 4, device="cuda")
    with pytest.raises(ValueError, match="A12"):
        tfs.film_siren_mlp_bwd(*voxel_inputs, g)


def edge_inputs(B, N, din, seed):
    """K1/K2 inputs at freq/30 (no rounding flip grows, so a masking or
    layout fault is O(0.1-1)), drawn as the `kernel_inputs` fixture draws
    them at Din 3 (L 4) and as `voxel_inputs` does at Din 32 (L 8), with a
    cotangent."""
    rng = np.random.default_rng(seed)
    H = tfs.KERNEL_HIDDEN
    if din == 3:
        L = 4
        arrays = (
            rng.uniform(-0.3, 0.3, (B, N, 3)),
            rng.uniform(25, 45, (B, L * H)) / 30,
            rng.uniform(-1, 1, (B, L * H)),
            rng.normal(0, 0.5, (3, H)),
            rng.normal(0, 0.1, (H,)),
            rng.normal(0, 1.0, (L - 1, H, H)) * np.sqrt(6 / H) / 30,
            rng.normal(0, 0.1, (L - 1, H)),
            rng.normal(0, 0.1, (H, 4)),
            rng.normal(0, 0.1, (4,)),
        )
    else:
        L, trunk = 8, np.sqrt(6 / H) / 25
        arrays = (
            rng.uniform(-1, 1, (B, N, din)),
            rng.uniform(25, 45, (B, L * H)) / 30,
            rng.uniform(-1, 1, (B, L * H)),
            rng.uniform(-1 / din, 1 / din, (din, H)),
            rng.uniform(-0.2, 0.2, (H,)),
            rng.uniform(-trunk, trunk, (L - 1, H, H)),
            rng.uniform(-1 / 16, 1 / 16, (L - 1, H)),
            rng.uniform(-trunk, trunk, (H, 4)),
            rng.uniform(-1 / 16, 1 / 16, (4,)),
        )
    g = rng.normal(0, 1, (B, N, 4))
    return ([torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays],
            torch.from_numpy(g.astype(np.float32)).cuda())


# the edges of the 64-point warpgroup tile and the 128-point CTA tile; B 3
# makes the persistent loop cross batch elements within a CTA
EDGE_N = (1, 63, 64, 65, 127, 129, 1000)
EDGE_B = (1, 3)


@pytest.mark.parametrize("din", tfs.KERNEL_INS)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("N", EDGE_N)
def test_kernel_at_tile_edges(din, B, N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, _ = edge_inputs(B, N, din, seed=N + B)
    before = tfs.film_siren_mlp.launches
    with torch.no_grad():
        out = tfs.film_siren_mlp(*args)
        plain = tfs.film_siren_mlp_folded(*args)
    torch.cuda.synchronize()
    assert tfs.film_siren_mlp.launches == before + 1
    assert out.shape == (B, N, 4) and torch.isfinite(out).all()
    # freq/30 maxima seen at N 1000: 8.9e-4 (Din 3), 2.2e-5 (Din 32)
    assert (out - plain).abs().max().item() < (2e-3 if din == 3 else 1e-4)


@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("N", EDGE_N)
def test_bwd_kernel_at_tile_edges(B, N):
    """K2 against the plain VJP at freq/30, and two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, g = edge_inputs(B, N, 3, seed=N + B)
    before = tfs.film_siren_mlp_bwd.launches
    out = tfs.film_siren_mlp_bwd(*args, g)
    again = tfs.film_siren_mlp_bwd(*args, g)
    plain = tfs.film_siren_mlp_folded_vjp(*args, g)
    torch.cuda.synchronize()
    assert tfs.film_siren_mlp_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    for k, p in zip(out, plain):
        assert k.shape == p.shape and torch.isfinite(k).all()
        # as test_bwd_kernel_matches_plain_vjp at freq/30
        assert ((k - p).norm() / p.norm()).item() < 2e-3


@pytest.fixture
def volume_coords():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(3)
    vol = rng.normal(size=(2, 16, 12, 20, 32)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 3000, 3)).astype(np.float32)
    coords[:, :6] = [[1, 1, 1], [-1, -1, -1], [19 / 20, 11 / 12, 15 / 16],
                     [-19 / 20, -11 / 12, -15 / 16], [0, 0, 0], [1, -1, 0]]
    return torch.from_numpy(vol).cuda(), torch.from_numpy(coords).cuda()


def test_trilinear_kernel_matches_plain(volume_coords):
    vol, coords = volume_coords
    before = tgs.trilinear_point_features.launches
    out = tgs.trilinear_point_features(vol, coords)
    plain = tgs.border_trilerp_reference(vol, coords)
    torch.cuda.synchronize()
    assert tgs.trilinear_point_features.launches == before + 1
    assert out.shape == plain.shape == (2, 3000, 32)
    # the same fp32 roundings in the same order, no FMA contraction
    assert (out - plain).abs().max().item() <= 1e-5 * vol.abs().max().item()


def test_trilinear_kernel_refuses_what_it_does_not_take(volume_coords):
    vol, coords = volume_coords
    with pytest.raises(ValueError, match="contiguous"):
        tgs.trilinear_point_features(vol, coords.transpose(0, 1).contiguous()
                                     .transpose(0, 1))
    with pytest.raises(TypeError, match="float32"):
        tgs.trilinear_point_features(vol.double(), coords)
    with pytest.raises(ValueError, match="C % 4"):
        tgs.trilinear_point_features(vol[..., :6].contiguous(), coords)
    with pytest.raises(ValueError, match="on"):
        tgs.trilinear_point_features(vol, coords.cpu())


# every instance the study launches, and every mode at 128 points per CTA
STUDY_CASES = [(k, m, t, n) for k, m, t in kernel_instances() for n in (256, 1000)]


@pytest.mark.parametrize("kernel,mode,tile,n", STUDY_CASES,
                         ids=[f"{k}-{m}-{t}-{n}" for k, m, t, n in STUDY_CASES])
def test_study_kernel_matches_plain(kernel, mode, tile, n):
    """Each study kernel at a small and a ragged N against its plain version
    at freq/30 (the script's input distribution), where no rounding flip
    grows: a layout or masking fault is O(1). The bound is relative above 1
    for `nosin`, whose outputs reach ~10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    arrays = make_inputs(0, n)
    arrays["freq"] = arrays["freq"] / np.float32(30)
    args = [torch.from_numpy(arrays[k]).cuda() for k in ARGS]
    before = tstudy.film_siren_study.launches[kernel]
    with torch.no_grad():
        out = tstudy.film_siren_study(*args, kernel=kernel, mode=mode, tile=tile)
        plain = tstudy.film_study_reference(*args, kernel=kernel, mode=mode)
    torch.cuda.synchronize()
    assert tstudy.film_siren_study.launches[kernel] == before + 1
    assert out.shape == (2, n, 4) and torch.isfinite(out).all()
    err = (out - plain).abs().max().item() / max(1.0, plain.abs().max().item())
    assert err < 5e-3


def test_study_kernel_refuses_an_uncompiled_instance():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    args = [torch.from_numpy(v).cuda() for v in make_inputs(0, 256).values()]
    with pytest.raises(ValueError, match="no instance of v4 sin7 at 32 points"):
        tstudy.film_siren_study(*args, kernel="v4", mode="sin7", tile=32)
