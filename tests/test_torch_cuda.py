"""Card-only tests of the hand-written CUDA kernels (marker `cuda`): the
FiLM-SIREN forward (K1) and backward (K2), each at Din 3 and 32, the
trilinear sampler and its backward, and the study kernels (K3, K4 v4 and
v5), against their plain versions; one Trainer step on the card; a
render with its backward, a train step and a request that never make the
host wait for the stream; and, at the thesis G step's shapes, ray chunks
that keep their activations against chunks replayed in the backward.

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
from conditioned_nerf_gan_torch.ops.kernels import trilinear as ttri
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


@pytest.mark.parametrize("freq_scale,norm_tol", [
    # summation order alone, against O(0.1-1) for a layout fault; over 8
    # layers a flipped bf16 rounding grows through twice the products of
    # L 4 (chip_smoke.py phase 4b on an H100: 4.5e-3 at freq/30, 5.1e-3 at
    # freq 25-45; the deepest grads at freq/30 are ~1e-10, one bf16 step of
    # their terms apart)
    (1.0 / 30.0, 1e-2),
    (1.0, 1e-2),
])
def test_bwd_kernel_din32_matches_plain_vjp(voxel_inputs, freq_scale, norm_tol):
    """K2 at the voxel family's shape (Din 32, L 8): all nine grads, dpoints
    (the sampled features' cotangent) among them, and the dX product on the
    tensor cores."""
    voxel_inputs[1] = voxel_inputs[1] * freq_scale
    B, N, _ = voxel_inputs[0].shape
    g = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (B, N, 4))
                         .astype(np.float32)).cuda()
    before = tfs.film_siren_mlp_bwd.launches
    out = tfs.film_siren_mlp_bwd(*voxel_inputs, g)
    plain = tfs.film_siren_mlp_folded_vjp(*voxel_inputs, g)
    torch.cuda.synchronize()
    assert tfs.film_siren_mlp_bwd.launches == before + 1
    assert out[0].shape == (B, N, 32)
    for k, p in zip(out, plain):
        assert k.shape == p.shape and torch.isfinite(k).all()
        assert ((k - p).norm() / p.norm()).item() < norm_tol


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


@pytest.mark.parametrize("din", tfs.KERNEL_INS)
@pytest.mark.parametrize("B", EDGE_B)
@pytest.mark.parametrize("N", EDGE_N)
def test_bwd_kernel_at_tile_edges(din, B, N):
    """K2 against the plain VJP at freq/30, and two launches bitwise equal,
    at Din 3 (L 4) and Din 32 (L 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    args, g = edge_inputs(B, N, din, seed=N + B)
    before = tfs.film_siren_mlp_bwd.launches
    out = tfs.film_siren_mlp_bwd(*args, g)
    again = tfs.film_siren_mlp_bwd(*args, g)
    plain = tfs.film_siren_mlp_folded_vjp(*args, g)
    torch.cuda.synchronize()
    assert tfs.film_siren_mlp_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    for k, p in zip(out, plain):
        assert k.shape == p.shape and torch.isfinite(k).all()
        # as test_bwd_kernel_matches_plain_vjp (Din 3) and
        # test_bwd_kernel_din32_matches_plain_vjp (Din 32) at freq/30
        assert ((k - p).norm() / p.norm()).item() < (2e-3 if din == 3 else 1e-2)


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


@pytest.mark.parametrize("C", [32, 16, 12])
@pytest.mark.parametrize("n", [1, 1001, 40_000])
def test_trilinear_index_paths_bit_equal_at_ragged_n(volume_coords, C, n):
    """Both index paths (the short one at C 32, the generic one at another
    width) give the plain version's bits at ragged N."""
    vol, _ = volume_coords
    vol = vol[..., :C].contiguous()
    rng = np.random.default_rng(n)
    coords = torch.from_numpy(rng.uniform(-1.3, 1.3, (2, n, 3)).astype(np.float32)).cuda()
    out = ttri.trilinear_fwd(vol, coords)
    plain = tgs.border_trilerp_reference(vol, coords)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


def test_trilinear_volume_past_32_bit_offsets():
    """A C 32 volume past 2^31 floats (1040 x 256^2 x 32, 8.7 GB): a point
    with z above 0.971 has its corner rows past 2^31 floats, beyond the short
    index path's 32-bit offsets, so both kernels must take the generic path
    and sample and scatter the plain version's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(8)
    vol = torch.randn(1, 1040, 256, 256, 32, device="cuda", generator=gen)
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1.3, 1.3, (1, 4001, 3))
    pts[..., 2] = rng.uniform(0.0, 1.3, 4001)  # z -> D: a quarter of them past 2^31 floats
    coords = torch.from_numpy(pts.astype(np.float32)).cuda()
    out = ttri.trilinear_fwd(vol, coords)
    plain = tgs.border_trilerp_reference(vol, coords)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    g = torch.from_numpy(rng.normal(0, 1, (1, 4001, 32)).astype(np.float32)).cuda()
    dvol = torch.zeros_like(vol)
    dcoords = ttri.trilinear_bwd(vol, coords, g, dvol, need_coords=True)
    pvol, pcoords = tgs.border_trilerp_vjp_reference(vol, coords, g, True)
    torch.cuda.synchronize()
    # as test_trilinear_bwd_matches_plain, dV compared a 1 GiB slice at a time
    err = max((a - b).abs().max().item() for a, b in zip(dvol.view(-1).split(2 ** 28),
                                                          pvol.view(-1).split(2 ** 28)))
    assert err <= 1e-5 * pvol.abs().max().item() and pvol.abs().max().item() > 0
    assert (dcoords - pcoords).abs().max().item() <= 1e-5 * pcoords.abs().max().item()


def _border_coords(n, seed):
    """A third inside the cube, a third outside it (the border clamp), a third
    with one coordinate exactly on a face."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (2, n, 3))
    third = n // 3
    pts[:, :third] = rng.uniform(-1.5, 1.5, (2, third, 3))
    axis = rng.integers(0, 3, (2, third))
    rows = pts[:, third:2 * third]
    np.put_along_axis(rows, axis[..., None], rng.choice([-1.0, 1.0], (2, third, 1)), axis=-1)
    return torch.from_numpy(pts.astype(np.float32)).cuda()


@pytest.mark.parametrize("points,C", [("ragged", 32), ("border", 32), ("ragged", 16)])
def test_trilinear_bwd_matches_plain(volume_coords, points, C):
    """dV and dcoords against `border_trilerp_vjp_reference` on the card, at
    C 32 and C 16 (dcoords: the short index path and the generic one): dV is
    the same weighted corner rows, pre-summed per tile and added by atomics
    into a zeroed buffer in another order (the plain `index_add_` sums with
    atomics too), dcoords the same products summed over channels in another
    order."""
    vol, coords = volume_coords
    vol = vol[..., :C].contiguous()
    if points == "ragged":
        coords = coords[:, :1001].contiguous()
    else:
        coords = _border_coords(3000, seed=5)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (2, coords.shape[1], C)).astype(np.float32)).cuda()
    before = ttri.trilinear_bwd.launches
    dvol = torch.zeros_like(vol)
    dcoords = ttri.trilinear_bwd(vol, coords, g, dvol, need_coords=True)
    pvol, pcoords = tgs.border_trilerp_vjp_reference(vol, coords, g, True)
    torch.cuda.synchronize()
    assert ttri.trilinear_bwd.launches == before + 1
    assert dcoords.shape == coords.shape
    # a few points per voxel: fp32 sums of a few terms in another order
    assert (dvol - pvol).abs().max().item() <= 1e-5 * pvol.abs().max().item()
    assert (dcoords - pcoords).abs().max().item() <= 1e-5 * pcoords.abs().max().item()
    only_volume = torch.zeros_like(vol)
    assert ttri.trilinear_bwd(vol, coords, g, only_volume) is None
    assert (only_volume - pvol).abs().max().item() <= 1e-5 * pvol.abs().max().item()
    assert ttri.trilinear_bwd(vol, coords, g, None, need_coords=True).shape == coords.shape


def _cell_coords(n, seed):
    """n points inside one cell of the fixture's 16 x 12 x 20 volume: every
    point of a tile adds into the same 8 rows."""
    rng = np.random.default_rng(seed)
    cell = rng.uniform(0.1, 0.9, (1, n, 3)) + np.array([7, 5, 9])  # (x, y, z) voxels
    pts = (2 * cell + 1) / np.array([20, 12, 16]) - 1
    return torch.from_numpy(np.concatenate([pts, pts[:, ::-1]]).astype(np.float32)).cuda()


def _ray_coords(rays, samples, seed):
    """`samples` samples of `rays` rays from 2 cameras, ray-major as the
    generator lays them out, normalized for a volume in the +-0.6 cube:
    (2, rays * samples, 3)."""
    from conditioned_nerf_gan_torch.ops.rays import (
        create_cam2world_matrix,
        get_initial_rays,
        sample_camera_positions,
        transform_rays,
    )

    u = torch.from_numpy(np.random.default_rng(seed).uniform(0.1, 0.9, (2, 3))
                         .astype(np.float32))
    cams = create_cam2world_matrix(sample_camera_positions(
        2, cam_r_start=0.7, cam_r_end=1.5, uniforms=u))
    points, z_vals, rays_d = get_initial_rays(2, samples, 49.134342641202636, (16, rays // 16),
                                              0.25, 1.95)
    points = transform_rays(points, z_vals, rays_d, cams)[0]
    return (points.reshape(2, -1, 3) / 0.6).contiguous().cuda()


@pytest.mark.parametrize("points,C", [
    ("one cell", 32), ("border", 32), ("rays", 32), ("ragged", 32), ("ragged", 16),
    ("ragged", 12)])
def test_trilinear_bwd_adds_into_a_nonzero_buffer(volume_coords, points, C):
    """dV added into a buffer that holds a seeded volume: every voxel is
    within k_v fp32 roundings of its sum of |terms| (the buffer's value and
    its k_v contributions, summed in fp64 with the plain roundings of each
    contribution), as chip_smoke.py holds it. Crowded sets (every point in
    one cell; a third of the points outside the cube or on its faces),
    ray-ordered samples (208 rays of 48, a ragged last tile), ragged N
    (1001), and C 16 and 12."""
    vol, coords = volume_coords
    vol = vol[..., :C].contiguous()
    coords = {"one cell": lambda: _cell_coords(3000, seed=9),
              "border": lambda: _border_coords(3000, seed=5),
              "rays": lambda: _ray_coords(208, 48, seed=10),
              "ragged": lambda: coords[:, :1001].contiguous()}[points]()
    N = coords.shape[1]
    g = torch.from_numpy(np.random.default_rng(11).normal(0, 1, (2, N, C))
                         .astype(np.float32)).cuda()
    start = torch.from_numpy(np.random.default_rng(12).normal(0, 1, tuple(vol.shape))
                             .astype(np.float32)).cuda()
    dvol = start.clone()
    before = ttri.trilinear_bwd.launches
    assert ttri.trilinear_bwd(vol, coords, g, dvol) is None
    torch.cuda.synchronize()
    assert ttri.trilinear_bwd.launches == before + 1
    rows, parts = tgs.corner_contributions(vol, coords, g)
    exact = start.double().reshape(-1, C).index_add(0, rows, parts.double())
    magnitude = start.double().abs().reshape(-1, C).index_add(0, rows, parts.double().abs())
    count = torch.ones(exact.shape[0], dtype=torch.float64, device="cuda")
    count.index_add_(0, rows, (parts != 0).any(-1).double())
    err = (dvol.double().reshape(-1, C) - exact).abs()
    assert bool((err <= count[:, None] * 2.0 ** -24 * magnitude).all())
    assert (exact - start.double().reshape(-1, C)).abs().max().item() > 0


def test_trilinear_bwd_refuses_buffers_it_cannot_add_into(volume_coords):
    vol, coords = volume_coords
    g = torch.zeros(*coords.shape[:2], 32, device="cuda")
    with pytest.raises(ValueError, match="shape"):
        ttri.trilinear_bwd(vol, coords, g, torch.zeros_like(vol)[:1])
    with pytest.raises(TypeError, match="float32"):
        ttri.trilinear_bwd(vol, coords, g, torch.zeros_like(vol).double())
    with pytest.raises(ValueError, match="is on cpu"):
        ttri.trilinear_bwd(vol, coords, g, torch.zeros(vol.shape))
    with pytest.raises(ValueError, match="contiguous"):
        ttri.trilinear_bwd(vol, coords, g, torch.zeros(*vol.shape[:-1], 64,
                                                       device="cuda")[..., ::2])
    with pytest.raises(ValueError, match="16-byte"):
        ttri.trilinear_bwd(vol, coords, g, torch.zeros(vol.numel() + 1, device="cuda")[1:]
                           .view(vol.shape))


def test_c1_cuda_volume_that_needs_grad_gets_the_backward_kernel(volume_coords):
    """A CUDA volume that needs grad gets a result with a grad_fn (the
    `TrilinearSample` Function, on the volume's own `VolumeGrad` buffer),
    and its grad is the plain backward's."""
    vol, coords = volume_coords
    vol = vol.clone().requires_grad_()
    fwd, bwd = tgs.trilinear_point_features.launches, ttri.trilinear_bwd.launches
    out = tgs.trilinear_point_features(vol, coords)
    assert out.grad_fn is not None and "TrilinearSample" in type(out.grad_fn).__name__
    g = torch.from_numpy(np.random.default_rng(7).normal(0, 1, tuple(out.shape))
                         .astype(np.float32)).cuda()
    out.backward(g)
    torch.cuda.synchronize()
    assert (tgs.trilinear_point_features.launches, ttri.trilinear_bwd.launches) == (fwd + 1,
                                                                                  bwd + 1)
    plain, _ = tgs.border_trilerp_vjp_reference(vol.detach(), coords, g, False)
    assert (vol.grad - plain).abs().max().item() <= 1e-5 * plain.abs().max().item()


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


# every instance the study launches, and every mode at 128 points per CTA, at
# a small N and a ragged one (a tile of each, v5's half tiles, the tail)
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
    # point-major tiles are wgmma's M, 64 points a warpgroup: no 32
    with pytest.raises(ValueError, match="no instance of v3 single at 32 points"):
        tstudy.film_siren_study(*args, kernel="v3", mode="single", tile=32)


def _stage0_inputs(freq_scale):
    """Seeded Din 3 inputs at the thesis stage 0's shape: batch 24, 32^2
    rays of 48 samples, unchunked."""
    rng = np.random.default_rng(24)
    B, N, H, L = 24, 32 * 32 * 48, tfs.KERNEL_HIDDEN, 4
    arrays = (
        rng.uniform(-0.3, 0.3, (B, N, 3)),
        rng.uniform(25, 45, (B, L * H)) * freq_scale,
        rng.uniform(-1, 1, (B, L * H)),
        rng.normal(0, 0.5, (3, H)),
        rng.normal(0, 0.1, (H,)),
        rng.normal(0, 1.0, (L - 1, H, H)) * np.sqrt(6 / H) / 30,
        rng.normal(0, 0.1, (L - 1, H)),
        rng.normal(0, 0.1, (H, 4)),
        rng.normal(0, 0.1, (4,)),
    )
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]


@pytest.mark.parametrize("freq_scale", [1.0 / 30.0, 1.0])
def test_kernels_at_the_stage0_shape(freq_scale):
    """K1 and K2 at 24 x 49,152 points against their plain versions, with
    chip_smoke's phase 1 and 4 bounds: at freq/30 K1's max within 3e-3 and
    K2's norm-relative error within 2e-3; at freq 25-45 (where a flipped
    bf16 rounding grows ~2x a layer) K1's mean within 3e-4 and K2's norm
    within 3e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = _stage0_inputs(freq_scale)
    g = torch.from_numpy(np.random.default_rng(25).normal(
        0, 1, (*inputs[0].shape[:2], 4)).astype(np.float32)).cuda()
    with torch.no_grad():
        err = (tfs.film_siren_mlp(*inputs) - tfs.film_siren_mlp_folded(*inputs)).abs()
    if freq_scale < 1:
        assert err.max().item() < 3e-3
    else:
        assert torch.isfinite(err).all() and err.mean().item() < 3e-4
    out = tfs.film_siren_mlp_bwd(*inputs, g)
    plain = tfs.film_siren_mlp_folded_vjp(*inputs, g)
    torch.cuda.synchronize()
    for k, p in zip(out, plain):
        assert k.shape == p.shape and torch.isfinite(k).all()
        assert ((k - p).norm() / p.norm()).item() < (2e-3 if freq_scale < 1 else 3e-3)


def test_one_trainer_step_on_the_card(tmp_path):
    """The Trainer on the card: the thesis model (full width, the kernels'
    policy) at a small stage 0 (batch 2 at 16^2, unchunked) on the port's
    fixture written on the card. One step launches K1 for the D step's
    render and the G step's (coarse and fine: 4) and K2 for the G step's
    backward (2), and leaves a checkpoint."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import types

    from conditioned_nerf_gan_torch.config import curriculum_to_json, load_curriculum
    from conditioned_nerf_gan_torch.data.synthetic import make_synthetic_shapenet
    from conditioned_nerf_gan_torch.training.trainer import Trainer

    ds = make_synthetic_shapenet(tmp_path / "data", n_cars=2, n_views=3, img_size=32,
                                 n_points=512, voxel_resolutions=(32,), device="cuda")
    cur = load_curriculum(config_base="thousand")
    cur[0].update(batch_size=2, img_size=16, num_steps=12)
    cur["dataset"]["path"] = str(ds)
    out = tmp_path / "run"
    out.mkdir()
    curriculum_to_json(cur, out / "curriculum.json")
    args = types.SimpleNamespace(output_dir=str(out), load_dir="", load_curriculum="",
                                 sampling_interval=100, print_freq=100, eval_freq=100,
                                 n_epochs=1, stop_step=0, config=None, config_base="thousand",
                                 seed=0, profile_dir=None, device="cuda")
    trainer = Trainer(args)
    trainer.load_models()
    before = (tfs.film_siren_mlp.launches, tfs.film_siren_mlp_bwd.launches)
    trainer.train()
    torch.cuda.synchronize()
    assert (tfs.film_siren_mlp.launches - before[0],
            tfs.film_siren_mlp_bwd.launches - before[1]) == (4, 2)
    assert (out / "checkpoints" / "0.pt").exists()
    assert np.isfinite(trainer.histories["photometry_losses"]).all()


# ---------------------------------------------------------------------------
# no host wait on the stream inside a render, a train step or a request
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def thesis_bench():
    """The thesis preset at stage 2 (its widths, the kernels' policy) cut
    to batch 2 at 16^2, 6 + 6 samples in 4 ray chunks, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from conditioned_nerf_gan_torch.training import build_stage_bench

    bench = build_stage_bench("thousand", stage=2, meta_overrides=dict(
        batch_size=2, img_size=16, num_steps=6, ray_chunks=4))
    for net in (bench.generator, bench.encoder, bench.discriminator):
        net.cuda()
    batch = {k: torch.from_numpy(v).cuda() for k, v in bench.batch.items()}
    return bench, batch


def _without_waits(run):
    """Run `run` once to build and warm every kernel and shape, then once
    under `torch.cuda.set_sync_debug_mode("error")`, where any call that
    makes the host wait for the device raises, on autograd's backward
    thread too. Returns the copy counters' moves in the second run:
    (staged, waited)."""
    from conditioned_nerf_gan_torch.utils import tracing

    run()
    torch.cuda.synchronize()
    staged, waited = tracing.h2d_staged, tracing.h2d_waited
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return tracing.h2d_staged - staged, tracing.h2d_waited - waited


def test_a_render_and_its_backward_never_wait(thesis_bench):
    from conditioned_nerf_gan_torch.models.pointnet import encode_pcl

    bench, batch = thesis_bench
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run():
        z, _ = encode_pcl(bench.encoder, batch["pcl"])
        img, depth = bench.generator(z, batch["cam2world"], bench.config.render,
                                     generator=gen, nerf_noise=bench.nerf_noise)
        (img.square().mean() + depth.mean()).backward()

    assert _without_waits(run) == (0, 0)


def test_a_train_step_never_waits(thesis_bench):
    from conditioned_nerf_gan_torch.training import create_train_state, make_train_step

    bench, batch = thesis_bench
    state = create_train_state(bench.generator, bench.encoder, bench.discriminator,
                               bench.config)
    step = make_train_step(bench.config)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def run():
        step(state, batch, gen, bench.alpha, bench.nerf_noise)

    assert _without_waits(run) == (0, 0)


def test_a_request_never_waits(tmp_path):
    """`Inferencer.encode` then `generate_img` from numpy clouds and
    cameras: two copies staged in pinned memory, none that waits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from conditioned_nerf_gan_torch.infer.inference import (
        Inferencer,
        build_models,
        load_metadata,
        save_checkpoint,
    )

    G, E = build_models(load_metadata(30000), generator=torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(tmp_path / "checkpoints" / "30000.pt", 30000, G, E)
    inf = Inferencer(ckpt, load_dataset=False, device="cuda", num_imgs=2, image_size=16)
    inf.curriculum.update(num_steps=6, ray_chunks=4)
    rng = np.random.default_rng(2)
    pcl = rng.uniform(-0.4, 0.4, (2, 4096, 6)).astype(np.float32)
    from conditioned_nerf_gan_torch.ops import create_cam2world_matrix, sample_camera_positions

    cams = create_cam2world_matrix(sample_camera_positions(
        2, cam_r_start=0.7, cam_r_end=1.5, uniforms=torch.from_numpy(
            rng.uniform(0.1, 0.9, (2, 3)).astype(np.float32)))).numpy()

    def run():
        inf.generate_img(inf.encode({"pcl": pcl}), cams)

    assert _without_waits(run) == (2, 0)


@pytest.mark.parametrize("fov", [49.13, np.array([30.0, 49.13, 75.0], np.float32)],
                         ids=["number", "per_image"])
def test_rays_of_a_host_fov_equal_those_of_the_fov_on_the_card(fov):
    """A number filled in on the card, or an array copied without a wait,
    gives the rays of the same fov copied with `torch.as_tensor` (the
    earlier formulation: a tensor on the card takes that path unchanged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from conditioned_nerf_gan_torch.ops import pixel_rays

    copied = torch.as_tensor(fov, dtype=torch.float32, device="cuda")
    for rows in ({}, dict(row_offset=5, full_height=32)):
        got = pixel_rays(fov, 32, 8, device="cuda", **rows)
        want = pixel_rays(copied, 32, 8, device="cuda", **rows)
        assert torch.equal(got, want)


def test_transmittance_grads_on_the_card_bit_equal_to_torch_cumprod(monkeypatch):
    """The render's integrate at a training chunk's shape (12 x 1,024 rays
    of 96 samples): its grads without torch's test for zeros in the
    cumprod equal torch.cumprod's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from conditioned_nerf_gan_torch.ops import integration, volume_integrate

    gen = torch.Generator(device="cuda").manual_seed(3)
    B, R, S = 12, 1024, 96
    rgb_sigma = torch.randn((B, R, S, 4), generator=gen, device="cuda") * 3
    rgb_sigma[0, :64, S // 2:, 3] = 1e4
    z = torch.sort(torch.rand((B, R, S, 1), generator=gen, device="cuda"), dim=2)[0] + 0.7
    g = [torch.randn(s, generator=gen, device="cuda")
         for s in ((B, R, 3), (B, R, 1), (B, R, S, 1))]

    def grads():
        x = rgb_sigma.clone().requires_grad_()
        outs = volume_integrate(x, z, white_back=True)
        sum((o * gi).sum() for o, gi in zip(outs, g)).backward()
        return outs, x.grad

    outs, grad = grads()
    monkeypatch.setattr(integration, "cumprod_of_nonzeros", torch.cumprod)
    outs_before, grad_before = grads()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(outs, outs_before))
    assert torch.isfinite(grad).all() and torch.equal(grad, grad_before)


# ---------------------------------------------------------------------------
# ray chunks that keep their activations, at the thesis G step's shapes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def thesis_stage2():
    """The thesis preset at stage 2, uncut (batch 12, 128^2, 48 + 48
    samples in 16 ray chunks, 65,536-point clouds), on the card, with a
    function that runs its G render: the clouds encoded, the images
    rendered from the step's seeded stream and a loss on them backed up
    into G and E."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from conditioned_nerf_gan_torch.models.pointnet import encode_pcl
    from conditioned_nerf_gan_torch.training import build_stage_bench

    bench = build_stage_bench("thousand", stage=2)
    assert (bench.meta["batch_size"], bench.config.render.img_size,
            bench.config.render.num_steps, bench.config.render.ray_chunks) == (12, 128, 48, 16)
    for net in (bench.generator, bench.encoder, bench.discriminator):
        net.cuda()
    batch = {k: torch.from_numpy(v).cuda() for k, v in bench.batch.items()}

    def g_render():
        z, _ = encode_pcl(bench.encoder, batch["pcl"])
        gen = torch.Generator(device="cuda").manual_seed(4)
        img, depth = bench.generator(z, batch["cam2world"], bench.config.render,
                                     generator=gen, nerf_noise=bench.nerf_noise)
        (img.square().mean() + depth.mean()).backward()

    return bench, g_render


def _grads_and_peak(bench, g_render):
    """Run `g_render` from cleared grads -> (every G and E grad, the rise of
    the allocator's peak over what was allocated before it)."""
    nets = (bench.generator, bench.encoder)
    for net in nets:
        net.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g_render()
    torch.cuda.synchronize()
    grads = {f"{i}/{n}": p.grad.clone() for i, net in enumerate(nets)
             for n, p in net.named_parameters() if p.grad is not None}
    return grads, torch.cuda.max_memory_allocated() - base


def test_kept_chunks_match_the_replay_at_the_thesis_shapes(thesis_stage2, monkeypatch):
    """The 16 chunks of the thesis G render keep their activations on an
    80 GB card (16 kept, none replayed); their grads equal, bit for bit,
    those of the same render with chunks 1-15 replayed in the backward
    (no room handed in), and they raise the peak over the replay's by at
    most 1.25 x 15 x the bytes chunk 0 retained."""
    from conditioned_nerf_gan_torch.models import generator as generator_module
    from conditioned_nerf_gan_torch.utils import tracing

    bench, g_render = thesis_stage2
    g_render()  # build and warm every kernel and shape
    readings = []
    allocated = generator_module.allocated_bytes

    def read(device):
        readings.append(allocated(device))
        return readings[-1]

    monkeypatch.setattr(generator_module, "allocated_bytes", read)
    counts = tracing.chunks_kept, tracing.chunks_replayed
    kept, kept_peak = _grads_and_peak(bench, g_render)
    assert (tracing.chunks_kept - counts[0], tracing.chunks_replayed - counts[1]) == (16, 0)
    chunk0 = readings[1] - readings[0]
    monkeypatch.setattr(generator_module, "activation_room", lambda device: 0)
    counts = tracing.chunks_kept, tracing.chunks_replayed
    replayed, replay_peak = _grads_and_peak(bench, g_render)
    assert (tracing.chunks_kept - counts[0], tracing.chunks_replayed - counts[1]) == (1, 15)
    assert kept.keys() == replayed.keys() and len(kept) > 0
    for name in kept:
        assert torch.equal(kept[name], replayed[name]), name
    assert chunk0 > 0
    assert 0 < kept_peak - replay_peak <= 1.25 * 15 * chunk0, (kept_peak, replay_peak, chunk0)


def test_a_g_render_at_the_thesis_shapes_never_waits(thesis_stage2):
    _, g_render = thesis_stage2
    assert _without_waits(g_render) == (0, 0)


def test_the_room_is_read_without_waiting_for_the_stream():
    """`activation_room` reads the card's free memory while the stream is
    busy (about half a second of `torch.cuda._sleep` queued) and returns
    long before the stream drains."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    from conditioned_nerf_gan_torch.models.generator import activation_room

    device = torch.device("cuda", torch.cuda.current_device())
    activation_room(device)
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(1_000_000_000)
    done.record()
    t0 = time.perf_counter()
    room = activation_room(device)
    took = time.perf_counter() - t0
    busy = not done.query()
    torch.cuda.synchronize()
    assert busy and took < 0.05, took
    assert 0 < room < torch.cuda.get_device_properties(device).total_memory
