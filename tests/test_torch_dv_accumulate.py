"""One dV a render, on the CPU: the feature volume's grad on the kernel
route, where `VolumeGrad` owns one buffer and every lookup's backward
(`TrilinearSample`) adds into it. The CUDA launches are stood in for by
plain versions: the forward by `border_trilerp_reference`, the backward by
the launcher's CPU branch, which adds the plain VJP into the buffer it is
given (spied on: each call's buffer and its contents as they came in).

The kernel itself (`csrc/trilinear_bwd.cu`, pre-summing the corner rows a
tile of points shares) runs only on a card: tests/test_torch_cuda.py
(marker `cuda`) skips here, and `python3 chip_smoke.py` holds it against
its plain version. Here `chip_smoke.presummed_contributions`, the plain
replica of its grouping with which chip_smoke.py counts the reductions the
kernel issues, is held against the plain VJP.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
import conditioned_nerf_gan_torch.models.generator as generator_module
from conditioned_nerf_gan_tpu.ops import grid_sample as jgs
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig, make_unet
from conditioned_nerf_gan_torch.ops import grid_sample as tgs
from conditioned_nerf_gan_torch.ops.kernels import trilinear as ttri
from conditioned_nerf_gan_torch.ops.rays import (
    create_cam2world_matrix,
    get_initial_rays,
    sample_camera_positions,
    transform_rays,
)
from conditioned_nerf_gan_torch.training import (
    build_stage_bench,
    create_train_state,
    make_train_step,
)
from test_torch_train import _chunk_memory
from test_torch_voxel import _trilerp_inputs, _voxels

UNET = dict(in_channels=4, out_channels=8, f_maps=8, num_levels=3, return_global=True)
GLOBAL, FEAT, H = 32, 8, 32  # the U-Net's global width (8 * 2^2), C, SIREN width
RENDER = dict(img_size=16, num_steps=6, fov=49.134342641202636, ray_start=0.25,
              ray_end=1.95, hierarchical_sample=True, white_back=True, perturb=True,
              density_noise=True)


def _kernel_route(monkeypatch) -> list:
    """Put CPU tensors on the kernel route with both launches stood in for;
    returns the list the backward stand-in records its calls in."""
    calls = []

    def bwd(volume, coords, g, dvol, need_coords):
        calls.append(dict(ptr=dvol.data_ptr(), before=dvol.clone(),
                          args=(volume.detach().clone(), coords.detach().clone(),
                                g.detach().clone())))
        return ttri.trilinear_bwd(volume, coords, g, dvol, need_coords)

    monkeypatch.setattr(tgs, "_takes_kernels", lambda t: True)
    monkeypatch.setattr(tgs, "trilinear_fwd", tgs.border_trilerp_reference)
    monkeypatch.setattr(tgs, "trilinear_bwd", bwd)
    return calls


def _plain_dv(volume, coords, g):
    return tgs.border_trilerp_vjp_reference(volume, coords, g, False)[0]


def _check_one_buffer(calls):
    """The calls went into one buffer, zeroed before the first and never
    again: each found the sum of the plain VJPs before it. Returns the
    buffer's final contents."""
    assert len({c["ptr"] for c in calls}) == 1
    expect = torch.zeros_like(calls[0]["before"])
    for c in calls:
        assert torch.equal(c["before"], expect)
        expect = expect + _plain_dv(*c["args"])
    return expect


def test_two_lookups_add_into_one_buffer(monkeypatch):
    """Two lookups of one volume: their scatters go into one buffer, and the
    volume's grad is the sum of two fresh plain VJPs, and JAX's VJP of the
    two lookups."""
    calls = _kernel_route(monkeypatch)
    vol, c1 = _trilerp_inputs(seed=30)
    c2 = _trilerp_inputs(seed=31)[1]
    rng = np.random.default_rng(32)
    g1, g2 = (rng.normal(size=(*c1.shape[:2], vol.shape[-1])).astype(np.float32)
              for _ in range(2))
    v = torch.from_numpy(vol).requires_grad_()
    shared = tgs.one_volume_grad(v)
    assert shared is not v and tgs.one_volume_grad(shared) is shared
    out1 = tgs.trilinear_point_features(shared, torch.from_numpy(c1))
    out2 = tgs.trilinear_point_features(shared, torch.from_numpy(c2))
    ((out1 * torch.from_numpy(g1)).sum() + (out2 * torch.from_numpy(g2)).sum()).backward()
    assert len(calls) == 2
    assert torch.equal(v.grad, _check_one_buffer(calls))
    fresh = (_plain_dv(torch.from_numpy(vol), torch.from_numpy(c), torch.from_numpy(g))
             for c, g in ((c1, g1), (c2, g2)))
    ref = sum(fresh)
    # the same fp32 contributions, one sum in another order
    torch.testing.assert_close(v.grad, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))

    def j_loss(volume):
        return sum(jnp.sum(jgs.trilinear_point_features(volume, jnp.asarray(c)) * g)
                   for c, g in ((c1, g1), (c2, g2)))

    j_grad = np.asarray(jax.grad(j_loss)(jnp.asarray(vol)))
    # JAX's dV takes its one-hot P and Q in bf16 (as in
    # test_trilerp_vjp_matches_jax)
    np.testing.assert_allclose(v.grad.numpy(), j_grad, rtol=0, atol=1e-2 * np.abs(j_grad).max())


def _models(seed):
    gen = torch.Generator().manual_seed(seed)
    tenc = make_unet(**UNET, generator=gen)
    tgen = ImplicitGenerator3d(siren_type="TALLSIREN_dg", z_dim=GLOBAL, input_dim=FEAT,
                               hidden_dim=H, generator=gen)
    with torch.no_grad():  # a 10x head: sigma of both signs, not all background
        tgen.siren.final_layer.weight.mul_(10.0)
    u = torch.from_numpy(np.random.default_rng(seed).uniform(0.1, 0.9, (2, 3))
                         .astype(np.float32))
    cams = create_cam2world_matrix(sample_camera_positions(
        2, cam_r_start=0.7, cam_r_end=1.5, uniforms=u))
    return tenc, tgen, torch.from_numpy(_voxels(seed)), cams


def _render_grads(tenc, tgen, vox, cams, chunks, renders=1):
    """Encode, `renders` renders of the volume in `chunks` ray chunks (the
    same random numbers each), a weighted sum of pixels and depth, backward;
    returns the volume's grad and every parameter's."""
    for p in (*tenc.parameters(), *tgen.parameters()):
        p.grad = None
    volume, glob = tenc(vox)
    volume.retain_grad()
    loss = 0.0
    for _ in range(renders):
        pix, depth = tgen((volume, glob), cams, RenderConfig(**RENDER, ray_chunks=chunks),
                          generator=torch.Generator().manual_seed(33), nerf_noise=0.5)
        rng = np.random.default_rng(34)
        loss = (loss + (pix * torch.from_numpy(rng.normal(size=pix.shape).astype(np.float32))).sum()
                + (depth * torch.from_numpy(rng.normal(size=depth.shape).astype(np.float32))).sum())
    loss.backward()
    return volume.grad, {n: p.grad.clone() for n, p in
                         (*tenc.named_parameters(prefix="E"), *tgen.named_parameters(prefix="G"))}


@pytest.mark.parametrize("renders", [1, 2])
def test_chunked_render_takes_one_buffer_a_render(renders, monkeypatch):
    """A `dg` render in 4 ray chunks, chunks 1-3 under checkpoint (no room
    handed in), on the kernel route: every lookup's scatter (coarse and fine
    in each chunk, never in a replay) goes into the render's one buffer,
    zeroed once; the volume's grad and every parameter's equal
    the unchunked render's under plain autograd. Two renders of one volume
    keep a buffer each."""
    tenc, tgen, vox, cams = _models(seed=35)
    ref_vol, ref = _render_grads(tenc, tgen, vox, cams, chunks=0, renders=renders)
    _chunk_memory(monkeypatch, 4, keep=False)
    calls = _kernel_route(monkeypatch)
    got_vol, got = _render_grads(tenc, tgen, vox, cams, chunks=4, renders=renders)
    per_render = 2 * 4  # coarse and fine lookups in each of 4 chunks
    assert len(calls) == renders * per_render
    by_buffer = {}
    for c in calls:
        by_buffer.setdefault(c["ptr"], []).append(c)
    assert sorted(len(v) for v in by_buffer.values()) == [per_render] * renders
    total = sum(_check_one_buffer(v) for v in by_buffer.values())
    torch.testing.assert_close(got_vol, total, rtol=1e-6, atol=0)
    # the chunked render evaluates the same math on slices of the rays; the
    # SIREN's products and the U-Net's sums take another order (observed
    # below 1e-6 of each tensor's largest grad)
    torch.testing.assert_close(got_vol, ref_vol, rtol=1e-5,
                               atol=1e-5 * float(ref_vol.abs().max()))
    assert ref_vol.abs().max() > 0
    for name, g in ref.items():
        torch.testing.assert_close(got[name], g, rtol=1e-5, atol=1e-5 * float(g.abs().max()),
                                   msg=name)


def test_dg_dis_step_puts_each_g_render_through_once(monkeypatch):
    """A small `dg_shortsiren_dis` step on the kernel route: the D step's
    render runs without grad and makes no buffer; each G render makes one
    (one `VolumeGrad` a batch split) that all its lookups add into; the
    step's grads equal the same step's under plain autograd."""
    small = dict(batch_size=2, img_size=16, num_steps=6, ray_chunks=4, voxel_resolution=16)
    bench = build_stage_bench("dg_shortsiren_dis", stage=2, meta_overrides=small)
    cfg = bench.config
    batch = {k: torch.from_numpy(v) for k, v in bench.batch.items()}

    def step(state):
        grads = {}
        for net in ("G", "E", "D"):
            opt = getattr(state, f"opt_{net}")
            inner = opt.step

            def recording(*a, _net=net, _opt=opt, _inner=inner, **k):
                grads[_net] = torch.cat([
                    (torch.zeros_like(p) if p.grad is None else p.grad).flatten()
                    for group in _opt.param_groups for p in group["params"]])
                return _inner(*a, **k)

            opt.step = recording
        _, metrics = make_train_step(cfg)(state, batch, torch.Generator().manual_seed(36),
                                          bench.alpha, bench.nerf_noise)
        return grads, metrics

    state = create_train_state(bench.generator, bench.encoder, bench.discriminator, cfg)
    plain_grads, plain_metrics = step(copy.deepcopy(state))
    calls = _kernel_route(monkeypatch)
    wrapped = []

    def counting(volume):
        out = tgs.one_volume_grad(volume)
        wrapped.append(out is not volume)
        return out

    monkeypatch.setattr(generator_module, "one_volume_grad", counting)
    grads, metrics = step(state)
    splits, chunks = cfg.batch_split, cfg.render.ray_chunks
    assert wrapped.count(True) == splits and wrapped.count(False) == 1  # D's render: no grad
    assert len(calls) == splits * 2 * chunks
    for name, value in plain_metrics.items():
        torch.testing.assert_close(metrics[name], value, rtol=1e-5, atol=1e-7, msg=name)
    for net, g in plain_grads.items():
        # a dV summed once in another order (observed ~1e-7 relative)
        assert ((grads[net] - g).norm() / g.norm()).item() < 1e-5, net
    assert plain_grads["E"].abs().max() > 0


def _ray_coords(samples: int, seed: int) -> torch.Tensor:
    """The samples of a 20 x 15 render (300 rays, ray-major as the generator
    lays them out) from 2 cameras, normalized for a volume in the +-0.6
    cube: (2, 300 * samples, 3)."""
    u = torch.from_numpy(np.random.default_rng(seed).uniform(0.1, 0.9, (2, 3))
                         .astype(np.float32))
    cams = create_cam2world_matrix(sample_camera_positions(
        2, cam_r_start=0.7, cam_r_end=1.5, uniforms=u))
    points, z_vals, rays_d = get_initial_rays(2, samples, 49.134342641202636, (20, 15),
                                              0.25, 1.95)
    points = transform_rays(points, z_vals, rays_d, cams)[0]
    return (points.reshape(2, -1, 3) / 0.6).contiguous()


@pytest.mark.parametrize("S", [1, 6, 7, 48])
def test_presum_grouping_replica_gives_the_plain_dv(S):
    """The kernel's grouping in plain torch (tiles of 256 consecutive
    points), on ray-ordered samples of a render whose 300 rays of S samples
    leave a ragged last tile: the pre-sums add up to the plain VJP's dV
    within fp32 order."""
    coords = _ray_coords(S, seed=37)
    N = coords.shape[1]
    assert N == 300 * S and N % chip_smoke.PRESUM_TILE
    rng = np.random.default_rng(38)
    vol = torch.from_numpy(rng.normal(size=(2, 16, 16, 16, 8)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, N, 8)).astype(np.float32))
    rows, sums = chip_smoke.presummed_contributions(vol, coords, g)
    flat = torch.zeros(vol.numel() // 8, 8).index_add_(0, rows, sums)
    plain = _plain_dv(vol, coords, g).reshape(-1, 8)
    torch.testing.assert_close(flat, plain, rtol=0, atol=1e-6 * float(plain.abs().max()))
    # one sum a (tile, distinct row): no more than the live pairs, no fewer
    # than the distinct rows
    _, weights = tgs.corner_contributions(vol[..., :1], coords, torch.ones(2, N, 1))
    assert torch.unique(rows).numel() <= rows.numel() <= int((weights != 0).sum())


@pytest.mark.parametrize("case,error,match", [
    ("shape", ValueError, "shape"),
    ("dtype", TypeError, "float32"),
    ("device", ValueError, "is on meta"),
    ("strided", ValueError, "contiguous"),
    ("misaligned", ValueError, "16-byte"),
])
def test_dv_buffer_checks_refuse(case, error, match):
    """The launcher refuses a buffer it cannot add into, on any device (here
    the CPU branch)."""
    vol, coords = (torch.from_numpy(a) for a in _trilerp_inputs(seed=39))
    g = torch.ones(*coords.shape[:2], vol.shape[-1])
    dvol = torch.zeros_like(vol)
    if case == "shape":
        dvol = dvol[:1]
    elif case == "dtype":
        dvol = dvol.double()
    elif case == "device":
        dvol = dvol.to("meta")
    elif case == "strided":
        dvol = torch.zeros(*vol.shape[:-1], 2 * vol.shape[-1])[..., ::2]
    else:
        dvol = torch.zeros(vol.numel() + 1)[1:].view(vol.shape)
    with pytest.raises(error, match=match):
        ttri.trilinear_bwd(vol, coords, g, dvol)
