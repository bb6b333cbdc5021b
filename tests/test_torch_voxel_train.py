"""The voxel family's train step (`dg`: UNet3D + TALLSIREN_FG) on the CPU,
against the JAX package: the trilinear sampler's VJP, the FiLM-SIREN VJP at
the family's width (Din 32, L 8), the U-Net's grads and one whole train
step, with and without the discriminator. Weights cross through
`conditioned_nerf_gan_torch.bridge`; inputs come from seeded numpy; renders
are deterministic (JAX rng=None, port generator=None).

The CUDA kernels of the slice (K1 and K2 at Din 32, the trilinear forward
and backward) run only on a card: tests/test_torch_cuda.py (marker `cuda`)
skips here, and `python3 chip_smoke.py` holds them against these plain
versions at the main path's shapes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import make_discriminator as j_make_discriminator
from conditioned_nerf_gan_tpu.models import make_unet as j_make_unet
from conditioned_nerf_gan_tpu.ops import grid_sample as jgs
from conditioned_nerf_gan_tpu.training import train_step as jts
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
from conditioned_nerf_gan_torch.models import make_discriminator, make_unet
from conditioned_nerf_gan_torch.ops import grid_sample as tgs
from conditioned_nerf_gan_torch.ops.kernels import trilinear as ttri
from conditioned_nerf_gan_torch.training import (
    TrainStepConfig,
    build_stage_bench,
    create_train_state,
    make_train_step,
)
from test_torch_train import _DeterministicGenerator, _cams, _record_jax_grads
from test_torch_voxel import _trilerp_inputs, _voxels

UNET = dict(in_channels=4, out_channels=8, f_maps=8, num_levels=3, return_global=True)
GLOBAL, FEAT, H = 32, 8, 32  # the U-Net's global width (8 * 2^2), C, SIREN width
POLICY_J = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True, use_pallas=True)
POLICY_T = dict(compute_dtype=torch.bfloat16, use_fast_sin=True, use_kernel=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("strategy", ["expanded_slab", "block_gather"])
def test_trilerp_vjp_matches_jax(strategy, monkeypatch):
    """The plain VJP against jax.vjp of the JAX op (its custom VJP), with
    points outside the cube, on its faces and on the sample centres where
    the anchor shifts."""
    if strategy == "block_gather":
        monkeypatch.setattr(jgs, "_EXPAND_MAX_ELEMS", 0)
    vol, coords = _trilerp_inputs(seed=11)
    g = np.random.default_rng(12).normal(size=(*coords.shape[:2], vol.shape[-1]))
    g = g.astype(np.float32)
    _, vjp = jax.vjp(jgs.trilinear_point_features, jnp.asarray(vol), jnp.asarray(coords))
    j_vol, j_coords = vjp(jnp.asarray(g))
    t_vol, t_coords = tgs.border_trilerp_vjp_reference(
        torch.from_numpy(vol), torch.from_numpy(coords), torch.from_numpy(g), True)
    # dcoords: the same fp32 products, summed in another order (observed
    # 3.8e-6 of a max of 75 in both strategies)
    np.testing.assert_allclose(t_coords.numpy(), np.asarray(j_coords), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(j_coords)).max())
    # dV: the JAX one-hot matmuls take P and Q in bf16, the port sums fp32
    # products (observed 3.3e-3 of the largest grad, ~one bf16 step)
    np.testing.assert_allclose(t_vol.numpy(), np.asarray(j_vol), rtol=0,
                               atol=1e-2 * np.abs(np.asarray(j_vol)).max())


def test_trilerp_vjp_matches_autograd_of_the_forward():
    """The plain VJP against torch autograd of `border_trilerp_reference`:
    the same weighted corner rows (dV) and the same cotangent math
    (dcoords, with the inclusive clip and size / 2), in fp32."""
    vol, coords = (torch.from_numpy(a) for a in _trilerp_inputs(seed=13))
    g = torch.from_numpy(np.random.default_rng(14).normal(
        size=(*coords.shape[:2], vol.shape[-1])).astype(np.float32))
    v, c = vol.clone().requires_grad_(), coords.clone().requires_grad_()
    a_vol, a_coords = torch.autograd.grad(tgs.border_trilerp_reference(v, c), (v, c), g)
    p_vol, p_coords = tgs.border_trilerp_vjp_reference(vol, coords, g, True)
    # fp32 sums of the same products in another order (observed 1.2e-7 of
    # dV's max 4.5, 3.8e-6 of dcoords' max 75)
    torch.testing.assert_close(p_vol, a_vol, rtol=0, atol=1e-6 * float(a_vol.abs().max()))
    torch.testing.assert_close(p_coords, a_coords, rtol=0,
                               atol=1e-6 * float(a_coords.abs().max()))
    dvol, none = tgs.border_trilerp_vjp_reference(vol, coords, g, need_coords=False)
    assert none is None and torch.equal(dvol, p_vol)


def test_trilinear_sample_routes_forward_and_backward(monkeypatch):
    """`TrilinearSample` with its two kernel launches stood in for by their
    plain versions: the forward saves the volume and coordinates and counts
    a launch, the backward hands the (strided) cotangent to the backward
    launcher with the buffer of the volume's `VolumeGrad` node (the
    volume's grad), and asks for dcoords only when the coordinates need
    grad."""
    seen = []

    def fwd(volume, coords):
        seen.append("forward")
        return tgs.border_trilerp_reference(volume, coords)

    def bwd(volume, coords, g, dvol, need_coords):
        seen.append((g.shape, dvol is not None, need_coords))
        dv, dcoords = tgs.border_trilerp_vjp_reference(volume, coords, g, need_coords)
        dvol.add_(dv)
        return dcoords

    monkeypatch.setattr(tgs, "trilinear_fwd", fwd)
    monkeypatch.setattr(tgs, "trilinear_bwd", bwd)
    vol, coords = (torch.from_numpy(a) for a in _trilerp_inputs(seed=15))
    for coords_grad in (False, True):
        v = vol.clone().requires_grad_()
        c = coords.clone().requires_grad_(coords_grad)
        before = tgs.trilinear_point_features.launches
        out = tgs.TrilinearSample.apply(tgs.VolumeGrad.apply(v), c)
        assert tgs.trilinear_point_features.launches == before + 1 and seen[-1] == "forward"
        out[..., 1].sum().backward()  # the cotangent is an expanded, strided view
        g = torch.zeros_like(out)
        g[..., 1] = 1.0
        ref_vol, ref_coords = tgs.border_trilerp_vjp_reference(vol, coords, g, True)
        assert seen[-1] == (out.shape, True, coords_grad)
        torch.testing.assert_close(v.grad, ref_vol, rtol=0, atol=0)
        if coords_grad:
            torch.testing.assert_close(c.grad, ref_coords, rtol=0, atol=0)
        else:
            assert c.grad is None
    # a volume that needs grad and has no VolumeGrad node has no buffer to go to
    out = tgs.TrilinearSample.apply(vol.clone().requires_grad_(), coords)
    with pytest.raises(RuntimeError, match="one_volume_grad"):
        out.sum().backward()


def test_trilinear_bwd_on_cpu_takes_the_plain_vjp_without_launch():
    """On the CPU the launcher adds the plain VJP's dV into the caller's
    buffer and returns the plain dcoords, with no launch."""
    vol, coords = (torch.from_numpy(a) for a in _trilerp_inputs(seed=16))
    g = torch.ones(*coords.shape[:2], vol.shape[-1])
    before = ttri.trilinear_bwd.launches
    start = torch.from_numpy(np.random.default_rng(16).normal(size=vol.shape)
                             .astype(np.float32))
    dvol = start.clone()
    dcoords = ttri.trilinear_bwd(vol, coords, g, dvol, need_coords=True)
    assert ttri.trilinear_bwd.launches == before
    ref_vol, ref_coords = tgs.border_trilerp_vjp_reference(vol, coords, g, True)
    assert torch.equal(dvol, start + ref_vol) and torch.equal(dcoords, ref_coords)
    assert ttri.trilinear_bwd(vol, coords, g, dvol) is None


def test_cpu_volume_that_needs_grad_trains_by_plain_autograd():
    """On the CPU the wrapper takes the plain forward under plain autograd:
    the volume's grad is the plain VJP's."""
    vol, coords = (torch.from_numpy(a) for a in _trilerp_inputs(seed=17))
    v = vol.clone().requires_grad_()
    out = tgs.trilinear_point_features(v, coords)
    assert out.grad_fn is not None and "TrilinearSample" not in type(out.grad_fn).__name__
    g = torch.ones_like(out)
    out.backward(g)
    ref, _ = tgs.border_trilerp_vjp_reference(vol, coords, g, False)
    torch.testing.assert_close(v.grad, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))


def test_unet3d_grads_match_jax():
    """jax.grad of a weighted sum of both U-Net outputs against torch
    autograd, f_maps 8, 3 levels, 16^3."""
    vox = _voxels(seed=18)
    jenc = j_make_unet(**UNET)
    params = jenc.init(jax.random.PRNGKey(18), jnp.asarray(vox))
    rng = np.random.default_rng(19)
    wv = rng.normal(size=(2, 16, 16, 16, UNET["out_channels"])).astype(np.float32)
    wg = rng.normal(size=(2, GLOBAL)).astype(np.float32)

    def j_loss(p):
        vol, glob = jenc.apply(p, jnp.asarray(vox))
        return jnp.sum(vol * wv) + jnp.sum(glob * wg)

    j_grads = jax.jit(jax.grad(j_loss))(params)
    tenc = make_unet(**UNET)
    tenc.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    vol, glob = tenc(torch.from_numpy(vox))
    ((vol * torch.from_numpy(wv)).sum() + (glob * torch.from_numpy(wg)).sum()).backward()
    ref = bridge.params_to_state_dict(_np_tree(j_grads))
    names = dict(tenc.named_parameters())
    assert set(ref) == set(names)
    for name, g in ref.items():
        t = names[name].grad
        # fp32 convs and GroupNorm statistics taken another way on each side,
        # 10 norms deep (observed 2.1e-5 of each parameter's largest grad)
        np.testing.assert_allclose(t.numpy(), g.numpy(), rtol=0,
                                   atol=1e-3 * float(g.abs().max()), err_msg=name)


def _voxel_step_models(seed, discriminator):
    """The JAX and port modules of a smoke-size `dg` step: UNet3D f_maps 8,
    3 levels on 16^3 grids, TALLSIREN_FG 32 wide under the kernel policy,
    and the progressive discriminator when it is on."""
    jgen = JGenerator(siren_type="TALLSIREN_dg", z_dim=GLOBAL, input_dim=FEAT, hidden_dim=H,
                      **POLICY_J)
    jenc = j_make_unet(**UNET)
    jdisc = j_make_discriminator("ProgressiveDiscriminator") if discriminator else None
    tgen = ImplicitGenerator3d(siren_type="TALLSIREN_dg", z_dim=GLOBAL, input_dim=FEAT,
                               hidden_dim=H, **POLICY_T)
    tenc = make_unet(**UNET)
    tdisc = make_discriminator("ProgressiveDiscriminator") if discriminator else None
    return (jgen, jenc, jdisc), (tgen, tenc, tdisc)


@pytest.mark.parametrize("preset", ["dg", "dg_dis"])
def test_voxel_train_step_matches_jax(preset, monkeypatch):
    """One `dg` (and `dg_dis`: the discriminator on, with R1) step against
    JAX `make_train_step` from the same weights and batch: 16^3 grids, 16^2,
    6 + 6 samples, 4 ray chunks, batch_split 2 with grad_accum_scale 3.
    Deterministic renders (random_gen_img off)."""
    discriminator = preset == "dg_dis"
    cfg = dict(img_size=16, num_steps=6, fov=49.134342641202636, ray_start=0.25,
               ray_end=1.95, hierarchical_sample=True, white_back=True, ray_chunks=4,
               perturb=True, density_noise=False)
    step_kwargs = dict(
        batch_split=2, enable_discriminator=discriminator, photo_loss=True,
        load_voxel=True, load_pcl=False, random_gen_img=False, noise_weight=0.0,
        r1_lambda=10.0, grad_clip=1.0, z_reg_weight=0.01, grad_accum_scale=3.0,
        gen_lr=1e-4, disc_lr=2e-4, enc_lr=5e-5, betas=(0.0, 0.9), weight_decay=1e-3,
        mapping_lr_mult=0.5)
    jcfg = jts.TrainStepConfig(render=JRenderConfig(**cfg), **step_kwargs)
    tcfg = TrainStepConfig(render=RenderConfig(**cfg), **step_kwargs)
    B = 4
    rng = np.random.default_rng(20)
    batch = {
        "img": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
        "cam2world": _cams(B, seed=21).numpy(),
        "voxel": np.concatenate([_voxels(seed=22), _voxels(seed=23)]),
    }

    (jgen, jenc, jdisc), (tgen, tenc, tdisc) = _voxel_step_models(24, discriminator)
    wrapped_gen = _DeterministicGenerator(jgen)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jts.create_train_state(jax.random.PRNGKey(25), wrapped_gen, jenc, jdisc,
                                   j_batch, jcfg)
    # a 10x head: sigma of both signs, so the render is not all background
    head = state.params_G["params"]["siren"]["final_layer"]
    head["kernel"] = head["kernel"] * 10.0  # Adam's moments start at zero whatever it is
    nets = {"G": (tgen, state.params_G), "E": (tenc, state.params_E)}
    if discriminator:
        nets["D"] = (tdisc, state.params_D)
    for module, params in nets.values():
        module.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))

    j_recorded = _record_jax_grads(monkeypatch)
    j_step = jax.jit(jts.make_train_step(wrapped_gen, jenc, jdisc, jcfg))
    _, j_metrics = j_step(state, j_batch, jax.random.PRNGKey(26), jnp.float32(0.5),
                          jnp.float32(0.0))
    jax.effects_barrier()

    t_state = create_train_state(tgen, tenc, tdisc, tcfg)
    t_recorded = _record_port_grads(t_state)
    t_state, t_metrics = make_train_step(tcfg)(
        t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, 0.5, 0.0)

    # losses: fp32 on both sides; the U-Net's fp32 noise (~3e-5 of the
    # volume, GroupNorm) reaches D's logits (observed 2.3e-5 relative)
    names = ("g_loss", "photo_loss", "z_reg") + (("d_loss",) if discriminator else ())
    for name in names:
        np.testing.assert_allclose(t_metrics[name].item(), float(j_metrics[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    assert float(t_metrics["photo_loss"]) > 0.0
    # per-net grads before the clip, norm-relative and elementwise against
    # the largest grad. G: fp32 on both sides (observed 6.0e-4, 6.5e-4). D:
    # R1's double backward on renders that carry the U-Nets' fp32 noise
    # (observed 2.6e-3, 7.9e-3). E: its grads come back through the
    # sampler's dV, which the JAX package forms from bf16 one-hot matmuls
    # and the port sums in fp32, so E is held at bf16 tolerance (observed
    # 1.1e-2, 1.2e-2)
    tols = {"G": (2e-3, 1e-2), "D": (1e-2, 3e-2), "E": (3e-2, 3e-2)}
    for net in nets:
        ref = bridge.params_to_state_dict(_np_tree(j_recorded[net]))
        assert set(ref) == set(t_recorded[net])
        norm_tol, max_tol = tols[net]
        for name, g in ref.items():
            t, g = t_recorded[net][name].numpy(), g.numpy()
            assert np.linalg.norm(t - g) <= norm_tol * np.linalg.norm(g) + 1e-12, f"{net} {name}"
            np.testing.assert_allclose(t, g, rtol=0, atol=max_tol * np.abs(g).max() + 1e-12,
                                       err_msg=f"{net} {name}")
    # the U-Net trained through the sampler: its grads are not zero
    assert any(np.abs(g.numpy()).max() > 0 for g in t_recorded["E"].values())


def _record_port_grads(state):
    """Wrap the port's optimizers' step (D's where there is one) to keep the
    incoming grads."""
    recorded = {}
    for net, module in (("G", state.generator), ("E", state.encoder),
                        ("D", state.discriminator)):
        if module is None:
            continue
        opt = getattr(state, f"opt_{net}")
        step = opt.step

        def recording(*args, _net=net, _module=module, _step=step, **kwargs):
            recorded[_net] = {n: (p.grad.clone() if p.grad is not None
                                  else torch.zeros_like(p))
                              for n, p in _module.named_parameters()}
            return _step(*args, **kwargs)

        opt.step = recording
    return recorded


def test_make_train_step_takes_voxels_and_refuses_conditional_discriminators():
    """The voxel step builds, and with `cond_mode` (a conditional D, ROADMAP
    A13, held against JAX in tests/test_torch_cond_dis.py) it builds too;
    a step without a conditioning source still raises."""
    render = RenderConfig(img_size=8, num_steps=4)
    make_train_step(TrainStepConfig(render=render, load_voxel=True, load_pcl=False))
    assert callable(make_train_step(TrainStepConfig(render=render, load_voxel=True,
                                                    load_pcl=False, cond_mode=True)))
    with pytest.raises(ValueError, match="load_pcl or load_voxel"):
        make_train_step(TrainStepConfig(render=render, load_voxel=False, load_pcl=False))


def test_stage_bench_is_the_dg_stage_2_step():
    bench = build_stage_bench("dg", stage=2)
    cfg, r = bench.config, bench.config.render
    assert (cfg.load_voxel, cfg.load_pcl, cfg.enable_discriminator) == (True, False, False)
    assert bench.discriminator is None
    assert (r.img_size, r.num_steps, r.ray_chunks, r.hierarchical_sample) == (128, 48, 16,
                                                                              True)
    assert (cfg.batch_split, cfg.grad_accum_scale) == (1, 6)
    shapes = {k: v.shape for k, v in bench.batch.items()}
    assert shapes == {"img": (12, 128, 128, 3), "cam2world": (12, 4, 4),
                      "voxel": (12, 64, 64, 64, 4)}
    occupied = bench.batch["voxel"][..., 0]
    assert set(np.unique(occupied)) == {0.0, 1.0} and 0.001 < occupied.mean() < 0.05
    siren = bench.generator.siren
    assert len(siren.film_layers) == 8 and siren.film_layers[0].linear.weight.shape == (256, 32)
    assert siren.routes_to_kernel(torch.zeros(1, 2 * 8 * 256))
    assert bench.encoder.final_conv.weight.shape[0] == 32
    # the other U-Nets build too (their steps: test_torch_voxel_variants_train.py)
    assert not hasattr(make_unet("PyramidUNet3D", **UNET), "final_conv")
    assert len(make_unet("ResidualUNet3D", **UNET).upconvs) == UNET["num_levels"] - 1


@pytest.mark.parametrize("preset", ["dg", "dg_shortsiren_dis"])
def test_stage_bench_voxel_step_runs_on_cpu(preset):
    """chip_smoke.py's voxel training path on the CPU at a small size: two
    steps from one seeded generator are finite and move every net, the
    U-Net through the sampler's backward."""
    small = dict(batch_size=2, img_size=16, num_steps=6, ray_chunks=4, voxel_resolution=16)
    bench = build_stage_bench(preset, stage=2, meta_overrides=small)
    nets = [n for n in (bench.generator, bench.encoder, bench.discriminator) if n is not None]
    assert len(nets) == (3 if preset.endswith("_dis") else 2)
    before = [[p.detach().clone() for p in net.parameters()] for net in nets]
    state = create_train_state(bench.generator, bench.encoder, bench.discriminator,
                               bench.config)
    step = make_train_step(bench.config)
    batch = {k: torch.from_numpy(v) for k, v in bench.batch.items()}
    rng = torch.Generator().manual_seed(27)
    for _ in range(2):
        state, metrics = step(state, batch, rng, bench.alpha, bench.nerf_noise)
    assert all(np.isfinite(v.item()) for v in metrics.values())
    for net, old in zip(nets, before):
        assert any((p.detach() != q).any() for p, q in zip(net.parameters(), old))
