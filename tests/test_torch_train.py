"""The port's training slice vs the JAX package, on the CPU: SIREN and
generator gradients, the progressive discriminator and R1, losses,
schedules, the optimizer chains and one whole GAN train step. Weights cross
through `conditioned_nerf_gan_torch.bridge`; inputs come from seeded numpy;
renders are deterministic (JAX rng=None, port generator=None)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from conditioned_nerf_gan_tpu.config import extract_metadata, load_curriculum
from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import ResnetPointnet as JPointnet
from conditioned_nerf_gan_tpu.models import make_discriminator as j_make_discriminator
from conditioned_nerf_gan_tpu.training import losses as jlosses
from conditioned_nerf_gan_tpu.training import schedules as jschedules
from conditioned_nerf_gan_tpu.training import train_step as jts
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
from conditioned_nerf_gan_torch.models import ResnetPointnet, make_discriminator
from conditioned_nerf_gan_torch.training import (
    TrainStepConfig,
    build_stage_bench,
    create_train_state,
    fade_alpha,
    losses,
    make_optimizer,
    make_train_step,
    nerf_noise_schedule,
)

Z, H = 16, 32
# the thesis policy: on the CPU both wrappers take the fp32 reference
POLICY_J = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True, use_pallas=True)
POLICY_T = dict(compute_dtype=torch.bfloat16, use_fast_sin=True, use_kernel=True)
CFG = dict(img_size=16, num_steps=12, fov=49.134342641202636, ray_start=0.25,
           ray_end=1.95, hierarchical_sample=True, white_back=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _generators(seed=0):
    jgen = JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H, **POLICY_J)
    params = jgen.init(jax.random.PRNGKey(seed), jnp.zeros((1, Z)), jnp.eye(4)[None],
                       JRenderConfig(img_size=4, num_steps=4))
    tgen = ImplicitGenerator3d(z_dim=Z, hidden_dim=H, **POLICY_T)
    tgen.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    return jgen, params, tgen


def _discriminators(img=16, seed=0):
    jdisc = j_make_discriminator("ProgressiveDiscriminator")
    params = jdisc.init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 3)), 1.0)
    tdisc = make_discriminator("ProgressiveDiscriminator")
    tdisc.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    return jdisc, params, tdisc


def _cams(n, seed):
    from conditioned_nerf_gan_torch.ops import create_cam2world_matrix, sample_camera_positions

    u = torch.from_numpy(np.random.default_rng(seed).uniform(0.1, 0.9, (n, 3))
                         .astype(np.float32))
    return create_cam2world_matrix(sample_camera_positions(
        n, cam_r_start=0.7, cam_r_end=1.5, uniforms=u))


def _assert_grads_match(t_module, j_grads, rtol, atol_frac=0.0):
    """Each port grad against the JAX grad of the same bridged parameter:
    within rtol plus atol_frac of that parameter's largest JAX grad."""
    ref = bridge.params_to_state_dict(_np_tree(j_grads))
    names = dict(t_module.named_parameters())
    assert set(ref) == set(names)
    for name, g in ref.items():
        t = names[name].grad
        t = torch.zeros_like(g) if t is None else t
        np.testing.assert_allclose(t.numpy(), g.numpy(), rtol=rtol,
                                   atol=atol_frac * float(g.abs().max()) + 1e-12,
                                   err_msg=name)


def test_siren_grads_match_jax():
    """SHORTSIREN under the thesis policy: the port's CPU autograd path (the
    fp32 reference) against jax.grad through the JAX kernel wrapper's VJP."""
    jgen, params, tgen = _generators(seed=1)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.5, 0.5, (2, 40, 3)).astype(np.float32)
    z = rng.normal(size=(2, Z)).astype(np.float32)
    w = rng.normal(size=(2, 40, 4)).astype(np.float32)

    def j_loss(p):
        return jnp.sum(jgen.apply(p, jnp.asarray(pts), jnp.asarray(z),
                                  method="eval_points") * w)

    j_grads = jax.grad(j_loss)(params)
    (tgen.siren(torch.from_numpy(pts), torch.from_numpy(z)) * torch.from_numpy(w)).sum(
    ).backward()
    # fp32 on both sides; freq 30 +- 15 grows summation-order noise through
    # the layers (observed 4.9e-6 of each parameter's largest grad)
    _assert_grads_match(tgen, j_grads, rtol=1e-4, atol_frac=5e-5)


@pytest.mark.parametrize("chunks", [0, 4], ids=["whole", "ray_chunks"])
def test_generator_grads_match_jax(chunks):
    """Gradients of a weighted sum of pixels and depth, deterministic render
    (hierarchical, white background). With ray_chunks 4 the port checkpoints
    each chunk and recomputes it in the backward."""
    jgen, params, tgen = _generators(seed=3)
    rng = np.random.default_rng(4)
    z = rng.normal(size=(2, Z)).astype(np.float32)
    wp = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    wd = rng.normal(size=(2, 16, 16)).astype(np.float32)
    cams = _cams(2, seed=5)
    jcfg = JRenderConfig(ray_chunks=chunks, perturb=False, **CFG)

    def j_loss(p):
        pix, depth = jgen.apply(p, jnp.asarray(z), jnp.asarray(cams.numpy()), jcfg,
                                rng=None)
        return jnp.sum(pix * wp) + jnp.sum(depth * wd)

    j_grads = jax.jit(jax.grad(j_loss))(params)
    pix, depth = tgen(torch.from_numpy(z), cams,
                      RenderConfig(ray_chunks=chunks, perturb=False, **CFG))
    ((pix * torch.from_numpy(wp)).sum() + (depth * torch.from_numpy(wd)).sum()).backward()
    # fp32 on both sides through sample_pdf (detached), the stable merge and
    # the integrator (observed 7.2e-6 of each parameter's largest grad)
    _assert_grads_match(tgen, j_grads, rtol=1e-3, atol_frac=2e-4)


def test_chunked_grads_equal_unchunked_under_seeded_generator():
    """The checkpoint-RNG trap: a torch.Generator is not replayed by
    torch.utils.checkpoint, so a chunk's recompute must not draw. The render
    draws every random number (perturbation, fine-sample uniforms, density
    noise) for the whole image up front, so ray_chunks 4 gives the
    unchunked render and gradient under the same seed."""
    _, _, tgen = _generators(seed=6)
    z = torch.from_numpy(np.random.default_rng(7).normal(size=(2, Z)).astype(np.float32))
    cams = _cams(2, seed=8)
    results = []
    for chunks in (0, 4):
        tgen.zero_grad(set_to_none=True)
        zz = z.clone().requires_grad_()
        pix, depth = tgen(zz, cams, RenderConfig(ray_chunks=chunks, **CFG),
                          generator=torch.Generator().manual_seed(11), nerf_noise=0.5)
        (pix.square().sum() + depth.square().sum()).backward()
        results.append((pix.detach(), zz.grad,
                        {n: p.grad.clone() for n, p in tgen.named_parameters()}))
    (pix0, dz0, g0), (pix4, dz4, g4) = results
    # the same numbers, the grads summed per chunk (observed up to 5.4e-7 of
    # each tensor's largest value)
    torch.testing.assert_close(pix4, pix0, rtol=0, atol=1e-6)
    torch.testing.assert_close(dz4, dz0, rtol=1e-5, atol=1e-6 * float(dz0.abs().max()))
    for name in g0:
        torch.testing.assert_close(g4[name], g0[name], rtol=1e-5,
                                   atol=1e-5 * float(g0[name].abs().max()))


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_discriminator_logits_match_jax(alpha):
    jdisc, params, tdisc = _discriminators(seed=9)
    img = np.random.default_rng(10).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
    j = jdisc.apply(params, jnp.asarray(img), alpha)
    with torch.no_grad():
        t = tdisc(torch.from_numpy(img), alpha)
    assert t.shape == (3, 1)
    # fp32 convolutions on both sides (observed 3.0e-8)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)


def test_r1_penalty_and_grads_match_jax():
    """R1 on real images: the penalty and its parameter grads (a double
    backward through D) against the JAX fp32 module."""
    jdisc, params, tdisc = _discriminators(seed=12)
    img = np.random.default_rng(13).normal(size=(2, 16, 16, 3)).astype(np.float32)

    def j_loss(p):
        return jlosses.r1_penalty(
            lambda pp, i, a, cond: jdisc.apply(pp, i, a, cond=cond), p,
            jnp.asarray(img), 0.5)

    j_value, j_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    real = torch.from_numpy(img).requires_grad_()
    value = losses.r1_penalty(tdisc(real, 0.5), real)
    value.backward()
    # fp32 on both sides (observed up to 8.7e-7 of the penalty and of each
    # parameter's largest grad)
    np.testing.assert_allclose(value.item(), float(j_value), rtol=1e-5)
    _assert_grads_match(tdisc, j_grads, rtol=1e-4, atol_frac=1e-4)


def test_losses_and_schedules_match_jax():
    rng = np.random.default_rng(14)
    a, b = (rng.normal(size=(4, 1)).astype(np.float32) for _ in range(2))
    img, gen = (rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    gt = rng.uniform(0.5, 1.5, (2, 8, 8)).astype(np.float32)
    gt[:, :3] = 0.0  # background pixels
    pred = rng.uniform(0.5, 1.5, (2, 8, 8)).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (losses.gan_g_loss(t(a)), jlosses.gan_g_loss(a)),
        (losses.gan_d_loss(t(a), t(b)), jlosses.gan_d_loss(a, b)),
        (losses.photometric_loss(t(img), t(gen)), jlosses.photometric_loss(img, gen)),
        (losses.depth_loss(t(gt), t(pred)), jlosses.depth_loss(gt, pred)),
        (losses.depth_loss(t(gt * 0), t(pred)), jlosses.depth_loss(gt * 0, pred)),
    ]
    for port, ref in pairs:
        np.testing.assert_allclose(port.item(), float(ref), rtol=1e-6)
    for step in (0, 1000, 5000, 16000):
        assert nerf_noise_schedule(step) == pytest.approx(
            float(jschedules.nerf_noise_schedule(step)))
        assert fade_alpha(step, 15000, 2000) == pytest.approx(
            float(jschedules.fade_alpha(step, 15000, 2000)))


def test_bridge_maps_conv_kernels_and_refuses_3d():
    _, params, tdisc = _discriminators(seed=15)
    sd = bridge.params_to_state_dict(_np_tree(params))
    kernel = np.asarray(params["params"]["layer_2"]["conv1"]["kernel"])  # HWIO
    np.testing.assert_array_equal(sd["layers.2.conv1.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))
    assert sd["final_layer.weight"].shape == tdisc.final_layer.weight.shape
    with pytest.raises(NotImplementedError, match="A12"):
        bridge.params_to_state_dict({"conv3d": {"kernel": np.zeros((3, 3, 3, 4, 8))}})


def test_make_discriminator_refuses_unported_variants():
    with pytest.raises(NotImplementedError, match="A13"):
        make_discriminator("ProgressiveEncoderDiscriminator")
    with pytest.raises(ValueError, match="Unknown"):
        make_discriminator("NoSuchDiscriminator")


def test_train_step_config_matches_jax():
    meta = extract_metadata(load_curriculum(config_base="thousand"), 16000)
    port = dataclasses.asdict(TrainStepConfig.from_metadata(meta))
    ref = dataclasses.asdict(jts.TrainStepConfig.from_metadata(meta))
    ref.pop("remat")
    ref["render"].pop("save_siren_outputs")
    assert port == ref


def test_optimizer_chain_matches_optax():
    """Clip the global norm, coupled weight decay, Adam betas (0, 0.9), and
    the mapping network's lr multiplier, for two steps (the first clipped,
    the second not) against the JAX package's optax chain."""
    rng = np.random.default_rng(16)
    shapes = {"mapping_network": (5, 3), "film": (4, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (3.0, 0.01)]
    tx = jts.make_optimizer(1e-2, (0.0, 0.9), weight_decay=0.1, grad_clip=1.0,
                            lr_mult_mask=jts.mapping_network_mask, lr_mult=0.5)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(j_params)
    module = torch.nn.Module()
    module.mapping_network = torch.nn.Parameter(torch.from_numpy(params["mapping_network"]))
    module.film = torch.nn.Parameter(torch.from_numpy(params["film"]))
    opt = make_optimizer(module, 1e-2, (0.0, 0.9), weight_decay=0.1, grad_clip=1.0,
                         lr_mult=0.5)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(g[name].copy())
        opt.step()
        for name, p in module.named_parameters():
            # the same fp32 formulas (observed 0)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[name]),
                                       rtol=0, atol=1e-7, err_msg=name)


class _DeterministicGenerator:
    """The JAX generator with rng=None whatever key the train step passes:
    the JAX step's renders become deterministic, as the port's are with
    generator=None. Only the wrapper is new; the JAX package is unchanged."""

    def __init__(self, gen):
        self.gen = gen
        self.z_dim = gen.z_dim

    def init(self, *args, **kwargs):
        return self.gen.init(*args, **kwargs)

    def apply(self, params, z, cams, config, rng=None, **kwargs):
        return self.gen.apply(params, z, cams, config, rng=None, **kwargs)


def _record_jax_grads(monkeypatch):
    """Wrap the JAX step's three optax chains so each update hands its
    incoming (pre-clip) grads to the host; returns {net: grads}."""
    recorded = {}
    make_txs = jts._make_txs

    def wrapped(config):
        out = []
        for net, tx in zip("GED", make_txs(config)):
            def update(grads, state, params=None, _tx=tx, _net=net):
                jax.debug.callback(lambda g, _n=_net: recorded.__setitem__(_n, g), grads)
                return _tx.update(grads, state, params)
            out.append(optax.GradientTransformation(tx.init, update))
        return tuple(out)

    monkeypatch.setattr(jts, "_make_txs", wrapped)
    return recorded


def _record_port_grads(state):
    """Wrap the port's three optimizers' step to keep the incoming grads."""
    recorded = {}
    for net in "GED":
        opt = getattr(state, f"opt_{net}")
        module = {"G": state.generator, "E": state.encoder, "D": state.discriminator}[net]
        step = opt.step

        def recording(*args, _net=net, _module=module, _step=step, **kwargs):
            recorded[_net] = {n: (p.grad.clone() if p.grad is not None
                                  else torch.zeros_like(p))
                              for n, p in _module.named_parameters()}
            return _step(*args, **kwargs)

        opt.step = recording
    return recorded


def test_full_train_step_matches_jax(monkeypatch):
    """One D-then-G/E step against JAX `make_train_step` from the same
    weights and batch: R1, fade-in alpha 0.5, batch_split 2 with
    grad_accum_scale 3, coupled weight decay, the mapping-network lr
    multiplier, 4 ray chunks. Deterministic renders (random_gen_img and
    noise_weight off)."""
    render = dict(CFG, ray_chunks=4, perturb=True, density_noise=False)
    step_kwargs = dict(
        batch_split=2, enable_discriminator=True, photo_loss=True, load_pcl=True,
        random_gen_img=False, noise_weight=0.0, r1_lambda=10.0, grad_clip=1.0,
        z_reg_weight=0.01, grad_accum_scale=3.0, gen_lr=1e-4, disc_lr=2e-4,
        enc_lr=5e-5, betas=(0.0, 0.9), weight_decay=1e-3, mapping_lr_mult=0.5)
    jcfg = jts.TrainStepConfig(render=JRenderConfig(**render), **step_kwargs)
    tcfg = TrainStepConfig(render=RenderConfig(**render), **step_kwargs)
    B, alpha = 4, 0.5
    rng = np.random.default_rng(17)
    batch = {
        "img": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
        "cam2world": _cams(B, seed=18).numpy(),
        "pcl": rng.uniform(-0.4, 0.4, (B, 64, 6)).astype(np.float32),
    }

    jgen = JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H, **POLICY_J)
    jenc = JPointnet(c_dim=Z, hidden_dim=16)
    jdisc = j_make_discriminator("ProgressiveDiscriminator")
    wrapped_gen = _DeterministicGenerator(jgen)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jts.create_train_state(jax.random.PRNGKey(19), wrapped_gen, jenc, jdisc,
                                   j_batch, jcfg)
    tgen = ImplicitGenerator3d(z_dim=Z, hidden_dim=H, **POLICY_T)
    tenc = ResnetPointnet(c_dim=Z, hidden_dim=16)
    tdisc = make_discriminator("ProgressiveDiscriminator")
    for module, params in ((tgen, state.params_G), (tenc, state.params_E),
                           (tdisc, state.params_D)):
        module.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))

    j_recorded = _record_jax_grads(monkeypatch)
    j_step = jax.jit(jts.make_train_step(wrapped_gen, jenc, jdisc, jcfg))
    j_state, j_metrics = j_step(state, j_batch, jax.random.PRNGKey(20),
                                jnp.float32(alpha), jnp.float32(0.0))
    jax.effects_barrier()

    t_state = create_train_state(tgen, tenc, tdisc, tcfg)
    t_recorded = _record_port_grads(t_state)
    t_state, t_metrics = make_train_step(tcfg)(
        t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, alpha, 0.0)
    assert t_state.step == 1

    # losses: fp32 on both sides (observed 1.8e-7 relative)
    for name in ("d_loss", "g_loss", "photo_loss", "z_reg"):
        np.testing.assert_allclose(t_metrics[name].item(), float(j_metrics[name]),
                                   rtol=1e-5, err_msg=name)
    # grads, before the clip, per parameter: fp32 renders, PointNet and R1's
    # double backward. Norm-relative (observed 2.5e-4) and elementwise
    # against the largest grad (observed 2.3e-3: a conv output at a leaky
    # relu kink switches R1's second-order path for one element)
    old_params = {"G": state.params_G, "E": state.params_E, "D": state.params_D}
    new_params = {"G": j_state.params_G, "E": j_state.params_E, "D": j_state.params_D}
    modules = {"G": tgen, "E": tenc, "D": tdisc}
    lrs = {"G": tcfg.gen_lr, "E": tcfg.enc_lr, "D": tcfg.disc_lr}
    for net in "GED":
        ref = bridge.params_to_state_dict(_np_tree(j_recorded[net]))
        assert set(ref) == set(t_recorded[net])
        for name, g in ref.items():
            t, g = t_recorded[net][name].numpy(), g.numpy()
            assert np.linalg.norm(t - g) <= 2e-3 * np.linalg.norm(g), f"{net} {name}"
            np.testing.assert_allclose(t, g, rtol=0, atol=1e-2 * np.abs(g).max() + 1e-12,
                                       err_msg=f"{net} {name}")
        # updated params: with beta1 = 0 the first Adam step moves each
        # parameter by lr * u / (|u| + 1e-8), u = clipped grad + wd * param:
        # ~lr * sign(u), well defined only where u is not near 0. Compare
        # there, to 1% of the step (observed 4.2e-4 of lr)
        norm = np.sqrt(sum(np.sum(g.numpy().astype(np.float64) ** 2) for g in ref.values()))
        clip = 1.0 if norm < tcfg.grad_clip else tcfg.grad_clip / norm
        old = bridge.params_to_state_dict(_np_tree(old_params[net]))
        new = bridge.params_to_state_dict(_np_tree(new_params[net]))
        for name, p in modules[net].named_parameters():
            u = clip * ref[name].numpy() + tcfg.weight_decay * old[name].numpy()
            where = np.abs(u) > 1e-2 * np.abs(u).max()
            assert where.any()
            np.testing.assert_allclose(p.detach().numpy()[where], new[name].numpy()[where],
                                       rtol=0, atol=1e-2 * lrs[net], err_msg=f"{net} {name}")


def test_stage_bench_train_step_runs_noisy_stage_0_on_cpu():
    """chip_smoke.py's training path on the CPU at a small size, at stage 0
    where the density noise is on and the D step draws random cameras: two
    steps from one seeded generator are finite, move all three nets, and
    repeat exactly from the same seed."""
    small = dict(batch_size=2, img_size=16, num_steps=6, ray_chunks=4,
                 num_points_ratio=1 / 1024)
    runs = []
    for _ in range(2):
        bench = build_stage_bench(stage=0, meta_overrides=small)
        assert bench.config.render.density_noise and bench.nerf_noise == 1.0
        nets = (bench.generator, bench.encoder, bench.discriminator)
        before = [[p.detach().clone() for p in net.parameters()] for net in nets]
        state = create_train_state(*nets, bench.config)
        step = make_train_step(bench.config)
        batch = {k: torch.from_numpy(v) for k, v in bench.batch.items()}
        rng = torch.Generator().manual_seed(21)
        for _ in range(2):
            state, metrics = step(state, batch, rng, bench.alpha, bench.nerf_noise)
        assert all(np.isfinite(v.item()) for v in metrics.values())
        for net, old in zip(nets, before):
            assert any((p.detach() != q).any() for p, q in zip(net.parameters(), old))
        runs.append(({k: v.item() for k, v in metrics.items()},
                     [p.detach() for p in bench.generator.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_stage_bench_is_the_thesis_stage_2_step():
    bench = build_stage_bench(stage=2, step=16000)
    cfg, r = bench.config, bench.config.render
    assert (bench.alpha, bench.nerf_noise, r.density_noise) == (0.5, 0.0, False)
    assert (r.img_size, r.num_steps, r.ray_chunks, r.hierarchical_sample) == (128, 48, 16,
                                                                              True)
    assert (cfg.r1_lambda, cfg.batch_split, cfg.grad_accum_scale) == (10, 1, 6)
    shapes = {k: v.shape for k, v in bench.batch.items()}
    assert shapes == {"img": (12, 128, 128, 3), "cam2world": (12, 4, 4),
                      "pcl": (12, 65536, 6)}
    assert bench.generator.siren.routes_to_kernel(torch.zeros(1, 2048))
    assert sum(p.numel() for p in bench.encoder.parameters()) > 4_000_000
    with pytest.raises(ValueError, match="outside stage"):
        build_stage_bench(stage=2, step=30000)
