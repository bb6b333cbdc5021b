"""The discriminators of the port against the JAX package's, on the CPU:
the four progressive ones (the plain, Encoder, InputCat and Projection D;
`check_discriminator` also serves the three legacy strided ones in
tests/test_torch_legacy_models.py) at 32^2 and 64^2, in fp32 and under the
presets' bf16 policy (logits, the heads of the Encoder variants, R1 and
every parameter's grad), and the conditional discriminator's train step
(the `cond` smoke preset's InputCat D and a Projection variant) against
JAX `make_train_step`.

The JAX params are the port's own weights written as a flax tree
(`_flax_tree`, the bridge's inverse), checked leaf for leaf against the
JAX module's `jax.eval_shape` init and carried back by
`bridge.params_to_state_dict`, so no JAX init is compiled. The batch is 4:
at 2 the Projection D's ResNet18 reaches its last stage at 1x1, where a
train-mode BatchNorm of two values is ill-conditioned (its grads there
differ by 8% between two fp32 formulations).

About 140 s of CPU alone: each (D, size, precision) compiles one JAX
loss-and-grad (3-10 s; the Projection D's ResNet18 the most), and the two
train steps one JAX step each (~27 s each).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import make_discriminator as j_make_discriminator
from conditioned_nerf_gan_tpu.models import make_unet as j_make_unet
from conditioned_nerf_gan_tpu.training import losses as jlosses
from conditioned_nerf_gan_tpu.training import train_step as jts
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
from conditioned_nerf_gan_torch.models import make_discriminator, make_unet
from conditioned_nerf_gan_torch.models.discriminators import DISCRIMINATOR_REGISTRY
from conditioned_nerf_gan_torch.training import (
    TrainStepConfig,
    build_stage_bench,
    create_train_state,
    losses,
    make_train_step,
)
from test_torch_precision import _fp32_sum_pool
from test_torch_train import _DeterministicGenerator, _cams, _record_jax_grads
from test_torch_voxel import _voxels
from test_torch_voxel_train import POLICY_J, POLICY_T, _record_port_grads

B = 4
# the JAX bf16 loss compiled to round where the module's source rounds:
# XLA's CPU backend otherwise keeps some bf16 results in fp32 (a bf16 conv
# read by the fp32 statistics of a BatchNorm, for one), which puts JAX's
# bf16 ResNet18 8% from the port's at 32^2 and 2.7% with this option
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
COND_SIDE = 32  # the Projection D's conditioning views (its ResNet18's input)
HEADED = ("ProgressiveEncoderDiscriminator", "CCSEncoderDiscriminator")


def _flax_tree(module: torch.nn.Module) -> dict:
    """The port module's state dict as the flax param tree the bridge maps
    from: `fromRGB.i` -> `fromRGB_i`, `layers.i` -> `layer_i`, an OIHW conv
    weight -> an HWIO `kernel`, a BatchNorm's weight -> `scale`, the
    ResNet18's `fc` -> `fc_kernel` (512, F) and `fc_bias`."""
    tree: dict = {}
    for name, value in module.state_dict().items():
        parts, leaf = name.split(".")[:-1], name.split(".")[-1]
        path, i = [], 0
        while i < len(parts):
            if parts[i] in ("fromRGB", "layers") and i + 1 < len(parts):
                path.append({"fromRGB": "fromRGB_", "layers": "layer_"}[parts[i]]
                            + parts[i + 1])
                i += 2
            else:
                path.append(parts[i])
                i += 1
        a = value.numpy()
        if path and path[-1] == "fc":
            path, leaf, a = path[:-1], f"fc_{'kernel' if leaf == 'weight' else 'bias'}", (
                a.T if leaf == "weight" else a)
        elif leaf == "weight":
            leaf, a = ("kernel", a.transpose(2, 3, 1, 0)) if a.ndim == 4 else ("scale", a)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return {"params": tree}


def _pair(name: str, img: int, dtype):
    """(JAX D, its params, port D) with the port's seeded weights on both
    sides; the tree's leaves and shapes equal the JAX init's."""
    jdisc = j_make_discriminator(name, dtype=dtype)
    tdisc = make_discriminator(name, compute_dtype=None if dtype is None else torch.bfloat16,
                               generator=torch.Generator().manual_seed(7))
    params = _flax_tree(tdisc)
    x = jnp.zeros((1, img, img, 3))
    shapes = jax.eval_shape(lambda k: jdisc.init(k, x, 1.0, cond=_cond_like(name, x)),
                            jax.random.PRNGKey(0))
    assert jax.tree.map(lambda s: s.shape, shapes) == jax.tree.map(lambda a: a.shape, params)
    state = bridge.params_to_state_dict(jax.tree.map(np.asarray, params))
    assert set(state) == set(tdisc.state_dict())
    for k, v in tdisc.state_dict().items():
        assert torch.equal(state[k], v), k
    return jdisc, params, tdisc


def _cond_like(name: str, img):
    if name == "ProgressiveDiscriminator_projection":
        return jnp.zeros((img.shape[0], COND_SIDE, COND_SIDE, 3))
    if name == "ProgressiveDiscriminator_inputCat":
        return jnp.zeros_like(img)
    return None


def _inputs(name: str, img: int):
    rng = np.random.default_rng(img)
    x = rng.normal(size=(B, img, img, 3)).astype(np.float32)
    cond = _cond_like(name, jnp.asarray(x))
    if cond is not None:
        cond = rng.normal(size=cond.shape).astype(np.float32)
    weights = rng.normal(size=(B, 256 + 2)).astype(np.float32)  # the latent/position heads
    return x, cond, weights


def _objective(out, weights):
    """The logits' sum, plus a weighted sum of the Encoder heads (so every
    output channel of their final conv has a grad)."""
    if isinstance(out, tuple):
        logits, heads = out[0], [h for h in out[1:] if h is not None]
        extra = sum((h * w).sum() for h, w in zip(heads, (weights[:, :256], weights[:, 256:])))
        return logits, logits.sum() + 0.1 * extra
    return out, out.sum()


def _rel(a, b) -> float:
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


PROGRESSIVE = [n for n in DISCRIMINATOR_REGISTRY if n.startswith("Progressive")]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("img", [32, 64])
@pytest.mark.parametrize("name", PROGRESSIVE)
def test_discriminator_matches_jax(name, img, precision, monkeypatch):
    """The progressive discriminators (the legacy strided ones:
    tests/test_torch_legacy_models.py)."""
    check_discriminator(name, img, precision, monkeypatch)


def check_discriminator(name, img, precision, monkeypatch):
    """Logits (and heads), the objective plus R1, and every param's grad of
    it, at fade-in alpha 0.5, against the JAX D on the same weights."""
    bf16 = precision == "bf16"
    if bf16:
        _fp32_sum_pool(monkeypatch)
    jdisc, params, tdisc = _pair(name, img, jnp.bfloat16 if bf16 else None)
    x, cond, weights = _inputs(name, img)
    j_cond = None if cond is None else jnp.asarray(cond)

    def j_loss(p):
        out = jdisc.apply(p, jnp.asarray(x), 0.5, cond=j_cond)
        logits, value = _objective(out, jnp.asarray(weights))
        r1 = jlosses.r1_penalty(lambda pp, i, a, cond: jdisc.apply(pp, i, a, cond=cond),
                                p, jnp.asarray(x), 0.5, j_cond)
        return value + r1, (out, r1)

    j_fn = jax.jit(jax.value_and_grad(j_loss, has_aux=True))
    if bf16:
        j_fn = j_fn.lower(params).compile(compiler_options=NO_EXCESS_PRECISION)
    (j_value, (j_out, j_r1)), j_grads = j_fn(params)
    real = torch.from_numpy(x).requires_grad_()
    out = tdisc(real, 0.5, cond=None if cond is None else torch.from_numpy(cond))
    logits, value = _objective(out, torch.from_numpy(weights))
    r1 = losses.r1_penalty(out, real)
    (value + r1).backward()
    outs = out if isinstance(out, tuple) else (out,)
    j_outs = j_out if isinstance(j_out, tuple) else (j_out,)
    assert logits.dtype == torch.float32 and logits.shape == (B, 1)
    assert len(outs) == len(j_outs)
    ref = bridge.params_to_state_dict(jax.tree.map(np.asarray, j_grads))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
             for n, p in tdisc.named_parameters()}
    assert set(ref) == set(grads)
    net_rel = _net_rel(grads, ref)
    if not bf16:
        # fp32 convs summed in another order: outputs within 1e-5 of the
        # largest (observed up to 4.8e-6); the Projection D's logit is a dot
        # of 1600 terms that cancel (observed 1.3e-5), held at 5e-5
        out_tol = 5e-5 if name.endswith("projection") else 1e-5
        for t, j in zip(outs, j_outs):
            if j is None:
                assert t is None
                continue
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                                       atol=out_tol * float(np.abs(j).max()))
        assert abs(r1.item() - float(j_r1)) <= 1e-4 * abs(float(j_r1))  # observed 4.0e-6
        # the net's grads as one vector within 1e-3 (observed up to 7.4e-5),
        # each param's within 1e-2 of its largest entry (observed 4.7e-3: R1's
        # double backward through 6 blocks of fp32 convs in another order)
        assert net_rel <= 1e-3
        for n, g in ref.items():
            g = g.numpy()
            np.testing.assert_allclose(grads[n], g, rtol=0,
                                       atol=1e-2 * float(np.abs(g).max()) + 1e-12, err_msg=n)
        return
    # the bf16 policy: bf16 convs and activations on both sides, whose
    # roundings flip between two sums of the same products
    readings = (_rel(logits.detach().numpy(), j_outs[0]),
                abs((value + r1).item() - float(j_value)) / abs(float(j_value)), net_rel)
    logit_rel, value_rel, grad_rel = readings
    if name.endswith("projection"):
        # the ResNet18's train-mode BatchNorms normalise 4 views (its last
        # stage is 1x1 at 32^2) and amplify every flipped bf16 rounding
        # through R1's double backward: logits observed 2.4e-2 and 5.5e-2,
        # the objective 1.1e-2 and 8.2e-2, the grads 0.30 and 0.55. The
        # grads are held to be nearer JAX's bf16 D than the port's fp32
        # path on the same weights is (observed 0.69 and 0.66)
        fp32 = make_discriminator(name)
        fp32.load_state_dict(tdisc.state_dict())
        real32 = torch.from_numpy(x).requires_grad_()
        out32 = fp32(real32, 0.5, cond=torch.from_numpy(cond))
        (_objective(out32, torch.from_numpy(weights))[1]
         + losses.r1_penalty(out32, real32)).backward()
        grads32 = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                   for n, p in fp32.named_parameters()}
        assert logit_rel <= 0.1 and value_rel <= 0.15
        assert grad_rel < _net_rel(grads32, ref)
        return
    # logits by L2 (observed up to 2.1e-2), the objective plus R1 relative
    # (2.6e-2), the whole net's grads as one vector (5.3e-2):
    # tests/test_torch_precision.py holds its progressive D's at 2e-2, 1e-3
    # and 0.12 at 8 images and one head
    assert logit_rel <= 3e-2 and value_rel <= 3e-2 and grad_rel <= 0.12


def _net_rel(grads: dict, ref: dict) -> float:
    """The net's grads as one vector: |port - JAX|_2 / |JAX|_2."""
    num = sum(np.sum((grads[k].astype(np.float64) - ref[k].numpy()) ** 2) for k in ref)
    den = sum(np.sum(ref[k].numpy().astype(np.float64) ** 2) for k in ref)
    return float(np.sqrt(num / den))


def test_conditional_discriminators_need_cond():
    x = torch.zeros(B, 32, 32, 3)
    for name in ("ProgressiveDiscriminator_inputCat", "ProgressiveDiscriminator_projection"):
        with pytest.raises(ValueError, match="conditioning image"):
            make_discriminator(name)(x, 1.0)
    # InputCat defaults to the 6 channels of image and view: the JAX module
    # infers them at init, the port cannot
    adapter = make_discriminator("ProgressiveDiscriminator_inputCat").fromRGB[0]
    assert adapter.conv.weight.shape[1] == 6


def test_encoder_discriminator_instance_noise():
    """Instance noise from an explicit generator: the heads move, the same
    seed gives the same heads, and no generator (or no noise) adds none."""
    D = make_discriminator("ProgressiveEncoderDiscriminator",
                           generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 16, 16, 3)).astype(np.float32))
    plain = D(x, 1.0)
    noisy = [D(x, 1.0, instance_noise=0.5, generator=torch.Generator().manual_seed(s))
             for s in (3, 3, 4)]
    assert torch.equal(D(x, 1.0, instance_noise=0.5)[0], plain[0])
    assert torch.equal(noisy[0][1], noisy[1][1])
    assert not torch.equal(noisy[0][1], noisy[2][1])
    assert not torch.equal(noisy[0][1], plain[1])


# --- the conditional train step --------------------------------------------------------

UNET = dict(in_channels=4, out_channels=16, f_maps=8, num_levels=3, return_global=True)
GLOBAL, FEAT, H = 32, 16, 64  # the `cond` smoke preset's widths


@pytest.mark.parametrize("disc", ["ProgressiveDiscriminator_inputCat",
                                  "ProgressiveDiscriminator_projection"])
def test_cond_train_step_matches_jax(disc, monkeypatch):
    """One step of the `cond` smoke preset (UNet3D f_maps 8, 3 levels, out
    16; SHORTSIREN_dg 64 wide under the kernel policy; the InputCat D,
    batch_split 2), and the same with the Projection D (views at 32^2,
    batch_split 1: its ResNet18's BatchNorms need 4 views, see the module
    docstring), against JAX `make_train_step`: 16^3 grids, 16^2, 6 + 6
    samples, 4 ray chunks, deterministic renders; the D step and every G
    split read `cond`."""
    cfg = dict(img_size=16, num_steps=6, fov=49.134342641202636, ray_start=0.25,
               ray_end=1.95, hierarchical_sample=True, white_back=True, ray_chunks=4,
               perturb=True, density_noise=False)
    split = 1 if disc.endswith("projection") else 2
    step_kwargs = dict(
        batch_split=split, enable_discriminator=True, photo_loss=True, load_voxel=True,
        load_pcl=False, cond_mode=True, random_gen_img=False, noise_weight=0.0,
        r1_lambda=10.0, grad_clip=1.0, z_reg_weight=0.01, gen_lr=1e-4, disc_lr=2e-4,
        enc_lr=5e-5, betas=(0.0, 0.9), weight_decay=0.0, mapping_lr_mult=0.5)
    jcfg = jts.TrainStepConfig(render=JRenderConfig(**cfg), **step_kwargs)
    tcfg = TrainStepConfig(render=RenderConfig(**cfg), **step_kwargs)
    side = COND_SIDE if disc.endswith("projection") else 16
    rng = np.random.default_rng(30)
    batch = {
        "img": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
        "cam2world": _cams(B, seed=31).numpy(),
        "voxel": np.concatenate([_voxels(seed=32), _voxels(seed=33)]),
        "cond": rng.uniform(-1, 1, (B, side, side, 3)).astype(np.float32),
    }
    gen = dict(siren_type="SHORTSIREN_dg", z_dim=GLOBAL, input_dim=FEAT, hidden_dim=H)
    jgen, jenc = JGenerator(**gen, **POLICY_J), j_make_unet(**UNET)
    tgen, tenc = ImplicitGenerator3d(**gen, **POLICY_T), make_unet(**UNET)
    jdisc, params_D, tdisc = _pair(disc, 16, None)
    wrapped_gen = _DeterministicGenerator(jgen)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jts.create_train_state(jax.random.PRNGKey(34), wrapped_gen, jenc, jdisc,
                                   {k: v for k, v in j_batch.items() if k != "cond"},
                                   dataclasses.replace(jcfg, cond_mode=False,
                                                       enable_discriminator=False))
    state = state.replace(params_D=params_D, opt_D=jts._make_txs(jcfg)[2].init(params_D))
    # the head x3 and sigma's bias +1: sigma of both signs, so the render is
    # not all background. With the head x10 (tests/test_torch_voxel_train.py's
    # choice for TALLSIREN) this SIREN's step is ill-conditioned: E's weights
    # moved by 1e-6 of themselves move G's grads by 0.56% in the port alone
    # (3.7e-4 here), past what two fp32 sums can be held to
    head = state.params_G["params"]["siren"]["final_layer"]
    head["kernel"] = head["kernel"] * 3.0
    head["bias"] = head["bias"].at[3].add(1.0)
    for module, p in ((tgen, state.params_G), (tenc, state.params_E)):
        module.load_state_dict(bridge.params_to_state_dict(jax.tree.map(np.asarray, p)))

    j_recorded = _record_jax_grads(monkeypatch)
    j_step = jax.jit(jts.make_train_step(wrapped_gen, jenc, jdisc, jcfg))
    _, j_metrics = j_step(state, j_batch, jax.random.PRNGKey(35), jnp.float32(0.5),
                          jnp.float32(0.0))
    jax.effects_barrier()

    t_state = create_train_state(tgen, tenc, tdisc, tcfg)
    t_recorded = _record_port_grads(t_state)
    seen = []
    forward = tdisc.forward
    monkeypatch.setattr(tdisc, "forward", lambda img, alpha, cond=None: (
        seen.append(None if cond is None else tuple(cond.shape)), forward(img, alpha, cond))[1])
    threads = torch.get_num_threads()
    torch.set_num_threads(8)  # D's grads were read at 8: the CPU's conv backward sums by threads
    try:
        _, t_metrics = make_train_step(tcfg)(
            t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, 0.5, 0.0)
    finally:
        torch.set_num_threads(threads)
    # D step: real, fake and R1's real (one call: its logits are the real
    # ones); G step: each split's views
    assert seen == [(B, side, side, 3)] * 2 + [(B // split, side, side, 3)] * split

    # losses: fp32 D and U-Net on both sides, the SIREN's plain kernel
    # version; the U-Net's fp32 noise reaches D's logits (observed 1.5e-5)
    for name in ("d_loss", "g_loss", "photo_loss"):
        np.testing.assert_allclose(t_metrics[name].item(), float(j_metrics[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    # grads before the clip, norm-relative and elementwise against the
    # largest: the bounds of tests/test_torch_voxel_train.py's dg_dis step
    # (E at bf16 tolerance: JAX's dV comes from bf16 one-hot matmuls)
    tols = {"G": (2e-3, 1e-2), "D": (1e-2, 3e-2), "E": (3e-2, 3e-2)}
    for net, (norm_tol, max_tol) in tols.items():
        ref = bridge.params_to_state_dict(jax.tree.map(np.asarray, j_recorded[net]))
        assert set(ref) == set(t_recorded[net])
        for name, g in ref.items():
            t, g = t_recorded[net][name].numpy(), g.numpy()
            assert np.linalg.norm(t - g) <= norm_tol * np.linalg.norm(g) + 1e-12, f"{net} {name}"
            np.testing.assert_allclose(t, g, rtol=0, atol=max_tol * np.abs(g).max() + 1e-12,
                                       err_msg=f"{net} {name}")
    assert any(np.abs(g.numpy()).max() > 0 for g in t_recorded["D"].values())


@pytest.mark.parametrize("preset,side", [("cond_nearest", 128), ("proj_random", 256)])
def test_stage_bench_gives_cond_views(preset, side):
    """A conditional preset's bench: its D and seeded views at the loader's
    size (256 for the Projection D's ResNet18)."""
    bench = build_stage_bench(preset, stage=2, step=16000)
    assert bench.config.cond_mode and bench.config.enable_discriminator
    assert type(bench.discriminator).__name__ == {
        "cond_nearest": "ProgressiveDiscriminatorInputCat",
        "proj_random": "ProgressiveDiscriminatorProjection"}[preset]
    cond = bench.batch["cond"]
    assert cond.shape == (12, side, side, 3) and cond.dtype == np.float32
    assert -1 <= cond.min() and cond.max() <= 1
