"""The presets' bf16 policy (`compute_dtype: "bfloat16"`) in the port's
PointNet, discriminator and U-Net, against the JAX modules built with
`dtype=jnp.bfloat16`, on the CPU. Weights cross through `bridge.py`; inputs
come from seeded numpy.

Each module is also held closer to the JAX bf16 module than the port's fp32
path (`compute_dtype=None`, the same weights) is, so the policy is shown to
be in effect, not just within noise: where the ratio of the two distances
is 2.8 or more it is asserted at half its measured value; where it is
smaller (the U-Net's and D's grads, D's value), the reading is held at a
limit that the policy passes and the fp32 path fails, both asserted.

One artefact of the reference on the CPU: XLA's CPU backend sums a bf16
cotangent into a bias (`lax.reduce` in bf16) in bf16, one rounding an add
(0.29 off a sum of 3.4 over 2,048 terms, where a sum in fp32 rounded once
is 0.0078 off), so the JAX D's conv-bias grads are that far from the sums
the port rounds once. The D's bias grads are therefore held inside the
whole net's grad norm, its kernels one by one.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.config import extract_metadata, load_curriculum
from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import ResnetPointnet as JPointnet
from conditioned_nerf_gan_tpu.models import make_discriminator as j_make_discriminator
from conditioned_nerf_gan_tpu.models import make_unet as j_make_unet
from conditioned_nerf_gan_tpu.models.layers import TorchLinear as JLinear
from conditioned_nerf_gan_tpu.training import losses as jlosses
from conditioned_nerf_gan_tpu.training import train_step as jts
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.infer import build_models
from conditioned_nerf_gan_torch.models import (
    ImplicitGenerator3d,
    RenderConfig,
    ResnetPointnet,
    make_discriminator,
    make_unet,
)
from conditioned_nerf_gan_torch.models.layers import TorchLinear
from conditioned_nerf_gan_torch.training import (
    TrainStepConfig,
    create_train_state,
    losses,
    make_train_step,
)
from test_torch_train import (
    CFG,
    POLICY_J,
    POLICY_T,
    _cams,
    _DeterministicGenerator,
    _record_jax_grads,
    _record_port_grads,
)
from test_torch_voxel import UNET, _voxels

BF16 = torch.bfloat16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jitter(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + jnp.asarray(rng.normal(0, scale, p.shape), p.dtype), tree)


def _rel(a, b) -> float:
    """|a - b|_2 / |b|_2 in fp64."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grads(module) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for n, p in module.named_parameters()}


def _pair(jmodule, params, make_port, dtype):
    """The port module under `dtype` with the JAX params."""
    port = make_port(dtype)
    port.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    return port


def _net_rel(t_grads: dict, j_grads, keep=lambda name: True) -> float:
    """The net's grads (of the params `keep` admits) as one vector:
    |port - JAX|_2 / |JAX|_2."""
    ref = {k: v.numpy() for k, v in bridge.params_to_state_dict(_np_tree(j_grads)).items()}
    assert set(ref) == set(t_grads)
    ref = {k: v for k, v in ref.items() if keep(k)}
    num = sum(np.sum((t_grads[k].astype(np.float64) - ref[k]) ** 2) for k in ref)
    den = sum(np.sum(ref[k].astype(np.float64) ** 2) for k in ref)
    return float(np.sqrt(num / den))


def _worst_param_rel(t_grads: dict, j_grads, skip=lambda name: False) -> float:
    ref = {k: v.numpy() for k, v in bridge.params_to_state_dict(_np_tree(j_grads)).items()}
    return max(_rel(t_grads[k], g) for k, g in ref.items()
               if not skip(k) and np.abs(g).max() > 0)


def _median_leaf_rel(t_grads: dict, j_grads) -> float:
    """The median over the net's params of |port - JAX|_2 / |JAX|_2."""
    ref = {k: v.numpy() for k, v in bridge.params_to_state_dict(_np_tree(j_grads)).items()}
    return float(np.median([_rel(t_grads[k], g) for k, g in ref.items()
                            if np.abs(g).max() > 0]))


def _first_kernels(j_grads, blocks: int):
    """A filter of the conv kernels of the progressive D's first `blocks`
    live blocks (the first at the image's resolution)."""
    ref = bridge.params_to_state_dict(_np_tree(j_grads))
    live = sorted({int(k.split(".")[1]) for k, g in ref.items()
                   if k.startswith("layers.") and g.abs().max() > 0})
    return lambda name: name.endswith(".weight") and any(
        name.startswith(f"layers.{i}.") for i in live[:blocks])


def _fp32_sum_pool(monkeypatch):
    """The JAX D's 2x2 average pool as a sum in fp32 rounded once to bf16,
    as the port takes it: XLA's CPU backend otherwise sums the four in
    bf16, rounding each add."""
    from conditioned_nerf_gan_tpu.models import discriminators as jd

    pool = jd.avg_pool_2x
    monkeypatch.setattr(jd, "avg_pool_2x",
                        lambda x: pool(x.astype(jnp.float32)).astype(x.dtype))


def _bf16_ulp_share(t, j) -> float:
    """Share of elements within one bf16 ulp of the JAX output's magnitude."""
    t, j = (np.asarray(x, np.float32) for x in (t, j))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(j), 1e-30))) - 7)
    return float((np.abs(t - j) <= ulp).mean())


@pytest.mark.parametrize("extra", [False, True], ids=["plain", "extra"])
@pytest.mark.parametrize("fp32_out", [False, True], ids=["bf16_out", "fp32_out"])
def test_torch_linear_policy_matches_jax(extra, fp32_out):
    """A 512 -> 512 product (1024 -> 512 with the pooled `extra` operand)
    on 2 x 256 points: the output dtype is JAX's, and nearly every element
    is within one bf16 ulp of JAX's (observed: all but 0 to 6 of 262,144,
    products summed in another order flipping a rounding, or near-zero
    fp32 outputs, whose ulp is tiny)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 256, 512)).astype(np.float32)
    e = rng.normal(size=(2, 1, 512)).astype(np.float32)
    jl = JLinear(512, dtype=jnp.bfloat16, fp32_out=fp32_out)
    args = (jnp.asarray(x),) + ((None, jnp.asarray(e)) if extra else ())
    params = jl.init(jax.random.PRNGKey(1), *args)
    jy = jl.apply(params, *args)
    kernel = np.asarray(params["params"]["kernel"])
    tl = TorchLinear(kernel.shape[0], 512, compute_dtype=BF16, fp32_out=fp32_out)
    tl.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()),
                        "bias": torch.from_numpy(np.asarray(params["params"]["bias"]))})
    with torch.no_grad():
        ty = tl(torch.from_numpy(x), extra=torch.from_numpy(e) if extra else None)
    assert ty.dtype == (torch.float32 if fp32_out else BF16)
    assert str(jy.dtype) == ("float32" if fp32_out else "bfloat16")
    assert ty.shape == jy.shape
    assert _bf16_ulp_share(ty.float().numpy(), jy.astype(jnp.float32)) >= 0.999


def test_torch_linear_fp32_out_backward_is_mixed_dot():
    """fp32_out under the policy: the grads of `ops/mixed.py::mixed_dot`
    (the cotangent rounded to bf16, products summed in fp32), in the primal
    dtypes."""
    from conditioned_nerf_gan_tpu.ops.mixed import mixed_dot

    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 40, 24)).astype(np.float32)
    w = rng.normal(size=(24, 16)).astype(np.float32)
    g = rng.normal(size=(3, 40, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: mixed_dot(a, b, jnp.bfloat16), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tl = TorchLinear(24, 16, use_bias=False, compute_dtype=BF16)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w.T.copy()))
    tx = torch.from_numpy(x).requires_grad_()
    tl(tx).backward(torch.from_numpy(g))
    assert tx.grad.dtype == torch.float32
    # the same bf16 operands summed in fp32 in another order (observed 9.5e-7
    # on dx, 3.8e-6 on dW)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl.weight.grad.numpy(), np.asarray(jdw).T, rtol=0, atol=1e-4)


def test_pointnet_policy_matches_jax():
    """ResnetPointnet (hidden 32, c_dim 16) on 2 x 256 points: the latent
    and the param grads of a weighted sum of it."""
    rng = np.random.default_rng(2)
    pcl = rng.uniform(-0.4, 0.4, (2, 256, 6)).astype(np.float32)
    w = rng.normal(size=(2, 16)).astype(np.float32)
    jenc = JPointnet(c_dim=16, hidden_dim=32, dtype=jnp.bfloat16)
    params = _jitter(jenc.init(jax.random.PRNGKey(2), jnp.asarray(pcl)), seed=3)
    j_out = jenc.apply(params, jnp.asarray(pcl))
    j_grads = jax.grad(lambda p: jnp.sum(jenc.apply(p, jnp.asarray(pcl)) * w))(params)
    results = {}
    for dtype in (BF16, None):
        tenc = _pair(jenc, params, lambda d: ResnetPointnet(c_dim=16, hidden_dim=32,
                                                            compute_dtype=d), dtype)
        out = tenc(torch.from_numpy(pcl))
        assert out.dtype == torch.float32
        (out * torch.from_numpy(w)).sum().backward()
        results[dtype] = (_rel(out.detach().numpy(), j_out), _net_rel(_grads(tenc), j_grads),
                          _worst_param_rel(_grads(tenc), j_grads))
    out_rel, net_rel, worst = results[BF16]
    # bf16 products rounded as JAX rounds them: the latent came out equal
    # (observed 0); the grads carry bf16 cotangents through 11 products
    # (observed 5.5e-3 over the net, 1.5e-2 for the worst parameter)
    assert out_rel <= 1e-3
    assert net_rel <= 2e-2 and worst <= 4e-2
    # the fp32 path is farther from JAX-bf16: latent observed 5.9e-3, grads
    # 6.0e-2 over the net (11x the policy's), 0.16 for the worst parameter
    fp32_out_rel, fp32_net_rel, _ = results[None]
    assert fp32_out_rel >= 3e-3
    assert fp32_net_rel >= 0.5 * 11 * net_rel


@pytest.mark.parametrize("img", [32, 64])
def test_discriminator_policy_matches_jax(img, monkeypatch):
    """The progressive D at fade-in alpha 0.5 on 8 images: the fp32 logits
    and the grads of the logits' sum plus the R1 penalty (a double backward
    through bf16 convs, the image grad coming back fp32 through the cast),
    with the JAX pool of `_fp32_sum_pool`."""
    _fp32_sum_pool(monkeypatch)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, img, img, 3)).astype(np.float32)
    jdisc = j_make_discriminator("ProgressiveDiscriminator", dtype=jnp.bfloat16)
    params = jdisc.init(jax.random.PRNGKey(5), jnp.zeros((1, img, img, 3)), 1.0)

    def j_loss(p):
        logits = jdisc.apply(p, jnp.asarray(x), 0.5)
        r1 = jlosses.r1_penalty(lambda pp, i, a, cond: jdisc.apply(pp, i, a, cond=cond),
                                p, jnp.asarray(x), 0.5)
        return jnp.sum(logits) + r1, logits

    (j_value, j_logits), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    results = {}
    for dtype in (BF16, None):
        tdisc = _pair(jdisc, params, lambda d: make_discriminator(
            "ProgressiveDiscriminator", compute_dtype=d), dtype)
        real = torch.from_numpy(x).requires_grad_()
        logits = tdisc(real, 0.5)
        assert logits.dtype == torch.float32 and logits.shape == (8, 1)
        value = logits.sum() + losses.r1_penalty(logits, real)
        value.backward()
        g = _grads(tdisc)
        results[dtype] = (_rel(logits.detach().numpy(), j_logits),
                          abs(value.item() - float(j_value)) / abs(float(j_value)),
                          _net_rel(g, j_grads),
                          _worst_param_rel(g, j_grads, skip=lambda n: n.endswith(".bias")),
                          _net_rel(g, j_grads, _first_kernels(j_grads, 1)))
    logit_rel, value_rel, net_rel, worst_kernel, first_rel = results[BF16]
    # the logits are the bf16 output of the 2x2 conv plus a bf16 bias: at
    # 64^2 they came out equal to JAX's, at 32^2 a flipped rounding moves a
    # near-zero logit (observed 5.7e-3 over the 8 logits, 5.0e-4 of the
    # logits' sum plus R1). Grads: kernels observed up to 1.3e-2, the whole
    # net 2.5e-2 (32^2) and 6.3e-2 (64^2), the conv biases' share (see the
    # module docstring)
    assert logit_rel <= 2e-2 and worst_kernel <= 3e-2 and net_rel <= 0.12
    _, fp32_value_rel, _, _, fp32_first_rel = results[None]
    # held at limits that the fp32 path fails. The logits' sum plus R1:
    # observed 5.0e-4 and 0 (32^2, 64^2), the fp32 path's 8.6e-3 and 2.2e-3.
    # The first live block's conv kernels (the convs at the image's
    # resolution) as one vector: observed 2.40e-3 and 2.32e-3, the fp32
    # path's 4.08e-3 and 4.64e-3. Deeper blocks' grads and the logits do not
    # separate the two: bf16 cotangents through R1's double backward flip
    # roundings on either side (the logits at 32^2, 5.7e-3, are farther
    # than the fp32 path's at 64^2, 3.0e-3)
    assert value_rel <= 1e-3 < fp32_value_rel
    assert first_rel <= 3.2e-3 < fp32_first_rel


def test_unet_policy_matches_jax():
    """UNet3D (f_maps 8, 3 levels, 16^3, return_global): the fp32 feature
    volume and global feature, and the grads of a weighted sum of both."""
    vox = _voxels(0)
    jenc = j_make_unet(**UNET, dtype=jnp.bfloat16)
    params = _jitter(jenc.init(jax.random.PRNGKey(0), jnp.asarray(vox)), seed=1, scale=0.05)
    j_vol, j_glob = jenc.apply(params, jnp.asarray(vox))
    rng = np.random.default_rng(6)
    wv = rng.normal(size=j_vol.shape).astype(np.float32)
    wg = rng.normal(size=j_glob.shape).astype(np.float32)

    def j_loss(p):
        vol, glob = jenc.apply(p, jnp.asarray(vox))
        return jnp.sum(vol * wv) + jnp.sum(glob * wg)

    j_grads = jax.jit(jax.grad(j_loss))(params)
    results = {}
    for dtype in (BF16, None):
        tenc = _pair(jenc, params, lambda d: make_unet(**UNET, compute_dtype=d), dtype)
        vol, glob = tenc(torch.from_numpy(vox))
        assert vol.dtype == glob.dtype == torch.float32
        ((vol * torch.from_numpy(wv)).sum() + (glob * torch.from_numpy(wg)).sum()).backward()
        g = _grads(tenc)
        results[dtype] = (_rel(vol.detach().numpy(), j_vol), _rel(glob.detach().numpy(), j_glob),
                          _net_rel(g, j_grads), _median_leaf_rel(g, j_grads))
    vol_rel, glob_rel, net_rel, leaf_rel = results[BF16]
    # bf16 convs between fp32 GroupNorms: one fp32 ulp of a statistic flips
    # bf16 roundings downstream, so this distance depends on the summation
    # order, and so on the CPU thread count (a Tier-1 worker's one). Observed:
    # 6.2e-3 (volume), 8.3e-4 (global), 0.146 (the grads as one vector),
    # 9.3e-2 (median over the params of each one's grads)
    assert vol_rel <= 1.2e-2 and glob_rel <= 2e-3
    fp32_vol_rel, fp32_glob_rel, fp32_net_rel, fp32_leaf_rel = results[None]
    # the fp32 path is farther: volume 2.8x (1.7e-2), global 2.8x
    assert fp32_vol_rel >= 0.5 * 2.8 * vol_rel
    assert fp32_glob_rel >= 0.5 * 2.8 * glob_rel
    # the grads at limits that the fp32 path fails: 0.256 as one vector,
    # 0.182 the median param (at 8 threads 0.182 too); the policy is
    # closer on 30 of the 32 params with grads
    assert net_rel <= 0.2 < fp32_net_rel
    assert leaf_rel <= 0.13 < fp32_leaf_rel


def test_policy_output_dtypes_inside_the_nets():
    """Under the policy the block outputs are bf16 and the nets' results
    fp32: PointNet's blocks and the U-Net's convs bf16, GroupNorm fp32;
    with compute_dtype None everything is fp32."""
    seen = {}

    def hook(name):
        def record(module, args, out):
            seen.setdefault(name, out.dtype)

        return record

    pn = ResnetPointnet(c_dim=8, hidden_dim=16, compute_dtype=BF16)
    pn.blocks[2].register_forward_hook(hook("pointnet block"))
    unet = make_unet(**UNET, compute_dtype=BF16)
    unet.encoders[1].conv1.conv.register_forward_hook(hook("unet conv"))
    unet.encoders[1].conv1.norm.register_forward_hook(hook("unet groupnorm"))
    with torch.no_grad():
        z = pn(torch.rand(2, 32, 6))
        vol, glob = unet(torch.from_numpy(_voxels(1)))
    assert seen == {"pointnet block": BF16, "unet conv": BF16, "unet groupnorm": torch.float32}
    assert z.dtype == vol.dtype == glob.dtype == torch.float32
    seen.clear()
    pn = ResnetPointnet(c_dim=8, hidden_dim=16)
    pn.blocks[2].register_forward_hook(hook("pointnet block"))
    unet = make_unet(**UNET)
    unet.encoders[1].conv1.conv.register_forward_hook(hook("unet conv"))
    with torch.no_grad():
        pn(torch.rand(2, 32, 6))
        unet(torch.from_numpy(_voxels(1)))
    assert seen == {"pointnet block": torch.float32, "unet conv": torch.float32}


def test_build_models_and_trainer_pass_the_policy():
    """Under a preset (`compute_dtype: "bfloat16"`) the encoder and D are
    built bf16, as the JAX Trainer builds them; without the key, fp32."""
    from conditioned_nerf_gan_torch.training.trainer import Trainer

    meta = extract_metadata(load_curriculum(config_base="thousand"), 0)
    assert meta["compute_dtype"] == "bfloat16"
    shrunk = dict(meta, generator=dict(meta["generator"], z_dim=16, hidden_dim=16))
    for m, expect in ((shrunk, BF16), ({k: v for k, v in shrunk.items()
                                         if k != "compute_dtype"}, None)):
        G, E = build_models(m)
        assert E.fc_pos.compute_dtype is expect and E.fc_c.compute_dtype is expect
        assert G.siren.film_layers[0].compute_dtype is expect
        trainer = Trainer.__new__(Trainer)
        trainer.metadata, trainer.seed = m, 0
        _, E2, D = trainer._build_models()
        assert E2.blocks[1].fc_0.compute_dtype is expect
        assert D.compute_dtype is expect and D.layers[0].conv1.compute_dtype is expect
    dg = extract_metadata(load_curriculum(config_base="thousand", config="dg"), 0)
    _, unet = build_models(dict(dg, unet=dict(dg["unet"], f_maps=8)))
    assert unet.encoders[0].conv1.conv.compute_dtype is BF16


def test_train_step_under_the_policy_matches_jax(monkeypatch):
    """One thesis D-then-G/E step with the encoder and D under the bf16
    policy (the SIREN under the kernel policy, as before) against JAX
    `make_train_step` with the same nets built `dtype=bfloat16`: the
    harness of test_torch_train.py's full step, R1, alpha 0.5, batch_split
    2, 4 ray chunks, with the JAX pool of `_fp32_sum_pool`."""
    _fp32_sum_pool(monkeypatch)
    render = dict(CFG, ray_chunks=4, perturb=True, density_noise=False)
    step_kwargs = dict(
        batch_split=2, enable_discriminator=True, photo_loss=True, load_pcl=True,
        random_gen_img=False, noise_weight=0.0, r1_lambda=10.0, grad_clip=1.0,
        z_reg_weight=0.01, grad_accum_scale=3.0, gen_lr=1e-4, disc_lr=2e-4,
        enc_lr=5e-5, betas=(0.0, 0.9), weight_decay=1e-3, mapping_lr_mult=0.5)
    jcfg = jts.TrainStepConfig(render=JRenderConfig(**render), **step_kwargs)
    tcfg = TrainStepConfig(render=RenderConfig(**render), **step_kwargs)
    B, alpha, Z, H = 4, 0.5, 16, 32
    rng = np.random.default_rng(17)
    batch = {
        "img": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
        "cam2world": _cams(B, seed=18).numpy(),
        "pcl": rng.uniform(-0.4, 0.4, (B, 64, 6)).astype(np.float32),
    }
    jgen = _DeterministicGenerator(JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H,
                                              **POLICY_J))
    jenc = JPointnet(c_dim=Z, hidden_dim=16, dtype=jnp.bfloat16)
    jdisc = j_make_discriminator("ProgressiveDiscriminator", dtype=jnp.bfloat16)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jts.create_train_state(jax.random.PRNGKey(19), jgen, jenc, jdisc, j_batch, jcfg)
    tgen = ImplicitGenerator3d(z_dim=Z, hidden_dim=H, **POLICY_T)
    tenc = ResnetPointnet(c_dim=Z, hidden_dim=16, compute_dtype=BF16)
    tdisc = make_discriminator("ProgressiveDiscriminator", compute_dtype=BF16)
    for module, params in ((tgen, state.params_G), (tenc, state.params_E),
                           (tdisc, state.params_D)):
        module.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))

    j_recorded = _record_jax_grads(monkeypatch)
    j_step = jax.jit(jts.make_train_step(jgen, jenc, jdisc, jcfg))
    _, j_metrics = j_step(state, j_batch, jax.random.PRNGKey(20), jnp.float32(alpha),
                          jnp.float32(0.0))
    jax.effects_barrier()
    t_state = create_train_state(tgen, tenc, tdisc, tcfg)
    t_recorded = _record_port_grads(t_state)
    t_state, t_metrics = make_train_step(tcfg)(
        t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, alpha, 0.0)
    assert t_state.step == 1
    # losses: the D's logits are bf16 roundings (observed 8.3e-5 relative,
    # D; 1.8e-4, G); the photometric loss renders through the SIREN from a
    # bf16 PointNet's fp32 latent (observed 1.7e-7; z_reg 8.9e-8)
    for name, tol in (("d_loss", 1e-3), ("g_loss", 1e-3), ("photo_loss", 1e-5),
                      ("z_reg", 1e-5)):
        np.testing.assert_allclose(t_metrics[name].item(), float(j_metrics[name]),
                                   rtol=tol, err_msg=name)
    # each net's pre-clip grads as one vector (the D's conv biases summed in
    # bf16 by XLA's CPU backend, see the module docstring): observed 3.8e-3
    # (G, through the bf16 D's backward), 3.2e-3 (E), 3.1e-2 (D)
    for net, tol in (("G", 1e-2), ("E", 1e-2), ("D", 0.1)):
        t = {k: v.numpy() for k, v in t_recorded[net].items()}
        assert _net_rel(t, j_recorded[net]) <= tol, net
    # D's first two live blocks' conv kernels as one vector: observed
    # 2.27e-2, where the same step with the encoder and D at compute_dtype
    # None reads 4.07e-2 (and E 4.6e-2, g_loss 2.7e-3, z_reg 5.4e-4: each
    # past its limit above)
    t = {k: v.numpy() for k, v in t_recorded["D"].items()}
    assert _net_rel(t, j_recorded["D"], _first_kernels(j_recorded["D"], 2)) <= 3e-2
