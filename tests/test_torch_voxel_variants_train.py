"""The rest of the voxel family's renders and training on the CPU, against
the JAX package on bridged weights: one `dRes` step (UNet3D without the
global feature, TALLSIREN_dRes on the bare volume, the discriminator on)
and one `doublesiren_dis_featurepyramid` step (PyramidUNet3D, DOUBLESIREN_FG
on the levels' concatenated features), losses and every net's grads; the
PyramidUNet3D's and ResidualUNet3D's grads against jax.grad (the grads come
back through every level); their renders; one dV a level a render on the
kernel route (the launches stood in for, as tests/test_torch_dv_accumulate.py
does); and a JAX trainer checkpoint of a ResidualUNet3D run through
`bridge.convert_train_checkpoint`.

About 70 s on one CPU process, most of it the two JAX step compiles.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.config import extract_metadata as j_extract_metadata
from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import make_discriminator as j_make_discriminator
from conditioned_nerf_gan_tpu.models import make_unet as j_make_unet
from conditioned_nerf_gan_tpu.training import train_step as jts
from conditioned_nerf_gan_tpu.training.checkpoints import save_checkpoint as j_save
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.config import curriculum_to_json, load_curriculum
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
from conditioned_nerf_gan_torch.models import make_discriminator, make_unet
from conditioned_nerf_gan_torch.training import (
    TrainStepConfig,
    create_train_state,
    make_train_step,
)
from test_torch_dv_accumulate import _check_one_buffer, _kernel_route
from test_torch_train import _DeterministicGenerator, _cams, _chunk_memory, _record_jax_grads
from test_torch_voxel import _voxels
from test_torch_voxel_train import _record_port_grads

UNET = dict(in_channels=4, out_channels=8, f_maps=8, num_levels=3)
GLOBAL, H = 32, 32  # the U-Net's global width (8 * 2^2), the SIREN width
POLICY_J = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True, use_pallas=True)
POLICY_T = dict(compute_dtype=torch.bfloat16, use_fast_sin=True, use_kernel=True)
RENDER = dict(img_size=16, num_steps=6, fov=49.134342641202636, ray_start=0.25,
              ray_end=1.95, hierarchical_sample=True, white_back=True, perturb=True)
# each path: (U-Net type, return_global, SIREN, its input width); the
# pyramid's levels at f_maps 8 and 3 levels are 8^3 x 16 and 16^3 x 8
PATHS = {
    "dRes": ("UNet3D", False, "TALLSIREN_dRes", 8),
    "featurepyramid": ("PyramidUNet3D", True, "DoubleSIREN_dg", 24),
    "residual_dg": ("ResidualUNet3D", True, "TALLSIREN_dg", 8),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(path, discriminator=False):
    """The JAX and port (generator, encoder, discriminator) of a path at
    smoke size, the SIREN under the kernel policy."""
    kind, glob, siren, width = PATHS[path]
    unet = dict(UNET, return_global=glob)
    jgen = JGenerator(siren_type=siren, z_dim=GLOBAL, input_dim=width, hidden_dim=H, **POLICY_J)
    tgen = ImplicitGenerator3d(siren_type=siren, z_dim=GLOBAL, input_dim=width, hidden_dim=H,
                               **POLICY_T)
    jdisc = j_make_discriminator("ProgressiveDiscriminator") if discriminator else None
    tdisc = make_discriminator("ProgressiveDiscriminator") if discriminator else None
    return (jgen, j_make_unet(kind, **unet), jdisc), (tgen, make_unet(kind, **unet), tdisc)


def _scale_head(params_G):
    """A 10x head and a sigma bias of +1.5: sigma of both signs, so the
    render is not all background (at the init's small outputs every sigma
    of TALLSIREN_dRes is negative, and nothing trains G or E)."""
    head = params_G["params"]["siren"]["final_layer"]
    head["kernel"] = head["kernel"] * 10.0
    head["bias"] = head["bias"] + jnp.asarray([0.0, 0.0, 0.0, 1.5], head["bias"].dtype)


@pytest.mark.parametrize("path", ["dRes", "featurepyramid"])
def test_variant_train_step_matches_jax(path, monkeypatch):
    """One step of the path against JAX `make_train_step` from the same
    weights and batch, the discriminator (with R1) on as in both presets:
    16^3 grids, 16^2, 6 + 6 samples, 4 ray chunks, batch_split 2 with
    grad_accum_scale 3, deterministic renders. The bounds are
    test_torch_voxel_train.py's for the `dg_dis` step: losses 1e-4
    relative (observed 3.6e-7); G's and D's grads param by param,
    norm-relative and elementwise against the param's largest grad, G
    (2e-3, 1e-2), D (1e-2, 3e-2) (observed 1.4e-3 and 3.8e-4 at most). E's
    (3e-2, 3e-2) are held over the whole U-Net, the norm of all its grads
    and each grad against the largest: its GroupNorm biases' grads are
    near-cancelling sums over the volume, where XLA's CPU fp32 conv
    backward, 1.6e-2 of a param's largest grad from fp64 sums
    (test_unet_grads_match_jax), reads up to 7e-2 of such a param's own
    (observed over the net 1.7e-3 and 1.5e-2 elementwise)."""
    cfg = dict(RENDER, ray_chunks=4, density_noise=False)
    step_kwargs = dict(
        batch_split=2, enable_discriminator=True, photo_loss=True, load_voxel=True,
        load_pcl=False, random_gen_img=False, noise_weight=0.0, r1_lambda=10.0,
        grad_clip=1.0, z_reg_weight=0.01, grad_accum_scale=3.0, gen_lr=1e-4, disc_lr=2e-4,
        enc_lr=5e-5, betas=(0.0, 0.9), weight_decay=1e-3, mapping_lr_mult=0.5)
    jcfg = jts.TrainStepConfig(render=JRenderConfig(**cfg), **step_kwargs)
    tcfg = TrainStepConfig(render=RenderConfig(**cfg), **step_kwargs)
    B = 4
    rng = np.random.default_rng(40)
    batch = {
        "img": rng.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32),
        "cam2world": _cams(B, seed=41).numpy(),
        "voxel": np.concatenate([_voxels(seed=42), _voxels(seed=43)]),
    }
    (jgen, jenc, jdisc), (tgen, tenc, tdisc) = _models(path, discriminator=True)
    wrapped_gen = _DeterministicGenerator(jgen)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jts.create_train_state(jax.random.PRNGKey(44), wrapped_gen, jenc, jdisc,
                                   j_batch, jcfg)
    _scale_head(state.params_G)
    nets = {"G": (tgen, state.params_G), "E": (tenc, state.params_E),
            "D": (tdisc, state.params_D)}
    for module, params in nets.values():
        module.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))

    j_recorded = _record_jax_grads(monkeypatch)
    j_step = jax.jit(jts.make_train_step(wrapped_gen, jenc, jdisc, jcfg))
    _, j_metrics = j_step(state, j_batch, jax.random.PRNGKey(45), jnp.float32(0.5),
                          jnp.float32(0.0))
    jax.effects_barrier()

    t_state = create_train_state(tgen, tenc, tdisc, tcfg)
    t_recorded = _record_port_grads(t_state)
    _, t_metrics = make_train_step(tcfg)(
        t_state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, 0.5, 0.0)

    for name in ("g_loss", "photo_loss", "z_reg", "d_loss"):
        np.testing.assert_allclose(t_metrics[name].item(), float(j_metrics[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    assert float(t_metrics["photo_loss"]) > 0.0
    tols = {"G": (2e-3, 1e-2), "D": (1e-2, 3e-2), "E": (3e-2, 3e-2)}
    for net in nets:
        ref = bridge.params_to_state_dict(_np_tree(j_recorded[net]))
        assert set(ref) == set(t_recorded[net])
        norm_tol, max_tol = tols[net]
        pairs = [(name, t_recorded[net][name].numpy(), g.numpy()) for name, g in ref.items()]
        if net == "E":  # the whole U-Net as one vector
            t, g = (np.concatenate([p[i].ravel() for p in pairs]) for i in (1, 2))
            pairs = [("all", t, g)]
        for name, t, g in pairs:
            assert np.linalg.norm(t - g) <= norm_tol * np.linalg.norm(g) + 1e-12, f"{net} {name}"
            np.testing.assert_allclose(t, g, rtol=0, atol=max_tol * np.abs(g).max() + 1e-12,
                                       err_msg=f"{net} {name}")
        assert max(np.abs(g).max() for _, _, g in pairs) > 0, net
    # the U-Net trained through the sampler, through every decoder level
    # (the pyramid's coarse level through its own lookup)
    e_grads = t_recorded["E"]
    assert all(np.abs(e_grads[f"decoders.{i}.conv2.conv.weight"].numpy()).max() > 0
               for i in range(UNET["num_levels"] - 1))


@pytest.mark.parametrize("kind", ["PyramidUNet3D", "ResidualUNet3D"])
def test_unet_grads_match_jax(kind):
    """jax.grad of a weighted sum of every output (each pyramid level, or the
    volume, and the global feature) against torch autograd of the port run
    in fp64, f_maps 8, 3 levels, 16^3. fp64 because the CPU's fp32 conv
    backward (oneDNN, which XLA's CPU backend uses too) is far from exact
    sums and its distance depends on the thread count: on one thread the
    port's fp32 grads read up to 0.47 of a ResidualUNet3D param's largest
    grad from its fp64 ones, on eight 5.2e-6. JAX's fp32 grads are up to
    1.6e-2 of a param's largest grad from the port's fp64 ones (8.5e-4 for
    PyramidUNet3D), held at 3e-2, plus 1e-5 of the net's largest grad (a
    bias ahead of a GroupNorm of one channel a group has a grad of 0 up to
    roundings)."""
    vox = _voxels(seed=46)
    unet = dict(UNET, return_global=True)
    jenc = j_make_unet(kind, **unet)
    params = jenc.init(jax.random.PRNGKey(46), jnp.asarray(vox))
    outs = jax.tree.leaves(jenc.apply(params, jnp.asarray(vox)))
    rng = np.random.default_rng(47)
    weights = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def j_loss(p):
        return sum(jnp.sum(o * w) for o, w in
                   zip(jax.tree.leaves(jenc.apply(p, jnp.asarray(vox))), weights))

    ref = bridge.params_to_state_dict(_np_tree(jax.jit(jax.grad(j_loss))(params)))
    tenc = make_unet(kind, **unet)
    tenc.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    tenc.double()
    out = tenc(torch.from_numpy(vox).double())
    leaves = [*out[0], out[1]] if kind == "PyramidUNet3D" else list(out)
    sum((o * torch.from_numpy(w).double()).sum() for o, w in zip(leaves, weights)).backward()
    grads = {n: p.grad.numpy() for n, p in tenc.named_parameters()}
    assert set(ref) == set(grads)
    floor = 1e-5 * max(np.abs(g).max() for g in grads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(ref[name].numpy(), g, rtol=0,
                                   atol=3e-2 * np.abs(g).max() + floor, err_msg=name)


@pytest.mark.parametrize("path", list(PATHS))
def test_variant_render_matches_jax(path):
    """The port's encode, then one deterministic 16^2 render (6 + 6 samples,
    4 ray chunks) against the JAX generator's render of the same encoder
    output (the U-Nets are held in test_torch_voxel_variants.py): the
    SIREN's fp32 sums in another order, as test_torch_voxel.py holds a
    render from one encode (5e-5; observed 3.0e-6)."""
    (jgen, jenc, _), (tgen, tenc, _) = _models(path)
    vox = _voxels(seed=48)
    e_params = jenc.init(jax.random.PRNGKey(48), jnp.asarray(vox))
    z_j = jenc.apply(e_params, jnp.asarray(vox))
    z_j = tuple(z_j) if isinstance(z_j, list) else z_j
    cams = _cams(2, seed=49)
    cfg = dict(RENDER, perturb=False, ray_chunks=4)
    g_params = jgen.init(jax.random.PRNGKey(49), z_j, jnp.asarray(cams.numpy()),
                         JRenderConfig(**cfg))
    _scale_head(g_params)
    tenc.load_state_dict(bridge.params_to_state_dict(_np_tree(e_params)))
    tgen.load_state_dict(bridge.params_to_state_dict(_np_tree(g_params)))
    with torch.no_grad():
        z_t = tenc(torch.from_numpy(vox))
        t_pix, t_depth = tgen(z_t, cams, RenderConfig(**cfg))
    z_t = jax.tree.map(lambda t: jnp.asarray(t.numpy()), z_t)
    z_t = tuple(z_t) if isinstance(z_t, list) else z_t
    j_pix, j_depth = jgen.apply(g_params, z_t, jnp.asarray(cams.numpy()), JRenderConfig(**cfg))
    np.testing.assert_allclose(t_pix.numpy(), np.asarray(j_pix), atol=5e-5)
    np.testing.assert_allclose(t_depth.numpy(), np.asarray(j_depth), atol=5e-5)
    assert np.asarray(j_pix).std() > 1e-3


@pytest.mark.parametrize("path", ["featurepyramid", "dRes"])
def test_chunked_render_takes_one_buffer_a_level(path, monkeypatch):
    """A render in 4 ray chunks, chunks 1-3 under checkpoint (no room
    handed in), on the kernel route: each
    feature volume, a pyramid's every level, goes through one `VolumeGrad`,
    so each level's lookups (coarse and fine in each chunk) scatter into
    that level's one buffer, zeroed once; each level's grad, and the
    SIREN's grads, equal the unchunked render's under plain autograd (fp32
    sums in another order, observed below 1e-6 of each tensor's largest
    grad; the U-Net's own backward is held in test_unet_grads_match_jax)."""
    _, (tgen, tenc, _) = _models(path)
    with torch.no_grad():
        tgen.siren.final_layer.weight.mul_(10.0)
        tgen.siren.final_layer.bias[3] += 1.5
    vox = torch.from_numpy(_voxels(seed=50))
    cams = _cams(2, seed=51)

    def grads(chunks):
        for p in tgen.parameters():
            p.grad = None
        with torch.no_grad():
            z = tenc(vox)
        levels = [t.requires_grad_() for t in (z[0] if path == "featurepyramid" else [z])]
        z = (levels, z[1]) if path == "featurepyramid" else levels[0]
        pix, depth = tgen(z, cams, RenderConfig(**RENDER, ray_chunks=chunks),
                          generator=torch.Generator().manual_seed(52), nerf_noise=0.5)
        rng = np.random.default_rng(53)
        ((pix * torch.from_numpy(rng.normal(size=pix.shape).astype(np.float32))).sum()
         + (depth * torch.from_numpy(rng.normal(size=depth.shape).astype(np.float32))).sum()
         ).backward()
        out = {f"level {i}": t.grad.clone() for i, t in enumerate(levels)}
        out.update({n: p.grad.clone() for n, p in tgen.named_parameters()
                    if p.grad is not None})
        return out

    ref = grads(0)
    _chunk_memory(monkeypatch, 4, keep=False)
    calls = _kernel_route(monkeypatch)
    got = grads(4)
    levels = UNET["num_levels"] - 1 if path == "featurepyramid" else 1
    by_buffer = {}
    for c in calls:
        by_buffer.setdefault(c["ptr"], []).append(c)
    assert sorted(len(v) for v in by_buffer.values()) == [2 * 4] * levels
    for v in by_buffer.values():
        _check_one_buffer(v)
    assert set(got) == set(ref) and all(ref[f"level {i}"].abs().max() > 0
                                        for i in range(levels))
    for name, g in ref.items():
        torch.testing.assert_close(got[name], g, rtol=1e-5, atol=1e-5 * float(g.abs().max()),
                                   msg=name)


def test_residual_unet_train_checkpoint_converts(tmp_path):
    """A JAX TrainState of the `dg_dis` preset with `unet.type`
    ResidualUNet3D (the documented override), its Adam moments filled with
    seeded values, saved as a JAX trainer checkpoint and converted by
    `bridge.convert_train_checkpoint`: the port's checkpoint holds the JAX
    params (the transposed convs' kernels included) and moments bit for
    bit."""
    cur = load_curriculum(config_base="thousand", config="dg_dis")
    cur["unet"]["type"] = "ResidualUNet3D"
    run = tmp_path / "run"
    run.mkdir()
    curriculum_to_json(cur, run / "curriculum.json")
    meta = j_extract_metadata(cur, 3)
    jgen = JGenerator(siren_type=meta["generator"]["siren_type"],
                      z_dim=meta["generator"]["z_dim"],
                      input_dim=meta["generator"]["input_dim"])
    jenc = j_make_unet(**meta["unet"])
    jdisc = j_make_discriminator(meta["discriminator"])
    jcfg = jts.TrainStepConfig.from_metadata(meta)
    batch = {"img": np.zeros((2, 32, 32, 3), np.float32),
             "cam2world": np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
             "voxel": _voxels(seed=54)}
    state = jts.create_train_state(jax.random.PRNGKey(54), jgen, jenc, jdisc,
                                   {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    rng = np.random.default_rng(55)

    def seeded(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            return rng.uniform(0.1, 1.0, x.shape).astype(x.dtype)
        return np.full_like(x, 3)  # Adam's count

    state = jax.device_get(state)
    state = state.replace(step=np.asarray(4, np.int32),
                          **{f"opt_{n}": jax.tree.map(seeded, getattr(state, f"opt_{n}"))
                             for n in "GED"})
    path = j_save(run / "checkpoints", 3, state, {"photometry_losses": [0.5]})
    converted = bridge.convert_train_checkpoint(path)
    assert converted == run / "checkpoints" / "3.pt"
    saved = torch.load(converted, map_location="cpu", weights_only=True)
    assert saved["step"] == 4
    assert any(name.startswith("upconvs.") for name in saved["params_E"])
    for net in "GED":
        params = bridge.params_to_state_dict(_np_tree(getattr(state, f"params_{net}")))
        assert set(params) == set(saved[f"params_{net}"])
        for name, value in params.items():
            assert torch.equal(saved[f"params_{net}"][name], value), (net, name)
    # the port's encoder of that curriculum loads the converted params
    enc = make_unet(**cur["unet"])
    enc.load_state_dict(saved["params_E"])
    assert len(enc.upconvs) == cur["unet"]["num_levels"] - 1
