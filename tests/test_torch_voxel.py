"""The voxel-conditioned family (`dg`: UNet3D + TALLSIREN_FG) on the CPU:
the port's 3-D U-Net, trilinear sampler, FG SIRENs, the whole encode ->
render slice, `_load_car_cond` and the CLI, each against the JAX package on
bridged weights.

The trilinear CUDA kernel and K1 at Din 32 run only on a card:
tests/test_torch_cuda.py (marker `cuda`) skips here, and `python3
chip_smoke.py` holds both against their plain versions at the main path's
shapes.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from flax import serialization

from conditioned_nerf_gan_tpu.infer.inference import Inferencer as JInferencer
from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import make_siren as j_make_siren
from conditioned_nerf_gan_tpu.models import make_unet as j_make_unet
from conditioned_nerf_gan_tpu.ops import grid_sample as jgs
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
from conditioned_nerf_gan_torch.models import make_siren, make_unet
from conditioned_nerf_gan_torch.ops import grid_sample as tgs

UNET = dict(in_channels=4, out_channels=8, f_maps=8, num_levels=3, return_global=True)
GLOBAL, FEAT, H = 32, 8, 32  # the U-Net's global width (8 * 2^2), C, SIREN width
# the preset's policy: on the CPU both kernel wrappers take the fp32 reference
POLICY_J = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True, use_pallas=True)
POLICY_T = dict(compute_dtype=torch.bfloat16, use_fast_sin=True, use_kernel=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jitter(tree, seed, scale=0.05):
    """Perturb every param (GroupNorm's scale 1 and bias 0 too)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + jnp.asarray(rng.normal(0, scale, p.shape), p.dtype), tree)


def _voxels(seed, n=2, side=16):
    """Occupancy + color grids of a few boxes, (n, side, side, side, 4)."""
    rng = np.random.default_rng(seed)
    vox = np.zeros((n, side, side, side, 4), np.float32)
    for b in range(n):
        for _ in range(3):
            lo = rng.integers(0, side // 2, 3)
            hi = lo + rng.integers(2, side // 2, 3)
            vox[b, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = [1.0, *rng.uniform(0, 1, 3)]
    return vox


def _unets(seed):
    vox = _voxels(seed)
    jenc = j_make_unet(**UNET)
    params = _jitter(jenc.init(jax.random.PRNGKey(seed), jnp.asarray(vox)), seed + 1)
    tenc = make_unet(**UNET)
    tenc.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    return jenc, params, tenc, vox


def test_unet3d_matches_jax():
    jenc, params, tenc, vox = _unets(seed=0)
    jvol, jglobal = jenc.apply(params, jnp.asarray(vox))
    with torch.no_grad():
        tvol, tglobal = tenc(torch.from_numpy(vox))
    assert tvol.shape == (2, 16, 16, 16, 8) and tvol.is_contiguous()
    assert tglobal.shape == (2, GLOBAL)
    # fp32 convs summed in another order, GroupNorm's variance taken another
    # way (flax: E[x^2] - E[x]^2), 10 norms deep on a volume of max 3.0: both
    # sides are as far from the port run in fp64 (4.5e-5 port, 3.6e-5 JAX;
    # observed 6.3e-5 between them, 1.3e-6 on the global feature)
    np.testing.assert_allclose(tvol.numpy(), np.asarray(jvol), atol=2e-4)
    np.testing.assert_allclose(tglobal.numpy(), np.asarray(jglobal), atol=1e-5)


def test_unet3d_layout_and_unported_variants():
    """Encoder 0's first GroupNorm takes 1 group over the 4 input channels
    and its conv has no bias under the norm; mid width max(f // 2, c_in).
    The other variants build: PyramidUNet3D without a final conv,
    ResidualUNet3D with transposed convs up, and any order of the DSL
    (their parity: tests/test_torch_voxel_variants.py)."""
    enc = make_unet(**UNET)
    first = enc.encoders[0].conv1
    assert first.norm.num_groups == 1 and first.norm.num_channels == 4
    assert first.conv.bias is None and first.conv.weight.shape == (4, 4, 3, 3, 3)
    assert enc.encoders[1].conv1.norm.num_groups == 8
    assert enc.decoders[0].conv1.conv.weight.shape == (16, 48, 3, 3, 3)
    assert enc.final_conv.bias is not None
    assert not hasattr(make_unet("PyramidUNet3D", **UNET), "final_conv")
    assert len(make_unet("ResidualUNet3D", **UNET).upconvs) == UNET["num_levels"] - 1
    with pytest.raises(ValueError, match="Unknown"):
        make_unet("NoSuchUNet", **UNET)
    assert make_unet(**UNET, layer_order="cge").encoders[0].conv1.elu is not None


def _trilerp_inputs(seed, B=2, D=5, Hs=7, W=9, C=6, N=64):
    """A volume and coords in [-1.5, 1.5]: outside +-1 (the border clamp),
    exactly on the faces (+-1), and exactly on the high/low sample centres
    (f = size - 1 and f = 0, where the anchor shifts)."""
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=(B, D, Hs, W, C)).astype(np.float32)
    coords = rng.uniform(-1.5, 1.5, (B, N, 3)).astype(np.float32)
    sizes = np.array([W, Hs, D], np.float32)
    special = np.stack([np.full(3, 1.0), np.full(3, -1.0), (sizes - 1) / sizes,
                        -(sizes - 1) / sizes, np.zeros(3)]).astype(np.float32)
    coords[:, :len(special)] = special
    coords[:, len(special):2 * len(special)] = special[:, ::-1] * [1, -1, 1]
    return vol, coords


@pytest.mark.parametrize("strategy", ["expanded_slab", "block_gather"])
def test_border_trilerp_matches_jax(strategy, monkeypatch):
    if strategy == "block_gather":
        monkeypatch.setattr(jgs, "_EXPAND_MAX_ELEMS", 0)
    vol, coords = _trilerp_inputs(seed=1)
    j = jgs.trilinear_point_features(jnp.asarray(vol), jnp.asarray(coords))
    t = tgs.border_trilerp_reference(torch.from_numpy(vol), torch.from_numpy(coords))
    # the same fp32 lerps in the same order (observed 0 in both strategies)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_border_trilerp_matches_grid_sample():
    """Against F.grid_sample(bilinear, border, align_corners=False) on the
    NCDHW layout, as tests/test_ops_golden.py holds the JAX op."""
    vol, coords = _trilerp_inputs(seed=2)
    t = tgs.border_trilerp_reference(torch.from_numpy(vol), torch.from_numpy(coords))
    ref = F.grid_sample(torch.from_numpy(vol).permute(0, 4, 1, 2, 3),
                        torch.from_numpy(coords)[:, None, None], mode="bilinear",
                        padding_mode="border", align_corners=False)
    # the same interpolation with another anchor and order of sums
    # (observed 2.4e-7)
    np.testing.assert_allclose(t.numpy(), ref[:, :, 0, 0].permute(0, 2, 1).numpy(),
                               atol=1e-5)


def test_trilinear_wrapper_on_cpu_and_refusals():
    vol, coords = (torch.from_numpy(a) for a in _trilerp_inputs(seed=3))
    before = tgs.trilinear_point_features.launches
    out = tgs.trilinear_point_features(vol, coords)
    assert tgs.trilinear_point_features.launches == before
    torch.testing.assert_close(out, tgs.border_trilerp_reference(vol, coords),
                               rtol=0, atol=0)
    # zeros padding answers in plain torch, no launch (both align_corners);
    # border padding takes align_corners=False alone
    for align in (False, True):
        torch.testing.assert_close(
            tgs.trilinear_point_features(vol, coords, padding_mode="zeros",
                                         align_corners=align),
            tgs.masked_trilerp(vol, coords, align_corners=align), rtol=0, atol=0)
    assert tgs.trilinear_point_features.launches == before
    with pytest.raises(ValueError, match="align_corners=False"):
        tgs.trilinear_point_features(vol, coords, align_corners=True)
    # a side of 1 takes the plain version too (both corners on its voxel)
    thin = vol[:, :1].contiguous()
    torch.testing.assert_close(tgs.trilinear_point_features(thin, coords),
                               tgs.border_trilerp_reference(thin, coords), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel"):
        tgs.trilinear_point_features(vol.to("meta"), coords.to("meta"))


def _conditioning(seed, n=2, side=6):
    rng = np.random.default_rng(seed)
    vol = rng.normal(0, 0.5, (n, side, side, side, FEAT)).astype(np.float32)
    glob = rng.normal(size=(n, GLOBAL)).astype(np.float32)
    return vol, glob


@pytest.mark.parametrize("name,thesis", [
    ("TALLSIREN_FG", True), ("TALLSIREN_FG", False), ("SHORTSIREN_FG", True),
    ("SHORTSIREN_FG", False), ("SingleSIREN_dg", False), ("SingleSIREN_dg", True),
], ids=["TALLSIREN_FG-kernel_gate", "TALLSIREN_FG-fp32_stack",
        "SHORTSIREN_FG-kernel_gate", "SHORTSIREN_FG-fp32_stack",
        "SingleSIREN_dg-fp32_stack", "SingleSIREN_dg-thesis_policy"])
def test_fg_siren_matches_jax(name, thesis):
    policy_j, policy_t = (POLICY_J, POLICY_T) if thesis else ({}, {})
    jmodel = j_make_siren(name, z_dim=GLOBAL, hidden_dim=H, **policy_j)
    rng = np.random.default_rng(4)
    pts = jnp.asarray(rng.uniform(-0.7, 0.7, (2, 40, 3)), jnp.float32)
    vol, glob = _conditioning(seed=5)
    z = (jnp.asarray(vol), jnp.asarray(glob))
    params = jmodel.init(jax.random.PRNGKey(0), pts, z)
    tmodel = make_siren(name, z_dim=GLOBAL, input_dim=FEAT, hidden_dim=H, **policy_t)
    tmodel.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    freq, _ = tmodel.mapping_network(torch.from_numpy(glob))
    assert tmodel.routes_to_kernel(freq) == (thesis and name != "SingleSIREN_dg")
    j = jmodel.apply(params, pts, z)
    with torch.no_grad():
        t = tmodel(torch.from_numpy(np.asarray(pts)),
                   (torch.from_numpy(vol), torch.from_numpy(glob)))
    # fp32 on both sides, sums in another order growing ~freq x per layer
    # over up to 8 layers (observed 8.6e-7 at most). SingleSIREN_dg under the
    # policy is never routed: both layer paths fold freq into bf16 weights,
    # sum bf16 products in fp32 and take fast_sin in fp32, so only the order
    # of the fp32 sums differs, a few fp32 ulps of the pre-activation that
    # rarely flip a bf16 rounding of h (observed 3.0e-8)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def test_fg_siren_refuses_pyramids_and_bare_volumes():
    """An FG SIREN samples a pyramid's every level and concatenates them (its
    first layer as wide as their sum): on a pyramid of one volume twice it
    equals the SIREN of that volume whose first weight is the sum of the
    two halves (fp32 sums in another order, observed 6e-8). It still
    refuses a bare volume: its FiLM needs the global feature."""
    siren = make_siren("TALLSIREN_dg", z_dim=GLOBAL, input_dim=2 * FEAT, hidden_dim=H)
    narrow = make_siren("TALLSIREN_dg", z_dim=GLOBAL, input_dim=FEAT, hidden_dim=H)
    state = siren.state_dict()
    w = state["film_layers.0.linear.weight"]
    state["film_layers.0.linear.weight"] = w[:, :FEAT] + w[:, FEAT:]
    narrow.load_state_dict(state)
    vol, glob = (torch.from_numpy(a) for a in _conditioning(seed=6))
    pts = torch.from_numpy(np.random.default_rng(6).uniform(-0.6, 0.6, (2, 5, 3))
                           .astype(np.float32))
    with torch.no_grad():
        out = siren(pts, ([vol, vol], glob))
        ref = narrow(pts, (vol, glob))
    assert out.shape == (2, 5, 4)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="pair"):
        siren(pts, vol)


def _voxel_generators(seed):
    jgen = JGenerator(siren_type="TALLSIREN_dg", z_dim=GLOBAL, input_dim=FEAT,
                      hidden_dim=H, **POLICY_J)
    vol, glob = _conditioning(seed)
    params = jgen.init(jax.random.PRNGKey(seed), (jnp.asarray(vol), jnp.asarray(glob)),
                       jnp.eye(4)[None].repeat(2, 0), JRenderConfig(img_size=4, num_steps=4))
    # a 10x head: sigma of both signs, so the render is not all background
    head = params["params"]["siren"]["final_layer"]
    head["kernel"] = head["kernel"] * 10.0
    tgen = ImplicitGenerator3d(siren_type="TALLSIREN_dg", z_dim=GLOBAL, input_dim=FEAT,
                               hidden_dim=H, **POLICY_T)
    tgen.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    return jgen, params, tgen


def test_voxel_encode_render_matches_jax(monkeypatch):
    """The slice: encode(voxel) -> (volume, global) -> a 16^2 render with 6 +
    6 samples in 4 ray chunks, against JAX with rng=None. Spies on what
    reaches both kernel wrappers, as the CUDA kernels take contiguous fp32."""
    import conditioned_nerf_gan_torch.models.siren as siren_module
    from conditioned_nerf_gan_torch.ops.rays import (
        create_cam2world_matrix,
        sample_camera_positions,
    )

    calls = {"film": [], "trilerp": []}
    film, trilerp = siren_module.film_siren_mlp, siren_module.trilinear_point_features

    def film_spy(points, *args):
        assert points.is_contiguous() and points.shape[-1] == FEAT
        calls["film"].append(points.shape)
        return film(points, *args)

    def trilerp_spy(volume, coords, **kwargs):
        assert volume.is_contiguous() and coords.is_contiguous()
        calls["trilerp"].append(coords.shape)
        return trilerp(volume, coords, **kwargs)

    monkeypatch.setattr(siren_module, "film_siren_mlp", film_spy)
    monkeypatch.setattr(siren_module, "trilinear_point_features", trilerp_spy)
    jenc, params_E, tenc, vox = _unets(seed=7)
    jgen, params_G, tgen = _voxel_generators(seed=8)
    u = torch.from_numpy(np.random.default_rng(9).uniform(0.1, 0.9, (2, 3))
                         .astype(np.float32))
    cams = create_cam2world_matrix(sample_camera_positions(
        2, cam_r_start=0.7, cam_r_end=1.5, uniforms=u))
    cfg = dict(img_size=16, num_steps=6, fov=49.134342641202636, ray_start=0.25,
               ray_end=1.95, hierarchical_sample=True, white_back=True, perturb=False,
               ray_chunks=4)

    jz = jenc.apply(params_E, jnp.asarray(vox))
    j_pix, j_depth = jax.jit(lambda p, zz, c: jgen.apply(p, zz, c, JRenderConfig(**cfg),
                                                         rng=None))(
        params_G, jz, jnp.asarray(cams.numpy()))
    with torch.no_grad():
        tz = tenc(torch.from_numpy(vox))
        t_pix, t_depth = tgen(tz, cams, RenderConfig(**cfg))
    assert t_pix.shape == (2, 16, 16, 3) and t_depth.shape == (2, 16, 16)
    assert len(calls["film"]) == len(calls["trilerp"]) == 2 * 4  # coarse + fine per chunk
    assert t_pix.std() > 0.1 and t_depth.max() > 1.0  # not all background
    # fp32 on both sides; the U-Nets' own fp32 noise (~3e-5 of the volume,
    # as far from fp64 on either side) grows through the SIREN (observed
    # 7.9e-5 pixels, 6.8e-5 depth)
    np.testing.assert_allclose(t_pix.numpy(), np.asarray(j_pix), atol=5e-4)
    np.testing.assert_allclose(t_depth.numpy(), np.asarray(j_depth), atol=5e-4)
    # the render alone, from the port's encode on both sides (observed
    # 3.9e-6 pixels, 3.0e-6 depth)
    j_pix, j_depth = jax.jit(lambda p, zz, c: jgen.apply(p, zz, c, JRenderConfig(**cfg),
                                                         rng=None))(
        params_G, tuple(jnp.asarray(t.numpy()) for t in tz), jnp.asarray(cams.numpy()))
    np.testing.assert_allclose(t_pix.numpy(), np.asarray(j_pix), atol=5e-5)
    np.testing.assert_allclose(t_depth.numpy(), np.asarray(j_depth), atol=5e-5)


@pytest.fixture(scope="module")
def voxel_run(tmp_path_factory):
    """A run dir with a smoke-scale voxel curriculum (UNet3D f_maps 8, 3
    levels, out 16; TALLSIREN_FG 32 wide), a synthetic dataset with 32^3
    grids, and a port checkpoint converted from a flax msgpack one."""
    from conditioned_nerf_gan_tpu.config import curriculum_to_json, load_curriculum
    from conditioned_nerf_gan_tpu.data import make_synthetic_shapenet

    root = tmp_path_factory.mktemp("torch_voxel_cli")
    ds_root = make_synthetic_shapenet(root / "data", n_cars=2, n_views=2, img_size=16,
                                      n_points=256, voxel_resolutions=(32,))
    curriculum = load_curriculum(config_base="smoke")
    unet = curriculum["unet"]
    curriculum["generator"].update(siren_type="TALLSIREN_dg", z_dim=32,
                                   input_dim=unet["out_channels"], hidden_dim=H)
    curriculum["dataset"].update(path=str(ds_root), load_voxel=True, load_pcl=False)
    run = root / "run"
    run.mkdir()
    curriculum_to_json(curriculum, run / "curriculum.json")

    step = 3
    side = 32
    vox = jnp.zeros((1, side, side, side, unet["in_channels"]))
    jenc = j_make_unet(**unet)
    params_E = jenc.init(jax.random.PRNGKey(1), vox)
    jvol, jglob = jenc.apply(params_E, vox)
    jgen = JGenerator(siren_type="TALLSIREN_dg", z_dim=32, input_dim=unet["out_channels"],
                      hidden_dim=H, use_fast_sin=True)
    params_G = jgen.init(jax.random.PRNGKey(0), (jvol, jglob), jnp.eye(4)[None],
                         JRenderConfig(img_size=4, num_steps=4))
    ckpt = run / "checkpoints" / f"{step}.ckpt"
    ckpt.parent.mkdir()
    ckpt.write_bytes(serialization.to_bytes(
        {"params_G": params_G, "params_E": params_E, "step": step}))
    return bridge.convert_checkpoint(ckpt)


def test_cli_images_on_a_voxel_run(voxel_run):
    from conditioned_nerf_gan_torch.infer.__main__ import main

    assert main([str(voxel_run), "--images", "--num_imgs", "2", "--image_size", "16",
                 "--input_voxel_resolution", "32", "--device", "cpu"]) == 0
    grids = list((voxel_run.parent.parent / "inference").glob("3_random_*.png"))
    assert len(grids) == 1 and grids[0].stat().st_size > 0


@pytest.mark.parametrize("mode", ["voxel", "pcl"])
def test_load_car_cond_matches_jax(voxel_run, mode):
    """`_load_car_cond` of both Inferencers on one synthetic car: the voxel
    grid transposed to NDHWC, or the same random point subset."""
    from conditioned_nerf_gan_torch.infer import Inferencer

    inf = Inferencer(voxel_run, input_voxel_resolution=32, image_size=16,
                     load_dataset=False, seed=3, device="cpu")
    if mode == "pcl":
        inf.curriculum["dataset"]["load_pcl"] = True
        inf.curriculum["num_points_ratio"] = 0.5
    jself = types.SimpleNamespace(curriculum=inf.curriculum, rng=np.random.default_rng(3))
    port = inf._load_car_cond("car0001")
    ref = JInferencer._load_car_cond(jself, "car0001")
    assert port.keys() == ref.keys() == {mode}
    assert port[mode].dtype == np.float32 and port[mode].flags.c_contiguous
    np.testing.assert_array_equal(port[mode], ref[mode])
    if mode == "voxel":
        z = inf.encode(port)
        assert isinstance(z, tuple) and z[0].shape == (1, 32, 32, 32, 16)
        assert z[1].shape == (1, 32)
