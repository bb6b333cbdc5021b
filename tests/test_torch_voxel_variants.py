"""The rest of the voxel family on the CPU, module by module, each against
the JAX package on bridged weights: PyramidUNet3D and ResidualUNet3D (and
UNet3D) in fp32 and under the presets' bf16 policy, the order DSL's other
letters, the segmentation head, every SIREN spec that is new to the port
(in fp32 and under the policy, with the kernel gate asserted), the pyramid
lookup, the border trilerp on volumes with a side of 1 with its VJP, K1's
and K2's plain versions at the new input widths (Din 224 and 35) against
the Pallas pair in interpret mode, and the Inferencer's refusal of a
pyramid beside the JAX Inferencer's fault on the same input.

The kernels themselves run only on a card: tests/test_torch_cuda.py (marker
`cuda`) skips here, and `python3 chip_smoke.py` phase 13 holds them against
their plain versions at the main path's shapes. About 40 s on one CPU
process, most of it JAX compiles.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.infer.inference import Inferencer as JInferencer
from conditioned_nerf_gan_tpu.models import make_siren as j_make_siren
from conditioned_nerf_gan_tpu.models import make_unet as j_make_unet
from conditioned_nerf_gan_tpu.models import siren as jsiren
from conditioned_nerf_gan_tpu.ops import grid_sample as jgs
from conditioned_nerf_gan_tpu.ops.pallas import film_siren as jfs
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.infer import inference as tinference
from conditioned_nerf_gan_torch.models import make_siren, make_unet
from conditioned_nerf_gan_torch.models import siren as tsiren
from conditioned_nerf_gan_torch.ops import grid_sample as tgs
from conditioned_nerf_gan_torch.ops.kernels import film_siren as tfs

UNET = dict(in_channels=4, out_channels=8, f_maps=8, num_levels=3, return_global=True)
GLOBAL, H = 32, 32  # the U-Net's global width (8 * 2^2), the SIREN width
POLICY_J = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True, use_pallas=True)
POLICY_T = dict(compute_dtype=torch.bfloat16, use_fast_sin=True, use_kernel=True)
UNET_POLICY_J = dict(dtype=jnp.bfloat16)
UNET_POLICY_T = dict(compute_dtype=torch.bfloat16)


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


def _unets(kind, seed, policy=False, **overrides):
    """The JAX and port U-Nets of `kind` on the same jittered weights."""
    kwargs = dict(UNET, **overrides)
    vox = _voxels(seed)
    jenc = j_make_unet(kind, **kwargs, **(UNET_POLICY_J if policy else {}))
    params = _jitter(jenc.init(jax.random.PRNGKey(seed), jnp.asarray(vox)), seed + 1)
    tenc = make_unet(kind, **kwargs, **(UNET_POLICY_T if policy else {}))
    tenc.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    return jenc, params, tenc, vox


def _outputs(out):
    """A U-Net's result as a flat list of numpy arrays (pyramid levels
    first, then the global feature)."""
    if isinstance(out, (tuple, list)):
        return [a for part in out for a in _outputs(part)]
    return [np.asarray(out.float() if isinstance(out, torch.Tensor) else out, np.float32)]


@pytest.mark.parametrize("policy", [False, True], ids=["fp32", "policy"])
@pytest.mark.parametrize("kind", ["UNet3D", "PyramidUNet3D", "ResidualUNet3D"])
def test_unets_match_jax(kind, policy):
    """Every output (the volume, or each pyramid level, and the global
    feature) against the JAX U-Net of the same type. fp32: convs summed in
    another order and GroupNorm's variance taken another way, ~10 norms deep
    on a volume of max ~3 (test_torch_voxel.py's bound, 2e-4; observed
    6e-5). Policy: bf16 convs between fp32 GroupNorms, where one fp32 ulp of
    a statistic flips bf16 roundings downstream; held as
    test_torch_precision.py holds UNet3D's policy, |port - JAX|_2 / |JAX|_2
    within 1.2e-2 for a volume or level and 2e-3 for the global feature
    (observed at most 6.2e-3 and 8.3e-4 there)."""
    jenc, params, tenc, vox = _unets(kind, seed=0, policy=policy)
    j = _outputs(jenc.apply(params, jnp.asarray(vox)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the policy's bounds were read on one: conv sums follow the threads
    try:
        with torch.no_grad():
            out = tenc(torch.from_numpy(vox))
    finally:
        torch.set_num_threads(threads)
    t = _outputs(out)
    if kind == "PyramidUNet3D":
        levels, glob = out
        assert [tuple(v.shape) for v in levels] == [(2, 8, 8, 8, 16), (2, 16, 16, 16, 8)]
        assert all(v.dtype == torch.float32 and v.is_contiguous() for v in levels)
        assert not hasattr(tenc, "final_conv")
    assert len(t) == len(j)
    for i, (a, b) in enumerate(zip(t, j)):
        assert a.shape == b.shape
        if policy:
            rel = np.linalg.norm((a - b).astype(np.float64)) / np.linalg.norm(b)
            assert rel <= (2e-3 if i == len(t) - 1 else 1.2e-2), (i, rel)
        else:
            np.testing.assert_allclose(a, b, atol=2e-4 * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("order", ["gcr", "cge", "gcl", "bcr"])
@pytest.mark.parametrize("kind", ["ResidualUNet3D", "UNet3D"])
def test_layer_orders_match_jax(kind, order):
    """The order DSL: g GroupNorm, b a GroupNorm of one group a channel, c
    conv, r ReLU, e ELU, l LeakyReLU(0.1); ExtResNetBlock's conv3 without
    r, e, l and its final activation by the order's letter. fp32, bound as
    test_unets_match_jax's (observed 5e-5)."""
    jenc, params, tenc, vox = _unets(kind, seed=3, layer_order=order)
    j = _outputs(jenc.apply(params, jnp.asarray(vox)))
    with torch.no_grad():
        t = _outputs(tenc(torch.from_numpy(vox)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, atol=2e-4 * max(np.abs(b).max(), 1.0))
    if "b" in order:
        norm = tenc.encoders[1].conv1.batchnorm
        assert norm.num_groups == norm.num_channels


@pytest.mark.parametrize("final_sigmoid", [True, False], ids=["sigmoid", "softmax"])
def test_segmentation_head_matches_jax(final_sigmoid):
    """is_segmentation with testing: a sigmoid, or a softmax over the
    channels, on the final conv (observed 1e-7)."""
    jenc, params, tenc, vox = _unets("UNet3D", seed=5, is_segmentation=True, testing=True,
                                     final_sigmoid=final_sigmoid, return_global=False)
    j = np.asarray(jenc.apply(params, jnp.asarray(vox)))
    with torch.no_grad():
        t = tenc(torch.from_numpy(vox)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)
    if not final_sigmoid:
        np.testing.assert_allclose(t.sum(-1), 1.0, atol=1e-5)


def test_unet_defaults_and_refusals():
    """ResidualUNet3D defaults to 5 levels (transposed convs up), the
    others to 4; an unknown type or order letter raises."""
    kwargs = dict(in_channels=4, out_channels=8, f_maps=8)
    res = make_unet("ResidualUNet3D", **kwargs)
    assert len(res.encoders) == 5 and len(res.upconvs) == 4
    assert tuple(res.upconvs[0].weight.shape) == (128, 64, 3, 3, 3)
    assert len(make_unet("PyramidUNet3D", **kwargs).encoders) == 4
    with pytest.raises(ValueError, match="Unknown"):
        make_unet("NoSuchUNet", **kwargs)
    with pytest.raises(ValueError, match="Unsupported"):
        make_unet(**kwargs, layer_order="gcx")


def _feature_inputs(seed, n=2, levels=((4, 16), (8, 8))):
    """Feature volumes (one a level, (side, C)), a global feature and
    points."""
    rng = np.random.default_rng(seed)
    vols = [rng.normal(0, 0.5, (n, s, s, s, c)).astype(np.float32) for s, c in levels]
    glob = rng.normal(size=(n, GLOBAL)).astype(np.float32)
    pts = rng.uniform(-0.7, 0.7, (n, 40, 3)).astype(np.float32)
    return vols, glob, pts


# each newly ported spec with the conditioning it takes: "volume" a bare
# feature volume, "pair" (volume, global), "pyramid" ([levels], global)
NEW_SPECS = [("TALLSIREN_dRes", "volume"), ("TALLSIREN_dResLong", "volume"),
             ("SHORTSIREN_F", "volume"), ("SHORTSIREN_FRes", "volume"),
             ("TALLSIREN_dgx", "pair"), ("SHORTSIREN_FG_Pyrmd", "pyramid"),
             ("DOUBLESIREN_FG", "pyramid")]


def _conditioning(cond, vols, glob, lib):
    as_array = jnp.asarray if lib == "jax" else torch.from_numpy
    if cond == "volume":
        return as_array(vols[1])
    if cond == "pair":
        return (as_array(vols[1]), as_array(glob))
    return ([as_array(v) for v in vols], as_array(glob))


@pytest.mark.parametrize("policy", [False, True], ids=["fp32", "policy"])
@pytest.mark.parametrize("name,cond", NEW_SPECS, ids=[n for n, _ in NEW_SPECS])
def test_new_sirens_match_jax(name, cond, policy):
    """The spec's SIREN against the JAX one on bridged weights. The kernel
    gate routes the all-FiLM stacks of 2 or more layers under the policy
    (on the CPU the wrapper takes the fp32 reference, as the JAX wrapper
    does off the TPU); the SIREN and residual layers run layer by layer,
    under the policy with bf16 operands, fp32 sums and fast_sin on both
    sides. fp32 sums in another order growing ~freq x per layer over up to
    8 layers: test_torch_voxel.py's bound (1e-4; observed 2.5e-6), which
    also takes the policy's rare flip of a bf16 rounding."""
    vols, glob, pts = _feature_inputs(seed=7)
    width = {"volume": 8, "pair": 8, "pyramid": 24}[cond]
    policy_j, policy_t = (POLICY_J, POLICY_T) if policy else ({}, {})
    jmodel = j_make_siren(name, z_dim=GLOBAL, hidden_dim=H, **policy_j)
    z_j = _conditioning(cond, vols, glob, "jax")
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(pts), z_j)
    tmodel = make_siren(name, z_dim=GLOBAL, input_dim=width, hidden_dim=H, **policy_t)
    tmodel.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    spec = tsiren.SIREN_SPECS[tsiren.resolve_siren_alias(name)]
    freq = None
    if spec.mapping is not None:
        freq, _ = tmodel.mapping_network(torch.from_numpy(glob))
    film = all(k == "film" for k in spec.layers)
    assert tmodel.routes_to_kernel(freq) == (policy and film)
    j = jmodel.apply(params, jnp.asarray(pts), z_j)
    with torch.no_grad():
        t = tmodel(torch.from_numpy(pts), _conditioning(cond, vols, glob, "torch"))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def test_every_spec_but_tallsiren_is_ported():
    """Every spec is ported now, TALLSIREN's per-point `pointfeat` mapping
    and the legacy variants too (ROADMAP A13): each builds; a features
    SIREN with FiLM still needs a (volume, global) pair."""
    for name, spec in tsiren.SIREN_SPECS.items():
        siren = make_siren(name, z_dim=GLOBAL, input_dim=8, hidden_dim=H)
        assert siren.spec == spec
    for name in ("TALLSIREN", "SPATIALSIRENBASELINE", "EmbeddingPiGAN128"):
        assert isinstance(make_siren(name, z_dim=8, hidden_dim=H), torch.nn.Module)
    siren = make_siren("TALLSIREN_dg", z_dim=GLOBAL, input_dim=8, hidden_dim=H)
    with pytest.raises(ValueError, match="pair"):
        siren(torch.zeros(2, 5, 3), torch.zeros(2, 4, 4, 4, 8))


@pytest.mark.parametrize("levels", [1, 3])
def test_pyramid_lookup_matches_jax(levels):
    """`sample_pyramid_features`: every level sampled at the points and
    concatenated in order (the same fp32 lerps, observed 0); one volume
    is a pyramid of one level."""
    vols, _, pts = _feature_inputs(seed=9, levels=((2, 12), (4, 8), (8, 4))[:levels])
    j = jsiren.sample_pyramid_features(jnp.asarray(pts), [jnp.asarray(v) for v in vols])
    t = tsiren.sample_pyramid_features(torch.from_numpy(pts),
                                       [torch.from_numpy(v) for v in vols])
    assert t.shape == (2, 40, sum(v.shape[-1] for v in vols))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    single = tsiren.sample_pyramid_features(torch.from_numpy(pts), torch.from_numpy(vols[0]))
    torch.testing.assert_close(single, t[..., :vols[0].shape[-1]], rtol=0, atol=0)


SIDE_ONE = [(2, 1, 5, 7, 6), (2, 4, 1, 3, 4), (2, 3, 6, 1, 8), (1, 1, 1, 1, 4)]


@pytest.mark.parametrize("shape", SIDE_ONE, ids=["D1", "H1", "W1", "all1"])
def test_side_one_trilerp_and_vjp_match_jax(shape):
    """A volume with a side of 1: the border clamp puts both corners of that
    axis on its one voxel. The plain forward against the JAX lookup (its
    generic path: clamped corners, weights multiplied out; observed 2.4e-7
    of the volume's max) and the plain VJP against jax.vjp of it (fp32
    scatter-adds on both sides: dV observed 4.8e-7, dcoords 9.5e-7 of their
    max; along the side of 1 dcoords is 0)."""
    rng = np.random.default_rng(11)
    vol = rng.normal(size=shape).astype(np.float32)
    coords = rng.uniform(-1.4, 1.4, (shape[0], 50, 3)).astype(np.float32)
    g = rng.normal(size=(shape[0], 50, shape[-1])).astype(np.float32)
    j_out, vjp = jax.vjp(jgs.trilinear_point_features, jnp.asarray(vol), jnp.asarray(coords))
    j_dv, j_dc = vjp(jnp.asarray(g))
    t_vol, t_coords = torch.from_numpy(vol), torch.from_numpy(coords)
    t_out = tgs.border_trilerp_reference(t_vol, t_coords)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=1e-6 * np.abs(vol).max())
    t_dv, t_dc = tgs.border_trilerp_vjp_reference(t_vol, t_coords, torch.from_numpy(g))
    np.testing.assert_allclose(t_dv.numpy(), np.asarray(j_dv),
                               atol=1e-5 * np.abs(np.asarray(j_dv)).max())
    np.testing.assert_allclose(t_dc.numpy(), np.asarray(j_dc),
                               atol=1e-5 * max(np.abs(np.asarray(j_dc)).max(), 1.0))
    for axis, size in enumerate((shape[3], shape[2], shape[1])):
        if size == 1:
            assert not t_dc[..., axis].any()
    # the wrapper takes it on the CPU (the plain version, no launch)
    before = tgs.trilinear_point_features.launches
    torch.testing.assert_close(tgs.trilinear_point_features(t_vol, t_coords), t_out,
                               rtol=0, atol=0)
    assert tgs.trilinear_point_features.launches == before


def _film_inputs(din, L, B=2, N=100, seed=0, freq_scale=1.0):
    """K1/K2 inputs at a narrow width (H 32) as test_torch_film_siren*.py
    draw them, with a cotangent."""
    rng = np.random.default_rng(seed)
    arrays = (
        rng.uniform(-1, 1, (B, N, din)),
        (rng.normal(size=(B, L * H)) * 15 + 30) * freq_scale,
        rng.normal(size=(B, L * H)),
        rng.normal(size=(din, H)) * 0.3 / np.sqrt(din / 3),
        rng.normal(size=(H,)) * 0.1,
        rng.normal(size=(L - 1, H, H)) * 0.05,
        rng.normal(size=(L - 1, H)) * 0.1,
        rng.normal(size=(H, 4)) * 0.05,
        rng.normal(size=(4,)) * 0.1,
    )
    g = rng.normal(size=(B, N, 4))
    return [a.astype(np.float32) for a in arrays], g.astype(np.float32)


WIDE = [(224, 2), (224, 4), (35, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("din,L", WIDE, ids=["din224_l2", "din224_l4", "din35_l8"])
def test_folded_forward_at_new_widths_matches_pallas_interpret(din, L, dtype):
    """K1's plain version (`film_siren_mlp_folded`) at the pyramid's Din 224
    and TALLSIREN_dgx's Din 35 against the Pallas forward in interpret mode
    (100 points, 32-point tiles), at freq/30: the same roundings, fp32 sums
    in another order (test_torch_film_siren.py's bound, 1e-4; observed
    4.5e-7)."""
    arrays, _ = _film_inputs(din, L, freq_scale=1.0 / 30.0)
    j = jfs._forward_pallas(*map(jnp.asarray, arrays), tile=32,
                            matmul_dtype=getattr(jnp, dtype), interpret=True)
    t = tfs.film_siren_mlp_folded(*map(torch.from_numpy, arrays),
                                  matmul_dtype=getattr(torch, dtype))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


@pytest.mark.parametrize("din,L", WIDE, ids=["din224_l2", "din224_l4", "din35_l8"])
def test_folded_vjp_at_new_widths_matches_pallas_interpret(din, L):
    """K2's plain version (`film_siren_mlp_folded_vjp`) against the Pallas
    backward in interpret mode, fp32 operands at freq/30, every one of the
    nine grads within 1e-5 of its largest value (test_torch_film_siren_bwd's
    bound; observed 6.1e-7): dpoints is the pyramid's cotangent, (B, N,
    224)."""
    arrays, g = _film_inputs(din, L, freq_scale=1.0 / 30.0)
    j = jfs._backward_pallas(*map(jnp.asarray, arrays), jnp.asarray(g), tile=32,
                             matmul_dtype=jnp.float32, interpret=True)
    t = tfs.film_siren_mlp_folded_vjp(*map(torch.from_numpy, arrays), torch.from_numpy(g),
                                      matmul_dtype=torch.float32)
    assert t[0].shape == (2, 100, din)
    for a, b in zip(t, j):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


def test_kernel_wrappers_take_the_new_widths():
    """The checks the wrappers run on a card take Din 3, 32, 35 and 224 and
    refuse any other width; the backward's point/cotangent scratch holds x
    and g in whole 64-column blocks."""
    assert tfs.KERNEL_INS == (3, 32, 35, 224)
    for din in tfs.KERNEL_INS:
        arrays, _ = _film_inputs(din, 2)
        arrays[3] = np.zeros((din, tfs.KERNEL_HIDDEN), np.float32)
        t = [torch.from_numpy(a) for a in arrays]
        H_ = tfs.KERNEL_HIDDEN
        t[1:3] = [torch.zeros(2, 2 * H_), torch.zeros(2, 2 * H_)]
        t[4:9] = [torch.zeros(H_), torch.zeros(1, H_, H_), torch.zeros(1, H_),
                  torch.zeros(H_, 4), torch.zeros(4)]
        tfs._check_kernel_inputs(*t)
        tfs._check_kernel_inputs(*t, name="film_siren_mlp_bwd")
        if din == 224:
            wrong = [t[0][..., :100], *t[1:3], t[3][:100], *t[4:]]
            with pytest.raises(ValueError, match="3 or 32 or 35 or 224"):
                tfs._check_kernel_inputs(*wrong)
    assert [tfs.bwd_xg_cols(d) for d in tfs.KERNEL_INS] == [64, 64, 64, 256]


def test_inferencer_refuses_a_pyramid_as_the_jax_one_fails():
    """The JAX Inferencer cannot render a pyramid in blocks: `_tile_z` stacks
    the ragged levels into one array, and the `z_batched` cut slices the
    list of levels instead of the batch. The port's `render_batched` (and
    the interpolation) refuse it, naming the fault."""
    vols, glob, _ = _feature_inputs(seed=13, n=1, levels=((2, 12), (4, 8), (8, 4)))
    z = ([jnp.asarray(v) for v in vols], jnp.asarray(glob))
    seen = []
    stand_in = types.SimpleNamespace(
        _tile_z=JInferencer._tile_z,
        generate_img=lambda z_c, cams, **_: (seen.append(z_c), (
            np.zeros((len(cams), 2, 2, 3)), np.zeros((len(cams), 2, 2))))[1])
    cams = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    with pytest.raises((ValueError, TypeError)):
        JInferencer.render_batched(stand_in, z, cams)
    batched = ([jnp.concatenate([v] * 3) for v in z[0]], jnp.concatenate([z[1]] * 3))
    JInferencer.render_batched(stand_in, batched, cams, chunk=2, z_batched=True)
    # the first block's "levels" are the first two levels, each of batch 3
    assert len(seen[0][0]) == 2 and seen[0][0][0].shape[0] == 3

    port = types.SimpleNamespace(generate_img=None)
    t_z = ([torch.from_numpy(v) for v in vols], torch.from_numpy(glob))
    with pytest.raises(NotImplementedError, match="JAX"):
        tinference.Inferencer.render_batched(port, t_z, cams)
    with pytest.raises(NotImplementedError, match="pyramid"):
        tinference.refuse_pyramid(t_z, "interpolate_latent_codes")
    tinference.refuse_pyramid((t_z[0][0], t_z[1]), "a pair")  # a pair passes
