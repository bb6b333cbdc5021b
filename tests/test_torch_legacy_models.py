"""The rest of the JAX package's models and losses on the CPU, against the
JAX package on bridged weights: the legacy strided discriminators
(Strided, CCS, CCSEncoder; tests/test_torch_cond_dis.py's
`check_discriminator`), TALLSIREN's per-point `pointfeat` mapping,
the `LongMappingNetwork` of SHORTSIREN, SPATIALSIRENBASELINE and
EmbeddingPiGAN (fp32 and under the presets' bf16 policy, grads in fp32),
the zeros-padding / align_corners lookup with its grads, points outside
the cube among them (also against `F.grid_sample`), the fixture writer's
zeros lookup, `generate_avg_frequencies`, `geometry_loss` and `z_sampler`.

About 80 s on one CPU process, most of it JAX compiles (the
discriminators' 12 cases ~55 s).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import make_siren as j_make_siren
from conditioned_nerf_gan_tpu.models import generator as jgenerator
from conditioned_nerf_gan_tpu.models import siren as jsiren
from conditioned_nerf_gan_tpu.ops import grid_sample as jgs
from conditioned_nerf_gan_tpu.training import losses as jlosses
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.data import synthetic
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, make_siren
from conditioned_nerf_gan_torch.models import siren as tsiren
from conditioned_nerf_gan_torch.models.generator import generate_avg_frequencies
from conditioned_nerf_gan_torch.ops import grid_sample as tgs
from conditioned_nerf_gan_torch.training import losses
from test_torch_cond_dis import check_discriminator

POLICY_J = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True, use_pallas=True)
POLICY_T = dict(compute_dtype=torch.bfloat16, use_fast_sin=True, use_kernel=True)
C, H, Z = 8, 32, 16  # sampled features, SIREN width, latent


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("img", [32, 64])
@pytest.mark.parametrize("name", ["StridedDiscriminator", "CCSDiscriminator",
                                  "CCSEncoderDiscriminator"])
def test_strided_discriminator_matches_jax(name, img, precision, monkeypatch):
    """The legacy strided discriminators, as tests/test_torch_cond_dis.py
    holds the progressive ones: (pred, None, None) or the three heads."""
    check_discriminator(name, img, precision, monkeypatch)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(seed, n=2, points=40, side=8):
    rng = np.random.default_rng(seed)
    vol = rng.normal(0, 0.5, (n, side, side, side, C)).astype(np.float32)
    z = rng.normal(size=(n, Z)).astype(np.float32)
    pts = rng.uniform(-0.7, 0.7, (n, points, 3)).astype(np.float32)
    return vol, z, pts


def _pair(name, policy, cond, pts, **kwargs):
    """The JAX and port SIRENs of `name` on the JAX init's weights."""
    jmodel = j_make_siren(name, hidden_dim=H, **(POLICY_J if policy else {}), **kwargs)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(pts), cond)
    tmodel = make_siren(name, hidden_dim=H, **(POLICY_T if policy else {}), **kwargs)
    tmodel.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("policy", [False, True], ids=["fp32", "policy"])
def test_tallsiren_pointfeat_matches_jax(policy):
    """TALLSIREN on a bare volume: FiLM per point from
    PointFeaturesMappingNetwork of the features sampled at the points, off
    the fused kernel under the policy too (its freq has ndim 3, the JAX
    gate's and the port's). Under the policy each FiLM layer takes bf16
    operands, fp32 sums and fast_sin on both sides. fp32 sums in another
    order growing ~freq x per layer over 8 layers: test_torch_voxel.py's
    bound 1e-4 (observed 1.1e-6 fp32, 7.6e-6 policy)."""
    vol, _, pts = _inputs(seed=1)
    jmodel, params, tmodel = _pair("TALLSIREN", policy, jnp.asarray(vol), pts, z_dim=C)
    freq, _ = tmodel.mapping_network(torch.zeros(2, 40, C))
    assert freq.shape == (2, 40, 8 * H) and not tmodel.routes_to_kernel(freq * 15 + 30)
    assert type(tmodel.mapping_network).__name__ == "PointFeaturesMappingNetwork"
    assert len(tmodel.mapping_network.layers) == 2
    j = jmodel.apply(params, jnp.asarray(pts), jnp.asarray(vol))
    t_vol = torch.from_numpy(vol).requires_grad_(not policy)
    t = tmodel(torch.from_numpy(pts), t_vol)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-4)
    if policy:
        return
    # grads of a weighted sum, params and volume, in fp32 (observed 2e-6 of
    # each leaf's largest)
    w = np.random.default_rng(2).normal(size=t.shape).astype(np.float32)
    j_grads, j_dvol = jax.grad(
        lambda p, v: jnp.sum(jmodel.apply(p, jnp.asarray(pts), v) * w), argnums=(0, 1))(
        params, jnp.asarray(vol))
    (t * torch.from_numpy(w)).sum().backward()
    ref = bridge.params_to_state_dict(_np_tree(j_grads))
    for name, p in tmodel.named_parameters():
        g = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-12, err_msg=name)
    # the volume's grad at bf16 tolerance: JAX forms dV from bf16 one-hot
    # matmuls, the port sums in fp32 (observed 1.4e-3 of the largest)
    np.testing.assert_allclose(t_vol.grad.numpy(), np.asarray(j_dvol), rtol=0,
                               atol=1e-2 * np.abs(np.asarray(j_dvol)).max())


def test_tallsiren_takes_a_pair_and_needs_a_volume():
    """A (volume, global) pair's volume feeds the mapping; the global goes
    unused, as in JAX."""
    vol, z, pts = _inputs(seed=4)
    siren = make_siren("TALLSIREN", z_dim=C, hidden_dim=H)
    bare = siren(torch.from_numpy(pts), torch.from_numpy(vol))
    paired = siren(torch.from_numpy(pts), (torch.from_numpy(vol), torch.from_numpy(z)))
    assert torch.equal(bare, paired)


@pytest.mark.parametrize("mapping", ["CustomMappingNetwork", "LongMappingNetwork"])
def test_shortsiren_selectable_mapping_matches_jax(mapping):
    """SHORTSIREN with the 3- or 5-hidden-layer mapping (fp32; the mapping
    is fp32 on both sides under the policy)."""
    _, z, pts = _inputs(seed=5)
    jmodel, params, tmodel = _pair("SHORTSIREN", False, jnp.asarray(z), pts, z_dim=Z,
                                   mapping_network=mapping)
    assert len(tmodel.mapping_network.layers) == {"CustomMappingNetwork": 4,
                                                  "LongMappingNetwork": 6}[mapping]
    j = jmodel.apply(params, jnp.asarray(pts), jnp.asarray(z))
    with torch.no_grad():
        t = tmodel(torch.from_numpy(pts), torch.from_numpy(z))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


LEGACY = [("SPATIALSIRENBASELINE", {}), ("EmbeddingPiGAN", dict(embedding_res=8))]


def _legacy_pair(name, policy, pts, z, **kwargs):
    dtype = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True) if policy else {}
    tdtype = dict(compute_dtype=torch.bfloat16, use_fast_sin=True) if policy else {}
    if name == "EmbeddingPiGAN":
        jmodel = jsiren.EmbeddingPiGAN(z_dim=Z, hidden_dim=H, **dtype, **kwargs)
        tmodel = tsiren.EmbeddingPiGAN(z_dim=Z, hidden_dim=H, **tdtype, **kwargs)
    else:
        jmodel = j_make_siren(name, z_dim=Z, hidden_dim=H, **dtype)
        tmodel = make_siren(name, z_dim=Z, hidden_dim=H, **tdtype)
    params = jmodel.init(jax.random.PRNGKey(6), jnp.asarray(pts), jnp.asarray(z))
    if name == "EmbeddingPiGAN":  # a cube of scale 0.5, so its features matter
        emb = params["params"]["spatial_embeddings"]
        params["params"]["spatial_embeddings"] = emb * 50.0
    tmodel.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
    return jmodel, params, tmodel


@pytest.mark.parametrize("policy", [False, True], ids=["fp32", "policy"])
@pytest.mark.parametrize("name,kwargs", LEGACY, ids=[n for n, _ in LEGACY])
def test_legacy_sirens_match_jax(name, kwargs, policy):
    """The unconditional pi-GAN baseline and EmbeddingPiGAN (an 8^3 cube)
    at points inside and outside the warp's box, no ray directions (zeros,
    as the generator passes none). Under the policy both take the folded
    FiLM and `_MixedLinear` heads. fp32: test_torch_voxel.py's 1e-4 over 8
    layers (observed 1.4e-6). The policy by L2, as
    tests/test_torch_precision.py holds its nets: a flipped bf16 rounding of
    one input feature moves a point's output (observed 7.7e-4 at 2 of 320
    outputs, 1.3e-4 relative)."""
    _, z, pts = _inputs(seed=8)
    pts = pts * 0.3  # the warp maps +-0.12 to +-1: some points inside, some out
    jmodel, params, tmodel = _legacy_pair(name, policy, pts, z, **kwargs)
    j = jmodel.apply(params, jnp.asarray(pts), jnp.asarray(z))
    t = tmodel(torch.from_numpy(pts), torch.from_numpy(z))
    assert t.shape == (2, 40, 4) and t.dtype == torch.float32
    if policy:
        t, j = t.detach().numpy().astype(np.float64), np.asarray(j, np.float64)
        assert np.linalg.norm(t - j) <= 1e-3 * np.linalg.norm(j)
        return
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-4)
    w = np.random.default_rng(9).normal(size=t.shape).astype(np.float32)
    j_grads = jax.grad(lambda p: jnp.sum(jmodel.apply(p, jnp.asarray(pts), jnp.asarray(z))
                                         * w))(params)
    (t * torch.from_numpy(w)).sum().backward()
    ref = bridge.params_to_state_dict(_np_tree(j_grads))
    assert set(ref) == {n for n, _ in tmodel.named_parameters()}
    for n, p in tmodel.named_parameters():
        g = ref[n].numpy()
        # fp32 in another order, 9 FiLM layers (observed 3e-6 of the largest)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max() + 1e-12, err_msg=n)
    if name == "EmbeddingPiGAN":
        assert np.abs(ref["spatial_embeddings"].numpy()).max() > 0


@pytest.mark.parametrize("name,hidden,side", [("EmbeddingPiGAN128", 128, 96),
                                              ("EmbeddingPiGAN256", 256, 64),
                                              ("SPATIALSIRENBASELINE", 256, None)])
def test_make_siren_builds_the_legacy_variants(name, hidden, side):
    """make_siren's widths and cubes (siren.py:428-474), and a forward."""
    siren = make_siren(name, z_dim=Z, generator=torch.Generator().manual_seed(0))
    assert siren.film_layers[1].linear.weight.shape == (hidden, hidden)
    assert len(siren.film_layers) == 8
    if side is not None:
        assert siren.spatial_embeddings.shape == (1, side, side, side, 32)
        assert siren.film_layers[0].linear.weight.shape == (hidden, 35)
        assert siren.film_layers[0].linear.weight.abs().max() <= 1 / 3
    out = siren(torch.zeros(1, 5, 3), torch.zeros(1, Z))
    assert out.shape == (1, 5, 4) and torch.isfinite(out).all()


def test_every_registry_name_builds():
    for name in tsiren.SIREN_REGISTRY:
        make_siren(name, z_dim=C, input_dim=C, hidden_dim=H)
    with pytest.raises(ValueError, match="Unknown"):
        make_siren("NoSuchSiren")


@pytest.mark.parametrize("align", [True, False])
def test_masked_lookup_and_grads_match_jax(align):
    """The zeros lookup against the JAX one and `F.grid_sample`, and its
    grads (volume and coordinates, torch autograd) against jax.vjp, at
    points inside, on the faces of and outside the cube (|coord| up to
    1.6). fp32: the forward within 1e-5 relative, the grads within 1e-5 of
    their largest (observed 2e-7)."""
    rng = np.random.default_rng(10)
    vol = rng.normal(size=(2, 5, 6, 7, 3)).astype(np.float32)
    coords = rng.uniform(-1.6, 1.6, (2, 64, 3)).astype(np.float32)
    coords[:, :6] = [[-1, -1, -1], [1, 1, 1], [1, 0, -1], [0, 0, 0], [-1, 0.5, 1], [0.9, -1, 0]]
    g = rng.normal(size=(2, 64, 3)).astype(np.float32)
    kw = dict(align_corners=align, padding_mode="zeros")
    j, vjp = jax.vjp(lambda v, c: jgs.trilinear_point_features(v, c, **kw),
                     jnp.asarray(vol), jnp.asarray(coords))
    j_dvol, j_dcoords = vjp(jnp.asarray(g))
    t_vol = torch.from_numpy(vol).requires_grad_()
    t_coords = torch.from_numpy(coords).requires_grad_()
    before = tgs.trilinear_point_features.launches
    t = tgs.trilinear_point_features(t_vol, t_coords, **kw)
    assert tgs.trilinear_point_features.launches == before  # plain torch, no kernel
    scale = float(np.abs(vol).max())
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=1e-5 * scale)
    ref = F.grid_sample(t_vol.detach().permute(0, 4, 1, 2, 3), t_coords.detach()[:, :, None, None],
                        mode="bilinear", **kw)[:, :, :, 0, 0].permute(0, 2, 1)
    np.testing.assert_allclose(t.detach().numpy(), ref.numpy(), rtol=0, atol=1e-5 * scale)
    t.backward(torch.from_numpy(g))
    for ours, theirs in ((t_vol.grad, j_dvol), (t_coords.grad, j_dcoords)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=1e-5 * np.abs(theirs).max())
    with pytest.raises(ValueError, match="padding_mode"):
        tgs.trilinear_point_features(t_vol, t_coords, padding_mode="reflection")


def _old_zeros_trilerp(volume, coords):
    """The fixture writer's zeros lookup as it stood before it became
    `ops.grid_sample.masked_trilerp`, kept to show the files unchanged."""
    B, D, H, W, C = volume.shape
    flat = volume.reshape(B, D * H * W, C)
    f = [((coords[..., i] + 1.0) * size - 1.0) / 2.0 for i, size in enumerate((W, H, D))]
    lo = [torch.floor(v) for v in f]
    t = [v - l for v, l in zip(f, lo)]
    lo = [l.long() for l in lo]
    out = torch.zeros((B, coords.shape[1], C), dtype=volume.dtype, device=volume.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix, iy, iz = lo[0] + dx, lo[1] + dy, lo[2] + dz
                w = ((t[0] if dx else 1.0 - t[0]) * (t[1] if dy else 1.0 - t[1])
                     * (t[2] if dz else 1.0 - t[2]))
                valid = ((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0)
                         & (iz < D))
                index = ((iz.clamp(0, D - 1) * H + iy.clamp(0, H - 1)) * W
                         + ix.clamp(0, W - 1))
                corner = torch.gather(flat, 1, index[..., None].expand(-1, -1, C))
                out = out + corner * torch.where(valid, w, 0.0)[..., None]
    return out


def test_fixture_is_byte_equal_through_the_one_zeros_lookup(tmp_path, monkeypatch):
    """The fixture written through `masked_trilerp` is the fixture written
    through the writer's former lookup, file for file and byte for byte."""
    kw = dict(n_cars=2, n_views=2, img_size=16, n_points=256, voxel_resolutions=(32,),
              device="cpu")
    new = synthetic.make_synthetic_shapenet(tmp_path / "new", **kw).parent
    monkeypatch.setattr(synthetic, "zeros_trilerp", _old_zeros_trilerp)
    old = synthetic.make_synthetic_shapenet(tmp_path / "old", **kw).parent
    files = sorted(p.relative_to(old) for p in old.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(new) for p in new.rglob("*") if p.is_file())
    assert any(f.suffix == ".png" for f in files)
    for f in files:
        assert (old / f).read_bytes() == (new / f).read_bytes(), f


def test_generate_avg_frequencies_matches_jax(monkeypatch):
    """The mapping's mean freq/phase over the same latents (both draws
    replaced by them: the streams differ), SHORTSIREN and TALLSIREN_FG; a
    name without a mapping raises, as in JAX."""
    n = 64
    z = np.random.default_rng(11).normal(size=(n, Z)).astype(np.float32)
    models = []
    for name in ("SHORTSIREN", "TALLSIREN_FG"):
        jgen = JGenerator(siren_type=name, z_dim=Z, hidden_dim=H)
        jmodel = j_make_siren(name, z_dim=Z, hidden_dim=H)
        cond = ((jnp.zeros((1, 4, 4, 4, C)), jnp.zeros((1, Z))) if name != "SHORTSIREN"
                else jnp.zeros((1, Z)))
        params = {"params": {"siren": jmodel.init(jax.random.PRNGKey(12), jnp.zeros((1, 4, 3)),
                                                  cond)["params"]}}
        tgen = ImplicitGenerator3d(siren_type=name, z_dim=Z, hidden_dim=H,
                                   input_dim=3 if name == "SHORTSIREN" else C)
        tgen.load_state_dict(bridge.params_to_state_dict(_np_tree(params)))
        models.append((jgen, params, tgen))
    normal = jax.random.normal  # flax's shape check of a param calls its init too

    def latents(key, shape, *args, **kwargs):
        return jnp.asarray(z) if tuple(shape) == z.shape else normal(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "normal", latents)
    monkeypatch.setattr(torch, "randn", lambda *args, **kwargs: torch.from_numpy(z))
    for jgen, params, tgen in models:
        j_freq, j_phase = jgenerator.generate_avg_frequencies(jgen, params, None, n)
        t_freq, t_phase = generate_avg_frequencies(tgen, n)
        for t, j in ((t_freq, j_freq), (t_phase, j_phase)):
            assert t.shape == (1, j.shape[1]) == (1, 4 * H if tgen.siren_type == "SHORTSIREN"
                                                  else 8 * H)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no mapping"):
        generate_avg_frequencies(ImplicitGenerator3d(siren_type="SHORTSIREN_F", z_dim=Z,
                                                     input_dim=C, hidden_dim=H), 4)
    g = ImplicitGenerator3d(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H)
    a = generate_avg_frequencies(g, 8, generator=torch.Generator().manual_seed(0))
    b = generate_avg_frequencies(g, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_geometry_loss_and_z_sampler():
    sigma = np.random.default_rng(13).normal(size=(3, 10)).astype(np.float32) * 4
    np.testing.assert_allclose(losses.geometry_loss(torch.from_numpy(sigma), 4).item(),
                               float(jlosses.geometry_loss(jnp.asarray(sigma), 4)), rtol=1e-6)
    # the streams differ: shapes, ranges and the seed's determinism
    g = losses.z_sampler((500, 8), generator=torch.Generator().manual_seed(1))
    j = jlosses.z_sampler(jax.random.PRNGKey(1), (500, 8))
    assert g.shape == j.shape == (500, 8) and g.dtype == torch.float32
    assert abs(g.mean().item()) < 0.1 and abs(g.std().item() - 1) < 0.1
    u = losses.z_sampler((500, 8), "uniform", generator=torch.Generator().manual_seed(1))
    ju = jlosses.z_sampler(jax.random.PRNGKey(1), (500, 8), "uniform")
    assert -1 <= u.min() and u.max() < 1 and float(jnp.min(ju)) >= -1
    assert torch.equal(u, losses.z_sampler((500, 8), "uniform",
                                           generator=torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="z_dist"):
        losses.z_sampler((2,), "cauchy")
    with pytest.raises(ValueError, match="z_dist"):
        jlosses.z_sampler(jax.random.PRNGKey(0), (2,), "cauchy")
