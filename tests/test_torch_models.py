"""Port models vs the JAX models on the CPU, with JAX-initialised params
carried across by `conditioned_nerf_gan_torch.bridge`."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import ResnetPointnet as JPointnet
from conditioned_nerf_gan_tpu.models import encode_pcl as j_encode_pcl
from conditioned_nerf_gan_tpu.models import make_siren as j_make_siren
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, ResnetPointnet
from conditioned_nerf_gan_torch.models import encode_pcl, make_siren
from conditioned_nerf_gan_torch.models.layers import kaiming_leaky_init

Z, H = 16, 32


def _jitter(tree, seed, scale=0.1):
    """Perturb every param (zero-initialised ones too, e.g. PointNet fc_1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: p + jnp.asarray(rng.normal(0, scale, p.shape), p.dtype), tree)


def _siren_pair(thesis: bool):
    policy = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True, use_pallas=True) \
        if thesis else {}
    jmodel = j_make_siren("SHORTSIREN", z_dim=Z, hidden_dim=H, **policy)
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-0.6, 0.6, (2, 40, 3)), jnp.float32)
    z = jnp.asarray(rng.normal(size=(2, Z)), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0), pts, z)
    tmodel = make_siren("SHORTSIREN", z_dim=Z, hidden_dim=H,
                        compute_dtype=torch.bfloat16 if thesis else None,
                        use_fast_sin=thesis, use_kernel=thesis)
    tmodel.load_state_dict(bridge.params_to_state_dict(
        jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel, pts, z


@pytest.mark.parametrize("thesis", [True, False], ids=["thesis_gate", "fp32_stack"])
def test_conditioned_siren_matches_jax(thesis):
    jmodel, params, tmodel, pts, z = _siren_pair(thesis)
    t_pts, t_z = torch.from_numpy(np.asarray(pts)), torch.from_numpy(np.asarray(z))
    freq, _ = tmodel.mapping_network(t_z)
    assert tmodel.routes_to_kernel(freq * 15 + 30) == thesis
    j = jmodel.apply(params, pts, z)
    with torch.no_grad():
        t = tmodel(t_pts, t_z)
    # fp32 on both sides (off the card the kernel's wrapper takes the fp32
    # reference, as the JAX wrapper does off the TPU); sums in another order
    # grow ~freq x per layer (observed 2.2e-7)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4)


def test_mapping_network_matches_jax():
    from conditioned_nerf_gan_tpu.models.layers import CustomMappingNetwork

    _, params, tmodel, _, z = _siren_pair(thesis=True)
    jfreq, jphase = CustomMappingNetwork(hidden_dim=256, output_dim=4 * H * 2).apply(
        {"params": params["params"]["mapping_network"]}, z)
    with torch.no_grad():
        tfreq, tphase = tmodel.mapping_network(torch.from_numpy(np.asarray(z)))
    # fp32 matmuls in another order (observed 6.0e-7)
    np.testing.assert_allclose(tfreq.numpy(), np.asarray(jfreq), atol=1e-5)
    np.testing.assert_allclose(tphase.numpy(), np.asarray(jphase), atol=1e-5)


def test_pointnet_and_encode_pcl_match_jax():
    rng = np.random.default_rng(1)
    pcl = jnp.asarray(rng.uniform(-0.4, 0.4, (3, 50, 6)), jnp.float32)
    jenc = JPointnet(c_dim=Z, hidden_dim=H)
    params = _jitter(jenc.init(jax.random.PRNGKey(1), pcl), seed=2)
    tenc = ResnetPointnet(c_dim=Z, dim=6, hidden_dim=H)
    tenc.load_state_dict(bridge.params_to_state_dict(jax.tree.map(np.asarray, params)))
    t_pcl = torch.from_numpy(np.asarray(pcl))
    with torch.no_grad():  # observed 3.9e-7 (latent), 4.8e-7 (z)
        np.testing.assert_allclose(tenc(t_pcl).numpy(),
                                   np.asarray(jenc.apply(params, pcl)), atol=1e-5)
        noise = rng.normal(size=(3, Z)).astype(np.float32)
        jz, jl = j_encode_pcl(jenc.apply, params, pcl, noise_weight=0.3,
                              noise=jnp.asarray(noise))
        tz, tl = encode_pcl(tenc, t_pcl, noise_weight=0.3, noise=torch.from_numpy(noise))
    # whitening uses the unbiased (ddof=1) std on both sides
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)


def test_bridge_round_trip(tmp_path):
    """JAX params -> state_dict loads strictly into the port modules, each
    Dense kernel arrives transposed, and convert_checkpoint writes the same
    tensors from a flax msgpack checkpoint."""
    jgen = JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H)
    cfg = JRenderConfig(img_size=4, num_steps=4)
    params_G = jgen.init(jax.random.PRNGKey(2), jnp.zeros((1, Z)),
                         jnp.eye(4)[None], cfg)
    params_E = JPointnet(c_dim=Z, hidden_dim=H).init(jax.random.PRNGKey(3),
                                                     jnp.zeros((1, 8, 6)))
    sd_G = bridge.params_to_state_dict(jax.tree.map(np.asarray, params_G))
    tgen = ImplicitGenerator3d(z_dim=Z, hidden_dim=H)
    tgen.load_state_dict(sd_G)  # strict: every key matches both ways
    kernel = np.asarray(params_G["params"]["siren"]["FiLMLayer_1"]["TorchLinear_0"]["kernel"])
    np.testing.assert_array_equal(tgen.siren.film_layers[1].linear.weight.detach().numpy(),
                                  kernel.T)
    ResnetPointnet(c_dim=Z, hidden_dim=H).load_state_dict(
        bridge.params_to_state_dict(jax.tree.map(np.asarray, params_E)))

    ckpt = tmp_path / "7.ckpt"
    ckpt.write_bytes(serialization.to_bytes(
        {"params_G": params_G, "params_E": params_E, "step": 7}))
    converted = torch.load(bridge.convert_checkpoint(ckpt), weights_only=True)
    assert converted["step"] == 7
    for key, value in sd_G.items():
        torch.testing.assert_close(converted["params_G"][key], value, rtol=0, atol=0)
    assert set(converted["params_E"]) == set(ResnetPointnet(c_dim=Z, hidden_dim=H).state_dict())


def test_init_schemes_are_seeded_and_scaled():
    """chip_smoke renders from these inits: same seed, same weights; each
    layer within the JAX package's init bounds."""
    def build(seed):
        return make_siren("SHORTSIREN", z_dim=64, hidden_dim=256,
                          generator=torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        assert not torch.equal(va, vc), k
    assert a.film_layers[0].linear.weight.abs().max() <= 1.0 / 3
    assert a.film_layers[1].linear.weight.abs().max() <= np.sqrt(6 / 256) / 25
    assert a.film_layers[1].linear.bias.abs().max() <= 1 / 16
    w = torch.empty(4096, 256)
    kaiming_leaky_init(scale=0.25)(w, torch.Generator().manual_seed(0))
    expected = np.sqrt(2 / 1.04) / 16 * 0.25
    assert abs(w.std().item() / expected - 1) < 0.01


@pytest.mark.parametrize("name,item", [
    ("EmbeddingPiGAN256", "A13"), ("TALLSIREN", "pointfeat"), ("TALLSIREN", "A13"),
    ("SPATIALSIREN" + "BASELINE", "A13"), ("EmbeddingPiGAN128", "A13"),
])
def test_unported_sirens_name_their_roadmap_item(name, item):
    """The SIRENs that were ROADMAP A13 now build, each with the JAX
    module's param tree (names and shapes, through the bridge; the JAX
    init only traced); TALLSIREN's mapping is the per-point
    `pointfeat` one."""
    pts, z = jnp.zeros((1, 4, 3)), jnp.zeros((1, Z))
    cond = jnp.zeros((1, 4, 4, 4, Z)) if name == "TALLSIREN" else z
    shapes = jax.eval_shape(lambda k: j_make_siren(name, z_dim=Z, hidden_dim=H).init(k, pts, cond),
                            jax.random.PRNGKey(0))
    ref = bridge.params_to_state_dict(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    port = make_siren(name, z_dim=Z, hidden_dim=H)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    if item == "pointfeat":
        assert type(port.mapping_network).__name__ == "PointFeaturesMappingNetwork"


def test_unknown_siren_raises():
    with pytest.raises(ValueError):
        make_siren("NoSuchSiren")
