"""The port's metric nets (`conditioned_nerf_gan_torch/eval`) against the JAX
package's, on the CPU: FID-InceptionV3's 768 map and 2048 vector and LPIPS
with the same weights (JAX's random init written with `flatten_params` to
an .npz that both packages load through their CNG_*_WEIGHTS variable), the
strict loader, the 299^2 resize, Newton-Schulz and the fid.txt stamp."""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import conditioned_nerf_gan_tpu.eval.inception as j_inception
import conditioned_nerf_gan_tpu.eval.lpips as j_lpips
import conditioned_nerf_gan_tpu.eval.weights as j_weights
import conditioned_nerf_gan_torch.eval.inception as t_inception
import conditioned_nerf_gan_torch.eval.lpips as t_lpips
import conditioned_nerf_gan_torch.eval.weights as t_weights
from conditioned_nerf_gan_tpu.eval.metrics import newton_schulz_sqrt_trace as j_newton_schulz
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.eval import LPIPS, newton_schulz_sqrt_trace


def _jax_npz(model, args, path, seed):
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), *args)
    flat = {k: np.asarray(v) for k, v in j_weights.flatten_params(params).items()}
    np.savez(path, **flat)
    return flat


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX's random-init params of both nets as .npz files. The BatchNorm
    statistics are moved off (0, 1) and the LPIPS heads drawn by JAX's own
    init, so every tensor's mapping is exercised."""
    root = tmp_path_factory.mktemp("metric_weights")
    dummy = jnp.zeros((1, 64, 64, 3))
    inception = _jax_npz(j_inception.InceptionV3Features(), (dummy,), root / "inception.npz", 0)
    rng = np.random.default_rng(0)
    for key in list(inception):
        if key.endswith(("bn_mean", "bn_bias")):
            inception[key] = rng.normal(0, 0.1, inception[key].shape).astype(np.float32)
        elif key.endswith(("bn_var", "bn_scale")):
            inception[key] = rng.uniform(0.5, 1.5, inception[key].shape).astype(np.float32)
    np.savez(root / "inception.npz", **inception)
    lpips = _jax_npz(j_lpips.LPIPS(), (dummy, dummy), root / "lpips.npz", 1)
    return {"inception": (root / "inception.npz", inception),
            "lpips": (root / "lpips.npz", lpips)}


@pytest.fixture
def env_weights(weights, monkeypatch):
    """Both packages' nets built anew from the .npz files: their per-process
    caches emptied around the environment variables."""
    monkeypatch.setenv("CNG_INCEPTION_WEIGHTS", str(weights["inception"][0]))
    monkeypatch.setenv("CNG_LPIPS_WEIGHTS", str(weights["lpips"][0]))
    for module in (j_inception, j_lpips, t_inception, t_lpips):
        monkeypatch.setattr(module, "_cached", {})
    return weights


@pytest.fixture(scope="module")
def inception_features(weights):
    """Both packages' features of the same batch of 2 at 128^2 (the eval
    protocol's size), each net built by its package's getter from the .npz
    that CNG_INCEPTION_WEIGHTS names."""
    imgs = np.random.default_rng(1).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CNG_INCEPTION_WEIGHTS", str(weights["inception"][0]))
        for module in (j_inception, t_inception):
            mp.setattr(module, "_cached", {})
        model, params = j_inception.get_inception()
        j768, j2048 = jax.jit(model.apply)(params, jnp.asarray(imgs))
        port = t_inception.get_inception(device="cpu")
        with torch.no_grad():
            t768, t2048 = port(torch.from_numpy(imgs))
    return {768: (t768.numpy(), np.asarray(j768)), 2048: (t2048.numpy(), np.asarray(j2048))}


@pytest.mark.parametrize("dim", [768, 2048])
def test_inception_features_match_jax(inception_features, dim):
    """The Mixed_6e map (2, 17, 17, 768) and the 2048 global mean: fp32
    convs summed in another order through ~20 layers (observed 2.5e-6 of
    the largest value, 768; 3.8e-7, 2048)."""
    t, j = inception_features[dim]
    assert t.shape == j.shape == ((2, 17, 17, 768) if dim == 768 else (2, 2048))
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * np.abs(j).max())


def test_lpips_matches_jax(env_weights):
    """LPIPS of 3 pairs at 64^2 from the same .npz, loaded through the
    environment variable by both packages' getters (observed 6.0e-8 of
    distances ~0.13)."""
    rng = np.random.default_rng(2)
    a, b = (rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32) for _ in range(2))
    model, params = j_lpips.get_lpips()
    expected = np.asarray(jax.jit(model.apply)(params, jnp.asarray(a), jnp.asarray(b)))
    port = t_lpips.get_lpips(device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        same = port(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(same, 0.0, atol=1e-6)
    assert t_lpips.get_lpips(device="cpu") is port  # one net a process and device


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_strict_loader_raises(weights, fault):
    """A key the net needs that the file lacks, or a shape that differs,
    raises, as the JAX loader does; nothing is half loaded silently."""
    flat = dict(weights["lpips"][1])
    if fault == "missing":
        del flat["params/lin3"]
        with pytest.raises(KeyError, match="missing 1 keys"):
            bridge.load_flat_weights(LPIPS(), flat, name="test")
    else:
        flat["params/alex/conv1_kernel"] = flat["params/alex/conv1_kernel"][:, :, :, :8]
        with pytest.raises(ValueError, match="shape mismatch at params/alex/conv1_kernel"):
            bridge.load_flat_weights(LPIPS(), flat, name="test")


def test_random_init_warns_and_is_fixed_seed(monkeypatch):
    """Without the weight variables the nets warn and draw the same
    weights every time from the seed."""
    monkeypatch.delenv("CNG_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.delenv("CNG_LPIPS_WEIGHTS", raising=False)
    states = []
    for _ in range(2):
        monkeypatch.setattr(t_lpips, "_cached", {})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            net = t_lpips.get_lpips(device="cpu")
        assert any("RANDOM weights" in str(w.message) for w in caught)
        states.append({k: v.clone() for k, v in net.state_dict().items()})
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])
    assert (states[0]["lin2"] > 0).all()


@pytest.mark.parametrize("side", [128, 400], ids=["enlarge", "shrink"])
def test_resize_to_299_matches_jax(side):
    """The Inception's input resize against `jax.image.resize(...,
    "bilinear")`: plain half-pixel lerps enlarging 128 -> 299, the
    antialiased triangle filter shrinking 400 -> 299 (observed 1.8e-7 and
    3.0e-7)."""
    x = np.random.default_rng(3).uniform(0, 1, (1, side, side, 3)).astype(np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), method="bilinear"))
    t = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(299, 299),
                                        mode="bilinear", align_corners=False,
                                        antialias=side > 299).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-6)


def test_newton_schulz_matches_jax_and_scipy():
    """trace(sqrtm(A)) of a 64 x 64 SPD matrix: torch against JAX (the same
    50 iterations in fp32) and against scipy's sqrtm in fp64."""
    from scipy import linalg

    a = np.random.default_rng(4).normal(size=(64, 64))
    spd = (a @ a.T / 64 + np.eye(64) * 0.1).astype(np.float32)
    exact = float(np.trace(linalg.sqrtm(spd.astype(np.float64))).real)
    port = float(newton_schulz_sqrt_trace(torch.from_numpy(spd)))
    ref = float(j_newton_schulz(jnp.asarray(spd)))
    # the same fp32 iterations (observed equal), 7.1e-8 from the exact trace
    np.testing.assert_allclose(port, ref, rtol=1e-5)
    np.testing.assert_allclose(port, exact, rtol=1e-3)


@pytest.mark.parametrize("calibrated", [(False, False), (True, False), (True, True)],
                         ids=["none", "inception", "both"])
def test_stamp_metric_log_matches_jax(tmp_path, monkeypatch, calibrated):
    """The fid.txt stamp names the same uncalibrated columns, with the same
    text, as the JAX package's, and none when both nets are calibrated."""
    for var, on in zip(("CNG_INCEPTION_WEIGHTS", "CNG_LPIPS_WEIGHTS"), calibrated):
        if on:
            fake = tmp_path / f"{var}.npz"
            fake.write_bytes(b"x")
            monkeypatch.setenv(var, str(fake))
        else:
            monkeypatch.delenv(var, raising=False)
    t_weights.stamp_metric_log(tmp_path / "port.txt")
    j_weights.stamp_metric_log(tmp_path / "jax.txt")
    assert t_weights.metrics_calibrated() == j_weights.metrics_calibrated() == all(calibrated)
    if all(calibrated):
        assert not (tmp_path / "port.txt").exists() and not (tmp_path / "jax.txt").exists()
    else:
        assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
