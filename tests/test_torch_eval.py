"""The port's eval metrics and `Trainer.evaluate` on the CPU: the Trainer's
eval at eval_freq on the port's synthetic fixture, with fid.txt and
fid_history across a resume; the directory metrics (FID, oFID, LPIPS, PSNR)
it wrote against the JAX package's on the same two directories with the
same weights; PNG reading against cv2's rules. One eval serves both tests:
one FID's 2048 x 2048 sqrtm takes ~23 s of this CPU."""

import copy
import math
import types

import numpy as np
import pytest

import conditioned_nerf_gan_tpu.eval.inception as j_inception
import conditioned_nerf_gan_tpu.eval.lpips as j_lpips
import conditioned_nerf_gan_tpu.eval.metrics as j_metrics
import conditioned_nerf_gan_torch.eval.inception as t_inception
import conditioned_nerf_gan_torch.eval.lpips as t_lpips
from conditioned_nerf_gan_torch.config import curriculum_to_json, load_curriculum
from conditioned_nerf_gan_torch.data.synthetic import make_synthetic_shapenet
from conditioned_nerf_gan_torch.eval import compute_psnr, frechet_distance
from conditioned_nerf_gan_torch.eval.metrics import read_rgb
from conditioned_nerf_gan_torch.eval.weights import RANDOM_INIT_STAMP_PREFIX
from conditioned_nerf_gan_torch.training.trainer import Trainer

cv2 = pytest.importorskip("cv2")  # the JAX metrics read PNGs with cv2


def test_psnr_and_frechet_match_jax():
    rng = np.random.default_rng(7)
    a, b = (rng.uniform(0, 1, (3, 8, 8, 3)).astype(np.float32) for _ in range(2))
    assert compute_psnr(a, b) == j_metrics.compute_psnr(a, b)
    feats = [rng.normal(size=(200, 6)) + shift for shift in (0.0, 0.5)]
    stats = [x for f in feats for x in (f.mean(0), np.cov(f, rowvar=False))]
    assert frechet_distance(*stats) == j_metrics.frechet_distance(*stats)


@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "grey8", "rgb16"])
def test_read_rgb_follows_cv2_imread_color(tmp_path, kind):
    """PNGs written by cv2 read as cv2.imread(IMREAD_COLOR)[..., ::-1]
    gives them, the JAX metrics' reader."""
    rng = np.random.default_rng(8)
    channels = {"rgb8": 3, "rgba8": 4, "grey8": 1, "rgb16": 3}[kind]
    dtype = np.uint16 if kind == "rgb16" else np.uint8
    img = rng.integers(0, np.iinfo(dtype).max + 1, (9, 7, channels)).astype(dtype)
    path = tmp_path / f"{kind}.png"
    cv2.imwrite(str(path), img[..., 0] if channels == 1 else img)
    expected = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(read_rgb(path), expected)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    """The port's synthetic fixture, rendered on the CPU: 2 cars x 10 views
    at 32^2 (the smoke preset's fid.target_size; oFID needs 10 views)."""
    root = tmp_path_factory.mktemp("eval_fixture")
    return make_synthetic_shapenet(root, n_cars=2, n_views=10, img_size=32, n_points=512,
                                   voxel_resolutions=(32,), device="cpu")


def _trainer(out, dataset, stop_step, eval_freq):
    cur = copy.deepcopy(load_curriculum(config_base="smoke"))
    cur["dataset"]["path"] = str(dataset)
    out.mkdir(parents=True, exist_ok=True)
    curriculum_to_json(cur, out / "curriculum.json")
    args = types.SimpleNamespace(
        output_dir=str(out), load_dir="", load_curriculum="", sampling_interval=100,
        print_freq=100, eval_freq=eval_freq, n_epochs=100, stop_step=stop_step, config=None,
        config_base="smoke", seed=0, profile_dir=None, device="cpu")
    trainer = Trainer(args)
    trainer.load_models()
    trainer.train()
    return trainer


@pytest.fixture(scope="module")
def evaluated(fixture_root, tmp_path_factory):
    """A run to step 2 with eval_freq 2 and the metric nets' fixed-seed
    random weights: the eval at step 1 renders the fid subset (20 views at
    32^2, 96 samples) and scores it."""
    root = tmp_path_factory.mktemp("evaluated")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("CNG_INCEPTION_WEIGHTS", raising=False)
        mp.delenv("CNG_LPIPS_WEIGHTS", raising=False)
        mp.setenv("CNG_EVAL_IMAGES", str(root / "eval_images"))
        trainer = _trainer(root / "run", fixture_root, stop_step=2, eval_freq=2)
    return types.SimpleNamespace(out=root / "run", trainer=trainer,
                                 text=(root / "run" / "fid.txt").read_text(),
                                 real_dir=root / "eval_images" / fixture_root.stem / "val_32")


def _fid_line(text: str) -> list[str]:
    values = [line.split() for line in text.splitlines()[1:] if line.strip()]
    assert len(values) == 1
    return values[0]


def test_trainer_evaluate_writes_fid_txt_and_resumes(evaluated, fixture_root, monkeypatch):
    """fid.txt gets the random-weights stamp and one line of four finite
    values, and fid_history, checkpointed at the end (step 2), comes back
    on resume (run to step 3 without an eval)."""
    out = evaluated.out
    lines = evaluated.text.splitlines()
    assert lines[0].startswith(RANDOM_INIT_STAMP_PREFIX) and "LPIPS" in lines[0]
    values = _fid_line(evaluated.text)
    assert values[0] == "1" and len(values) == 5
    assert all(math.isfinite(float(v)) for v in values[1:])
    assert len(list((out / "evaluation").glob("car*_*.png"))) == 20
    assert len(list(evaluated.real_dir.glob("car*_*.png"))) == 20
    history = evaluated.trainer.histories["fid_history"]
    assert len(history) == 1 and history[0][0] == 1
    np.testing.assert_array_equal(history[0][1:], [float(v) for v in values[1:]])

    monkeypatch.delenv("CNG_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.delenv("CNG_LPIPS_WEIGHTS", raising=False)
    resumed = _trainer(out, fixture_root, stop_step=3, eval_freq=1000)
    assert resumed.step == 4
    np.testing.assert_array_equal(resumed.histories["fid_history"], history)
    assert (out / "fid.txt").read_text() == evaluated.text


def _flat_weights(module) -> dict:
    """A port metric net's weights in the JAX package's flat .npz layout
    (conv kernels OIHW -> HWIO)."""
    state = module.state_dict()
    flat = {}
    for key, path in module.flax_paths().items():
        arr = state[key].detach().cpu().numpy()
        flat[path] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
    return flat


def test_compute_metrics_from_dirs_matches_jax(evaluated, fixture_root, tmp_path, monkeypatch):
    """The (FID, oFID, LPIPS, PSNR) line the eval wrote against the JAX
    package's `compute_metrics_from_dirs` on the same real and generated
    directories, JAX loading the port's fixed-seed nets from .npz files
    through CNG_*_WEIGHTS. Both read the same 8-bit PNGs; the features
    differ by fp32 summation orders, which the Frechet distances over 20
    samples of 2048 (FID) and 2,890 of 768 (oFID) carry on."""
    monkeypatch.delenv("CNG_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.delenv("CNG_LPIPS_WEIGHTS", raising=False)
    for module in (t_inception, t_lpips):
        monkeypatch.setattr(module, "_cached", {})
    np.savez(tmp_path / "inception.npz", **_flat_weights(t_inception.get_inception(device="cpu")))
    np.savez(tmp_path / "lpips.npz", **_flat_weights(t_lpips.get_lpips(device="cpu")))
    monkeypatch.setenv("CNG_INCEPTION_WEIGHTS", str(tmp_path / "inception.npz"))
    monkeypatch.setenv("CNG_LPIPS_WEIGHTS", str(tmp_path / "lpips.npz"))
    for module in (j_inception, j_lpips):
        monkeypatch.setattr(module, "_cached", {})
    monkeypatch.setattr(j_metrics._inception_features, "_fn", None)
    monkeypatch.setattr(j_metrics.compute_lpips_batch, "_fn", None)
    expected = j_metrics.compute_metrics_from_dirs(
        evaluated.real_dir, evaluated.out / "evaluation", fixture_root.parent / "val.lst")
    got = [float(v) for v in _fid_line(evaluated.text)[1:]]
    assert np.isfinite(got).all() and got[0] > 0 and got[1] > 0 and got[2] > 0
    assert 0 < got[3] < 35
    np.testing.assert_allclose(got, expected, rtol=1e-4)
