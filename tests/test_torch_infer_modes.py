"""The rest of inference on the CPU: the port's orbit video, colored point
clouds, density voxels, metrics and latent interpolation against the JAX
`Inferencer`, on one converted run.

Both Inferencers load the same weights (a flax msgpack checkpoint and its
`bridge.convert_checkpoint`; smoke widths, PointNet 512 wide, fp32) and read
one synthetic dataset of 3 cars x 4 views at 16^2. The GT depth of car0000
is 24^2 (the masked export resizes it), car0001's is an EXR only. The
random-camera draws are stood in for by one seeded set in both inference
modules, Python's `random` is seeded alike on both sides, and each side
records what reaches its `render_batched`. Renders are fp32 on both sides
(SIREN outputs agree to ~1e-6), so rgb and depth are held at 1e-4 and the
exported points at 1e-4 (xyz) and one level (rgb). The metric nets' scores
are stood in for on both sides: FID's 2048^2 sqrtm alone takes ~25 s of
this CPU, and tests/test_torch_eval.py holds the scoring.

About 35 s of CPU alone, most of it JAX compiles.
"""

import random
import types
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

import conditioned_nerf_gan_torch.infer.inference as tinference
import conditioned_nerf_gan_tpu.infer.inference as jinference
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.infer import Inferencer
from conditioned_nerf_gan_torch.infer import extract_shapes as textract
from conditioned_nerf_gan_torch.infer.mrc import read_mrc, write_mrc
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d
from conditioned_nerf_gan_torch.utils.rotation import perturb_extrinsics, rodrigues
from conditioned_nerf_gan_torch.utils.video import read_avi
from conditioned_nerf_gan_tpu.infer import extract_shapes as jextract
from conditioned_nerf_gan_tpu.infer.inference import Inferencer as JInferencer
from conditioned_nerf_gan_tpu.infer.mrc import write_mrc as j_write_mrc
from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import ResnetPointnet as JPointnet

Z, H = 16, 32
VIEWS = 4
RENDER_TOL = 1e-4  # fp32 renders on both sides [observed ~1e-6]
# the thesis policy: on the CPU both kernel wrappers take the fp32 reference
POLICY_J = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True, use_pallas=True)
POLICY_T = dict(compute_dtype=torch.bfloat16, use_fast_sin=True, use_kernel=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX run and a port run of one checkpoint over one dataset."""
    from conditioned_nerf_gan_torch.data.exr import write_exr_depth
    from conditioned_nerf_gan_tpu.config import curriculum_to_json, load_curriculum
    from conditioned_nerf_gan_tpu.data import make_synthetic_shapenet

    root = tmp_path_factory.mktemp("infer_modes")
    ds_root = make_synthetic_shapenet(root / "data", n_cars=3, n_views=VIEWS, img_size=16,
                                      n_points=256, voxel_resolutions=(32,))
    rng = np.random.default_rng(3)
    for view in range(VIEWS):
        gt = rng.uniform(0.5, 1.5, (24, 24)).astype(np.float32)
        gt[:, :10] = 0  # background on the left: the mask removes those points
        np.save(ds_root / "car0000" / "depth" / f"{view:04}.npy", gt)
        npy = ds_root / "car0001" / "depth" / f"{view:04}.npy"
        write_exr_depth(npy.with_name(f"{view:04}0001.exr"), np.load(npy))
        npy.unlink()
    curriculum = load_curriculum(config_base="smoke")
    curriculum["generator"].update(z_dim=Z, hidden_dim=H)
    curriculum["dataset"]["path"] = str(ds_root)
    curriculum["fid"]["target_size"] = 16

    step = 3
    gen = JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H, use_fast_sin=True)
    params_G = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, Z)), jnp.eye(4)[None],
                        JRenderConfig(img_size=4, num_steps=4))
    # a sigma bias of 1.5 puts most depths inside (ray_start, ray_end), so
    # the point clouds are not empty
    params_G = jax.tree_util.tree_map_with_path(
        lambda path, x: x.at[3].add(1.5) if "final_layer" in str(path) and "bias" in str(path)
        else x, params_G)
    params_E = JPointnet(c_dim=Z).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 6)))
    out = {}
    for side in ("jax", "torch"):
        run = root / side
        (run / "checkpoints").mkdir(parents=True)
        curriculum_to_json(curriculum, run / "curriculum.json")
        ckpt = run / "checkpoints" / f"{step}.ckpt"
        ckpt.write_bytes(serialization.to_bytes(
            {"params_G": params_G, "params_E": params_E, "step": step}))
        out[side] = ckpt if side == "jax" else bridge.convert_checkpoint(ckpt)
    return types.SimpleNamespace(jckpt=out["jax"], tckpt=out["torch"], ds_root=ds_root)


@pytest.fixture(scope="module")
def jinf(runs):
    return JInferencer(runs.jckpt, num_imgs=VIEWS, image_size=16, seed=0)


@pytest.fixture
def tinf(runs):
    return Inferencer(runs.tckpt, num_imgs=VIEWS, image_size=16, seed=0, device="cpu")


def _record(monkeypatch, inf) -> list:
    """Record each render_batched call's cameras, z and numpy outputs."""
    calls = []
    inner = inf.render_batched

    def recorder(z, cams, **kwargs):
        rgb, depth = inner(z, cams, **kwargs)
        calls.append(dict(z=z, cams=np.asarray(cams), rgb=rgb, depth=depth, **kwargs))
        return rgb, depth

    monkeypatch.setattr(inf, "render_batched", recorder)
    return calls


def _np(x):
    if isinstance(x, (tuple, list)):
        return tuple(_np(p) for p in x)
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_renders(jcalls, tcalls, depth=True):
    assert len(jcalls) == len(tcalls) == 1
    j, t = jcalls[0], tcalls[0]
    np.testing.assert_allclose(t["cams"], j["cams"], atol=1e-6)
    np.testing.assert_allclose(t["rgb"], j["rgb"], atol=RENDER_TOL)
    if depth:
        np.testing.assert_allclose(t["depth"], j["depth"], atol=RENDER_TOL)


def _seeded_cameras(monkeypatch, n_seed=11):
    """Stand in one seeded set of camera origins for both modules' draw."""
    def origins(n):
        rng = np.random.default_rng(n_seed)
        u = torch.from_numpy(rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32))
        from conditioned_nerf_gan_torch.ops import sample_camera_positions

        return sample_camera_positions(n, cam_r_start=0.9, cam_r_end=1.3, uniforms=u)

    monkeypatch.setattr(jinference, "sample_camera_positions",
                        lambda key, n, **kw: jnp.asarray(origins(n).numpy()))
    monkeypatch.setattr(tinference, "sample_camera_positions", lambda n, **kw: origins(n))


# ---------------------------------------------------------------------------
# shape extraction and the .mrc writer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,origin,cube", [(2, (0, 0, 0), 2.0), (9, (0.1, -0.2, 0.3), 1.2),
                                           (17, (0, 0, 0), 1.2)])
def test_create_samples_bitwise(n, origin, cube):
    t = textract.create_samples(n, origin, cube)
    j = jextract.create_samples(n, origin, cube)
    assert t[0].dtype == j[0].dtype == np.float32
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2] == j[2]


def _field_generators(pair: bool):
    """The policy generators on bridged weights: SHORTSIREN on a latent, or
    TALLSIREN_dg on a (volume, global) pair of 8 channels."""
    kw = (dict(siren_type="TALLSIREN_dg", z_dim=32, input_dim=8) if pair
          else dict(siren_type="SHORTSIREN", z_dim=Z))
    rng = np.random.default_rng(4)
    if pair:
        z = (rng.normal(size=(1, 6, 6, 6, 8)).astype(np.float32),
             rng.normal(size=(1, 32)).astype(np.float32))
    else:
        z = rng.normal(size=(1, Z)).astype(np.float32)
    jz = tuple(map(jnp.asarray, z)) if pair else jnp.asarray(z)
    jgen = JGenerator(hidden_dim=H, **kw, **POLICY_J)
    params = jgen.init(jax.random.PRNGKey(2), jz, jnp.eye(4)[None],
                       JRenderConfig(img_size=4, num_steps=4))
    tgen = ImplicitGenerator3d(hidden_dim=H, **kw, **POLICY_T)
    tgen.load_state_dict(bridge.params_to_state_dict(jax.tree.map(np.asarray, params)))
    tz = tuple(map(torch.from_numpy, z)) if pair else torch.from_numpy(z)
    return jgen, params, jz, tgen, tz


@pytest.mark.parametrize("n,max_points,pair", [(9, 64 ** 3, False), (17, 1000, False),
                                               (9, 200, True)],
                         ids=["latent_9", "latent_17_padded", "pair_9_padded"])
def test_sigma_grid_matches_jax(n, max_points, pair, monkeypatch):
    """The grid over `eval_points` against JAX `sample_sigma_grid` over
    `generator.apply(..., method="eval_points")`, within 1e-5 of the grid's
    largest |sigma|; every chunk reaches the kernel wrapper contiguous."""
    import conditioned_nerf_gan_torch.models.siren as siren_module

    wrapper, chunks = siren_module.film_siren_mlp, []

    def spy(points, *args):
        assert points.is_contiguous() and points.shape[:2] == (1, min(max_points, n ** 3))
        chunks.append(points.shape)
        return wrapper(points, *args)

    monkeypatch.setattr(siren_module, "film_siren_mlp", spy)
    jgen, params, jz, tgen, tz = _field_generators(pair)
    ref = jextract.sample_sigma_grid(
        lambda p, pts, zz: jgen.apply(p, pts, zz, method="eval_points"), params, jz,
        voxel_resolution=n, cube_length=1.2, max_points=max_points)
    got = textract.sample_sigma_grid(tgen.eval_points, tz, voxel_resolution=n,
                                     cube_length=1.2, max_points=max_points)
    assert got.shape == ref.shape == (n, n, n) and got.dtype == np.float32
    assert len(chunks) == -(-n ** 3 // min(max_points, n ** 3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert ref.std() > 0


def test_mrc_bytes_match_jax(tmp_path):
    vol = np.random.default_rng(5).normal(size=(7, 5, 6)).astype(np.float32)
    write_mrc(tmp_path / "t.mrc", vol, voxel_size=0.5)
    j_write_mrc(tmp_path / "j.mrc", vol, voxel_size=0.5)
    assert (tmp_path / "t.mrc").read_bytes() == (tmp_path / "j.mrc").read_bytes()
    np.testing.assert_array_equal(read_mrc(tmp_path / "t.mrc"), vol)


# ---------------------------------------------------------------------------
# the camera perturbation
# ---------------------------------------------------------------------------
def _rotations(kind: str, count: int = 40):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng({"random": 0, "tiny": 1, "near_pi": 2, "exact": 3}[kind])
    out = []
    for i in range(count):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        theta = {"random": rng.uniform(0, np.pi), "tiny": rng.uniform(0, 1e-6),
                 "near_pi": np.pi - rng.uniform(0, 1e-6),
                 "exact": (0.0, np.pi)[i % 2]}[kind]
        out.append(cv2.Rodrigues((axis * theta)[:, None])[0])
    return cv2, out


@pytest.mark.parametrize("kind", ["random", "tiny", "near_pi", "exact"])
def test_rodrigues_matches_cv2(kind):
    """Both directions against cv2.Rodrigues to 1e-6, including theta under
    1e-6 and within 1e-6 of pi (cv2's two special branches)."""
    cv2, rotations = _rotations(kind)
    for R in rotations:
        rvec = rodrigues(R)
        assert rvec.shape == (3, 1)
        np.testing.assert_allclose(rvec, cv2.Rodrigues(R)[0], atol=1e-6)
        np.testing.assert_allclose(rodrigues(rvec), cv2.Rodrigues(rvec)[0], atol=1e-6)
        np.testing.assert_allclose(rodrigues(rvec.ravel()), cv2.Rodrigues(rvec)[0], atol=1e-6)


def test_perturb_extrinsics_matches_jax(runs):
    cams_npz = np.load(runs.ds_root / "car0000" / "cameras.npz")
    cams = np.stack([cams_npz[f"world_mat_inv_{i}"] for i in range(VIEWS)])
    got = perturb_extrinsics(cams, 0.1, np.random.default_rng(7))
    ref = jinference.perturb_extrinsics(cams, 0.1, np.random.default_rng(7))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_fixed_cameras_with_noise_match_jax(jinf, tinf, monkeypatch):
    """`_inference_camera(fixed=True, cam_noise=...)`: the same views, the
    same perturbed cameras and renders."""
    jcalls, tcalls = _record(monkeypatch, jinf), _record(monkeypatch, tinf)
    for inf in (jinf, tinf):
        inf.rng = np.random.default_rng(8)
        random.seed(9)
        assert inf._inference_camera(fixed=True, cam_noise=0.05).exists()
    _same_renders(jcalls, tcalls)


# ---------------------------------------------------------------------------
# the modes, port against JAX
# ---------------------------------------------------------------------------
def _read_obj(path: Path) -> np.ndarray:
    rows = [line.split()[1:] for line in path.read_text().splitlines()]
    assert rows and all(len(r) == 6 for r in rows)
    return np.asarray(rows, np.float64)


def _same_points(jpath: Path, tpath: Path):
    j, t = _read_obj(jpath), _read_obj(tpath)
    assert t.shape == j.shape
    np.testing.assert_allclose(t[:, :3], j[:, :3], atol=RENDER_TOL)
    assert np.abs(t[:, 3:] - j[:, 3:]).max() <= 1


def test_render_pcl_matches_jax(jinf, tinf, monkeypatch):
    _seeded_cameras(monkeypatch)
    jcalls, tcalls = _record(monkeypatch, jinf), _record(monkeypatch, tinf)
    jout, tout = jinf.render_pcl(0, num_views=VIEWS), tinf.render_pcl(0, num_views=VIEWS)
    _same_renders(jcalls, tcalls)
    _same_points(jout, tout)
    assert tout.suffix == ".obj" and tout.parent.name == "inference"
    assert list(tout.parent.glob("3_pcl_*.png"))


@pytest.mark.parametrize("car", ["car0000", "car0001", "car0002"],
                         ids=["npy_resized", "exr", "npy"])
def test_render_pcl_masked_matches_jax(car, jinf, tinf, monkeypatch):
    """The GT-depth mask: car0000's 24^2 npy resized bilinearly (cv2.resize
    INTER_LINEAR, even when it shrinks), car0001's EXR, car0002's npy."""
    cv2 = pytest.importorskip("cv2")
    from conditioned_nerf_gan_torch.utils.resize import resize

    idx = [Path(s["img_path"]).parent.parent.name
           for s in (tinf.valset[i] for i in range(len(tinf.valset)))].index(car)
    jcalls, tcalls = _record(monkeypatch, jinf), _record(monkeypatch, tinf)
    random.seed(10)
    jout = jinf.render_pcl_masked(idx, num_views=VIEWS)
    random.seed(10)
    tout = tinf.render_pcl_masked(idx, num_views=VIEWS)
    _same_renders(jcalls, tcalls)
    _same_points(jout, tout)
    if car == "car0000":
        gt = np.load(tinf.valset[idx]["img_path"].replace("image", "depth")
                     .replace(".png", ".npy"))
        np.testing.assert_allclose(resize(gt, 16, "linear"), cv2.resize(gt, (16, 16)),
                                   atol=1e-6)
        # the mask removes points: fewer than the unmasked export's (read
        # first: both land in one file within the same second)
        masked = len(_read_obj(tout))
        random.seed(10)
        assert len(_read_obj(tinf.render_pcl_masked(idx, VIEWS, mask=False))) > masked


def test_render_video_frames_match_jax(jinf, tinf, monkeypatch):
    """The frames JAX hands cv2.VideoWriter against the port's AVI read
    back: within one level, the share of differing bytes printed; and
    cv2.VideoCapture opens the AVI and counts its frames."""
    cv2 = pytest.importorskip("cv2")
    frames = []

    class Recorder:
        def __init__(self, path, fourcc, fps, size):
            self.size = size

        def write(self, frame):
            assert frame.shape[1::-1] == self.size
            frames.append(frame.copy())

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    jcalls, tcalls = _record(monkeypatch, jinf), _record(monkeypatch, tinf)
    jinf.render_video(0, num_frames=8, fps=1)
    out = tinf.render_video(0, num_frames=8, fps=1)
    _same_renders(jcalls, tcalls, depth=False)
    assert tcalls[0]["chunk"] == 16
    np.testing.assert_allclose(tcalls[0]["fov"], jcalls[0]["fov"])
    assert out.suffix == ".avi" and out.parent.name == "video"
    got, fps = read_avi(out)
    ref = np.stack(frames)
    assert fps == 1 and got.shape == ref.shape == (8, 16, 16, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref)
    print(f"video frames: max |port - JAX| {diff.max()} levels, "
          f"{(diff > 0).mean():.2e} of the bytes differ")
    assert diff.max() <= 1
    cap = cv2.VideoCapture(str(out))
    try:
        assert cap.isOpened() and cap.get(cv2.CAP_PROP_FRAME_COUNT) == 8
        ok, first = cap.read()
        assert ok and np.array_equal(first, got[0])
    finally:
        cap.release()


def test_save_voxel_matches_jax(jinf, tinf):
    jout, tout = jinf.save_voxel(0, voxel_resolution=9), tinf.save_voxel(0, voxel_resolution=9)
    assert tout.name == jout.name and tout.parent.name == "inference"
    ref, got = read_mrc(jout), read_mrc(tout)
    assert got.shape == (9, 9, 9)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert tout.read_bytes()[:1024][:76] == jout.read_bytes()[:1024][:76]


def test_interpolate_latent_matches_jax(jinf, runs, monkeypatch):
    """On a latent, from an Inferencer built without the dataset (as the
    CLI builds it for --interpolate)."""
    tinf = Inferencer(runs.tckpt, image_size=16, seed=0, device="cpu", load_dataset=False)
    assert not hasattr(tinf, "valset")
    jcalls, tcalls = _record(monkeypatch, jinf), _record(monkeypatch, tinf)
    outs = []
    for inf in (jinf, tinf):
        inf.rng = np.random.default_rng(12)
        outs.append(inf.interpolate_latent_codes("car0000", "car0001",
                                                 inf.run_dir / "interp", interpolate_n=7))
    np.testing.assert_allclose(_np(tcalls[0]["z"]), _np(jcalls[0]["z"]), atol=1e-5)
    _same_renders(jcalls, tcalls)
    assert outs[1].name == "car0000_to_car0001_fz.png" and outs[1].exists()


@pytest.mark.parametrize("mode", ["fz", "f", "z"])
def test_interpolate_pair_matches_jax(mode, runs, monkeypatch):
    """On a (volume, global) pair: each mode's stack and renders, the
    Inferencers stood in for by objects holding the policy generators
    (TALLSIREN_dg on bridged weights) and a seeded pair a car."""
    jgen, params, _, tgen, _ = _field_generators(pair=True)
    curriculum = Inferencer(runs.tckpt, image_size=16, device="cpu",
                            load_dataset=False).curriculum
    rng = np.random.default_rng(13)
    pairs = {car: (rng.normal(size=(1, 6, 6, 6, 8)).astype(np.float32),
                   rng.normal(size=(1, 32)).astype(np.float32))
             for car in ("car0000", "car0001")}
    jself = object.__new__(JInferencer)
    jself.__dict__.update(curriculum=curriculum, generator=jgen, params_G=params,
                          _render_cache={}, shard_rays=False)
    tself = object.__new__(Inferencer)
    tself.__dict__.update(curriculum=curriculum, generator=tgen, device=torch.device("cpu"),
                          shard_rays=False)
    for inf, wrap in ((jself, jnp.asarray), (tself, torch.from_numpy)):
        inf._load_car_cond = lambda car: {"car": car}
        inf.encode = lambda cond, wrap=wrap: tuple(map(wrap, pairs[cond["car"]]))
    jcalls, tcalls = _record(monkeypatch, jself), _record(monkeypatch, tself)
    for inf, out in ((jself, runs.jckpt.parent.parent), (tself, runs.tckpt.parent.parent)):
        inf.interpolate_latent_codes("car0000", "car0001", out / "interp_pair", mode=mode,
                                     interpolate_n=4)
    for t, j in zip(_np(tcalls[0]["z"]), _np(jcalls[0]["z"])):
        assert t.shape[0] == 5
        np.testing.assert_allclose(t, j, atol=1e-6)
    _same_renders(jcalls, tcalls)


def test_compute_metrics_matches_jax(jinf, tinf, tmp_path, monkeypatch):
    """The fid subset rendered into evaluation_{voxres}_{steps}_{step}_128
    (the same PNG names, pixels within one level of JAX's), scored on the
    Inferencer's device, and fid_inference.txt stamped with one 7-field
    line."""
    import conditioned_nerf_gan_torch.eval.metrics as tmetrics
    import conditioned_nerf_gan_tpu.eval.metrics as jmetrics
    from conditioned_nerf_gan_torch.eval.weights import RANDOM_INIT_STAMP_PREFIX
    from conditioned_nerf_gan_torch.utils.png import read_png

    monkeypatch.delenv("CNG_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.delenv("CNG_LPIPS_WEIGHTS", raising=False)
    scored = {}

    def stand_in(side):
        def score(real_dir, gen_dir, car_lst, **kwargs):
            scored[side] = dict(real=Path(real_dir), gen=Path(gen_dir), lst=Path(car_lst),
                                **kwargs)
            return 12.5, 3.25, 0.5, 20.0
        return score

    monkeypatch.setattr(jmetrics, "compute_metrics_from_dirs", stand_in("jax"))
    monkeypatch.setattr(tmetrics, "compute_metrics_from_dirs", stand_in("torch"))
    for side, inf in (("jax", jinf), ("torch", tinf)):
        monkeypatch.setenv("CNG_EVAL_IMAGES", str(tmp_path / side))
        assert inf.compute_metrics() == (12.5, 3.25, 0.5, 20.0)
    j, t = scored["jax"], scored["torch"]
    assert t["device"] == torch.device("cpu") and t["lst"] == j["lst"]
    assert t["gen"].name == j["gen"].name == "evaluation_64_48_3_128"
    names = sorted(p.name for p in j["gen"].glob("*.png"))
    assert names and names == sorted(p.name for p in t["gen"].glob("*.png"))
    assert names == sorted(p.name for p in t["real"].glob("*.png"))
    worst = max(np.abs(read_png(t["gen"] / n).astype(int) - read_png(j["gen"] / n)).max()
                for n in names)
    assert worst <= 1
    lines = (tinf.run_dir / "fid_inference.txt").read_text().splitlines()
    assert lines[0].startswith(RANDOM_INIT_STAMP_PREFIX)
    rows = [line.split() for line in lines if line and not line.startswith("#")]
    assert rows[-1] == ["3", "64", "48", "12.5", "3.25", "0.5", "20.0"]


def test_generate_img_takes_tensors(jinf, tinf):
    """`eval.output_images` hands the Inferencer tensors (on the card, CUDA
    ones): encode_batch and generate_img take them as they take arrays."""
    batch = tinf.valset.get_batch([0, 1])
    z_np = tinf.encode_batch({"pcl": batch["pcl"]})
    z_t = tinf.encode_batch({"pcl": torch.as_tensor(batch["pcl"])})
    assert torch.equal(z_np, z_t)
    a = tinf.generate_img(z_t, batch["cam2world"])
    b = tinf.generate_img(z_t, torch.as_tensor(batch["cam2world"]))
    assert torch.equal(a[0], b[0]) and a[0].shape == (2, 16, 16, 3)
    assert len(tinf.fidset) == len(jinf.fidset) and tinf.fidset.img_size == 16


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI_MODES = {
    "images_fixed": (["--images", "--cam_fixed"], "3_fixed_*.png"),
    "video": (["--video", "--num_frames", "8", "--fps", "1"], "video/torch_3_*.avi"),
    "pcl": (["--pcl", "--pcl_views", "4"], "3_car*.obj"),
    "pcl_masked": (["--pcl_masked"], "3_car*_masked_*.obj"),
    "voxel": (["--voxel", "--voxel_resolution", "9"], "car*.mrc"),
    "metrics": (["--metrics"], None),
    "interpolate": (["--interpolate", "--interpolate_src", "car0001",
                     "--interpolate_tgt", "car0002"], "car0001_to_car0002_fz.png"),
    "all_at_once": (["--video", "--num_frames", "8", "--fps", "1", "--pcl", "--pcl_views", "4",
                     "--pcl_masked", "--voxel", "--voxel_resolution", "9", "--metrics"],
                    "3_car*_masked_*.obj"),
}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_cli_mode_on_cpu(mode, runs, tmp_path, monkeypatch):
    import conditioned_nerf_gan_torch.eval.metrics as tmetrics
    from conditioned_nerf_gan_torch.infer.__main__ import main

    monkeypatch.setenv("CNG_EVAL_IMAGES", str(tmp_path / "eval_images"))
    monkeypatch.setattr(tmetrics, "compute_metrics_from_dirs",
                        lambda *a, **kw: (1.0, 2.0, 3.0, 4.0))
    flags, pattern = CLI_MODES[mode]
    run = runs.tckpt.parent.parent

    def written():
        return {p: p.stat().st_mtime_ns for p in (run / "inference").glob(pattern)}

    before = written() if pattern else {}
    assert main([str(runs.tckpt), "--image_size", "16", "--num_imgs", "2", *flags,
                 "--device", "cpu"]) == 0
    if pattern is None:
        assert (run / "fid_inference.txt").read_text().splitlines()[-1].endswith(
            "1.0 2.0 3.0 4.0")
    else:
        assert set(written().items()) - set(before.items())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_cli_modes_refuse_without_a_card(runs, capsys):
    from conditioned_nerf_gan_torch.infer.__main__ import main

    assert main([str(runs.tckpt), "--video", "--voxel", "--metrics"]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert main([str(runs.tckpt), "--interpolate", "--device", "cpu"]) == 2
    assert "--interpolate_src" in capsys.readouterr().err
