"""The port's tools that the JAX package writes with jax (tools/geometry,
geoloss, voxel_render, pcl2voxel, blender/fixture's render) against the JAX
tools on the port's synthetic fixture, on the CPU; and the JAX package's
numpy-only tools, which the port does not copy, run with jax, jaxlib and
flax blocked. ~30 s of CPU alone (the JAX renders' and Inferencer's
compiles, ten `--help` subprocesses)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.tools import geometry as jgeometry
from conditioned_nerf_gan_tpu.tools import pcl2voxel as jpcl2voxel
from conditioned_nerf_gan_tpu.tools import voxel_render as jvoxel_render
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.data.synthetic import make_synthetic_shapenet
from conditioned_nerf_gan_torch.tools import geometry, pcl2voxel, voxel_render
from conditioned_nerf_gan_torch.utils.video import read_avi

REPO = Path(__file__).resolve().parent.parent
FOV = 49.134342641202636


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    return make_synthetic_shapenet(tmp_path_factory.mktemp("torch_tools"), n_cars=2,
                                   n_views=3, img_size=32, n_points=1024,
                                   voxel_resolutions=(32,), device="cpu")


def test_chamfer_matches_jax_and_kdtree():
    """The chunked on-device chamfer (a ragged last chunk) against the JAX
    tool's and against scipy's cKDTree in fp64."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(3)
    a = rng.uniform(-0.5, 0.5, (1000, 3)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (700, 3)).astype(np.float32)
    got = geometry.chamfer_distance(a, b, chunk=256, device="cpu")
    ref = (cKDTree(b).query(a)[0] ** 2).mean() + (cKDTree(a).query(b)[0] ** 2).mean()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, jgeometry.chamfer_distance(a, b, chunk=256), rtol=1e-5)
    assert geometry.chamfer_distance(a, a, device="cpu") == 0.0


def test_backprojection_camera_check_and_kdtree_samples(dataset_root):
    """Backprojection and the KD-tree samples are the JAX tool's numpy
    (equal arrays); the camera check agrees with the JAX one on the npy
    depth and on an EXR (the port's reader) and stays under a voxel."""
    from conditioned_nerf_gan_torch.data.exr import write_exr_depth

    car = dataset_root / "car0000"
    depth = np.load(car / "depth" / "0001.npy")
    cam = np.load(car / "cameras.npz")["world_mat_inv_1"]
    np.testing.assert_array_equal(geometry.backproject_depth(depth, cam, FOV),
                                  jgeometry.backproject_depth(depth, cam, FOV))
    pcl = np.load(car / "pcl_color.npy")
    np.testing.assert_array_equal(geometry.kdtree_negative_samples(pcl, 64, seed=2),
                                  jgeometry.kdtree_negative_samples(pcl, 64, seed=2))
    exr_car = car.parent / "car_exr"
    exr_car.mkdir()
    for name in ("cameras.npz", "pcl_color.npy"):
        (exr_car / name).write_bytes((car / name).read_bytes())
    (exr_car / "depth").mkdir()
    depth0 = np.load(car / "depth" / "0000.npy")
    write_exr_depth(exr_car / "depth" / "00000001.exr",
                    np.where(depth0 > 0, depth0, np.inf).astype(np.float32))
    for car_dir in (car, exr_car):
        got = geometry.check_camera_convention(car_dir, view=0, img_size=32, device="cpu")
        ref = jgeometry.check_camera_convention(car_dir, view=0, img_size=32)
        np.testing.assert_allclose(got, ref, rtol=1e-5)
        assert got < 0.01


def test_pointnet_critical_points_match_jax():
    """The critical points of a PointNet with bridged weights, jittered off
    the init (fc_1 starts at zero): the same indices as the JAX tool's."""
    from conditioned_nerf_gan_tpu.models import ResnetPointnet as JPointnet
    from conditioned_nerf_gan_torch.models import ResnetPointnet

    pcl = np.random.default_rng(5).uniform(-0.4, 0.4, (300, 6)).astype(np.float32)
    jnet = JPointnet(c_dim=16, hidden_dim=32)
    params = jnet.init(jax.random.PRNGKey(6), jnp.zeros((1, 8, 6)))
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    params = jax.tree.unflatten(tree, [x + 0.05 * jax.random.normal(k, x.shape)
                                       for x, k in zip(leaves, keys)])
    tnet = ResnetPointnet(c_dim=16, hidden_dim=32)
    tnet.load_state_dict(bridge.params_to_state_dict(jax.tree.map(np.asarray, params)))
    got = geometry.pointnet_critical_points(tnet, pcl)
    ref = jgeometry.pointnet_critical_points(jnet.apply, params, pcl)
    np.testing.assert_array_equal(got, ref)
    assert 1 < len(got) <= 32


def _voxel_and_cams(dataset_root, n=2):
    car = dataset_root / "car0000"
    vox = np.load(car / "voxel_32.npz")["voxel"].astype(np.float32)
    cams = np.load(car / "cameras.npz")
    return vox, np.stack([cams[f"world_mat_inv_{i}"] for i in range(n)]).astype(np.float32)


def test_voxel_surface_render_matches_jax(dataset_root):
    """The first-hit render of a 32^3 grid at 32^2 and 128 steps against the
    JAX tool's: the nearest lookups' indices and the first hits agree but
    where a ray sample lies within fp32 roundings of a cell face (the two
    ray generators differ by an ulp), observed 0 pixels."""
    vox, cams = _voxel_and_cams(dataset_root)
    vol = np.ascontiguousarray(np.broadcast_to(vox.transpose(2, 1, 0, 3)[None],
                                               (2, 32, 32, 32, 4)))
    got = voxel_render.voxel_surface_render(torch.from_numpy(vol), torch.from_numpy(cams), 32,
                                            FOV, 0.2, 2.0, 128).numpy()
    ref = np.asarray(jvoxel_render.voxel_surface_render(jnp.asarray(vol), jnp.asarray(cams),
                                                        32, FOV, 0.2, 2.0, 128))
    differ = np.abs(got - ref).max(-1) > 1e-6
    assert differ.mean() <= 0.01, differ.mean()
    assert (got < 0.97).any(-1).mean() > 0.05  # the car is in view
    coords = np.random.default_rng(8).uniform(-1.2, 1.2, (2, 500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        voxel_render.nearest_point_features(torch.from_numpy(vol), torch.from_numpy(coords)),
        np.asarray(jvoxel_render.nearest_point_features(jnp.asarray(vol),
                                                        jnp.asarray(coords))))


def test_voxelize_and_orbit_video_match_jax(dataset_root, tmp_path, monkeypatch):
    """voxelize_pcl is the JAX tool's numpy (equal grids); the orbit AVI's
    frames, read back, against the frames the JAX tool hands
    cv2.VideoWriter: within a level but for near-face samples (observed 0
    pixels apart)."""
    cv2 = pytest.importorskip("cv2")
    pcl = np.load(dataset_root / "car0001" / "pcl_color.npy")
    rng_args = dict(noise_color=0.02, noise_xyz=0.01)
    vox = pcl2voxel.voxelize_pcl(pcl, 24, rng=np.random.default_rng(1), **rng_args)
    np.testing.assert_array_equal(vox, jpcl2voxel.voxelize_pcl(
        pcl, 24, rng=np.random.default_rng(1), **rng_args))

    frames = []

    class Recorder:
        def __init__(self, path, fourcc, fps, size):
            pass

        def write(self, frame):
            frames.append(frame.copy())

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoWriter", Recorder)
    jpcl2voxel.voxel_orbit_video(vox, tmp_path / "j.mp4", img_size=32, num_frames=4, fps=2)
    out = pcl2voxel.voxel_orbit_video(vox, tmp_path / "t.avi", img_size=32, num_frames=4,
                                      fps=2, device="cpu")
    got, fps = read_avi(out)
    ref = np.stack(frames)
    assert fps == 2 and got.shape == ref.shape == (4, 32, 32, 3)
    differ = np.abs(got.astype(int) - ref).max(-1) > 1
    assert differ.mean() <= 0.01, differ.mean()


def test_fixture_render_matches_jax():
    """The exporter fixture's Blender stand-in (boxes of one seeded car at
    three exporter cameras, 24^2, 64 samples) against the JAX one: pixels
    within fp32 roundings of the zeros lookup, the same background (inf)
    pixels, depth close where both hit."""
    from conditioned_nerf_gan_tpu.tools.blender import fixture as jfixture
    from conditioned_nerf_gan_torch.data.synthetic import _make_car
    from conditioned_nerf_gan_torch.tools.blender import fixture
    from conditioned_nerf_gan_torch.tools.blender.camera_utils import (
        BLENDER_CAM_FLIP,
        blender_cam_pose,
        sample_cam,
    )

    boxes = _make_car(np.random.default_rng(9))
    cams = np.stack([blender_cam_pose(o) @ BLENDER_CAM_FLIP
                     for o in sample_cam(3, 1.1, 1.1, 10)]).astype(np.float32)
    pix, depth = fixture.render_views(boxes, cams, 24, FOV, 0.25, 1.95, device="cpu")
    j_pix, j_depth = jfixture._render_views(boxes, cams, 24, FOV, 0.25, 1.95)
    np.testing.assert_allclose(pix, j_pix, atol=1e-3)
    assert (np.isinf(depth) == np.isinf(j_depth)).mean() >= 0.99
    hit = np.isfinite(depth) & np.isfinite(j_depth)
    assert hit.mean() > 0.05
    np.testing.assert_allclose(depth[hit], j_depth[hit], atol=1e-3)


def test_export_car_writes_the_exporter_layout(tmp_path):
    """export_car writes cameras.npz, 16-bit RGBA PNGs, RLE EXR depths the
    port's reader decodes, and the surface samples, and the camera check
    passes on its EXR depth."""
    from conditioned_nerf_gan_torch.data.exr import read_exr_depth
    from conditioned_nerf_gan_torch.data.synthetic import _make_car
    from conditioned_nerf_gan_torch.tools.blender import fixture
    from conditioned_nerf_gan_torch.utils.png import read_png

    car = tmp_path / "car0000"
    boxes = _make_car(np.random.default_rng(11))
    fixture.export_car(car, boxes, 2, 24, FOV, 1.1, 0.25, 1.95, 2048, 12, device="cpu")
    img = read_png(car / "image" / "0001.png")
    assert img.shape == (24, 24, 4) and img.dtype == np.uint16
    depth = read_exr_depth(car / "depth" / "00010001.exr")
    assert depth.shape == (24, 24) and 0 < (depth > 0).mean() < 1
    points = np.load(car / "pointcloud.npz")["points"]
    np.save(car / "pcl_color.npy", np.concatenate([points, np.ones_like(points)], axis=1))
    assert geometry.check_camera_convention(car, view=1, device="cpu") < 0.02


@pytest.fixture(scope="module")
def converted_run(tmp_path_factory):
    """A JAX run (smoke curriculum at z 16, width 32, on a JAX fixture) and
    its checkpoint converted to the port's."""
    from flax import serialization

    from conditioned_nerf_gan_tpu.config import curriculum_to_json, load_curriculum
    from conditioned_nerf_gan_tpu.data import make_synthetic_shapenet as j_make_synthetic
    from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
    from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
    from conditioned_nerf_gan_tpu.models import ResnetPointnet as JPointnet

    root = tmp_path_factory.mktemp("geoloss")
    ds_root = j_make_synthetic(root / "data", n_cars=2, n_views=2, img_size=16, n_points=512,
                               voxel_resolutions=(32,))
    curriculum = load_curriculum(config_base="smoke")
    curriculum["generator"].update(z_dim=16, hidden_dim=32)
    curriculum["dataset"]["path"] = str(ds_root)
    run = root / "run"
    run.mkdir()
    curriculum_to_json(curriculum, run / "curriculum.json")
    gen = JGenerator(siren_type="SHORTSIREN", z_dim=16, hidden_dim=32, use_fast_sin=True)
    params_G = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 16)), jnp.eye(4)[None],
                        JRenderConfig(img_size=4, num_steps=4))
    params_E = JPointnet(c_dim=16).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 6)))
    ckpt = run / "checkpoints" / "3.ckpt"
    ckpt.parent.mkdir()
    ckpt.write_bytes(serialization.to_bytes({"params_G": params_G, "params_E": params_E,
                                             "step": 3}))
    return ckpt, bridge.convert_checkpoint(ckpt)


def test_geoloss_replay_matches_jax(converted_run, capsys):
    """The geometry-loss replay of a converted run against the JAX tool's
    on the JAX checkpoint (the same car, positives and negatives), and the
    CLI's line."""
    from conditioned_nerf_gan_tpu.tools.geoloss import replay_geometry_loss as j_replay
    from conditioned_nerf_gan_torch.tools import geoloss

    jax_ckpt, port_ckpt = converted_run
    got = geoloss.replay_geometry_loss(port_ckpt, n_points=256, device="cpu")
    ref = j_replay(jax_ckpt, n_points=256)
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert geoloss.main([str(port_ckpt), "--n_points", "256", "--device", "cpu"]) == 0
    assert f"geometry loss: {got:.4f}" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
@pytest.mark.parametrize("tool", ["geometry", "geoloss", "voxel_render", "pcl2voxel"])
def test_tool_clis_refuse_cuda_without_a_card(tool, tmp_path, capsys):
    """Each tool runs on cuda unless given --device cpu, and exits 2
    without a card."""
    import importlib

    module = importlib.import_module(f"conditioned_nerf_gan_torch.tools.{tool}")
    argv = {"geometry": ["chamfer", "a.npy", "b.npy"], "geoloss": ["x.pt"],
            "voxel_render": ["--dataset_path", str(tmp_path), "--out_dir", str(tmp_path)],
            "pcl2voxel": ["--dataset_path", str(tmp_path), "--video"]}[tool]
    assert module.main(argv) == 2
    assert "--device cpu" in capsys.readouterr().err


NUMPY_TOOLS = ["converters", "latents", "plots", "video_grid", "write_pcl_color",
               "prepare_data", "submit_slurm", "blender.draw", "blender.project",
               "blender.render_shapenet"]


@pytest.mark.parametrize("tool", NUMPY_TOOLS)
def test_numpy_tools_run_without_jax(tool):
    """The JAX package's tools that import only numpy run as they are where
    jax, jaxlib and flax cannot be imported (the card's machine has none),
    so the port does not copy them: `--help` exits 0, and the Blender
    script, which runs inside Blender, names it."""
    code = (
        "import sys, runpy\n"
        "for name in ('jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['{tool}', '--help']\n"
        f"runpy.run_module('conditioned_nerf_gan_tpu.tools.{tool}', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    if tool == "blender.render_shapenet":
        assert "must run inside Blender" in out.stderr, out.stderr
    else:
        assert out.returncode == 0, out.stderr
        assert "usage:" in out.stdout
