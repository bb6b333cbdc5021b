"""The slice end to end on the CPU: the port's generator, encoder -> render
path and CLI vs the JAX package, plus the port's import hygiene."""

import subprocess
import sys
from pathlib import Path

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
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.models import ImplicitGenerator3d, RenderConfig
from conditioned_nerf_gan_torch.models import ResnetPointnet, encode_pcl

REPO = Path(__file__).resolve().parent.parent
Z, H = 16, 32
# the thesis policy: on the CPU both wrappers take the fp32 reference
POLICY_J = dict(compute_dtype=jnp.bfloat16, use_fast_sin=True, use_pallas=True)
POLICY_T = dict(compute_dtype=torch.bfloat16, use_fast_sin=True, use_kernel=True)
CFG = dict(img_size=16, num_steps=12, fov=49.134342641202636, ray_start=0.25,
           ray_end=1.95, hierarchical_sample=True, white_back=True, perturb=False)


def _cams(n, seed):
    from conditioned_nerf_gan_torch.ops import create_cam2world_matrix, sample_camera_positions

    u = torch.from_numpy(np.random.default_rng(seed).uniform(0.1, 0.9, (n, 3))
                         .astype(np.float32))
    return create_cam2world_matrix(sample_camera_positions(
        n, cam_r_start=0.7, cam_r_end=1.5, uniforms=u))


def _generators(seed=0):
    jgen = JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H, **POLICY_J)
    params = jgen.init(jax.random.PRNGKey(seed), jnp.zeros((1, Z)), jnp.eye(4)[None],
                       JRenderConfig(img_size=4, num_steps=4))
    tgen = ImplicitGenerator3d(z_dim=Z, hidden_dim=H, **POLICY_T)
    tgen.load_state_dict(bridge.params_to_state_dict(jax.tree.map(np.asarray, params)))
    return jgen, params, tgen


def _compare(jgen, params, tgen, z, cams, chunks, **slab):
    """slab: optional row_offset/render_rows (a horizontal slab of the image)."""
    jcfg = JRenderConfig(ray_chunks=chunks, **CFG)
    j_pix, j_depth = jax.jit(lambda p, zz, c: jgen.apply(p, zz, c, jcfg, rng=None,
                                                         **slab))(
        params, jnp.asarray(z.numpy()), jnp.asarray(cams.numpy()))
    with torch.no_grad():
        t_pix, t_depth = tgen(z, cams, RenderConfig(ray_chunks=chunks, **CFG), **slab)
    rows = slab.get("render_rows", 16)
    assert t_pix.shape == (2, rows, 16, 3) and t_depth.shape == (2, rows, 16)
    # fp32 on both sides; SIREN outputs agree to ~1e-6 and the integrator,
    # inverse-CDF and merge are continuous in them (observed 4.8e-7 pixels,
    # 6.0e-7 depth)
    np.testing.assert_allclose(t_pix.numpy(), np.asarray(j_pix), atol=1e-4)
    np.testing.assert_allclose(t_depth.numpy(), np.asarray(j_depth), atol=1e-4)


@pytest.mark.parametrize("chunks,slab", [
    (0, {}), (4, {}), (2, dict(row_offset=4, render_rows=8)),
], ids=["whole", "ray_chunks", "row_slab"])
def test_generator_matches_jax(chunks, slab, monkeypatch):
    import conditioned_nerf_gan_torch.models.siren as siren_module

    wrapper = siren_module.film_siren_mlp
    calls = []

    def spy(points, *args):  # what the CUDA kernel would be handed
        assert points.is_contiguous() and points.shape[-1] == 3
        calls.append(points.shape)
        return wrapper(points, *args)

    monkeypatch.setattr(siren_module, "film_siren_mlp", spy)
    jgen, params, tgen = _generators()
    z = torch.from_numpy(np.random.default_rng(5).normal(size=(2, Z)).astype(np.float32))
    _compare(jgen, params, tgen, z, _cams(2, seed=6), chunks, **slab)
    assert len(calls) == 2 * max(chunks, 1)  # coarse + fine per ray chunk


def test_encoder_to_generator_matches_jax():
    rng = np.random.default_rng(7)
    pcl = rng.uniform(-0.35, 0.35, (2, 64, 6)).astype(np.float32)
    jenc = JPointnet(c_dim=Z, hidden_dim=H)
    params_E = jenc.init(jax.random.PRNGKey(8), jnp.asarray(pcl))
    tenc = ResnetPointnet(c_dim=Z, hidden_dim=H)
    tenc.load_state_dict(bridge.params_to_state_dict(jax.tree.map(np.asarray, params_E)))
    jz, _ = j_encode_pcl(jenc.apply, params_E, jnp.asarray(pcl))
    with torch.no_grad():
        tz, _ = encode_pcl(tenc, torch.from_numpy(pcl))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5)  # observed 2.4e-7
    jgen, params_G, tgen = _generators(seed=9)
    _compare(jgen, params_G, tgen, tz, _cams(2, seed=10), chunks=0)


@pytest.fixture(scope="module")
def converted_run(tmp_path_factory):
    """A run dir with a smoke-scale curriculum and a port checkpoint
    converted from a flax msgpack checkpoint."""
    from conditioned_nerf_gan_tpu.config import curriculum_to_json, load_curriculum
    from conditioned_nerf_gan_tpu.data import make_synthetic_shapenet

    root = tmp_path_factory.mktemp("torch_cli")
    ds_root = make_synthetic_shapenet(root / "data", n_cars=2, n_views=2, img_size=16,
                                      n_points=256, voxel_resolutions=(32,))
    curriculum = load_curriculum(config_base="smoke")
    curriculum["generator"].update(z_dim=Z, hidden_dim=H)
    curriculum["dataset"]["path"] = str(ds_root)
    run = root / "run"
    run.mkdir()
    curriculum_to_json(curriculum, run / "curriculum.json")

    step = 3
    gen = JGenerator(siren_type="SHORTSIREN", z_dim=Z, hidden_dim=H, use_fast_sin=True)
    params_G = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, Z)), jnp.eye(4)[None],
                        JRenderConfig(img_size=4, num_steps=4))
    # the Inferencer builds PointNet at its default hidden width (512)
    params_E = JPointnet(c_dim=Z).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 6)))
    ckpt = run / "checkpoints" / f"{step}.ckpt"
    ckpt.parent.mkdir()
    ckpt.write_bytes(serialization.to_bytes(
        {"params_G": params_G, "params_E": params_E, "step": step}))
    return bridge.convert_checkpoint(ckpt)


def test_cli_images_writes_grid(converted_run):
    from conditioned_nerf_gan_torch.infer.__main__ import main

    assert main([str(converted_run), "--images", "--num_imgs", "2",
                 "--image_size", "16", "--device", "cpu"]) == 0
    grids = list((converted_run.parent.parent / "inference").glob("3_random_*.png"))
    assert len(grids) == 1 and grids[0].stat().st_size > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_cli_defaults_to_cuda_and_refuses_without_it(converted_run, capsys):
    from conditioned_nerf_gan_torch.infer.__main__ import main, parse_args

    assert parse_args([str(converted_run)]).device == "cuda"
    assert main([str(converted_run), "--images", "--num_imgs", "2",
                 "--image_size", "16"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_load_metadata_is_the_thesis_model():
    """With no run curriculum, the port's metadata is the thousand preset
    chain that chip_smoke.py serves, as the JAX package resolves it."""
    from conditioned_nerf_gan_tpu.config import extract_metadata, load_curriculum
    from conditioned_nerf_gan_torch.infer import load_metadata

    meta = load_metadata(30000)
    assert meta == extract_metadata(load_curriculum(config_base="thousand"), 30000)
    gen = meta["generator"]
    assert (gen["siren_type"], gen["z_dim"], meta["ray_chunks"]) == ("SHORTSIREN", 512, 16)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the system only through the port's package:
    it imports neither jax, flax nor the JAX package itself."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    modules = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
               for alias in node.names}
    modules |= {node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.module}
    roots = {m.split(".")[0] for m in modules}
    assert "conditioned_nerf_gan_torch" in roots
    assert not roots & {"jax", "flax", "conditioned_nerf_gan_tpu"}, roots


def test_cli_refuses_unported_features(converted_run, capsys, monkeypatch):
    """What the port's CLI still refuses: the JAX backend switch (the port
    takes --device). `--shard_rays`, once refused, renders: without more
    than one card it renders as without the flag (the JAX CLI's rule), and
    over two devices (`shard_devices` stood in for: "cpu:0" twice, a device
    other than the generator's, so each slab runs on a replica) through
    `render_ray_sharded`; the same grid bytes each time."""
    from conditioned_nerf_gan_torch.infer import inference
    from conditioned_nerf_gan_torch.infer.__main__ import main

    assert main([str(converted_run), "--shard_rays", "--platform", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "--platform" in err and "--device" in err and "--shard_rays" not in err

    sharded, render_ray_sharded = [], inference.render_ray_sharded
    monkeypatch.setattr(inference, "render_ray_sharded",
                        lambda *a, **k: sharded.append(a[4]) or render_ray_sharded(*a, **k))
    grids, calls = [], []
    for flags in ([], ["--shard_rays"], ["--shard_rays"]):
        if len(grids) == 2:
            monkeypatch.setattr(inference, "shard_devices",
                                lambda device, img_size: [torch.device("cpu", 0)] * 2)
        assert main([str(converted_run), "--images", "--image_size", "16", "--num_imgs", "2",
                     "--device", "cpu", *flags]) == 0
        out = converted_run.parent.parent / "inference"
        newest = max(out.glob("*.png"), key=lambda p: p.stat().st_mtime)
        grids.append(newest.read_bytes())
        newest.unlink()  # names are stamped to the second
        calls.append(len(sharded))
    assert grids[0] == grids[1] == grids[2]
    assert calls[:2] == [0, 0] and calls[2] > 0
    assert all(devices == [torch.device("cpu", 0)] * 2 for devices in sharded)


def test_port_imports_without_jax():
    """Every port module (and chip_smoke.py) imports with jax, flax and the
    JAX package blocked; only bridge.convert_checkpoint reaches for flax,
    lazily."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['conditioned_nerf_gan_tpu'] = None\n"
        "import conditioned_nerf_gan_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "loaded = [m for m in sys.modules if sys.modules[m] is not None]\n"
        "assert not [m for m in loaded if m.split('.')[0] in "
        "('jax', 'flax', 'conditioned_nerf_gan_tpu')], loaded\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30


def test_port_sources_never_import_the_jax_package():
    """No import statement of the port names conditioned_nerf_gan_tpu: the
    port keeps its own copies of the config, data and image modules."""
    import ast

    offenders = []
    for path in sorted((REPO / "conditioned_nerf_gan_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            offenders += [f"{path.name}: {n}" for n in names
                          if n.split(".")[0] in ("conditioned_nerf_gan_tpu", "jax")]
    assert offenders == []


def test_inferencer_defaults_to_cuda_and_refuses_without_it(converted_run, monkeypatch):
    """Without a card, an Inferencer built with the default device raises
    and names device="cpu"; it never carries on on the CPU."""
    from conditioned_nerf_gan_torch.infer import Inferencer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Inferencer(converted_run, image_size=16, load_dataset=False)
    inf = Inferencer(converted_run, image_size=16, load_dataset=False, device="cpu")
    assert next(inf.generator.parameters()).device.type == "cpu"
