"""The port's own copies of the JAX package's config, data reader and image
writer (conditioned_nerf_gan_torch/{config,data,utils}) against the
originals: every preset resolves to the same curriculum and metadata, the
JSON round-trip holds, the ShapeNet reader yields the same arrays and the
grid writer the same pixels."""

from pathlib import Path

import numpy as np
import pytest

import conditioned_nerf_gan_tpu.config as jconfig
import conditioned_nerf_gan_tpu.data as jdata
import conditioned_nerf_gan_torch.config as tconfig
import conditioned_nerf_gan_torch.data as tdata
from conditioned_nerf_gan_tpu.config.presets import ALIASES as J_ALIASES
from conditioned_nerf_gan_tpu.utils.image import save_image_grid as j_save_grid
from conditioned_nerf_gan_torch.config.presets import ALIASES as T_ALIASES
from conditioned_nerf_gan_torch.config.presets import resolve_siren_alias
from conditioned_nerf_gan_torch.utils.image import save_image_grid as t_save_grid


def _preset_names(base: str) -> list:
    """None (default ∘ special) and every experiment dict the JAX preset
    package `base` exposes."""
    module = jconfig.get_config_base(base)
    return [None] + sorted(name for name, value in vars(module).items()
                           if isinstance(value, dict) and not name.startswith("_")
                           and name not in ("default", "special"))


PRESETS = [(base, name) for base in ("thousand", "smoke") for name in _preset_names(base)]


@pytest.mark.parametrize("base,name", PRESETS,
                         ids=[f"{base}-{name or 'base'}" for base, name in PRESETS])
def test_preset_resolves_like_jax(base, name):
    """The same curriculum, and the same metadata at every stage-start step."""
    port = tconfig.load_curriculum(config_base=base, config=name)
    ref = jconfig.load_curriculum(config_base=base, config=name)
    assert port == ref
    starts = sorted(k for k in ref if isinstance(k, int))
    assert starts
    for step in starts:
        assert tconfig.extract_metadata(port, step) == jconfig.extract_metadata(ref, step)


def test_port_preset_packages_are_the_ports():
    assert tconfig.get_config_base("thousand").__name__ == (
        "conditioned_nerf_gan_torch.config.presets.thousand")
    assert T_ALIASES == J_ALIASES
    assert resolve_siren_alias("TALLSIREN_dg") == "TALLSIREN_FG"
    assert resolve_siren_alias("SHORTSIREN") == "SHORTSIREN"


def test_curriculum_json_round_trip(tmp_path):
    """Both write the same file and read it back the same (tuples come back
    as lists, integer milestone keys as ints); a second trip is exact."""
    cur = tconfig.load_curriculum(config_base="thousand", config="dg")
    tconfig.curriculum_to_json(cur, tmp_path / "curriculum.json")
    jconfig.curriculum_to_json(cur, tmp_path / "jax.json")
    assert (tmp_path / "curriculum.json").read_text() == (tmp_path / "jax.json").read_text()
    loaded = tconfig.curriculum_from_json(tmp_path / "curriculum.json")
    assert loaded == jconfig.curriculum_from_json(tmp_path / "curriculum.json")
    assert sorted(k for k in loaded if isinstance(k, int)) == sorted(
        k for k in cur if isinstance(k, int))
    tconfig.curriculum_to_json(loaded, tmp_path / "again.json")
    assert tconfig.curriculum_from_json(tmp_path / "again.json") == loaded
    # the precedence: a run's own curriculum.json beats the presets
    assert tconfig.load_curriculum(output_dir=tmp_path, config_base="smoke") == loaded


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    pytest.importorskip("cv2")
    return jdata.make_synthetic_shapenet(
        tmp_path_factory.mktemp("shapenet"), n_cars=3, n_views=3, img_size=32,
        n_points=512, voxel_resolutions=(32,))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_shapenet_dataset_matches_jax(dataset_root, mode):
    meta = {"num_points_ratio": 0.5, "dataset": {}}
    kwargs = dict(load_voxel=True, load_pcl=True, dataset_mode=mode, voxel_resolution=32,
                  load_depth=True, cond_mode="nearest", seed=3)
    port = tdata.ShapeNetDataset(dataset_root, 16, "twenty", meta, **kwargs)
    ref = jdata.ShapeNetDataset(dataset_root, 16, "twenty", meta, **kwargs)
    assert [p.name for p in port.data] == [p.name for p in ref.data]
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert a.keys() == b.keys() >= {"img", "depth", "voxel", "pcl", "cam2world"}
        for key in b:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    # a shuffled, collated batch through the port's loader
    port_batch = next(iter(tdata.DataLoader(port, batch_size=2, shuffle=True, seed=1)))
    ref_batch = next(iter(jdata.DataLoader(ref, batch_size=2, shuffle=True, seed=1)))
    for key in ref_batch:
        np.testing.assert_array_equal(port_batch[key], ref_batch[key], err_msg=key)


def test_save_image_grid_writes_the_same_pixels(tmp_path):
    cv2 = pytest.importorskip("cv2")
    images = np.random.default_rng(0).uniform(-0.1, 1.1, (5, 8, 6, 3)).astype(np.float32)
    t_save_grid(images, tmp_path / "port" / "grid.png", nrow=3, padding=1)
    j_save_grid(images, tmp_path / "jax" / "grid.png", nrow=3, padding=1)
    port = cv2.imread(str(tmp_path / "port" / "grid.png"), cv2.IMREAD_UNCHANGED)
    ref = cv2.imread(str(tmp_path / "jax" / "grid.png"), cv2.IMREAD_UNCHANGED)
    assert port.shape == ref.shape == (2 * 8 + 3, 3 * 6 + 4, 3)
    np.testing.assert_array_equal(port, ref)


def test_native_loader_builds_into_the_ports_build_dir():
    """The port's native.py compiles native/fastload.cc into its own
    gitignored _build/, never beside the source as the JAX copy does."""
    from conditioned_nerf_gan_torch.data import native

    pkg = Path(tdata.__file__).resolve().parent.parent
    assert native._LIB == pkg / "_build" / "libfastload.so"
    assert native._SRC == pkg.parent / "native" / "fastload.cc" and native._SRC.exists()


def test_native_png_decode_matches_jax(dataset_root):
    """Where a toolchain builds it, the port's library decodes a dataset
    PNG to the same floats as the JAX package's."""
    from conditioned_nerf_gan_tpu.data import native as jnative
    from conditioned_nerf_gan_torch.data import native as tnative

    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ toolchain to build native/fastload.cc")
    png = sorted(Path(dataset_root).glob("*/image/*.png"))[0]
    np.testing.assert_array_equal(tnative.read_png16(png, 16), jnative.read_png16(png, 16))
