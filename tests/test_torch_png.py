"""The port's own image code against OpenCV, and its fixture writer and
native-loader build against the JAX package's, on the CPU: the PNG codec
(`utils/png.py`), cv2's INTER_AREA and INTER_LINEAR (`utils/resize.py`),
the EXR depth resize, `data/synthetic.py` and `data/native.py`. Inputs are
seeded numpy; the JAX fixture is written once for the module."""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

import conditioned_nerf_gan_tpu.data as jdata
import conditioned_nerf_gan_torch.data as tdata
from conditioned_nerf_gan_tpu.data import exr as jexr
from conditioned_nerf_gan_torch.data import exr as texr
from conditioned_nerf_gan_torch.data import native
from conditioned_nerf_gan_torch.data.synthetic import make_synthetic_shapenet
from conditioned_nerf_gan_torch.utils import png
from conditioned_nerf_gan_torch.utils.image import save_image_grid
from conditioned_nerf_gan_torch.utils.resize import resize

cv2 = pytest.importorskip("cv2")


FIXTURE = dict(n_cars=3, n_views=4, img_size=32, n_points=512)


@pytest.fixture(scope="module")
def jax_fixture(tmp_path_factory):
    return jdata.make_synthetic_shapenet(tmp_path_factory.mktemp("jax_fixture"), **FIXTURE)


def _cv2_rgb(path) -> np.ndarray:
    """cv2.imread in the file's channel order (RGB[A])."""
    x = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if x.ndim == 2:
        return x[..., None]
    return x[..., [2, 1, 0, 3][:x.shape[2]]] if x.shape[2] == 4 else x[..., ::-1]


def test_png16_decode_is_bit_equal_to_cv2(jax_fixture):
    paths = sorted(Path(jax_fixture).glob("*/image/*.png"))
    assert len(paths) == FIXTURE["n_cars"] * FIXTURE["n_views"]
    for path in paths:
        out = png.read_png(path)
        assert out.dtype == np.uint16 and out.shape == (32, 32, 4)
        np.testing.assert_array_equal(out, _cv2_rgb(path), err_msg=path.name)


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """A PNG of `img` whose row y uses filter filters[y % len(filters)]."""
    depth = 8 * img.dtype.itemsize
    h, w, c = img.shape
    bpp = c * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    rows = rows.reshape(h, -1).astype(np.int64)
    prev = np.zeros(rows.shape[1], np.int64)
    lines = []
    for y in range(h):
        r, f = rows[y], filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        c_ = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [np.zeros_like(r), a, prev, (a + prev) >> 1, png._paeth(a, prev, c_)][f]
        lines.append(np.concatenate([[f], (r - pred) & 0xFF]).astype(np.uint8))
        prev = r
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (png._SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(np.stack(lines).tobytes()))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decode_undoes_all_five_filters(tmp_path, dtype, channels):
    """Rows cycling through None, Sub, Up, Average and Paeth (the
    anti-diagonal path), and rows of None/Sub/Up only (the row path), each
    decoded as cv2 decodes them."""
    img = np.random.default_rng(channels).integers(
        0, np.iinfo(dtype).max + 1, (23, 17, channels)).astype(dtype)
    for name, filters in (("all", [0, 1, 2, 3, 4, 4, 3]), ("rows", [0, 1, 2, 2])):
        path = tmp_path / f"{name}.png"
        path.write_bytes(_filtered_png(img, filters))
        np.testing.assert_array_equal(png.read_png(path), img, err_msg=name)
        np.testing.assert_array_equal(_cv2_rgb(path), img, err_msg=name)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_round_trips_through_cv2(tmp_path, dtype, channels):
    img = np.random.default_rng(7).integers(
        0, np.iinfo(dtype).max + 1, (19, 13, channels)).astype(dtype)
    png.write_png(tmp_path / "x.png", img)
    np.testing.assert_array_equal(_cv2_rgb(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(png.read_png(tmp_path / "x.png"), img)


def test_grid_writer_decodes_to_cv2_imwrites_pixels(tmp_path):
    """save_image_grid's 8-bit RGB PNG against cv2.imwrite of the same grid."""
    images = np.random.default_rng(0).uniform(-0.1, 1.1, (5, 8, 6, 3)).astype(np.float32)
    save_image_grid(images, tmp_path / "grid.png", nrow=3, padding=1)
    grid = png.read_png(tmp_path / "grid.png")
    assert grid.shape == (2 * 8 + 3, 3 * 6 + 4, 3) and grid.dtype == np.uint8
    cv2.imwrite(str(tmp_path / "cv2.png"), np.ascontiguousarray(grid[..., ::-1]))
    np.testing.assert_array_equal(_cv2_rgb(tmp_path / "grid.png"),
                                  _cv2_rgb(tmp_path / "cv2.png"))


# (source side, output side, mode): the dataset's downscales 128 -> 64 and
# 128 -> 32 (INTER_AREA), its upscale 64 -> 128 (INTER_LINEAR), and a
# non-integer ratio each way
RESIZES = [(128, 64, "area"), (128, 32, "area"), (128, 48, "area"), (64, 128, "linear"),
           (48, 128, "linear")]


@pytest.mark.parametrize("src,dst,mode", RESIZES)
@pytest.mark.parametrize("dtype,channels", [(np.float32, None), (np.float32, 3),
                                            (np.float32, 4), (np.uint16, 3)])
def test_resize_matches_cv2(src, dst, mode, dtype, channels):
    """float32: area within 1e-7 of the image's max (observed: bit-equal),
    linear within 1e-6 of it (observed 1.6e-7: OpenCV fuses some of its
    multiply-adds). uint16: within 1 (one rounding; observed 0)."""
    rng = np.random.default_rng(src + dst)
    shape = (src, src) if channels is None else (src, src, channels)
    if dtype == np.uint16:
        x = rng.integers(0, 65536, shape).astype(np.uint16)
    else:
        x = rng.uniform(0, 3, shape).astype(np.float32)
    flag = cv2.INTER_AREA if mode == "area" else cv2.INTER_LINEAR
    ref = cv2.resize(x, (dst, dst), interpolation=flag)
    out = resize(x, dst, mode)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    diff = np.abs(out.astype(np.float64) - ref.astype(np.float64)).max()
    if dtype == np.uint16:
        assert diff <= 1
    else:
        assert diff <= (1e-7 if mode == "area" else 1e-6) * np.abs(x).max()


@pytest.mark.parametrize("size", [16, 24, 64])
def test_exr_depth_resize_matches_jax(tmp_path, size):
    """read_exr_depth with the background (65504 -> inf, zeroed after the
    resize) at 32 -> 16 (area, 2x), 32 -> 24 (area) and 32 -> 64 (linear)
    against the JAX package's cv2 path, to fp64 rounding (1e-12)."""
    rng = np.random.default_rng(size)
    depth = rng.uniform(0.5, 1.5, (32, 32)).astype(np.float32)
    depth[:, :9] = 65504.0
    depth[20:, 25:] = 65504.0
    path = tmp_path / "d.exr"
    jexr.write_exr(path, {"R": depth, "G": depth, "B": depth})
    port, ref = texr.read_exr_depth(path, size), jexr.read_exr_depth(path, size)
    np.testing.assert_array_equal(port == 0, ref == 0)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-12)


def test_fixture_writer_matches_jax(jax_fixture, tmp_path):
    """The same seed and sizes give the same split lists, cameras, clouds
    and voxels; the renders (fp32 sums in another order) give depth maps
    within 1e-6 (observed 3.6e-7) and 16-bit pixels within 2 (observed 1)."""
    port = make_synthetic_shapenet(tmp_path / "port", **FIXTURE, device="cpu")
    ref = Path(jax_fixture)
    for lst in sorted(ref.parent.glob("*.lst")):
        assert (port.parent / lst.name).read_text() == lst.read_text()
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    for rel in files:
        a, b = ref / rel, port / rel
        if rel.suffix == ".npz":
            ra, rb = np.load(a), np.load(b)
            assert ra.files == rb.files
            for k in ra.files:
                np.testing.assert_array_equal(rb[k], ra[k], err_msg=f"{rel} {k}")
        elif rel.name == "pcl_color.npy":
            np.testing.assert_array_equal(np.load(b), np.load(a))
        elif rel.suffix == ".npy":
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=0, atol=1e-6,
                                       err_msg=str(rel))
        else:
            diff = np.abs(png.read_png(b).astype(np.int64) - _cv2_rgb(a).astype(np.int64))
            assert diff.max() <= 2, rel


def test_port_dataset_reads_the_port_fixture_like_jax(tmp_path):
    """The port's fixture, read by both packages' datasets (the port's
    decoder and resize against cv2): the same samples, bit for bit."""
    root = make_synthetic_shapenet(tmp_path, **FIXTURE, device="cpu")
    meta = {"num_points_ratio": 0.5, "dataset": {}}
    kwargs = dict(load_voxel=False, load_pcl=True, dataset_mode="train", load_depth=True,
                  seed=1)
    for size in (16, 64):
        port = tdata.ShapeNetDataset(root, size, "twenty", meta, **kwargs)
        ref = jdata.ShapeNetDataset(root, size, "twenty", meta, **kwargs)
        for i in range(len(ref)):
            a, b = port[i], ref[i]
            for key in ("img", "depth", "pcl", "cam2world"):
                if size > 32 and key in ("img", "depth"):
                    # INTER_LINEAR: OpenCV's fused multiply-adds, one uint16
                    # rounding of the image
                    np.testing.assert_allclose(a[key], b[key], rtol=0, atol=2 * 2 / 65535)
                else:
                    np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key} {i}")


def test_native_loader_raises_when_it_cannot_build(tmp_path, monkeypatch):
    """CNG_NATIVE_LOADER=1 with no compiler: the reader raises and says
    what is missing, instead of falling back."""
    import subprocess

    def no_compiler(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_LIB", tmp_path / "libfastload.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "_error", "")
    monkeypatch.setattr(subprocess, "run", no_compiler)
    monkeypatch.setenv("CNG_NATIVE_LOADER", "1")
    root = make_synthetic_shapenet(tmp_path / "d", n_cars=1, n_views=2, img_size=8,
                                   n_points=16, voxel_resolutions=(32,), device="cpu")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tdata.ShapeNetDataset(root, 8, "twenty", {"dataset": {}}, load_voxel=False,
                              load_pcl=False)
    assert not native.available() and "g++" in native.build_error()


def test_native_build_writes_through_a_temporary_name(tmp_path, monkeypatch):
    """The compiler writes a name of its own, which is renamed onto the
    library: a process building at the same time never loads half a file."""
    import subprocess

    outputs = []

    def fake_gxx(cmd, **kwargs):
        out = Path(cmd[cmd.index("-o") + 1])
        outputs.append(out)
        out.write_bytes(b"library")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    lib = tmp_path / "_build" / "libfastload.so"
    monkeypatch.setattr(native, "_LIB", lib)
    monkeypatch.setattr(subprocess, "run", fake_gxx)
    assert native._build()
    assert len(outputs) == 1 and outputs[0] != lib and outputs[0].parent == lib.parent
    assert lib.read_bytes() == b"library" and not outputs[0].exists()
