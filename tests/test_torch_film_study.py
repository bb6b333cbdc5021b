"""The FiLM-SIREN kernel study on the CPU: the port's plain version of every
(kernel, mode) of the study kernels K3 and K4 against the JAX bodies of
scripts/bench_film_kernel.py run in interpret mode, the port's fast_sin
against the JAX one, the wrapper's CPU path and the study CLI.

The CUDA study kernels run only on a card: tests/test_torch_cuda.py (marker
`cuda`) skips here, and `python3 chip_smoke.py` (phase 8) holds each kernel
against these plain versions at the study shape.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from conditioned_nerf_gan_tpu.ops.fastmath import fast_cos as j_fast_cos
from conditioned_nerf_gan_tpu.ops.fastmath import fast_sin as j_fast_sin
from conditioned_nerf_gan_torch.ops.fastmath import fast_cos, fast_sin
from conditioned_nerf_gan_torch.ops.kernels import build
import conditioned_nerf_gan_torch.ops.kernels.film_study as fs
from conditioned_nerf_gan_torch.ops.kernels.film_siren import film_siren_mlp_folded
from conditioned_nerf_gan_torch.tools import bench_film_kernel as tool

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_film_kernel.py"
N, TILE = 64, 32  # points per batch element, and the JAX tile (2 tiles each)
PAIRS = [(k, m) for k, modes in fs.STUDY_MODES.items() for m in modes]


@pytest.fixture(scope="module")
def jax_study():
    """The JAX study script as a module (it is a script, not a package
    module; loading it changes nothing in it)."""
    spec = importlib.util.spec_from_file_location("jax_bench_film_kernel", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _InterpretPallas:
    """`pl` with every pallas_call in interpret mode (the CPU has no TPU);
    every other attribute passes through."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


def _inputs(seed: int, freq_scale: float = 1 / 30):
    """The script's make_inputs distribution at N points, freq scaled."""
    arrays = tool.make_inputs(seed, N)
    arrays["freq"] = (arrays["freq"] * np.float32(freq_scale)).astype(np.float32)
    return arrays


def _jax_forward(module, kernel, mode, arrays):
    args = [jnp.asarray(arrays[k]) for k in tool.ARGS]
    if kernel == "v3":
        return module.forward_v3(*args, tile=TILE, mode=mode)
    return module.forward_v4(*args, tile=TILE, mode=mode)


# observed max|port - JAX| / max(1, max|JAX|) at freq/30 (max|JAX| in
# brackets): v3 single 2.6e-4 [4.24], nosin 4.5e-4 [10.3], nodot 4.6e-5
# [1.85], jnpsin 8.8e-4 [4.24]; v4 full 2.6e-4 [4.24], sin7 4.2e-4 [4.24],
# nosin 6.7e-4 [11.0], nodot 4.6e-5 [1.85]; v5 interleave 4.2e-4 [4.24]:
# a few flipped bf16 roundings of h through the study's N(0, 0.1) trunk
STUDY_TOL = 2e-3


@pytest.mark.parametrize("kernel,mode", PAIRS, ids=[f"{k}-{m}" for k, m in PAIRS])
def test_plain_version_matches_jax_body(jax_study, monkeypatch, kernel, mode):
    """The same folded bf16 operands on both sides; fp32 sums in another
    order, which at freq/30 nothing amplifies. The bound is relative above
    1 for `nosin`, whose outputs reach ~10 here."""
    monkeypatch.setattr(jax_study, "pl", _InterpretPallas())
    arrays = _inputs(seed=0)
    jmode = "interleave" if kernel == "v5" else mode
    ref = np.asarray(_jax_forward(jax_study, kernel, jmode, arrays))
    port = fs.film_study_reference(*(torch.from_numpy(arrays[k]) for k in tool.ARGS),
                                   kernel=kernel, mode=mode).numpy()
    assert port.shape == ref.shape == (2, N, 4)
    err = np.abs(port - ref).max() / max(1.0, np.abs(ref).max())
    print(f"{kernel} {mode}: max|port - JAX| / max(1, max|JAX|) {err:.2e}, "
          f"max|JAX| {np.abs(ref).max():.3g}")
    assert err <= STUDY_TOL


# the JAX variants the port runs on a study kernel, each at its own TPU tile
TILE_VARIANTS = sorted(name for name, (_, fn) in tool.VARIANTS.items()
                       if getattr(fn, "func", None) is fs.film_siren_study)
# observed max|port - JAX| / max(1, max|JAX|) at 2 TPU tiles a batch element
# (1,024-4,096 points, freq/30): 3.8e-4 (nodot modes) to 2.75e-3 (single2048,
# v4_2048): STUDY_TOL's flipped bf16 roundings over 16-64x the points of its
# N 64, so a larger max. Both sides are as far from the same math with fp64
# sums (the JAX bodies 2.1e-3-3.4e-3, the port 1.4e-3-3.2e-3), and the JAX
# bodies give the same outputs at tile 32 (v5 aside, whose half-tile dots
# change shape). About twice the largest reading, far below the O(0.1-1) of
# a tile that changed the function.
TILE_TOL = 6e-3


@pytest.mark.parametrize("name", TILE_VARIANTS)
def test_jax_variant_at_its_own_tile_matches_plain_version(jax_study, monkeypatch, name):
    """Each JAX variant the port runs, at its own TPU tile (2 tiles a batch
    element, interpret mode), against the port's plain version of its
    (kernel, mode): a tile does not change the function, on which the
    port's 1/16 tile map rests."""
    monkeypatch.setattr(jax_study, "pl", _InterpretPallas())
    jlabel, jfn = jax_study.VARIANTS[name]()
    tpu_tile = int(jlabel.rsplit("_", 1)[1])
    assert jfn.keywords["tile"] == tpu_tile
    kw = tool.VARIANTS[name][1].keywords
    arrays = tool.make_inputs(0, 2 * tpu_tile)
    arrays["freq"] = (arrays["freq"] / np.float32(30)).astype(np.float32)
    ref = np.asarray(jfn(*(jnp.asarray(arrays[k]) for k in tool.ARGS)))
    port = fs.film_study_reference(*(torch.from_numpy(arrays[k]) for k in tool.ARGS),
                                   kernel=kw["kernel"], mode=kw["mode"]).numpy()
    assert port.shape == ref.shape == (2, 2 * tpu_tile, 4)
    err = np.abs(port - ref).max() / max(1.0, np.abs(ref).max())
    print(f"{name} (TPU tile {tpu_tile}, Hopper tile {kw['tile']}): max|port - JAX| / "
          f"max(1, max|JAX|) {err:.2e}")
    assert err <= TILE_TOL


def test_mode_functions():
    """v4 sin7 and v5 are K1's function (the plain versions are the same
    ops, to the bit); v3 single and v4 full are one function; the two
    kernels' nosin modes are not."""
    t = [torch.from_numpy(_inputs(seed=1, freq_scale=1.0)[k]) for k in tool.ARGS]
    k1 = film_siren_mlp_folded(*t)
    for kernel, mode in (("v4", "sin7"), ("v5", "interleave")):
        torch.testing.assert_close(fs.film_study_reference(*t, kernel=kernel, mode=mode),
                                   k1, rtol=0, atol=0)
    torch.testing.assert_close(fs.film_study_reference(*t, kernel="v3", mode="single"),
                               fs.film_study_reference(*t, kernel="v4", mode="full"),
                               rtol=0, atol=0)
    torch.testing.assert_close(fs.film_study_reference(*t, kernel="v3", mode="nodot"),
                               fs.film_study_reference(*t, kernel="v4", mode="nodot"),
                               rtol=0, atol=0)
    v3, v4 = (fs.film_study_reference(*t, kernel=k, mode="nosin") for k in ("v3", "v4"))
    assert (v3 - v4).abs().max() > 1.0


def _ties() -> np.ndarray:
    """fp32 x whose x * (1/2pi) is exactly k + 1/2: the round-half-to-even
    case of the range reduction."""
    inv = np.float32(1 / (2 * np.pi))
    ties = []
    for k in range(-16, 16):
        y = np.float32(k + 0.5)
        x = np.float32(y / inv)
        for _ in range(8):
            p = np.float32(x * inv)
            if p == y:
                ties.append(x)
                break
            x = np.nextafter(x, np.float32(np.inf if p < y else -np.inf), dtype=np.float32)
    assert len(ties) > 16
    return np.array(ties, np.float32)


def test_fast_sin_matches_jax_bitwise():
    """On fp32 inputs over +-100 rad and at exact half-period ties, the
    port's fast_sin and fast_cos equal the JAX functions (called op by op,
    as the package defines them) to the bit."""
    x = np.concatenate([np.random.default_rng(0).uniform(-100, 100, 100_000),
                        np.arange(-31, 32) * np.pi]).astype(np.float32)
    x = np.concatenate([x, _ties()])
    assert (np.round(_ties() * np.float32(1 / (2 * np.pi))) % 2 == 0).all()
    for port_fn, jax_fn in ((fast_sin, j_fast_sin), (fast_cos, j_fast_cos)):
        port = port_fn(torch.from_numpy(x)).numpy()
        ref = np.asarray(jax_fn(jnp.asarray(x)))
        np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32))
    assert np.abs(fast_sin(torch.from_numpy(x)).numpy() - np.sin(x.astype(np.float64))).max() < 3e-5


def test_fast_sin_gradient_is_fast_cos():
    """The JAX custom JVP: d fast_sin = fast_cos of the same argument."""
    x = torch.linspace(-40, 40, 1001, requires_grad=True)
    (g,) = torch.autograd.grad(fast_sin(x).sum(), x)
    torch.testing.assert_close(g, fast_cos(x.detach()), rtol=0, atol=0)
    j = jax.grad(lambda v: j_fast_sin(v).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-6)


def test_wrapper_on_cpu_and_refusals():
    t = [torch.from_numpy(_inputs(seed=2)[k]) for k in tool.ARGS]
    before = dict(fs.film_siren_study.launches)
    out = fs.film_siren_study(*t, kernel="v4", mode="nosin", tile=128)
    assert fs.film_siren_study.launches == before
    torch.testing.assert_close(out, fs.film_study_reference(*t, kernel="v4", mode="nosin"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="no mode"):
        fs.film_siren_study(*t, kernel="v3", mode="sin7")
    with pytest.raises(ValueError, match="no mode"):
        fs.film_siren_study(*t, kernel="v6", mode="single")
    with pytest.raises(ValueError, match="no kernel"):
        fs.film_siren_study(*(a.to("meta") for a in t), kernel="v3", mode="single")
    # the study launches every (kernel, mode), at tiles a CTA holds: point-
    # major at wgmma's M (64 points a warpgroup), v5 at half a tile a
    # warpgroup
    instances = tool.kernel_instances()
    assert {(k, m) for k, m, _ in instances} == set(PAIRS)
    tiles = {k: {t for kk, _, t in instances if kk == k} for k in fs.STUDY_MODES}
    assert tiles == {"v3": {64, 128}, "v4": {32, 64, 128}, "v5": {64, 128}}
    assert len(instances) == 16


def _cu_enum(source: str, name: str) -> dict[str, int]:
    body = re.search(rf"enum {name} \{{([^}}]*)\}};", source).group(1)
    return {k.strip(): int(v) for k, v in (e.split("=") for e in body.split(","))}


def test_library_compiles_the_instances_the_study_launches():
    """The wrapper names a mode by the values of the .cu file's enums, and
    the library compiles exactly the (layout, tile, activations, products)
    instances that `kernel_instances` lists."""
    source = (Path(fs.__file__).resolve().parents[2] / "csrc"
              / "film_siren_study.cu").read_text()
    layouts, acts = _cu_enum(source, "Layout"), _cu_enum(source, "Act")
    assert layouts == {"kPointMajor": fs.LAYOUT_IDS["v3"], "kFeatureMajor": fs.LAYOUT_IDS["v4"],
                       "kInterleave": fs.LAYOUT_IDS["v5"]}
    assert acts == {"kFastSin": fs.ACT_IDS["fast_sin"], "kSin7": fs.ACT_IDS["sin7"],
                    "kAffine": fs.ACT_IDS["affine"], "kSinf": fs.ACT_IDS["sin"]}
    no_instance = re.search(r"constexpr int kNoInstance = (-?\d+);", source).group(1)
    assert int(no_instance) == fs._NO_INSTANCE
    cases = re.findall(r"^  STUDY_CASE\((\w+), (\d+), (\w+), (\w+), (true|false)\)$",
                       source, re.M)
    compiled = {(layouts[lay], int(t), acts[a0], acts[a], dot == "true")
                for lay, t, a0, a, dot in cases}
    assert len(compiled) == len(cases)
    needed = set()
    for kernel, mode, tile in tool.kernel_instances():
        a0, a, dot = fs.STUDY_MODES[kernel][mode]
        needed.add((fs.LAYOUT_IDS[kernel], tile, fs.ACT_IDS[a0], fs.ACT_IDS[a], dot))
    assert compiled == needed
    # compiled in parallel, two instances a translation unit, the entry in
    # part 0 asking every part
    parts = build.parts("film_siren_study")
    blocks = re.findall(r"^#(?:el)?if NVCC_PART == (\d+)\n((?:  STUDY_CASE\(.*\)\n)+)",
                        source, re.M)
    assert [int(p) for p, _ in blocks] == list(range(parts)) and parts == 8
    assert all(body.count("STUDY_CASE") == 2 for _, body in blocks)
    entry = source[source.index('extern "C" int film_siren_study('):]
    assert all(f"film_study_part{p}" in entry for p in range(parts))


def _cu_constants(source: str, names) -> dict[str, float]:
    return {n: float(re.search(rf"constexpr float {n} = ([-+.e0-9]+)f;", source).group(1))
            for n in names}


def test_kernel_fast_sin_is_fastmath_fast_sin():
    """The study kernels' fast_sin coefficients are ops/fastmath.py's."""
    import conditioned_nerf_gan_torch.ops.fastmath as fm

    source = (Path(fs.__file__).resolve().parents[2] / "csrc"
              / "film_siren_study.cu").read_text()
    found = _cu_constants(source, [f"F{k}" for k in (1, 3, 5, 7, 9, 11)])
    assert found == {f"F{k}": getattr(fm, f"_C{k}") for k in (1, 3, 5, 7, 9, 11)}


def _fma32(a, b, c):
    """fp32 fma: the exact product of two fp32 values fits a float64."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(
        np.float32)


def test_kernel_accurate_sin_replica_within_two_ulp():
    """`jnpsin`'s accurate sin (csrc/film_siren_study.cu `sin_accurate`),
    replayed in numpy from the constants in the source, op for op: within 2
    ulp of sin up to the limit of its reduction (torch.sin, which is sinf,
    is within 1)."""
    source = (Path(fs.__file__).resolve().parents[2] / "csrc"
              / "film_siren_study.cu").read_text()
    body = source[source.index("float sin_accurate("):]
    body = body[:body.index("\n}\n")]
    k = [np.float32(v) for v in re.findall(r"([-+]?\d+\.\d+(?:e[-+]?\d+)?)f", body)]
    shift, inv_pio2, p1, p2, p3, s9, s7, s5, s3, c8, c6, c4, c2, c0 = k
    limit = float(re.search(r"kSinLimit = ([.0-9]+)f", source).group(1))
    x = np.concatenate([np.random.default_rng(0).uniform(-limit, limit, 400_000),
                        np.random.default_rng(1).uniform(-50, 50, 400_000),
                        np.arange(-40, 41) * np.pi / 4]).astype(np.float32)
    t = _fma32(x, inv_pio2, shift)
    q = t.view(np.int32)
    qf = (t - shift).astype(np.float32)
    r = _fma32(-qf, p1, x)
    r = _fma32(-qf, p2, r)
    r = _fma32(-qf, p3, r)
    s = (r * r).astype(np.float32)
    sn = _fma32(_fma32(_fma32(s9, s, s7), s, s5), s, s3)
    sn = _fma32((sn * s).astype(np.float32), r, r)
    cs = _fma32(_fma32(_fma32(_fma32(c8, s, c6), s, c4), s, c2), s, c0)
    v = np.where(q & 1, cs, sn)
    v = np.where(q & 2, -v, v)
    exact = np.sin(x.astype(np.float64))
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert (np.abs(v - exact) / ulp).max() <= 2.0


def test_every_jax_variant_has_a_port(jax_study):
    """Every variant the JAX script names runs in the port, its label
    carrying the Hopper tile (the TPU tile / 16), or is refused with a
    reason that names ROADMAP.md B."""
    names = set(jax_study.VARIANTS) | set(jax_study.VJP_VARIANTS)
    ported = set(tool.VARIANTS) | set(tool.VJP_VARIANTS)
    assert names == ported | set(tool.REFUSED) and not ported & set(tool.REFUSED)
    assert all("ROADMAP.md B" in why for why in tool.REFUSED.values())
    assert set(tool.REFUSED) == {"single512", "single4096", "v4_4096", "vjp_kernel_512",
                                 "vjp_kernel_2048"}
    assert set(tool.DEFAULT_VARIANTS) | set(tool.SWEEPS) <= ported
    assert tool.DEFAULT_VARIANTS == ("xla", "v2", "single", "nosin", "nodot")
    for name, make in jax_study.VARIANTS.items():
        if name in tool.REFUSED:
            continue
        jlabel = make()[0]
        if jlabel[-4:].isdigit() or jlabel[-3:].isdigit():
            tpu_tile = int(jlabel.rsplit("_", 1)[1])
            assert tool.label(name).endswith(f"_{tpu_tile // 16}"), (name, tool.label(name))


def test_cli_on_cpu(capsys):
    assert tool.main(["--device", "cpu", "--n", "256", "single", "v4_sin7", "v5",
                      "vjp_kernel"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device: cpu") and "2x256 points" in lines[0]
    labels = [line.split(":")[0].strip() for line in lines[1:]]
    assert labels == ["v3_single_64", "v4_sin7_128", "v5_interleave_128", "vjp_k1_k2"]
    for line in lines[1:]:
        ms = float(line.split(":")[1].split("ms")[0])
        assert ms > 0 and "Mpts/s" in line
    assert tool.main(["--device", "cpu", "no_such_variant"]) == 2
    assert tool.main(["--device", "cpu", "--n", "256", "single", "vjp_kernel_2048"]) == 2
    captured = capsys.readouterr()
    assert not captured.out and "vjp_kernel_2048: not run" in captured.err
    assert "ROADMAP.md B" in captured.err
    assert tool.main(["--device", "cpu", "--n", "256", "single512"]) == 2
    captured = capsys.readouterr()
    assert not captured.out and "single512: not run" in captured.err
    assert "wgmma's M" in captured.err
