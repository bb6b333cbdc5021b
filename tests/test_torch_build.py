"""CPU tests of the kernel build's library names (ops/kernels/build.py).

A library is named by the hash of its source, of every shared header beside
it and of the compiler flags, so an edited header is never served by a stale
library. Naming reads files only: these tests run without nvcc.
"""

import pytest

from conditioned_nerf_gan_torch.ops.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source directory of two kernels sharing one header; nvcc refused."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "first.cu").write_text('#include "shared.cuh"\n// first\n')
    (src / "second.cu").write_text('#include "shared.cuh"\n// second\n')
    (src / "shared.cuh").write_text("// shared, version 1\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")

    def no_nvcc():
        raise AssertionError("naming a library must not need nvcc")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    return src


@pytest.mark.parametrize("name", ["first", "second"])
def test_editing_a_shared_header_renames_every_library(csrc, name):
    before = build._library_path(name)
    (csrc / "shared.cuh").write_text("// shared, version 2\n")
    after = build._library_path(name)
    assert after != before
    assert after.parent == before.parent and after.name.startswith(f"{name}-")


def test_adding_a_header_renames_the_library(csrc):
    before = build._library_path("first")
    (csrc / "more.cuh").write_text("// another shared header\n")
    assert build._library_path("first") != before


def test_editing_the_source_renames_only_its_library(csrc):
    first, second = build._library_path("first"), build._library_path("second")
    (csrc / "first.cu").write_text('#include "shared.cuh"\n// first, edited\n')
    assert build._library_path("first") != first
    assert build._library_path("second") == second


def test_the_flags_are_in_the_name(csrc, monkeypatch):
    before = build._library_path("first")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._library_path("first") != before


def test_names_are_stable_and_distinct(csrc):
    assert build._library_path("first") == build._library_path("first")
    assert build._library_path("first") != build._library_path("second")


@pytest.mark.parametrize("name", ["film_siren_fwd", "film_siren_bwd", "film_siren_study",
                                  "trilinear_fwd"])
def test_every_kernel_of_the_package_is_named_without_nvcc(monkeypatch, name):
    def no_nvcc():
        raise AssertionError("naming a library must not need nvcc")

    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    path = build._library_path(name)
    assert path.parent == build.BUILD_DIR and path.name.startswith(f"{name}-")
    assert path.suffix == ".so"
