"""CPU tests of the kernel build's library names (ops/kernels/build.py).

A library is named by the hash of its source, of every shared header beside
it and of the compiler flags, so an edited header is never served by a stale
library. Naming reads files only: these tests run without nvcc. A source
that names its translation units (`// nvcc parts: P`) is compiled once a
part and linked; the commands are checked here without running them.
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


def test_one_part_is_one_command(csrc, monkeypatch):
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    assert build.parts("first") == 1
    tmp = csrc / "first.tmp"
    compiles, link = build.commands("first", tmp)
    assert link is None
    assert compiles == [["nvcc", *build.NVCC_FLAGS, "-o", str(tmp), str(csrc / "first.cu")]]


def test_parts_compile_apart_and_link_once(csrc, monkeypatch):
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    (csrc / "first.cu").write_text('#include "shared.cuh"\n// nvcc parts: 3\n')
    assert build.parts("first") == 3
    tmp = csrc / "first.tmp"
    compiles, link = build.commands("first", tmp)
    objects = [str(csrc / f"first.part{p}.o") for p in range(3)]
    assert [cmd[cmd.index("-o") + 1] for cmd in compiles] == objects
    for p, cmd in enumerate(compiles):
        assert "-c" in cmd and f"-DNVCC_PART={p}" in cmd and "-shared" not in cmd
        assert cmd[-1] == str(csrc / "first.cu") and "-Xptxas" in cmd
    assert link[0] == "nvcc" and "-shared" in link and "sm_90a" in " ".join(link)
    assert link[link.index("-o") + 1:] == [str(tmp), *objects]


def test_the_study_library_is_built_in_parts():
    """The study library's 16 kernels take ptxas one at a time: 8 parts."""
    assert build.parts("film_siren_study") == 8
    assert all(build.parts(name) == 1 for name in
               ("film_siren_fwd", "film_siren_bwd", "trilinear_fwd", "trilinear_bwd"))
