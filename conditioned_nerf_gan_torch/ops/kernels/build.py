"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into `_build/<name>-<hash>.so`, beside the package in
a directory that .gitignore lists. The hash covers the source, every shared
header `csrc/*.cuh` and the flags, so an edited source or header is never
served by a stale library. The TMA kernels reach the tensor-map encoder, a
libcuda function, through the runtime (`cudaGetDriverEntryPoint`), so no
flag links libcuda. Nothing here runs at import time: the CPU tests import
every module, and the host may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelLibrary:
    """A compiled kernel library, its build time and the compiler's report."""

    def __init__(self, name: str, path: Path, build_seconds: float, log: str):
        self.name = name
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))


_LOADED: dict[str, KernelLibrary] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> Path:
    """The library of `csrc/<name>.cu`, named by the hash of the source, the
    headers beside it and the flags; reads files only."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load_libraries(*names: str) -> list[KernelLibrary]:
    """Compile every missing `csrc/<name>.cu`, one nvcc each, all started
    together; then load them all."""
    started = {}
    for name in names:
        if name in _LOADED:  # the hash reads every source: once per process
            continue
        out = _library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in started.items():
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        _LOADED[name] = KernelLibrary(name, out, seconds, log)
    for name in names:
        if name not in _LOADED:
            _LOADED[name] = KernelLibrary(name, _library_path(name), 0.0,
                                          "(cached build)")
    return [_LOADED[name] for name in names]


def load_library(name: str) -> KernelLibrary:
    """Compile `csrc/<name>.cu` if its library is missing, then load it."""
    return load_libraries(name)[0]
