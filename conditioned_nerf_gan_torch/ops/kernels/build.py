"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into `_build/<name>-<hash>.so`, beside the package in
a directory that .gitignore lists. The hash covers the source, every shared
header `csrc/*.cuh` and the flags, so an edited source or header is never
served by a stale library. A source whose line `// nvcc parts: P` names P
translation units is compiled P times, with `-DNVCC_PART=0` .. `P-1`, into
objects linked into one library: ptxas takes one kernel at a time, so a
library of many large kernels builds P times sooner. The TMA kernels reach
the tensor-map encoder, a libcuda function, through the runtime
(`cudaGetDriverEntryPoint`), so no flag links libcuda. Nothing here runs at import time: the CPU tests import
every module, and the host may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def parts(name: str) -> int:
    """The translation units `csrc/<name>.cu` is compiled in (its `// nvcc
    parts: P` line; 1 without one)."""
    found = re.search(r"^// nvcc parts: (\d+)$", (CSRC / f"{name}.cu").read_text(), re.M)
    return int(found.group(1)) if found else 1


def commands(name: str, tmp: Path) -> tuple[list[list[str]], list[str] | None]:
    """The nvcc commands that build `csrc/<name>.cu` into `tmp`: one that
    compiles and links it, or one per part (`-c`, into `tmp`'s `.part<p>.o`)
    and the link of their objects."""
    src = str(CSRC / f"{name}.cu")
    n = parts(name)
    if n == 1:
        return [[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]], None
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objects = [str(tmp.with_suffix(f".part{p}.o")) for p in range(n)]
    compiles = [[_nvcc(), *compile_flags, "-c", f"-DNVCC_PART={p}", "-o", obj, src]
                for p, obj in enumerate(objects)]
    return compiles, [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objects]


def load_libraries(*names: str) -> list[KernelLibrary]:
    """Compile every missing `csrc/<name>.cu` (one nvcc each, or one a part),
    all started together; then load them all."""
    started = {}
    for name in names:
        if name in _LOADED:  # the hash reads every source: once per process
            continue
        out = _library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        compiles, link = commands(name, tmp)
        logs = [tmp.with_suffix(f".{p}.log") for p in range(len(compiles))]
        procs = []
        for cmd, log in zip(compiles, logs):
            with log.open("w") as sink:
                procs.append(subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT))
        started[name] = (procs, logs, link, tmp, out, time.perf_counter())
    ends = {(name, p): None for name, entry in started.items() for p in range(len(entry[0]))}
    while None in ends.values():  # each part's time, for the log
        for (name, p), end in ends.items():
            if end is None and started[name][0][p].poll() is not None:
                ends[name, p] = time.perf_counter() - started[name][5]
        time.sleep(0.05)
    for name, (procs, paths, link, tmp, out, t0) in started.items():
        failed = any(proc.returncode != 0 for proc in procs)
        logs = [(f"part {p}: {ends[name, p]:.2f} s\n" if link else "") + path.read_text()
                for p, path in enumerate(paths)]
        for path in paths:
            path.unlink()
        if link and not failed:
            linked = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            logs.append(linked.stdout)
            failed = linked.returncode != 0
            for obj in link[link.index(str(tmp)) + 1:]:
                Path(obj).unlink(missing_ok=True)
        log = "".join(logs)
        seconds = time.perf_counter() - t0
        if failed:
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
