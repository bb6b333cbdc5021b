"""ctypes bindings for the native fastload data path (native/fastload.cc).

Port copy of conditioned_nerf_gan_tpu/data/native.py. Compiles the shared
library on first use (g++ -O3) into the port's `_build/` (a directory that
.gitignore lists, beside the kernels' libraries), through a temporary name
that is moved into place whole, so a process that builds it at the same time
as another never loads a half-written file. `available()` says whether it
built; `build_error()` says why not. Enable in the reader with
CNG_NATIVE_LOADER=1, which then raises when the library is unavailable.

The reader's default path decodes PNGs in numpy (`utils/png.py`); the
JAX package's copy of this module records how the two compared on its hosts.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "fastload.cc"
_LIB = _PKG / "_build" / "libfastload.so"

_lib = None
_load_failed = False
_error = ""


def _build() -> bool:
    """Compile to a name of this process's own, then rename it onto _LIB
    (atomic on one file system)."""
    global _error
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    try:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC),
             "-lz", "-lpthread"],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, _LIB)
        return True
    except FileNotFoundError as exc:
        _error = f"no C++ compiler ({exc})"
    except subprocess.CalledProcessError as exc:
        _error = f"g++ failed: {exc.stderr.strip()[-500:]}"
    finally:
        tmp.unlink(missing_ok=True)
    return False


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _lib, _load_failed, _error
    if _lib is not None or _load_failed:
        return _lib
    if not _SRC.exists():
        _error = f"{_SRC} is missing"
        _load_failed = True
        return None
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError as exc:
        _error = f"could not load {_LIB}: {exc}"
        _load_failed = True
        return None
    lib.fastload_png16.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
    ]
    lib.fastload_png16.restype = ctypes.c_int
    lib.fastload_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ]
    lib.fastload_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> str:
    """Why the library is unavailable ("" when it loaded or was not tried)."""
    return _error


def read_png16(path: str | Path, img_size: int, scale: float = 2.0,
               shift: float = -1.0) -> np.ndarray:
    """Decode+resize+normalize one 16-bit PNG → (S, S, 3) float32.

    Default affine (×2 −1) reproduces the dataset's Normalize(0.5, 0.5).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("fastload library unavailable")
    out = np.empty((img_size, img_size, 3), np.float32)
    rc = lib.fastload_png16(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img_size, scale, shift,
    )
    if rc != 0:
        raise RuntimeError(f"fastload_png16({path}) failed with code {rc}")
    return out


def read_png16_batch(paths: list[str | Path], img_size: int,
                     scale: float = 2.0, shift: float = -1.0,
                     n_threads: int | None = None) -> np.ndarray:
    """Decode a whole batch through the C++ thread pool → (N, S, S, 3)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("fastload library unavailable")
    n = len(paths)
    out = np.empty((n, img_size, img_size, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.fastload_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img_size, scale, shift, n_threads or min(8, os.cpu_count() or 1),
    )
    if rc != 0:
        raise RuntimeError(f"fastload_batch failed with code {rc}")
    return out


def _exr_bound(lib):
    if getattr(lib, "_exr_bound", False):
        return
    lib.fastload_exr_depth.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.fastload_exr_depth.restype = ctypes.c_int
    lib.fastload_exr_depth_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.fastload_exr_depth_batch.restype = ctypes.c_int
    lib._exr_bound = True


def read_exr_depth_native(path: str | Path, img_size: int) -> np.ndarray:
    """C++ EXR depth decode (data/exr.py::read_exr_depth semantics):
    R channel, 65504 -> inf before the area resize, non-finite zeroed."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("fastload library unavailable")
    _exr_bound(lib)
    out = np.empty((img_size, img_size), np.float32)
    rc = lib.fastload_exr_depth(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), img_size,
    )
    if rc != 0:
        raise RuntimeError(f"fastload_exr_depth({path}) failed with code {rc}")
    return out


def read_exr_depth_batch(paths: list[str | Path], img_size: int,
                         n_threads: int | None = None) -> np.ndarray:
    """Thread-pool EXR depth decode -> (N, S, S) float32."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("fastload library unavailable")
    _exr_bound(lib)
    n = len(paths)
    out = np.empty((n, img_size, img_size), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.fastload_exr_depth_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img_size, n_threads or min(8, os.cpu_count() or 1),
    )
    if rc != 0:
        raise RuntimeError(f"fastload_exr_depth_batch failed with code {rc}")
    return out
