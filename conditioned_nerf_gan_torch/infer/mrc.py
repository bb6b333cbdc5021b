"""Minimal MRC-2014 volume writer (mode 2, float32); a copy of
conditioned_nerf_gan_tpu/infer/mrc.py, which the port does not import.

Replaces the reference's `mrcfile.new_mmap` usage (reference
inference.py:377-384) without the mrcfile dependency; output opens in
ChimeraX / mrcfile readers.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def write_mrc(path: str | Path, volume: np.ndarray, voxel_size: float = 1.0) -> None:
    """Write a 3-D float32 volume as an MRC file."""
    volume = np.ascontiguousarray(volume, np.float32)
    nz, ny, nx = volume.shape
    header = bytearray(1024)
    struct.pack_into("<3i", header, 0, nx, ny, nz)          # NX NY NZ
    struct.pack_into("<i", header, 12, 2)                   # MODE 2 = float32
    struct.pack_into("<3i", header, 28, nx, ny, nz)         # MX MY MZ
    struct.pack_into(
        "<3f", header, 40, nx * voxel_size, ny * voxel_size, nz * voxel_size
    )                                                       # CELLA
    struct.pack_into("<3f", header, 52, 90.0, 90.0, 90.0)   # CELLB
    struct.pack_into("<3i", header, 64, 1, 2, 3)            # MAPC MAPR MAPS
    struct.pack_into(
        "<3f", header, 76,
        float(volume.min()), float(volume.max()), float(volume.mean()),
    )                                                       # DMIN DMAX DMEAN
    header[208:212] = b"MAP "                               # MAP stamp
    header[212:216] = b"\x44\x44\x00\x00"                   # little-endian stamp
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(volume.tobytes())


def read_mrc(path: str | Path) -> np.ndarray:
    """The (NZ, NY, NX) float32 volume of a mode-2 MRC file `write_mrc`
    wrote; raises on another mode or a missing MAP stamp."""
    raw = Path(path).read_bytes()
    nx, ny, nz = struct.unpack_from("<3i", raw, 0)
    (mode,) = struct.unpack_from("<i", raw, 12)
    if mode != 2 or raw[208:212] != b"MAP ":
        raise ValueError(f"{path}: not a mode-2 MRC volume (mode {mode}, stamp {raw[208:212]!r})")
    return np.frombuffer(raw, np.float32, nx * ny * nz, 1024).reshape(nz, ny, nx)
