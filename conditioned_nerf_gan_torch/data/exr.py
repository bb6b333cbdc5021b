"""Minimal OpenEXR scanline reader (no external OpenEXR dependency).

Supports the subset Blender's depth passes use: single-part scanline files,
HALF/FLOAT channels, NONE/RLE/ZIPS/ZIP compression. `read_exr_depth` replicates
the reference's `readEXR` semantics (reference datasets.py:183-216): take the
R channel, map the half-float max 65504 to inf, resize, then zero out inf
(background) pixels.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..utils.resize import resize

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_COMPRESSION_SCANLINES = {0: 1, 1: 1, 2: 1, 3: 16}  # NONE, RLE, ZIPS, ZIP


def _read_null_string(buf: memoryview, pos: int) -> tuple[str, int]:
    end = pos
    while buf[end] != 0:
        end += 1
    return bytes(buf[pos:end]).decode("latin-1"), end + 1


def _unpredict_and_interleave(data: bytes) -> bytes:
    """Undo the EXR zip predictor + byte-plane split."""
    arr = np.frombuffer(data, dtype=np.uint8)
    # predictor: arr[i] += arr[i-1] - 128 (mod 256), sequential — vectorized
    # as a cumulative sum of (arr - 128) offsets.
    deltas = arr.astype(np.int64)
    deltas[1:] -= 128
    out = np.cumsum(deltas) % 256
    arr = out.astype(np.uint8)
    half = (len(arr) + 1) // 2
    inter = np.empty(len(arr), dtype=np.uint8)
    inter[0::2] = arr[:half]
    inter[1::2] = arr[half : half + len(arr) - half]
    return inter.tobytes()


def _rle_decompress(data: bytes) -> bytes:
    """OpenEXR RLE scheme: a signed count byte per run — negative means
    -count literal bytes follow, non-negative means count+1 copies of the
    next byte. The output then goes through the same predictor/interleave
    postprocess as zip."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        count = data[i]
        i += 1
        if count > 127:  # signed < 0: literal run
            run = 256 - count
            if i + run > n:
                raise ValueError(
                    f"corrupt RLE chunk: literal run of {run} bytes extends "
                    f"past the {n}-byte buffer"
                )
            out += data[i : i + run]
            i += run
        else:
            if i >= n:
                raise ValueError(
                    "corrupt RLE chunk: repeat run missing its value byte"
                )
            out += data[i : i + 1] * (count + 1)
            i += 1
    return bytes(out)


def read_exr(path: str | Path) -> dict[str, np.ndarray]:
    """Parse an EXR file into {channel_name: (H, W) float32 array}."""
    raw = Path(path).read_bytes()
    buf = memoryview(raw)
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    pos = 8

    channels: list[tuple[str, int]] = []
    data_window = None
    compression = 0
    while True:
        name, pos = _read_null_string(buf, pos)
        if not name:
            break
        attr_type, pos = _read_null_string(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_null_string(payload, cpos)
                (ptype,) = struct.unpack_from("<i", payload, cpos)
                cpos += 16  # type + pLinear/reserved + xSampling + ySampling
                channels.append((cname, ptype))
        elif name == "dataWindow":
            data_window = struct.unpack_from("<4i", payload, 0)
        elif name == "compression":
            compression = payload[0]

    if data_window is None:
        raise ValueError(f"{path}: missing dataWindow")
    if compression not in _COMPRESSION_SCANLINES:
        raise ValueError(f"{path}: unsupported compression {compression}")

    x_min, y_min, x_max, y_max = data_window
    width = x_max - x_min + 1
    height = y_max - y_min + 1
    channels.sort(key=lambda c: c[0])  # EXR stores channels alphabetically
    lines_per_chunk = _COMPRESSION_SCANLINES[compression]
    n_chunks = (height + lines_per_chunk - 1) // lines_per_chunk

    # scanline offset table
    pos += 8 * n_chunks

    out = {
        cname: np.empty((height, width), dtype=np.float32)
        for cname, _ in channels
    }
    for _ in range(n_chunks):
        y, nbytes = struct.unpack_from("<ii", buf, pos)
        pos += 8
        chunk = bytes(buf[pos : pos + nbytes])
        pos += nbytes
        n_lines = min(lines_per_chunk, y_max - y + 1)
        row_bytes = sum(
            width * np.dtype(_PIXEL_DTYPES[t]).itemsize for _, t in channels
        )
        expected = row_bytes * n_lines
        if compression in (2, 3) and nbytes < expected:
            chunk = _unpredict_and_interleave(zlib.decompress(chunk))
        elif compression == 1 and nbytes < expected:
            chunk = _unpredict_and_interleave(_rle_decompress(chunk))
        if len(chunk) != expected:
            raise ValueError(
                f"{path}: chunk at scanline {y} decoded to {len(chunk)} "
                f"bytes, expected {expected} — corrupt or truncated file"
            )
        cpos = 0
        for line in range(n_lines):
            for cname, ptype in channels:
                dtype = _PIXEL_DTYPES[ptype]
                nb = width * np.dtype(dtype).itemsize
                vals = np.frombuffer(chunk, dtype=dtype, count=width, offset=cpos)
                out[cname][y - y_min + line] = vals.astype(np.float32)
                cpos += nb
    return out


def read_exr_depth(path: str | Path, img_size: int | None = None) -> np.ndarray:
    """Depth map with the reference's background convention (datasets.py:183-216)."""
    chans = read_exr(path)
    key = "R" if "R" in chans else next(iter(chans))
    depth = chans[key].astype(np.float64)
    depth[depth == 65504] = np.inf
    if img_size is not None and img_size != depth.shape[0]:
        mode = "linear" if img_size > depth.shape[0] else "area"
        depth = resize(depth, img_size, mode)
    # zero ALL non-finite values, not just +inf: bilinear UPSCALE across the
    # inf background produces NaN (inf - inf inside cv2's lerp), which the
    # reference's `depth[depth == np.inf] = 0` (datasets.py:215) would leak
    # into the depth loss — latent there (it never upscales), fixed here.
    depth[~np.isfinite(depth)] = 0
    return depth


# ---------------------------------------------------------------------------
# Writer (the decoder's inverse): produce the same subset Blender's depth
# passes use — single-part scanline, HALF/FLOAT channels, NONE/RLE. Used by
# the exporter-fixture pipeline (tools/blender stand-in) and round-trip tests.
# ---------------------------------------------------------------------------

_COMPRESSION_IDS = {"none": 0, "rle": 1}


def _predict_and_deinterleave(data: bytes) -> bytes:
    """Forward transform of _unpredict_and_interleave: split bytes into the
    two half-planes, then delta-encode (d[i] = x[i] - x[i-1] + 128)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    planes = np.concatenate([arr[0::2], arr[1::2]])
    deltas = planes.astype(np.int64)
    deltas[1:] = deltas[1:] - planes[:-1].astype(np.int64) + 128
    return (deltas % 256).astype(np.uint8).tobytes()


def _rle_compress(data: bytes) -> bytes:
    """OpenEXR RLE scheme (see _rle_decompress): repeat runs as
    (count-1, byte) with count <= 128, literal runs as (256-len, bytes)."""
    out = bytearray()
    i, n = 0, len(data)
    lit_start = i
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            while lit_start < i:  # flush pending literals
                chunk = min(127, i - lit_start)
                out.append(256 - chunk)
                out += data[lit_start : lit_start + chunk]
                lit_start += chunk
            out.append(run - 1)
            out.append(data[i])
            i += run
            lit_start = i
        else:
            i += run
    while lit_start < i:
        chunk = min(127, i - lit_start)
        out.append(256 - chunk)
        out += data[lit_start : lit_start + chunk]
        lit_start += chunk
    return bytes(out)


def _attr(name: str, attr_type: str, payload: bytes) -> bytes:
    return (
        name.encode("latin-1") + b"\0" + attr_type.encode("latin-1") + b"\0"
        + struct.pack("<i", len(payload)) + payload
    )


def write_exr(path: str | Path, channels: dict[str, np.ndarray],
              compression: str = "rle") -> None:
    """Write a single-part scanline EXR (channels: {name: (H, W) array};
    float32 arrays become FLOAT channels, float16 become HALF)."""
    comp_id = _COMPRESSION_IDS[compression]
    names = sorted(channels)  # EXR stores channels alphabetically
    arrays = {}
    ptypes = {}
    height = width = None
    for name in names:
        arr = np.asarray(channels[name])
        if arr.ndim != 2:
            raise ValueError(f"channel {name!r} must be 2-D, got {arr.shape}")
        if height is None:
            height, width = arr.shape
        elif arr.shape != (height, width):
            raise ValueError("all channels must share one shape")
        if arr.dtype == np.float16:
            ptypes[name] = 1
        else:
            arr = arr.astype(np.float32)
            ptypes[name] = 2
        arrays[name] = arr

    chan_payload = bytearray()
    for name in names:
        chan_payload += name.encode("latin-1") + b"\0"
        chan_payload += struct.pack("<i", ptypes[name])
        chan_payload += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        chan_payload += struct.pack("<ii", 1, 1)  # x/y sampling
    chan_payload += b"\0"

    box = struct.pack("<4i", 0, 0, width - 1, height - 1)
    header = bytearray()
    header += struct.pack("<ii", _MAGIC, 2)
    header += _attr("channels", "chlist", bytes(chan_payload))
    header += _attr("compression", "compression", bytes([comp_id]))
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")  # increasing Y
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"  # end of header

    chunks = []
    for y in range(height):  # NONE and RLE are 1 scanline per chunk
        raw = b"".join(arrays[name][y].tobytes() for name in names)
        if comp_id == 1:
            packed = _rle_compress(_predict_and_deinterleave(raw))
            data = packed if len(packed) < len(raw) else raw
        else:
            data = raw
        chunks.append(struct.pack("<ii", y, len(data)) + data)

    offset_table_pos = len(header)
    data_pos = offset_table_pos + 8 * height
    offsets = []
    for chunk in chunks:
        offsets.append(data_pos)
        data_pos += len(chunk)

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{height}Q", *offsets))
        for chunk in chunks:
            f.write(chunk)


def write_exr_depth(path: str | Path, depth: np.ndarray,
                    compression: str = "rle", dtype=np.float16) -> None:
    """Write a depth map with the Blender-pipeline background convention:
    non-finite (background) pixels become the half-float max 65504, which
    read_exr_depth maps back to inf→0 (reference datasets.py:205-215).

    HALF channel by default — the 65504 background sentinel is the half max,
    i.e. the reference pipeline's depth passes were half-precision (and the
    constant background gives the RLE scheme actual runs to compress)."""
    depth = np.asarray(depth, dtype=np.float32).copy()
    background = ~np.isfinite(depth)  # mask BEFORE sentinel overwrite, so a
    # genuine finite depth of exactly 65504.0 is treated as foreground
    depth[background] = 65504.0
    if dtype == np.float16:
        # finite values at/past the half max would overflow to inf (or hit
        # the 65504 background sentinel) and read back as background 0 —
        # clip to the largest half BELOW the sentinel so foreground depth
        # stays foreground
        depth[~background] = np.minimum(depth[~background], 65472.0)
    write_exr(path, {"R": depth.astype(dtype)}, compression=compression)
