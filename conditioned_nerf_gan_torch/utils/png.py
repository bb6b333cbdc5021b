"""PNG decoding and encoding in numpy and the standard library's `zlib`,
without cv2 (the GPU machine has none).

`read_png` decodes a non-interlaced greyscale, grey + alpha, RGB or RGBA
PNG of 8 or 16 bits a sample, undoing all five scanline filters, to an
(H, W, C) uint8 or uint16 array in the file's channel order (RGB[A], where
cv2.imread gives BGR[A]). An image whose rows use only the None, Sub and Up
filters is unfiltered a row at a time; one with Average or Paeth rows, whose
bytes depend on their left neighbours, a pixel anti-diagonal at a time,
every row at once. `write_png` writes such an array with the Up filter on
every row.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """None, Sub and Up rows, (H, stride) -> (H, stride) bytes."""
    out = np.empty_like(raw)
    prior = np.zeros(raw.shape[1], np.int64)
    for y, f in enumerate(filters):
        row = raw[y].astype(np.int64)
        if f == 1:  # Sub: a running sum of each byte lane, mod 256
            row = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1)
        elif f == 2:
            row = row + prior
        prior = row & 0xFF
        out[y] = prior
    return out


def _unfilter_wavefront(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Any filters: pixel (y, x) needs its left, upper and upper-left
    neighbours, all on earlier anti-diagonals y + x."""
    H, stride = raw.shape
    W = stride // bpp
    raw = raw.reshape(H, W, bpp).astype(np.int64)
    x = np.zeros((H + 1, W + 1, bpp), np.int64)  # a zero row above, a zero column left
    for t in range(H + W - 1):
        ys = np.arange(max(0, t - W + 1), min(H, t + 1))
        xs = t - ys
        a, b, c = x[ys + 1, xs], x[ys, xs + 1], x[ys, xs]
        f = filters[ys][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        x[ys + 1, xs + 1] = (raw[ys, xs] + pred) & 0xFF
    return x[1:, 1:].reshape(H, stride)


def read_png(path: str | Path) -> np.ndarray:
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: colour type {colour}, depth {depth}, interlace "
                         f"{interlace} is not supported (8/16-bit grey, grey + alpha, "
                         "RGB or RGBA, not interlaced)")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    stride = width * bpp
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != height * (stride + 1):
        raise ValueError(f"{path}: image data holds {flat.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = flat.reshape(height, stride + 1)
    filters, raw = rows[:, 0], rows[:, 1:]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown scanline filter {filters.max()}")
    if np.isin(filters, (3, 4)).any():
        pixels = _unfilter_wavefront(raw, filters, bpp)
    else:
        pixels = _unfilter_rows(raw, filters, bpp)
    pixels = pixels.astype(np.uint8)
    if depth == 16:
        return pixels.reshape(height, width * channels, 2).view(">u2")[..., 0].astype(
            np.uint16).reshape(height, width, channels)
    return pixels.reshape(height, width, channels)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str | Path, image: np.ndarray, level: int = 6) -> None:
    """Write an (H, W) or (H, W, C) uint8 or uint16 array, C 1 (grey), 2
    (grey + alpha), 3 (RGB) or 4 (RGBA)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype not in (np.uint8, np.uint16) or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"write_png takes uint8/uint16 images of 1-4 channels, not "
                         f"{img.dtype} {img.shape}")
    height, width, channels = img.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    rows = rows.reshape(height, width * channels * img.dtype.itemsize)
    up = rows.astype(np.int16)
    up[1:] -= rows[:-1]
    scanlines = np.empty((height, rows.shape[1] + 1), np.uint8)
    scanlines[:, 0] = 2  # Up
    scanlines[:, 1:] = (up & 0xFF).astype(np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(scanlines.tobytes(), level))
        + _chunk(b"IEND", b""))
