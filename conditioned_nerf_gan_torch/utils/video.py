"""Uncompressed AVI video, in numpy and `struct` (the port does not use cv2).

`write_avi` writes RIFF AVI 1.0: one `vids` stream of BI_RGB 24-bit
top-down DIB frames (a negative biHeight; `00db` chunks, each row padded to
4 bytes) and an `idx1` index of key frames. Frames are handed over as cv2
takes them, BGR uint8 (n, H, W, 3). FFmpeg, and so `cv2.VideoCapture`,
reads the frames back bit-exact. Top-down because OpenCV 5.0's FFmpeg
reader crashes on bottom-up BI_RGB frames, whose rows FFmpeg hands over
with a negative stride. `read_avi` reads a file back for the tests.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(kind: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", kind + payload)


def _dib(frame: np.ndarray) -> bytes:
    """A BGR (H, W, 3) frame as a top-down 24-bit DIB, rows padded to 4 bytes."""
    h, w, _ = frame.shape
    rows = np.zeros((h, (3 * w + 3) & ~3), np.uint8)
    rows[:, :3 * w] = frame.reshape(h, 3 * w)
    return rows.tobytes()


def write_avi(path: str | Path, frames: np.ndarray, fps: int) -> Path:
    """Write BGR uint8 frames (n, H, W, 3) at `fps` as an uncompressed AVI."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
        raise ValueError(f"write_avi takes BGR uint8 frames (n, H, W, 3), not "
                         f"{frames.dtype} {frames.shape}")
    n, h, w, _ = frames.shape
    size = ((3 * w + 3) & ~3) * h
    avih = struct.pack("<10I4I", round(1e6 / fps), size * fps, 0, _AVIF_HASINDEX, n, 0, 1,
                       size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"DIB ", 0, 0, 0, 0, 1, fps, 0, n,
                       size, -1, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, index, offset = [], [], 4  # idx1 offsets count from the 'movi' fourcc
    for frame in frames:
        data = _chunk(b"00db", _dib(frame))
        index.append(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME, offset, size))
        movi.append(data)
        offset += len(data)
    body = (b"AVI " + hdrl + _list(b"movi", b"".join(movi))
            + _chunk(b"idx1", b"".join(index)))
    path = Path(path)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


def _walk(data: bytes, start: int, end: int):
    """(fourcc, payload start, payload size) of each chunk in data[start:end];
    a LIST yields its kind as the fourcc."""
    pos = start
    while pos + 8 <= end:
        fourcc, size = struct.unpack_from("<4sI", data, pos)
        if fourcc == b"LIST":
            yield data[pos + 8:pos + 12], pos + 12, size - 4
        else:
            yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)


def read_avi(path: str | Path) -> tuple[np.ndarray, int]:
    """The BGR uint8 frames (n, H, W, 3) and fps of an AVI `write_avi` wrote."""
    data = Path(path).read_bytes()
    riff, _, kind = struct.unpack_from("<4sI4s", data, 0)
    if (riff, kind) != (b"RIFF", b"AVI "):
        raise ValueError(f"{path}: not a RIFF AVI file")
    fps = w = h = None
    frames = []
    for fourcc, start, size in _walk(data, 12, len(data)):
        if fourcc == b"hdrl":
            for sub, s, n in _walk(data, start, start + size):
                if sub == b"strl":
                    for leaf, ls, _ in _walk(data, s, s + n):
                        if leaf == b"strh":
                            scale, rate = struct.unpack_from("<II", data, ls + 20)
                            fps = rate // scale
                        elif leaf == b"strf":
                            _, w, h, _, bits, compression = struct.unpack_from(
                                "<IiiHHI", data, ls)
                            if (bits, compression) != (24, 0):
                                raise ValueError(f"{path}: not BI_RGB 24-bit frames")
        elif fourcc == b"movi":
            stride, rows_down = (3 * w + 3) & ~3, -1 if h > 0 else 1  # h > 0: bottom-up
            for sub, s, n in _walk(data, start, start + size):
                if sub == b"00db":
                    rows = np.frombuffer(data, np.uint8, n, s).reshape(abs(h), stride)
                    frames.append(rows[::rows_down, :3 * w].reshape(abs(h), w, 3))
    return np.stack(frames), fps
