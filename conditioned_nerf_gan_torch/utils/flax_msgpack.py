"""A reader for flax's msgpack checkpoints, in plain Python (the port of
`flax.serialization.msgpack_restore`, which imports jax).

A JAX `{step}.ckpt` is one msgpack document: maps, arrays, strings, numbers
and three extension types of flax's `_MsgpackExtType` (ndarray 1,
native_complex 2, npscalar 3). An ndarray's payload is itself a msgpack
array (shape, dtype name, C-order bytes). Leaves larger than 1 GiB were
split by flax into a `__msgpack_chunked_array__` map of flat chunks, which
`msgpack_restore` joins again. Arrays come back as numpy arrays read by
dtype name; a `bfloat16` leaf, which numpy cannot carry, comes back as a
torch bfloat16 tensor; any other unknown dtype raises, naming it.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

_NDARRAY, _NATIVE_COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-size heads: type byte -> (struct format, bytes)
_NUMBERS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
            0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
            0xD2: (">i", 4), 0xD3: (">q", 8)}
_LENGTHS = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes, ext_hook):
        self.data, self.pos, self.ext_hook = memoryview(data), 0, ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated document")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def length(self, size: int) -> int:
        return struct.unpack(_LENGTHS[size], self.take(size))[0]

    def items(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        return self.ext_hook(code, bytes(self.take(n)))

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.mapping(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.items(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in _NUMBERS:
            fmt, n = _NUMBERS[t]
            return struct.unpack(fmt, self.take(n))[0]
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.length(1 << (t - 0xC4))))
        if t in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.length(1 << (t - 0xD9))), "utf-8")
        if t in (0xDC, 0xDD):  # array 16/32
            return self.items(self.length(2 << (t - 0xDC)))
        if t in (0xDE, 0xDF):  # map 16/32
            return self.mapping(self.length(2 << (t - 0xDE)))
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (t - 0xD4))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self.ext(self.length(1 << (t - 0xC7)))
        raise ValueError(f"msgpack: unknown type byte {t:#x}")


def unpackb(data: bytes, ext_hook=None):
    """Decode one msgpack document (strings as str, bin as bytes)."""
    reader = _Reader(data, ext_hook or (lambda code, payload: (code, payload)))
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the document")
    return out


def _ndarray_from_bytes(payload: bytes):
    shape, name, buffer = unpackb(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return flat.reshape(tuple(shape))
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: array of dtype {name!r}, which neither numpy nor "
                         "torch carries") from None
    return np.frombuffer(buffer, dtype=dtype).reshape(tuple(shape), order="C")


def _ext_hook(code: int, payload: bytes):
    if code == _NDARRAY:
        return _ndarray_from_bytes(payload)
    if code == _NATIVE_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    if code == _NPSCALAR:
        return _ndarray_from_bytes(payload)[()]
    raise ValueError(f"msgpack: unknown extension type {code}")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def msgpack_restore(data: bytes):
    """A flax msgpack document -> its tree of dicts, lists and leaves
    (`flax.serialization.msgpack_restore`)."""
    return _unchunk(unpackb(data, _ext_hook))
