"""Image resizing with OpenCV's rules, in numpy: `cv2.resize`'s INTER_AREA
(downscaling) and INTER_LINEAR, which the dataset reader and the sample
grids use, without cv2 (the GPU machine has none).

INTER_AREA averages each output pixel over its exact source rectangle with
fractional edge weights (OpenCV's `computeResizeAreaTab`): a horizontal
pass, then a vertical one, each summing its taps in order in float32
(float64 for float64 images) with float32 weights. At a ratio of exactly 2, OpenCV takes its fast
path: a uint16 image rounds `(a + b + c + d + 2) >> 2`, and a float32 image
of 1 or 4 channels sums the two row pairs first. INTER_LINEAR takes
half-pixel centres and replicated borders, as `native/fastload.cc` does.
uint16 results round to nearest, ties to even (OpenCV's `saturate_cast`).

The same rules in C++ are `native/fastload.cc:175-230`. Area results agree
with cv2 bit for bit where the tests compare them; linear results agree to
float32 rounding (OpenCV fuses some of its multiply-adds).
"""

from __future__ import annotations

import math

import numpy as np


def _area_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """Per output index, the source indices and weights of its rectangle,
    (dst, m) each, padded with weight-0 taps on index 0."""
    scale = src / dst
    taps = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        taps.append(row)
    m = max(len(row) for row in taps)
    idx = np.zeros((dst, m), np.int64)
    weight = np.zeros((dst, m), np.float64)
    for d, row in enumerate(taps):
        for k, (s, w) in enumerate(row):
            idx[d, k], weight[d, k] = s, w
    return idx, weight


def _linear_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per output index, its two source indices and the float32 weight of
    the second (OpenCV's coefficient rule, borders replicated)."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    low = s < 0
    f[low], s[low] = 0.0, 0
    high = s >= src - 1
    f[high], s[high] = 0.0, src - 1
    return s, np.minimum(s + 1, src - 1), f


def _taps_sum(x: np.ndarray, axis: int, idx: np.ndarray, weight: np.ndarray,
              acc) -> np.ndarray:
    """sum_k x[idx[:, k]] * weight[:, k] along `axis`, in tap order, in
    `acc` arithmetic."""
    shape = [1] * x.ndim
    shape[axis] = -1
    out = None
    for k in range(idx.shape[1]):
        term = (np.take(x, idx[:, k], axis=axis)
                * weight[:, k].astype(np.float32).astype(acc).reshape(shape))
        out = term if out is None else out + term
    return out


def _touched(bad: np.ndarray, axis: int, idx: np.ndarray, live: np.ndarray) -> np.ndarray:
    """Whether any live tap of each output reads a True of `bad`."""
    shape = [1] * bad.ndim
    shape[axis] = -1
    out = np.zeros_like(np.take(bad, idx[:, 0], axis=axis))
    for k in range(idx.shape[1]):
        out |= np.take(bad, idx[:, k], axis=axis) & live[:, k].reshape(shape)
    return out


def _area_2x(x: np.ndarray) -> np.ndarray:
    a, b = x[0::2, 0::2], x[0::2, 1::2]
    c, d = x[1::2, 0::2], x[1::2, 1::2]
    if x.dtype == np.uint16:
        s = a.astype(np.int64) + b + c + d
        return ((s + 2) >> 2).astype(np.uint16)
    quarter = x.dtype.type(0.25)
    if x.dtype == np.float32 and (x.ndim == 2 or x.shape[2] in (1, 4)):
        return ((a + b) + (c + d)) * quarter
    return (((a + b) + c) + d) * quarter


def resize(img: np.ndarray, size, interpolation: str) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=INTER_AREA or INTER_LINEAR)`
    for an (H, W) or (H, W, C) uint16, float32 or float64 image; `size` is
    (h, w) or one side of a square; `interpolation` "area" (downscaling
    only, as the callers use it) or "linear". An output pixel whose taps
    read a non-finite value is NaN."""
    x = np.asarray(img)
    if x.dtype not in (np.uint16, np.float32, np.float64):
        raise TypeError(f"resize takes uint16, float32 or float64 images, not {x.dtype}")
    out_h, out_w = (size, size) if np.isscalar(size) else size
    h, w = x.shape[:2]
    if (out_h, out_w) == (h, w):
        return x.copy()
    acc = np.float64 if x.dtype == np.float64 else np.float32
    if interpolation == "area":
        if out_h > h or out_w > w:
            raise ValueError("area resizing here only shrinks an image")
        if h == 2 * out_h and w == 2 * out_w and np.isfinite(x).all():
            return _area_2x(x)
        (iy, wy), (ix, wx) = _area_taps(h, out_h), _area_taps(w, out_w)
        live_y, live_x = wy > 0, wx > 0
    elif interpolation == "linear":
        y0, y1, fy = _linear_taps(h, out_h)
        x0, x1, fx = _linear_taps(w, out_w)
        iy, ix = np.stack([y0, y1], 1), np.stack([x0, x1], 1)
        one = np.float32(1.0)
        wy, wx = np.stack([one - fy, fy], 1), np.stack([one - fx, fx], 1)
        live_y = live_x = np.ones_like(iy, dtype=bool)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    values = x.astype(acc)
    bad = ~np.isfinite(values)
    if bad.any():
        values = np.where(bad, 0.0, values).astype(acc)
    out = _taps_sum(_taps_sum(values, 1, ix, wx, acc), 0, iy, wy, acc)
    if bad.any():
        out[_touched(_touched(bad, 1, ix, live_x), 0, iy, live_y)] = np.nan
    if x.dtype == np.uint16:
        return np.clip(np.rint(out), 0, 65535).astype(np.uint16)
    return out.astype(x.dtype)
