// Border-mode trilinear sampling of an NDHWC feature volume: what the
// forward kernel (trilinear_fwd.cu, K5) and its backward (trilinear_bwd.cu)
// share. Anchors, fractions and the lerp are rounded operation by operation
// as the torch version (ops/grid_sample.py::border_trilerp_reference) rounds
// them, with no FMA contraction, so both kernels agree with it to the bit on
// every product they share with it.
//
// Work layout of the forward and of the backward's dcoords kernel: one
// thread takes 4 channels (a float4) of one point, so C / 4 neighbouring
// lanes share a point and each corner row (C fp32, 128 bytes at C = 32) is
// one coalesced transaction. An item is (point, channel quad), point = b * N
// + n; one 256-thread CTA per 256 items, in point order. (The backward's dV
// kernel tiles points its own way: trilinear_bwd.cu.)
//
// Each item is a chain of dependent steps: its index, the coordinates'
// load, the anchors, the 8 corner loads, the lerps, the store. At the main
// path's sizes (~10^5 points a launch) a few such chains a thread are the
// kernel's time, so their latency, not the bytes, sets it. The short index
// path (`FAST`: C = 32, fewer than 2^31 items and one volume of fewer than
// 2^31 floats) takes the point and its quad by shifts, its batch element by
// one 32-bit division and its offset within the volume in 32 bits; the
// generic path (any C and size; the first design) divides 64-bit integers
// by C / 4 and by N, a software routine at the head of the chain.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace trilinear {

constexpr int THREADS = 256;

struct Axis {
  int i;        // anchor, in [0, max(size - 2, 0)]
  float t;      // fraction in [0, 1]
  bool inside;  // the unclamped position lies in [0, size - 1]: the clip passes grads
};

// A side of 1 clamps both corners onto index 0: the anchor is 0, the
// fraction 0, and the second corner is `step` (0 on that axis) from it.
__device__ __forceinline__ Axis anchor(float coord, int size) {
  // ((coord + 1) * size - 1) / 2, clamped to [0, size - 1]
  const float u = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(coord, 1.f), (float)size), 1.f), 0.5f);
  const float f = fminf(fmaxf(u, 0.f), (float)(size - 1));
  const int i = max(min((int)floorf(f), size - 2), 0);
  return {i, __fsub_rn(f, (float)i), u >= 0.f && u <= (float)(size - 1)};
}

// the offset of an axis' second corner from its first: the axis' stride, or
// 0 on a side of 1
__device__ __forceinline__ long long step(int size, long long stride) {
  return size > 1 ? stride : 0;
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  // a * (1 - t) + b * t, each operation rounded
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, t)), __fmul_rn(b, t));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  return make_float4(lerp(a.x, b.x, t), lerp(a.y, b.y, t), lerp(a.z, b.z, t),
                     lerp(a.w, b.w, t));
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
                     __fmul_rn(a.w, s));
}

// One item's point: its anchors and fractions, and the offset (in floats) of
// its lane's 4 channels of the (z0, y0, x0) corner row; the other corners are
// sx, sy, sz floats on (0 along a side of 1).
struct Sample {
  long long point;  // b * N + n
  int q;            // channel quad
  Axis ax, ay, az;
  long long base;
  long long sx, sy, sz;
};

// FAST: the launch passed `fast_path` (see above), so items and offsets
// within one volume fit in 32 bits; else any C and size.
template <bool FAST>
__device__ __forceinline__ Sample sample(const float* __restrict__ coords, long long item, int N,
                                         int D, int H, int W, int C) {
  Sample s;
  if constexpr (FAST) {
    const int point = (int)item >> 3;
    const int b = point / N;
    const float* xyz = coords + point * 3;
    s.point = point;
    s.q = (int)item & 7;
    s.ax = anchor(__ldg(xyz), W);
    s.ay = anchor(__ldg(xyz + 1), H);
    s.az = anchor(__ldg(xyz + 2), D);
    const int sy = W * 32, sz = H * W * 32;
    s.sx = step(W, 32);
    s.sy = step(H, sy);
    s.sz = step(D, sz);
    s.base = (long long)b * D * sz + (s.az.i * sz + s.ay.i * sy + s.ax.i * 32 + 4 * s.q);
  } else {
    const int quads = C / 4;
    s.point = item / quads;
    s.q = (int)(item % quads);
    const long long b = s.point / N;
    const float* xyz = coords + s.point * 3;
    s.ax = anchor(__ldg(xyz), W);
    s.ay = anchor(__ldg(xyz + 1), H);
    s.az = anchor(__ldg(xyz + 2), D);
    const long long sy = (long long)W * C, sz = (long long)H * W * C;
    s.sx = step(W, C);
    s.sy = step(H, sy);
    s.sz = step(D, sz);
    s.base = b * D * sz + s.az.i * sz + s.ay.i * sy + s.ax.i * (long long)C + 4 * s.q;
  }
  return s;
}

// The corners' x-lerps, in the order z0y0, z0y1, z1y0, z1y1 (the torch
// version's g00, g01, g10, g11), and the x-differences of the same pairs.
struct Corners {
  float4 lo[4], hi[4];  // x0 and x1 corner of each (z, y) pair
};

__device__ __forceinline__ Corners gather(const float* __restrict__ volume, const Sample& s) {
  const float* v = volume + s.base;
  const long long zy[4] = {0, s.sy, s.sz, s.sz + s.sy};
  Corners c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.lo[k] = __ldg(reinterpret_cast<const float4*>(v + zy[k]));
    c.hi[k] = __ldg(reinterpret_cast<const float4*>(v + zy[k] + s.sx));
  }
  return c;
}

// The short index path serves a launch of n_items items at C 32 whose
// volume (D, H, W, C) holds fewer than 2^31 floats; the generic path serves
// the rest.
inline bool fast_path(long long n_items, int D, int H, int W, int C) {
  return C == 32 && n_items < 2147483647LL && (long long)D * H * W * C < 2147483647LL;
}

}  // namespace trilinear
