// Border-mode trilinear sampling of an NDHWC feature volume for Hopper
// (sm_90a), bound through a plain C interface (ctypes; see
// ops/kernels/build.py and ops/kernels/trilinear.py).
//
// Replaces scripts/bench_pallas_gather.py::make_kernel(...).kernel, the
// Pallas core of the binned trilerp: per point, one (2, 4C) row pair of the
// (z, y)-neighbour-expanded slab times [wx0, wx1, u00..u11]. That is the
// forward of conditioned_nerf_gan_tpu/ops/grid_sample.py::_border_trilerp,
// whose anchors and weights this kernel computes itself:
//     f   = clamp(((coord + 1) * size - 1) / 2, 0, size - 1)  per axis
//     i   = min(floor(f), size - 2),  t = f - i                (align_corners False)
//     out = lerp_z(lerp_y(lerp_x(v[z][y][x])))                 _lerp_blocks' order
// volume (B, D, H, W, C) f32, coords (B, N, 3) f32 in the grid convention
// (x -> W, y -> H, z -> D) -> out (B, N, C) f32. Every product and sum is
// rounded as the torch version rounds it (no FMA contraction), so the two
// agree to the bit.
//
// What bounds it: 8 corner rows of C fp32 per point (1 KB at C = 32) read
// against 12 bytes in and 4C out, so it is a gather, bound by L2 and the
// load units: no arithmetic to speak of. The plain torch version writes
// and reads 8 (B, N, C) corner tensors and the lerp temporaries in device
// memory.
//
// What the design does about it: the TPU kernel's 4x (z, y)-expanded slab
// was a workaround for the TPU's cost per discontiguous gather segment. Here
// one voxel's C channels are contiguous (128 bytes at C = 32), so each corner
// is one coalesced read and the volume is read as it is. One thread takes 4
// channels (a float4) of one point: C / 4 neighbouring lanes share a point,
// so a corner row is one 128-byte transaction, and a warp serves 32 / (C / 4)
// points (4 at C = 32). Each lane computes its point's anchor and weights
// (three coordinate loads, broadcast within the point's lanes). A 64³ x 32
// volume is 33.5 MB, inside the 50 MB L2, and the points of one batch
// element run together, so the corner reads hit L2 mostly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Axis {
  int i;    // anchor, in [0, size - 2]
  float t;  // fraction in [0, 1]
};

__device__ __forceinline__ Axis anchor(float coord, int size) {
  // ((coord + 1) * size - 1) / 2, clamped to [0, size - 1]
  float f = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(coord, 1.f), (float)size), 1.f), 0.5f);
  f = fminf(fmaxf(f, 0.f), (float)(size - 1));
  const int i = min((int)floorf(f), size - 2);
  return {i, __fsub_rn(f, (float)i)};
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  // a * (1 - t) + b * t, each operation rounded
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, t)), __fmul_rn(b, t));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  return make_float4(lerp(a.x, b.x, t), lerp(a.y, b.y, t), lerp(a.z, b.z, t),
                     lerp(a.w, b.w, t));
}

__global__ void __launch_bounds__(THREADS)
trilinear_fwd_kernel(const float* __restrict__ volume, const float* __restrict__ coords,
                     float* __restrict__ out, long long n_items, int N, int D, int H,
                     int W, int C) {
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (item >= n_items) return;
  const int quads = C / 4;
  const long long point = item / quads;  // b * N + n
  const int q = (int)(item % quads);
  const long long b = point / N;

  const float* xyz = coords + point * 3;
  const Axis ax = anchor(__ldg(xyz), W);
  const Axis ay = anchor(__ldg(xyz + 1), H);
  const Axis az = anchor(__ldg(xyz + 2), D);

  const long long sx = C, sy = (long long)W * C, sz = (long long)H * W * C;
  const float* v = volume + b * D * sz + az.i * sz + ay.i * sy + ax.i * sx + 4 * q;
  auto corner = [&](long long offset) {
    return __ldg(reinterpret_cast<const float4*>(v + offset));
  };
  // x first, for each (z, y) in the order z0y0, z0y1, z1y0, z1y1; then y; then z
  const float4 g00 = lerp4(corner(0), corner(sx), ax.t);
  const float4 g01 = lerp4(corner(sy), corner(sy + sx), ax.t);
  const float4 g10 = lerp4(corner(sz), corner(sz + sx), ax.t);
  const float4 g11 = lerp4(corner(sz + sy), corner(sz + sy + sx), ax.t);
  const float4 gz0 = lerp4(g00, g01, ay.t);
  const float4 gz1 = lerp4(g10, g11, ay.t);
  reinterpret_cast<float4*>(out + point * C)[q] = lerp4(gz0, gz1, az.t);
}

}  // namespace

// volume (B, D, H, W, C), coords (B, N, 3), out (B, N, C), all fp32,
// contiguous, 16-byte aligned; C % 4 == 0 and every side >= 2. Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int trilinear_fwd(const float* volume, const float* coords, float* out, int B,
                             int N, int D, int H, int W, int C, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || C % 4 || D < 2 || H < 2 || W < 2)
    return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)B * N * (C / 4);
  const long long blocks = (n_items + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  trilinear_fwd_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      volume, coords, out, n_items, N, D, H, W, C);
  return (int)cudaGetLastError();
}
