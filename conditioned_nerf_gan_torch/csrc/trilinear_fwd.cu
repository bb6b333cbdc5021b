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
//     i   = max(min(floor(f), size - 2), 0),  t = f - i       (align_corners False)
//     out = lerp_z(lerp_y(lerp_x(v[z][y][x])))                 _lerp_blocks' order
// volume (B, D, H, W, C) f32, coords (B, N, 3) f32 in the grid convention
// (x -> W, y -> H, z -> D) -> out (B, N, C) f32. Every product and sum is
// rounded as the torch version rounds it (no FMA contraction), so the two
// agree to the bit.
//
// What bounds it: 8 corner rows of C fp32 per point (1 KB at C = 32) read
// against 12 bytes in and 4C out, so it is a gather: the compulsory bytes
// are the coordinates, the output and the corner rows the points touch, each
// once. Read per point, the corner rows are ~7x the rest, at the rate of L2
// (a 64^3 x 32 volume is 33.5 MB, inside the 50 MB L2), not of HBM.
//
// What the design does about it: the TPU kernel's 4x (z, y)-expanded slab
// was a workaround for the TPU's cost per discontiguous gather segment. Here
// one voxel's C channels are contiguous, so each corner is one coalesced
// read and the volume is read as it is (trilinear_common.cuh: 4 channels a
// lane, one small CTA per 32 points). At the main path's sizes a launch is a
// few dependent chains of loads a thread, so the design shortens the chain:
// at C = 32 the index math ahead of the first load is shifts and one 32-bit
// division instead of two 64-bit divisions (the generic path, the first
// design, is kept for other widths and volumes past 2^31 floats). Orders that read
// the corners neighbouring rays share together (sample-major tiles of rays,
// each SM walking contiguous ranges) were measured and were slower.

#include "trilinear_common.cuh"

namespace {

using namespace trilinear;

template <bool FAST>
__global__ void __launch_bounds__(THREADS)
trilinear_fwd_kernel(const float* __restrict__ volume, const float* __restrict__ coords,
                     float* __restrict__ out, long long n_items, int N, int D, int H, int W,
                     int C) {
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (item >= n_items) return;
  const Sample s = sample<FAST>(coords, item, N, D, H, W, C);
  const Corners c = gather(volume, s);
  // x first, for each (z, y) in the order z0y0, z0y1, z1y0, z1y1; then y; then z
  const float4 g00 = lerp4(c.lo[0], c.hi[0], s.ax.t);
  const float4 g01 = lerp4(c.lo[1], c.hi[1], s.ax.t);
  const float4 g10 = lerp4(c.lo[2], c.hi[2], s.ax.t);
  const float4 g11 = lerp4(c.lo[3], c.hi[3], s.ax.t);
  const float4 gz0 = lerp4(g00, g01, s.ay.t);
  const float4 gz1 = lerp4(g10, g11, s.ay.t);
  reinterpret_cast<float4*>(out + s.point * C)[s.q] = lerp4(gz0, gz1, s.az.t);
}

}  // namespace

// volume (B, D, H, W, C), coords (B, N, 3), out (B, N, C), all fp32,
// contiguous, 16-byte aligned; C % 4 == 0 and every side >= 1 (a side of 1
// clamps both corners onto it). Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int trilinear_fwd(const float* volume, const float* coords, float* out, int B,
                             int N, int D, int H, int W, int C, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || C % 4 || D < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)B * N * (C / 4);
  const long long blocks = (n_items + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast_path(n_items, D, H, W, C))
    trilinear_fwd_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(volume, coords, out, n_items,
                                                                   N, D, H, W, C);
  else
    trilinear_fwd_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(volume, coords, out, n_items,
                                                                    N, D, H, W, C);
  return (int)cudaGetLastError();
}
