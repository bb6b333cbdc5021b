// The VJP of border-mode trilinear sampling for Hopper (sm_90a), bound
// through a plain C interface (ctypes; see ops/kernels/trilinear.py).
//
// Counterpart of the XLA custom VJP of
// conditioned_nerf_gan_tpu/ops/grid_sample.py::_border_trilerp
// (`_expanded_bwd`), which replaces no Pallas kernel: the TPU has no atomic
// scatter, so the JAX package forms dV = P^T Q as one-hot matmuls in bf16.
// Here dV is the scatter itself. Per point, with the anchors and fractions
// recomputed exactly as the forward computes them (trilinear_common.cuh):
//   dV   the 8 corner rows of g weighted as the VJP of the forward's lerp
//        tree, ((g (1 - tz)) (1 - ty)) (1 - tx) for corner (z0, y0, x0) and
//        likewise, each product rounded as torch autograd of
//        border_trilerp_reference rounds it, added into a zeroed dV;
//   dcoords (only when asked) the JAX cotangents of the fractions from the
//        re-gathered corners, d_tx = sum_c g sum_k (x1_k - x0_k) u_k and the
//        y and z ones from the x-lerps, passed where the unclamped position
//        lies in [0, size - 1] and scaled by size / 2.
//
// What bounds it: dV is as large as the volume (403 MB at 12 x 64^3 x 32),
// and must be zeroed and written whatever the points: that and the
// coordinates and cotangent read once are the compulsory bytes (plus the
// volume read once for dcoords). The scatter itself is 8 float4 reductions
// of 16 bytes per lane and point, done in L2.
//
// What the design does about it: fp32 float4 atomics (`red.global.add` on
// 16 bytes, sm_90) into dV, 4 channels a lane and the index paths as in the
// forward (trilinear_common.cuh). A corner whose weight is exactly zero is
// skipped (its
// contribution is a zero): every point outside the cube clamps to a
// fraction of 0 or 1 on that axis, so at least half its corners carry no
// weight, and those are the rows where points crowd (the border). The order
// of the atomic sums changes from launch to launch, so dV is repeatable only
// to fp32 summation order (the JAX package's dV is bf16 products summed in
// fp32 by the MXU); dcoords has no atomics and is bitwise repeatable.

#include "trilinear_common.cuh"

namespace {

using namespace trilinear;

__device__ __forceinline__ void add4(float* dst, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  atomicAdd(reinterpret_cast<float4*>(dst), v);  // one 16-byte red.global.add
#else
  atomicAdd(dst, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
#endif
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// dvol (null: not asked) and dcoords (null: not asked). Every lane of a
// point runs to the end (they reduce dcoords with shuffles); lanes past the
// last item do nothing else.
template <bool FAST>
__global__ void __launch_bounds__(THREADS)
trilinear_bwd_kernel(const float* __restrict__ volume, const float* __restrict__ coords,
                     const float* __restrict__ g, float* __restrict__ dvol,
                     float* __restrict__ dcoords, long long n_items, int N, int D, int H, int W,
                     int C) {
  const int quads = C / 4;
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = item < n_items;
  float dtx = 0.f, dty = 0.f, dtz = 0.f;
  Sample s;
  if (valid) {
    s = sample<FAST>(coords, item, N, D, H, W, C);
    const float4 gv = __ldg(reinterpret_cast<const float4*>(g + s.point * C) + s.q);
    if (dvol != nullptr) {
      const float wz[2] = {__fsub_rn(1.f, s.az.t), s.az.t};
      const float wy[2] = {__fsub_rn(1.f, s.ay.t), s.ay.t};
      const float wx[2] = {__fsub_rn(1.f, s.ax.t), s.ax.t};
      float* v = dvol + s.base;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        if (wz[dz] == 0.f) continue;
        const float4 gz = scale4(gv, wz[dz]);
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          if (wy[dy] == 0.f) continue;
          const float4 gzy = scale4(gz, wy[dy]);
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            if (wx[dx] == 0.f) continue;
            add4(v + dz * s.sz + dy * s.sy + dx * s.sx, scale4(gzy, wx[dx]));
          }
        }
      }
    }
    if (dcoords != nullptr) {
      const Corners c = gather(volume, s);
      const float tx = s.ax.t, ty = s.ay.t, tz = s.az.t;
      const float uy0 = 1.f - ty, uz0 = 1.f - tz;
      const float u[4] = {uy0 * uz0, ty * uz0, uy0 * tz, ty * tz};
      float4 gx[4];
      float4 ex = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 d = sub4(c.hi[k], c.lo[k]);
        ex = make_float4(ex.x + d.x * u[k], ex.y + d.y * u[k], ex.z + d.z * u[k],
                         ex.w + d.w * u[k]);
        gx[k] = lerp4(c.lo[k], c.hi[k], tx);
      }
      const float4 ey = make_float4(
          uz0 * (gx[1].x - gx[0].x) + tz * (gx[3].x - gx[2].x),
          uz0 * (gx[1].y - gx[0].y) + tz * (gx[3].y - gx[2].y),
          uz0 * (gx[1].z - gx[0].z) + tz * (gx[3].z - gx[2].z),
          uz0 * (gx[1].w - gx[0].w) + tz * (gx[3].w - gx[2].w));
      const float4 ez = make_float4(
          (gx[2].x * uy0 + gx[3].x * ty) - (gx[0].x * uy0 + gx[1].x * ty),
          (gx[2].y * uy0 + gx[3].y * ty) - (gx[0].y * uy0 + gx[1].y * ty),
          (gx[2].z * uy0 + gx[3].z * ty) - (gx[0].z * uy0 + gx[1].z * ty),
          (gx[2].w * uy0 + gx[3].w * ty) - (gx[0].w * uy0 + gx[1].w * ty));
      dtx = dot4(ex, gv);
      dty = dot4(ey, gv);
      dtz = dot4(ez, gv);
    }
  }
  if (dcoords != nullptr) {
    // the point's quads are `quads` neighbouring lanes (a power of two <= 32)
    for (int m = 1; m < quads; m <<= 1) {
      dtx += __shfl_xor_sync(0xffffffffu, dtx, m);
      dty += __shfl_xor_sync(0xffffffffu, dty, m);
      dtz += __shfl_xor_sync(0xffffffffu, dtz, m);
    }
    if (valid && s.q == 0) {
      float* o = dcoords + s.point * 3;
      o[0] = s.ax.inside ? dtx * (0.5f * W) : 0.f;
      o[1] = s.ay.inside ? dty * (0.5f * H) : 0.f;
      o[2] = s.az.inside ? dtz * (0.5f * D) : 0.f;
    }
  }
}

}  // namespace

// volume (B, D, H, W, C) (read only for dcoords), coords (B, N, 3), g (B, N,
// C), all fp32, contiguous, 16-byte aligned; C % 4 == 0, every side >= 2.
// dvol (B, D, H, W, C) fp32, zeroed by the caller, or null; dcoords (B, N, 3)
// fp32 or null (then C / 4 must be a power of two <= 32). Launches on
// `stream`; returns cudaGetLastError().
extern "C" int trilinear_bwd(const float* volume, const float* coords, const float* g,
                             float* dvol, float* dcoords, int B, int N, int D, int H, int W,
                             int C, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || C % 4 || D < 2 || H < 2 || W < 2)
    return (int)cudaErrorInvalidValue;
  const int quads = C / 4;
  if (dcoords != nullptr && (quads > 32 || (quads & (quads - 1))))
    return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)B * N * quads;
  const long long blocks = (n_items + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast_path(n_items, D, H, W, C))
    trilinear_bwd_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        volume, coords, g, dvol, dcoords, n_items, N, D, H, W, C);
  else
    trilinear_bwd_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        volume, coords, g, dvol, dcoords, n_items, N, D, H, W, C);
  return (int)cudaGetLastError();
}
