// FiLM-SIREN kernel study for Hopper (sm_90a): the ablation kernels of the
// FiLM-SIREN study, bound through a plain C interface (ctypes; see
// ops/kernels/build.py and ops/kernels/film_study.py).
//
// Replaces the Pallas study kernels of scripts/bench_film_kernel.py:
//   K3     forward_v3 -> _kernel_v3: point-major (activations T x H);
//   K4 v4  forward_v4 -> _kernel_v4: feature-major (activations H x T, the
//          folded weights the left operand of every product), one chain;
//   K4 v5  forward_v4(mode="interleave") -> _kernel_v5: v4 with sin7 and two
//          half-tile chains whose products and sin epilogues interleave.
// Each computes, on freq-folded weights (the fold stays in torch), with bf16
// operands and fp32 sums:
//     h_0 = act0(bf16(x) . W0f[b] + c[b,0])                 x (B, N, 3)
//     h_l = act(bf16(h_{l-1}) . Wsf[b,l-1] + c[b,l])        l = 1..L-1
//           (no product, act(h_{l-1} + c[b,l]) on the fp32 h, in `nodot`)
//     out = bf16(h_{L-1}) . bf16(Wf) + bf                   (B, N, 4) f32
// with the activations of each mode (template parameters ACT0, ACT, DOT):
//   K3 single: fast_sin, fast_sin      K4 full: fast_sin, fast_sin
//   K3 nosin:  fast_sin, 0.9 v         K4 nosin: 0.9 v, 0.9 v
//   K3 nodot:  fast_sin, fast_sin, no product     K4 nodot: the same
//   K3 jnpsin: sin, sin (accurate)     K4 sin7: sin7, sin7 (K1's function)
//   K4 v5: sin7, sin7
// fast_sin is ops/fastmath.py's polynomial, sin7 K1's; both take the trunk's
// range reduction (round half to even, as torch.round). The accurate sin is
// `sin_accurate`, within 1.5 ulp of sin (torch.sin is sinf, within 1).
//
// What bounds it: per point 0.39 MFLOP of products at L = 4 (bf16 tensor
// cores, 0.63 ms at 2 x 786,432 points) and 1,024 activations on the FP32
// pipes (0.48-0.96 ms by the mode's instructions) against 28 bytes of
// device I/O: compute-bound, like K1. The ablations split that time: `nosin`
// is the products with a 2-operation epilogue, `nodot` the activations alone
// (bound by the FP32 pipes), v4 against v5 what overlapping the epilogue with
// the products is worth.
//
// What the design does about it: all three kernels run on the trunk of
// film_siren_trunk.cuh, K1's and K2's: the products on wgmma, the trunk
// weights streamed by TMA (64-K-row x 256-unit chunks in the 128-byte
// swizzle) into an mbarrier ring by a producer warpgroup (`setmaxnreg`: 24
// registers for it, 240 for the two consumer warpgroups), a persistent grid
// of one CTA per SM walking (batch element, tile) items, no __syncthreads()
// after set-up. The chunk's bytes serve both layouts: as wgmma's B (units x
// K, K-major) point-major, and, a 64-unit block at chunk + 8 KB x block, as
// its K-major A feature-major. Per layout and tile (points per CTA, T):
//   * K3 at T 128 is K1's arrangement: each consumer warpgroup owns 64 points
//     (wgmma's M) and all 256 units (m64n256k16), A = h in registers (a
//     thread's accumulator fragment, after its epilogue and a pack to bf16
//     pairs, is its next A fragment); the two warpgroups take turns at the
//     products (the trunk's hand-over mbarriers), so one's epilogue overlaps
//     the other's products (ping-pong).
//   * K3 at T 64: both warpgroups split the units of one 64-point tile
//     (m64n128k16, B = their half of the chunk), so h crosses them: each
//     epilogue writes its half of bf16 h into a shared buffer (points x K,
//     K-major, 128-byte swizzle, stmatrix), read as A through a descriptor.
//     Cooperative: both wait on one layer mbarrier (8 warp arrivals) before
//     either starts the next layer; the epilogue does not overlap products.
//   * K4 v4 (T 32, 64, 128) is cooperative too: each warpgroup owns two
//     64-unit blocks of the tile's 256 units (two m64nTk16 a k-step, A the
//     chunk's blocks, B = h, points x K in the shared buffer). The
//     accumulator's rows are units, so the bias runs along rows and the
//     epilogue writes h transposed (stmatrix .trans) into the buffer.
//   * K4 v5 (T 64, 128) is ping-pong: each warpgroup owns half the tile's
//     points (N = T / 2) and all 256 units (four m64n(T/2)k16 a k-step) in
//     its own buffer, and the two take turns at the products as K3 at 128.
//   * The h buffers are double-buffered (the epilogue writes the one the
//     products just stopped reading), each write fenced to the async proxy
//     and then published by the layer mbarrier, so one barrier a layer
//     suffices; buffers and ring share the 227 KB (ring depth 3 where the
//     buffers take 128 KB, else 4).
//   * One loop holds every layer's epilogue and the next layer's products,
//     once each (unrolled, K1's layers outgrew the instruction cache).
//   * Layer 0 (K = 3) runs on the FMA units; the 256 -> 4 head on the FMA
//     units too: from registers with quad shuffles in K3 at 128 (K1's), from
//     the staged h elsewhere, so no sum crosses the warpgroups in registers.
//   * `nodot` issues no trunk product and loads no trunk weight: the producer
//     stays idle past set-up, and the consumers run the activations on the
//     fp32 h in registers, writing bf16 h once, for the head.
//   * Ragged N: points past N are zero on load and masked on store.
// Registers bound the tile: every instance holds T fp32 accumulators a thread
// (128 at T 128); 256 points a CTA would need 256, past the 240 a consumer
// gets, and their double-buffered h 256 KB of shared memory.

// The library is compiled as 8 translation units in parallel (ptxas takes one
// kernel at a time), each with -DNVCC_PART=p (ops/kernels/build.py reads the
// next line): part p instantiates its own two instances, part 0 also holds
// the C entry, which asks each part in turn.
// nvcc parts: 8
#ifndef NVCC_PART
#error "compile with -DNVCC_PART=0..7, one translation unit a part (ops/kernels/build.py)"
#endif

#include "film_siren_trunk.cuh"

namespace {

using namespace film_trunk;

constexpr int DIN = 3;  // xyz points
// ops/fastmath.py fast_sin
constexpr float F1 = 9.9999970703e-01f;
constexpr float F3 = -1.6666577215e-01f;
constexpr float F5 = 8.3325581177e-03f;
constexpr float F7 = -1.9812575520e-04f;
constexpr float F9 = 2.7040512127e-06f;
constexpr float F11 = -2.0534244526e-08f;

enum Act { kFastSin = 0, kSin7 = 1, kAffine = 2, kSinf = 3 };
enum Layout { kPointMajor = 0, kFeatureMajor = 1, kInterleave = 2 };
constexpr int kNoInstance = -1;  // no instance of a combination (the entry's return)

// `jnpsin`'s accurate sin, within 1.5 ulp of sin (as torch.sin, which is
// sinf): x - q pi/2 in three FMA steps (Cody-Waite; exact enough for |x| up to
// kSinLimit), then sin or cos of the remainder in [-pi/4, pi/4] by the
// quadrant q. sinf itself inlines a Payne-Hanek reduction for larger
// arguments: 128 copies of it in one epilogue took ptxas past 7 minutes, so
// that path runs once, in a loop (activate_all).
constexpr float kSinLimit = 105615.0f;

__device__ __forceinline__ float sin_accurate(float x) {
  constexpr float SHIFT = 12582912.0f;  // 1.5 x 2^23: q in the low mantissa bits
  const float t = __fmaf_rn(x, 0.636619772f, SHIFT);
  const int q = __float_as_int(t);
  const float qf = __fsub_rn(t, SHIFT);
  float r = __fmaf_rn(-qf, 1.57079601e+00f, x);
  r = __fmaf_rn(-qf, 3.13916473e-07f, r);
  r = __fmaf_rn(-qf, 5.39030253e-15f, r);
  const float s = r * r;
  float sn = __fmaf_rn(__fmaf_rn(__fmaf_rn(2.86567956e-6f, s, -1.98559923e-4f), s,
                                 8.33338592e-3f), s, -1.66666672e-1f);
  sn = __fmaf_rn(sn * s, r, r);
  const float cs = __fmaf_rn(__fmaf_rn(__fmaf_rn(__fmaf_rn(2.44677067e-5f, s, -1.38877297e-3f),
                                                 s, 4.16666567e-2f), s, -0.5f), s, 1.0f);
  const float v = (q & 1) ? cs : sn;
  return (q & 2) ? -v : v;
}

template <int A>
__device__ __forceinline__ float act(float v) {
  if constexpr (A == kFastSin) {
    const float r = reduce_range(v);
    const float r2 = r * r;
    return r * (F1 + r2 * (F3 + r2 * (F5 + r2 * (F7 + r2 * (F9 + r2 * F11)))));
  } else if constexpr (A == kSin7) {
    return sin7(v);
  } else if constexpr (A == kAffine) {
    return v * 0.9f;
  } else {
    return sin_accurate(v);
  }
}

// acc = act<A>(acc), elementwise; at kSinf, sinf on the rare thread with an
// argument past kSinLimit, in a loop (one inlined copy)
template <int A, int NACC>
__device__ __forceinline__ void activate_all(float (&acc)[NACC]) {
  if constexpr (A == kSinf) {
    float big = 0.f;
#pragma unroll
    for (int i = 0; i < NACC; ++i) big = fmaxf(big, fabsf(acc[i]));
    if (!(big <= kSinLimit)) {  // an infinity or NaN too
      float tmp[NACC];
#pragma unroll
      for (int i = 0; i < NACC; ++i) tmp[i] = acc[i];
#pragma unroll 1
      for (int i = 0; i < NACC; ++i) tmp[i] = sinf(tmp[i]);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] = tmp[i];
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = act<A>(acc[i]);
}

// The arrangement of one (layout, T): a consumer warpgroup's accumulators are
// kBlocks blocks of one m64nN wgmma each (kN / 2 fp32 a thread each).
template <int LAYOUT, int T>
struct Shape {
  static constexpr bool kPM = LAYOUT == kPointMajor;
  static_assert(kPM ? (T == 64 || T == 128)
                    : LAYOUT == kFeatureMajor ? (T == 32 || T == 64 || T == 128)
                                              : (T == 64 || T == 128),
                "point-major T is 64 or 128, v4's 32, 64 or 128, v5's 64 or 128");
  static constexpr bool kRegA = kPM && T == 128;  // K1's arrangement
  static constexpr bool kCoop = LAYOUT == kFeatureMajor || (kPM && T == 64);
  static constexpr int kBlocks = kPM ? 1 : (kCoop ? 2 : 4);
  static constexpr int kN = kPM ? (kCoop ? 128 : 256) : (kCoop ? T : T / 2);
  static constexpr int kBlockAcc = kN / 2;
  static constexpr int kAcc = kBlocks * kBlockAcc;
  // points of one h buffer; buffers: two (cooperative) or two a warpgroup
  static constexpr int kRows = kPM ? 64 : (kCoop ? T : T / 2);
  static constexpr int kBufBytes = kRows * H * 2;
  static constexpr int kBuffers = kRegA ? 0 : (kCoop ? 2 : 4);
  static constexpr int kNS = kBuffers * kBufBytes > 65536 ? 3 : 4;
  static constexpr int kHeadSplit = (kCoop ? 256 : 128) / kRows;  // head threads a point
  static constexpr size_t kSmem = ring_bytes(kNS) + 16 + 1024 + (size_t)kBuffers * kBufBytes;
  static_assert(kN % 16 == 0 && kAcc <= 128, "accumulators");
  static_assert(kSmem <= 232448, "shared memory");
};

// d (the 64 x N block at d, N / 2 fp32 a thread) (+)= a . b, both in shared
// memory, K-major
template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                       int scale_d) {
  if constexpr (N == 32) {
    wgmma_m64n32k16_ss(*reinterpret_cast<float(*)[16]>(d), desc_a, desc_b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16_ss(*reinterpret_cast<float(*)[32]>(d), desc_a, desc_b, scale_d);
  } else {
    static_assert(N == 128, "N is 32, 64 or 128");
    wgmma_m64n128k16_ss(*reinterpret_cast<float(*)[64]>(d), desc_a, desc_b, scale_d);
  }
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

// 16-byte chunk c (units 8c .. 8c+7) of point row p of an h buffer of `rows`
// points: 4 blocks of rows x 64 units, each K-major in the 128-byte swizzle
__device__ __forceinline__ uint32_t h_at(uint32_t buf, int rows, int p, int c) {
  return buf + (c >> 3) * rows * 128 + p * 128 + (((c & 7) ^ (p & 7)) << 4);
}

// The writers of an h buffer are done and visible to wgmma: each warp fences
// its writes to the async proxy and arrives; all wait.
__device__ __forceinline__ void layer_sync(uint32_t bar, uint32_t& phase) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
  mbar_wait(bar, phase);
  phase ^= 1u;
}

// K3 at T 64: A = h (64 points x 256 K in the buffer), B = this warpgroup's
// 128 units of the chunk (rows 128 wg .. 128 wg + 127, 16 KB in)
struct PointMajorIssue {
  uint32_t h;
  int wg;
  template <int NACC>
  __device__ __forceinline__ void operator()(float (&d)[NACC], int s, uint64_t desc_w,
                                             int scale_d) const {
    const uint64_t desc_h = sw128_desc(h + (s >> 2) * 8192 + (s & 3) * 32);
    mma_ss<128>(d, desc_h, desc_w + (uint64_t)(wg * (16384 >> 4)), scale_d);
  }
};

// K4: A = 64-unit block `unit0 + m` of the chunk (8 KB each), B = h (ROWS
// points x 256 K in the buffer); one wgmma per block of the warpgroup
template <int BLOCKS, int N, int ROWS>
struct FeatureMajorIssue {
  uint32_t h;
  int unit0;
  template <int NACC>
  __device__ __forceinline__ void operator()(float (&d)[NACC], int s, uint64_t desc_w,
                                             int scale_d) const {
    const uint64_t desc_h = sw128_desc(h + (s >> 2) * ROWS * 128 + (s & 3) * 32);
#pragma unroll
    for (int m = 0; m < BLOCKS; ++m)
      mma_ss<N>(d + m * (N / 2), desc_w + (uint64_t)((unit0 + m) * (8192 >> 4)), desc_h,
                scale_d);
  }
};

// pts (B, N, 3) f32; w0f (B, 3, H) bf16; c (B, L, H) f32 (c_0 then c_1..);
// wmap reads Wsf^T as ((B (L-1) H) x H) (the trunk's K-major weights); wf
// (H, 4) bf16; bf (4) f32; out (B, N, 4) f32. `tiles` = ceil(N / T).
template <int LAYOUT, int T, int ACT0, int ACT, bool DOT>
__global__ void __launch_bounds__(THREADS, 1)
film_study_kernel(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ pts,
                  const __nv_bfloat16* __restrict__ w0f, const float* __restrict__ c,
                  const __nv_bfloat16* __restrict__ wf, const float* __restrict__ bf,
                  float* __restrict__ out, int B, int N, int L, int tiles) {
  using S = Shape<LAYOUT, T>;
  extern __shared__ unsigned char smem[];
  Ring<S::kNS> ring = ring_setup<S::kNS>(smem);
  const uint32_t bars = ring.turn + 16;  // the layer barriers: one, or one a warpgroup
  const uint32_t bufs = (bars + 16 + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    mbar_init(bars, S::kCoop ? 8 : 4);  // one arrive per warp that writes the buffer
    mbar_init(bars + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int items = B * tiles;

  if ((threadIdx.x >> 7) == PRODUCER_WG) {
    setmaxnreg_dec<24>();
    if constexpr (DOT) {
      if (threadIdx.x == PRODUCER_WG * 128) {
        const int chunks = (L - 1) * CHUNKS_PER_LAYER;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
          const int b = item / tiles;
          for (int q = 0; q < chunks; ++q)
            produce(ring, &wmap, (q % CHUNKS_PER_LAYER) * KC,
                    (b * (L - 1) + q / CHUNKS_PER_LAYER) * H);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int r0 = 16 * warp + (lane >> 2);  // accumulator row of elements 0, 1 (+8: 2, 3)
  // point-major: this thread's first unit column; feature-major: the
  // warpgroup's first 64-unit block
  const int u0 = S::kCoop ? 128 * wg : 0;
  const int unit0 = S::kCoop ? S::kBlocks * wg : 0;
  const uint32_t bar = bars + (S::kCoop ? 0u : 8u * wg);
  uint32_t bar_phase = 0;
  int next_buf = 0;  // double buffering, run on across items
  auto buffer = [&](int i) {
    return bufs + (uint32_t)((S::kCoop ? i : 2 * wg + i) * S::kBufBytes);
  };

  float acc[S::kAcc];
#pragma unroll
  for (int i = 0; i < S::kAcc; ++i) acc[i] = 0.f;
  uint32_t hreg[S::kRegA ? HREGS : 1];

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / tiles;
    // the first point of this warpgroup's h (point-major at T 128 and v5: its
    // own points; otherwise the tile's)
    const int p0 = (item % tiles) * T + (S::kCoop ? 0 : wg * (S::kPM ? 64 : T / 2));
    const float* cb = c + (size_t)b * L * H;
    const __nv_bfloat16* w0b = w0f + (size_t)b * DIN * H;
    auto x_of = [&](int p, float (&x)[DIN]) {
#pragma unroll
      for (int i = 0; i < DIN; ++i)
        x[i] = p < N ? bf16_round(pts[((size_t)b * N + p) * DIN + i]) : 0.f;
    };

    // layer 0's products on the FMA units: acc = bf16(x) . W0f
    if constexpr (S::kPM) {
      float xa[DIN], xb[DIN];
      x_of(p0 + r0, xa);
      x_of(p0 + r0 + 8, xb);
#pragma unroll
      for (int j = 0; j < S::kN / 8; ++j) {
        const int n = u0 + 8 * j + 2 * q;
        const float2 w_0 = ldg_bf16x2(w0b + n);
        const float2 w_1 = ldg_bf16x2(w0b + H + n);
        const float2 w_2 = ldg_bf16x2(w0b + 2 * H + n);
        acc[4 * j] = xa[0] * w_0.x + xa[1] * w_1.x + xa[2] * w_2.x;
        acc[4 * j + 1] = xa[0] * w_0.y + xa[1] * w_1.y + xa[2] * w_2.y;
        acc[4 * j + 2] = xb[0] * w_0.x + xb[1] * w_1.x + xb[2] * w_2.x;
        acc[4 * j + 3] = xb[0] * w_0.y + xb[1] * w_1.y + xb[2] * w_2.y;
      }
    } else {
      float w[S::kBlocks][2][DIN];  // W0f of units 64 (unit0 + m) + r0 (+8)
#pragma unroll
      for (int m = 0; m < S::kBlocks; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < DIN; ++i)
            w[m][e][i] = __bfloat162float(w0b[i * H + 64 * (unit0 + m) + r0 + 8 * e]);
#pragma unroll
      for (int j = 0; j < S::kN / 8; ++j) {
        float xa[DIN], xb[DIN];  // points 8j + 2q, +1
        x_of(p0 + 8 * j + 2 * q, xa);
        x_of(p0 + 8 * j + 2 * q + 1, xb);
#pragma unroll
        for (int m = 0; m < S::kBlocks; ++m) {
          float* d = acc + m * S::kBlockAcc + 4 * j;
          d[0] = xa[0] * w[m][0][0] + xa[1] * w[m][0][1] + xa[2] * w[m][0][2];
          d[1] = xb[0] * w[m][0][0] + xb[1] * w[m][0][1] + xb[2] * w[m][0][2];
          d[2] = xa[0] * w[m][1][0] + xa[1] * w[m][1][1] + xa[2] * w[m][1][2];
          d[3] = xb[0] * w[m][1][0] + xb[1] * w[m][1][1] + xb[2] * w[m][1][2];
        }
      }
    }

    // acc = act(acc + c_l): the bias along the columns (point-major) or rows
    auto activate_layer = [&](int l) {
      const float* cl = cb + l * H;
      if constexpr (S::kPM) {
#pragma unroll
        for (int j = 0; j < S::kN / 8; ++j) {
          const float2 cc = __ldg(reinterpret_cast<const float2*>(cl + u0 + 8 * j + 2 * q));
          acc[4 * j] += cc.x;
          acc[4 * j + 1] += cc.y;
          acc[4 * j + 2] += cc.x;
          acc[4 * j + 3] += cc.y;
        }
      } else {
#pragma unroll
        for (int m = 0; m < S::kBlocks; ++m) {
          const float lo = __ldg(cl + 64 * (unit0 + m) + r0);
          const float hi = __ldg(cl + 64 * (unit0 + m) + r0 + 8);
#pragma unroll
          for (int j = 0; j < S::kN / 8; ++j) {
            float* d = acc + m * S::kBlockAcc + 4 * j;
            d[0] += lo;
            d[1] += lo;
            d[2] += hi;
            d[3] += hi;
          }
        }
      }
      if (ACT0 != ACT && l == 0)
        activate_all<ACT0>(acc);
      else
        activate_all<ACT>(acc);
    };
    // bf16 h out of acc: into the A registers, or into the next buffer
    // (stmatrix: point-major rows are points; feature-major transposed)
    int cur = 0;
    auto write_h = [&]() {
      if constexpr (S::kRegA) {
#pragma unroll
        for (int j = 0; j < S::kN / 8; ++j) {
          hreg[2 * j] = pack_bf16(acc[4 * j], acc[4 * j + 1]);
          hreg[2 * j + 1] = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
        }
      } else {
        cur = next_buf;
        next_buf ^= 1;
        const uint32_t buf = buffer(cur);
        const int m8 = lane >> 3;
#pragma unroll
        for (int m = 0; m < S::kBlocks; ++m) {
#pragma unroll
          for (int j = 0; j < S::kN / 8; j += 2) {
            const float* d = acc + m * S::kBlockAcc + 4 * j;
            const uint32_t v0 = pack_bf16(d[0], d[1]), v1 = pack_bf16(d[2], d[3]);
            const uint32_t v2 = pack_bf16(d[4], d[5]), v3 = pack_bf16(d[6], d[7]);
            if constexpr (S::kPM) {
              const int p = 16 * warp + (lane & 7) + 8 * (m8 & 1);
              stmatrix_x4(h_at(buf, S::kRows, p, u0 / 8 + j + (m8 >> 1)), v0, v1, v2, v3);
            } else {
              const int p = 8 * (j + (m8 >> 1)) + (lane & 7);
              const int chunk = 8 * (unit0 + m) + 2 * warp + (m8 & 1);
              stmatrix_x4_trans(h_at(buf, S::kRows, p, chunk), v0, v1, v2, v3);
            }
          }
        }
        layer_sync(bar, bar_phase);
      }
    };

    // every layer's epilogue, then the next layer's products: one copy of
    // each in the code
#pragma unroll 1
    for (int l = 0;; ++l) {
      activate_layer(l);
      if (!DOT && l < L - 1) continue;  // nodot: the fp32 h stays in acc
      write_h();
      if (l == L - 1) break;
      if constexpr (DOT) {
        if constexpr (S::kRegA) {
          layer_mma<CHUNKS_PER_LAYER, CHUNKS_PER_LAYER>(ring, wg, acc, hreg);
        } else if constexpr (S::kPM) {
          layer_products<CHUNKS_PER_LAYER, CHUNKS_PER_LAYER, false>(
              ring, wg, acc, PointMajorIssue{buffer(cur), wg});
        } else {
          // cooperative: both warpgroups at once; ping-pong: in turns
          layer_products<CHUNKS_PER_LAYER, CHUNKS_PER_LAYER, !S::kCoop>(
              ring, wg, acc, FeatureMajorIssue<S::kBlocks, S::kN, S::kRows>{buffer(cur), unit0});
        }
      }
    }

    // the head on the FMA units: out = bf16(h) . Wf + bf
    if constexpr (S::kRegA) {
      // K1's: each thread's last h fragment, summed across the quad
      const int pa = p0 + r0, pb = pa + 8;
      float oa[COUT] = {0.f, 0.f, 0.f, 0.f}, ob[COUT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < S::kN / 8; ++j) {
        const int n = 8 * j + 2 * q;
        const float2 ha = unpack_bf16(hreg[2 * j]), hb = unpack_bf16(hreg[2 * j + 1]);
        const float2 w01 = ldg_bf16x2(wf + n * COUT), w23 = ldg_bf16x2(wf + n * COUT + 2);
        const float2 v01 = ldg_bf16x2(wf + (n + 1) * COUT);
        const float2 v23 = ldg_bf16x2(wf + (n + 1) * COUT + 2);
        oa[0] += ha.x * w01.x + ha.y * v01.x;
        oa[1] += ha.x * w01.y + ha.y * v01.y;
        oa[2] += ha.x * w23.x + ha.y * v23.x;
        oa[3] += ha.x * w23.y + ha.y * v23.y;
        ob[0] += hb.x * w01.x + hb.y * v01.x;
        ob[1] += hb.x * w01.y + hb.y * v01.y;
        ob[2] += hb.x * w23.x + hb.y * v23.x;
        ob[3] += hb.x * w23.y + hb.y * v23.y;
      }
#pragma unroll
      for (int o = 0; o < COUT; ++o) {
        oa[o] = quad_sum(oa[o]) + bf[o];
        ob[o] = quad_sum(ob[o]) + bf[o];
      }
      if (q == 0 && pa < N)
        *reinterpret_cast<float4*>(out + ((size_t)b * N + pa) * COUT) =
            make_float4(oa[0], oa[1], oa[2], oa[3]);
      if (q == 1 && pb < N)
        *reinterpret_cast<float4*>(out + ((size_t)b * N + pb) * COUT) =
            make_float4(ob[0], ob[1], ob[2], ob[3]);
    } else {
      // from the staged h: kHeadSplit neighbouring lanes a point, each a
      // strided share of its 32 unit chunks, summed by shuffles
      constexpr int SPLIT = S::kHeadSplit;
      const int t = S::kCoop ? threadIdx.x : threadIdx.x & 127;
      const int p = t / SPLIT, part = t % SPLIT;
      const unsigned char* hrow = smem + (buffer(cur) - smem_addr(smem));
      float o[COUT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int ch = part; ch < H / 8; ch += SPLIT) {
        const uint4 hv = *reinterpret_cast<const uint4*>(
            hrow + (h_at(0, S::kRows, p, ch)));
        const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
        const uint4* w8 = reinterpret_cast<const uint4*>(wf + ch * 8 * COUT);
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // units 8 ch + 2k, +1
          const uint4 w = __ldg(w8 + k);
          const float2 h2 = unpack_bf16(hw[k]);
          const float2 w01 = unpack_bf16(w.x), w23 = unpack_bf16(w.y);
          const float2 v01 = unpack_bf16(w.z), v23 = unpack_bf16(w.w);
          o[0] += h2.x * w01.x + h2.y * v01.x;
          o[1] += h2.x * w01.y + h2.y * v01.y;
          o[2] += h2.x * w23.x + h2.y * v23.x;
          o[3] += h2.x * w23.y + h2.y * v23.y;
        }
      }
#pragma unroll
      for (int s = 1; s < SPLIT; s <<= 1)
#pragma unroll
        for (int k = 0; k < COUT; ++k) o[k] += __shfl_xor_sync(0xffffffffu, o[k], s);
      const int pg = p0 + p;
      if (part == 0 && pg < N)
        *reinterpret_cast<float4*>(out + ((size_t)b * N + pg) * COUT) =
            make_float4(o[0] + bf[0], o[1] + bf[1], o[2] + bf[2], o[3] + bf[3]);
    }
  }
}

template <int LAYOUT, int T, int ACT0, int ACT, bool DOT>
int launch(const float* pts, const void* w0f, const float* c, const void* wst, const void* wf,
           const float* bf, float* out, int B, int N, int L, cudaStream_t stream) {
  using S = Shape<LAYOUT, T>;
  auto kernel = film_study_kernel<LAYOUT, T, ACT0, ACT, DOT>;
  CUtensorMap wmap;
  int err = weight_map(&wmap, wst, (uint64_t)B * (L - 1) * H, H);
  if (err) return err;
  const int tiles = (N + T - 1) / T;
  int grid = 0;
  err = persistent_grid(B * tiles, &grid);
  if (err) return err;
  cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  kernel<<<grid, THREADS, S::kSmem, stream>>>(
      wmap, pts, static_cast<const __nv_bfloat16*>(w0f), c,
      static_cast<const __nv_bfloat16*>(wf), bf, out, B, N, L, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

#define STUDY_PARAMS                                                                     \
  const float *pts, const void *w0f, const float *c, const void *wst, const void *wf,     \
      const float *bf, float *out, int layout, int act0, int act, int dot, int tile, int B, \
      int N, int L, cudaStream_t s
#define STUDY_CAT2(a, b) a##b
#define STUDY_CAT(a, b) STUDY_CAT2(a, b)
#define STUDY_PART_DECL(p) int film_study_part##p(STUDY_PARAMS);
STUDY_PART_DECL(0) STUDY_PART_DECL(1) STUDY_PART_DECL(2) STUDY_PART_DECL(3)
STUDY_PART_DECL(4) STUDY_PART_DECL(5) STUDY_PART_DECL(6) STUDY_PART_DECL(7)

// The instances of this translation unit (two a part, the heavy point-major
// ones at T 128 apart); kNoInstance for any other.
int STUDY_CAT(film_study_part, NVCC_PART)(STUDY_PARAMS) {
#define STUDY_CASE(LAYOUT, TT, A0, A, DOT)                                           \
  if (layout == LAYOUT && tile == TT && act0 == A0 && act == A && (dot != 0) == DOT) \
    return launch<LAYOUT, TT, A0, A, DOT>(pts, w0f, c, wst, wf, bf, out, B, N, L, s);
  // K3 (point-major): single, nosin, nodot, jnpsin; K4 v4 (feature-major,
  // cooperative): full, sin7, nosin, nodot; K4 v5 (feature-major, ping-pong)
#if NVCC_PART == 0
  STUDY_CASE(kPointMajor, 128, kFastSin, kFastSin, true)
  STUDY_CASE(kFeatureMajor, 32, kFastSin, kFastSin, true)
#elif NVCC_PART == 1
  STUDY_CASE(kPointMajor, 128, kFastSin, kAffine, true)
  STUDY_CASE(kFeatureMajor, 64, kFastSin, kFastSin, true)
#elif NVCC_PART == 2
  STUDY_CASE(kPointMajor, 128, kFastSin, kFastSin, false)
  STUDY_CASE(kFeatureMajor, 128, kFastSin, kFastSin, false)
#elif NVCC_PART == 3
  STUDY_CASE(kPointMajor, 128, kSinf, kSinf, true)
  STUDY_CASE(kPointMajor, 64, kFastSin, kFastSin, false)
#elif NVCC_PART == 4
  STUDY_CASE(kPointMajor, 64, kFastSin, kFastSin, true)
  STUDY_CASE(kFeatureMajor, 128, kFastSin, kFastSin, true)
#elif NVCC_PART == 5
  STUDY_CASE(kPointMajor, 64, kFastSin, kAffine, true)
  STUDY_CASE(kFeatureMajor, 128, kSin7, kSin7, true)
#elif NVCC_PART == 6
  STUDY_CASE(kPointMajor, 64, kSinf, kSinf, true)
  STUDY_CASE(kFeatureMajor, 128, kAffine, kAffine, true)
#elif NVCC_PART == 7
  STUDY_CASE(kInterleave, 64, kSin7, kSin7, true)
  STUDY_CASE(kInterleave, 128, kSin7, kSin7, true)
#endif
#undef STUDY_CASE
  return kNoInstance;
}

#if NVCC_PART == 0
// One instance per (layout, T, layer-0 activation, trunk activation, trunk
// products), named by the values of `enum Layout` and `enum Act` (which
// ops/kernels/film_study.py mirrors); T is the points per CTA tile. wst is
// Wsf transposed per layer, (B, L-1, H_out, H_in) bf16 (the trunk's K-major
// weights). Launches on `stream`; returns 0, a cudaError, or kNoInstance
// when the library holds no instance of that combination.
extern "C" int film_siren_study(const float* pts, const void* w0f, const float* c,
                                const void* wst, const void* wf, const float* bf,
                                float* out, int layout, int act0, int act, int dot,
                                int tile, int B, int N, int L, void* stream) {
  if (B <= 0 || N <= 0 || tile <= 0 || L < 2 || L > MAX_LAYERS ||
      (long long)B * ((N + tile - 1) / tile) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int (*const parts[])(STUDY_PARAMS) = {film_study_part0, film_study_part1, film_study_part2,
                                         film_study_part3, film_study_part4, film_study_part5,
                                         film_study_part6, film_study_part7};
  for (auto part : parts) {
    const int err = part(pts, w0f, c, wst, wf, bf, out, layout, act0, act, dot, tile, B, N, L,
                         s);
    if (err != kNoInstance) return err;
  }
  return kNoInstance;
}
#endif
