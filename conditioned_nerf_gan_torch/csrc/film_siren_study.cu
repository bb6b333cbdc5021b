// FiLM-SIREN kernel study for Hopper (sm_90a): the ablation kernels of the
// FiLM-SIREN study, bound through a plain C interface (ctypes; see
// ops/kernels/build.py and ops/kernels/film_study.py).
//
// Replaces the Pallas study kernels of scripts/bench_film_kernel.py:
//   K3     forward_v3 -> _kernel_v3: point-major, one chain per tile;
//   K4 v4  forward_v4 -> _kernel_v4: feature-major (activations H x T,
//          the folded weights the left operand of every product);
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
//   K3 jnpsin: sinf, sinf (accurate)   K4 sin7: sin7, sin7 (K1's function)
//   K4 v5: sin7, sin7
// fast_sin is ops/fastmath.py's polynomial, sin7 K1's (csrc/film_siren_fwd.cu).
//
// What bounds it: per point 0.39 MFLOP of products at L = 4 (bf16 tensor
// cores) and 1,024 sin evaluations (FP32 pipes) against 28 bytes of device
// I/O: compute-bound, like K1. The ablations split that time: `nosin` is
// the products with a 2-operation epilogue, `nodot` the sins alone.
//
// What the design does about it. Points per CTA (T) are 32, 64 or 128:
// a TPU tile of 512-4,096 points is a VMEM block, and one layer's fp32
// output of T points lives in the registers of the CTA's 8 warps (128 KB at
// T = 128, half the register file), so the CTA can overwrite h in place in
// shared memory; 256 points would need the whole register file.
//   * Products on the tensor cores with mma.sync m16n8k16 (bf16, fp32
//     accumulators); the folded weights stream from L2 through a cp.async
//     ring of 32-row K chunks, as in K1.
//   * Point-major (K3): A = h (T x 256, rows = points), B = the weight chunk;
//     warps tile points x units 2 x 4 at T = 128, else 1 x 8.
//   * Feature-major (K4): A = the weight chunk read transposed (ldmatrix
//     .trans: the K x units rows are W^T's columns), B = h (256 x T, rows =
//     units, points contiguous); warps tile units x points 4 x 2 at T = 128,
//     else 8 x 1.
//   * v5: the two 4-warp groups each own half of the tile's points and run
//     the same chunk loop LAG = 4 chunks apart over a shared 7-chunk ring,
//     so each group's end-of-layer sin7 epilogue falls in steps where the
//     other group's warps issue products (a ping-pong schedule). Each group
//     syncs its epilogue on its own named barrier.
//   * Layer 0 (K = 3) and the 256 -> 4 head run on the FMA units; `nodot`
//     runs every layer there and never loads a trunk weight.
//   * Ragged N: points past N are zero on load and masked on store.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int H = 256;        // hidden width
constexpr int DIN = 3;        // xyz points
constexpr int COUT = 4;       // rgb + sigma
constexpr int KC = 32;        // weight rows per ring chunk
constexpr int WPITCH = H + 8; // ring row pitch in bf16 (conflict-free ldmatrix)
constexpr int THREADS = 256;  // 8 warps
constexpr int CHUNKS_PER_LAYER = H / KC;
constexpr int MAX_LAYERS = 8;
constexpr int NSTAGE = 3;     // single-chain ring depth
constexpr int V5_LAG = CHUNKS_PER_LAYER / 2;  // chunks between the two chains
constexpr int V5_PREFETCH = 2;
constexpr int V5_RING = V5_LAG + V5_PREFETCH + 1;

constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float INV_TWO_PI = 0.15915494309189533577f;
// ops/fastmath.py fast_sin
constexpr float C1 = 9.9999970703e-01f;
constexpr float C3 = -1.6666577215e-01f;
constexpr float C5 = 8.3325581177e-03f;
constexpr float C7 = -1.9812575520e-04f;
constexpr float C9 = 2.7040512127e-06f;
constexpr float C11 = -2.0534244526e-08f;
// csrc/film_siren_fwd.cu sin7
constexpr float S1 = 9.9926289884e-01f;
constexpr float S3 = -1.6565644419e-01f;
constexpr float S5 = 7.9559223702e-03f;
constexpr float S7 = -1.4495299408e-04f;

enum Act { kFastSin = 0, kSin7 = 1, kAffine = 2, kSinf = 3 };
enum Layout { kPointMajor = 0, kFeatureMajor = 1, kInterleave = 2 };
constexpr int kNoInstance = -1;  // no instance of a combination (the entry's return)

__device__ __forceinline__ float reduce_2pi(float x) {
  // x - round(x / 2pi) * 2pi without FMA contraction, as torch computes it;
  // rintf rounds half to even, as torch.round does
  return __fsub_rn(x, __fmul_rn(rintf(__fmul_rn(x, INV_TWO_PI)), TWO_PI));
}

template <int A>
__device__ __forceinline__ float act(float v) {
  if constexpr (A == kFastSin) {
    const float r = reduce_2pi(v);
    const float r2 = r * r;
    return r * (C1 + r2 * (C3 + r2 * (C5 + r2 * (C7 + r2 * (C9 + r2 * C11)))));
  } else if constexpr (A == kSin7) {
    const float r = reduce_2pi(v);
    const float r2 = r * r;
    return r * (S1 + r2 * (S3 + r2 * (S5 + r2 * S7)));
  } else if constexpr (A == kAffine) {
    return v * 0.9f;
  } else {
    return sinf(v);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The tiling of one instance: T points per pass, 8 warps as WP (along
// points) x WU (along units); each warp's accumulator block is MT x NT
// m16n8 tiles (m along points when point-major, along units otherwise).
template <int LAYOUT, int T, bool DOT>
struct Tiling {
  static_assert(T == 32 || T == 64 || T == 128, "T is 32, 64 or 128 points");
  static constexpr bool kFM = LAYOUT != kPointMajor;
  static constexpr bool kV5 = LAYOUT == kInterleave;
  static constexpr int kWP = (kV5 || T == 128) ? 2 : 1;
  static constexpr int kWU = 8 / kWP;
  static constexpr int kTP = T / kWP;  // points per warp
  static constexpr int kTU = H / kWU;  // units per warp
  static constexpr int kMT = (kFM ? kTU : kTP) / 16;
  static constexpr int kNT = (kFM ? kTP : kTU) / 8;
  static_assert(kMT >= 1 && kNT % 2 == 0, "warp tile");
  static constexpr int kHRows = kFM ? H : T;  // h buffer rows
  static constexpr int kHP = kFM ? T + 8 : H + 8;  // h row pitch in bf16
  static constexpr int kRing = !DOT ? 0 : (kV5 ? V5_RING : NSTAGE);
  static constexpr int kPrefetch = kV5 ? V5_PREFETCH : NSTAGE - 1;
  static constexpr int kLag = kV5 ? V5_LAG : 0;
  static constexpr int kSplit = THREADS / T;  // head: threads per point
};

template <int LAYOUT, int T, bool DOT>
size_t smem_bytes(int L) {
  using C = Tiling<LAYOUT, T, DOT>;
  return sizeof(__nv_bfloat16) * (size_t)(C::kHRows * C::kHP + C::kRing * KC * WPITCH) +
         sizeof(float) * (size_t)(L * H + H * COUT + DIN * H + T * DIN);
}

// pts (B, N, 3) f32; w0f (B, 3, H) bf16; c (B, L, H) f32 (c_0 then c_1..);
// wsf (B, L-1, H, H) bf16 as [k][n]; wf (H, 4) bf16; bf (4) f32; out (B, N,
// 4) f32. Grid: (ceil(N / T), B).
template <int LAYOUT, int T, int ACT0, int ACT, bool DOT>
__global__ void __launch_bounds__(THREADS, 1)
film_study_kernel(const float* __restrict__ pts, const __nv_bfloat16* __restrict__ w0f,
                  const float* __restrict__ c, const __nv_bfloat16* __restrict__ wsf,
                  const __nv_bfloat16* __restrict__ wf, const float* __restrict__ bf,
                  float* __restrict__ out, int N, int L) {
  using C = Tiling<LAYOUT, T, DOT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sH = reinterpret_cast<__nv_bfloat16*>(smem);  // kHRows x kHP
  __nv_bfloat16* sW = sH + C::kHRows * C::kHP;                   // kRing x KC x WPITCH
  float* sC = reinterpret_cast<float*>(sW + C::kRing * KC * WPITCH);  // L x H
  float* sWF = sC + L * H;                                       // H x COUT
  float* sW0 = sWF + H * COUT;                                   // DIN x H
  float* sX = sW0 + DIN * H;                                     // T x DIN

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const __nv_bfloat16* w0b = w0f + (size_t)b * DIN * H;
  const __nv_bfloat16* wb = wsf + (size_t)b * (L - 1) * H * H;
  const int nchunks = DOT ? (L - 1) * CHUNKS_PER_LAYER : 0;

  for (int i = tid; i < L * H; i += THREADS) sC[i] = c[(size_t)b * L * H + i];
  for (int i = tid; i < H * COUT; i += THREADS) sWF[i] = __bfloat162float(wf[i]);
  for (int i = tid; i < DIN * H; i += THREADS) sW0[i] = __bfloat162float(w0b[i]);

  // chunk g: rows [g*KC, (g+1)*KC) of the (L-1)*H stacked trunk weight rows
  auto load_chunk = [&](int g) {
    const __nv_bfloat16* src = wb + (size_t)g * KC * H;
    __nv_bfloat16* dst = sW + (g % C::kRing) * KC * WPITCH;
#pragma unroll
    for (int i = 0; i < (KC * H / 8) / THREADS; ++i) {
      const int s = tid + i * THREADS;
      const int row = s / (H / 8);
      const int col = (s % (H / 8)) * 8;
      cp_async16(dst + row * WPITCH + col, src + (size_t)row * H + col);
    }
  };

  const int wpi = warp / C::kWU;  // warp's block along points (v5: its chain)
  const int wui = warp % C::kWU;  // warp's block along units
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
  const int lcol = (lane >> 4) * 8;                     // ldmatrix column offset
  const uint32_t sH_base = smem_addr(sH);
  const uint32_t sW_base = smem_addr(sW);

  const int p0 = blockIdx.x * T;
  const int valid = min(T, N - p0);

  if constexpr (DOT) {
    for (int s = 0; s < C::kPrefetch; ++s) {
      if (s < nchunks) load_chunk(s);
      cp_async_commit();
    }
  }
  const float* xb = pts + ((size_t)b * N + p0) * DIN;
  for (int i = tid; i < T * DIN; i += THREADS) {
    const float v = i < valid * DIN ? xb[i] : 0.f;
    sX[i] = __bfloat162float(__float2bfloat16(v));
  }
  __syncthreads();

  // layer 0 on the FMA units (K = 3); `nodot` runs the trunk here too
  for (int i = tid; i < T * H / 2; i += THREADS) {
    int p, n;  // a pair of points (feature-major) or of units (point-major)
    if constexpr (C::kFM) {
      n = i / (T / 2);
      p = (i % (T / 2)) * 2;
    } else {
      p = i / (H / 2);
      n = (i % (H / 2)) * 2;
    }
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int pj = C::kFM ? p + j : p;
      const int nj = C::kFM ? n : n + j;
      const float* x = sX + pj * DIN;
      v[j] = act<ACT0>(x[0] * sW0[nj] + x[1] * sW0[H + nj] + x[2] * sW0[2 * H + nj] +
                       sC[nj]);
      if constexpr (!DOT) {
        for (int l = 1; l < L; ++l) v[j] = act<ACT>(v[j] + sC[l * H + nj]);
      }
    }
    store_bf16x2(C::kFM ? sH + n * C::kHP + p : sH + p * C::kHP + n, v[0], v[1]);
  }

  if constexpr (DOT) {
    float acc[C::kMT][C::kNT][4];
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    // step s: the (first) chain takes chunk s; v5's second chain chunk s - LAG
    const int steps = nchunks + C::kLag;
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<C::kPrefetch - 1>();
      __syncthreads();  // chunk s landed, h is complete, the freed slot is free
      if (s + C::kPrefetch < nchunks) load_chunk(s + C::kPrefetch);
      cp_async_commit();

      const int g = s - wpi * C::kLag;
      if (g < 0 || g >= nchunks) continue;
      const int layer = 1 + g / CHUNKS_PER_LAYER;
      const int kc = g % CHUNKS_PER_LAYER;
      const uint32_t w_stage =
          sW_base + (uint32_t)((g % C::kRing) * KC * WPITCH * 2);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[C::kMT][4];
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt) {
          if constexpr (C::kFM) {
            // A = W^T (units x k) from the [k][unit] chunk, transposed
            const int krow = kk + (lane & 7) + (lane >> 4) * 8;
            const int ucol = wui * C::kTU + mt * 16 + ((lane >> 3) & 1) * 8;
            ldmatrix_x4_trans(a[mt], w_stage + (uint32_t)((krow * WPITCH + ucol) * 2));
          } else {
            // A = h (points x k)
            const int row = wpi * C::kTP + mt * 16 + lrow;
            const int col = kc * KC + kk + lcol;
            ldmatrix_x4(a[mt], sH_base + (uint32_t)((row * C::kHP + col) * 2));
          }
        }
#pragma unroll
        for (int np = 0; np < C::kNT / 2; ++np) {
          uint32_t bq[4];
          if constexpr (C::kFM) {
            // B = h (k x points)
            const int krow = kc * KC + kk + lrow;
            const int col = wpi * C::kTP + np * 16 + lcol;
            ldmatrix_x4_trans(bq, sH_base + (uint32_t)((krow * C::kHP + col) * 2));
          } else {
            // B = the weight chunk (k x units)
            const int krow = kk + lrow;
            const int col = wui * C::kTU + np * 16 + lcol;
            ldmatrix_x4_trans(bq, w_stage + (uint32_t)((krow * WPITCH + col) * 2));
          }
#pragma unroll
          for (int mt = 0; mt < C::kMT; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], bq[0], bq[1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
          }
        }
      }

      if (kc == CHUNKS_PER_LAYER - 1) {
        // layer done: h = bf16(act(acc + c_l)), written over the old h once
        // every warp reading it (v5: of this chain) is through
        if constexpr (C::kV5) {
          named_barrier(1 + wpi, THREADS / 2);
        } else {
          __syncthreads();
        }
        const float* cl = sC + layer * H;
#pragma unroll
        for (int mt = 0; mt < C::kMT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < C::kNT; ++nt) {
            float* d = acc[mt][nt];
            if constexpr (C::kFM) {
              const int u = wui * C::kTU + mt * 16 + (lane >> 2);
              const int p = wpi * C::kTP + nt * 8 + (lane & 3) * 2;
              const float cu = cl[u], cu8 = cl[u + 8];
              store_bf16x2(sH + u * C::kHP + p, act<ACT>(d[0] + cu), act<ACT>(d[1] + cu));
              store_bf16x2(sH + (u + 8) * C::kHP + p, act<ACT>(d[2] + cu8),
                           act<ACT>(d[3] + cu8));
            } else {
              const int r0 = wpi * C::kTP + mt * 16 + (lane >> 2);
              const int col = wui * C::kTU + nt * 8 + (lane & 3) * 2;
              const float c0 = cl[col], c1 = cl[col + 1];
              store_bf16x2(sH + r0 * C::kHP + col, act<ACT>(d[0] + c0), act<ACT>(d[1] + c1));
              store_bf16x2(sH + (r0 + 8) * C::kHP + col, act<ACT>(d[2] + c0),
                           act<ACT>(d[3] + c1));
            }
            d[0] = d[1] = d[2] = d[3] = 0.f;
          }
        }
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();

  // head on the FMA units: out = h . Wf + bf; kSplit threads per point
  {
    const int p = tid / C::kSplit;
    const int part = tid % C::kSplit;
    const float4* wf4 = reinterpret_cast<const float4*>(sWF);
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll 8
    for (int u = part; u < H; u += C::kSplit) {
      const float hv = __bfloat162float(C::kFM ? sH[u * C::kHP + p] : sH[p * C::kHP + u]);
      const float4 w = wf4[u];
      o0 += hv * w.x;
      o1 += hv * w.y;
      o2 += hv * w.z;
      o3 += hv * w.w;
    }
#pragma unroll
    for (int o = 1; o < C::kSplit; o <<= 1) {
      o0 += __shfl_xor_sync(0xffffffffu, o0, o);
      o1 += __shfl_xor_sync(0xffffffffu, o1, o);
      o2 += __shfl_xor_sync(0xffffffffu, o2, o);
      o3 += __shfl_xor_sync(0xffffffffu, o3, o);
    }
    if (part == 0 && p < valid) {
      *reinterpret_cast<float4*>(out + ((size_t)b * N + p0 + p) * COUT) =
          make_float4(o0 + bf[0], o1 + bf[1], o2 + bf[2], o3 + bf[3]);
    }
  }
}

template <int LAYOUT, int T, int ACT0, int ACT, bool DOT>
int launch(const float* pts, const void* w0f, const float* c, const void* wsf,
           const void* wf, const float* bf, float* out, int B, int N, int L,
           cudaStream_t stream) {
  auto kernel = film_study_kernel<LAYOUT, T, ACT0, ACT, DOT>;
  const size_t smem = smem_bytes<LAYOUT, T, DOT>(L);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + T - 1) / T), (unsigned)B);
  kernel<<<grid, THREADS, smem, stream>>>(
      pts, static_cast<const __nv_bfloat16*>(w0f), c,
      static_cast<const __nv_bfloat16*>(wsf), static_cast<const __nv_bfloat16*>(wf), bf,
      out, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// One instance per (layout, T, layer-0 activation, trunk activation, trunk
// products), named by the values of `enum Layout` and `enum Act` (which
// ops/kernels/film_study.py mirrors); T is the points per CTA. Launches on
// `stream`; returns 0, a cudaError, or kNoInstance when the library holds no
// instance of that combination.
extern "C" int film_siren_study(const float* pts, const void* w0f, const float* c,
                                const void* wsf, const void* wf, const float* bf,
                                float* out, int layout, int act0, int act, int dot,
                                int tile, int B, int N, int L, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || L < 2 || L > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STUDY_CASE(LAYOUT, TT, A0, A, DOT)                                           \
  if (layout == LAYOUT && tile == TT && act0 == A0 && act == A && (dot != 0) == DOT) \
    return launch<LAYOUT, TT, A0, A, DOT>(pts, w0f, c, wsf, wf, bf, out, B, N, L, s);
  // K3 (point-major): single, nosin, nodot, jnpsin
  STUDY_CASE(kPointMajor, 32, kFastSin, kFastSin, true)
  STUDY_CASE(kPointMajor, 64, kFastSin, kFastSin, true)
  STUDY_CASE(kPointMajor, 128, kFastSin, kFastSin, true)
  STUDY_CASE(kPointMajor, 64, kFastSin, kAffine, true)
  STUDY_CASE(kPointMajor, 128, kFastSin, kAffine, true)
  STUDY_CASE(kPointMajor, 64, kFastSin, kFastSin, false)
  STUDY_CASE(kPointMajor, 128, kFastSin, kFastSin, false)
  STUDY_CASE(kPointMajor, 64, kSinf, kSinf, true)
  STUDY_CASE(kPointMajor, 128, kSinf, kSinf, true)
  // K4 v4 (feature-major): full, sin7, nosin, nodot
  STUDY_CASE(kFeatureMajor, 32, kFastSin, kFastSin, true)
  STUDY_CASE(kFeatureMajor, 64, kFastSin, kFastSin, true)
  STUDY_CASE(kFeatureMajor, 128, kFastSin, kFastSin, true)
  STUDY_CASE(kFeatureMajor, 128, kSin7, kSin7, true)
  STUDY_CASE(kFeatureMajor, 128, kAffine, kAffine, true)
  STUDY_CASE(kFeatureMajor, 128, kFastSin, kFastSin, false)
  // K4 v5 (two interleaved chains): sin7
  STUDY_CASE(kInterleave, 64, kSin7, kSin7, true)
  STUDY_CASE(kInterleave, 128, kSin7, kSin7, true)
#undef STUDY_CASE
  return kNoInstance;
}
