// Fused FiLM-SIREN VJP for Hopper (sm_90a), bound through a plain C interface
// (ctypes; see ops/kernels/build.py and ops/kernels/film_siren.py).
//
// Replaces conditioned_nerf_gan_tpu/ops/pallas/film_siren.py::_backward_kernel
// (the Pallas VJP launched by _backward_pallas). It computes exactly that
// kernel's math on freq-folded weights (the fold and its unwind stay in torch):
//   recompute  x = bf16(points); pre_0 = x . W0f[b] + c[b,0];
//              pre_l = h_{l-1} . Wsf[b,l-1] + c[b,l];
//              h_l = bf16(sin7(pre_l)), cos_l = bf16(cos7(pre_l))   (cos7 = sin7')
//   backward   gb = bf16(g); dh_{L-1} = gb . bf16(Wf)^T;
//              dpre_l = bf16(dh_l * cos_l); dh_{l-1} = dpre_l . Wsf[b,l-1]^T;
//              dX = dpre_0 . W0f[b]^T
//   weights    dWsf[b,l] = h_l^T dpre_{l+1}, dcs[b,l] = 1^T dpre_{l+1},
//              dW0f[b] = x^T dpre_0, dc0[b] = 1^T dpre_0,
//              dWf[b] = h_{L-1}^T gb, dbf[b] = 1^T gb        (summed over points)
// with bf16 operands and fp32 sums throughout.
//
// What bounds it: the recompute and the sweep are 2 x 3 x 256 x 256 x 2 FLOP
// per point on the tensor cores; the weight grads another 3 x 256 x 256 x 2
// summed over every point of a batch element, a reduction across the point
// axis.
//
// What the design does about it. The TPU kernel keeps h_l and cos_l of a
// 2048-point tile resident (~4 MB of VMEM) and sums the weight grads by
// revisiting one output block in grid order. Neither carries over: 4 layers x
// 256 x 2 bf16 tensors are 4 KB per point, and CTAs run in parallel and in no
// order. So the VJP is three kernels:
//   (a) film_siren_bwd_sweep: one CTA per batch element x 128 points, the
//       forward kernel's layout (8 warps of 64 x 64 mma.sync m16n8k16 fp32
//       accumulators, 32-row weight chunks streamed through a 3-stage
//       cp.async ring that runs on from the forward layers into the backward
//       ones, which read W^T). It writes h_l and cos_l to device memory in
//       the forward epilogues; each backward epilogue reads cos_l back at the
//       same accumulator positions it was written from (same thread, no
//       barrier needed) and overwrites it with dpre_l. It also writes dX and
//       the bf16 points and cotangent, padded to 16 columns. Scratch: 4 KB per
//       point (2.4 GB for 12 x 49,152 points).
//   (b) film_siren_bwd_wgrad: one CTA per 128 x 128 tile of one weight grad of
//       one batch element and one segment of (at least 4,096) points. It
//       loops over the segment's points in order: 32-point chunks of both
//       operands through a 3-stage cp.async ring, mma.sync with fp32
//       accumulators; the CTAs of the first row tile also sum dpre's columns
//       (the ones row), Kahan-compensated. Each CTA writes its partial tile;
//   (c) film_siren_bwd_reduce sums the segments' partials in segment order.
//       Per-segment partials give the B = 2 study shape 6,144 CTAs where a
//       whole-N loop per tile had 32, and cut each serial fp32 sum from N/16
//       tensor-core steps to 256 plus one per segment. No atomics: every sum
//       runs in the same order in every launch, so the grads are bitwise
//       deterministic from run to run.
// The small products (dW0f: 3 rows, dWf: 4 columns) run as mostly-empty
// 128 x 128 tiles of (b) (16 tiles per batch element and segment, 4 of them
// small). wgmma, TMA and warp specialisation are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int H = 256;        // hidden width (SHORTSIREN)
constexpr int DIN = 3;        // xyz
constexpr int COUT = 4;       // rgb + sigma
constexpr int PADC = 16;      // columns of the padded point / cotangent scratch
constexpr int T = 128;        // points per sweep CTA
constexpr int KC = 32;        // weight rows per pipeline chunk
constexpr int NSTAGE = 3;     // cp.async ring depth
constexpr int PITCH = H + 8;  // shared-memory row pitch in bf16
constexpr int THREADS = 256;  // 8 warps
constexpr int CHUNKS_PER_LAYER = H / KC;

// weight-grad kernel
constexpr int BT = 128;          // output tile (rows and columns)
constexpr int WKC = 32;          // points per chunk
constexpr int WPITCH = BT + 8;   // shared-memory row pitch in bf16
constexpr int JOB_TILES = 4;     // tiles of the largest job (256 x 256)

constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float INV_TWO_PI = 0.15915494309189533577f;
constexpr float S1 = 9.9926289884e-01f;
constexpr float S3 = -1.6565644419e-01f;
constexpr float S5 = 7.9559223702e-03f;
constexpr float S7 = -1.4495299408e-04f;
// cos7 coefficients, rounded from the double products as torch and JAX do
constexpr float C3 = (float)(3.0 * -1.6565644419e-01);
constexpr float C5 = (float)(5.0 * 7.9559223702e-03);
constexpr float C7 = (float)(7.0 * -1.4495299408e-04);

__device__ __forceinline__ float reduce_range(float x) {
  // without FMA contraction, as the torch version computes it
  return __fsub_rn(x, __fmul_rn(rintf(__fmul_rn(x, INV_TWO_PI)), TWO_PI));
}

__device__ __forceinline__ float sin7(float x) {
  const float r = reduce_range(x);
  const float r2 = r * r;
  return r * (S1 + r2 * (S3 + r2 * (S5 + r2 * S7)));
}

__device__ __forceinline__ float cos7(float x) {
  const float r = reduce_range(x);
  const float r2 = r * r;
  return S1 + r2 * (C3 + r2 * (C5 + r2 * C7));
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

size_t sweep_smem_bytes(int L) {
  return sizeof(__nv_bfloat16) * (size_t)(T * PITCH + NSTAGE * KC * PITCH) +
         sizeof(float) * (size_t)(L * H + DIN * H + H * COUT + T * DIN + T * COUT);
}

constexpr size_t WGRAD_SMEM_BYTES =
    sizeof(__nv_bfloat16) * (size_t)(2 * NSTAGE * WKC * WPITCH);

// pts (B, N, 3) f32; g (B, N, 4) f32; w0f (B, 3, H) bf16; c (B, L, H) f32;
// wsf (B, L-1, H, H) bf16 as [k][n]; wsft its transpose per layer, [n][k];
// wf (H, 4) bf16. Writes hbuf/pbuf (B, L, Np, H) bf16 (h_l; dpre_l),
// xbuf/gbuf (B, Np, 16) bf16 and dx (B, N, 3) f32. Grid: (Np / T, B).
__global__ void __launch_bounds__(THREADS, 1)
film_siren_bwd_sweep(const float* __restrict__ pts, const float* __restrict__ g,
                     const __nv_bfloat16* __restrict__ w0f,
                     const float* __restrict__ c,
                     const __nv_bfloat16* __restrict__ wsf,
                     const __nv_bfloat16* __restrict__ wsft,
                     const __nv_bfloat16* __restrict__ wf,
                     __nv_bfloat16* __restrict__ hbuf, __nv_bfloat16* __restrict__ pbuf,
                     __nv_bfloat16* __restrict__ xbuf, __nv_bfloat16* __restrict__ gbuf,
                     float* __restrict__ dx, int N, int Np, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sH = reinterpret_cast<__nv_bfloat16*>(smem);  // T x PITCH
  __nv_bfloat16* sW = sH + T * PITCH;                           // NSTAGE x KC x PITCH
  float* sC = reinterpret_cast<float*>(sW + NSTAGE * KC * PITCH);  // L x H
  float* sW0 = sC + L * H;                                      // DIN x H
  float* sWF = sW0 + DIN * H;                                   // H x COUT
  float* sX = sWF + H * COUT;                                   // T x DIN
  float* sG = sX + T * DIN;                                     // T x COUT

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * T;
  const int valid = max(0, min(T, N - p0));
  const int nf = (L - 1) * CHUNKS_PER_LAYER;  // forward chunks; as many backward
  const int nchunks = 2 * nf;

  // chunk q < nf: rows [q*KC, (q+1)*KC) of the stacked Wsf[b] (forward order);
  // chunk nf + r: rows of Wsf[b, L-2 - r/8]^T (backward order)
  auto chunk_src = [&](int q) -> const __nv_bfloat16* {
    if (q < nf) return wsf + (size_t)b * (L - 1) * H * H + (size_t)q * KC * H;
    const int r = q - nf;
    const int layer = L - 2 - r / CHUNKS_PER_LAYER;
    return wsft + ((size_t)b * (L - 1) + layer) * H * H +
           (size_t)(r % CHUNKS_PER_LAYER) * KC * H;
  };
  auto load_chunk = [&](int q) {
    const __nv_bfloat16* src = chunk_src(q);
    __nv_bfloat16* dst = sW + (q % NSTAGE) * KC * PITCH;
#pragma unroll
    for (int i = 0; i < (KC * H / 8) / THREADS; ++i) {
      const int s = tid + i * THREADS;
      const int row = s / (H / 8);
      const int col = (s % (H / 8)) * 8;
      cp_async16(dst + row * PITCH + col, src + (size_t)row * H + col);
    }
  };

  for (int s = 0; s < NSTAGE - 1; ++s) {
    load_chunk(s);  // nchunks >= 16 > NSTAGE - 1
    cp_async_commit();
  }

  for (int i = tid; i < L * H; i += THREADS) sC[i] = c[(size_t)b * L * H + i];
  for (int i = tid; i < DIN * H; i += THREADS)
    sW0[i] = __bfloat162float(w0f[(size_t)b * DIN * H + i]);
  for (int i = tid; i < H * COUT; i += THREADS) sWF[i] = __bfloat162float(wf[i]);
  for (int i = tid; i < T * DIN; i += THREADS) {
    const float v = i < valid * DIN ? pts[((size_t)b * N + p0) * DIN + i] : 0.f;
    sX[i] = __bfloat162float(__float2bfloat16(v));
  }
  for (int i = tid; i < T * COUT; i += THREADS) {
    const float v = i < valid * COUT ? g[((size_t)b * N + p0) * COUT + i] : 0.f;
    sG[i] = __bfloat162float(__float2bfloat16(v));
  }
  __syncthreads();

  // the bf16 points and cotangent for the weight-grad kernel, zero-padded to
  // PADC columns (and zero on the ragged tail)
  for (int i = tid; i < T * PADC; i += THREADS) {
    const int p = i / PADC, j = i % PADC;
    const size_t at = ((size_t)b * Np + p0 + p) * PADC + j;
    xbuf[at] = __float2bfloat16(j < DIN ? sX[p * DIN + j] : 0.f);
    gbuf[at] = __float2bfloat16(j < COUT ? sG[p * COUT + j] : 0.f);
  }

  // accumulator layout: warp (wm, wn) owns points wm*64.. and units wn*64..;
  // element e of acc[mt][nt] is point frow(mt, e), unit fcol(nt) + (e & 1)
  const int wm = warp >> 2;
  const int wn = warp & 3;
  auto frow = [&](int mt, int e) { return wm * 64 + mt * 16 + (lane >> 2) + (e >> 1) * 8; };
  auto fcol = [&](int nt) { return wn * 64 + nt * 8 + (lane & 3) * 2; };
  auto slot = [&](__nv_bfloat16* buf, int layer, int p, int n) {
    return reinterpret_cast<__nv_bfloat162*>(
        buf + (((size_t)b * L + layer) * Np + p0 + p) * H + n);
  };

  // layer 0 on the FMA units (K = 3), in the accumulator layout
#pragma unroll 1
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int p = frow(mt, half * 2);
      const float x0 = sX[p * DIN], x1 = sX[p * DIN + 1], x2 = sX[p * DIN + 2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = fcol(nt);
        const float v0 = x0 * sW0[n] + x1 * sW0[H + n] + x2 * sW0[2 * H + n] + sC[n];
        const float v1 = x0 * sW0[n + 1] + x1 * sW0[H + n + 1] + x2 * sW0[2 * H + n + 1] +
                         sC[n + 1];
        const __nv_bfloat162 h = __floats2bfloat162_rn(sin7(v0), sin7(v1));
        *reinterpret_cast<__nv_bfloat162*>(sH + p * PITCH + n) = h;
        *slot(hbuf, 0, p, n) = h;
        *slot(pbuf, 0, p, n) = __floats2bfloat162_rn(cos7(v0), cos7(v1));
      }
    }
  }

  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
  const int lcol = (lane >> 4) * 8;                     // ldmatrix column offset
  const uint32_t sH_base = smem_addr(sH);
  const uint32_t sW_base = smem_addr(sW);

  float acc[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll 1
  for (int q = 0; q < nchunks; ++q) {
    if (q == nf) {
      // backward head on the FMA units: dpre_{L-1} = bf16(gb . Wf^T * cos_{L-1}),
      // written over h_{L-1} in sH at this thread's own accumulator positions
#pragma unroll 1
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll 1
        for (int half = 0; half < 2; ++half) {
          const int p = frow(mt, half * 2);
          const float4 gv = *reinterpret_cast<const float4*>(sG + p * COUT);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int n = fcol(nt);
            const float4 wa = *reinterpret_cast<const float4*>(sWF + n * COUT);
            const float4 wb = *reinterpret_cast<const float4*>(sWF + (n + 1) * COUT);
            const float d0 = gv.x * wa.x + gv.y * wa.y + gv.z * wa.z + gv.w * wa.w;
            const float d1 = gv.x * wb.x + gv.y * wb.y + gv.z * wb.z + gv.w * wb.w;
            __nv_bfloat162* at = slot(pbuf, L - 1, p, n);
            const float2 cv = __bfloat1622float2(*at);
            const __nv_bfloat162 dp = __floats2bfloat162_rn(d0 * cv.x, d1 * cv.y);
            *reinterpret_cast<__nv_bfloat162*>(sH + p * PITCH + n) = dp;
            *at = dp;
          }
        }
      }
    }
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk q landed, sH is complete, stage (q-1) is free
    if (q + NSTAGE - 1 < nchunks) load_chunk(q + NSTAGE - 1);
    cp_async_commit();

    const int kc = q % CHUNKS_PER_LAYER;
    const uint32_t w_stage = sW_base + (uint32_t)((q % NSTAGE) * KC * PITCH * 2);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int row = wm * 64 + mt * 16 + lrow;
        const int col = kc * KC + kk + lcol;
        ldmatrix_x4(a[mt], sH_base + (uint32_t)((row * PITCH + col) * 2));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        const int krow = kk + lrow;
        const int col = wn * 64 + np * 16 + lcol;
        ldmatrix_x4_trans(bq, w_stage + (uint32_t)((krow * PITCH + col) * 2));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bq[0], bq[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
        }
      }
    }

    if (kc == CHUNKS_PER_LAYER - 1) {
      __syncthreads();  // every warp has finished reading sH
      const bool fwd = q < nf;
      // forward: layer q/8 + 1 gives h (sH, hbuf) and cos (pbuf);
      // backward: layer L-2 - (q-nf)/8 turns cos (pbuf) into dpre (sH, pbuf)
      const int layer = fwd ? q / CHUNKS_PER_LAYER + 1 : L - 2 - (q - nf) / CHUNKS_PER_LAYER;
      const float* cl = sC + layer * H;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = fcol(nt);
          float* d = acc[mt][nt];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = frow(mt, half * 2);
            const float v0 = d[half * 2], v1 = d[half * 2 + 1];
            __nv_bfloat162* at = slot(pbuf, layer, p, n);
            __nv_bfloat162 out;
            if (fwd) {
              const float pre0 = v0 + cl[n], pre1 = v1 + cl[n + 1];
              out = __floats2bfloat162_rn(sin7(pre0), sin7(pre1));
              *slot(hbuf, layer, p, n) = out;
              *at = __floats2bfloat162_rn(cos7(pre0), cos7(pre1));
            } else {
              const float2 cv = __bfloat1622float2(*at);
              out = __floats2bfloat162_rn(v0 * cv.x, v1 * cv.y);
              *at = out;
            }
            *reinterpret_cast<__nv_bfloat162*>(sH + p * PITCH + n) = out;
          }
          d[0] = d[1] = d[2] = d[3] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // dX = dpre_0 . W0f^T on the FMA units; two threads per point split K
  {
    const int p = tid >> 1;
    const int part = tid & 1;
    const __nv_bfloat162* row = reinterpret_cast<const __nv_bfloat162*>(sH + p * PITCH);
    float o0 = 0.f, o1 = 0.f, o2 = 0.f;
#pragma unroll 8
    for (int j = part; j < H / 2; j += 2) {
      const float2 v = __bfloat1622float2(row[j]);
      const int k = 2 * j;
      o0 += v.x * sW0[k] + v.y * sW0[k + 1];
      o1 += v.x * sW0[H + k] + v.y * sW0[H + k + 1];
      o2 += v.x * sW0[2 * H + k] + v.y * sW0[2 * H + k + 1];
    }
    o0 += __shfl_xor_sync(0xffffffffu, o0, 1);
    o1 += __shfl_xor_sync(0xffffffffu, o1, 1);
    o2 += __shfl_xor_sync(0xffffffffu, o2, 1);
    if (part == 0 && p < valid) {
      float* o = dx + ((size_t)b * N + p0 + p) * DIN;
      o[0] = o0;
      o[1] = o1;
      o[2] = o2;
    }
  }
}

// One weight-grad product C = A^T B over the point axis (and the column sums
// of B), for one batch element. A (Np, a_cols) and B (Np, b_cols) are bf16,
// point-major; C rows < c_rows and columns < c_cols are written, row pitch ldc.
struct WgradJob {
  const __nv_bfloat16* a;
  const __nv_bfloat16* bm;
  float* out;
  float* colsum;
  int a_cols, b_cols, c_rows, c_cols, ldc;
};

// The grads of all batch elements in one flat block of floats, in this order:
// dws (B, L-1, H, H), dcs (B, L-1, H), dw0 (B, 3, H), dc0 (B, H),
// dwf (B, H, 4), dbf (B, 4). The wrapper slices the same layout.
__host__ __device__ inline size_t grads_size(int B, int L) {
  return (size_t)B * ((L - 1) * (H * H + H) + DIN * H + H + H * COUT + COUT);
}

__device__ WgradJob make_job(int job, int b, int B, int L, int Np,
                             const __nv_bfloat16* hbuf, const __nv_bfloat16* pbuf,
                             const __nv_bfloat16* xbuf, const __nv_bfloat16* gbuf,
                             float* grads) {
  float* dws = grads;
  float* dcs = dws + (size_t)B * (L - 1) * H * H;
  float* dw0 = dcs + (size_t)B * (L - 1) * H;
  float* dc0 = dw0 + (size_t)B * DIN * H;
  float* dwf = dc0 + (size_t)B * H;
  float* dbf = dwf + (size_t)B * H * COUT;
  auto layer = [&](const __nv_bfloat16* buf, int l) {
    return buf + ((size_t)b * L + l) * Np * H;
  };
  WgradJob j;
  if (job < L - 1) {  // dWsf[b, job] = h_job^T dpre_{job+1}; dcs[b, job]
    j.a = layer(hbuf, job);
    j.bm = layer(pbuf, job + 1);
    j.out = dws + ((size_t)b * (L - 1) + job) * H * H;
    j.colsum = dcs + ((size_t)b * (L - 1) + job) * H;
    j.a_cols = H; j.b_cols = H; j.c_rows = H; j.c_cols = H; j.ldc = H;
  } else if (job == L - 1) {  // dW0f[b] = x^T dpre_0; dc0[b]
    j.a = xbuf + (size_t)b * Np * PADC;
    j.bm = layer(pbuf, 0);
    j.out = dw0 + (size_t)b * DIN * H;
    j.colsum = dc0 + (size_t)b * H;
    j.a_cols = PADC; j.b_cols = H; j.c_rows = DIN; j.c_cols = H; j.ldc = H;
  } else {  // dWf[b] = h_{L-1}^T gb; dbf[b]
    j.a = layer(hbuf, L - 1);
    j.bm = gbuf + (size_t)b * Np * PADC;
    j.out = dwf + (size_t)b * H * COUT;
    j.colsum = dbf + (size_t)b * COUT;
    j.a_cols = H; j.b_cols = PADC; j.c_rows = H; j.c_cols = COUT; j.ldc = COUT;
  }
  return j;
}

// Grid: (4 tiles, L + 1 jobs, segments x B). Segment s covers points
// [s * seg, min((s+1) * seg, Np)) and writes the partial grads block s of
// `part`. 8 warps: warp (wm, wn) owns rows wm*64.. and columns wn*32.. of
// the CTA's 128 x 128 tile.
__global__ void __launch_bounds__(THREADS)
film_siren_bwd_wgrad(const __nv_bfloat16* __restrict__ hbuf,
                     const __nv_bfloat16* __restrict__ pbuf,
                     const __nv_bfloat16* __restrict__ xbuf,
                     const __nv_bfloat16* __restrict__ gbuf, float* part, int B, int Np,
                     int L, int seg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // NSTAGE x WKC x WPITCH
  __nv_bfloat16* sB = sA + NSTAGE * WKC * WPITCH;              // NSTAGE x WKC x WPITCH

  const int b = blockIdx.z % B;
  const int segment = blockIdx.z / B;
  const int p_begin = segment * seg;
  const WgradJob job = make_job(blockIdx.y, b, B, L, Np, hbuf, pbuf, xbuf, gbuf,
                                part + (size_t)segment * grads_size(B, L));
  const int n_tiles = (job.b_cols + BT - 1) / BT;
  const int m_tiles = (job.c_rows + BT - 1) / BT;
  if ((int)blockIdx.x >= m_tiles * n_tiles) return;
  const int m0 = (blockIdx.x / n_tiles) * BT;
  const int n0 = (blockIdx.x % n_tiles) * BT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // operand columns past a_cols / b_cols are never loaded: zero them once
  for (int i = tid; i < 2 * NSTAGE * WKC * WPITCH / 2; i += THREADS)
    reinterpret_cast<uint32_t*>(sA)[i] = 0u;
  __syncthreads();

  const int a_vecs = min(BT, job.a_cols - m0) / 8;  // 16-byte vectors per row
  const int b_vecs = min(BT, job.b_cols - n0) / 8;
  auto load_chunk = [&](int q) {
    const size_t p = (size_t)p_begin + (size_t)q * WKC;
    __nv_bfloat16* da = sA + (q % NSTAGE) * WKC * WPITCH;
    __nv_bfloat16* db = sB + (q % NSTAGE) * WKC * WPITCH;
    for (int s = tid; s < WKC * (BT / 8); s += THREADS) {
      const int row = s / (BT / 8), v = s % (BT / 8);
      if (v < a_vecs)
        cp_async16(da + row * WPITCH + v * 8, job.a + (p + row) * job.a_cols + m0 + v * 8);
      if (v < b_vecs)
        cp_async16(db + row * WPITCH + v * 8, job.bm + (p + row) * job.b_cols + n0 + v * 8);
    }
  };

  const int nchunks = (min(Np, p_begin + seg) - p_begin) / WKC;
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nchunks) load_chunk(s);
    cp_async_commit();
  }

  const int wm = warp >> 2;  // rows wm*64 .. +64
  const int wn = warp & 3;   // columns wn*32 .. +32
  // A^T fragments from the point-major tile: 8x8 blocks at (k, m) offsets
  // (0,0) (0,8) (8,0) (8,8) for lanes 0-7, 8-15, 16-23, 24-31, transposed
  const int a_krow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int a_mcol = ((lane >> 3) & 1) * 8;
  const int b_krow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_ncol = (lane >> 4) * 8;
  const bool do_colsum = m0 == 0 && tid < BT;
  float colsum = 0.f, comp = 0.f;  // Kahan-compensated column sum

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll 1
  for (int q = 0; q < nchunks; ++q) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk q landed, stage (q-1) is free
    if (q + NSTAGE - 1 < nchunks) load_chunk(q + NSTAGE - 1);
    cp_async_commit();

    const __nv_bfloat16* tA = sA + (q % NSTAGE) * WKC * WPITCH;
    const __nv_bfloat16* tB = sB + (q % NSTAGE) * WKC * WPITCH;
    const uint32_t a_stage = smem_addr(tA);
    const uint32_t b_stage = smem_addr(tB);
#pragma unroll
    for (int kk = 0; kk < WKC; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int krow = kk + a_krow;
        const int col = wm * 64 + mt * 16 + a_mcol;
        ldmatrix_x4_trans(a[mt], a_stage + (uint32_t)((krow * WPITCH + col) * 2));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4];
        const int krow = kk + b_krow;
        const int col = wn * 32 + np * 16 + b_ncol;
        ldmatrix_x4_trans(bq, b_stage + (uint32_t)((krow * WPITCH + col) * 2));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], bq[0], bq[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
        }
      }
    }
    if (do_colsum) {
#pragma unroll 8
      for (int r = 0; r < WKC; ++r) {
        const float y = __bfloat162float(tB[r * WPITCH + tid]) - comp;
        const float t = colsum + y;
        comp = (t - colsum) - y;
        colsum = t;
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 64 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
        const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2 + (e & 1);
        if (row < job.c_rows && col < job.c_cols)
          job.out[(size_t)row * job.ldc + col] = acc[mt][nt][e];
      }
    }
  }
  if (do_colsum && n0 + tid < job.c_cols) job.colsum[n0 + tid] = colsum;
}

// grads[i] = sum over segments s = 0, 1, .. of part[s][i], in that order.
__global__ void film_siren_bwd_reduce(const float* __restrict__ part,
                                      float* __restrict__ grads, size_t size,
                                      int segments) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < size;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < segments; ++s) sum += part[(size_t)s * size + i];
    grads[i] = sum;
  }
}

}  // namespace

// Launches the kernels on `stream`; returns the first failing
// cudaGetLastError() (0 = all launched). Scratch and outputs are allocated by
// the caller: hbuf/pbuf (B, L, Np, H) bf16, xbuf/gbuf (B, Np, 16) bf16 with
// Np = N rounded up to 128; dx (B, N, 3) f32; `grads` one block of
// grads_size(B, L) floats (layout above); `part` segments x grads_size(B, L)
// floats with segments = ceil(Np / seg), seg a multiple of 32 (with one
// segment `part` may be `grads`).
extern "C" int film_siren_bwd(const float* pts, const float* g, const void* w0f,
                              const float* c, const void* wsf, const void* wsft,
                              const void* wf, void* hbuf, void* pbuf, void* xbuf,
                              void* gbuf, float* dx, float* part, float* grads, int B,
                              int N, int L, int seg, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || L < 2 || seg <= 0 || seg % WKC)
    return (int)cudaErrorInvalidValue;
  const int Np = (N + T - 1) / T * T;
  const int segments = (Np + seg - 1) / seg;
  if ((long long)segments * B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sweep_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      film_siren_bwd_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  film_siren_bwd_sweep<<<dim3((unsigned)(Np / T), (unsigned)B), THREADS, smem, s>>>(
      pts, g, static_cast<const __nv_bfloat16*>(w0f), c,
      static_cast<const __nv_bfloat16*>(wsf), static_cast<const __nv_bfloat16*>(wsft),
      static_cast<const __nv_bfloat16*>(wf), static_cast<__nv_bfloat16*>(hbuf),
      static_cast<__nv_bfloat16*>(pbuf), static_cast<__nv_bfloat16*>(xbuf),
      static_cast<__nv_bfloat16*>(gbuf), dx, N, Np, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(film_siren_bwd_wgrad,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WGRAD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  film_siren_bwd_wgrad<<<dim3(JOB_TILES, (unsigned)(L + 1), (unsigned)(segments * B)),
                         THREADS, WGRAD_SMEM_BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(hbuf), static_cast<const __nv_bfloat16*>(pbuf),
      static_cast<const __nv_bfloat16*>(xbuf), static_cast<const __nv_bfloat16*>(gbuf),
      segments == 1 ? grads : part, B, Np, L, seg);
  err = cudaGetLastError();
  if (err != cudaSuccess || segments == 1) return (int)err;
  const size_t size = grads_size(B, L);
  const size_t want = (size + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 8 ? want : 132 * 8);
  film_siren_bwd_reduce<<<blocks, 256, 0, s>>>(part, grads, size, segments);
  return (int)cudaGetLastError();
}
