// Fused FiLM-SIREN forward for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ops/kernels/build.py and ops/kernels/film_siren.py).
//
// Replaces conditioned_nerf_gan_tpu/ops/pallas/film_siren.py::_kernel (the
// Pallas forward launched by _forward_pallas). It computes exactly that
// kernel's math on freq-folded weights (the fold stays in torch):
//     x   = bf16(points)                                    (B, N, DIN)
//     h_0 = sin7(x . W0f[b] + c[b,0])                       fp32 accumulation
//     h_l = sin7(bf16(h_{l-1}) . Wsf[b,l-1] + c[b,l])       bf16 operands
//     out = bf16(h_{L-1}) . bf16(Wf) + bf                   (B, N, 4) fp32
// Two instances: DIN = 3 (xyz points, the SHORTSIREN family) and DIN = 32
// (trilinearly sampled U-Net features, the voxel-conditioned FG family);
// L from 2 to 8 layers of 256 units.
//
// What bounds it: per point, (L-1) x 256 x 256 x 2 + small FLOP (0.4 MFLOP at
// L = 4, 0.94 MFLOP at DIN = 32, L = 8) against 16 + 4 DIN bytes of device
// I/O, so it is compute-bound: the tensor cores, and the sin7 epilogues
// between the products. The plain torch version writes and reads the
// (N, 256) activations in device memory for every layer (~1 KB per point
// per layer in fp32).
//
// What the design does about it: one CTA takes one batch element x T = 128
// points and keeps that tile's activations in shared memory as bf16 for the
// whole chain, so nothing but points in and 4 channels out touches device
// memory per point.
//   * layers 1..L-1 are 128 x 256 x 256 bf16 products on the tensor cores
//     (mma.sync m16n8k16, fp32 accumulators). 8 warps tile the output
//     2 (points) x 4 (units); each warp holds a 64 x 64 fp32 accumulator
//     block in registers, so the whole layer output lives in registers and
//     the epilogue can overwrite h in place (one h buffer, not two);
//   * layer 0 at DIN = 3 (K = 3) runs on the FMA units. At DIN = 32 it is
//     one more 32-row chunk of the same tensor-core loop: x is rounded to
//     bf16 into the first 32 columns of the h buffer, W0f streams as the
//     first chunk of the weight ring, and its epilogue writes h_0 over x.
//     On the FMA units it would be 8,192 MACs per point, each reading two
//     shared-memory operands; on the tensor cores it is two k-steps;
//   * the 256 -> 4 head runs on the FMA units;
//   * the folded weights stream from global/L2 through a 3-stage cp.async
//     ring of 32-row K chunks; the stream runs across layer boundaries;
//   * rows are padded to 264 bf16 so ldmatrix reads are bank-conflict free;
//   * the ragged tail of N is zero-filled on load and masked on store.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int H = 256;        // hidden width
constexpr int COUT = 4;       // rgb + sigma
constexpr int T = 128;        // points per CTA
constexpr int KC = 32;        // weight rows per pipeline chunk
constexpr int NSTAGE = 3;     // cp.async ring depth
constexpr int PITCH = H + 8;  // shared-memory row pitch in bf16
constexpr int THREADS = 256;  // 8 warps: 2 along points x 4 along units
constexpr int CHUNKS_PER_LAYER = H / KC;
constexpr int MAX_LAYERS = 8;

constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float INV_TWO_PI = 0.15915494309189533577f;
constexpr float S1 = 9.9926289884e-01f;
constexpr float S3 = -1.6565644419e-01f;
constexpr float S5 = 7.9559223702e-03f;
constexpr float S7 = -1.4495299408e-04f;

// layer 0 on the FMA units (K = 3), or as W0_CHUNKS chunks of the ring
template <int DIN>
struct Layer0 {
  static_assert(DIN == 3 || DIN % KC == 0, "DIN is 3 or a multiple of 32");
  static constexpr bool kFma = DIN == 3;
  static constexpr int kChunks = kFma ? 0 : DIN / KC;
  // fp32 shared memory besides sC and sWF: sW0 (DIN x H) and sX (T x DIN)
  static constexpr int kFmaFloats = kFma ? DIN * H + T * DIN : 0;
};

__device__ __forceinline__ float sin7(float x) {
  // range reduction without FMA contraction, as the torch version computes it
  const float r = __fsub_rn(x, __fmul_rn(rintf(__fmul_rn(x, INV_TWO_PI)), TWO_PI));
  const float r2 = r * r;
  return r * (S1 + r2 * (S3 + r2 * (S5 + r2 * S7)));
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

template <int DIN>
size_t smem_bytes(int L) {
  return sizeof(__nv_bfloat16) * (size_t)(T * PITCH + NSTAGE * KC * PITCH) +
         sizeof(float) * (size_t)(L * H + H * COUT + Layer0<DIN>::kFmaFloats);
}

// pts (B, N, DIN) f32; w0f (B, DIN, H) bf16; c (B, L, H) f32 (c_0 then
// c_1..); wsf (B, L-1, H, H) bf16 as [k][n]; wf (H, 4) bf16; bf (4) f32;
// out (B, N, 4) f32. Grid: (ceil(N / T), B).
template <int DIN>
__global__ void __launch_bounds__(THREADS, 1)
film_siren_fwd_kernel(const float* __restrict__ pts,
                      const __nv_bfloat16* __restrict__ w0f,
                      const float* __restrict__ c,
                      const __nv_bfloat16* __restrict__ wsf,
                      const __nv_bfloat16* __restrict__ wf,
                      const float* __restrict__ bf,
                      float* __restrict__ out, int N, int L) {
  using L0 = Layer0<DIN>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sH = reinterpret_cast<__nv_bfloat16*>(smem);  // T x PITCH
  __nv_bfloat16* sW = sH + T * PITCH;                           // NSTAGE x KC x PITCH
  float* sC = reinterpret_cast<float*>(sW + NSTAGE * KC * PITCH);  // L x H
  float* sWF = sC + L * H;                                      // H x COUT
  float* sW0 = sWF + H * COUT;                                  // DIN x H (FMA layer 0)
  float* sX = sW0 + DIN * H;                                    // T x DIN (FMA layer 0)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * T;
  const int valid = min(T, N - p0);
  const __nv_bfloat16* w0b = w0f + (size_t)b * DIN * H;
  const __nv_bfloat16* wb = wsf + (size_t)b * (L - 1) * H * H;
  const int nchunks = L0::kChunks + (L - 1) * CHUNKS_PER_LAYER;

  // chunk g: rows [g*KC, (g+1)*KC) of W0f's DIN rows (tensor-core layer 0)
  // followed by the (L-1)*H stacked trunk weight rows
  auto load_chunk = [&](int g) {
    const __nv_bfloat16* src = g < L0::kChunks
        ? w0b + (size_t)g * KC * H
        : wb + (size_t)(g - L0::kChunks) * KC * H;
    __nv_bfloat16* dst = sW + (g % NSTAGE) * KC * PITCH;
#pragma unroll
    for (int i = 0; i < (KC * H / 8) / THREADS; ++i) {
      const int s = tid + i * THREADS;
      const int row = s / (H / 8);
      const int col = (s % (H / 8)) * 8;
      cp_async16(dst + row * PITCH + col, src + (size_t)row * H + col);
    }
  };

  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nchunks) load_chunk(s);
    cp_async_commit();
  }

  for (int i = tid; i < L * H; i += THREADS) sC[i] = c[(size_t)b * L * H + i];
  for (int i = tid; i < H * COUT; i += THREADS) sWF[i] = __bfloat162float(wf[i]);
  const float* xb = pts + ((size_t)b * N + p0) * DIN;
  if constexpr (L0::kFma) {
    for (int i = tid; i < DIN * H; i += THREADS) sW0[i] = __bfloat162float(w0b[i]);
    for (int i = tid; i < T * DIN; i += THREADS) {
      const float v = i < valid * DIN ? xb[i] : 0.f;
      sX[i] = __bfloat162float(__float2bfloat16(v));
    }
    __syncthreads();

    // layer 0 on the FMA units (K = 3)
    for (int i = tid; i < T * H / 2; i += THREADS) {
      const int p = i / (H / 2);
      const int n = (i % (H / 2)) * 2;
      const float x0 = sX[p * DIN], x1 = sX[p * DIN + 1], x2 = sX[p * DIN + 2];
      const float v0 = x0 * sW0[n] + x1 * sW0[H + n] + x2 * sW0[2 * H + n] + sC[n];
      const float v1 = x0 * sW0[n + 1] + x1 * sW0[H + n + 1] + x2 * sW0[2 * H + n + 1] +
                       sC[n + 1];
      *reinterpret_cast<__nv_bfloat162*>(sH + p * PITCH + n) =
          __floats2bfloat162_rn(sin7(v0), sin7(v1));
    }
  } else {
    // x as bf16 into the first DIN columns of h: the A operand of layer 0
    for (int i = tid; i < T * DIN / 2; i += THREADS) {
      const int p = i / (DIN / 2);
      const int k = (i % (DIN / 2)) * 2;
      float2 v = make_float2(0.f, 0.f);
      if (p < valid) v = make_float2(xb[p * DIN + k], xb[p * DIN + k + 1]);
      *reinterpret_cast<__nv_bfloat162*>(sH + p * PITCH + k) =
          __floats2bfloat162_rn(v.x, v.y);
    }
  }

  // the chunked products on the tensor cores: layer 0 at DIN = 32, then
  // layers 1..L-1
  const int wm = warp >> 2;  // rows wm*64 .. +64
  const int wn = warp & 3;   // units wn*64 .. +64
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

  for (int g = 0; g < nchunks; ++g) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk g landed, h is complete, stage (g-1) is free
    if (g + NSTAGE - 1 < nchunks) load_chunk(g + NSTAGE - 1);
    cp_async_commit();

    // layer of chunk g and the chunk's K offset within that layer
    const bool first = g < L0::kChunks;
    const int t = g - L0::kChunks;
    const int layer = first ? 0 : 1 + t / CHUNKS_PER_LAYER;
    const int kc = first ? g : t % CHUNKS_PER_LAYER;
    const bool last = first ? g == L0::kChunks - 1 : kc == CHUNKS_PER_LAYER - 1;
    const uint32_t w_stage = sW_base + (uint32_t)((g % NSTAGE) * KC * PITCH * 2);
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

    if (last) {
      // layer done: h = bf16(sin7(acc + c_l)), written over the old h (or x)
      const float* cl = sC + layer * H;
      __syncthreads();  // every warp has finished reading the old h
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r0 = wm * 64 + mt * 16 + (lane >> 2);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = wn * 64 + nt * 8 + (lane & 3) * 2;
          const float c0 = cl[col], c1 = cl[col + 1];
          float* d = acc[mt][nt];
          *reinterpret_cast<__nv_bfloat162*>(sH + r0 * PITCH + col) =
              __floats2bfloat162_rn(sin7(d[0] + c0), sin7(d[1] + c1));
          *reinterpret_cast<__nv_bfloat162*>(sH + (r0 + 8) * PITCH + col) =
              __floats2bfloat162_rn(sin7(d[2] + c0), sin7(d[3] + c1));
          d[0] = d[1] = d[2] = d[3] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // head on the FMA units: out = h . Wf + bf; two threads per point split K
  {
    const int p = tid >> 1;
    const int half = tid & 1;
    const __nv_bfloat162* hrow = reinterpret_cast<const __nv_bfloat162*>(sH + p * PITCH);
    const float4* wf4 = reinterpret_cast<const float4*>(sWF);
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll 8
    for (int j = half; j < H / 2; j += 2) {
      const float2 hv = __bfloat1622float2(hrow[j]);
      const float4 wa = wf4[2 * j];
      const float4 wc = wf4[2 * j + 1];
      o0 += hv.x * wa.x + hv.y * wc.x;
      o1 += hv.x * wa.y + hv.y * wc.y;
      o2 += hv.x * wa.z + hv.y * wc.z;
      o3 += hv.x * wa.w + hv.y * wc.w;
    }
    o0 += __shfl_xor_sync(0xffffffffu, o0, 1);
    o1 += __shfl_xor_sync(0xffffffffu, o1, 1);
    o2 += __shfl_xor_sync(0xffffffffu, o2, 1);
    o3 += __shfl_xor_sync(0xffffffffu, o3, 1);
    if (half == 0 && p < valid) {
      *reinterpret_cast<float4*>(out + ((size_t)b * N + p0 + p) * COUT) =
          make_float4(o0 + bf[0], o1 + bf[1], o2 + bf[2], o3 + bf[3]);
    }
  }
}

template <int DIN>
int launch(const float* pts, const void* w0f, const float* c, const void* wsf,
           const void* wf, const float* bf, float* out, int B, int N, int L,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DIN>(L);
  cudaError_t err = cudaFuncSetAttribute(
      film_siren_fwd_kernel<DIN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + T - 1) / T), (unsigned)B);
  film_siren_fwd_kernel<DIN><<<grid, THREADS, smem, stream>>>(
      pts, static_cast<const __nv_bfloat16*>(w0f), c,
      static_cast<const __nv_bfloat16*>(wsf), static_cast<const __nv_bfloat16*>(wf),
      bf, out, N, L);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the DIN = din instance (3 or 32) on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int film_siren_fwd(const float* pts, const void* w0f, const float* c,
                              const void* wsf, const void* wf, const float* bf,
                              float* out, int B, int N, int L, int din, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || L < 2 || L > MAX_LAYERS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (din == 3) return launch<3>(pts, w0f, c, wsf, wf, bf, out, B, N, L, s);
  if (din == 32) return launch<32>(pts, w0f, c, wsf, wf, bf, out, B, N, L, s);
  return (int)cudaErrorInvalidValue;
}
