// The FiLM-SIREN trunk on Hopper (sm_90a), shared by the forward kernel
// (film_siren_fwd.cu, K1) and the recompute-and-sweep kernel of the VJP
// (film_siren_bwd.cu, K2).
//
// A trunk layer is a (points x 256) . (256 x 256) product of bf16 operands
// with fp32 sums, followed by an elementwise epilogue (sin7 of the sum plus
// the folded bias in the forward; dh * cos in the backward). What a CTA does:
//   * warp roles: 384 threads. Warpgroups 0 and 1 are consumers of 64 points
//     each (a 128-point tile); warpgroup 2 is the producer, of which one
//     thread issues every load. `setmaxnreg` gives the consumers 240
//     registers and the producer 24;
//   * the weight ring: NS stages of one chunk each (4 in K1, 3 in the sweep),
//     a chunk being 64 K-rows x 256 units of bf16 (32 KB) in the 128-byte
//     swizzle that wgmma's descriptors read. The producer TMA-loads chunk
//     after chunk, in the order the consumers read them, across layer and
//     tile boundaries. Each stage has a full barrier (the TMA's byte count)
//     and an empty barrier (one arrive from each of the 8 consumer warps);
//   * the products: wgmma.mma_async m64n256k16, B the chunk in shared memory
//     (K-major: the weights are stored with the K axis contiguous), fp32
//     accumulators in registers (128 per thread). A is h: in K1 it stays in
//     registers (a thread's accumulator fragment of layer l, after its
//     epilogue and a pack to bf16 pairs, is exactly its A fragment of layer
//     l+1), so h never touches shared memory; the sweep stages h through
//     shared memory anyway for its scratch stores, and reads A from there;
//   * no __syncthreads() after set-up: consumers wait only on full barriers
//     and release stages with arrives, and the two consumer warpgroups take
//     turns at issuing their products, handed over by two more mbarriers
//     (named barriers cost the consumers their extra registers: ptxas then
//     ignores setmaxnreg), so one warpgroup's epilogue overlaps the other's
//     products;
//   * the waits are PTX loops, as CUTLASS writes them: a C++ loop around
//     try_wait made ptxas serialise the consumers' wgmmas (C7520), which
//     slowed K1. Only the producer's waits trap after a poll limit;
//   * a persistent grid: one CTA per SM walks over (batch element, tile)
//     items.
// The kernels define the layers around the trunk: layer 0 (FMA units at 3
// input features, a 2-k-step product at 32), the head, and the VJP's sweep.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace film_trunk {

constexpr int H = 256;                     // hidden width
constexpr int COUT = 4;                    // rgb + sigma
constexpr int KC = 64;                     // K rows per weight chunk (128 bytes of bf16)
constexpr int CHUNKS_PER_LAYER = H / KC;   // 4
constexpr int CHUNK_BYTES = KC * H * 2;    // 32 KB
constexpr int NSTAGE = 4;                  // K1's weight ring depth
constexpr int WG_POINTS = 64;              // points per consumer warpgroup
constexpr int TILE = 2 * WG_POINTS;        // points per CTA tile
constexpr int THREADS = 384;               // 2 consumer warpgroups + 1 producer
constexpr int PRODUCER_WG = 2;
constexpr int ACC = WG_POINTS * H / 128;   // fp32 accumulators per consumer thread
constexpr int HREGS = ACC / 2;             // bf16x2 registers of one layer's h
constexpr int MAX_LAYERS = 8;

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

// x - rint(x / 2pi) 2pi without FMA contraction, as the torch version
// computes it. rint by the 1.5 x 2^23 shift: two adds on the FP32 pipes give
// the same round-half-even result as rintf (FRND, a conversion-rate
// instruction) for |x / 2pi| < 2^22, far beyond any activation here.
__device__ __forceinline__ float reduce_range(float x) {
  constexpr float SHIFT = 12582912.0f;  // 1.5 x 2^23
  const float k = __fsub_rn(__fadd_rn(__fmul_rn(x, INV_TWO_PI), SHIFT), SHIFT);
  return __fsub_rn(x, __fmul_rn(k, TWO_PI));
}

__device__ __forceinline__ float sin7(float x) {
  const float r = reduce_range(x);
  const float r2 = r * r;
  return r * (S1 + r2 * (S3 + r2 * (S5 + r2 * S7)));
}

// sin7(x) and cos7(x) = sin7'(x), sharing the range reduction
__device__ __forceinline__ void sincos7(float x, float& s, float& c) {
  const float r = reduce_range(x);
  const float r2 = r * r;
  s = r * (S1 + r2 * (S3 + r2 * (S5 + r2 * S7)));
  c = S1 + r2 * (C3 + r2 * (C5 + r2 * C7));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// two consecutive bf16 of global memory as floats
__device__ __forceinline__ float2 ldg_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA, named barriers, register reallocation ----------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Waits for the phase of parity `parity` to complete. The loop is PTX, as
// CUTLASS writes it: a C++ loop around try_wait (or a trap on a poll count
// inside the PTX) made ptxas serialise the wgmmas around the consumers' waits
// (C7520).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// The producer's wait: after 2^26 polls (seconds, far beyond any real wait)
// it traps. A lost arrival anywhere in a kernel stalls its producer too, so
// the launch then fails instead of hanging the card; the producer issues no
// wgmma, so the trap costs the consumers nothing.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// box {c0 (inner), c1 (row)} of a 2-D tensor map into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the async MMA
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Descriptor of a K-major bf16 operand in the 128-byte swizzle: rows of 64
// K-values (128 bytes), 8-row groups 1024 bytes apart (SBO), the base at a
// 1024-byte boundary. A k-step of 16 values advances the start by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor of an MN-major (transposed) bf16 operand in the 128-byte
// swizzle, as a TMA box of 64 MN-columns (128 bytes) by K rows lays it out:
// 8-row K groups 1024 bytes apart (SBO), 64-column blocks `lbo` bytes apart
// (LBO). A k-step of 16 rows advances the start by 2048 bytes.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the 128 fp32 accumulator registers of an m64n256 wgmma, as asm operands
#define FT_ACC_REGS                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "     \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "     \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "     \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "     \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "     \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "       \
  "%123, %124, %125, %126, %127}"
#define FT_ACC_OPERANDS(d)                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),      \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),      \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),      \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),      \
      "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),      \
      "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),      \
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),      \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),      \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),      \
      "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),   \
      "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),              \
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]),              \
      "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]),              \
      "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]),              \
      "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 256, fp32) (+)= a (64 x 16, bf16 registers) . b (16 x 256, bf16
// shared memory, K-major); scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[ACC], uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " FT_ACC_REGS ", "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : FT_ACC_OPERANDS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256, fp32) (+)= a (64 x 16) . b (16 x 256), both bf16 in shared
// memory, K-major (MN 0) or MN-major (MN 1: trans-a, trans-b); scale_d 0
// overwrites d
template <int MN>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[ACC], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " FT_ACC_REGS ", "
      "%128, %129, p, 1, 1, %131, %131;\n}\n"
      : FT_ACC_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(MN));
}

// ---- the ring ----------------------------------------------------------------

// NS stages of one chunk each
template <int NS>
struct Ring {
  uint32_t stages;  // shared address of stage 0 (1024-aligned)
  uint32_t full;    // shared address of full[0]; full[s] at full + 8 s
  uint32_t empty;   // shared address of empty[0]
  uint32_t turn;    // shared address of turn[0]: warpgroup w may issue products
  int stage = 0;
  uint32_t phase = 0;
  uint32_t turn_phase = 0;  // parity of this warpgroup's next turn

  __device__ __forceinline__ void advance() {
    if (++stage == NS) {
      stage = 0;
      phase ^= 1u;
    }
  }
  __device__ __forceinline__ uint32_t full_bar(int s) const { return full + 8u * s; }
  __device__ __forceinline__ uint32_t empty_bar(int s) const { return empty + 8u * s; }
  __device__ __forceinline__ uint32_t turn_bar(int wg) const { return turn + 8u * wg; }
};

// dynamic shared memory of an NS-stage ring: the stages at a 1024-byte
// boundary (the swizzle's period), then the full, empty and turn barriers
constexpr size_t ring_bytes(int ns) { return 1024 + (size_t)ns * CHUNK_BYTES + (2 * ns + 2) * 8; }

// Carves the ring out of dynamic shared memory; thread 0 initialises the
// barriers; every thread returns after the one set-up __syncthreads().
template <int NS>
__device__ __forceinline__ Ring<NS> ring_setup(unsigned char* smem) {
  Ring<NS> r;
  r.stages = (smem_addr(smem) + 1023u) & ~1023u;
  r.full = r.stages + NS * CHUNK_BYTES;
  r.empty = r.full + 8u * NS;
  r.turn = r.empty + 8u * NS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(r.full_bar(s), 1);   // the producer's expect_tx arrive
      mbar_init(r.empty_bar(s), 8);  // one arrive per consumer warp
    }
    mbar_init(r.turn_bar(0), 4);     // one arrive per warp of the other warpgroup
    mbar_init(r.turn_bar(1), 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // warpgroup 0 takes the first turn
  if ((threadIdx.x >> 7) == 1 && (threadIdx.x & 31) == 0) mbar_arrive(r.turn_bar(0));
  return r;
}

// Producer: the next chunk, box {c0, c1} of `map`, into the next stage.
template <int NS>
__device__ __forceinline__ void produce(Ring<NS>& r, const CUtensorMap* map, int c0, int c1) {
  mbar_wait_or_trap(r.empty_bar(r.stage), r.phase ^ 1u);
  mbar_expect_tx(r.full_bar(r.stage), CHUNK_BYTES);
  tma_load_2d(r.stages + r.stage * CHUNK_BYTES, map, c0, c1, r.full_bar(r.stage));
  r.advance();
}

// Consumer: acc = A . (the next NCHUNK chunks, KSTEPS k-steps of each), in
// this warpgroup's turn (wg 0 or 1). `issue(acc, s, desc_b, scale_d)` issues
// the product of k-step s (kc * CHUNKS_PER_LAYER + kk) against the chunk's
// descriptor. Each stage is released once the products reading it are done.
// The turn passes to the other warpgroup once the last chunk's products are
// issued or, with fewer stages than chunks, once every stage has been: the
// next chunk then waits for the other warpgroup to release a stage.
template <int NCHUNK, int KSTEPS, int NS, typename Issue>
__device__ __forceinline__ void layer_products(Ring<NS>& r, int wg, float (&acc)[ACC],
                                               const Issue& issue) {
  constexpr int kPass = (NS < NCHUNK ? NS : NCHUNK) - 1;
  const bool lane0 = (threadIdx.x & 31) == 0;
  mbar_wait(r.turn_bar(wg), r.turn_phase);
  r.turn_phase ^= 1u;
  fence_acc(acc);
  wgmma_fence();
  int prev = 0;
#pragma unroll
  for (int kc = 0; kc < NCHUNK; ++kc) {
    mbar_wait(r.full_bar(r.stage), r.phase);
    const uint64_t desc = sw128_desc(r.stages + r.stage * CHUNK_BYTES);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      issue(acc, kc * CHUNKS_PER_LAYER + kk, desc + 2 * kk, (kc | kk) ? 1 : 0);
    wgmma_commit();
    if (kc == kPass && lane0) mbar_arrive(r.turn_bar(wg ^ 1));
    if (kc > 0) {
      wgmma_wait<1>();
      if (lane0) mbar_arrive(r.empty_bar(prev));
    }
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane0) mbar_arrive(r.empty_bar(prev));
}

// The A operand of layer_products from registers: four per k-step, in k order
template <int NA>
struct RegisterA {
  const uint32_t (&a)[NA];
  __device__ __forceinline__ void operator()(float (&d)[ACC], int s, uint64_t desc_b,
                                             int scale_d) const {
    wgmma_m64n256k16(d, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3], desc_b, scale_d);
  }
};

// The A operand of layer_products from shared memory: the warpgroup's 64 rows
// x 256 K-values as 4 K-major 128-byte-swizzled blocks of 64 rows x 64
// K-values, 8 KB apart from `a` on
struct SharedA {
  uint32_t a;
  __device__ __forceinline__ void operator()(float (&d)[ACC], int s, uint64_t desc_b,
                                             int scale_d) const {
    wgmma_m64n256k16_ss<0>(d, sw128_desc(a + (s >> 2) * 8192 + (s & 3) * 32), desc_b, scale_d);
  }
};

template <int NCHUNK, int KSTEPS, int NS, int NA>
__device__ __forceinline__ void layer_mma(Ring<NS>& r, int wg, float (&acc)[ACC],
                                          const uint32_t (&a)[NA]) {
  static_assert(NA >= 4 * ((NCHUNK - 1) * CHUNKS_PER_LAYER + KSTEPS), "A fragments");
  layer_products<NCHUNK, KSTEPS>(r, wg, acc, RegisterA<NA>{a});
}

template <int NS>
__device__ __forceinline__ void layer_mma_smem(Ring<NS>& r, int wg, float (&acc)[ACC],
                                               uint32_t a) {
  layer_products<CHUNKS_PER_LAYER, CHUNKS_PER_LAYER>(r, wg, acc, SharedA{a});
}

// The fragment of a consumer thread: D element 4j + e is at point row
// `row0 + 8 (e >> 1)` of the warpgroup's 64 and unit `8 j + 2 (lane & 3) +
// (e & 1)`; A register t of the next layer packs D elements 2t and 2t + 1.
struct Frag {
  int wg;    // consumer warpgroup, 0 or 1
  int row0;  // 16 (warp in warpgroup) + lane / 4
  int q;     // lane & 3
  __device__ __forceinline__ Frag() {
    wg = threadIdx.x >> 7;
    row0 = 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
    q = threadIdx.x & 3;
  }
  __device__ __forceinline__ int col(int j) const { return 8 * j + 2 * q; }
};

// sum over the 4 threads of a quad (they hold the same rows)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- host ----------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The tensor map of a row-major bf16 matrix (rows x cols, cols contiguous)
// read in boxes of 64 columns x `box_rows` rows in the 128-byte swizzle;
// columns past `cols` read as zeros. The encoder, a libcuda function, is
// reached through the runtime (cudaGetDriverEntryPoint), so the library links
// no libcuda.
inline int tensor_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                      uint32_t box_rows) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {KC, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the trunk weights' map: chunks of 64 K-rows (columns) x 256 units (rows)
inline int weight_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols) {
  return tensor_map(map, base, rows, cols, H);
}

// CTAs of a persistent launch over `items` work items: one per SM at most
inline int persistent_grid(int items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *grid = items < sms ? items : sms;
  return 0;
}

}  // namespace film_trunk
