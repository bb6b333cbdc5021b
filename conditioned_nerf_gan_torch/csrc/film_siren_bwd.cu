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
// with bf16 operands and fp32 sums throughout. Points of 3 features only.
//
// What bounds it: the recompute and the sweep are 2 x (L-1) x 256 x 256 x 2
// FLOP per point on the tensor cores, the weight grads another (L-1) x 256 x
// 256 x 2 summed over every point of a batch element; and the bf16 scratch
// below: at L = 4, 2 KB of h_l and 2 KB of dpre_l written per point and read
// back once (the cos_l round trip between the sweep's two halves mostly stays
// in L2), ~1.4 ms of HBM traffic at 12 x 49,152 points, twice the products.
//
// What the design does about it. The TPU kernel keeps h_l and cos_l of a
// 2048-point tile resident (~4 MB of VMEM) and sums the weight grads by
// revisiting one output block in grid order. Neither carries over: 4 layers x
// 256 x 2 bf16 tensors are 4 KB per point, and CTAs run in parallel and in no
// order. So the VJP is three kernels:
//   (a) film_siren_bwd_sweep, on the trunk of film_siren_trunk.cuh (wgmma, a
//       TMA weight ring under mbarriers, a producer warpgroup and two
//       consumer warpgroups taking turns, a persistent grid over 128-point
//       tiles). The ring runs on from the forward chunks (Wsf^T, K-major)
//       into the backward ones (Wsf itself is K-major for dh = dpre . W^T).
//       Each epilogue stages its bf16 result in shared memory (stmatrix);
//       TMA bulk stores write it to the scratch while the next layer's
//       products run, and the same buffer is their A operand, read through a
//       descriptor: h needs
//       no registers during the products, and the sweep does not spill (with
//       A in registers it spilled, and with ~200 KB of shared memory beside
//       them the spills miss L1). The forward epilogues
//       take sin7 and cos7 from one range reduction and store h_l and cos_l;
//       the last keeps cos in its buffer, and dpre_{L-1} = bf16(gb . Wf^T *
//       cos) comes from g and Wf on the FMA units; each backward epilogue
//       reads cos_l back (cp.async, while the products run) and stores dpre_l
//       over it. dX comes from dpre_0 on the FMA units. It also writes the
//       bf16 points and cotangent as one 64-column row per point (x in
//       columns 0-2, g in 3-6). Scratch: 4 KB + 128 bytes per point. What
//       set its pace was its code: one loop holds every layer's epilogue and
//       the next layer's products, once each; with the layers unrolled the
//       sweep ran at the rate its instructions were fetched, far below the
//       FP32 rate in the epilogues, and took about twice as long;
//   (b) film_siren_bwd_wgrad, persistent and warp-specialised like the trunk:
//       a work item is one (segment of points, batch element, 128-row tile of
//       one weight grad). The producer TMA-loads 64-point chunks of both
//       operands (point-major in memory, so wgmma reads both MN-major) into a
//       4-stage mbarrier ring; two consumer warpgroups run wgmma
//       m64n256k16 over them, 64 rows each, and sum the columns for dc from
//       the same shared-memory chunk (16-byte loads of 8 columns, plain sums
//       within a chunk, Kahan-compensated across chunks, the 8 warps' sums
//       added in warp order). dW0f and dWf are 64-row tiles over the
//       point/cotangent rows: x^T dpre_0 (rows 0-2) and gb^T h_{L-1} (rows
//       3-6, stored transposed); dbf sums columns 3-6;
//   (c) film_siren_bwd_reduce sums the segments' partials in segment order.
//       No atomics: every sum runs in the same order in every launch, so the
//       grads are bitwise deterministic from run to run.

#include "film_siren_trunk.cuh"

namespace {

using namespace film_trunk;

constexpr int DIN = 3;      // xyz
constexpr int XG_COLS = 64; // columns of the point/cotangent scratch (one 128-byte row)
constexpr int XG_G = 3;     // its first cotangent column

// ---- the sweep -----------------------------------------------------------------

constexpr int SWEEP_STAGES = 3;  // the ring's depth, to leave room for the buffers
constexpr int BLOCK = 64 * 128;  // 64 rows x 64 bf16 in the 128-byte swizzle
constexpr int WG_BUF = 4 * BLOCK;  // a warpgroup's 64 rows x 256
// the ring, two warpgroup barriers, then (1024-aligned) the A buffers of both
// warpgroups and their cos buffers
constexpr size_t SWEEP_SMEM_BYTES = ring_bytes(SWEEP_STAGES) + 16 + 1024 + 4 * (size_t)WG_BUF;

// A warp's 16 rows of a warpgroup buffer (64 rows x 256 bf16 as 4 blocks of
// 64 rows x 64, each K-major in the 128-byte swizzle: 16-byte chunk c of row
// r sits in block c / 8 at row r, chunk (c % 8) ^ (r % 8), which is also
// the layout of a TMA box of 16 rows x 64 columns). The A buffer is both
// the next product's A operand (wgmma reads it through a descriptor) and the
// source of its scratch stores; stmatrix/ldmatrix and the cp.async loads (16
// bytes a lane, a 512-byte row a warp instruction) are free of bank
// conflicts.
struct Staging {
  uint32_t base;  // this warp's row 0
  int lane;
  __device__ __forceinline__ uint32_t at(int row, int chunk) const {
    return base + (chunk >> 3) * BLOCK + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
  }
  // this lane's stmatrix/ldmatrix address for the x4 group of fragment
  // registers 2j .. 2j+3: matrices (rows 0-7 | 8-15) x (chunk j | j+1)
  __device__ __forceinline__ uint32_t frag(int j) const {
    const int m = lane >> 3;
    return at((lane & 7) + 8 * (m & 1), j + (m >> 1));
  }
};

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1,
                                            uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// the warp's rows -> rows row .. row + 15 of the scratch that `map` reads:
// four TMA bulk stores (16 rows x 64 columns each) issued by one lane, which
// read the buffer while the next layer's products run
__device__ __forceinline__ void store_rows(const Staging& st, const CUtensorMap* map, int row) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (st.lane == 0) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      asm volatile(
          "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n"
          :: "l"(reinterpret_cast<uint64_t>(map)), "r"(64 * s), "r"(row),
             "r"(st.base + s * BLOCK)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// Before the warp writes its rows of a buffer again: its stores have read
// them (they have had a layer's products to do so).
__device__ __forceinline__ void stores_read(const Staging& st) {
  if (st.lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  __syncwarp();
}

// The warp's stores but the newest `keep` groups are done in device memory
// and visible to its own loads.
template <int KEEP>
__device__ __forceinline__ void stores_done(const Staging& st) {
  if (st.lane == 0) asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(KEEP) : "memory");
  __syncwarp();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// rows 0..15 at src (pitch H) -> the warp's rows, asynchronously
__device__ __forceinline__ void load_rows_async(const Staging& st, const __nv_bfloat16* src) {
#pragma unroll
  for (int r = 0; r < 16; ++r)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(st.at(r, st.lane)), "l"(src + r * H + st.lane * 8) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The warpgroup's A buffer is written and visible to wgmma: each warp fences
// its stmatrix writes to the async proxy and arrives; all wait.
__device__ __forceinline__ void wg_sync(uint32_t bar, uint32_t& phase) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
  mbar_wait(bar, phase);
  phase ^= 1u;
}

// The epilogue of a hidden forward layer: pre = acc + c_l; bf16(sin7(pre))
// into the A buffer (the next layer's A operand) and bf16(cos7(pre)) into the
// cos buffer, pair by pair; then both to row `row` of the scratch: cos (if
// store_cos) to pmap's, h to hmap's.
__device__ __forceinline__ void hidden_epilogue(const float (&acc)[ACC], const float* cl,
                                                const Frag& f, const Staging& sa,
                                                const Staging& sc, const CUtensorMap* pmap,
                                                const CUtensorMap* hmap, int row,
                                                bool store_cos) {
  stores_read(sa);
#pragma unroll
  for (int j = 0; j < ACC / 4; j += 2) {
    uint32_t hv[4], cv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {  // fragment register 2j + m: D elements 4j + 2m, +1
      const float2 cc = __ldg(reinterpret_cast<const float2*>(cl + f.col(j + (m >> 1))));
      float s0, c0, s1, c1;
      sincos7(acc[4 * j + 2 * m] + cc.x, s0, c0);
      sincos7(acc[4 * j + 2 * m + 1] + cc.y, s1, c1);
      hv[m] = pack_bf16(s0, s1);
      cv[m] = pack_bf16(c0, c1);
    }
    stmatrix_x4(sa.frag(j), hv[0], hv[1], hv[2], hv[3]);
    stmatrix_x4(sc.frag(j), cv[0], cv[1], cv[2], cv[3]);
  }
  if (store_cos) store_rows(sc, pmap, row);
  store_rows(sa, hmap, row);
}

// pts (B, N, 3) f32; g (B, N, 4) f32; w0f (B, 3, H) bf16; c (B, L, H) f32;
// wf (H, 4) bf16. tmap reads Wsf^T and wmap Wsf, each as ((B (L-1) H) x H).
// Writes hbuf/pbuf (B, L, Np, H) bf16 (h_l; dpre_l) through hmap/pmap (each
// ((B L Np) x H) in boxes of 16 rows x 64 columns) and reads cos_l back from
// pbuf; writes xg (B, Np, 64) bf16 and dx (B, N, 3) f32. Np = tiles x TILE.
__global__ void __launch_bounds__(THREADS, 1)
film_siren_bwd_sweep(const __grid_constant__ CUtensorMap tmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap hmap,
                     const __grid_constant__ CUtensorMap pmap,
                     const float* __restrict__ pts, const float* __restrict__ g,
                     const __nv_bfloat16* __restrict__ w0f, const float* __restrict__ c,
                     const __nv_bfloat16* __restrict__ wf,
                     const __nv_bfloat16* __restrict__ pbuf, __nv_bfloat16* __restrict__ xg,
                     float* __restrict__ dx, int B, int N, int L, int tiles) {
  extern __shared__ unsigned char smem[];
  Ring<SWEEP_STAGES> ring = ring_setup<SWEEP_STAGES>(smem);
  const uint32_t wg_bars = ring.turn + 16;  // one per consumer warpgroup
  const uint32_t bufs = (wg_bars + 16 + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    mbar_init(wg_bars, 4);  // one arrive per warp of the warpgroup
    mbar_init(wg_bars + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int items = B * tiles;
  const int Np = tiles * TILE;
  const int layer_chunks = (L - 1) * CHUNKS_PER_LAYER;

  if ((threadIdx.x >> 7) == PRODUCER_WG) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == PRODUCER_WG * 128) {
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / tiles;
        for (int q = 0; q < layer_chunks; ++q)  // forward: Wsf[b, 0..L-2]^T
          produce(ring, &tmap, (q % CHUNKS_PER_LAYER) * KC,
                  (b * (L - 1) + q / CHUNKS_PER_LAYER) * H);
        for (int q = 0; q < layer_chunks; ++q)  // backward: Wsf[b, L-2..0]
          produce(ring, &wmap, (q % CHUNKS_PER_LAYER) * KC,
                  (b * (L - 1) + L - 2 - q / CHUNKS_PER_LAYER) * H);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const Frag f;
    const uint32_t a_buf = bufs + f.wg * WG_BUF;  // this warpgroup's A operand
    const uint32_t warp_rows = ((threadIdx.x >> 5) & 3) * 16 * 128;
    const Staging sa{a_buf + warp_rows, (int)(threadIdx.x & 31)};
    const Staging sc{bufs + (2 + f.wg) * WG_BUF + warp_rows, (int)(threadIdx.x & 31)};
    const uint32_t wg_bar = wg_bars + 8u * f.wg;
    uint32_t wg_phase = 0;
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int b = item / tiles;
      const int pa = (item % tiles) * TILE + f.wg * WG_POINTS + f.row0;  // rows pa, pb
      const int pb = pa + 8;
      const int prow = pa - (f.row0 & 15);  // this warp's row 0
      const float* cb = c + (size_t)b * L * H;
      const __nv_bfloat16* w0b = w0f + (size_t)b * DIN * H;
      // this warp's first row of a scratch layer
      auto row_of = [&](int layer) { return (b * L + layer) * Np + prow; };

      float xa[DIN], xb[DIN];
#pragma unroll
      for (int i = 0; i < DIN; ++i) {
        xa[i] = pa < N ? bf16_round(pts[((size_t)b * N + pa) * DIN + i]) : 0.f;
        xb[i] = pb < N ? bf16_round(pts[((size_t)b * N + pb) * DIN + i]) : 0.f;
      }
      {
        // the xg rows of points pa and pb: lane q of the quad writes 32 bytes
        // (16 columns) q of each; columns 0-2 are x, 3-6 g, the rest zeros
        uint4 ra[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
        uint4 rb[2] = {ra[0], ra[1]};
        if (f.q == 0) {
          float ga[COUT], gb[COUT];
#pragma unroll
          for (int o = 0; o < COUT; ++o) {
            ga[o] = pa < N ? g[((size_t)b * N + pa) * COUT + o] : 0.f;
            gb[o] = pb < N ? g[((size_t)b * N + pb) * COUT + o] : 0.f;
          }
          ra[0] = make_uint4(pack_bf16(xa[0], xa[1]), pack_bf16(xa[2], ga[0]),
                             pack_bf16(ga[1], ga[2]), pack_bf16(ga[3], 0.f));
          rb[0] = make_uint4(pack_bf16(xb[0], xb[1]), pack_bf16(xb[2], gb[0]),
                             pack_bf16(gb[1], gb[2]), pack_bf16(gb[3], 0.f));
        }
        uint4* da = reinterpret_cast<uint4*>(xg + ((size_t)b * Np + pa) * XG_COLS) + 2 * f.q;
        uint4* db = reinterpret_cast<uint4*>(xg + ((size_t)b * Np + pb) * XG_COLS) + 2 * f.q;
        da[0] = ra[0];
        da[1] = ra[1];
        db[0] = rb[0];
        db[1] = rb[1];
      }

      // layer 0 on the FMA units (x . W0f; the epilogue adds c_0)
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const int n = f.col(j);
        const float2 w_0 = ldg_bf16x2(w0b + n);
        const float2 w_1 = ldg_bf16x2(w0b + H + n);
        const float2 w_2 = ldg_bf16x2(w0b + 2 * H + n);
        acc[4 * j] = xa[0] * w_0.x + xa[1] * w_1.x + xa[2] * w_2.x;
        acc[4 * j + 1] = xa[0] * w_0.y + xa[1] * w_1.y + xa[2] * w_2.y;
        acc[4 * j + 2] = xb[0] * w_0.x + xb[1] * w_1.x + xb[2] * w_2.x;
        acc[4 * j + 3] = xb[0] * w_0.y + xb[1] * w_1.y + xb[2] * w_2.y;
      }
      // each layer's epilogue, then the next layer's products: one copy of
      // each in the code (unrolled, the kernel would be far larger than the
      // instruction cache, and it runs at the rate its code is fetched). The
      // last layer's cos7(pre) is not stored but kept in the cos buffer.
#pragma unroll 1
      for (int l = 0;; ++l) {
        const bool last = l == L - 1;
        hidden_epilogue(acc, cb + l * H, f, sa, sc, &pmap, &hmap, row_of(l), !last);
        if (last) break;
        wg_sync(wg_bar, wg_phase);
        layer_mma_smem(ring, f.wg, acc, a_buf);
      }

      // dpre_{L-1} = bf16(gb . Wf^T * bf16(cos7(pre_{L-1}))) into the A buffer
      // and stored
      {
        float ga[COUT], gb[COUT];  // gb = bf16(g) of rows pa, pb
#pragma unroll
        for (int o = 0; o < COUT; ++o) {
          ga[o] = pa < N ? bf16_round(g[((size_t)b * N + pa) * COUT + o]) : 0.f;
          gb[o] = pb < N ? bf16_round(g[((size_t)b * N + pb) * COUT + o]) : 0.f;
        }
        stores_read(sa);
#pragma unroll
        for (int j = 0; j < ACC / 4; j += 2) {
          uint32_t cv[4], dv[4];
          ldmatrix_x4(cv, sc.frag(j));
#pragma unroll
          for (int m = 0; m < 4; ++m) {  // row pa for even m, pb for odd
            // Wf rows n, n + 1: 8 bf16
            const int n = f.col(j + (m >> 1));
            const uint4 w = __ldg(reinterpret_cast<const uint4*>(wf + n * COUT));
            const float2 w01 = unpack_bf16(w.x), w23 = unpack_bf16(w.y);
            const float2 v01 = unpack_bf16(w.z), v23 = unpack_bf16(w.w);
            const float g0 = (m & 1) ? gb[0] : ga[0], g1 = (m & 1) ? gb[1] : ga[1];
            const float g2 = (m & 1) ? gb[2] : ga[2], g3 = (m & 1) ? gb[3] : ga[3];
            const float d0 = g0 * w01.x + g1 * w01.y + g2 * w23.x + g3 * w23.y;
            const float d1 = g0 * v01.x + g1 * v01.y + g2 * v23.x + g3 * v23.y;
            const float2 cm = unpack_bf16(cv[m]);
            dv[m] = pack_bf16(d0 * cm.x, d1 * cm.y);
          }
          stmatrix_x4(sa.frag(j), dv[0], dv[1], dv[2], dv[3]);
        }
        store_rows(sa, &pmap, row_of(L - 1));
        wg_sync(wg_bar, wg_phase);
      }
      // the cos_l stores are done (all but h_{L-1} and dpre_{L-1}'s): read below
      stores_done<2>(sa);

      // backward layers: dpre_{l-1} = bf16(dpre_l . Wsf[b,l-1]^T * cos_{l-1});
      // cos_{l-1} comes into the cos buffer while the products run
#pragma unroll 1
      for (int l = L - 1; l >= 1; --l) {
        load_rows_async(sc, pbuf + (size_t)row_of(l - 1) * H);
        layer_mma_smem(ring, f.wg, acc, a_buf);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
        stores_read(sa);
#pragma unroll
        for (int j = 0; j < ACC / 4; j += 2) {
          uint32_t cv[4], dv[4];
          ldmatrix_x4(cv, sc.frag(j));
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float2 cm = unpack_bf16(cv[m]);
            dv[m] = pack_bf16(acc[4 * j + 2 * m] * cm.x, acc[4 * j + 2 * m + 1] * cm.y);
          }
          stmatrix_x4(sa.frag(j), dv[0], dv[1], dv[2], dv[3]);
        }
        store_rows(sa, &pmap, row_of(l - 1));
        wg_sync(wg_bar, wg_phase);
      }

      // dX = dpre_0 . W0f^T on the FMA units, summed across the quad
      float oa[DIN] = {0.f, 0.f, 0.f}, ob[DIN] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < ACC / 4; j += 2) {
        uint32_t dv[4];
        ldmatrix_x4(dv, sa.frag(j));
#pragma unroll
        for (int m = 0; m < 4; m += 2) {
          const int n = f.col(j + (m >> 1));
          const float2 da = unpack_bf16(dv[m]), db = unpack_bf16(dv[m + 1]);
#pragma unroll
          for (int i = 0; i < DIN; ++i) {
            const float2 w = ldg_bf16x2(w0b + i * H + n);
            oa[i] += da.x * w.x + da.y * w.y;
            ob[i] += db.x * w.x + db.y * w.y;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < DIN; ++i) {
        oa[i] = quad_sum(oa[i]);
        ob[i] = quad_sum(ob[i]);
      }
      if (f.q == 0 && pa < N) {
        float* o = dx + ((size_t)b * N + pa) * DIN;
        o[0] = oa[0];
        o[1] = oa[1];
        o[2] = oa[2];
      }
      if (f.q == 1 && pb < N) {
        float* o = dx + ((size_t)b * N + pb) * DIN;
        o[0] = ob[0];
        o[1] = ob[1];
        o[2] = ob[2];
      }
    }
    stores_done<0>(sa);  // no bulk store outlives the CTA's shared memory
  }
}

// ---- the weight grads ----------------------------------------------------------

constexpr int KP = 64;                        // points per chunk
constexpr int BOX_BYTES = KP * 128;           // 64 columns x KP points of bf16: 8 KB
constexpr int A_BOXES = 2;                    // A: 128 rows of the grad (2 x 64 columns)
constexpr int B_BOXES = H / 64;               // B: 256 columns
constexpr int WSTAGE_BYTES = (A_BOXES + B_BOXES) * BOX_BYTES;  // 48 KB
constexpr int WSTAGES = 4;
// the column sums' hand-over between warps: two buffers of 8 warps x 256 floats
constexpr int RED_BYTES = 2 * 8 * H * 4;
constexpr size_t WGRAD_SMEM_BYTES =
    1024 + (size_t)WSTAGES * WSTAGE_BYTES + RED_BYTES + (2 * WSTAGES + 1) * 8;

// The grads of all batch elements in one flat block of floats, in this order:
// dws (B, L-1, H, H), dcs (B, L-1, H), dw0 (B, 3, H), dc0 (B, H),
// dwf (B, H, 4), dbf (B, 4). The wrapper slices the same layout.
__host__ __device__ inline size_t grads_size(int B, int L) {
  return (size_t)B * ((L - 1) * (H * H + H) + DIN * H + H + H * COUT + COUT);
}

// One work item's product C = A^T B over a segment of points (both operands
// point-major bf16, read through the tensor maps), and a column sum.
struct WgradJob {
  const CUtensorMap* amap;
  const CUtensorMap* bmap;
  int a_row0, b_row0;  // the batch element's (and layer's) first row in each map
  int a_col0;          // first A column (the tile's first grad row)
  int a_boxes;         // 2 (128 grad rows) or 1 (the 64 point/cotangent columns)
  float* out;          // the grad block; C row r, column n at out[r * H + n] or,
  bool transposed;     //   transposed, out[n * COUT + r - row0]
  int row0, rows;      // C rows [row0, row0 + rows) of the tile are stored
  float* colsum;       // sums of `cs_cols` columns from column cs_col0, or null
  bool cs_from_a;      // of the A chunk (else of the B chunk)
  int cs_col0, cs_cols;
};

// Work item t of a batch element (0 <= t < 2L): trunk grad l = t / 2, rows
// 128 (t % 2) onwards, for t < 2(L-1); then dW0f and dWf.
__device__ WgradJob make_job(int t, int b, int B, int L, int Np, const CUtensorMap* hmap,
                             const CUtensorMap* pmap, const CUtensorMap* xmap,
                             float* grads) {
  float* dws = grads;
  float* dcs = dws + (size_t)B * (L - 1) * H * H;
  float* dw0 = dcs + (size_t)B * (L - 1) * H;
  float* dc0 = dw0 + (size_t)B * DIN * H;
  float* dwf = dc0 + (size_t)B * H;
  float* dbf = dwf + (size_t)B * H * COUT;
  WgradJob j;
  j.transposed = false;
  j.cs_from_a = false;
  j.cs_col0 = 0;
  j.cs_cols = H;
  if (t < 2 * (L - 1)) {  // dWsf[b, l] = h_l^T dpre_{l+1}; dcs[b, l]
    const int l = t >> 1, half = t & 1;
    j.amap = hmap;
    j.bmap = pmap;
    j.a_row0 = (b * L + l) * Np;
    j.b_row0 = (b * L + l + 1) * Np;
    j.a_col0 = 128 * half;
    j.a_boxes = 2;
    j.out = dws + ((size_t)b * (L - 1) + l) * H * H;
    j.row0 = 128 * half;
    j.rows = 128;
    j.colsum = half == 0 ? dcs + ((size_t)b * (L - 1) + l) * H : nullptr;
  } else if (t == 2 * (L - 1)) {  // dW0f[b] = x^T dpre_0 (rows 0-2); dc0[b]
    j.amap = xmap;
    j.bmap = pmap;
    j.a_row0 = b * Np;
    j.b_row0 = b * L * Np;
    j.a_col0 = 0;
    j.a_boxes = 1;
    j.out = dw0 + (size_t)b * DIN * H;
    j.row0 = 0;
    j.rows = DIN;
    j.colsum = dc0 + (size_t)b * H;
  } else {  // dWf[b]^T = gb^T h_{L-1} (rows 3-6); dbf[b] = the sums of gb
    j.amap = xmap;
    j.bmap = hmap;
    j.a_row0 = b * Np;
    j.b_row0 = (b * L + L - 1) * Np;
    j.a_col0 = 0;
    j.a_boxes = 1;
    j.out = dwf + (size_t)b * H * COUT;
    j.transposed = true;
    j.row0 = XG_G;
    j.rows = COUT;
    j.colsum = dbf + (size_t)b * COUT;
    j.cs_from_a = true;
    j.cs_col0 = XG_G;
    j.cs_cols = COUT;
  }
  return j;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

// Items: (segment, batch element, t) with t fastest, so the two row tiles of
// one trunk grad, which read the same B chunks, run side by side. Segment s
// covers points [s * seg, min((s+1) * seg, Np)) and writes partial block s of
// `part`. hmap/pmap read hbuf/pbuf as ((B L Np) x H), xmap xg as ((B Np) x 64),
// all in boxes of 64 columns x KP points.
__global__ void __launch_bounds__(THREADS, 1)
film_siren_bwd_wgrad(const __grid_constant__ CUtensorMap hmap,
                     const __grid_constant__ CUtensorMap pmap,
                     const __grid_constant__ CUtensorMap xmap, float* part, int B, int Np,
                     int L, int seg, int segments) {
  extern __shared__ unsigned char smem[];
  const uint32_t stages = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t red = stages + WSTAGES * WSTAGE_BYTES;
  const uint32_t full = red + RED_BYTES;
  const uint32_t empty = full + 8u * WSTAGES;
  const uint32_t red_bar = empty + 8u * WSTAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full + 8u * s, 1);   // the producer's expect_tx arrive
      mbar_init(empty + 8u * s, 8);  // one arrive per consumer warp
    }
    mbar_init(red_bar, 8);           // one arrive per consumer warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int per_b = 2 * L;
  const int items = segments * B * per_b;
  const size_t block = grads_size(B, L);
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == WSTAGES) {
      stage = 0;
      phase ^= 1u;
    }
  };

  if ((threadIdx.x >> 7) == PRODUCER_WG) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == PRODUCER_WG * 128) {
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int t = item % per_b, b = (item / per_b) % B, s = item / (per_b * B);
        const WgradJob job = make_job(t, b, B, L, Np, &hmap, &pmap, &xmap, part);
        const int p_end = min(Np, (s + 1) * seg);
        for (int p = s * seg; p < p_end; p += KP) {
          const uint32_t dst = stages + stage * WSTAGE_BYTES;
          mbar_wait_or_trap(empty + 8u * stage, phase ^ 1u);
          mbar_expect_tx(full + 8u * stage, (job.a_boxes + B_BOXES) * BOX_BYTES);
          for (int i = 0; i < job.a_boxes; ++i)
            tma_load_2d(dst + i * BOX_BYTES, job.amap, job.a_col0 + 64 * i, job.a_row0 + p,
                        full + 8u * stage);
          for (int i = 0; i < B_BOXES; ++i)
            tma_load_2d(dst + (A_BOXES + i) * BOX_BYTES, job.bmap, 64 * i, job.b_row0 + p,
                        full + 8u * stage);
          advance();
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const Frag f;
    // the column sums: a thread adds 16-byte groups cg (8 columns) of rows
    // 8 rg .. 8 rg + 7 of each chunk, plainly within the chunk and
    // Kahan-compensated across chunks; then the 8 warps' sums of a column are
    // added in warp order through shared memory
    const int cg = threadIdx.x & 31, rg = threadIdx.x >> 5;
    const bool lane0 = (threadIdx.x & 31) == 0;
    uint32_t red_phase = 0;
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int t = item % per_b, b = (item / per_b) % B, s = item / (per_b * B);
      const WgradJob job = make_job(t, b, B, L, Np, &hmap, &pmap, &xmap,
                                    part + (size_t)s * block);
      const bool sums = job.colsum != nullptr;
      const bool my_sums = sums && cg < (job.cs_from_a ? 1 : H / 8);
      // the thread's 16-byte group of a chunk's row 8 rg
      const uint32_t group = (job.cs_from_a ? 0 : (A_BOXES + (cg >> 3)) * BOX_BYTES) +
                             rg * 8 * 128;
      float sum[8], comp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) sum[i] = comp[i] = 0.f;
      const int p_end = min(Np, (s + 1) * seg);
      bool first = true;
      for (int p = s * seg; p < p_end; p += KP) {
        const uint32_t chunk = stages + stage * WSTAGE_BYTES;
        mbar_wait(full + 8u * stage, phase);
        // both warpgroups issue their products; in a one-box job the second
        // one's A box is stale and its rows are not stored
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP / 16; ++kk)
          wgmma_m64n256k16_ss<1>(
              acc, sw128_mn_desc(chunk + f.wg * BOX_BYTES + kk * 2048, BOX_BYTES),
              sw128_mn_desc(chunk + A_BOXES * BOX_BYTES + kk * 2048, BOX_BYTES),
              (first && kk == 0) ? 0 : 1);
        wgmma_commit();
        if (my_sums) {
          float part[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) part[i] = 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const uint4 v = lds128(chunk + group + r * 128 + (((cg & 7) ^ r) << 4));
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 x = unpack_bf16(w[i]);
              part[2 * i] += x.x;
              part[2 * i + 1] += x.y;
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float y = part[i] - comp[i];
            const float tt = sum[i] + y;
            comp[i] = (tt - sum[i]) - y;
            sum[i] = tt;
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        __syncwarp();
        if (lane0) mbar_arrive(empty + 8u * stage);
        advance();
        first = false;
      }

#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int r = job.a_col0 + f.wg * 64 + f.row0 + 8 * (e >> 1);
          const int n = f.col(j);
          if (r < job.row0 || r >= job.row0 + job.rows) continue;
          if (job.transposed) {
            job.out[(size_t)n * COUT + r - job.row0] = acc[4 * j + e];
            job.out[(size_t)(n + 1) * COUT + r - job.row0] = acc[4 * j + e + 1];
          } else {
            *reinterpret_cast<float2*>(job.out + (size_t)r * H + n) =
                make_float2(acc[4 * j + e], acc[4 * j + e + 1]);
          }
        }
      }
      if (sums) {
        const uint32_t buf = red + (red_phase & 1u) * (RED_BYTES / 2);
        if (my_sums) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = sum[i] - comp[i];
          const uint32_t at = buf + (rg * H + 8 * cg) * 4;
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                       :: "r"(at), "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]) : "memory");
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                       :: "r"(at + 16), "f"(v[4]), "f"(v[5]), "f"(v[6]), "f"(v[7]) : "memory");
        }
        __syncwarp();
        if (lane0) mbar_arrive(red_bar);
        mbar_wait(red_bar, red_phase & 1u);
        ++red_phase;
        const int c = threadIdx.x;  // column c's total, over the warps in order
        if (c >= job.cs_col0 && c < job.cs_col0 + job.cs_cols) {
          float total = 0.f;
#pragma unroll
          for (int w = 0; w < 8; ++w) {
            float x;
            asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(buf + (w * H + c) * 4)
                         : "memory");
            total += x;
          }
          job.colsum[c - job.cs_col0] = total;
        }
      }
    }
  }
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
// the caller: hbuf/pbuf (B, L, Np, H) bf16, xg (B, Np, 64) bf16 with Np = N
// rounded up to 128; dx (B, N, 3) f32; `grads` one block of grads_size(B, L)
// floats (layout above); `part` segments x grads_size(B, L) floats with
// segments = ceil(Np / seg), seg a multiple of 64 (with one segment `part`
// may be `grads`). wsf is (B, L-1, H_in, H_out) bf16 and wsft its transpose
// per layer.
extern "C" int film_siren_bwd(const float* pts, const float* g, const void* w0f,
                              const float* c, const void* wsf, const void* wsft,
                              const void* wf, void* hbuf, void* pbuf, void* xg, float* dx,
                              float* part, float* grads, int B, int N, int L, int seg,
                              void* stream) {
  if (B <= 0 || N <= 0 || L < 2 || L > MAX_LAYERS || seg <= 0 || seg % KP)
    return (int)cudaErrorInvalidValue;
  const int tiles = (N + TILE - 1) / TILE;
  const long long Np = (long long)tiles * TILE;
  const long long segments = (Np + seg - 1) / seg;
  if ((long long)B * L * Np > 0x7fffffff || segments * B * 2 * L > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tmap, wmap, hmap, pmap, xmap, hstore, pstore;
  const uint64_t rows = (uint64_t)B * L * Np;
  int e = weight_map(&tmap, wsft, (uint64_t)B * (L - 1) * H, H);
  if (!e) e = weight_map(&wmap, wsf, (uint64_t)B * (L - 1) * H, H);
  if (!e) e = tensor_map(&hstore, hbuf, rows, H, 16);
  if (!e) e = tensor_map(&pstore, pbuf, rows, H, 16);
  if (!e) e = tensor_map(&hmap, hbuf, rows, H, KP);
  if (!e) e = tensor_map(&pmap, pbuf, rows, H, KP);
  if (!e) e = tensor_map(&xmap, xg, (uint64_t)B * Np, XG_COLS, KP);
  int grid = 0, wgrid = 0;
  if (!e) e = persistent_grid(B * tiles, &grid);
  if (!e) e = persistent_grid((int)(segments * B * 2 * L), &wgrid);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(
      film_siren_bwd_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SWEEP_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  film_siren_bwd_sweep<<<grid, THREADS, SWEEP_SMEM_BYTES, s>>>(
      tmap, wmap, hstore, pstore, pts, g, static_cast<const __nv_bfloat16*>(w0f), c,
      static_cast<const __nv_bfloat16*>(wf), static_cast<const __nv_bfloat16*>(pbuf),
      static_cast<__nv_bfloat16*>(xg), dx, B, N, L, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(film_siren_bwd_wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)WGRAD_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  film_siren_bwd_wgrad<<<wgrid, THREADS, WGRAD_SMEM_BYTES, s>>>(
      hmap, pmap, xmap, segments == 1 ? grads : part, B, (int)Np, L, seg, (int)segments);
  err = cudaGetLastError();
  if (err != cudaSuccess || segments == 1) return (int)err;
  const size_t size = grads_size(B, L);
  const size_t want = (size + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 8 ? want : 132 * 8);
  film_siren_bwd_reduce<<<blocks, 256, 0, s>>>(part, grads, size, (int)segments);
  return (int)cudaGetLastError();
}
