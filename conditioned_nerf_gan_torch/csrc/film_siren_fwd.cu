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
// Four instances: DIN = 3 (xyz points, the SHORTSIREN family), DIN = 32
// (trilinearly sampled U-Net features, the voxel-conditioned FG family),
// DIN = 35 (32 features and xyz, TALLSIREN_dgx) and DIN = 224 (the 128 + 64 +
// 32 features of a PyramidUNet3D's three levels); L from 2 to 8 layers of 256
// units.
//
// What bounds it: per point, (L-1) x 256 x 256 x 2 + small FLOP (0.4 MFLOP at
// L = 4, 0.94 MFLOP at DIN = 32, L = 8) against 16 + 4 DIN bytes of device
// I/O, so it is compute-bound: the tensor cores, and the sin7 epilogues
// between the products (about as long again on the FP32 pipes at L = 4).
// Each 128-point tile also streams its batch element's folded weights
// (393 KB at L = 4) from L2. At DIN = 224 and L = 2 (the pyramid's
// DOUBLESIREN) the point's 912 bytes of fp32 features and output take about
// as long at HBM's rate as its 0.25 MFLOP at the tensor cores' peak.
//
// What the design does about it: the trunk of film_siren_trunk.cuh (wgmma
// with h in registers, a TMA weight ring under mbarriers, a producer
// warpgroup and two consumer warpgroups taking turns, a persistent grid), so
// the products run at wgmma's rate and one warpgroup's sin7 epilogue overlaps
// the other's products. Around it:
//   * layer 0 at DIN = 3 (K = 3) runs on the FMA units into the
//     accumulators; at DIN = 32 it is two wgmma k-steps with x as register A
//     fragments (loaded from device memory) and W0f^T as the first chunk of
//     the ring (its columns past 32 read as zeros from the TMA, unused). At
//     DIN = 35 and 224 (`wide_layer0`) it is a trunk-shaped product: x,
//     rounded to bf16 and zero past DIN, goes into the registers that hold h
//     in the later layers (free until layer 0's epilogue), as A fragments of
//     K = 48 (3 k-steps, one chunk) or 256 (16 k-steps, four chunks), and
//     W0f^T streams through the ring in chunks of 64 K-columns, its columns
//     past DIN read as zeros from the TMA. At 224 the last chunk's second
//     half multiplies zeros (an eighth of layer 0's products);
//   * one loop then runs every layer's epilogue (sin7 of acc + c_l into the
//     A registers) and the next layer's products: one copy of each in the
//     code. Unrolled layer by layer the kernel ran slower: a kernel this
//     large runs at the rate its code is fetched (see film_siren_bwd.cu);
//   * the 256 -> 4 head runs on the FMA units on each thread's last h
//     fragment, summed across the quad by shuffles;
//   * the ragged tail of N is zero on load and masked on store.
// The trunk weights come transposed, (B, L-1, H_out, H_in), the K-major
// layout of wgmma's B operand.

#include "film_siren_trunk.cuh"

namespace {

using namespace film_trunk;

// Layer 0's products into acc at DIN 35 or 224, x . W0f (the epilogue adds
// c_0): x of points pa and pb of batch element b (zeros past N and past DIN),
// rounded to bf16, as the A fragments of layer 0's k-steps in `a` (the
// registers of h, free until layer 0's epilogue); W0f^T the ring's next
// w0_chunks(DIN) chunks. A fragment register 2j (2j + 1) holds columns
// col(j), col(j) + 1 of row pa (pb), as an accumulator fragment does.
template <int DIN, int NS>
__device__ __forceinline__ void wide_layer0(Ring<NS>& ring, const Frag& f, float (&acc)[ACC],
                                            uint32_t (&a)[HREGS],
                                            const float* __restrict__ pts, int b, int N, int pa,
                                            int pb) {
  static_assert(DIN == 35 || DIN == 224, "the wide instances are DIN 35 and 224");
  constexpr int CHUNKS = w0_chunks(DIN), KSTEPS = w0_ksteps(DIN);
  constexpr int GROUPS = ((CHUNKS - 1) * CHUNKS_PER_LAYER + KSTEPS) * 2;  // of 8 columns
  const float* xa = pts + ((size_t)b * N + pa) * DIN;
  const float* xb = pts + ((size_t)b * N + pb) * DIN;
  auto pair = [&](const float* x, bool live, int k) {
    float2 v = make_float2(0.f, 0.f);
    if (live && k < DIN) {
      if constexpr (DIN % 2 == 0) {
        v = *reinterpret_cast<const float2*>(x + k);
      } else {
        v.x = x[k];
        if (k + 1 < DIN) v.y = x[k + 1];
      }
    }
    return pack_bf16(v.x, v.y);
  };
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    a[2 * j] = pair(xa, pa < N, f.col(j));
    a[2 * j + 1] = pair(xb, pb < N, f.col(j));
  }
  layer_mma<CHUNKS, KSTEPS>(ring, f.wg, acc, a);
}

// pts (B, N, DIN) f32; w0: at DIN 3 W0f (B, 3, H), else W0f^T (B, H, DINP)
// with DINP = DIN rounded up to 8 (zero columns past DIN), bf16; c (B, L, H)
// f32 (c_0 then c_1..); wf (H, 4) bf16; bf (4) f32; out (B, N, 4) f32. wmap
// reads Wsf^T as ((B (L-1) H) x H); w0map W0f^T as ((B H) x DINP) (DIN > 3
// only). `tiles` = ceil(N / TILE).
template <int DIN>
__global__ void __launch_bounds__(THREADS, 1)
film_siren_fwd_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap w0map,
                      const float* __restrict__ pts, const __nv_bfloat16* __restrict__ w0,
                      const float* __restrict__ c, const __nv_bfloat16* __restrict__ wf,
                      const float* __restrict__ bf, float* __restrict__ out, int B, int N,
                      int L, int tiles) {
  static_assert(DIN == 3 || DIN == 32 || DIN == 35 || DIN == 224, "DIN is 3, 32, 35 or 224");
  constexpr bool WIDE = DIN == 35 || DIN == 224;
  extern __shared__ unsigned char smem[];
  Ring<NSTAGE> ring = ring_setup<NSTAGE>(smem);
  const int items = B * tiles;
  const int trunk_chunks = (L - 1) * CHUNKS_PER_LAYER;

  if ((threadIdx.x >> 7) == PRODUCER_WG) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == PRODUCER_WG * 128) {
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int b = item / tiles;
        if constexpr (DIN == 32) produce(ring, &w0map, 0, b * H);
        if constexpr (WIDE)
          for (int kc = 0; kc < w0_chunks(DIN); ++kc) produce(ring, &w0map, kc * KC, b * H);
        for (int q = 0; q < trunk_chunks; ++q)
          produce(ring, &wmap, (q % CHUNKS_PER_LAYER) * KC,
                  (b * (L - 1) + q / CHUNKS_PER_LAYER) * H);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const Frag f;
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    uint32_t h[HREGS];

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int b = item / tiles;
      const int pa = (item % tiles) * TILE + f.wg * WG_POINTS + f.row0;  // rows pa, pb
      const int pb = pa + 8;
      const float* cb = c + (size_t)b * L * H;

      // the epilogue of a hidden layer: h = bf16(sin7(acc + c_l))
      auto hidden = [&](const float* cl) {
#pragma unroll
        for (int j = 0; j < ACC / 4; ++j) {
          const float2 cc = __ldg(reinterpret_cast<const float2*>(cl + f.col(j)));
          h[2 * j] = pack_bf16(sin7(acc[4 * j] + cc.x), sin7(acc[4 * j + 1] + cc.y));
          h[2 * j + 1] = pack_bf16(sin7(acc[4 * j + 2] + cc.x), sin7(acc[4 * j + 3] + cc.y));
        }
      };

      if constexpr (WIDE)
        wide_layer0<DIN>(ring, f, acc, h, pts, b, N, pa, pb);
      else
        layer0_products<DIN>(ring, f, acc, pts, w0, b, N, pa, pb);

      // each layer's epilogue, then the next layer's products: one copy of
      // each in the code (unrolled, a kernel larger than the instruction
      // cache runs at the rate its code is fetched)
#pragma unroll 1
      for (int l = 0;; ++l) {
        hidden(cb + l * H);
        if (l == L - 1) break;
        layer_mma<CHUNKS_PER_LAYER, CHUNKS_PER_LAYER>(ring, f.wg, acc, h);
      }

      // head on the FMA units: out = h_{L-1} . Wf + bf (h already in bf16)
      float oa[COUT] = {0.f, 0.f, 0.f, 0.f}, ob[COUT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const int n = f.col(j);
        const float2 ha = unpack_bf16(h[2 * j]), hb = unpack_bf16(h[2 * j + 1]);
        const float ha0 = ha.x, ha1 = ha.y, hb0 = hb.x, hb1 = hb.y;
        const float2 w01 = ldg_bf16x2(wf + n * COUT), w23 = ldg_bf16x2(wf + n * COUT + 2);
        const float2 v01 = ldg_bf16x2(wf + (n + 1) * COUT);
        const float2 v23 = ldg_bf16x2(wf + (n + 1) * COUT + 2);
        oa[0] += ha0 * w01.x + ha1 * v01.x;
        oa[1] += ha0 * w01.y + ha1 * v01.y;
        oa[2] += ha0 * w23.x + ha1 * v23.x;
        oa[3] += ha0 * w23.y + ha1 * v23.y;
        ob[0] += hb0 * w01.x + hb1 * v01.x;
        ob[1] += hb0 * w01.y + hb1 * v01.y;
        ob[2] += hb0 * w23.x + hb1 * v23.x;
        ob[3] += hb0 * w23.y + hb1 * v23.y;
      }
#pragma unroll
      for (int o = 0; o < COUT; ++o) {
        oa[o] = quad_sum(oa[o]) + bf[o];
        ob[o] = quad_sum(ob[o]) + bf[o];
      }
      if (f.q == 0 && pa < N)
        *reinterpret_cast<float4*>(out + ((size_t)b * N + pa) * COUT) =
            make_float4(oa[0], oa[1], oa[2], oa[3]);
      if (f.q == 1 && pb < N)
        *reinterpret_cast<float4*>(out + ((size_t)b * N + pb) * COUT) =
            make_float4(ob[0], ob[1], ob[2], ob[3]);
    }
  }
}

template <int DIN>
int launch(const float* pts, const void* w0, const float* c, const void* wst, const void* wf,
           const float* bf, float* out, int B, int N, int L, cudaStream_t stream) {
  CUtensorMap wmap, w0map;
  int err = weight_map(&wmap, wst, (uint64_t)B * (L - 1) * H, H);
  if (err) return err;
  // at DIN 3 the ring has no layer-0 chunk: w0map is a copy never read
  err = DIN != 3 ? weight_map(&w0map, w0, (uint64_t)B * H, (DIN + 7) & ~7) : 0;
  if (err) return err;
  if (DIN == 3) w0map = wmap;
  const int tiles = (N + TILE - 1) / TILE;
  int grid = 0;
  err = persistent_grid(B * tiles, &grid);
  if (err) return err;
  cudaError_t cerr = cudaFuncSetAttribute(
      film_siren_fwd_kernel<DIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ring_bytes(NSTAGE));
  if (cerr != cudaSuccess) return (int)cerr;
  film_siren_fwd_kernel<DIN><<<grid, THREADS, ring_bytes(NSTAGE), stream>>>(
      wmap, w0map, pts, static_cast<const __nv_bfloat16*>(w0), c,
      static_cast<const __nv_bfloat16*>(wf), bf, out, B, N, L, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the DIN = din instance (3, 32, 35 or 224) on `stream`; returns
// cudaGetLastError() (0 = launched). wst is Wsf transposed per layer,
// (B, L-1, H_out, H_in) bf16; w0 is W0f (B, 3, H) at din 3 and else W0f^T
// (B, H, DINP), DINP = din rounded up to 8, its columns past din zero.
extern "C" int film_siren_fwd(const float* pts, const void* w0, const float* c,
                              const void* wst, const void* wf, const float* bf, float* out,
                              int B, int N, int L, int din, void* stream) {
  if (B <= 0 || N <= 0 || L < 2 || L > MAX_LAYERS || (long long)B * ((N + TILE - 1) / TILE) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (din == 3) return launch<3>(pts, w0, c, wst, wf, bf, out, B, N, L, s);
  if (din == 32) return launch<32>(pts, w0, c, wst, wf, bf, out, B, N, L, s);
  if (din == 35) return launch<35>(pts, w0, c, wst, wf, bf, out, B, N, L, s);
  if (din == 224) return launch<224>(pts, w0, c, wst, wf, bf, out, B, N, L, s);
  return (int)cudaErrorInvalidValue;
}
