// The VJP of border-mode trilinear sampling for Hopper (sm_90a), bound
// through a plain C interface (ctypes; see ops/kernels/trilinear.py).
//
// Counterpart of the XLA custom VJP of
// conditioned_nerf_gan_tpu/ops/grid_sample.py::_border_trilerp
// (`_expanded_bwd`), which replaces no Pallas kernel: the TPU has no atomic
// scatter, so the JAX package forms dV = P^T Q as one-hot matmuls in bf16.
// Here dV is a scatter. Per point, with the anchors and fractions recomputed
// exactly as the forward computes them (trilinear_common.cuh):
//   dV   the 8 corner rows of g weighted as the VJP of the forward's lerp
//        tree, ((g (1 - tz)) (1 - ty)) (1 - tx) for corner (z0, y0, x0) and
//        likewise, each product rounded as torch autograd of
//        border_trilerp_reference rounds it, ADDED into a dV the caller owns
//        (a render zeroes one dV and every lookup of it adds into it);
//   dcoords (only when asked) the JAX cotangents of the fractions from the
//        re-gathered corners, d_tx = sum_c g sum_k (x1_k - x0_k) u_k and the
//        y and z ones from the x-lerps, passed where the unclamped position
//        lies in [0, size - 1] and scaled by size / 2.
//
// What bounds dV: the coordinates and g read once, and every distinct
// corner row the points touch read and written once. What set the first
// design's pace was none of these bytes but the count of its 16-byte
// reductions: one `red.global.add.v4.f32` per point, live corner and
// channel quad (up to 37.7M a call at the training chunk), against ~0.025
// ms of bytes.
//
// What this design does about it (trilinear_bwd_presum_kernel): a CTA takes
// a tile of TILE consecutive points and sums their contributions to each
// distinct corner row on chip, so one reduction a row and channel quad
// leaves the SM. A render's points lie ray-major, so a tile is ~5 rays of
// 48 samples, whose corners neighbouring samples and rays share. (Tiles of
// one sample index across 256 neighbouring rays halve the reductions again
// but ran slower in the `dg` train step: once the reductions are few, the
// grouping and the sum loop below set the pace.) In shared memory, per
// tile:
//   1. each thread (a point) inserts the rows of its live corners (weight
//      not exactly zero) into a hash table of voxel indices (linear probing,
//      atomicCAS) and counts them per row, keeping each pair's rank;
//   2. a block scan over the distinct rows gives each row its first pair;
//   3. each pair writes its (point, corner) code at its row's place;
//   4. the tile's g rows are read once into shared memory (8 channel quads
//      a pass), and the pairs, so grouped, cut into TILE / 8 runs of equal
//      length (at C 32); per (run, channel quad) one thread sums each row's
//      pairs in the run in fp32 and issues one float4 reduction a row into
//      dV (a row that runs over a cut gets one a run, so a crowded border
//      row does not hold its CTA on one thread).
// g is staged because each point's row is read once for each of its live
// corners (8 at most): from L2, with the L1 that the shared memory leaves,
// that re-read took as long as the reductions it saves.
// The contributions are rounded as the plain version rounds them and summed
// with no FMA contraction, so dV differs from an fp32 `index_add_` only in
// the order of its sums (the tile's, then the atomics'), which changes from
// launch to launch. The keys are 32-bit voxel indices within one volume
// (D H W < 2^31), the addresses 64-bit, so one index path serves every size.
//
// dcoords keeps the first design (trilinear_dcoords_kernel): one thread a
// (point, channel quad), the quads of a point summed with shuffles, no
// atomics, bitwise repeatable; its short index path (FAST) and the generic
// one as in the forward.

#include "trilinear_common.cuh"

namespace {

using namespace trilinear;

constexpr int TILE = THREADS;          // points a CTA pre-sums, one a thread
constexpr int PAIRS = 8 * TILE;        // (point, live corner) pairs of a tile, at most
constexpr int SLOT_BITS = 12;
constexpr int SLOTS = 1 << SLOT_BITS;  // hash slots: at most PAIRS keys, load <= 1/2
constexpr unsigned EMPTY = 0xffffffffu;

constexpr int PASS_QUADS = 8;        // channel quads a pass of step 4 stages (C 32: one pass)

struct PresumBuild {                 // steps 1-3
  unsigned key[SLOTS];               // voxel index within the volume, or EMPTY
  unsigned short count[SLOTS];       // the slot's pairs; after the scan, its first pair
  unsigned short row_slot[PAIRS];    // the distinct rows' slots, in order of insertion
};

struct PresumShared {
  union {
    PresumBuild build;
    float4 g[TILE * PASS_QUADS];     // step 4: the tile's cotangent, PASS_QUADS quads a point
  } u;
  float4 frac[TILE];                 // each point's fractions (tx, ty, tz, -)
  unsigned short pair[PAIRS];        // point * 8 + corner, grouped by row
  unsigned base[TILE];               // each point's (z0, y0, x0) voxel index
  unsigned warp_total[TILE / 32];
  unsigned n_rows, n_pairs;
};

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

// The slot's count (16 bits of a shared word) before this thread's +1. A
// count stays <= PAIRS, so it never carries into the neighbouring slot's.
__device__ __forceinline__ unsigned count_up(unsigned short* count, unsigned slot) {
  const unsigned shift = (slot & 1u) * 16u;
  const unsigned old = atomicAdd(reinterpret_cast<unsigned*>(count) + (slot >> 1), 1u << shift);
  return (old >> shift) & 0xffffu;
}

// The slot that holds `key`, inserting it (and listing it as a distinct row)
// if no thread has. At most PAIRS keys in SLOTS slots: a probe always ends.
__device__ __forceinline__ unsigned insert(PresumShared& sm, unsigned key) {
  unsigned slot = (key * 2654435761u) >> (32 - SLOT_BITS);
  while (true) {
    const unsigned prev = atomicCAS(&sm.u.build.key[slot], EMPTY, key);
    if (prev == EMPTY) {
      sm.u.build.row_slot[atomicAdd(&sm.n_rows, 1u)] = (unsigned short)slot;
      return slot;
    }
    if (prev == key) return slot;
    slot = (slot + 1) & (SLOTS - 1);
  }
}

// dV += the VJP. Block (b, tile): points [n0, n0 + TILE) of batch element b.
__global__ void __launch_bounds__(TILE)
trilinear_bwd_presum_kernel(const float* __restrict__ coords, const float* __restrict__ g,
                            float* __restrict__ dvol, int N, int tiles, int D, int H, int W,
                            int C) {
  __shared__ PresumShared sm;
  const int tid = threadIdx.x;
  const int b = (int)(blockIdx.x / (unsigned)tiles);
  const int n0 = (int)(blockIdx.x % (unsigned)tiles) * TILE;
  const long long first = (long long)b * N + n0;  // point i is first + i

  uint4* keys4 = reinterpret_cast<uint4*>(sm.u.build.key);
  for (int k = tid; k < SLOTS / 4; k += TILE) keys4[k] = make_uint4(EMPTY, EMPTY, EMPTY, EMPTY);
  uint4* counts4 = reinterpret_cast<uint4*>(sm.u.build.count);
  for (int k = tid; k < SLOTS / 8; k += TILE) counts4[k] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) sm.n_rows = sm.n_pairs = 0u;
  __syncthreads();

  // 1. the rows of this thread's live corners, and each pair's rank in its row
  const int HW = H * W;
  const bool valid = n0 + tid < N;
  unsigned slot_rank[8];  // slot << 16 | rank, or EMPTY for a corner of zero weight
#pragma unroll
  for (int c = 0; c < 8; ++c) slot_rank[c] = EMPTY;
  if (valid) {
    const float* xyz = coords + (first + tid) * 3;
    const Axis ax = anchor(__ldg(xyz), W);
    const Axis ay = anchor(__ldg(xyz + 1), H);
    const Axis az = anchor(__ldg(xyz + 2), D);
    sm.frac[tid] = make_float4(ax.t, ay.t, az.t, 0.f);
    const unsigned base = (unsigned)((az.i * H + ay.i) * W + ax.i);
    sm.base[tid] = base;
    // a side of 1 has t 0 on its axis: its second corner weighs 0, is not live
    const bool live_z[2] = {az.t != 1.f, az.t != 0.f};
    const bool live_y[2] = {ay.t != 1.f, ay.t != 0.f};
    const bool live_x[2] = {ax.t != 1.f, ax.t != 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int dz = c >> 2, dy = (c >> 1) & 1, dx = c & 1;
      if (live_z[dz] && live_y[dy] && live_x[dx]) {
        const unsigned slot = insert(sm, base + dz * HW + dy * W + dx);
        slot_rank[c] = (slot << 16) | count_up(sm.u.build.count, slot);
      }
    }
  }
  __syncthreads();

  // 2. exclusive scan of the rows' counts, PER rows a thread
  constexpr int PER = PAIRS / TILE;
  const unsigned n_rows = sm.n_rows;
  const int lane = tid & 31, warp = tid >> 5;
  unsigned counts[PER], local = 0u;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const unsigned id = tid * PER + k;
    counts[k] = id < n_rows ? sm.u.build.count[sm.u.build.row_slot[id]] : 0u;
    local += counts[k];
  }
  unsigned incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) sm.warp_total[warp] = incl;
  __syncthreads();
  unsigned run = incl - local;
  for (int w = 0; w < warp; ++w) run += sm.warp_total[w];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const unsigned id = tid * PER + k;
    if (id < n_rows) {
      sm.u.build.count[sm.u.build.row_slot[id]] = (unsigned short)run;  // the slot's first pair
      run += counts[k];
      if (id + 1 == n_rows) sm.n_pairs = run;
    }
  }
  __syncthreads();

  // 3. each pair at its row's place
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (slot_rank[c] != EMPTY) {
      const unsigned slot = slot_rank[c] >> 16, rank = slot_rank[c] & 0xffffu;
      sm.pair[sm.u.build.count[slot] + rank] = (unsigned short)(tid * 8 + c);
    }
  }
  __syncthreads();

  // 4. per pass of PASS_QUADS channel quads: the tile's cotangent rows,
  // read from device memory once, into shared memory (over the build
  // arrays, done with); then the pairs, grouped by row, cut into `chunks`
  // runs of equal length, and per (run, channel quad) one thread sums the
  // pairs of each row in its run and issues one float4 reduction a row. A
  // crowded row (hundreds of points clamped onto one border voxel) is cut
  // into several runs, a reduction each, rather than summed by one thread
  // while the CTA waits.
  const int quads = C / 4;
  const int n_pairs = (int)sm.n_pairs;
  const long long volume_rows = (long long)b * D * HW;
  for (int q0 = 0; q0 < quads; q0 += PASS_QUADS) {
    const int nq = min(PASS_QUADS, quads - q0);
    for (int k = tid; k < TILE * nq; k += TILE) {
      const int i = k / nq, qq = k - i * nq;
      if (n0 + i < N)
        sm.u.g[i * PASS_QUADS + qq] =
            __ldg(reinterpret_cast<const float4*>(g + (first + i) * C) + q0 + qq);
    }
    __syncthreads();
    const int chunks = TILE / nq;
    const int per = (n_pairs + chunks - 1) / chunks;
    for (int item = tid; item < chunks * nq; item += TILE) {
      const int j = item / nq, qq = item - j * nq;
      float* out = dvol + volume_rows * C + 4 * (q0 + qq);
      const int k1 = min(n_pairs, (j + 1) * per);
      unsigned row = EMPTY;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = j * per; k < k1; ++k) {
        const unsigned p = sm.pair[k];
        const int i = (int)(p >> 3), c = (int)(p & 7u);
        const unsigned key = sm.base[i] + (c >> 2) * HW + ((c >> 1) & 1) * W + (c & 1);
        if (key != row) {
          if (row != EMPTY) add4(out + (long long)row * C, acc);
          row = key;
          acc = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const float4 f = sm.frac[i];
        const float wz = (c & 4) ? f.z : __fsub_rn(1.f, f.z);
        const float wy = (c & 2) ? f.y : __fsub_rn(1.f, f.y);
        const float wx = (c & 1) ? f.x : __fsub_rn(1.f, f.x);
        const float4 part = scale4(scale4(scale4(sm.u.g[i * PASS_QUADS + qq], wz), wy), wx);
        acc = make_float4(__fadd_rn(acc.x, part.x), __fadd_rn(acc.y, part.y),
                          __fadd_rn(acc.z, part.z), __fadd_rn(acc.w, part.w));
      }
      if (row != EMPTY) add4(out + (long long)row * C, acc);
    }
    __syncthreads();  // the next pass overwrites the staged rows
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// dcoords. Every lane of a point runs to the end (they reduce dcoords with
// shuffles); lanes past the last item do nothing else.
template <bool FAST>
__global__ void __launch_bounds__(THREADS)
trilinear_dcoords_kernel(const float* __restrict__ volume, const float* __restrict__ coords,
                         const float* __restrict__ g, float* __restrict__ dcoords,
                         long long n_items, int N, int D, int H, int W, int C) {
  const int quads = C / 4;
  const long long item = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = item < n_items;
  float dtx = 0.f, dty = 0.f, dtz = 0.f;
  Sample s;
  if (valid) {
    s = sample<FAST>(coords, item, N, D, H, W, C);
    const float4 gv = __ldg(reinterpret_cast<const float4*>(g + s.point * C) + s.q);
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

}  // namespace

// volume (B, D, H, W, C) (read only for dcoords), coords (B, N, 3), g (B, N,
// C), all fp32, contiguous, 16-byte aligned; C % 4 == 0, every side >= 1.
// dvol (B, D, H, W, C) fp32 that the VJP is added into, or null (then D H W
// may be any size; else < 2^31); dcoords (B, N, 3) fp32 or null (then C / 4
// must be a power of two <= 32). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int trilinear_bwd(const float* volume, const float* coords, const float* g,
                             float* dvol, float* dcoords, int B, int N, int D, int H, int W,
                             int C, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || C % 4 || D < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int quads = C / 4;
  if (dcoords != nullptr && (quads > 32 || (quads & (quads - 1))))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dvol != nullptr) {
    if ((long long)D * H * W >= 2147483647LL) return (int)cudaErrorInvalidValue;
    const int tiles = (N + TILE - 1) / TILE;
    const long long blocks = (long long)B * tiles;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    trilinear_bwd_presum_kernel<<<(unsigned)blocks, TILE, 0, st>>>(coords, g, dvol, N, tiles,
                                                                   D, H, W, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dcoords != nullptr) {
    const long long n_items = (long long)B * N * quads;
    const long long blocks = (n_items + THREADS - 1) / THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    if (fast_path(n_items, D, H, W, C))
      trilinear_dcoords_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
          volume, coords, g, dcoords, n_items, N, D, H, W, C);
    else
      trilinear_dcoords_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
          volume, coords, g, dcoords, n_items, N, D, H, W, C);
  }
  return (int)cudaGetLastError();
}
