// trilinear_bwd: page gradient of the paged hash-grid trilinear
// contraction, with the per-page reduction fused in and no float atomics.
//
// Replaces the TPU kernel contract_bwd_rows / _bwd_rows_kernel in
// f2nerf_tpu/kernels/trilinear.py together with the per-level XLA
// jax.ops.segment_sum that reduced its d_rows into pages
// (f2nerf_tpu/ops/hash_paged.py _encode_core_bwd). The TPU kernel wrote
// d_rows = g (x) w, one dense row of C*128 per (point, level): 4.3 GB in
// bf16 at one training step of the default config. This kernel never
// materializes it.
//
// What it computes, for every page p and slot s = x*25 + y*5 + z of its
// haloed row, slot-major [128, C] (trilinear_common.cuh):
//   d_haloed[p, s*C + c] = sum over entries m with page(m) = p of
//       g[i(m), l(m)*C + c] * wx[x] * wy[y] * wz[z]
//   w_ax[v] = max(0, 1 - |v - (local_ax + frac_ax)|)
// which is _axis_factors / _weights exactly. Only the 8 corners
// v in {local, local + 1} per axis can be nonzero (frac is in [0, 1]), so
// only they are computed. Pad slots 125..127 are 0. Sums are f32; the
// store is in the haloed table's dtype (bf16 or f32).
//
// Schedule. The wrapper orders the M = L*N (level, point) entries by page
// with a stable sort (glue, as the segment_sum was XLA glue), so every
// page's entries form one run of the sorted order, in ascending entry
// index. The sorted order is cut into tiles of kTile entries.
//   pass 1 (trilinear_bwd_tiles, one warp per tile, kWarps tiles a
//     block): the warp walks its tile's entries in sorted order, 32 at a
//     time. Lane = (corner k, channel c): for each entry it adds
//     g[c] * w[k] into the corner's slot of a per-warp f32 row in shared
//     memory. The 8 corners of an entry are 8 distinct slots, so the
//     warp's adds go to distinct addresses. When the page key changes,
//     the warp stores the row (16 B-per-lane coalesced stores) and zeroes
//     it. A run that lies strictly inside the tile is a whole page: it is
//     stored to d_haloed at once. The tile's first and last runs may
//     continue into the neighbouring tiles: their sums go to a scratch
//     row each (f32).
//   pass 2 (trilinear_bwd_merge, one block of 32*C threads per tile,
//     4 columns a thread): the tile that holds the first entry of a page
//     whose run touches a tile edge adds that run's scratch rows in tile
//     order and stores the page. The run's last tile is found first (a
//     warp ballot over 32 tile heads at a time), so the rows of a long
//     run are loaded 16 at a time before they are added, in order.
//
// Determinism. Each touched page is stored by exactly one warp, and every
// slot's sum is taken in entry order (the entries of a tile one after
// another, then the tiles' rows in tile order), so two launches on the
// same inputs give bitwise-equal results. Pages no entry touches keep the
// zeros the wrapper filled in. With the weight formula ((wx*wy)*wz from
// fmaxf(0, 1 - |v - (local + frac)|)) and the fused acc = fma(g, w, acc),
// each slot's sum equals the sum over every entry of the tile in entry
// order with all 125 slots' terms, up to the sign of a zero: the 117
// other slots of an entry add +-0. So the output does not depend on
// which terms a design skips (== compares -0 and +0 equal).
//
// Launch shape. The per-warp row is padded: slot (x, y, z) lives at
// padded slot 36x + 6y + z (173 padded slots x C floats, 2.7 KB at
// C = 4), so the 8 corners {0, 1, 6, 7, 36, 37, 42, 43} are 8 distinct
// slots mod 8: at C = 4 the warp's 32 adds hit 32 distinct banks (the
// unpadded offsets {0, 1, 5, 6, 25, 26, 30, 31} put two pairs in one
// bank each). At C = 8 each lane takes two channels as a float2, and each
// half-warp is again conflict-free; at C = 2 and C = 1 only 16 or 8 lanes
// work. Each lane stages one entry of the next 32 in registers (its perm
// entry two chunks ahead, then that entry's local_frac, 24 B, and g
// slice, 4C B, one chunk ahead) while the warp adds the current 32, so
// the random gathers overlap the adds; the staged entry's page key, base
// slot, 8 corner weights and g go through shared memory.
//
// Layout: g [N, L*C] f32 (16 B-aligned); local_frac [L, N, 6] f32
// (8 B-aligned; entry m = l*N + i); skey [M] int32 sorted page keys;
// perm [M] int64 entry of each sorted position; d_haloed [P, 128*C]
// slot-major (bf16 or f32); partial [tiles, 2, 128*C] f32 scratch.
//
// Bound on an H100 SXM (3.35 TB/s): per entry the useful bytes are C*4 B
// of g, 24 B of local_frac and 4 B of key (~44 B at C = 4), plus the
// d_haloed table written once (56 MB in bf16 at the default config); at
// the 4.19 M entries of one default training step that is ~0.24 GB,
// ~0.07 ms. The function needs ~8*(2+2C) flops per entry, far below the
// compute bound: it is bound by bytes. chip_smoke.py computes this bound
// from its own inputs. What this design adds to it: the sort, the
// permutation (8 B per entry), and the random gathers through it: a 32 B
// sector of g for 4C B and one or two of local_frac for 24 B per entry,
// ~100 B per entry in all, read at the card's random-access rate. Pass 1
// is bound by those gathers; its ~5 shared-memory accesses per entry and
// warp hide under them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trilinear_common.cuh"

namespace {

using trilinear::kRowPad;
using trilinear::load_corner;
using trilinear::Raw;

constexpr int kCells = 125;
constexpr int kTile = 256;
constexpr int kChunk = 32;                   // entries staged at a time
constexpr int kPadSlots = 36 * 4 + 6 * 4 + 4 + 1;

__device__ __forceinline__ int padded_slot(int x, int y, int z) {
  return 36 * x + 6 * y + z;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void to_raw(float v, float* p) { *p = v; }
__device__ __forceinline__ void to_raw(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// v[0..K) stored at p as T, one vector store of K*sizeof(T) bytes (two
// of 16 B for 32 B); p is aligned to that size.
template <typename T, int K>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[K]) {
  constexpr int kBytes = K * (int)sizeof(T);
  constexpr int kPart = kBytes < 16 ? kBytes : 16;
  using U = typename Raw<kPart>::type;
  U raw[kBytes / kPart];
  T* t = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int k = 0; k < K; ++k) to_raw(v[k], t + k);
#pragma unroll
  for (int k = 0; k < kBytes / kPart; ++k) reinterpret_cast<U*>(p)[k] = raw[k];
}

// Lanes per corner and channels per lane for C channels: 8 corners x C
// channels over at most 32 lanes.
template <int C>
struct Lanes {
  static constexpr int kPerLane = C > 4 ? C / 4 : 1;
  static constexpr int kPerCorner = C / kPerLane;
  static constexpr int kActive = 8 * kPerCorner;
  static constexpr int kWarps = C > 4 ? 4 : 8;   // keeps a block < 48 KB
};

// One entry in registers: its page key, local_frac and g slice.
template <int C>
struct Staged {
  int key;
  float lf[6];
  float g[C];
};

template <int C>
__device__ __forceinline__ void fetch(Staged<C>& e, int64_t m,
                                      int32_t key, const float* __restrict__ g,
                                      const float* __restrict__ local_frac,
                                      int64_t n, int n_levels) {
  const int lvl = (int)(m / n);
  const int64_t i = m - (int64_t)lvl * n;
  const float2* lf = reinterpret_cast<const float2*>(local_frac) + m * 3;
  const float2 a = lf[0], b = lf[1], c = lf[2];
  e.key = key;
  e.lf[0] = a.x; e.lf[1] = a.y; e.lf[2] = b.x;
  e.lf[3] = b.y; e.lf[4] = c.x; e.lf[5] = c.y;
  load_corner<float, C>(g + i * (int64_t)(n_levels * C) + lvl * C, e.g);
}

// Per-warp shared memory: the padded f32 row and one staged chunk.
template <int C>
struct alignas(16) WarpSmem {
  float row[kPadSlots * C];
  int2 kb[kChunk];            // page key, padded slot of corner (0, 0, 0)
  float w[kChunk][8];         // corner weights (wx*wy)*wz
  float g[kChunk][C];
};

template <int C>
__device__ __forceinline__ void put(WarpSmem<C>& sm, int j,
                                    const Staged<C>& e) {
  float wa[3][2];
  int l[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = e.lf[a] + e.lf[3 + a];
    l[a] = min(max((int)e.lf[a], 0), 3);
#pragma unroll
    for (int d = 0; d < 2; ++d)
      wa[a][d] = fmaxf(0.f, 1.f - fabsf((float)(l[a] + d) - pos));
  }
  sm.kb[j] = make_int2(e.key, padded_slot(l[0], l[1], l[2]));
#pragma unroll
  for (int k = 0; k < 8; ++k)
    sm.w[j][k] = (wa[0][k >> 2] * wa[1][(k >> 1) & 1]) * wa[2][k & 1];
#pragma unroll
  for (int c = 0; c < C; ++c) sm.g[j][c] = e.g[c];
}

// Store the warp's row for `key` (to the tile's head or tail scratch row
// when the run touches a tile edge, else to d_haloed) and zero it.
template <typename T, int C>
__device__ __forceinline__ void flush(float* __restrict__ row, int key,
                                      int first, int last,
                                      T* __restrict__ d_haloed,
                                      float* __restrict__ head_row,
                                      int lane) {
  constexpr int cw = C * kRowPad;
  __syncwarp();
  for (int s = lane; s < kRowPad; s += 32) {
    float v[C];
    if (s < kCells) {
      float* r = row + padded_slot(s / 25, (s / 5) % 5, s % 5) * C;
      load_corner<float, C>(r, v);
      const float zero[C] = {};
      store_vec<float, C>(r, zero);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = 0.f;
    }
    if (key == first)
      store_vec<float, C>(head_row + s * C, v);
    else if (key == last)
      store_vec<float, C>(head_row + cw + s * C, v);
    else
      store_vec<T, C>(d_haloed + (int64_t)key * cw + s * C, v);
  }
  __syncwarp();
}

template <typename T, int C>
__global__ void __launch_bounds__(Lanes<C>::kWarps * 32)
trilinear_bwd_tiles(const float* __restrict__ g,
                    const float* __restrict__ local_frac,
                    const int32_t* __restrict__ skey,
                    const int64_t* __restrict__ perm,
                    T* __restrict__ d_haloed, float* __restrict__ partial,
                    int64_t m_total, int64_t n_tiles, int64_t n,
                    int n_levels) {
  using Ln = Lanes<C>;
  __shared__ WarpSmem<C> smem[Ln::kWarps];
  const int lane = threadIdx.x % 32;
  const int64_t tile = (int64_t)blockIdx.x * Ln::kWarps + threadIdx.x / 32;
  if (tile >= n_tiles) return;             // the whole warp leaves
  WarpSmem<C>& sm = smem[threadIdx.x / 32];
  const int64_t start = tile * kTile;
  const int cnt = (int)min64(kTile, m_total - start);
  const int first = skey[start];
  const int last = skey[start + cnt - 1];
  float* head_row = partial + tile * 2 * (C * kRowPad);

  for (int q = lane; q < kPadSlots * C; q += 32) sm.row[q] = 0.f;

  // this lane's corner (dx, dy, dz) and channels
  const int k = lane / Ln::kPerCorner;
  const bool active = lane < Ln::kActive;
  const int corner = active ? padded_slot(k >> 2, (k >> 1) & 1, k & 1) : 0;
  const int c0 = (lane % Ln::kPerCorner) * Ln::kPerLane;

  // chunk 0 in registers, chunk 1's perm entry
  Staged<C> e;
  if (lane < cnt)
    fetch(e, perm[start + lane], skey[start + lane], g, local_frac, n,
          n_levels);
  int64_t p_next = kChunk + lane < cnt ? perm[start + kChunk + lane] : 0;

  int cur = first;
  for (int base = 0; base < cnt; base += kChunk) {
    if (base + lane < cnt) put(sm, lane, e);
    __syncwarp();
    // gathers of the next chunk (and the perm entries of the one after)
    // are in flight while this chunk is added
    const int nxt = base + kChunk + lane;
    if (nxt < cnt)
      fetch(e, p_next, skey[start + nxt], g, local_frac, n, n_levels);
    if (nxt + kChunk < cnt) p_next = perm[start + nxt + kChunk];

    const int n_here = min(kChunk, cnt - base);
    for (int j = 0; j < n_here; ++j) {
      const int2 kb = sm.kb[j];
      if (kb.x != cur) {
        flush<T, C>(sm.row, cur, first, last, d_haloed, head_row, lane);
        cur = kb.x;
      }
      if (active) {
        const float w = sm.w[j][k];
        float* r = sm.row + (kb.y + corner) * C + c0;
        if constexpr (Ln::kPerLane == 1) {
          *r = fmaf(sm.g[j][c0], w, *r);
        } else {
          const float2 gv = *reinterpret_cast<const float2*>(&sm.g[j][c0]);
          float2 rv = *reinterpret_cast<float2*>(r);
          rv.x = fmaf(gv.x, w, rv.x);
          rv.y = fmaf(gv.y, w, rv.y);
          *reinterpret_cast<float2*>(r) = rv;
        }
      }
      __syncwarp();
    }
  }
  flush<T, C>(sm.row, cur, first, last, d_haloed, head_row, lane);
}

template <typename T, int C>
__global__ void __launch_bounds__(C * 32)
trilinear_bwd_merge(const int32_t* __restrict__ skey,
                    const float* __restrict__ partial,
                    T* __restrict__ d_haloed, int64_t m_total,
                    int64_t n_tiles) {
  constexpr int cw = C * kRowPad;
  constexpr int kVec = 4;           // columns per thread: 32*C threads
  constexpr int kAhead = 16;        // rows loaded before they are added
  const int lane = threadIdx.x % 32;
  const int64_t k = blockIdx.x;
  const int64_t start = k * kTile;
  const int64_t end = min64(start + kTile, m_total);
  const int head = skey[start];
  const int tail = skey[end - 1];
  const float* col = partial + threadIdx.x * kVec;

  // the last tile after k whose first entry is `key` (k if none): the
  // tile heads are sorted, so they equal `key` on a prefix of the tiles
  // after k, found 32 tiles at a time (each warp finds it alike)
  auto chain_end = [&](int key) {
    for (int64_t t0 = k + 1;; t0 += 32) {
      const int64_t t = t0 + lane;
      const unsigned same =
          __ballot_sync(0xffffffffu, t < n_tiles && skey[t * kTile] == key);
      if (same != 0xffffffffu) return t0 + __popc(same) - 1;
    }
  };

  // sum of `key`'s run: this tile's scratch row `row`, then the head rows
  // of the following tiles the run continues into, in tile order; kAhead
  // rows at a time are loaded first, so a long run's loads overlap
  auto merge = [&](int key, int row) {
    float acc[kVec];
    load_corner<float, kVec>(col + (k * 2 + row) * cw, acc);
    const int64_t end_tile = tail == key ? chain_end(key) : k;
    int64_t t = k + 1;
    for (; t + kAhead - 1 <= end_tile; t += kAhead) {
      float v[kAhead][kVec];
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
        load_corner<float, kVec>(col + (t + a) * 2 * cw, v[a]);
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] += v[a][e];
    }
    for (; t <= end_tile; ++t) {
      float v[kVec];
      load_corner<float, kVec>(col + t * 2 * cw, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] += v[e];
    }
    store_vec<T, kVec>(d_haloed + (int64_t)key * cw + threadIdx.x * kVec, acc);
  };

  if (k == 0 || skey[start - 1] != head) merge(head, 0);
  if (tail != head) merge(tail, 1);
}

template <typename T, int C>
int launch(const float* g, const float* local_frac, const int32_t* skey,
           const int64_t* perm, void* d_haloed, float* partial,
           int64_t m_total, int64_t n, int n_levels, cudaStream_t stream) {
  constexpr int kWarps = Lanes<C>::kWarps;
  const int64_t n_tiles = (m_total + kTile - 1) / kTile;
  T* out = static_cast<T*>(d_haloed);
  trilinear_bwd_tiles<T, C>
      <<<(unsigned)((n_tiles + kWarps - 1) / kWarps), kWarps * 32, 0,
         stream>>>(g, local_frac, skey, perm, out, partial, m_total, n_tiles,
                   n, n_levels);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  trilinear_bwd_merge<T, C><<<(unsigned)n_tiles, C * 32, 0, stream>>>(
      skey, partial, out, m_total, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int trilinear_bwd_tile_size() { return kTile; }

// Returns cudaGetLastError() after the two launches (0 = launched); an
// unsupported channel count returns cudaErrorInvalidValue unlaunched.
// d_haloed must hold zeros; partial holds 2 * C * 128 floats per tile.
extern "C" int trilinear_bwd(const float* g, const float* local_frac,
                             const int32_t* skey, const int64_t* perm,
                             void* d_haloed, int haloed_is_bf16,
                             float* partial, int64_t n, int n_levels,
                             int n_channels, void* stream) {
  const int64_t m_total = n * n_levels;
  if (m_total == 0) return 0;
  if ((m_total + kTile - 1) / kTile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F2_CASE(CH)                                                        \
  case CH:                                                                 \
    return haloed_is_bf16                                                  \
               ? launch<__nv_bfloat16, CH>(g, local_frac, skey, perm,      \
                                           d_haloed, partial, m_total, n,  \
                                           n_levels, s)                    \
               : launch<float, CH>(g, local_frac, skey, perm, d_haloed,    \
                                   partial, m_total, n, n_levels, s);
  switch (n_channels) {
    F2_CASE(1)
    F2_CASE(2)
    F2_CASE(4)
    F2_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef F2_CASE
}
