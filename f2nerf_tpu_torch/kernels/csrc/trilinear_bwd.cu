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
// which is _axis_factors / _weights exactly. Pad slots 125..127 are 0.
// Sums are f32; the store is in the haloed table's dtype (bf16 or f32).
//
// Determinism. The wrapper orders the M = L*N (level, point) entries by
// page with a stable sort (glue, as the segment_sum was XLA glue), so
// every page's entries form one run of the sorted order, in ascending
// entry index. The sorted order is cut into tiles of kTile entries.
//   pass 1 (one block per tile): each thread t owns one (slot t / C,
//     channel t % C), the row's column t, and walks the tile's entries
//     in order. A run that lies strictly inside the tile is a whole
//     page: it is stored to d_haloed at once.
//     The tile's first run and its last run may continue into the
//     neighbouring tiles: their sums go to a scratch row each.
//   pass 2 (one block per tile): the tile that holds the first entry of
//     a page whose run touches a tile edge adds that run's scratch rows
//     in tile order and stores the page.
// Each touched page is stored by exactly one thread block, and every sum
// is taken in a fixed order, so two launches on the same inputs give
// bitwise-equal results. Pages no entry touches keep the zeros the
// wrapper filled in.
//
// Layout: g [N, L*C] f32; local_frac [L, N, 6] f32 (entry m = l*N + i);
// skey [M] int32 sorted page keys; perm [M] int64 entry of each sorted
// position; d_haloed [P, 128*C] slot-major (bf16 or f32); partial
// [tiles, 2, 128*C] f32 scratch.
//
// Bound on an H100 SXM (3.35 TB/s): per entry the useful bytes are C*4 B
// of g, 24 B of local_frac, 4 B of key and 8 B of permutation (~52 B at
// C = 4), plus the d_haloed table written once (56 MB in bf16 at the
// default config); at the 4.19 M entries of one default training step
// that is ~0.27 GB, ~0.08 ms. The function needs ~8*(2+2C) flops per
// entry, far below the compute bound: it is bound by bytes.
// chip_smoke.py computes this bound from its own inputs.
//
// Design (simple first): the tile's weights and cotangents are staged in
// shared memory, then every thread (slot, channel) evaluates its slot's
// weight for every entry: the TPU kernel's dense 128-slot work, 16x the
// 8 nonzero corners, but from shared memory and with no atomics. A
// corner-only design with a warp per page run is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowPad = 128;
constexpr int kCells = 125;
constexpr int kTile = 256;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int C>
__global__ void __launch_bounds__(C * kRowPad)
trilinear_bwd_tiles(const float* __restrict__ g,
                    const float* __restrict__ local_frac,
                    const int32_t* __restrict__ skey,
                    const int64_t* __restrict__ perm,
                    T* __restrict__ d_haloed, float* __restrict__ partial,
                    int64_t m_total, int64_t n, int n_levels) {
  __shared__ int32_t s_key[kTile];
  __shared__ float s_w[kTile][15];   // wx[0..4], wy[0..4], wz[0..4]
  __shared__ float s_g[kTile][C];

  const int64_t start = (int64_t)blockIdx.x * kTile;
  const int cnt = (int)min64(kTile, m_total - start);
  for (int j = threadIdx.x; j < cnt; j += C * kRowPad) {
    const int64_t m = perm[start + j];
    const int lvl = (int)(m / n);
    const int64_t i = m - (int64_t)lvl * n;
    const float* lf = local_frac + m * 6;
    s_key[j] = skey[start + j];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = lf[a] + lf[3 + a];
#pragma unroll
      for (int v = 0; v < 5; ++v)
        s_w[j][a * 5 + v] = fmaxf(0.f, 1.f - fabsf((float)v - pos));
    }
    const float* gi = g + i * (int64_t)(n_levels * C) + lvl * C;
#pragma unroll
    for (int c = 0; c < C; ++c) s_g[j][c] = gi[c];
  }
  __syncthreads();

  const int s = threadIdx.x / C;
  const int c = threadIdx.x % C;
  const bool live = s < kCells;
  const int sx = live ? s / 25 : 0;
  const int sy = live ? (s / 5) % 5 : 0;
  const int sz = live ? s % 5 : 0;
  const int first = s_key[0];
  const int last = s_key[cnt - 1];
  const int64_t cw = (int64_t)C * kRowPad;
  float* head_row = partial + (int64_t)blockIdx.x * 2 * cw;
  float* tail_row = head_row + cw;

  auto flush = [&](int key, float acc) {
    const float v = live ? acc : 0.f;
    if (key == first)
      head_row[threadIdx.x] = v;
    else if (key == last)
      tail_row[threadIdx.x] = v;
    else
      store(d_haloed + (int64_t)key * cw + threadIdx.x, v);
  };

  int cur = first;
  float acc = 0.f;
  for (int j = 0; j < cnt; ++j) {
    const int key = s_key[j];
    if (key != cur) {
      flush(cur, acc);
      acc = 0.f;
      cur = key;
    }
    acc += s_g[j][c] * ((s_w[j][sx] * s_w[j][5 + sy]) * s_w[j][10 + sz]);
  }
  flush(cur, acc);
}

template <typename T, int C>
__global__ void __launch_bounds__(C * kRowPad)
trilinear_bwd_merge(const int32_t* __restrict__ skey,
                    const float* __restrict__ partial,
                    T* __restrict__ d_haloed, int64_t m_total,
                    int64_t n_tiles) {
  const int64_t k = blockIdx.x;
  const int64_t start = k * kTile;
  const int64_t end = min64(start + kTile, m_total);
  const int head = skey[start];
  const int tail = skey[end - 1];
  const int64_t cw = (int64_t)C * kRowPad;

  // sum of `key`'s run: this tile's scratch row `row`, then the head rows
  // of the following tiles while the run continues into them
  auto merge = [&](int key, int row) {
    float acc = partial[(k * 2 + row) * cw + threadIdx.x];
    if (skey[end - 1] == key) {
      for (int64_t t = k + 1; t < n_tiles && skey[t * kTile] == key; ++t) {
        acc += partial[t * 2 * cw + threadIdx.x];
        if (skey[min64((t + 1) * kTile, m_total) - 1] != key) break;
      }
    }
    store(d_haloed + (int64_t)key * cw + threadIdx.x, acc);
  };

  if (k == 0 || skey[start - 1] != head) merge(head, 0);
  if (tail != head) merge(tail, 1);
}

template <typename T, int C>
int launch(const float* g, const float* local_frac, const int32_t* skey,
           const int64_t* perm, void* d_haloed, float* partial,
           int64_t m_total, int64_t n, int n_levels, cudaStream_t stream) {
  const int64_t n_tiles = (m_total + kTile - 1) / kTile;
  T* out = static_cast<T*>(d_haloed);
  trilinear_bwd_tiles<T, C><<<(unsigned)n_tiles, C * kRowPad, 0, stream>>>(
      g, local_frac, skey, perm, out, partial, m_total, n, n_levels);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  trilinear_bwd_merge<T, C><<<(unsigned)n_tiles, C * kRowPad, 0, stream>>>(
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
  if ((m_total + kTile - 1) / kTile > 0x7fffffff)
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
