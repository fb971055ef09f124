// trilinear_fwd: fused row gather + trilinear contraction of the paged
// hash grid, forward.
//
// Replaces the TPU kernel contract_fwd / _fwd_kernel in
// f2nerf_tpu/kernels/trilinear.py, together with the XLA row gather
// that fed it (f2nerf_tpu/ops/hash_paged.py _fetch_level,
// jnp.take(haloed, page_idx, mode="clip")).
//
// What it computes, per point i and level l, with page = page_idx[l, i]
// and (lx, ly, lz, fx, fy, fz) = local_frac[l, i]:
//   feat[i, l*C + c] = sum over the 8 corners (dx, dy, dz) in {0,1}^3 of
//       w * haloed[page, (25*(lx+dx) + 5*(ly+dy) + (lz+dz))*C + c]
//   w = (dx ? fx : 1-fx) * (dy ? fy : 1-fy) * (dz ? fz : 1-fz)
// which is the TPU kernel's 128-slot hat-weight reduction with only its
// 8 nonzero slots evaluated. Weights and sums are f32, the rows bf16 or
// f32, as in _fwd_kernel (rows.astype(f32) * w).
//
// Layout: haloed [P_total, 128*C] slot-major (bf16 or f32; see
// trilinear_common.cuh), page_idx [L, N] int32 (global page index),
// local_frac [L, N, 6] f32, feat [N, L*C] f32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the function reads
// 4 B of page index and 24 B of local_frac and writes 4C B of feat per
// (point, level), and reads each table cell the corners touch once (at
// most the 56 MB haloed table in bf16 at the default config): at the
// 8.4 M pairs of one mode-0 request about 0.43 GB, 0.13 ms. The work is
// about 80 flops per pair, far below the compute bound: the byte bound
// is the bound, and chip_smoke.py computes it from its own inputs.
//
// What holds the kernel above that bound is the number of L1/L2 sector
// requests, not DRAM bytes: the 32 lanes of a warp gather from 32
// unrelated pages, so every corner load is its own 32 B sector request
// whatever its width. With channel-major rows a pair took 8*C scalar
// corner loads plus C scalar stores 128 B apart (36 requests at C = 4).
//
// Design: the slot-major table makes a corner one vector load, 8 per
// pair; the block mapping of trilinear_common.cuh (warp = level, lane =
// point) keeps page_idx and local_frac reads coalesced; the block's
// [32, L*C] slice of feat is assembled in shared memory and written as
// one contiguous run with 16 B stores. About 10 requests per pair. No
// TMA and no wgmma: this is a gather with ~80 flops per pair, not a
// matrix product.

#include "trilinear_common.cuh"

namespace {

using namespace trilinear;

template <typename T, int C>
__global__ void __launch_bounds__(kMaxWarps * 32)
trilinear_fwd_kernel(const T* __restrict__ haloed,
                     const int32_t* __restrict__ page_idx,
                     const float* __restrict__ local_frac,
                     float* __restrict__ feat, int64_t n, int n_levels,
                     int64_t n_pages) {
  extern __shared__ float tile[];          // [kPoints][L*C + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row = n_levels * C;
  const int64_t i0 = (int64_t)blockIdx.x * kPoints;
  const int count = (int)(n - i0 < kPoints ? n - i0 : kPoints);

  if (lane < count) {
    for (int lvl = warp; lvl < n_levels; lvl += warps) {
      const Point p = read_point(page_idx, local_frac,
                                 (int64_t)lvl * n + i0 + lane, n_pages);
      const T* rowp = haloed + p.page * (int64_t)(kRowPad * C);
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
        const float w = ((dx ? p.fx : 1.f - p.fx) * (dy ? p.fy : 1.f - p.fy)) *
                        (dz ? p.fz : 1.f - p.fz);
        float v[C];
        load_corner<T, C>(rowp + corner_column<C>(p, k), v);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * v[c];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) tile[lane * (row + 1) + lvl * C + c] = acc[c];
    }
  }
  __syncthreads();
  move_run<false>(feat + i0 * row, tile, count * row, row);
}

template <typename T, int C>
int launch(const void* haloed, const int32_t* page_idx,
           const float* local_frac, float* feat, int64_t n, int n_levels,
           int64_t n_pages, cudaStream_t stream) {
  unsigned blocks;
  int threads;
  size_t smem;
  if (!launch_shape(n, n_levels, C, &blocks, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  trilinear_fwd_kernel<T, C><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(haloed), page_idx, local_frac, feat, n,
      n_levels, n_pages);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); an
// unsupported channel count, L*C over kMaxRowFloats or too many points
// return cudaErrorInvalidValue unlaunched. haloed must start 16 B-aligned
// and local_frac 8 B-aligned.
extern "C" int trilinear_fwd(const void* haloed, int haloed_is_bf16,
                             const int32_t* page_idx,
                             const float* local_frac, float* feat,
                             int64_t n, int n_levels, int n_channels,
                             int64_t n_pages, void* stream) {
  if (n == 0 || n_levels == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F2_CASE(CH)                                                        \
  case CH:                                                                 \
    return haloed_is_bf16                                                  \
               ? launch<__nv_bfloat16, CH>(haloed, page_idx, local_frac,   \
                                           feat, n, n_levels, n_pages, s)  \
               : launch<float, CH>(haloed, page_idx, local_frac, feat, n,  \
                                   n_levels, n_pages, s);
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
