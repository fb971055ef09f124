// trilinear_bwd_frac: point gradient of the paged hash encode, the
// gradient of trilinear_fwd's output with respect to the trilinear
// fractions.
//
// Replaces the TPU kernel contract_bwd_frac / _bwd_frac_kernel in
// f2nerf_tpu/kernels/trilinear.py, together with the XLA row re-gather
// that fed it (f2nerf_tpu/ops/hash_paged.py _encode_core_bwd ->
// _fetch_level) and the zero `local` columns the JAX backward
// concatenates in front of it.
//
// What it computes, per point i and level l, with page = page_idx[l, i],
// (lx, ly, lz, fx, fy, fz) = local_frac[l, i] and the cotangent
// g_c = g[i, l*C + c] of feat[i, l*C + c]:
//   v_k   = sum_c g_c * haloed[page, (25*(lx+dx) + 5*(ly+dy) + (lz+dz))*C + c]
//           for the 8 corners k = (dx, dy, dz) in {0,1}^3
//   d_fx  = sum_k v_k * (dx ? +1 : -1) * wy * wz, and alike for y and z,
//   w_ax  = (d_ax ? f_ax : 1 - f_ax)
// which is the TPU kernel's 128-slot reduction
// sum_s d_w[s] * dw_x[s] * w_y[s] * w_z[s] with only its 8 nonzero slots
// evaluated. At f == 0 exactly it gives the one-sided -1 / +1 of the JAX
// jnp branch (_dfrac_level's one-hot weight row); the Pallas hat
// derivative gives 0 there. g is f32 and the rows are widened to f32
// before the product, as in _bwd_frac_kernel; all sums are f32.
//
// Layout: haloed [P_total, 128*C] slot-major (bf16 or f32; see
// trilinear_common.cuh), page_idx [L, N] int32 (global page index),
// local_frac [L, N, 6] f32, g [N, L*C] f32, d_local_frac [L, N, 6] f32:
// columns 0-2 (the integer `local` coords) are written as zeros, columns
// 3-5 get d_frac, so the autograd backward returns the whole tensor
// without a concatenation.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): per (point, level)
// the function must read 4 B of page index, 24 B of local_frac and
// C x 4 B of g, and write 12 B of d_frac; the table cells the corners
// touch are read once each (at most the 56 MB haloed table in bf16).
// At one mode-1 step's 13.0 M (point, level) pairs that is about
// 0.75 GB, 0.22 ms; the work is ~136 flops per pair, 1.8 GFLOP, far
// below the compute bound: the byte bound is the bound, and
// chip_smoke.py computes it from its own inputs.
//
// As in trilinear_fwd.cu, what holds the kernel above that bound is the
// number of sector requests: channel-major rows took 8*C scalar corner
// loads per pair, plus C scalar loads of g 128 B apart and 6 scalar
// stores (44 requests at C = 4).
//
// Design: trilinear_fwd's (trilinear_common.cuh): one vector load per
// corner, warp = level and lane = point, so page_idx and local_frac
// reads are coalesced. The block's [32, L*C] slice of g is one
// contiguous run, read with 16 B loads into shared memory, where each
// thread takes its C values. Each thread writes its 6 outputs as three
// float2. About 13 requests per pair. No atomics: each output has one
// writer, so two launches on the same inputs are bitwise equal.

#include "trilinear_common.cuh"

namespace {

using namespace trilinear;

template <typename T, int C>
__global__ void __launch_bounds__(kMaxWarps * 32)
trilinear_bwd_frac_kernel(const T* __restrict__ haloed,
                          const int32_t* __restrict__ page_idx,
                          const float* __restrict__ local_frac,
                          const float* __restrict__ g,
                          float* __restrict__ d_local_frac, int64_t n,
                          int n_levels, int64_t n_pages) {
  extern __shared__ float tile[];          // [kPoints][L*C + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row = n_levels * C;
  const int64_t i0 = (int64_t)blockIdx.x * kPoints;
  const int count = (int)(n - i0 < kPoints ? n - i0 : kPoints);

  move_run<true>(g + i0 * row, tile, count * row, row);
  __syncthreads();
  if (lane >= count) return;

  for (int lvl = warp; lvl < n_levels; lvl += warps) {
    const int64_t m = (int64_t)lvl * n + i0 + lane;
    const Point p = read_point(page_idx, local_frac, m, n_pages);
    const T* rowp = haloed + p.page * (int64_t)(kRowPad * C);
    float gc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) gc[c] = tile[lane * (row + 1) + lvl * C + c];

    float dfx = 0.f, dfy = 0.f, dfz = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      float corner[C];
      load_corner<T, C>(rowp + corner_column<C>(p, k), corner);
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) v += gc[c] * corner[c];
      const float wx = dx ? p.fx : 1.f - p.fx;
      const float wy = dy ? p.fy : 1.f - p.fy;
      const float wz = dz ? p.fz : 1.f - p.fz;
      dfx += (dx ? v : -v) * (wy * wz);
      dfy += (dy ? v : -v) * (wx * wz);
      dfz += (dz ? v : -v) * (wx * wy);
    }
    float2* out = reinterpret_cast<float2*>(d_local_frac) + m * 3;
    out[0] = make_float2(0.f, 0.f);
    out[1] = make_float2(0.f, dfx);
    out[2] = make_float2(dfy, dfz);
  }
}

template <typename T, int C>
int launch(const void* haloed, const int32_t* page_idx,
           const float* local_frac, const float* g, float* d_local_frac,
           int64_t n, int n_levels, int64_t n_pages, cudaStream_t stream) {
  unsigned blocks;
  int threads;
  size_t smem;
  if (!launch_shape(n, n_levels, C, &blocks, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  trilinear_bwd_frac_kernel<T, C><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(haloed), page_idx, local_frac, g, d_local_frac,
      n, n_levels, n_pages);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); an
// unsupported channel count, L*C over kMaxRowFloats or too many points
// return cudaErrorInvalidValue unlaunched. haloed and g must start
// 16 B-aligned, local_frac and d_local_frac 8 B-aligned.
extern "C" int trilinear_bwd_frac(const void* haloed, int haloed_is_bf16,
                                  const int32_t* page_idx,
                                  const float* local_frac, const float* g,
                                  float* d_local_frac, int64_t n,
                                  int n_levels, int n_channels,
                                  int64_t n_pages, void* stream) {
  if (n == 0 || n_levels == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F2_CASE(CH)                                                         \
  case CH:                                                                  \
    return haloed_is_bf16                                                   \
               ? launch<__nv_bfloat16, CH>(haloed, page_idx, local_frac, g, \
                                           d_local_frac, n, n_levels,       \
                                           n_pages, s)                      \
               : launch<float, CH>(haloed, page_idx, local_frac, g,         \
                                   d_local_frac, n, n_levels, n_pages, s);
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
