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
//   v_k   = sum_c g_c * haloed[page, c*128 + 25*(lx+dx) + 5*(ly+dy) + (lz+dz)]
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
// Layout: haloed [P_total, C*128] (bf16 or f32), page_idx [L, N] int32
// (global page index), local_frac [L, N, 6] f32, g [N, L*C] f32,
// d_local_frac [L, N, 6] f32: columns 0-2 (the integer `local` coords)
// are written as zeros, columns 3-5 get d_frac, so the autograd
// backward returns the whole tensor without a concatenation.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): per (point, level)
// the function must read 4 B of page index, 24 B of local_frac and
// C x 4 B of g, and write 12 B of d_frac; the table cells the corners
// touch are read once each (at most the 56 MB haloed table in bf16).
// At one mode-1 step's 13.0 M (point, level) pairs that is about
// 0.75 GB, 0.22 ms; the work is ~136 flops per pair, 1.8 GFLOP, far
// below the compute bound: the kernel is bound by bytes.
// chip_smoke.py computes the bound from its own inputs.
//
// Design (simple first, as trilinear_fwd.cu): one thread per (point,
// level), level-major so neighbouring threads read neighbouring
// page_idx / local_frac entries; the 8 corners gathered by the thread
// itself, so no [N, C*128] rows buffer exists; C cotangents and three
// accumulators in registers; no shared memory, no atomics (each output
// is written by one thread, so two launches are bitwise equal).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowPad = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_frac_kernel(const T* __restrict__ haloed,
                          const int32_t* __restrict__ page_idx,
                          const float* __restrict__ local_frac,
                          const float* __restrict__ g,
                          float* __restrict__ d_local_frac, int64_t n,
                          int n_levels, int64_t n_pages) {
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (m >= n * n_levels) return;
  const int lvl = (int)(m / n);
  const int64_t i = m - (int64_t)lvl * n;

  // in range by construction; clamp like the forward's gather
  int64_t page = page_idx[m];
  page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
  const float* lf = local_frac + m * 6;
  const int lx = min(max((int)lf[0], 0), 3);
  const int ly = min(max((int)lf[1], 0), 3);
  const int lz = min(max((int)lf[2], 0), 3);
  const float fx = lf[3], fy = lf[4], fz = lf[5];
  const T* row = haloed + page * (int64_t)(C * kRowPad);

  float gc[C];
  const float* gi = g + i * (int64_t)(n_levels * C) + lvl * C;
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = gi[c];

  float dfx = 0.f, dfy = 0.f, dfz = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const int slot = 25 * (lx + dx) + 5 * (ly + dy) + (lz + dz);
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) v += gc[c] * to_float(row[c * kRowPad + slot]);
    const float wx = dx ? fx : 1.f - fx;
    const float wy = dy ? fy : 1.f - fy;
    const float wz = dz ? fz : 1.f - fz;
    dfx += (dx ? v : -v) * (wy * wz);
    dfy += (dy ? v : -v) * (wx * wz);
    dfz += (dz ? v : -v) * (wx * wy);
  }
  float* out = d_local_frac + m * 6;
  out[0] = 0.f;
  out[1] = 0.f;
  out[2] = 0.f;
  out[3] = dfx;
  out[4] = dfy;
  out[5] = dfz;
}

template <typename T, int C>
void launch(const void* haloed, const int32_t* page_idx,
            const float* local_frac, const float* g, float* d_local_frac,
            int64_t n, int n_levels, int64_t n_pages, cudaStream_t stream) {
  const int64_t total = n * n_levels;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  trilinear_bwd_frac_kernel<T, C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(haloed), page_idx, local_frac, g, d_local_frac,
      n, n_levels, n_pages);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); an
// unsupported channel count returns cudaErrorInvalidValue unlaunched.
extern "C" int trilinear_bwd_frac(const void* haloed, int haloed_is_bf16,
                                  const int32_t* page_idx,
                                  const float* local_frac, const float* g,
                                  float* d_local_frac, int64_t n,
                                  int n_levels, int n_channels,
                                  int64_t n_pages, void* stream) {
  if (n * n_levels == 0) return 0;
  if ((n * n_levels + kThreads - 1) / kThreads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F2_CASE(CH)                                                         \
  case CH:                                                                  \
    if (haloed_is_bf16)                                                     \
      launch<__nv_bfloat16, CH>(haloed, page_idx, local_frac, g,            \
                                d_local_frac, n, n_levels, n_pages, s);     \
    else                                                                    \
      launch<float, CH>(haloed, page_idx, local_frac, g, d_local_frac, n,   \
                        n_levels, n_pages, s);                              \
    break;
  switch (n_channels) {
    F2_CASE(1)
    F2_CASE(2)
    F2_CASE(4)
    F2_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef F2_CASE
  return (int)cudaGetLastError();
}
