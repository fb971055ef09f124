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
//       w * haloed[page, c*128 + 25*(lx+dx) + 5*(ly+dy) + (lz+dz)]
//   w = (dx ? fx : 1-fx) * (dy ? fy : 1-fy) * (dz ? fz : 1-fz)
// which is the TPU kernel's 128-slot hat-weight reduction with only its
// 8 nonzero slots evaluated. Weights and sums are f32, the rows bf16 or
// f32, as in _fwd_kernel (rows.astype(f32) * w).
//
// Layout: haloed [P_total, C*128] (bf16 or f32), page_idx [L, N] int32
// (global page index), local_frac [L, N, 6] f32, feat [N, L*C] f32.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): per (point, level)
// the useful bytes are 8 corners x C x 2 B of table (bf16), 4 B of page
// index, 24 B of local_frac and 16 B of output, about 108 B; at the
// 8.4 M (point, level) pairs of one mode-0 localize request that is
// about 0.9 GB, 0.27 ms. Counting each input byte once, the table is
// read at most once (56 MB haloed in bf16 at the default config), so
// the least traffic is about 56 MB + 44 B per pair = 0.43 GB, 0.13 ms;
// chip_smoke.py computes this bound from its own inputs. The work is
// about 80 flops per pair, far below the compute bound: the kernel is
// bound by bytes. The scattered corner reads move whole 32 B sectors
// (one per channel and z-pair of corners: 4 x 32 B for 16 useful bytes
// per channel, ~8x), and the 56 MB haloed table is about the size of the 50 MB L2,
// so how many of those sectors come from device memory rather than L2
// depends on the points' locality.
//
// Design (simple first): one thread per (point, level), level-major so
// neighbouring threads read neighbouring page_idx / local_frac entries;
// C accumulators in registers; no shared memory, no TMA, no wgmma.

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
trilinear_fwd_kernel(const T* __restrict__ haloed,
                     const int32_t* __restrict__ page_idx,
                     const float* __restrict__ local_frac,
                     float* __restrict__ feat, int64_t n, int n_levels,
                     int64_t n_pages) {
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (m >= n * n_levels) return;
  const int lvl = (int)(m / n);
  const int64_t i = m - (int64_t)lvl * n;

  // in range by construction; clamp like the gather's mode="clip"
  int64_t page = page_idx[m];
  page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
  const float* lf = local_frac + m * 6;
  const int lx = min(max((int)lf[0], 0), 3);
  const int ly = min(max((int)lf[1], 0), 3);
  const int lz = min(max((int)lf[2], 0), 3);
  const float fx = lf[3], fy = lf[4], fz = lf[5];
  const T* row = haloed + page * (int64_t)(C * kRowPad);

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const float w = ((dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy)) *
                    (dz ? fz : 1.f - fz);
    const int slot = 25 * (lx + dx) + 5 * (ly + dy) + (lz + dz);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += w * to_float(row[c * kRowPad + slot]);
  }
  float* out = feat + i * (int64_t)(n_levels * C) + lvl * C;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = acc[c];
}

template <typename T, int C>
void launch(const void* haloed, const int32_t* page_idx,
            const float* local_frac, float* feat, int64_t n, int n_levels,
            int64_t n_pages, cudaStream_t stream) {
  const int64_t total = n * n_levels;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  trilinear_fwd_kernel<T, C><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(haloed), page_idx, local_frac, feat, n,
      n_levels, n_pages);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); an
// unsupported channel count returns cudaErrorInvalidValue unlaunched.
extern "C" int trilinear_fwd(const void* haloed, int haloed_is_bf16,
                             const int32_t* page_idx,
                             const float* local_frac, float* feat,
                             int64_t n, int n_levels, int n_channels,
                             int64_t n_pages, void* stream) {
  if (n * n_levels == 0) return 0;
  if ((n * n_levels + kThreads - 1) / kThreads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define F2_CASE(CH)                                                        \
  case CH:                                                                 \
    if (haloed_is_bf16)                                                    \
      launch<__nv_bfloat16, CH>(haloed, page_idx, local_frac, feat, n,     \
                                n_levels, n_pages, s);                     \
    else                                                                   \
      launch<float, CH>(haloed, page_idx, local_frac, feat, n, n_levels,   \
                        n_pages, s);                                       \
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
