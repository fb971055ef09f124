// page_index: the paged encode's index, from contracted points to each
// (level, point) pair's global page and its local cell and fractions,
// in one pass.
//
// Replaces no TPU kernel: the JAX package computes the index in XLA
// (f2nerf_tpu/ops/hash_paged.py _page_indices_lm), and the port did it
// with ops/hash_paged.page_indices, about 20 eager ATen passes over
// [L, N, 3] and [L, N] tensors, then a concatenation into local_frac.
// page_indices stays the specification, and this kernel gives its values
// bit for bit:
//
//   pt    = x * scale[l] + bias[l]           a rounded product, a rounded add
//   f     = floor(pt);  frac = pt - f;  ip = int32(f)
//   local = ip & 3
//   blk   = uint32(ip >> 2)                  an arithmetic shift
//   page  = (blk.x * a[l] + blk.y * b[l] + blk.z) mod 2^32 mod n_pages[l]
//           + page_offset[l]
//
// The plain version hashes in int64 with each product and the sum masked
// to 32 bits, which gives the uint32 residues used here. Explicit _rn
// intrinsics keep the compiler from contracting the product and the add
// into one fused multiply-add, which ATen rounds apart.
//
// Layout: points [N, 3] f32; the level constants on the device: scales
// [L] f32, biases [L, 3] f32, a, b, n_pages, page_offset [L] int64;
// outputs page_idx [L, N] int32 and local_frac [L, N, 6] f32 (local xyz
// as floats, then frac xyz), the layout the trilinear kernels take.
//
// Bound on an H100 SXM (3.35 TB/s): 12 B read per point and 4 + 24 B
// written per (level, point) pair; at the ~30 integer and float
// operations a pair that is bytes by two orders of magnitude. A frame's
// 3.27 M points at 16 levels: 1.5 GB, 0.44 ms.
//
// Design: one thread per point, which reads its point once and walks the
// levels. The level constants are staged in shared memory once a block.
// Per level the warp writes its 32 page indices as one coalesced run,
// and the block's [256, 6] slice of local_frac, one contiguous run of
// 6 KB, goes through shared memory and out as 8 B stores that neighbour
// threads make to neighbouring addresses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // points a block, one a thread
constexpr int kMaxLevels = 1024;   // shared constants: 32 KB
constexpr int kBlock = 4;          // cells per page axis

struct Level {
  float scale, bias[3];
  uint32_t a, b, n_pages;
  int32_t offset;
};

__global__ void __launch_bounds__(kThreads)
page_index_kernel(const float* __restrict__ points, int64_t n, int n_levels,
                  const float* __restrict__ scales,
                  const float* __restrict__ biases,
                  const int64_t* __restrict__ a,
                  const int64_t* __restrict__ b,
                  const int64_t* __restrict__ n_pages,
                  const int64_t* __restrict__ page_offset,
                  int32_t* __restrict__ page_idx,
                  float* __restrict__ local_frac) {
  __shared__ float2 tile[kThreads * 3];          // [256, 6] f32
  extern __shared__ Level levels[];              // [L]
  for (int l = threadIdx.x; l < n_levels; l += kThreads) {
    Level c;
    c.scale = scales[l];
    for (int k = 0; k < 3; ++k) c.bias[k] = biases[3 * l + k];
    c.a = (uint32_t)a[l];
    c.b = (uint32_t)b[l];
    c.n_pages = (uint32_t)n_pages[l];
    c.offset = (int32_t)page_offset[l];
    levels[l] = c;
  }
  const int64_t i0 = (int64_t)blockIdx.x * kThreads;
  const int64_t i = i0 + threadIdx.x;
  const int count = (int)(n - i0 < kThreads ? n - i0 : kThreads);
  float x[3] = {0.f, 0.f, 0.f};
  if (i < n) {
    for (int k = 0; k < 3; ++k) x[k] = points[3 * i + k];
  }
  __syncthreads();

  for (int l = 0; l < n_levels; ++l) {
    const Level c = levels[l];
    float out[6];
    uint32_t blk[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float pt = __fadd_rn(__fmul_rn(x[k], c.scale), c.bias[k]);
      const float f = floorf(pt);
      const int32_t ip = static_cast<int32_t>(f);
      out[k] = (float)(ip & (kBlock - 1));
      out[3 + k] = __fsub_rn(pt, f);
      blk[k] = (uint32_t)(ip >> 2);
    }
    const uint32_t raw = blk[0] * c.a + blk[1] * c.b + blk[2];
    const int64_t m0 = (int64_t)l * n + i0;
    if (i < n)
      page_idx[m0 + threadIdx.x] = (int32_t)(raw % c.n_pages) + c.offset;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      tile[3 * threadIdx.x + k] = make_float2(out[2 * k], out[2 * k + 1]);
    __syncthreads();
    // the block's run starts at float 6 * m0: 8 B-aligned
    float2* dst = reinterpret_cast<float2*>(local_frac) + 3 * m0;
    for (int q = threadIdx.x; q < 3 * count; q += kThreads) dst[q] = tile[q];
    __syncthreads();
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); more than
// kMaxLevels levels or too many points return cudaErrorInvalidValue
// unlaunched. local_frac must start 8 B-aligned.
extern "C" int page_index(const float* points, int64_t n, int n_levels,
                          const float* scales, const float* biases,
                          const int64_t* a, const int64_t* b,
                          const int64_t* n_pages,
                          const int64_t* page_offset, int32_t* page_idx,
                          float* local_frac, void* stream) {
  if (n == 0 || n_levels == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n_levels < 0 || n_levels > kMaxLevels || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  page_index_kernel<<<(unsigned)blocks, kThreads, n_levels * sizeof(Level),
                      static_cast<cudaStream_t>(stream)>>>(
      points, n, n_levels, scales, biases, a, b, n_pages, page_offset,
      page_idx, local_frac);
  return (int)cudaGetLastError();
}
