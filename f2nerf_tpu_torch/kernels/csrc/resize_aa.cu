// resize_aa: the localizer's resize of the node's frame, on the card.
//
// Replaces no TPU kernel: the JAX package resizes on the host (PIL). It
// was added because the port's host resize, utils/image_io.resize_image,
// held the device idle for a third of each frame (numpy's quantize of
// the 850x1920x3 float32 frame, then ATen's CPU antialiased bilinear).
// resize_image stays the specification, and this kernel gives its
// float32 values bit for bit:
//
//   q        = trunc(clip(x * 255 + 0.5, 0, 255))       numpy, two roundings
//   h[r, x]  = sum over the width taps of q * w_x        ATen's first pass
//   v[y, x]  = sum over the height taps r of h[r, x] * w_y   its second pass
//   out      = clip(round_half_even(v), 0, 255) / 255
//
// Each sum is ATen's: out = x0 * w0, then out += x_j * w_j in index
// order, in float32. Taps 1 .. plain round the product and the add apart,
// later taps are one fused multiply-add, as ATen's AVX2 / AVX-512 builds
// compile the leftover taps of their loop unrolled by four. The wrapper
// (kernels/resize.py) reads each output's taps, weights and split from
// ATen itself. Explicit _rn intrinsics keep the compiler from contracting
// a product and an add that ATen rounds apart.
//
// Layout: image [H, W, C] float32, out [h, w, C] float32 (HWC, contiguous);
// rows [3, h] int32 (first tap, tap count, plain) and row_w [h, row_k]
// float32, the same for the columns.
//
// Bound on an H100 SXM (3.35 TB/s): the frame read once and the result
// written once, 19.6 MB + 0.31 MB at 850x1920 -> 106x240, 5.9 us. The
// work, about 17 x 17 taps per output value and 17 quantizes per tap
// row, stays far below the float32 rate.
//
// Design: one block row per output row (grid.x), one thread per output
// (column, channel) (grid.y covers wide rows). A thread streams the
// height taps' input rows; for each it sums the width taps from the
// frame itself (the taps of neighbouring columns overlap, so most reads
// hit L1) and adds the row's sum into its height accumulator, in ATen's
// order. No shared memory: the frame is read about four times through
// L1/L2, which costs microseconds, where the frame's copy to the card
// costs milliseconds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// numpy's x * 255.0 + 0.5 in float32 (two passes, two roundings), clip
// to [0, 255] and the truncation of astype(uint8). fmaxf maps NaN to 0.
__device__ __forceinline__ float quantize(float x) {
  const float v = __fadd_rn(__fmul_rn(x, 255.f), 0.5f);
  return truncf(fminf(fmaxf(v, 0.f), 255.f));
}

// one tap of ATen's sum: a rounded product then a rounded add, or one
// fused multiply-add
__device__ __forceinline__ float tap(float acc, float x, float w,
                                     bool fused) {
  return fused ? __fmaf_rn(x, w, acc) : __fadd_rn(acc, __fmul_rn(x, w));
}

__global__ void __launch_bounds__(kThreads)
resize_aa_kernel(const float* __restrict__ image, int w_in, int channels,
                 const int32_t* __restrict__ rows,
                 const float* __restrict__ row_w, int row_k, int h_out,
                 const int32_t* __restrict__ cols,
                 const float* __restrict__ col_w, int col_k, int w_out,
                 float* __restrict__ out) {
  const int y = blockIdx.x;
  const int t = blockIdx.y * kThreads + threadIdx.x;  // column * C + channel
  if (t >= w_out * channels) return;
  const int x = t / channels, ch = t - x * channels;
  const int y0 = rows[y], ny = rows[h_out + y], y_plain = rows[2 * h_out + y];
  const int x0 = cols[x], nx = cols[w_out + x], x_plain = cols[2 * w_out + x];
  const float* wy = row_w + (int64_t)y * row_k;
  const float* wx = col_w + (int64_t)x * col_k;

  float acc = 0.f;
  for (int j = 0; j < ny; ++j) {
    const float* src =
        image + ((int64_t)(y0 + j) * w_in + x0) * channels + ch;
    float h = __fmul_rn(quantize(__ldg(src)), __ldg(wx));
    for (int i = 1; i < nx; ++i)
      h = tap(h, quantize(__ldg(src + (int64_t)i * channels)), __ldg(wx + i),
              i > x_plain);
    acc = j == 0 ? __fmul_rn(h, __ldg(wy)) : tap(acc, h, __ldg(wy + j),
                                                 j > y_plain);
  }
  const float q = fminf(fmaxf(rintf(acc), 0.f), 255.f);
  out[(int64_t)y * w_out * channels + t] = __fdiv_rn(q, 255.f);
}

}  // namespace

extern "C" int resize_aa(const float* image, int w_in, int channels,
                         const int32_t* rows, const float* row_w, int row_k,
                         int h_out, const int32_t* cols, const float* col_w,
                         int col_k, int w_out, float* out,
                         cudaStream_t stream) {
  if (h_out <= 0 || w_out <= 0 || channels <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(h_out, (w_out * channels + kThreads - 1) / kThreads);
  resize_aa_kernel<<<grid, kThreads, 0, stream>>>(
      image, w_in, channels, rows, row_w, row_k, h_out, cols, col_w, col_k,
      w_out, out);
  return (int)cudaGetLastError();
}
