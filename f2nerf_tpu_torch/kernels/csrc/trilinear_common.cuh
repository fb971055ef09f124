// trilinear_common.cuh: the corner gather and the block mapping that
// trilinear_fwd.cu and trilinear_bwd_frac.cu share.
//
// Table layout (ops/hash_paged.py): the haloed table is slot-major.
// Page p's row holds 128 slots x C channels; element (slot s, channel c)
// sits at column s*C + c, with s = 25x + 5y + z over the page's 5x5x5
// haloed cells and slots 125..127 zero. A corner's C channels are
// therefore contiguous, C*sizeof(T) bytes (8 B for bf16 at C = 4), and
// aligned to that size: a row is 128*C*sizeof(T) bytes and the table
// starts on a 16 B boundary (the wrappers see to it). Each corner is one
// vector load (two 16 B loads for f32 at C = 8), so a (point, level) pair
// makes 8 table requests, where the channel-major rows took 8*C scalar
// ones.
//
// Block mapping: a block covers kPoints = 32 consecutive points and all
// L levels; warp w takes levels w, w + warps, ... and lane j point
// i0 + j. A warp's reads of page_idx [L, N] and local_frac [L, N, 6] are
// then 32 consecutive entries of one level (local_frac as three float2
// per lane: entry m starts at m*24 B, 8 B-aligned), and the block's part
// of a [N, L*C] f32 tensor (feat, g) is one contiguous run of 32*L*C
// floats, which the block moves with 16 B vector accesses through shared
// memory. The shared tile is [kPoints][L*C + 1]: the extra float puts the
// 32 rows that a warp touches at one time into 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace trilinear {

constexpr int kRowPad = 128;        // slots per haloed row
constexpr int kPoints = 32;         // points per block, one per lane
constexpr int kMaxWarps = 8;        // warps per block; levels stride over them
constexpr int kMaxRowFloats = 256;  // largest L*C: a 33 KB shared tile

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int kBytes>
struct Raw;
template <>
struct Raw<2> { using type = unsigned short; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<16> { using type = uint4; };

// The C channels of the corner at `p`, widened to f32: one load of
// C*sizeof(T) bytes, or two of 16 B for 32 B.
template <typename T, int C>
__device__ __forceinline__ void load_corner(const T* __restrict__ p,
                                            float (&v)[C]) {
  constexpr int kBytes = C * (int)sizeof(T);
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  using U = typename Raw<kChunk>::type;
  U raw[kBytes / kChunk];
#pragma unroll
  for (int k = 0; k < kBytes / kChunk; ++k)
    raw[k] = reinterpret_cast<const U*>(p)[k];
  const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = to_float(t[c]);
}

struct Point {
  int64_t page;
  int lx, ly, lz;
  float fx, fy, fz;
};

// Entry m = lvl*N + i of page_idx and local_frac. The page is clamped
// like the gather's mode="clip" and the local coords to [0, 3]; both are
// in range by construction.
__device__ __forceinline__ Point read_point(const int32_t* __restrict__ page_idx,
                                            const float* __restrict__ local_frac,
                                            int64_t m, int64_t n_pages) {
  int64_t page = page_idx[m];
  page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
  const float2* lf = reinterpret_cast<const float2*>(local_frac) + m * 3;
  const float2 a = lf[0], b = lf[1], c = lf[2];
  Point p;
  p.page = page;
  p.lx = min(max((int)a.x, 0), 3);
  p.ly = min(max((int)a.y, 0), 3);
  p.lz = min(max((int)b.x, 0), 3);
  p.fx = b.y;
  p.fy = c.x;
  p.fz = c.y;
  return p;
}

// Column of corner k = (dx, dy, dz) = (k>>2, (k>>1)&1, k&1) of `p` in a
// slot-major row of C channels.
template <int C>
__device__ __forceinline__ int corner_column(const Point& p, int k) {
  const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
  return (25 * (p.lx + dx) + 5 * (p.ly + dy) + (p.lz + dz)) * C;
}

// Element e of the block's [count, row] run in the shared tile, whose
// rows are row + 1 floats apart: (e / row) * (row + 1) + e % row.
__device__ __forceinline__ float& tile_at(float* tile, int e, int row) {
  return tile[e + e / row];
}

// The block's run of `total` = count*row floats, moved between device
// memory at `dev` (16 B-aligned) and the shared tile, four floats a
// thread at a time; the ragged end one float at a time.
template <bool kToShared, typename P>
__device__ __forceinline__ void move_run(P dev, float* tile, int total,
                                         int row) {
  for (int q = 4 * (int)threadIdx.x; q < total; q += 4 * (int)blockDim.x) {
    if (q + 4 <= total) {
      if constexpr (kToShared) {
        const float4 v = *reinterpret_cast<const float4*>(dev + q);
        tile_at(tile, q, row) = v.x;
        tile_at(tile, q + 1, row) = v.y;
        tile_at(tile, q + 2, row) = v.z;
        tile_at(tile, q + 3, row) = v.w;
      } else {
        *reinterpret_cast<float4*>(dev + q) =
            make_float4(tile_at(tile, q, row), tile_at(tile, q + 1, row),
                        tile_at(tile, q + 2, row), tile_at(tile, q + 3, row));
      }
    } else {
      for (int e = q; e < total; ++e) {
        if constexpr (kToShared)
          tile_at(tile, e, row) = dev[e];
        else
          dev[e] = tile_at(tile, e, row);
      }
    }
  }
}

// Launch shape for n points and L levels (kPoints points a block) and
// the shared tile's bytes; false when L*C is over kMaxRowFloats or the
// grid too large.
inline bool launch_shape(int64_t n, int n_levels, int n_channels,
                         unsigned* blocks, int* threads, size_t* smem) {
  const int row = n_levels * n_channels;
  const int64_t b = (n + kPoints - 1) / kPoints;
  if (n_levels < 1 || row > kMaxRowFloats || b > 0x7fffffff) return false;
  *blocks = (unsigned)b;
  *threads = 32 * (n_levels < kMaxWarps ? n_levels : kMaxWarps);
  *smem = sizeof(float) * kPoints * (row + 1);
  return true;
}

}  // namespace trilinear
