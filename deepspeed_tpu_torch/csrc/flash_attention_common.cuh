// Shared pieces of the attention kernels (the flash attention forward and
// backward in flash_attention_{fwd,bwd}.cu, the block-sparse forward and
// backward in block_sparse_attention_{fwd,bwd}.cu): the thread layout, the
// per-tensor strides, the masked-logit fill, the tile loader, the row
// reductions and the conversions between the input types and float32 (round
// to nearest even), written with the intrinsics only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace dstorch_attn {

constexpr int kThreads = 128;
// thread (tr, tc) of a block owns tile rows tr + 16 * i and columns tc + 8 * j
constexpr int kRowGroups = kThreads / 8;
constexpr float kNegInf = -1e30f;

// (batch, head, token) strides of one [B, H, T, D]-indexed tensor, in
// elements; the head dim has unit stride. The packed [B, T, H*D] layout is
// (T*H*D, D, H*D), a contiguous [B, H, T, D] is (H*T*D, T*D, D).
struct HeadStrides {
  long long b, h, t;
};

__device__ __forceinline__ long long head_offset(const HeadStrides& s, int b, int h) {
  return (long long)b * s.b + (long long)h * s.h;
}

// True when load_tile may read each 8-column chunk of these n tensors with
// 16-byte loads: d is a multiple of 8, and every base pointer and every
// (batch, head, token) stride, in bytes, is a multiple of 16.
inline bool chunks_aligned(const void* const* ptrs, const HeadStrides* strides, int n,
                           long long itemsize, int d) {
  if (d % 8 != 0) return false;
  for (int i = 0; i < n; ++i) {
    const HeadStrides& s = strides[i];
    if (reinterpret_cast<std::uintptr_t>(ptrs[i]) % 16 != 0 || s.b * itemsize % 16 != 0 ||
        s.h * itemsize % 16 != 0 || s.t * itemsize % 16 != 0)
      return false;
  }
  return true;
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to the input type and widened back: the kernels' rounding points
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// causal mask with the optional sliding window: keep 0 <= q - k < window
__device__ __forceinline__ bool keep_pair(int q_pos, int k_pos, int window) {
  return q_pos >= k_pos && (window <= 0 || q_pos - k_pos < window);
}

// Row length, in elements, of a shared-memory tile of T holding d8
// columns: d8 plus a pad that makes the row an odd number of 4-byte words,
// so that the rows a warp reads at one column fall on distinct banks.
template <typename T> __host__ __device__ constexpr int tile_ld(int d8) {
  return d8 + (sizeof(T) == 4 ? 1 : 2);
}

// rows [off, off + rows) of one head (x already offset to it) into a tile
// [rows][ld] of S (the input type T, or f32): columns [0, d) from x, [d, d8)
// zero, so that a dot product may run over d8 = d rounded up to 8 columns.
// Each thread takes 8 adjacent columns at a time and issues their loads
// before any store: with one element per iteration each load waited on the
// last (PERF.md). With vec (chunks_aligned) the 8 columns come in one
// 16-byte load (two for f32), so a warp's load covers 512 contiguous bytes
// instead of one 2-byte column in every 16 bytes of them.
template <typename T, typename S>
__device__ __forceinline__ void load_tile(S* dst, const T* __restrict__ x, long long stride_t,
                                          int off, int rows, int d, int d8, int ld, bool vec) {
  static_assert(std::is_same_v<S, T> || std::is_same_v<S, float>, "tiles: input type or f32");
  const int chunks = d8 / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c0 = (idx - r * chunks) * 8;
    const T* src = x + (long long)(off + r) * stride_t + c0;
    T vals[8];
    if (vec) {
      constexpr int kLoads = sizeof(T) / 2;
      uint4 raw[kLoads];
#pragma unroll
      for (int w = 0; w < kLoads; ++w) raw[w] = reinterpret_cast<const uint4*>(src)[w];
      memcpy(vals, raw, sizeof(vals));
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) vals[u] = c0 + u < d ? src[u] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if constexpr (std::is_same_v<S, T>) {
        dst[r * ld + c0 + u] = vals[u];
      } else {
        dst[r * ld + c0 + u] = to_f32<T>(vals[u]);
      }
    }
  }
}

// acc[i][j] = sum_c a[row_i][c] * b[col_j][c] in f32 over c < d8 (a
// multiple of 8) for this thread's rows tr + 16 i of a and rows tc + 8 j of b
template <typename T, int R, int C>
__device__ __forceinline__ void tile_dot(float (&acc)[R][C], const T* a, const T* b, int ld,
                                         int d8, int tr, int tc) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < d8; c0 += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float av[R], bv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) av[i] = to_f32<T>(a[(tr + kRowGroups * i) * ld + c0 + u]);
#pragma unroll
      for (int j = 0; j < C; ++j) bv[j] = to_f32<T>(b[(tc + 8 * j) * ld + c0 + u]);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// ---- pieces of the forward kernels (flash_attention_fwd.cu and the
// block-sparse block_sparse_attention_fwd.cu)

// sum / max over the 8 threads (consecutive lanes) that share a row
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// The shared-memory type of the forward kernels' Q, K and V tiles: f32 at
// the 64 head-dim ceiling (widened once as they are loaded, so the inner
// products read them with no conversion), the input type above it (which in
// bf16 at D = 128 fits two blocks on an SM where f32 tiles fit one)
template <typename T, int DMAX>
using FwdTile = std::conditional_t<DMAX <= 64, float, T>;

// ---- pieces of the backward kernels (flash_attention_bwd.cu and
// block_sparse_attention_bwd.cu)

// rows of a block's own tile (k rows in dkdv, q rows in dq) and of the
// tiles it loops over, by head-dim ceiling
template <int DMAX> struct Tiles {
  static constexpr int kOwn = DMAX > 128 ? 32 : 64;
  static constexpr int kLoop = 64;
};

// rows tr + 16 i of an [R * 16][d] f32 accumulator, written in the input type
template <typename T, int R, int C>
__device__ __forceinline__ void store_rows(T* __restrict__ out, long long stride_t, int off,
                                           const float (&acc)[R][C], int d, int tr, int tc) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T* row = out + (long long)(off + tr + kRowGroups * i) * stride_t;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = tc + 8 * c;
      if (col < d) row[col] = from_f32<T>(acc[i][c]);
    }
  }
}

// The head-dim ceilings the kernels are built for: f(ceiling, exact) with
// ceiling the smallest of 64, 128, 256 that holds d, and exact true when d
// is the ceiling itself, so that the common head dims run with d known at
// compile time and any other d is masked inside its ceiling.
template <typename F>
__host__ int dispatch_head_dim(int d, F&& f) {
  using std::integral_constant;
  if (d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  if (d == 64) return f(integral_constant<int, 64>(), std::true_type());
  if (d == 128) return f(integral_constant<int, 128>(), std::true_type());
  if (d == 256) return f(integral_constant<int, 256>(), std::true_type());
  if (d < 64) return f(integral_constant<int, 64>(), std::false_type());
  if (d < 128) return f(integral_constant<int, 128>(), std::false_type());
  return f(integral_constant<int, 256>(), std::false_type());
}

}  // namespace dstorch_attn
