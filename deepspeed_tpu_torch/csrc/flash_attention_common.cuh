// Shared pieces of the packed flash attention kernels (K1 forward in
// flash_attention_packed.cu, K2 backward in flash_attention_packed_bwd.cu):
// the tile shape, the masked-logit fill and the conversions between the
// input types and float32 (round to nearest even), written with the
// intrinsics only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace dstorch_attn {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
// thread (tr, tc) owns tile rows tr + 16 * i (i < 4) and columns tc + 8 * j
constexpr int kRowGroups = kThreads / 8;
constexpr int kRowsPerThread = kBlockQ / kRowGroups;
constexpr int kColsPerThread = kBlockK / 8;
constexpr float kNegInf = -1e30f;

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

}  // namespace dstorch_attn
