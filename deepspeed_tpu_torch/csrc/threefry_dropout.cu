// Dropout on the JAX package's threefry keys, a hand-written Hopper kernel.
//
// It replaces no Pallas kernel: it is the counterpart of the JAX package's
// `_token_dropout` (deepspeed_tpu/models/gpt2.py:97-102) and of the
// attention-probability dropout of its plain attention
// (deepspeed_tpu/ops/flash_attention.py:45-47), which XLA fuses into one
// pass. The port needs it so that dropout keyed as `jax.random` keys it is
// affordable: the same arithmetic in plain PyTorch on the card takes some
// 130 elementwise passes over int64 tensors a call.
//
// One pass. Element i of the row-major tensor (i < n) takes counter
// c = offset + i (a 64-bit element offset: the tensor is then elements
// [offset, offset + n) of a larger draw, as a data-parallel rank's rows of
// the global batch are; jax_threefry_partitionable gives element c of a
// draw the bits of counter c), or, under the two-level map (inner > 0),
// c = offset + (i / inner) * stride + i % inner: segments of `inner`
// elements `stride` apart, as a tensor-parallel rank's heads of each row
// of the attention probabilities lie in the whole [B, H, T, T] draw. Then
//   bits = o0 ^ o1, (o0, o1) = Threefry-2x32(key, counter (c >> 32, c))
//   u    = bitcast<float>((bits >> 9) | 0x3F800000) - 1       (jax uniform)
//   keep = u < threshold                  (threshold = float32(1 - rate))
//   out  = round_T((float(x) * keep) / divisor)
// with the divisor `1 - rate` rounded to x's type first (the weak-typed
// Python float of `x * keep / (1.0 - rate)` in JAX) and IEEE division, as
// the JAX program divides (under jit XLA multiplies f32 and f16 by the
// reciprocal instead; bf16 gives the same bits either way). x * 0 keeps
// the sign of x (-0.0), as JAX's product does. The backward of dropout is
// this kernel on the gradient: JAX's transpose is (g / c) * keep, the same
// values.
//
// What bounds it on the H100: integer work, not bytes. Each element costs
// ~95 32-bit integer and float operations (20 threefry rounds of add,
// funnel-shift rotate and xor, 5 key injections, the float conversion,
// the compare and the division) against 2 to 8 bytes of traffic, so the
// ~64 INT32 lanes an SM (132 SMs) bind long before HBM's 3.35 TB/s. The
// design keeps every thread busy on independent hashes: a thread takes
// 16 bytes of x (4 f32 or 8 bf16/f16 elements) with one vector load and
// store where both pointers are 16-byte aligned, hashes each element's
// counter, and walks the tensor in a grid-stride loop; a ragged tail (n
// not a multiple of the vector) is done element by element. The key words
// are launch arguments: no device memory is read for them, so a dropout
// needs no host-device sync. The two-level map is a kernel of its own (the
// contiguous map keeps its instance, and its bits and time): a 64-bit
// division an element could cost as much as the hash, so each thread
// divides once, for its first index, and then carries (segment,
// remainder) across its grid stride with adds and one compare. Vectors
// stay 16 bytes where `inner` is a multiple of the vector width, so a
// vector never straddles two segments; elsewhere every element goes one
// by one under the same carried map.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, of the counter (hi, lo) under key (k0, k1):
// the xor of its two output words (jax.random.bits of one element).
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t hi,
                                                  uint32_t lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_ROUNDS_A
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUNDS_B
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUNDS_A
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUNDS_B
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUNDS_A
  x0 += k2;
  x1 += k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND
  return x0 ^ x1;
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_float<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

struct DropArgs {
  unsigned long long offset;  // the first element's counter
  unsigned long long inner;   // two-level map: segment length (0: contiguous)
  unsigned long long stride;  // and the counters between segment starts
  uint32_t k0, k1;
  float threshold;  // float32(1 - rate)
  float divisor;    // 1 - rate rounded to the element type
};

// x dropped at counter c.
template <typename T>
__device__ __forceinline__ T drop_at(T x, unsigned long long c, const DropArgs& a) {
  const uint32_t bits = threefry_bits(a.k0, a.k1, (uint32_t)(c >> 32), (uint32_t)c);
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float keep = u < a.threshold ? 1.0f : 0.0f;
  return from_float<T>(__fdiv_rn(__fmul_rn(to_float(x), keep), a.divisor));
}

template <typename T>
__device__ __forceinline__ T drop_one(T x, unsigned long long i, const DropArgs& a) {
  return drop_at(x, a.offset + i, a);
}

// (segment, remainder) of an element index under the map, advanced by a
// fixed step with the step's own quotient and remainder: no division in
// the loop.
struct MapWalker {
  unsigned long long seg, rem, dq, dr, inner;
  __device__ __forceinline__ MapWalker(unsigned long long i, unsigned long long step,
                                       unsigned long long inner_)
      : seg(i / inner_), rem(i % inner_), dq(step / inner_), dr(step % inner_), inner(inner_) {}
  __device__ __forceinline__ unsigned long long counter(const DropArgs& a) const {
    return a.offset + seg * a.stride + rem;
  }
  __device__ __forceinline__ void advance() {
    seg += dq;
    rem += dr;
    if (rem >= inner) {
      rem -= inner;
      ++seg;
    }
  }
};

// VEC elements (16 bytes) a step of each thread; `vec` is 0 when x or out
// is not 16-byte aligned, and then every element goes one by one.
template <typename T>
__global__ void threefry_dropout_kernel(const T* __restrict__ x, T* __restrict__ out,
                                        unsigned long long n, DropArgs a, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  const unsigned long long first = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const unsigned long long chunks = n / VEC;
    for (unsigned long long c = first; c < chunks; c += stride) {
      const unsigned long long base = c * VEC;
      alignas(16) T in[VEC];
      alignas(16) T res[VEC];
      *reinterpret_cast<uint4*>(in) = reinterpret_cast<const uint4*>(x)[c];
#pragma unroll
      for (int j = 0; j < VEC; ++j) res[j] = drop_one(in[j], base + j, a);
      reinterpret_cast<uint4*>(out)[c] = *reinterpret_cast<const uint4*>(res);
    }
    for (unsigned long long i = chunks * VEC + first; i < n; i += stride)
      out[i] = drop_one(x[i], i, a);
  } else {
    for (unsigned long long i = first; i < n; i += stride) out[i] = drop_one(x[i], i, a);
  }
}

// The two-level map (a.inner > 0). `vec` as above; 16-byte vectors only
// where a.inner is a multiple of the vector width.
template <typename T>
__global__ void threefry_dropout_mapped_kernel(const T* __restrict__ x, T* __restrict__ out,
                                               unsigned long long n, DropArgs a, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  const unsigned long long first = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec && a.inner % VEC == 0) {
    const unsigned long long chunks = n / VEC;
    MapWalker w(first * VEC, stride * VEC, a.inner);
    for (unsigned long long c = first; c < chunks; c += stride, w.advance()) {
      const unsigned long long base = w.counter(a);
      alignas(16) T in[VEC];
      alignas(16) T res[VEC];
      *reinterpret_cast<uint4*>(in) = reinterpret_cast<const uint4*>(x)[c];
#pragma unroll
      for (int j = 0; j < VEC; ++j) res[j] = drop_at(in[j], base + j, a);
      reinterpret_cast<uint4*>(out)[c] = *reinterpret_cast<const uint4*>(res);
    }
    for (unsigned long long i = chunks * VEC + first; i < n; i += stride)
      out[i] = drop_at(x[i], a.offset + (i / a.inner) * a.stride + i % a.inner, a);
  } else {
    MapWalker w(first, stride, a.inner);
    for (unsigned long long i = first; i < n; i += stride, w.advance())
      out[i] = drop_at(x[i], w.counter(a), a);
  }
}

template <typename T>
int launch(const void* x, void* out, unsigned long long n, const DropArgs& a, int vec,
           cudaStream_t s) {
  constexpr int kThreads = 256;
  constexpr int VEC = 16 / sizeof(T);
  const bool vectors = vec && (a.inner == 0 || a.inner % VEC == 0);
  const unsigned long long work = vectors ? (n + VEC - 1) / VEC : n;
  // enough blocks to fill 132 SMs many times over; the grid-stride loop
  // takes the rest
  unsigned long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132ull * 64) blocks = 132ull * 64;
  if (blocks < 1) blocks = 1;
  if (a.inner == 0)
    threefry_dropout_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, a, vec);
  else
    threefry_dropout_mapped_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, a, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Dropout of n contiguous elements of x into out (dtype 0 = float32, 1 =
// bfloat16, 2 = float16) under the key words (k0, k1), element i drawn at
// counter offset + i, or with inner > 0 at offset + (i / inner) * stride +
// i % inner: keep where the element's uniform is below `threshold`, then
// divide by `divisor`. `vec` = 1 when both pointers are 16-byte aligned.
// Returns the CUDA error of the launch (0 on success). The wrapper has
// checked types, layout and the map (inner 0 wherever it is contiguous).
extern "C" int dstorch_threefry_dropout(const void* x, void* out, long long n,
                                        unsigned long long offset, unsigned long long inner,
                                        unsigned long long stride, unsigned k0, unsigned k1,
                                        float threshold, float divisor, int dtype, int vec,
                                        void* stream) {
  if (n < 0 || dtype < 0 || dtype > 2 || (inner && stride < inner))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const DropArgs a{offset, inner, stride, k0, k1, threshold, divisor};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long count = (unsigned long long)n;
  switch (dtype) {
    case 0:
      return launch<float>(x, out, count, a, vec, s);
    case 1:
      return launch<__nv_bfloat16>(x, out, count, a, vec, s);
    default:
      return launch<__half>(x, out, count, a, vec, s);
  }
}
