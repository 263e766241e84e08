// Packed flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention_packed.py
// :_fwd_kernel (via _fwd). Same function: online-softmax attention over the
// packed layout q, k, v = [B, T, H*D], causal or not, with an optional
// sliding window (keep keys where 0 <= q - k < window), masked logits filled
// with -1e30 (not -inf), the row sum clamped l >= 1e-30, P rounded to the
// input type before P.V, and f32 accumulation. It writes O as [B, T, H*D]
// and lse = m + log(l) as [B, H, T] f32 (the TPU kernel's lane-packed lse
// layout was an artefact of the (8, 128) tiling).
//
// q, k and v are read in place from the [B, T, 3*H*D] qkv projection: the
// wrapper passes their pointers and one (batch, token) stride pair, so no
// head transpose and no contiguous copy is made.
//
// What bounds it on the H100: at GPT-2-125M's shape (B=8, T=1024, H=12,
// D=64, bf16, causal) the least time is ~15 us, set by the 50 MB of q/k/v/o
// at 3.35 TB/s (the 12.9 GFLOP of the two products take ~13 us at the
// 989 TFLOP/s bf16 tensor-core peak). This first version does not reach
// that bound: both products run as f32 FMAs on the CUDA cores, so it is
// bound by the FMA rate and shared-memory traffic. Its design keeps what
// matters for device memory: each (batch, head, 64-row q tile) block keeps
// its Q tile and running m/l/acc on chip and streams 64-row K/V tiles
// through shared memory, so q/k/v are read from device memory about
// T/128 times each (K/V) and once (Q), O and lse are written once, and no
// [T, T] score matrix ever leaves the SM. The K loop stops at the diagonal
// (causal) and starts at the window's first tile. wgmma, TMA and warp
// specialisation are later work.

#include "flash_attention_common.cuh"

namespace {

using namespace dstorch_attn;

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

template <int D>
constexpr size_t smem_bytes() {
  // Q, K, V tiles [64][D + 1] and the P tile [64][64 + 1], all f32; the +1
  // column keeps rows on distinct banks
  return sizeof(float) * (3 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int seq, int n_head,
           long long stride_b, long long stride_t, float scale, int causal, int window) {
  constexpr int kLd = D + 1;
  constexpr int kPld = kBlockK + 1;
  constexpr int kOutCols = (D + 7) / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * kLd;
  float* vs = ks + kBlockK * kLd;
  float* ps = vs + kBlockK * kLd;

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / n_head;
  const int h = bh - b * n_head;
  // the longest causal rows first, so the last wave is made of short ones
  const int q_off = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const long long head = (long long)b * stride_b + (long long)h * D;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    qs[r * kLd + c] = to_f32<T>(q[head + (long long)(q_off + r) * stride_t + c]);
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kOutCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? (q_off + kBlockQ + kBlockK - 1) / kBlockK : seq / kBlockK;
  int j0 = 0;
  if (causal && window > 0) {
    const int first = q_off - window + 1;
    j0 = (first > 0 ? first : 0) / kBlockK;
  }

  for (int j = j0; j < nk; ++j) {
    const int k_off = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const long long g = head + (long long)(k_off + r) * stride_t + c;
      ks[r * kLd + c] = to_f32<T>(k[g]);
      vs[r * kLd + c] = to_f32<T>(v[g]);
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int jj = 0; jj < kColsPerThread; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = qs[(tr + kRowGroups * i) * kLd + kk];
#pragma unroll
      for (int jj = 0; jj < kColsPerThread; ++jj) kv[jj] = ks[(tc + 8 * jj) * kLd + kk];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int jj = 0; jj < kColsPerThread; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = tr + kRowGroups * i;
      const int q_pos = q_off + row;
      float tile_max = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kColsPerThread; ++jj) {
        float x = s[i][jj] * scale;
        if (causal) {
          const int k_pos = k_off + tc + 8 * jj;
          if (!keep_pair(q_pos, k_pos, window)) x = kNegInf;
        }
        s[i][jj] = x;
        tile_max = fmaxf(tile_max, x);
      }
      // a row masked over the whole tile keeps m = -1e30 and sums
      // exp(0) = 1 per column here; alpha = exp(-1e30 - m) = 0 wipes that
      // at its first live tile, as on the TPU
      const float m_new = fmaxf(m[i], row_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float p_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kColsPerThread; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        p_sum += p;
        ps[row * kPld + tc + 8 * jj] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(p_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) pv[i] = ps[(tr + kRowGroups * i) * kPld + kk];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) {
        const int col = tc + 8 * c;
        if (col < D) {
          const float vv = vs[kk * kLd + col];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  const long long hd_total = (long long)n_head * D;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int q_pos = q_off + tr + kRowGroups * i;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)b * seq + q_pos) * hd_total + (long long)h * D;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int col = tc + 8 * c;
      if (col < D) orow[col] = from_f32<T>(acc[i][c] / lc);
    }
    if (tc == 0) lse[((long long)b * n_head + h) * seq + q_pos] = m[i] + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
           int seq, int n_head, long long stride_b, long long stride_t, float scale,
           int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * n_head, seq / kBlockQ);
  fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), seq, n_head, stride_b, stride_t, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int head_dim, const void* q, const void* k, const void* v, void* o, void* lse,
             int batch, int seq, int n_head, long long stride_b, long long stride_t,
             float scale, int causal, int window, cudaStream_t stream) {
#define DSTORCH_FA_CASE(DIM)                                                             \
  case DIM:                                                                              \
    return launch<T, DIM>(q, k, v, o, lse, batch, seq, n_head, stride_b, stride_t, scale, \
                          causal, window, stream);
  switch (head_dim) {
    DSTORCH_FA_CASE(1)
    DSTORCH_FA_CASE(2)
    DSTORCH_FA_CASE(4)
    DSTORCH_FA_CASE(8)
    DSTORCH_FA_CASE(16)
    DSTORCH_FA_CASE(32)
    DSTORCH_FA_CASE(64)
    DSTORCH_FA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DSTORCH_FA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns the CUDA error of
// the launch (0 on success). The wrapper has checked shapes and strides.
extern "C" int dstorch_flash_attention_packed_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch, int seq,
    int n_head, int head_dim, long long stride_b, long long stride_t, float scale,
    int causal, int window, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(head_dim, q, k, v, o, lse, batch, seq, n_head, stride_b,
                             stride_t, scale, causal, window, s);
    case 1:
      return launch_d<__nv_bfloat16>(head_dim, q, k, v, o, lse, batch, seq, n_head,
                                     stride_b, stride_t, scale, causal, window, s);
    case 2:
      return launch_d<__half>(head_dim, q, k, v, o, lse, batch, seq, n_head, stride_b,
                              stride_t, scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
