// Packed flash attention backward for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/flash_attention_packed.py
// :_bwd_kernel (via _bwd), the backward of K1. Same function: from q, k, v
// and dO in the packed layout [B, T, H*D], K1's lse [B, H, T] and
// delta = rowsum(dO * O) [B, H, T] (both f32), it computes, per (q, k) pair
// that the mask keeps,
//   p  = exp(s - lse)                      s = q.k * scale, masked s = -1e30
//   dv += round(p)^T . dO
//   dp = dO . v^T
//   ds = p * (dp - delta) * scale
//   dk += round(ds)^T . q,   dq += round(ds) . k
// with round() to the input type (the TPU kernel's rounding points) and f32
// accumulation; the window keeps 0 <= q - k < window.
//
// The TPU kernel carries dq across a sequential k-tile grid axis in a VMEM
// scratch. Hopper has no sequential grid, so the work is split into two
// kernels with no atomics, and the result is deterministic:
//   dkdv_kernel: one block per (batch, head, 64-row k tile); it loops over
//     the q tiles that reach its k tile and keeps dk, dv in registers.
//   dq_kernel: one block per (batch, head, 64-row q tile); it loops over
//     K1's k-tile range for that q tile and keeps dq in registers.
// Both read q/k/v in place from the [B, T, 3*H*D] qkv projection and write
// dq, dk, dv straight into the column thirds of one [B, T, 3*H*D] gradient,
// through (batch, token) strides.
//
// What bounds it on the H100: at GPT-2-125M's shape (B=8, T=1024, H=12,
// D=64, bf16, causal) the 50.4 M kept pairs cost 10*D FLOP each, 32.2 GFLOP
// in all, ~33 us at the 989 TFLOP/s bf16 tensor-core peak; the 88 MB read and
// written take ~26 us at 3.35 TB/s, so it is bound by operations. This first
// version does not approach that: every product runs as f32 FMAs on the CUDA
// cores, and the split recomputes s and dp in both kernels (14*D FLOP per
// pair instead of 10*D). What it keeps from the TPU design is that no
// [T, T] matrix leaves the SM: s, p, dp and ds live in registers and one
// 64x64 shared tile. wgmma, TMA and warp specialisation are later work.

#include "flash_attention_common.cuh"

namespace {

using namespace dstorch_attn;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int seq;
  int n_head;
  long long in_sb, in_st;    // q, k, v (batch, token) strides
  long long do_sb, do_st;    // dO
  long long out_sb, out_st;  // dq, dk, dv
  float scale;
  int causal;
  int window;
};

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles [64][D + 1], the P and dS tiles [64][64 + 1], all f32,
  // and one q tile's lse and delta
  return sizeof(float) * (4 * kBlockQ * (D + 1) + 2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles [64][D + 1] and the dS tile [64][64 + 1], all f32
  return sizeof(float) * (4 * kBlockQ * (D + 1) + kBlockQ * (kBlockK + 1));
}

// rows [off, off + 64) of one head of x into a [64][D + 1] f32 tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x, long long head,
                                          long long stride_t, int off) {
  for (int idx = threadIdx.x; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = to_f32<T>(x[head + (long long)(off + r) * stride_t + c]);
  }
}

// acc[i][j] = sum_d a[row_i][d] * b[col_j][d] over one pair of tiles, for
// this thread's rows tr + 16 i and columns tc + 8 j
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[kRowsPerThread][kColsPerThread],
                                         const float* a, const float* b, int tr, int tc) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < D; ++kk) {
    float av[kRowsPerThread], bv[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) av[i] = a[(tr + kRowGroups * i) * kLd + kk];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) bv[j] = b[(tc + 8 * j) * kLd + kk];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// rows tr + 16 i of a [64][D] f32 accumulator, written in the input type
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ out, long long head,
                                           long long stride_t, int off,
                                           const float (&acc)[kRowsPerThread][(D + 7) / 8],
                                           int tr, int tc) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    T* row = out + head + (long long)(off + tr + kRowGroups * i) * stride_t;
#pragma unroll
    for (int c = 0; c < (D + 7) / 8; ++c) {
      const int col = tc + 8 * c;
      if (col < D) row[col] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(BwdArgs a) {
  constexpr int kLd = D + 1;
  constexpr int kPld = kBlockQ + 1;
  constexpr int kCols = (D + 7) / 8;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBlockK * kLd;
  float* qs = vs + kBlockK * kLd;
  float* dos = qs + kBlockQ * kLd;
  float* pt = dos + kBlockQ * kLd;   // [k row][q col]: p rounded to T
  float* dst = pt + kBlockK * kPld;  // [k row][q col]: p, then ds rounded to T
  float* lse_s = dst + kBlockK * kPld;
  float* delta_s = lse_s + kBlockQ;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  // small k tiles first: under the causal mask they have the longest loops
  const int k_off = blockIdx.y * kBlockK;
  const long long in_head = (long long)b * a.in_sb + (long long)h * D;
  const long long do_head = (long long)b * a.do_sb + (long long)h * D;
  const float* lse = a.lse + (long long)bh * a.seq;
  const float* delta = a.delta + (long long)bh * a.seq;

  load_tile<T, D>(ks, k, in_head, a.in_st, k_off);
  load_tile<T, D>(vs, v, in_head, a.in_st, k_off);

  float dk[kRowsPerThread][kCols], dv[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the q tiles that reach this k tile (the TPU kernel's range, :159-162)
  int i0 = 0, i1 = a.seq / kBlockQ;
  if (a.causal) {
    i0 = k_off / kBlockQ;
    if (a.window > 0) {
      const int lim = (k_off + kBlockK + a.window - 1 + kBlockQ - 1) / kBlockQ;
      i1 = lim < i1 ? lim : i1;
    }
  }

  for (int i = i0; i < i1; ++i) {
    const int q_off = i * kBlockQ;
    __syncthreads();  // the previous q tile's readers are done
    load_tile<T, D>(qs, q, in_head, a.in_st, q_off);
    load_tile<T, D>(dos, dout, do_head, a.do_st, q_off);
    if (tid < kBlockQ) {
      lse_s[tid] = lse[q_off + tid];
      delta_s[tid] = delta[q_off + tid];
    }
    __syncthreads();

    // this thread's (k row, q column) pairs: k = k_off + tr + 16 r,
    // q = q_off + tc + 8 c
    float acc[kRowsPerThread][kColsPerThread];
    tile_dot<D>(acc, ks, qs, tr, tc);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = tr + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = tc + 8 * c;
        float s = acc[r][c] * a.scale;
        if (a.causal && !keep_pair(q_off + col, k_off + row, a.window)) s = kNegInf;
        const float p = expf(s - lse_s[col]);
        pt[row * kPld + col] = round_to<T>(p);
        dst[row * kPld + col] = p;
      }
    }
    tile_dot<D>(acc, vs, dos, tr, tc);  // dp, transposed
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = tr + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = tc + 8 * c;
        const float p = dst[row * kPld + col];  // written by this thread
        dst[row * kPld + col] = round_to<T>(p * (acc[r][c] - delta_s[col]) * a.scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockQ; ++c) {
      float pv[kRowsPerThread], dsv[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        pv[r] = pt[(tr + kRowGroups * r) * kPld + c];
        dsv[r] = dst[(tr + kRowGroups * r) * kPld + c];
      }
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int col = tc + 8 * cc;
        if (col < D) {
          const float dov = dos[c * kLd + col];
          const float qv = qs[c * kLd + col];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            dv[r][cc] = fmaf(pv[r], dov, dv[r][cc]);
            dk[r][cc] = fmaf(dsv[r], qv, dk[r][cc]);
          }
        }
      }
    }
  }

  const long long out_head = (long long)b * a.out_sb + (long long)h * D;
  store_rows<T, D>(static_cast<T*>(a.dk), out_head, a.out_st, k_off, dk, tr, tc);
  store_rows<T, D>(static_cast<T*>(a.dv), out_head, a.out_st, k_off, dv, tr, tc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  constexpr int kLd = D + 1;
  constexpr int kPld = kBlockK + 1;
  constexpr int kCols = (D + 7) / 8;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBlockQ * kLd;
  float* ks = dos + kBlockQ * kLd;
  float* vs = ks + kBlockK * kLd;
  float* dss = vs + kBlockK * kLd;  // [q row][k col]: p, then ds rounded to T

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  // the longest causal rows first, so the last wave is made of short ones
  const int q_off = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const long long in_head = (long long)b * a.in_sb + (long long)h * D;
  const long long do_head = (long long)b * a.do_sb + (long long)h * D;

  load_tile<T, D>(qs, q, in_head, a.in_st, q_off);
  load_tile<T, D>(dos, dout, do_head, a.do_st, q_off);
  float lse_r[kRowsPerThread], delta_r[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const long long at = (long long)bh * a.seq + q_off + tr + kRowGroups * r;
    lse_r[r] = a.lse[at];
    delta_r[r] = a.delta[at];
  }

  float dq[kRowsPerThread][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;

  // K1's k-tile range for this q tile
  const int nk = a.causal ? (q_off + kBlockQ + kBlockK - 1) / kBlockK : a.seq / kBlockK;
  int j0 = 0;
  if (a.causal && a.window > 0) {
    const int first = q_off - a.window + 1;
    j0 = (first > 0 ? first : 0) / kBlockK;
  }

  for (int j = j0; j < nk; ++j) {
    const int k_off = j * kBlockK;
    __syncthreads();  // the previous k tile's readers are done
    load_tile<T, D>(ks, k, in_head, a.in_st, k_off);
    load_tile<T, D>(vs, v, in_head, a.in_st, k_off);
    __syncthreads();

    // this thread's (q row, k column) pairs
    float acc[kRowsPerThread][kColsPerThread];
    tile_dot<D>(acc, qs, ks, tr, tc);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = tr + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = tc + 8 * c;
        float s = acc[r][c] * a.scale;
        if (a.causal && !keep_pair(q_off + row, k_off + col, a.window)) s = kNegInf;
        dss[row * kPld + col] = expf(s - lse_r[r]);
      }
    }
    tile_dot<D>(acc, dos, vs, tr, tc);  // dp
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int row = tr + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = tc + 8 * c;
        const float p = dss[row * kPld + col];  // written by this thread
        dss[row * kPld + col] = round_to<T>(p * (acc[r][c] - delta_r[r]) * a.scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float dsv[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) dsv[r] = dss[(tr + kRowGroups * r) * kPld + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int col = tc + 8 * cc;
        if (col < D) {
          const float kv = ks[c * kLd + col];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) dq[r][cc] = fmaf(dsv[r], kv, dq[r][cc]);
        }
      }
    }
  }

  const long long out_head = (long long)b * a.out_sb + (long long)h * D;
  store_rows<T, D>(static_cast<T*>(a.dq), out_head, a.out_st, q_off, dq, tr, tc);
}

template <typename T, int D>
int launch(const BwdArgs& a, int batch, cudaStream_t stream) {
  const dim3 grid(batch * a.n_head, a.seq / kBlockQ);
  constexpr size_t smem_kv = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, D><<<grid, kThreads, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem_q = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, D><<<grid, kThreads, smem_q, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int head_dim, const BwdArgs& a, int batch, cudaStream_t stream) {
#define DSTORCH_FA_BWD_CASE(DIM) \
  case DIM:                      \
    return launch<T, DIM>(a, batch, stream);
  switch (head_dim) {
    DSTORCH_FA_BWD_CASE(1)
    DSTORCH_FA_BWD_CASE(2)
    DSTORCH_FA_BWD_CASE(4)
    DSTORCH_FA_BWD_CASE(8)
    DSTORCH_FA_BWD_CASE(16)
    DSTORCH_FA_BWD_CASE(32)
    DSTORCH_FA_BWD_CASE(64)
    DSTORCH_FA_BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DSTORCH_FA_BWD_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Launches dkdv_kernel, then
// dq_kernel, on `stream`; returns the first CUDA error (0 on success). The
// wrapper has checked shapes, types and strides.
extern "C" int dstorch_flash_attention_packed_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, int batch, int seq, int n_head,
    int head_dim, long long in_sb, long long in_st, long long do_sb, long long do_st,
    long long out_sb, long long out_st, float scale, int causal, int window, int dtype,
    void* stream) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.seq = seq;
  a.n_head = n_head;
  a.in_sb = in_sb;
  a.in_st = in_st;
  a.do_sb = do_sb;
  a.do_st = do_st;
  a.out_sb = out_sb;
  a.out_st = out_st;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(head_dim, a, batch, s);
    case 1:
      return launch_d<__nv_bfloat16>(head_dim, a, batch, s);
    case 2:
      return launch_d<__half>(head_dim, a, batch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
