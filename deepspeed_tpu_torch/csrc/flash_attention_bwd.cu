// Flash attention backward for Hopper (sm_90a): K2, K3b/K5 and K4b.
//
// Replaces four TPU kernels that compute one function, the backward of the
// forward in flash_attention_fwd.cu:
//   K2   deepspeed_tpu/ops/pallas/flash_attention_packed.py:_bwd_kernel (via
//        _bwd), over the packed layout [B, T, H*D];
//   K3b  deepspeed_tpu/ops/pallas/flash_attention.py:_bwd_fused_kernel (via
//        _bwd_fused), over [B, H, T, D], dq carried in a VMEM scratch across
//        a sequential k-tile grid;
//   K5   deepspeed_tpu/ops/pallas/flash_attention.py:_bwd_dq_kernel +
//        _bwd_dkv_kernel (via _bwd with DSTPU_FLASH_BWD != fused), the same
//        function split into a dq and a dk/dv kernel;
//   K4b  deepspeed_tpu/ops/pallas/flash_attention.py:_bwd_dq_kernel_streamed
//        + _bwd_dkv_kernel_streamed (via _bwd_streamed), K5's split over
//        long T with K/V (and Q/dO) blocks on a third grid axis.
// From q, k, v and dO, the forward's lse [B, H, T] and delta = rowsum(dO*O)
// [B, H, T] (both f32), it computes, per (q, k) pair that the mask keeps,
//   p  = exp(s - lse)                      s = q.k * scale, masked s = -1e30
//   dv += round(p)^T . dO
//   dp = dO . v^T
//   ds = p * (dp - delta) * scale
//   dk += round(ds)^T . q,   dq += round(ds) . k
// with round() to the input type (the TPU kernels' rounding points; ds uses
// the unrounded p) and f32 accumulation; the window keeps 0 <= q - k <
// window. Every tensor comes with its own (batch, head, token) strides and a
// unit head-dim stride: the packed K2 call reads q/k/v in place from the
// [B, T, 3*H*D] qkv projection and writes dq/dk/dv into the column thirds of
// one [B, T, 3*H*D] gradient; the K3b/K5 call takes any [B, H, T, D] views.
//
// Hopper has no sequential grid to carry dq across, so the work is K5's
// split, two kernels with no atomics and a deterministic result:
//   dkdv_kernel: one block per (batch, head, k tile); it loops over the q
//     tiles that reach its k tile and keeps dk, dv in registers.
//   dq_kernel: one block per (batch, head, q tile); it loops over the
//     forward's k-tile range for that q tile and keeps dq in registers.
// The head dim is any d <= 256: built for d = 64, 128 and 256 exactly and
// for each of those ceilings with a runtime d masked inside. The q, k, v
// and dO tiles are kept in shared memory in the input type: at D = 128 in
// bf16 two blocks then share an SM, where f32 tiles left room for one,
// which more than halved the time at LLaMA-7B's shape (PERF.md).
// Up to 128 both kernels use 64 x 64 tiles. At 256, four f32 [64][257]
// tiles (263 KB) would exceed the 227 KB a block may hold, and 64 rows of
// dk and dv would take 256 registers a thread, so the block's own tile is
// cut to 32 rows (dkdv: 32 k rows against 64-row q tiles; dq: 32 q rows
// against 64-row k tiles): 128 accumulator registers a thread and at most
// ~210 KB (f32 inputs).
//
// What bounds it on the H100: at LLaMA-7B's attention shape (B=4, H=32,
// T=2048, D=128, bf16, causal) the 268.6 M kept pairs cost 10*D FLOP each,
// 343.8 GFLOP, ~0.348 ms at the 989 TFLOP/s bf16 tensor-core peak; the
// 472 MB read and written take ~0.141 ms at 3.35 TB/s, so it is bound by
// operations. This version does not approach that: every product runs as
// f32 FMAs on the CUDA cores, and the split recomputes s and dp in both
// kernels (14*D FLOP per pair instead of 10*D). What it keeps from the TPU
// design is that no [T, T] matrix leaves the SM: s, p, dp and ds live in
// registers and shared tiles. wgmma, TMA and warp specialisation are later
// work.

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
  HeadStrides sq, sk, sv, sdo, sdq, sdk, sdv;
  int seq, n_head, d;
  float scale;
  int causal, window;
  bool vec;  // q, k, v, dout chunks_aligned
};

// K, V tiles [own][ld] and Q, dO tiles [loop][ld] in the input type; the P
// and dS tiles [own][loop + 1] and one q tile's lse and delta in f32
template <typename T, int DMAX>
size_t dkdv_smem_bytes(int d8) {
  constexpr int own = Tiles<DMAX>::kOwn, loop = Tiles<DMAX>::kLoop;
  return sizeof(T) * 2 * (own + loop) * tile_ld<T>(d8) +
         sizeof(float) * (2 * own * (loop + 1) + 2 * loop);
}

// Q, dO tiles [own][ld] and K, V tiles [loop][ld] in the input type; the dS
// tile [own][loop + 1] in f32
template <typename T, int DMAX>
size_t dq_smem_bytes(int d8) {
  constexpr int own = Tiles<DMAX>::kOwn, loop = Tiles<DMAX>::kLoop;
  return sizeof(T) * 2 * (own + loop) * tile_ld<T>(d8) + sizeof(float) * own * (loop + 1);
}

// EXACT: d == DMAX, known at compile time; otherwise d < DMAX is masked
template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(BwdArgs a) {
  constexpr int kK = Tiles<DMAX>::kOwn;   // k rows of this block
  constexpr int kQ = Tiles<DMAX>::kLoop;  // q rows of each visited tile
  constexpr int kR = kK / kRowGroups;
  constexpr int kC = kQ / 8;
  constexpr int kCols = DMAX / 8;
  constexpr int kPld = kQ + 1;
  const int d = EXACT ? DMAX : a.d;
  const int d8 = EXACT ? DMAX : (d + 7) & ~7;
  const int ld = tile_ld<T>(d8);
  extern __shared__ float smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kK * ld;
  T* qs = vs + kK * ld;
  T* dos = qs + kQ * ld;
  // [k row][q col] f32 tiles: p rounded to T; p, then ds rounded to T
  float* pt = reinterpret_cast<float*>(dos + kQ * ld);
  float* dst = pt + kK * kPld;
  float* lse_s = dst + kK * kPld;
  float* delta_s = lse_s + kQ;

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  // small k tiles first: under the causal mask they have the longest loops
  const int k_off = blockIdx.y * kK;
  const T* q = static_cast<const T*>(a.q) + head_offset(a.sq, b, h);
  const T* dout = static_cast<const T*>(a.dout) + head_offset(a.sdo, b, h);
  const float* lse = a.lse + (long long)bh * a.seq;
  const float* delta = a.delta + (long long)bh * a.seq;

  load_tile<T>(ks, static_cast<const T*>(a.k) + head_offset(a.sk, b, h), a.sk.t, k_off, kK, d,
               d8, ld, a.vec);
  load_tile<T>(vs, static_cast<const T*>(a.v) + head_offset(a.sv, b, h), a.sv.t, k_off, kK, d,
               d8, ld, a.vec);

  float dk[kR][kCols], dv[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the q tiles that reach this k tile (the TPU kernels' range)
  int i0 = 0, i1 = a.seq / kQ;
  if (a.causal) {
    i0 = k_off / kQ;
    if (a.window > 0) {
      const int lim = (k_off + kK + a.window - 1 + kQ - 1) / kQ;
      i1 = lim < i1 ? lim : i1;
    }
  }

  for (int i = i0; i < i1; ++i) {
    const int q_off = i * kQ;
    __syncthreads();  // the previous q tile's readers are done
    load_tile<T>(qs, q, a.sq.t, q_off, kQ, d, d8, ld, a.vec);
    load_tile<T>(dos, dout, a.sdo.t, q_off, kQ, d, d8, ld, a.vec);
    if (tid < kQ) {
      lse_s[tid] = lse[q_off + tid];
      delta_s[tid] = delta[q_off + tid];
    }
    __syncthreads();

    // this thread's (k row, q column) pairs: k = k_off + tr + 16 r,
    // q = q_off + tc + 8 c
    float acc[kR][kC];
    tile_dot(acc, ks, qs, ld, d8, tr, tc);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = tr + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = tc + 8 * c;
        float s = acc[r][c] * a.scale;
        if (a.causal && !keep_pair(q_off + col, k_off + row, a.window)) s = kNegInf;
        const float p = expf(s - lse_s[col]);
        pt[row * kPld + col] = round_to<T>(p);
        dst[row * kPld + col] = p;
      }
    }
    tile_dot(acc, vs, dos, ld, d8, tr, tc);  // dp, transposed
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = tr + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = tc + 8 * c;
        const float p = dst[row * kPld + col];  // written by this thread
        dst[row * kPld + col] = round_to<T>(p * (acc[r][c] - delta_s[col]) * a.scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kQ; ++c) {
      float pv[kR], dsv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        pv[r] = pt[(tr + kRowGroups * r) * kPld + c];
        dsv[r] = dst[(tr + kRowGroups * r) * kPld + c];
      }
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int col = tc + 8 * cc;
        if (col < d) {
          const float dov = to_f32<T>(dos[c * ld + col]);
          const float qv = to_f32<T>(qs[c * ld + col]);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            dv[r][cc] = fmaf(pv[r], dov, dv[r][cc]);
            dk[r][cc] = fmaf(dsv[r], qv, dk[r][cc]);
          }
        }
      }
    }
  }

  store_rows<T>(static_cast<T*>(a.dk) + head_offset(a.sdk, b, h), a.sdk.t, k_off, dk, d, tr,
                tc);
  store_rows<T>(static_cast<T*>(a.dv) + head_offset(a.sdv, b, h), a.sdv.t, k_off, dv, d, tr,
                tc);
}

template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdArgs a) {
  constexpr int kQ = Tiles<DMAX>::kOwn;   // q rows of this block
  constexpr int kK = Tiles<DMAX>::kLoop;  // k rows of each visited tile
  constexpr int kR = kQ / kRowGroups;
  constexpr int kC = kK / 8;
  constexpr int kCols = DMAX / 8;
  constexpr int kPld = kK + 1;
  const int d = EXACT ? DMAX : a.d;
  const int d8 = EXACT ? DMAX : (d + 7) & ~7;
  const int ld = tile_ld<T>(d8);
  extern __shared__ float smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + kQ * ld;
  T* ks = dos + kQ * ld;
  T* vs = ks + kK * ld;
  // [q row][k col] f32 tile: p, then ds rounded to T
  float* dss = reinterpret_cast<float*>(vs + kK * ld);

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  // the longest causal rows first, so the last wave is made of short ones
  const int q_off = (gridDim.y - 1 - blockIdx.y) * kQ;
  const T* k = static_cast<const T*>(a.k) + head_offset(a.sk, b, h);
  const T* v = static_cast<const T*>(a.v) + head_offset(a.sv, b, h);

  load_tile<T>(qs, static_cast<const T*>(a.q) + head_offset(a.sq, b, h), a.sq.t, q_off, kQ, d,
               d8, ld, a.vec);
  load_tile<T>(dos, static_cast<const T*>(a.dout) + head_offset(a.sdo, b, h), a.sdo.t, q_off,
               kQ, d, d8, ld, a.vec);
  float lse_r[kR], delta_r[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const long long at = (long long)bh * a.seq + q_off + tr + kRowGroups * r;
    lse_r[r] = a.lse[at];
    delta_r[r] = a.delta[at];
  }

  float dq[kR][kCols];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;

  // the forward's k-tile range for this q tile
  const int nk = a.causal ? (q_off + kQ + kK - 1) / kK : a.seq / kK;
  int j0 = 0;
  if (a.causal && a.window > 0) {
    const int first = q_off - a.window + 1;
    j0 = (first > 0 ? first : 0) / kK;
  }

  for (int j = j0; j < nk; ++j) {
    const int k_off = j * kK;
    __syncthreads();  // the previous k tile's readers are done
    load_tile<T>(ks, k, a.sk.t, k_off, kK, d, d8, ld, a.vec);
    load_tile<T>(vs, v, a.sv.t, k_off, kK, d, d8, ld, a.vec);
    __syncthreads();

    // this thread's (q row, k column) pairs
    float acc[kR][kC];
    tile_dot(acc, qs, ks, ld, d8, tr, tc);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = tr + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = tc + 8 * c;
        float s = acc[r][c] * a.scale;
        if (a.causal && !keep_pair(q_off + row, k_off + col, a.window)) s = kNegInf;
        dss[row * kPld + col] = expf(s - lse_r[r]);
      }
    }
    tile_dot(acc, dos, vs, ld, d8, tr, tc);  // dp
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int row = tr + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = tc + 8 * c;
        const float p = dss[row * kPld + col];  // written by this thread
        dss[row * kPld + col] = round_to<T>(p * (acc[r][c] - delta_r[r]) * a.scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kK; ++c) {
      float dsv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) dsv[r] = dss[(tr + kRowGroups * r) * kPld + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int col = tc + 8 * cc;
        if (col < d) {
          const float kv = to_f32<T>(ks[c * ld + col]);
#pragma unroll
          for (int r = 0; r < kR; ++r) dq[r][cc] = fmaf(dsv[r], kv, dq[r][cc]);
        }
      }
    }
  }

  store_rows<T>(static_cast<T*>(a.dq) + head_offset(a.sdq, b, h), a.sdq.t, q_off, dq, d, tr,
                tc);
}

template <typename T, int DMAX, bool EXACT>
int launch(const BwdArgs& a, int batch, cudaStream_t stream) {
  constexpr int own = Tiles<DMAX>::kOwn;
  const int d8 = (a.d + 7) & ~7;
  // each ceiling's shared memory is the most any d under it asks for
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<T, DMAX, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem_bytes<T, DMAX>(DMAX));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_head, a.seq / own);
  dkdv_kernel<T, DMAX, EXACT>
      <<<grid, kThreads, dkdv_smem_bytes<T, DMAX>(d8), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel<T, DMAX, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem_bytes<T, DMAX>(DMAX));
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, DMAX, EXACT><<<grid, kThreads, dq_smem_bytes<T, DMAX>(d8), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const BwdArgs& a, int batch, cudaStream_t stream) {
  return dispatch_head_dim(a.d, [&](auto dmax, auto exact) {
    return launch<T, decltype(dmax)::value, decltype(exact)::value>(a, batch, stream);
  });
}

}  // namespace

// strides: 21 values, the (batch, head, token) strides of q, k, v, dout,
// dq, dk and dv in that order. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. seq must be a multiple of 64. Launches dkdv_kernel, then
// dq_kernel, on `stream`; returns the first CUDA error (0 on success). The
// wrapper has checked shapes, types and strides.
extern "C" int dstorch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dq, void* dk, void* dv, int batch, int seq,
                                           int n_head, int head_dim, const long long* strides,
                                           float scale, int causal, int window, int dtype,
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
  HeadStrides* dst[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *dst[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.seq = seq;
  a.n_head = n_head;
  a.d = head_dim;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  const void* inputs[4] = {q, k, v, dout};
  const HeadStrides input_strides[4] = {a.sq, a.sk, a.sv, a.sdo};
  a.vec = chunks_aligned(inputs, input_strides, 4, dtype == 0 ? 4 : 2, head_dim);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(a, batch, s);
    case 1:
      return launch_d<__nv_bfloat16>(a, batch, s);
    case 2:
      return launch_d<__half>(a, batch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
