// Block-sparse attention backward for Hopper (sm_90a): K7.
//
// Replaces the TPU kernels deepspeed_tpu/ops/pallas/block_sparse_attention.py:
// _dq_kernel and _dkv_kernel (via _bwd), the backward of the forward in
// block_sparse_attention_fwd.cu. From q, k, v and dO, the forward's lse
// [B, H, T] and delta = rowsum(dO*O) [B, H, T] (both f32), it computes, for
// each (q, k) pair of every visited coarse tile pair,
//   p  = exp(s - lse)            s = q.k * scale, fine-masked s = -1e30
//   dv += round(p)^T . dO
//   dp = dO . v^T
//   ds = p * (dp - delta) * scale
//   dk += round(ds)^T . q,   dq += round(ds) . k
// with round() to the input type (the TPU kernels' rounding points) and f32
// accumulation. The visited pairs are the TPU kernels' own: dq walks each q
// tile's live k tiles (kcols / nnz), dk/dv walk each k tile's live q tiles
// (the transposed plan qrows_t / nnz_t), and the fine layout [H][nb][nb]
// (uint8) masks inside a tile.
//
// The design is the split of flash_attention_bwd.cu, with no atomics and a
// deterministic result:
//   sparse_dkdv_kernel: one block per (batch * head, k rows of a coarse
//     tile); it loops over its k tile's live q tiles, each in 64-row
//     sub-tiles, and keeps dk, dv in registers;
//   sparse_dq_kernel: one block per (batch * head, q rows of a coarse tile);
//     it loops over its q tile's live k tiles, each in 64-key sub-tiles, and
//     keeps dq in registers.
// A block's own tile is 64 rows (32 at the 256 head-dim ceiling, as in
// flash_attention_bwd.cu, for the same register and shared-memory limits);
// the fine-layout window of each sub-tile pair is staged in shared memory.
//
// What bounds it on the H100: the function needs the live fine pairs, 10*D
// FLOP each at the bf16 tensor-core peak, and 7 * B*H*T*D values read and
// written; both are far under a millisecond at BERT-large's T 4096. This
// version runs every product as f32 FMAs on the CUDA cores over whole
// visited coarse tiles and recomputes s and dp in both kernels (14*D FLOP a
// visited pair), so it is bound by the FMA rate over the visited pairs.
// wgmma, TMA and skipping dead sub-tiles are later work.

#include "flash_attention_common.cuh"

namespace {

using namespace dstorch_attn;

constexpr int kMaxWin = 5;  // fine blocks along 64 rows, at most, for fb >= 16

struct SparseBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  const int* kcols;        // [H][nt][max_nnz]
  const int* nnz;          // [H][nt]
  const int* qrows_t;      // [H][nt][max_nnz_t]
  const int* nnz_t;        // [H][nt]
  const uint8_t* layout;   // [H][nb][nb]
  int max_nnz, max_nnz_t, tile, fine_block;
  HeadStrides sq, sk, sv, sdo, sdq, sdk, sdv;
  int seq, n_head, d;
  float scale;
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

// The fine layout of rows [q_off, q_off + nq) x columns [k_off, k_off + nk)
// of head h, one byte per fine-block pair, into win[(q fine) * kMaxWin +
// (k fine)] relative to (q_off / fb, k_off / fb). The caller synchronises.
__device__ __forceinline__ void load_window(uint8_t* win, const uint8_t* lay, int nb, int fb,
                                            int q_off, int nq, int k_off, int nk) {
  const int qf0 = q_off / fb, kf0 = k_off / fb;
  const int nfq = (q_off + nq - 1) / fb - qf0 + 1;
  const int nfk = (k_off + nk - 1) / fb - kf0 + 1;
  const int tid = threadIdx.x;
  if (tid < nfq * nfk) {
    const int r = tid / nfk;
    const int c = tid - r * nfk;
    win[r * kMaxWin + c] = lay[(long long)(qf0 + r) * nb + kf0 + c];
  }
}

template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) sparse_dkdv_kernel(SparseBwdArgs a) {
  constexpr int kK = Tiles<DMAX>::kOwn;   // k rows of this block
  constexpr int kQ = Tiles<DMAX>::kLoop;  // q rows of each visited sub-tile
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
  __shared__ uint8_t win[kMaxWin * kMaxWin];

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  const int k_off = blockIdx.y * kK;
  const int nt = a.seq / a.tile;
  const int kt = k_off / a.tile;
  const int* rows = a.qrows_t + ((long long)h * nt + kt) * a.max_nnz_t;
  const int n = a.nnz_t[h * nt + kt];
  const int fb = a.fine_block;
  const int nb = a.seq / fb;
  const uint8_t* lay = a.layout + (long long)h * nb * nb;
  const int kf0 = k_off / fb;
  const T* q = static_cast<const T*>(a.q) + head_offset(a.sq, b, h);
  const T* dout = static_cast<const T*>(a.dout) + head_offset(a.sdo, b, h);
  const float* lse = a.lse + (long long)bh * a.seq;
  const float* delta = a.delta + (long long)bh * a.seq;

  load_tile<T>(ks, static_cast<const T*>(a.k) + head_offset(a.sk, b, h), a.sk.t, k_off, kK, d,
               d8, ld, a.vec);
  load_tile<T>(vs, static_cast<const T*>(a.v) + head_offset(a.sv, b, h), a.sv.t, k_off, kK, d,
               d8, ld, a.vec);

  float dk[kR][kCols], dv[kR][kCols];
  int wk[kR];  // this thread's k rows' fine columns in the window
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    wk[i] = (k_off + tr + kRowGroups * i) / fb - kf0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int jj = 0; jj < n; ++jj) {
    const int tile_off = rows[jj] * a.tile;
    for (int sub = 0; sub < a.tile; sub += kQ) {
      const int q_off = tile_off + sub;
      const int qf0 = q_off / fb;
      __syncthreads();  // the previous q tile's readers are done
      load_tile<T>(qs, q, a.sq.t, q_off, kQ, d, d8, ld, a.vec);
      load_tile<T>(dos, dout, a.sdo.t, q_off, kQ, d, d8, ld, a.vec);
      if (tid < kQ) {
        lse_s[tid] = lse[q_off + tid];
        delta_s[tid] = delta[q_off + tid];
      }
      load_window(win, lay, nb, fb, q_off, kQ, k_off, kK);
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
          if (!win[((q_off + col) / fb - qf0) * kMaxWin + wk[r]]) s = kNegInf;
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
  }

  store_rows<T>(static_cast<T*>(a.dk) + head_offset(a.sdk, b, h), a.sdk.t, k_off, dk, d, tr,
                tc);
  store_rows<T>(static_cast<T*>(a.dv) + head_offset(a.sdv, b, h), a.sdv.t, k_off, dv, d, tr,
                tc);
}

template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) sparse_dq_kernel(SparseBwdArgs a) {
  constexpr int kQ = Tiles<DMAX>::kOwn;   // q rows of this block
  constexpr int kK = Tiles<DMAX>::kLoop;  // k rows of each visited sub-tile
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
  __shared__ uint8_t win[kMaxWin * kMaxWin];

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  const int q_off = blockIdx.y * kQ;
  const int nt = a.seq / a.tile;
  const int qt = q_off / a.tile;
  const int* cols = a.kcols + ((long long)h * nt + qt) * a.max_nnz;
  const int n = a.nnz[h * nt + qt];
  const int fb = a.fine_block;
  const int nb = a.seq / fb;
  const uint8_t* lay = a.layout + (long long)h * nb * nb;
  const int qf0 = q_off / fb;
  const T* k = static_cast<const T*>(a.k) + head_offset(a.sk, b, h);
  const T* v = static_cast<const T*>(a.v) + head_offset(a.sv, b, h);

  load_tile<T>(qs, static_cast<const T*>(a.q) + head_offset(a.sq, b, h), a.sq.t, q_off, kQ, d,
               d8, ld, a.vec);
  load_tile<T>(dos, static_cast<const T*>(a.dout) + head_offset(a.sdo, b, h), a.sdo.t, q_off,
               kQ, d, d8, ld, a.vec);
  float lse_r[kR], delta_r[kR];
  int wq[kR];  // this thread's q rows' fine rows in the window
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int q_pos = q_off + tr + kRowGroups * r;
    const long long at = (long long)bh * a.seq + q_pos;
    lse_r[r] = a.lse[at];
    delta_r[r] = a.delta[at];
    wq[r] = q_pos / fb - qf0;
  }

  float dq[kR][kCols];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[r][c] = 0.f;

  for (int jj = 0; jj < n; ++jj) {
    const int tile_off = cols[jj] * a.tile;
    for (int sub = 0; sub < a.tile; sub += kK) {
      const int k_off = tile_off + sub;
      const int kf0 = k_off / fb;
      __syncthreads();  // the previous k tile's readers are done
      load_tile<T>(ks, k, a.sk.t, k_off, kK, d, d8, ld, a.vec);
      load_tile<T>(vs, v, a.sv.t, k_off, kK, d, d8, ld, a.vec);
      load_window(win, lay, nb, fb, q_off, kQ, k_off, kK);
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
          if (!win[wq[r] * kMaxWin + (k_off + col) / fb - kf0]) s = kNegInf;
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
  }

  store_rows<T>(static_cast<T*>(a.dq) + head_offset(a.sdq, b, h), a.sdq.t, q_off, dq, d, tr,
                tc);
}

template <typename T, int DMAX, bool EXACT>
int launch(const SparseBwdArgs& a, int batch, cudaStream_t stream) {
  constexpr int own = Tiles<DMAX>::kOwn;
  const int d8 = (a.d + 7) & ~7;
  cudaError_t err = cudaFuncSetAttribute(sparse_dkdv_kernel<T, DMAX, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_smem_bytes<T, DMAX>(DMAX));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_head, a.seq / own);
  sparse_dkdv_kernel<T, DMAX, EXACT>
      <<<grid, kThreads, dkdv_smem_bytes<T, DMAX>(d8), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sparse_dq_kernel<T, DMAX, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem_bytes<T, DMAX>(DMAX));
  if (err != cudaSuccess) return (int)err;
  sparse_dq_kernel<T, DMAX, EXACT><<<grid, kThreads, dq_smem_bytes<T, DMAX>(d8), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const SparseBwdArgs& a, int batch, cudaStream_t stream) {
  return dispatch_head_dim(a.d, [&](auto dmax, auto exact) {
    return launch<T, decltype(dmax)::value, decltype(exact)::value>(a, batch, stream);
  });
}

}  // namespace

// kcols/nnz and qrows_t/nnz_t: the plan and its transpose, [H][nt][width]
// and [H][nt] int32 (nt = seq / tile); layout: [H][seq / fine_block]
// [seq / fine_block] uint8. strides: 21 values, the (batch, head, token)
// strides of q, k, v, dout, dq, dk and dv. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. tile must be a multiple of 64 and
// fine_block >= 16 must divide it. Launches sparse_dkdv_kernel, then
// sparse_dq_kernel, on `stream`; returns the first CUDA error (0 on
// success). The wrapper has checked shapes, types and strides.
extern "C" int dstorch_block_sparse_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, void* dk, void* dv, const void* kcols,
                                        const void* nnz, const void* layout, int max_nnz,
                                        int tile, int fine_block, const void* qrows_t,
                                        const void* nnz_t, int max_nnz_t, int batch, int seq,
                                        int n_head, int head_dim, const long long* strides,
                                        float scale, int dtype, void* stream) {
  if (tile % 64 != 0 || fine_block < 16 || tile % fine_block != 0)
    return (int)cudaErrorInvalidValue;
  SparseBwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.kcols = static_cast<const int*>(kcols);
  a.nnz = static_cast<const int*>(nnz);
  a.qrows_t = static_cast<const int*>(qrows_t);
  a.nnz_t = static_cast<const int*>(nnz_t);
  a.layout = static_cast<const uint8_t*>(layout);
  a.max_nnz = max_nnz;
  a.max_nnz_t = max_nnz_t;
  a.tile = tile;
  a.fine_block = fine_block;
  HeadStrides* dst[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 7; ++i) *dst[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.seq = seq;
  a.n_head = n_head;
  a.d = head_dim;
  a.scale = scale;
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
