// Block-sparse attention forward for Hopper (sm_90a): K6.
//
// Replaces the TPU kernel deepspeed_tpu/ops/pallas/block_sparse_attention.py:
// _fwd_kernel (via _fwd): bidirectional attention over only the live coarse
// tiles of a sparsity layout. The host plan (build_plan in
// ops/kernels/block_sparse_attention.py) gives, for each (head, coarse q
// tile), the live coarse k tiles kcols[h][i][0 .. nnz[h][i]) in ascending
// order. Inside a live tile the fine layout [H][nb][nb] (uint8, fine block
// fb) masks each (q, k) fine-block pair: a masked logit is -1e30, not -inf.
// The online softmax keeps f32 m, l and acc, updates them in the TPU
// kernel's order, rounds P to the input type before P.V, clamps l >= 1e-30
// and writes out (q's dtype, any (batch, head, token) strides) and
// lse = m + log(l) ([B, H, T] f32). Because the kernel visits exactly the
// plan's tiles, a fine row with no live block in any visited tile gets the
// mean of V over the visited columns, and a coarse row with nnz = 0 gets
// out 0 and lse ~ -1e30, as on the TPU.
//
// Design: one block per (batch * head, 64 q rows of a coarse tile); the
// block reads its own row of the plan and loops over the live coarse tiles,
// each in 64-key sub-tiles, with the K1/K3 forward's tiles and thread
// layout (flash_attention_common.cuh: 16-byte tile loads, head-dim
// ceilings 64/128/256, f32 tiles at 64). The fine-layout window of each
// 64 x 64 sub-tile (at most 5 x 5 fine blocks, fb >= 16) is staged in
// shared memory. Coarse tiles are multiples of 64 (the wrapper checks it).
// The TPU's (8, 128) fine-window packing was a Mosaic constraint and is not
// copied. Dead sub-tiles inside a live coarse tile are visited and masked,
// as the TPU kernel computes its whole tile.
//
// What bounds it on the H100: at BERT-large with the Fixed layout at T 4096
// (B=4, H=16, D=64, bf16, fb 16) the function needs only the live fine
// pairs, 4*D FLOP each, and its 4 * B*H*T*D values read and written: both
// are far under a millisecond at the bf16 tensor-core peak and 3.35 TB/s.
// This version runs every product as f32 FMAs on the CUDA cores over whole
// visited coarse tiles (with fb 16 the Fixed layout's global column makes
// every 128-wide coarse tile live), so it is bound by the FMA rate over the
// visited pairs. wgmma, TMA and skipping dead sub-tiles are later work.

#include "flash_attention_common.cuh"

namespace {

using namespace dstorch_attn;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowsPerThread = kBlockQ / kRowGroups;
constexpr int kColsPerThread = kBlockK / 8;
constexpr int kMaxWin = 5;  // fine blocks along 64 rows, at most, for fb >= 16

struct SparseFwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* kcols;        // [H][nt][max_nnz]
  const int* nnz;          // [H][nt]
  const uint8_t* layout;   // [H][nb][nb]
  int max_nnz, tile, fine_block;
  HeadStrides sq, sk, sv, so;
  int seq, n_head, d;
  float scale;
  bool vec;  // q, k, v chunks_aligned
};

// Q, K, V tiles [64][ld] in the tile type S and the P tile [64][64 + 1] f32
template <typename S>
size_t smem_bytes(int d8) {
  return sizeof(S) * 3 * kBlockQ * tile_ld<S>(d8) + sizeof(float) * kBlockQ * (kBlockK + 1);
}

template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) sparse_fwd_kernel(SparseFwdArgs a) {
  using S = FwdTile<T, DMAX>;
  constexpr int kPld = kBlockK + 1;
  constexpr int kOutCols = DMAX / 8;
  const int d = EXACT ? DMAX : a.d;
  const int d8 = EXACT ? DMAX : (d + 7) & ~7;
  const int ld = tile_ld<S>(d8);
  extern __shared__ float smem[];
  S* qs = reinterpret_cast<S*>(smem);
  S* ks = qs + kBlockQ * ld;
  S* vs = ks + kBlockK * ld;
  float* ps = reinterpret_cast<float*>(vs + kBlockK * ld);
  __shared__ uint8_t win[kMaxWin * kMaxWin];

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  const int q_off = blockIdx.y * kBlockQ;
  const int nt = a.seq / a.tile;
  const int qt = q_off / a.tile;
  const int* cols = a.kcols + ((long long)h * nt + qt) * a.max_nnz;
  const int n = a.nnz[h * nt + qt];
  const int fb = a.fine_block;
  const int nb = a.seq / fb;
  const uint8_t* lay = a.layout + (long long)h * nb * nb;
  const int qf0 = q_off / fb;
  const int nfq = (q_off + kBlockQ - 1) / fb - qf0 + 1;
  const T* q = static_cast<const T*>(a.q) + head_offset(a.sq, b, h);
  const T* k = static_cast<const T*>(a.k) + head_offset(a.sk, b, h);
  const T* v = static_cast<const T*>(a.v) + head_offset(a.sv, b, h);

  load_tile<T>(qs, q, a.sq.t, q_off, kBlockQ, d, d8, ld, a.vec);

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kOutCols];
  int wrow[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    wrow[i] = (q_off + tr + kRowGroups * i) / fb - qf0;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.f;
  }

  for (int jj = 0; jj < n; ++jj) {
    const int tile_off = cols[jj] * a.tile;
    for (int sub = 0; sub < a.tile; sub += kBlockK) {
      const int k_off = tile_off + sub;
      const int kf0 = k_off / fb;
      const int nfk = (k_off + kBlockK - 1) / fb - kf0 + 1;
      __syncthreads();  // the previous tile's readers are done with ks/vs/ps/win
      load_tile<T>(ks, k, a.sk.t, k_off, kBlockK, d, d8, ld, a.vec);
      load_tile<T>(vs, v, a.sv.t, k_off, kBlockK, d, d8, ld, a.vec);
      if (tid < nfq * nfk) {
        const int r = tid / nfk;
        win[r * kMaxWin + tid - r * nfk] = lay[(long long)(qf0 + r) * nb + kf0 + tid - r * nfk];
      }
      __syncthreads();

      float s[kRowsPerThread][kColsPerThread];
      tile_dot(s, qs, ks, ld, d8, tr, tc);

#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int row = tr + kRowGroups * i;
        float tile_max = kNegInf;
#pragma unroll
        for (int jc = 0; jc < kColsPerThread; ++jc) {
          const int wc = (k_off + tc + 8 * jc) / fb - kf0;
          float x = s[i][jc] * a.scale;
          if (!win[wrow[i] * kMaxWin + wc]) x = kNegInf;
          s[i][jc] = x;
          tile_max = fmaxf(tile_max, x);
        }
        // a row masked over everything visited so far keeps m = -1e30 and
        // sums exp(0) = 1 per column; alpha = exp(-1e30 - m) = 0 wipes that
        // at its first live column, as on the TPU
        const float m_new = fmaxf(m[i], row_max(tile_max));
        const float alpha = expf(m[i] - m_new);
        float p_sum = 0.f;
#pragma unroll
        for (int jc = 0; jc < kColsPerThread; ++jc) {
          const float p = expf(s[i][jc] - m_new);
          p_sum += p;
          ps[row * kPld + tc + 8 * jc] = round_to<T>(p);
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
          if (col < d) {
            const float vv = to_f32<S>(vs[kk * ld + col]);
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
          }
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o) + head_offset(a.so, b, h);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int q_pos = q_off + tr + kRowGroups * i;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + (long long)q_pos * a.so.t;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int col = tc + 8 * c;
      if (col < d) orow[col] = from_f32<T>(acc[i][c] / lc);
    }
    if (tc == 0) a.lse[((long long)b * a.n_head + h) * a.seq + q_pos] = m[i] + logf(lc);
  }
}

template <typename T, int DMAX, bool EXACT>
int launch(const SparseFwdArgs& a, int batch, cudaStream_t stream) {
  using S = FwdTile<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(sparse_fwd_kernel<T, DMAX, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<S>(DMAX));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_head, a.seq / kBlockQ);
  sparse_fwd_kernel<T, DMAX, EXACT>
      <<<grid, kThreads, smem_bytes<S>((a.d + 7) & ~7), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const SparseFwdArgs& a, int batch, cudaStream_t stream) {
  return dispatch_head_dim(a.d, [&](auto dmax, auto exact) {
    return launch<T, decltype(dmax)::value, decltype(exact)::value>(a, batch, stream);
  });
}

}  // namespace

// kcols/nnz: the plan's [H][nt][max_nnz] and [H][nt] int32 arrays (nt =
// seq / tile); layout: [H][seq / fine_block][seq / fine_block] uint8.
// strides: 12 values, the (batch, head, token) strides of q, k, v and o.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. tile must be a multiple
// of 64 and fine_block >= 16 must divide it. Returns the CUDA error of the
// launch (0 on success). The wrapper has checked shapes, types and strides.
extern "C" int dstorch_block_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, const void* kcols, const void* nnz,
                                        const void* layout, int max_nnz, int tile,
                                        int fine_block, int batch, int seq, int n_head,
                                        int head_dim, const long long* strides, float scale,
                                        int dtype, void* stream) {
  if (tile % kBlockK != 0 || fine_block < 16 || tile % fine_block != 0)
    return (int)cudaErrorInvalidValue;
  SparseFwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.kcols = static_cast<const int*>(kcols);
  a.nnz = static_cast<const int*>(nnz);
  a.layout = static_cast<const uint8_t*>(layout);
  a.max_nnz = max_nnz;
  a.tile = tile;
  a.fine_block = fine_block;
  HeadStrides* dst[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) *dst[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.seq = seq;
  a.n_head = n_head;
  a.d = head_dim;
  a.scale = scale;
  const void* inputs[3] = {q, k, v};
  const HeadStrides input_strides[3] = {a.sq, a.sk, a.sv};
  a.vec = chunks_aligned(inputs, input_strides, 3, dtype == 0 ? 4 : 2, head_dim);
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
