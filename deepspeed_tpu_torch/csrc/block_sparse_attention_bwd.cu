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
// deterministic result: a dk/dv kernel, one block per (batch * head, k rows
// of a coarse tile), loops over its k tile's live q tiles (each in 64-row
// sub-tiles) and keeps dk, dv in registers; a dq kernel, one block per
// (batch * head, q rows of a coarse tile), loops over its q tile's live k
// tiles (each in 64-key sub-tiles) and keeps dq in registers. Two pairs
// compute this, by tensor_core_route (flash_attention_mma.cuh), as the
// flash attention's do:
//   mma_sparse_dkdv_kernel + mma_sparse_dq_kernel, bf16 and f16 at the 64
//     and 128 head-dim ceilings: mma_dkdv_kernel's and mma_dq_kernel's
//     tensor-core tile steps over the plan, with the forward's two skips
//     (block_sparse_plan.cuh): (a) a 64 x 64 sub-tile whose fine window is
//     dead and whose q rows all have a live block is neither copied nor
//     computed; (b) with fine_block % 16 == 0 a warp skips a dead 16-row
//     step (a fine-block pair) whose q rows have a live block. Where a q
//     row has no live block its masked p is 1, not 0 (lse ~ -1e30, as on
//     the TPU), so its steps are all computed.
//   sparse_dkdv_kernel + sparse_dq_kernel, f32 and the 256 ceiling: the
//     products as f32 FMAs on the CUDA cores over whole visited coarse
//     tiles; a block's own tile is 64 rows (32 at the 256 ceiling, as in
//     flash_attention_bwd.cu, for the same register and shared-memory
//     limits); the fine-layout window of each sub-tile pair is staged in
//     shared memory.
//
// What bounds it on the H100: the function needs the live fine pairs, 10*D
// FLOP each, and 7 * B*H*T*D values read and written; at BERT-large's
// [4, 16, 4096, 64] under the Fixed layout the FLOPs bound it, ~0.44 ms at
// the bf16 tensor-core peak. The tensor-core kernels compute the live pairs
// only (skip (b)) and recompute s and dp in both kernels (14*D FLOP a
// computed pair), at the rate of mma.sync with 8 warps an SM; wgmma, TMA
// and warp specialisation are later work (ROADMAP.md queue D).

#include "block_sparse_plan.cuh"
#include "flash_attention_mma.cuh"

namespace {

using namespace dstorch_attn;

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
  const uint8_t* live_rows;  // [H][nb]: the fine row has a live block
  int max_nnz, max_nnz_t, tile, fine_block;
  HeadStrides sq, sk, sv, sdo, sdq, sdk, sdv;
  int seq, n_head, d;
  float scale;
  bool vec;      // q, k, v, dout chunks_aligned
  bool out_vec;  // dq, dk, dv chunks_aligned
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

// ---- the tensor-core kernels: bf16 and f16 at the 64 and 128 ceilings

constexpr int kMmaBlock = 64;  // rows of the own tile and of each visited sub-tile

// dkdv: K and V tiles, a ring of two (Q, dO) stages, two stages of a q
// sub-tile's lse and delta (f32); dq: Q and dO tiles and a ring of two (K,
// V) stages. Tiles [64][DMAX] in the input type, swizzled; then the
// block's list of visited sub-tiles.
template <int DMAX>
size_t mma_dkdv_bytes(int seq) {
  return 2 * (size_t)kMmaBlock * DMAX * (2 + 2 * 2) + 2 * 2 * kMmaBlock * sizeof(float) +
         subtile_list_bytes(seq);
}
template <int DMAX>
size_t mma_dq_bytes(int seq) {
  return 2 * (size_t)kMmaBlock * DMAX * (2 + 2 * 2) + subtile_list_bytes(seq);
}

// mma_dkdv_kernel (flash_attention_bwd.cu) walked over the transposed plan:
// one block of 128 threads per (batch, head, 64 k rows), warp w owning k
// rows 16 w .. 16 w + 15 with their f32 dk and dv in registers. The block
// lists the 64-row q sub-tiles of its k tile's live q tiles (qrows_t), in
// plan order, leaving out those whose fine window is dead and whose 64 q
// rows all have a live block (skip (a)); the next one's Q, dO, lse and
// delta are in flight by cp.async. Per sub-tile a warp skips the 16-row q
// steps whose fine block is dead for its k rows and whose q rows have a
// live block (skip (b): their p is exactly 0). S^T = K Q^T, P^T =
// exp2(S^T log2(e) scale - lse log2(e)) with masked logits -1e30 (a q row
// with no live block has p = 1 there, as on the TPU), dV += round(P^T) dO,
// dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale, dK += round(dS^T) Q.
template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) mma_sparse_dkdv_kernel(SparseBwdArgs a) {
  constexpr int KS = DMAX / 16;
  constexpr int NT = DMAX / 8;
  constexpr int QN = kMmaBlock / 8;  // 8-column q tiles of S^T
  constexpr int kStepUnroll = step_unroll<DMAX, EXACT>();
  // skip (b) at the 64 ceiling; at 128, where dk and dv take 128 of the 255
  // registers, a live sub-tile's four steps all run (a dead step of q rows
  // with a live block has p = 0, so that changes no bit) and no per-step
  // predicate holds registers
  constexpr bool kStepSkip = DMAX <= 64;
  constexpr uint32_t kTileBytes = 2 * kMmaBlock * DMAX;
  const int d = EXACT ? DMAX : a.d;
  const int nch = EXACT ? DMAX / 8 : ((d + 15) >> 4) * 2;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const uint32_t k_sm = smem_addr(mma_smem);
  const uint32_t v_sm = k_sm + kTileBytes;
  const uint32_t qd_sm = v_sm + kTileBytes;  // stage s: Q at + 2 s tiles, dO after it
  float* stats = reinterpret_cast<float*>(mma_smem + 6 * kTileBytes);  // stage s: lse, delta
  int* subs = reinterpret_cast<int*>(stats + 4 * kMmaBlock);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Ldsm<DMAX> ld(lane);
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  const int k_off = blockIdx.y * kMmaBlock;
  const int kw = k_off + 16 * warp;  // this warp's first k row
  const int nt = a.seq / a.tile;
  const int kt = k_off / a.tile;
  const int fb = a.fine_block;
  const int nb = a.seq / fb;
  const uint8_t* lay = a.layout + (long long)h * nb * nb;
  const uint8_t* flags = a.live_rows + (long long)h * nb;
  const T* q = static_cast<const T*>(a.q) + head_offset(a.sq, b, h);
  const T* dout = static_cast<const T*>(a.dout) + head_offset(a.sdo, b, h);
  const float* lse = a.lse + (long long)bh * a.seq;
  const float* delta = a.delta + (long long)bh * a.seq;

  load_tile_async<T, DMAX, kMmaBlock, kThreads>(
      k_sm, static_cast<const T*>(a.k) + head_offset(a.sk, b, h), a.sk.t, k_off, d, nch, a.vec);
  load_tile_async<T, DMAX, kMmaBlock, kThreads>(
      v_sm, static_cast<const T*>(a.v) + head_offset(a.sv, b, h), a.sv.t, k_off, d, nch, a.vec);
  uint16_t* codes = reinterpret_cast<uint16_t*>(subs + a.seq / kSubTile);
  const int ns =
      list_subtiles(subs, codes, a.qrows_t + ((long long)h * nt + kt) * a.max_nnz_t,
                    a.nnz_t[h * nt + kt], a.tile, lay, flags, nb, fb, k_off, true);
  auto fetch = [&](int i) {
    const int st = i & 1, q_off = subs[i];
    const uint32_t at = qd_sm + 2 * kTileBytes * st;
    load_tile_async<T, DMAX, kMmaBlock, kThreads>(at, q, a.sq.t, q_off, d, nch, a.vec);
    load_tile_async<T, DMAX, kMmaBlock, kThreads>(at + kTileBytes, dout, a.sdo.t, q_off, d, nch,
                                                  a.vec);
    const int r = threadIdx.x & (kMmaBlock - 1);
    const float* src = threadIdx.x < kMmaBlock ? lse : delta;
    cp_async4(smem_addr(stats + 2 * kMmaBlock * st + threadIdx.x), src + q_off + r);
  };
  if (ns > 0) fetch(0);
  cp_async_commit();

  // p = exp2(s * (scale * log2(e)) - lse * log2(e)) and ds = p (dp - delta)
  // scale, each step rounded as written (no contraction into an FMA), as
  // the plain version computes them
  const float sl2 = __fmul_rn(a.scale, kLog2e);
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < ns; ++i) {
    const int q_off = subs[i];
    cp_async_wait<0>();
    __syncthreads();  // sub-tile i has landed; every warp is done with sub-tile i - 1
    if (i + 1 < ns) fetch(i + 1);
    cp_async_commit();
    const int st = i & 1;
    const uint32_t qs_sm = qd_sm + 2 * kTileBytes * st;
    const uint32_t dos_sm = qs_sm + kTileBytes;
    const float* lse_s = stats + 2 * kMmaBlock * st;
    const float* delta_s = lse_s + kMmaBlock;
    const unsigned code = codes[4 * i + warp];
    if ((code & 0xFu) == 0) continue;  // every p of the sub-tile is 0 for these k rows
    const unsigned run = kStepSkip ? code & 0xFu : 0xFu;

    // S^T = K Q^T: element e of tile n is (k row kw + g + 8 (e >> 1), q
    // column q_off + 8 n + 2 t + (e & 1))
    float s[QN][4];
#pragma unroll
    for (int n = 0; n < QN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll kStepUnroll
    for (int kk = 0; kk < KS; ++kk) {
      if (2 * kk >= nch) continue;
      uint32_t ka[4];
      ldsm_x4(ka, ld.A(k_sm, 16 * warp, kk));
#pragma unroll
      for (int np = 0; np < QN / 2; ++np) {
        if (!((run >> np) & 1u)) continue;
        uint32_t bf[4];
        ldsm_x4(bf, ld.B(qs_sm, 16 * np, kk));
        mma16816<T>(s[2 * np], ka, bf[0], bf[1]);
        mma16816<T>(s[2 * np + 1], ka, bf[2], bf[3]);
      }
    }
    const unsigned keep = keep_bits(code, a.fine_block, kw, q_off);
#pragma unroll
    for (int n = 0; n < QN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const float x = (keep >> (4 * n + e)) & 1u ? __fmul_rn(s[n][e], sl2) : kNegInf;
        s[n][e] = (run >> (n >> 1)) & 1u
                      ? exp2f(__fsub_rn(x, __fmul_rn(lse_s[col], kLog2e)))
                      : 0.f;
      }

    // dV += round(P^T) dO over the computed 16-row q steps
#pragma unroll
    for (int kq = 0; kq < QN / 2; ++kq) {
      if (!((run >> kq) & 1u)) continue;
      uint32_t pa[4];
      frag_a<T>(pa, s[2 * kq], s[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (2 * np >= nch) continue;
        uint32_t bf[4];
        ldsm_x4_t(bf, ld.Bt(dos_sm, 16 * kq, np));
        mma16816<T>(dv[2 * np], pa, bf[0], bf[1]);
        mma16816<T>(dv[2 * np + 1], pa, bf[2], bf[3]);
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale in place
    float dp[QN][4];
#pragma unroll
    for (int n = 0; n < QN; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll kStepUnroll
    for (int kk = 0; kk < KS; ++kk) {
      if (2 * kk >= nch) continue;
      uint32_t va[4];
      ldsm_x4(va, ld.A(v_sm, 16 * warp, kk));
#pragma unroll
      for (int np = 0; np < QN / 2; ++np) {
        if (!((run >> np) & 1u)) continue;
        uint32_t bf[4];
        ldsm_x4(bf, ld.B(dos_sm, 16 * np, kk));
        mma16816<T>(dp[2 * np], va, bf[0], bf[1]);
        mma16816<T>(dp[2 * np + 1], va, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < QN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = __fmul_rn(
            __fmul_rn(s[n][e], __fsub_rn(dp[n][e], delta_s[8 * n + 2 * t + (e & 1)])), a.scale);

    // dK += round(dS^T) Q
#pragma unroll
    for (int kq = 0; kq < QN / 2; ++kq) {
      if (!((run >> kq) & 1u)) continue;
      uint32_t da[4];
      frag_a<T>(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (2 * np >= nch) continue;
        uint32_t bf[4];
        ldsm_x4_t(bf, ld.Bt(qs_sm, 16 * kq, np));
        mma16816<T>(dk[2 * np], da, bf[0], bf[1]);
        mma16816<T>(dk[2 * np + 1], da, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // dk and dv through this warp's rows of the K and V tiles, then 16-byte
  // stores
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (2 * (n >> 1) >= nch) continue;
    stage_acc<T, DMAX>(k_sm, 16 * warp, n, dk[n], lane);
    stage_acc<T, DMAX>(v_sm, 16 * warp, n, dv[n], lane);
  }
  __syncwarp();
  store_rows16<T, DMAX>(static_cast<T*>(a.dk) + head_offset(a.sdk, b, h), a.sdk.t, k_off, k_sm,
                        16 * warp, d, a.out_vec);
  store_rows16<T, DMAX>(static_cast<T*>(a.dv) + head_offset(a.sdv, b, h), a.sdv.t, k_off, v_sm,
                        16 * warp, d, a.out_vec);
}

// mma_dq_kernel (flash_attention_bwd.cu) walked over the plan: one block of
// 128 threads per (batch, head, 64 q rows), warp w owning q rows 16 w .. 16
// w + 15 with their lse, delta and f32 dq in registers. It lists and skips
// the plan row's 64-key sub-tiles as the forward does (skips (a) and (b));
// the next one's K and V are in flight by cp.async. S = Q K^T, P = exp2(S
// log2(e) scale - lse log2(e)), dP = dO V^T, dS = P (dP - delta) scale, dQ
// += round(dS) K with dS as the A fragment and K through ldmatrix.trans.
template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) mma_sparse_dq_kernel(SparseBwdArgs a) {
  constexpr int KS = DMAX / 16;
  constexpr int NT = DMAX / 8;
  constexpr int KN = kMmaBlock / 8;
  constexpr int kStepUnroll = step_unroll<DMAX, EXACT>();
  constexpr uint32_t kTileBytes = 2 * kMmaBlock * DMAX;
  const int d = EXACT ? DMAX : a.d;
  const int nch = EXACT ? DMAX / 8 : ((d + 15) >> 4) * 2;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const uint32_t q_sm = smem_addr(mma_smem);
  const uint32_t do_sm = q_sm + kTileBytes;
  const uint32_t kv_sm = do_sm + kTileBytes;  // stage s: K at + 2 s tiles, V after it
  int* subs = reinterpret_cast<int*>(mma_smem + 6 * kTileBytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const Ldsm<DMAX> ld(lane);
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  const int q_off = blockIdx.y * kMmaBlock;
  const int qw = q_off + 16 * warp;
  const int nt = a.seq / a.tile;
  const int qt = q_off / a.tile;
  const int fb = a.fine_block;
  const int nb = a.seq / fb;
  const uint8_t* lay = a.layout + (long long)h * nb * nb;
  const uint8_t* flags = a.live_rows + (long long)h * nb;
  const T* k = static_cast<const T*>(a.k) + head_offset(a.sk, b, h);
  const T* v = static_cast<const T*>(a.v) + head_offset(a.sv, b, h);

  load_tile_async<T, DMAX, kMmaBlock, kThreads>(
      q_sm, static_cast<const T*>(a.q) + head_offset(a.sq, b, h), a.sq.t, q_off, d, nch, a.vec);
  load_tile_async<T, DMAX, kMmaBlock, kThreads>(
      do_sm, static_cast<const T*>(a.dout) + head_offset(a.sdo, b, h), a.sdo.t, q_off, d, nch,
      a.vec);
  uint16_t* codes = reinterpret_cast<uint16_t*>(subs + a.seq / kSubTile);
  const int ns = list_subtiles(subs, codes, a.kcols + ((long long)h * nt + qt) * a.max_nnz,
                               a.nnz[h * nt + qt], a.tile, lay, flags, nb, fb, q_off, false);
  auto fetch = [&](int i) {
    const uint32_t at = kv_sm + 2 * kTileBytes * (i & 1);
    load_tile_async<T, DMAX, kMmaBlock, kThreads>(at, k, a.sk.t, subs[i], d, nch, a.vec);
    load_tile_async<T, DMAX, kMmaBlock, kThreads>(at + kTileBytes, v, a.sv.t, subs[i], d, nch,
                                                  a.vec);
  };
  if (ns > 0) fetch(0);
  cp_async_commit();

  float lse2[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = (long long)bh * a.seq + qw + g + 8 * r;
    lse2[r] = __fmul_rn(a.lse[at], kLog2e);
    delta_r[r] = a.delta[at];
  }
  const float sl2 = __fmul_rn(a.scale, kLog2e);  // rounded as in mma_sparse_dkdv_kernel
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int i = 0; i < ns; ++i) {
    const int k_off = subs[i];
    cp_async_wait<0>();
    __syncthreads();  // sub-tile i has landed; every warp is done with sub-tile i - 1
    if (i + 1 < ns) fetch(i + 1);
    cp_async_commit();
    const uint32_t ks_sm = kv_sm + 2 * kTileBytes * (i & 1);
    const uint32_t vs_sm = ks_sm + kTileBytes;
    const unsigned code = codes[4 * i + warp];
    const unsigned run = code & 0xFu;
    if (run == 0) continue;  // every p of the sub-tile is 0 for these q rows

    // S = Q K^T, then P: element e of tile n is (q row qw + g + 8 (e >>
    // 1), k column k_off + 8 n + 2 t + (e & 1))
    float s[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll kStepUnroll
    for (int kk = 0; kk < KS; ++kk) {
      if (2 * kk >= nch) continue;
      uint32_t qa[4];
      ldsm_x4(qa, ld.A(q_sm, 16 * warp, kk));
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        if (!((run >> np) & 1u)) continue;
        uint32_t bf[4];
        ldsm_x4(bf, ld.B(ks_sm, 16 * np, kk));
        mma16816<T>(s[2 * np], qa, bf[0], bf[1]);
        mma16816<T>(s[2 * np + 1], qa, bf[2], bf[3]);
      }
    }
    const unsigned keep = keep_bits(code, a.fine_block, qw, k_off);
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (keep >> (4 * n + e)) & 1u ? __fmul_rn(s[n][e], sl2) : kNegInf;
        s[n][e] = (run >> (n >> 1)) & 1u ? exp2f(__fsub_rn(x, lse2[e >> 1])) : 0.f;
      }

    // dP = dO V^T, then dS = P (dP - delta) scale in place
    float dp[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll kStepUnroll
    for (int kk = 0; kk < KS; ++kk) {
      if (2 * kk >= nch) continue;
      uint32_t da[4];
      ldsm_x4(da, ld.A(do_sm, 16 * warp, kk));
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        if (!((run >> np) & 1u)) continue;
        uint32_t bf[4];
        ldsm_x4(bf, ld.B(vs_sm, 16 * np, kk));
        mma16816<T>(dp[2 * np], da, bf[0], bf[1]);
        mma16816<T>(dp[2 * np + 1], da, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = __fmul_rn(__fmul_rn(s[n][e], __fsub_rn(dp[n][e], delta_r[e >> 1])), a.scale);

    // dQ += round(dS) K over the computed 16-key steps
#pragma unroll
    for (int kk = 0; kk < kMmaBlock / 16; ++kk) {
      if (!((run >> kk) & 1u)) continue;
      uint32_t da[4];
      frag_a<T>(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (2 * np >= nch) continue;
        uint32_t bf[4];
        ldsm_x4_t(bf, ld.Bt(ks_sm, 16 * kk, np));
        mma16816<T>(dq[2 * np], da, bf[0], bf[1]);
        mma16816<T>(dq[2 * np + 1], da, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's Q copies have landed, also where ns == 0

#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (2 * (n >> 1) < nch) stage_acc<T, DMAX>(q_sm, 16 * warp, n, dq[n], lane);
  __syncwarp();
  store_rows16<T, DMAX>(static_cast<T*>(a.dq) + head_offset(a.sdq, b, h), a.sdq.t, q_off, q_sm,
                        16 * warp, d, a.out_vec);
}

template <typename T, int DMAX, bool EXACT>
int launch_mma(const SparseBwdArgs& a, int batch, cudaStream_t stream) {
  const size_t dkdv_bytes = mma_dkdv_bytes<DMAX>(a.seq);
  const size_t dq_bytes = mma_dq_bytes<DMAX>(a.seq);
  cudaError_t err = cudaFuncSetAttribute(mma_sparse_dkdv_kernel<T, DMAX, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_head, a.seq / kMmaBlock);
  mma_sparse_dkdv_kernel<T, DMAX, EXACT><<<grid, kThreads, dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mma_sparse_dq_kernel<T, DMAX, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return (int)err;
  mma_sparse_dq_kernel<T, DMAX, EXACT><<<grid, kThreads, dq_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernels for a type and head dim, by tensor_core_route (as the flash
// attention's): the scalar pair keeps f32 and the 256 ceiling.
template <typename T>
int launch_d(const SparseBwdArgs& a, int batch, cudaStream_t stream) {
  return dispatch_head_dim(a.d, [&](auto dmax, auto exact) {
    constexpr int kD = decltype(dmax)::value;
    constexpr bool kExact = decltype(exact)::value;
    if constexpr (tensor_core_route(sizeof(T), kD))
      return launch_mma<T, kD, kExact>(a, batch, stream);
    else
      return launch<T, kD, kExact>(a, batch, stream);
  });
}

}  // namespace

// kcols/nnz and qrows_t/nnz_t: the plan and its transpose, [H][nt][width]
// and [H][nt] int32 (nt = seq / tile); layout: [H][seq / fine_block]
// [seq / fine_block] uint8; live_rows: [H][seq / fine_block] uint8, 1
// where the fine row has a live block. strides: 21 values, the (batch,
// head, token) strides of q, k, v, dout, dq, dk and dv. dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. tile must be a multiple of 64 and
// fine_block >= 16 must divide it. Launches the dk/dv kernel, then the dq
// kernel (tensor-core or scalar, by tensor_core_route), on `stream`;
// returns the first CUDA error (0 on success). The wrapper has checked
// shapes, types and strides.
extern "C" int dstorch_block_sparse_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, void* dk, void* dv, const void* kcols,
                                        const void* nnz, const void* layout,
                                        const void* live_rows, int max_nnz, int tile,
                                        int fine_block, const void* qrows_t,
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
  a.live_rows = static_cast<const uint8_t*>(live_rows);
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
  const void* outputs[3] = {dq, dk, dv};
  const HeadStrides output_strides[3] = {a.sdq, a.sdk, a.sdv};
  a.out_vec = chunks_aligned(outputs, output_strides, 3, dtype == 0 ? 4 : 2, head_dim);
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
