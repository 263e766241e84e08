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
// lse = m + log(l) ([B, H, T] f32; the tensor-core kernel keeps m in log2
// units and writes m ln(2) + log(l)). Because the kernels visit exactly the
// plan's tiles (their skips change no result), a fine row with no live
// block in any visited tile gets the mean of V over the visited columns,
// and a coarse row with nnz = 0 gets out 0 and lse ~ -1e30, as on the TPU.
//
// Design: one block per (batch * head, 64 q rows of a coarse tile); the
// block reads its own row of the plan and loops over the live coarse tiles,
// each in 64-key sub-tiles. Coarse tiles are multiples of 64 (the wrapper
// checks it). The TPU's (8, 128) fine-window packing was a Mosaic
// constraint and is not copied: the kernels read the fine layout itself.
// Two kernels compute this, by tensor_core_route (flash_attention_mma.cuh),
// as the flash attention's do:
//   mma_sparse_fwd_kernel, bf16 and f16 at the 64 and 128 head-dim
//     ceilings: mma_fwd_kernel's tensor-core tile step (mma.sync.m16n8k16,
//     f32 accumulators, P from the S accumulators in registers, ldmatrix
//     from XOR-swizzled tiles, a two-stage cp.async K/V ring) over the
//     plan's sub-tiles, with two skips that change no bit of the result
//     (block_sparse_plan.cuh): (a) a 64-key sub-tile whose fine window is
//     dead for all 64 rows of the block is neither copied nor computed,
//     and (b) with fine_block % 16 == 0 a warp's 16 rows and one 16-key
//     step are one fine-block pair, so a warp neither multiplies nor sums a
//     dead step. Both hold only where the rows have a live block somewhere
//     (the plan's live_rows); a block or warp holding a row without one
//     computes all it visits, as the TPU kernel does.
//   sparse_fwd_kernel, f32 and the 256 ceiling: the K1/K3 scalar forward's
//     tiles and thread layout (flash_attention_common.cuh: 16-byte tile
//     loads, f32 tiles at 64), every product as f32 FMAs on the CUDA cores
//     over whole visited coarse tiles, the fine window of each 64 x 64
//     sub-tile (at most 5 x 5 fine blocks, fb >= 16) staged in shared memory.
//
// What bounds it on the H100: at BERT-large with the Fixed layout at T 4096
// (B=4, H=16, D=64, bf16, fb 16) the function needs only the live fine
// pairs, 4*D FLOP each (0.631 of all pairs: with fb 16 the Fixed layout's
// global column makes every 128-wide coarse tile live), and its 4 *
// B*H*T*D values read and written: the FLOPs bound it, ~0.18 ms at the
// bf16 tensor-core peak. The tensor-core kernel computes the live pairs
// only (skip (b)), at the rate of mma.sync with 8 warps an SM; wgmma, TMA
// and warp specialisation are later work (ROADMAP.md queue D).

#include "block_sparse_plan.cuh"
#include "flash_attention_mma.cuh"

namespace {

using namespace dstorch_attn;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowsPerThread = kBlockQ / kRowGroups;
constexpr int kColsPerThread = kBlockK / 8;

struct SparseFwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* kcols;        // [H][nt][max_nnz]
  const int* nnz;          // [H][nt]
  const uint8_t* layout;   // [H][nb][nb]
  const uint8_t* live_rows;  // [H][nb]: the fine row has a live block
  int max_nnz, tile, fine_block;
  HeadStrides sq, sk, sv, so;
  int seq, n_head, d;
  float scale;
  bool vec;      // q, k, v chunks_aligned
  bool out_vec;  // o chunks_aligned
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
      __syncthreads();  // the previous tile's readers are done with ks/vs/ps/win
      load_tile<T>(ks, k, a.sk.t, k_off, kBlockK, d, d8, ld, a.vec);
      load_tile<T>(vs, v, a.sv.t, k_off, kBlockK, d, d8, ld, a.vec);
      load_window(win, lay, nb, fb, q_off, kBlockQ, k_off, kBlockK);
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

// ---- the tensor-core kernel: bf16 and f16 at the 64 and 128 ceilings

// Q tile [64][DMAX] and a ring of two K/V stages [2][64][DMAX], swizzled,
// then the block's list of visited sub-tiles
template <int DMAX>
size_t mma_smem_bytes(int seq) {
  return 2 * (size_t)kBlockQ * DMAX * (1 + 2 * 2) + subtile_list_bytes(seq);
}

// mma_fwd_kernel (flash_attention_fwd.cu) walked over the plan: one block of
// 128 threads per (batch, head, 64 q rows), warp w owning q rows 16 w .. 16
// w + 15 with their Q fragments, running max, sum and f32 output in
// registers. The block first lists the 64-key sub-tiles of its plan row's
// live coarse tiles, in plan order, leaving out those whose fine window is
// dead for all 64 rows when every row has a live block (skip (a),
// block_sparse_plan.cuh); K/V of the next listed sub-tile are copied
// (cp.async) while this one is computed, across coarse tiles too. Per
// sub-tile each warp reads which of its four 16-key steps hold a live fine
// block (warp_code, listed with the sub-tiles) and, when its rows have a
// live block, neither
// multiplies nor sums the dead ones (skip (b)). S = Q K^T on the tensor
// cores, the masked online softmax in the log2 domain (masked logits
// -1e30), O += round(P) V with P from the S accumulators as the A fragment
// and V through ldmatrix.trans. EXACT: d == DMAX; otherwise d < DMAX is
// masked: the tiles hold columns [0, d rounded up to 16), zero from d on.
template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) mma_sparse_fwd_kernel(SparseFwdArgs a) {
  constexpr int KS = DMAX / 16;     // 16-column steps over the head dim
  constexpr int NT = DMAX / 8;      // 8-column tiles of the output
  constexpr int KN = kBlockK / 8;   // 8-key tiles of S
  constexpr uint32_t kTileBytes = 2 * kBlockQ * DMAX;
  const int d = EXACT ? DMAX : a.d;
  const int nch = EXACT ? DMAX / 8 : ((d + 15) >> 4) * 2;  // chunks held a row
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const uint32_t q_sm = smem_addr(mma_smem);
  const uint32_t kv_sm = q_sm + kTileBytes;  // stage s: K at + 2 s tiles, V after it
  int* subs = reinterpret_cast<int*>(mma_smem + 5 * kTileBytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Ldsm<DMAX> ld(lane);
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  const int q_off = blockIdx.y * kBlockQ;
  const int qw = q_off + 16 * warp;  // this warp's first q row
  const int nt = a.seq / a.tile;
  const int qt = q_off / a.tile;
  const int fb = a.fine_block;
  const int nb = a.seq / fb;
  const uint8_t* lay = a.layout + (long long)h * nb * nb;
  const uint8_t* flags = a.live_rows + (long long)h * nb;
  const T* q = static_cast<const T*>(a.q) + head_offset(a.sq, b, h);
  const T* k = static_cast<const T*>(a.k) + head_offset(a.sk, b, h);
  const T* v = static_cast<const T*>(a.v) + head_offset(a.sv, b, h);

  load_tile_async<T, DMAX, kBlockQ, kThreads>(q_sm, q, a.sq.t, q_off, d, nch, a.vec);
  uint16_t* codes = reinterpret_cast<uint16_t*>(subs + a.seq / kSubTile);
  const int ns = list_subtiles(subs, codes, a.kcols + ((long long)h * nt + qt) * a.max_nnz,
                               a.nnz[h * nt + qt], a.tile, lay, flags, nb, fb, q_off, false);
  auto fetch = [&](int i) {
    const uint32_t at = kv_sm + 2 * kTileBytes * (i & 1);
    load_tile_async<T, DMAX, kBlockK, kThreads>(at, k, a.sk.t, subs[i], d, nch, a.vec);
    load_tile_async<T, DMAX, kBlockK, kThreads>(at + kTileBytes, v, a.sv.t, subs[i], d, nch,
                                                a.vec);
  };
  if (ns > 0) fetch(0);
  cp_async_commit();

  // logits in log2 units, x = s * (scale * log2(e)), and p = exp2(x - m),
  // each rounded as written (no contraction into an FMA): the plain version
  // repeats these float32 steps, so both round P to the input type alike
  const float sl2 = __fmul_rn(a.scale, kLog2e);
  uint32_t qf[KS][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows g and g + 8 of this warp: running max (log2 units) and sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int i = 0; i < ns; ++i) {
    const int k_off = subs[i];
    cp_async_wait<0>();
    __syncthreads();  // sub-tile i has landed; every warp is done with sub-tile i - 1
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        if (2 * kk < nch) ldsm_x4(qf[kk], ld.A(q_sm, 16 * warp, kk));
    }
    if (i + 1 < ns) fetch(i + 1);
    cp_async_commit();
    const uint32_t ks_sm = kv_sm + 2 * kTileBytes * (i & 1);
    const uint32_t vs_sm = ks_sm + kTileBytes;
    // a sub-tile dead for these rows leaves m, l and O as they are (or
    // adds what the row's first live column wipes)
    const unsigned code = codes[4 * i + warp];
    const unsigned run = code & 0xFu;
    if (run == 0) continue;

    float s[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (2 * kk >= nch) continue;
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        if (!((run >> np) & 1u)) continue;
        uint32_t bf[4];
        ldsm_x4(bf, ld.B(ks_sm, 16 * np, kk));
        mma16816<T>(s[2 * np], qf[kk], bf[0], bf[1]);
        mma16816<T>(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    const unsigned keep = keep_bits(code, a.fine_block, qw, k_off);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (keep >> (4 * n + e)) & 1u ? __fmul_rn(s[n][e], sl2) : kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2], p_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new[r]);
    }
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (run >> (n >> 1)) & 1u ? exp2f(__fsub_rn(s[n][e], m_new[e >> 1])) : 0.f;
        p_sum[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(p_sum[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += round(P) V over the sub-tile's computed 16-key steps
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      if (!((run >> kk) & 1u)) continue;
      uint32_t pa[4];
      frag_a<T>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (2 * np >= nch) continue;
        uint32_t bf[4];
        ldsm_x4_t(bf, ld.Bt(vs_sm, 16 * kk, np));
        mma16816<T>(o[2 * np], pa, bf[0], bf[1]);
        mma16816<T>(o[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's Q copies have landed, also where ns == 0

  // out = acc / l through this warp's own rows of the Q tile, then 16-byte
  // stores; lse = m ln(2) + log(l) in f32, each step rounded as written
  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) lc[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (2 * (n >> 1) >= nch) continue;
    o[n][0] /= lc[0];
    o[n][1] /= lc[0];
    o[n][2] /= lc[1];
    o[n][3] /= lc[1];
    stage_acc<T, DMAX>(q_sm, 16 * warp, n, o[n], lane);
  }
  __syncwarp();
  T* out = static_cast<T*>(a.o) + head_offset(a.so, b, h);
  store_rows16<T, DMAX>(out, a.so.t, q_off, q_sm, 16 * warp, d, a.out_vec);
  if (t == 0) {
    float* lse = a.lse + ((long long)b * a.n_head + h) * a.seq + qw + g;
    lse[0] = __fadd_rn(__fmul_rn(m[0], kLn2), logf(lc[0]));
    lse[8] = __fadd_rn(__fmul_rn(m[1], kLn2), logf(lc[1]));
  }
}

template <typename T, int DMAX, bool EXACT>
int launch_mma(const SparseFwdArgs& a, int batch, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes<DMAX>(a.seq);
  cudaError_t err = cudaFuncSetAttribute(mma_sparse_fwd_kernel<T, DMAX, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_head, a.seq / kBlockQ);
  mma_sparse_fwd_kernel<T, DMAX, EXACT><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernel for a type and head dim, by tensor_core_route (as the flash
// attention's): the scalar kernel keeps f32 and the 256 ceiling.
template <typename T>
int launch_d(const SparseFwdArgs& a, int batch, cudaStream_t stream) {
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

// 1 if a block-sparse launch of dtype (0 = float32, 1 = bfloat16, 2 =
// float16) at head_dim takes the tensor-core kernels, forward and backward
// (tensor_core_route), 0 if it takes the scalar ones, -1 for a dtype or
// head dim the kernels do not take.
extern "C" int dstorch_block_sparse_tensor_cores(int dtype, int head_dim) {
  if (dtype < 0 || dtype > 2 || head_dim < 1 || head_dim > 256) return -1;
  return dispatch_head_dim(head_dim, [&](auto dmax, auto) {
    return (int)tensor_core_route(dtype == 0 ? 4 : 2, decltype(dmax)::value);
  });
}

// kcols/nnz: the plan's [H][nt][max_nnz] and [H][nt] int32 arrays (nt =
// seq / tile); layout: [H][seq / fine_block][seq / fine_block] uint8;
// live_rows: [H][seq / fine_block] uint8, 1 where the fine row has a live
// block. strides: 12 values, the (batch, head, token) strides of q, k, v
// and o.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. tile must be a multiple
// of 64 and fine_block >= 16 must divide it. Returns the CUDA error of the
// launch (0 on success). The wrapper has checked shapes, types and strides.
extern "C" int dstorch_block_sparse_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, const void* kcols, const void* nnz,
                                        const void* layout, const void* live_rows,
                                        int max_nnz, int tile,
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
  a.live_rows = static_cast<const uint8_t*>(live_rows);
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
  const void* outputs[1] = {o};
  a.out_vec = chunks_aligned(outputs, &a.so, 1, dtype == 0 ? 4 : 2, head_dim);
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
