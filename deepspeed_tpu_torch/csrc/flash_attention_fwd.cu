// Flash attention forward for Hopper (sm_90a): K1, K3 and K4.
//
// Replaces three TPU kernels that compute one function:
//   K1  deepspeed_tpu/ops/pallas/flash_attention_packed.py:_fwd_kernel (via
//       _fwd), over the packed layout q, k, v = [B, T, H*D];
//   K3  deepspeed_tpu/ops/pallas/flash_attention.py:_fwd_kernel (via _fwd),
//       over [B, H, T, D] with K/V resident in VMEM;
//   K4  deepspeed_tpu/ops/pallas/flash_attention.py:_fwd_kernel_streamed
//       (via _fwd_streamed), the same over long T (T*D*itemsize > 1 MiB),
//       K/V blocks on a third grid axis. This kernel streams 64-row K/V
//       tiles through shared memory at any T (offsets in 64 bits), so the
//       TPU's two regimes are one kernel here.
// Online-softmax attention, causal or not, with an optional sliding window
// (keep keys where 0 <= q - k < window), masked logits filled with -1e30
// (not -inf), the row sum clamped l >= 1e-30, P rounded to the input type
// before P.V, f32 accumulation, and lse = m + log(l) in f32. The layout is
// the caller's: q, k, v and o each come with their own (batch, head, token)
// strides and a unit head-dim stride, so the packed K1 call reads q/k/v in
// place from the [B, T, 3*H*D] qkv projection and K3 takes any [B, H, T, D]
// view; lse is [B, H, T] f32. The head dim is any d <= 256 (K3 takes
// d % 8 == 0, K1 any d dividing 128): the kernel is built for d = 64, 128
// and 256 exactly, and for each of those ceilings with a runtime d masked
// inside, its tiles zero-padded to a multiple of 8 columns so the dot
// products need no tail.
//
// What bounds it on the H100: at LLaMA-7B's attention shape (B=4, H=32,
// T=2048, D=128, bf16, causal) the 268.6 M kept pairs cost 4*D FLOP each,
// 137.5 GFLOP, ~0.139 ms at the 989 TFLOP/s bf16 tensor-core peak, above the
// 0.080 ms the 269 MB of q/k/v/o take at 3.35 TB/s; at GPT-2-125M's (B=8,
// T=1024, H=12, D=64) the bytes bound it (~15 us). Each (batch, head,
// 64-row q tile) block keeps its running m/l/acc on chip and streams
// 64-row K/V tiles through shared memory, so no [T, T] score matrix leaves
// the SM; the K loop stops at the diagonal (causal) and starts at the
// window's first tile. Three kernels compute this, by fwd_tensor_core_route
// (flash_attention_mma.cuh):
//   mma_fwd_kernel, bf16 and f16 at the 64 and 128 head-dim ceilings: both
//     products on the tensor cores (mma.sync.m16n8k16, f32 accumulators,
//     P handed from the S accumulators to the P.V product in registers),
//     ldmatrix fragment loads from XOR-swizzled tiles, and a two-stage
//     cp.async ring that copies K/V tile j + 1 while tile j is computed
//     (flash_attention_mma.cuh). Its 4 warps of 16 q rows keep the TPU
//     kernel's 64-row tiles.
//   wgmma_fwd_kernel, bf16 and f16 at the 256 ceiling (GPT-J's head dim,
//     and 128 < d < 256 masked): both products on Hopper's warpgroup
//     tensor cores (wgmma.mma_async, flash_attention_wgmma.cuh), Q and K/V
//     read from 128-byte-swizzled shared-memory panels through descriptors.
//     At D 256 mma_fwd_kernel's register tiles do not fit (Q fragments 64,
//     O 128 and S 32 registers a thread, past the 255 a thread may hold);
//     wgmma reads Q from shared memory instead, so a thread holds O's 128,
//     S's 32 and P's 16. Two warpgroups of 64 q rows share each K/V tile (a
//     128-row q tile, which halves the K/V bytes a product reads against
//     64-row tiles), each copying half of it with cp.async into a ring of
//     stages guarded by mbarriers, and take turns at the tensor cores, so
//     that one's softmax runs while the other's products do. A third,
//     producer warpgroup (setmaxnreg 24 / 240) spilled the consumers'
//     registers; TMA is later work (ROADMAP.md queue D).
//   fwd_kernel, f32 (TF32 would keep ~10 mantissa bits, outside the f32
//     checks): both products as f32 FMAs on the CUDA cores, bound by the
//     FMA rate and shared-memory traffic; its tiles hold the input type.
// The TPU kernel's bq 512/256 and bk 256/128 were VMEM choices and are not
// copied.

#include <utility>

#include "flash_attention_wgmma.cuh"

namespace {

using namespace dstorch_attn;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowsPerThread = kBlockQ / kRowGroups;
constexpr int kColsPerThread = kBlockK / 8;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  HeadStrides sq, sk, sv, so;
  int seq, n_head, d;
  float scale;
  int causal, window;
  bool vec;      // q, k, v chunks_aligned
  bool out_vec;  // o chunks_aligned
};

// Q, K, V tiles [64][ld] in the tile type S and the P tile [64][64 + 1] in
// f32 (the odd row lengths, in 4-byte words, keep rows on distinct banks)
template <typename S>
size_t smem_bytes(int d8) {
  return sizeof(S) * 3 * kBlockQ * tile_ld<S>(d8) + sizeof(float) * kBlockQ * (kBlockK + 1);
}

// EXACT: d == DMAX, known at compile time; otherwise d < DMAX is masked
template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) fwd_kernel(FwdArgs a) {
  using S = T;
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

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  // the longest causal rows first, so the last wave is made of short ones
  const int q_off = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const T* q = static_cast<const T*>(a.q) + head_offset(a.sq, b, h);
  const T* k = static_cast<const T*>(a.k) + head_offset(a.sk, b, h);
  const T* v = static_cast<const T*>(a.v) + head_offset(a.sv, b, h);

  load_tile<T>(qs, q, a.sq.t, q_off, kBlockQ, d, d8, ld, a.vec);

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kOutCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.f;
  }

  const int nk = a.causal ? (q_off + kBlockQ + kBlockK - 1) / kBlockK : a.seq / kBlockK;
  int j0 = 0;
  if (a.causal && a.window > 0) {
    const int first = q_off - a.window + 1;
    j0 = (first > 0 ? first : 0) / kBlockK;
  }

  for (int j = j0; j < nk; ++j) {
    const int k_off = j * kBlockK;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    load_tile<T>(ks, k, a.sk.t, k_off, kBlockK, d, d8, ld, a.vec);
    load_tile<T>(vs, v, a.sv.t, k_off, kBlockK, d, d8, ld, a.vec);
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
    tile_dot(s, qs, ks, ld, d8, tr, tc);

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = tr + kRowGroups * i;
      const int q_pos = q_off + row;
      float tile_max = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kColsPerThread; ++jj) {
        float x = s[i][jj] * a.scale;
        if (a.causal && !keep_pair(q_pos, k_off + tc + 8 * jj, a.window)) x = kNegInf;
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
        if (col < d) {
          const float vv = to_f32<S>(vs[kk * ld + col]);
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
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
int launch(const FwdArgs& a, int batch, cudaStream_t stream) {
  using S = T;
  // the ceiling's shared memory is the most any d under it asks for
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, DMAX, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<S>(DMAX));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_head, a.seq / kBlockQ);
  fwd_kernel<T, DMAX, EXACT>
      <<<grid, kThreads, smem_bytes<S>((a.d + 7) & ~7), stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the tensor-core kernel: bf16 and f16 at the 64 and 128 ceilings

// Q tile [64][DMAX] and a ring of two K/V stages [2][64][DMAX], swizzled
template <int DMAX>
constexpr size_t mma_smem_bytes() {
  return 2 * (size_t)kBlockQ * DMAX * (1 + 2 * 2);
}

// One block of 128 threads per (batch, head, 64-row q tile); warp w owns q
// rows 16 w .. 16 w + 15 and keeps their Q fragments, running max, sum and
// f32 output in registers. Per 64-key tile: S = Q K^T on the tensor cores
// (K through ldmatrix), the masked online softmax in the log2 domain
// (exp2 with log2(e) folded into the scale; masked logits -1e30, so a row
// masked over a whole tile still sums exp2(0) = 1 a column there and is
// wiped at its first live tile, as on the TPU), then O += round(P) V with P
// passed from the S accumulators as the A fragment in registers and V
// through ldmatrix.trans. The mask is only evaluated on tiles that straddle
// the diagonal or the window's edge. K/V tile j + 1 is copied (cp.async)
// while tile j is computed; unaligned inputs take the register-staged copy.
// EXACT: d == DMAX; otherwise d < DMAX is masked: the tiles hold columns
// [0, d rounded up to 16), zero from d on.
template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) mma_fwd_kernel(FwdArgs a) {
  constexpr int KS = DMAX / 16;     // 16-column steps over the head dim
  constexpr int NT = DMAX / 8;      // 8-column tiles of the output
  constexpr int KN = kBlockK / 8;   // 8-key tiles of S
  constexpr uint32_t kTileBytes = 2 * kBlockQ * DMAX;
  const int d = EXACT ? DMAX : a.d;
  const int nch = EXACT ? DMAX / 8 : ((d + 15) >> 4) * 2;  // chunks held a row
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const uint32_t q_sm = smem_addr(mma_smem);
  const uint32_t kv_sm = q_sm + kTileBytes;  // stage s: K at + 2 s tiles, V after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Ldsm<DMAX> ld(lane);
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  // the longest causal rows first, so the last wave is made of short ones
  const int q_off = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int qw = q_off + 16 * warp;  // this warp's first q row
  const T* q = static_cast<const T*>(a.q) + head_offset(a.sq, b, h);
  const T* k = static_cast<const T*>(a.k) + head_offset(a.sk, b, h);
  const T* v = static_cast<const T*>(a.v) + head_offset(a.sv, b, h);

  const int nk = a.causal ? (q_off + kBlockQ + kBlockK - 1) / kBlockK : a.seq / kBlockK;
  int j0 = 0;
  if (a.causal && a.window > 0) {
    const int first = q_off - a.window + 1;
    j0 = (first > 0 ? first : 0) / kBlockK;
  }

  load_tile_async<T, DMAX, kBlockQ, kThreads>(q_sm, q, a.sq.t, q_off, d, nch, a.vec);
  load_tile_async<T, DMAX, kBlockK, kThreads>(kv_sm, k, a.sk.t, j0 * kBlockK, d, nch, a.vec);
  load_tile_async<T, DMAX, kBlockK, kThreads>(kv_sm + kTileBytes, v, a.sv.t, j0 * kBlockK, d,
                                              nch, a.vec);
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

  for (int j = j0; j < nk; ++j) {
    const int k_off = j * kBlockK;
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; every warp is done with tile j - 1
    if (j == j0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        if (2 * kk < nch) ldsm_x4(qf[kk], ld.A(q_sm, 16 * warp, kk));
    }
    if (j + 1 < nk) {
      const uint32_t next = kv_sm + 2 * kTileBytes * ((j + 1 - j0) & 1);
      load_tile_async<T, DMAX, kBlockK, kThreads>(next, k, a.sk.t, k_off + kBlockK, d, nch,
                                                  a.vec);
      load_tile_async<T, DMAX, kBlockK, kThreads>(next + kTileBytes, v, a.sv.t,
                                                  k_off + kBlockK, d, nch, a.vec);
    }
    cp_async_commit();
    const uint32_t ks_sm = kv_sm + 2 * kTileBytes * ((j - j0) & 1);
    const uint32_t vs_sm = ks_sm + kTileBytes;

    float s[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (2 * kk >= nch) continue;
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, ld.B(ks_sm, 16 * np, kk));
        mma16816<T>(s[2 * np], qf[kk], bf[0], bf[1]);
        mma16816<T>(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    const bool kept = tile_kept(a.causal, a.window, qw, 16, k_off, kBlockK);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[n][e], sl2);
        if (!kept && !keep_pair(qw + g + 8 * (e >> 1), k_off + 8 * n + 2 * t + (e & 1), a.window))
          x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2], p_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp2f(m[i] - m_new[i]);
    }
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(__fsub_rn(s[n][e], m_new[e >> 1]));
        p_sum[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + quad_sum(p_sum[i]);
      m[i] = m_new[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += round(P) V over the tile's 64 keys, 16 at a time
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
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

  // out = acc / l through this warp's own rows of the Q tile (only this
  // warp read them), then 16-byte stores; lse = m + log(l) in f32
  float lc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lc[i] = fmaxf(l[i], 1e-30f);
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
    lse[0] = m[0] * kLn2 + logf(lc[0]);
    lse[8] = m[1] * kLn2 + logf(lc[1]);
  }
}

template <typename T, int DMAX, bool EXACT>
int launch_mma(const FwdArgs& a, int batch, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(mma_fwd_kernel<T, DMAX, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_head, a.seq / kBlockQ);
  mma_fwd_kernel<T, DMAX, EXACT><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the warpgroup tensor-core kernel: bf16 and f16 at the 256 ceiling

constexpr int kWgRows = 64;                      // q rows of a warpgroup
constexpr int kWgs = 2;                          // warpgroups a block
constexpr int kWgBlockQ = kWgRows * kWgs;        // q rows of a block
constexpr int kWgThreads = 128 * kWgs;
constexpr int kKStages = 2, kVStages = 3;        // K and V tiles held
constexpr uint32_t kWgTile = 64 * 256 * 2;       // bytes of a 64-row tile at D 256
// Q [2][64][256], the K and V stages [64][256] each, in panels: 224 KiB;
// then the mbarriers (K full and empty, V full and empty); plus the slack
// that aligns the base to 1024 bytes
constexpr uint32_t kWgBarOff = kWgTile * (kWgs + kKStages + kVStages);
constexpr size_t kWgSmemBytes = kWgBarOff + 8 * 2 * (kKStages + kVStages) + 1024;

// the byte offset of 16-column step kk in a 64-row panel tile
__host__ __device__ constexpr int step_off(int kk) {
  return (kk >> 2) * (kWgRows * 128) + (kk & 3) * 32;
}
template <typename T, int... KK>
__device__ __forceinline__ void issue_score_steps(float (&s)[8][4], uint64_t qd, uint64_t kd,
                                                  std::integer_sequence<int, KK...>) {
  (wgmma_ss_off<T, (step_off(KK) >> 4), (step_off(KK) >> 4), (KK == 0)>(s, qd, kd), ...);
}
// S = Q K^T of a warpgroup's 64 q rows and a 64-key tile: 16 wgmma steps
// over the head dim, the descriptors' steps as immediates; nks of them in
// the masked instance, in a loop of its own (unrolled under a runtime
// bound, its products spilled registers)
template <typename T, bool EXACT>
__device__ __forceinline__ void issue_scores(float (&s)[8][4], uint32_t q_sm, uint32_t k_sm,
                                             int nks) {
  if constexpr (EXACT) {
    issue_score_steps<T>(s, wgmma_desc(q_sm, 16), wgmma_desc(k_sm, 16),
                         std::make_integer_sequence<int, 16>());
  } else {
#pragma unroll 1
    for (int kk = 0; kk < nks; ++kk)
      wgmma_ss<T>(s, wgmma_desc(q_sm + step_off(kk), 16), wgmma_desc(k_sm + step_off(kk), 16),
                  kk > 0);
  }
}

// the offset, in 16-byte units, of keys [16 kk, +16) of output chunk c in
// a 64-row V panel tile
__host__ __device__ constexpr int pv_off(int c, int kk) {
  return (c * kBlockK * 128 + kk * 16 * 128) >> 4;
}
template <typename T, int C, int... KK>
__device__ __forceinline__ void issue_pv_chunk(float (&o)[8][4], const uint32_t (&pa)[4][4],
                                               uint64_t vd, std::integer_sequence<int, KK...>) {
  (wgmma_rs_off<T, pv_off(C, KK)>(o, pa[KK], vd), ...);
}
// O += round(P) V over a 64-key tile: 16 keys by 64 output columns a step,
// the first nnc column chunks
template <typename T, bool EXACT>
__device__ __forceinline__ void issue_pv(float (&o)[4][8][4], const uint32_t (&pa)[4][4],
                                         uint32_t v_sm, int nnc) {
  const uint64_t vd = wgmma_desc(v_sm, kBlockK * 128);
  const auto steps = std::make_integer_sequence<int, 4>();
  issue_pv_chunk<T, 0>(o[0], pa, vd, steps);
  issue_pv_chunk<T, 1>(o[1], pa, vd, steps);
  if (EXACT || nnc > 2) issue_pv_chunk<T, 2>(o[2], pa, vd, steps);
  if (EXACT || nnc > 3) issue_pv_chunk<T, 3>(o[3], pa, vd, steps);
}

// The masked online softmax of one 64-key tile in the log2 domain on a
// thread's S accumulators (mma_fwd_kernel's arithmetic, row for row; its
// rows qw + g and qw + g + 8): s becomes P, m and l move on, alpha is the
// factor O takes before this tile's P V
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2, int causal,
                                             int window, int qw, int k_off, int g, int t) {
  const bool kept = tile_kept(causal, window, qw, 16, k_off, kBlockK);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(s[n][e], sl2);
      if (!kept && !keep_pair(qw + g + 8 * (e >> 1), k_off + 8 * n + 2 * t + (e & 1), window))
        x = kNegInf;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float m_new[2], p_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_new[i] = fmaxf(m[i], quad_max(mx[i]));
    alpha[i] = exp2f(m[i] - m_new[i]);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(__fsub_rn(s[n][e], m_new[e >> 1]));
      p_sum[e >> 1] += p;
      s[n][e] = p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l[i] * alpha[i] + quad_sum(p_sum[i]);
    m[i] = m_new[i];
  }
}

// O *= alpha (rows g and g + 8), then P rounded into the A operand of P V
template <typename T>
__device__ __forceinline__ void rescale_and_pack(float (&o)[4][8][4], uint32_t (&pa)[4][4],
                                                 const float (&s)[8][4],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[c][n][0] *= alpha[0];
      o[c][n][1] *= alpha[0];
      o[c][n][2] *= alpha[1];
      o[c][n][3] *= alpha[1];
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) frag_a<T>(pa[kk], s[2 * kk], s[2 * kk + 1]);
}

// Rows [r0, r0 + ROWS) of a 64-row panel tile (the tile's rows [off, off +
// 64) of one head, x offset to it) by the 128 threads of a warpgroup
// (tid): load_tile_async's chunk copy (cp.async with vec, else staged in
// registers; columns >= d zero) in the panel layout. Written out here: with
// the chunk copy shared with load_tile_async through a helper, ptxas gave
// the kernel 254 registers instead of 230, and it ran slower.
template <typename T, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* __restrict__ x,
                                          long long stride_t, int off, int r0, int d, int nch,
                                          bool vec, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 32 / 128; ++i) {
    const int idx = tid + 128 * i;
    const int r = r0 + (idx >> 5), c = idx & 31;
    if (c >= nch) continue;
    const T* row = x + (long long)(off + r) * stride_t;
    const uint32_t at = dst + pan<64>(r, c);
    if (vec) {
      cp_async16(at, c * 8 < d ? row + c * 8 : row, c * 8 < d ? 16 : 0);
    } else {
      uint16_t vals[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int col = c * 8 + u;
        vals[u] = col < d ? reinterpret_cast<const uint16_t*>(row)[col] : 0;
      }
      uint4 v;
      memcpy(&v, vals, sizeof(v));
      st_shared16(at, v);
    }
  }
}

// One block of 256 threads per (batch, head, 128-row q tile): two
// warpgroups, each owning 64 q rows, sharing every K and V tile, each
// copying half of each (cp.async, or register-staged for unaligned
// inputs). The warpgroups meet only at mbarriers and take turns, so that
// they run half a step apart: a stage's "full" barrier completes when both
// halves have landed (cp.async.mbarrier.arrive, or a plain arrive after a
// register-staged copy), its "empty" barrier when both warpgroups are done
// with it; K_{i+1} is copied from the start of tile i into the stage of
// K_{i-1}, V_{i+1} from its end into that of V_{i-2} (three V stages: 224
// KiB of the 227 a block may have). Per 64-key tile i a warpgroup issues,
// when its turn comes (named barriers 1 and 2), S_i = Q K_i^T (16 wgmma
// m64n64k16 steps over the head dim, Q and K read from shared memory
// through descriptors: Q costs no registers) and, behind it, O +=
// round(P_{i-1}) V_{i-1} (4 x 4 wgmma m64n64k16 steps of 16 keys by 64
// output columns, P passed from the last tile's S accumulators as the
// register A operand, V read MN-major), then lets the other go: the
// tensor cores run one warpgroup's products while the other computes the
// masked online softmax of its S_i in the log2 domain, which also overlaps
// its own P_{i-1} V. O is rescaled by tile i's alpha once that product has
// landed, so each O accumulator sees the same sequence of operations as in
// mma_fwd_kernel, row for row. A thread holds O's 128 f32 accumulators,
// S's 32 and P's 16 registers. Both warpgroups visit every k tile of the
// block's range: one fully masked for a warpgroup's rows (past its
// diagonal, or before its window) adds exactly nothing to them (alpha 1
// and p 0 past the diagonal; wiped by alpha 0 at the first live tile
// before the window), so each row ends as in mma_fwd_kernel and the plain
// version, and no product waits on a branch (ptxas serializes wgmma behind
// one). The tiles are 128-byte-swizzled 64-column panels (pan), 1024 bytes
// aligned. The mask is evaluated only on tiles that straddle the diagonal
// or the window's edge; the longest causal rows go first. EXACT: d == 256;
// otherwise 128 < d < 256 (d % 8 == 0 on the aligned path) is masked: the
// S steps past d and the 64-column output chunks past d are skipped, the
// tiles hold zeros from d to the chunk's end.
template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kWgThreads, 1) wgmma_fwd_kernel(FwdArgs a) {
  static_assert(DMAX == 256, "the warpgroup kernel serves the 256 ceiling");
  const int d = EXACT ? DMAX : a.d;
  const int nks = EXACT ? DMAX / 16 : (d + 15) >> 4;  // 16-column steps of S
  const int nnc = EXACT ? DMAX / 64 : (d + 63) >> 6;  // 64-column chunks of O
  const int nch = 8 * nnc;                            // 16-byte chunks held a row
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t k_st = base + kWgs * kWgTile;      // K stage s at + s tiles
  const uint32_t v_st = k_st + kKStages * kWgTile;  // V likewise
  const uint32_t k_full = base + kWgBarOff, k_empty = k_full + 8 * kKStages;
  const uint32_t v_full = k_empty + 8 * kKStages, v_empty = v_full + 8 * kVStages;

  // the warpgroup, read through a shuffle so that the compiler sees it is
  // the same across a warp (wgmma takes warp-uniform paths)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t q_sm = base + wg * kWgTile;  // this warpgroup's Q rows
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  // the longest causal rows first, so the last wave is made of short ones
  const int q_off = (gridDim.y - 1 - blockIdx.y) * kWgBlockQ;
  const int qg = q_off + kWgRows * wg;  // this warpgroup's first q row
  const int qw = qg + 16 * warp;        // this warp's first q row
  // at T % 128 == 64 the last q tile's second warpgroup has no rows: it
  // computes on unloaded Q and stores nothing
  const bool live = qg < a.seq;
  const T* q = static_cast<const T*>(a.q) + head_offset(a.sq, b, h);
  const T* k = static_cast<const T*>(a.k) + head_offset(a.sk, b, h);
  const T* v = static_cast<const T*>(a.v) + head_offset(a.sv, b, h);
  int nk = a.seq / kBlockK;
  if (a.causal) nk = min(nk, (q_off + kWgBlockQ + kBlockK - 1) / kBlockK);
  int j0 = 0;
  if (a.causal && a.window > 0) {
    const int first = q_off - a.window + 1;
    j0 = (first > 0 ? first : 0) / kBlockK;
  }
  const int n = nk - j0;  // k tiles visited; tile i is j0 + i

  if (threadIdx.x == 0) {
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(k_full + 8 * s, kWgThreads);
      mbar_init(k_empty + 8 * s, kWgThreads);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(v_full + 8 * s, kWgThreads);
      mbar_init(v_empty + 8 * s, kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this warpgroup's half of K_i or V_i into its stage, once both
  // warpgroups are done with the tile held there before; its arrival on
  // the stage's full barrier once its copies have landed
  auto landed = [&](uint32_t bar) {
    if (a.vec)
      mbar_arrive_cp_async(bar);
    else
      mbar_arrive(bar);
  };
  auto load_k = [&](int i) {
    const int sk = i % kKStages;
    if (i >= kKStages) mbar_wait(k_empty + 8 * sk, (i / kKStages - 1) & 1);
    load_rows<T, 32>(k_st + sk * kWgTile, k, a.sk.t, (j0 + i) * kBlockK, 32 * wg, d, nch, a.vec,
                     tid);
    landed(k_full + 8 * sk);
  };
  auto load_v = [&](int i) {
    const int sv = i % kVStages;
    if (i >= kVStages) mbar_wait(v_empty + 8 * sv, (i / kVStages - 1) & 1);
    load_rows<T, 32>(v_st + sv * kWgTile, v, a.sv.t, (j0 + i) * kBlockK, 32 * wg, d, nch, a.vec,
                     tid);
    landed(v_full + 8 * sv);
  };

  // Q (this warpgroup's rows), then K_0, V_0 and K_1
  if (live) load_rows<T, kWgRows>(q_sm, q, a.sq.t, qg, 0, d, nch, a.vec, tid);
  cp_async_commit();
  load_k(0);
  load_v(0);
  if (n > 1) load_k(1);
  cp_async_wait<0>();  // Q (the only committed group)
  fence_proxy_async();
  bar_sync(3 + wg, 128);

  // logits in log2 units and p = exp2(x - m), each rounded as written, as
  // in mma_fwd_kernel (and the plain version)
  const float sl2 = __fmul_rn(a.scale, kLog2e);
  float o[4][8][4];  // output columns 64 c + 8 n + 2 t + e % 2
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) o[c][nn][0] = o[c][nn][1] = o[c][nn][2] = o[c][nn][3] = 0.f;
  // rows g and g + 8 of this warp: running max (log2 units) and sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t pa[4][4];  // round(P) of the last tile, the A operand of its P V
  float s[8][4];      // S, then P, of the current tile: keys 8 n + 2 t + e % 2
  float alpha[2];
  // turns at issuing products: warpgroup wg waits at barrier 1 + wg, and
  // lets the other go at its barrier; the first turn is warpgroup 0's
  const int my_turn = 1 + wg, their_turn = 2 - wg;

  // tile 0: S and its softmax only
  mbar_wait(k_full, 0);
  fence_proxy_async();  // both halves' copies, visible to wgmma
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
  wgmma_fence();
  issue_scores<T, EXACT>(s, q_sm, k_st, nks);
  wgmma_commit();
  wgmma_wait<0>();
  pin_regs(s);
  mbar_arrive(k_empty);
  softmax_tile(s, m, l, alpha, sl2, a.causal, a.window, qw, j0 * kBlockK, g, t);
  rescale_and_pack<T>(o, pa, s, alpha);
  if (n > 1) load_v(1);

  if (wg == 1) bar_arrive(their_turn, kWgThreads);
  for (int i = 1; i < n; ++i) {
    const int sk = i % kKStages, sv = (i - 1) % kVStages;
    if (i + 1 < n) load_k(i + 1);
    mbar_wait(k_full + 8 * sk, (i / kKStages) & 1);
    mbar_wait(v_full + 8 * sv, ((i - 1) / kVStages) & 1);
    fence_proxy_async();
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
    bar_sync(my_turn, kWgThreads);
    wgmma_fence();
    issue_scores<T, EXACT>(s, q_sm, k_st + sk * kWgTile, nks);
    wgmma_commit();
    issue_pv<T, EXACT>(o, pa, v_st + sv * kWgTile, nnc);
    wgmma_commit();
    bar_arrive(their_turn, kWgThreads);
    wgmma_wait<1>();  // S_i has landed; P_{i-1} V_{i-1} may still run
    pin_regs(s);
    mbar_arrive(k_empty + 8 * sk);
    softmax_tile(s, m, l, alpha, sl2, a.causal, a.window, qw, (j0 + i) * kBlockK, g, t);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < 4; ++c) pin_regs(o[c]);
    pin_regs(pa);
    mbar_arrive(v_empty + 8 * sv);
    rescale_and_pack<T>(o, pa, s, alpha);
    if (i + 1 < n) load_v(i + 1);
  }
  // warpgroup 0 takes the last turn warpgroup 1 gave it, so both named
  // barriers end where they began
  if (wg == 0) bar_sync(my_turn, kWgThreads);
  const int sv = (n - 1) % kVStages;
  mbar_wait(v_full + 8 * sv, ((n - 1) / kVStages) & 1);
  fence_proxy_async();
  wgmma_fence();
  issue_pv<T, EXACT>(o, pa, v_st + sv * kWgTile, nnc);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < 4; ++c) pin_regs(o[c]);
  if (!live) return;

  // out = acc / l through this warp's own rows of its warpgroup's Q tile
  // (only this warpgroup read it, and its products are done), then 16-byte
  // stores; lse = m + log(l) in f32
  float lc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lc[i] = fmaxf(l[i], 1e-30f);
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (!EXACT && c >= nnc) continue;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const int ch = 8 * c + nn;
      st_shared4(q_sm + pan<kWgRows>(r0, ch) + 4 * t,
                 pack2<T>(o[c][nn][0] / lc[0], o[c][nn][1] / lc[0]));
      st_shared4(q_sm + pan<kWgRows>(r0 + 8, ch) + 4 * t,
                 pack2<T>(o[c][nn][2] / lc[1], o[c][nn][3] / lc[1]));
    }
  }
  __syncwarp();
  T* out = static_cast<T*>(a.o) + head_offset(a.so, b, h);
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * warp + i, c = lane;
    if (c * 8 >= d) continue;
    const uint4 val = ld_shared16(q_sm + pan<kWgRows>(r, c));
    T* dst = out + (long long)(qg + r) * a.so.t + c * 8;
    if (a.out_vec) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      uint16_t vals[8];
      memcpy(vals, &val, sizeof(val));
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c * 8 + u < d) reinterpret_cast<uint16_t*>(dst)[u] = vals[u];
    }
  }
  if (t == 0) {
    float* lse = a.lse + ((long long)b * a.n_head + h) * a.seq + qw + g;
    lse[0] = m[0] * kLn2 + logf(lc[0]);
    lse[8] = m[1] * kLn2 + logf(lc[1]);
  }
}

template <typename T, int DMAX, bool EXACT>
int launch_wgmma(const FwdArgs& a, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wgmma_fwd_kernel<T, DMAX, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kWgSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_head, (a.seq + kWgBlockQ - 1) / kWgBlockQ);
  wgmma_fwd_kernel<T, DMAX, EXACT><<<grid, kWgThreads, kWgSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernel for a type and head dim, by fwd_tensor_core_route: 2-byte
// types on the tensor cores (mma.sync up to the 128 ceiling, wgmma at
// 256), f32 on the scalar kernel.
template <typename T>
int launch_d(const FwdArgs& a, int batch, cudaStream_t stream) {
  return dispatch_head_dim(a.d, [&](auto dmax, auto exact) {
    constexpr int kD = decltype(dmax)::value;
    constexpr bool kExact = decltype(exact)::value;
    if constexpr (!fwd_tensor_core_route(sizeof(T), kD))
      return launch<T, kD, kExact>(a, batch, stream);
    else if constexpr (kD == 256)
      return launch_wgmma<T, kD, kExact>(a, batch, stream);
    else
      return launch_mma<T, kD, kExact>(a, batch, stream);
  });
}

// One mma.sync.m16n8k16 (mma16816, the instruction of every product of
// the tensor-core kernels) per 16 x 8 tile: d[i] = a[i] b[i]^T + c[i], with
// a [n][16][16] and b [n][8][16] of T, c and d [n][16][8] f32, row-major.
// On no attention path: it gives the card's sums that the plain versions'
// model of them (ops/kernels/flash_attention.mma_step) is checked against.
template <typename T>
__global__ void mma_probe_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                                 const float* __restrict__ c, float* __restrict__ d) {
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  a += blockIdx.x * 256;
  b += blockIdx.x * 128;
  c += blockIdx.x * 128;
  d += blockIdx.x * 128;
  auto pair = [](const uint16_t* x) { return (uint32_t)x[0] | ((uint32_t)x[1] << 16); };
  const uint32_t fa[4] = {pair(a + g * 16 + 2 * t), pair(a + (g + 8) * 16 + 2 * t),
                          pair(a + g * 16 + 2 * t + 8), pair(a + (g + 8) * 16 + 2 * t + 8)};
  const int r0 = g * 8 + 2 * t, r1 = (g + 8) * 8 + 2 * t;
  float acc[4] = {c[r0], c[r0 + 1], c[r1], c[r1 + 1]};
  mma16816<T>(acc, fa, pair(b + g * 16 + 2 * t), pair(b + g * 16 + 2 * t + 8));
  d[r0] = acc[0];
  d[r0 + 1] = acc[1];
  d[r1] = acc[2];
  d[r1 + 1] = acc[3];
}

// One wgmma m64n8k16 (wgmma_ss_n8: A and B K-major in the panel layout,
// read through the descriptors of wgmma_fwd_kernel's S product) per 64 x 8
// tile: d[i] = a[i] b[i]^T + c[i], with a [n][64][16] and b [n][8][16] of T,
// c and d [n][64][8] f32, row-major. On no attention path: it gives the
// card's wgmma sums that the plain versions' model of them
// (ops/kernels/flash_attention.mma_step) is checked against.
template <typename T>
__global__ void __launch_bounds__(128) wgmma_probe_kernel(const uint16_t* __restrict__ a,
                                                          const uint16_t* __restrict__ b,
                                                          const float* __restrict__ c,
                                                          float* __restrict__ d) {
  __shared__ __align__(128) unsigned char probe_smem[64 * 128 + 8 * 128 + 1024];
  const uint32_t raw = smem_addr(probe_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // A's panel, B's 8192 bytes on
  unsigned char* at = probe_smem + (base - raw);
  a += blockIdx.x * 64 * 16;
  b += blockIdx.x * 8 * 16;
  c += blockIdx.x * 64 * 8;
  d += blockIdx.x * 64 * 8;
  // one 16-byte chunk (8 columns) a thread: A's 64 rows x 2, then B's 8 x 2
  for (int i = threadIdx.x; i < 2 * (64 + 8); i += 128) {
    const bool is_a = i < 2 * 64;
    const int r = (is_a ? i : i - 2 * 64) >> 1, ch = i & 1;
    const uint16_t* src = (is_a ? a : b) + r * 16 + ch * 8;
    const uint32_t off = is_a ? pan<64>(r, ch) : 64 * 128 + pan<8>(r, ch);
    *reinterpret_cast<uint4*>(at + off) = *reinterpret_cast<const uint4*>(src);
  }
  fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5) + g, r1 = r0 + 8;
  float acc[4] = {c[r0 * 8 + 2 * t], c[r0 * 8 + 2 * t + 1], c[r1 * 8 + 2 * t],
                  c[r1 * 8 + 2 * t + 1]};
  wgmma_fence();
  wgmma_ss_n8<T>(acc, wgmma_desc(base, 16), wgmma_desc(base + 64 * 128, 16));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  d[r0 * 8 + 2 * t] = acc[0];
  d[r0 * 8 + 2 * t + 1] = acc[1];
  d[r1 * 8 + 2 * t] = acc[2];
  d[r1 * 8 + 2 * t + 1] = acc[3];
}

}  // namespace

// 1 if a forward launch of dtype (0 = float32, 1 = bfloat16, 2 = float16)
// at head_dim takes a tensor-core kernel (fwd_tensor_core_route), 0 if it
// takes the scalar one, -1 for a dtype or head dim the kernels do not take.
// The backward library reports its own route
// (dstorch_flash_attention_bwd_tensor_cores).
extern "C" int dstorch_flash_attention_tensor_cores(int dtype, int head_dim) {
  if (dtype < 0 || dtype > 2 || head_dim < 1 || head_dim > 256) return -1;
  return dispatch_head_dim(head_dim, [&](auto dmax, auto) {
    return (int)fwd_tensor_core_route(dtype == 0 ? 4 : 2, decltype(dmax)::value);
  });
}

// wgmma_probe_kernel over n tiles (dtype 1 = bfloat16, 2 = float16; the
// buffers contiguous on the card) on `stream`; returns the CUDA error of
// the launch (0 on success).
extern "C" int dstorch_wgmma_probe(const void* a, const void* b, const void* c, void* d, int n,
                                   int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a16 = static_cast<const uint16_t*>(a);
  const auto* b16 = static_cast<const uint16_t*>(b);
  const auto* c32 = static_cast<const float*>(c);
  auto* d32 = static_cast<float*>(d);
  if (n < 1 || (dtype != 1 && dtype != 2)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    wgmma_probe_kernel<__nv_bfloat16><<<n, 128, 0, s>>>(a16, b16, c32, d32);
  else
    wgmma_probe_kernel<__half><<<n, 128, 0, s>>>(a16, b16, c32, d32);
  return (int)cudaGetLastError();
}

// mma_probe_kernel over n tiles (dtype 1 = bfloat16, 2 = float16; the
// buffers contiguous on the card) on `stream`; returns the CUDA error of
// the launch (0 on success).
extern "C" int dstorch_mma_probe(const void* a, const void* b, const void* c, void* d, int n,
                                 int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a16 = static_cast<const uint16_t*>(a);
  const auto* b16 = static_cast<const uint16_t*>(b);
  const auto* c32 = static_cast<const float*>(c);
  auto* d32 = static_cast<float*>(d);
  if (n < 1 || (dtype != 1 && dtype != 2)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    mma_probe_kernel<__nv_bfloat16><<<n, 32, 0, s>>>(a16, b16, c32, d32);
  else
    mma_probe_kernel<__half><<<n, 32, 0, s>>>(a16, b16, c32, d32);
  return (int)cudaGetLastError();
}

// strides: 12 values, the (batch, head, token) strides of q, k, v and o in
// that order. dtype: 0 = float32, 1 = bfloat16, 2 = float16. seq must be a
// multiple of 64. Returns the CUDA error of the launch (0 on success). The
// wrapper has checked shapes, types and strides.
extern "C" int dstorch_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                           void* lse, int batch, int seq, int n_head,
                                           int head_dim, const long long* strides, float scale,
                                           int causal, int window, int dtype, void* stream) {
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  HeadStrides* dst[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) *dst[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.seq = seq;
  a.n_head = n_head;
  a.d = head_dim;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
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
