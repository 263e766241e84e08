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
//   dkdv: one block per (batch, head, k tile); it loops over the q tiles
//     that reach its k tile and keeps dk, dv in registers.
//   dq: one block per (batch, head, q tile); it loops over the forward's
//     k-tile range for that q tile and keeps dq in registers.
// bf16 and f16 at the 64 and 128 head-dim ceilings take mma_dkdv_kernel
// and mma_dq_kernel: every product on the tensor cores (mma.sync.m16n8k16,
// f32 accumulators; P^T and dS^T, P and dS handed from one product's
// accumulators to the next in registers), ldmatrix(.trans) fragment loads
// from XOR-swizzled 64-row tiles and a two-stage cp.async ring for the
// visited tiles (flash_attention_mma.cuh). f32 and the 256 ceiling keep
// dkdv_kernel and dq_kernel, f32 FMAs on the CUDA cores: the q, k, v and
// dO tiles in shared memory in the input type (two blocks an SM at D = 128
// in bf16), and at 256 the block's own tile cut to 32 rows (dkdv: 32 k
// rows against 64-row q tiles; dq: 32 q rows against 64-row k tiles) so
// that ~210 KB of tiles and 128 accumulator registers a thread fit.
//
// What bounds it on the H100: at LLaMA-7B's attention shape (B=4, H=32,
// T=2048, D=128, bf16, causal) the 268.6 M kept pairs cost 10*D FLOP each,
// 343.8 GFLOP, ~0.348 ms at the 989 TFLOP/s bf16 tensor-core peak; the
// 472 MB read and written take ~0.141 ms at 3.35 TB/s, so it is bound by
// operations. The split recomputes s and dp in both kernels (14*D FLOP a
// pair instead of 10*D). No [T, T] matrix leaves the SM: s, p, dp and ds
// live in registers (and in the scalar kernels' shared tiles). wgmma, TMA
// and warp specialisation are later work (ROADMAP.md queue D).

#include "flash_attention_mma.cuh"

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

// ---- the tensor-core kernels: bf16 and f16 at the 64 and 128 ceilings

constexpr int kMmaBlock = 64;  // rows of the own tile and of each visited tile

// dkdv: K and V tiles, a ring of two (Q, dO) stages, and two stages of a q
// tile's lse and delta (f32); dq: Q and dO tiles and a ring of two (K, V)
// stages. Tiles [64][DMAX] in the input type, swizzled.
template <int DMAX>
constexpr size_t mma_tiles_bytes() {
  return 2 * (size_t)kMmaBlock * DMAX * (2 + 2 * 2);
}
constexpr size_t kMmaStatsBytes = 2 * 2 * kMmaBlock * sizeof(float);

// One block of 128 threads per (batch, head, 64-row k tile); warp w owns k
// rows 16 w .. 16 w + 15 and keeps their f32 dk and dv in registers. Per
// visited 64-row q tile (the next one's Q, dO, lse and delta in flight by
// cp.async): S^T = K Q^T, P^T = exp(S^T - lse) (log2 domain), dV +=
// round(P^T) dO with P^T passed from the accumulators as the A fragment and
// dO through ldmatrix.trans; dP^T = V dO^T, dS^T = P^T (dP^T - delta)
// scale, dK += round(dS^T) Q likewise. K and V are read as A fragments from
// the warp's own rows of their tiles, which then stage its dk and dv for
// 16-byte stores.
template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) mma_dkdv_kernel(BwdArgs a) {
  constexpr int KS = DMAX / 16;
  constexpr int NT = DMAX / 8;
  constexpr int QN = kMmaBlock / 8;  // 8-column q tiles of S^T
  constexpr int kStepUnroll = step_unroll<DMAX, EXACT>();
  constexpr uint32_t kTileBytes = 2 * kMmaBlock * DMAX;
  const int d = EXACT ? DMAX : a.d;
  const int nch = EXACT ? DMAX / 8 : ((d + 15) >> 4) * 2;
  extern __shared__ __align__(128) unsigned char mma_smem[];
  const uint32_t k_sm = smem_addr(mma_smem);
  const uint32_t v_sm = k_sm + kTileBytes;
  const uint32_t qd_sm = v_sm + kTileBytes;  // stage s: Q at + 2 s tiles, dO after it
  float* stats = reinterpret_cast<float*>(mma_smem + 6 * kTileBytes);  // stage s: lse, delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Ldsm<DMAX> ld(lane);
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  // small k tiles first: under the causal mask they have the longest loops
  const int k_off = blockIdx.y * kMmaBlock;
  const int kw = k_off + 16 * warp;  // this warp's first k row
  const T* q = static_cast<const T*>(a.q) + head_offset(a.sq, b, h);
  const T* dout = static_cast<const T*>(a.dout) + head_offset(a.sdo, b, h);
  const float* lse = a.lse + (long long)bh * a.seq;
  const float* delta = a.delta + (long long)bh * a.seq;

  // the q tiles that reach this k tile (the TPU kernels' range)
  int i0 = 0, i1 = a.seq / kMmaBlock;
  if (a.causal) {
    i0 = k_off / kMmaBlock;
    if (a.window > 0) {
      const int lim = (k_off + kMmaBlock + a.window - 1 + kMmaBlock - 1) / kMmaBlock;
      i1 = lim < i1 ? lim : i1;
    }
  }
  auto fetch = [&](int i) {
    const int st = (i - i0) & 1, q_off = i * kMmaBlock;
    const uint32_t at = qd_sm + 2 * kTileBytes * st;
    load_tile_async<T, DMAX, kMmaBlock, kThreads>(at, q, a.sq.t, q_off, d, nch, a.vec);
    load_tile_async<T, DMAX, kMmaBlock, kThreads>(at + kTileBytes, dout, a.sdo.t, q_off, d, nch,
                                                  a.vec);
    const int r = threadIdx.x & (kMmaBlock - 1);
    const float* src = threadIdx.x < kMmaBlock ? lse : delta;
    cp_async4(smem_addr(stats + 2 * kMmaBlock * st + threadIdx.x), src + q_off + r);
  };
  load_tile_async<T, DMAX, kMmaBlock, kThreads>(
      k_sm, static_cast<const T*>(a.k) + head_offset(a.sk, b, h), a.sk.t, k_off, d, nch, a.vec);
  load_tile_async<T, DMAX, kMmaBlock, kThreads>(
      v_sm, static_cast<const T*>(a.v) + head_offset(a.sv, b, h), a.sv.t, k_off, d, nch, a.vec);
  if (i0 < i1) fetch(i0);
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

  for (int i = i0; i < i1; ++i) {
    const int q_off = i * kMmaBlock;
    cp_async_wait<0>();
    __syncthreads();  // q tile i has landed; every warp is done with q tile i - 1
    if (i + 1 < i1) fetch(i + 1);
    cp_async_commit();
    const int st = (i - i0) & 1;
    const uint32_t qs_sm = qd_sm + 2 * kTileBytes * st;
    const uint32_t dos_sm = qs_sm + kTileBytes;
    const float* lse_s = stats + 2 * kMmaBlock * st;
    const float* delta_s = lse_s + kMmaBlock;

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
        uint32_t bf[4];
        ldsm_x4(bf, ld.B(qs_sm, 16 * np, kk));
        mma16816<T>(s[2 * np], ka, bf[0], bf[1]);
        mma16816<T>(s[2 * np + 1], ka, bf[2], bf[3]);
      }
    }
    const bool kept = tile_kept(a.causal, a.window, q_off, kMmaBlock, kw, 16);
#pragma unroll
    for (int n = 0; n < QN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const bool live = kept || keep_pair(q_off + col, kw + g + 8 * (e >> 1), a.window);
        s[n][e] = live ? exp2f(__fsub_rn(__fmul_rn(s[n][e], sl2), __fmul_rn(lse_s[col], kLog2e)))
                       : 0.f;
      }

    // dV += round(P^T) dO over the 64 q rows, 16 at a time
#pragma unroll
    for (int kq = 0; kq < QN / 2; ++kq) {
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

// One block of 128 threads per (batch, head, 64-row q tile); warp w owns q
// rows 16 w .. 16 w + 15, their lse and delta in registers and their f32
// dq. Per visited 64-row k tile (the next one's K and V in flight by
// cp.async): S = Q K^T, P = exp(S - lse), dP = dO V^T, dS = P (dP - delta)
// scale, dQ += round(dS) K with dS passed as the A fragment and K through
// ldmatrix.trans. The warp's own rows of the Q tile then stage its dq.
template <typename T, int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) mma_dq_kernel(BwdArgs a) {
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

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Ldsm<DMAX> ld(lane);
  const int bh = blockIdx.x;
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  // the longest causal rows first, so the last wave is made of short ones
  const int q_off = (gridDim.y - 1 - blockIdx.y) * kMmaBlock;
  const int qw = q_off + 16 * warp;
  const T* k = static_cast<const T*>(a.k) + head_offset(a.sk, b, h);
  const T* v = static_cast<const T*>(a.v) + head_offset(a.sv, b, h);

  // the forward's k-tile range for this q tile
  const int nk = a.causal ? (q_off + 2 * kMmaBlock - 1) / kMmaBlock : a.seq / kMmaBlock;
  int j0 = 0;
  if (a.causal && a.window > 0) {
    const int first = q_off - a.window + 1;
    j0 = (first > 0 ? first : 0) / kMmaBlock;
  }
  auto fetch = [&](int j) {
    const uint32_t at = kv_sm + 2 * kTileBytes * ((j - j0) & 1);
    load_tile_async<T, DMAX, kMmaBlock, kThreads>(at, k, a.sk.t, j * kMmaBlock, d, nch, a.vec);
    load_tile_async<T, DMAX, kMmaBlock, kThreads>(at + kTileBytes, v, a.sv.t, j * kMmaBlock, d,
                                                  nch, a.vec);
  };
  load_tile_async<T, DMAX, kMmaBlock, kThreads>(
      q_sm, static_cast<const T*>(a.q) + head_offset(a.sq, b, h), a.sq.t, q_off, d, nch, a.vec);
  load_tile_async<T, DMAX, kMmaBlock, kThreads>(
      do_sm, static_cast<const T*>(a.dout) + head_offset(a.sdo, b, h), a.sdo.t, q_off, d, nch,
      a.vec);
  fetch(j0);
  cp_async_commit();

  float lse2[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = (long long)bh * a.seq + qw + g + 8 * i;
    lse2[i] = __fmul_rn(a.lse[at], kLog2e);
    delta_r[i] = a.delta[at];
  }
  const float sl2 = __fmul_rn(a.scale, kLog2e);  // rounded as in mma_dkdv_kernel
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int j = j0; j < nk; ++j) {
    const int k_off = j * kMmaBlock;
    cp_async_wait<0>();
    __syncthreads();  // k tile j has landed; every warp is done with k tile j - 1
    if (j + 1 < nk) fetch(j + 1);
    cp_async_commit();
    const uint32_t ks_sm = kv_sm + 2 * kTileBytes * ((j - j0) & 1);
    const uint32_t vs_sm = ks_sm + kTileBytes;

    // S = Q K^T, then P = exp(S - lse): element e of tile n is (q row qw +
    // g + 8 (e >> 1), k column k_off + 8 n + 2 t + (e & 1))
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
        uint32_t bf[4];
        ldsm_x4(bf, ld.B(ks_sm, 16 * np, kk));
        mma16816<T>(s[2 * np], qa, bf[0], bf[1]);
        mma16816<T>(s[2 * np + 1], qa, bf[2], bf[3]);
      }
    }
    const bool kept = tile_kept(a.causal, a.window, qw, 16, k_off, kMmaBlock);
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live =
            kept || keep_pair(qw + g + 8 * (e >> 1), k_off + 8 * n + 2 * t + (e & 1), a.window);
        s[n][e] = live ? exp2f(__fsub_rn(__fmul_rn(s[n][e], sl2), lse2[e >> 1])) : 0.f;
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

    // dQ += round(dS) K over the tile's 64 keys, 16 at a time
#pragma unroll
    for (int kk = 0; kk < kMmaBlock / 16; ++kk) {
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
  __syncthreads();

#pragma unroll
  for (int n = 0; n < NT; ++n)
    if (2 * (n >> 1) < nch) stage_acc<T, DMAX>(q_sm, 16 * warp, n, dq[n], lane);
  __syncwarp();
  store_rows16<T, DMAX>(static_cast<T*>(a.dq) + head_offset(a.sdq, b, h), a.sdq.t, q_off, q_sm,
                        16 * warp, d, a.out_vec);
}

template <typename T, int DMAX, bool EXACT>
int launch_mma(const BwdArgs& a, int batch, cudaStream_t stream) {
  constexpr size_t dkdv_bytes = mma_tiles_bytes<DMAX>() + kMmaStatsBytes;
  constexpr size_t dq_bytes = mma_tiles_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(mma_dkdv_kernel<T, DMAX, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * a.n_head, a.seq / kMmaBlock);
  mma_dkdv_kernel<T, DMAX, EXACT><<<grid, kThreads, dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mma_dq_kernel<T, DMAX, EXACT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (err != cudaSuccess) return (int)err;
  mma_dq_kernel<T, DMAX, EXACT><<<grid, kThreads, dq_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernels for a type and head dim, by tensor_core_route: the scalar
// pair keeps the 256 ceiling, whose dk and dv would not fit the registers
// of 64-row tiles (later work, ROADMAP.md queue D).
template <typename T>
int launch_d(const BwdArgs& a, int batch, cudaStream_t stream) {
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

// 1 if a backward launch of dtype (0 = float32, 1 = bfloat16, 2 =
// float16) at head_dim takes the tensor-core kernels (tensor_core_route:
// up to the 128 ceiling), 0 if it takes the scalar pair, -1 for a dtype or
// head dim the kernels do not take.
extern "C" int dstorch_flash_attention_bwd_tensor_cores(int dtype, int head_dim) {
  if (dtype < 0 || dtype > 2 || head_dim < 1 || head_dim > 256) return -1;
  return dispatch_head_dim(head_dim, [&](auto dmax, auto) {
    return (int)tensor_core_route(dtype == 0 ? 4 : 2, decltype(dmax)::value);
  });
}

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
