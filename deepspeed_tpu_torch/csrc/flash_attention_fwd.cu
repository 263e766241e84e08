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
// T=1024, H=12, D=64) the bytes bound it (~15 us). This version does not
// reach either bound: both products run as f32 FMAs on the CUDA cores, so it
// is bound by the FMA rate and shared-memory traffic. Its design keeps what
// matters for device memory: each (batch, head, 64-row q tile) block keeps
// its Q tile and running m/l/acc on chip and streams 64-row K/V tiles
// through shared memory, so no [T, T] score matrix leaves the SM; the K
// loop stops at the diagonal (causal) and starts at the window's first
// tile. The tile type is chosen per head-dim ceiling (FwdTile): at 64 the
// tiles are f32, widened once as they are loaded (66.5 KB, three blocks an
// SM), so the inner products read them with no conversion; at 128 and 256
// they stay in the input type and are widened as they are read, which in
// bf16 at D = 128 fits two blocks on an SM where f32 tiles (116 KB) fit one
// (PERF.md). The TPU kernel's bq 512/256 and bk 256/128 were VMEM choices
// and are not copied. wgmma, TMA and warp specialisation are later work.

#include "flash_attention_common.cuh"

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
  bool vec;  // q, k, v chunks_aligned
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
  using S = FwdTile<T, DMAX>;
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

template <typename T>
int launch_d(const FwdArgs& a, int batch, cudaStream_t stream) {
  return dispatch_head_dim(a.d, [&](auto dmax, auto exact) {
    return launch<T, decltype(dmax)::value, decltype(exact)::value>(a, batch, stream);
  });
}

}  // namespace

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
