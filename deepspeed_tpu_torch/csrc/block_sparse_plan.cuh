// Shared pieces of the block-sparse attention kernels (K6 in
// block_sparse_attention_fwd.cu, K7 in block_sparse_attention_bwd.cu): the
// fine-layout window of a 64 x 64 sub-tile pair (the scalar kernels stage it
// in shared memory), and the tests and list behind the tensor-core kernels'
// skips.
//
// The skips change no bit of the result. A (q, k) pair whose fine block is
// dead has the logit -1e30. In a q row that has a live fine block somewhere
// (its flag in live_rows, layout.any(-1), computed on the host with the
// plan), every visited tile holds that block's column, so:
//   - forward: once the running max m is real, a dead pair adds exp2(-1e30 -
//     m) = 0 to l and to O and leaves m as it is; before the row's first
//     live column it adds 1s that the first live column wipes (alpha =
//     exp2(-1e30 - m) = 0);
//   - backward: p = exp2(-1e30 - lse) = 0, so dS = 0, and a tensor-core sum
//     with zero products is the accumulator itself.
// A row with no live block has lse ~ -1e30 and p = 1 on its masked columns
// (the TPU kernels' result: the mean of V over the visited columns), so a
// warp or block that holds such a row computes everything it visits.
#pragma once

#include "flash_attention_common.cuh"

namespace dstorch_attn {

constexpr int kMaxWin = 5;  // fine blocks along 64 rows, at most, for fb >= 16
constexpr int kSubTile = 64;  // rows of the sub-tiles a coarse tile is walked in

// The fine layout of rows [q_off, q_off + nq) x columns [k_off, k_off + nk)
// of one head (lay), one byte per fine-block pair, into win[(q fine) *
// kMaxWin + (k fine)] relative to (q_off / fb, k_off / fb). The caller
// synchronises.
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

// True when a fine block of one head's layout (lay) in rows [q_off, q_off +
// 64) x columns [k_off, k_off + 64) is live
__device__ __forceinline__ bool window_live(const uint8_t* lay, int nb, int fb, int q_off,
                                            int k_off) {
  for (int r = q_off / fb; r <= (q_off + kSubTile - 1) / fb; ++r)
    for (int c = k_off / fb; c <= (k_off + kSubTile - 1) / fb; ++c)
      if (lay[(long long)r * nb + c]) return true;
  return false;
}

// True when every fine row of q rows [q_off, q_off + 64) has a live block
// (flags: one head's live_rows)
__device__ __forceinline__ bool rows_flagged(const uint8_t* flags, int fb, int q_off) {
  for (int r = q_off / fb; r <= (q_off + kSubTile - 1) / fb; ++r)
    if (!flags[r]) return false;
  return true;
}

// Bytes of the sub-tile list a block of a plan row may need at sequence
// length seq (every 64-row sub-tile of the sequence: its offset, int, and
// the four warps' codes, uint16 each)
__host__ __device__ constexpr size_t subtile_list_bytes(int seq) {
  return (sizeof(int) + 4 * sizeof(uint16_t)) * (size_t)(seq / kSubTile);
}

// What one warp does with its 16 rows [row0, row0 + 16) against the 64
// rows [off, off + 64) of the other side (transposed: the warp's rows are
// k rows, as in dkdv, and the other side q rows; else the warp's rows are
// q rows, as in fwd and dq), as 16 bits. Bits 0..3, run: bit s set where
// the warp computes the 16 other rows [off + 16 s, off + 16 s + 16).
//   - fine_block % 16 == 0: the warp's 16 rows and each such step are one
//     fine-block pair; bit 4 + s is set where it is live, and the step is
//     skipped (skip (b)) where it is dead and its q rows have a live block.
//   - else every step runs, and bit 4 + 4 i + j is set where the pair (own
//     fine block row0 / fb + i, other off / fb + j) is live (16 rows span
//     at most 2 fine blocks and 64 at most 4, for the fine blocks the
//     wrapper takes).
// lay, flags: one head's layout [nb][nb] and live_rows [nb].
__device__ __forceinline__ unsigned warp_code(const uint8_t* lay, const uint8_t* flags, int nb,
                                              int fb, int row0, int off, bool transposed) {
  auto live = [&](int own, int other) {  // fine-block indices
    return (unsigned)((transposed ? lay[(long long)other * nb + own]
                                  : lay[(long long)own * nb + other]) != 0);
  };
  const int f0 = row0 / fb, c0 = off / fb;
  unsigned code = 0;
  if (fb % 16 == 0) {
    for (int s = 0; s < 4; ++s) {
      const int c = (off + 16 * s) / fb;
      const unsigned on = live(f0, c);
      const bool flag = flags[transposed ? c : f0] != 0;
      code |= on << (4 + s) | (unsigned)(on || !flag) << s;
    }
    return code;
  }
  for (int i = 0; i <= (row0 + 15) / fb - f0; ++i)
    for (int j = 0; j <= (off + kSubTile - 1) / fb - c0; ++j)
      code |= live(f0 + i, c0 + j) << (4 + 4 * i + j);
  return code | 0xFu;
}

// The 64-row sub-tiles a block of the tensor-core kernels visits, in plan
// order, and its warps' codes: the block's own 64 rows start at own_off (q
// rows, or k rows where transposed), and ids[0 .. n) are its plan row's
// coarse tiles of `tile` rows (kcols, or qrows_t where transposed). A
// sub-tile is left out (skip (a)) where its fine window is dead and every
// q row in it has a live block. Writes the offsets to list[] and codes[4 i
// + w] for sub-tile i and warp w (rows own_off + 16 w); returns how many.
// Every thread of the block calls it (it synchronises); both arrays are
// then visible to all.
__device__ __forceinline__ int list_subtiles(int* list, uint16_t* codes, const int* ids, int n,
                                             int tile, const uint8_t* lay,
                                             const uint8_t* flags, int nb, int fb, int own_off,
                                             bool transposed) {
  __shared__ int warp_count[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nsub = tile / kSubTile, total = n * nsub;
  const bool own_flagged = transposed || rows_flagged(flags, fb, own_off);
  int count = 0;
  for (int base = 0; base < total; base += kThreads) {
    const int i = base + threadIdx.x;
    int off = 0;
    bool keep = false;
    if (i < total) {
      const int jj = i / nsub;
      off = ids[jj] * tile + (i - jj * nsub) * kSubTile;
      keep = !(transposed ? rows_flagged(flags, fb, off) : own_flagged) ||
             window_live(lay, nb, fb, transposed ? off : own_off, transposed ? own_off : off);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int at = count;
    for (int w = 0; w < warp; ++w) at += warp_count[w];
    if (keep) list[at + __popc(ballot & ((1u << lane) - 1))] = off;
    for (int w = 0; w < kThreads / 32; ++w) count += warp_count[w];
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < 4 * count; idx += kThreads)
    codes[idx] = (uint16_t)warp_code(lay, flags, nb, fb, own_off + 16 * (idx & 3),
                                     list[idx >> 2], transposed);
  __syncthreads();
  return count;
}

// From a warp code, which elements of the warp's m16n8k16 accumulators a
// thread keeps: bit 4 n + e for element e of 8-column tile n, that is own
// row row0 + g + 8 (e >> 1) against other row off + 8 n + 2 t + (e & 1)
// (g = lane / 4, t = lane % 4).
__device__ __forceinline__ unsigned keep_bits(unsigned code, int fb, int row0, int off) {
  unsigned keep = 0;
  if (fb % 16 == 0) {
#pragma unroll
    for (int s = 0; s < 4; ++s) keep |= (code >> (4 + s)) & 1u ? 0xFFu << (8 * s) : 0u;
    return keep;
  }
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ro = row0 % fb, co = off % fb;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = ro + g + 8 * (e >> 1) >= fb;
      const int x = co + 8 * n + 2 * t + (e & 1);
      const int j = (x >= fb) + (x >= 2 * fb) + (x >= 3 * fb);
      keep |= ((code >> (4 + 4 * i + j)) & 1u) << (4 * n + e);
    }
  return keep;
}

}  // namespace dstorch_attn
