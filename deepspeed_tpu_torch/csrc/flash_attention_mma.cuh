// Tensor-core pieces of the bf16/f16 flash attention kernels
// (mma_fwd_kernel in flash_attention_fwd.cu, mma_dkdv_kernel and
// mma_dq_kernel in flash_attention_bwd.cu): the swizzled shared-memory tile
// layout, the 16-byte asynchronous tile copies (cp.async) and their
// register-staged form for unaligned inputs, the ldmatrix fragment loads,
// the mma.sync.m16n8k16 product with f32 accumulators, and the conversion
// of an f32 accumulator fragment into an A fragment of the input type.
//
// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4), each register two
// 16-bit values, the lower column in the low half:
//   A 16 x 16:  a0 (row g, cols 2t..2t+1), a1 (row g+8, cols 2t..),
//               a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..)
//   B 16 x 8:   b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C 16 x 8:   c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// So the C fragments of two adjacent 8-column tiles of a product are, once
// rounded and packed in pairs, the A fragment of the next product over
// those 16 columns (frag_a): P and dS go from one product to the next in
// registers, and the conversion is the input-type rounding point.
#pragma once

#include "flash_attention_common.cuh"

namespace dstorch_attn {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The routes of the attention launches, decided here alone. The flash
// forward takes the tensor cores for 2-byte types (bf16, f16) at every
// head-dim ceiling: mma_fwd_kernel up to 128, wgmma_fwd_kernel at 256
// (fwd_tensor_core_route). The flash backward and both block-sparse
// kernels take them up to the 128 ceiling (tensor_core_route); at 256 their
// scalar kernels stay. f32 stays scalar everywhere (TF32 would keep ~10
// mantissa bits, outside the f32 checks). launch_d in each source
// dispatches on its route, and each library reports it to the Python side
// (dstorch_flash_attention_tensor_cores for the flash forward,
// dstorch_flash_attention_bwd_tensor_cores for its backward,
// dstorch_block_sparse_tensor_cores).
__host__ __device__ constexpr bool tensor_core_route(int elem_bytes, int dmax) {
  return elem_bytes == 2 && dmax <= 128;
}
__host__ __device__ constexpr bool fwd_tensor_core_route(int elem_bytes, int dmax) {
  return elem_bytes == 2 && dmax <= 256;
}

// A tile of 64 rows of DMAX 2-byte columns is DMAX / 8 16-byte chunks a
// row. Chunk c of row r sits at chunk c ^ (r % 8) of that row, so the eight
// rows an ldmatrix 8 x 8 matrix reads at one column chunk fall on eight
// distinct 16-byte bank groups, as do the rows a cp.async wave writes.
template <int CHUNKS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(CHUNKS >= 8, "the XOR swizzle needs at least 8 chunks a row");
  return (uint32_t)((r * CHUNKS + (c ^ (r & 7))) * 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_shared4(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}

// rows [off, off + ROWS) of one head (x already offset to it) into the
// swizzled tile at dst: chunks c < nch, columns >= d zero. With vec
// (chunks_aligned: d % 8 == 0 and 16-byte aligned rows) each chunk is one
// cp.async, left in flight for the caller's commit and wait; otherwise
// the chunk is read element by element into registers and stored.
template <typename T, int DMAX, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const T* __restrict__ x,
                                                long long stride_t, int off, int d, int nch,
                                                bool vec) {
  constexpr int CH = DMAX / 8;
  static_assert(sizeof(T) == 2, "tensor-core tiles hold bf16 or f16");
  static_assert(ROWS * CH % THREADS == 0, "whole waves of chunks");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CH, c = idx % CH;
    if (c >= nch) continue;
    const T* row = x + (long long)(off + r) * stride_t;
    const uint32_t at = dst + swz<CH>(r, c);
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

// Rows [0, 16) of a warp's output, staged in the swizzled tile at src (row
// base row0), written to out rows off + row0 + r: 16-byte stores with vec,
// else element by element; columns >= d are not written.
template <typename T, int DMAX>
__device__ __forceinline__ void store_rows16(T* __restrict__ out, long long stride_t, int off,
                                             uint32_t src, int row0, int d, bool vec) {
  constexpr int CH = DMAX / 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {
    const int idx = lane + 32 * i;
    const int r = row0 + idx / CH, c = idx % CH;
    if (c * 8 >= d) continue;
    const uint4 v = ld_shared16(src + swz<CH>(r, c));
    T* dst = out + (long long)(off + r) * stride_t + c * 8;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      uint16_t vals[8];
      memcpy(vals, &v, sizeof(v));
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c * 8 + u < d) reinterpret_cast<uint16_t*>(dst)[u] = vals[u];
    }
  }
}

// four 8 x 8 matrices of 16-bit values; lane i gives the address of row
// i % 8 of matrix i / 8 and receives (row lane / 4, cols 2 (lane % 4) ..)
// of each (.trans: (rows 2 (lane % 4) .., col lane / 4))
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Addresses, in a swizzled tile of DMAX columns, of the ldmatrix.x4 that
// loads:
//   A: the A fragment of rows [r0, r0 + 16), k columns [16 kk, +16) of a
//      row-major tile (Q, K, V, dO as the left operand);
//   B: with ldsm_x4, the B fragments of two 8-column tiles, n rows [n0, n0
//      + 16) of a tile stored [n][k] (K in S = Q K^T, V, Q, dO likewise),
//      k columns [16 kk, +16); r[0..1] for n0, r[2..3] for n0 + 8;
//   Bt: with ldsm_x4_t, the B fragments of two 8-column tiles, columns
//      [16 np, +16) of a tile stored [k][n] (V in P V, K in dS K, Q and dO
//      in the dK and dV products), k rows [k0, k0 + 16); r[0..1] for
//      columns 16 np .., r[2..3] for 16 np + 8 ...
// Lane i addresses row i % 8 of matrix i / 8. Column chunk 2 kk + x (x in
// {0, 1}) of row r lands at chunk (x ^ r % 8) ^ 2 kk, and a row is a
// multiple of 128 bytes, so every address is a per-lane offset of the kk =
// 0 (np = 0) load XORed with 32 kk bytes: one instruction a load, no
// address registers per step.
template <int DMAX> struct Ldsm {
  static constexpr uint32_t kRow = DMAX / 8 * 16;  // bytes a tile row
  uint32_t a, b;  // this lane's offsets: A and Bt loads, B loads
  __device__ __forceinline__ explicit Ldsm(int lane)
      : a(swz<DMAX / 8>((lane & 7) + (((lane >> 3) & 1) << 3), lane >> 4)),
        b(swz<DMAX / 8>((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1)) {}
  __device__ __forceinline__ uint32_t A(uint32_t base, int r0, int kk) const {
    return base + r0 * kRow + (a ^ (kk << 5));
  }
  __device__ __forceinline__ uint32_t B(uint32_t base, int n0, int kk) const {
    return base + n0 * kRow + (b ^ (kk << 5));
  }
  __device__ __forceinline__ uint32_t Bt(uint32_t base, int k0, int np) const {
    return base + k0 * kRow + (a ^ (np << 5));
  }
};

// c += a . b on the tensor cores, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to the input type (to nearest even), lo in the
// low half
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, sizeof(r));
  return r;
}

// the A fragment over columns [16 kk, +16) of a 16-row f32 accumulator held
// as 8-column tiles c[2 kk] and c[2 kk + 1], rounded to the input type
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// max / sum over the 4 lanes (t = 0..3) that share an accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// True when every (q, k) pair of q rows [q0, q0 + nq) and k rows [k0, k0 +
// nk) is kept, so that the tile needs no mask
__device__ __forceinline__ bool tile_kept(int causal, int window, int q0, int nq, int k0,
                                          int nk) {
  return !causal || (k0 + nk - 1 <= q0 && (window <= 0 || q0 + nq - 1 - k0 < window));
}

// Unroll of the backward kernels' 16-column step loops of S and dP (the
// flash attention's mma_dkdv_kernel and mma_dq_kernel, the block-sparse
// mma_sparse_dkdv_kernel and mma_sparse_dq_kernel): one step at a time at
// the 128 ceiling and at exact d = 64 (at 128 dk and dv take 128 of the 255
// registers, and the unrolled steps' fragments spilled; at exact 64 the
// registers then fit three blocks an SM), all steps for a d masked under 64
// (which spilled one step at a time). Chosen from ptxas's reports: with
// these no instance spills (PERF.md).
template <int DMAX, bool EXACT>
__host__ __device__ constexpr int step_unroll() {
  return DMAX > 64 || EXACT ? 1 : DMAX / 16;
}

// the write of one 16 x 8 f32 accumulator tile, rounded to T, into rows
// [r0, r0 + 16) and 8-column chunk c of a swizzled staging tile
template <typename T, int DMAX>
__device__ __forceinline__ void stage_acc(uint32_t base, int r0, int c, const float (&acc)[4],
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
  st_shared4(base + swz<DMAX / 8>(r0 + g, c) + 4 * t, pack2<T>(acc[0], acc[1]));
  st_shared4(base + swz<DMAX / 8>(r0 + g + 8, c) + 4 * t, pack2<T>(acc[2], acc[3]));
}

}  // namespace dstorch_attn
