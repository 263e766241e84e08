// Hopper's warpgroup tensor-core pieces of the bf16/f16 flash attention
// forward at the 256 head-dim ceiling (wgmma_fwd_kernel in
// flash_attention_fwd.cu): the 128-byte-swizzled panel layout that wgmma
// reads from shared memory, its matrix descriptors, the asynchronous
// wgmma.mma_async products (m64n64k16, f32 accumulators) with both operands
// in shared memory or A in registers, their fences, and the mbarriers and
// named barriers of the kernel's pipeline.
//
// Panel layout: a tile of ROWS rows of 2-byte values is stored as 64-column
// panels, each [ROWS][64] with 128-byte rows; 16-byte chunk c of row r sits
// at chunk (c % 8) ^ (r % 8) of that row of panel c / 8. With panels that
// start on 1024-byte boundaries this is the canonical SWIZZLE_128B layout
// (the hardware XORs address bits [4, 7) with bits [7, 10)), which wgmma
// reads K-major (rows along M or N, the 64 columns along K: Q and K in
// S = Q K^T) or MN-major (rows along K, columns along N: V in P V).
//
// Accumulator fragment of m64nNk16 (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): register 4 n + e holds row 16 w + g + 8 (e / 2), column
// 8 n + 2 t + e % 2, the C fragment of mma.m16n8k16 per 8-column tile; the
// register A fragment of m64n?k16 is mma.m16n8k16's A fragment of the
// warp's 16 rows, so frag_a turns two 8-column tiles of S into the A
// operand of P V, as in mma_fwd_kernel.
#pragma once

#include "flash_attention_mma.cuh"

namespace dstorch_attn {

// byte offset of 16-byte chunk c of row r in a panel tile of ROWS rows
template <int ROWS>
__device__ __forceinline__ uint32_t pan(int r, int c) {
  return (uint32_t)((((c >> 3) * ROWS + r) << 7) + (((c & 7) ^ (r & 7)) << 4));
}

// shared-memory matrix descriptor of a SWIZZLE_128B operand at addr (a
// 1024-byte-aligned panel, plus 32 bytes a 16-column step for K-major
// operands): start >> 4 in bits [0, 14), the leading byte offset >> 4 in
// [16, 30) (MN-major: the stride between 64-column panels; unused
// K-major), the stride byte offset >> 4 in [32, 46) (1024: the next 8
// rows), layout 1 (128-byte swizzle) in [62, 64)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lead_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lead_bytes & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// every prior register access of the warpgroup is ordered before the next
// wgmma.mma_async
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed groups are in flight
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// this thread's generic-proxy writes to shared memory (st.shared, cp.async)
// made visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers (shared memory, 8 bytes each) and named barriers: the
// pipeline between a block's warpgroups

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// an arrival of this thread (release)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
// this thread's arrival, made once all its earlier cp.async copies have
// landed (counted in the barrier's expected arrivals)
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of the given parity has completed (acquire)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// named barrier id over `count` threads: wait for it, or only arrive
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Registers that an in-flight wgmma reads or writes, pinned: an empty asm
// that "modifies" each, placed after wgmma_wait, so that the compiler
// neither reads an accumulator before the wait nor reuses an A register
// while the product may still read it.
template <int N, int M>
__device__ __forceinline__ void pin_regs(float (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+f"(x[i][j])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void pin_regs(uint32_t (&x)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

#define DSTORCH_WGMMA_D32                                                                       \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),     \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), \
      "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), \
      "+f"(d[7][2]), "+f"(d[7][3])
#define DSTORCH_WGMMA_R32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B over one 16-deep step, both from shared memory: A [64][16]
// K-major (desc a), B [64][16] K-major (desc b), i.e. d = A B^T of two
// row-major tiles; scale_d 0 overwrites d
#define DSTORCH_WGMMA_SS(TY)                                                            \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSTORCH_WGMMA_R32 \
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                                 \
      : DSTORCH_WGMMA_D32                                                               \
      : "l"(a), "l"(b), "r"(scale_d))
// the same with the two descriptors as bases plus compile-time offsets
// (OA, OB: bytes >> 4, added inside the instruction's asm), so that the
// per-step descriptors are never held in registers; FIRST overwrites d
// (scale-d false)
#define DSTORCH_WGMMA_SS_OFF(TY, SCALE)                                                 \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\n.reg .b32 sd;\n.reg .b64 da, db;\nadd.s64 da, %32, %34;\n"   \
      "add.s64 db, %33, %35;\nmov.b32 sd, " SCALE ";\nsetp.ne.b32 p, sd, 0;\n"          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSTORCH_WGMMA_R32 \
      ", da, db, p, 1, 1, 0, 0;\n}\n"                                                   \
      : DSTORCH_WGMMA_D32                                                               \
      : "l"(a), "l"(b), "n"(OA), "n"(OB))
// d += A B over one 16-deep step: A [64][16] in registers (a, the
// mma.m16n8k16 A fragment of each warp's 16 rows), B [16][64] MN-major
// from shared memory (base desc b plus OB: 16 rows of a panel, the 64
// columns along N)
#define DSTORCH_WGMMA_RS_OFF(TY)                                                        \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\n.reg .b64 db;\nadd.s64 db, %36, %38;\n"                      \
      "setp.ne.b32 p, %37, 0;\n"                                                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " DSTORCH_WGMMA_R32 \
      ", {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"                                    \
      : DSTORCH_WGMMA_D32                                                               \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(OB))

template <typename T, int OA, int OB, bool FIRST>
__device__ __forceinline__ void wgmma_ss_off(float (&d)[8][4], uint64_t a, uint64_t b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && FIRST)
    DSTORCH_WGMMA_SS_OFF("bf16", "0");
  else if constexpr (std::is_same_v<T, __nv_bfloat16>)
    DSTORCH_WGMMA_SS_OFF("bf16", "1");
  else if constexpr (FIRST)
    DSTORCH_WGMMA_SS_OFF("f16", "0");
  else
    DSTORCH_WGMMA_SS_OFF("f16", "1");
}
template <typename T, int OB>
__device__ __forceinline__ void wgmma_rs_off(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    DSTORCH_WGMMA_RS_OFF("bf16");
  else
    DSTORCH_WGMMA_RS_OFF("f16");
}

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<__nv_bfloat16>(float (&d)[8][4], uint64_t a, uint64_t b,
                                                        int scale_d) {
  DSTORCH_WGMMA_SS("bf16");
}
template <>
__device__ __forceinline__ void wgmma_ss<__half>(float (&d)[8][4], uint64_t a, uint64_t b,
                                                 int scale_d) {
  DSTORCH_WGMMA_SS("f16");
}

#undef DSTORCH_WGMMA_SS
#undef DSTORCH_WGMMA_SS_OFF
#undef DSTORCH_WGMMA_RS_OFF
#undef DSTORCH_WGMMA_R32
#undef DSTORCH_WGMMA_D32

// d += A B^T for A [64][16] and B [8][16], both K-major from shared memory:
// one m64n8k16 (four accumulators a thread), the probe of the sums
#define DSTORCH_WGMMA_N8(TY)                                                            \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY                            \
      " {%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                                  \
      : "l"(a), "l"(b), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss_n8<__nv_bfloat16>(float (&d)[4], uint64_t a, uint64_t b) {
  DSTORCH_WGMMA_N8("bf16");
}
template <>
__device__ __forceinline__ void wgmma_ss_n8<__half>(float (&d)[4], uint64_t a, uint64_t b) {
  DSTORCH_WGMMA_N8("f16");
}
#undef DSTORCH_WGMMA_N8

}  // namespace dstorch_attn
