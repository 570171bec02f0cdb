// Hopper warpgroup matrix multiply (wgmma) helpers for sm_90a: shared-memory
// matrix descriptors, the fence / commit / wait that order a warpgroup's
// asynchronous products, and the bf16 products with both operands in shared
// memory.  Plain C++ over inline PTX (no CUTLASS), included by the kernels
// under csrc/.
//
// A descriptor (64 bits) names one operand tile of one wgmma:
//   bits  0-13  start address in shared memory >> 4
//   bits 16-29  leading byte offset (LBO) >> 4
//   bits 32-45  stride byte offset (SBO) >> 4
//   bits 49-51  base offset (0: every swizzled tile starts on its repeat)
//   bits 62-63  swizzle: 0 none, 1 128-byte, 2 64-byte, 3 32-byte
// In the canonical layouts (CUTLASS's cute/arch/mma_sm90_desc.hpp):
//   K-major, swizzle S bytes: rows of S bytes, 8 rows an atom; SBO steps
//     from one 8-row group to the next, LBO is not read (16 by convention);
//     one k16 step (32 bytes of a row) lies inside the atom's row.
//   MN-major, swizzle S bytes: S bytes of consecutive M (or N) in a row,
//     8 rows of consecutive k an atom; SBO steps from one 8-deep k group to
//     the next, LBO from one S-byte M group to the next.
// The swizzle XORs address bits [4, 4+b) with bits [7, 7+b), b = log2(S/16),
// on the absolute shared address, so a tile starts on a multiple of 8*S.

#pragma once

#include <stdint.h>

namespace wgmma {

enum Swizzle : int { kNone = 0, kB128 = 1, kB64 = 2, kB32 = 3 };

// The descriptor's fields other than the start address (offsets in bytes).
__host__ __device__ constexpr uint64_t desc_bits(uint32_t lbo, uint32_t sbo,
                                                 int swizzle) {
  return (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(swizzle & 3) << 62);
}

// A descriptor at shared address `addr` (16-byte aligned).  Moving a
// descriptor by `bytes` within its tile is `d + (bytes >> 4)`.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint64_t bits) {
  return bits | static_cast<uint64_t>((addr >> 4) & 0x3FFF);
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy that wgmma reads through; then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers across wgmma's asynchronous window, so that
// the compiler neither moves nor reads them between the fence and the wait.
template <int M>
__device__ __forceinline__ void fence_operands(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WGMMA_D8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N, f32, N/2 registers a thread) += A (64 x 16) . B (16 x N), bf16
// operands from shared memory through descriptors `a` and `b`.  TransA /
// TransB = 1: that operand is MN-major, 0: K-major.  Accumulator fragment:
// d[v0 + 2*v1 + 4*j] is row 16*warp + lane/4 + 8*v1, column 8*j +
// 2*(lane%4) + v0 (warp and lane within the warpgroup).
template <int N, int TransA, int TransB>
__device__ __forceinline__ void mma_bf16(float (&d)[N / 2], uint64_t a,
                                         uint64_t b) {
  static_assert(N == 16 || N == 64 || N == 128, "instantiated widths");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " %8, %9, p, 1, 1, %11, %12;\n}\n"
        : WGMMA_D8(d, 0)
        : "l"(a), "l"(b), "r"(1), "n"(TransA), "n"(TransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, %35, %36;\n}\n"
        : WGMMA_D8(d, 0), WGMMA_D8(d, 8), WGMMA_D8(d, 16), WGMMA_D8(d, 24)
        : "l"(a), "l"(b), "r"(1), "n"(TransA), "n"(TransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, %67, %68;\n}\n"
        : WGMMA_D8(d, 0), WGMMA_D8(d, 8), WGMMA_D8(d, 16), WGMMA_D8(d, 24),
          WGMMA_D8(d, 32), WGMMA_D8(d, 40), WGMMA_D8(d, 48), WGMMA_D8(d, 56)
        : "l"(a), "l"(b), "r"(1), "n"(TransA), "n"(TransB));
  }
}

#undef WGMMA_D8

}  // namespace wgmma
