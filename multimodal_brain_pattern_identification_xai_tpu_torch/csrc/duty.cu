// Conv-probe duty kernel: out (co, N) f32 = sum over R passes of
// W (co, k) bf16 @ P (k, N) bf16, every pass from on-chip memory, for Hopper.
//
// Replaces the Pallas TPU kernel bench.py:bench_convprobe:make_duty
// (duty_kernel, pallas_call at bench.py:1123): the probe of the tensor-core
// rate at the small-Cout GEMM shapes a fused spectrogram block could run,
// with no device-memory traffic inside the loop.
//
// Design: a wgmma loop over shared-memory descriptors.  The product is
// computed transposed, out^T (columns x co) = P^T . W^T, so that the long
// dimension fills wgmma's 64 rows: M = 64 columns of P a warpgroup, N = co
// (16, 64 or 128), K = k in k16 steps (m64n{co}k16, f32 += bf16 . bf16).
// In the other orientation co = 16 would fill a quarter of each product.
// One CTA owns 128 columns of P with two warpgroups, one m64 tile each,
// sharing one staged W; with N = 16384 that is 128 CTAs for 132 SMs.
//
// Shared memory, staged once per CTA with 16-byte loads, in the wgmma
// canonical layouts (wgmma.cuh):
// - A, the P tile of each warpgroup: k rows of 64 columns = 128 bytes, the
//   128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)).  P is
//   n-contiguous, so A is MN-major (imm-trans-a = 1); SBO = 1024 bytes (8
//   rows of k), LBO = the tile's size (the next 64 columns; an m64 product
//   spans one 64-column group and does not read it); a k16 step moves the
//   descriptor by 2048 bytes.  Each tile starts on a multiple of 1024.
// - B, W: K-major (W is row-major; imm-trans-b = 0) in the 32-byte swizzle,
//   whose atom (8 rows of 32 bytes) is exactly one k16 slab: slab s holds
//   W[:, 16s:16s+16] as co rows of 32 bytes (chunk h of row c at h ^
//   ((c / 4) % 2)), SBO = 256 bytes (8 rows), LBO unused (16); a k16 step
//   moves the descriptor by co * 32 bytes.  k = 144 and 48 are not multiples
//   of 64, and this swizzle needs no padding: nothing past column k is
//   staged or read.
// The wrapper's smem_layout (ops/cuda_duty.py) states the same numbers and
// duty_layout below exports the kernel's; chip_smoke.py holds them equal and
// the CPU tests rehearse the staging and the descriptors' reads with numpy.
//
// The loop: one wgmma.fence, then each pass issues its k/16 products on the
// same accumulators and commits them as one group.  Operands in shared
// memory never change and chained wgmmas of one shape order their
// accumulators themselves, so passes need no barrier and no wait: the
// warpgroup waits once, before the epilogue.  Every operand is re-read from
// shared memory in every pass, as a fused block streaming its activations
// would (keeping P in registers would measure something else).  The
// accumulator fragment is stored transposed into out (co, N), written once.
//
// What bounds it on an H100: operations for co = 64 and 128, 2*R*co*k*N
// over the dense bf16 rate (989 TFLOP/s); for co = 16, shared memory: each
// m64n16k16 reads 2048 bytes of A and 512 of B for 32,768 operations, and
// an SM reads 128 bytes a clock, so it cannot pass ~40 % of that rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kWarpgroups = 2;                 // m64 tiles per CTA
constexpr int kNTile = 64 * kWarpgroups;       // columns of P per CTA
constexpr int kARow = 128;                     // bytes per k-row of an A tile
constexpr int kASbo = 8 * kARow;               // 8 rows of k: one B128 atom
constexpr int kAKStep = 16 * kARow;            // bytes per k16 step
constexpr int kBRow = 32;                      // bytes per W row in a slab
constexpr int kBSbo = 8 * kBRow;               // 8 rows: one B32 atom
constexpr int kBLbo = 16;                      // not read (K-major swizzled)
constexpr int kAlign = 1024;                   // the B128 swizzle's repeat
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ constexpr int a_tile_bytes(int k) { return k * kARow; }
__host__ __device__ constexpr int b_offset(int k) {
  return kWarpgroups * a_tile_bytes(k);
}
__host__ __device__ constexpr int b_kstep(int co) { return co * kBRow; }

// The tiles, plus slack to round the dynamic base up to kAlign.
inline size_t smem_bytes(int co, int k) {
  return static_cast<size_t>(b_offset(k)) + static_cast<size_t>(co) * k * 2 +
         kAlign;
}

template <int CO, int K>
__global__ void __launch_bounds__(128 * kWarpgroups, 1)
duty_kernel(const __nv_bfloat16* __restrict__ w,
            const __nv_bfloat16* __restrict__ p, float* __restrict__ out,
            int N, int R) {
  static_assert(K % 16 == 0 && CO % 8 == 0, "shape");
  constexpr uint64_t kADesc = wgmma::desc_bits(a_tile_bytes(K), kASbo,
                                               wgmma::kB128);
  constexpr uint64_t kBDesc = wgmma::desc_bits(kBLbo, kBSbo, wgmma::kB32);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~uint32_t(kAlign - 1);
  uint8_t* sm = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kNTile;

  // P tile: row kr, 16-byte chunk c of the CTA's 128 columns -> warpgroup
  // g = c / 8's tile, chunk (c % 8) ^ (kr % 8) of its 128-byte row
  for (int i = tid; i < K * (kNTile / 8); i += blockDim.x) {
    const int kr = i / (kNTile / 8), c = i % (kNTile / 8);
    const uint4 v = *reinterpret_cast<const uint4*>(
        p + static_cast<size_t>(kr) * N + n0 + c * 8);
    *reinterpret_cast<uint4*>(sm + (c / 8) * a_tile_bytes(K) + kr * kARow +
                              (((c % 8) ^ (kr % 8)) << 4)) = v;
  }
  // W: row ch, 16-byte chunk q of k -> slab q / 2, half q % 2, swizzled
  for (int i = tid; i < CO * (K / 8); i += blockDim.x) {
    const int ch = i / (K / 8), q = i % (K / 8);
    const uint4 v = *reinterpret_cast<const uint4*>(
        w + static_cast<size_t>(ch) * K + q * 8);
    *reinterpret_cast<uint4*>(sm + b_offset(K) + (q / 2) * b_kstep(CO) +
                              (ch / 8) * kBSbo + (ch % 8) * kBRow +
                              (((q % 2) ^ ((ch / 4) % 2)) << 4)) = v;
  }
  wgmma::fence_proxy_async();
  __syncthreads();

  const int g = tid / 128;
  const uint64_t a0 = wgmma::desc(base + g * a_tile_bytes(K), kADesc);
  const uint64_t b0 = wgmma::desc(base + b_offset(K), kBDesc);

  float acc[CO / 2];
#pragma unroll
  for (int i = 0; i < CO / 2; ++i) acc[i] = 0.f;
  wgmma::fence_operands(acc);
  wgmma::fence();
  for (int pass = 0; pass < R; ++pass) {
#pragma unroll
    for (int s = 0; s < K / 16; ++s)
      wgmma::mma_bf16<CO, 1, 0>(acc, a0 + ((s * kAKStep) >> 4),
                                b0 + ((s * b_kstep(CO)) >> 4));
    wgmma::commit();
  }
  wgmma::wait<0>();
  wgmma::fence_operands(acc);

  // acc[v0 + 2*v1 + 4*j]: M row (a column of P) 16*warp + lane/4 + 8*v1,
  // N column (an output channel) 8*j + 2*(lane%4) + v0
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int col = n0 + g * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < CO / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int ch = 8 * j + 2 * (lane % 4) + v % 2;
      out[static_cast<size_t>(ch) * N + col + 8 * (v / 2)] = acc[4 * j + v];
    }
}

template <int CO, int K>
int launch(const void* w, const void* p, float* out, int N, int R,
           cudaStream_t st) {
  const size_t smem = smem_bytes(CO, K);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kern = duty_kernel<CO, K>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<N / kNTile, 128 * kWarpgroups, smem, st>>>(
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(p), out, N, R);
  return cudaGetLastError();
}

bool known(int co, int k) {
  return (co == 16 && k == 144) || (co == 64 && k == 256) ||
         (co == 128 && k == 384) || (co == 64 && k == 48);
}

}  // namespace

extern "C" {

// The kernel's shared-memory layout for (co, k), in the order of
// ops/cuda_duty.py's LAYOUT_KEYS: warpgroups, n_tile, a_swizzle, a_pitch,
// a_tile, a_lbo, a_sbo, a_kstep, a_desc, b_offset, b_swizzle, b_pitch,
// b_pad, b_lbo, b_sbo, b_kstep, b_desc, smem_bytes (bytes; swizzles in
// bytes; *_desc the descriptor's bits besides the start address).  Writes
// at most n values; returns how many it has, or -1 for a shape it does
// not take.
int duty_layout(int co, int k, unsigned long long* v, int n) {
  if (!known(co, k)) return -1;
  using u64 = unsigned long long;
  const u64 f[] = {u64(kWarpgroups), u64(kNTile), 128, u64(kARow),
                   u64(a_tile_bytes(k)), u64(a_tile_bytes(k)), u64(kASbo),
                   u64(kAKStep),
                   wgmma::desc_bits(a_tile_bytes(k), kASbo, wgmma::kB128),
                   u64(b_offset(k)), 32, u64(kBRow), 0, u64(kBLbo),
                   u64(kBSbo), u64(b_kstep(co)),
                   wgmma::desc_bits(kBLbo, kBSbo, wgmma::kB32),
                   u64(smem_bytes(co, k))};
  const int m = static_cast<int>(sizeof(f) / sizeof(f[0]));
  for (int i = 0; i < m && i < n; ++i) v[i] = f[i];
  return m;
}

// w: (co, k) bf16 row-major; p: (k, N) bf16 row-major; out: (co, N) f32.
// (co, k) in {(16, 144), (64, 256), (128, 384), (64, 48)}; N a positive
// multiple of 128 (at most 128 * 2^31 - 1); R >= 0.  Returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not take).
int duty_bf16(const void* w, const void* p, float* out, int co, int k, int N,
              int R, void* stream) {
  if (N < kNTile || N % kNTile || R < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (co == 16 && k == 144) return launch<16, 144>(w, p, out, N, R, st);
  if (co == 64 && k == 256) return launch<64, 256>(w, p, out, N, R, st);
  if (co == 128 && k == 384) return launch<128, 384>(w, p, out, N, R, st);
  if (co == 64 && k == 48) return launch<64, 48>(w, p, out, N, R, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
