// Conv-probe duty kernel: out (co, N) f32 = sum over R passes of
// W (co, k) bf16 @ P (k, N) bf16, every pass from on-chip memory, for Hopper.
//
// Replaces the Pallas TPU kernel bench.py:bench_convprobe:make_duty
// (duty_kernel, pallas_call at bench.py:1123): the probe of the tensor-core
// rate at the small-Cout GEMM shapes a fused spectrogram block could run,
// with no device-memory traffic inside the loop.
//
// Design: one CTA per 128-column tile of P.  The CTA copies W (co x k) and
// its P tile (k x 128) into shared memory once (rows padded by 16 bytes so
// that ldmatrix's eight row addresses fall in distinct banks), then runs R
// passes.  Each pass re-reads every operand fragment from shared memory
// with ldmatrix (A row-major; B with .trans, since P is k-major) into bf16
// mma.sync.m16n8k16 with f32 accumulators in registers; the result is
// written once.  Keeping W's fragments in registers across passes would
// measure something a fused block never does.  Warps tile the (co x 128)
// output: WN = 4 warps across the columns (32 each, four n8 tiles), WM =
// max(1, co / 32) warps down the rows (MT = co / 16 / WM m16 tiles each).
//
// What bounds it on an H100: operations.  A pass reads no device memory, so
// the least time is 2*R*co*k*N over the dense bf16 tensor-core rate
// (989 TFLOP/s).  mma.sync issues at most ~2/3 of that rate on Hopper
// (wgmma alone reaches it, and needs 64-row tiles that co = 16 does not
// fill), and with N = 16384 there are 128 CTAs for 132 SMs, one each, so
// each SM has only 4-16 warps to hide ldmatrix and mma latency.
//
// Shared memory: (co*(k+8) + k*(128+8)) * 2 bytes; (128, 384) needs
// 204,800 bytes (above 48 KB: cudaFuncSetAttribute raises the limit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNTile = 128;               // columns of P per CTA
constexpr int kPad = 8;                   // bf16 of padding per smem row
constexpr int kPPitch = kNTile + kPad;    // P tile row pitch (bf16)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int warps_m(int co) {
  return co >= 32 ? co / 32 : 1;
}

inline size_t smem_bytes(int co, int k) {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>(co) * (k + kPad) +
          static_cast<size_t>(k) * kPPitch);
}

template <int CO, int K>
__global__ void __launch_bounds__(128 * warps_m(CO))
duty_kernel(const __nv_bfloat16* __restrict__ w,
            const __nv_bfloat16* __restrict__ p, float* __restrict__ out,
            int N, int R) {
  constexpr int WM = warps_m(CO);
  constexpr int MT = CO / 16 / WM;        // m16 tiles per warp
  constexpr int NT = 4;                   // n8 tiles per warp (32 columns)
  constexpr int WP = K + kPad;            // W row pitch (bf16)
  static_assert(K % 16 == 0 && CO % 16 == 0 && MT >= 1, "shape");

  extern __shared__ uint4 smem16[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem16);
  __nv_bfloat16* ps = ws + CO * WP;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kNTile;

  // W and the CTA's P tile into shared memory, 16 bytes per thread per step
  for (int i = tid; i < CO * (K / 8); i += blockDim.x) {
    const int r = i / (K / 8), c = (i % (K / 8)) * 8;
    *reinterpret_cast<uint4*>(ws + r * WP + c) =
        *reinterpret_cast<const uint4*>(w + static_cast<size_t>(r) * K + c);
  }
  for (int i = tid; i < K * (kNTile / 8); i += blockDim.x) {
    const int r = i / (kNTile / 8), c = (i % (kNTile / 8)) * 8;
    *reinterpret_cast<uint4*>(ps + r * kPPitch + c) =
        *reinterpret_cast<const uint4*>(p + static_cast<size_t>(r) * N + n0 +
                                        c);
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int row0 = wm * MT * 16;          // first output row of this warp
  const int col0 = wn * NT * 8;           // first column (within the tile)

  // ldmatrix row addresses: lane supplies row (lane % 16), column half
  // (lane / 16) * 8 — for A (rows of W) and, transposed, for B (rows of P)
  uint32_t a_addr[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    a_addr[mt] = smem_u32(ws + (row0 + mt * 16 + lane % 16) * WP +
                          (lane / 16) * 8);
  uint32_t b_addr[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j)
    b_addr[j] = smem_u32(ps + (lane % 16) * kPPitch + col0 + j * 16 +
                         (lane / 16) * 8);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  for (int pass = 0; pass < R; ++pass) {
#pragma unroll 4
    for (int kk = 0; kk < K; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], a_addr[mt] + kk * 2);
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldmatrix_x4_trans(b[j], b_addr[j] + kk * kPPitch * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          mma_bf16(acc[mt][2 * j], a[mt], b[j][0], b[j][1]);
          mma_bf16(acc[mt][2 * j + 1], a[mt], b[j][2], b[j][3]);
        }
    }
  }

  // C fragment: (row lane/4, cols 2*(lane%4) + {0,1}) and row + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = row0 + mt * 16 + lane / 4;
      const int c = n0 + col0 + nt * 8 + 2 * (lane % 4);
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * N + c) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8) * N + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
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
  kern<<<N / kNTile, 128 * warps_m(CO), smem, st>>>(
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(p), out, N, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs for (co, k).
long long duty_smem_bytes(int co, int k) {
  return static_cast<long long>(smem_bytes(co, k));
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
