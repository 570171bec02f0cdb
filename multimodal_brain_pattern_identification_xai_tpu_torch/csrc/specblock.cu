// Fused spectrogram block: three 3x3 SAME convs (bias + ReLU each) then a
// 2x2 stride-2 VALID max or avg pool, NHWC in and out, for Hopper.
//
// Replaces the Pallas TPU kernel multimodal_brain_pattern_identification_xai_tpu/
// ops/pallas_specblock.py:_make_kernel (launched by fused_specblock_convpool,
// pallas_call at :242).  As there, the two intermediate activations never
// reach device memory.  The TPU kernel's phase-packed GEMM layout existed
// to fill the MXU and is not carried over.
//
// Design: one CTA of 256 threads per (sample, 16x16 tile of conv3
// outputs).  It stages the input tile with a 3-pixel halo in shared memory
// (channel-planar, zero outside the image), then runs
//   conv1: (16+6)^2 x Cin  -> (16+4)^2 x C
//   conv2: (16+4)^2 x C    -> (16+2)^2 x C
//   conv3: (16+2)^2 x C    ->  16^2    x C
// through shared memory, each stage's weights (HWIO, i.e. [tap][ci][co])
// staged in shared memory and read as warp-uniform float4 broadcasts.  A
// thread owns one output pixel and all C output channels in registers.
// SAME-padding trap: each conv is padded on its own, so every intermediate
// position outside the image is written as zero (not as a conv output over
// the padded input) — the TPU kernel re-zeros them after every stage.
// Ragged edges (W = 300, 150 are not multiples of 16) are masked at the
// pooled store.  Storage type T (float or bf16): every stage's f32
// bias+ReLU result is rounded to T, and the avg pool sums in f32 and
// divides by 4, as _xla_chain_convpool and the TPU kernel do.
//
// Shared memory (f32 words): weights 9*max(Cin,C)*C + bias 3C +
// max(Cin*22^2, C*18^2) + max(C*20^2, C*(16^2+1)).  Block 2 (Cin=16, C=32)
// needs 129,920 bytes (above 48 KB, so cudaFuncSetAttribute raises the
// limit), block 1 (Cin=3, C=16) 55,744 bytes.
//
// What bounds it on an H100: at the main path's B=256 block 1 moves
// ~369 MB in and ~491 MB out (~0.26 ms at 3.35 TB/s) but needs ~0.31
// TFLOP of f32 multiply-adds (~4.6 ms at 67 TFLOP/s on the CUDA cores);
// block 2 ~0.74 GB and ~0.35 TFLOP (~5.3 ms).  Both are bound by
// operations.  This first kernel runs them as direct convolution on the
// CUDA cores, with ~1.56x (conv1) and ~1.27x (conv2) halo recompute; an
// implicit-GEMM formulation on the tensor cores is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                 // conv3 output tile edge
constexpr int kThreads = 256;
constexpr int kR0 = kTile + 6;            // staged input edge
constexpr int kR1 = kTile + 4;            // conv1 output edge
constexpr int kR2 = kTile + 2;            // conv2 output edge
constexpr int kP3 = kTile * kTile + 1;    // conv3 plane pitch (odd: no bank
                                          // conflicts in the pool pass)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float load_f(float v) { return v; }
__device__ __forceinline__ float load_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T store_t(float v);
template <>
__device__ __forceinline__ float store_t<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_t<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return load_f(store_t<T>(v));
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int weight_words(int cin, int c) {
  return 9 * imax(cin, c) * c;
}
__host__ __device__ inline int buf0_words(int cin, int c) {
  return imax(cin * kR0 * kR0, c * kR2 * kR2);
}
__host__ __device__ inline int bufa_words(int c) {
  return imax(c * kR1 * kR1, c * kP3);
}
inline size_t smem_bytes(int cin, int c) {
  return sizeof(float) * static_cast<size_t>(weight_words(cin, c) + 3 * c +
                                             buf0_words(cin, c) + bufa_words(c));
}

// One conv stage: src (cin planes of rin x rin) -> dst (C planes of
// rout x rout, plane pitch `pitch`), rout = rin - 2; `halo` = how far the
// dst region starts above/left of the tile origin (y0, x0).
template <int C, typename T>
__device__ __forceinline__ void conv_stage(const float* __restrict__ src,
                                           int rin, int cin,
                                           const float* __restrict__ sw,
                                           const float* __restrict__ sb,
                                           float* __restrict__ dst, int pitch,
                                           int halo, int y0, int x0, int H,
                                           int W) {
  const int rout = rin - 2;
  const int plane = rin * rin;
  for (int p = threadIdx.x; p < rout * rout; p += blockDim.x) {
    const int py = p / rout, px = p - py * rout;
    float acc[C];
#pragma unroll
    for (int co = 0; co < C; ++co) acc[co] = 0.f;
    for (int ci = 0; ci < cin; ++ci) {
      const float* s = src + ci * plane + py * rin + px;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v = s[ky * rin + kx];
          const float4* w4 = reinterpret_cast<const float4*>(
              sw + ((ky * 3 + kx) * cin + ci) * C);
#pragma unroll
          for (int q = 0; q < C / 4; ++q) {
            const float4 w = w4[q];
            acc[4 * q + 0] += v * w.x;
            acc[4 * q + 1] += v * w.y;
            acc[4 * q + 2] += v * w.z;
            acc[4 * q + 3] += v * w.w;
          }
        }
      }
    }
    const int gy = y0 - halo + py, gx = x0 - halo + px;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int co = 0; co < C; ++co) {
      const float r = inside ? fmaxf(acc[co] + sb[co], 0.f) : 0.f;
      dst[co * pitch + p] = round_to<T>(r);
    }
  }
}

template <int C, typename T>
__global__ void __launch_bounds__(kThreads)
specblock_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ w2, const float* __restrict__ w3,
                 const float* __restrict__ bias, T* __restrict__ out, int H,
                 int W, int cin, int tiles_x, int pool_max) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  float* sb = sw + weight_words(cin, C);
  float* buf0 = sb + 3 * C;
  float* bufa = buf0 + buf0_words(cin, C);

  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int tid = threadIdx.x;

  // input tile with a 3-pixel halo, channel-planar; zero outside the image
  for (int i = tid; i < kR0 * kR0 * cin; i += blockDim.x) {
    const int c = i % cin, p = i / cin;
    const int gy = y0 - 3 + p / kR0, gx = x0 - 3 + p % kR0;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = load_f(x[((static_cast<size_t>(b) * H + gy) * W + gx) * cin + c]);
    buf0[c * kR0 * kR0 + p] = v;
  }
  for (int i = tid; i < 3 * C; i += blockDim.x) sb[i] = bias[i];
  for (int i = tid; i < 9 * cin * C; i += blockDim.x) sw[i] = w1[i];
  __syncthreads();
  conv_stage<C, T>(buf0, kR0, cin, sw, sb, bufa, kR1 * kR1, 2, y0, x0, H, W);
  __syncthreads();
  for (int i = tid; i < 9 * C * C; i += blockDim.x) sw[i] = w2[i];
  __syncthreads();
  conv_stage<C, T>(bufa, kR1, C, sw, sb + C, buf0, kR2 * kR2, 1, y0, x0, H,
                   W);
  __syncthreads();
  for (int i = tid; i < 9 * C * C; i += blockDim.x) sw[i] = w3[i];
  __syncthreads();
  conv_stage<C, T>(buf0, kR2, C, sw, sb + 2 * C, bufa, kP3, 0, y0, x0, H, W);
  __syncthreads();

  // 2x2 pool of the conv3 tile; NHWC store, channel fastest (coalesced)
  const int ho = H / 2, wo = W / 2, half = kTile / 2;
  for (int i = tid; i < half * half * C; i += blockDim.x) {
    const int co = i % C, q = i / C;
    const int qy = q / half, qx = q % half;
    const int oy = y0 / 2 + qy, ox = x0 / 2 + qx;
    if (oy >= ho || ox >= wo) continue;
    const float* s = bufa + co * kP3 + 2 * qy * kTile + 2 * qx;
    const float a = s[0], bb = s[1], c = s[kTile], d = s[kTile + 1];
    const float r = pool_max ? fmaxf(fmaxf(a, bb), fmaxf(c, d))
                             : (a + bb + c + d) * 0.25f;
    out[((static_cast<size_t>(b) * ho + oy) * wo + ox) * C + co] =
        store_t<T>(r);
  }
}

template <int C, typename T>
int launch(const void* x, const float* w1, const float* w2, const float* w3,
           const float* bias, void* out, int B, int H, int W, int cin,
           int pool_max, cudaStream_t st) {
  const size_t smem = smem_bytes(cin, C);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kern = specblock_kernel<C, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles_y = (H + kTile - 1) / kTile;
  const int tiles_x = (W + kTile - 1) / kTile;
  const dim3 grid(tiles_y * tiles_x, B);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(x), w1, w2, w3,
                                     bias, static_cast<T*>(out), H, W, cin,
                                     tiles_x, pool_max);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int cout, const void* x, const float* w1, const float* w2,
             const float* w3, const float* bias, void* out, int B, int H,
             int W, int cin, int pool_max, cudaStream_t st) {
  switch (cout) {
    case 8:
      return launch<8, T>(x, w1, w2, w3, bias, out, B, H, W, cin, pool_max,
                          st);
    case 16:
      return launch<16, T>(x, w1, w2, w3, bias, out, B, H, W, cin, pool_max,
                           st);
    case 32:
      return launch<32, T>(x, w1, w2, w3, bias, out, B, H, W, cin, pool_max,
                           st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs for (cin, cout).
long long specblock_smem_bytes(int cin, int cout) {
  return static_cast<long long>(smem_bytes(cin, cout));
}

// x: (B, H, W, cin) NHWC of the storage type (bf16 != 0: __nv_bfloat16,
// else float); w1: (3, 3, cin, cout), w2, w3: (3, 3, cout, cout) HWIO f32
// (already rounded to the storage type); bias: (3, cout) f32; out:
// (B, H/2, W/2, cout) NHWC of the storage type.  H, W even; cout in
// {8, 16, 32}; B <= 65535.  Returns cudaGetLastError() (or
// cudaErrorInvalidValue for shapes it does not take).
int specblock_convpool(const void* x, const float* w1, const float* w2,
                       const float* w3, const float* bias, void* out, int B,
                       int H, int W, int cin, int cout, int pool_max,
                       int bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || H % 2 || W % 2 || cin < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(cout, x, w1, w2, w3, bias, out, B, H, W,
                                   cin, pool_max, st);
  return dispatch<float>(cout, x, w1, w2, w3, bias, out, B, H, W, cin,
                         pool_max, st);
}

}  // extern "C"
