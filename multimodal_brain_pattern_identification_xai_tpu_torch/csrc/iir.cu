// SOS-cascade IIR filtering (scipy.signal.sosfilt semantics) for Hopper.
//
// Replaces the Pallas TPU kernels of multimodal_brain_pattern_identification_xai_tpu/
// ops/pallas_iir.py: _make_kernel (plain cascade, optional lfilter_zi
// steady-state init; called at :165) and _make_rolldec_kernel (cascade
// from zero state with the fused 4-tap rolling mean + ::4 decimation;
// called at :254).
//
// Layout: time-major (T, lanes) float32; the Python wrapper transposes, as
// the TPU wrapper packs (n_tiles, T, 8, 128).  One thread owns one lane and
// walks time serially with every section's two DF2T state words in
// registers; a warp reads 32 consecutive lanes (128 contiguous bytes) per
// step.  The normalised coefficients (b0, b1, b2, a1, a2) per section come
// by value in the kernel's parameter space (uniform constant-bank reads);
// the kernel is templated on the section count K (1..12).
//
// What bounds it on an H100: at the main path's largest shape (B=256:
// 5,120 lanes x 10,000 samples, 11 sections) the data is ~205 MB in and
// ~51 MB out for the rolldec variant, ~0.08 ms at 3.35 TB/s, and the
// arithmetic is ~0.6 GFLOP.  Neither is the floor: the recurrence is a
// serial chain of 10,000 steps x K dependent FMAs per lane, and 5,120
// lanes (80 at B=4) fill only a few warps on each of the 132 SMs, so the
// kernel is latency-bound on that chain.  The design spreads lanes over as
// many SMs as possible (32-thread blocks) and keeps loads independent of
// the state so they issue ahead of the chain; a chunked (block-parallel)
// scan that shortens the chain is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 12;
constexpr int kThreads = 32;

struct Sections {
  float c[kMaxSections][5];    // b0, b1, b2, a1, a2 (a0 normalised to 1)
  float zi[kMaxSections][2];   // steady-state DF2T state per unit input
};

template <int K>
__device__ __forceinline__ float cascade_step(float v, float (&z0)[K],
                                              float (&z1)[K],
                                              const Sections& s) {
  // DF2T, in the order of pallas_iir.py:67-73:
  //   y = b0 v + z0;  z0' = b1 v + z1 - a1 y;  z1' = b2 v - a2 y
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float y = s.c[k][0] * v + z0[k];
    z0[k] = s.c[k][1] * v + z1[k] - s.c[k][3] * y;
    z1[k] = s.c[k][2] * v - s.c[k][4] * y;
    v = y;
  }
  return v;
}

template <int K, bool ZI>
__global__ void __launch_bounds__(kThreads)
sosfilt_kernel(const float* __restrict__ x, float* __restrict__ y, int T,
               int lanes, Sections s) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  float z0[K], z1[K];
  const float v0 = ZI ? x[l] : 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    z0[k] = ZI ? s.zi[k][0] * v0 : 0.f;
    z1[k] = ZI ? s.zi[k][1] * v0 : 0.f;
  }
  const size_t stride = static_cast<size_t>(lanes);
#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    y[t * stride + l] = cascade_step<K>(x[t * stride + l], z0, z1, s);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
sosfilt_rolldec_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int T, int lanes, Sections s) {
  // zero initial state; out[u] = mean(y[4u .. 4u+3]) (requires T % 4 == 0,
  // so no window crosses the end of a lane — pallas_iir.py:92-96)
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  float z0[K], z1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) z0[k] = z1[k] = 0.f;
  const size_t stride = static_cast<size_t>(lanes);
  const int n_out = T / 4;
  for (int u = 0; u < n_out; ++u) {
    const float* xu = x + (4 * static_cast<size_t>(u)) * stride + l;
    const float y0 = cascade_step<K>(xu[0], z0, z1, s);
    const float y1 = cascade_step<K>(xu[stride], z0, z1, s);
    const float y2 = cascade_step<K>(xu[2 * stride], z0, z1, s);
    const float y3 = cascade_step<K>(xu[3 * stride], z0, z1, s);
    y[u * stride + l] = (y0 + y1 + y2 + y3) * 0.25f;
  }
}

Sections make_sections(int K, const float* coef, const float* zi) {
  Sections s{};
  for (int k = 0; k < K; ++k) {
    for (int j = 0; j < 5; ++j) s.c[k][j] = coef[5 * k + j];
    if (zi != nullptr) {
      s.zi[k][0] = zi[2 * k];
      s.zi[k][1] = zi[2 * k + 1];
    }
  }
  return s;
}

#define IIR_CASES(M) \
  M(1) M(2) M(3) M(4) M(5) M(6) M(7) M(8) M(9) M(10) M(11) M(12)

}  // namespace

extern "C" {

// y (T, lanes) = cascade(x (T, lanes)); coef: host (K, 5); zi: host (K, 2)
// or NULL for a zero initial state.  Returns cudaGetLastError().
int iir_sosfilt_f32(const void* x, void* y, int T, int lanes, int K,
                    const float* coef, const float* zi, void* stream) {
  if (K < 1 || K > kMaxSections || T < 1 || lanes < 1)
    return cudaErrorInvalidValue;
  const Sections s = make_sections(K, coef, zi);
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* yo = static_cast<float*>(y);
#define LAUNCH(k)                                                          \
  case k:                                                                  \
    if (zi != nullptr)                                                     \
      sosfilt_kernel<k, true><<<grid, kThreads, 0, st>>>(xi, yo, T, lanes, \
                                                         s);               \
    else                                                                   \
      sosfilt_kernel<k, false><<<grid, kThreads, 0, st>>>(xi, yo, T,       \
                                                          lanes, s);       \
    break;
  switch (K) { IIR_CASES(LAUNCH) }
#undef LAUNCH
  return cudaGetLastError();
}

// y (T/4, lanes) = rolling-mean-4 + ::4 of cascade(x (T, lanes)) from zero
// state; T % 4 == 0.  Returns cudaGetLastError().
int iir_sosfilt_rolldec_f32(const void* x, void* y, int T, int lanes, int K,
                            const float* coef, void* stream) {
  if (K < 1 || K > kMaxSections || T < 4 || T % 4 != 0 || lanes < 1)
    return cudaErrorInvalidValue;
  const Sections s = make_sections(K, coef, nullptr);
  const dim3 grid((lanes + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* yo = static_cast<float*>(y);
#define LAUNCH(k)                                                        \
  case k:                                                                \
    sosfilt_rolldec_kernel<k><<<grid, kThreads, 0, st>>>(xi, yo, T, lanes, \
                                                          s);            \
    break;
  switch (K) { IIR_CASES(LAUNCH) }
#undef LAUNCH
  return cudaGetLastError();
}

}  // extern "C"
