// SOS-cascade IIR filtering (scipy.signal.sosfilt semantics) for Hopper, as
// a chunked (block-parallel) scan over time.
//
// Replaces the Pallas TPU kernels of multimodal_brain_pattern_identification_xai_tpu/
// ops/pallas_iir.py: _make_kernel (plain cascade, optional lfilter_zi
// steady-state init; called at :165) and _make_rolldec_kernel (cascade
// from zero state with the fused 4-tap rolling mean + ::4 decimation;
// called at :254).  The TPU kernels walk time serially, 1,024 lanes to a
// vector register.  The JAX package runs lfilter from an explicit initial
// state as an XLA scan (ops/iir.py:473-475); here that is a third start
// mode of the same scan, in a kernel of its own with smaller CTAs
// (given_scan_kernel, entry iir_sosfilt_zi_f32).
//
// What bounds it on an H100: at the main path's largest shape (B=256:
// 5,120 lanes x 10,000 samples, 11 sections) the data is ~205 MB in and
// ~51 MB out for the rolldec variant, ~0.08 ms at 3.35 TB/s, and the
// arithmetic is 9 flop per biquad step, ~0.5 GFLOP.  A scan that walks each
// lane serially reaches neither: it is a chain of 10,000 dependent steps,
// and 5,120 lanes (80 at B=4, the on-demand batch) are too few threads to
// fill 132 SMs.
//
// Design: time is cut into C chunks of L samples (L % 4 == 0, the last one
// ragged).  One thread owns one (lane, chunk); a CTA owns every chunk of G
// lanes.  x is read and y written in their natural (lanes, T) layout with
// no transposes: the CTA stages kStage samples of each of its chunks at a
// time through shared memory, loaded with cp.async (16 bytes a thread,
// consecutive threads on consecutive addresses, double-buffered so the
// next stage loads while this one is scanned) and stored back the same
// way.  A thread streaming its own chunk straight from global memory
// touched 32 lines per warp access and reached ~0.9 TB/s.
//   Pass A: each thread scans its chunk from a seed and keeps only the exit
//     state (2K values).  Chunk 0 starts from the call's initial state
//     (zero, zi * x[0], or a state given for each lane); chunk j >= 1 from
//     w_j = zi * x[jL], the steady state of its own first sample, so a DC
//     offset leaves no large transient to cancel in the chain.
//   Chain: serial over chunks, one thread per (lane, state row), in
//     float64: e_1 = exit_0, e_{j+1} = A^L (e_j - w_j) + exit_j, with A^L
//     (2K x 2K, of the float32-rounded sections the passes run) in the
//     kernel's parameters.  In float32, or with A^L of the float64 design,
//     the chain's error (poles near z = 1, A^64 entries up to ~40) reached
//     the 2e-4 bound at L = 64; in float64 it stays at the sequential
//     scan's.  Nothing is truncated, so a NaN reaches every later chunk.
//     (Params exceed 4 KB: CUDA >= 12.1.)
//   Pass C: each thread rescans its chunk from its entry state e_j and
//     writes y, or the mean of every 4 outputs.
// A thread's dependent chain is 2L scan steps plus C chain steps instead of
// T; the price is the cascade's arithmetic twice (passes A and C) and x read
// twice.  The DF2T step is the TPU kernel's (pallas_iir.py:67-73).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 12;
constexpr int kMaxState = 2 * kMaxSections;
constexpr int kMaxThreads = 512;
constexpr int kGivenThreads = 256;   // given_scan_kernel's CTA limit
constexpr int kStage = 32;           // samples of every chunk staged at once
constexpr int kPitch = kStage + 4;   // floats per staged row: 16-byte rows,
                                     // float4 reads free of bank conflicts

struct Params {
  float c[kMaxSections][5];           // b0, b1, b2, a1, a2 (a0 normalised to 1)
  float zi[kMaxState];                // unit-step steady state, (z0, z1) per section
  double a_pow[kMaxState][kMaxState]; // A^L in the same state order
};

// Where the CTA's chunks lie: chunk j of lane lane0 + g is staged in row
// w = g * C + j and covers samples [jL, min(T, jL + L)); a pass stages
// chunks j < staged.
struct Geometry {
  const float* x;
  float* y;
  int T, lanes, L, C, lane0, staged;
};

// f(w, k, lane, t) for item k (of kPer, kStage / kPer samples each) of
// every row w < rows of the stage at s0 that lies inside its chunk, the
// signal, the lanes and the pass; t is the item's first sample.  kPer
// consecutive threads share a row, so a warp's accesses are contiguous.
template <int kPer, class F>
__device__ __forceinline__ void for_items(const Geometry& q, int rows, int s0,
                                          F f) {
  const int step = blockDim.x / kPer, k = threadIdx.x % kPer;
  const int s = s0 + k * (kStage / kPer);
  const int dg = step / q.C, dj = step - dg * q.C;
  int w = threadIdx.x / kPer, g = w / q.C, j = w - g * q.C;
  for (; w < rows; w += step) {
    const int lane = q.lane0 + g, t = j * q.L + s;
    if (lane < q.lanes && j < q.staged && s < q.L && t < q.T)
      f(w, k, lane, t);
    g += dg;
    j += dj;
    if (j >= q.C) {
      j -= q.C;
      ++g;
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Stage samples [s0, s0 + kStage) of the first `rows` rows into buf.
template <bool VEC>
__device__ __forceinline__ void stage_load(float* buf, const Geometry& q,
                                           int rows, int s0) {
  constexpr int kPer = VEC ? kStage / 4 : kStage;
  for_items<kPer>(q, rows, s0, [&](int w, int k, int lane, int t) {
    const float* src = q.x + static_cast<size_t>(lane) * q.T + t;
    float* dst = buf + w * kPitch + k * (kStage / kPer);
    if constexpr (VEC)
      cp_async16(dst, src);
    else
      cp_async4(dst, src);
  });
}

template <int K>
__device__ __forceinline__ float cascade_step(float v, float (&z0)[K],
                                              float (&z1)[K],
                                              const Params& p) {
  // DF2T, in the order of pallas_iir.py:67-73:
  //   y = b0 v + z0;  z0' = b1 v + z1 - a1 y;  z1' = b2 v - a2 y
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float y = p.c[k][0] * v + z0[k];
    z0[k] = p.c[k][1] * v + z1[k] - p.c[k][3] * y;
    z1[k] = p.c[k][2] * v - p.c[k][4] * y;
    v = y;
  }
  return v;
}

// Output sinks: what a scanned stage leaves in its own row, and (kStores)
// how the CTA then stores the staged rows.
struct NoOut {
  static constexpr bool kStores = false;
  __device__ void one(float*, int, float) const {}
  __device__ void four(float*, int, float, float, float, float) const {}
};

template <bool VEC>
struct StoreOut {                      // y (lanes, T): the outputs in place
  static constexpr bool kStores = true;
  __device__ void one(float* row, int s, float a) const { row[s] = a; }
  __device__ void four(float* row, int s, float a, float b, float c,
                       float d) const {
    *reinterpret_cast<float4*>(row + s) = make_float4(a, b, c, d);
  }
  __device__ void store(const float* buf, const Geometry& q, int rows,
                        int s0) const {
    constexpr int kPer = VEC ? kStage / 4 : kStage;
    for_items<kPer>(q, rows, s0, [&](int w, int k, int lane, int t) {
      const float* src = buf + w * kPitch + k * (kStage / kPer);
      float* dst = q.y + static_cast<size_t>(lane) * q.T + t;
      if constexpr (VEC)
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      else
        *dst = *src;
    });
  }
};

struct MeanOut {                       // y (lanes, T/4): row[s/4] = mean of 4
  static constexpr bool kStores = true;
  __device__ void one(float*, int, float) const {}  // T % 4 == 0: unused
  __device__ void four(float* row, int s, float a, float b, float c,
                       float d) const {
    row[s >> 2] = (a + b + c + d) * 0.25f;   // row[s..s+3] already read
  }
  __device__ void store(const float* buf, const Geometry& q, int rows,
                        int s0) const {
    for_items<kStage / 4>(q, rows, s0, [&](int w, int k, int lane, int t) {
      q.y[static_cast<size_t>(lane) * (q.T / 4) + t / 4] = buf[w * kPitch + k];
    });
  }
};

// Scan n samples of a staged row from the state (z0, z1).
template <int K, class Out>
__device__ __forceinline__ void scan_row(float* row, int n, float (&z0)[K],
                                         float (&z1)[K], const Params& p,
                                         const Out& out) {
  int s = 0;
  for (; s + 4 <= n; s += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + s);
    const float y0 = cascade_step<K>(v.x, z0, z1, p);
    const float y1 = cascade_step<K>(v.y, z0, z1, p);
    const float y2 = cascade_step<K>(v.z, z0, z1, p);
    const float y3 = cascade_step<K>(v.w, z0, z1, p);
    out.four(row, s, y0, y1, y2, y3);
  }
  for (; s < n; ++s) out.one(row, s, cascade_step<K>(row[s], z0, z1, p));
}

// One pass over the chunks of the CTA: stage after stage, the next one
// loading while this one is scanned.  Row w (this thread's, if active) is
// scanned over its chunk's `len` samples; the first `rows` rows are staged.
template <int K, bool VEC, class Out>
__device__ __forceinline__ void pass(float* buf0, float* buf1,
                                     const Geometry& q, int rows, bool active,
                                     int w, int len, float (&z0)[K],
                                     float (&z1)[K], const Params& p,
                                     const Out& out) {
  const int n_stages = (q.L + kStage - 1) / kStage;
  stage_load<VEC>(buf0, q, rows, 0);
  for (int st = 0, s0 = 0; st < n_stages; ++st, s0 += kStage) {
    float* cur = (st & 1) ? buf1 : buf0;
    cp_async_wait_all();
    __syncthreads();   // stage st landed; every read of the other buffer done
    if (st + 1 < n_stages)
      stage_load<VEC>((st & 1) ? buf0 : buf1, q, rows, s0 + kStage);
    const int n = min(kStage, len - s0);
    if (active && n > 0) scan_row<K>(cur + w * kPitch, n, z0, z1, p, out);
    if constexpr (Out::kStores) {
      __syncthreads();
      out.store(cur, q, rows, s0);
    }
  }
}

template <int K>
__device__ __forceinline__ void steady(float v, float (&z0)[K],
                                       float (&z1)[K], const Params& p) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    z0[k] = p.zi[2 * k] * v;
    z1[k] = p.zi[2 * k + 1] * v;
  }
}

// Where chunk 0 of a lane starts: from zero, from the steady state
// zi * x[0] (lfilter_zi), or from the lane's row of a given state
// (lanes, K, 2) in device memory.
constexpr int kFromZero = 0, kFromSteady = 1, kFromGiven = 2;

template <int K, int S>
__device__ __forceinline__ void start(const float* __restrict__ x,
                                      const float* __restrict__ zg, int lane,
                                      int T, float (&z0)[K], float (&z1)[K],
                                      const Params& p) {
  if constexpr (S == kFromSteady) {
    steady<K>(__ldg(x + static_cast<size_t>(lane) * T), z0, z1, p);
  } else if constexpr (S == kFromGiven) {
    const float* z = zg + static_cast<size_t>(lane) * 2 * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      z0[k] = __ldg(z + 2 * k);
      z1[k] = __ldg(z + 2 * k + 1);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) z0[k] = z1[k] = 0.f;
  }
}

// Dynamic shared memory: one region that holds either the chain's states
// (G*C*2K doubles) or the two stage buffers (2*G*C*kPitch floats), then
// G*C floats of x[jL].
__host__ __device__ inline size_t state_region(int rows, int K) {
  const size_t st = static_cast<size_t>(rows) * 2 * K * sizeof(double);
  const size_t bufs = static_cast<size_t>(rows) * 2 * kPitch * sizeof(float);
  return st > bufs ? st : bufs;
}

// S: where chunk 0 starts (kFromZero, kFromSteady, kFromGiven: from zg).
template <int K, int S, bool VEC, class Out>
__device__ __forceinline__ void chunked_scan(const float* __restrict__ x,
                                             float* __restrict__ y,
                                             const float* __restrict__ zg,
                                             int T, int lanes, int L, int C,
                                             int G, const Params& p) {
  constexpr int N = 2 * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = G * C;
  double* st = reinterpret_cast<double*>(smem);   // [G][C][N]: exit of
                                                  // chunk j, then e_{j+1}
  float* buf0 = reinterpret_cast<float*>(smem);   // aliases st
  float* buf1 = buf0 + rows * kPitch;
  float* x0 = reinterpret_cast<float*>(smem + state_region(rows, K));
  Geometry q{x, y, T, lanes, L, C, static_cast<int>(blockIdx.x) * G, C - 1};

  const int w = threadIdx.x, g = w / C, j = w - g * C;
  const int lane = q.lane0 + g;
  const bool worker = w < rows && lane < lanes;
  const int len = min(L, T - j * L);
  float z0[K], z1[K];

  // --- pass A: exit state of every chunk but the last, from its seed
  const bool first = worker && j < C - 1;
  if (first) {
    const float v0 = __ldg(x + static_cast<size_t>(lane) * T + j * L);
    x0[w] = v0;
    if (j > 0)
      steady<K>(v0, z0, z1, p);
    else
      start<K, S>(x, zg, lane, T, z0, z1, p);
  }
  if (C > 1) {
    pass<K, VEC>(buf0, buf1, q, rows, first, w, len, z0, z1, p, NoOut{});
    __syncthreads();   // the stage buffers are free: st may overwrite them
    if (first) {
      double* s = st + w * N;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s[2 * k] = z0[k];
        s[2 * k + 1] = z1[k];
      }
    }
  }

  // --- chain: st[j] = A^L (st[j-1] - w_j) + st[j], serial over j
  if (C > 2) {
    const int gr = threadIdx.x / N, i = threadIdx.x - gr * N;
    const bool row = gr < G && q.lane0 + gr < lanes;
    double a[N];
#pragma unroll
    for (int m = 0; m < N; ++m) a[m] = row ? p.a_pow[i][m] : 0.0;
    for (int jj = 1; jj < C - 1; ++jj) {
      __syncthreads();
      if (row) {
        const double* e = st + (gr * C + jj - 1) * N;
        const double v = x0[gr * C + jj];
        double* out = st + (gr * C + jj) * N + i;
        double acc0 = *out, acc1 = 0.0;
#pragma unroll
        for (int m = 0; m < N; m += 2) {
          acc0 = fma(a[m], fma(-static_cast<double>(p.zi[m]), v, e[m]), acc0);
          acc1 = fma(a[m + 1],
                     fma(-static_cast<double>(p.zi[m + 1]), v, e[m + 1]),
                     acc1);
        }
        *out = acc0 + acc1;
      }
    }
  }
  __syncthreads();

  // --- pass C: rescan every chunk from its entry state and write
  if (worker) {
    if (j == 0) {
      start<K, S>(x, zg, lane, T, z0, z1, p);
    } else {
      const double* s = st + (w - 1) * N;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        z0[k] = static_cast<float>(s[2 * k]);
        z1[k] = static_cast<float>(s[2 * k + 1]);
      }
    }
  }
  __syncthreads();     // every entry state read: the buffers may overwrite st
  q.staged = C;
  pass<K, VEC>(buf0, buf1, q, rows, worker, w, len, z0, z1, p, Out{});
}

template <int K, int S, bool VEC, class Out>
__global__ void __launch_bounds__(kMaxThreads)
chunked_scan_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float* __restrict__ zg, int T, int lanes, int L,
                    int C, int G, Params p) {
  chunked_scan<K, S, VEC, Out>(x, y, zg, T, lanes, L, C, G, p);
}

// From a given state: CTAs of at most kGivenThreads threads, so a thread
// may hold up to 255 registers; at kMaxThreads these instantiations spill
// at K = 5, 11 and 12 (20-88 B), at this bound none does.
template <int K, bool VEC>
__global__ void __launch_bounds__(kGivenThreads)
given_scan_kernel(const float* __restrict__ x, float* __restrict__ y,
                  const float* __restrict__ zg, int T, int lanes, int L,
                  int C, int G, Params p) {
  chunked_scan<K, kFromGiven, VEC, StoreOut<VEC>>(x, y, zg, T, lanes, L, C,
                                                  G, p);
}

struct Shape {
  int C;
  dim3 grid, block;
  size_t smem;
};

// Checks the arguments and derives the launch (at most max_threads a CTA);
// 0 or a cudaError_t.
int shape_of(int T, int lanes, int K, int L, int G, Shape* s,
             int max_threads = kMaxThreads) {
  if (K < 1 || K > kMaxSections || T < 1 || lanes < 1 || L < 4 || L % 4 ||
      G < 1)
    return cudaErrorInvalidValue;
  s->C = (T + L - 1) / L;
  const int width = s->C > 2 ? (s->C > 2 * K ? s->C : 2 * K) : s->C;
  if (static_cast<long>(G) * width > max_threads) return cudaErrorInvalidValue;
  s->grid = dim3((lanes + G - 1) / G);
  s->block = dim3((G * width + 31) / 32 * 32);
  s->smem = state_region(G * s->C, K) + G * s->C * sizeof(float);
  return 0;
}

Params make_params(int K, const float* coef, const float* zi,
                   const double* a_pow) {
  Params p{};
  const int n = 2 * K;
  for (int k = 0; k < K; ++k)
    for (int j = 0; j < 5; ++j) p.c[k][j] = coef[5 * k + j];
  for (int i = 0; i < n; ++i) {
    p.zi[i] = zi[i];
    for (int m = 0; m < n; ++m) p.a_pow[i][m] = a_pow[i * n + m];
  }
  return p;
}

template <typename Kern>
int launch(Kern kern, const Shape& s, cudaStream_t st, const float* x,
           float* y, const float* zg, int T, int lanes, int L, int G,
           const Params& p) {
  if (s.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(s.smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<s.grid, s.block, s.smem, st>>>(x, y, zg, T, lanes, L, s.C, G, p);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

#define IIR_CASES(M) \
  M(1) M(2) M(3) M(4) M(5) M(6) M(7) M(8) M(9) M(10) M(11) M(12)

}  // namespace

extern "C" {

// y (lanes, T) = cascade(x (lanes, T)), chunks of L samples, G lanes per
// CTA.  coef: host (K, 5); zi: host (K, 2) unit-step steady state; a_pow:
// host (2K, 2K) float64 A^L; zi_init: start from zi * x[0], not zero.
// Returns cudaGetLastError().
int iir_sosfilt_f32(const void* x, void* y, int T, int lanes, int K, int L,
                    int G, const float* coef, const float* zi, int zi_init,
                    const double* a_pow, void* stream) {
  Shape s;
  if (const int e = shape_of(T, lanes, K, L, G, &s)) return e;
  const Params p = make_params(K, coef, zi, a_pow);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* yo = static_cast<float*>(y);
  const bool vec = T % 4 == 0 && aligned16(x) && aligned16(y);
#define PICK(k, from, vec_)                                                 \
  launch(chunked_scan_kernel<k, from, vec_, StoreOut<vec_>>, s, st, xi, yo, \
         nullptr, T, lanes, L, G, p)
#define LAUNCH(k)                                                         \
  case k:                                                                 \
    return zi_init ? (vec ? PICK(k, kFromSteady, true)                    \
                          : PICK(k, kFromSteady, false))                  \
                   : (vec ? PICK(k, kFromZero, true)                      \
                          : PICK(k, kFromZero, false));
  switch (K) { IIR_CASES(LAUNCH) }
#undef LAUNCH
#undef PICK
  return cudaErrorInvalidValue;
}

// As iir_sosfilt_f32, with chunk 0 of lane l starting from z[l]: z is a
// device buffer (lanes, K, 2) float32, contiguous, the DF2T state (z0, z1)
// of each section; G lanes of C chunks fill at most kGivenThreads threads.
// Returns cudaGetLastError().
int iir_sosfilt_zi_f32(const void* x, void* y, int T, int lanes, int K, int L,
                       int G, const float* coef, const float* zi,
                       const void* z, const double* a_pow, void* stream) {
  Shape s;
  if (const int e = shape_of(T, lanes, K, L, G, &s, kGivenThreads)) return e;
  const Params p = make_params(K, coef, zi, a_pow);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  const float* zg = static_cast<const float*>(z);
  float* yo = static_cast<float*>(y);
  const bool vec = T % 4 == 0 && aligned16(x) && aligned16(y);
#define PICK(k, vec_) \
  launch(given_scan_kernel<k, vec_>, s, st, xi, yo, zg, T, lanes, L, G, p)
#define LAUNCH(k) \
  case k:         \
    return vec ? PICK(k, true) : PICK(k, false);
  switch (K) { IIR_CASES(LAUNCH) }
#undef LAUNCH
#undef PICK
  return cudaErrorInvalidValue;
}

// y (lanes, T/4) = rolling-mean-4 + ::4 of cascade(x (lanes, T)) from zero
// state; T % 4 == 0, x 16-byte aligned.  Returns cudaGetLastError().
int iir_sosfilt_rolldec_f32(const void* x, void* y, int T, int lanes, int K,
                            int L, int G, const float* coef, const float* zi,
                            const double* a_pow, void* stream) {
  Shape s;
  if (T % 4 || !aligned16(x)) return cudaErrorInvalidValue;
  if (const int e = shape_of(T, lanes, K, L, G, &s)) return e;
  const Params p = make_params(K, coef, zi, a_pow);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* yo = static_cast<float*>(y);
#define LAUNCH(k)                                                            \
  case k:                                                                    \
    return launch(chunked_scan_kernel<k, kFromZero, true, MeanOut>, s, st,  \
                  xi, yo, nullptr, T, lanes, L, G, p);
  switch (K) { IIR_CASES(LAUNCH) }
#undef LAUNCH
  return cudaErrorInvalidValue;
}

}  // extern "C"
