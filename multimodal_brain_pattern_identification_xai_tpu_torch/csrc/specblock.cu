// Fused spectrogram block: three 3x3 SAME convs (bias + ReLU each) then a
// 2x2 stride-2 VALID max or avg pool, NHWC in and out, for Hopper.
//
// Replaces the Pallas TPU kernel multimodal_brain_pattern_identification_xai_tpu/
// ops/pallas_specblock.py:_make_kernel (launched by fused_specblock_convpool,
// pallas_call at :242).  As there, the two intermediate activations never
// reach device memory, except at Cout 64/128/256 (three launches of one
// conv, below).  The TPU kernel's phase-packed GEMM layout
// existed to fill the MXU and is not carried over.
//
// Cout 8/16/32, tiling (both storage types): one CTA of 256 threads per
// (sample, 16x16 tile of conv3 outputs), batches above gridDim.y's 65,535
// in slices.  It stages the input tile with a 3-pixel halo in
// shared memory (channel-planar, zero outside the image), then runs
//   conv1: (16+6)^2 x Cin  -> (16+4)^2 x C
//   conv2: (16+4)^2 x C    -> (16+2)^2 x C
//   conv3: (16+2)^2 x C    ->  16^2    x C
// through shared memory, each stage's weights (HWIO, i.e. [tap][ci][co])
// staged in shared memory, then pools the conv3 tile into the NHWC output
// (ragged edges masked; W = 300, 150 are not multiples of 16).
// SAME-padding trap: each conv is padded on its own, so every intermediate
// position outside the image is written as zero (not as a conv output over
// the padded input) — the TPU kernel re-zeros them after every stage.
//
// float32 storage: specblock_tc_kernel<C>, an implicit GEMM per conv stage
// on the tensor cores (mma.sync.m16n8k8 tf32).  M = the stage's output
// positions (400, 324, 256, padded to multiples of 16; padded rows read a
// clamped in-bounds address and are dropped at the store), N = C in n-tiles
// of 8, K = 9 taps x Cin in k-steps of 8 channels within one tap.  The A
// fragment is gathered straight from the channel-planar source: element
// (m, k) is src[(k0+k)*pitch + (py(m)+ky)*rin + px(m)+kx], so a tap is an
// address offset and no im2col buffer exists.  3xTF32 keeps f32 accuracy:
// each weight is split once per CTA into hi = tf32(w), lo = tf32(w - hi)
// (two shared arrays), each activation after its fragment load, and each
// k-step issues lo*hi, hi*lo, hi*hi (lo*lo, ~2^-22 relative, is left out).
// The tensor cores truncate toward zero when they add into an accumulator:
// with all three products chained in one accumulator the block-2 output
// sat ~10x further from a float64 reference than cuDNN's f32 convolution
// and missed rtol = atol = 1e-5.  So the small products chain in their own
// accumulator, and each k-step's hi*hi starts from zero and is added to
// the main accumulator by an f32 add that rounds to nearest; the result
// is then closer to float64 than cuDNN's f32 convolution.  A warp owns a
// contiguous run of m-tiles, taken in pairs over all n-tiles, so each B
// fragment serves two m-tiles (C = 8, one n-tile, takes them singly).
// conv1 with Cin % 8 != 0 (block 1's Cin = 3) stays a direct convolution
// on the CUDA cores (conv_stage): padding 3 channels to a k-step of 8
// would waste 2.7x on it.  Bank padding: the planes an A fragment is
// gathered from have pitches = 8 (mod 32) words (484 -> 488, 400 -> 424,
// 324 -> 328), so the four k-columns x eight rows of a fragment hit
// distinct banks (up to 2-way where the eight rows wrap an image row); the
// weights' co pitch is C + 8 for C in {16, 32} for the same reason; the
// conv3 plane keeps an odd pitch (257) for the pool pass, which reads it
// channel-fastest.  x and the weights are read as float4 (16-byte aligned).
//
// bf16 storage: specblock_bf16_tc_kernel<C>, an implicit GEMM per conv
// stage on the tensor cores (mma.sync m16n8k16 bf16, f32 accumulators),
// with the tiling above.  Activations live in shared memory as planes of
// channel pairs: word (p, pos) holds channels 2p (low half) and 2p+1 of a
// position as bf16x2, the odd channel of an odd Cin zero.  K runs tap-major
// over the channel pairs of a tap, j = tap*ceil(Cin/2) + p, padded with
// zero weights to a multiple of 4 pairs.  A k16 step covers 8 pairs:
// lane (g, t) loads A fragment a0 = pair j0+t of row g's position plus the
// tap offset, one 32-bit load (a2: pair j0+4+t; a1, a3: row g+8), and B
// fragment b0 = weight word (j0+t, n0+g).  What is left over (C = 8: 36
// pairs a stage, 4 k16 steps) takes one m16n8k8 step, so K is not padded
// to 16.  For conv2 and conv3 (Cin = C, pairs a tap a multiple of 4) each
// half step's 4 pairs share a tap and the offsets are compile-time; conv1
// (any Cin) reads them from a per-CTA table.  Block 1's Cin = 3 thus runs
// on the tensor cores too, as 2 pairs a tap (one zero channel): 20 pair
// rows (K = 40) for 27 real products, two k16 steps and one k8 step.
// Each stage's weights are packed once per call on the host as bf16x2
// words [tap][ci-pair][co] (ops/cuda_specblock._pack_bf16_pairs) and
// copied into shared memory with cp.async, row pitch wpitch(C) (the B
// loads' banks as for f32): conv1's and conv2's are in flight
// while the input stages, conv3's while conv2 computes, so one barrier
// separates two stages.  A stage's accumulators c0, c1 are channels 2t,
// 2t+1 of one position, i.e. one pair word: bias + ReLU in f32, zero
// outside the image, rounded to bf16 and stored as that word.  conv3 is
// stored as f32 planes (pitch kP3) for pool_store, so every stage is
// rounded to bf16 and the avg pool sums in f32 and divides by 4, as
// _xla_chain_convpool and the TPU kernel do.  No hi/lo split: a bf16 x
// bf16 product is exact in f32, and the truncating accumulation of the
// tensor cores (see above) errs by ~2^-23 of a partial sum, far below the
// 2^-8 rounding of every stage's bf16 result.  Pair-plane pitches are the
// f32 kernel's (488, 424, 328 = 8 mod 32 words), so a fragment's 4 pairs x
// 8 rows hit distinct banks; __launch_bounds__(256, 2) and ~100 KB of
// shared memory (block 2) fit two CTAs on an SM.
//
// The whole bf16 block, specblock_bf16_tc_kernel<C, true> (Cout 8/16/32;
// specblock_whole_bf16): the same conv x3 + pool, and in the epilogue the
// rest of models/layers.SpectrogramBlock in eval mode, so the block's one
// store is its output.  x is read in the layout it arrives in, through
// its four element strides (n, h, w, c): block 1's plane expanded to 3
// channels (channel stride 0, NCHW; 16-bit loads, coalesced along W) and
// block 2's NHWC input (16-byte loads, as above).  The skip resizes x by
// exactly 1/2 (bilinear, align_corners=False): the source of output j is
// 2j + 1/2 on both axes, so both weights are 1/2 and the resize is the
// mean of each 2x2 window, which skip_means takes from the staged tile
// (before conv2 overwrites it) in f32 in torch's order, 0.5*(0.5a + 0.5b)
// + 0.5*(0.5c + 0.5d) with a, b and c, d along W, rounded to bf16.
// pool_store_whole takes each pooled value p, rounded to bf16, through the
// block's own rounding points: eval BatchNorm, (p - mean) * 1/sqrt(var +
// 1e-5) * weight + bias in f32 -> bf16; the 1x1 skip conv, bf16-rounded
// weights and bias, f32 sum over Cin of the means plus the bias -> bf16;
// the add in f32 -> bf16; one NHWC store.  The skip rounds once, as
// conv2d with a bias does on the CPU (oneDNN adds the bias inside the
// conv); the card's stock path rounds twice there, cuDNN's bf16 sum and
// then torch's separate bf16 add of the bias, so the two may differ by
// one bf16 unit of the skip.  The BatchNorm's and the skip's operands come
// with 16-byte cp.async beside conv2's weights (every CTA copies them: 168
// requests at block 2 where 4-byte copies made 672) and are rounded where
// they are read.  Shared memory: the bf16 layout above
// plus 5C + C*Cin + 64*Cin words (the BatchNorm's mean, variance, weight
// and bias, the skip's bias and weights [co][ci], the means of the tile's
// 8x8 pooled pixels): block 2 107,424 B, still two CTAs on an SM; block 1
// 42,320 B.
//
// Widths 64, 128 and 256 (blocks 3-5): ONE 3x3 SAME conv (+ bias, ReLU)
// as an implicit GEMM on the tensor cores, launched three times a call:
// wide_bf16_conv_kernel<Pool> (bf16, specblock_wide_bf16) and
// wide_tf32_conv_kernel<Pool> (f32, 3xTF32, specblock_wide_f32).  The 16x16
// layouts above cannot hold these widths (at C = 64 the tf32 hi/lo
// weights alone are 331,776 B).  conv1 (Cin -> C) runs into t1, conv2
// into t2 (t1, t2: (B, H, W, C) NHWC scratch of the storage type in device
// memory, allocated by the wrapper), conv3 with the 2x2 pool in its
// epilogue into out.  Not fused as the narrow kernels are: a CTA that
// keeps the chain on chip needs a stage's whole weights (at C = 256 conv2's
// are 9*256*256*2 B = 1.18 MB in bf16) streamed through shared memory,
// while the intermediates through device memory are small at the wide
// blocks' planes (B=256 on 8x6 at C = 256: two 6.3 MB bf16 tensors, ~4 us
// at 3.35 TB/s, mostly L2-resident; 100x76 at C = 64: two 249 MB, ~0.3
// ms; twice that in f32).
//   GEMM: M = B*H*W output pixels in window-major order, m = ((b*H/2 + wy)
// *W/2 + wx)*4 + 2*dy + dx for pixel (b, 2wy+dy, 2wx+dx), so a 2x2 window
// is 4 consecutive rows and m/4 is the pooled pixel's NHWC index (H, W
// even; M % 4 == 0, so no window straddles a tile).  N = C in tiles of 64:
// C only sets the grid.  K = 9 taps x Cin, tap-major, in K-blocks of 64
// bytes of one tap's channels (kWK = 16 words): 32 bf16 channels (16 pair
// words, the row order of ops/cuda_specblock._pack_bf16_pairs, row j =
// tap*Cin/2 + p) or 16 f32 channels (the HWIO weights' own rows, tap*Cin
// + ci), so B reads the weights unchanged, 16 rows a K-block, and both
// types share the copy code (WideLoader) and the ring (wide_k_loop).  A
// 3-stage cp.async ring (static shared memory, no whole-stage weight
// staging): each A row (one pixel's 64 bytes of one tap) gathered
// from NHWC memory, 16 B a cp.async, a tap outside the image zero-filled
// (src-size 0: the SAME padding), as are rows past M (never stored); each
// B row copied from the weights.  Row pitches 20 (A) and 72 (B) words, so
// a fragment's 8 rows x 4 words hit 32 distinct banks.  Cin not a
// multiple of 32 (conv1 only; blocks 3-5 have 32/64/128) is zero-padded by
// the wrapper.
//   bf16 CTA: 128 pixels x 64 channels, 4 warps as 2 (M) x 2 (N) of 64 x 32
// (4 m16 x 4 n8 tiles), mma.sync m16n8k16 bf16 with f32 accumulators;
// __launch_bounds__(128, 4): 128 registers, 4 CTAs an SM, so Cout 256 on
// 8x6 at B=256 (384 CTAs) is resident in one wave.  (8 warps of 32 x 32,
// half the MMAs a warp between barriers and 2 CTAs an SM, took 1.25x as
// long on an H100 80GB HBM3 at 700 W: scripts/torch_specblock_wide.py
// --tiles.)  Epilogue: bias, ReLU in f32, rounded to bf16; launches 1-2
// store each pair word at the pixel's NHWC address.
//   tf32 CTA: 64 pixels x 64 channels, 4 warps as 2 (M) x 2 (N) of 32 x 32
// (2 m16 x 4 n8 tiles), mma.sync m16n8k8 tf32 with the 3xTF32
// arithmetic of specblock_tc_kernel: each k8 step splits its A and B
// fragments (one 32-bit shared load each) into hi and lo, lo*hi and hi*lo
// chain in their own accumulator and hi*hi starts from zero and is added
// on the CUDA cores.  Two accumulator sets on a 32 x 32 warp tile are 64
// registers; __launch_bounds__(128, 3) allows 170 (156 used, no spills).
// On an H100 80GB HBM3 at 700 W (scripts/torch_specblock_wide.py --dtype
// float32 --tiles, the three block shapes at B=256 / 100x76): 1.345 /
// 8.584 ms, against 1.541 / 9.118 for 8 warps of 32 x 32 at 2 CTAs an SM
// (128 registers, 32 B spilled), 1.365 / 7.892 for 4 warps of 64 x 32 at
// 2 (255 registers) and 1.661 / 10.555 for 8 warps at 1.  t1 and t2 stay
// f32, unrounded, as _chain_convpool in f32.
//   Launch 3's epilogue first reduces each window: its 4 rows are
// accumulator rows g..g+3 (g % 4 == 0), lanes 4 and 8 apart
// (__shfl_xor_sync; the m16n8 accumulator layout is the same for both
// types), on the stored values (bf16: max, or the f32 sum x 0.25 rounded
// to bf16, as _chain_convpool and the TPU kernel round), and stores only
// the window's channels at out[m/4].
//   Bound on an H100 (blocks 3-5 at B=256 on a 64x48 input: 9.06 + 9.06
// GFLOP, Cout 256 on 8x6: 36.2 GFLOP; 100x76 at C = 64: 358.6 GFLOP):
// operations, bf16 at 989 TFLOP/s, 3xTF32 three tf32 products per useful
// one at 495 TFLOP/s; bytes second (each intermediate written once and
// gathered once a tap, the repeats mostly from L2).
//
// Shared memory per CTA (specblock_smem_bytes), 32-bit words:
//   f32:  2 * 9*max(Cin,C)*wpitch(C) (weights hi + lo) + 3C (bias)
//         + max(Cin*488, C*328) + max(C*424, C*257)
//         block 2 (Cin=16, C=32): 188,800 B (1 CTA per SM); block 1 (Cin=3,
//         C=16): 75,968 B.
//   bf16: (max(R(Cin), R(C)) + R(C)) * wpitch(C) (conv1/conv3 and conv2
//         weight words) + 3C (bias) + R(Cin) (conv1's offset table)
//         + max(ceil(Cin/2)*488, C/2*328) + max(C/2*424, C*257), with
//         R(n) = 9*ceil(n/2) rounded up to 4 pair rows
//         block 2: 100,640 B (2 CTAs per SM); block 1: 41,040 B.
// Above 48 KB, so cudaFuncSetAttribute raises the limit per launch.
//   wide, static, for every (Cin, C): 3 stages x (M*20 + 16*72) words,
//         bf16 (M = 128 pixels) 44,544 B, tf32 (M = 64) 29,184 B.
//
// What bounds it on an H100: at the main path's B=256 block 1 moves
// ~369 MB in and ~491 MB out (~0.26 ms at 3.35 TB/s) and block 2 ~0.74 GB,
// against 3.1e11 and 3.5e11 useful flops.  3xTF32 issues three tensor-core
// products per useful one: 1.88 and 2.15 ms at 495 TFLOP/s dense TF32
// (f32 on the CUDA cores: 4.6 and 5.3 ms at 67 TFLOP/s).  Both are bound by
// operations.  Halo recompute (~1.56x on conv1, ~1.27x on conv2) and M
// padding add ~1.24x on block 2; one CTA per SM at block 2's budget leaves
// the staging loads and the __syncthreads between stages unhidden.  In
// bf16 the same useful work is 0.31 and 0.36 ms at 989 TFLOP/s; there the
// A fragments bound it first: every k16 step loads 4 words per m-tile for
// C/8 MMAs, ~2 shared-memory loads per MMA at C = 16 and 32.

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                 // conv3 output tile edge
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR0 = kTile + 6;            // staged input edge
constexpr int kR1 = kTile + 4;            // conv1 output edge
constexpr int kR2 = kTile + 2;            // conv2 output edge
constexpr int kP3 = kTile * kTile + 1;    // conv3 plane pitch (odd: no bank
                                          // conflicts in the pool pass)
// tensor-core kernel: plane pitches = 8 (mod 32) words (see the header)
constexpr int kP0 = 488;                  // staged input, 22^2 = 484
constexpr int kP1 = 424;                  // conv1 output, 20^2 = 400
constexpr int kP2 = 328;                  // conv2 output, 18^2 = 324
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

// --- tensor-core kernel's shared-memory layout (f32) ---------------------
__host__ __device__ constexpr int wpitch(int c) { return c == 8 ? 8 : c + 8; }
__host__ __device__ inline int tc_weight_words(int cin, int c) {  // hi or lo
  return 9 * imax(cin, c) * wpitch(c);
}
__host__ __device__ inline int tc_buf0_words(int cin, int c) {
  return imax(cin * kP0, c * kP2);
}
__host__ __device__ inline int tc_bufa_words(int c) {
  return imax(c * kP1, c * kP3);
}
inline size_t tc_smem_bytes(int cin, int c) {
  return sizeof(float) *
         static_cast<size_t>(2 * tc_weight_words(cin, c) + 3 * c +
                             tc_buf0_words(cin, c) + tc_bufa_words(c));
}

// --- bf16 tensor-core kernel's shared-memory layout (32-bit words) -------
// pair rows of a stage's packed weights: 9 taps x ceil(cin/2) channel
// pairs, padded to a multiple of 4 (one m16n8k8 step); the same rule as
// ops/cuda_specblock._pack_bf16_pairs
__host__ __device__ constexpr int bf16_rows(int cin) {
  return (9 * ((cin + 1) / 2) + 3) / 4 * 4;
}
__host__ __device__ inline int bf16_wa_words(int cin, int c) {  // conv1, conv3
  return imax(bf16_rows(cin), bf16_rows(c)) * wpitch(c);
}
__host__ __device__ inline int bf16_buf0_words(int cin, int c) {
  return imax((cin + 1) / 2 * kP0, c / 2 * kP2);
}
__host__ __device__ inline int bf16_bufa_words(int c) {
  return imax(c / 2 * kP1, c * kP3);
}
// the whole block's epilogue operands, after bufa (see the header)
__host__ __device__ constexpr int tail_words(int cin, int c) {
  return 5 * c + c * cin + (kTile / 2) * (kTile / 2) * cin;
}
inline size_t bf16_smem_bytes(int cin, int c, bool whole = false) {
  return sizeof(uint32_t) *
         static_cast<size_t>(bf16_wa_words(cin, c) + bf16_rows(c) * wpitch(c) +
                             3 * c + bf16_rows(cin) + bf16_buf0_words(cin, c) +
                             bf16_bufa_words(c) +
                             (whole ? tail_words(cin, c) : 0));
}

// Input tile (edge kTile) with a 3-pixel halo into channel-planar shared
// memory (plane pitch `pitch`); zero outside the image.
template <typename T>
__device__ __forceinline__ void stage_input(const T* __restrict__ x,
                                            float* __restrict__ buf,
                                            int pitch, int b, int y0, int x0,
                                            int H, int W, int cin) {
  for (int i = threadIdx.x; i < kR0 * kR0 * cin; i += blockDim.x) {
    const int c = i % cin, p = i / cin;
    const int gy = y0 - 3 + p / kR0, gx = x0 - 3 + p % kR0;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = load_f(x[((static_cast<size_t>(b) * H + gy) * W + gx) * cin + c]);
    buf[c * pitch + p] = v;
  }
}

// One conv stage on the CUDA cores: src (cin planes of rin x rin, pitch
// `spitch`) -> dst (C planes of rout x rout, pitch `dpitch`), rout =
// rin - 2; weights [tap][ci][co] unpadded; `halo` = how far the dst region
// starts above/left of the tile origin (y0, x0).
template <int C, typename T>
__device__ __forceinline__ void conv_stage(const float* __restrict__ src,
                                           int rin, int spitch, int cin,
                                           const float* __restrict__ sw,
                                           const float* __restrict__ sb,
                                           float* __restrict__ dst,
                                           int dpitch, int halo, int y0,
                                           int x0, int H, int W) {
  const int rout = rin - 2;
  for (int p = threadIdx.x; p < rout * rout; p += blockDim.x) {
    const int py = p / rout, px = p - py * rout;
    float acc[C];
#pragma unroll
    for (int co = 0; co < C; ++co) acc[co] = 0.f;
    for (int ci = 0; ci < cin; ++ci) {
      const float* s = src + ci * spitch + py * rin + px;
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
      dst[co * dpitch + p] = round_to<T>(r);
    }
  }
}

// 2x2 pool of the kTile x kTile conv3 tile (plane pitch kP3); NHWC store,
// channel fastest (coalesced), ragged edges masked.
template <int C, typename T>
__device__ __forceinline__ void pool_store(const float* __restrict__ src,
                                           T* __restrict__ out, int b,
                                           int y0, int x0, int H, int W,
                                           int pool_max) {
  const int ho = H / 2, wo = W / 2, half = kTile / 2;
  for (int i = threadIdx.x; i < half * half * C; i += blockDim.x) {
    const int co = i % C, q = i / C;
    const int qy = q / half, qx = q % half;
    const int oy = y0 / 2 + qy, ox = x0 / 2 + qx;
    if (oy >= ho || ox >= wo) continue;
    const float* s = src + co * kP3 + 2 * qy * kTile + 2 * qx;
    const float a = s[0], bb = s[1], c = s[kTile], d = s[kTile + 1];
    const float r = pool_max ? fmaxf(fmaxf(a, bb), fmaxf(c, d))
                             : (a + bb + c + d) * 0.25f;
    out[((static_cast<size_t>(b) * ho + oy) * wo + ox) * C + co] =
        store_t<T>(r);
  }
}

// --- tensor-core (3xTF32) path -------------------------------------------

// stage_input for f32 with cin % 4 == 0: float4 loads (x 16-byte aligned),
// several in flight per thread, into planes of pitch kP0.
__device__ __forceinline__ void stage_input4(const float* __restrict__ x,
                                             float* __restrict__ buf, int b,
                                             int y0, int x0, int H, int W,
                                             int cin) {
  const int c4 = cin / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < kR0 * kR0 * c4; i += blockDim.x) {
    const int c = 4 * (i % c4), p = i / c4;
    const int gy = y0 - 3 + p / kR0, gx = x0 - 3 + p % kR0;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = *reinterpret_cast<const float4*>(
          x + ((static_cast<size_t>(b) * H + gy) * W + gx) * cin + c);
    buf[c * kP0 + p] = v.x;
    buf[(c + 1) * kP0 + p] = v.y;
    buf[(c + 2) * kP0 + p] = v.z;
    buf[(c + 3) * kP0 + p] = v.w;
  }
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d += a * b, m16n8k8, tf32 inputs (32-bit registers, low 13 mantissa bits
// zero), f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b (zero accumulator in)
__device__ __forceinline__ void mma_tf32_z(float (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Stage weights [tap][ci][co] (9*cin rows of C) as hi and lo tf32 halves,
// row pitch wpitch(C); float4 along co.
template <int C>
__device__ __forceinline__ void stage_split(const float* __restrict__ w,
                                            int cin, float* __restrict__ swh,
                                            float* __restrict__ swl) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll 4
  for (int i = threadIdx.x; i < 9 * cin * C / 4; i += blockDim.x) {
    const int row = i / (C / 4), co = 4 * (i % (C / 4));
    const float4 v = w4[i];
    float4 hi, lo;
    hi.x = __uint_as_float(tf32(v.x));
    hi.y = __uint_as_float(tf32(v.y));
    hi.z = __uint_as_float(tf32(v.z));
    hi.w = __uint_as_float(tf32(v.w));
    lo.x = __uint_as_float(tf32(v.x - hi.x));
    lo.y = __uint_as_float(tf32(v.y - hi.y));
    lo.z = __uint_as_float(tf32(v.z - hi.z));
    lo.w = __uint_as_float(tf32(v.w - hi.w));
    *reinterpret_cast<float4*>(swh + row * wpitch(C) + co) = hi;
    *reinterpret_cast<float4*>(swl + row * wpitch(C) + co) = lo;
  }
}

// NM (1 or 2) m-tiles of 16 output positions from `mt`, all C/8 n-tiles:
// implicit GEMM over 9 taps x cin channels, then bias + ReLU + zero
// outside the image into dst (plane pitch DP).  Fragment maps of
// m16n8k8 (g = lane/4, t = lane%4): a0..a3 = (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); b0, b1 = (k=t, n=g), (t+4, g); c0..c3 = (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1).  The tensor cores truncate when they add into an
// accumulator, so the two small products chain in `cor` (their error is
// 2^-11 smaller) while each k-step's hi*hi starts from zero and is added
// to `acc` on the CUDA cores, rounded to nearest.
template <int C, int NM, int RIN, int SP, int DP>
__device__ __forceinline__ void mma_tiles(int mt, const float* __restrict__ src,
                                          int cin,
                                          const float* __restrict__ swh,
                                          const float* __restrict__ swl,
                                          const float* __restrict__ sb,
                                          float* __restrict__ dst, int halo,
                                          int y0, int x0, int H, int W) {
  constexpr int ROUT = RIN - 2, M = ROUT * ROUT, NT = C / 8;
  constexpr int WP = wpitch(C);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  const float* pa[NM][2];   // row g / g+8 of each m-tile, channel k0 + t
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min((mt + i) * 16 + g + 8 * h, M - 1);   // clamp pad rows
      pa[i][h] = src + t * SP + (m / ROUT) * RIN + m % ROUT;
    }
  const float* wh = swh + t * WP + g;
  const float* wl = swl + t * WP + g;
  const int tstride = cin * WP;

  float acc[NM][NT][4], cor[NM][NT][4];
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][n][j] = cor[i][n][j] = 0.f;

#pragma unroll 1
  for (int k0 = 0; k0 < cin; k0 += 8) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * RIN + tap % 3;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int o = tap * tstride + n * 8;
        bh[n][0] = __float_as_uint(wh[o]);
        bh[n][1] = __float_as_uint(wh[o + 4 * WP]);
        bl[n][0] = __float_as_uint(wl[o]);
        bl[n][1] = __float_as_uint(wl[o + 4 * WP]);
      }
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        const float a[4] = {pa[i][0][toff], pa[i][1][toff],
                            pa[i][0][toff + 4 * SP], pa[i][1][toff + 4 * SP]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ah[j] = tf32(a[j]);
          al[j] = tf32(a[j] - __uint_as_float(ah[j]));
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {   // small terms first
          mma_tf32(cor[i][n], al, bh[n][0], bh[n][1]);
          mma_tf32(cor[i][n], ah, bl[n][0], bl[n][1]);
          float p[4];
          mma_tf32_z(p, ah, bh[n][0], bh[n][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][n][j] += p[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      pa[i][0] += 8 * SP;
      pa[i][1] += 8 * SP;
    }
    wh += 8 * WP;
    wl += 8 * WP;
  }

#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (mt + i) * 16 + g + 8 * h;
      if (m >= M) continue;
      const int py = m / ROUT, px = m % ROUT;
      const int gy = y0 - halo + py, gx = x0 - halo + px;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = n * 8 + 2 * t + j;
          const float v = acc[i][n][2 * h + j] + cor[i][n][2 * h + j];
          const float r = inside ? fmaxf(v + sb[co], 0.f) : 0.f;
          dst[co * DP + m] = r;
        }
    }
}

// One conv stage on the tensor cores: src (cin planes of RIN x RIN, pitch
// SP, cin % 8 == 0) -> dst (C planes of (RIN-2)^2, pitch DP).  Warp w owns
// m-tiles [w*MT/8, (w+1)*MT/8), taken in pairs (C >= 16: a B fragment then
// serves two m-tiles; C = 8 has one n-tile and takes them singly).
template <int C, int RIN, int SP, int DP>
__device__ __forceinline__ void mma_stage(const float* __restrict__ src,
                                          int cin,
                                          const float* __restrict__ swh,
                                          const float* __restrict__ swl,
                                          const float* __restrict__ sb,
                                          float* __restrict__ dst, int halo,
                                          int y0, int x0, int H, int W) {
  constexpr int MT = ((RIN - 2) * (RIN - 2) + 15) / 16;
  const int warp = threadIdx.x / 32;
  const int end = (warp + 1) * MT / kWarps;
  int mt = warp * MT / kWarps;
  for (; C > 8 && mt + 1 < end; mt += 2)
    mma_tiles<C, 2, RIN, SP, DP>(mt, src, cin, swh, swl, sb, dst, halo, y0,
                                 x0, H, W);
  for (; mt < end; ++mt)
    mma_tiles<C, 1, RIN, SP, DP>(mt, src, cin, swh, swl, sb, dst, halo, y0,
                                 x0, H, W);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
specblock_tc_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ w2,
                    const float* __restrict__ w3,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int H, int W, int cin, int tiles_x, int pool_max) {
  extern __shared__ float4 smem4[];
  float* swh = reinterpret_cast<float*>(smem4);
  const int ww = tc_weight_words(cin, C);
  float* swl = swh + ww;
  float* sb = swh + 2 * ww;
  float* buf0 = sb + 3 * C;
  float* bufa = buf0 + tc_buf0_words(cin, C);

  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int tid = threadIdx.x;

  if (cin % 4)
    stage_input(x, buf0, kP0, b, y0, x0, H, W, cin);
  else
    stage_input4(x, buf0, b, y0, x0, H, W, cin);
  for (int i = tid; i < 3 * C; i += blockDim.x) sb[i] = bias[i];
  if (cin % 8) {            // CUDA cores; unpadded f32 weights in swh
    for (int i = tid; i < 9 * cin * C; i += blockDim.x) swh[i] = w1[i];
    __syncthreads();
    conv_stage<C, float>(buf0, kR0, kP0, cin, swh, sb, bufa, kP1, 2, y0, x0,
                         H, W);
  } else {
    stage_split<C>(w1, cin, swh, swl);
    __syncthreads();
    mma_stage<C, kR0, kP0, kP1>(buf0, cin, swh, swl, sb, bufa, 2, y0, x0, H,
                                W);
  }
  __syncthreads();
  stage_split<C>(w2, C, swh, swl);
  __syncthreads();
  mma_stage<C, kR1, kP1, kP2>(bufa, C, swh, swl, sb + C, buf0, 1, y0, x0, H,
                              W);
  __syncthreads();
  stage_split<C>(w3, C, swh, swl);
  __syncthreads();
  mma_stage<C, kR2, kP2, kP3>(buf0, C, swh, swl, sb + 2 * C, bufa, 0, y0, x0,
                              H, W);
  __syncthreads();
  pool_store<C, float>(bufa, out, b, y0, x0, H, W, pool_max);
}

// --- bf16 tensor-core path -----------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a * b, m16n8k16 (8 channel pairs), bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a * b, m16n8k8 (4 channel pairs)
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Word offset of pair row j (tap-major, CP pairs a tap) from a position's
// (0, 0) tap, over planes of pitch SP and edge RIN
template <int CP, int RIN, int SP>
__host__ __device__ constexpr int pair_off(int j) {
  return (j % CP) * SP + (j / CP / 3) * RIN + (j / CP) % 3;
}

// Element strides of the bf16 kernel's x along (sample, row, column,
// channel): NHWC contiguous for the fused conv x3 + pool, any layout for
// the whole block
struct XStrides {
  long long n, h, w, c;
};

// x tile (edge kR0, with the 3-pixel halo) into planes of channel pairs,
// pitch kP0: zero outside the image and in the pad channel of an odd cin;
// 16-byte loads (4 pairs) where a pixel's channels are contiguous 16-byte
// runs (cin % 8 == 0, channel stride 1, x and each pixel 16-byte aligned),
// else two 16-bit loads a pair at the strides' addresses.
__device__ __forceinline__ void stage_input_pairs(
    const __nv_bfloat16* __restrict__ x, const XStrides& xs,
    uint32_t* __restrict__ buf, int b, int y0, int x0, int H, int W,
    int cin) {
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) +
                             static_cast<long long>(b) * xs.n;
  if (cin % 8 == 0 && xs.c == 1 && xs.w % 8 == 0 && xs.h % 8 == 0 &&
      xs.n % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int c8 = cin / 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < kR0 * kR0 * c8; i += blockDim.x) {
      const int q = i % c8, p = i / c8;
      const int gy = y0 - 3 + p / kR0, gx = x0 - 3 + p % kR0;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = *reinterpret_cast<const uint4*>(xb + gy * xs.h + gx * xs.w +
                                            8 * q);
      uint32_t* d = buf + 4 * q * kP0 + p;
      d[0] = v.x;
      d[kP0] = v.y;
      d[2 * kP0] = v.z;
      d[3 * kP0] = v.w;
    }
    return;
  }
  const int cp = (cin + 1) / 2;
  for (int i = threadIdx.x; i < kR0 * kR0 * cp; i += blockDim.x) {
    const int pr = i % cp, p = i / cp;
    const int gy = y0 - 3 + p / kR0, gx = x0 - 3 + p % kR0;
    uint32_t v = 0u;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const unsigned short* s = xb + gy * xs.h + gx * xs.w + 2 * pr * xs.c;
      v = s[0];
      if (2 * pr + 1 < cin) v |= static_cast<uint32_t>(s[xs.c]) << 16;
    }
    buf[pr * kP0 + p] = v;
  }
}

// --- the whole block's epilogue (specblock_bf16_tc_kernel<C, true>) -------

// The block's eval BatchNorm and 1x1 skip conv as the module holds them,
// f32: BatchNorm weight, bias, running mean and running variance (C each),
// the skip's weight (C, cin) and bias (C)
struct BlockTail {
  const float* bn_w;
  const float* bn_b;
  const float* bn_mean;
  const float* bn_var;
  const float* skip_w;
  const float* skip_b;
};

// The tail's operands as the module holds them (every pointer 16-byte
// aligned), into tail_words(cin, C) words at tl with 16-byte cp.async (no
// commit: they land with the next committed group): [0, C) mean, [C, 2C)
// variance, [2C, 3C) BatchNorm weight, [3C, 4C) its bias, [4C, 5C) the
// skip's bias, then its weights [co][ci], then room for the means
// (skip_means).  Rounded and combined where pool_store_whole reads them.
template <int C>
__device__ __forceinline__ void stage_tail_async(const BlockTail& t, int cin,
                                                 float* __restrict__ tl) {
  constexpr int Q = C / 4;   // 16-byte chunks a vector
  for (int i = threadIdx.x; i < 5 * Q; i += blockDim.x) {
    const int v = i / Q;
    const float* src = v == 0 ? t.bn_mean : v == 1 ? t.bn_var
                     : v == 2 ? t.bn_w : v == 3 ? t.bn_b : t.skip_b;
    cp_async16(tl + 4 * i, src + 4 * (i % Q));
  }
  for (int i = threadIdx.x; i < Q * cin; i += blockDim.x)
    cp_async16(tl + 5 * C + 4 * i, t.skip_w + 4 * i);
}

// The skip's bilinear resize by 1/2 at each pooled pixel q of the tile
// (8x8, q = 8 qy + qx) and input channel: the mean of the staged tile's
// 2x2 window at (3 + 2qy, 3 + 2qx), in torch's f32 order, rounded to bf16,
// into means[q * cin + ci].  A window outside the image is never stored.
__device__ __forceinline__ void skip_means(const uint32_t* __restrict__ buf,
                                           int cin,
                                           float* __restrict__ means) {
  constexpr int half = kTile / 2;
  const int cp = (cin + 1) / 2;
  for (int i = threadIdx.x; i < half * half * cp; i += blockDim.x) {
    const int pr = i % cp, q = i / cp;
    const uint32_t* s =
        buf + pr * kP0 + (3 + 2 * (q / half)) * kR0 + 3 + 2 * (q % half);
    const uint32_t w[4] = {s[0], s[1], s[kR0], s[kR0 + 1]};
    for (int hi = 0; hi < 2 && 2 * pr + hi < cin; ++hi) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = __uint_as_float(hi ? w[k] & 0xffff0000u : w[k] << 16);
      const float m = 0.5f * (0.5f * v[0] + 0.5f * v[1]) +
                      0.5f * (0.5f * v[2] + 0.5f * v[3]);
      means[q * cin + 2 * pr + hi] = round_to<__nv_bfloat16>(m);
    }
  }
}

// pool_store's pool, then the block's BatchNorm, skip and add (see the
// header), one NHWC bf16 store a pooled value.  Thread t keeps output
// channel co = t % C for the tile's pooled pixels q = t / C + j * (256 /
// C), so it reads its channel's operands once and sums the skip over ci
// for all of its NQ pixels at once (the means: one broadcast a warp).
template <int C>
__device__ __forceinline__ void pool_store_whole(
    const float* __restrict__ src, const float* __restrict__ tl,
    __nv_bfloat16* __restrict__ out, int b, int y0, int x0, int H, int W,
    int cin, int pool_max) {
  constexpr int half = kTile / 2, QS = kThreads / C, NQ = half * half / QS;
  static_assert(kThreads % C == 0 && NQ * QS == half * half, "epilogue");
  const int ho = H / 2, wo = W / 2;
  const int co = threadIdx.x % C, q0 = threadIdx.x / C;
  const float* sw = tl + 5 * C + co * cin;
  const float* means = tl + 5 * C + C * cin;
  float acc[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) acc[j] = 0.f;
  if (cin % 4 == 0) {   // 16-byte reads: weights and means 16-byte aligned
    for (int ci = 0; ci < cin; ci += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(sw + ci);
      const float w[4] = {round_to<__nv_bfloat16>(w4.x),
                          round_to<__nv_bfloat16>(w4.y),
                          round_to<__nv_bfloat16>(w4.z),
                          round_to<__nv_bfloat16>(w4.w)};
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float4 m = *reinterpret_cast<const float4*>(
            means + (q0 + j * QS) * cin + ci);
        acc[j] += w[0] * m.x;
        acc[j] += w[1] * m.y;
        acc[j] += w[2] * m.z;
        acc[j] += w[3] * m.w;
      }
    }
  } else {
    for (int ci = 0; ci < cin; ++ci) {
      const float w = round_to<__nv_bfloat16>(sw[ci]);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        acc[j] += w * means[(q0 + j * QS) * cin + ci];
    }
  }
  const float mean = tl[co], inv = 1.f / sqrtf(tl[C + co] + 1e-5f);
  const float gamma = tl[2 * C + co], beta = tl[3 * C + co];
  const float sbias = round_to<__nv_bfloat16>(tl[4 * C + co]);
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int q = q0 + j * QS, qy = q / half, qx = q % half;
    const int oy = y0 / 2 + qy, ox = x0 / 2 + qx;
    if (oy >= ho || ox >= wo) continue;
    const float* s = src + co * kP3 + 2 * qy * kTile + 2 * qx;
    const float a = s[0], bb = s[1], c = s[kTile], d = s[kTile + 1];
    const float p = round_to<__nv_bfloat16>(
        pool_max ? fmaxf(fmaxf(a, bb), fmaxf(c, d))
                 : (a + bb + c + d) * 0.25f);
    const float bn = round_to<__nv_bfloat16>((p - mean) * inv * gamma + beta);
    const float skip = round_to<__nv_bfloat16>(acc[j] + sbias);
    out[((static_cast<size_t>(b) * ho + oy) * wo + ox) * C + co] =
        __float2bfloat16(bn + skip);
  }
}

// Packed weight words [rows][C] (16-byte aligned) into shared memory at row
// pitch wpitch(C), with cp.async as one committed group.
template <int C>
__device__ __forceinline__ void stage_pairs_async(
    const uint32_t* __restrict__ w, int rows, uint32_t* __restrict__ sw) {
  constexpr int Q = C / 4;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * Q; i += blockDim.x)
    cp_async16(sw + (i / Q) * wpitch(C) + 4 * (i % Q), w + 4 * i);
  cp_async_commit();
}

// NM (1 or 2) m-tiles of 16 output positions from `mt`, all C/8 n-tiles,
// over `rows` pair rows of K (a multiple of 4): k16 steps, then one k8 step
// for a remainder of 4.  CP > 0: CP pairs a tap (CP % 4 == 0), offsets at
// compile time, lane t's pair plane folded into its row pointers; CP == 0:
// offsets from the table `tbl` (one int a pair row).  Fragment maps
// (g = lane/4, t = lane%4): a0..a3 = pairs (row g, j0+t), (g+8, j0+t),
// (g, j0+4+t), (g+8, j0+4+t); b0, b1 = pairs (j0+t, n=g), (j0+4+t, g);
// c0..c3 = (g, co 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).  Out = uint32_t:
// dst is pair planes (pitch DP), one word per (position, pair 4n+t);
// Out = float: C planes of f32 holding the bf16-rounded values.
template <int C, int NM, int RIN, int SP, int DP, int CP, typename Out>
__device__ __forceinline__ void bf16_tiles(
    int mt, const uint32_t* __restrict__ src, int rows,
    const int* __restrict__ tbl, const uint32_t* __restrict__ sw,
    const float* __restrict__ sb, Out* __restrict__ dst, int halo, int y0,
    int x0, int H, int W) {
  constexpr int ROUT = RIN - 2, M = ROUT * ROUT, NT = C / 8;
  constexpr int WP = wpitch(C);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  const uint32_t* pa[NM][2];   // row g / g+8 of each m-tile
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min((mt + i) * 16 + g + 8 * h, M - 1);   // clamp pad rows
      pa[i][h] = src + (CP > 0 ? t * SP : 0) + (m / ROUT) * RIN + m % ROUT;
    }
  const uint32_t* wb = sw + t * WP + g;

  float acc[NM][NT][4];
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][n][j] = 0.f;

  // one k16 step at pair row j0; o0, o1 = this lane's offsets of pairs
  // j0+t and j0+4+t
  auto step16 = [&](int j0, int o0, int o1) {
    uint32_t b0[NT], b1[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      b0[n] = wb[j0 * WP + n * 8];
      b1[n] = wb[(j0 + 4) * WP + n * 8];
    }
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      const uint32_t a0 = pa[i][0][o0], a1 = pa[i][1][o0];
      const uint32_t a2 = pa[i][0][o1], a3 = pa[i][1][o1];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_bf16_k16(acc[i][n], a0, a1, a2, a3, b0[n], b1[n]);
    }
  };
  auto step8 = [&](int j0, int o0) {
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      const uint32_t a0 = pa[i][0][o0], a1 = pa[i][1][o0];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_bf16_k8(acc[i][n], a0, a1, wb[j0 * WP + n * 8]);
    }
  };
  if constexpr (CP > 0) {
    constexpr int R = 9 * CP;
#pragma unroll
    for (int j0 = 0; j0 + 8 <= R; j0 += 8)
      step16(j0, pair_off<CP, RIN, SP>(j0), pair_off<CP, RIN, SP>(j0 + 4));
    if constexpr (R % 8 != 0) step8(R - 4, pair_off<CP, RIN, SP>(R - 4));
  } else {
#pragma unroll 2
    for (int j0 = 0; j0 + 8 <= rows; j0 += 8)
      step16(j0, tbl[j0 + t], tbl[j0 + 4 + t]);
    if (rows % 8) step8(rows - 4, tbl[rows - 4 + t]);
  }

#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (mt + i) * 16 + g + 8 * h;
      if (m >= M) continue;
      const int py = m / ROUT, px = m % ROUT;
      const int gy = y0 - halo + py, gx = x0 - halo + px;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int co = n * 8 + 2 * t;
        const float r0 = inside ? fmaxf(acc[i][n][2 * h] + sb[co], 0.f) : 0.f;
        const float r1 =
            inside ? fmaxf(acc[i][n][2 * h + 1] + sb[co + 1], 0.f) : 0.f;
        if constexpr (std::is_same<Out, uint32_t>::value) {
          dst[(n * 4 + t) * DP + m] = pack_bf16(r0, r1);
        } else {
          dst[co * DP + m] = round_to<__nv_bfloat16>(r0);
          dst[(co + 1) * DP + m] = round_to<__nv_bfloat16>(r1);
        }
      }
    }
}

// One conv stage on the tensor cores, bf16: src pair planes (edge RIN,
// pitch SP) -> dst (pair planes of pitch DP, or f32 planes); warp w owns
// m-tiles [w*MT/8, (w+1)*MT/8), taken in pairs so a B fragment serves two.
template <int C, int RIN, int SP, int DP, int CP, typename Out>
__device__ __forceinline__ void bf16_stage(const uint32_t* __restrict__ src,
                                           int rows,
                                           const int* __restrict__ tbl,
                                           const uint32_t* __restrict__ sw,
                                           const float* __restrict__ sb,
                                           Out* __restrict__ dst, int halo,
                                           int y0, int x0, int H, int W) {
  constexpr int MT = ((RIN - 2) * (RIN - 2) + 15) / 16;
  const int warp = threadIdx.x / 32;
  const int end = (warp + 1) * MT / kWarps;
  int mt = warp * MT / kWarps;
  for (; mt + 1 < end; mt += 2)
    bf16_tiles<C, 2, RIN, SP, DP, CP>(mt, src, rows, tbl, sw, sb, dst, halo,
                                      y0, x0, H, W);
  if (mt < end)
    bf16_tiles<C, 1, RIN, SP, DP, CP>(mt, src, rows, tbl, sw, sb, dst, halo,
                                      y0, x0, H, W);
}

// Whole = false: conv x3 + pool of NHWC x (the fused block); Whole = true:
// the whole block, x in any layout (xs), tail its BatchNorm and skip
template <int C, bool Whole>
__global__ void __launch_bounds__(kThreads, 2)
specblock_bf16_tc_kernel(const __nv_bfloat16* __restrict__ x, XStrides xs,
                         const uint32_t* __restrict__ w1,
                         const uint32_t* __restrict__ w2,
                         const uint32_t* __restrict__ w3,
                         const float* __restrict__ bias, BlockTail tail,
                         __nv_bfloat16* __restrict__ out, int H, int W,
                         int cin, int tiles_x, int pool_max) {
  constexpr int CP = C / 2, RC = bf16_rows(C);   // conv2/conv3: 9*C/2 rows
  const int rows1 = bf16_rows(cin);
  extern __shared__ uint4 smem_u4[];
  uint32_t* swa = reinterpret_cast<uint32_t*>(smem_u4);   // conv1, conv3
  uint32_t* swb = swa + bf16_wa_words(cin, C);             // conv2
  float* sb = reinterpret_cast<float*>(swb + RC * wpitch(C));
  int* tbl = reinterpret_cast<int*>(sb + 3 * C);
  uint32_t* buf0 = reinterpret_cast<uint32_t*>(tbl + rows1);
  uint32_t* bufa = buf0 + bf16_buf0_words(cin, C);
  float* tl = reinterpret_cast<float*>(bufa + bf16_bufa_words(C));  // Whole

  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int tid = threadIdx.x;

  stage_pairs_async<C>(w1, rows1, swa);
  if constexpr (Whole) stage_tail_async<C>(tail, cin, tl);   // lands with w2
  stage_pairs_async<C>(w2, RC, swb);
  stage_input_pairs(x, xs, buf0, b, y0, x0, H, W, cin);
  for (int i = tid; i < 3 * C; i += blockDim.x) sb[i] = bias[i];
  const int cp = (cin + 1) / 2;
  for (int j = tid; j < rows1; j += blockDim.x) {   // pad rows: weights 0
    const int tap = j / cp;
    tbl[j] = j < 9 * cp ? (j % cp) * kP0 + (tap / 3) * kR0 + tap % 3 : 0;
  }
  cp_async_wait<1>();             // conv1's weights (conv2's may still fly)
  __syncthreads();
  // conv1 only reads the staged tile too; conv2 overwrites it
  if constexpr (Whole) skip_means(buf0, cin, tl + 5 * C + C * cin);
  bf16_stage<C, kR0, kP0, kP1, 0>(buf0, rows1, tbl, swa, sb, bufa, 2, y0, x0,
                                  H, W);
  cp_async_wait<0>();
  __syncthreads();
  stage_pairs_async<C>(w3, RC, swa);   // lands while conv2 computes
  bf16_stage<C, kR1, kP1, kP2, CP>(bufa, RC, nullptr, swb, sb + C, buf0, 1,
                                   y0, x0, H, W);
  cp_async_wait<0>();
  __syncthreads();
  float* c3 = reinterpret_cast<float*>(bufa);
  bf16_stage<C, kR2, kP2, kP3, CP>(buf0, RC, nullptr, swa, sb + 2 * C, c3, 0,
                                   y0, x0, H, W);
  __syncthreads();
  if constexpr (Whole)
    pool_store_whole<C>(c3, tl, out, b, y0, x0, H, W, cin, pool_max);
  else
    pool_store<C, __nv_bfloat16>(c3, out, b, y0, x0, H, W, pool_max);
}

// --- wide path: one implicit-GEMM conv, three launches ---------------------

// A K-block is 64 bytes of one tap's channels (32 bf16, 16 f32): kWK
// 32-bit words of an A row (a pixel) and kWK rows of B (pair words, or
// f32 weights), so both storage types share the copy code and the ring.
constexpr int kWK = 16;                  // 32-bit words a K-block
constexpr int kWStages = 3;
enum { kPoolNone = 0, kPoolMax = 1, kPoolAvg = 2 };

// CTA tile: WM x WN warps, each MI m16 tiles x 4 n8 tiles (16 MI x 32), so
// kM = 16 MI WM pixels and kN = 32 WN output channels a CTA.
template <int WM, int WN, int MI>
struct WideTile {
  static constexpr int kWarpsM = WM, kMI = MI;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kM = 16 * MI * WM;
  static constexpr int kN = 32 * WN;
  static constexpr int kAP = kWK + 4;    // A row pitch, words
  static constexpr int kBP = kN + 8;     // B row pitch, words
  static constexpr int kStageWords = kM * kAP + kWK * kBP;
  static constexpr int kSmem = kWStages * kStageWords * 4;
  static constexpr int kA = kM * 4 / kThreads;         // A chunks a thread
  static constexpr int kB = kWK * kN / 4 / kThreads;   // B chunks a thread
  static_assert(kSmem <= 48 * 1024 && kA >= 1 && kB >= 1 &&
                kThreads % 16 == 0, "wide tile");
};

// bf16: 4 warps of 64 x 32, 4 CTAs an SM (128 registers)
constexpr int kWWarpsM = 2, kWWarpsN = 2, kWMI = 4;
constexpr int kWMinBlocks = 4;           // CTAs an SM (__launch_bounds__)
using Bf16Tile = WideTile<kWWarpsM, kWWarpsN, kWMI>;
// tf32 (3xTF32): two accumulator sets, so 4 warps of 32 x 32, 3 CTAs an SM
// (170 registers)
constexpr int kTWarpsM = 2, kTWarpsN = 2, kTMI = 2;
constexpr int kTMinBlocks = 3;
using Tf32Tile = WideTile<kTWarpsM, kTWarpsN, kTMI>;

// cp.async of 16 bytes, zero-filled (nothing read) where !valid
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// NHWC pixel index of window-major GEMM row m, and its (y, x)
__device__ __forceinline__ int wide_pixel(int m, int H, int W, int& y,
                                          int& x) {
  const int win = m >> 2, w2 = W >> 1, h2 = H >> 1;
  const int wx = win % w2, r = win / w2;
  const int wy = r % h2, b = r / h2;
  y = 2 * wy + ((m >> 1) & 1);
  x = 2 * wx + (m & 1);
  return (b * H + y) * W + x;
}

// One thread's share of a stage's cp.async copies: A rows ar + h *
// kThreads/4 at 16-byte chunk aq; B rows br + h * kThreads/16 at chunk bq
// (words 4bq..4bq+3).  x: NHWC of T with cin % (64 / sizeof(T)) == 0; w:
// (9*cin*sizeof(T)/4, C) 32-bit words, K-block kb = rows kWK kb..+kWK.
template <typename T, class Tile>
struct WideLoader {
  static constexpr int kCh = 64 / sizeof(T);   // channels a K-block
  const T* x;
  const T* abase[Tile::kA];
  int ay[Tile::kA], ax[Tile::kA];
  const uint32_t* bsrc;
  int H, W, cin, C, cblocks;

  __device__ __forceinline__ WideLoader(const T* x_, const uint32_t* w,
                                        int m0, int n0, int M, int H_,
                                        int W_, int cin_, int C_)
      : x(x_), H(H_), W(W_), cin(cin_), C(C_), cblocks(cin_ / kCh) {
    const int tid = threadIdx.x, ar = tid / 4, aq = tid % 4;
#pragma unroll
    for (int h = 0; h < Tile::kA; ++h) {
      const int m = m0 + ar + h * (Tile::kThreads / 4);
      if (m < M) {
        const int p = wide_pixel(m, H, W, ay[h], ax[h]);
        abase[h] = x + static_cast<size_t>(p) * cin + aq * (kCh / 4);
      } else {            // every tap outside the image: zero rows
        ay[h] = -4;
        ax[h] = 0;
        abase[h] = x;
      }
    }
    bsrc = w + static_cast<size_t>(tid / 16) * C + n0 + 4 * (tid % 16);
  }

  // K-block kb (tap kb / cblocks, channels kCh (kb % cblocks) ..) into
  // the stage at `sa` (A rows, then B rows); SAME padding by zero-fill
  __device__ __forceinline__ void load(int kb, uint32_t* sa) const {
    uint32_t* sb = sa + Tile::kM * Tile::kAP;
    const int tid = threadIdx.x, ar = tid / 4, aq = tid % 4;
    const int tap = kb / cblocks, cb = kb - tap * cblocks;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int h = 0; h < Tile::kA; ++h) {
      const int yy = ay[h] + dy, xx = ax[h] + dx;
      const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
      const T* src =
          ok ? abase[h] + (static_cast<ptrdiff_t>(dy) * W + dx) * cin +
                   kCh * cb
             : x;
      cp_async16_zfill(sa + (ar + h * (Tile::kThreads / 4)) * Tile::kAP +
                           4 * aq,
                       src, ok);
    }
#pragma unroll
    for (int h = 0; h < Tile::kB; ++h)
      cp_async16(sb + (tid / 16 + h * (Tile::kThreads / 16)) * Tile::kBP +
                     4 * (tid % 16),
                 bsrc + (static_cast<size_t>(kb) * kWK +
                         h * (Tile::kThreads / 16)) * C);
  }
};

// The K loop of both wide kernels: the 3-stage ring over 9*cblocks
// K-blocks, `step(sa, sb)` on each landed stage (A rows of kAP words at
// sa, B rows of kBP words at sb).
template <class Tile, typename L, typename Step>
__device__ __forceinline__ void wide_k_loop(const L& ld, uint32_t* smem,
                                            Step step) {
  const int kblocks = 9 * ld.cblocks;
#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < kblocks) ld.load(s, smem + s * Tile::kStageWords);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kb = 0; kb < kblocks; ++kb) {
    cp_async_wait<kWStages - 2>();   // K-block kb has landed
    __syncthreads();                 // and every warp is done with kb - 1
    const int nx = kb + kWStages - 1;
    if (nx < kblocks)
      ld.load(nx, smem + (nx % kWStages) * Tile::kStageWords);
    cp_async_commit();
    const uint32_t* sa = smem + (kb % kWStages) * Tile::kStageWords;
    step(sa, sa + Tile::kM * Tile::kAP);
  }
  cp_async_wait<0>();
}

// The epilogue's 2x2 pool of rows g..g+3 (g % 4 == 0: lanes 4 and 8
// apart) on this lane's two channels; the result is valid in lanes with
// g % 4 == 0
template <int Pool>
__device__ __forceinline__ void wide_pool(float& r0, float& r1) {
  if constexpr (Pool == kPoolMax) {
    r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 4));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 4));
    r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 8));
    r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 8));
  } else if constexpr (Pool == kPoolAvg) {
    r0 += __shfl_xor_sync(0xffffffffu, r0, 4);
    r1 += __shfl_xor_sync(0xffffffffu, r1, 4);
    r0 = (r0 + __shfl_xor_sync(0xffffffffu, r0, 8)) * 0.25f;
    r1 = (r1 + __shfl_xor_sync(0xffffffffu, r1, 8)) * 0.25f;
  }
}

// Output element index of channel 0 of GEMM row m (Pool: of its window)
template <int Pool>
__device__ __forceinline__ size_t wide_row(int m, int M, int H, int W,
                                           int C) {
  if constexpr (Pool == kPoolNone) {
    int y, xx;
    return m < M ? static_cast<size_t>(wide_pixel(m, H, W, y, xx)) * C : 0;
  } else {
    return static_cast<size_t>(m >> 2) * C;
  }
}

// out = conv3x3_SAME(x, w) + bias, ReLU, bf16; Pool != kPoolNone: then the
// 2x2 pool, out (B, H/2, W/2, C).  x (B, H, W, cin) NHWC, cin % 32 == 0;
// w the packed pair words (9*cin/2, C); M = B*H*W; grid ceil(M/kM) * C/kN.
template <int Pool>
__global__ void __launch_bounds__(Bf16Tile::kThreads, kWMinBlocks)
wide_bf16_conv_kernel(const __nv_bfloat16* __restrict__ x,
                      const uint32_t* __restrict__ w,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int M, int H, int W,
                      int cin, int C) {
  using Tl = Bf16Tile;
  constexpr int MI = Tl::kMI;
  __shared__ __align__(16) uint32_t smem[kWStages * Tl::kStageWords];
  const int ntiles = C / Tl::kN;
  const int m0 = (blockIdx.x / ntiles) * Tl::kM;
  const int n0 = (blockIdx.x % ntiles) * Tl::kN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  const WideLoader<__nv_bfloat16, Tl> ld(x, w, m0, n0, M, H, W, cin, C);

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][n][j] = 0.f;

  wide_k_loop<Tl>(ld, smem, [&](const uint32_t* sa, const uint32_t* sb) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {   // two k16 steps of 8 pair words
      uint32_t b[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t* pb = sb + (ks * 8 + t) * Tl::kBP + wn * 32 + n * 8 + g;
        b[n][0] = pb[0];
        b[n][1] = pb[4 * Tl::kBP];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const uint32_t* pa =
            sa + (wm * 16 * MI + i * 16 + g) * Tl::kAP + ks * 8 + t;
        const uint32_t a0 = pa[0], a1 = pa[8 * Tl::kAP];
        const uint32_t a2 = pa[4], a3 = pa[8 * Tl::kAP + 4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16_k16(acc[i][n], a0, a1, a2, a3, b[n][0], b[n][1]);
      }
    }
  });

  uint32_t* ow = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 16 * MI + i * 16 + g + 8 * h;
      const size_t row = wide_row<Pool>(m, M, H, W, C) / 2;   // words
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int co = n0 + wn * 32 + n * 8 + 2 * t;
        float r0 = round_to<__nv_bfloat16>(
            fmaxf(acc[i][n][2 * h] + bias[co], 0.f));
        float r1 = round_to<__nv_bfloat16>(
            fmaxf(acc[i][n][2 * h + 1] + bias[co + 1], 0.f));
        wide_pool<Pool>(r0, r1);
        if (m < M && (Pool == kPoolNone || g % 4 == 0))
          ow[row + co / 2] = pack_bf16(r0, r1);
      }
    }
}

// out = conv3x3_SAME(x, w) + bias, ReLU, f32, as 3xTF32; Pool as above.
// x (B, H, W, cin) f32 NHWC, cin % 16 == 0; w (9*cin, C) f32, row tap*cin
// + ci (HWIO); M = B*H*W; grid ceil(M/kM) * C/kN.  Each k8 step splits
// its A and B fragments into tf32 hi = tf32(v), lo = tf32(v - hi); lo*hi
// and hi*lo chain in `cor`, and hi*hi starts from zero each step and is
// added into `acc` on the CUDA cores (the tensor cores truncate when they
// accumulate; see the header).
template <int Pool>
__global__ void __launch_bounds__(Tf32Tile::kThreads, kTMinBlocks)
wide_tf32_conv_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ out, int M, int H, int W, int cin,
                      int C) {
  using Tl = Tf32Tile;
  constexpr int MI = Tl::kMI;
  __shared__ __align__(16) uint32_t smem[kWStages * Tl::kStageWords];
  const int ntiles = C / Tl::kN;
  const int m0 = (blockIdx.x / ntiles) * Tl::kM;
  const int n0 = (blockIdx.x % ntiles) * Tl::kN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % Tl::kWarpsM, wn = warp / Tl::kWarpsM;
  const WideLoader<float, Tl> ld(x, reinterpret_cast<const uint32_t*>(w), m0,
                                 n0, M, H, W, cin, C);

  float acc[MI][4][4], cor[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][n][j] = cor[i][n][j] = 0.f;

  wide_k_loop<Tl>(ld, smem, [&](const uint32_t* sa, const uint32_t* sb) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {   // two k8 steps of 8 channels
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint32_t* pb = sb + (ks * 8 + t) * Tl::kBP + wn * 32 + n * 8 + g;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = __uint_as_float(pb[4 * j * Tl::kBP]);
          bh[n][j] = tf32(v);
          bl[n][j] = tf32(v - __uint_as_float(bh[n][j]));
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const uint32_t* pa =
            sa + (wm * 16 * MI + i * 16 + g) * Tl::kAP + ks * 8 + t;
        const uint32_t a[4] = {pa[0], pa[8 * Tl::kAP], pa[4],
                               pa[8 * Tl::kAP + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ah[j] = tf32(__uint_as_float(a[j]));
          al[j] = tf32(__uint_as_float(a[j]) - __uint_as_float(ah[j]));
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {   // small terms first
          mma_tf32(cor[i][n], al, bh[n][0], bh[n][1]);
          mma_tf32(cor[i][n], ah, bl[n][0], bl[n][1]);
          float p[4];
          mma_tf32_z(p, ah, bh[n][0], bh[n][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][n][j] += p[j];
        }
      }
    }
  });

#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 16 * MI + i * 16 + g + 8 * h;
      const size_t row = wide_row<Pool>(m, M, H, W, C);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int co = n0 + wn * 32 + n * 8 + 2 * t;
        float r0 = fmaxf(acc[i][n][2 * h] + cor[i][n][2 * h] + bias[co], 0.f);
        float r1 = fmaxf(acc[i][n][2 * h + 1] + cor[i][n][2 * h + 1] +
                             bias[co + 1],
                         0.f);
        wide_pool<Pool>(r0, r1);
        if (m < M && (Pool == kPoolNone || g % 4 == 0))
          *reinterpret_cast<float2*>(out + row + co) = make_float2(r0, r1);
      }
    }
}

template <typename T, typename Wt>
using WideKernel = void (*)(const T*, const Wt*, const float*, T*, int, int,
                            int, int, int);

// The three launches of one wide call on `st`, x -> t1 -> t2 -> out:
// kern[0] (no pool) twice, then kern[1] (max pool) or kern[2] (avg).
// Returns the first launch's cudaGetLastError() that is not cudaSuccess.
template <class Tile, typename T, typename Wt>
int wide_call(const WideKernel<T, Wt> (&kern)[3], const void* x,
              const void* w1, const void* w2, const void* w3,
              const float* bias, void* t1, void* t2, void* out, int M, int H,
              int W, int cin, int C, int pool_max, cudaStream_t st) {
  const int grid = (M + Tile::kM - 1) / Tile::kM * (C / Tile::kN);
  const void* src[3] = {x, t1, t2};
  const void* ws[3] = {w1, w2, w3};
  void* dst[3] = {t1, t2, out};
  for (int s = 0; s < 3; ++s) {
    const WideKernel<T, Wt> k = kern[s < 2 ? 0 : (pool_max ? 1 : 2)];
    k<<<grid, Tile::kThreads, 0, st>>>(
        static_cast<const T*>(src[s]), static_cast<const Wt*>(ws[s]),
        bias + s * C, static_cast<T*>(dst[s]), M, H, W, s ? C : cin, C);
    const int e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// One CTA per (sample, 16x16 tile): the tile in blockIdx.x, the sample in
// blockIdx.y.  gridDim.y holds at most 65,535 samples, so a larger batch
// launches in slices of that many: go(grid, b0, tiles_x) launches the
// slice from sample b0, x and out offset to it (the kernel unchanged).
template <typename Kern, typename Go>
int launch_tiles(Kern kern, size_t smem, int B, int H, int W, Go go) {
  constexpr int kMaxGridY = 65535;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles_y = (H + kTile - 1) / kTile;
  const int tiles_x = (W + kTile - 1) / kTile;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const dim3 grid(tiles_y * tiles_x, B - b0 < kMaxGridY ? B - b0 : kMaxGridY);
    go(grid, b0, tiles_x);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// specblock_bf16_tc_kernel<C, Whole> over B samples of x (strides xs)
template <int C, bool Whole>
int launch_bf16(const void* x, const XStrides& xs, const void* w1,
                const void* w2, const void* w3, const float* bias,
                const BlockTail& tail, void* out, int B, int H, int W,
                int cin, int pool_max, cudaStream_t st) {
  const size_t smem = bf16_smem_bytes(cin, C, Whole);
  const size_t o_step = static_cast<size_t>(H / 2) * (W / 2) * C;
  return launch_tiles(
      specblock_bf16_tc_kernel<C, Whole>, smem, B, H, W,
      [&](dim3 grid, int b0, int tiles_x) {
        specblock_bf16_tc_kernel<C, Whole><<<grid, kThreads, smem, st>>>(
            static_cast<const __nv_bfloat16*>(x) + b0 * xs.n, xs,
            static_cast<const uint32_t*>(w1), static_cast<const uint32_t*>(w2),
            static_cast<const uint32_t*>(w3), bias, tail,
            static_cast<__nv_bfloat16*>(out) + b0 * o_step, H, W, cin,
            tiles_x, pool_max);
      });
}

// C <= 32: the tensor-core kernels, f32 (3xTF32) or bf16, on NHWC x
template <int C>
int dispatch(const void* x, const void* w1, const void* w2, const void* w3,
             const float* bias, void* out, int B, int H, int W, int cin,
             int pool_max, int bf16, cudaStream_t st) {
  if (!aligned16({x, w1, w2, w3}))   // 16-byte loads, cp.async
    return cudaErrorInvalidValue;
  if (bf16) {
    const XStrides nhwc{static_cast<long long>(H) * W * cin,
                        static_cast<long long>(W) * cin, cin, 1};
    return launch_bf16<C, false>(x, nhwc, w1, w2, w3, bias, BlockTail{}, out,
                                 B, H, W, cin, pool_max, st);
  }
  const size_t smem = tc_smem_bytes(cin, C);
  const size_t x_step = static_cast<size_t>(H) * W * cin;
  const size_t o_step = static_cast<size_t>(H / 2) * (W / 2) * C;
  return launch_tiles(
      specblock_tc_kernel<C>, smem, B, H, W,
      [&](dim3 grid, int b0, int tiles_x) {
        specblock_tc_kernel<C><<<grid, kThreads, smem, st>>>(
            static_cast<const float*>(x) + b0 * x_step,
            static_cast<const float*>(w1), static_cast<const float*>(w2),
            static_cast<const float*>(w3), bias,
            static_cast<float*>(out) + b0 * o_step, H, W, cin, tiles_x,
            pool_max);
      });
}

}  // namespace

extern "C" {

// Shared-memory bytes one CTA needs for (cin, cout) and the storage type
// (cout >= 64: the wide convs, static, each of three launches; bf16 != 0:
// wide_bf16_conv_kernel, else wide_tf32_conv_kernel.  cout <= 32: the
// tensor-core kernel of the type, dynamic; bf16 != 0:
// specblock_bf16_tc_kernel, else specblock_tc_kernel).
long long specblock_smem_bytes(int cin, int cout, int bf16) {
  if (cout >= 64) return bf16 ? Bf16Tile::kSmem : Tf32Tile::kSmem;
  return static_cast<long long>(bf16 ? bf16_smem_bytes(cin, cout)
                                     : tc_smem_bytes(cin, cout));
}

// Shapes and pointers a wide call takes: H, W even; cout in {64, 128,
// 256}; cin a positive multiple of `cin_unit`; B*H*W < 2^31 - 128; x, t1,
// t2 and the weights 16-byte aligned, out 8-byte.
static bool wide_args_ok(const void* x, const void* w1, const void* w2,
                         const void* w3, const void* t1, const void* t2,
                         const void* out, int B, int H, int W, int cin,
                         int cout, int cin_unit) {
  const long long M = static_cast<long long>(B) * H * W;
  return B >= 1 && H >= 2 && W >= 2 && H % 2 == 0 && W % 2 == 0 &&
         cin >= cin_unit && cin % cin_unit == 0 &&
         (cout == 64 || cout == 128 || cout == 256) &&
         M <= (1LL << 31) - 129 && aligned16({x, w1, w2, w3, t1, t2}) &&
         reinterpret_cast<uintptr_t>(out) % 8 == 0;
}

// The bf16 block at cout in {64, 128, 256}: three launches of
// wide_bf16_conv_kernel on `stream`, x -> t1 -> t2 -> out.  x: (B, H, W,
// cin) bf16 NHWC with cin % 32 == 0 (the wrapper zero-pads); w1, w2, w3:
// the int32 words (9*cin/2 or 9*cout/2, cout) of
// ops/cuda_specblock._pack_bf16_pairs; bias: (3, cout) f32; t1, t2: (B, H,
// W, cout) bf16 scratch; out: (B, H/2, W/2, cout) bf16 (wide_args_ok).
// Returns the first launch's cudaGetLastError() that is not cudaSuccess
// (or cudaErrorInvalidValue for shapes it does not take).
int specblock_wide_bf16(const void* x, const void* w1, const void* w2,
                        const void* w3, const float* bias, void* t1,
                        void* t2, void* out, int B, int H, int W, int cin,
                        int cout, int pool_max, void* stream) {
  if (!wide_args_ok(x, w1, w2, w3, t1, t2, out, B, H, W, cin, cout, 32))
    return cudaErrorInvalidValue;
  static const WideKernel<__nv_bfloat16, uint32_t> kern[3] = {
      wide_bf16_conv_kernel<kPoolNone>, wide_bf16_conv_kernel<kPoolMax>,
      wide_bf16_conv_kernel<kPoolAvg>};
  return wide_call<Bf16Tile>(kern, x, w1, w2, w3, bias, t1, t2, out,
                             B * H * W, H, W, cin, cout, pool_max,
                             static_cast<cudaStream_t>(stream));
}

// The float32 block at cout in {64, 128, 256}: three launches of
// wide_tf32_conv_kernel, as specblock_wide_bf16 but f32 throughout: x
// (B, H, W, cin) with cin % 16 == 0; w1, w2, w3: HWIO (3, 3, cin or cout,
// cout) f32; t1, t2: (B, H, W, cout) f32; out (B, H/2, W/2, cout) f32.
int specblock_wide_f32(const void* x, const void* w1, const void* w2,
                       const void* w3, const float* bias, void* t1, void* t2,
                       void* out, int B, int H, int W, int cin, int cout,
                       int pool_max, void* stream) {
  if (!wide_args_ok(x, w1, w2, w3, t1, t2, out, B, H, W, cin, cout, 16))
    return cudaErrorInvalidValue;
  static const WideKernel<float, float> kern[3] = {
      wide_tf32_conv_kernel<kPoolNone>, wide_tf32_conv_kernel<kPoolMax>,
      wide_tf32_conv_kernel<kPoolAvg>};
  return wide_call<Tf32Tile>(kern, x, w1, w2, w3, bias, t1, t2, out,
                             B * H * W, H, W, cin, cout, pool_max,
                             static_cast<cudaStream_t>(stream));
}

// x: (B, H, W, cin) NHWC of the storage type (bf16 != 0: __nv_bfloat16,
// else float); w1: (3, 3, cin, cout), w2, w3: (3, 3, cout, cout) HWIO f32
// (already rounded to the storage type), except for bf16: each the int32
// words (bf16_rows(cin or cout), cout) of
// ops/cuda_specblock._pack_bf16_pairs; bias: (3, cout) f32; out:
// (B, H/2, W/2, cout) NHWC of the storage type.  x and the weights 16-byte
// aligned; H, W even; cout in {8, 16, 32} (wider: specblock_wide_bf16,
// specblock_wide_f32); any B >= 1 (above 65,535 in slices).  Returns the
// first launch's cudaGetLastError() that is not cudaSuccess (or
// cudaErrorInvalidValue for shapes it does not take).
int specblock_convpool(const void* x, const void* w1, const void* w2,
                       const void* w3, const float* bias, void* out, int B,
                       int H, int W, int cin, int cout, int pool_max,
                       int bf16, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || cin < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 8:
      return dispatch<8>(x, w1, w2, w3, bias, out, B, H, W, cin, pool_max,
                         bf16, st);
    case 16:
      return dispatch<16>(x, w1, w2, w3, bias, out, B, H, W, cin, pool_max,
                          bf16, st);
    case 32:
      return dispatch<32>(x, w1, w2, w3, bias, out, B, H, W, cin, pool_max,
                          bf16, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The whole bf16 block (models/layers.SpectrogramBlock in eval mode) at
// cout in {8, 16, 32}: one launch of specblock_bf16_tc_kernel<cout, true>.
// x: bf16, B samples of cin channels on an H x W plane at element strides
// sn, sh, sw, sc (sample, row, column, channel; any layout, 2-byte
// aligned); w1, w2, w3, bias: as specblock_convpool's bf16 call; bn_w,
// bn_b, bn_mean, bn_var: the BatchNorm's f32 (cout); skip_w: the 1x1
// conv's f32 weight (cout, cin), skip_b its bias (cout); every pointer but
// x and out 16-byte aligned;
// out: (B, H/2, W/2, cout) NHWC bf16.  H, W even.  Returns the first
// launch's cudaGetLastError() that is not cudaSuccess (or
// cudaErrorInvalidValue for shapes it does not take).
int specblock_whole_bf16(const void* x, long long sn, long long sh,
                         long long sw, long long sc, const void* w1,
                         const void* w2, const void* w3, const float* bias,
                         const float* bn_w, const float* bn_b,
                         const float* bn_mean, const float* bn_var,
                         const float* skip_w, const float* skip_b, void* out,
                         int B, int H, int W, int cin, int cout, int pool_max,
                         void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || cin < 1 || sn < 0 ||
      sh < 0 || sw < 0 || sc < 0 || reinterpret_cast<uintptr_t>(x) % 2 ||
      !aligned16({w1, w2, w3, bn_w, bn_b, bn_mean, bn_var, skip_w, skip_b}))
    return cudaErrorInvalidValue;
  const XStrides xs{sn, sh, sw, sc};
  const BlockTail tail{bn_w, bn_b, bn_mean, bn_var, skip_w, skip_b};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cout) {
    case 8:
      return launch_bf16<8, true>(x, xs, w1, w2, w3, bias, tail, out, B, H, W,
                                  cin, pool_max, st);
    case 16:
      return launch_bf16<16, true>(x, xs, w1, w2, w3, bias, tail, out, B, H,
                                   W, cin, pool_max, st);
    case 32:
      return launch_bf16<32, true>(x, xs, w1, w2, w3, bias, tail, out, B, H,
                                   W, cin, pool_max, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
