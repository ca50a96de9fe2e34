// Multi-level orthonormal 2-D Haar DWT and its inverse, float32, NCHW.
//
// Replaces the Pallas TPU kernel `_dwt_kernel` (kdip_tpu/ops/pallas_dwt.py:49,
// driven by `_run` and exposed as dwt2_pallas / idwt2_pallas). Same function:
// level `lv` maps the top-left (H>>lv, W>>lv) block of each (b, c) plane to
// its [[ll, lh], [hl, hh]] quadrants, lo = (e + o)/sqrt2 and hi = (e - o)/sqrt2,
// rows first, then columns (pywt's coeffs_to_array layout; the plain version
// is kdip_tpu_torch/ops/dwt.py: dwt2_plain / idwt2_plain).
//
// Design. The TPU kernel keeps a whole plane in VMEM and runs each level as
// two packing-matrix products on the MXU. Here that plane (256 KiB at
// 256x256) would not fit a block's shared memory, and matrix products would
// waste the card's time on a transform that needs a few adds per value.
// L Haar levels only mix pixels inside an aligned 2^L x 2^L input tile, so
// each thread owns one tile of one plane: it loads the tile's 4^L values
// into registers, runs every level's butterflies there (one template
// instance per level, so every index is a compile-time constant), and
// writes each coefficient once to its packed position. The inverse gathers
// from those positions and writes the tile. Nothing is shared between
// threads, so the kernel needs no shared memory and no synchronisation.
//
// Bound on an H100 SXM: memory. Each value is read once and written once
// (2 x 786,432 B at [1,3,256,256] f32, ~0.47 us at 3.35 TB/s) against ~5
// flops per value; at that size the launch latency dominates. No single
// PyTorch call computes a packed multi-level Haar DWT.
//
// Rounding. Each butterfly output is (e +/- o) * float32(1/sqrt2), with
// round-to-nearest intrinsics that the compiler cannot contract into an
// FMA: the plain version computes the same products elementwise, so the
// two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvSqrt2 = 0.707106769084930419921875f;  // float32(1/sqrt2)

__device__ __forceinline__ float hsum(float a, float b) {
  return __fmul_rn(__fadd_rn(a, b), kInvSqrt2);
}
__device__ __forceinline__ float hdif(float a, float b) {
  return __fmul_rn(__fsub_rn(a, b), kInvSqrt2);
}

// Level LV of an L-level forward transform on one thread's tile v, whose
// top-left (S>>LV)^2 entries hold the level-LV approximation. Writes the
// level's three detail quadrants and leaves its approximation in the
// top-left quarter of that block.
template <int L, int LV>
__device__ __forceinline__ void fwd_levels(float (&v)[1 << L][1 << L],
                                           float* yp, int ti, int tj, int H,
                                           int W) {
  if constexpr (LV < L) {
    constexpr int h2 = (1 << (L - LV)) / 2;  // this tile's quadrant size
    const int hq = (H >> LV) / 2, wq = (W >> LV) / 2;  // the block's
#pragma unroll
    for (int i = 0; i < h2; ++i)
#pragma unroll
      for (int j = 0; j < h2; ++j) {
        const float a = v[2 * i][2 * j], b = v[2 * i + 1][2 * j];
        const float c = v[2 * i][2 * j + 1], d = v[2 * i + 1][2 * j + 1];
        const float lo0 = hsum(a, b), hi0 = hdif(a, b);  // rows
        const float lo1 = hsum(c, d), hi1 = hdif(c, d);
        const int r = ti * h2 + i, col = tj * h2 + j;
        yp[(int64_t)r * W + wq + col] = hdif(lo0, lo1);               // lh
        yp[(int64_t)(hq + r) * W + col] = hsum(hi0, hi1);             // hl
        yp[(int64_t)(hq + r) * W + wq + col] = hdif(hi0, hi1);        // hh
        // (i, j) <= (2i, 2j): no later butterfly of this level reads it
        v[i][j] = hsum(lo0, lo1);                                     // ll
      }
    fwd_levels<L, LV + 1>(v, yp, ti, tj, H, W);
  }
}

// Level LV of the inverse, after levels L-1 .. LV+1: expands the top-left
// (S>>(LV+1))^2 approximation entries of v with the level's details.
template <int L, int LV>
__device__ __forceinline__ void inv_levels(float (&v)[1 << L][1 << L],
                                           const float* xp, int ti, int tj,
                                           int H, int W) {
  if constexpr (LV >= 0) {
    constexpr int h2 = (1 << (L - LV)) / 2;
    const int hq = (H >> LV) / 2, wq = (W >> LV) / 2;
    // reverse order, so that v[i][j] is read before the butterflies of
    // smaller (i, j) overwrite it
#pragma unroll
    for (int i = h2 - 1; i >= 0; --i)
#pragma unroll
      for (int j = h2 - 1; j >= 0; --j) {
        const int r = ti * h2 + i, col = tj * h2 + j;
        const float ll = v[i][j];
        const float lh = xp[(int64_t)r * W + wq + col];
        const float hl = xp[(int64_t)(hq + r) * W + col];
        const float hh = xp[(int64_t)(hq + r) * W + wq + col];
        const float lo_e = hsum(ll, lh), lo_o = hdif(ll, lh);  // columns
        const float hi_e = hsum(hl, hh), hi_o = hdif(hl, hh);
        v[2 * i][2 * j] = hsum(lo_e, hi_e);                    // rows
        v[2 * i + 1][2 * j] = hdif(lo_e, hi_e);
        v[2 * i][2 * j + 1] = hsum(lo_o, hi_o);
        v[2 * i + 1][2 * j + 1] = hdif(lo_o, hi_o);
      }
    inv_levels<L, LV - 1>(v, xp, ti, tj, H, W);
  }
}

template <int L>
__global__ void haar_dwt2_fwd(const float* __restrict__ x, float* __restrict__ y,
                              int64_t n_tiles, int H, int W) {
  constexpr int S = 1 << L;
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= n_tiles) return;
  const int tw = W >> L, th = H >> L;
  const int tj = (int)(idx % tw);
  const int ti = (int)((idx / tw) % th);
  const int64_t plane = idx / ((int64_t)tw * th);
  const float* xp = x + plane * H * W;
  float* yp = y + plane * H * W;

  float v[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j)
      v[i][j] = xp[(int64_t)(ti * S + i) * W + tj * S + j];
  fwd_levels<L, 0>(v, yp, ti, tj, H, W);
  yp[(int64_t)ti * W + tj] = v[0][0];
}

template <int L>
__global__ void haar_dwt2_inv(const float* __restrict__ x, float* __restrict__ y,
                              int64_t n_tiles, int H, int W) {
  constexpr int S = 1 << L;
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= n_tiles) return;
  const int tw = W >> L, th = H >> L;
  const int tj = (int)(idx % tw);
  const int ti = (int)((idx / tw) % th);
  const int64_t plane = idx / ((int64_t)tw * th);
  const float* xp = x + plane * H * W;
  float* yp = y + plane * H * W;

  float v[S][S];
  v[0][0] = xp[(int64_t)ti * W + tj];
  inv_levels<L, L - 1>(v, xp, ti, tj, H, W);
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j)
      yp[(int64_t)(ti * S + i) * W + tj * S + j] = v[i][j];
}

template <int L>
cudaError_t launch(const float* x, float* y, int64_t planes, int H, int W,
                   int inverse, cudaStream_t stream) {
  const int64_t n_tiles = planes * (int64_t)(H >> L) * (W >> L);
  // small blocks: at the slice's shape (3,072 tiles at L=3) more of the
  // 132 SMs get work
  const int threads = 64;
  const int64_t blocks = (n_tiles + threads - 1) / threads;
  if (inverse)
    haar_dwt2_inv<L><<<(unsigned)blocks, threads, 0, stream>>>(x, y, n_tiles, H, W);
  else
    haar_dwt2_fwd<L><<<(unsigned)blocks, threads, 0, stream>>>(x, y, n_tiles, H, W);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. x and y are distinct contiguous float32
// [planes, H, W] buffers on the current device; H and W divisible by
// 2^level; level in 1..3. Launches on `stream` and returns the launch's
// cudaGetLastError() (0 on success) without synchronising.
extern "C" int haar_dwt2_f32(const float* x, float* y, int64_t planes, int H,
                             int W, int level, int inverse, void* stream) {
  if (level < 1 || level > 3 || planes <= 0 || H <= 0 || W <= 0 ||
      H % (1 << level) || W % (1 << level) || x == y)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (level) {
    case 1: return (int)launch<1>(x, y, planes, H, W, inverse, s);
    case 2: return (int)launch<2>(x, y, planes, H, W, inverse, s);
    default: return (int)launch<3>(x, y, planes, H, W, inverse, s);
  }
}
