// Winograd F(2x2, 3x3) convolution, stride 1, same padding, NCHW, bf16/fp16
// with float32 accumulation; optionally fused with a silu(x*a + b) prologue.
//
// Replaces the Pallas TPU kernel `_wino_kernel`
// (kdip_tpu/ops/experimental/winograd_pallas.py:60, called at :229 by
// `_wino_pallas_single`), in both of its forms: plain (`_wino_op`, whose
// VJP's dx is the same kernel on the rotated weight) and `prologue=True`
// (`_wino_fused_op`). One template, two entry points: winograd_f23_conv and
// winograd_f23_conv_fused. The plain version, which holds every rounding
// named below, is kdip_tpu_torch/ops/winograd.py: winograd_conv3x3_plain.
//
// Per 2x2 output tile, Y = A^T [ V_p . (B^T d B)_p ] A over the 16 positions
// p of the 4x4 input patch d, where V = G g G^T [16, C, F] comes from
// kernel_transform (a plain torch op, as in kdip_tpu).
//
// Design. The TPU kernel splits x into four parity planes outside the kernel
// (Mosaic lowers strided VMEM gathers poorly) and cuts C and F into chunks
// of at most 128 (VMEM, and the 128x128 matrix unit). Neither applies here.
// One block of 256 threads (8 warps) owns one sample, a block of 8x8 output
// tiles (16x16 pixels) and 32 output channels, and loops over the input
// channels in chunks of 16, the depth of one tensor-core product:
//   1. it loads the chunk's 18x18 halo patch from NCHW (consecutive threads
//      on consecutive W) into shared memory, zero outside the image; with
//      the prologue it applies silu(round(x*a + b)) on the way, and the
//      conv's zero padding stays zero;
//   2. it loads V's chunk [16][16][32], zero beyond C and F;
//   3. each thread forms B^T d B for (tile, channel) pairs: float32 adds of
//      the bf16 values, rounded to bf16 after the row stage and again after
//      the column stage, exactly as the Pallas kernel rounds (:138-151);
//   4. each warp runs the 16 products of its 16 tiles x 16 channels with
//      nvcuda::wmma (bf16 16x16x16, float32 accumulators). Its 16
//      accumulator fragments stay in registers across all of C (16 x 8
//      floats per thread).
// After the last chunk, A^T M A runs elementwise on the fragments: all
// accumulator fragments of one shape share their element mapping, so
// element e of the 16 fragments belongs to one (tile, channel). The four
// outputs (float32 adds in the Pallas kernel's order) go through shared
// memory and are written to NCHW rounded once to bf16. The whole of C
// accumulates in float32, where kdip_tpu sums 128-channel chunks in bf16.
// Any C and F are taken (partial chunks are zero-filled); H and W must be
// even. The caller checks dtype, shapes and contiguity.
//
// Bound on an H100 SXM (700 W). The 16 products are 2*16*(H/2)*(W/2)*C*F
// flops; the bytes are x + y + V. At the hottest shape of FFHQ-256
// (256x256, 128 -> 128, B=1) that is 8.6 GFLOP (8.7 us at 989 TFLOP/s
// dense bf16) against 34 MB (10 us at 3.35 TB/s): balanced, so a fast
// kernel must keep the transformed tiles (4x the input) out of device
// memory, as this one does. This first version re-reads each patch for
// every block of 32 output channels, re-reads V for every tile block, and
// synchronises between stages with no overlap of loads and products; wgmma,
// TMA and a pipelined ring of chunks are later work. The library yardstick
// is cuDNN's direct conv (torch.nn.functional.conv2d), which this kernel
// does not call.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTilesH = 8;                 // tile rows per block
constexpr int kTilesW = 8;                 // tile columns per block
constexpr int kNT = kTilesH * kTilesW;     // 64 tiles: the products' rows
constexpr int kCK = 16;                    // input channels per chunk
constexpr int kFB = 32;                    // output channels per block
constexpr int kPH = 2 * kTilesH + 2;       // halo patch rows
constexpr int kPW = 2 * kTilesW + 2;       // halo patch columns
constexpr int kWarpsN = kNT / 16;          // warps along the tiles
constexpr int kThreads = 32 * kWarpsN * (kFB / 16);  // 256

// shared memory: U [16][kNT][kCK], V [16][kCK][kFB], patch [kCK][kPH][kPW]
// (16-bit each); after the loop the float32 outputs [4][kNT][kFB] reuse U
constexpr int kUBytes = 16 * kNT * kCK * 2;
constexpr int kVBytes = 16 * kCK * kFB * 2;
constexpr int kPBytes = kCK * kPH * kPW * 2;
constexpr int kSmemBytes = kUBytes + kVBytes + kPBytes;
static_assert(4 * kNT * kFB * 4 <= kUBytes, "outputs must fit U's space");

template <typename T> struct Cvt;
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 t(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float f(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half t(float v) {
    return __float2half_rn(v);
  }
};

// a float32 value rounded to T and back
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return Cvt<T>::f(Cvt<T>::t(v));
}

template <typename T, bool PROLOGUE>
__global__ void __launch_bounds__(kThreads, 1)
winograd_f23_kernel(const T* __restrict__ x, const T* __restrict__ v,
                    const float* __restrict__ pa, const float* __restrict__ pb,
                    T* __restrict__ y, int C, int F, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Us = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + kUBytes);
  T* Ps = reinterpret_cast<T*>(smem + kUBytes + kVBytes);
  float* Ys = reinterpret_cast<float*>(smem);

  const int tw = W / 2;
  const int blocks_w = (tw + kTilesW - 1) / kTilesW;
  const int ty0 = (blockIdx.x / blocks_w) * kTilesH;
  const int tx0 = (blockIdx.x % blocks_w) * kTilesW;
  const int f0 = blockIdx.y * kFB;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % kWarpsN;  // this warp's 16 tiles
  const int wf = warp / kWarpsN;  // and 16 output channels

  const int64_t plane = (int64_t)H * W;
  const T* xn = x + (int64_t)n * C * plane;
  const int iy0 = 2 * ty0 - 1, ix0 = 2 * tx0 - 1;  // the patch's origin

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) wmma::fill_fragment(acc[p], 0.0f);

  for (int c0 = 0; c0 < C; c0 += kCK) {
    __syncthreads();  // the last chunk's products are done with U and V

    // 1. the halo patch, zero outside the image
    for (int i = tid; i < kCK * kPH * kPW; i += kThreads) {
      const int cc = i / (kPH * kPW);
      const int r = (i / kPW) % kPH, q = i % kPW;
      const int c = c0 + cc, iy = iy0 + r, ix = ix0 + q;
      float val = 0.0f;
      if (c < C && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        val = Cvt<T>::f(xn[c * plane + (int64_t)iy * W + ix]);
        if constexpr (PROLOGUE) {
          // the affine in float32 (no FMA), rounded to T; SiLU in float32
          const float t = rnd<T>(__fadd_rn(__fmul_rn(val, pa[n * C + c]),
                                           pb[n * C + c]));
          val = t / (1.0f + expf(-t));
        }
      }
      Ps[i] = Cvt<T>::t(val);
    }
    // 2. V's chunk
    for (int i = tid; i < 16 * kCK * kFB; i += kThreads) {
      const int p = i / (kCK * kFB), cc = (i / kFB) % kCK, ff = i % kFB;
      const int c = c0 + cc, f = f0 + ff;
      Vs[i] = (c < C && f < F) ? v[((int64_t)p * C + c) * F + f]
                               : Cvt<T>::t(0.0f);
    }
    __syncthreads();

    // 3. U_p = B^T d B per (tile, channel)
    for (int i = tid; i < kNT * kCK; i += kThreads) {
      const int cc = i % kCK, t = i / kCK;
      const T* d = Ps + cc * kPH * kPW + 2 * (t / kTilesW) * kPW
                   + 2 * (t % kTilesW);
      float a[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // rows: B^T along H
        const float d0 = Cvt<T>::f(d[j]), d1 = Cvt<T>::f(d[kPW + j]);
        const float d2 = Cvt<T>::f(d[2 * kPW + j]);
        const float d3 = Cvt<T>::f(d[3 * kPW + j]);
        a[0][j] = rnd<T>(d0 - d2);
        a[1][j] = rnd<T>(d1 + d2);
        a[2][j] = rnd<T>(d2 - d1);
        a[3][j] = rnd<T>(d1 - d3);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // columns: B along W
        T* u = Us + ((r * 4) * kNT + t) * kCK + cc;
        u[0 * kNT * kCK] = Cvt<T>::t(a[r][0] - a[r][2]);
        u[1 * kNT * kCK] = Cvt<T>::t(a[r][1] + a[r][2]);
        u[2 * kNT * kCK] = Cvt<T>::t(a[r][2] - a[r][1]);
        u[3 * kNT * kCK] = Cvt<T>::t(a[r][1] - a[r][3]);
      }
    }
    __syncthreads();

    // 4. the 16 products of this warp's tiles and channels
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      wmma::load_matrix_sync(fa, Us + (p * kNT + wm * 16) * kCK, kCK);
      wmma::load_matrix_sync(fb, Vs + p * kCK * kFB + wf * 16, kFB);
      wmma::mma_sync(acc[p], fa, fb, acc[p]);
    }
  }

  // A^T M A, elementwise on the fragments, into acc[0..3] = y00 y01 y10 y11
#pragma unroll
  for (int e = 0; e < acc[0].num_elements; ++e) {
    float m[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) m[p] = acc[p].x[e];
    float s;
    s = m[0]; s = __fadd_rn(s, m[1]); s = __fadd_rn(s, m[2]);
    s = __fadd_rn(s, m[4]); s = __fadd_rn(s, m[5]); s = __fadd_rn(s, m[6]);
    s = __fadd_rn(s, m[8]); s = __fadd_rn(s, m[9]); s = __fadd_rn(s, m[10]);
    const float y00 = s;
    s = m[1]; s = __fsub_rn(s, m[2]); s = __fsub_rn(s, m[3]);
    s = __fadd_rn(s, m[5]); s = __fsub_rn(s, m[6]); s = __fsub_rn(s, m[7]);
    s = __fadd_rn(s, m[9]); s = __fsub_rn(s, m[10]); s = __fsub_rn(s, m[11]);
    const float y01 = s;
    s = m[4]; s = __fadd_rn(s, m[5]); s = __fadd_rn(s, m[6]);
    s = __fsub_rn(s, m[8]); s = __fsub_rn(s, m[9]); s = __fsub_rn(s, m[10]);
    s = __fsub_rn(s, m[12]); s = __fsub_rn(s, m[13]); s = __fsub_rn(s, m[14]);
    const float y10 = s;
    s = m[5]; s = __fsub_rn(s, m[6]); s = __fsub_rn(s, m[7]);
    s = __fsub_rn(s, m[9]); s = __fadd_rn(s, m[10]); s = __fadd_rn(s, m[11]);
    s = __fsub_rn(s, m[13]); s = __fadd_rn(s, m[14]); s = __fadd_rn(s, m[15]);
    const float y11 = s;
    acc[0].x[e] = y00;
    acc[1].x[e] = y01;
    acc[2].x[e] = y10;
    acc[3].x[e] = y11;
  }
  __syncthreads();  // every warp is done with U: its space takes the outputs
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wmma::store_matrix_sync(Ys + (q * kNT + wm * 16) * kFB + wf * 16, acc[q],
                            kFB, wmma::mem_row_major);
  __syncthreads();

  // NCHW out, rounded once; consecutive threads on consecutive W
  constexpr int kOH = 2 * kTilesH, kOW = 2 * kTilesW;
  T* yn = y + (int64_t)n * F * plane;
  for (int i = tid; i < kFB * kOH * kOW; i += kThreads) {
    const int ox = i % kOW, oy = (i / kOW) % kOH, ff = i / (kOH * kOW);
    const int f = f0 + ff, gy = 2 * ty0 + oy, gx = 2 * tx0 + ox;
    if (f < F && gy < H && gx < W) {
      const int t = (oy / 2) * kTilesW + ox / 2, q = (oy % 2) * 2 + ox % 2;
      yn[f * plane + (int64_t)gy * W + gx] =
          Cvt<T>::t(Ys[(q * kNT + t) * kFB + ff]);
    }
  }
}

template <typename T, bool PROLOGUE>
cudaError_t launch(const void* x, const void* v, const float* a,
                   const float* b, void* y, int B, int C, int F, int H, int W,
                   cudaStream_t stream) {
  auto kernel = winograd_f23_kernel<T, PROLOGUE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int th = H / 2, tw = W / 2;
  const int tile_blocks =
      ((th + kTilesH - 1) / kTilesH) * ((tw + kTilesW - 1) / kTilesW);
  const dim3 grid(tile_blocks, (F + kFB - 1) / kFB, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(v), a, b,
      static_cast<T*>(y), C, F, H, W);
  return cudaGetLastError();
}

template <bool PROLOGUE>
int dispatch(const void* x, const void* v, const float* a, const float* b,
             void* y, int B, int C, int F, int H, int W, int dtype,
             void* stream) {
  if (B <= 0 || C <= 0 || F <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 ||
      B > 65535 || (F + kFB - 1) / kFB > 65535 || x == y)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch<__nv_bfloat16, PROLOGUE>(x, v, a, b, y, B, C, F, H,
                                                  W, s);
    case 1:
      return (int)launch<__half, PROLOGUE>(x, v, a, b, y, B, C, F, H, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points for ctypes. x [B, C, H, W], V [16, C, F] and
// y [B, F, H, W] are contiguous buffers of one dtype (0 = bfloat16,
// 1 = float16) on the current device, y distinct from x; a and b are
// contiguous float32 [B, C]. H and W even. Each launches on `stream` and
// returns the launch's cudaGetLastError() (0 on success) without
// synchronising.
extern "C" int winograd_f23_conv(const void* x, const void* v, void* y, int B,
                                 int C, int F, int H, int W, int dtype,
                                 void* stream) {
  return dispatch<false>(x, v, nullptr, nullptr, y, B, C, F, H, W, dtype,
                         stream);
}

extern "C" int winograd_f23_conv_fused(const void* x, const void* v,
                                       const float* a, const float* b, void* y,
                                       int B, int C, int F, int H, int W,
                                       int dtype, void* stream) {
  if (a == nullptr || b == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(x, v, a, b, y, B, C, F, H, W, dtype, stream);
}
