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
// Bound on an H100 SXM (700 W). The 16 products are 2*16*(H/2)*(W/2)*C*F
// flops; the bytes are x + y + V. At FFHQ-256's hottest shape (256x256,
// 128 -> 128, B=1) 8.6 GFLOP (8.7 us at 989 TFLOP/s) against 34 MB (10 us
// at 3.35 TB/s); at 8-16 px V (16*C*F) is most of the bytes. A fast kernel
// keeps the transformed tiles (4x the input) out of device memory, and
// fills the card at every level of the UNet, 8 px to 256 px.
//
// Design. A CTA owns one sample, a block of TH x TW output tiles, a group
// of F blocks of FB output channels and a slice of the input channels. The
// host (ops/winograd.py: launch_config) picks the tiling, the C split and
// the F groups from (B, C, F, H, W):
//   * the C split is a thread-block cluster of S <= 8 CTAs along C. Each
//     CTA applies A^T . A to its partial M (A^T M A is linear) and writes
//     its four float32 output planes to its own shared memory; after a
//     cluster barrier each CTA sums one share of the outputs over the S
//     CTAs' planes through distributed shared memory, in rank order, and
//     rounds once. A conv stays one launch and writes no float32 partials
//     to device memory. The barrier that frees the planes again is split:
//     the CTA arrives after its sum and waits only before it next writes
//     that memory;
//   * U = B^T d B is built once per C slice into shared memory (up to US
//     channels) and reused for every F block of the CTA; a slice wider
//     than US is rebuilt per F block (the host then gives each CTA one F
//     block). The halo patch of 16 channels arrives by 4-byte cp.async,
//     two patches in flight; the prologue's affine and expf run once per
//     loaded element, on half rows of a channel, and the conv's zero
//     padding stays zero; the transform runs on packed pairs of channels;
//   * V streams through a ring of NST stages in shared memory, each the 16
//     products x 16 channels x FB of one chunk, one TMA box a stage (zero
//     past C and F), completed on an mbarrier, so that stage s+NST-1 is in
//     flight while stage s is multiplied;
//   * two warpgroups run wgmma from shared memory, float32 accumulators in
//     registers: each warpgroup holds 8 of the 16 products over the CTA's
//     whole C slice, and A^T M A runs after the C loop, each warpgroup's
//     rows of the 4x4 first, then their sum through shared memory. The 8x8
//     tiling (64 tiles x 32 output channels) runs m64n32k16 with A = U_p,
//     B = V_p (128 accumulator registers a thread). The 4x4 tiling (16
//     tiles x 64 output channels, for 8 px images, where 64 tile rows would
//     be three quarters zeros) puts F on the 64-row side, M_p^T = V_p^T
//     U_p^T: m64n16k16 with V_p as the M-major A and U_p as the K-major B
//     (64 accumulator registers a thread).
// Rounding points are the Pallas kernel's: the input transform's two add
// stages; the prologue's affine (float32, no FMA) rounded to T, then SiLU
// in float32 rounded to T; float32 accumulation over the whole of C;
// A^T M A in float32, rounded once. kdip_tpu sums 128-channel chunks in
// bf16 instead (tests/test_torch_winograd_ops.py records the difference).
// Any B, C, F and even H, W are taken; the caller checks dtype, shapes and
// contiguity. The library yardstick is cuDNN's direct conv
// (torch.nn.functional.conv2d), which this kernel does not call.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;  // the portable cluster size

// TH x TW tiles a CTA, FB output channels at a time; two warpgroups, each
// with 8 of the 16 products. Without TRANS a product is wgmma m64n32k16
// with the 64 tiles as its rows; with TRANS, m64n16k16 with the 64 output
// channels as its rows and the 16 tiles as its columns. US input channels
// U holds; NST ring stages of V, 16 channels each.
template <int TH_, int TW_, int FB_, bool TRANS_, int US_, int NST_>
struct Tiling {
  static constexpr int TH = TH_, TW = TW_, FB = FB_;
  static constexpr bool TRANS = TRANS_;
  static constexpr int NT = TH * TW;         // tiles
  static constexpr int PPW = 8;              // products a warpgroup
  static constexpr int ACC = NT * FB / 128;  // floats a product, thread
  static constexpr int US = US_, NST = NST_;
  static constexpr int THREADS = 256;
  static constexpr int PH = 2 * TH + 2;      // halo patch rows
  static constexpr int QW = 2 * TW + 4;      // its columns, 4-byte aligned
  static constexpr int YLD = 4 * NT + 4;     // float32 output plane stride
  // shared memory: U [16][US/16][16-channel block, u_off]; the V ring
  // [NST][16 products][FB/8][16 channels][8] (as the TMA box lands); a
  // scratch that holds two halo patches [2][16][PH][QW] while U is built
  // and the float32 outputs [FB][2TH][2TW] after the C loop
  static constexpr int U_BYTES = 16 * NT * US * 2;
  static constexpr int STAGE = 16 * 16 * FB;
  static constexpr int RING_BYTES = NST * STAGE * 2;
  static constexpr int P_ELEMS = 16 * PH * QW;
  static constexpr int Y_BYTES = FB * YLD * 4;
  static constexpr int SCRATCH_BYTES =
      Y_BYTES > 4 * P_ELEMS ? Y_BYTES : 4 * P_ELEMS;
  static constexpr int SMEM = U_BYTES + RING_BYTES + SCRATCH_BYTES;
  static_assert(TRANS ? NT == 16 && FB == 64 : NT == 64 && FB == 32,
                "wgmma m64n16 over 64 output channels, or m64n32 over 64 "
                "tiles");
  static_assert(US % 16 == 0 && NST >= 2, "ring");
  static_assert(TW % 2 == 0, "outputs leave in quads of 4");
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
};
// ops/winograd.py's TILINGS repeats (TH, TW, FB, US) of these two
using TilingL = Tiling<8, 8, 32, false, 64, 3>;
using TilingT = Tiling<4, 4, 64, true, 64, 3>;

// element offset of (tile t, channel c) in a 16-channel block of U: core
// matrices of 8 tiles x 8 channels
__device__ __forceinline__ int u_off(int t, int c) {
  return (((t >> 3) * 2 + (c >> 3)) << 6) + ((t & 7) << 3) + (c & 7);
}

// element offset of (channel c of 16, output channel f) in one product's
// block of a V stage: 16-byte rows of 8 output channels, the 16 channels of
// a group of 8 outputs together (8x8 core matrices, 128 bytes each)
__device__ __forceinline__ int v_off(int c, int f) {
  return (((f >> 3) * 16 + c) << 3) + (f & 7);
}

template <typename T> struct Cvt;
template <> struct Cvt<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 t(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Cvt<__half> {
  using T2 = __half2;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// the two halves of a cluster barrier, so that work can run between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a wgmma shared-memory matrix descriptor, no swizzle: core matrices of
// 8 rows x 16 bytes, lbo bytes apart along K, sbo bytes apart along M or N
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 32, the warpgroup's fragments) += a (64 x 16, K-major) .
// b (16 x 32, N-major), float32 accumulators
template <typename T>
__device__ __forceinline__ void wgmma_m64n32k16(float* d, uint64_t a,
                                                uint64_t b) {
#define WINO_WGMMA(TYPE)                                                     \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPE "." TYPE " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
      "%15}, %16, %17, p, 1, 1, 0, 1;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15])                                                          \
      : "l"(a), "l"(b), "r"(1))
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WINO_WGMMA("bf16");
  } else {
    WINO_WGMMA("f16");
  }
#undef WINO_WGMMA
}

// d (64 x 16, the warpgroup's fragments) += a (64 x 16, M-major) .
// b (16 x 16, K-major), float32 accumulators
template <typename T>
__device__ __forceinline__ void wgmma_m64n16k16_ta(float* d, uint64_t a,
                                                   uint64_t b) {
#define WINO_WGMMA(TYPE)                                                     \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TYPE "." TYPE " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                   \
      : "l"(a), "l"(b), "r"(1))
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    WINO_WGMMA("bf16");
  } else {
    WINO_WGMMA("f16");
  }
#undef WINO_WGMMA
}

// mbarriers: a TMA load completes its stage's barrier by its bytes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// a 4-d TMA box of `map` at (c0, c1, c2, c3) into shared memory
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory writes of this thread made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T, bool PROLOGUE, class K>
__global__ void __launch_bounds__(K::THREADS)
winograd_f23_kernel(const T* __restrict__ x, const T* __restrict__ v,
                    const float* __restrict__ pa, const float* __restrict__ pb,
                    T* __restrict__ y, int C, int F, int H, int W, int cs,
                    int fper, const __grid_constant__ CUtensorMap vmap,
                    int vtma) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t vbar[K::NST];     // the V ring's TMA barriers
  __shared__ float pab[2][16];          // the prologue's a, b of a chunk
  T* Us = reinterpret_cast<T*>(smem);
  T* Vr = reinterpret_cast<T*>(smem + K::U_BYTES);
  unsigned char* scratch = smem + K::U_BYTES + K::RING_BYTES;
  float* Ys = reinterpret_cast<float*>(scratch);  // after the C loop
  T* Ps = reinterpret_cast<T*>(scratch);           // while U is built

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());  // the C split
  const int rank = static_cast<int>(cluster.block_rank());  // = x % S
  const int tid = threadIdx.x, lane = tid & 31;
  const int wp = tid >> 7;  // this thread's warpgroup: products 8wp..8wp+7

  const int tw = W / 2;
  const int nbw = (tw + K::TW - 1) / K::TW;
  const int ty0 = (blockIdx.y / nbw) * K::TH;
  const int tx0 = (blockIdx.y % nbw) * K::TW;
  const int n = blockIdx.z;
  const int c_lo = rank * cs, c_hi = min(C, c_lo + cs);
  const int nchunks = c_hi > c_lo ? (c_hi - c_lo + 15) / 16 : 0;
  const int nfb = (F + K::FB - 1) / K::FB;
  const int fb_lo = (blockIdx.x / S) * fper;
  const int nfbl = min(nfb, fb_lo + fper) - fb_lo;
  constexpr int UCH = K::US / 16;  // 16-channel chunks U holds
  const bool rebuild = nchunks > UCH;
  const int total = nfbl * nchunks;  // ring stages

  const int64_t plane = (int64_t)H * W;
  const T* xn = x + (int64_t)n * C * plane;
  const bool xvec = (reinterpret_cast<uintptr_t>(x) & 3) == 0;
  bool pending = false;  // a cluster barrier arrived at, not yet waited on

  // ring stage s: V [16 products][16 channels][FB] of F block s / nchunks
  // and chunk s % nchunks: one TMA box (zero past F and C; channels past
  // this slice meet zeros in U), or, where V's rows are not 16-byte
  // pieces, loads by every thread
  auto load_stage = [&](int s) {
    const int c0 = c_lo + 16 * (s % nchunks);
    const int f0 = (fb_lo + s / nchunks) * K::FB;
    T* dst = Vr + (s % K::NST) * K::STAGE;
    if (vtma) {
      if (tid == 0) {
        mbar_expect(&vbar[s % K::NST], K::STAGE * 2);
        tma_load_4d(dst, &vmap, &vbar[s % K::NST], 0, c0, f0 / 8, 0);
      }
    } else {
      for (int i = tid; i < 16 * 16 * K::FB; i += K::THREADS) {
        const int row = i / K::FB, ff = i % K::FB;
        const int c = c0 + row % 16, f = f0 + ff;
        dst[(row / 16) * 16 * K::FB + v_off(row % 16, ff)] =
            (c < c_hi && f < F)
                ? v[((int64_t)(row / 16) * C + c) * F + f]
                : Cvt<T>::t(0.0f);
      }
    }
  };

  // the halo patch of chunk k, [16][PH][QW] from column 2*tx0 - 2, in
  // 4-byte pieces (2 columns; W is even, so a piece is all in the image or
  // all out of it), zero outside the image and past the slice
  auto load_patch = [&](int k, T* dst) {
    constexpr int QP = K::QW / 2;
    const int cbase = c_lo + 16 * k;
    for (int i = tid; i < 16 * K::PH * QP; i += K::THREADS) {
      const int cc = i / (K::PH * QP), r = (i / QP) % K::PH, m = i % QP;
      const int c = cbase + cc, iy = 2 * ty0 - 1 + r, ix = 2 * tx0 - 2 + 2 * m;
      const bool ok = c < c_hi && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const T* src = ok ? xn + c * plane + (int64_t)iy * W + ix : x;
      T* d = dst + (cc * K::PH + r) * K::QW + 2 * m;
      if (xvec) {
        cp_async4(d, src, ok);
      } else {
        d[0] = ok ? src[0] : Cvt<T>::t(0.0f);
        d[1] = ok ? src[1] : Cvt<T>::t(0.0f);
      }
    }
  };

  // U [16][NT][chunks k0.. of this slice] = B^T d B, zero past the slice;
  // the patch of chunk k+1 is in flight while chunk k is transformed
  auto build_u = [&](int k0) {
    const int k1 = min(nchunks, k0 + UCH);
    if (pending) {  // the cluster is done reading the outputs' planes
      cluster_wait();
      pending = false;
    }
    load_patch(k0, Ps);
    cp_async_commit();
    for (int k = k0; k < k1; ++k) {
      T* pk = Ps + ((k - k0) & 1) * K::P_ELEMS;
      __syncthreads();  // chunk k-1's transform is done with its patch
      if (k + 1 < k1) load_patch(k + 1, Ps + ((k + 1 - k0) & 1) * K::P_ELEMS);
      cp_async_commit();
      cp_async_wait<1>();  // chunk k's patch (and every older copy) landed
      if constexpr (PROLOGUE) {
        if (tid < 16) {
          const int c = min(c_lo + 16 * k + tid, C - 1);
          pab[0][tid] = pa[n * C + c];
          pab[1][tid] = pb[n * C + c];
        }
      }
      __syncthreads();
      if constexpr (PROLOGUE) {
        // silu(x*a + b) in place, the padding kept zero: the affine in
        // float32 (no FMA), rounded to T; SiLU in float32, rounded to T
        // on the columns the transform reads, 1 .. 2TW+2: a thread takes
        // half a row of one channel, TW+1 elements, all read before any
        // is written
        constexpr int HW = K::TW + 1;
        for (int u = tid; u < 16 * K::PH * 2; u += K::THREADS) {
          const int cc = u / (2 * K::PH), r = (u >> 1) % K::PH;
          const int c = c_lo + 16 * k + cc, iy = 2 * ty0 - 1 + r;
          if (c >= c_hi || iy < 0 || iy >= H) continue;
          const float ca = pab[0][cc], cb = pab[1][cc];
          const int q0 = 1 + (u & 1) * HW, ix0 = 2 * tx0 - 2 + q0;
          T* row = pk + (cc * K::PH + r) * K::QW + q0;
          float val[HW];
#pragma unroll
          for (int j = 0; j < HW; ++j) val[j] = Cvt<T>::f(row[j]);
#pragma unroll
          for (int j = 0; j < HW; ++j) {
            if (ix0 + j >= 0 && ix0 + j < W) {
              const float t = rnd<T>(__fadd_rn(__fmul_rn(val[j], ca), cb));
              row[j] = Cvt<T>::t(t / (1.0f + expf(-t)));
            }
          }
        }
        __syncthreads();
      }
      // two channels a thread, as packed pairs: a packed add rounds its
      // exact sum once, as a float32 add of two T values rounded to T does
      using T2 = typename Cvt<T>::T2;
      for (int i = tid; i < K::NT * 8; i += K::THREADS) {
        const int cc = 2 * (i % 8), t = i / 8;
        const T* d = pk + (cc * K::PH + 2 * (t / K::TW)) * K::QW +
                     2 * (t % K::TW) + 1;
        const T* e = d + K::PH * K::QW;  // channel cc + 1
        T2 a[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // rows: B^T along H
          const T2 d0(d[j], e[j]), d1(d[K::QW + j], e[K::QW + j]);
          const T2 d2(d[2 * K::QW + j], e[2 * K::QW + j]);
          const T2 d3(d[3 * K::QW + j], e[3 * K::QW + j]);
          a[0][j] = __hsub2(d0, d2);
          a[1][j] = __hadd2(d1, d2);
          a[2][j] = __hsub2(d2, d1);
          a[3][j] = __hsub2(d1, d3);
        }
        T2* u = reinterpret_cast<T2*>(Us + (k - k0) * K::NT * 16 +
                                      u_off(t, cc));
        constexpr int P = K::NT * K::US / 2;  // one product's stride
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // columns: B along W
          u[(4 * r + 0) * P] = __hsub2(a[r][0], a[r][2]);
          u[(4 * r + 1) * P] = __hadd2(a[r][1], a[r][2]);
          u[(4 * r + 2) * P] = __hsub2(a[r][2], a[r][1]);
          u[(4 * r + 3) * P] = __hsub2(a[r][1], a[r][3]);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();  // U is whole; the patches are free
  };

  const int g = lane >> 2, tq = lane & 3;  // accumulator fragment
  T* yn = y + (int64_t)n * F * plane;
  const bool yvec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 7) == 0;

  if (tid == 0) {
    for (int i = 0; i < K::NST; ++i) mbar_init(&vbar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < K::NST - 1 && s < total; ++s) load_stage(s);
  int s = 0;  // the ring stage consumed next
  for (int fbl = 0; fbl < nfbl; ++fbl) {
    float acc[K::PPW][K::ACC];  // this group's products
#pragma unroll
    for (int q = 0; q < K::PPW; ++q)
#pragma unroll
      for (int e = 0; e < K::ACC; ++e) acc[q][e] = 0.0f;

    for (int k = 0; k < nchunks; ++k) {
      if (k % UCH == 0 && (fbl == 0 || rebuild)) build_u(k);
      const T* uk = Us + (k % UCH) * K::NT * 16;  // product 0's block
      if (vtma) mbar_wait(&vbar[s % K::NST], (s / K::NST) & 1);
      fence_proxy_async();  // the loads by threads
      __syncthreads();  // stage s has landed; stage s-1's buffer is free
      if (s + K::NST - 1 < total) load_stage(s + K::NST - 1);
      const T* vs = Vr + (s % K::NST) * K::STAGE;
      // one wgmma a product: U_p [64 tiles x 16 channels] . V_p [16 x 32],
      // or V_p^T [64 outputs x 16 channels] . U_p^T [16 x 16 tiles]
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int q = 0; q < K::PPW; ++q) {
        const int p = wp * K::PPW + q;
        const uint64_t du = wgmma_desc(uk + p * K::NT * K::US, 128, 256);
        const uint64_t dv = wgmma_desc(vs + p * 16 * K::FB, 128, 256);
        if constexpr (K::TRANS)
          wgmma_m64n16k16_ta<T>(acc[q], dv, du);
        else
          wgmma_m64n32k16<T>(acc[q], du, dv);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int q = 0; q < K::PPW; ++q)
#pragma unroll
        for (int e = 0; e < K::ACC; ++e)
          asm volatile("" : "+f"(acc[q][e])::"memory");
      ++s;
    }

    // warpgroup g holds the products of rows i = 2g, 2g+1 of the 4x4:
    // P_il = sum_j A^T[l][j] M_ij, then each group's share of
    // y_kl = sum_i A^T[k][i] P_il, warpgroup 1's written first and
    // warpgroup 0's added to it (float32, in that order)
    if (pending) {  // the cluster is done reading the last planes
      cluster_wait();
      pending = false;
    }
    const int wi = (tid >> 5) & 3;  // warp in the warpgroup
    for (int half = 1; half >= 0; --half) {
      if (wp == half) {
#pragma unroll
        for (int e = 0; e < K::ACC; ++e) {
          float pr[2][2];  // P_il of this group's two rows
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m0 = acc[4 * r][e], m1 = acc[4 * r + 1][e];
            const float m2 = acc[4 * r + 2][e], m3 = acc[4 * r + 3][e];
            pr[r][0] = (m0 + m1) + m2;
            pr[r][1] = (m1 - m2) - m3;
          }
          float y[2][2];
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            y[0][l] = half ? pr[0][l] : pr[0][l] + pr[1][l];
            y[1][l] = half ? -pr[0][l] - pr[1][l] : pr[1][l];
          }
          // fragment element e: row 16 wi + g (+8 for e%4 >= 2), column
          // 8 (e/4) + 2 tq + e%2; rows are tiles, or with TRANS outputs
          const int row = 16 * wi + g + 8 * ((e >> 1) & 1);
          const int col = 8 * (e >> 2) + 2 * tq + (e & 1);
          const int t = K::TRANS ? col : row, ff = K::TRANS ? row : col;
          float* o = Ys + ff * K::YLD + 2 * (t / K::TW) * (2 * K::TW) +
                     2 * (t % K::TW);
          const int at[4] = {0, 1, 2 * K::TW, 2 * K::TW + 1};
#pragma unroll
          for (int kl = 0; kl < 4; ++kl)
            o[at[kl]] = half ? y[kl >> 1][kl & 1]
                             : o[at[kl]] + y[kl >> 1][kl & 1];
        }
      }
      __syncthreads();
    }
    cluster_arrive();
    cluster_wait();  // every CTA's planes are complete

    // this CTA's share of the outputs, in quads of 4 along W: the sum over
    // the cluster's planes in rank order, rounded once, out to NCHW
    const int f0 = (fb_lo + fbl) * K::FB;
    constexpr int QPF = K::TH * K::TW;  // quads a channel
    for (int i = rank * K::THREADS + tid; i < K::FB * QPF;
         i += S * K::THREADS) {
      const int ff = i / QPF, qi = i % QPF;
      const int oy = qi / (K::TW / 2), ox = 4 * (qi % (K::TW / 2));
      const int off = ff * K::YLD + oy * 2 * K::TW + ox;
      float4 sum = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(Ys, 0) + off);
      for (int q = 1; q < S; ++q) {
        const float4 w = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(Ys, q) + off);
        sum.x += w.x;
        sum.y += w.y;
        sum.z += w.z;
        sum.w += w.w;
      }
      const int f = f0 + ff, gy = 2 * ty0 + oy, gx = 2 * tx0 + ox;
      if (f < F && gy < H && gx < W) {
        T* dst = yn + f * plane + (int64_t)gy * W + gx;
        struct alignas(8) Quad { T v[4]; } out;
        out.v[0] = Cvt<T>::t(sum.x);
        out.v[1] = Cvt<T>::t(sum.y);
        out.v[2] = Cvt<T>::t(sum.z);
        out.v[3] = Cvt<T>::t(sum.w);
        if (yvec && gx + 3 < W) {
          *reinterpret_cast<Quad*>(dst) = out;
        } else {
          for (int e = 0; e < 4 && gx + e < W; ++e) dst[e] = out.v[e];
        }
      }
    }
    cluster_arrive();  // waited on before the planes' memory is written
    pending = true;
  }
  if (pending) cluster_wait();  // no CTA leaves while its planes are read
}

template <class K>
void tiling_info(int* out) {
  out[0] = K::TH;
  out[1] = K::TW;
  out[2] = K::FB;
  out[3] = K::US;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                              &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

template <typename T, bool PROLOGUE, class K>
cudaError_t launch(const void* x, const void* v, const float* a,
                   const float* b, void* y, int B, int C, int F, int H, int W,
                   int csplit, int cs, int groups, int fper,
                   cudaStream_t stream) {
  // csplit slices of cs channels cover C (the last ones may be empty);
  // groups groups of fper F blocks cover F, none empty
  const int nfb = (F + K::FB - 1) / K::FB;
  if (cs < 16 || cs % 16 || (int64_t)csplit * cs < C || fper < 1 ||
      (int64_t)groups * fper < nfb || (int64_t)(groups - 1) * fper >= nfb)
    return cudaErrorInvalidValue;
  auto kernel = winograd_f23_kernel<T, PROLOGUE, K>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = ((H / 2 + K::TH - 1) / K::TH) *
                    ((W / 2 + K::TW - 1) / K::TW);
  if (tiles > 65535) return cudaErrorInvalidValue;
  // V [16, C, F] as 4-d (8 outputs, C channels, F/8 groups, 16 products),
  // so that a box lands as the V stage's core matrices
  CUtensorMap vmap;
  memset(&vmap, 0, sizeof(vmap));
  const int vtma = F % 8 == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  if (vtma) {
    static const EncodeTiled encode = encoder();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {8, (cuuint64_t)C, (cuuint64_t)F / 8, 16};
    const cuuint64_t strides[3] = {(cuuint64_t)F * 2, 16,
                                   (cuuint64_t)C * F * 2};
    const cuuint32_t box[4] = {8, 16, K::FB / 8, 16}, ones[4] = {1, 1, 1, 1};
    if (encode(&vmap, CU_TENSOR_MAP_DATA_TYPE_UINT16, 4, const_cast<void*>(v),
               dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csplit * groups, tiles, B);
  cfg.blockDim = dim3(K::THREADS);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                            static_cast<const T*>(v), a, b,
                            static_cast<T*>(y), C, F, H, W, cs, fper, vmap,
                            vtma);
}

template <typename T, bool PROLOGUE>
cudaError_t launch_tiling(const void* x, const void* v, const float* a,
                          const float* b, void* y, int B, int C, int F, int H,
                          int W, const int* cfg, cudaStream_t s) {
#define WINO_LAUNCH(K)                                                     \
  launch<T, PROLOGUE, K>(x, v, a, b, y, B, C, F, H, W, cfg[1], cfg[2],     \
                         cfg[3], cfg[4], s)
  switch (cfg[0]) {
    case 0: return WINO_LAUNCH(TilingL);
    case 1: return WINO_LAUNCH(TilingT);
    default: return cudaErrorInvalidValue;
  }
#undef WINO_LAUNCH
}

template <bool PROLOGUE>
int dispatch(const void* x, const void* v, const float* a, const float* b,
             void* y, int B, int C, int F, int H, int W, int dtype,
             const int* cfg, void* stream) {
  if (B <= 0 || C <= 0 || F <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2 ||
      B > 65535 || x == y || cfg == nullptr || cfg[1] < 1 ||
      cfg[1] > kMaxCluster || cfg[3] < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)launch_tiling<__nv_bfloat16, PROLOGUE>(x, v, a, b, y, B, C,
                                                         F, H, W, cfg, s);
    case 1:
      return (int)launch_tiling<__half, PROLOGUE>(x, v, a, b, y, B, C, F, H,
                                                  W, cfg, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points for ctypes. x [B, C, H, W], V [16, C, F] and
// y [B, F, H, W] are contiguous buffers of one dtype (0 = bfloat16,
// 1 = float16) on the current device, y distinct from x; a and b are
// contiguous float32 [B, C]. H and W even. cfg[5] is the launch
// configuration from ops/winograd.py: launch_config, (tiling, csplit, cs,
// fgroups, fper): the tiling's index, csplit <= 8 CTAs along C in a cluster,
// each over a slice of cs channels, and fgroups groups of fper F blocks.
// Each launches on `stream` and returns the launch's cudaError_t (0 on
// success) without synchronising.
extern "C" int winograd_f23_conv(const void* x, const void* v, void* y, int B,
                                 int C, int F, int H, int W, int dtype,
                                 const int* cfg, void* stream) {
  return dispatch<false>(x, v, nullptr, nullptr, y, B, C, F, H, W, dtype, cfg,
                         stream);
}

extern "C" int winograd_f23_conv_fused(const void* x, const void* v,
                                       const float* a, const float* b, void* y,
                                       int B, int C, int F, int H, int W,
                                       int dtype, const int* cfg,
                                       void* stream) {
  if (a == nullptr || b == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(x, v, a, b, y, B, C, F, H, W, dtype, cfg, stream);
}

// (TH, TW, FB, US) of a tiling into out[4], so that the wrapper can hold its
// table to the kernel's; 0 on success
extern "C" int winograd_f23_tiling(int tiling, int* out) {
  switch (tiling) {
    case 0: tiling_info<TilingL>(out); return 0;
    case 1: tiling_info<TilingT>(out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}
