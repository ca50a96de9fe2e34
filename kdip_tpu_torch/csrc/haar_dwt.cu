// Multi-level orthonormal 2-D Haar DWT, its inverse, and the fused
// covariance matvec of DWT-Var, float32, NCHW.
//
// Replaces the Pallas TPU kernel `_dwt_kernel` (kdip_tpu/ops/pallas_dwt.py:49,
// driven by `_run` and exposed as dwt2_pallas / idwt2_pallas). Same function:
// level `lv` maps the top-left (H>>lv, W>>lv) block of each (b, c) plane to
// its [[ll, lh], [hl, hh]] quadrants, lo = (e + o)/sqrt2 and hi = (e - o)/sqrt2,
// rows first, then columns (pywt's coeffs_to_array layout; the plain version
// is kdip_tpu_torch/ops/dwt.py: dwt2_plain / idwt2_plain). A third entry
// point computes the CG matvec of DWT-Var, y = s2*v + mask * W^-1(theta * W v)
// (kdip_tpu/guidance.py:394-395), in one pass, where the TPU program lets XLA
// fuse the elementwise ops around two pallas_calls.
//
// Bound on an H100 SXM: memory, and below it the launch. The transforms read
// and write each value once (2 x 786,432 B at [1,3,256,256], 0.47 us at
// 3.35 TB/s), the matvec reads v, theta and the mask and writes y (4 x
// 786,432 B, 0.94 us), against ~5 flops per value and level. An empty
// kernel's device time (torch.cuda._sleep(0), chip_smoke.py's
// launch_floor_ms) is of the same order, so at this size what a kernel
// adds to its launch, the latency from its first load to its last store,
// decides as much as its bytes do.
//
// Design. L Haar levels mix values only inside aligned 2^L x 2^L tiles. A
// thread owns a 2 x U patch of one plane (U = 4, or 2 where a row is not a
// whole number of float4s or a pointer is not 16-byte aligned), and the
// patches of a tile lie on consecutive lanes of one warp, so that:
// - loads and stores are coalesced and vectorised: a warp reads whole
//   128-byte row segments as 16-byte loads (U = 4), and writes level 0's
//   quadrants as 8-byte stores, neighbouring lanes on neighbouring
//   addresses; the deeper levels' few coefficients go out as 4-byte stores
//   of 16-32 contiguous bytes a warp;
// - level 0 runs in each thread's registers; every deeper level exchanges
//   the previous level's ll between the (up to) four lanes that hold its
//   2x2 block with __shfl_xor_sync, each of them computing the block, so
//   nothing goes through shared memory and no barrier is needed. (A
//   design that staged each CTA's region in shared memory, one barrier a
//   level, measured no faster than a tile-per-thread kernel on the H100:
//   its loops over the levels cost more than the barriers; PERF.md.)
// - the inverse needs no exchange: each lane loads its blocks' packed
//   coefficients (lanes that share a block read the same address, one
//   transaction) and keeps the value at its own position level by level.
// - the matvec loads v, the mask and theta at every packed position its
//   blocks touch, all before any arithmetic, so their latencies overlap;
//   runs the forward levels, which leave every lane all coefficients of
//   its blocks; multiplies them by theta; runs the inverse levels in
//   registers; and writes y once: 4 passes over the plane in one launch,
//   where the composed chain took 6 launches and ~15 passes.
// - No tensor cores, on purpose: the TPU kernel multiplies by packing
//   matrices on its MXU, but a Haar level is ~5 adds and multiplies per
//   value, and a TF32 wgmma would break the bit-equality with the float32
//   plain version.
// - The threads of a CTA (ops.dwt.launch_config, taken as given here) are
//   chosen so that a launch has a CTA for each of the 132 SMs where the
//   shape has the work.
//
// Rounding. Each butterfly output is (e +/- o) * float32(1/sqrt2), then
// theta * t, then s2*v + mask*w, each with a round-to-nearest intrinsic that
// the compiler cannot contract into an FMA: PyTorch's composed ops round
// after each op, so kernel and plain version agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvSqrt2 = 0.707106769084930419921875f;  // float32(1/sqrt2)
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float hsum(float a, float b) {
  return __fmul_rn(__fadd_rn(a, b), kInvSqrt2);
}
__device__ __forceinline__ float hdif(float a, float b) {
  return __fmul_rn(__fsub_rn(a, b), kInvSqrt2);
}

// The geometry of a thread's 2 x U patch at L levels: a group is the
// tiles (one, or two 2x2 tiles where U = 4 > S) whose patches lie on LPG
// consecutive lanes, CU patches along each of its S/2 row pairs.
template <int L, int U>
struct Geo {
  static constexpr int S = 1 << L;
  static constexpr int SG = U > S ? U : S;  // group width
  static constexpr int CU = SG / U;         // patches along a group's row
  static constexpr int LPG = (S / 2) * CU;  // lanes a group
  static_assert(LPG <= 32, "a group must lie within a warp");
};

// Where a thread's patch lies: rows y0, y0+1 and columns x0 .. x0+U-1 of
// its plane; (r0, c0) = (y0/2, x0/2) in level 0's grid. Lanes past the last
// patch (the end of a partial warp) alias patch 0, take part in the
// exchanges and store nothing.
struct Patch {
  bool active;
  int plane, y0, x0, r0, c0;
};

// 32-bit index arithmetic throughout (launch_dims bounds the grid's
// threads below 2^31): a 64-bit division costs ~100 instructions.
template <int L, int U>
__device__ __forceinline__ Patch patch_of(int planes, int H, int W) {
  using G = Geo<L, U>;
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const int within = (int)(t % G::LPG);
  const int rp = within / G::CU, cu = within % G::CU;
  const int per_row = W / G::SG;
  const unsigned per_plane = (unsigned)(H / G::S) * per_row;
  unsigned group = t / G::LPG;
  Patch p;
  p.active = group < (unsigned)planes * per_plane;
  if (!p.active) group = 0;
  p.plane = (int)(group / per_plane);
  const int gi = (int)(group - p.plane * per_plane);
  p.y0 = (gi / per_row) * G::S + 2 * rp;
  p.x0 = (gi % per_row) * G::SG + cu * U;
  p.r0 = p.y0 >> 1;
  p.c0 = p.x0 >> 1;
  return p;
}

// N consecutive floats as one access of 4 * N bytes
template <int N>
__device__ __forceinline__ void load(float (&d)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = __ldg(p);
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float (&d)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  else
    *p = d[0];
}

// Plane offsets of level lv's lh, hl, hh and (lv = L-1) final ll at
// position (r, c) of the level's quadrant grid.
struct Quads {
  int ll, lh, hl, hh;
};
__device__ __forceinline__ Quads quads(int lv, int r, int c, int H, int W) {
  const int hq = H >> (lv + 1), wq = W >> (lv + 1);
  return {r * W + c, r * W + wq + c, (hq + r) * W + c, (hq + r) * W + wq + c};
}

// All coefficients a thread's blocks touch. Level 0: the U/2 blocks of its
// patch (d0[q][e] for q = lh, hl, hh). Level lv >= 1: the 2x2 block of the
// level lv-1 grid that holds the thread's own position (d[lv][q]), which
// the (up to) four lanes holding that block all compute. ll: the final
// approximation, U/2 values at L = 1, else one. (Arrays of one, so that
// every value goes through the same load and store.)
template <int L, int U>
struct Coeffs {
  static constexpr int NLL = L == 1 ? U / 2 : 1;
  float d0[3][U / 2];
  float d[L][3][1];  // d[0] unused
  float ll[NLL];
};

// The lanes and bits of level lv >= 1's block: the thread's own position
// in the level lv-1 grid is row bit rb, column bit cb of the block; the
// lanes that hold the block's other rows and columns are lane ^ rmask and
// lane ^ cmask. At lv = 1 with U = 4 a lane holds both columns (cmask 0).
template <int L, int U>
struct Block {
  int rb, cb, rmask, cmask;
};
template <int L, int U>
__device__ __forceinline__ Block<L, U> block_of(const Patch& p, int lv) {
  using G = Geo<L, U>;
  Block<L, U> b;
  b.rb = (p.r0 >> (lv - 1)) & 1;
  b.cb = (p.c0 >> (lv - 1)) & 1;
  b.rmask = G::CU << (lv - 1);
  b.cmask = U == 4 ? (lv >= 2 ? 1 << (lv - 2) : 0) : 1 << (lv - 1);
  return b;
}

// One forward butterfly of the 2x2 block q[row][col]: ll, lh, hl, hh
__device__ __forceinline__ void butterfly(float q00, float q01, float q10,
                                          float q11, float& ll, float& lh,
                                          float& hl, float& hh) {
  const float lo0 = hsum(q00, q10), hi0 = hdif(q00, q10);  // rows
  const float lo1 = hsum(q01, q11), hi1 = hdif(q01, q11);
  ll = hsum(lo0, lo1);
  lh = hdif(lo0, lo1);
  hl = hsum(hi0, hi1);
  hh = hdif(hi0, hi1);
}

// Its inverse: the block q[row][col] from ll, lh, hl, hh
__device__ __forceinline__ void unbutterfly(float ll, float lh, float hl,
                                            float hh, float (&q)[2][2]) {
  const float lo_e = hsum(ll, lh), lo_o = hdif(ll, lh);  // columns
  const float hi_e = hsum(hl, hh), hi_o = hdif(hl, hh);
  q[0][0] = hsum(lo_e, hi_e);                            // rows
  q[1][0] = hdif(lo_e, hi_e);
  q[0][1] = hsum(lo_o, hi_o);
  q[1][1] = hdif(lo_o, hi_o);
}

// The forward levels of the patch rows a (y0) and b (y0+1).
template <int L, int U>
__device__ __forceinline__ Coeffs<L, U> forward(const Patch& p,
                                                const float (&a)[U],
                                                const float (&b)[U]) {
  Coeffs<L, U> k;
  float ll0[U / 2];
#pragma unroll
  for (int e = 0; e < U / 2; ++e)
    butterfly(a[2 * e], a[2 * e + 1], b[2 * e], b[2 * e + 1], ll0[e],
              k.d0[0][e], k.d0[1][e], k.d0[2][e]);
  if constexpr (L == 1) {
#pragma unroll
    for (int e = 0; e < U / 2; ++e) k.ll[e] = ll0[e];
  } else {
    float ll = ll0[0];
#pragma unroll
    for (int lv = 1; lv < L; ++lv) {
      const Block<L, U> bl = block_of<L, U>(p, lv);
      float q[2][2];
      if (U == 4 && lv == 1) {  // this lane holds its row's two columns
        const float o0 = __shfl_xor_sync(kAll, ll0[0], bl.rmask);
        const float o1 = __shfl_xor_sync(kAll, ll0[U / 2 - 1], bl.rmask);
        q[bl.rb][0] = ll0[0];
        q[bl.rb][1] = ll0[U / 2 - 1];
        q[bl.rb ^ 1][0] = o0;
        q[bl.rb ^ 1][1] = o1;
      } else {
        const float xr = __shfl_xor_sync(kAll, ll, bl.rmask);
        const float xc = __shfl_xor_sync(kAll, ll, bl.cmask);
        const float xrc = __shfl_xor_sync(kAll, ll, bl.rmask | bl.cmask);
        q[bl.rb][bl.cb] = ll;
        q[bl.rb][bl.cb ^ 1] = xc;
        q[bl.rb ^ 1][bl.cb] = xr;
        q[bl.rb ^ 1][bl.cb ^ 1] = xrc;
      }
      butterfly(q[0][0], q[0][1], q[1][0], q[1][1], ll, k.d[lv][0][0],
                k.d[lv][1][0], k.d[lv][2][0]);
    }
    k.ll[0] = ll;
  }
  return k;
}

// The inverse levels: the patch rows a, b from all of its coefficients.
template <int L, int U>
__device__ __forceinline__ void inverse(const Patch& p, const Coeffs<L, U>& k,
                                        float (&a)[U], float (&b)[U]) {
  float ll0[U / 2];
  if constexpr (L == 1) {
#pragma unroll
    for (int e = 0; e < U / 2; ++e) ll0[e] = k.ll[e];
  } else {
    float ll = k.ll[0];
#pragma unroll
    for (int lv = L - 1; lv >= 1; --lv) {
      const Block<L, U> bl = block_of<L, U>(p, lv);
      float q[2][2];
      unbutterfly(ll, k.d[lv][0][0], k.d[lv][1][0], k.d[lv][2][0], q);
      if (U == 4 && lv == 1) {
        ll0[0] = q[bl.rb][0];
        ll0[U / 2 - 1] = q[bl.rb][1];
      } else {
        ll = q[bl.rb][bl.cb];
      }
    }
    if (U == 2) ll0[0] = ll;
  }
#pragma unroll
  for (int e = 0; e < U / 2; ++e) {
    float q[2][2];
    unbutterfly(ll0[e], k.d0[0][e], k.d0[1][e], k.d0[2][e], q);
    a[2 * e] = q[0][0];
    a[2 * e + 1] = q[0][1];
    b[2 * e] = q[1][0];
    b[2 * e + 1] = q[1][1];
  }
}

// Visits every packed coefficient of the thread's blocks once, as
// f(level, quadrant 0..2 = lh, hl, hh or 3 = ll, plane offset, value ref).
// For store, `primary` selects the one lane of a block's holders that
// writes each value; for loads every holder visits all.
template <int L, int U, bool kPrimary, typename F, typename K>
__device__ __forceinline__ void visit(const Patch& p, int H, int W, K& k, F f) {
  {  // level 0: U/2 values a quadrant
    const Quads o = quads(0, p.r0, p.c0, H, W);
    f(0, 0, o.lh, k.d0[0]);
    f(0, 1, o.hl, k.d0[1]);
    f(0, 2, o.hh, k.d0[2]);
    if constexpr (L == 1) f(0, 3, o.ll, k.ll);
  }
#pragma unroll
  for (int lv = 1; lv < L; ++lv) {
    const Quads o = quads(lv, p.r0 >> lv, p.c0 >> lv, H, W);
    const Block<L, U> bl = block_of<L, U>(p, lv);
    // lower bits of the own position that duplicate holders differ in
    const int low = (lv >= 2 ? (p.r0 & ((1 << (lv - 1)) - 1)) |
                                   (p.c0 & ((1 << (lv - 1)) - 1))
                             : 0);
    // who writes what: quadrant (rb, cb) of the block; at lv = 1 with
    // U = 4, row 0 writes lh (and ll), row 1 hl and hh
    const bool one_col = U == 4 && lv == 1;
    const bool w_ll = bl.rb == 0 && (one_col || bl.cb == 0);
    const bool w_lh = bl.rb == 0 && (one_col || bl.cb == 1);
    const bool w_hl = bl.rb == 1 && (one_col || bl.cb == 0);
    const bool w_hh = bl.rb == 1 && (one_col || bl.cb == 1);
    const bool mine = !kPrimary || (p.active && low == 0);
    if (mine && (!kPrimary || w_lh)) f(lv, 0, o.lh, k.d[lv][0]);
    if (mine && (!kPrimary || w_hl)) f(lv, 1, o.hl, k.d[lv][1]);
    if (mine && (!kPrimary || w_hh)) f(lv, 2, o.hh, k.d[lv][2]);
    if (lv == L - 1 && mine && (!kPrimary || w_ll)) f(lv, 3, o.ll, k.ll);
  }
}

template <int L, int U>
__global__ void haar_dwt2_fwd(const float* __restrict__ x, float* __restrict__ y,
                              int planes, int H, int W) {
  const Patch p = patch_of<L, U>(planes, H, W);
  const float* xp = x + (int64_t)p.plane * H * W;
  float* yp = y + (int64_t)p.plane * H * W;
  float a[U], b[U];
  load(a, xp + p.y0 * W + p.x0);
  load(b, xp + (p.y0 + 1) * W + p.x0);
  Coeffs<L, U> k = forward<L, U>(p, a, b);
  if (!p.active) return;  // after the exchanges
  visit<L, U, true>(p, H, W, k, [&](int, int, int off, auto& v) {
    store(yp + off, v);
  });
}

template <int L, int U>
__global__ void haar_dwt2_inv(const float* __restrict__ x, float* __restrict__ y,
                              int planes, int H, int W) {
  const Patch p = patch_of<L, U>(planes, H, W);
  if (!p.active) return;  // the inverse exchanges nothing
  const float* xp = x + (int64_t)p.plane * H * W;
  float* yp = y + (int64_t)p.plane * H * W;
  Coeffs<L, U> k;
  visit<L, U, false>(p, H, W, k, [&](int, int, int off, auto& v) {
    load(v, xp + off);
  });
  float a[U], b[U];
  inverse<L, U>(p, k, a, b);
  store(yp + p.y0 * W + p.x0, a);
  store(yp + (p.y0 + 1) * W + p.x0, b);
}

// y = s2*v + mask * W^-1(theta * W v), or W^-1(theta * W v) without a mask.
// theta's and the mask's planes repeat every theta_planes / mask_planes
// planes of v.
template <int L, int U>
__global__ void haar_dwt2_matvec(const float* __restrict__ v,
                                 const float* __restrict__ theta,
                                 const float* __restrict__ mask, float s2,
                                 float* __restrict__ y, int planes, int H,
                                 int W, int theta_planes, int mask_planes) {
  const Patch p = patch_of<L, U>(planes, H, W);
  const int64_t hw = (int64_t)H * W;
  const float* vp = v + (int64_t)p.plane * hw;
  const float* tp = theta + (int64_t)(p.plane % theta_planes) * hw;
  const float* mp =
      mask ? mask + (int64_t)(p.plane % mask_planes) * hw : nullptr;
  const int row0 = p.y0 * W + p.x0, row1 = row0 + W;
  // every load first, so that their latencies overlap
  float a[U], b[U], ma[U], mb[U];
  load(a, vp + row0);
  load(b, vp + row1);
  if (mp) {
    load(ma, mp + row0);
    load(mb, mp + row1);
  }
  Coeffs<L, U> t;
  visit<L, U, false>(p, H, W, t, [&](int, int, int off, auto& d) {
    load(d, tp + off);
  });
  Coeffs<L, U> k = forward<L, U>(p, a, b);
  if (!p.active) return;  // after the exchanges
  // theta * W v, value by value as visit pairs them
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < U / 2; ++e) k.d0[q][e] = __fmul_rn(t.d0[q][e], k.d0[q][e]);
#pragma unroll
  for (int lv = 1; lv < L; ++lv)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      k.d[lv][q][0] = __fmul_rn(t.d[lv][q][0], k.d[lv][q][0]);
#pragma unroll
  for (int e = 0; e < Coeffs<L, U>::NLL; ++e) k.ll[e] = __fmul_rn(t.ll[e], k.ll[e]);
  float wa[U], wb[U];
  inverse<L, U>(p, k, wa, wb);
  if (mp) {
#pragma unroll
    for (int e = 0; e < U; ++e) {
      wa[e] = __fadd_rn(__fmul_rn(s2, a[e]), __fmul_rn(ma[e], wa[e]));
      wb[e] = __fadd_rn(__fmul_rn(s2, b[e]), __fmul_rn(mb[e], wb[e]));
    }
  }
  float* yp = y + (int64_t)p.plane * hw;
  store(yp + row0, wa);
  store(yp + row1, wb);
}

// The grid of a launch with `threads` a CTA and patches of U floats, or
// false where the kernel cannot take it. ops.dwt.launch_config and
// launch_shape mirror this.
bool launch_dims(int64_t planes, int H, int W, int level, int threads, int U,
                 const void* const* ptrs, int n_ptrs, unsigned* blocks) {
  const int S = 1 << level;
  if (level < 1 || level > 3 || planes <= 0 || H <= 0 || W <= 0 ||
      (int64_t)H * W > INT32_MAX || H % S || W % S || (U != 2 && U != 4) ||
      W % U || threads < 32 || threads > 1024 || threads % 32)
    return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (ptrs[i] && (uintptr_t)ptrs[i] % (4 * U)) return false;
  const int64_t patches = planes * H * (int64_t)W / (2 * U);
  const int64_t n = (patches + threads - 1) / threads;
  if (n * threads > INT32_MAX) return false;  // patch_of's 32-bit indices
  *blocks = (unsigned)n;
  return true;
}

template <int L, int U>
cudaError_t launch_transform(const float* x, float* y, int planes, int H,
                             int W, int inverse, unsigned blocks, int threads,
                             cudaStream_t s) {
  if (inverse)
    haar_dwt2_inv<L, U><<<blocks, threads, 0, s>>>(x, y, planes, H, W);
  else
    haar_dwt2_fwd<L, U><<<blocks, threads, 0, s>>>(x, y, planes, H, W);
  return cudaGetLastError();
}

template <int L, int U>
cudaError_t launch_matvec(const float* v, const float* theta, const float* mask,
                          float s2, float* y, int planes, int H, int W,
                          int theta_planes, int mask_planes, unsigned blocks,
                          int threads, cudaStream_t s) {
  haar_dwt2_matvec<L, U><<<blocks, threads, 0, s>>>(
      v, theta, mask, s2, y, planes, H, W, theta_planes, mask_planes);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Tensors are contiguous float32
// [planes, H, W] buffers on the current device, the output distinct from
// every input; H and W divisible by 2^level, level in 1..3; the launch is
// (threads a CTA, U) from ops.dwt.launch_config, checked here with the
// pointers' alignment (4 * U bytes). Each launches on `stream` and returns
// the launch's cudaGetLastError() (0 on success) without synchronising, or
// cudaErrorInvalidValue for arguments it cannot take.

#define HAAR_DISPATCH(FN, ...)                                           \
  switch (level * 10 + vec) {                                            \
    case 12: return (int)FN<1, 2>(__VA_ARGS__);                          \
    case 14: return (int)FN<1, 4>(__VA_ARGS__);                          \
    case 22: return (int)FN<2, 2>(__VA_ARGS__);                          \
    case 24: return (int)FN<2, 4>(__VA_ARGS__);                          \
    case 32: return (int)FN<3, 2>(__VA_ARGS__);                          \
    default: return (int)FN<3, 4>(__VA_ARGS__);                          \
  }

extern "C" int haar_dwt2_f32(const float* x, float* y, int64_t planes, int H,
                             int W, int level, int inverse, int threads,
                             int vec, void* stream) {
  unsigned blocks;
  const void* ptrs[2] = {x, y};
  if (!x || !y || x == y ||
      !launch_dims(planes, H, W, level, threads, vec, ptrs, 2, &blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  HAAR_DISPATCH(launch_transform, x, y, (int)planes, H, W, inverse, blocks,
                threads, s)
}

// y = s2*v + mask * W^-1(theta * W v); mask == nullptr gives
// W^-1(theta * W v) (s2 unused). theta and mask hold theta_planes and
// mask_planes planes, which repeat over v's planes (planes a multiple of
// each).
extern "C" int haar_ot_matvec_f32(const float* v, const float* theta,
                                  const float* mask, float s2, float* y,
                                  int64_t planes, int H, int W, int level,
                                  int theta_planes, int mask_planes,
                                  int threads, int vec, void* stream) {
  unsigned blocks;
  const void* ptrs[4] = {v, theta, mask, y};
  if (!v || !theta || !y || y == v || y == theta || y == mask ||
      theta_planes <= 0 || planes % theta_planes ||
      (mask && (mask_planes <= 0 || planes % mask_planes)) ||
      !launch_dims(planes, H, W, level, threads, vec, ptrs, 4, &blocks))
    return (int)cudaErrorInvalidValue;
  if (!mask) mask_planes = 1;
  cudaStream_t s = (cudaStream_t)stream;
  HAAR_DISPATCH(launch_matvec, v, theta, mask, s2, y, (int)planes, H, W,
                theta_planes, mask_planes, blocks, threads, s)
}
