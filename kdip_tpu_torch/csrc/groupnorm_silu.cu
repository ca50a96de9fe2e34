// GroupNorm with float32 statistics, an optional FiLM scale and shift and an
// optional SiLU, forward and backward, NCHW (any [B, C, *]) in bf16, fp16 or
// float32: the GroupNorm32 sites of the ADM torso
// (kdip_tpu_torch/models/layers.py: GroupNorm32).
//
// Replaces no Pallas kernel: kdip_tpu leaves its `_FusedGroupNorm`
// (kdip_tpu/models/layers.py:40-47) to XLA, which fuses the statistics, the
// affine, the FiLM terms and the SiLU into the neighbouring ops. Eager
// PyTorch runs the same function as ~20 aten ops forward and ~37 backward a
// site, each reading and writing the whole activation; these kernels are
// that fusion written by hand. The plain version, which holds every rounding
// named below, is kdip_tpu_torch/ops/groupnorm.py.
//
// Four entry points, one launch each:
//   groupnorm_fwd        y = silu(rnd(rnd(rnd(x*a + b) * rnd(1 + s)) + t))
//                        (the FiLM terms and the SiLU each optional), and
//                        the (mean, raw variance) of each (sample, group);
//   groupnorm_stats_fwd  only (a, b) [B, C] float32 and the statistics: the
//                        affine that the Winograd kernel's prologue takes;
//   groupnorm_bwd        gx from gy (float32 inside, rounded once), and the
//                        per-(sample, channel) sums that give the gradients
//                        of gamma, beta, s and t;
//   groupnorm_stats_bwd  gx = c1*x + c2 per (sample, group) from the
//                        gradients of a and b.
// Here a = gamma * rstd and b = beta - mean * a per (sample, channel); the
// statistics are one pass of sum and sum of squares in float32, the variance
// m2 - m^2 clamped at 0, rstd = rsqrt(var + eps) (rsqrtf, as PyTorch's rsqrt
// on the card). rnd() rounds to the input's type, as each eager op of the
// direct path does; the affine is a float32 multiply and add without FMA,
// SiLU is float32 x / (1 + exp(-x)) (exp and the division the hardware's
// approximations for a 16-bit result, below).
//
// Bound on an H100 SXM (700 W): bytes. A site does a few flops an element
// against the ~295 flop/B at which the tensor cores would bind, so the least
// time is the bytes the function needs at 3.35 TB/s: x read and y written
// (4 B an element in bf16), x and gy read and gx written backward (6 B), x
// read for the statistics alone (2 B). Eager PyTorch moves 54-122 B an
// element a site; the statistics need the whole (sample, group) slab before
// the first output, which is what makes a one-pass kernel hard.
//
// Design. A (sample, group) slab is spread over a thread-block cluster of
// up to 8 CTAs (the host picks the cluster size; ops/groupnorm.py:
// launch_plan), each over one range of positions of every channel of the
// group. Pass one reads the CTA's range once and sums, keeping what fits of
// it in shared memory: x in the forward (up to 104 KB, two CTAs an SM), x
// and its float32 gu in the backward (up to 200 KB, one CTA of 1024
// threads an SM; gu in 16-byte planes, free of bank conflicts). The CTAs'
// partial sums meet through distributed shared memory after a cluster
// barrier, each CTA adding them in rank order, so every CTA holds the same
// totals. Pass two writes y (or gx) from shared memory, and re-reads from
// device memory (much of it still in the 50 MB L2) only the part that did
// not fit. So a slab that fits its cluster costs the bytes above; a larger
// one reads its overflow twice. Loads and stores are 16 bytes a thread
// where a channel's positions allow it; warps take whole channels, or share
// one where the group has fewer channels than the CTA has warps; a 16-bit
// pair rounds in one paired conversion. No CTA leaves while another can
// still read its shared memory. Sums are taken in a fixed order: the result
// does not change from run to run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxThreads = 512;       // the forward's and the statistics'
constexpr int kMaxThreadsBwd = 1024;   // the full backward's
constexpr int kMaxWarps = kMaxThreadsBwd / 32;
constexpr int kUnroll = 4;        // 16-byte loads in flight a thread
constexpr int kMaxCpg = 64;       // channels a group: C <= 64 * groups

// What a launch covers: x is [B, C, HW], C = groups * cpg; a CTA of a
// cluster takes positions [rank * span, rank * span + span) of each of its
// group's channels; `cap` packs of each cached tensor fit its shared memory.
struct Geometry {
  int C, groups, cpg, HW, span, cap;
  float eps;
};

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// Rounding to T (and back to float) and stores of rounded values, one or
// two at a time: a pair of 16-bit values is one paired conversion.
template <typename T>
struct Round;
template <>
struct Round<float> {
  __device__ __forceinline__ static void one(float&) {}
  __device__ __forceinline__ static void two(float&, float&) {}
  __device__ __forceinline__ static void store(float* d, float a) { d[0] = a; }
  __device__ __forceinline__ static void store2(float* d, float a, float b) {
    d[0] = a;
    d[1] = b;
  }
};
template <>
struct Round<__nv_bfloat16> {
  __device__ __forceinline__ static void one(float& a) {
    a = __bfloat162float(__float2bfloat16_rn(a));
  }
  __device__ __forceinline__ static void two(float& a, float& b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    a = __low2float(h);
    b = __high2float(h);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* d, float a) {
    d[0] = __float2bfloat16_rn(a);
  }
  __device__ __forceinline__ static void store2(__nv_bfloat16* d, float a,
                                                float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    d[0] = h.x;
    d[1] = h.y;
  }
};
template <>
struct Round<__half> {
  __device__ __forceinline__ static void one(float& a) {
    a = __half2float(__float2half_rn(a));
  }
  __device__ __forceinline__ static void two(float& a, float& b) {
    const __half2 h = __floats2half2_rn(a, b);
    a = __low2float(h);
    b = __high2float(h);
  }
  __device__ __forceinline__ static void store(__half* d, float a) {
    d[0] = __float2half_rn(a);
  }
  __device__ __forceinline__ static void store2(__half* d, float a, float b) {
    const __half2 h = __floats2half2_rn(a, b);
    d[0] = h.x;
    d[1] = h.y;
  }
};

// elements handled together: pairs of a 16-bit T in 16-byte packs
template <typename T, int V>
constexpr int kStep = V % 2 == 0 && sizeof(T) == 2 ? 2 : 1;

// v[0..S) rounded to T, and stored rounded at d[0..S)
template <typename T, int S>
__device__ __forceinline__ void rnd_n(float* v) {
  if constexpr (S == 2) Round<T>::two(v[0], v[1]);
  else Round<T>::one(v[0]);
}
template <typename T, int S>
__device__ __forceinline__ void store_n(T* d, const float* v) {
  if constexpr (S == 2) Round<T>::store2(d, v[0], v[1]);
  else Round<T>::store(d, v[0]);
}

// v rounded to T and back
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  Round<T>::one(v);
  return v;
}

// V elements of T, loaded and stored as one piece (16 bytes where V > 1)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sums of v[0..N) into out[0..N), in a fixed order: the warps'
// sums through `scratch` [kMaxWarps * N], then warp by warp. Every thread
// calls it; out is written by threads 0..N-1 and is visible after the next
// __syncthreads (or cluster barrier).
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch,
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[warp * N + i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float acc = 0.f;
    const int warps = blockDim.x >> 5;
    for (int w = 0; w < warps; ++w) acc += scratch[w * N + threadIdx.x];
    out[threadIdx.x] = acc;
  }
}

// rstd from the raw variance, as PyTorch's rsqrt on the card computes it
__device__ __forceinline__ float rstd_of(float var, float eps) {
  return rsqrtf(__fadd_rn(fmaxf(var, 0.f), eps));
}

// the affine of channel c of sample n: a = gamma * rstd, b = beta - mean * a
struct Affine {
  float a, b, sp1, t;  // sp1 = rnd(1 + s), t: the FiLM terms, where given
};

template <typename T>
__device__ __forceinline__ Affine affine_of(
    const float* gamma, const float* beta, const T* s, const T* t, int n,
    int C, int ch, float mean, float rstd) {
  Affine f;
  f.a = __fmul_rn(rstd, gamma[ch]);
  f.b = __fsub_rn(beta[ch], __fmul_rn(mean, f.a));
  f.sp1 = 1.f;
  f.t = 0.f;
  if (s != nullptr) {
    f.sp1 = rnd<T>(__fadd_rn(1.f, to_f<T>(s[(size_t)n * C + ch])));
    f.t = to_f<T>(t[(size_t)n * C + ch]);
  }
  return f;
}

// the forward's values before the SiLU of S elements: u = rnd(x*a + b),
// then w = rnd(rnd(u * sp1) + t) with the FiLM terms, else w = u
template <typename T, int S>
__device__ __forceinline__ void pre_act(const float* x, const Affine& f,
                                        bool film, float* u, float* w) {
#pragma unroll
  for (int i = 0; i < S; ++i) u[i] = __fadd_rn(__fmul_rn(x[i], f.a), f.b);
  rnd_n<T, S>(u);
#pragma unroll
  for (int i = 0; i < S; ++i) w[i] = u[i];
  if (film) {
#pragma unroll
    for (int i = 0; i < S; ++i) w[i] = __fmul_rn(w[i], f.sp1);
    rnd_n<T, S>(w);
#pragma unroll
    for (int i = 0; i < S; ++i) w[i] = __fadd_rn(w[i], f.t);
    rnd_n<T, S>(w);
  }
}

// SiLU and its derivative in float32, as PyTorch computes them: w / (1 +
// exp(-w)) and s (1 + w (1 - s)) with s = 1 / (1 + exp(-w)). For a 16-bit
// result exp and the division are the hardware's approximations (relative
// error under 2e-6 for |w| < 10), which move a rounded output only where its
// float32 value lies that close to a rounding boundary (about one output in
// a thousand, at most one ulp); a float32 result keeps expf and the IEEE
// division.
template <typename T>
__device__ __forceinline__ float divide(float a, float b) {
  return std::is_same<T, float>::value ? a / b : __fdividef(a, b);
}

template <typename T>
__device__ __forceinline__ float exp_f(float a) {
  return std::is_same<T, float>::value ? expf(a) : __expf(a);
}

template <typename T>
__device__ __forceinline__ float silu_f(float w) {
  return divide<T>(w, 1.f + exp_f<T>(-w));
}

template <typename T>
__device__ __forceinline__ float dsilu_f(float w) {
  const float sig = divide<T>(1.f, 1.f + exp_f<T>(-w));
  return sig * (1.f + w * (1.f - sig));
}

// Shared memory ahead of the caches, in floats: this CTA's partial sums
// [kMaxCpg][4], the cluster's totals [kMaxCpg][4], the warps' sums or
// block_sum's scratch, and a few statistics.
constexpr int kPartFloats = kMaxCpg * 4;
constexpr int kScratchFloats = kMaxWarps * 4;
static_assert(kPartFloats >= 2 * kScratchFloats, "scratch fits");
constexpr int kHeadBytes =
    (3 * kPartFloats + 8) * (int)sizeof(float) + kMaxCpg * 16;  // + Affine
static_assert(kHeadBytes % 32 == 0, "the caches start 32-byte aligned");

// ---------------------------------------------------------------------------
// How a CTA's threads share its range: each warp takes whole channels of the
// group, or, where the group has fewer channels than the CTA has warps,
// `wpc` warps share a channel, lane-interleaved 16-byte packs, so that the
// channels of a small image run side by side rather than one after another.
// ---------------------------------------------------------------------------

struct Lanes {
  int wpc, sub, c0, cstep, lane;
  __device__ __forceinline__ explicit Lanes(int cpg) {
    const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
    wpc = max(1, warps / cpg);  // warps a channel
    c0 = warp / wpc;            // the warp's first channel
    sub = warp % wpc;           // its place among the channel's warps
    cstep = warps / wpc;        // channels between its successive channels
    lane = threadIdx.x & 31;
  }
  __device__ __forceinline__ int first() const { return sub * 32 + lane; }
  __device__ __forceinline__ int stride() const { return 32 * wpc; }
};

// The sum over the cluster's ranks, in rank order, of element i of `part`
// in each CTA's shared memory; the K reads are issued together.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* part, int i, int K) {
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    v[q] = q < K ? cluster.map_shared_rank(part, q)[i] : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < K) acc += v[q];
  return acc;
}

// ---------------------------------------------------------------------------
// Forward: the statistics, then (APPLY) y, else (a, b)
// ---------------------------------------------------------------------------

template <typename T, int V, bool APPLY>
__global__ void __launch_bounds__(kMaxThreads, 2)
    groupnorm_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const T* __restrict__ s, const T* __restrict__ t,
                         T* __restrict__ y, float* __restrict__ a_out,
                         float* __restrict__ b_out,
                         float* __restrict__ stats, Geometry geo, int silu) {
  using P = Pack<T, V>;
  constexpr int S = kStep<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);  // [2] this CTA's sums
  float* scratch = part + 2 * kPartFloats;
  float* st = scratch + 2 * kScratchFloats;      // mean, rstd
  Affine* tab = reinterpret_cast<Affine*>(part + 3 * kPartFloats + 8);
  P* cache = reinterpret_cast<P*>(smem + kHeadBytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int slab = blockIdx.y;  // n * groups + g
  const int n = slab / geo.groups, g = slab % geo.groups;
  const int lo = rank * geo.span;
  const int len = max(0, min(geo.HW, lo + geo.span) - lo);
  const int nv = len / V, slot = geo.span / V;
  const size_t base = ((size_t)n * geo.C + (size_t)g * geo.cpg) * geo.HW + lo;
  const Lanes ln(geo.cpg);
  const int stride = ln.stride();

  // pass one: sum and sum of squares, keeping what fits in the cache
  float acc[2] = {0.f, 0.f};
  for (int c = ln.c0; c < geo.cpg; c += ln.cstep) {
    const P* xc = reinterpret_cast<const P*>(x + base + (size_t)c * geo.HW);
    for (int j0 = ln.first(); j0 < nv; j0 += stride * kUnroll) {
      P buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * stride;
        if (j < nv) buf[u] = xc[j];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * stride;
        if (j < nv) {
          if (APPLY && c * slot + j < geo.cap) cache[c * slot + j] = buf[u];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float v = to_f<T>(buf[u].v[e]);
            acc[0] += v;
            acc[1] += v * v;
          }
        }
      }
    }
  }
  block_sum<2>(acc, scratch, part);
  cluster_arrive();
  cluster_wait();  // every CTA's partial sums are complete
  if (threadIdx.x < 2) scratch[threadIdx.x] = cluster_sum(cluster, part,
                                                          threadIdx.x, K);
  __syncthreads();
  if (threadIdx.x == 0) {
    const float s1 = scratch[0], s2 = scratch[1];
    const float N = (float)geo.cpg * (float)geo.HW;
    const float mean = __fdiv_rn(s1, N), m2 = __fdiv_rn(s2, N);
    const float var = __fsub_rn(m2, __fmul_rn(mean, mean));
    st[0] = mean;
    st[1] = rstd_of(var, geo.eps);
    if (rank == 0) {
      stats[2 * slab] = mean;
      stats[2 * slab + 1] = var;
    }
  }
  cluster_arrive();  // this CTA has read the others' sums
  __syncthreads();
  const float mean = st[0], rstd = st[1];

  if (!APPLY) {
    if (rank == 0) {
      for (int c = threadIdx.x; c < geo.cpg; c += blockDim.x) {
        const int ch = g * geo.cpg + c;
        const Affine f = affine_of<T>(gamma, beta, nullptr, nullptr, n,
                                      geo.C, ch, mean, rstd);
        a_out[(size_t)n * geo.C + ch] = f.a;
        b_out[(size_t)n * geo.C + ch] = f.b;
      }
    }
  } else {
    // pass two: y from the cache, or from device memory past it
    const bool film = s != nullptr;
    for (int c = threadIdx.x; c < geo.cpg; c += blockDim.x)
      tab[c] = affine_of<T>(gamma, beta, s, t, n, geo.C, g * geo.cpg + c,
                            mean, rstd);
    __syncthreads();
    for (int c = ln.c0; c < geo.cpg; c += ln.cstep) {
      const Affine f = tab[c];
      const P* xc = reinterpret_cast<const P*>(x + base + (size_t)c * geo.HW);
      P* yc = reinterpret_cast<P*>(y + base + (size_t)c * geo.HW);
      for (int j0 = ln.first(); j0 < nv; j0 += stride * kUnroll) {
        P buf[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * stride;
          if (j < nv)
            buf[u] = c * slot + j < geo.cap ? cache[c * slot + j] : xc[j];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = j0 + u * stride;
          if (j < nv) {
            P out;
#pragma unroll
            for (int e = 0; e < V; e += S) {
              float xv[S], uu[S], w[S];
#pragma unroll
              for (int i = 0; i < S; ++i) xv[i] = to_f<T>(buf[u].v[e + i]);
              pre_act<T, S>(xv, f, film, uu, w);
#pragma unroll
              for (int i = 0; i < S; ++i)
                if (silu) w[i] = silu_f<T>(w[i]);
              store_n<T, S>(&out.v[e], w);
            }
            yc[j] = out;
          }
        }
      }
    }
  }
  cluster_wait();  // no CTA of the cluster still reads this one's sums
}

// ---------------------------------------------------------------------------
// Backward of the full site
// ---------------------------------------------------------------------------

// c1, c2 of gx = ... + c1 * x + c2 from the per-channel sums of the gradients
// of a and b (ga[c], gb[c] at stride `step`): the statistics' backward.
// gr = sum_c gamma_c (ga_c - mean gb_c), gm = -sum_c gb_c a_c, then through
// rstd = (clamp(var, 0) + eps)^-1/2, var = m2 - mean^2. Every thread calls
// it: threads c < cpg form channel c's terms in `terms` [2 * kMaxCpg], then
// thread 0 adds them in channel order into c12; visible after the next
// __syncthreads.
__device__ __forceinline__ void stats_grad(const float* ga, const float* gb,
                                           int step, const float* gamma,
                                           int cpg, int HW, float mean,
                                           float var, float rstd,
                                           float* terms, float* c12) {
  for (int c = threadIdx.x; c < cpg; c += blockDim.x) {
    const float gam = gamma[c];
    terms[2 * c] = gam * (ga[c * step] - mean * gb[c * step]);
    terms[2 * c + 1] = gb[c * step] * __fmul_rn(rstd, gam);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float gr = 0.f, gm = 0.f;
    for (int c = 0; c < cpg; ++c) {
      gr += terms[2 * c];
      gm -= terms[2 * c + 1];
    }
    const float gvar = var >= 0.f ? -0.5f * gr * rstd * rstd * rstd : 0.f;
    const float N = (float)cpg * (float)HW;
    c12[0] = 2.f * gvar / N;
    c12[1] = (gm - 2.f * mean * gvar) / N;
  }
}


// gu of S elements: the gradient at the affine's output u = rnd(x*a + b),
// through the FiLM terms and the SiLU; u[] = u, gw[] the gradient at the
// SiLU's input
template <typename T, int S>
__device__ __forceinline__ void grad_u(const float* xv, const float* gy,
                                       const Affine& f, bool film, bool silu,
                                       float* u, float* gw, float* gu) {
  float w[S];
  pre_act<T, S>(xv, f, film, u, w);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    gw[i] = silu ? gy[i] * dsilu_f<T>(w[i]) : gy[i];
    gu[i] = gw[i] * f.sp1;
  }
}

template <typename T, int V, int THREADS>
__global__ void __launch_bounds__(THREADS)
    groupnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         const T* __restrict__ s, const T* __restrict__ t,
                         const float* __restrict__ stats,
                         T* __restrict__ gx, float* __restrict__ sums,
                         int B, Geometry geo, int silu) {
  using P = Pack<T, V>;
  constexpr int S = kStep<T, V>;
  using Q = Pack<float, V>;  // gu of a pack
  // the cache keeps gu in planes of 16-byte pieces, so that a warp's stores
  // and loads of a pack's gu meet no bank conflicts
  constexpr int NP = V >= 4 ? V / 4 : 1, W = V / NP;
  using Piece = Pack<float, W>;
  constexpr int U = THREADS > 512 ? 1 : 2;  // packs in flight a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);  // [cpg][4] this CTA's sums
  float* total = part + kPartFloats;             // [cpg][4] the cluster's
  float* wsum = total + kPartFloats;  // [cpg * wpc][4] (<= kPartFloats)
  float* st = wsum + kPartFloats;     // c1, c2
  Affine* tab = reinterpret_cast<Affine*>(st + 8);
  Piece* gucache = reinterpret_cast<Piece*>(smem + kHeadBytes);  // [NP][cap]
  P* xcache = reinterpret_cast<P*>(gucache + NP * geo.cap);

  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int slab = blockIdx.y;
  const int n = slab / geo.groups, g = slab % geo.groups;
  const int lo = rank * geo.span;
  const int len = max(0, min(geo.HW, lo + geo.span) - lo);
  const int nv = len / V, slot = geo.span / V;
  const size_t base = ((size_t)n * geo.C + (size_t)g * geo.cpg) * geo.HW + lo;
  const Lanes ln(geo.cpg);
  const int stride = ln.stride();
  const bool film = s != nullptr;
  const float mean = stats[2 * slab], var = stats[2 * slab + 1];
  const float rstd = rstd_of(var, geo.eps);
  for (int c = threadIdx.x; c < geo.cpg; c += blockDim.x)
    tab[c] = affine_of<T>(gamma, beta, s, t, n, geo.C, g * geo.cpg + c, mean,
                          rstd);
  __syncthreads();

  // pass one: per channel, sum gu*x, gu and, where the sums are asked for,
  // gw and gw*u; keep x and gu of what fits in the cache. The next packs
  // load while these are computed.
  const bool all_sums = sums != nullptr;
  for (int c = ln.c0; c < geo.cpg; c += ln.cstep) {
    const Affine f = tab[c];
    const P* xc = reinterpret_cast<const P*>(x + base + (size_t)c * geo.HW);
    const P* gc = reinterpret_cast<const P*>(gy + base + (size_t)c * geo.HW);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    P xb[U], gb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = ln.first() + u * stride;
      if (j < nv) {
        xb[u] = xc[j];
        gb[u] = gc[j];
      }
    }
    for (int j0 = ln.first(); j0 < nv; j0 += stride * U) {
      P xn[U], gn[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + (U + u) * stride;
        if (j < nv) {
          xn[u] = xc[j];
          gn[u] = gc[j];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * stride;
        if (j < nv) {
          Q gq;
#pragma unroll
          for (int e = 0; e < V; e += S) {
            float xv[S], gv[S], uu[S], gw[S], gu[S];
#pragma unroll
            for (int i = 0; i < S; ++i) {
              xv[i] = to_f<T>(xb[u].v[e + i]);
              gv[i] = to_f<T>(gb[u].v[e + i]);
            }
            grad_u<T, S>(xv, gv, f, film, silu, uu, gw, gu);
#pragma unroll
            for (int i = 0; i < S; ++i) {
              gq.v[e + i] = gu[i];
              acc[0] += gu[i] * xv[i];
              acc[1] += gu[i];
              if (all_sums) {
                acc[2] += gw[i];
                acc[3] += gw[i] * uu[i];
              }
            }
          }
          const int q = c * slot + j;
          if (q < geo.cap) {
            xcache[q] = xb[u];
#pragma unroll
            for (int k = 0; k < NP; ++k) {
              Piece piece;
#pragma unroll
              for (int i = 0; i < W; ++i) piece.v[i] = gq.v[k * W + i];
              gucache[k * geo.cap + q] = piece;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        xb[u] = xn[u];
        gb[u] = gn[u];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = warp_sum(acc[k]);
    if (ln.lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wsum[(c * ln.wpc + ln.sub) * 4 + k] = acc[k];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < geo.cpg * 4; i += blockDim.x) {
    const int c = i >> 2, k = i & 3;
    float a = 0.f;
    for (int w = 0; w < ln.wpc; ++w) a += wsum[(c * ln.wpc + w) * 4 + k];
    part[i] = a;
  }
  cluster_arrive();
  cluster_wait();  // every CTA's per-channel sums are complete
  // the cluster's sums, rank by rank; rank 0 writes them out as [4][B][C]
  for (int i = threadIdx.x; i < geo.cpg * 4; i += blockDim.x)
    total[i] = cluster_sum(cluster, part, i, K);
  cluster_arrive();  // this CTA has read the others' sums
  __syncthreads();
  stats_grad(total, total + 1, 4, gamma + g * geo.cpg, geo.cpg, geo.HW, mean,
             var, rstd, wsum, st);
  if (rank == 0 && sums != nullptr) {
    const size_t plane = (size_t)B * geo.C;
    for (int i = threadIdx.x; i < geo.cpg * 4; i += blockDim.x) {
      const int c = i >> 2, k = i & 3;
      sums[k * plane + (size_t)n * geo.C + g * geo.cpg + c] = total[i];
    }
  }
  __syncthreads();
  const float c1 = st[0], c2 = st[1];

  // pass two: gx = gu * a + c1 * x + c2, gu from the cache or computed again
  for (int c = ln.c0; c < geo.cpg; c += ln.cstep) {
    const Affine f = tab[c];
    const P* xc = reinterpret_cast<const P*>(x + base + (size_t)c * geo.HW);
    const P* gc = reinterpret_cast<const P*>(gy + base + (size_t)c * geo.HW);
    P* oc = reinterpret_cast<P*>(gx + base + (size_t)c * geo.HW);
    for (int j0 = ln.first(); j0 < nv; j0 += stride * U) {
      P xb[U], gb[U];
      Q gq[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * stride;
        const int q = c * slot + j;
        if (j < nv) {
          if (q < geo.cap) {
            xb[u] = xcache[q];
#pragma unroll
            for (int k = 0; k < NP; ++k) {
              const Piece piece = gucache[k * geo.cap + q];
#pragma unroll
              for (int i = 0; i < W; ++i) gq[u].v[k * W + i] = piece.v[i];
            }
          } else {
            xb[u] = xc[j];
            gb[u] = gc[j];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * stride;
        if (j < nv) {
          const bool hit = c * slot + j < geo.cap;
          P out;
#pragma unroll
          for (int e = 0; e < V; e += S) {
            float xv[S], gv[S], uu[S], gw[S], gu[S], o[S];
#pragma unroll
            for (int i = 0; i < S; ++i) xv[i] = to_f<T>(xb[u].v[e + i]);
            if (hit) {
#pragma unroll
              for (int i = 0; i < S; ++i) gu[i] = gq[u].v[e + i];
            } else {
#pragma unroll
              for (int i = 0; i < S; ++i) gv[i] = to_f<T>(gb[u].v[e + i]);
              grad_u<T, S>(xv, gv, f, film, silu, uu, gw, gu);
            }
#pragma unroll
            for (int i = 0; i < S; ++i) o[i] = gu[i] * f.a + c1 * xv[i] + c2;
            store_n<T, S>(&out.v[e], o);
          }
          oc[j] = out;
        }
      }
    }
  }
  cluster_wait();  // no CTA of the cluster still reads this one's sums
}

// ---------------------------------------------------------------------------
// Backward of the statistics alone: gx = c1 * x + c2 per (sample, group)
// ---------------------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    groupnorm_stats_bwd_kernel(const T* __restrict__ x,
                               const float* __restrict__ ga,
                               const float* __restrict__ gb,
                               const float* __restrict__ gamma,
                               const float* __restrict__ stats,
                               T* __restrict__ gx, Geometry geo) {
  using P = Pack<T, V>;
  constexpr int S = kStep<T, V>;
  __shared__ float st[2], terms[2 * kMaxCpg];
  const int slab = blockIdx.y;
  const int n = slab / geo.groups, g = slab % geo.groups;
  const int lo = blockIdx.x * geo.span;
  const int len = max(0, min(geo.HW, lo + geo.span) - lo);
  const int nv = len / V;
  const size_t base = ((size_t)n * geo.C + (size_t)g * geo.cpg) * geo.HW + lo;
  const Lanes ln(geo.cpg);
  const int stride = ln.stride();
  {
    const float mean = stats[2 * slab], var = stats[2 * slab + 1];
    const size_t i = (size_t)n * geo.C + g * geo.cpg;
    stats_grad(ga + i, gb + i, 1, gamma + g * geo.cpg, geo.cpg, geo.HW, mean,
               var, rstd_of(var, geo.eps), terms, st);
  }
  __syncthreads();
  const float c1 = st[0], c2 = st[1];
  for (int c = ln.c0; c < geo.cpg; c += ln.cstep) {
    const P* xc = reinterpret_cast<const P*>(x + base + (size_t)c * geo.HW);
    P* oc = reinterpret_cast<P*>(gx + base + (size_t)c * geo.HW);
    for (int j0 = ln.first(); j0 < nv; j0 += stride * kUnroll) {
      P buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * stride;
        if (j < nv) buf[u] = xc[j];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * stride;
        if (j < nv) {
          P out;
#pragma unroll
          for (int e = 0; e < V; e += S) {
            float o[S];
#pragma unroll
            for (int i = 0; i < S; ++i)
              o[i] = c1 * to_f<T>(buf[u].v[e + i]) + c2;
            store_n<T, S>(&out.v[e], o);
          }
          oc[j] = out;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// The launch plan, which ops/groupnorm.py: launch_plan owns, as
// (cluster, span, cap, threads, vec). The kernels only hold it to their own
// limits; a cache larger than the card's shared memory fails at launch.
struct Plan {
  int cluster, span, cap, threads, vec;
};

bool plan_ok(const Plan& p, const Geometry& geo, int B, int elem,
             int max_threads) {
  return p.cluster >= 1 && p.cluster <= kMaxCluster && p.threads >= 32 &&
         p.threads <= max_threads && p.threads % 32 == 0 &&
         (p.vec == 1 || p.vec * elem == 16) && p.span >= p.vec &&
         p.span % p.vec == 0 && (int64_t)p.cluster * p.span >= geo.HW &&
         geo.HW % p.vec == 0 && p.cap >= 0 &&
         (int64_t)p.cap <= (int64_t)geo.cpg * (p.span / p.vec) &&
         geo.cpg >= 1 &&
         geo.cpg <= kMaxCpg && (int64_t)B * geo.groups <= 65535;
}

// Raises a kernel's dynamic shared memory limit to `smem` once per device
// and size, not at every launch.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  struct Entry {
    const void* kernel;
    int device;
    size_t smem;
  };
  static std::mutex lock;
  static Entry seen[256];
  static int n = 0;
  if (smem > (size_t)INT_MAX) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < n; ++i)
    if (seen[i].kernel == kernel && seen[i].device == device &&
        seen[i].smem >= smem)
      return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && n < 256) seen[n++] = Entry{kernel, device, smem};
  return err;
}

template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), const Plan& p,
                           int slabs, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, slabs, 1);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int V>
cudaError_t fwd_typed(const void* x, const float* gamma, const float* beta,
                      const void* s, const void* t, void* y, float* a_out,
                      float* b_out, float* stats, int B, Geometry geo,
                      int silu, const Plan& p, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(s);
  const T* tp = static_cast<const T*>(t);
  T* yp = static_cast<T*>(y);
  const bool apply = y != nullptr;
  const size_t smem =
      kHeadBytes + (apply ? (size_t)geo.cap * sizeof(Pack<T, V>) : 0);
  return launch_cluster(apply ? groupnorm_fwd_kernel<T, V, true>
                              : groupnorm_fwd_kernel<T, V, false>,
                        p, B * geo.groups, smem, stream, xp, gamma, beta, sp,
                        tp, yp, a_out, b_out, stats, geo, silu);
}

template <typename T, int V>
cudaError_t bwd_typed(const void* x, const void* gy, const float* gamma,
                      const float* beta, const void* s, const void* t,
                      const float* stats, void* gx, float* sums, int B,
                      Geometry geo, int silu, const Plan& p,
                      cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gy);
  const T* sp = static_cast<const T*>(s);
  const T* tp = static_cast<const T*>(t);
  T* op = static_cast<T*>(gx);
  const size_t smem =
      kHeadBytes + (size_t)geo.cap * (sizeof(Pack<T, V>) + sizeof(Pack<float, V>));
  return launch_cluster(p.threads > kMaxThreads
                            ? groupnorm_bwd_kernel<T, V, kMaxThreadsBwd>
                            : groupnorm_bwd_kernel<T, V, kMaxThreads>,
                        p, B * geo.groups, smem, stream, xp, gp, gamma, beta,
                        sp, tp, stats, op, sums, B, geo, silu);
}

template <typename T, int V>
cudaError_t stats_bwd_typed(const void* x, const float* ga, const float* gb,
                            const float* gamma, const float* stats, void* gx,
                            int B, Geometry geo, const Plan& p,
                            cudaStream_t stream) {
  groupnorm_stats_bwd_kernel<T, V>
      <<<dim3(p.cluster, B * geo.groups, 1), p.threads, 0, stream>>>(
          static_cast<const T*>(x), ga, gb, gamma, stats, static_cast<T*>(gx),
          geo);
  return cudaGetLastError();
}

// dtype codes: 0 bfloat16, 1 float16, 2 float32
#define GN_DISPATCH(FN, ...)                                                \
  do {                                                                      \
    const bool vec = p.vec > 1;                                             \
    switch (dtype) {                                                        \
      case 0:                                                               \
        return (int)(vec ? FN<__nv_bfloat16, 8>(__VA_ARGS__)                \
                         : FN<__nv_bfloat16, 1>(__VA_ARGS__));              \
      case 1:                                                               \
        return (int)(vec ? FN<__half, 8>(__VA_ARGS__)                       \
                         : FN<__half, 1>(__VA_ARGS__));                     \
      case 2:                                                               \
        return (int)(vec ? FN<float, 4>(__VA_ARGS__)                        \
                         : FN<float, 1>(__VA_ARGS__));                      \
      default:                                                              \
        return (int)cudaErrorInvalidValue;                                  \
    }                                                                       \
  } while (0)

int elem_bytes(int dtype) { return dtype == 2 ? 4 : 2; }

// the activations' pointers allow the plan's 16-byte pieces
bool aligned(const Plan& p, const void* a, const void* b = nullptr,
             const void* c = nullptr) {
  if (p.vec == 1) return true;
  for (const void* q : {a, b, c})
    if (reinterpret_cast<uintptr_t>(q) & 15) return false;
  return true;
}

bool geometry(int B, int C, int groups, int HW, float eps, int dtype,
              const int* plan, Geometry* geo, Plan* p,
              int max_threads = kMaxThreads) {
  if (B <= 0 || C <= 0 || groups <= 0 || HW <= 0 || C % groups ||
      dtype < 0 || dtype > 2 || plan == nullptr || !(eps > 0.f))
    return false;
  *p = Plan{plan[0], plan[1], plan[2], plan[3], plan[4]};
  *geo = Geometry{C, groups, C / groups, HW, p->span, p->cap, eps};
  return plan_ok(*p, *geo, B, elem_bytes(dtype), max_threads);
}

}  // namespace

// Plain C entry points for ctypes. x [B, C, HW] (HW the product of the
// trailing sizes, 1 for [B, C]), y, gy and gx alike, are contiguous buffers
// of one dtype (0 = bfloat16, 1 = float16, 2 = float32) on the current
// device; gamma and beta contiguous float32 [C]; s and t (both or neither)
// contiguous [B, C] of x's dtype; stats float32 [B, groups, 2] (mean, raw
// variance); a, b, ga and gb float32 [B, C]; sums float32 [4, B, C] or null.
// plan[5] = (cluster, span, cap, threads, vec) from ops/groupnorm.py:
// launch_plan. Each launches on `stream` and returns the launch's
// cudaError_t (0 on success) without synchronising.
extern "C" int groupnorm_fwd(const void* x, const float* gamma,
                             const float* beta, const void* s, const void* t,
                             void* y, float* stats, int B, int C, int groups,
                             int HW, float eps, int silu, int dtype,
                             const int* plan, void* stream) {
  Geometry geo;
  Plan p;
  if (!geometry(B, C, groups, HW, eps, dtype, plan, &geo, &p) ||
      x == nullptr || y == nullptr || x == y || gamma == nullptr ||
      beta == nullptr || stats == nullptr ||
      (s == nullptr) != (t == nullptr) || !aligned(p, x, y))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  GN_DISPATCH(fwd_typed, x, gamma, beta, s, t, y, nullptr, nullptr, stats, B,
              geo, silu, p, st);
}

extern "C" int groupnorm_stats_fwd(const void* x, const float* gamma,
                                   const float* beta, float* a, float* b,
                                   float* stats, int B, int C, int groups,
                                   int HW, float eps, int dtype,
                                   const int* plan, void* stream) {
  Geometry geo;
  Plan p;
  if (!geometry(B, C, groups, HW, eps, dtype, plan, &geo, &p) ||
      x == nullptr || a == nullptr || b == nullptr || gamma == nullptr ||
      beta == nullptr || stats == nullptr || !aligned(p, x))
    return (int)cudaErrorInvalidValue;
  geo.cap = 0;
  cudaStream_t st = (cudaStream_t)stream;
  GN_DISPATCH(fwd_typed, x, gamma, beta, nullptr, nullptr, nullptr, a, b,
              stats, B, geo, 0, p, st);
}

extern "C" int groupnorm_bwd(const void* x, const void* gy,
                             const float* gamma, const float* beta,
                             const void* s, const void* t, const float* stats,
                             void* gx, float* sums, int B, int C, int groups,
                             int HW, float eps, int silu, int dtype,
                             const int* plan, void* stream) {
  Geometry geo;
  Plan p;
  if (!geometry(B, C, groups, HW, eps, dtype, plan, &geo, &p,
                kMaxThreadsBwd) ||
      x == nullptr || gy == nullptr || gx == nullptr || gx == x ||
      gx == gy || gamma == nullptr || beta == nullptr || stats == nullptr ||
      (s == nullptr) != (t == nullptr) || !aligned(p, x, gy, gx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  GN_DISPATCH(bwd_typed, x, gy, gamma, beta, s, t, stats, gx, sums, B, geo,
              silu, p, st);
}

extern "C" int groupnorm_stats_bwd(const void* x, const float* ga,
                                   const float* gb, const float* gamma,
                                   const float* stats, void* gx, int B, int C,
                                   int groups, int HW, float eps, int dtype,
                                   const int* plan, void* stream) {
  Geometry geo;
  Plan p;
  if (!geometry(B, C, groups, HW, eps, dtype, plan, &geo, &p) ||
      x == nullptr || ga == nullptr || gb == nullptr || gamma == nullptr ||
      stats == nullptr || gx == nullptr || gx == x || !aligned(p, x, gx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  GN_DISPATCH(stats_bwd_typed, x, ga, gb, gamma, stats, gx, B, geo, p, st);
}
