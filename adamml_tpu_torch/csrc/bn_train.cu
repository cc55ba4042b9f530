// Train-mode grouped batch norm for Hopper (sm_90a): six kernels, two
// passes over the activation forward and two backward.
//
// x: (n, P, C) row-major (the rows' pixels P = H*W, channels last), bf16 or
// f32. Rows are (R replica groups, clips, S segments, si frames)-ordered;
// group g = rep*S + s holds the rows of replica rep and segment s, and
// moments are taken per (g, channel) over the group's rows and pixels
// (models/norm.py). R = S = si = 1 is the global-moments fallback.
//
// Forward:
//   bn_stats_kernel      x -> per-block partial sums (G, K, 2, C) of x, x^2
//   bn_finalize_kernel   partials -> mean, meansq (2, G, C); var = meansq -
//                        mean^2, a = w*rsqrt(var + eps), b = bias - mean*a
//                        (G, C); the running statistics folded in place
//                        from replica 0's S moment sets, in segment order
//   bn_apply_kernel      y = x*a[g] + b[g] in f32, one rounding to x's type
//                        (skipped when the caller takes (a, b) itself)
// Backward (the autograd of those formulas, written out):
//   bn_grad_sums_kernel      (dy, x) -> partials (G, K, 2, C) of dy*x, dy
//   bn_grad_finalize_kernel  per-group (da, db) -> dweight, dbias (C) and
//                            per group (a, dmean/N, 2*dmeansq/N) (3, G, C)
//   bn_dx_kernel             dx = dy*a + dmean/N + x*(2*dmeansq/N), f32,
//                            one rounding (no dy term when the caller took
//                            (a, b): its own backward routes dy*a)
//
// Replaces no Pallas kernel: the JAX package leaves train-mode BN to XLA.
// It replaces some 40 PyTorch kernels a BN (float32 copies, casts, two mean
// reductions, the per-group rsqrt and affine, and their autograd).
//
// Bound: device memory. A BN whose input needs a gradient must read x twice
// and write y once forward, and read dy and x twice and write dx once
// backward: 8 passes of 2 bytes (bf16), 16 bytes an element; a forward-only
// BN 6. The partials and the per-group vectors are a few percent of that.
//
// Design:
//  - One plan for the four passes over x (ops/kernels/bn_train.py::plan): a
//    block owns one (group, slab of the group's pixels, channel slice). Its
//    threads are `lanes` pixel lanes by `tcg` channel groups of V channels
//    (V = 8 bf16 or 4 f32 in one 16-byte load; V = 1 when C % V != 0 or x
//    is not 16-byte aligned); lane l walks the slab's pixels l, l + lanes,
//    ... four at a time, so each thread has four 16-byte loads in flight.
//    A warp's loads cover consecutive channels and then consecutive pixels:
//    whole lines. Slabs are sized so that the blocks fill the card two to
//    four times over, with at least 8 pixels a lane. A group's rows are runs of si
//    consecutive rows, one run a clip, so a lane carries (run, offset) and
//    steps it without division.
//  - Sums are deterministic, with no float atomics: each thread adds its
//    pixels in order; the block adds its lanes by a fixed tree in shared
//    memory and writes one partial per (group, slab, channel); the finalize
//    kernels add a group's slabs in 32 strided runs (a few hundred terms at
//    most) and the runs by a fixed tree. So a replay gives the bits of the
//    eager launches.
//  - The finalize kernels are small: 256 threads for 8 channels x 32 runs.
//    Under sync-BN the caller all-reduces the moments between the two halves
//    of the forward finalize (mode 1, then mode 2), and the moments'
//    gradients between the backward finalize and the dx pass.
// Products whose rounding is part of the formula use the _rn intrinsics, so
// nvcc does not contract them with the following add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The geometry of x and the plan of the passes over it (all int64 so that
// ctypes passes one plain struct). Outside the unnamed namespace: the
// extern "C" entry points take it, and would otherwise not be exported.
struct Shape {
  int64_t n, p, c;          // rows, pixels a row, channels
  int64_t r, s, si;         // replica groups, segments, frames a run
  int64_t vec, tcg, lanes;  // channels a thread, channel groups, lanes
  int64_t ns, k, slab;      // channel slices, slabs a group, slab pixels
};

namespace {

constexpr int kMaxThreads = 256;  // threads a block of the passes over x
constexpr int kUnroll = 4;        // pixels a lane loads before it adds
constexpr int kFinCh = 8;         // channels a finalize block
constexpr int kFinRuns = 32;      // strided runs over the slabs a channel
constexpr int kFinThreads = kFinCh * kFinRuns;

constexpr int kMoments = 1;  // finalize mode: partials -> moments
constexpr int kAffine = 2;   // finalize mode: moments -> a, b, running

// Derived per-launch constants of a Shape.
struct Walk {
  int64_t run_len;     // pixels of one run (si rows)
  int64_t run_stride;  // pixels from one run of a group to the next
  int64_t q;           // pixels a group
  int64_t step_runs, step_off;  // a lane's step as whole runs + offset
};

__host__ __device__ inline Walk walk_of(const Shape& sh) {
  Walk w;
  w.run_len = sh.si * sh.p;
  w.run_stride = sh.s * w.run_len;
  w.q = sh.n / (sh.r * sh.s) * sh.p;
  w.step_runs = sh.lanes / w.run_len;
  w.step_off = sh.lanes % w.run_len;
  return w;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V channels of T as loaded: one 16-byte vector when V > 1, else one T.
// The passes load raw vectors (4 registers each) and widen them to f32
// only when they use them.
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  if constexpr (V == 1) {
    return p[0];
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    return *reinterpret_cast<const uint4*>(p);
  }
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> zero_raw() {
  if constexpr (V == 1) {
    return T(0.f);
  } else {
    return make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int V>
__device__ __forceinline__ void widen(const Raw<T, V>& raw, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32<T>(raw);
  } else if constexpr (std::is_same<T, float>::value) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (std::is_same<T, float>::value) {
      p[0] = v[0];
    } else {
      p[0] = __float2bfloat16_rn(v[0]);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// f32 values at p, V of them (per-group vectors, C % V == 0 when V > 1)
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = p[i];
}

// A thread's place in the plan: its group, slab, channel and pixel walk.
struct Place {
  int64_t g, rep, seg;
  int64_t c0;        // first channel
  bool active;       // owns channels (the last slice may be short)
  int lane, cgl;
  int64_t q0, q1;    // the slab's group-local pixels
  int64_t base;      // pixel index of the group's first pixel
};

template <int V>
__device__ __forceinline__ Place place_of(const Shape& sh, const Walk& w) {
  Place pl;
  const int64_t b = blockIdx.x;
  const int64_t slice = b % sh.ns;
  const int64_t rest = b / sh.ns;
  const int64_t kk = rest % sh.k;
  pl.g = rest / sh.k;
  pl.rep = pl.g / sh.s;
  pl.seg = pl.g % sh.s;
  pl.lane = static_cast<int>(threadIdx.x / sh.tcg);
  pl.cgl = static_cast<int>(threadIdx.x % sh.tcg);
  const int64_t cg = slice * sh.tcg + pl.cgl;
  pl.c0 = cg * V;
  pl.active = pl.c0 < sh.c;
  pl.q0 = kk * sh.slab;
  pl.q1 = pl.q0 + sh.slab < w.q ? pl.q0 + sh.slab : w.q;
  pl.base = (pl.rep * (sh.n / sh.r) + pl.seg * sh.si) * sh.p;
  return pl;
}

// The element offset of group-local pixel (run, off) at channel c0, then
// the walk one lane step on.
__device__ __forceinline__ int64_t elem_and_step(const Shape& sh,
                                                 const Walk& w,
                                                 const Place& pl,
                                                 int64_t& run, int64_t& off) {
  const int64_t e = (pl.base + run * w.run_stride + off) * sh.c + pl.c0;
  off += w.step_off;
  run += w.step_runs;
  if (off >= w.run_len) {
    off -= w.run_len;
    ++run;
  }
  return e;
}

// Sums over the block's lanes by a fixed tree in shared memory (red holds
// 2 * blockDim.x * V floats, [stat][lane][cgl*V + j]); every thread of the
// block calls it. The caller's lane-0 threads then hold the block's sums.
template <int V>
__device__ __forceinline__ void block_sums(const Shape& sh, const Place& pl,
                                           float (&s0)[V], float (&s1)[V],
                                           float* red) {
  const int lanes = static_cast<int>(sh.lanes);
  const int width = static_cast<int>(sh.tcg) * V;
  float* r0 = red;
  float* r1 = red + lanes * width;
  const int at = pl.lane * width + pl.cgl * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    r0[at + j] = s0[j];
    r1[at + j] = s1[j];
  }
  __syncthreads();
  int half = 1;
  while (half < lanes) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (pl.lane < half && pl.lane + half < lanes) {
      const int from = at + half * width;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        r0[at + j] += r0[from + j];
        r1[at + j] += r1[from + j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s0[j] = r0[at + j];
    s1[j] = r1[at + j];
  }
}

// Per-(group, slab, channel) sums of (x, x*x), or of (dy*x, dy) when kGrad,
// into part (G, K, 2, C).
template <typename T, int V, bool kGrad>
__device__ __forceinline__ void pass_sums(const T* __restrict__ x,
                                          const T* __restrict__ dy,
                                          float* __restrict__ part,
                                          const Shape& sh) {
  __shared__ float red[2 * kMaxThreads * (V > 1 ? V : 1)];
  const Walk w = walk_of(sh);
  const Place pl = place_of<V>(sh, w);
  float s0[V], s1[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s0[j] = s1[j] = 0.f;
  int64_t q = pl.q0 + pl.lane;
  int64_t run = q / w.run_len, off = q - run * w.run_len;
  if (pl.active) {
    for (; q < pl.q1; q += kUnroll * sh.lanes) {
      Raw<T, V> xr[kUnroll], dr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = q + u * sh.lanes < pl.q1;
        const int64_t e = elem_and_step(sh, w, pl, run, off);
        xr[u] = ok ? load_raw<T, V>(x + e) : zero_raw<T, V>();
        if constexpr (kGrad) {
          dr[u] = ok ? load_raw<T, V>(dy + e) : zero_raw<T, V>();
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float xv[V], dv[V];
        widen<T, V>(xr[u], xv);
        if constexpr (kGrad) widen<T, V>(dr[u], dv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if constexpr (kGrad) {
            s0[j] = __fadd_rn(s0[j], __fmul_rn(dv[j], xv[j]));
            s1[j] = __fadd_rn(s1[j], dv[j]);
          } else {
            s0[j] = __fadd_rn(s0[j], xv[j]);
            s1[j] = __fadd_rn(s1[j], __fmul_rn(xv[j], xv[j]));
          }
        }
      }
    }
  }
  block_sums<V>(sh, pl, s0, s1, red);
  if (pl.lane == 0 && pl.active) {
    const int64_t kk = (blockIdx.x / sh.ns) % sh.k;
    float* out = part + ((pl.g * sh.k + kk) * 2) * sh.c + pl.c0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[j] = s0[j];
      out[sh.c + j] = s1[j];
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                Shape sh) {
  pass_sums<T, V, false>(x, nullptr, part, sh);
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
bn_grad_sums_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                    float* __restrict__ part, Shape sh) {
  pass_sums<T, V, true>(x, dy, part, sh);
}

// out = x*c1 + c0 (+ dy*ca when dy), per group, f32, one rounding. The
// forward's apply is (c1, c0) = (a, b); the backward's dx is (ca, c0, c1)
// = (a, dmean/N, 2*dmeansq/N).
template <typename T, int V, bool kDy>
__device__ __forceinline__ void pass_affine(const T* __restrict__ x,
                                            const T* __restrict__ dy,
                                            const float* __restrict__ c1v,
                                            const float* __restrict__ c0v,
                                            const float* __restrict__ cav,
                                            T* __restrict__ out,
                                            const Shape& sh) {
  const Walk w = walk_of(sh);
  const Place pl = place_of<V>(sh, w);
  if (!pl.active) return;
  float c1[V], c0[V], ca[V];
  const int64_t at = pl.g * sh.c + pl.c0;
  load_f32<V>(c1v + at, c1);
  load_f32<V>(c0v + at, c0);
  if constexpr (kDy) load_f32<V>(cav + at, ca);
  int64_t q = pl.q0 + pl.lane;
  int64_t run = q / w.run_len, off = q - run * w.run_len;
  for (; q < pl.q1; q += kUnroll * sh.lanes) {
    Raw<T, V> xr[kUnroll], dr[kUnroll];
    int64_t e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e[u] = elem_and_step(sh, w, pl, run, off);
      if (q + u * sh.lanes < pl.q1) {
        xr[u] = load_raw<T, V>(x + e[u]);
        if constexpr (kDy) dr[u] = load_raw<T, V>(dy + e[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q + u * sh.lanes < pl.q1) {
        float xv[V], dv[V], o[V];
        widen<T, V>(xr[u], xv);
        if constexpr (kDy) widen<T, V>(dr[u], dv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float v = __fadd_rn(__fmul_rn(xv[j], c1[j]), c0[j]);
          if constexpr (kDy) v = __fadd_rn(__fmul_rn(dv[j], ca[j]), v);
          o[j] = v;
        }
        store_vec<T, V>(out + e[u], o);
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ y, Shape sh) {
  pass_affine<T, V, false>(x, nullptr, a, b, nullptr, y, sh);
}

// dx: coef (3, G, C) = (a, dmean/N, 2*dmeansq/N), N the group's count
template <typename T, int V, bool kDy>
__global__ void __launch_bounds__(kMaxThreads)
bn_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
             const float* __restrict__ c1, const float* __restrict__ c0,
             const float* __restrict__ ca, T* __restrict__ dx, Shape sh) {
  pass_affine<T, V, kDy>(x, dy, c1, c0, ca, dx, sh);
}

// The sums over a group's K slabs of two f32 (G, K, C) arrays (strides
// sg, sk, 1) for this block's 8 channels, in 32 strided runs added by a
// fixed tree; red is [2][kFinRuns][kFinCh]. Threads of run 0 get the sums.
__device__ __forceinline__ void slab_sums(const float* __restrict__ p0,
                                          const float* __restrict__ p1,
                                          int64_t sg, int64_t sk, int64_t k,
                                          int64_t g, int64_t c, bool live,
                                          int ch, int run, float* red,
                                          float& t0, float& t1) {
  float s0 = 0.f, s1 = 0.f;
  if (live) {
    const int64_t at = g * sg + c;
#pragma unroll 4
    for (int64_t kk = run; kk < k; kk += kFinRuns) {
      s0 = __fadd_rn(s0, p0[at + kk * sk]);
      s1 = __fadd_rn(s1, p1[at + kk * sk]);
    }
  }
  float* r0 = red;
  float* r1 = red + kFinRuns * kFinCh;
  r0[run * kFinCh + ch] = s0;
  r1[run * kFinCh + ch] = s1;
  __syncthreads();
  for (int half = kFinRuns / 2; half > 0; half >>= 1) {
    if (run < half) {
      r0[run * kFinCh + ch] += r0[(run + half) * kFinCh + ch];
      r1[run * kFinCh + ch] += r1[(run + half) * kFinCh + ch];
    }
    __syncthreads();
  }
  t0 = r0[ch];
  t1 = r1[ch];
  __syncthreads();  // red is reused by the next group
}

struct FinArgs {
  const float* p0;  // sums of x (G, K, C), strides sg, sk
  const float* p1;  // sums of x*x
  int64_t sg, sk, k;
  float* mom;       // (2, G, C) mean, meansq
  const float* w;
  const float* bias;
  float* a;         // (G, C)
  float* b;
  float* rm;        // running statistics (C), or null
  float* rv;
  int64_t c, r, s;
  // count: a group's elements a channel; unbias: n/(n-1) of the running
  // variance; decay: m^S; the fold's weights (1-m) m^(S-1-i)
  float count, unbias, decay, momentum, one_minus_m, eps;
  int mode;
};

// grid (ceil(C / 8), R): a block folds its replica's S groups in order
__global__ void __launch_bounds__(kFinThreads)
bn_finalize_kernel(FinArgs f) {
  __shared__ float red[2 * kFinRuns * kFinCh];
  const int ch = threadIdx.x % kFinCh;
  const int run = threadIdx.x / kFinCh;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kFinCh + ch;
  const bool live = c < f.c;
  const int64_t rep = blockIdx.y;
  const int64_t gc = f.r * f.s * f.c;
  const bool fold = f.rm != nullptr && rep == 0;
  float acc_m = 0.f, acc_v = 0.f;
  for (int64_t seg = 0; seg < f.s; ++seg) {
    const int64_t g = rep * f.s + seg;
    float mean = 0.f, meansq = 0.f;
    if (f.mode & kMoments) {
      float t0, t1;
      slab_sums(f.p0, f.p1, f.sg, f.sk, f.k, g, c, live, ch, run, red, t0,
                t1);
      mean = __fdiv_rn(t0, f.count);
      meansq = __fdiv_rn(t1, f.count);
      if (run == 0 && live) {
        f.mom[g * f.c + c] = mean;
        f.mom[gc + g * f.c + c] = meansq;
      }
    } else if (live) {
      mean = f.mom[g * f.c + c];
      meansq = f.mom[gc + g * f.c + c];
    }
    if ((f.mode & kAffine) && run == 0 && live) {
      const float var = __fsub_rn(meansq, __fmul_rn(mean, mean));
      const float a = __fmul_rn(f.w[c], rsqrtf(__fadd_rn(var, f.eps)));
      f.a[g * f.c + c] = a;
      f.b[g * f.c + c] = __fsub_rn(f.bias[c], __fmul_rn(mean, a));
      if (fold) {
        const float wt = __fmul_rn(
            f.one_minus_m,
            powf(f.momentum, static_cast<float>(f.s - 1 - seg)));
        acc_m = __fadd_rn(acc_m, __fmul_rn(wt, mean));
        acc_v = __fadd_rn(acc_v, __fmul_rn(wt, __fmul_rn(var, f.unbias)));
      }
    }
  }
  if ((f.mode & kAffine) && fold && run == 0 && live) {
    f.rm[c] = __fadd_rn(__fmul_rn(f.rm[c], f.decay), acc_m);
    f.rv[c] = __fadd_rn(__fmul_rn(f.rv[c], f.decay), acc_v);
  }
}

struct GradFinArgs {
  const float* p0;  // sums of dy*x, or da (G, K, C), strides sg, sk
  const float* p1;  // sums of dy, or db
  int64_t sg, sk, k;
  const float* mom;  // (2, G, C)
  const float* w;
  float* dw;         // (C)
  float* db;
  float* coef;       // (3, G, C): a, dmean/N, 2*dmeansq/N
  int64_t c, g;
  float count, eps;  // N: a group's elements a channel (this shard's)
};

// grid ceil(C / 8): a block walks every group of its channels in order
__global__ void __launch_bounds__(kFinThreads)
bn_grad_finalize_kernel(GradFinArgs f) {
  __shared__ float red[2 * kFinRuns * kFinCh];
  const int ch = threadIdx.x % kFinCh;
  const int run = threadIdx.x / kFinCh;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kFinCh + ch;
  const bool live = c < f.c;
  const int64_t gc = f.g * f.c;
  float dw = 0.f, dbias = 0.f;
  for (int64_t g = 0; g < f.g; ++g) {
    float da, db;
    slab_sums(f.p0, f.p1, f.sg, f.sk, f.k, g, c, live, ch, run, red, da, db);
    if (run == 0 && live) {
      const int64_t at = g * f.c + c;
      const float mean = f.mom[at];
      const float meansq = f.mom[gc + at];
      const float var = __fsub_rn(meansq, __fmul_rn(mean, mean));
      const float rstd = rsqrtf(__fadd_rn(var, f.eps));
      const float a = __fmul_rn(f.w[c], rstd);
      // b = bias - mean*a: a's gradient gains -db*mean, mean's is -db*a
      const float ga = __fsub_rn(da, __fmul_rn(db, mean));
      dw = __fadd_rn(dw, __fmul_rn(ga, rstd));
      dbias = __fadd_rn(dbias, db);
      // rstd = rsqrt(var + eps): d var = d rstd * -0.5 * rstd^3
      const float grstd = __fmul_rn(ga, f.w[c]);
      const float r3 = __fmul_rn(__fmul_rn(rstd, rstd), rstd);
      const float gvar = __fmul_rn(__fmul_rn(grstd, -0.5f), r3);
      // var = meansq - mean*mean
      const float gmean = __fsub_rn(__fmul_rn(-db, a),
                                    __fmul_rn(__fmul_rn(2.f, mean), gvar));
      // mean = sum(x)/N, meansq = sum(x*x)/N: dx = dmean/N + 2x*dmeansq/N
      f.coef[at] = a;
      f.coef[gc + at] = __fdiv_rn(gmean, f.count);
      f.coef[2 * gc + at] = 2.f * __fdiv_rn(gvar, f.count);
    }
  }
  if (run == 0 && live) {
    f.dw[c] = dw;
    f.db[c] = dbias;
  }
}

template <typename T>
int vec_of() {
  return 16 / static_cast<int>(sizeof(T));
}

bool plan_ok(const Shape& sh, int vec_full) {
  if (sh.n <= 0 || sh.p <= 0 || sh.c <= 0 || sh.r <= 0 || sh.s <= 0 ||
      sh.si <= 0 || sh.n % (sh.r * sh.s * sh.si) != 0) {
    return false;
  }
  if (sh.vec != 1 && (sh.vec != vec_full || sh.c % sh.vec != 0)) return false;
  const int64_t groups = sh.c / sh.vec + (sh.c % sh.vec != 0);
  if (sh.tcg <= 0 || sh.lanes <= 0 || sh.tcg * sh.lanes > kMaxThreads ||
      sh.ns * sh.tcg < groups || sh.k <= 0 || sh.slab <= 0) {
    return false;
  }
  const int64_t q = sh.n / (sh.r * sh.s) * sh.p;
  return sh.k * sh.slab >= q && (sh.k - 1) * sh.slab < q;
}

int64_t blocks_of(const Shape& sh) { return sh.r * sh.s * sh.k * sh.ns; }

cudaError_t launched() { return cudaGetLastError(); }

template <typename T>
int stats(const void* x, float* part, const Shape& sh, cudaStream_t st) {
  if (!plan_ok(sh, vec_of<T>())) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks_of(sh)));
  const dim3 block(static_cast<unsigned>(sh.tcg * sh.lanes));
  const T* xp = static_cast<const T*>(x);
  if (sh.vec == 1) {
    bn_stats_kernel<T, 1><<<grid, block, 0, st>>>(xp, part, sh);
  } else if constexpr (std::is_same<T, float>::value) {
    bn_stats_kernel<T, 4><<<grid, block, 0, st>>>(xp, part, sh);
  } else {
    bn_stats_kernel<T, 8><<<grid, block, 0, st>>>(xp, part, sh);
  }
  return launched();
}

template <typename T>
int grad_sums(const void* dy, const void* x, float* part, const Shape& sh,
              cudaStream_t st) {
  if (!plan_ok(sh, vec_of<T>())) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks_of(sh)));
  const dim3 block(static_cast<unsigned>(sh.tcg * sh.lanes));
  const T* dp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  if (sh.vec == 1) {
    bn_grad_sums_kernel<T, 1><<<grid, block, 0, st>>>(dp, xp, part, sh);
  } else if constexpr (std::is_same<T, float>::value) {
    bn_grad_sums_kernel<T, 4><<<grid, block, 0, st>>>(dp, xp, part, sh);
  } else {
    bn_grad_sums_kernel<T, 8><<<grid, block, 0, st>>>(dp, xp, part, sh);
  }
  return launched();
}

template <typename T>
int apply(const void* x, const float* a, const float* b, void* y,
          const Shape& sh, cudaStream_t st) {
  if (!plan_ok(sh, vec_of<T>())) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks_of(sh)));
  const dim3 block(static_cast<unsigned>(sh.tcg * sh.lanes));
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (sh.vec == 1) {
    bn_apply_kernel<T, 1><<<grid, block, 0, st>>>(xp, a, b, yp, sh);
  } else if constexpr (std::is_same<T, float>::value) {
    bn_apply_kernel<T, 4><<<grid, block, 0, st>>>(xp, a, b, yp, sh);
  } else {
    bn_apply_kernel<T, 8><<<grid, block, 0, st>>>(xp, a, b, yp, sh);
  }
  return launched();
}

template <typename T, bool kDy>
int dx_pass(const void* dy, const void* x, const float* coef, void* dx,
            const Shape& sh, cudaStream_t st) {
  const int64_t gc = sh.r * sh.s * sh.c;
  const float* ca = coef;
  const float* c0 = coef + gc;
  const float* c1 = coef + 2 * gc;
  const dim3 grid(static_cast<unsigned>(blocks_of(sh)));
  const dim3 block(static_cast<unsigned>(sh.tcg * sh.lanes));
  const T* dp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(dx);
  if (sh.vec == 1) {
    bn_dx_kernel<T, 1, kDy><<<grid, block, 0, st>>>(dp, xp, c1, c0, ca, op,
                                                    sh);
  } else if constexpr (std::is_same<T, float>::value) {
    bn_dx_kernel<T, 4, kDy><<<grid, block, 0, st>>>(dp, xp, c1, c0, ca, op,
                                                    sh);
  } else {
    bn_dx_kernel<T, 8, kDy><<<grid, block, 0, st>>>(dp, xp, c1, c0, ca, op,
                                                    sh);
  }
  return launched();
}

template <typename T>
int dx(const void* dy, const void* x, const float* coef, void* out,
       const Shape& sh, cudaStream_t st) {
  if (!plan_ok(sh, vec_of<T>())) return cudaErrorInvalidValue;
  if (dy != nullptr) return dx_pass<T, true>(dy, x, coef, out, sh, st);
  return dx_pass<T, false>(dy, x, coef, out, sh, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, dy, y, dx: (n, P, C) contiguous;
// shape and plan from ops/kernels/bn_train.py (checked here: a plan the
// kernels cannot run returns cudaErrorInvalidValue); every launch goes on
// `stream` and returns the first CUDA error.
int bn_train_stats(const void* x, void* part, int dtype, const Shape* sh,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  if (dtype == 0) return stats<float>(x, pp, *sh, st);
  if (dtype == 1) return stats<__nv_bfloat16>(x, pp, *sh, st);
  return cudaErrorInvalidValue;
}

int bn_train_apply(const void* x, const void* a, const void* b, void* y,
                   int dtype, const Shape* sh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  if (dtype == 0) return apply<float>(x, ap, bp, y, *sh, st);
  if (dtype == 1) return apply<__nv_bfloat16>(x, ap, bp, y, *sh, st);
  return cudaErrorInvalidValue;
}

int bn_train_grad_sums(const void* dy, const void* x, void* part, int dtype,
                       const Shape* sh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  if (dtype == 0) return grad_sums<float>(dy, x, pp, *sh, st);
  if (dtype == 1) return grad_sums<__nv_bfloat16>(dy, x, pp, *sh, st);
  return cudaErrorInvalidValue;
}

// coef (3, G, C) = (a, dmean/N, 2*dmeansq/N) from the grad finalize. dy
// may be null (the caller took (a, b) and routes dy*a itself).
int bn_train_dx(const void* dy, const void* x, const void* coef, void* out,
                int dtype, const Shape* sh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(coef);
  if (dtype == 0) return dx<float>(dy, x, cp, out, *sh, st);
  if (dtype == 1) return dx<__nv_bfloat16>(dy, x, cp, out, *sh, st);
  return cudaErrorInvalidValue;
}

// mode 1: the slabs' sums -> mom; mode 2: mom -> a, b and (rm, rv not null)
// the running statistics of replica 0; mode 3: both in one launch.
int bn_train_finalize(const void* p0, const void* p1, long long sg,
                      long long sk, long long k, void* mom, const void* w,
                      const void* bias, void* a, void* b, void* rm, void* rv,
                      long long c, long long r, long long s, float count,
                      float unbias, float decay, float momentum,
                      float one_minus_m, float eps, int mode, void* stream) {
  if (mode < 1 || mode > 3 || c <= 0 || r <= 0 || s <= 0 ||
      ((mode & kMoments) && (k <= 0 || p0 == nullptr || p1 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  FinArgs f;
  f.p0 = static_cast<const float*>(p0);
  f.p1 = static_cast<const float*>(p1);
  f.sg = sg;
  f.sk = sk;
  f.k = k;
  f.mom = static_cast<float*>(mom);
  f.w = static_cast<const float*>(w);
  f.bias = static_cast<const float*>(bias);
  f.a = static_cast<float*>(a);
  f.b = static_cast<float*>(b);
  f.rm = static_cast<float*>(rm);
  f.rv = static_cast<float*>(rv);
  f.c = c;
  f.r = r;
  f.s = s;
  f.count = count;
  f.unbias = unbias;
  f.decay = decay;
  f.momentum = momentum;
  f.one_minus_m = one_minus_m;
  f.eps = eps;
  f.mode = mode;
  const dim3 grid(static_cast<unsigned>((c + kFinCh - 1) / kFinCh),
                  static_cast<unsigned>(r));
  bn_finalize_kernel<<<grid, kFinThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(f);
  return launched();
}

int bn_train_grad_finalize(const void* p0, const void* p1, long long sg,
                           long long sk, long long k, const void* mom,
                           const void* w, void* dw, void* db, void* coef,
                           long long c, long long g, float count,
                           float eps, void* stream) {
  if (c <= 0 || g <= 0 || k <= 0) return cudaErrorInvalidValue;
  GradFinArgs f;
  f.p0 = static_cast<const float*>(p0);
  f.p1 = static_cast<const float*>(p1);
  f.sg = sg;
  f.sk = sk;
  f.k = k;
  f.mom = static_cast<const float*>(mom);
  f.w = static_cast<const float*>(w);
  f.dw = static_cast<float*>(dw);
  f.db = static_cast<float*>(db);
  f.coef = static_cast<float*>(coef);
  f.c = c;
  f.g = g;
  f.count = count;
  f.eps = eps;
  bn_grad_finalize_kernel<<<static_cast<unsigned>((c + kFinCh - 1) / kFinCh),
                            kFinThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(f);
  return launched();
}

const char* bn_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
