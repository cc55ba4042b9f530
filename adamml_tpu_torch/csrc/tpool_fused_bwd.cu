// Backward of the fused ResNet stage-boundary epilogue for Hopper (sm_90a).
//
// Forward (csrc/tpool_fused.cu):
//   out = maxpool_t(k=3, s=2, pad=1)( relu( pre ) ),  pre = y*a[g] + b[g] + ident
//
// Given the pooled cotangent ct (N, F_out, H, W, C), this computes
//   dpre  = [pre > 0] * (ct routed to the FIRST maximum of each window
//           [2fo-1, 2fo+1] n [0, F), in window order; frame 2fo+1 sums the
//           two windows it belongs to)
//   dident = dpre rounded to ident's dtype                       (written)
//   dy     = dident * a[g], rounded to y's dtype                 (written)
//   per-row partials (sum dpre*y, sum dpre) over (F, H, W) per channel, from
//   the unrounded f32 dpre; the caller sums rows per group into (da, db).
// y, ident, dy, dident: (N, F, H, W, C) bf16 or f32; ct: (N, F_out, H, W, C)
// in y's dtype; a, b: (R*S, C) f32; row n takes g = (n / (N/R)) * S + n % S.
//
// Replaces the two backward Pallas kernels of
// adamml_tpu/ops/pallas/tpool_fused.py: _bwd_kernel (row-major 5D view) and
// _bwd_kernel_hwnfc (the (H, W, N*F, C) view XLA:TPU's conv layout needs).
// With channels_last torch tensors one kernel covers both, as in the forward.
//
// Bound: device memory. It reads y, ident and ct once and writes dident and
// dy once: (4*N*F + N*F_out) * H*W*C * itemsize bytes, against a handful of
// f32 operations per element. Design: a thread owns one (row, 8-channel
// group) and walks ppt pixels of one row; per pixel it walks the F frames
// once, window by window, carrying the odd frame shared by two windows (its
// pre, y and routed gradient) in registers, so every input byte is read once
// and every output byte written once, with 16-byte loads and stores
// (neighbouring threads on neighbouring 16 bytes). Writing dy here saves
// the separate pass over dident that dy = dident * a would take.
//
// The (da, db) sums need a reduction across blocks, which run in no order.
// It is deterministic, in two passes of one launch: each block reduces its
// pixels in shared memory by a fixed tree and writes one partial per
// (row, pixel chunk, channel) to a scratch buffer the caller allocates; a
// second kernel sums each row's chunks in order. Multiplies and adds of pre
// use the _rn intrinsics (no FMA contraction), so pre, the routing and
// dident/dy are bit-equal to the plain PyTorch version; NaN in pre routes
// nothing and masks to 0, as the plain version's == and > do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;          // channels per thread
constexpr int kThreads = 256;    // threads per block
constexpr int kMaxGx = 128;      // channel groups per block
constexpr int kMaxPixelsPerThread = 8;
constexpr int64_t kResidentThreads = 132 * 2048;  // H100 SXM: SMs x threads

struct Geometry {
  int gx;      // blockDim.x: channel groups
  int py;      // blockDim.y: pixel lanes
  int gz;      // gridDim.z: channel-group blocks
  int ppt;     // pixels per thread
  int chunks;  // pixel chunks per row (py * ppt pixels each)
};

Geometry geometry(int64_t n, int64_t hw, int c) {
  Geometry g;
  const int groups = c / kVec;
  g.gx = groups < kMaxGx ? groups : kMaxGx;
  g.py = kThreads / g.gx;
  g.gz = (groups + g.gx - 1) / g.gx;
  // enough pixels per thread to keep about two waves of resident threads
  const int64_t ppt = n * hw * groups / (2 * kResidentThreads);
  g.ppt = ppt < 1 ? 1
                  : (ppt > kMaxPixelsPerThread ? kMaxPixelsPerThread
                                               : static_cast<int>(ppt));
  const int64_t per_chunk = static_cast<int64_t>(g.py) * g.ppt;
  g.chunks = static_cast<int>((hw + per_chunk - 1) / per_chunk);
  return g;
}

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

// v rounded to the storage type T and back (what a store then a load gives)
__device__ __forceinline__ float rounded(float v, const float*) { return v; }
__device__ __forceinline__ float rounded(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max that returns NaN if either side is NaN, like torch.maximum
__device__ __forceinline__ float nan_max(float m, float z) {
  return (z > m || z != z) ? z : m;
}

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// y (as f32) and pre = y*a + b + ident for one frame's 8 channels
template <typename T>
__device__ __forceinline__ void load_pre(const T* yp, const T* ip,
                                         const float a[kVec],
                                         const float b[kVec], float yv[kVec],
                                         float pre[kVec]) {
  float iv[kVec];
  load8(yp, yv);
  load8(ip, iv);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    pre[k] = __fadd_rn(__fadd_rn(__fmul_rn(yv[k], a[k]), b[k]), iv[k]);
  }
}

// Mask one frame's routed gradient, write dident and dy, add the partials.
template <typename T>
__device__ __forceinline__ void finish(T* dpre_p, T* dy_p, const float pre[kVec],
                                       const float yv[kVec],
                                       const float dz[kVec],
                                       const float a[kVec], float sy[kVec],
                                       float s1[kVec]) {
  float d[kVec], dyv[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    d[k] = pre[k] > 0.f ? dz[k] : 0.f;
    sy[k] = __fadd_rn(sy[k], __fmul_rn(d[k], yv[k]));
    s1[k] = __fadd_rn(s1[k], d[k]);
    dyv[k] = __fmul_rn(rounded(d[k], dpre_p), a[k]);
  }
  store8(dpre_p, d);
  store8(dy_p, dyv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tpool_fused_bwd_kernel(const T* __restrict__ y, const T* __restrict__ ident,
                       const float* __restrict__ a,
                       const float* __restrict__ b, const T* __restrict__ ct,
                       T* __restrict__ dpre, T* __restrict__ dy,
                       float* __restrict__ part, int f_in, int f_out,
                       int64_t hw, int c, int64_t rows_per_rep, int s, int ppt,
                       int chunks) {
  __shared__ float red[2][kThreads][kVec];
  const int gx = blockDim.x, py = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * gx + tx;
  const int64_t n = blockIdx.x / chunks;
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const int cg = blockIdx.z * gx + tx;
  const bool active = cg < c / kVec;
  const int64_t g = (n / rows_per_rep) * s + n % s;

  float av[kVec], bv[kVec], sy[kVec], s1[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    av[k] = bv[k] = sy[k] = s1[k] = 0.f;
  }
  if (active) {
    load8(a + g * c + cg * kVec, av);
    load8(b + g * c + cg * kVec, bv);
  }

  const int64_t frame = hw * c;
  for (int it = 0; it < ppt; ++it) {
    const int64_t p = (static_cast<int64_t>(chunk) * ppt + it) * py + ty;
    if (!active || p >= hw) continue;
    const int64_t in_off = (n * f_in * hw + p) * c + cg * kVec;
    const T* yp = y + in_off;
    const T* ip = ident + in_off;
    T* dp = dpre + in_off;
    T* dyp = dy + in_off;
    const T* cp = ct + (n * f_out * hw + p) * c + cg * kVec;

    // the odd frame 2fo-1: last member of window fo-1, first of window fo
    float c_pre[kVec], c_y[kVec], c_dz[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      c_pre[k] = c_y[k] = c_dz[k] = 0.f;
    }
    for (int fo = 0; fo < f_out; ++fo) {
      const int fe = 2 * fo;
      const bool has_o = fe + 1 < f_in;
      float e_pre[kVec], e_y[kVec], e_dz[kVec];
      float o_pre[kVec], o_y[kVec], o_dz[kVec], gv[kVec];
      load_pre(yp + fe * frame, ip + fe * frame, av, bv, e_y, e_pre);
      if (has_o) {
        load_pre(yp + (fe + 1) * frame, ip + (fe + 1) * frame, av, bv, o_y,
                 o_pre);
      }
      load8(cp + fo * frame, gv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float zc = fo > 0 ? relu(c_pre[k]) : 0.f;
        const float ze = relu(e_pre[k]);
        const float zo = has_o ? relu(o_pre[k]) : 0.f;
        float m = fo > 0 ? nan_max(zc, ze) : ze;
        if (has_o) m = nan_max(m, zo);
        bool taken = false;
        if (fo > 0) {
          taken = zc == m;
          c_dz[k] = __fadd_rn(c_dz[k], taken ? gv[k] : 0.f);
        }
        const bool sel_e = !taken && ze == m;
        e_dz[k] = __fadd_rn(0.f, sel_e ? gv[k] : 0.f);
        taken = taken || sel_e;
        o_dz[k] = __fadd_rn(0.f, (has_o && !taken && zo == m) ? gv[k] : 0.f);
      }
      if (fo > 0) {
        finish(dp + (fe - 1) * frame, dyp + (fe - 1) * frame, c_pre, c_y,
               c_dz, av, sy, s1);
      }
      finish(dp + fe * frame, dyp + fe * frame, e_pre, e_y, e_dz, av, sy,
             s1);
      if (has_o) {
        if (fo + 1 < f_out) {
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            c_pre[k] = o_pre[k];
            c_y[k] = o_y[k];
            c_dz[k] = o_dz[k];
          }
        } else {
          finish(dp + (fe + 1) * frame, dyp + (fe + 1) * frame, o_pre, o_y,
                 o_dz, av, sy, s1);
        }
      }
    }
  }

  // fixed-order tree over the pixel lanes of the block
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    red[0][tid][k] = sy[k];
    red[1][tid][k] = s1[k];
  }
  __syncthreads();
  int span = 1;
  while (span < py) span <<= 1;
  for (int st = span >> 1; st > 0; st >>= 1) {
    if (ty < st && ty + st < py) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        red[0][tid][k] += red[0][tid + st * gx][k];
        red[1][tid][k] += red[1][tid + st * gx][k];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && active) {
    float* out = part + (n * chunks + chunk) * 2 * c + cg * kVec;
    store8(out, red[0][tx]);
    store8(out + c, red[1][tx]);
  }
}

// dab[n][q][c] = sum over chunks j, in order, of part[n][j][q][c]
__global__ void __launch_bounds__(kThreads)
tpool_fused_bwd_reduce(const float* __restrict__ part, float* __restrict__ dab,
                       int64_t total, int chunks, int c) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t ch = t % c;
  const int64_t nq = t / c;  // n * 2 + q
  const int64_t n = nq / 2, q = nq % 2;
  float acc = 0.f;
  for (int j = 0; j < chunks; ++j) {
    acc += part[((n * chunks + j) * 2 + q) * c + ch];
  }
  dab[t] = acc;
}

template <typename T>
int launch(const void* y, const void* ident, const float* a, const float* b,
           const void* ct, void* dpre, void* dy, float* part, float* dab,
           int64_t n, int f_in, int64_t hw, int c, int r, int s,
           cudaStream_t st) {
  const Geometry g = geometry(n, hw, c);
  if (n * g.chunks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int f_out = (f_in - 1) / 2 + 1;
  const dim3 block(g.gx, g.py);
  const dim3 grid(static_cast<unsigned int>(n * g.chunks), 1, g.gz);
  tpool_fused_bwd_kernel<T><<<grid, block, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(ident), a, b,
      static_cast<const T*>(ct), static_cast<T*>(dpre), static_cast<T*>(dy),
      part, f_in, f_out, hw, c, n / r, s, g.ppt, g.chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = n * 2 * c;
  tpool_fused_bwd_reduce<<<static_cast<unsigned int>(
                               (total + kThreads - 1) / kThreads),
                           kThreads, 0, st>>>(part, dab, total, g.chunks, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pixel chunks per row: the caller allocates part as (N, chunks, 2, C) f32.
int tpool_fused_bwd_chunks(long long n, long long hw, int c) {
  return geometry(n, hw, c).chunks;
}

// dtype: 0 = float32, 1 = bfloat16. Shapes are validated by the Python
// wrapper (C % 8 == 0, F >= 2, N % (R*S) == 0, (N/R) % S == 0, 16-byte
// aligned pointers). Launches both kernels on `stream` and returns
// cudaGetLastError() after each.
int tpool_fused_bwd(const void* y, const void* ident, const void* a,
                    const void* b, const void* ct, void* dpre, void* dy,
                    void* part, void* dab, int dtype, long long n, int f_in,
                    long long hw, int c, int r, int s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* pf = static_cast<float*>(part);
  float* df = static_cast<float*>(dab);
  if (dtype == 0) {
    return launch<float>(y, ident, af, bf, ct, dpre, dy, pf, df, n, f_in, hw,
                         c, r, s, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(y, ident, af, bf, ct, dpre, dy, pf, df, n,
                                 f_in, hw, c, r, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tpool_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
