// The stage-boundary prototype for Hopper (sm_90a): per-channel affine, a
// rounding to the input dtype, residual add, ReLU and temporal max-pool,
//
//   out = maxpool_t(k=3, s=2, pad=1)( relu( round(y * a + b) + ident ) )
//
// y, ident: (N, F, H, W, C) row-major, bf16 or f32; a, b: (C,) f32; out:
// (N, (F + 1) / 2, H, W, C) in y's dtype. z = y*a + b is rounded to y's
// dtype before the add, and the add is rounded again, as the prototype's
// program text does (jnp arithmetic in the input dtype).
//
// Replaces the Pallas kernel _pool_kernel of tools/bench_tpool.py
// (launched by tpool_pallas), the round-3 prototype of the fused epilogue
// (csrc/tpool_fused.cu, which rounds once and takes a grouped affine). Kept
// in its own source so the flagship kernel's source and build stay as they
// are.
//
// Bound: device memory. Each input byte is read once and each output byte
// written once. Design as in csrc/tpool_fused.cu: one thread per
// (n, h, w, 8-channel group), 16-byte vector accesses, a and b read once per
// thread, the frames walked once with the frame shared by two windows
// carried in registers. The _rn intrinsics keep nvcc from contracting the
// multiply-add into an FMA, so the result is bit-equal to the plain PyTorch
// version. ReLU and max propagate NaN like torch.relu / torch.max.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;        // channels per thread
constexpr int kThreads = 256;  // threads per block

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

// a float32 value rounded to T and back
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max that returns NaN if either side is NaN (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float m, float z) {
  return (z > m || z != z) ? z : m;
}

// z = relu(round(round(y*a + b) + ident)) for one frame's 8 channels
template <typename T>
__device__ __forceinline__ void frame(const T* yp, const T* ip,
                                      const float a[kVec],
                                      const float b[kVec], float z[kVec]) {
  float yv[kVec], iv[kVec];
  load8(yp, yv);
  load8(ip, iv);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float u = round_to(__fadd_rn(__fmul_rn(yv[k], a[k]), b[k]), yp);
    const float v = round_to(__fadd_rn(u, iv[k]), yp);
    z[k] = v < 0.f ? 0.f : v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tpool_proto_kernel(const T* __restrict__ y, const T* __restrict__ ident,
                   const float* __restrict__ a, const float* __restrict__ b,
                   T* __restrict__ out, int64_t total, int f_in, int f_out,
                   int64_t hw, int c) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int groups_per_pixel = c / kVec;
  const int cg = static_cast<int>(t % groups_per_pixel);
  const int64_t rest = t / groups_per_pixel;
  const int64_t p = rest % hw;
  const int64_t n = rest / hw;

  float av[kVec], bv[kVec];
  load8(a + cg * kVec, av);
  load8(b + cg * kVec, bv);

  const int64_t fstride = hw * c;
  const int64_t in_off = (n * f_in * hw + p) * c + cg * kVec;
  const T* yp = y + in_off;
  const T* ip = ident + in_off;
  T* op = out + (n * f_out * hw + p) * c + cg * kVec;

  // window fo covers frames 2fo-1, 2fo, 2fo+1 (clipped to [0, F)); the odd
  // frame 2fo+1 is also the first frame of window fo+1
  float carry[kVec];
  for (int fo = 0; fo < f_out; ++fo) {
    const int fe = 2 * fo;
    float m[kVec];
    frame(yp + fe * fstride, ip + fe * fstride, av, bv, m);
    if (fo > 0) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) m[k] = nan_max(carry[k], m[k]);
    }
    if (fe + 1 < f_in) {
      frame(yp + (fe + 1) * fstride, ip + (fe + 1) * fstride, av, bv, carry);
#pragma unroll
      for (int k = 0; k < kVec; ++k) m[k] = nan_max(m[k], carry[k]);
    }
    store8(op + fo * fstride, m);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Shapes are validated by the Python
// wrapper (C % 8 == 0, F >= 1, 16-byte aligned pointers). Launches on
// `stream` and returns cudaGetLastError().
int tpool_proto_fwd(const void* y, const void* ident, const void* a,
                    const void* b, void* out, int dtype, long long n,
                    int f_in, long long hw, int c, void* stream) {
  const int f_out = (f_in + 1) / 2;
  const int64_t total = static_cast<int64_t>(n) * hw * (c / kVec);
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) {
    tpool_proto_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(y), static_cast<const float*>(ident), af, bf,
        static_cast<float*>(out), total, f_in, f_out, hw, c);
  } else if (dtype == 1) {
    tpool_proto_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(ident), af, bf,
        static_cast<__nv_bfloat16*>(out), total, f_in, f_out, hw, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpool_proto_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
