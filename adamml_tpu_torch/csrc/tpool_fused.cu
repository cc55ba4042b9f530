// Fused ResNet stage-boundary epilogue for Hopper (sm_90a):
//
//   out = maxpool_t(k=3, s=2, pad=1)( relu( y * a[g] + b[g] + ident ) )
//
// y, ident: (N, F, H, W, C) row-major, bf16 or f32; a, b: (R*S, C) f32;
// out: (N, F_out, H, W, C) in y's dtype, F_out = (F - 1) / 2 + 1.
// Row n takes the grouped-BN affine g = (n / (N / R)) * S + n % S.
//
// Replaces the two forward Pallas kernels of
// adamml_tpu/ops/pallas/tpool_fused.py: _kernel (row-major 5D view) and
// _kernel_hwnfc (the (H, W, N*F, C) view XLA:TPU's conv layout needs). With
// channels_last torch tensors the conv output (N*F, C, H, W) is byte-for-byte
// the row-major (N, F, H, W, C) this kernel reads, so one kernel covers both.
//
// Bound: device memory. Each input byte is read once and each output byte
// written once: (2*N*F + N*F_out) * H * W * C * itemsize bytes, against about
// four f32 operations per input element. Design: one thread per
// (n, h, w, 8-channel group); 16-byte vector loads and stores for bf16 (two
// per 8 channels for f32); a and b read once per thread; the F frames walked
// once, with the odd frame shared by two windows carried in registers. Math is
// f32 with one rounding at the end. Multiply and adds use the _rn intrinsics
// so nvcc does not contract them into an FMA: the result is then bit-equal to
// the plain PyTorch composition (y*a, +b, +ident, each rounded in f32). ReLU
// and max propagate NaN like torch.relu / torch.max. The backward is
// csrc/tpool_fused_bwd.cu.

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

// max that returns NaN if either side is NaN (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float m, float z) {
  return (z > m || z != z) ? z : m;
}

// z = relu(y*a + b + ident) for one frame's 8 channels
template <typename T>
__device__ __forceinline__ void pre_relu(const T* yp, const T* ip,
                                         const float a[kVec],
                                         const float b[kVec], float z[kVec]) {
  float yv[kVec], iv[kVec];
  load8(yp, yv);
  load8(ip, iv);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(yv[k], a[k]), b[k]), iv[k]);
    z[k] = v < 0.f ? 0.f : v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tpool_fused_kernel(const T* __restrict__ y, const T* __restrict__ ident,
                   const float* __restrict__ a, const float* __restrict__ b,
                   T* __restrict__ out, int64_t total, int f_in, int f_out,
                   int64_t hw, int c, int64_t rows_per_rep, int s) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int groups_per_pixel = c / kVec;
  const int cg = static_cast<int>(t % groups_per_pixel);
  const int64_t rest = t / groups_per_pixel;
  const int64_t p = rest % hw;
  const int64_t n = rest / hw;
  const int64_t g = (n / rows_per_rep) * s + n % s;

  float av[kVec], bv[kVec];
  load8(a + g * c + cg * kVec, av);
  load8(b + g * c + cg * kVec, bv);

  const int64_t frame = hw * c;
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
    pre_relu(yp + fe * frame, ip + fe * frame, av, bv, m);
    if (fo > 0) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) m[k] = nan_max(carry[k], m[k]);
    }
    if (fe + 1 < f_in) {
      pre_relu(yp + (fe + 1) * frame, ip + (fe + 1) * frame, av, bv, carry);
#pragma unroll
      for (int k = 0; k < kVec; ++k) m[k] = nan_max(m[k], carry[k]);
    }
    store8(op + fo * frame, m);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Shapes are validated by the Python
// wrapper (C % 8 == 0, F >= 2, N % (R*S) == 0, (N/R) % S == 0, 16-byte
// aligned pointers). Launches on `stream` and returns cudaGetLastError().
int tpool_fused_fwd(const void* y, const void* ident, const void* a,
                    const void* b, void* out, int dtype, long long n,
                    int f_in, long long hw, int c, int r, int s,
                    void* stream) {
  const int f_out = (f_in - 1) / 2 + 1;
  const int64_t total = static_cast<int64_t>(n) * hw * (c / kVec);
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  const int64_t rows_per_rep = n / r;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0) {
    tpool_fused_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(y), static_cast<const float*>(ident), af, bf,
        static_cast<float*>(out), total, f_in, f_out, hw, c, rows_per_rep, s);
  } else if (dtype == 1) {
    tpool_fused_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(ident), af, bf,
        static_cast<__nv_bfloat16*>(out), total, f_in, f_out, hw, c,
        rows_per_rep, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpool_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
