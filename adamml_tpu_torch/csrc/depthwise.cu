// Fused 3x3 depthwise convolution for Hopper (sm_90a):
//
//   out = [relu6]( conv3x3_depthwise_SAME(x, w, stride) * scale + bias )
//
// x: (B, H, W, C) row-major (channels last), bf16 or f32; w: (3, 3, C) f32
// taps; scale, bias: (C,) f32; out: (B, OH, OW, C) in x's dtype. Padding is
// XLA's "SAME", given by its top and left sizes (pad_t, pad_l); the bottom
// and right padding follow from the bounds checks against H and W, so no
// padded copy of x is made.
//
// Replaces the Pallas kernel _dw_kernel of adamml_tpu/ops/pallas/
// depthwise.py (launched by _pallas_dw, which pads x with a jnp.pad pass
// first). The same kernel, with flipped taps, is the stride-1 input
// gradient.
//
// Bound: device memory. Each input byte is read once and each output byte
// written once, against 18 f32 operations per output element. Design: one
// thread per (b, oy, ox, 8-channel group), 16-byte loads and stores for bf16
// (two per 8 channels for f32); consecutive threads take consecutive channel
// groups and then consecutive output pixels, so a warp's loads of one tap
// are contiguous, and the neighbouring taps of a pixel hit L1. Taps, scale
// and bias are read once per thread. Math is f32 in row-major tap order
// (dy, dx), with the _rn intrinsics so nvcc contracts nothing into an FMA,
// then acc*scale + bias, the clip and one rounding: bit-equal to the plain
// PyTorch version. When C % 8 != 0 or a pointer is not 16-byte aligned the
// wrapper picks the scalar path (one channel per thread).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block

template <int V>
__device__ __forceinline__ void loadv(const float* p, float v[V]) {
  if constexpr (V == 8) {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[k];
  }
}

template <int V>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float v[V]) {
  if constexpr (V == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __bfloat162float(p[k]);
  }
}

template <int V>
__device__ __forceinline__ void storev(float* p, const float v[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

template <int V>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float v[V]) {
  if constexpr (V == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dw3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             T* __restrict__ out, int64_t total, int h, int wd, int c, int oh,
             int ow, int stride, int pad_t, int pad_l, int relu6) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int groups = c / V;
  const int c0 = static_cast<int>(t % groups) * V;
  int64_t rest = t / groups;
  const int ox = static_cast<int>(rest % ow);
  rest /= ow;
  const int oy = static_cast<int>(rest % oh);
  const int64_t b = rest / oh;

  float tap[9][V];
#pragma unroll
  for (int k = 0; k < 9; ++k) loadv<V>(w + k * c + c0, tap[k]);

  const T* xb = x + b * h * wd * c + c0;
  const int iy0 = oy * stride - pad_t;
  const int ix0 = ox * stride - pad_l;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = iy0 + dy;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = ix0 + dx;
      if (ix < 0 || ix >= wd) continue;
      float xv[V];
      loadv<V>(xb + (static_cast<int64_t>(iy) * wd + ix) * c, xv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        acc[k] = __fadd_rn(acc[k], __fmul_rn(xv[k], tap[3 * dy + dx][k]));
      }
    }
  }

  float sv[V], bv[V];
  loadv<V>(scale + c0, sv);
  loadv<V>(bias + c0, bv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float v = __fadd_rn(__fmul_rn(acc[k], sv[k]), bv[k]);
    // clip as torch.clamp does: NaN passes through
    if (relu6) v = v < 0.f ? 0.f : (v > 6.f ? 6.f : v);
    acc[k] = v;
  }
  storev<V>(out + ((b * oh + oy) * ow + ox) * c + c0, acc);
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* scale,
                   const float* bias, void* out, int b, int h, int wd, int c,
                   int oh, int ow, int stride, int pad_t, int pad_l,
                   int relu6, int vec, cudaStream_t st) {
  const int v = vec ? 8 : 1;
  const int64_t total = static_cast<int64_t>(b) * oh * ow * (c / v);
  const unsigned int blocks =
      static_cast<unsigned int>((total + kThreads - 1) / kThreads);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec) {
    dw3x3_kernel<T, 8><<<blocks, kThreads, 0, st>>>(
        xt, w, scale, bias, ot, total, h, wd, c, oh, ow, stride, pad_t,
        pad_l, relu6);
  } else {
    dw3x3_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
        xt, w, scale, bias, ot, total, h, wd, c, oh, ow, stride, pad_t,
        pad_l, relu6);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec = 1 takes 8 channels a thread with
// 16-byte accesses (C % 8 == 0, every pointer 16-byte aligned), vec = 0 one
// channel a thread. Shapes are validated by the Python wrapper. Launches on
// `stream` and returns cudaGetLastError().
int dw3x3_fwd(const void* x, const void* w, const void* scale,
              const void* bias, void* out, int dtype, int b, int h, int wd,
              int c, int oh, int ow, int stride, int pad_t, int pad_l,
              int relu6, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0) {
    return static_cast<int>(launch<float>(x, wf, sf, bf, out, b, h, wd, c, oh,
                                          ow, stride, pad_t, pad_l, relu6,
                                          vec, st));
  }
  if (dtype == 1) {
    return static_cast<int>(launch<__nv_bfloat16>(
        x, wf, sf, bf, out, b, h, wd, c, oh, ow, stride, pad_t, pad_l, relu6,
        vec, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dw3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
