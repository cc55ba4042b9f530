// Fused 3x3 depthwise convolution for Hopper (sm_90a):
//
//   out = [relu6]( conv3x3_depthwise_SAME(x, w, stride) [* scale + bias] )
//
// x: (B, H, W, C) row-major (channels last), bf16 or f32; w: (3, 3, C)
// taps in bf16 or f32, read in their own dtype and through their own element
// strides (the model passes a permuted view of its (C, 1, 3, 3) weight), and
// optionally flipped in both spatial axes (the stride-1 input gradient);
// scale, bias: (C,) f32, each optional (null: the identity). out: (B, OH,
// OW, C) in x's dtype. Padding is XLA's "SAME", given by its top and left
// sizes (pad_t, pad_l); the bottom and right padding are the zeros staged for
// input rows and columns outside the image, so no padded copy of x is made.
//
// Replaces the Pallas kernel _dw_kernel of adamml_tpu/ops/pallas/
// depthwise.py (launched by _pallas_dw, which pads x with a jnp.pad pass
// first). The same kernel, with flipped taps, is the stride-1 input
// gradient.
//
// Bound: device memory. Each input byte must be read once and each output
// byte written once, against 18 f32 operations per output element, far below
// the card's rate. Design: a block owns a tile of TH output rows x TW output
// columns x CB channels of one image. It stages the tile's input window,
// ((TH-1)*S+3) x ((TW-1)*S+3) x CB, in shared memory once, with 16-byte
// cp.async copies that zero-fill the padding and the ragged edge (a plain
// element copy when a pixel's channels are not 16-byte aligned), and the 9 x
// CB taps (and the affine) beside it, converted to f32. Each thread owns one
// output column and V = 4 channels (1 when C % 4 != 0), holds its 9 x V taps
// in registers and walks the tile's rows: at stride 1 each input row is read
// from shared memory once and feeds three output rows kept in three rolling
// accumulators; at stride 2 an even row feeds two. (At V = 8 the 72 taps
// took 128 registers a thread and lost to V = 4 at most layers.) So x comes
// from device memory about once (the halo rows of neighbouring tiles from
// L2) and each output is written by one 8- or 16-byte store. Math is f32 in
// row-major tap order (dy, dx) per output, with the _rn intrinsics so nvcc
// contracts nothing into an FMA, then acc*scale + bias, the clip and one
// rounding:
// bit-equal to the plain PyTorch version. Every output is computed by one
// thread in one fixed order, so the result is deterministic. The tile
// geometry comes from the Python wrapper (tile_plan), which the CPU tests
// check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;  // shared memory a block can use (sm_90)
constexpr int kMaxThreads = 512;

struct Args {
  const void* x;
  const void* w;
  const float* scale;  // null: 1
  const float* bias;   // null: 0
  void* out;
  int64_t w_off, w_sdy, w_sdx, w_sc;  // taps' offset and strides, elements
  int w_bf16, affine, relu6;
  int h, wd, c, oh, ow, pad_t, pad_l;
  int th, tw, cb, tiles_x, pitch, tile_bytes;
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <int V>
__device__ __forceinline__ void loadv(const float* p, float v[V]) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[k];
  }
}

template <int V>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float v[V]) {
  if constexpr (V == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __bfloat162float(p[k]);
  }
}

template <int V>
__device__ __forceinline__ void storev(float* p, const float v[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

template <int V>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float v[V]) {
  if constexpr (V == 4) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc (+)= x * tap, elementwise; `first` starts the sum at 0 as the plain
// version's zeros do
template <int V>
__device__ __forceinline__ void madd(float acc[V], const float xv[V],
                                     const float tap[V], bool first) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    acc[k] = __fadd_rn(first ? 0.f : acc[k], __fmul_rn(xv[k], tap[k]));
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_row(const Args& a, T* dst,
                                          const float acc[V], const float* s,
                                          const float* b) {
  float v[V];
  if (a.affine) {
    float sv[V], bv[V];
    loadv<V>(s, sv);
    loadv<V>(b, bv);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __fadd_rn(__fmul_rn(acc[k], sv[k]), bv[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = acc[k];
  }
  if (a.relu6) {
    // clip as torch.clamp does: NaN passes through
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = v[k] < 0.f ? 0.f : (v[k] > 6.f ? 6.f : v[k]);
  }
  storev<V>(dst, v);
}

// Stride 1, tile row j (0 <= j < rows + 2): it is dy = 0 of output row j
// (n, started here), dy = 1 of row j - 1 (m) and dy = 2 of row j - 2 (o,
// finished and stored here). Each output thus takes its nine products in
// (dy, dx) order.
template <typename T, int V>
__device__ __forceinline__ void row_s1(const Args& a, const T* xr, int j,
                                       int rows, const float (&w)[9][V],
                                       float (&n)[V], float (&m)[V],
                                       float (&o)[V], T* orow0,
                                       int64_t ostep, const float* s,
                                       const float* b) {
  const bool has_n = j < rows, has_m = j >= 1 && j <= rows, has_o = j >= 2;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float xv[V];
    loadv<V>(xr + dx * a.cb, xv);
    if (has_n) madd<V>(n, xv, w[dx], dx == 0);
    if (has_m) madd<V>(m, xv, w[3 + dx], false);
    if (has_o) madd<V>(o, xv, w[6 + dx], false);
  }
  if (has_o) store_row<T, V>(a, orow0 + (j - 2) * ostep, o, s, b);
}

// Stride 2, output row k (0 <= k <= rows): tile row 2k is dy = 0 of row k
// (cur, started) and dy = 2 of row k - 1 (prev, finished and stored); tile
// row 2k + 1 is dy = 1 of row k.
template <typename T, int V>
__device__ __forceinline__ void rows_s2(const Args& a, const T* xr, int k,
                                        int rows, const float (&w)[9][V],
                                        float (&cur)[V], float (&prev)[V],
                                        T* orow0, int64_t ostep,
                                        const float* s, const float* b) {
  const bool has_cur = k < rows, has_prev = k >= 1;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float xv[V];
    loadv<V>(xr + dx * a.cb, xv);
    if (has_prev) madd<V>(prev, xv, w[6 + dx], false);
    if (has_cur) madd<V>(cur, xv, w[dx], dx == 0);
  }
  if (has_prev) store_row<T, V>(a, orow0 + (k - 1) * ostep, prev, s, b);
  if (has_cur) {
    const T* xr1 = xr + a.pitch * a.cb;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float xv[V];
      loadv<V>(xr1 + dx * a.cb, xv);
      madd<V>(cur, xv, w[3 + dx], false);
    }
  }
}

template <typename T, int V, int S, bool ASYNC>
__global__ void __launch_bounds__(kMaxThreads)
dw3x3_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  float* wsm = reinterpret_cast<float*>(smem + a.tile_bytes);  // [9][cb]
  float* ssm = wsm + 9 * a.cb;                                 // [cb]
  float* bsm = ssm + a.cb;                                     // [cb]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tile_x = blockIdx.x % a.tiles_x, tile_y = blockIdx.x / a.tiles_x;
  const int c0 = blockIdx.y * a.cb;
  const int64_t img = blockIdx.z;
  const int oy0 = tile_y * a.th, ox0 = tile_x * a.tw;
  const int rows = min(a.th, a.oh - oy0), cols = min(a.tw, a.ow - ox0);
  const int rows_in = (rows - 1) * S + 3, cols_in = (cols - 1) * S + 3;
  const int iy0 = oy0 * S - a.pad_t, ix0 = ox0 * S - a.pad_l;
  const T* xb = static_cast<const T*>(a.x) + img * a.h * a.wd * a.c + c0;

  // stage the input window: cp.async chunks of 16 bytes, or elements; the
  // index walks (row, col, piece) by carries, one step of nthreads a turn
  {
    constexpr int E = ASYNC ? 16 / static_cast<int>(sizeof(T)) : 1;
    const int pieces = a.cb / E, per_row = cols_in * pieces;
    int r = tid / per_row, rem = tid - r * per_row;
    int col = rem / pieces, p = rem - col * pieces;
    const int sr = nthreads / per_row, srem = nthreads - sr * per_row;
    const int scol = srem / pieces, sp = srem - scol * pieces;
    while (r < rows_in) {
      const int iy = iy0 + r, ix = ix0 + col;
      const bool ok = iy >= 0 && iy < a.h && ix >= 0 && ix < a.wd;
      T* dst = tile + (r * a.pitch + col) * a.cb + p * E;
      const T* src = xb + (static_cast<int64_t>(iy) * a.wd + ix) * a.c + p * E;
      if constexpr (ASYNC) {
        cp_async16(dst, ok ? src : static_cast<const T*>(a.x), ok);
      } else {
        *dst = ok ? *src : zero<T>();
      }
      p += sp;
      col += scol;
      r += sr;
      if (p >= pieces) { p -= pieces; ++col; }
      if (col >= cols_in) { col -= cols_in; ++r; }
    }
  }
  // the taps (flipped through w_off and the strides) and the affine, as f32
  for (int i = tid; i < 9 * a.cb; i += nthreads) {
    const int k = i / a.cb, j = i - k * a.cb;
    const int dy = k / 3, dx = k - 3 * dy;
    const int64_t off = a.w_off + dy * a.w_sdy + dx * a.w_sdx +
                        static_cast<int64_t>(c0 + j) * a.w_sc;
    wsm[i] = a.w_bf16
                 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.w)[off])
                 : static_cast<const float*>(a.w)[off];
  }
  if (a.affine) {
    for (int i = tid; i < a.cb; i += nthreads) {
      ssm[i] = a.scale ? a.scale[c0 + i] : 1.f;
      bsm[i] = a.bias ? a.bias[c0 + i] : 0.f;
    }
  }
  if constexpr (ASYNC) cp_async_wait_all();
  __syncthreads();

  const int gb = a.cb / V;
  const int q = tid / gb, g = tid - q * gb;  // output column, channel group
  if (q >= cols) return;
  float w[9][V];
#pragma unroll
  for (int k = 0; k < 9; ++k) loadv<V>(wsm + k * a.cb + g * V, w[k]);
  const float* s = ssm + g * V;
  const float* b = bsm + g * V;
  const T* xc = tile + q * S * a.cb + g * V;  // tile row 0, first tap column
  const int rstep = a.pitch * a.cb;
  const int64_t ostep = static_cast<int64_t>(a.ow) * a.c;
  T* orow0 = static_cast<T*>(a.out) +
             ((img * a.oh + oy0) * a.ow + ox0 + q) * a.c + c0 + g * V;

  float acc0[V], acc1[V], acc2[V];
  if constexpr (S == 1) {
    // three accumulators rotate their roles (new, middle, old) by row
    for (int j = 0; j < rows + 2; j += 3) {
      row_s1<T, V>(a, xc + j * rstep, j, rows, w, acc0, acc2, acc1, orow0,
                   ostep, s, b);
      if (j + 1 < rows + 2) {
        row_s1<T, V>(a, xc + (j + 1) * rstep, j + 1, rows, w, acc1, acc0,
                     acc2, orow0, ostep, s, b);
      }
      if (j + 2 < rows + 2) {
        row_s1<T, V>(a, xc + (j + 2) * rstep, j + 2, rows, w, acc2, acc1,
                     acc0, orow0, ostep, s, b);
      }
    }
  } else {
    for (int k = 0; k <= rows; k += 2) {
      rows_s2<T, V>(a, xc + 2 * k * rstep, k, rows, w, acc0, acc1, orow0,
                    ostep, s, b);
      if (k + 1 <= rows) {
        rows_s2<T, V>(a, xc + 2 * (k + 1) * rstep, k + 1, rows, w, acc1,
                      acc0, orow0, ostep, s, b);
      }
    }
  }
  (void)acc2;
}

template <typename T, int V, int S, bool ASYNC>
cudaError_t launch_one(const Args& a, dim3 grid, int threads, int smem,
                       cudaStream_t st) {
  // raise the dynamic shared memory limit once for this instantiation
  static bool raised = false;
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw3x3_kernel<T, V, S, ASYNC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  dw3x3_kernel<T, V, S, ASYNC><<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_v(const Args& a, int stride, int async16, dim3 grid,
                     int threads, int smem, cudaStream_t st) {
  if (stride == 1) {
    return async16 ? launch_one<T, V, 1, true>(a, grid, threads, smem, st)
                   : launch_one<T, V, 1, false>(a, grid, threads, smem, st);
  }
  return async16 ? launch_one<T, V, 2, true>(a, grid, threads, smem, st)
                 : launch_one<T, V, 2, false>(a, grid, threads, smem, st);
}

template <typename T>
cudaError_t launch_t(const Args& a, int stride, int vec, int async16,
                     dim3 grid, int threads, int smem, cudaStream_t st) {
  if (vec == 4) return launch_v<T, 4>(a, stride, async16, grid, threads, smem, st);
  return launch_v<T, 1>(a, stride, async16, grid, threads, smem, st);
}

}  // namespace

extern "C" {

// One launch of the tiled kernel. dtype / w_dtype: 0 = float32,
// 1 = bfloat16. scale, bias: float32 (C,) or null (the identity); affine is
// on when either is given. flip reads w[2-dy, 2-dx]. w_s*: the taps' element
// strides. The tile plan (th, tw, cb, vec, async16) comes from the wrapper's
// tile_plan; async16 = 1 needs x 16-byte aligned and C and cb times the
// element size multiples of 16. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan it cannot run.
int dw3x3_fwd(const void* x, const void* w, const void* scale,
              const void* bias, void* out, int dtype, int w_dtype, int b,
              int h, int wd, int c, int oh, int ow, int stride, int pad_t,
              int pad_l, int relu6, int flip, long long w_sdy,
              long long w_sdx, long long w_sc, int th, int tw, int cb,
              int vec, int async16, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const bool ok =
      (dtype == 0 || dtype == 1) && (w_dtype == 0 || w_dtype == 1) &&
      (stride == 1 || stride == 2) && (vec == 1 || vec == 4) &&
      b >= 1 && b <= 65535 && th >= 1 && tw >= 1 && cb >= vec &&
      cb % vec == 0 && c % cb == 0 && c / cb <= 65535 &&
      tw * (cb / vec) <= kMaxThreads &&
      (!async16 || (cb * esize) % 16 == 0);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.w = w;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.w_sdy = flip ? -w_sdy : w_sdy;
  a.w_sdx = flip ? -w_sdx : w_sdx;
  a.w_sc = w_sc;
  a.w_off = flip ? 2 * (w_sdy + w_sdx) : 0;
  a.w_bf16 = w_dtype;
  a.affine = scale != nullptr || bias != nullptr;
  a.relu6 = relu6;
  a.h = h; a.wd = wd; a.c = c; a.oh = oh; a.ow = ow;
  a.pad_t = pad_t; a.pad_l = pad_l;
  a.th = th; a.tw = tw; a.cb = cb;
  a.tiles_x = (ow + tw - 1) / tw;
  const int tiles_y = (oh + th - 1) / th;
  a.pitch = (tw - 1) * stride + 3;
  const long long tile =
      static_cast<long long>((th - 1) * stride + 3) * a.pitch * cb * esize;
  a.tile_bytes = static_cast<int>((tile + 15) / 16 * 16);
  const long long smem = a.tile_bytes + 11LL * cb * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(a.tiles_x * tiles_y),
                  static_cast<unsigned int>(c / cb),
                  static_cast<unsigned int>(b));
  const int threads = tw * (cb / vec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  const cudaError_t e =
      dtype == 0 ? launch_t<float>(a, stride, vec, async16, grid, threads, sm, st)
                 : launch_t<__nv_bfloat16>(a, stride, vec, async16, grid,
                                           threads, sm, st);
  return static_cast<int>(e);
}

const char* dw3x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
