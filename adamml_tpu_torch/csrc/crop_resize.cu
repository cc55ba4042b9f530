// Crop, resize, flip and normalize of uint8 video canvases, with the
// RGB-difference frames formed on the fly, for Hopper (sm_90a): one kernel
// from the loader's canvases to the model's input layout.
//
// frames: (Nc, T_in, H, W, C) uint8 canvases, C = 2 or 3. Sample n (of
// N = Nc * ncrops) reads canvas n / ncrops (the oversample eval's crops fold
// into the batch without a copy of the canvases). crop: (N, 4) f32 rectangles
// (x0, y0, w, h) in canvas pixels; flip: (N,) bool. out: (N, T_out, HO, WO,
// CONS * C), f32 or bf16: output frame t packs CONS resized frames
// frame-major into its channels, canvas frames t*CONS + k (k < CONS), or with
// rgbdiff the differences of canvas frames t*(CONS+1) + k + 1 and
// t*(CONS+1) + k.
//
// What it computes is ops/augment.py's plain path, value for value:
// jax.image.scale_and_translate (linear, antialiased) of each crop to
// HO x WO with per-axis scale out/crop and translation -origin*scale; the
// flip (output column q takes resized column WO-1-q), and, for flow, the x
// channel inverted as 255 - v on a flipped sample; then v/255, -mean, /std in
// that order, rounded once to the output type. rgbdiff's frames are
// floor((a - b + 255) * 255/510), and 255/510 is 1/2 exactly, so a tap reads
// (a - b + 255) >> 1: rgbdiff_from_frames bit for bit.
//
// The taps of an output along one axis follow resample_weights' f32
// arithmetic in its order: scale = (1/extent)*out, inv = 1/scale,
// shift = (-origin*scale)*inv, sample_f = (o + 0.5)*inv - shift - 0.5,
// kernel_scale = max(inv, 1), weight = max(1 - |sample_f - i|/kernel_scale,
// 0) / total, zeroed when the total is under 1000 f32 eps or sample_f lies
// outside [-0.5, in - 0.5]. A tap is evaluated only over the candidates
// floor(sample_f - ks) - 1 .. ceil(sample_f + ks) + 1, clipped to the canvas
// (every weight outside is 0); the band of nonzero weights and its total are
// kept per output (ops/kernels/crop_resize.py::axis_taps writes the same rule
// in PyTorch; the CPU tests hold it to resample_weights' dense matrix, and the
// card tests hold this kernel's weights to it bit for bit).
// There is no fixed tap maximum: the first kInline weights of a band are
// cached, the rest evaluated in the loop. The _rn intrinsics keep nvcc from
// contracting the rule's products into FMAs; the sums of products are FMAs,
// as in the GEMM of the plain path, in f32.
//
// Replaces no Pallas kernel: adamml_tpu/ops/augment.py::_one_sample leaves
// the resize to XLA. It was added because the plain path multiplied whole
// f32 canvases by dense (out x in) weight matrices, more than 99% of whose
// products are by zero, and then made eight more f32 passes.
//
// Bound: device memory. The canvas bytes under the taps' support must be
// read once and the output written once; a handful of f32 operations per
// tap is far below the card's rate. Design: a block owns `rows` output rows
// of one output frame of one sample, with all CONS (or CONS + 1) canvas
// frames that feed them. It computes its sample's column taps and its rows'
// taps once into shared memory; a thread takes one output pixel at a time
// (a warp: consecutive columns, so its canvas reads are neighbouring bytes,
// served from L1 where the taps of neighbouring outputs overlap) and sums
// every slot and channel of it in registers; the block stages its rows in
// shared memory, flipped where the sample is, and stores them as one
// contiguous run, 16 bytes at a time when the run is 16-byte aligned. Each
// output is computed by one thread in a fixed order: deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInline = 4;  // weights of a band cached in its entry
constexpr float kTiny = 1000.f * 1.1920928955078125e-07f;  // 1000 f32 eps

struct Params {
  const uint8_t* frames;
  const float* crop;
  const uint8_t* flip;
  void* out;
  int64_t frame_elems;  // H * W * C
  int t_in, h_in, w_in;
  int t_out, h_out, w_out;
  int ncrops, rows, tiles;
  int flow, normalize;
  int stage_bytes;  // the staged output rows, rounded up to 16
  float mean[3], stdv[3];
};

// One sample's resampling along one axis.
struct Axis {
  float inv, ks, shift;
  int in;
};

// One output's taps along one axis: sample_f, the total of its weights, the
// first canvas index of its band of nonzero weights and the band's length
// (0: the output is 0), and the band's first kInline normalised weights.
struct Tap {
  float sf, total;
  int lo, cnt;
  float w[kInline];
};
// ops/kernels/crop_resize.py's TAP_BYTES, by which its plan sizes the
// block's shared memory
static_assert(sizeof(Tap) == 32, "a Tap is TAP_BYTES long");

// PyTorch computes a number over a tensor, out / extent and 1 / scale, as
// the tensor's reciprocal times the number (Tensor.__rtruediv__), so the
// plain path's scale is rounded twice.
__device__ __forceinline__ Axis axis_of(float origin, float extent,
                                        int out_size, int in_size) {
  const float scale =
      __fmul_rn(__frcp_rn(extent), static_cast<float>(out_size));
  const float trans = __fmul_rn(-origin, scale);
  Axis a;
  a.inv = __frcp_rn(scale);
  a.ks = a.inv > 1.f ? a.inv : 1.f;
  a.shift = __fmul_rn(trans, a.inv);
  a.in = in_size;
  return a;
}

// The unnormalised triangle weight of canvas index i.
__device__ __forceinline__ float tri(float sf, float ks, int i) {
  const float x = __fdiv_rn(fabsf(__fsub_rn(sf, static_cast<float>(i))), ks);
  const float w = __fsub_rn(1.f, x);
  return w > 0.f ? w : 0.f;
}

__device__ Tap tap_of(const Axis& a, int o) {
  Tap t;
  t.sf = __fsub_rn(__fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f),
                                       a.inv),
                             a.shift),
                   0.5f);
  t.total = 0.f;
  t.lo = 0;
  t.cnt = 0;
  // NaN fails the test too
  if (!(t.sf >= -0.5f && t.sf <= static_cast<float>(a.in) - 0.5f)) return t;
  const int first = static_cast<int>(
      fmaxf(floorf(__fsub_rn(t.sf, a.ks)) - 1.f, 0.f));
  const int last = static_cast<int>(
      fminf(ceilf(__fadd_rn(t.sf, a.ks)) + 1.f, static_cast<float>(a.in - 1)));
  int lo = -1, hi = -1;
  float total = 0.f;
  for (int i = first; i <= last; ++i) {
    const float w = tri(t.sf, a.ks, i);
    if (w > 0.f) {
      if (lo < 0) lo = i;
      hi = i;
      total = __fadd_rn(total, w);
    }
  }
  if (!(total > kTiny)) return t;
  t.total = total;
  t.lo = lo;
  t.cnt = hi - lo + 1;
#pragma unroll
  for (int j = 0; j < kInline; ++j) {
    t.w[j] = j < t.cnt ? __fdiv_rn(tri(t.sf, a.ks, lo + j), total) : 0.f;
  }
  return t;
}

__device__ __forceinline__ float weight(const Tap& t, float ks, int j) {
  return j < kInline ? t.w[j] : __fdiv_rn(tri(t.sf, ks, t.lo + j), t.total);
}

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int C, int CONS, bool DIFF>
__global__ void __launch_bounds__(kThreads)
    crop_resize_kernel(const Params p) {
  constexpr int K = CONS * C;
  extern __shared__ uint4 smem[];
  T* stage = reinterpret_cast<T*>(smem);
  Tap* cols = reinterpret_cast<Tap*>(reinterpret_cast<char*>(smem) +
                                     p.stage_bytes);
  Tap* rows = cols + p.w_out;

  const int tile = blockIdx.x % p.tiles;
  const int frame = blockIdx.x / p.tiles;  // n * t_out + t
  const int n = frame / p.t_out;
  const int t = frame - n * p.t_out;
  const int r0 = tile * p.rows;
  const int nrows = min(p.rows, p.h_out - r0);

  const float* cr = p.crop + 4 * static_cast<int64_t>(n);
  const Axis ax = axis_of(cr[0], cr[2], p.w_out, p.w_in);
  const Axis ay = axis_of(cr[1], cr[3], p.h_out, p.h_in);
  const bool flip = p.flip[n] != 0;
  for (int q = threadIdx.x; q < p.w_out; q += blockDim.x) {
    cols[q] = tap_of(ax, q);
  }
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    rows[r] = tap_of(ay, r0 + r);
  }
  __syncthreads();

  const int per_out = DIFF ? CONS + 1 : CONS;
  const uint8_t* base =
      p.frames + (static_cast<int64_t>(n / p.ncrops) * p.t_in +
                  static_cast<int64_t>(t) * per_out) * p.frame_elems;
  const int items = nrows * p.w_out;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int r = it / p.w_out;
    const int q = it - r * p.w_out;
    const Tap& tr = rows[r];
    const Tap& tc = cols[q];
    float acc[K];
#pragma unroll
    for (int kc = 0; kc < K; ++kc) acc[kc] = 0.f;
    for (int i = 0; i < tc.cnt; ++i) {
      const float wx = weight(tc, ax.ks, i);
      const int x = tc.lo + i;
      float col[K];
#pragma unroll
      for (int kc = 0; kc < K; ++kc) col[kc] = 0.f;
      for (int j = 0; j < tr.cnt; ++j) {
        const float wy = weight(tr, ay.ks, j);
        const uint8_t* px =
            base + (static_cast<int64_t>(tr.lo + j) * p.w_in + x) * C;
#pragma unroll
        for (int k = 0; k < CONS; ++k) {
          const uint8_t* f = px + k * p.frame_elems;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float v;
            if constexpr (DIFF) {
              const int a = __ldg(f + p.frame_elems + c);
              const int b = __ldg(f + c);
              v = static_cast<float>((a - b + 255) >> 1);
            } else {
              v = static_cast<float>(__ldg(f + c));
            }
            col[k * C + c] = __fmaf_rn(wy, v, col[k * C + c]);
          }
        }
      }
#pragma unroll
      for (int kc = 0; kc < K; ++kc) acc[kc] = __fmaf_rn(wx, col[kc], acc[kc]);
    }
    T* dst = stage + (static_cast<int64_t>(r) * p.w_out +
                      (flip ? p.w_out - 1 - q : q)) * K;
#pragma unroll
    for (int k = 0; k < CONS; ++k) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = acc[k * C + c];
        if (c == 0 && flip && p.flow) v = __fsub_rn(255.f, v);
        if (p.normalize) {
          v = __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.f), p.mean[c]), p.stdv[c]);
        }
        dst[k * C + c] = to_out<T>(v);
      }
    }
  }
  __syncthreads();

  // the block's rows are one contiguous run of the output
  const int64_t count = static_cast<int64_t>(nrows) * p.w_out * K;
  T* out = static_cast<T*>(p.out) +
           (static_cast<int64_t>(frame) * p.h_out + r0) * p.w_out * K;
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int64_t vecs = count * static_cast<int64_t>(sizeof(T)) / 16;
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int64_t v = threadIdx.x; v < vecs; v += blockDim.x) o4[v] = smem[v];
    done = vecs * 16 / static_cast<int64_t>(sizeof(T));
  }
  for (int64_t e = done + threadIdx.x; e < count; e += blockDim.x) {
    out[e] = stage[e];
  }
}

template <typename T, int C, int CONS, bool DIFF>
cudaError_t launch(const Params& p, int blocks, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        crop_resize_kernel<T, C, CONS, DIFF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  crop_resize_kernel<T, C, CONS, DIFF><<<blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// The three visual modalities' (C, CONS, DIFF): rgb, flow, rgbdiff.
template <typename T>
cudaError_t launch_t(const Params& p, int c, int cons, int rgbdiff,
                     int blocks, int smem, cudaStream_t st) {
  if (c == 3 && cons == 1 && !rgbdiff) {
    return launch<T, 3, 1, false>(p, blocks, smem, st);
  }
  if (c == 2 && cons == 5 && !rgbdiff) {
    return launch<T, 2, 5, false>(p, blocks, smem, st);
  }
  if (c == 3 && cons == 5 && rgbdiff) {
    return launch<T, 3, 5, true>(p, blocks, smem, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One launch. dtype: 0 = float32, 1 = bfloat16 output. frames: (nc, t_in,
// h_in, w_in, c) uint8, crop (nc * ncrops, 4) f32, flip (nc * ncrops,) bool,
// out (nc * ncrops, t_out, h_out, w_out, cons * c), all contiguous on one
// card; (c, cons, rgbdiff) one of rgb's (3, 1, 0), flow's (2, 5, 0) and
// rgbdiff's (3, 5, 1); t_out = t_in / cons, or t_in / (cons + 1) with
// rgbdiff. mean, stdv: c floats on the host, or null for no normalisation.
// rows, tiles, stage_bytes, smem_bytes: the launch's plan
// (ops/kernels/crop_resize.py::plan), taken as it is. Launches on `stream`
// and returns cudaGetLastError(), or cudaErrorInvalidValue for arguments it
// cannot run.
int crop_resize(const void* frames, const void* crop, const void* flip,
                void* out, int dtype, int c, int cons, int rgbdiff, int flow,
                int nc, int ncrops, int t_in, int h_in, int w_in, int h_out,
                int w_out, int rows, int tiles, int stage_bytes,
                int smem_bytes, const float* mean, const float* stdv,
                void* stream) {
  const int per_out = rgbdiff ? cons + 1 : cons;
  const bool ok = (dtype == 0 || dtype == 1) && (c == 2 || c == 3) &&
                  cons >= 1 && nc >= 1 && ncrops >= 1 && t_in >= per_out &&
                  t_in % per_out == 0 && h_in >= 1 && w_in >= 1 &&
                  h_out >= 1 && w_out >= 1 && rows >= 1 &&
                  static_cast<int64_t>(rows) * tiles >= h_out &&
                  stage_bytes >= 0 && smem_bytes >= stage_bytes &&
                  (mean == nullptr) == (stdv == nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.frames = static_cast<const uint8_t*>(frames);
  p.crop = static_cast<const float*>(crop);
  p.flip = static_cast<const uint8_t*>(flip);
  p.out = out;
  p.frame_elems = static_cast<int64_t>(h_in) * w_in * c;
  p.t_in = t_in;
  p.h_in = h_in;
  p.w_in = w_in;
  p.t_out = t_in / per_out;
  p.h_out = h_out;
  p.w_out = w_out;
  p.ncrops = ncrops;
  p.rows = rows;
  p.tiles = tiles;
  p.stage_bytes = stage_bytes;
  p.flow = flow;
  p.normalize = mean != nullptr;
  for (int i = 0; i < 3; ++i) {
    p.mean[i] = mean != nullptr && i < c ? mean[i] : 0.f;
    p.stdv[i] = stdv != nullptr && i < c ? stdv[i] : 1.f;
  }
  const int64_t blocks = static_cast<int64_t>(nc) * ncrops * p.t_out * tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(blocks);
  const cudaError_t e =
      dtype == 0
          ? launch_t<float>(p, c, cons, rgbdiff, b, smem_bytes, st)
          : launch_t<__nv_bfloat16>(p, c, cons, rgbdiff, b, smem_bytes, st);
  return static_cast<int>(e);
}

const char* crop_resize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
