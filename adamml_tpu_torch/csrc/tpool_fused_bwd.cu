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
//   per-row (sum dpre*y, sum dpre) over (F, H, W) per channel, from the
//   unrounded f32 dpre, into dab (N, 2, C); the caller sums rows per group
//   into (da, db).
// y, ident, dy, dident: (N, F, H, W, C) bf16 or f32; ct: (N, F_out, H, W, C)
// in y's dtype; a, b: (R*S, C) f32; row n takes g = (n / (N/R)) * S + n % S.
//
// Replaces the two backward Pallas kernels of
// adamml_tpu/ops/pallas/tpool_fused.py: _bwd_kernel (row-major 5D view) and
// _bwd_kernel_hwnfc (the (H, W, N*F, C) view XLA:TPU's conv layout needs).
// With channels_last torch tensors one kernel covers both, as in the forward.
//
// Bound: device memory. It must read y, ident and ct once and write dident
// and dy once: (4*N*F + N*F_out) * H*W*C * itemsize bytes, against about 14
// f32 operations per input element.
//
// The first design (one thread per (row, 8-channel group) walking a few
// pixels, partials reduced in a 16 KB shared-memory tree, a second kernel
// summing them) reached 0.60 / 0.50 / 0.26 of this bound at the three
// flagship stage boundaries (PERF.md, the kernel table), for two reasons:
//  1. 162 registers a thread left room for one 256-thread block an SM, and
//     a thread had about five 16-byte loads in flight: too few bytes in
//     flight to keep the memory busy.
//  2. Blocks of one or two pixels a thread wrote one f32 partial per
//     (row, block, channel): at stage 3, 44% more bytes than the bound
//     counts, summed by a serial second kernel.
// This design:
//  1. Bytes in flight held in shared memory, not registers. A thread owns
//     one 16-byte channel group of a pixel lane and walks its lane's pixels
//     window by window (a "step": the even and odd frame's y and ident and
//     the window's ct, five 16-byte pieces). Its own cp.async copies fill a
//     ring of kStages steps in dynamic shared memory, kStages - 1 steps
//     ahead of the step it computes; the odd frame shared by two windows is
//     read again from the previous step's slot. No thread reads another's
//     slot, so the ring needs no barrier. A warp is 4 pixel lanes x 8
//     channel groups, so each of its copies and stores moves whole
//     128-byte lines (a warp of 8 lanes x 4 groups, moving half lines, ran
//     markedly slower on the same plan).
//  2. A block owns one (row, pixel chunk, slice group) and walks its
//     channel slices (256 bf16 or 128 f32 channels each). The plan
//     (ops/kernels/tpool_fused.py::bwd_plan) makes the chunks many and
//     small, which the card schedules evenly, as many as keep the f32
//     partials, written and read, within 2% of the bound's bytes; and
//     splits the slices into groups when the chunks alone give too few
//     blocks. At the end of a slice each warp adds its 4 lanes' sums by
//     shuffles, the upper half of the block hands its sums to the lower
//     half through 2 KB of shared memory, and the lower half writes the
//     chunk's partial. With one chunk a row that partial is the row's
//     result. Otherwise the last block of a row to finish (a ticket:
//     __threadfence and an atomic counter, zeroed by a memset on the
//     stream before the launch) adds the row's chunks in index order. One
//     kernel a call, no float atomics.
// A channel's terms are added in an order fixed by the plan alone: each
// lane over its pixels in order and, per pixel, frames 0..F-1; then the
// lanes in the tree ((l0+l2)+(l1+l3))+((l4+l6)+(l5+l7)); then the chunks in
// order. The chunks depend on (N, F, H, W) and the dtype, not on C or the
// slice groups, so a channel block gets the bits of the full-C launch, and
// every launch the same bits (``planned_row_sums`` is this order on the
// CPU). Multiplies and adds use the _rn intrinsics (no FMA contraction), so
// pre, the routing and dident/dy are bit-equal to the plain PyTorch
// version; NaN in pre routes nothing and masks to 0, as the plain version's
// == and > do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block: 8 warps
constexpr int kLanes = 8;      // pixel lanes a block
constexpr int kWarpLanes = 4;  // pixel lanes a warp: 4 lanes x 8 groups
constexpr int kWarpGroups = 32 / kWarpLanes;    // channel groups a warp
constexpr int kGroups = kThreads / kLanes;      // channel groups a slice
constexpr int kChannelWarps = kGroups / kWarpGroups;
constexpr int kStages = 4;     // ring depth, in steps
constexpr int kSlots = 5;      // y, ident of the even and odd frame; ct
constexpr int kPiece = 16;     // bytes a thread copies per slot
constexpr int kStageBytes = kSlots * kThreads * kPiece;
constexpr int kSmem = kStages * kStageBytes;   // 81,920 bytes
constexpr int kMinBlocks = 2;  // blocks an SM (launch bound, and the ring)

// channels in one 16-byte piece
template <typename T>
__host__ __device__ constexpr int vec() {
  return kPiece / static_cast<int>(sizeof(T));
}

struct Args {
  const void* y;
  const void* ident;
  const float* a;
  const float* b;
  const void* ct;
  void* dident;
  void* dy;
  float* part;   // (N, chunks, 2, C) partials, or dab when chunks == 1
  int* tickets;  // (N,) zeroed before the launch, when chunks > 1
  float* dab;    // (N, 2, C)
  int64_t hw, rows_per_rep;
  int c, f_in, f_out, s;
  int slices, slice_groups, chunks, chunk_pixels, lane_pixels;
};

__device__ __forceinline__ void unpack(uint4 raw, const float*, float v[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(uint4 raw, const __nv_bfloat16*,
                                       float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float v[4], const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 pack(const float v[8],
                                      const __nv_bfloat16*) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  return raw;
}

// one 16-byte piece of T from shared or device memory, as f32
template <typename T>
__device__ __forceinline__ void load_piece(const void* p, float v[]) {
  unpack(*reinterpret_cast<const uint4*>(p), static_cast<const T*>(nullptr),
         v);
}

template <typename T>
__device__ __forceinline__ void store_piece(T* p, const float v[]) {
  *reinterpret_cast<uint4*>(p) = pack(v, static_cast<const T*>(nullptr));
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float v[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float v[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// pre = y*a + b + ident from one frame's pieces of y and ident in the ring
template <typename T, int V>
__device__ __forceinline__ void ring_pre(const unsigned char* yp,
                                         const unsigned char* ip,
                                         const float a[V], const float b[V],
                                         float pre[V]) {
  float yv[V], iv[V];
  load_piece<T>(yp, yv);
  load_piece<T>(ip, iv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    pre[k] = __fadd_rn(__fadd_rn(__fmul_rn(yv[k], a[k]), b[k]), iv[k]);
  }
}

// Mask one frame's routed gradient, write dident and dy, add the sums.
template <typename T, int V>
__device__ __forceinline__ void finish(T* dident, T* dy,
                                       const unsigned char* yp,
                                       const unsigned char* ip,
                                       const float dz[V], const float a[V],
                                       const float b[V], float sy[V],
                                       float s1[V]) {
  float pre[V], yv[V], d[V], dyv[V];
  ring_pre<T, V>(yp, ip, a, b, pre);
  load_piece<T>(yp, yv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    d[k] = pre[k] > 0.f ? dz[k] : 0.f;
    sy[k] = __fadd_rn(sy[k], __fmul_rn(d[k], yv[k]));
    s1[k] = __fadd_rn(s1[k], d[k]);
    dyv[k] = __fmul_rn(rounded(d[k], dident), a[k]);
  }
  store_piece(dident, d);
  store_piece(dy, dyv);
}

// A thread's walk: step -> (channel slice, pixel index j of its lane,
// window fo), advanced one step at a time.
struct Cursor {
  int slice = 0, j = 0, fo = 0;
  __device__ void next(int f_out, int lane_pixels) {
    if (++fo == f_out) {
      fo = 0;
      if (++j == lane_pixels) {
        j = 0;
        ++slice;
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tpool_fused_bwd_kernel(const Args p) {
  constexpr int V = vec<T>();
  extern __shared__ __align__(16) unsigned char ring[];
  // the upper half's lane sums, handed to the lower half at a slice's end
  __shared__ __align__(16) float xchg[kChannelWarps][kWarpGroups][2][8];
  __shared__ int last_block;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = warp / kChannelWarps;  // pixel lanes 0-3 or 4-7
  const int cw = warp % kChannelWarps;
  const int gw = lane % kWarpGroups;
  const int pl = half * kWarpLanes + lane / kWarpGroups;  // pixel lane
  const int gb = cw * kWarpGroups + gw;
  // block = (row, pixel chunk, slice group): the group walks slices
  // sg, sg + slice_groups, ...
  const int per_row = p.chunks * p.slice_groups;
  const int64_t n = blockIdx.x / per_row;
  const int rem = static_cast<int>(blockIdx.x % per_row);
  const int chunk = rem / p.slice_groups;
  const int sg = rem % p.slice_groups;
  const int64_t g = (n / p.rows_per_rep) * p.s + n % p.s;
  const int groups = p.c / V;
  const int64_t p0 = static_cast<int64_t>(chunk) * p.chunk_pixels;
  const int64_t pend =
      p0 + p.chunk_pixels < p.hw ? p0 + p.chunk_pixels : p.hw;
  const int steps_slice = p.lane_pixels * p.f_out;
  const int total =
      (p.slices - sg + p.slice_groups - 1) / p.slice_groups * steps_slice;
  const int64_t frame = p.hw * p.c;
  const T* y = static_cast<const T*>(p.y);
  const T* ident = static_cast<const T*>(p.ident);
  const T* ct = static_cast<const T*>(p.ct);
  T* dident = static_cast<T*>(p.dident);
  T* dy = static_cast<T*>(p.dy);

  // this thread's piece of slot q of ring stage st
  auto slot = [&](int st, int q) {
    return ring + st * kStageBytes + (q * kThreads + tid) * kPiece;
  };
  // the step's pixel and channel group, if this thread has one there
  auto locate = [&](const Cursor& u, int64_t& px, int& cg) {
    px = p0 + pl + static_cast<int64_t>(u.j) * kLanes;
    cg = (sg + u.slice * p.slice_groups) * kGroups + gb;
    return cg < groups && px < pend;
  };

  Cursor at_copy;
  int copied = 0;
  auto prefetch = [&]() {
    int64_t px;
    int cg;
    if (copied < total && locate(at_copy, px, cg)) {
      const int st = copied % kStages;
      const int fe = 2 * at_copy.fo;
      const int64_t off = (n * p.f_in * p.hw + px) * p.c + cg * V;
      cp_async16(slot(st, 0), y + off + fe * frame);
      cp_async16(slot(st, 1), ident + off + fe * frame);
      if (fe + 1 < p.f_in) {
        cp_async16(slot(st, 2), y + off + (fe + 1) * frame);
        cp_async16(slot(st, 3), ident + off + (fe + 1) * frame);
      }
      cp_async16(slot(st, 4), ct + (n * p.f_out * p.hw + px) * p.c + cg * V +
                                  at_copy.fo * frame);
    }
    cp_async_commit();
    at_copy.next(p.f_out, p.lane_pixels);
    ++copied;
  };

  float av[V], bv[V], sy[V], s1[V], cdz[V];
  auto start_slice = [&](int own) {
    const int slice = sg + own * p.slice_groups;
    const int cg = slice * kGroups + gb;
#pragma unroll
    for (int k = 0; k < V; ++k) av[k] = bv[k] = sy[k] = s1[k] = 0.f;
    if (slice < p.slices && cg < groups) {
      load_f32<V>(p.a + g * p.c + cg * V, av);
      load_f32<V>(p.b + g * p.c + cg * V, bv);
    }
  };
  start_slice(0);
#pragma unroll
  for (int k = 0; k < V; ++k) cdz[k] = 0.f;
  float* out = p.chunks > 1 ? p.part : p.dab;

  for (int i = 0; i < kStages - 1; ++i) prefetch();
  Cursor at;
  for (int t = 0; t < total; ++t) {
    cp_async_wait<kStages - 2>();  // step t's copies have landed
    int64_t px;
    int cg;
    if (locate(at, px, cg)) {
      const int st = t % kStages;
      const int pv = (t + kStages - 1) % kStages;  // step t-1: frame 2fo-1
      const int fo = at.fo;
      const int fe = 2 * fo;
      const bool has_c = fo > 0;
      const bool has_o = fe + 1 < p.f_in;
      float pc[V], pe[V], po[V], gv[V], edz[V], odz[V];
      if (has_c) ring_pre<T, V>(slot(pv, 2), slot(pv, 3), av, bv, pc);
      ring_pre<T, V>(slot(st, 0), slot(st, 1), av, bv, pe);
      if (has_o) ring_pre<T, V>(slot(st, 2), slot(st, 3), av, bv, po);
      load_piece<T>(slot(st, 4), gv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float zc = has_c ? relu(pc[k]) : 0.f;
        const float ze = relu(pe[k]);
        const float zo = has_o ? relu(po[k]) : 0.f;
        float m = has_c ? nan_max(zc, ze) : ze;
        if (has_o) m = nan_max(m, zo);
        bool taken = false;
        if (has_c) {
          taken = zc == m;
          cdz[k] = __fadd_rn(cdz[k], taken ? gv[k] : 0.f);
        }
        const bool sel_e = !taken && ze == m;
        edz[k] = __fadd_rn(0.f, sel_e ? gv[k] : 0.f);
        taken = taken || sel_e;
        odz[k] = __fadd_rn(0.f, (has_o && !taken && zo == m) ? gv[k] : 0.f);
      }
      const int64_t off = (n * p.f_in * p.hw + px) * p.c + cg * V;
      if (has_c) {
        finish<T, V>(dident + off + (fe - 1) * frame,
                     dy + off + (fe - 1) * frame, slot(pv, 2), slot(pv, 3),
                     cdz, av, bv, sy, s1);
      }
      finish<T, V>(dident + off + fe * frame, dy + off + fe * frame,
                   slot(st, 0), slot(st, 1), edz, av, bv, sy, s1);
      if (has_o) {
        if (fo + 1 < p.f_out) {
#pragma unroll
          for (int k = 0; k < V; ++k) cdz[k] = odz[k];
        } else {
          finish<T, V>(dident + off + (fe + 1) * frame,
                       dy + off + (fe + 1) * frame, slot(st, 2),
                       slot(st, 3), odz, av, bv, sy, s1);
        }
      }
    }
    // refill the stage of step t-1, read for the last time above
    prefetch();
    const int slice = at.slice;
    at.next(p.f_out, p.lane_pixels);
    if (at.slice != slice) {
      // the slice's sums over the 8 pixel lanes: in each warp lane + 2 then
      // lane + 1 (16 and 8 apart in the warp), every lane taking part; then
      // the lower half's 4 lanes plus the upper half's
#pragma unroll
      for (int k = 0; k < V; ++k) {
#pragma unroll
        for (int d = 2 * kWarpGroups; d >= kWarpGroups; d >>= 1) {
          sy[k] = __fadd_rn(sy[k], __shfl_down_sync(0xffffffffu, sy[k], d));
          s1[k] = __fadd_rn(s1[k], __shfl_down_sync(0xffffffffu, s1[k], d));
        }
      }
      const bool head = lane < kWarpGroups;
      if (head && half == 1) {
        store_f32<V>(xchg[cw][gw][0], sy);
        store_f32<V>(xchg[cw][gw][1], s1);
      }
      __syncthreads();
      const int cgs = (sg + slice * p.slice_groups) * kGroups + gb;
      if (head && half == 0) {
        float uy[V], u1[V];
        load_f32<V>(xchg[cw][gw][0], uy);
        load_f32<V>(xchg[cw][gw][1], u1);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          sy[k] = __fadd_rn(sy[k], uy[k]);
          s1[k] = __fadd_rn(s1[k], u1[k]);
        }
        if (cgs < groups) {
          float* dst = out + (n * p.chunks + chunk) * 2 * p.c + cgs * V;
          store_f32<V>(dst, sy);
          store_f32<V>(dst + p.c, s1);
        }
      }
      __syncthreads();  // xchg is free for the next slice
      start_slice(at.slice);
    }
  }
  cp_async_wait<0>();

  if (p.chunks == 1) return;
  // the row's last block adds its chunks in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_block = atomicAdd(p.tickets + n, 1) == per_row - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int64_t width = 2 * static_cast<int64_t>(p.c);
  const float* src = p.part + n * p.chunks * width;
  for (int64_t i = tid; i < width; i += kThreads) {
    float acc = __ldcg(src + i);
    for (int j = 1; j < p.chunks; ++j) {
      acc = __fadd_rn(acc, __ldcg(src + j * width + i));
    }
    p.dab[n * width + i] = acc;
  }
}

template <typename T>
int launch(Args p, int64_t n, int threads, int lanes, int vec_, int stages,
           int smem, cudaStream_t st) {
  // the plan must be one this kernel runs (ops/kernels/tpool_fused.py)
  const int groups = p.c / vec<T>();
  const bool ok =
      threads == kThreads && lanes == kLanes && vec_ == vec<T>() &&
      stages == kStages && smem == kSmem && p.c % vec<T>() == 0 &&
      p.slices == (groups + kGroups - 1) / kGroups && p.slice_groups >= 1 &&
      p.slice_groups <= p.slices && p.chunk_pixels > 0 &&
      p.chunks == (p.hw + p.chunk_pixels - 1) / p.chunk_pixels &&
      p.lane_pixels == (p.chunk_pixels + kLanes - 1) / kLanes &&
      static_cast<int64_t>(p.slices) * p.lane_pixels * p.f_out <= INT32_MAX &&
      n * p.chunks * p.slice_groups <= INT32_MAX &&
      (p.chunks == 1 || (p.part != nullptr && p.tickets != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // raise the dynamic shared memory limit once for this instantiation (the
  // first call is eager: no graph capture is running)
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        tpool_fused_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  if (p.chunks > 1) {
    const cudaError_t e =
        cudaMemsetAsync(p.tickets, 0, n * sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tpool_fused_bwd_kernel<T><<<static_cast<unsigned int>(
                                  n * p.chunks * p.slice_groups),
                              kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Shapes are validated by the Python
// wrapper (C % 8 == 0, F >= 2, N % (R*S) == 0, (N/R) % S == 0, 16-byte
// aligned pointers); the plan (threads, lanes, vec, stages, smem, slices,
// slice_groups, chunks, chunk_pixels, lane_pixels) comes from bwd_plan and
// is checked here: one this kernel cannot run returns
// cudaErrorInvalidValue. part and tickets may be null when chunks == 1.
// Zeroes the tickets and launches on `stream`; returns the first CUDA
// error.
int tpool_fused_bwd(const void* y, const void* ident, const void* a,
                    const void* b, const void* ct, void* dident, void* dy,
                    void* part, void* tickets, void* dab, int dtype,
                    long long n, int f_in, long long hw, int c, int r, int s,
                    int threads, int lanes, int vec_, int stages, int smem,
                    int slices, int slice_groups, int chunks,
                    int chunk_pixels,
                    int lane_pixels, void* stream) {
  Args p;
  p.y = y;
  p.ident = ident;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.ct = ct;
  p.dident = dident;
  p.dy = dy;
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.dab = static_cast<float*>(dab);
  p.hw = hw;
  p.rows_per_rep = n / r;
  p.c = c;
  p.f_in = f_in;
  p.f_out = (f_in - 1) / 2 + 1;
  p.s = s;
  p.slices = slices;
  p.slice_groups = slice_groups;
  p.chunks = chunks;
  p.chunk_pixels = chunk_pixels;
  p.lane_pixels = lane_pixels;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(p, n, threads, lanes, vec_, stages, smem, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(p, n, threads, lanes, vec_, stages, smem,
                                 st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tpool_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
