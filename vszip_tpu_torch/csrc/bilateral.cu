// Bilateral's algorithm 2 (the "truncated" spatial window) for Hopper (sm_90a).
// The JAX package computes it in plain jnp (vszip_tpu/ops/bilateral.py); no
// Pallas kernel stands behind it.  One launch takes every processed plane of
// an op call (up to 3, each with its own size, radius, step and weights).
//
// For every sample of an (n, h, w) plane, with its "key" the joint ref's
// sample (or the source's own) and taps at (+-yy, +-xx) for yy, xx in 1,
// 1 + step, ... <= radius, edges replicated:
//   wsum = w0,  s = src(p) * w0                  (w0 = gs[0] * c)
//   for each (yy, xx), in that order:
//     for the taps (-yy, xx), (yy, xx), (-yy, -xx), (yy, -xx):
//       wr    = range weight of |key(p) - key(tap)|
//       rsum += wr,  acc += wr * src(tap)        (rsum, acc start at the first)
//     wsum += rsum * gs(yy, xx),  s += acc * gs(yy, xx)
//   out = s / wsum                               (IEEE division)
// stored as trunc(clamp(out + 0.5, 0, peak)) for integer planes, rounded to
// the plane's type for float ones.  The range weight of an index i is
//   exp(((min(i, upper) * scale)^2) * -0.5) * c
// with i the int32 |difference| for integer planes and, for float planes, the
// difference taken in the storage type (f16: __hsub), then
// trunc(min(1, |d|) * 65535 + 0.5) in f32.
//
// Exact arithmetic: the library builds with -fmad=false, so every product and
// sum rounds on its own as the plain torch version's (ops on whole planes)
// do; expf is CUDA's accurate one, the function torch's exp calls on the card
// (not __expf); the division is IEEE.  So every output equals the plain
// version's on the card bit for bit.
//
// Design.  The plain version runs about ten full-plane torch ops per tap, each
// a trip to device memory.  Here a block of 32 x 4 threads takes a 32 x 32
// tile of one frame of one plane: it loads the tile and its radius-wide halo
// into shared memory once, as f32 (and the ref's beside it), clamping the
// load indices to replicate the edges, so no padded copy is made; each thread
// then takes 8 outputs of one column, and every weight, product and sum stays
// in registers.  Per tap that is one shared load (two with a ref), the
// |difference|, the weight's steps (expf takes eight instructions, one of
// them MUFU.EX2) and three f32 updates, about 20 instructions: the kernel is
// bound by the instruction rate and by MUFU.EX2 sharing the MIO queue with the
// shared loads, not by bytes.  Where upper is at least every index the type
// can give (sigmaR >= 1/8 at full range), the clamp min(index, upper) is
// left out (kClamp).  The weight is computed, not read from a table: at 16
// bits a table holds 256 KB, more than a block's shared memory, and on noise
// a warp's 32 lanes would read 32 different lines of it per tap.  Computing
// each unordered pair's weight once (it is the same from p to q as from q to
// p) and handing it to the other output through shared memory halves the
// MUFU.EX2s but adds as many shared stores and loads to the same queue; on
// the H100 that ran 20% slower than this kernel.  Where the tile and halo
// exceed the 227 KB a block may use (radius > 104 without a ref, > 69 with
// one), a second instantiation reads every tap from device memory with
// clamped indices.
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns a CUDA error
// code (0 on success).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kTileW = 32, kThreadRows = 4, kRows = 8;  // outputs per thread, one column
constexpr int kTileH = kThreadRows * kRows;
constexpr int kThreads = kTileW * kThreadRows;
constexpr size_t kDefaultSmemBytes = 48 * 1024;

struct Plane {
  const void* src;
  const void* ref;  // the range key's plane: the source itself without a ref
  void* out;
  const float* swei;  // samples x samples spatial weights gs(yy, xx), row-major
  int h, w, radius, step, samples;
  int tiles_x, tiles, first_block;  // tiles per frame; the plane's first block
  float upper, scale, c, w0;
};

struct Args {
  Plane p[kMaxPlanes];
  int planes, n;
  float peak;
};

template <typename T>
__device__ __forceinline__ float load(const T* p) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half2float(*p);
  } else {
    return (float)*p;
  }
}

// |a - b| with the difference taken in T: exact for integers below 2^24 and
// for f32; f16 rounds it to f16 (a and b hold f16 values exactly).
template <typename T>
__device__ __forceinline__ float absdiff(float a, float b) {
  if constexpr (std::is_same<T, __half>::value) {
    return fabsf(__half2float(__hsub(__float2half_rn(a), __float2half_rn(b))));
  } else {
    return fabsf(a - b);
  }
}

// The range weight of |difference| d, step by step in f32.  Without kClamp
// upper is at least every index the type can give, so min(f, upper) is f.
template <typename T, bool kClamp>
__device__ __forceinline__ float range_weight(float d, float upper, float scale, float c) {
  float f;
  if constexpr (std::is_integral<T>::value) {
    f = d;  // the int32 index, exact in f32
  } else {
    const float m = d > 1.f ? 1.f : d;   // torch's clamp: NaN stays NaN (and indexes 0)
    f = (float)(int)(m * 65535.f + 0.5f);
  }
  f = (kClamp ? fminf(f, upper) : f) * scale;
  f = f * f;
  f = f * -0.5f;
  return expf(f) * c;
}

template <typename T>
__device__ __forceinline__ void put(T* o, float s, float wsum, float peak) {
  const float r = s / wsum;
  if constexpr (std::is_integral<T>::value) {
    *o = (T)(int)fminf(fmaxf(r + 0.5f, 0.f), peak);  // NaN -> 0, as torch's cast on the card
  } else if constexpr (std::is_same<T, __half>::value) {
    *o = __float2half_rn(r);
  } else {
    *o = r;
  }
}

template <typename T, bool kRef, bool kShared, bool kClamp>
__global__ void __launch_bounds__(kThreads) window_kernel(const Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int k = (a.planes > 2 && b >= a.p[2].first_block) ? 2
                : (a.planes > 1 && b >= a.p[1].first_block) ? 1 : 0;
  const Plane& pl = a.p[k];
  const int h = pl.h, w = pl.w, r = pl.radius, step = pl.step, samples = pl.samples;
  const float upper = pl.upper, scale = pl.scale, c = pl.c, w0 = pl.w0;
  const float* __restrict__ swei = pl.swei;
  const int local = b - pl.first_block;
  const int f = local / pl.tiles, t = local - f * pl.tiles;
  const int ty = t / pl.tiles_x, tx = t - ty * pl.tiles_x;
  const int x0 = tx * kTileW, y0 = ty * kTileH;
  const size_t plane = (size_t)h * w;
  const T* __restrict__ src = (const T*)pl.src + f * plane;
  const T* __restrict__ ref = (const T*)pl.ref + f * plane;
  const int lx = threadIdx.x, ly = threadIdx.y * kRows;  // the thread's first output in the tile
  const int x = x0 + lx;

  const int pitch = kTileW + 2 * r, rows = kTileH + 2 * r;
  float* tile = smem;
  float* rtile = kRef ? smem + (size_t)pitch * rows : smem;
  if (kShared) {
    for (int i = threadIdx.y; i < rows; i += kThreadRows) {
      const size_t yy = (size_t)min(max(y0 - r + i, 0), h - 1) * w;
      for (int j = lx; j < pitch; j += kTileW) {
        const size_t at = yy + min(max(x0 - r + j, 0), w - 1);
        tile[i * pitch + j] = load(src + at);
        if (kRef) rtile[i * pitch + j] = load(ref + at);
      }
    }
    __syncthreads();
  }
  // the key and the source value of output i's tap (dy, dx)
  auto tap = [&](int i, int dy, int dx, float& key, float& val) {
    if (kShared) {
      const int o = (ly + i + r + dy) * pitch + lx + r + dx;
      val = tile[o];
      key = kRef ? rtile[o] : val;
    } else {
      const size_t o = (size_t)min(max(y0 + ly + i + dy, 0), h - 1) * w +
                       min(max(x + dx, 0), w - 1);
      val = load(src + o);
      key = kRef ? load(ref + o) : val;
    }
  };

  float kc[kRows], wsum[kRows], s[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float v;
    tap(i, 0, 0, kc[i], v);
    wsum[i] = w0;
    s[i] = v * w0;
  }
  for (int gy = 0; gy < samples; ++gy) {
    const int yy = 1 + gy * step;
    for (int gx = 0; gx < samples; ++gx) {
      const int xx = 1 + gx * step;
      const float sw = __ldg(swei + gy * samples + gx);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float k1, v1, k2, v2, k3, v3, k4, v4;
        tap(i, -yy, xx, k1, v1);
        tap(i, yy, xx, k2, v2);
        tap(i, -yy, -xx, k3, v3);
        tap(i, yy, -xx, k4, v4);
        const float w1 = range_weight<T, kClamp>(absdiff<T>(kc[i], k1), upper, scale, c);
        const float w2 = range_weight<T, kClamp>(absdiff<T>(kc[i], k2), upper, scale, c);
        const float w3 = range_weight<T, kClamp>(absdiff<T>(kc[i], k3), upper, scale, c);
        const float w4 = range_weight<T, kClamp>(absdiff<T>(kc[i], k4), upper, scale, c);
        float rsum = w1 + w2;
        rsum = rsum + w3;
        rsum = rsum + w4;
        float acc = w1 * v1;
        acc = acc + w2 * v2;
        acc = acc + w3 * v3;
        acc = acc + w4 * v4;
        wsum[i] = wsum[i] + rsum * sw;
        s[i] = s[i] + acc * sw;
      }
    }
  }
  if (x >= w) return;
  T* out = (T*)pl.out + f * plane;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int y = y0 + ly + i;
    if (y < h) put(out + (size_t)y * w + x, s[i], wsum[i], a.peak);
  }
}

// Shared memory of one block's tile and halo at radius r.
size_t tile_bytes(int r, bool has_ref) {
  return (size_t)(kTileW + 2 * r) * (kTileH + 2 * r) * sizeof(float) * (has_ref ? 2 : 1);
}

template <typename T, bool kRef>
int launch(const Args& a, int blocks, int rmax, bool clamp, cudaStream_t s) {
  const size_t bytes = tile_bytes(rmax, kRef);
  const dim3 threads(kTileW, kThreadRows);
  if (bytes > kMaxSmemBytes) {
    window_kernel<T, kRef, false, true><<<blocks, threads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  auto kernel = clamp ? window_kernel<T, kRef, true, true> : window_kernel<T, kRef, true, false>;
  if (bytes > kDefaultSmemBytes) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, threads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int by_ref(bool has_ref, const Args& a, int blocks, int rmax, bool clamp, cudaStream_t s) {
  return has_ref ? launch<T, true>(a, blocks, rmax, clamp, s)
                 : launch<T, false>(a, blocks, rmax, clamp, s);
}

}  // namespace

extern "C" {

// Whether a launch whose largest radius is r keeps its tiles in shared memory.
int vz_bilateral_window_on_chip(int r, int has_ref) {
  return tile_bytes(r, has_ref != 0) <= kMaxSmemBytes;
}

// planes (1-3) planes of n frames of one type (dtype 0 u8, 1 u16, 2 f16, 3 f32)
// on one device.  Per plane p: ptrs[4p..4p+3] = src, ref (src without a ref),
// out, the samples^2 f32 spatial weights on the device; ints[5p..5p+4] = h, w,
// radius, step, samples; flts[4p..4p+3] = upper, scale, c, w0.  has_ref: some
// plane's ref is not its source.  peak: the integer output's largest value.
int vz_bilateral_window(const void* const* ptrs, const int* ints, const float* flts, int planes,
                        int n, int dtype, int has_ref, float peak, void* stream) {
  if (planes < 1 || planes > kMaxPlanes || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Args a{};
  a.planes = planes;
  a.n = n;
  a.peak = peak;
  long long blocks = 0;
  int rmax = 0;
  // whether some plane's upper lies below an index the type can hold
  const float top = dtype == 0 ? 255.f : 65535.f;
  bool clamp = false;
  for (int i = 0; i < planes; ++i) {
    Plane& p = a.p[i];
    p.src = ptrs[4 * i];
    p.ref = ptrs[4 * i + 1];
    p.out = const_cast<void*>(ptrs[4 * i + 2]);
    p.swei = (const float*)ptrs[4 * i + 3];
    p.h = ints[5 * i];
    p.w = ints[5 * i + 1];
    p.radius = ints[5 * i + 2];
    p.step = ints[5 * i + 3];
    p.samples = ints[5 * i + 4];
    if (p.h < 1 || p.w < 1 || p.step < 1 || p.samples < 1 ||
        1 + (p.samples - 1) * p.step > p.radius) {  // every tap within the halo
      return (int)cudaErrorInvalidValue;
    }
    p.upper = flts[4 * i];
    p.scale = flts[4 * i + 1];
    p.c = flts[4 * i + 2];
    p.w0 = flts[4 * i + 3];
    p.tiles_x = (p.w + kTileW - 1) / kTileW;
    p.tiles = p.tiles_x * ((p.h + kTileH - 1) / kTileH);
    p.first_block = (int)blocks;
    blocks += (long long)n * p.tiles;
    rmax = p.radius > rmax ? p.radius : rmax;
    clamp = clamp || p.upper < top;
  }
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return by_ref<uint8_t>(has_ref, a, (int)blocks, rmax, clamp, s);
    case 1: return by_ref<uint16_t>(has_ref, a, (int)blocks, rmax, clamp, s);
    case 2: return by_ref<__half>(has_ref, a, (int)blocks, rmax, clamp, s);
    case 3: return by_ref<float>(has_ref, a, (int)blocks, rmax, clamp, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
