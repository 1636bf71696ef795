// BilateralDither's window kernels for Hopper (sm_90a), the CUDA counterparts of
//   dense_kernel   B17 dense_blur_pallas   (vszip_tpu/kernels/bilateral_dither_pallas.py)
//   subspl_kernel  B18 subspl_blur_pallas  (the same file)
// For every pixel of an (n, h, w) u8/u16/f32 plane (reference
// src/filters/bilateral_dither.zig), over a set of window offsets (dy, dx):
//   w   = max(min(m - |vr - cen_ref|, wmax), 0)     (vr, cen_ref: the joint ref
//                                                     plane, or the source)
//   s  += (v - cen) * w,   sw += w                   in f32, in the reference's order
//   p   = cen + s / max(sw, swmin)                   (IEEE division)
//   out = floor(clip(p, 0, peak) + 0.5) for integer planes, p for f32.
// B17 visits every offset of the (2r-1)^2 window 1-r..r-1 in (dy, dx)
// row-major order.  B18 visits the k points of list (start[y] + (x >> 2)) % 23
// of a (23, k) table of (dy, dx) int16 pairs, in list order.  Taps outside
// the plane read its 'symmetric' mirror (i < 0 -> -1-i, i >= n -> 2n-1-i);
// the op keeps r <= the plane's sides, so one reflection suffices.
//
// Exact arithmetic: the library builds with -fmad=false (no a*b+c
// contraction), divides with nvcc's default IEEE division, and rounds the
// integer store with floorf(... + 0.5f), round half up as the reference's
// floor(x + 0.5), not rintf's half to even; m, wmax and swmin arrive as the
// f32 values the op rounded them to.  So every output equals the plain torch
// version's bit for bit.
//
// The TPU kernels pad the plane into an f32 cache in HBM, roll a VMEM slab
// per tap, and select each sub-sampled tap through a chain over all 23
// lists (the TPU has no gather).  Here one thread computes one output pixel
// of a 32x16 block tile.  The block first fills shared memory with the f32
// tile and its (r-1) halo straight from the native plane with mirrored
// indices (and the ref's, when given), so no padded cache is materialised;
// B18 also turns its table into shared-memory offsets (dy * pitch + dx) when
// it fits beside the tile, and otherwise reads the int16 pairs through the
// read-only cache.  Each tap is then one shared-memory load (two with a
// ref) and 7 f32 instructions (8 with a ref; -fmad=false keeps the multiply
// and the add apart).  Where the tile and halo exceed the 227 KB a block may
// use (r >= 110 without a ref, r >= 75 with one), a second instantiation
// reads every tap from device memory with mirrored indices.
//
// What bounds them: the f32 instructions.  At r = 8, B17's 225 taps take
// about 1,600 issued f32 instructions per pixel against 4 bytes of u16 in
// and out; B18's 30 taps at the default r = 16 take about 220.  Both are
// far above the bytes' 0.24 ms per 64 frames of 1080p YUV420P16.
//
// Plain C interface, loaded with ctypes.  Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns a CUDA error
// code (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileW = 32, kTileH = 16;  // one thread per output pixel
constexpr int kLists = 23;
constexpr int kMaxGridZ = 65535;
constexpr size_t kMaxSmemBytes = 232448;
constexpr size_t kDefaultSmemBytes = 48 * 1024;

struct Params {
  int n, h, w, r, k;
  float m, wmax, swmin, peak;
};

__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -1 - i : (i >= n ? 2 * n - 1 - i : i);
}

template <typename T>
__device__ __forceinline__ void put(T* o, float p, float peak) {
  if constexpr (std::is_same<T, float>::value) {
    *o = p;
  } else {
    *o = (T)(int)floorf(fminf(fmaxf(p, 0.f), peak) + 0.5f);
  }
}

// One tap: its weight from the ref values, its term from the source's.
template <bool kRef>
__device__ __forceinline__ void tap(float v, float vr, float cen, float cref, const Params& p,
                                    float& s, float& sw) {
  const float wgt = fmaxf(fminf(p.m - fabsf((kRef ? vr : v) - cref), p.wmax), 0.f);
  s = s + (v - cen) * wgt;
  sw = sw + wgt;
}

// Fill `tile` (and `rtile` with a ref) with the f32 values of rows
// y0-halo.. and columns x0-halo.. of the frame, mirrored; positions that no
// pixel of the plane reads are clamped into it.
template <typename T, bool kRef>
__device__ __forceinline__ void fill(float* tile, float* rtile, const T* s, const T* rr,
                                     int x0, int y0, int halo, int pitch, int rows,
                                     const Params& p) {
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < pitch * rows; i += kTileW * kTileH) {
    const int yy = min(max(mirror(y0 - halo + i / pitch, p.h), 0), p.h - 1);
    const int xx = min(max(mirror(x0 - halo + i % pitch, p.w), 0), p.w - 1);
    const size_t at = (size_t)yy * p.w + xx;
    tile[i] = (float)s[at];
    if (kRef) rtile[i] = (float)rr[at];
  }
}

template <typename T, bool kRef, bool kShared>
__global__ void __launch_bounds__(kTileW* kTileH)
    dense_kernel(const T* __restrict__ src, const T* __restrict__ ref, T* __restrict__ out,
                 Params p) {
  extern __shared__ float smem[];
  const int halo = p.r - 1, taps = 2 * p.r - 1;
  const int pitch = kTileW + 2 * halo, rows = kTileH + 2 * halo;
  float* tile = smem;
  float* rtile = smem + (size_t)pitch * rows;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const bool inside = x < p.w && y < p.h;
  const size_t plane = (size_t)p.h * p.w;
  for (int f = blockIdx.z; f < p.n; f += gridDim.z) {
    const T* s = src + f * plane;
    const T* rr = ref + f * plane;
    float acc = 0.f, accw = 0.f, cen, cref;
    if (kShared) {
      __syncthreads();  // the previous frame's taps are read
      fill<T, kRef>(tile, rtile, s, rr, x0, y0, halo, pitch, rows, p);
      __syncthreads();
      if (!inside) continue;
      const int c = (threadIdx.y + halo) * pitch + threadIdx.x + halo;
      cen = tile[c];
      cref = kRef ? rtile[c] : cen;
      for (int dy = 0; dy < taps; ++dy) {
        const float* row = tile + (threadIdx.y + dy) * pitch + threadIdx.x;
        const float* rrow = rtile + (threadIdx.y + dy) * pitch + threadIdx.x;
        for (int dx = 0; dx < taps; ++dx) {
          tap<kRef>(row[dx], kRef ? rrow[dx] : 0.f, cen, cref, p, acc, accw);
        }
      }
    } else {
      if (!inside) continue;
      const size_t at = (size_t)y * p.w + x;
      cen = (float)s[at];
      cref = kRef ? (float)rr[at] : cen;
      for (int dy = -halo; dy <= halo; ++dy) {
        const size_t yy = (size_t)mirror(y + dy, p.h) * p.w;
        for (int dx = -halo; dx <= halo; ++dx) {
          const size_t a = yy + mirror(x + dx, p.w);
          tap<kRef>((float)s[a], kRef ? (float)rr[a] : 0.f, cen, cref, p, acc, accw);
        }
      }
    }
    put(out + f * plane + (size_t)y * p.w + x, cen + acc / fmaxf(accw, p.swmin), p.peak);
  }
}

// kTab: 0 the table as shared-memory offsets beside the tile, 1 the int16
// pairs through the read-only cache with the tile in shared memory, 2 both
// from device memory.
template <typename T, bool kRef, int kTab>
__global__ void __launch_bounds__(kTileW* kTileH)
    subspl_kernel(const T* __restrict__ src, const T* __restrict__ ref, T* __restrict__ out,
                  const int* __restrict__ start, const short2* __restrict__ dyx, Params p) {
  extern __shared__ float smem[];
  const int halo = p.r - 1;
  const int pitch = kTileW + 2 * halo, rows = kTileH + 2 * halo;
  const size_t tile_words = (size_t)pitch * rows;
  float* tile = smem;
  float* rtile = smem + tile_words;
  int* offs = (int*)(smem + (kRef ? 2 : 1) * tile_words);
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  const bool inside = x < p.w && y < p.h;
  const size_t plane = (size_t)p.h * p.w;
  if (kTab == 0) {
    const int tid = threadIdx.y * kTileW + threadIdx.x;
    for (int i = tid; i < kLists * p.k; i += kTileW * kTileH) {
      const short2 e = dyx[i];
      offs[i] = e.x * pitch + e.y;
    }
  }
  const int list = inside ? (start[y] + (x >> 2)) % kLists : 0;
  for (int f = blockIdx.z; f < p.n; f += gridDim.z) {
    const T* s = src + f * plane;
    const T* rr = ref + f * plane;
    float acc = 0.f, accw = 0.f, cen, cref;
    if (kTab != 2) {
      __syncthreads();  // the previous frame's taps are read
      fill<T, kRef>(tile, rtile, s, rr, x0, y0, halo, pitch, rows, p);
      __syncthreads();
      if (!inside) continue;
      const int c = (threadIdx.y + halo) * pitch + threadIdx.x + halo;
      cen = tile[c];
      cref = kRef ? rtile[c] : cen;
      const float* tc = tile + c;
      const float* rc = rtile + c;
      for (int j = 0; j < p.k; ++j) {
        int o;
        if (kTab == 0) {
          o = offs[list * p.k + j];
        } else {
          const short2 e = __ldg(dyx + list * p.k + j);
          o = e.x * pitch + e.y;
        }
        tap<kRef>(tc[o], kRef ? rc[o] : 0.f, cen, cref, p, acc, accw);
      }
    } else {
      if (!inside) continue;
      const size_t at = (size_t)y * p.w + x;
      cen = (float)s[at];
      cref = kRef ? (float)rr[at] : cen;
      for (int j = 0; j < p.k; ++j) {
        const short2 e = __ldg(dyx + list * p.k + j);
        const size_t a = (size_t)mirror(y + e.x, p.h) * p.w + mirror(x + e.y, p.w);
        tap<kRef>((float)s[a], kRef ? (float)rr[a] : 0.f, cen, cref, p, acc, accw);
      }
    }
    put(out + f * plane + (size_t)y * p.w + x, cen + acc / fmaxf(accw, p.swmin), p.peak);
  }
}

size_t tile_bytes(int r, bool has_ref) {
  const size_t pitch = kTileW + 2 * (size_t)(r - 1), rows = kTileH + 2 * (size_t)(r - 1);
  return (has_ref ? 2 : 1) * pitch * rows * sizeof(float);
}

dim3 grid_of(const Params& p) {
  return dim3((p.w + kTileW - 1) / kTileW, (p.h + kTileH - 1) / kTileH,
              p.n < kMaxGridZ ? p.n : kMaxGridZ);
}

template <typename K, typename... A>
int launch(K kernel, size_t bytes, const Params& p, cudaStream_t s, A... args) {
  if (bytes > kDefaultSmemBytes) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid_of(p), dim3(kTileW, kTileH), bytes, s>>>(args..., p);
  return (int)cudaGetLastError();
}

// Calls f with a null pointer of the plane's element type (0 u8, 1 u16, 2 f32).
template <typename F>
int by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0: return f((uint8_t*)nullptr);
    case 1: return f((uint16_t*)nullptr);
    case 2: return f((float*)nullptr);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool kRef>
int dense(const void* src, const void* ref, void* out, const Params& p, cudaStream_t s) {
  const size_t bytes = tile_bytes(p.r, kRef);
  const T* x = (const T*)src;
  const T* rr = (const T*)ref;
  if (bytes <= kMaxSmemBytes) {
    return launch(dense_kernel<T, kRef, true>, bytes, p, s, x, rr, (T*)out);
  }
  return launch(dense_kernel<T, kRef, false>, 0, p, s, x, rr, (T*)out);
}

template <typename T, bool kRef>
int subspl(const void* src, const void* ref, void* out, const void* start, const void* dyx,
           const Params& p, cudaStream_t s) {
  const size_t bytes = tile_bytes(p.r, kRef), tab = (size_t)kLists * p.k * sizeof(int);
  const T* x = (const T*)src;
  const T* rr = (const T*)ref;
  const int* st = (const int*)start;
  const short2* t = (const short2*)dyx;
  if (bytes + tab <= kMaxSmemBytes) {
    return launch(subspl_kernel<T, kRef, 0>, bytes + tab, p, s, x, rr, (T*)out, st, t);
  }
  if (bytes <= kMaxSmemBytes) {
    return launch(subspl_kernel<T, kRef, 1>, bytes, p, s, x, rr, (T*)out, st, t);
  }
  return launch(subspl_kernel<T, kRef, 2>, 0, p, s, x, rr, (T*)out, st, t);
}

}  // namespace

extern "C" {

// src, ref, out: (n, h, w) contiguous planes of one type (dtype 0 u8, 1 u16,
// 2 f32) on one device; ref is read only when has_ref; 1 <= r <= min(h, w).
int vz_bd_dense(const void* src, const void* ref, void* out, int dtype, int has_ref, int n,
                int h, int w, int r, float m, float wmax, float swmin, float peak,
                void* stream) {
  if (n == 0) return 0;
  const Params p{n, h, w, r, 0, m, wmax, swmin, peak};
  cudaStream_t s = (cudaStream_t)stream;
  return by_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return has_ref ? dense<T, true>(src, ref, out, p, s) : dense<T, false>(src, ref, out, p, s);
  });
}

// As vz_bd_dense, plus start: (h,) int32 start list per row; dyx: (23, k)
// int16 (dy, dx) pairs, each within +-(r-1).
int vz_bd_subspl(const void* src, const void* ref, void* out, const void* start,
                 const void* dyx, int dtype, int has_ref, int n, int h, int w, int r, int k,
                 float m, float wmax, float swmin, float peak, void* stream) {
  if (n == 0) return 0;
  const Params p{n, h, w, r, k, m, wmax, swmin, peak};
  cudaStream_t s = (cudaStream_t)stream;
  return by_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return has_ref ? subspl<T, true>(src, ref, out, start, dyx, p, s)
                   : subspl<T, false>(src, ref, out, start, dyx, p, s);
  });
}

}  // extern "C"
