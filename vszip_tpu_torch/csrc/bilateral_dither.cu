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
// lists (the TPU has no gather).  Here B17 (and B18 where a band's tile does
// not fit, below) takes one output pixel per thread of a 32x16 block tile.
// The block first fills shared memory with the f32 tile and its (r-1) halo
// straight from the native plane with mirrored indices (and the ref's, when
// given), so no padded cache is materialised; B18 there turns its table into
// shared-memory offsets (dy * pitch + dx) when it fits beside the tile, and
// otherwise reads the int16 pairs through the read-only cache.  Where the
// tile and halo exceed the 227 KB a block may use (r >= 110 without a ref,
// r >= 75 with one), a second instantiation reads every tap from device
// memory with mirrored indices.
//
// B18's band layout (subspl_kernel).  On the 32x16 tile a warp's 32 pixels
// took 8 lists, so each tap's offset and value loads hit the banks at
// random, and the tile's fill took 5.6 elements of about 48 instructions
// each per output pixel.  Pixel (y, x)'s list advances every 4 columns and
// repeats every 92, so lane (i, j) of warp g takes column 4g + i + 92j of a
// 736-column band: the warp reads one list, one broadcast offset per tap
// (four in one 16-byte load), and values on 32 distinct banks.  A warp
// splits its eight 92-column groups over the same row of 8 frames (a
// 92-column band), or of 1, 2 or 4 (736, 368, 184 columns) where the clip
// has fewer frames or the tile does not fit: 92-column bands waste the
// fewest lanes past a plane's edge (1920 and 960 columns: 99% and 95% of
// lanes busy, where 736-column bands keep 87% and 65%), and on 1080p luma
// they cost the same as 184-column bands, whose smaller halo share lets
// more rows fit (PERF.md).  A block of 23 warps takes the most rows that
// fit in shared memory beside the table (22 at r 16), fills its tile by
// 16-byte loads where rows are 16-byte aligned, and walks each column down
// two rows at a time.  Each tap then issues 9.25 instructions: the value's load, a quarter of the offsets'
// load, its address and the 7 f32 operations.
//
// What bounds them: the f32 instructions.  At r = 8, B17's 225 taps take
// about 1,600 issued f32 instructions per pixel against 4 bytes of u16 in
// and out; B18's 30 taps at the default r = 16 take about 220.  Both are
// far above the bytes' 0.24 ms per 64 frames of 1080p YUV420P16.  B18's
// band kernel issues about 1.3 instructions per f32 one it needs, and its
// block (one per SM: the tile fills shared memory) waits on its fill for
// about a tenth of its time.
//
// Plain C interface, loaded with ctypes.  Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns a CUDA error
// code (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTileW = 32, kTileH = 16;  // one thread per output pixel
constexpr int kLists = 23;
constexpr int kMaxGridZ = 65535;
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

// B18 on the 32x16 tile of dense_kernel, for tables and radii the band
// layout below cannot hold.  kTab: 0 the table as shared-memory offsets
// beside the tile, 1 the int16 pairs through the read-only cache with the
// tile in shared memory, 2 both from device memory.
template <typename T, bool kRef, int kTab>
__global__ void __launch_bounds__(kTileW* kTileH)
    subspl_tile_kernel(const T* __restrict__ src, const T* __restrict__ ref, T* __restrict__ out,
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

// ---- B18's band layout (see the header) ------------------------------------
// Lane (i, j) of warp g reads column 4g + i + 92j; 92 = 28 (mod 32) puts the
// 32 lanes of one frame on 32 banks.  With `frames` frames per warp (8 /
// frames groups each), the frames' tiles lie `stride` elements apart with
// stride = 32 / frames (mod 32), or (mod 16) for the float2 tile with a ref,
// whose 8-byte loads serve half a warp at a time: the banks stay distinct.
constexpr int kBandWarps = kLists;             // warp g: the columns of group g (mod 23)
constexpr int kBandThreads = 32 * kBandWarps;  // 736
constexpr int kListCols = 4 * kLists;          // 92: columns between two groups of a list
constexpr int kMaxBandRows = 64;

// One block's share: `frames` frames x `cols` columns x `rows` rows, and its
// shared-memory tile of `tile_rows` rows of `pitch` elements per frame,
// `stride` elements apart; `kp` table entries per list (k rounded up to 4).
// div_*: 2^32 / divisor + 1, for exact __umulhi division of small indices.
struct Band {
  int frames, cols, rows, pitch, tile_rows, stride, kp;
  unsigned div_chunks, div_rows;
};

template <bool kRef>
struct Elem {
  using type = float;
};
template <>
struct Elem<true> {
  using type = float2;  // (source, ref)
};

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __int_as_float(0x4B000000 | (uint32_t)v) - 8388608.f;  // exact below 2^23
  }
}

// Element e of a 16-byte chunk of T.
template <typename T>
__device__ __forceinline__ float chunk_f32(const uint4& a, int e) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else if constexpr (sizeof(T) == 2) {
    return to_f32<uint16_t>((uint16_t)(w[e >> 1] >> (16 * (e & 1))));
  } else {
    return to_f32<uint8_t>((uint8_t)(w[e >> 2] >> (8 * (e & 3))));
  }
}

// The band's tile: for each of the band's frames, rows y0-halo.. and columns
// ox.. of the plane, mirrored (clamped where no pixel reads), as f32, with
// the ref's beside each value.  Items are chunks of V elements: with kVec
// (rows 16-byte aligned, w and ox multiples of V) the chunks inside the row
// come by 16-byte loads and go out as 16-byte stores; chunks past the row's
// ends, and every element without kVec (V = 1), by single mirrored loads.
// kBatch items per thread are loaded before any is stored.
template <typename T, bool kRef, bool kVec>
__device__ __forceinline__ void fill_band(typename Elem<kRef>::type* tile, const T* src,
                                          const T* ref, int f0, int ox, int y0,
                                          const Params& p, const Band& b) {
  using E = typename Elem<kRef>::type;
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  constexpr int kBatch = kRef ? 2 : 4;
  const int halo = p.r - 1, chunks = b.pitch / V;
  const int items = b.frames * b.tile_rows * chunks;
  const size_t plane = (size_t)p.h * p.w;
  for (int i0 = threadIdx.x; i0 < items; i0 += kBatch * kBandThreads) {
    uint4 a[kBatch], ar[kBatch];
    int dst[kBatch], gx[kBatch];
    size_t row[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kBandThreads;
      dst[u] = -1;
      if (i >= items) continue;
      const int q = __umulhi(i, b.div_chunks), c = i - q * chunks;
      const int fs = __umulhi(q, b.div_rows), tr = q - fs * b.tile_rows;
      const int f = min(f0 + fs, p.n - 1);  // frames past the clip: lanes that store nothing
      const int yy = min(max(mirror(y0 - halo + tr, p.h), 0), p.h - 1);
      row[u] = (size_t)f * plane + (size_t)yy * p.w;
      gx[u] = ox + c * V;
      dst[u] = fs * b.stride + tr * b.pitch + c * V;
      if (kVec && gx[u] >= 0 && gx[u] < p.w) {
        a[u] = __ldg(reinterpret_cast<const uint4*>(src + row[u] + gx[u]));
        if (kRef) ar[u] = __ldg(reinterpret_cast<const uint4*>(ref + row[u] + gx[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (dst[u] < 0) continue;
      E* d = tile + dst[u];
      if (kVec && gx[u] >= 0 && gx[u] < p.w) {
        float v[V], r[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          v[e] = chunk_f32<T>(a[u], e);
          r[e] = kRef ? chunk_f32<T>(ar[u], e) : 0.f;
        }
        float4* d4 = reinterpret_cast<float4*>(d);
        if constexpr (kRef) {
#pragma unroll
          for (int e = 0; e < V; e += 2) {
            d4[e / 2] = make_float4(v[e], r[e], v[e + 1], r[e + 1]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < V; e += 4) {
            d4[e / 4] = make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const size_t at = row[u] + min(max(mirror(gx[u] + e, p.w), 0), p.w - 1);
          if constexpr (kRef) {
            d[e] = make_float2((float)src[at], (float)ref[at]);
          } else {
            d[e] = (float)src[at];
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void center(float v, float& cen, float& cref) { cen = cref = v; }
__device__ __forceinline__ void center(float2 v, float& cen, float& cref) {
  cen = v.x;
  cref = v.y;
}

__device__ __forceinline__ void tap_e(float v, float cen, float cref, const Params& p, float& s,
                                      float& sw) {
  tap<false>(v, 0.f, cen, cref, p, s, sw);
}
__device__ __forceinline__ void tap_e(float2 v, float cen, float cref, const Params& p, float& s,
                                      float& sw) {
  tap<true>(v.x, v.y, cen, cref, p, s, sw);
}

// B18 on bands: a block of 23 warps computes b.rows rows of a b.cols-column
// band of b.frames frames.  Its table sits in shared memory as offsets
// dy * pitch + dx into the tile, kp per list; each thread walks its column
// down the rows, two rows at a time, reading four offsets of each row's list
// in one broadcast 16-byte load.
template <typename T, bool kRef, bool kVec>
__global__ void __launch_bounds__(kBandThreads, 1)
    subspl_kernel(const T* __restrict__ src, const T* __restrict__ ref, T* __restrict__ out,
                  const int* __restrict__ start, const short2* __restrict__ dyx, Params p,
                  Band b) {
  using E = typename Elem<kRef>::type;
  extern __shared__ float4 smem4[];
  E* tile = reinterpret_cast<E*>(smem4);
  int* offs = reinterpret_cast<int*>(tile + (size_t)b.frames * b.stride);
  constexpr int V = kVec ? 16 / sizeof(T) : 1;
  const int halo = p.r - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = 8 / b.frames;  // 92-column groups of one frame in a warp
  const int fs = (lane >> 2) / groups, jj = (lane >> 2) - fs * groups;
  const int x0 = blockIdx.x * b.cols, y0 = blockIdx.y * b.rows;
  const int ox = (x0 - halo) - (((x0 - halo) % V) + V) % V;  // the tile's first column
  const int x = x0 + 4 * warp + (lane & 3) + kListCols * jj;
  for (int i = threadIdx.x; i < kLists * b.kp; i += kBandThreads) {
    const int l = i / b.kp, j = i - l * b.kp;
    const short2 e = j < p.k ? dyx[l * p.k + j] : make_short2(0, 0);
    offs[i] = e.x * b.pitch + e.y;
  }
  const size_t plane = (size_t)p.h * p.w;
  const E* col = tile + fs * b.stride + halo * b.pitch + (x - ox);  // (row y0, column x)
  // lane l holds the table offset of this warp's list in rows y0+l and
  // y0+32+l (b.rows <= 64)
  const int list0 = ((__ldg(start + min(y0 + lane, p.h - 1)) + warp) % kLists) * b.kp;
  const int list1 = ((__ldg(start + min(y0 + 32 + lane, p.h - 1)) + warp) % kLists) * b.kp;
  const int rows = min(b.rows, p.h - y0);
  for (int f0 = blockIdx.z * b.frames; f0 < p.n; f0 += gridDim.z * b.frames) {
    __syncthreads();  // the previous frames' taps are read (and the table is in)
    fill_band<T, kRef, kVec>(tile, src, ref, f0, ox, y0, p, b);
    __syncthreads();
    const int f = f0 + fs;
    const bool keep = f < p.n && x < p.w;
    // two rows at a time (two lists, two sums), the second a copy of the
    // first past the block's last row
    for (int rr = 0; rr < rows; rr += 2) {
      const int r1 = min(rr + 1, rows - 1);
      const int* lo0 = offs + __shfl_sync(0xffffffffu, rr < 32 ? list0 : list1, rr & 31);
      const int* lo1 = offs + __shfl_sync(0xffffffffu, r1 < 32 ? list0 : list1, r1 & 31);
      const E* t0 = col + rr * b.pitch;
      const E* t1 = col + r1 * b.pitch;
      float cen0, cref0, cen1, cref1;
      center(*t0, cen0, cref0);
      center(*t1, cen1, cref1);
      float acc0 = 0.f, accw0 = 0.f, acc1 = 0.f, accw1 = 0.f;
      int j = 0;
      for (; j + 4 <= p.k; j += 4) {
        const int4 o0 = *reinterpret_cast<const int4*>(lo0 + j);
        const int4 o1 = *reinterpret_cast<const int4*>(lo1 + j);
        tap_e(t0[o0.x], cen0, cref0, p, acc0, accw0);
        tap_e(t1[o1.x], cen1, cref1, p, acc1, accw1);
        tap_e(t0[o0.y], cen0, cref0, p, acc0, accw0);
        tap_e(t1[o1.y], cen1, cref1, p, acc1, accw1);
        tap_e(t0[o0.z], cen0, cref0, p, acc0, accw0);
        tap_e(t1[o1.z], cen1, cref1, p, acc1, accw1);
        tap_e(t0[o0.w], cen0, cref0, p, acc0, accw0);
        tap_e(t1[o1.w], cen1, cref1, p, acc1, accw1);
      }
      for (; j < p.k; ++j) {
        tap_e(t0[lo0[j]], cen0, cref0, p, acc0, accw0);
        tap_e(t1[lo1[j]], cen1, cref1, p, acc1, accw1);
      }
      if (keep) {
        T* o = out + f * plane + (size_t)(y0 + rr) * p.w + x;
        put(o, cen0 + acc0 / fmaxf(accw0, p.swmin), p.peak);
        if (r1 > rr) put(o + p.w, cen1 + acc1 / fmaxf(accw1, p.swmin), p.peak);
      }
    }
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

// The band shape whose tile and table fit a block's shared memory (elements
// of `elem_bytes`, rows padded to chunks of V), or false: the most frames per
// warp that the clip fills (the largest power of two up to min(8, n)), fewer
// where their tile does not fit, and the most rows that fit.
bool plan_band(const Params& p, int elem_bytes, int V, Band& b) {
  const int halo = p.r - 1, kp = (p.k + 3) & ~3;
  const size_t tab = (size_t)kLists * kp * sizeof(int);
  const int mod = elem_bytes == 8 ? 16 : 32;
  int frames = 8;
  while (frames > p.n && frames > 1) frames /= 2;
  for (; frames >= 1; frames /= 2) {
    b.frames = frames;
    b.cols = kListCols * 8 / frames;
    b.kp = kp;
    const int align = V > 4 ? V : 4;
    b.pitch = (b.cols + 2 * halo + V - 1 + align - 1) / align * align;
    auto shape = [&](int rows) {
      b.rows = rows;
      b.tile_rows = rows + 2 * halo > 1 ? rows + 2 * halo : 2;
      const int words = b.tile_rows * b.pitch, target = (32 / frames) % mod;
      b.stride = words + ((target - words) % mod + mod) % mod;
      return (size_t)frames * b.stride * elem_bytes + tab;
    };
    int rows = p.h < kMaxBandRows ? p.h : kMaxBandRows;
    while (rows > 0 && shape(rows) > kMaxSmemBytes) --rows;
    if (rows == 0) continue;
    b.div_chunks = (unsigned)(0x100000000ull / (b.pitch / V) + 1);
    b.div_rows = (unsigned)(0x100000000ull / b.tile_rows + 1);
    return true;
  }
  return false;
}

template <typename T, bool kRef, bool kVec>
int launch_band(const T* x, const T* rr, T* out, const int* start, const short2* dyx,
                const Params& p, const Band& b, cudaStream_t s) {
  using E = typename Elem<kRef>::type;
  const size_t bytes =
      (size_t)b.frames * b.stride * sizeof(E) + (size_t)kLists * b.kp * sizeof(int);
  auto kernel = subspl_kernel<T, kRef, kVec>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int groups = (p.n + b.frames - 1) / b.frames;
  const dim3 grid((p.w + b.cols - 1) / b.cols, (p.h + b.rows - 1) / b.rows,
                  groups < kMaxGridZ ? groups : kMaxGridZ);
  kernel<<<grid, kBandThreads, bytes, s>>>(x, rr, out, start, dyx, p, b);
  return (int)cudaGetLastError();
}

// Whether B18 can fill its tiles by 16-byte loads: rows 16-byte aligned.
template <typename T, bool kRef>
bool vec_rows(const void* src, const void* ref, const Params& p) {
  return p.w % (16 / sizeof(T)) == 0 && (uintptr_t)src % 16 == 0 &&
         (!kRef || (uintptr_t)ref % 16 == 0);
}

template <typename T, bool kRef>
bool plan_of(const void* src, const void* ref, const Params& p, Band& b) {
  return plan_band(p, kRef ? 8 : 4, vec_rows<T, kRef>(src, ref, p) ? 16 / sizeof(T) : 1, b);
}

template <typename T, bool kRef>
int subspl(const void* src, const void* ref, void* out, const void* start, const void* dyx,
           const Params& p, cudaStream_t s) {
  const T* x = (const T*)src;
  const T* rr = (const T*)ref;
  const int* st = (const int*)start;
  const short2* t = (const short2*)dyx;
  const bool vec = vec_rows<T, kRef>(src, ref, p);
  Band b;
  if (plan_of<T, kRef>(src, ref, p, b)) {
    return vec ? launch_band<T, kRef, true>(x, rr, (T*)out, st, t, p, b, s)
               : launch_band<T, kRef, false>(x, rr, (T*)out, st, t, p, b, s);
  }
  const size_t bytes = tile_bytes(p.r, kRef), tab = (size_t)kLists * p.k * sizeof(int);
  if (bytes + tab <= kMaxSmemBytes) {
    return launch(subspl_tile_kernel<T, kRef, 0>, bytes + tab, p, s, x, rr, (T*)out, st, t);
  }
  if (bytes <= kMaxSmemBytes) {
    return launch(subspl_tile_kernel<T, kRef, 1>, bytes, p, s, x, rr, (T*)out, st, t);
  }
  return launch(subspl_tile_kernel<T, kRef, 2>, 0, p, s, x, rr, (T*)out, st, t);
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

// The band vz_bd_subspl launches for these arguments: out[0..2] = frames,
// columns and rows per block; 0 where it takes the 32x16 tile kernel.
int vz_bd_subspl_band(const void* src, const void* ref, int dtype, int has_ref, int n, int h,
                      int w, int r, int k, int* out) {
  const Params p{n, h, w, r, k, 0.f, 0.f, 0.f, 0.f};
  return by_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    Band b;
    const bool band =
        has_ref ? plan_of<T, true>(src, ref, p, b) : plan_of<T, false>(src, ref, p, b);
    if (band) {
      out[0] = b.frames;
      out[1] = b.cols;
      out[2] = b.rows;
    }
    return (int)band;
  });
}

}  // extern "C"
