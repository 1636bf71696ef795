// Deband centre kernels for Hopper (sm_90a), the CUDA counterparts of the
// Pallas kernels
//   center_kernel  B5 deband_center_pallas     (vszip_tpu/kernels/deband_pallas.py)
//                  the separable int modes 1, 3, 4, 5, 6: taps x[y±v, x]
//                  (rows) and/or x[y, x±v] (columns) from one per-pixel
//                  magnitude plane v
//   m2_tile_kernel B6 deband_m2_center_pallas  (vszip_tpu/kernels/deband_m2_pallas.py)
//                  int mode 2: key = (val1+rmax)(2rmax+1) + (val2+rmax) gives
//                  r1 = (y+val2, x+val1), r3 = (y-val2, x-val1),
//                  r2 = (y-val1, x+val2), r4 = (y+val1, x-val2), its taps
//                  from a shared-memory frame tile (rmax <= 50)
//   m2_kernel      the same with the taps loaded from device memory, for
//                  ranges whose tiles do not fit a block (rmax > 50)
// Each writes the mode's pre-grain centre (ops/deband.py _mode_center) as
// int32; the grain and clamp tail runs outside, as in the JAX package.
//
// The TPU kernels resolve the taps as select chains over the offset
// alphabet (15 selects per tap for B5, 961 for B6 at range 15) because the
// TPU has no fast gather.  On Hopper a tap is an indexed load.  A tap
// outside the plane reads as the JAX package's CPU path has it: 0 for B5
// (its zero-padded _sep_taps; 4:2:2 chroma in modes 4-6 reaches there), the
// clamped coordinate for B6 (its _gather).
//
// What bounds them is device-memory bytes: read the u16 plane once
// (2 B/sample), the offset plane once (4 B/pixel, shared by all frames), and
// write the int32 centre (4 B/sample); a few integer operations per sample
// (mode 6 adds the pow polynomial, about 80 f32 operations).  The design:
// one thread per pixel of a 32x8 tile reads its offset once and walks the N
// frames, so the offsets cost one read per call and the taps' addresses are
// computed once.  Centre loads and stores are coalesced across a warp; taps
// are read through the non-coherent path and lie within the offset range of
// the pixel, so L1/L2 serve most of them.  That held B6 at 2.5x its bound:
// a frame's four gathers, up to 32 sectors a warp each, fill the load-store
// pipe, and a warp waited about 1,570 cycles a frame at its store.
// m2_tile_kernel stages each frame's tile once (see there).
//
// Mode 6 runs the VCL2 pow (ops/vcl.py pow_) in f32 with its order pinned:
// the file is built with -fmad=false, so nvcc does not contract a*b+c into
// FMA and every product and sum rounds as the plain torch version's do.
// Division is IEEE (nvcc's default -prec-div=true).
//
// Plain C interface, loaded with ctypes.  Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
// m2_tile: a block of kM2Threads threads owns kM2TileY x kM2TileX output
// pixels (kM2Rows rows of 4 adjacent columns a thread, 16 lanes across a
// tile's 64 columns) and holds, for two frames at a time, a tile of
// (kM2TileY + 2 rmax) x (kM2TileX + 2 pad) positions, pad = rmax rounded up
// to 8 columns so that rows stay on 16 bytes: the pair's 32-bit tile and
// the next pair's two 16-bit tiles; the wrapper takes m2_kernel where they
// pass kMaxSmemBytes (kernels/deband.py m2_on_chip holds the same numbers).
constexpr int kM2TileX = 64;
constexpr int kM2TileY = 64;
constexpr int kM2Threads = 256;
constexpr int kM2Rows = kM2TileY * kM2TileX / (4 * kM2Threads);
static_assert(kM2TileX == 64 && kM2Rows * 4 * kM2Threads == kM2TileY * kM2TileX,
              "16 lanes of 4 columns a row, whole rows a thread");
constexpr int kM2Group = 4;  // pairs of frames an m2_tile item takes from one tile

// A double constant rounded once to float, as NumPy's np.float32(v) does.
#define F32(v) static_cast<float>(v)

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Offset of (y+dy, x+dx), clamped into the plane, from the plane's start.
__device__ __forceinline__ long long tap(int y, int x, long long dy, long long dx, int h,
                                         int w) {
  return clampll(y + dy, 0, h - 1) * w + clampll(x + dx, 0, w - 1);
}

// Offset of (y+dy, x+dx) from the plane's start, or -1 outside the plane.
__device__ __forceinline__ long long tap_or_none(int y, int x, long long dy, long long dx,
                                                 int h, int w) {
  const long long yy = y + dy, xx = x + dx;
  return (yy < 0 || yy >= h || xx < 0 || xx >= w) ? -1 : yy * w + xx;
}

__device__ __forceinline__ int load_or_zero(const uint16_t* src, long long o) {
  return o < 0 ? 0 : __ldg(src + o);
}

__device__ __forceinline__ float round_half_away(float x) {
  return truncf(x + (x >= 0.0f ? 0.5f : -0.5f));
}

__device__ __forceinline__ float poly5(float x, float c0, float c1, float c2, float c3,
                                       float c4, float c5) {
  const float x2 = x * x;
  const float x4 = x2 * x2;
  return (c3 * x + c2) * x2 + ((c5 * x + c4) * x4 + (c1 * x + c0));
}

__device__ __forceinline__ float poly8(float x, float c0, float c1, float c2, float c3,
                                       float c4, float c5, float c6, float c7, float c8) {
  const float x2 = x * x;
  const float x4 = x2 * x2;
  const float x8 = x4 * x4;
  const float hi = (c7 * x + c6) * x2 + (c5 * x + c4);
  const float lo = (c3 * x + c2) * x2 + ((c1 * x + c0) + c8 * x8);
  return hi * x4 + lo;
}

// VCL2 pow_template_f, operation for operation as ops/vcl.py pow_.
__device__ float vcl_pow(float x0, float y) {
  const float x1 = fabsf(x0);
  float x = __uint_as_float((__float_as_uint(x1) & 0x007FFFFFu) | 0x3F000000u);
  const bool blend = x > F32(0.7071067811865476);
  x = blend ? x : x + x;
  x = x - 1.0f;

  const float x2 = x * x;
  float lg1 = poly8(x, F32(3.3333331174e-1), F32(-2.4999993993e-1), F32(2.0000714765e-1),
                    F32(-1.6668057665e-1), F32(1.4249322787e-1), F32(-1.2420140846e-1),
                    F32(1.1676998740e-1), F32(-1.1514610310e-1), F32(7.0376836292e-2));
  lg1 = lg1 * (x2 * x);

  float ef = (float)((int)((__float_as_uint(x1) >> 23) & 0xFFu) - 127);
  ef = blend ? ef + 1.0f : ef;

  const float e1 = round_half_away(ef * y);
  const float yr = ef * y - e1;

  const float half = 0.5f;
  const float lg = (half * (-x2) + x) + lg1;
  const float x2err = (half * x) * x + half * (-x2);
  const float lgerr = half * x2 + (lg - x) - lg1;

  const float log2e = F32(1.4426950408889634);
  const float ln2f_hi = F32(0.693359375);
  const float ln2f_lo = F32(-2.12194440e-4);
  const float ln2 = F32(0.6931471805599453);

  const float e2 = round_half_away(lg * y * log2e);
  float v = lg * y + (-e2) * ln2f_hi;
  v = (-e2) * ln2f_lo + v;

  const float correction = (lgerr + x2err) * y + (-yr) * ln2;
  v = v - correction;

  x = v;
  const float e3 = round_half_away(x * log2e);
  x = (-e3) * ln2 + x;

  const float x2e = x * x;
  float z = poly5(x, F32(1.0 / 2.0), F32(1.0 / 6.0), F32(1.0 / 24.0), F32(1.0 / 120.0),
                  F32(1.0 / 720.0), F32(1.0 / 5040.0));
  z = z * x2e + x + 1.0f;

  const float ee = e1 + e2 + e3;
  const int ei = (int)round_half_away(ee);
  z = __uint_as_float(__float_as_uint(z) + ((unsigned)ei << 23));  // wrapping add

  if ((__float_as_uint(x0) & 0x7F800000u) == 0u)
    return y < 0.0f ? __uint_as_float(0x7F800000u) : (y == 0.0f ? 1.0f : 0.0f);
  return z;
}

__device__ __forceinline__ float soft_gate(float dif, float t) {
  return fminf(fmaxf(3.0f * (1.0f - dif / fmaxf(t, F32(1e-5))), 0.0f), 1.0f);
}

// ops/deband.py _mode_center for int planes, on resolved taps.
template <int MODE, bool BLUR_FIRST>
__device__ __forceinline__ int center(int c, int r1, int r3, int r2, int r4, int thr,
                                      int thr1, int thr2) {
  if (MODE == 1 || MODE == 3) {
    const int avg = (r1 + r3 + 1) >> 1;
    const bool use_orig = BLUR_FIRST ? abs(avg - c) >= thr
                                     : (abs(r1 - c) >= thr || abs(r3 - c) >= thr);
    return use_orig ? c : avg;
  }
  if (MODE == 2) {
    int avg1 = (r1 + r3 + 1) >> 1;
    const int avg2 = (r2 + r4 + 1) >> 1;
    avg1 -= avg1 > 0;  // neo's SIMD avg_4 decrement-if-positive quirk
    const int avg = (avg1 + avg2 + 1) >> 1;
    const bool use_orig = BLUR_FIRST ? abs(avg - c) >= thr
                                     : (abs(r1 - c) >= thr || abs(r2 - c) >= thr ||
                                        abs(r3 - c) >= thr || abs(r4 - c) >= thr);
    return use_orig ? c : avg;
  }
  if (MODE == 4) {
    const int avg_v = (r1 + r3 + 1) >> 1;
    const int avg_h = (r2 + r4 + 1) >> 1;
    const bool uo_v = BLUR_FIRST ? abs(avg_v - c) >= thr
                                 : (abs(r1 - c) >= thr || abs(r3 - c) >= thr);
    const bool uo_h = BLUR_FIRST ? abs(avg_h - c) >= thr
                                 : (abs(r2 - c) >= thr || abs(r4 - c) >= thr);
    return ((uo_v ? c : avg_v) + (uo_h ? c : avg_h) + 1) >> 1;
  }
  if (MODE == 5) {
    const int avg = (r1 + r3 + r2 + r4) >> 2;
    const int max_dif = max(max(abs(r1 - c), abs(r3 - c)), max(abs(r2 - c), abs(r4 - c)));
    const bool use_orig = abs(avg - c) >= thr || max_dif >= thr1 ||
                          abs((r1 + r3) - (c << 1)) >= thr2 ||
                          abs((r2 + r4) - (c << 1)) >= thr2;
    return use_orig ? c : avg;
  }
  // MODE == 6: soft blend with factor pow(product of gates, 0.1)
  const float cf = (float)c;
  const float p1 = (float)r1, p2 = (float)r3, p3 = (float)r2, p4 = (float)r4;
  const float avg_refs = (p1 + p2 + p3 + p4) * 0.25f;
  const float diff = avg_refs - cf;
  const float max_dif = fmaxf(fmaxf(fabsf(p1 - cf), fabsf(p2 - cf)),
                              fmaxf(fabsf(p3 - cf), fabsf(p4 - cf)));
  const float two_src = cf * 2.0f;
  const float product = soft_gate(fabsf(diff), (float)thr) * soft_gate(max_dif, (float)thr1) *
                        soft_gate(fabsf((p1 + p2) - two_src), (float)thr2) *
                        soft_gate(fabsf((p3 + p4) - two_src), (float)thr2);
  const float factor = vcl_pow(product, F32(0.1));
  const float blended = cf + diff * factor;
  return (int)truncf(blended + 0.5f);
}

template <int MODE, bool BLUR_FIRST>
__global__ void center_kernel(const uint16_t* __restrict__ x, const int* __restrict__ vmap,
                              int* __restrict__ out, int n, int h, int w, int thr, int thr1,
                              int thr2) {
  const int px = blockIdx.x * kTileX + threadIdx.x;
  const int py = blockIdx.y * kTileY + threadIdx.y;
  if (px >= w || py >= h) return;
  const long long plane = (long long)h * w;
  const long long oc = (long long)py * w + px;
  const long long v = __ldg(vmap + oc);
  // rows for modes 1, 4-6; columns for 3-6 (mode 3 takes them as r1/r3)
  long long o1 = oc, o3 = oc, o2 = oc, o4 = oc;
  if (MODE != 3) {
    o1 = tap_or_none(py, px, v, 0, h, w);
    o3 = tap_or_none(py, px, -v, 0, h, w);
  }
  if (MODE != 1) {
    o2 = tap_or_none(py, px, 0, v, h, w);
    o4 = tap_or_none(py, px, 0, -v, h, w);
  }
  if (MODE == 3) {
    o1 = o2;
    o3 = o4;
    o2 = o4 = oc;
  }
  for (int f = 0; f < n; ++f) {
    const uint16_t* src = x + f * plane;
    const int c = __ldg(src + oc);
    const int r1 = load_or_zero(src, o1);
    const int r3 = load_or_zero(src, o3);
    int r2 = c, r4 = c;
    if (MODE != 1 && MODE != 3) {
      r2 = load_or_zero(src, o2);
      r4 = load_or_zero(src, o4);
    }
    out[f * plane + oc] = center<MODE, BLUR_FIRST>(c, r1, r3, r2, r4, thr, thr1, thr2);
  }
}

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <bool BLUR_FIRST>
__global__ void m2_kernel(const uint16_t* __restrict__ x, const int* __restrict__ key,
                          int* __restrict__ out, int n, int h, int w, int rmax, int thr) {
  const int px = blockIdx.x * kTileX + threadIdx.x;
  const int py = blockIdx.y * kTileY + threadIdx.y;
  if (px >= w || py >= h) return;
  const long long plane = (long long)h * w;
  const long long oc = (long long)py * w + px;
  const long long na = 2LL * rmax + 1;
  const long long k = __ldg(key + oc);
  const long long q = floordiv(k, na);
  const long long v1 = q - rmax;
  const long long v2 = (k - q * na) - rmax;
  const long long o1 = tap(py, px, v2, v1, h, w);
  const long long o3 = tap(py, px, -v2, -v1, h, w);
  const long long o2 = tap(py, px, -v1, v2, h, w);
  const long long o4 = tap(py, px, v1, -v2, h, w);
  for (int f = 0; f < n; ++f) {
    const uint16_t* src = x + f * plane;
    out[f * plane + oc] = center<2, BLUR_FIRST>(__ldg(src + oc), __ldg(src + o1),
                                                __ldg(src + o3), __ldg(src + o2),
                                                __ldg(src + o4), thr, 0, 0);
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The positions of one m2_tile tile (rows, row length) and the block's
// shared memory: a 32-bit pair tile and two 16-bit frame tiles.
struct M2Tile {
  int rows, stride;
  __host__ __device__ M2Tile(int rmax)
      : rows(kM2TileY + 2 * rmax), stride(kM2TileX + 2 * ((rmax + 7) / 8 * 8)) {}
  __host__ __device__ int positions() const { return rows * stride; }
  __host__ __device__ size_t bytes() const { return (size_t)positions() * 8; }
};

// A pixel's two tap offsets in its tile (o1 = v2*stride + v1 for r1 and
// -o1 for r3; o2 = -v1*stride + v2 for r2 and -o2 for r4) as two int16, or
// kFar where its key lies outside [0, (2rmax+1)^2), whose offsets pass the
// tile's halo (|o| <= rmax*stride + rmax < 2^15 - 1 where the tiles fit).
constexpr uint32_t kFar = 0x80008000u;

// B6 from shared memory.  A persistent grid of G blocks walks the plane's
// (group of kM2Group pairs of frames, tile) items, tiles inner, block b
// taking items b, b + G, b + 2G, ... and each item's pairs in turn: at each
// step the blocks hold neighbouring tiles of the same frames, so a tile's
// halo is read from L2 by its neighbours (a block taking a contiguous range
// of (tile, pair) items instead, its tile's keys decoded once, was 1.2x
// slower), and the items split evenly over the blocks however few tiles
// the plane has.  A block decodes each item's keys into registers (kFar or
// the offsets above, 4 kM2Rows pixels a thread) for its pairs.  The tiles
// hold the frames at plane-clamped coordinates, rows y0 - rmax .. y0 +
// kM2TileY + rmax - 1 and columns x0 - pad .. x0 + kM2TileX + pad - 1: a
// tap (y + dy, x + dx) with |dy|, |dx| <= rmax then reads, at the unclamped
// tile index, the clamped coordinate's value, as _gather does.  The four
// taps are random within +-rmax, so a warp's tap load meets bank conflicts
// (about 3.5 wavefronts); the pair tile, frame f in the low and frame f+1
// in the high half of each 32-bit position, gives both frames' tap in one
// load.  The next pair's frames come in by 16-byte cp.async copies into the
// 16-bit tiles while this pair computes (element loads at the plane's left
// and right edges, or everywhere off 16 bytes), and are interleaved into
// the pair tile between two block barriers.  A warp's 32 lanes cover 2 rows
// x 64 columns, so the centres are 16-byte loads, and the keys and the
// int32 outputs 16-byte loads and stores where the rows allow (vec4).  A
// kFar pixel (not made by the op) reads its taps from device memory, as
// m2_kernel does.  What bounds it is device-memory bytes, as m2_kernel; the
// tiles' halo costs (94 x 96) / (64 x 64) = 2.2x the frames' bytes from L2
// at rmax 15.
template <bool BLUR_FIRST, bool kVec>
__global__ void __launch_bounds__(kM2Threads, 3)
    m2_tile_kernel(const uint16_t* __restrict__ x, const int* __restrict__ key,
                   int* __restrict__ out, int n, int h, int w, int rmax, int thr, bool vec4) {
  extern __shared__ uint4 m2_smem[];
  const M2Tile tl(rmax);
  uint32_t* tile = reinterpret_cast<uint32_t*>(m2_smem);
  uint16_t* next0 = reinterpret_cast<uint16_t*>(tile + tl.positions());
  uint16_t* next1 = next0 + tl.positions();
  const int pad = (tl.stride - kM2TileX) / 2, chunks = tl.stride / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's columns tx .. tx + 3 of rows ty0 + kRowStep * i
  constexpr int kRowStep = kM2Threads / 16;
  const int tx = 4 * (lane & 15), ty0 = 2 * warp + (lane >> 4);
  const int tiles_x = (w + kM2TileX - 1) / kM2TileX, pairs = (n + 1) / 2;
  const long long plane = (long long)h * w;
  const int tiles = tiles_x * ((h + kM2TileY - 1) / kM2TileY);
  const int groups = (pairs + kM2Group - 1) / kM2Group;
  const long long total = (long long)tiles * groups;
  const long long steps = (total - blockIdx.x + gridDim.x - 1) / gridDim.x * kM2Group;
  if (steps <= 0) return;
  // this block's step k: item blockIdx.x + (k / kM2Group) * gridDim.x, its
  // tile and the first frame of its pair k % kM2Group (-1 past the last)
  auto step = [&](long long k) {
    const long long it = blockIdx.x + (k / kM2Group) * gridDim.x;
    const int pr = (int)(it / tiles) * kM2Group + (int)(k % kM2Group);
    return make_int2((int)(it % tiles), pr < pairs ? 2 * pr : -1);
  };

  // step k's two frames into next0 and next1 (the last frame twice where
  // n is odd)
  auto stage = [&](long long k) {
    const int2 tf = step(k);
    const int t = tf.x, f = tf.y;
    if (f < 0) return;
    const int y0 = (t / tiles_x) * kM2TileY, xa = (t % tiles_x) * kM2TileX - pad;
    const uint16_t* s0 = x + f * plane;
    const uint16_t* s1 = x + min(f + 1, n - 1) * plane;
    for (int q = tid; q < tl.rows * chunks; q += kM2Threads) {
      const int i = q / chunks, c = q - i * chunks, o = i * tl.stride + 8 * c;
      const long long row = (long long)min(max(y0 - rmax + i, 0), h - 1) * w;
      const int gx = xa + 8 * c;
      if (kVec && gx >= 0 && gx + 8 <= w) {
        cp_async16(next0 + o, s0 + row + gx);
        cp_async16(next1 + o, s1 + row + gx);
      } else {
        uint32_t va[4], vb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long lo = row + min(max(gx + 2 * e, 0), w - 1);
          const long long hi = row + min(max(gx + 2 * e + 1, 0), w - 1);
          va[e] = (uint32_t)__ldg(s0 + lo) | (uint32_t)__ldg(s0 + hi) << 16;
          vb[e] = (uint32_t)__ldg(s1 + lo) | (uint32_t)__ldg(s1 + hi) << 16;
        }
        *reinterpret_cast<uint4*>(next0 + o) = make_uint4(va[0], va[1], va[2], va[3]);
        *reinterpret_cast<uint4*>(next1 + o) = make_uint4(vb[0], vb[1], vb[2], vb[3]);
      }
    }
    cp_async_commit();
  };
  // the two frame tiles into the pair tile, position by position (frame f's
  // sample | frame f+1's << 16)
  auto interleave = [&]() {
    for (int q = tid; q < tl.positions() / 8; q += kM2Threads) {
      const uint4 a = reinterpret_cast<const uint4*>(next0)[q];
      const uint4 b = reinterpret_cast<const uint4*>(next1)[q];
      uint4* d = reinterpret_cast<uint4*>(tile) + 2 * q;
      d[0] = make_uint4(__byte_perm(a.x, b.x, 0x5410), __byte_perm(a.x, b.x, 0x7632),
                        __byte_perm(a.y, b.y, 0x5410), __byte_perm(a.y, b.y, 0x7632));
      d[1] = make_uint4(__byte_perm(a.z, b.z, 0x5410), __byte_perm(a.z, b.z, 0x7632),
                        __byte_perm(a.w, b.w, 0x5410), __byte_perm(a.w, b.w, 0x7632));
    }
  };

  // k / na as (k * na_m) >> 20, exact for every k < na^2 while na^3 < 2^20
  // (rmax <= 50: na <= 101)
  const int na = 2 * rmax + 1, na_m = ((1 << 20) + na - 1) / na;
  uint32_t off[4 * kM2Rows];
  int cur = -1, y0 = 0, x0 = 0;
  auto decode = [&](int t) {
    y0 = (t / tiles_x) * kM2TileY;
    x0 = (t % tiles_x) * kM2TileX;
#pragma unroll
    for (int i = 0; i < kM2Rows; ++i) {
      const int y = y0 + ty0 + kRowStep * i;
      const int* krow = key + (long long)y * w + x0 + tx;
      int kq[4];
      if (vec4 && y < h && x0 + tx < w) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(krow));
        kq[0] = v.x, kq[1] = v.y, kq[2] = v.z, kq[3] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) kq[k] = y < h && x0 + tx + k < w ? __ldg(krow + k) : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int xx = x0 + tx + k;
        uint32_t p = 0;  // outside the plane: taps at the centre, never stored
        if (y < h && xx < w) {
          const int kv = kq[k];
          if ((unsigned)kv < (unsigned)(na * na)) {
            const int q = (kv * na_m) >> 20, v1 = q - rmax, v2 = kv - q * na - rmax;
            const int o1 = v2 * tl.stride + v1, o2 = v2 - v1 * tl.stride;
            p = ((uint32_t)o1 & 0xffffu) | ((uint32_t)o2 << 16);
          } else {
            p = kFar;
          }
        }
        off[4 * i + k] = p;
      }
    }
  };
  // a kFar pixel's centre in frame f, its taps from device memory
  auto far = [&](int f, int c, int y, int xx) {
    const uint16_t* src = x + f * plane;
    const long long kv = __ldg(key + (long long)y * w + xx);
    const long long q = floordiv(kv, na);
    const long long v1 = q - rmax, v2 = (kv - q * na) - rmax;
    return center<2, BLUR_FIRST>(c, __ldg(src + tap(y, xx, v2, v1, h, w)),
                                 __ldg(src + tap(y, xx, -v2, -v1, h, w)),
                                 __ldg(src + tap(y, xx, -v1, v2, h, w)),
                                 __ldg(src + tap(y, xx, v1, -v2, h, w)), thr, 0, 0);
  };

  stage(0);
  cp_async_wait_all();
  __syncthreads();
  interleave();
  __syncthreads();
  if (1 < steps) stage(1);
  for (long long k = 0; k < steps; ++k) {
    const int2 tf = step(k);
    const int t = tf.x, f = tf.y;
    const bool second = f + 1 < n;
    if (t != cur) {
      decode(t);
      cur = t;
    }
#pragma unroll
    for (int i = 0; i < kM2Rows; ++i) {
      const int ty = ty0 + kRowStep * i, y = y0 + ty;
      if (y >= h || f < 0) break;
      const int ci = (ty + rmax) * tl.stride + pad + tx;
      const uint4 cc = *reinterpret_cast<const uint4*>(tile + ci);
      const uint32_t cv[4] = {cc.x, cc.y, cc.z, cc.w};
      int r0[4], r1[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t p = off[4 * i + k];
        const int c0 = (int)(cv[k] & 0xffffu), c1 = (int)(cv[k] >> 16);
        if (p != kFar) {
          const int o1 = (int)(p << 16) >> 16, o2 = (int)p >> 16;
          const uint32_t* c = tile + ci + k;
          const uint32_t t1 = c[o1], t3 = c[-o1], t2 = c[o2], t4 = c[-o2];
          r0[k] = center<2, BLUR_FIRST>(c0, (int)(t1 & 0xffffu), (int)(t3 & 0xffffu),
                                        (int)(t2 & 0xffffu), (int)(t4 & 0xffffu), thr, 0, 0);
          r1[k] = center<2, BLUR_FIRST>(c1, (int)(t1 >> 16), (int)(t3 >> 16), (int)(t2 >> 16),
                                        (int)(t4 >> 16), thr, 0, 0);
        } else {
          r0[k] = far(f, c0, y, x0 + tx + k);
          r1[k] = second ? far(f + 1, c1, y, x0 + tx + k) : 0;
        }
      }
      int* o = out + f * plane + (long long)y * w + x0 + tx;
#pragma unroll
      for (int fr = 0; fr < 2; ++fr) {
        const int* rv = fr ? r1 : r0;
        if (fr == 1 && !second) break;
        if (vec4 && x0 + tx < w) {
          *reinterpret_cast<int4*>(o) = make_int4(rv[0], rv[1], rv[2], rv[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (x0 + tx + k < w) o[k] = rv[k];
          }
        }
        o += plane;
      }
    }
    if (k + 1 < steps) {
      cp_async_wait_all();
      __syncthreads();  // this pair's tile is read, the next pair's frames are in
      interleave();
      __syncthreads();  // the next pair's tile is in; the frame tiles are free
      if (k + 2 < steps) stage(k + 2);
    }
  }
}

dim3 tile_grid(int h, int w) {
  return dim3((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
}

template <int MODE>
void launch_center(const uint16_t* x, const int* vmap, int* out, int n, int h, int w,
                   bool blur_first, int thr, int thr1, int thr2, cudaStream_t s) {
  const dim3 block(kTileX, kTileY);
  if (blur_first)
    center_kernel<MODE, true><<<tile_grid(h, w), block, 0, s>>>(x, vmap, out, n, h, w, thr,
                                                                thr1, thr2);
  else
    center_kernel<MODE, false><<<tile_grid(h, w), block, 0, s>>>(x, vmap, out, n, h, w, thr,
                                                                 thr1, thr2);
}

template <bool BLUR_FIRST, bool kVec>
int launch_m2_tile(const uint16_t* x, const int* key, int* out, int n, int h, int w, int rmax,
                   int thr, cudaStream_t s) {
  const M2Tile tl(rmax);
  if (tl.bytes() > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int groups = ((n + 1) / 2 + kM2Group - 1) / kM2Group;
  const long long items =
      (long long)((w + kM2TileX - 1) / kM2TileX) * ((h + kM2TileY - 1) / kM2TileY) * groups;
  if (items == 0) return 0;
  const void* kernel = reinterpret_cast<const void*>(m2_tile_kernel<BLUR_FIRST, kVec>);
  long long blocks;
  const cudaError_t e = resident_blocks(kernel, kM2Threads, tl.bytes(), &blocks);
  if (e != cudaSuccess) return (int)e;
  if (blocks > items) blocks = items;
  const bool vec4 = w % 4 == 0 && (uintptr_t)out % 16 == 0 && (uintptr_t)key % 16 == 0;
  m2_tile_kernel<BLUR_FIRST, kVec><<<(unsigned)blocks, kM2Threads, tl.bytes(), s>>>(
      x, key, out, n, h, w, rmax, thr, vec4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, h, w) uint16; vmap/key: (h, w) int32; out: (n, h, w) int32; all
// contiguous on one device.

int vz_deband_center(const void* x, const void* vmap, void* out, int n, int h, int w,
                     int mode, int blur_first, int thr, int thr1, int thr2, void* stream) {
  const uint16_t* xs = (const uint16_t*)x;
  const int* vs = (const int*)vmap;
  int* os = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const bool bf = blur_first != 0;
  switch (mode) {
    case 1: launch_center<1>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    case 3: launch_center<3>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    case 4: launch_center<4>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    case 5: launch_center<5>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    case 6: launch_center<6>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int vz_deband_m2_center(const void* x, const void* key, void* out, int n, int h, int w,
                        int rmax, int blur_first, int thr, void* stream) {
  const dim3 block(kTileX, kTileY);
  cudaStream_t s = (cudaStream_t)stream;
  if (blur_first)
    m2_kernel<true><<<tile_grid(h, w), block, 0, s>>>(
        (const uint16_t*)x, (const int*)key, (int*)out, n, h, w, rmax, thr);
  else
    m2_kernel<false><<<tile_grid(h, w), block, 0, s>>>(
        (const uint16_t*)x, (const int*)key, (int*)out, n, h, w, rmax, thr);
  return (int)cudaGetLastError();
}

// B6 from shared-memory tiles (M2Tile(rmax).bytes() <= kMaxSmemBytes).
int vz_deband_m2_tile(const void* x, const void* key, void* out, int n, int h, int w, int rmax,
                      int blur_first, int thr, void* stream) {
  const uint16_t* xs = (const uint16_t*)x;
  const int* ks = (const int*)key;
  int* os = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (uintptr_t)x % 16 == 0 && w % 8 == 0;
  if (blur_first) {
    return vec ? launch_m2_tile<true, true>(xs, ks, os, n, h, w, rmax, thr, s)
               : launch_m2_tile<true, false>(xs, ks, os, n, h, w, rmax, thr, s);
  }
  return vec ? launch_m2_tile<false, true>(xs, ks, os, n, h, w, rmax, thr, s)
             : launch_m2_tile<false, false>(xs, ks, os, n, h, w, rmax, thr, s);
}

}  // extern "C"
