// Checkmate's dot-crawl reducer for Hopper (sm_90a), the CUDA counterpart of
//   checkmate_kernel  B15 checkmate_pallas  (vszip_tpu/kernels/checkmate_pallas.py)
// For every pixel (y, x) of rows 2..h-3 of frame n (reference
// src/filters/checkmate.zig), with xl = max(x-2, 0), xr = min(x+2, w-1) and
// frames n+-1, n+-2 clamped to the clip:
//   cur_col    = c[y-2,x] + 2 c[y,x] + c[y+2,x]
//   curr_value = -c[y-2,xl] - c[y-2,xr] + 2 c[y,xl] + 2 c[y,xr]
//                - c[y+2,xl] - c[y+2,xr] + 2 cur_col + 12 c[y,x]
//   nw, pw     = min(clamp(thr + tmax - |col121(n+-1) - cur_col|, 0, tmax+1)
//                    * (8192 / tmax), 8192),   cw = 16384 - nw - pw
//   out        = clamp((cw * trunc(curr_value / 10) + pw (c + p1) + nw (c + n1)) >> 15,
//                      0, 255)
// and with tthr2 > 0 the temporal smooth (p1 + 2c + n1) >> 2 where
// |p1 - n1|, |p2 - c| and |c - n2| are all below tthr2.  Rows 0, 1, h-2 and
// h-1 pass through.  C's integer division truncates toward zero, as the
// reference's @divTrunc; the TPU kernel divides in f32 instead.
//
// The TPU kernel loads 64-row bands of five frames with 8-row halos through
// clamped block index maps.  Here a block owns a tile of 32 rows x 128
// columns and a run of 8 consecutive frames.  Each frame's tile (with a
// 2-row halo above and below and 16 columns either side) comes in once, by
// 16-byte `cp.async` copies while the frame before is computed, and is
// widened into 16-bit samples in a shared-memory ring of the frame window
// (n-1..n+1, n-2..n+2 with tthr2).  So each byte of the clip crosses L2
// about (8 + 2) / 8 times ((8 + 4) / 8 with tthr2) plus the halos, not the
// nine to eleven times of one thread per pixel reading its own
// neighbourhood; columns past the row's ends take the edge bytes, which is
// what the clamped xl and xr read.  Each thread computes 4 adjacent pixels
// as two pairs, one pixel in each 16-bit lane of a 32-bit word: the sums,
// the 16-bit min/max of the weights and their clamps act on both lanes at
// once, and only the blend with its division runs per pixel, in 32-bit
// integer arithmetic with 32-bit addresses inside the tile.  A plane whose
// rows are not 16-byte aligned fills its tiles with byte loads, the edge
// bytes included, and stores bytes.
//
// What bounds it: one u8 read and one u8 write per pixel (398 MB for 64
// frames of 1080p YUV420P8, 0.119 ms at 3.35 TB/s) and the integer
// operations as the card issues them (multiply-adds and 3-input adds
// fused), with the paired sums and weights counted once per pair and no
// column clamps: about 12 per pixel on the ALU pipe and 12 that the FMA
// pipe can take, 64 per SM per clock each, which outweigh the bytes.  On the 1080p
// rows the compute issues about 170 instructions per 4 pixels, most of them
// on the ALU pipe (16-bit min/max, shifts, masks, compares), which sets its
// pace; a new block's first instructions wait while older blocks issue.
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps: one tile row of 32 words per warp at a time
constexpr int kCols = 128;     // tile columns, 4 per thread
constexpr int kRows = 32;      // tile rows
constexpr int kFrames = 8;     // frames per block
constexpr int kPad = 16;       // columns kept either side of the tile (16-byte copies)
constexpr int kPitch = kCols + 2 * kPad;
constexpr int kTileRows = kRows + 4;  // rows y0-2 .. y0+kRows+1
constexpr int kSlot = kPitch * kTileRows;
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Plane {
  const uint8_t* src;
  int n, h, w;
};

// Frame `f`'s raw tile (rows y0-2.., columns x0-kPad..) into `slot`.
// kAligned: 16-byte copies of the chunks inside the row (rows are 16-byte
// aligned and w % 16 == 0, so a chunk lies wholly inside or outside; widen
// fills the others).  Otherwise byte loads with the column clamped to the
// row, edges included.
template <bool kAligned>
__device__ __forceinline__ void load_tile(uint8_t* slot, const Plane& P, int f, int x0, int y0) {
  const uint8_t* frame = P.src + (size_t)f * P.h * P.w;
  if (kAligned) {
    constexpr int kChunks = kPitch / 16;
    for (int i = threadIdx.x; i < kTileRows * kChunks; i += kThreads) {
      const int tr = i / kChunks, q = i - tr * kChunks;
      const int y = min(max(y0 - 2 + tr, 0), P.h - 1);
      const int x = x0 - kPad + 16 * q;
      if (x >= 0 && x < P.w) cp_async16(slot + tr * kPitch + 16 * q, frame + (size_t)y * P.w + x);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < kSlot; i += kThreads) {
      const int tr = i / kPitch, tc = i - tr * kPitch;
      const int y = min(max(y0 - 2 + tr, 0), P.h - 1);
      const int x = min(max(x0 - kPad + tc, 0), P.w - 1);
      slot[i] = frame[(size_t)y * P.w + x];
    }
  }
}

// A frame's raw tile (bytes) widened into `dst`, one 16-bit sample each, so
// that a 32-bit load gives two neighbouring pixels in two lanes.  Chunks of
// 16 bytes past the row's ends (left out by the 16-byte copies) take the
// edge bytes, which is what the clamped xl and xr read.
template <bool kAligned>
__device__ __forceinline__ void widen(uint16_t* dst, const uint8_t* raw, int w, int x0) {
  constexpr int kChunks = kPitch / 16;
  for (int i = threadIdx.x; i < kTileRows * kChunks; i += kThreads) {
    const int tr = i / kChunks, q = i - tr * kChunks;
    const int x = x0 - kPad + 16 * q;  // the chunk's first column
    const uint8_t* row = raw + tr * kPitch;
    uint4 v[2];
    uint32_t* o = reinterpret_cast<uint32_t*>(v);
    if (!kAligned || (x >= 0 && x < w)) {
      const uint4 a = *reinterpret_cast<const uint4*>(row + 16 * q);
      const uint32_t b[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[2 * k] = __byte_perm(b[k], 0, 0x4140);
        o[2 * k + 1] = __byte_perm(b[k], 0, 0x4342);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c0 = min(max(x + 2 * k, 0), w - 1), c1 = min(max(x + 2 * k + 1, 0), w - 1);
        o[k] = row[c0 - (x0 - kPad)] | (uint32_t)row[c1 - (x0 - kPad)] << 16;
      }
    }
    uint4* d = reinterpret_cast<uint4*>(dst + tr * kPitch + 16 * q);
    d[0] = v[0];
    d[1] = v[1];
  }
}

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t absdiff2(uint32_t a, uint32_t b) {
  return max2(a, b) - min2(a, b);
}

// The constants of a call, each 16-bit one in both lanes.
struct Consts {
  uint32_t k1024;  // thr + tmax + 1024
  uint32_t kmax;   // tmax + 1025
  int mult;        // 8192 / tmax
  int tthr2;
};

constexpr uint32_t kBias = 0x04000400u;  // 1024 in both lanes

// A temporal weight in both lanes: min(clamp(thr + tmax - |col - cur|, 0,
// tmax + 1) * mult, 8192), kept 1024 above 0 until the clamp so that no lane
// goes negative.
__device__ __forceinline__ uint32_t weight2(uint32_t col, uint32_t cur, const Consts& k) {
  const uint32_t c = min2(max2(k.k1024 - absdiff2(col, cur), kBias), k.kmax);
  return min2((c - kBias) * k.mult, 0x20002000u);
}

// Two neighbouring pixels, one in each 16-bit lane: frame n's rows y-2 (u),
// y (m) and y+2 (d) at their columns (C), two to the left (L) and two to
// the right (R); frames n-1 (p) and n+1 (n), and n-2, n+2, at their columns.
struct Pair {
  uint32_t uC, mC, dC, uL, uR, mL, mR, dL, dR, pu, pm, pd, nu, nm, nd, p2, n2;
};

// Every lane value of the sums stays in [0, 65535], so 32-bit adds and
// multiplies by small constants act on both lanes at once; the blend, which
// needs 32 bits, runs on each lane.
template <bool kTthr2>
__device__ __forceinline__ uint32_t pair(const Pair& v, const Consts& k) {
  const uint32_t mc = v.mC, pm = v.pm, nm = v.nm;
  const uint32_t cur = v.uC + v.dC + 2 * mc;
  const uint32_t colp = v.pu + v.pd + 2 * pm, coln = v.nu + v.nd + 2 * nm;
  // curr_value + 1024, in [4, 7144]
  const uint32_t cv = 2 * (v.mL + v.mR + cur) + 12 * mc + kBias - (v.uL + v.uR + v.dL + v.dR);
  const uint32_t nw = weight2(coln, cur, k), pw = weight2(colp, cur, k);
  const uint32_t cw = 0x40004000u - nw - pw, cp = mc + pm, cn = mc + nm;
  uint32_t still = 0, smooth = 0;
  if (kTthr2) {
    still = max2(max2(absdiff2(pm, nm), absdiff2(v.p2, mc)), absdiff2(mc, v.n2));
    smooth = pm + nm + 2 * mc;
  }
  uint32_t out = 0;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const auto lane = [&](uint32_t x) { return (int)(hi ? x >> 16 : x & 0xffff); };
    const int res = (lane(cw) * ((lane(cv) - 1024) / 10) + lane(pw) * lane(cp) +
                     lane(nw) * lane(cn)) >> 15;
    int o = __vimin_s32_relu(res, 255);  // clamp(res, 0, 255)
    if (kTthr2 && lane(still) < k.tthr2) o = lane(smooth) >> 2;
    out |= (uint32_t)o << (16 * hi);
  }
  return out;
}

// Output frame f from the ring's widened tiles: c (frame f), p1/n1 (f-+1),
// p2/n2 (f-+2, read with tthr2); 4 pixels (two pairs) per thread, 4 rows
// per thread.
template <bool kTthr2, bool kAligned>
__device__ __forceinline__ void compute(const uint16_t* c, const uint16_t* p1, const uint16_t* n1,
                                        const uint16_t* p2, const uint16_t* n2, uint8_t* out,
                                        int h, int w, int x0, int y0, const Consts& k) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = x0 + 4 * lane;
  if (x >= w) return;
  auto word = [](const uint16_t* t, int at) { return *(const uint32_t*)(t + at); };
  auto words = [](const uint16_t* t, int at) { return *(const uint2*)(t + at); };
  for (int rr = warp; rr < kRows; rr += kThreads / 32) {
    const int y = y0 + rr;
    if (y >= h) return;
    const int m = (rr + 2) * kPitch + kPad + 4 * lane;  // sample of (y, x) in a slot
    const uint2 mC = words(c, m);
    uint32_t res;
    if (y >= 2 && y < h - 2) {
      const int u = m - 2 * kPitch, d = m + 2 * kPitch;
      const uint2 uC = words(c, u), dC = words(c, d);
      const uint2 pu = words(p1, u), pm = words(p1, m), pd = words(p1, d);
      const uint2 nu = words(n1, u), nm = words(n1, m), nd = words(n1, d);
      const uint2 p2m = kTthr2 ? words(p2, m) : make_uint2(0, 0);
      const uint2 n2m = kTthr2 ? words(n2, m) : make_uint2(0, 0);
      // pixels x, x+1 (a) and x+2, x+3 (b)
      const Pair a{uC.x, mC.x, dC.x, word(c, u - 2), uC.y, word(c, m - 2), mC.y, word(c, d - 2),
                   dC.y, pu.x, pm.x, pd.x, nu.x, nm.x, nd.x, p2m.x, n2m.x};
      const Pair b{uC.y, mC.y, dC.y, uC.x, word(c, u + 4), mC.x, word(c, m + 4), dC.x,
                   word(c, d + 4), pu.y, pm.y, pd.y, nu.y, nm.y, nd.y, p2m.y, n2m.y};
      res = __byte_perm(pair<kTthr2>(a, k), pair<kTthr2>(b, k), 0x6420);
    } else {
      res = __byte_perm(mC.x, mC.y, 0x6420);
    }
    uint8_t* o = out + (size_t)y * w + x;
    if (kAligned) {
      *(uint32_t*)o = res;
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (x + b < w) o[b] = (uint8_t)(res >> (8 * b));
      }
    }
  }
}

// Shared memory of a block: the widened tiles of the frame window and the
// raw tile of the frame in flight.
constexpr int smem_bytes(bool tthr2) { return (2 * (tthr2 ? 5 : 3) + 1) * kSlot; }

template <bool kTthr2, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    checkmate_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, int n, int h,
                     int w, int thr, int tmax, int tthr2) {
  constexpr int W = kTthr2 ? 2 : 1;  // frames read either side
  constexpr int S = 2 * W + 1;       // widened tiles: the window
  extern __shared__ uint4 smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint8_t* raw = reinterpret_cast<uint8_t*>(ring + S * kSlot);
  const Plane P{src, n, h, w};
  const int x0 = blockIdx.x * kCols, y0 = blockIdx.y * kRows;
  const size_t plane = (size_t)h * w;
  const Consts k{(uint32_t)(thr + tmax + 1024) * 0x00010001u, (uint32_t)(tmax + 1025) * 0x00010001u,
                 8192 / tmax, tthr2};
  for (int f0 = blockIdx.z * kFrames; f0 < n; f0 += gridDim.z * kFrames) {
    const int f1 = min(f0 + kFrames, n);
    auto slot = [&](int g) { return ring + (g - f0 + W) % S * kSlot; };
    // the window of the run's first frame, one frame at a time
    for (int g = f0 - W; g <= f0 + W; ++g) {
      __syncthreads();  // the raw tile is widened; the previous run's reads are done
      load_tile<kAligned>(raw, P, min(max(g, 0), n - 1), x0, y0);
      if (kAligned) cp_async_wait_all();
      __syncthreads();
      widen<kAligned>(slot(g), raw, w, x0);
    }
    for (int f = f0; f < f1; ++f) {
      __syncthreads();  // frame f+W is widened, frame f-1 computed, the raw tile free
      if (f + 1 < f1) load_tile<kAligned>(raw, P, min(f + W + 1, n - 1), x0, y0);
      compute<kTthr2, kAligned>(slot(f), slot(f - 1), slot(f + 1), slot(f - W), slot(f + W),
                                out + f * plane, h, w, x0, y0, k);
      if (f + 1 < f1) {
        if (kAligned) cp_async_wait_all();
        __syncthreads();  // frame f+W+1 is in; nobody reads frame f-W's tile any more
        widen<kAligned>(slot(f + W + 1), raw, w, x0);
      }
    }
  }
}

template <bool kTthr2, bool kAligned>
int launch(const uint8_t* x, uint8_t* o, int n, int h, int w, int thr, int tmax, int tthr2,
           cudaStream_t s) {
  constexpr int bytes = smem_bytes(kTthr2);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        checkmate_kernel<kTthr2, kAligned>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int runs = (n + kFrames - 1) / kFrames;
  const dim3 grid((w + kCols - 1) / kCols, (h + kRows - 1) / kRows,
                  runs < kMaxGridZ ? runs : kMaxGridZ);
  checkmate_kernel<kTthr2, kAligned><<<grid, kThreads, bytes, s>>>(x, o, n, h, w, thr, tmax,
                                                                   tthr2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src, out: (n, h, w) uint8, contiguous, on one device; h >= 5, 1 <= tmax.
int vz_checkmate(const void* src, void* out, int n, int h, int w, int thr, int tmax, int tthr2,
                 void* stream) {
  if (n == 0 || w == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* x = (const uint8_t*)src;
  uint8_t* o = (uint8_t*)out;
  const bool aligned = w % 16 == 0 && (uintptr_t)src % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (tthr2 > 0) {
    return aligned ? launch<true, true>(x, o, n, h, w, thr, tmax, tthr2, s)
                   : launch<true, false>(x, o, n, h, w, thr, tmax, tthr2, s);
  }
  return aligned ? launch<false, true>(x, o, n, h, w, thr, tmax, tthr2, s)
                 : launch<false, false>(x, o, n, h, w, thr, tmax, tthr2, s);
}

}  // extern "C"
