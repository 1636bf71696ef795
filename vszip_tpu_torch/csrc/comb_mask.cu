// CombMask's comb detector for Hopper (sm_90a), the CUDA counterpart of
//   comb_mask_kernel  B16 comb_mask_pallas  (vszip_tpu/kernels/comb_mask_pallas.py)
// For every pixel (y, x) of frame n (reference src/filters/comb_mask.zig),
// rows y+-1 and y+-2 mirrored reflect-101 (row -k is row k):
//   metric 0: (c-up > t and c-dn > t) or (c-up < -t and c-dn < -t),
//             and |up2 + 4c + dn2 - 3(up + dn)| > 6t
//   metric 1: (up - c)(dn - c) > t
// With mthresh > 0 the mask is ANDed with |c - prev| > mthresh (prev: frame
// n-1, frame 0 compared with itself) dilated by one row: a zero row above
// the top, the bottom row clamped.  Then, with expand, the horizontal 3-tap
// dilation with the reference's quirks: column 0 is m[0] | m[1], the last
// column keeps its value, a plane under 2 columns is left as it is.
//
// The TPU kernel loads 64-row bands with 8-row halos (and the previous
// frame's) and patches the mirrored rows with global-row selects.  Here a
// warp owns a strip of 128 columns (lane l on the 32-bit word l of each
// row: 4 pixels) and a band of kBand rows, and walks a run of kRun frames
// in order.  For each frame it loads the band's rows and 2 rows either side
// once, 32-bit words into registers; the rows of frame f stay in registers
// as frame f+1's `prev`, so within a run the motion test reads nothing
// twice (the frame before a run is read once more).  The tests run on two
// pixels at a time in the 16-bit lanes of a 32-bit word, with biases that
// keep every lane in [0, 65535]: a difference is one add, and bit 15 of a
// lane plus a bias says whether a threshold is passed, so a comparison is
// one add and a mask.  The 5-tap check runs only where a lane's window
// test passes.  The expand's neighbours come from the adjacent lanes by
// shuffles and a funnel shift; lanes 0 and 31 load the columns either side
// of the warp's 120 output columns and write nothing, so a strip needs
// nothing from another warp.  A plane whose rows are not 4-byte aligned
// loads and stores bytes.  Bands of 8 rows and runs of 4 frames measured
// faster on the H100 than 4, 12 or 16 rows and runs of 8 or 16 frames:
// more warps in flight outweigh the halo rows read again.
// What bounds it: one u8 read and one u8 write per pixel (398 MB for 64
// frames of 1080p YUV420P8, 0.119 ms at 3.35 TB/s); the band's 4 halo rows
// and the strip's 8 halo columns come again from L2, not from device
// memory.  The kernel issues about 30 instructions a pixel, so at 0.24 ms
// it is held by issue and latency as much as by the bytes.
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // warps of a block, strips side by side
constexpr int kCols = 4 * 30;      // output columns of a warp: lanes 1-30
constexpr int kBand = 8;           // rows of a warp
constexpr int kRun = 4;            // frames a warp walks
constexpr int kMaxGrid = 65535;    // grid y and z
constexpr uint32_t kBit15 = 0x80008000u;  // bit 15 of both lanes
constexpr uint32_t kBias = 0x01000100u;   // 256 in both lanes

__device__ __forceinline__ int reflect101(int k, int h) {
  k = k < 0 ? -k : (k > h - 1 ? 2 * (h - 1) - k : k);
  return min(max(k, 0), h - 1);  // rows past one reflection are never used
}

// The two pixels of bytes 0-1 (lo2) or 2-3 (hi2) of a word, one per 16-bit lane.
__device__ __forceinline__ uint32_t lo2(uint32_t v) { return __byte_perm(v, 0, 0x4140); }
__device__ __forceinline__ uint32_t hi2(uint32_t v) { return __byte_perm(v, 0, 0x4342); }

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

// The constants of a call, each 16-bit one in both lanes.
struct Consts {
  uint32_t kpos;  // 32511 - t: bit 15 of min(c-up, c-dn) + 256 + kpos  <=> both > t
  uint32_t kneg;  // 32512 + t: bit 15 of max(c-up, c-dn) + 256 + kneg clear <=> both < -t
  uint32_t kvhi;  // 30719 - 6t: bit 15 of e + kvhi <=> e - 2048 > 6t
  uint32_t kvlo;  // 30720 + 6t: bit 15 of e + kvlo clear <=> e - 2048 < -6t
  uint32_t kmov;  // 32767 - mthresh: bit 15 of |c - prev| + kmov <=> |c - prev| > mthresh
  int t;          // cthresh (metric 1)
};

// Metric 0 of two pixels, rows y-2 .. y+2 (a2, a1, c, b1, b2) in 16-bit
// lanes: bit 15 of each lane set where the comb test holds.  t is clamped
// to 255 (no difference passes it, as none passes a larger one).
__device__ __forceinline__ uint32_t metric0(uint32_t a2, uint32_t a1, uint32_t c, uint32_t b1,
                                            uint32_t b2, const Consts& k) {
  const uint32_t du = c + kBias - a1, dd = c + kBias - b1;  // in [1, 511]
  const uint32_t pred = ((min2(du, dd) + k.kpos) | ~(max2(du, dd) + k.kneg)) & kBit15;
  if (pred == 0) return 0;
  // up2 + 4c + dn2 - 3(up + dn) + 2048, in [518, 3578]: every lane's result
  // is in range, so the word's arithmetic is exact per lane
  const uint32_t e = 4 * c + a2 + b2 + 0x08000800u - 3 * (a1 + b1);
  return pred & ((e + k.kvhi) | ~(e + k.kvlo));
}

// Metric 1 of two pixels: (up - c)(dn - c) > t needs 17 bits, so per lane.
__device__ __forceinline__ uint32_t metric1(uint32_t a1, uint32_t c, uint32_t b1, int t) {
  const uint32_t du = a1 + kBias - c, dd = b1 + kBias - c;  // up - c + 256, dn - c + 256
  const int p0 = ((int)(du & 0xffffu) - 256) * ((int)(dd & 0xffffu) - 256);
  const int p1 = ((int)(du >> 16) - 256) * ((int)(dd >> 16) - 256);
  return (p0 > t ? 0x8000u : 0u) | (p1 > t ? 0x80000000u : 0u);
}

// |c - p| > mthresh for two pixels, as bit 15 of each lane.
__device__ __forceinline__ uint32_t moved2(uint32_t c, uint32_t p, uint32_t kmov) {
  return (max2(c, p) - min2(c, p) + kmov) & kBit15;
}

// Pixels 0-3 of a word as bytes 0xff / 0x00, from bit 15 of the lanes of
// lo (pixels 0, 1) and hi (pixels 2, 3).
__device__ __forceinline__ uint32_t bytes_of(uint32_t lo, uint32_t hi) {
  return __byte_perm((lo >> 15) * 0xffu, (hi >> 15) * 0xffu, 0x6420);
}

// Columns x .. x+3 of a row as a word; columns outside the row read 0.
template <bool kAligned>
__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int x, int w) {
  if (kAligned) return x >= 0 && x < w ? *reinterpret_cast<const uint32_t*>(row + x) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (x + i >= 0 && x + i < w) v |= (uint32_t)row[x + i] << (8 * i);
  }
  return v;
}

template <bool kAligned>
__device__ __forceinline__ void store_word(uint8_t* row, int x, int w, uint32_t v) {
  if (kAligned) {
    *reinterpret_cast<uint32_t*>(row + x) = v;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (x + i < w) row[x + i] = (uint8_t)(v >> (8 * i));
  }
}

// The rows r101(y0 - 2 + j), j = 0 .. kBand+3, of `frame` at this lane's
// columns.
template <bool kAligned>
__device__ __forceinline__ void load_band(uint32_t* rows, const uint8_t* frame, int y0, int x,
                                          int h, int w) {
#pragma unroll
  for (int j = 0; j < kBand + 4; ++j) {
    rows[j] = load_word<kAligned>(frame + (size_t)reflect101(y0 - 2 + j, h) * w, x, w);
  }
}

template <bool kMetric1, bool kMotion, bool kAligned>
__global__ void __launch_bounds__(kWarps * 32)
    comb_mask_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, int n, int h,
                     int w, Consts k, bool expand) {
  const int lane = threadIdx.x & 31;
  const int xo = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kCols;
  if (xo >= w) return;  // the whole warp
  const int x = xo - 4 + 4 * lane;  // this lane's first column
  const bool writer = lane >= 1 && lane <= 30 && x < w;
  const int last = w - 1 - x;  // the byte of column w-1 in this lane's word, if in [0, 3]
  const uint32_t keep = last >= 0 && last < 4 ? 0xffu << (8 * last) : 0u;
  const size_t plane = (size_t)h * w;
  for (int y0 = blockIdx.y * kBand; y0 < h; y0 += gridDim.y * kBand) {
    for (int f0 = blockIdx.z * kRun; f0 < n; f0 += gridDim.z * kRun) {
      // rows y0-1 .. y0+kBand of the frame before (at j: row y0-1+j)
      uint32_t prev[kBand + 4];
      if (kMotion && f0 > 0) load_band<kAligned>(prev, src + (f0 - 1) * plane, y0, x, h, w);
      const int f1 = min(f0 + kRun, n);
      for (int f = f0; f < f1; ++f) {
        uint32_t cur[kBand + 4];
        load_band<kAligned>(cur, src + f * plane, y0, x, h, w);
        if (kMotion && f == 0) {
#pragma unroll
          for (int j = 0; j < kBand + 4; ++j) prev[j] = cur[j];
        }
        uint8_t* orow = out + f * plane + (size_t)y0 * w;  // row y0 + j at step j
        // motion bits of rows y-1 and y (lo, hi lanes)
        uint32_t dml = 0, dmh = 0, d0l = 0, d0h = 0;
        if (kMotion) {
          dml = moved2(lo2(cur[1]), lo2(prev[1]), k.kmov);
          dmh = moved2(hi2(cur[1]), hi2(prev[1]), k.kmov);
          d0l = moved2(lo2(cur[2]), lo2(prev[2]), k.kmov);
          d0h = moved2(hi2(cur[2]), hi2(prev[2]), k.kmov);
        }
#pragma unroll
        for (int j = 0; j < kBand; ++j) {
          const int y = y0 + j;
          if (y >= h) break;
          uint32_t ml, mh;
          if (kMetric1) {
            ml = metric1(lo2(cur[j + 1]), lo2(cur[j + 2]), lo2(cur[j + 3]), k.t);
            mh = metric1(hi2(cur[j + 1]), hi2(cur[j + 2]), hi2(cur[j + 3]), k.t);
          } else {
            ml = metric0(lo2(cur[j]), lo2(cur[j + 1]), lo2(cur[j + 2]), lo2(cur[j + 3]),
                         lo2(cur[j + 4]), k);
            mh = metric0(hi2(cur[j]), hi2(cur[j + 1]), hi2(cur[j + 2]), hi2(cur[j + 3]),
                         hi2(cur[j + 4]), k);
          }
          if (kMotion) {
            // row y+1, clamped at the bottom; a zero row above the top
            uint32_t dpl = moved2(lo2(cur[j + 3]), lo2(prev[j + 3]), k.kmov);
            uint32_t dph = moved2(hi2(cur[j + 3]), hi2(prev[j + 3]), k.kmov);
            if (y == h - 1) {
              dpl = d0l;
              dph = d0h;
            }
            if (y == 0) dml = dmh = 0;
            ml &= dml | d0l | dpl;
            mh &= dmh | d0h | dph;
            dml = d0l;
            dmh = d0h;
            d0l = dpl;
            d0h = dph;
          }
          const uint32_t m = bytes_of(ml, mh);
          uint32_t o = m;
          if (expand) {
            const uint32_t left = __shfl_up_sync(0xffffffffu, m, 1);
            const uint32_t right = __shfl_down_sync(0xffffffffu, m, 1);
            o = m | __funnelshift_l(left, m, 8) | __funnelshift_r(m, right, 8);
            o = (o & ~keep) | (m & keep);  // the last column keeps its value
          }
          if (writer) store_word<kAligned>(orow, x, w, o);
          orow += w;
        }
        if (kMotion) {
#pragma unroll
          for (int j = 0; j < kBand + 4; ++j) prev[j] = cur[j];
        }
      }
    }
  }
}

template <bool kMetric1, bool kMotion, bool kAligned>
void launch(const uint8_t* x, uint8_t* o, int n, int h, int w, const Consts& k, bool expand,
            cudaStream_t s) {
  const int strips = (w + kCols - 1) / kCols, warps = strips < kWarps ? strips : kWarps;
  const int bands = (h + kBand - 1) / kBand, runs = (n + kRun - 1) / kRun;
  const dim3 grid((strips + warps - 1) / warps, bands < kMaxGrid ? bands : kMaxGrid,
                  runs < kMaxGrid ? runs : kMaxGrid);
  comb_mask_kernel<kMetric1, kMotion, kAligned><<<grid, 32 * warps, 0, s>>>(x, o, n, h, w, k,
                                                                           expand);
}

template <bool kMetric1, bool kMotion>
void launch_aligned(const uint8_t* x, uint8_t* o, int n, int h, int w, const Consts& k,
                    bool expand, cudaStream_t s) {
  if ((uintptr_t)x % 4 == 0 && (uintptr_t)o % 4 == 0 && w % 4 == 0) {
    launch<kMetric1, kMotion, true>(x, o, n, h, w, k, expand, s);
  } else {
    launch<kMetric1, kMotion, false>(x, o, n, h, w, k, expand, s);
  }
}

}  // namespace

extern "C" {

// src, out: (n, h, w) uint8, contiguous, on one device; h >= 3.
int vz_comb_mask(const void* src, void* out, int n, int h, int w, int cthresh, int mthresh,
                 int metric_1, int expand, void* stream) {
  if (n == 0 || w == 0) return 0;
  const uint8_t* x = (const uint8_t*)src;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const bool e = expand != 0;
  const uint32_t t = cthresh < 255 ? cthresh : 255, lanes = 0x00010001u;
  const Consts k = {(32511 - t) * lanes, (32512 + t) * lanes, (30719 - 6 * t) * lanes,
                    (30720 + 6 * t) * lanes, (32767u - (uint32_t)mthresh) * lanes, cthresh};
  if (metric_1) {
    mthresh > 0 ? launch_aligned<true, true>(x, o, n, h, w, k, e, s)
                : launch_aligned<true, false>(x, o, n, h, w, k, e, s);
  } else {
    mthresh > 0 ? launch_aligned<false, true>(x, o, n, h, w, k, e, s)
                : launch_aligned<false, false>(x, o, n, h, w, k, e, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
