// XPSNR's per-block statistics for Hopper (sm_90a), the CUDA counterparts of
// the Pallas kernels
//   luma_warp_kernel<T, pair, order>   B11 luma_stats_pallas  (vszip_tpu/kernels/xpsnr_pallas.py)
//   chroma_strip_kernel<T, wide>,      B12 chroma_sse_pallas  (vszip_tpu/kernels/xpsnr_pallas.py)
//   chroma_block_kernel<T>
// Per (by x bx) block of a plane (64x64 on luma), exact integer sums of
//   sse = sum (org - rec)^2                       over the block's pixels
//   sa  = sum |12c - 2(l+r+u+d) - (ul+ur+dl+dr)|  over the pixels 1..h-2, 1..w-2
//   ta  = sum |org[i] - org[i-1]|                 (order 1), or
//         sum |org[i] - 2 org[i-1] + org[i-2]|    (order 2), missing frames 0
// (src/filters/xpsnr.zig:214-347); the chroma entry computes sse only.
//
// The TPU kernel splits column sums into 12-bit limbs and reduces them with
// block-indicator f32 matmuls, because the TPU has no 64-bit lanes.  Here the
// sums are integers in registers, exact in any order, so the results equal
// the plain torch version bit for bit.
//
// B11 (luma_warp_kernel): one warp walks each 64x64 block (kBlocksPerWarp
// blocks down a column strip), no block barrier.  Lane l owns columns
// x0 + 2l and x0 + 2l + 1, read as one 4-byte word for uint16 (2 bytes for
// uint8; two element loads where W is odd or a plane is off the pair's
// alignment: kernels.xpsnr.pair_loads), so a warp reads a block's row in one
// transaction.  The Laplacian splits by rows, f = H(y) - V(y-1) - V(y+1),
// so a lane keeps one row's H and two rows' V, each taken once from a row
// whose left and right neighbours come from the next lanes by
// __shfl_up/down_sync and, at the block's sides, from one load by lanes 0
// and 31; the rows above and below the block are its two halo rows.  A step
// takes one new row of org and this row of rec (and of the previous frames
// where `temporal` is on), their loads issued kAhead steps ahead.  Each lane
// sums its pixels in registers: sse as 32x32->64 multiply-adds, sa and ta in
// 32 bits (bounds at the accumulators), and one warp reduction per block
// writes the three sums.  Columns past the plane load 0, which adds 0 to
// sse and ta; the Laplacian takes only the interior.
//
// B12 (chroma_strip_kernel): one launch takes both chroma planes (U and V
// always share a shape; a one-plane call passes one).  A warp walks a column
// strip of 32 lanes x kLaneCols columns (kLaneBytes 8: 128 uint16 or 256
// uint8, four 32-wide blocks at 4:2:0) down kStripRows block rows of one
// plane and frame, with no block barrier and no shared memory.  Lane l owns
// kLaneCols adjacent columns of each row, read as one kLaneBytes load where
// the row width and every plane's base allow it (kernels.xpsnr.wide_loads),
// else one load a column, and issues kRowsAhead rows' loads of org and rec
// before it sums them.  It sums its pixels' squares exactly in registers:
// uint16 squares (< 2^32) as 32x32->64 multiply-adds, uint8 ones (< 2^16) a
// row at a time in 32 bits.  A block's bx / kLaneCols lanes (`group`, a
// power of two up to 32: kernels.xpsnr.strip_group) then reduce among
// themselves by __shfl_xor_sync, and the first lane of each group writes its
// block's sum.  Blocks that do not fit a lane group (bx not a multiple of
// kLaneCols, a group that is no power of two, a block wider than a warp row)
// take chroma_block_kernel: a warp per block, its lanes striding the block's
// columns one element each, one warp reduction.
//
// What bounds them is device-memory bytes: org and rec read once (the 3x3
// and temporal neighbours come from L1/L2), three int64 per luma block and
// one per chroma block written.  About 18 integer operations per luma pixel
// (sse 3, Laplacian 12, temporal 3), 3 per chroma pixel.
//
// Plain C interface, loaded with ctypes.  The entries launch on the given
// stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- B11: a warp per 64x64 luma block ----------------------------------

constexpr int kLumaBlock = 64;      // XPSNR's luma block
constexpr int kLumaWarps = 4;       // warps of a thread block, each on its own blocks
constexpr int kBlocksPerWarp = 1;   // luma blocks a warp walks down a column strip
constexpr int kAhead = 2;           // steps (rows) whose loads a warp keeps in flight
constexpr unsigned kFull = 0xffffffffu;
// A lane's two columns of one row as loaded: one word of both (kPair) or one
// element each; 0 where a column is not read.
template <typename T, bool kPair>
struct Cols {
  static constexpr int kBits = 8 * sizeof(T);
  uint32_t v0 = 0, v1 = 0;

  // p: the row at the lane's first column; in_a, in_b: read each column
  // (kPair: both or neither, p on 2 * sizeof(T) bytes)
  __device__ __forceinline__ void load(const T* p, bool in_a, bool in_b) {
    if constexpr (kPair) {
      using W = std::conditional_t<sizeof(T) == 2, uint32_t, uint16_t>;
      v0 = in_a ? (uint32_t)__ldg(reinterpret_cast<const W*>(p)) : 0u;
    } else {
      v0 = in_a ? (uint32_t)__ldg(p) : 0u;
      v1 = in_b ? (uint32_t)__ldg(p + 1) : 0u;
    }
  }
  __device__ __forceinline__ int a() const {
    return kPair ? (int)(v0 & ((1u << kBits) - 1)) : (int)v0;
  }
  __device__ __forceinline__ int b() const { return kPair ? (int)(v0 >> kBits) : (int)v1; }
};

// One row of org at a lane's two columns a and b, as the Laplacian takes
// it: f = H(row y) - V(row y-1) - V(row y+1), with
//   H = 12c - 2(l + r) and V = 2c + l + r
// at each column (l, r its neighbours in the row).
struct Part {
  int ca, cb, ha, hb, va, vb;
};

// The row's Part from its two columns as loaded: the left neighbour from
// the lane before, the right from the lane after (shuffles), lanes 0 and
// 31's from the halo column.
template <typename T, bool kPair>
__device__ __forceinline__ Part part(const Cols<T, kPair>& c, uint32_t halo, int lane) {
  const int a = c.a(), b = c.b();
  const int left = __shfl_up_sync(kFull, b, 1), right = __shfl_down_sync(kFull, a, 1);
  const int l = lane == 0 ? (int)halo : left, r = lane == 31 ? (int)halo : right;
  return {a, b, 12 * a - 2 * (l + b), 12 * b - 2 * (a + r), 2 * a + l + b, 2 * b + a + r};
}

// The warp's exact sum of a lane value v < 2^39 (sse: 128 pixels of under
// 2^32): its low 24 bits and the rest summed apart, each under 2^32.
__device__ __forceinline__ unsigned long long warp_total(long long v) {
  const unsigned lo = __reduce_add_sync(kFull, (unsigned)(v & 0xffffff));
  const unsigned hi = __reduce_add_sync(kFull, (unsigned)(v >> 24));
  return ((unsigned long long)hi << 24) + lo;
}

// grid: ceil(warps / kLumaWarps) blocks of kLumaWarps warps; warp g takes
// column strip g % nbw, strip (g / nbw) % strips of kBlocksPerWarp blocks,
// frame g / (nbw * strips).  kOrder: 0 (no temporal term), 1 or 2.
// out: (3, n, nbh, nbw) int64 [sse, sa, ta].
template <typename T, bool kPair, int kOrder>
__global__ void __launch_bounds__(32 * kLumaWarps)
    luma_warp_kernel(const T* __restrict__ org, const T* __restrict__ rec,
                     long long* __restrict__ out, int n, int h, int w, int nbh, int nbw) {
  const int lane = threadIdx.x & 31;
  const int strips = (nbh + kBlocksPerWarp - 1) / kBlocksPerWarp;
  const long long g = (long long)blockIdx.x * kLumaWarps + (threadIdx.x >> 5);
  if (g >= (long long)n * strips * nbw) return;
  const int bxi = (int)(g % nbw), s = (int)(g / nbw % strips), i = (int)(g / nbw / strips);
  const size_t plane = (size_t)h * w;
  const T* o = org + (size_t)i * plane;
  const T* r = rec + (size_t)i * plane;
  // the previous frames (missing ones read as 0)
  const T* p1 = o - plane;
  const T* p2 = o - 2 * plane;
  const bool has1 = kOrder >= 1 && i >= 1, has2 = kOrder == 2 && i >= 2;
  const int x0 = bxi * kLumaBlock, x = x0 + 2 * lane;
  const bool in_a = x < w, in_b = x + 1 < w;
  // the Laplacian's columns: the interior 1..w-2
  const bool lap_a = x >= 1 && x <= w - 2, lap_b = x + 1 <= w - 2;
  // the halo column, lane 0's x0-1 and lane 31's x0+64, from column x
  const unsigned dh = lane == 0 ? -1u : (unsigned)(kLumaBlock - 2 * lane);
  const bool in_h = (lane == 0 && x0 >= 1) || (lane == 31 && x0 + kLumaBlock < w);
  const int by0 = s * kBlocksPerWarp, by1 = min(nbh, by0 + kBlocksPerWarp);
  const int y0 = by0 * kLumaBlock, yend = min(h, by1 * kLumaBlock);

  // org at the lane's columns and the halo column of the row whose column-x
  // offset in the frame is `at` (offsets unsigned: a frame holds under 2^32
  // samples).  The window's rows above and below the plane are read
  // clamped: only the Laplacian, which leaves those rows out, would take
  // them.
  const auto load_org = [&](unsigned at, Cols<T, kPair>& c, uint32_t& halo) {
    c.load(o + at, in_a, in_b);
    halo = in_h ? (uint32_t)__ldg(o + (at + dh)) : 0u;
  };
  const unsigned uw = w;
  const unsigned at0 = (unsigned)y0 * uw + x;  // row y0's offset at column x
  Cols<T, kPair> co[kAhead], cr[kAhead], c1[kAhead], c2[kAhead];
  uint32_t ho[kAhead];
  load_org(y0 >= 1 ? at0 - uw : at0, co[0], ho[0]);
  const Part up = part(co[0], ho[0], lane);
  int vup_a = up.va, vup_b = up.vb;  // V of the row above the step's
  load_org(at0, co[0], ho[0]);
  Part mid = part(co[0], ho[0], lane);
  // the loads of the next kAhead steps, issued ahead: for step y, org row
  // y+1 (clamped to the plane) and rec, p1 and p2 at row y
  unsigned ao = at0, at = at0;  // org's and rec's last rows issued
  const auto issue = [&](int y, int k) {
    if (y + 1 < h) ao += uw;
    load_org(ao, co[k], ho[k]);
    cr[k].load(r + at, in_a, in_b);
    if (kOrder >= 1) c1[k].load(p1 + at, has1 && in_a, has1 && in_b);
    if (kOrder == 2) c2[k].load(p2 + at, has2 && in_a, has2 && in_b);
    at += uw;
  };
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    if (y0 + k < yend) issue(y0 + k, k);

  for (int b = by0; b < by1; ++b) {
    const int ye = min(h, (b + 1) * kLumaBlock);
    long long sse = 0;  // a pixel's (org - rec)^2 < 2^32; 128 a lane: < 2^39
    uint32_t sa = 0;    // |Laplacian| <= 12 * 65535; 128 a lane: < 2^27
    uint32_t ta = 0;    // |org - 2 p1 + p2| <= 2 * 65535; 128 a lane: < 2^25
    for (int y = b * kLumaBlock; y < ye; ++y) {
      // take this step's rows (their loads were issued kAhead steps ago) ...
      const Part dn = part(co[0], ho[0], lane);
      const int ra = cr[0].a(), rb = cr[0].b();
      const int qa = kOrder == 2 ? c1[0].a() * 2 - c2[0].a() : c1[0].a();
      const int qb = kOrder == 2 ? c1[0].b() * 2 - c2[0].b() : c1[0].b();
      // ... and issue step y+kAhead's loads
#pragma unroll
      for (int k = 0; k + 1 < kAhead; ++k) {
        co[k] = co[k + 1], ho[k] = ho[k + 1], cr[k] = cr[k + 1];
        c1[k] = c1[k + 1], c2[k] = c2[k + 1];
      }
      if (y + kAhead < yend) issue(y + kAhead, kAhead - 1);
      const int da = mid.ca - ra, db = mid.cb - rb;
      sse += (long long)da * da;
      sse += (long long)db * db;
      const bool row = y >= 1 && y <= h - 2;
      const int fa = mid.ha - vup_a - dn.va, fb = mid.hb - vup_b - dn.vb;
      sa += (row && lap_a ? (uint32_t)abs(fa) : 0u) + (row && lap_b ? (uint32_t)abs(fb) : 0u);
      if constexpr (kOrder >= 1)
        ta += (uint32_t)abs(mid.ca - qa) + (uint32_t)abs(mid.cb - qb);
      vup_a = mid.va;
      vup_b = mid.vb;
      mid = dn;
    }
    // the block's sums: sa and ta under 2^32 over the warp, sse in two parts
    const unsigned long long t0 = warp_total(sse);
    const unsigned t1 = __reduce_add_sync(kFull, sa), t2 = __reduce_add_sync(kFull, ta);
    if (lane == 0) {
      const size_t blk = ((size_t)i * nbh + b) * nbw + bxi, stride = (size_t)n * nbh * nbw;
      out[blk] = (long long)t0;
      out[stride + blk] = t1;
      out[2 * stride + blk] = t2;
    }
  }
}

template <typename T, bool kPair>
int launch_luma(const T* org, const T* rec, long long* out, int n, int h, int w, int order,
                int temporal, cudaStream_t s) {
  const int nbh = (h + kLumaBlock - 1) / kLumaBlock, nbw = (w + kLumaBlock - 1) / kLumaBlock;
  const long long warps = (long long)n * ((nbh + kBlocksPerWarp - 1) / kBlocksPerWarp) * nbw;
  const unsigned grid = (unsigned)((warps + kLumaWarps - 1) / kLumaWarps);
  const int threads = 32 * kLumaWarps;
  if (!temporal)
    luma_warp_kernel<T, kPair, 0><<<grid, threads, 0, s>>>(org, rec, out, n, h, w, nbh, nbw);
  else if (order == 1)
    luma_warp_kernel<T, kPair, 1><<<grid, threads, 0, s>>>(org, rec, out, n, h, w, nbh, nbw);
  else
    luma_warp_kernel<T, kPair, 2><<<grid, threads, 0, s>>>(org, rec, out, n, h, w, nbh, nbw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_luma(const void* org, const void* rec, long long* out, int n, int h, int w, int pair,
                int order, int temporal, cudaStream_t s) {
  const T *os = (const T*)org, *rs = (const T*)rec;
  return pair ? launch_luma<T, true>(os, rs, out, n, h, w, order, temporal, s)
              : launch_luma<T, false>(os, rs, out, n, h, w, order, temporal, s);
}

// ---- B12: a warp per column strip of chroma blocks -----------------------

constexpr int kLaneBytes = 8;     // a lane's columns of one row: one load of 4, 8 or 16 bytes
constexpr int kChromaWarps = 4;   // warps of a thread block, each on its own strip
constexpr int kStripRows = 1;     // block rows a warp walks down its strip
constexpr int kRowsAhead = 8;     // rows whose loads a warp issues before it sums them

// The planes of one launch: U and V, or one plane twice.
template <typename T>
struct ChromaPlanes {
  const T* org[2];
  const T* rec[2];
};

// A lane's kLaneBytes / sizeof(T) columns of one row as loaded: element c at
// bit 8 * sizeof(T) * c of the words.
struct alignas(kLaneBytes) LaneRow {
  uint32_t v[kLaneBytes / 4];
};

// The lane's row from p (the row at its first column), of which the first
// `in` columns lie in the row (the rest read 0): one kLaneBytes load (kWide:
// `in` is 0 or all of them, p on kLaneBytes), or one load a column.
template <typename T, bool kWide>
__device__ __forceinline__ LaneRow load_lane(const T* p, int in) {
  using Vec = std::conditional_t<kLaneBytes == 16, uint4,
                                 std::conditional_t<kLaneBytes == 8, uint2, uint32_t>>;
  LaneRow r = {};
  if constexpr (kWide) {
    if (in > 0) *reinterpret_cast<Vec*>(r.v) = __ldg(reinterpret_cast<const Vec*>(p));
  } else {
    constexpr int kCols = kLaneBytes / sizeof(T), kPerWord = 4 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < in) r.v[c / kPerWord] |= (uint32_t)__ldg(p + c) << (8 * sizeof(T) * (c % kPerWord));
  }
  return r;
}

// acc plus the squared differences of a lane's columns of one row of org (a)
// and rec (b), exact: uint16 squares (< 2^32) as 32x32->64 multiply-adds;
// uint8 squares (< 2^16) summed in 32 bits (16 under 2^20), then added.
template <typename T>
__device__ __forceinline__ long long lane_sse(const LaneRow& a, const LaneRow& b, long long acc) {
  constexpr int kBits = 8 * sizeof(T), kPerWord = 4 / sizeof(T);
  constexpr uint32_t kMask = (1u << kBits) - 1;
  int32_t row = 0;
#pragma unroll
  for (int j = 0; j < kLaneBytes / 4; ++j)
#pragma unroll
    for (int k = 0; k < kPerWord; ++k) {
      const int d = (int)((a.v[j] >> (kBits * k)) & kMask) - (int)((b.v[j] >> (kBits * k)) & kMask);
      if constexpr (sizeof(T) == 2)
        acc += (long long)d * d;
      else
        row += d * d;
    }
  return acc + row;
}

// grid: ceil(warps / kChromaWarps) blocks of kChromaWarps warps (warps under
// 2^32, and a frame under 2^32 samples); warp g takes
// column strip g % sx (32 / group blocks), block-row strip (g / sx) % sy of
// kStripRows block rows, frame (g / (sx * sy)) % n, plane g / (sx * sy * n).
// group: lanes of a block (bx / kLaneCols, a power of two up to 32).
// out: (planes, n, nbh, nbw) int64.
template <typename T, bool kWide>
__global__ void __launch_bounds__(32 * kChromaWarps)
    chroma_strip_kernel(ChromaPlanes<T> pl, long long* __restrict__ out, int planes, int n,
                        int h, int w, int by, int group, int nbh, int nbw) {
  constexpr int kLaneCols = kLaneBytes / sizeof(T);
  const int ln = threadIdx.x % 32, per = 32 / group;
  const unsigned sx = (nbw + per - 1) / per, sy = (nbh + kStripRows - 1) / kStripRows;
  const unsigned g = blockIdx.x * kChromaWarps + threadIdx.x / 32;
  if (g >= (unsigned)planes * n * sy * sx) return;
  const int cs = (int)(g % sx), s = (int)(g / sx % sy);
  const int i = (int)(g / sx / sy % n), p = (int)(g / sx / sy / n);
  const size_t frame = (size_t)i * h * w;
  const T* o = pl.org[p] + frame;
  const T* r = pl.rec[p] + frame;
  const int x = (cs * 32 + ln) * kLaneCols;  // the lane's first column
  const int in = min(max(w - x, 0), kLaneCols);
  const int bxi = cs * per + ln / group;     // the lane's block column
  const bool lead = ln % group == 0 && bxi < nbw;  // the lane that writes its block's sum
  const unsigned uw = w;
  const int b1 = min(nbh, (s + 1) * kStripRows);
  for (int b = s * kStripRows; b < b1; ++b) {
    const int ye = min(h, (b + 1) * by);
    long long acc = 0;  // a block's sum: under 2^32 a pixel
    for (int y = b * by; y < ye; y += kRowsAhead) {
      LaneRow wo[kRowsAhead], wr[kRowsAhead];
#pragma unroll
      for (int k = 0; k < kRowsAhead; ++k) {
        const unsigned at = (unsigned)(y + k) * uw + x;
        const int ink = y + k < ye ? in : 0;
        wo[k] = load_lane<T, kWide>(o + at, ink);
        wr[k] = load_lane<T, kWide>(r + at, ink);
      }
#pragma unroll
      for (int k = 0; k < kRowsAhead; ++k) acc = lane_sse<T>(wo[k], wr[k], acc);
    }
    // the block's lanes, adjacent and a power of two, reduce among themselves
    for (int m = group / 2; m > 0; m /= 2) acc += __shfl_xor_sync(kFull, acc, m);
    if (lead) out[(((size_t)p * n + i) * nbh + b) * nbw + bxi] = acc;
  }
}

// Blocks that fit no lane group.  grid: ceil(warps / kChromaWarps) blocks;
// warp g takes block g of the (planes, n, nbh, nbw) output, its lanes
// striding the block's columns.
template <typename T>
__global__ void __launch_bounds__(32 * kChromaWarps)
    chroma_block_kernel(ChromaPlanes<T> pl, long long* __restrict__ out, int planes, int n,
                        int h, int w, int by, int bx, int nbh, int nbw) {
  const int ln = threadIdx.x % 32;
  const unsigned g = blockIdx.x * kChromaWarps + threadIdx.x / 32;
  if (g >= (unsigned)planes * n * nbh * nbw) return;
  const int bj = (int)(g % nbw), bi = (int)(g / nbw % nbh);
  const int i = (int)(g / nbw / nbh % n), p = (int)(g / nbw / nbh / n);
  const size_t frame = (size_t)i * h * w;
  const T* o = pl.org[p] + frame;
  const T* r = pl.rec[p] + frame;
  const int x1 = min(w, (bj + 1) * bx), y1 = min(h, (bi + 1) * by);
  long long acc = 0;
  for (int y = bi * by; y < y1; ++y) {
    const unsigned row = (unsigned)y * (unsigned)w;
    for (int x = bj * bx + ln; x < x1; x += 32) {
      const int d = (int)__ldg(o + row + x) - (int)__ldg(r + row + x);
      acc += (long long)d * d;
    }
  }
  for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(kFull, acc, m);
  if (ln == 0) out[g] = acc;
}

template <typename T>
int launch_chroma(const void* const* planes_in, int planes, long long* out, int n, int h,
                  int w, int by, int bx, int group, int wide, cudaStream_t s) {
  const ChromaPlanes<T> pl = {{(const T*)planes_in[0], (const T*)planes_in[2]},
                              {(const T*)planes_in[1], (const T*)planes_in[3]}};
  const int nbh = (h + by - 1) / by, nbw = (w + bx - 1) / bx;
  const int threads = 32 * kChromaWarps;
  long long warps = (long long)planes * n;
  if (group) {
    const int per = 32 / group;
    warps *= (long long)((nbh + kStripRows - 1) / kStripRows) * ((nbw + per - 1) / per);
  } else {
    warps *= (long long)nbh * nbw;
  }
  // the kernels index warps in 32 bits
  if (warps > 0xffffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)((warps + kChromaWarps - 1) / kChromaWarps);
  if (!group)
    chroma_block_kernel<T><<<grid, threads, 0, s>>>(pl, out, planes, n, h, w, by, bx, nbh, nbw);
  else if (wide)
    chroma_strip_kernel<T, true><<<grid, threads, 0, s>>>(pl, out, planes, n, h, w, by, group,
                                                          nbh, nbw);
  else
    chroma_strip_kernel<T, false><<<grid, threads, 0, s>>>(pl, out, planes, n, h, w, by, group,
                                                           nbh, nbw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// org, rec: (n, h, w) uint8 (elem_bytes 1) or uint16 (2), contiguous; out:
// (3, n, ceil(h/64), ceil(w/64)) int64 [sse, sa, ta]; order 1 or 2; ta is 0
// when temporal is 0.  pair: w even and both planes on 2 * elem_bytes bytes
// (a lane's two columns in one load).
int vz_xpsnr_luma_stats(const void* org, const void* rec, void* out, int n, int h, int w,
                        int elem_bytes, int pair, int order, int temporal, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  long long* os = (long long*)out;
  return elem_bytes == 1
             ? launch_luma<uint8_t>(org, rec, os, n, h, w, pair, order, temporal, s)
             : launch_luma<uint16_t>(org, rec, os, n, h, w, pair, order, temporal, s);
}

// org0, rec0 (and org1, rec1 where planes is 2): (n, h, w) uint8 (elem_bytes
// 1) or uint16 (2), contiguous; out: (planes, n, ceil(h/by), ceil(w/bx))
// int64 per-block SSE.  group: a block's lanes on the strip path
// (kernels.xpsnr.strip_group), 0 for the block path; wide: every row of
// every plane read in 8-byte loads (kernels.xpsnr.wide_loads).
int vz_xpsnr_chroma_sse(const void* org0, const void* rec0, const void* org1, const void* rec1,
                        int planes, void* out, int n, int h, int w, int elem_bytes, int by,
                        int bx, int group, int wide, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  const void* in[4] = {org0, rec0, planes == 2 ? org1 : org0, planes == 2 ? rec1 : rec0};
  cudaStream_t s = (cudaStream_t)stream;
  long long* os = (long long*)out;
  return elem_bytes == 1
             ? launch_chroma<uint8_t>(in, planes, os, n, h, w, by, bx, group, wide, s)
             : launch_chroma<uint16_t>(in, planes, os, n, h, w, by, bx, group, wide, s);
}

}  // extern "C"
