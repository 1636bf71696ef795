// EEDI3 kernels for Hopper (sm_90a), the CUDA counterparts of the Pallas
// kernels
//   eedi3_line_kernel<0, M, K>  B8  eedi3_fused_pallas     (vszip_tpu/kernels/eedi3_fused_pallas.py)
//   eedi3_line_kernel<1, 0, K>  B9  eedi3_fused_hp_pallas  (same file)
//   vcheck_kernel               B10 vcheck_pallas          (vszip_tpu/kernels/vcheck_pallas.py)
//
// B8/B9: one block per line runs the reference's interpLine / interpLineHP
// (src/filters/eedi3.zig): the connection cost of every direction t at every
// x, the Viterbi DP across x with +-1 (hp: +-2) transitions, the backtrack,
// and the directional 4-tap (hp: 8-tap) interpolation.  The x axis is cut
// into chunks of 64 positions, and the block's warps split by role:
// - producer warps (6; hp 8) build chunk c+1's costs while the DP consumes
//   chunk c.  They stage the chunk's four row windows into shared memory
//   with cp.async (hp: and the four half-pel rows, computed from them once),
//   then take tasks from a counter: the directions +a and -a together
//   (their t_base reads the same eight values), largest a first, each
//   t_base, box sums in place, cost; and the backtrack map of chunk c-2.
//   Costs go to one of two buffers, x-major with a pitch of tp floats (odd,
//   so the producers' column stores meet no bank conflict).  Named barriers
//   hand a buffer over (full: producers arrive, the DP waits; empty: the DP
//   arrives, producers wait); __syncthreads is not used for it.
// - one DP warp walks the chunk's positions with its state in registers:
//   lane l owns directions K*(l - lo) .. K*(l - lo) + K-1, and the lanes
//   below lo = ceil(R / K) and above 31 - lo hold BIG, so that neighbours
//   come by warp shuffles with no edge tests.  It packs each step's code
//   (delta + R) at 2 bits (hp: 4) into one word per 16 (hp: 8) positions
//   and direction, written to the line's deltas and to a two-chunk ring.
// The line's deltas stay in shared memory where they fit kSmemBudget with
// the rest (narrow rows), else in a global scratch the wrapper allocates;
// at the bench's width both kernels use the scratch, since the shared
// memory buys more resident lines there.  The backtrack runs by chunks: a
// chunk's map (end direction -> entry direction, every end direction, a
// walk of at most 64 steps) is made by a producer while the DP runs (the
// last two chunks' after it, from the ring); thread 0 composes the maps from
// the right; each chunk is then walked once more from its known end to
// write fpath (scratch deltas copied into the freed shared memory first).
// All threads then interpolate.
//
// B10: line li of a frame reads only the line updated just before it
// (cur), at columns x + o within the reach of x's direction (|dmc|, hp
// |(dmc + 1) >> 1|, mostly at most mdis); every other input is known
// before the sweep.  So one frame's sweep runs on a
// cluster of up to 8 blocks (kVcheckCluster, the portable maximum; 16 for
// rows too wide for 8): block j owns a slice of about w / 8 columns (240 at
// 1920; at least mdis wide; one or two per thread) and keeps cur over its
// slice and a halo of mdis columns on each side in shared memory (two
// buffers, read and written by turns).  A block sends each column of its
// two edge strips, as it computes it, into its neighbours' halos with
// st.async through distributed shared memory; the bytes land on one of the
// receiver's two mbarriers (by line parity), which its threads wait on
// before they read cur.  So blocks run in step with their neighbours only,
// with no cluster-wide barrier and no release fence per line (a release
// would wait for the line's stores to device memory).  Per line a block
// then (1) waits for its own copies of the line's inputs and syncs its
// threads, (2) issues the cp.async copies of line li+ring-1 (dl, d1p, d1n,
// d2n over the window; cint and the three direction rows over the slice;
// 16 bytes each where w is a multiple of 4 and the rows are aligned) into
// a ring of 2-4 stages, (3)
// computes in registers the line's values that do not need cur (the keep
// test, the gathers from the other rows, ib, vb, vc, their errors, a2)
// while its neighbours' strips are in flight, and (4) waits for them and
// finishes: one or two reads of cur and a dozen f32 operations.  At the
// bench's 8 frames that is 64 blocks instead of 8.  A gather is needed
// only where the line is not kept, and there every column it reads lies in
// [0, w-1] (the reference's clamp never acts).  Directions mostly reach at
// most mdis columns (hp 2*mdis half-pels), but B9's backtrack walks past
// its directions where every cost saturates (ties keep the -2 candidate),
// so a direction may reach any column.  Before the sweep each block marks
// the lines whose directions in its slice reach past the halo, and ORs
// every block's marks through distributed shared memory.  On a marked line
// a block first finishes its other columns; then every block passes one
// cluster barrier (each block's line li-1 is then in `out`), and the
// columns that reach past the halo read their inputs and cur from device
// memory.  Unmarked lines take no such barrier, and the main loop keeps no
// state for far columns but their kind.
//
// Bit-exactness.  The file builds with -fmad=false, so every product and
// sum rounds to f32 on its own, in the reference's order, as the plain
// torch versions (ops/eedi3.py) round them:
//   tb = (|.|+|.|)+|.|; B(j) = tb(j-nrad) + ... + tb(j+nrad), k ascending;
//   s = (B(x+u)+B(x))+B(x+2u); ip = (.+.)*0.5;
//   cost = (alpha*s + f32(beta*|u|)) + omab*v;
//   the DP's strict-less candidate order, min(bval + cost, BIG);
//   the mclip gating (inactive x carries cost and delta; x==1 resets);
//   the backtrack reads direction 0 where its index leaves the directions.
// Rows read 0 past the mirror pad and hp's half-pel rows wrap circularly
// (the JAX package's zero-extended shifts and rolls), but no read of the
// cost build gets there: it reaches at most 2*mdis + nrad + 2 <= 85
// positions from the line, inside the 96 of the pad (static_assert below).
// The TPU kernels' one-hot sums, select chains, 8-step x padding and
// fused_fits limit stand in for gathers and VMEM sizes; they are not needed.
//
// What bounds B8/B9 is operations: about 41 (hp 81) directions x ~30 f32
// operations per pixel for the cost and the DP step, against a few bytes
// per pixel.  On the card the time goes to instructions: the producers'
// cost build (its loads and indexing besides the f32 work) and the DP
// warp's chain of w-1 dependent steps of a few tens of instructions each,
// which compete with the producers for the SM's schedulers;
// Shape::min_blocks asks for 6 (hp 3)
// resident lines per SM, to hide each other's latency.  B10 reads 9 f32/int
// rows per interpolated pixel and writes one: bytes.  Its first design, one
// 512-thread block per frame, sat at 27-39x that bound: 8 blocks on 132
// SMs, each line waiting on its own loads (about 9,500 cycles per line,
// two thirds of them in the loads and gathers).
//
// Plain C interface, loaded with ctypes.  Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPad = 96;
constexpr int kMdisMax = 40;
constexpr int kNradMax = 3;
static_assert(2 * kMdisMax + kNradMax + 2 < kPad, "the cost build's reads stay in the pad");
constexpr size_t kSmemBudget = 48 * 1024;  // deltas in shared memory up to this
// named barriers (0 is __syncthreads'): cost buffer 0/1 full, 0/1 empty,
// and the producers' own
constexpr int kBarFull = 1, kBarEmpty = 3, kBarProd = 5;
// B10: threads per block and columns per thread at most, blocks per frame
// (the portable cluster size) and ring stages at most
constexpr int kVcheckMaxThreads = 1024;
constexpr int kVcheckCols = 2;
constexpr int kVcheckCluster = 8;
constexpr int kVcheckRing = 4;

// The chunk width, the delta bits and deltas per word (a chunk holds whole
// words), the producer warps (warp prod runs the DP), and the pitch of a
// chunk's row windows: the four padded rows from jb = kPad + x0 - 2*mdis -
// kNradMax - 1 on, every read of the chunk's cost build.  (hp's four
// half-pel rows start at hb = kPad + x0 - mdis - kNradMax, pitch Plan::hw.)
template <bool kHp>
struct Shape {
  static constexpr int xc = 64, bits = kHp ? 4 : 2, per_word = 32 / bits;
  static constexpr int wpc = xc / per_word;
  static constexpr int prod = kHp ? 8 : 6, threads = 32 * (prod + 1), pt = 32 * prod;
  static constexpr int min_blocks = kHp ? 3 : 6;  // resident blocks per SM asked of ptxas
  static constexpr int rw = xc + 4 * kMdisMax + 2 * kNradMax + 4;
  static_assert(xc % per_word == 0 && xc % 32 == 0 && xc <= 64,
                "a chunk is whole words and lanes, its mask one u64");
};

// Shared-memory layout of one line's block, the same on host and device.
struct Plan {
  int tp, cen, K, nchunks, tbw, tb0w, per_warp, hw;
  long long bt_words;  // packed deltas of one line: word x / per_word, direction t
  size_t c_off, buf_off, win_off, hwin_off, ring_off, cm_off, queue_off, map_off, entry_off,
      base_bytes;
  bool bt_smem;
};

__host__ __device__ inline Plan plan(int w, int mdis, bool hp) {
  const int xc = hp ? Shape<true>::xc : Shape<false>::xc;
  const int wpc = hp ? Shape<true>::wpc : Shape<false>::wpc;
  const int prod = hp ? Shape<true>::prod : Shape<false>::prod;
  Plan p;
  p.tp = hp ? 4 * mdis + 1 : 2 * mdis + 1;
  p.cen = (p.tp - 1) / 2;
  // the DP's directions per lane: lanes lo .. 31 - lo hold them, lo = ceil(R
  // / K) for transitions of +-R, so that every shuffle of a lane with
  // directions reads a lane, and the lanes past either end hold BIG
  const int R = hp ? 2 : 1;
  p.K = 1;
  while (p.K * (32 - 2 * ((R + p.K - 1) / p.K)) < p.tp) ++p.K;
  p.nchunks = (w + xc - 1) / xc;
  p.bt_words = (long long)p.nchunks * wpc * p.tp;
  // a producer's t_base buffers of +u and -u, their box sums written in
  // place: the chunk plus |2u| (hp: |u|) <= 2*mdis, nrad more each side; hp
  // adds the half-pel t_base of odd directions over the chunk
  p.tbw = xc + 2 * mdis + 2 * kNradMax;
  p.tb0w = hp ? xc + 2 * kNradMax : 0;
  p.per_warp = 2 * (p.tbw + p.tb0w);
  p.hw = hp ? xc + 2 * mdis + 2 * kNradMax : 0;
  // two cost buffers, x-major, after a pad: the DP's lanes load their
  // slots K*(lane - lo) + k unconditionally, at most 6 before a row
  p.c_off = 64;
  size_t off = p.c_off + sizeof(float) * 2 * (size_t)xc * p.tp;
  p.buf_off = off;
  off += sizeof(float) * prod * (size_t)p.per_warp;
  p.win_off = off;  // two buffers of the four row windows
  off += sizeof(float) * 2 * 4 * (size_t)(hp ? Shape<true>::rw : Shape<false>::rw);
  p.hwin_off = off;  // hp: two buffers of the four half-pel windows
  off += sizeof(float) * 2 * 4 * (size_t)p.hw;
  p.ring_off = off;  // the deltas of the last two chunks
  off += sizeof(uint32_t) * 2 * (size_t)wpc * p.tp;
  p.cm_off = off = (off + 7) & ~(size_t)7;  // the two buffers' mclip bits
  off += 2 * sizeof(unsigned long long);
  p.queue_off = off;  // the two buffers' task counters
  off += 2 * sizeof(int);
  p.map_off = off;  // (chunk, end direction) -> entry direction
  off += sizeof(short) * (size_t)p.nchunks * p.tp;
  p.entry_off = off = (off + 15) & ~(size_t)15;  // each chunk's end direction
  off += sizeof(int) * (size_t)p.nchunks;
  p.base_bytes = (off + 15) & ~(size_t)15;
  p.bt_smem = p.base_bytes + 4 * (size_t)p.bt_words <= kSmemBudget;
  return p;
}

template <int kId, int kCount>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kId), "n"(kCount) : "memory");
}

template <int kId, int kCount>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, %1;" ::"n"(kId), "n"(kCount) : "memory");
}

// barrier kId + buf of a pair, buf 0 or 1
template <int kId, int kCount>
__device__ __forceinline__ void bar_sync_pair(int buf) {
  if (buf) bar_sync<kId + 1, kCount>();
  else bar_sync<kId, kCount>();
}

template <int kId, int kCount>
__device__ __forceinline__ void bar_arrive_pair(int buf) {
  if (buf) bar_arrive<kId + 1, kCount>();
  else bar_arrive<kId, kCount>();
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The half-pel row (ops/eedi3.py _hp_row) of a padded row at j; j - 1 and
// j + 2 stay inside the row here, so the roll's wrap is never taken.
__device__ __forceinline__ float hp_at(const float* a, int j) {
  return 0.5625f * (a[j] + a[j + 1]) - 0.0625f * (a[j - 1] + a[j + 2]);
}

// Producers: copy chunk c's row windows (the part inside the padded rows)
// into win; waited for by cp_async_wait_all.
template <bool kHp>
__device__ __forceinline__ void stage_rows(const float* const* rows, float* win, int c, int mdis,
                                           int wp) {
  using Sh = Shape<kHp>;
  const int jb = kPad + c * Sh::xc - 2 * mdis - kNradMax - 1;
  const int n = min(Sh::rw, wp - jb);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    for (int i = threadIdx.x; i < n; i += Sh::pt) cp_async4(win + r * Sh::rw + i, rows[r] + jb + i);
  }
}

// The t_base of the directions +u and -u at once, from the eight values
// both read: tp[i] = (|a[j] - b[j-sh]| + |b[j] - c[j-sh]|) + |c[j] - d[j-sh]|
// at j = jt + i and tm[i] = (|a[j'] - b[j'+sh]| + |b[j'] - c[j'+sh]|) +
// |c[j'] - d[j'+sh]| at j' = j - sh, for i < n.
__device__ __forceinline__ void t_base_pair(float* __restrict__ tp, float* __restrict__ tm,
                                            const float* a, const float* b, const float* c,
                                            const float* d, int jt, int sh, int n, int lane) {
#pragma unroll 2
  for (int i = lane; i < n; i += 32) {
    const int j = jt + i;
    const float a0 = a[j], b0 = b[j], c0 = c[j], d0 = d[j];
    const float a1 = a[j - sh], b1 = b[j - sh], c1 = c[j - sh], d1 = d[j - sh];
    const float vp = (fabsf(a0 - b1) + fabsf(b0 - c1)) + fabsf(c0 - d1);
    const float vm = (fabsf(a1 - b0) + fabsf(b1 - c0)) + fabsf(c1 - d0);
    tp[i] = vp;
    tm[i] = vm;
  }
}

// The box sums of two t_base buffers in place: x[i] = x[i] + x[i+1] + ... +
// x[i+2*NR], k ascending, i < n.  Each pass of 64 loads before any lane
// stores, and stores only below what the next pass loads.
template <int NR>
__device__ __forceinline__ void box_pair(float* x, float* y, int n, int lane) {
  for (int i0 = 0; i0 < n; i0 += 64) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // x, y at i0 + lane, then at i0 + 32 + lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 32 * h + lane;
      if (i < n) {
        float ax = x[i], ay = y[i];
#pragma unroll
        for (int k = 1; k <= 2 * NR; ++k) ax = ax + x[i + k], ay = ay + y[i + k];
        s[2 * h] = ax, s[2 * h + 1] = ay;
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 32 * h + lane;
      if (i < n) x[i] = s[2 * h], y[i] = s[2 * h + 1];
    }
  }
}

__device__ __forceinline__ void box_pair(float* x, float* y, int n, int nrad, int lane) {
  switch (nrad) {
    case 0: return box_pair<0>(x, y, n, lane);
    case 1: return box_pair<1>(x, y, n, lane);
    case 2: return box_pair<2>(x, y, n, lane);
    default: return box_pair<3>(x, y, n, lane);
  }
}

// One step of the backtrack at position x: direction index T at x to T at
// x-1, T += delta(x, T), reading direction 0 where T is not a direction (the
// JAX select chain's default).  words[(x / per_word) * tp + t] is the word
// of x's delta of direction t.
template <bool kHp>
__device__ __forceinline__ int back_step(const uint32_t* words, int x, int T, int tp) {
  using Sh = Shape<kHp>;
  const int tc = (T < 0 || T >= tp) ? 0 : T;
  const uint32_t wd = words[(x / Sh::per_word) * tp + tc];
  return T + (int)((wd >> (Sh::bits * (x % Sh::per_word))) & ((1u << Sh::bits) - 1u)) -
         (kHp ? 2 : 1);
}

// The backtrack over chunk c from T at its last position down to the
// position before its first (steps at x = max(x0, 1) .. end); with frow,
// fpath[x-1] is written on the way (0 outside the mask).
template <bool kHp, bool kMask>
__device__ __forceinline__ int walk(const uint32_t* bt, int c, int T, int w, int tp, int cen,
                                    const uint8_t* bm, int32_t* frow) {
  const int x0 = c * Shape<kHp>::xc, xe = min(x0 + Shape<kHp>::xc, w);
  for (int x = xe - 1; x >= max(x0, 1); --x) {
    T = back_step<kHp>(bt, x, T, tp);
    if (frow) frow[x - 1] = (kMask && bm[x - 1] == 0) ? 0 : T - cen;
  }
  return T;
}

// The DP lane of the first directions (see plan)
template <bool kHp, int K>
__host__ __device__ constexpr int first_lane() {
  return ((kHp ? 2 : 1) + K - 1) / K;
}

// One warp: chunk c's map, map[c * tp + T] = its entry direction for every
// end direction T (lane l walks T = l + 32q, q < K, in lockstep), from the
// chunk's deltas in ring slot c & 1.
template <bool kHp, int K>
__device__ __forceinline__ void chunk_map(const uint32_t* ring, short* map, int c, int w,
                                          int tp, int lane) {
  using Sh = Shape<kHp>;
  const int x0 = c * Sh::xc, xe = min(x0 + Sh::xc, w);
  // ring word (x / per_word) * tp + t for x in the chunk
  const uint32_t* words = ring + (c & 1) * Sh::wpc * tp - (x0 / Sh::per_word) * tp;
  int T[K];
#pragma unroll
  for (int q = 0; q < K; ++q) T[q] = lane + 32 * q;
  for (int x = xe - 1; x >= max(x0, 1); --x) {
#pragma unroll
    for (int q = 0; q < K; ++q) T[q] = back_step<kHp>(words, x, T[q], tp);
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (lane + 32 * q < tp) map[c * tp + lane + 32 * q] = (short)T[q];
  }
}

// The producers: the costs of every chunk, from its row windows in shared
// memory.  They stage chunk c+1's windows (cp.async) while they build chunk
// c's costs, and take the chunk's tasks from a counter: the map of chunk c-2
// (whose deltas the DP has finished) first, then the directions, largest
// |u| (the longest t_base span) first.  Costs go to C x-major, pitch tp.
template <bool kHp, bool kMask, int K>
__device__ __forceinline__ void produce(const Plan& P, const float* const* rows,
                                        const uint8_t* __restrict__ bm, float* C, float* win,
                                        float* hwin, const uint32_t* ring,
                                        unsigned long long* cm, int* queue, short* map,
                                        float* wb, int w, int mdis, int nrad, float alpha,
                                        double beta, float omab, int pw, int lane) {
  using Sh = Shape<kHp>;
  constexpr int kXc = Sh::xc, kRw = Sh::rw;
  const int hw = P.hw;
  const int wp = w + 2 * kPad, tp = P.tp;
  if (threadIdx.x < 2) queue[threadIdx.x] = 0;
  stage_rows<kHp>(rows, win, 0, mdis, wp);
  cp_async_wait_all();
  bar_sync<kBarProd, Sh::pt>();
  for (int c = 0; c < P.nchunks; ++c) {
    const int buf = c & 1;
    if (c >= 2) bar_sync_pair<kBarEmpty, Sh::threads>(buf);  // the DP is done with chunk c-2
    const int x0 = c * kXc, cn = min(kXc, w - x0);
    float* Cb = C + buf * kXc * tp;
    // the rows by padded position: every read below lies in the windows
    const int jb = kPad + x0 - 2 * mdis - kNradMax - 1;
    const float* wc = win + buf * 4 * kRw - jb;
    const float *r3p = wc, *r1p = wc + kRw, *r1n = wc + 2 * kRw, *r3n = wc + 3 * kRw;
    const float *h3p = nullptr, *h1p = nullptr, *h1n = nullptr, *h3n = nullptr;
    if (kHp) {
      const int hb = kPad + x0 - mdis - kNradMax;
      float* hc = hwin + buf * 4 * hw;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        for (int i = threadIdx.x; i < hw; i += Sh::pt) hc[r * hw + i] = hp_at(wc + r * kRw, hb + i);
      }
      bar_sync<kBarProd, Sh::pt>();
      hc -= hb;
      h3p = hc, h1p = hc + hw, h1n = hc + 2 * hw, h3n = hc + 3 * hw;
    }
    if (c + 1 < P.nchunks) stage_rows<kHp>(rows, win + (buf ^ 1) * 4 * kRw, c + 1, mdis, wp);
    if (kMask && pw == Sh::prod - 1) {
      const bool a0 = lane < cn && bm[x0 + lane] != 0;
      const bool a1 = lane + 32 < cn && bm[x0 + 32 + lane] != 0;
      const unsigned lo = __ballot_sync(0xffffffffu, a0), hi = __ballot_sync(0xffffffffu, a1);
      if (lane == 0) cm[buf] = ((unsigned long long)hi << 32) | lo;
    }
    const int first = c >= 2 ? 1 : 0;  // task 0: the map of chunk c-2
    for (;;) {
      int n = 0;
      if (lane == 0) n = atomicAdd(queue + buf, 1);
      n = __shfl_sync(0xffffffffu, n, 0) - first;
      if (n > P.cen) break;
      if (n < 0) {
        chunk_map<kHp, K>(ring, map, c - 2, w, tp, lane);
        continue;
      }
      // the directions u = +a and -a (a = 0: both are u = 0), a = cen - n
      const int a = P.cen - n;
      float* tbp = wb;  // +a: t_base over the span, then its box sums in place
      float* tbm = wb + P.tbw;
      // lane's x = x0 + lane + 32q; Cp/Cm: the costs of t = cen +- a at x0
      const float *p1p = r1p + kPad + x0 + lane, *p1n = r1n + kPad + x0 + lane;
      float* Cp = Cb + P.cen + a;
      float* Cm = Cb + P.cen - a;
      float cvp[kXc / 32], cvm[kXc / 32];
      if (!kHp) {
        // +a: B(x+d) = tbp[x - x0 + d]; -a (span starting 2a lower):
        // B(x-d) = tbm[x - x0 + 2a - d]
        const int ta = 2 * a;
        t_base_pair(tbp, tbm, r3p, r1p, r1n, r3n, kPad + x0 - nrad, ta, cn + ta + 2 * nrad, lane);
        __syncwarp();
        box_pair(tbp, tbm, cn + ta, nrad, lane);
        __syncwarp();
        const float bu = (float)(beta * (double)a);
#pragma unroll
        for (int q = 0; q < kXc / 32; ++q) {
          const int o = 32 * q, i = o + lane;
          const float sp = (tbp[i + a] + tbp[i]) + tbp[i + ta];
          const float sm = (tbm[i + a] + tbm[i + ta]) + tbm[i];
          const float ipp = (p1p[o + a] + p1n[o - a]) * 0.5f;
          const float ipm = (p1p[o - a] + p1n[o + a]) * 0.5f;
          const float vp = fabsf(p1p[o] - ipp) + fabsf(p1n[o] - ipp);
          const float vm = fabsf(p1p[o] - ipm) + fabsf(p1n[o] - ipm);
          cvp[q] = (alpha * sp + bu) + omab * vp;
          cvm[q] = (alpha * sm + bu) + omab * vm;
        }
      } else {
        // +a: B(x+d) = tbp[x - x0 + d]; -a: B(x-d) = tbm[x - x0 + a - d]; odd a:
        // the half-pel boxes around x + uh (+a) and x - uh - 1 (-a)
        const int uh = a >> 1;
        const bool odd = (a & 1) != 0;
        float* t0p = wb + 2 * P.tbw;
        float* t0m = t0p + P.tb0w;
        t_base_pair(tbp, tbm, r3p, r1p, r1n, r3n, kPad + x0 - nrad, a, cn + a + 2 * nrad, lane);
        if (odd) {
          t_base_pair(t0p, t0m, h3p, h1p, h1n, h3n, kPad + x0 + uh - nrad, a, cn + 2 * nrad,
                      lane);
        }
        __syncwarp();
        box_pair(tbp, tbm, cn + a, nrad, lane);
        if (odd) box_pair(t0p, t0m, cn, nrad, lane);
        __syncwarp();
        const float bu = (float)(beta * (double)a * 0.5);
        // ip of +a reads rb at x + uh and rc at x + lo0, of -a the other way
        // round (the half-pel rows for odd a)
        const float* rb = (odd ? h1p : r1p) + kPad + x0 + lane;
        const float* rc = (odd ? h1n : r1n) + kPad + x0 + lane;
        const int lo0 = odd ? -uh - 1 : -uh;
#pragma unroll
        for (int q = 0; q < kXc / 32; ++q) {
          const int o = 32 * q, i = o + lane;
          const float s0p = odd ? t0p[i] : tbp[i + uh];
          const float s0m = odd ? t0m[i] : tbm[i + a - uh];
          const float sp = (s0p + tbp[i]) + tbp[i + a];
          const float sm = (s0m + tbm[i + a]) + tbm[i];
          const float ipp = (rb[o + uh] + rc[o + lo0]) * 0.5f;
          const float ipm = (rb[o + lo0] + rc[o + uh]) * 0.5f;
          const float vp = fabsf(p1p[o] - ipp) + fabsf(p1n[o] - ipp);
          const float vm = fabsf(p1p[o] - ipm) + fabsf(p1n[o] - ipm);
          cvp[q] = (alpha * sp + bu) + omab * vp;
          cvm[q] = (alpha * sm + bu) + omab * vm;
        }
      }
#pragma unroll
      for (int q = 0; q < kXc / 32; ++q) {
        if (lane + 32 * q < cn) {
          Cp[(lane + 32 * q) * tp] = cvp[q];
          Cm[(lane + 32 * q) * tp] = cvm[q];
        }
      }
      __syncwarp();
    }
    bar_arrive_pair<kBarFull, Sh::threads>(buf);
    cp_async_wait_all();  // chunk c+1's windows are in; nobody reads chunk c's any more
    bar_sync<kBarProd, Sh::pt>();
    if (threadIdx.x == 0) queue[buf] = 0;  // for chunk c+2
  }
}

// The DP warp: every chunk's steps with the state in registers, the deltas
// packed into bt (word x / per_word, direction t) and into ring slot c & 1.
template <bool kHp, bool kMask, int K>
__device__ __forceinline__ void dp(const Plan& P, const float* C,
                                   const unsigned long long* cm, uint32_t* bt, uint32_t* ring,
                                   int w, float gamma, float big, int lane) {
  using Sh = Shape<kHp>;
  constexpr int kXc = Sh::xc;
  constexpr int R = kHp ? 2 : 1;  // transitions reach R directions
  constexpr int E = K + 2 * R;    // e[m]: direction t0 + m - R
  const int tp = P.tp, t0 = K * (lane - first_lane<kHp, K>());  // the lane's first direction
  const float g2 = gamma * 0.5f;
  bool ok[K];  // t0 + k is a direction; the others stay BIG
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = t0 + k >= 0 && t0 + k < tp;
  float v[K];
  int prev[K];       // the last stored code
  uint32_t word[K];  // codes (delta + R) of the word's steps
  bar_sync<kBarFull, Sh::threads>();  // chunk 0
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = ok[k] ? C[t0 + k] : big;  // x = 0
    prev[k] = R;
    word[k] = 0;
  }
  for (int c = 0; c < P.nchunks; ++c) {
    const int buf = c & 1;
    if (c > 0) bar_sync_pair<kBarFull, Sh::threads>(buf);
    const float* Cb = C + buf * kXc * tp + t0;
    const int x0 = c * kXc, xe = min(x0 + kXc, w);
    const unsigned long long mb = kMask ? cm[buf] : 0ull;
    for (int wi = 0; wi < Sh::wpc && x0 + wi * Sh::per_word < xe; ++wi) {
#pragma unroll
      for (int s = 0; s < Sh::per_word; ++s) {
        const int i = wi * Sh::per_word + s, x = x0 + i;
        if (x >= xe) break;
        if (x == 0) continue;
        float cst[K], e[E];
#pragma unroll
        for (int k = 0; k < K; ++k) cst[k] = Cb[i * tp + k];  // not a direction: discarded
#pragma unroll
        for (int m = 0; m < R; ++m) {  // the directions below the lane's, from lanes below
          const int rel = m - R, q = (-rel + K - 1) / K, idx = rel + q * K;
          e[m] = __shfl_up_sync(0xffffffffu, v[idx], q);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) e[k + R] = v[k];
#pragma unroll
        for (int m = 0; m < R; ++m) {  // the directions above, from lanes above
          const int rel = K + m, q = rel / K, idx = rel - q * K;
          e[K + R + m] = __shfl_down_sync(0xffffffffu, v[idx], q);
        }
        const bool active = !kMask || ((mb >> i) & 1ull) != 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float bval;
          int code;  // the delta + R
          if (!kHp) {
            const float left = e[k] + gamma;
            const float cent = e[k + 1];
            const float right = e[k + 2] + gamma;
            const bool lw = left < cent;
            bval = lw ? left : cent;
            code = lw ? 0 : 1;
            if (right < bval) bval = right, code = 2;
          } else {
            bval = e[k] + gamma;
            code = 0;
            float cv = e[k + 1] + g2;
            if (cv < bval) bval = cv, code = 1;
            cv = e[k + 2];
            if (cv < bval) bval = cv, code = 2;
            cv = e[k + 3] + g2;
            if (cv < bval) bval = cv, code = 3;
            cv = e[k + 4] + gamma;
            if (cv < bval) bval = cv, code = 4;
          }
          float nv = fminf(bval + cst[k], big);
          if (kMask && !active) {
            if (x == 1) {
              nv = cst[k];
              code = R;
            } else {
              nv = v[k];
              code = prev[k];
            }
          }
          v[k] = ok[k] ? nv : big;
          if (kMask) prev[k] = code;
          word[k] += (uint32_t)code << (Sh::bits * s);
        }
      }
      const int row = (c * Sh::wpc + wi) * tp, rrow = (buf * Sh::wpc + wi) * tp;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (ok[k]) {
          bt[row + t0 + k] = word[k];
          ring[rrow + t0 + k] = word[k];
        }
        word[k] = 0;
      }
    }
    if (c + 2 < P.nchunks) bar_arrive_pair<kBarEmpty, Sh::threads>(buf);
  }
}

template <bool kHp, bool kMask, int K>
__global__ void __launch_bounds__(Shape<kHp>::threads, Shape<kHp>::min_blocks)
    eedi3_line_kernel(const float* __restrict__ r3p_all, const float* __restrict__ r1p_all,
                      const float* __restrict__ r1n_all, const float* __restrict__ r3n_all,
                      const uint8_t* __restrict__ bmask, float* __restrict__ out,
                      int32_t* fpath, uint32_t* bt_global, int w, int mdis, int nrad,
                      float alpha, double beta, float gamma, float omab, float big) {
  using Sh = Shape<kHp>;
  constexpr int kThreads = Sh::threads;
  const Plan P = plan(w, mdis, kHp);
  const int line = blockIdx.x;
  const int wp = w + 2 * kPad;
  const float* r3p = r3p_all + (size_t)line * wp;
  const float* r1p = r1p_all + (size_t)line * wp;
  const float* r1n = r1n_all + (size_t)line * wp;
  const float* r3n = r3n_all + (size_t)line * wp;
  const uint8_t* bm = kMask ? bmask + (size_t)line * w : nullptr;
  float* orow = out + (size_t)line * w;
  int32_t* frow = fpath + (size_t)line * w;

  extern __shared__ __align__(16) unsigned char smem[];
  float* C = reinterpret_cast<float*>(smem + P.c_off);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + P.ring_off);
  unsigned long long* cm = reinterpret_cast<unsigned long long*>(smem + P.cm_off);
  short* map = reinterpret_cast<short*>(smem + P.map_off);
  int* entry = reinterpret_cast<int*>(smem + P.entry_off);
  uint32_t* bt = P.bt_smem ? reinterpret_cast<uint32_t*>(smem + P.base_bytes)
                           : bt_global + (size_t)line * P.bt_words;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tp = P.tp, cen = P.cen;

  if (warp < Sh::prod) {
    const float* rows[4] = {r3p, r1p, r1n, r3n};
    float* wb = reinterpret_cast<float*>(smem + P.buf_off) + (size_t)warp * P.per_warp;
    produce<kHp, kMask, K>(P, rows, bm, C, reinterpret_cast<float*>(smem + P.win_off),
                           reinterpret_cast<float*>(smem + P.hwin_off), ring, cm,
                           reinterpret_cast<int*>(smem + P.queue_off), map, wb, w, mdis, nrad,
                           alpha, beta, omab, warp, lane);
  } else {
    dp<kHp, kMask, K>(P, C, cm, bt, ring, w, gamma, big, lane);
  }
  __syncthreads();

  // ---- backtrack by chunks: fpath[w-1] = 0, fpath[x-1] = f(x) + delta(x) ----
  // 1. the maps of the last two chunks (the producers mapped the others)
  if (warp < 2 && P.nchunks - 2 + warp >= 0) {
    chunk_map<kHp, K>(ring, map, P.nchunks - 2 + warp, w, tp, lane);
  }
  __syncthreads();
  // 2. the chunks' end directions, composed from the right; an end outside
  //    the directions (the maps cover only those) walks its chunk here
  if (threadIdx.x == 0) {
    int T = cen;
    for (int c = P.nchunks - 1; c >= 0; --c) {
      entry[c] = T;
      T = (T >= 0 && T < tp) ? map[c * tp + T]
                             : walk<kHp, kMask>(bt, c, T, w, tp, cen, bm, nullptr);
    }
    frow[w - 1] = 0;
  }
  __syncthreads();
  // 3. every chunk walked once more from its end, writing fpath; deltas in
  //    global memory are first copied, as many chunks at a time as fit,
  //    into the shared memory before the ring, which nothing reads any more
  if (P.bt_smem) {
    for (int c = threadIdx.x; c < P.nchunks; c += kThreads) {
      walk<kHp, kMask>(bt, c, entry[c], w, tp, cen, bm, frow);
    }
  } else {
    const int cw = Sh::wpc * tp;  // words of a chunk
    const int per = (int)(P.ring_off / (4 * (size_t)cw));
    uint32_t* stage = reinterpret_cast<uint32_t*>(smem);
    for (int c0 = 0; c0 < P.nchunks; c0 += per) {
      const int nc = min(per, P.nchunks - c0);
      for (int i = threadIdx.x; i < nc * cw; i += kThreads) {
        cp_async4(reinterpret_cast<float*>(stage + i),
                  reinterpret_cast<const float*>(bt + (size_t)c0 * cw + i));
      }
      cp_async_wait_all();
      __syncthreads();
      for (int c = c0 + threadIdx.x; c < c0 + nc; c += kThreads) {
        // the stage's words indexed as bt's: (x / per_word) * tp + t
        walk<kHp, kMask>(stage - (size_t)c0 * cw, c, entry[c], w, tp, cen, bm, frow);
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // ---- directional interpolation ----
  const int last = wp - 1;
  for (int x = threadIdx.x; x < w; x += kThreads) {
    const int d = frow[x];
    const int p = kPad + x;
    if (!kHp) {
      const int ad = abs(d);
      const float g1p = r1p[min(max(p + d, 0), last)];
      const float g1n = r1n[min(max(p - d, 0), last)];
      const float g3p = r3p[min(max(p + 3 * d, 0), last)];
      const float g3n = r3n[min(max(p - 3 * d, 0), last)];
      const float four = 0.5625f * (g1p + g1n) - 0.0625f * (g3p + g3n);
      const float two = (g1p + g1n) * 0.5f;
      orow[x] = (x >= 3 * ad && x + 3 * ad <= w - 1) ? four : two;
    } else {
      auto at = [&](const float* r, int o) { return r[min(max(p + o, 0), last)]; };
      const int d2 = d >> 1, d21 = (d + 1) >> 1;
      const int d30 = (3 * d) >> 1, d31 = (3 * d + 1) >> 1;
      const float g1p_e = at(r1p, d2), g1n_e = at(r1n, -d2);
      const float g3p_e = at(r3p, d30), g3n_e = at(r3n, -d30);
      const float g3p_o = at(r3p, d31), g3n_o = at(r3n, -d31);
      const float g1p_o = at(r1p, d21), g1n_o = at(r1n, -d21);
      float res;
      if ((d & 1) == 0) {
        const int ad = abs(d2);
        const float four = 0.5625f * (g1p_e + g1n_e) - 0.0625f * (g3p_e + g3n_e);
        const float two = (g1p_e + g1n_e) * 0.5f;
        res = (x >= ad * 3 && x + ad * 3 <= w - 1) ? four : two;
      } else {
        const int ad = max(abs(d30), abs(d31));
        const float c0 = g3p_e + g3p_o, c1 = g1p_e + g1p_o;
        const float c2 = g1n_e + g1n_o, c3 = g3n_e + g3n_o;
        const float four = 0.28125f * (c1 + c2) - 0.03125f * (c0 + c3);
        const float two = (c1 + c2) * 0.25f;
        res = (x >= ad && x + ad <= w - 1) ? four : two;
      }
      orow[x] = res;
    }
  }
}

template <bool kHp, bool kMask, int K>
int launch_line(const float* r3p, const float* r1p, const float* r1n, const float* r3n,
                const uint8_t* bmask, float* out, int32_t* fpath, uint32_t* scratch,
                int lines, int w, int mdis, int nrad, float alpha, double beta, float gamma,
                float omab, float big, cudaStream_t s) {
  const Plan P = plan(w, mdis, kHp);
  const size_t bytes = P.base_bytes + (P.bt_smem ? 4 * (size_t)P.bt_words : 0);
  cudaError_t err = cudaFuncSetAttribute(eedi3_line_kernel<kHp, kMask, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  eedi3_line_kernel<kHp, kMask, K><<<lines, Shape<kHp>::threads, bytes, s>>>(
      r3p, r1p, r1n, r3n, bmask, out, fpath, scratch, w, mdis, nrad, alpha, beta, gamma,
      omab, big);
  return (int)cudaGetLastError();
}

// launch_line at the lanes' direction count K = ceil(tp / 32): 1-3, hp 1-6
template <bool kHp, bool kMask>
int launch_k(const float* r3p, const float* r1p, const float* r1n, const float* r3n,
             const uint8_t* bmask, float* out, int32_t* fpath, uint32_t* scratch, int lines,
             int w, int mdis, int nrad, float alpha, double beta, float gamma, float omab,
             float big, cudaStream_t s) {
#define VZ_LAUNCH(K)                                                                        \
  return launch_line<kHp, kMask, K>(r3p, r1p, r1n, r3n, bmask, out, fpath, scratch, lines, \
                                    w, mdis, nrad, alpha, beta, gamma, omab, big, s)
  switch (plan(w, mdis, kHp).K) {
    case 1: VZ_LAUNCH(1);
    case 2: VZ_LAUNCH(2);
    case 3: VZ_LAUNCH(3);
  }
  if constexpr (kHp) {
    switch (plan(w, mdis, kHp).K) {
      case 4: VZ_LAUNCH(4);
      case 5: VZ_LAUNCH(5);
      case 6: VZ_LAUNCH(6);
    }
  }
#undef VZ_LAUNCH
  return (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` (0-2) of this thread's newest groups are in
// flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  if (pending <= 0) asm volatile("cp.async.wait_group 0;" ::: "memory");
  else if (pending == 1) asm volatile("cp.async.wait_group 1;" ::: "memory");
  else asm volatile("cp.async.wait_group 2;" ::: "memory");
}

// The cluster's barrier, split: arrive publishes this thread's stores
// (shared memory of any block of the cluster, and device memory), wait
// sees every other thread's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The same shared-memory word in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(addr), "r"(rank));
  return d;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also expects `bytes` more to land on the barrier.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity is complete; what the
// completing stores wrote (from any block of the cluster) is then seen.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Store v at the cluster address `dst` and count its 4 bytes on the
// cluster barrier address `bar` (both in the same block).
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   dst),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// B10's split of a frame: a cluster of `blocks` blocks of `threads`
// threads, each owning `slice` columns (`cols` per thread, one up to
// kVcheckMaxThreads columns, else two: the kernel's kCols) plus a halo
// of `halo` on each side, a ring of `ring` stages of lines, and 16-byte
// copies (`vec`: w, slice and halo multiples of 4), and `marks` words of
// one bit per line (the lines that reach past the halo).
struct VcheckPlan {
  int blocks, threads, slice, halo, ring, marks, cols;
  bool vec;
  __host__ __device__ int win() const { return slice + 2 * halo; }
  // one stage: the rows dl, d1p, d1n, d2n over the window, cint and the
  // directions dmp, dmc, dmn over the slice
  __host__ __device__ int stage() const { return 4 * win() + 4 * slice; }
  // the two halo barriers, cur and nxt, the ring, and the block's marks
  // and the cluster's
  size_t bytes() const {
    return 16 + sizeof(float) * (2 * (size_t)win() + (size_t)ring * stage() + 2 * (size_t)marks);
  }
};

// The farthest column from x that a line's gathers of direction d reach
// (hp: d in half-pels).
template <bool kHp>
__device__ __forceinline__ int vcheck_reach(int d) {
  return kHp ? ((d & 1) == 0 ? abs(d >> 1) : max(abs(d >> 1), abs((d + 1) >> 1))) : abs(d);
}

// What a line's column needs of the line updated before it: `kind` 0 (kept:
// cint), 1 (it and vt from g = cur[x + o0]), 2 (hp, odd direction: g =
// cur[x + o0] + cur[x + o1]), the rest computed ahead; or 3 (a direction
// past the halo: all of it from device memory, after the line's others).
struct VcheckPre {
  int kind, o0, o1;
  float p1, p2, p3, d1p, vc, e1, e3, a2, dlx, ci;
};

// The blend of an interpolated pixel from its four errors (mode 1: min,
// 2: mean, 3: max of each pair), as the reference orders it.
__device__ __forceinline__ float vcheck_blend(float e0, float e1, float e2, float e3,
                                              float a2, float dlx, float ci, int mode,
                                              float rcp0, float rcp1) {
  float m0, m1;
  if (mode == 1) {
    m0 = fminf(e0, e1);
    m1 = fminf(e2, e3);
  } else if (mode == 2) {
    m0 = (e0 + e1) * 0.5f;
    m1 = (e2 + e3) * 0.5f;
  } else {
    m0 = fmaxf(e0, e1);
    m1 = fmaxf(e2, e3);
  }
  const float a0 = m0 * rcp0;
  const float a1 = m1 * rcp1;
  const float a = fminf(fmaxf(a0, fmaxf(a1, a2)), 1.0f);
  return (1.0f - a) * dlx + a * ci;
}

// A column's values that do not need cur, from the rows DL, D1P, D1N, D2N
// of its line indexed from xi (its ring stage, or device memory).
template <bool kHp>
__device__ __forceinline__ void vcheck_gather(VcheckPre& v, int dmc, const float* DL,
                                              const float* D1P, const float* D1N,
                                              const float* D2N, int xi, float rcp2, float vt2) {
  const float dlx = DL[xi], d1p = D1P[xi], d1n = D1N[xi];
  const float vc = fabsf(dlx - d1p) + fabsf(dlx - d1n);
  float ib, vb;
  v.kind = 1;
  v.o0 = dmc;
  if (kHp) {
    const int d20 = dmc >> 1, d21 = (dmc + 1) >> 1;
    const float a1 = D1P[xi + d20], a2 = DL[xi + d20];
    const float b0 = DL[xi - d20], b1 = D1N[xi - d20], b2 = D2N[xi - d20];
    v.o0 = d20;
    if ((dmc & 1) == 0) {
      ib = (a2 + b2) * 0.5f;
      vb = fabsf(b2 - b1) + fabsf(b0 - b1);
      v.p1 = b0;
      v.p2 = a1;
      v.p3 = fabsf(a2 - a1);
    } else {
      const float s1ps = a1 + D1P[xi + d21], pa0 = a2 + DL[xi + d21];
      const float ps0 = b0 + DL[xi - d21], s1ns = b1 + D1N[xi - d21];
      const float s2ns = b2 + D2N[xi - d21];
      ib = (pa0 + s2ns) * 0.25f;
      vb = (fabsf(s2ns - s1ns) + fabsf(ps0 - s1ns)) * 0.5f;
      v.kind = 2;
      v.o1 = d21;
      v.p1 = ps0;
      v.p2 = s1ps;
      v.p3 = fabsf(pa0 - s1ps);
    }
  } else {
    const float gu1 = D1P[xi + dmc], gu2 = DL[xi + dmc];
    const float gd0 = DL[xi - dmc], gd1 = D1N[xi - dmc], gd2 = D2N[xi - dmc];
    ib = (gu2 + gd2) * 0.5f;
    vb = fabsf(gd2 - gd1) + fabsf(gd0 - gd1);
    v.p1 = gd0;
    v.p2 = gu1;
    v.p3 = fabsf(gu2 - gu1);
  }
  const int dabs = kHp ? abs(dmc) >> 1 : abs(dmc);
  v.d1p = d1p;
  v.vc = vc;
  v.e1 = fabsf(ib - d1n);
  v.e3 = fabsf(vb - vc);
  v.a2 = fmaxf((vt2 - (float)dabs) * rcp2, 0.0f);
  v.dlx = dlx;
}

// An interpolated pixel from its values computed ahead and the one or two
// values g, g1 of the line updated before it.
template <bool kHp>
__device__ __forceinline__ float vcheck_finish(const VcheckPre& v, float g, float g1, int mode,
                                               float rcp0, float rcp1) {
  float it, vt;
  if (kHp && v.kind == 2) {
    g = g + g1;
    it = (g + v.p1) * 0.25f;
    vt = (fabsf(g - v.p2) + v.p3) * 0.5f;
  } else {
    it = (g + v.p1) * 0.5f;
    vt = fabsf(g - v.p2) + v.p3;
  }
  return vcheck_blend(fabsf(it - v.d1p), v.e1, fabsf(vt - v.vc), v.e3, v.a2, v.dlx, v.ci,
                      mode, rcp0, rcp1);
}

// Column x of a line with a direction dmc past the halo, from its rows
// dl, nb (d1p, d1n, d2n st apart) and the line updated before it, `prev`,
// in device memory.
template <bool kHp>
__device__ __forceinline__ float vcheck_far(const float* dl, const float* nb, size_t st,
                                         const float* prev, int x, int dmc, float ci, int mode,
                                         float rcp0, float rcp1, float rcp2, float vt2) {
  VcheckPre v;
  v.ci = ci;
  vcheck_gather<kHp>(v, dmc, dl, nb, nb + st, nb + 2 * st, x, rcp2, vt2);
  return vcheck_finish<kHp>(v, __ldcg(prev + x + v.o0),
                            kHp && v.kind == 2 ? __ldcg(prev + x + v.o1) : 0.0f, mode, rcp0,
                            rcp1);
}

// B10: one cluster per frame sweeps the interpolated lines in order (the
// design is in the header).  dl, cint, out: (n_off, B, w); nb, dm: (n_off,
// 3, B, w); init: (B, w).  kCols: columns per thread.
template <bool kHp, int kCols>
__global__ void __launch_bounds__(kVcheckMaxThreads)
    vcheck_kernel(const float* __restrict__ dl, const float* __restrict__ nb,
                  const int32_t* __restrict__ dm, const float* __restrict__ cint,
                  const float* __restrict__ init, float* __restrict__ out, int n_off,
                  int nbatch, int w, int mode, float rcp0, float rcp1, float rcp2, float vt2,
                  VcheckPlan pl) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int j = (int)cluster.block_rank();
  const int b = blockIdx.x / pl.blocks;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int H = pl.halo, WW = pl.win(), SW = pl.stage(), Sc = pl.slice;
  const int x0 = j * Sc, x1 = min(x0 + Sc, w);
  const int base = x0 - H;  // the column of window index 0
  const int lo = max(base, 0), hi = min(x1 + H, w);
  // the halo barriers (line l's halo lands on bar[l % 2]), then cur and
  // nxt over the window, then the ring
  const uint32_t bar0 = smem_addr(sm);
  float* const buf = sm + 4;
  float* cur = buf;  // the line the previous one updated (pd-2)
  float* nxt = buf + WW;
  float* const ring = buf + 2 * WW;
  const bool has_left = j > 0, has_right = j + 1 < pl.blocks;
  // the halo bytes each line brings: the left neighbour's last H columns,
  // the right neighbour's first min(H, its width)
  const int halo_bytes =
      4 * ((has_left ? H : 0) + (has_right ? min(H, w - (x0 + Sc)) : 0));
  const size_t st = (size_t)nbatch * w;  // one (B, W) plane
  const size_t fb = (size_t)b * w;

  // line l's inputs into ring stage l % ring, as one cp.async group
  auto issue = [&](int l) {
    float* S = ring + (l % pl.ring) * SW;
    const float* DL = dl + (size_t)l * st + fb;
    const float* NB = nb + (size_t)l * 3 * st + fb;
    const float* CI = cint + (size_t)l * st + fb;
    const float* DM = reinterpret_cast<const float*>(dm + (size_t)l * 3 * st + fb);
    float* Ss = S + 4 * WW;
    if (pl.vec) {
      for (int xx = lo + 4 * tid; xx < hi; xx += 4 * nt) {
        const int i = xx - base;
        cp_async16(S + i, DL + xx);
        cp_async16(S + WW + i, NB + xx);
        cp_async16(S + 2 * WW + i, NB + st + xx);
        cp_async16(S + 3 * WW + i, NB + 2 * st + xx);
      }
      for (int xx = x0 + 4 * tid; xx < x1; xx += 4 * nt) {
        const int i = xx - x0;
        cp_async16(Ss + i, CI + xx);
        cp_async16(Ss + Sc + i, DM + xx);
        cp_async16(Ss + 2 * Sc + i, DM + st + xx);
        cp_async16(Ss + 3 * Sc + i, DM + 2 * st + xx);
      }
    } else {
      for (int xx = lo + tid; xx < hi; xx += nt) {
        const int i = xx - base;
        cp_async4(S + i, DL + xx);
        cp_async4(S + WW + i, NB + xx);
        cp_async4(S + 2 * WW + i, NB + st + xx);
        cp_async4(S + 3 * WW + i, NB + 2 * st + xx);
      }
      for (int xx = x0 + tid; xx < x1; xx += nt) {
        const int i = xx - x0;
        cp_async4(Ss + i, CI + xx);
        cp_async4(Ss + Sc + i, DM + xx);
        cp_async4(Ss + 2 * Sc + i, DM + st + xx);
        cp_async4(Ss + 3 * Sc + i, DM + 2 * st + xx);
      }
    }
    cp_async_commit();
  };

  // column x's values of line l that do not need cur
  auto precompute = [&](int l, int x) {
    const float* S = ring + (l % pl.ring) * SW;
    const float* CI = S + 4 * WW;
    const int32_t* DMP = reinterpret_cast<const int32_t*>(CI + Sc);
    const int32_t* DMC = DMP + Sc;
    const int32_t* DMN = DMC + Sc;
    const int i = x - x0;
    VcheckPre v;
    const int dmc = DMC[i], dmp = DMP[i], dmn = DMN[i];
    bool keep = dmc == 0;
    keep |= (max(dmc * dmp, dmc * dmn) < 0) || (dmp == dmn && dmp == 0);
    const int maxoff = vcheck_reach<kHp>(dmc);
    keep |= (x + maxoff >= w) || (x - maxoff < 0);
    v.ci = CI[i];
    v.kind = 0;
    if (keep) return v;
    // every gather reaches at most maxoff columns from x, inside the row:
    // within the ring's window where maxoff <= H
    if (maxoff > H) v.kind = 3;
    else vcheck_gather<kHp>(v, dmc, S, S + WW, S + 2 * WW, S + 3 * WW, x - base, rcp2, vt2);
    return v;
  };

  // column x of line li from its values computed ahead and cur
  auto update = [&](int x, const VcheckPre& v) {
    if (v.kind == 0) return v.ci;
    const int xi = x - base;
    return vcheck_finish<kHp>(v, cur[xi + v.o0], kHp && v.kind == 2 ? cur[xi + v.o1] : 0.0f,
                              mode, rcp0, rcp1);
  };

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // lines 0 and 1 bring halos (the last line sends none)
    if (n_off > 1) mbar_expect(bar0, halo_bytes);
    if (n_off > 2) mbar_expect(bar0 + 8, halo_bytes);
  }
  for (int l = 0; l + 1 < pl.ring; ++l) {
    if (l < n_off) issue(l);
    else cp_async_commit();
  }
  for (int xx = lo + tid; xx < hi; xx += nt) cur[xx - base] = init[fb + xx];
  // mark the lines with a direction in this slice that reaches past the
  // halo (bit l % 32 of word l / 32): one thread per line and 4 columns (1
  // without 16-byte copies), each thread's 8 loads in flight at once
  uint32_t* const marks = reinterpret_cast<uint32_t*>(ring + pl.ring * SW);
  uint32_t* const far_lines = marks + pl.marks;  // the cluster's
  for (int i = tid; i < pl.marks; i += nt) marks[i] = 0;
  __syncthreads();
  {
    const int per = pl.vec ? 4 : 1, cpl = (x1 - x0 + per - 1) / per;
    const int total = n_off * cpl;
    const int32_t* D = dm + st + fb + x0;  // line 0's directions, at x0
    for (int e0 = tid; e0 < total; e0 += 8 * nt) {
      int4 d[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nt;
        d[u] = make_int4(0, 0, 0, 0);
        if (e < total) {
          const int32_t* q = D + (size_t)(e / cpl) * 3 * st + (e % cpl) * per;
          if (pl.vec) d[u] = __ldg(reinterpret_cast<const int4*>(q));
          else d[u].x = __ldg(q);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * nt;
        const int r = max(max(vcheck_reach<kHp>(d[u].x), vcheck_reach<kHp>(d[u].y)),
                          max(vcheck_reach<kHp>(d[u].z), vcheck_reach<kHp>(d[u].w)));
        if (e < total && r > H) atomicOr(marks + (e / cpl >> 5), 1u << (e / cpl & 31));
      }
    }
  }
  // the barriers are set and every block of the cluster runs before any
  // halo store; every block's marks are made
  cluster_arrive();
  cluster_wait();
  for (int i = tid; i < pl.marks; i += nt) {
    uint32_t m = 0;
    for (int k = 0; k < pl.blocks; ++k) m |= cluster.map_shared_rank(marks, k)[i];
    far_lines[i] = m;
  }
  // the neighbours' cur/nxt buffers (at the same offsets in every block)
  // and halo barriers
  const uint32_t left_buf = has_left ? cluster_addr(smem_addr(buf), j - 1) : 0;
  const uint32_t right_buf = has_right ? cluster_addr(smem_addr(buf), j + 1) : 0;
  const uint32_t left_bar = has_left ? cluster_addr(bar0, j - 1) : 0;
  const uint32_t right_bar = has_right ? cluster_addr(bar0, j + 1) : 0;

  // column x of line li into nxt, the neighbours' halos and out
  auto emit = [&](int li, int x, float tl) {
    const int xi = x - base;
    nxt[xi] = tl;
    if (li + 1 < n_off) {
      // the edge strips into the neighbours' halos (on the barrier of line
      // li's parity): column x sits at xi + slice in the left neighbour's
      // window, xi - slice in the right's
      const uint32_t nx = 4 * (uint32_t)(nxt - buf);  // nxt's byte offset in the buffers
      const uint32_t bar = 8 * (li & 1);
      if (has_left && x - x0 < H) st_async(left_buf + nx + 4 * (xi + Sc), tl, left_bar + bar);
      if (has_right && x >= x1 - H) st_async(right_buf + nx + 4 * (xi - Sc), tl, right_bar + bar);
    }
    out[(size_t)li * st + fb + x] = tl;
  };

  for (int li = 0; li < n_off; ++li) {
    // line li's stage is in, every thread is done with line li-1, and
    // this block's part of cur (nxt of line li-1) is written
    cp_async_wait_pending(pl.ring - 2);
    __syncthreads();
    // every thread has seen line li-2's halo land: its barrier may take
    // line li's (lines 0 and 1 were set above; the last line sends none)
    if (tid == 0 && li >= 2 && li + 1 < n_off) mbar_expect(bar0 + 8 * (li & 1), halo_bytes);
    if (li + pl.ring - 1 < n_off) issue(li + pl.ring - 1);  // into line li-1's stage
    else cp_async_commit();
    VcheckPre v[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int x = x0 + tid + k * nt;
      if (x < x1) v[k] = precompute(li, x);
    }
    if (li > 0) {
      // the neighbours' columns of line li-1 have landed in cur
      mbar_wait(bar0 + 8 * ((li - 1) & 1), ((li - 1) >> 1) & 1);
    }
    unsigned far_cols = 0;  // bit k: column k reaches past the halo
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int x = x0 + tid + k * nt;
      if (x < x1) {
        if (v[k].kind == 3) far_cols |= 1u << k;
        else emit(li, x, update(x, v[k]));
      }
    }
    if ((far_lines[li >> 5] >> (li & 31)) & 1u) {
      // a column of the line reaches past the halo: after this barrier
      // every block's line li-1 is in device memory
      if (li > 0) {
        cluster_arrive();
        cluster_wait();
      }
      const float* S = ring + (li % pl.ring) * SW;
      const float* CI = S + 4 * WW;
      const int32_t* DMC = reinterpret_cast<const int32_t*>(CI + 2 * Sc);
      const float* prev = li == 0 ? init + fb : out + (size_t)(li - 1) * st + fb;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int x = x0 + tid + k * nt;
        if ((far_cols >> k) & 1u) {
          emit(li, x,
               vcheck_far<kHp>(dl + (size_t)li * st + fb, nb + (size_t)li * 3 * st + fb, st,
                               prev, x, DMC[x - x0], CI[x - x0], mode, rcp0, rcp1, rcp2, vt2));
        }
      }
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  // no block leaves while a neighbour may still address it
  cluster_arrive();
  cluster_wait();
  if (tid == 0) {  // the memory holds no barrier for the next block on this SM
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(bar0) : "memory");
    asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(bar0 + 8) : "memory");
  }
}

// The cluster for frames of width w and directions up to mdis (hp: 2*mdis
// half-pels, mdis columns): at most `most` blocks, each slice at least the
// halo wide, so that a block's halo lies in its two neighbours, and at most
// kVcheckCols columns per thread; 16-byte copies where w is a multiple of 4
// (slice and halo rounded up to one too) and the rows start on 16 bytes
// (`aligned`); a mark bit for each of n_off lines; the deepest ring (2 to
// kVcheckRing stages) that fits shared memory.  blocks = 0: no plan fits.
VcheckPlan vcheck_plan(int w, int mdis, int n_off, int most, bool aligned) {
  VcheckPlan p;
  p.marks = (n_off + 31) / 32;
  p.vec = w % 4 == 0 && aligned;
  p.halo = p.vec ? (mdis + 3) / 4 * 4 : mdis;
  int c = w / p.halo;
  c = c < 1 ? 1 : (c > most ? most : c);
  p.slice = (w + c - 1) / c;
  if (p.vec) p.slice = (p.slice + 3) / 4 * 4;
  p.blocks = (w + p.slice - 1) / p.slice;
  p.cols = p.slice <= kVcheckMaxThreads ? 1 : kVcheckCols;
  p.threads = ((p.slice + p.cols - 1) / p.cols + 31) / 32 * 32;
  const long long words =
      (long long)((kMaxSmemBytes - 16) / sizeof(float)) - 2 * p.win() - 2 * p.marks;
  p.ring = (int)(words / p.stage());
  if (p.ring > kVcheckRing) p.ring = kVcheckRing;
  if (p.ring < 2 || p.threads > kVcheckMaxThreads) p.blocks = 0;
  return p;
}

}  // namespace

extern "C" {

// Words of global backtrack scratch each line needs (0: it fits the block's
// shared memory).
long long vz_eedi3_scratch_words(int w, int mdis, int hp) {
  const Plan P = plan(w, mdis, hp != 0);
  return P.bt_smem ? 0 : P.bt_words;
}

// r3p..r3n: (lines, w + 192) f32; bmask: (lines, w) bool or null (non-hp
// only); out: (lines, w) f32; fpath: (lines, w) int32; scratch: lines x
// vz_eedi3_scratch_words words, or null when that is 0; all contiguous on
// one device.
int vz_eedi3_fused(const void* r3p, const void* r1p, const void* r1n, const void* r3n,
                   const void* bmask, void* out, void* fpath, void* scratch, int lines, int w,
                   int mdis, int nrad, int hp, float alpha, double beta, float gamma,
                   float omab, float big, void* stream) {
  if (lines == 0 || w == 0) return 0;
  if (mdis < 1 || mdis > kMdisMax || nrad < 0 || nrad > kNradMax || (hp && bmask)) {
    return (int)cudaErrorInvalidValue;
  }
  const float *a = (const float*)r3p, *b = (const float*)r1p;
  const float *c = (const float*)r1n, *d = (const float*)r3n;
  const uint8_t* m = (const uint8_t*)bmask;
  float* o = (float*)out;
  int32_t* f = (int32_t*)fpath;
  uint32_t* sc = (uint32_t*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  if (hp) {
    return launch_k<true, false>(a, b, c, d, m, o, f, sc, lines, w, mdis, nrad, alpha, beta,
                                 gamma, omab, big, s);
  }
  if (m) {
    return launch_k<false, true>(a, b, c, d, m, o, f, sc, lines, w, mdis, nrad, alpha, beta,
                                 gamma, omab, big, s);
  }
  return launch_k<false, false>(a, b, c, d, m, o, f, sc, lines, w, mdis, nrad, alpha, beta,
                                gamma, omab, big, s);
}

// dl, cint, out: (n_off, B, w) f32; nb: (n_off, 3, B, w) f32; dm: (n_off, 3,
// B, w) int32; init: (B, w) f32; all contiguous on one device.  mdis: the
// op's, which sizes the halo (directions that reach further take the far
// path).
int vz_vcheck(const void* dl, const void* nb, const void* dm, const void* cint,
              const void* init, void* out, int n_off, int nbatch, int w, int mdis, int hp,
              int mode, float rcp0, float rcp1, float rcp2, float vt2, void* stream) {
  if (n_off == 0 || nbatch == 0 || w == 0) return 0;
  if (mdis < 1) return (int)cudaErrorInvalidValue;
  // the portable cluster, or for rows too wide for it twice as many blocks
  bool aligned = true;
  for (const void* t : {dl, nb, dm, cint}) aligned = aligned && (uintptr_t)t % 16 == 0;
  VcheckPlan P = vcheck_plan(w, mdis, n_off, kVcheckCluster, aligned);
  if (P.blocks == 0) P = vcheck_plan(w, mdis, n_off, 2 * kVcheckCluster, aligned);
  if (P.blocks == 0) return (int)cudaErrorInvalidValue;
  auto k = hp ? (P.cols == 1 ? vcheck_kernel<true, 1> : vcheck_kernel<true, kVcheckCols>)
              : (P.cols == 1 ? vcheck_kernel<false, 1> : vcheck_kernel<false, kVcheckCols>);
  cudaError_t err =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.bytes());
  if (err == cudaSuccess && P.blocks > kVcheckCluster) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nbatch * P.blocks);
  cfg.blockDim = dim3(P.threads);
  cfg.dynamicSmemBytes = P.bytes();
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, k, (const float*)dl, (const float*)nb, (const int32_t*)dm, (const float*)cint,
      (const float*)init, (float*)out, n_off, nbatch, w, mode, rcp0, rcp1, rcp2, vt2, P);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
