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
// B10: one block per frame sweeps the interpolated lines in order; the
// carried updated line lives in shared memory (two buffers, one read and
// one written per line, a __syncthreads between lines); threads over x.
// Every gather clamps its column into [0, w-1], as the edge pad does.
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
// resident lines per SM, to hide each other's latency.  B10 reads 9 f32/int rows per interpolated pixel and
// writes one: bytes, with only B blocks in flight.
//
// Plain C interface, loaded with ctypes.  Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPad = 96;
constexpr int kMdisMax = 40;
constexpr int kNradMax = 3;
static_assert(2 * kMdisMax + kNradMax + 2 < kPad, "the cost build's reads stay in the pad");
constexpr size_t kSmemBudget = 48 * 1024;  // deltas in shared memory up to this
// named barriers (0 is __syncthreads'): cost buffer 0/1 full, 0/1 empty,
// and the producers' own
constexpr int kBarFull = 1, kBarEmpty = 3, kBarProd = 5;
constexpr int kVcheckThreads = 512;

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

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <bool kHp>
__global__ void __launch_bounds__(kVcheckThreads)
    vcheck_kernel(const float* __restrict__ dl, const float* __restrict__ nb,
                  const int32_t* __restrict__ dm, const float* __restrict__ cint,
                  const float* __restrict__ init, float* __restrict__ out, int n_off,
                  int nbatch, int w, int mode, float rcp0, float rcp1, float rcp2,
                  float vt2) {
  extern __shared__ float carry[];
  float* cur = carry;  // the line the previous iteration updated (pd-2)
  float* nxt = carry + w;
  const int b = blockIdx.x;
  for (int x = threadIdx.x; x < w; x += kVcheckThreads) cur[x] = init[(size_t)b * w + x];
  __syncthreads();
  const size_t st = (size_t)nbatch * w;  // one (B, W) plane
  for (int li = 0; li < n_off; ++li) {
    const size_t o1 = (size_t)li * st + (size_t)b * w;
    const size_t o3 = (size_t)li * 3 * st + (size_t)b * w;
    const float* DL = dl + o1;
    const float* CI = cint + o1;
    const float* D1P = nb + o3;
    const float* D1N = D1P + st;
    const float* D2N = D1N + st;
    const int32_t* DMP = dm + o3;
    const int32_t* DMC = DMP + st;
    const int32_t* DMN = DMC + st;
    for (int x = threadIdx.x; x < w; x += kVcheckThreads) {
      const int dmc = DMC[x], dmp = DMP[x], dmn = DMN[x];
      bool keep = dmc == 0;
      keep |= (max(dmc * dmp, dmc * dmn) < 0) || (dmp == dmn && dmp == 0);
      const int maxoff = kHp ? ((dmc & 1) == 0 ? abs(dmc >> 1)
                                               : max(abs(dmc >> 1), abs((dmc + 1) >> 1)))
                             : abs(dmc);
      keep |= (x + maxoff >= w) || (x - maxoff < 0);
      // up stack (d2p, d1p, dl) at x + o, down stack (dl, d1n, d2n) at x - o
      auto up0 = [&](int o) { return cur[clampi(x + o, 0, w - 1)]; };
      auto up1 = [&](int o) { return D1P[clampi(x + o, 0, w - 1)]; };
      auto up2 = [&](int o) { return DL[clampi(x + o, 0, w - 1)]; };
      auto dn0 = [&](int o) { return DL[clampi(x - o, 0, w - 1)]; };
      auto dn1 = [&](int o) { return D1N[clampi(x - o, 0, w - 1)]; };
      auto dn2 = [&](int o) { return D2N[clampi(x - o, 0, w - 1)]; };
      float it, ib, vt, vb;
      int dabs;
      if (kHp) {
        const int d20 = dmc >> 1, d21 = (dmc + 1) >> 1;
        const float a0 = up0(d20), a1 = up1(d20), a2 = up2(d20);
        const float b0 = dn0(d20), b1 = dn1(d20), b2 = dn2(d20);
        if ((dmc & 1) == 0) {
          it = (a0 + b0) * 0.5f;
          ib = (a2 + b2) * 0.5f;
          vt = fabsf(a0 - a1) + fabsf(a2 - a1);
          vb = fabsf(b2 - b1) + fabsf(b0 - b1);
        } else {
          const float s2ps = a0 + up0(d21), s1ps = a1 + up1(d21), pa0 = a2 + up2(d21);
          const float ps0 = b0 + dn0(d21), s1ns = b1 + dn1(d21), s2ns = b2 + dn2(d21);
          it = (s2ps + ps0) * 0.25f;
          vt = (fabsf(s2ps - s1ps) + fabsf(pa0 - s1ps)) * 0.5f;
          ib = (pa0 + s2ns) * 0.25f;
          vb = (fabsf(s2ns - s1ns) + fabsf(ps0 - s1ns)) * 0.5f;
        }
        dabs = abs(dmc) >> 1;
      } else {
        const float gu0 = up0(dmc), gu1 = up1(dmc), gu2 = up2(dmc);
        const float gd0 = dn0(dmc), gd1 = dn1(dmc), gd2 = dn2(dmc);
        it = (gu0 + gd0) * 0.5f;
        ib = (gu2 + gd2) * 0.5f;
        vt = fabsf(gu0 - gu1) + fabsf(gu2 - gu1);
        vb = fabsf(gd2 - gd1) + fabsf(gd0 - gd1);
        dabs = abs(dmc);
      }
      const float dlx = DL[x], d1p = D1P[x], d1n = D1N[x], ci = CI[x];
      const float vc = fabsf(dlx - d1p) + fabsf(dlx - d1n);
      const float e0 = fabsf(it - d1p), e1 = fabsf(ib - d1n);
      const float e2 = fabsf(vt - vc), e3 = fabsf(vb - vc);
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
      const float a2 = fmaxf((vt2 - (float)dabs) * rcp2, 0.0f);
      const float a = fminf(fmaxf(a0, fmaxf(a1, a2)), 1.0f);
      float tl = (1.0f - a) * dlx + a * ci;
      tl = keep ? ci : tl;
      out[o1 + x] = tl;
      nxt[x] = tl;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
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
// B, w) int32; init: (B, w) f32; all contiguous on one device.
int vz_vcheck(const void* dl, const void* nb, const void* dm, const void* cint,
              const void* init, void* out, int n_off, int nbatch, int w, int hp, int mode,
              float rcp0, float rcp1, float rcp2, float vt2, void* stream) {
  if (n_off == 0 || nbatch == 0 || w == 0) return 0;
  const size_t bytes = 2 * sizeof(float) * (size_t)w;
  cudaStream_t s = (cudaStream_t)stream;
  const float *pdl = (const float*)dl, *pnb = (const float*)nb;
  const int32_t* pdm = (const int32_t*)dm;
  const float *pci = (const float*)cint, *pin = (const float*)init;
  float* po = (float*)out;
  cudaError_t err;
  if (hp) {
    err = cudaFuncSetAttribute(vcheck_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    vcheck_kernel<true><<<nbatch, kVcheckThreads, bytes, s>>>(
        pdl, pnb, pdm, pci, pin, po, n_off, nbatch, w, mode, rcp0, rcp1, rcp2, vt2);
  } else {
    err = cudaFuncSetAttribute(vcheck_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    vcheck_kernel<false><<<nbatch, kVcheckThreads, bytes, s>>>(
        pdl, pnb, pdm, pci, pin, po, n_off, nbatch, w, mode, rcp0, rcp1, rcp2, vt2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
