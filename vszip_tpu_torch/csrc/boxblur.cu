// BoxBlur integer kernels for Hopper (sm_90a), the CUDA counterparts of the
// Pallas kernels in vszip_tpu/kernels/boxblur_pallas.py.
//
// Five kernels, each exact to the reference's integer arithmetic:
//   v_chip      runtime vertical fixed-point pass(es)      (B3 rt_blur_v_multi_pallas,
//               on chip (up to 6 passes, rings in shared    B4 rt_blur_v_pallas)
//               memory)
//   v_fixed     the same as a column walk, for what v_chip
//               does not take (more passes, larger rings)
//   h_fixed     runtime horizontal fixed-point pass(es)    (B2 rt_blur_h_pallas, and
//                                                           the H stage of B1)
//   ct_v_chip   comptime vertical column sums, quantised,  (V stage of B1
//               on chip (a ring in shared memory, r <= 897) ct_blur_int_pallas)
//   ct_blur     both stages of B1 in one launch, the       (B1 ct_blur_int_pallas)
//               intermediate rows in shared memory
//
// The fixed point that must survive bit for bit (ops/boxblur.py:122-139):
//   inv  = (2^32 + r) / (2r+1),  inv2 = inv >> 16
//   C0   = (W0*inv + 2^31) >> 16            (W0: the window sum at index 0)
//   out  = (C0 + inv2*(W(x) - W0)) >> 16    (evaluated in int64; >> floors)
// The runtime mirror duplicates the edge: m(-j) = j-1, m(n-1+j) = n-j.
// The comptime vertical mirror is the hybrid one: above the top it reflects
// without duplication (clamped to n-1); below the bottom, tap offset o reads
// row max(n-1-o, 0).  Its column sums are quantised as (2*col + k) / (2k).
//
// Every kernel is bound by device-memory bytes (one read and one write of
// the plane per launch; about 12.4 MB per 1080p YUV420P16 frame against
// 3.35 TB/s), so the designs keep loads coalesced across a warp and keep
// the running state in registers or shared memory.  The TPU kernels' bf16
// band matmuls, byte splits and u32 limbs are not needed: Hopper has native
// int32/int64 arithmetic.  h_fixed's first design, one warp per row and a
// prefix sum built 32 values at a time by a chain of dependent shuffles
// (62 steps per 1920-wide row and pass), was held by that chain's latency,
// not by its work.  Its second, a block per row cut into one segment per
// thread, spent each extra pass in shared memory (about 6 accesses and 3
// block barriers a sample and pass).  Rows up to about 2,000 samples at
// r <= 23 now run one warp a row with the row in registers for all passes
// (h_fixed_kernel<T, kSlots, kChunks>): lanes hold runs of exactly 2r + 1
// samples, so a window's two ends sit in the same register of neighbouring
// runs and every pass is a 3-input add, a multiply-add and a shift a sample;
// other rows keep the block design (h_fixed_kernel<T, kGlobal>).
// v_fixed's column walk, one thread per column, rows loaded 8 ahead and
// every pass through device memory, reached about 1.3 TB/s and read and
// wrote the plane once per pass: v_chip runs all passes of a 128-byte
// strip in one warp as a wavefront, so the plane is read and written once
// per call (see v_chip_kernel).  B1's vertical stage was a column walk that
// spent 55-66% of a column in its runtime division and stores and 18-33%
// summing the 2r+1 taps of each edge row: ct_v_chip slides every row, edge
// rows too, and divides by a per-call multiply-high (see ct_v_chip_kernel).
// The op's comptime path takes r <= 22, so the ring's limit is the only one.
// B1's two stages each read and write the plane: where its shape fits,
// ct_blur_kernel runs both in one launch and keeps the quantised rows in
// shared memory, so the call reads and writes each plane once.
//
// Plain C interface, loaded with ctypes.  Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kChunk = 8;        // rows loaded ahead per step of a column walk
constexpr int kColThreads = 128; // threads per block of a column kernel
constexpr int kMaxGridY = 65535;
// h_fixed: samples per segment, the most threads per block, and the grid of
// the global-scratch variant (2 blocks per SM)
constexpr int kSeg = 8;
constexpr int kMaxRowThreads = 1024;
constexpr long long kScratchBlocks = 264;
// v_chip: the most passes it unrolls, the rows of one copy group (32 lanes
// x 16 bytes = 4 rows of a warp's 128-byte strip), and the groups in flight
// ahead of the row being consumed.  A warp's rings hold
// passes * (2r + 1) + kChipAheadRows rows of kStripBytes; the wrapper takes
// the column walk where they pass kMaxSmemBytes (kernels/boxblur.py
// v_fixed_on_chip holds the same numbers).
constexpr int kChipPasses = 6;
constexpr int kGroupRows = 4;
constexpr int kAheadGroups = 4;
constexpr int kChipAheadRows = (kAheadGroups + 1) * kGroupRows;
constexpr int kStripBytes = 128;
// h_fixed in registers: warps (rows in flight) per block, and its runs:
// {slots, chunks, blocks} holds n = 2r + 1 <= slots samples in each of up
// to `chunks` chunks a lane, with at least `blocks` blocks an SM (which caps
// ptxas' registers; the 4-slot run spills at its default of 128); the first
// run whose slots take n is used.  kernels/boxblur.py H_WARP_RUNS holds the
// same slots and chunks, and its h_fixed_warp_shape chooses the shape that
// vz_h_fixed_warp is given.
constexpr int kRowWarps = 4;
constexpr int kWarpRuns[][3] = {{4, 22, 1}, {8, 13, 3}, {16, 8, 2}, {24, 4, 3},
                                {28, 3, 3}, {32, 3, 2}, {48, 2, 2}};
// ct_blur (B1 in one launch): warps a block, also the rows of a group (the
// first half takes them two by two through the register pass, the second
// half computes their vertical sums, two 16-byte chunks of columns a thread,
// so rows take at most 32 * kFusedWarps chunks), and the groups of input
// rows copied ahead of the group being computed.  kernels/boxblur.py
// CT_FUSED_WARPS and CT_FUSED_AHEAD hold the same numbers.
constexpr int kFusedWarps = 8;
constexpr int kFusedAhead = 1;

// The least blocks an SM of the run with `slots`, and the least n = 2r + 1
// it takes (the odd number past the run before): slots below it always hold
// a sample.
__host__ __device__ constexpr int warp_run_blocks(int slots) {
  for (const auto& run : kWarpRuns) {
    if (run[0] == slots) return run[2];
  }
  return 1;
}
__host__ __device__ constexpr int warp_run_live(int slots) {
  int before = 2;
  for (const auto& run : kWarpRuns) {
    if (run[0] == slots) break;
    before = run[0];
  }
  return (before + 1) | 1;
}

__device__ __forceinline__ int mirror_dup(int k, int n) {
  return k < 0 ? -k - 1 : (k >= n ? 2 * n - 1 - k : k);
}

// The duplicate-edge mirror repeated with period 2n, as NumPy's 'symmetric'
// pad extends it: only a window wider than its row reaches past one
// reflection (the comptime quirk, where hpasses=0 skips the hradius check).
__device__ __forceinline__ int mirror_periodic(int k, int n) {
  k %= 2 * n;
  if (k < 0) k += 2 * n;
  return k < n ? k : 2 * n - 1 - k;
}

__device__ __forceinline__ long long fixed_c0(long long w0, long long inv) {
  return (w0 * inv + (1LL << 31)) >> 16;
}

__device__ __forceinline__ int fixed_out(long long c0, long long inv2, long long d) {
  return (int)((c0 + inv2 * d) >> 16);
}

// One runtime vertical pass down one column.  `src` and `dst` point at the
// column's row 0 and step by `w`; they never alias.  No pointer is
// `__restrict__`: a pass may read what an earlier pass of the same thread
// wrote, which the non-coherent load path would not see.
template <typename T>
__device__ void v_pass(const T* src, T* dst, int h, long long w, int r,
                       long long inv, long long inv2) {
  long long w0 = 0;
  for (int i = 0; i <= r; ++i) w0 += src[i * w];
  for (int i = 0; i < r; ++i) w0 += src[i * w];
  const long long c0 = fixed_c0(w0, inv);
  long long d = 0;  // W(y) - W(0)
  for (int y0 = 0; y0 < h; y0 += kChunk) {
    int lead[kChunk], trail[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int y = y0 + j;
      if (y < h) {
        lead[j] = src[mirror_dup(y + r + 1, h) * w];
        trail[j] = src[mirror_dup(y - r, h) * w];
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int y = y0 + j;
      if (y < h) {
        dst[y * w] = (T)fixed_out(c0, inv2, d);
        d += lead[j] - trail[j];
      }
    }
  }
}

// One thread per column of one frame; all `passes` run in the thread,
// ping-ponging between `out` and `scratch` so that the last pass lands in
// `out`.  No other thread touches the column, so no synchronisation.
template <typename T>
__global__ void v_fixed_kernel(const T* in, T* out, T* scratch, int n, int h,
                               int w, int r, int passes, long long inv,
                               long long inv2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  for (int f = blockIdx.y; f < n; f += gridDim.y) {
    const long long base = (long long)f * h * w + x;
    const T* src = in + base;
    for (int p = 0; p < passes; ++p) {
      T* dst = (((passes - 1 - p) & 1) == 0 ? out : scratch) + base;
      v_pass(src, dst, h, w, r, inv, inv2);
      src = dst;
    }
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 32-bit word of a row: K samples of T.
template <typename T>
struct Word {
  static constexpr int K = 4 / sizeof(T);
  static __device__ __forceinline__ uint32_t at(uint32_t v, int i) {
    return sizeof(T) == 2 ? (i ? v >> 16 : v & 0xffffu) : (v >> (8 * i)) & 0xffu;
  }
  // the outputs o[i] (bits 16.. of each) packed into one word
  static __device__ __forceinline__ uint32_t pack(const uint32_t* o) {
    if (sizeof(T) == 2) return __byte_perm(o[0], o[1], 0x7632);
    return __byte_perm(__byte_perm(o[0], o[1], 0x0062), __byte_perm(o[2], o[3], 0x0062), 0x5410);
  }
  // the outputs o[i] (bits 0.. of each) packed into one word
  static __device__ __forceinline__ uint32_t join(const uint32_t* o) {
    if (sizeof(T) == 2) return __byte_perm(o[0], o[1], 0x5410);
    return __byte_perm(__byte_perm(o[0], o[1], 0x0040), __byte_perm(o[2], o[3], 0x0040), 0x5410);
  }
};

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// One warp's walk down a 128-byte strip of one frame (v_chip, ct_v_chip):
// lane l owns word l (K columns from xl) of every row.  issue(g) fills
// rows 4g .. 4g+3 into the input ring of R0 rows of 32 words, 16-byte
// cp.async copies with lane l copying chunk l % 8 of row l / 8 (kVec: rows
// 16-byte aligned), else element loads into registers that are stored when
// the next group is issued; store(v) writes the next output row's word.
template <typename T, bool kVec>
struct StripWalk {
  static constexpr int K = Word<T>::K, E = 16 / sizeof(T);  // samples per word, per chunk
  const T* csrc;        // this lane's chunk of the next group
  uint32_t* cdst;       // its place in the ring's first slots
  T* orow;              // the next output row's word
  int h, w, R0, crow, cx, xl;
  int cslot = 0;        // ring slot of the next group's first row
  uint4 pend;           // element loads: the chunk of the last group issued
  uint32_t* pend_dst = nullptr;

  __device__ StripWalk(const T* in, T* out, uint32_t* ring, size_t base, int strip, int h_,
                       int w_, int R0_, int lane)
      : h(h_), w(w_), R0(R0_), crow(lane >> 3) {
    const int x0 = strip * 32 * K;
    xl = x0 + lane * K;
    cx = x0 + (lane & 7) * E;
    csrc = in + base + crow * w + cx;
    cdst = ring + crow * 32 + (lane & 7) * 4;
    orow = out + base + xl;
  }
  __device__ __forceinline__ void issue(int g) {
    const int row = g * kGroupRows + crow;
    uint32_t* d = cdst + (cslot + crow >= R0 ? cslot - R0 : cslot) * 32;
    if (kVec) {
      if (row < h && cx < w) cp_async16(d, csrc);
      cp_async_commit();
    } else {
      if (pend_dst != nullptr) *reinterpret_cast<uint4*>(pend_dst) = pend;
      pend_dst = nullptr;
      if (row < h) {
        uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (cx + i < w) v[i / K] |= (uint32_t)csrc[i] << (8 * sizeof(T) * (i % K));
        }
        pend = make_uint4(v[0], v[1], v[2], v[3]);
        pend_dst = d;
      }
    }
    csrc += (uint32_t)kGroupRows * w;
    cslot += kGroupRows;
    if (cslot >= R0) cslot -= R0;
  }
  __device__ __forceinline__ void store(uint32_t v) {
    if (kVec) {
      if (xl < w) *reinterpret_cast<uint32_t*>(orow) = v;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (xl + k < w) orow[k] = (T)Word<T>::at(v, k);
      }
    }
    orow += w;
  }
};

// v_fixed on chip: all P passes of one strip of 128 bytes of one frame's
// rows (64 uint16 or 128 uint8 columns) in one warp, lane l on word l of
// each row, one warp per block.  The passes run as a wavefront down the
// strip: at step s pass p takes its input row L = s - p(r+1) (its lead) and
// gives its output row L - r - 1, which is pass p+1's lead at the same step,
// so a row goes through all passes in registers and only the last pass
// writes device memory.  Pass p's window needs its input 2r+1 rows back
// (the trail) and, past the bottom, the mirrored rows, so each pass keeps a
// ring of its last 2r+1 input rows in shared memory, lane l reading and
// writing only its own words (no barrier).  The input's ring (ring 0) is
// filled ahead of the steps by 16-byte cp.async copies, kGroupRows rows a
// group and kAheadGroups groups (16 rows) in flight, lane l copying chunk
// l % 8 of row l / 8 of a group, so the ring is waited for and the warp
// synchronised once a group; a plane whose rows are not 16-byte aligned
// loads its chunks by elements into registers a group ahead instead.  Pass p >= 1 keeps its
// row L at slot (L + p(r+1)) mod (2r+1), so at step s every pass reads its
// trail from, and writes its lead to, slot s mod (2r+1).  The output
// (C0 + inv2*(W - W0)) >> 16 cast to T is (k0 + inv2*W) >> 16 mod 2^16 (or
// 2^8), so only the low 32 bits of k0 = C0 - inv2*W0 are kept.  Offsets
// inside a plane are 32-bit; pointers advance by rows.  At each step the
// window updates of the passes are independent (pass p's output at step s
// needs only its own sum of step s-1), so they overlap.
template <typename T, int P, bool kVec>
__global__ void __launch_bounds__(32)
    v_chip_kernel(const T* __restrict__ in, T* __restrict__ out, int h, int w, int r, int strips,
                  long long inv, uint32_t inv2) {
  using Wd = Word<T>;
  constexpr int K = Wd::K;  // samples per word
  extern __shared__ uint32_t ring[];
  const int lane = threadIdx.x;
  const int R = 2 * r + 1, R0 = R + kChipAheadRows;
  uint32_t* ring0 = ring;             // R0 input rows of 32 words
  uint32_t* rings = ring + R0 * 32;   // R slots of P-1 rows: pass p's at word (p-1)*32
  const int f = blockIdx.x / strips, strip = blockIdx.x - f * strips;
  StripWalk<T, kVec> st(in, out, ring0, (size_t)f * h * w, strip, h, w, R0, lane);

  uint32_t wx[P][K], k0[P][K];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int k = 0; k < K; ++k) wx[p][k] = k0[p][k] = 0;
  }
  int c0 = 0, t0 = R0 - R, cr = 0;  // s mod R0, (s - R) mod R0, s mod R
  auto advance = [&]() {
    c0 = c0 + 1 == R0 ? 0 : c0 + 1;
    t0 = t0 + 1 == R0 ? 0 : t0 + 1;
    cr = cr + 1 == R ? 0 : cr + 1;
  };
  // a step at which no pass mirrors: every pass reads its trail from and
  // writes its lead to slot s mod R of its ring
  auto steady = [&]() {
    uint32_t* rs = rings + cr * ((P - 1) * 32) + lane;
    uint32_t lead = ring0[c0 * 32 + lane], trail = ring0[t0 * 32 + lane];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p > 0) {
        trail = rs[(p - 1) * 32];
        rs[(p - 1) * 32] = lead;
      }
      uint32_t o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        o[k] = k0[p][k] + inv2 * wx[p][k];
        wx[p][k] += Wd::at(lead, k) - Wd::at(trail, k);
      }
      lead = Wd::pack(o);
    }
    st.store(lead);
  };
  // a step at the top or the bottom: passes that have not started or are
  // done skip it, the others take their window sum W0 or mirror
  const int hb0 = (2 * h - 1) % R0, hb = (2 * h - 1) % R;
  auto edge = [&](int s) {
    uint32_t* rs = rings + cr * ((P - 1) * 32) + lane;
    uint32_t carry = 0;  // pass p-1's output row at this step: pass p's lead
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int L = s - p * (r + 1);
      if (L < 0 || L > h + r) continue;
      uint32_t* rp = rings + (p - 1) * 32 + lane;  // pass p's ring, slot 0 (p >= 1)
      uint32_t lead;
      if (L <= h - 1) {
        lead = p == 0 ? ring0[c0 * 32 + lane] : carry;
      } else {  // row 2h-1-L
        lead = p == 0 ? ring0[wrap(hb0 - c0, R0) * 32 + lane]
                      : rp[wrap(hb + p - cr, R) * ((P - 1) * 32)];
      }
      if (L <= r) {  // W0 = rows 0 .. r plus rows 0 .. r-1
#pragma unroll
        for (int k = 0; k < K; ++k) wx[p][k] += (L < r ? 2u : 1u) * Wd::at(lead, k);
        if (p > 0) rs[(p - 1) * 32] = lead;
        if (L == r) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            k0[p][k] = (uint32_t)(fixed_c0(wx[p][k], inv) - (long long)inv2 * wx[p][k]);
          }
        }
        continue;
      }
      const int y = L - r - 1;  // the output row
      uint32_t o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = k0[p][k] + inv2 * wx[p][k];
      uint32_t trail;  // row y - r, mirrored above the top to r - 1 - y
      if (y >= r) {
        trail = p == 0 ? ring0[t0 * 32 + lane] : rs[(p - 1) * 32];
      } else {
        trail = p == 0 ? ring0[(2 * r - s) * 32 + lane] : rp[wrap(p - 1 - cr, R) * ((P - 1) * 32)];
      }
      if (p > 0 && L <= h - 1) rs[(p - 1) * 32] = lead;
#pragma unroll
      for (int k = 0; k < K; ++k) wx[p][k] += Wd::at(lead, k) - Wd::at(trail, k);
      carry = Wd::pack(o);
      if (p == P - 1) st.store(carry);
    }
  };

  for (int g = 0; g < kAheadGroups; ++g) st.issue(g);
  const int S = h + P * (r + 1);                // steps: the last pass gives row h-1 at S-1
  const int s_steady = (P + 1) * (r + 1) - 1;  // from here to h-1 no pass mirrors
  for (int s0 = 0; s0 < S; s0 += kGroupRows) {
    if (s0 < h) {
      __syncwarp();  // every lane is done with the rows the copies overwrite
      st.issue(s0 / kGroupRows + kAheadGroups);
      if (kVec) cp_async_wait<kAheadGroups>();
      __syncwarp();  // rows s0 .. s0+3 are in ring 0, for every lane
    }
    if (s0 >= s_steady && s0 + kGroupRows <= h) {
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
        steady();
        advance();
      }
    } else {
#pragma unroll 1
      for (int s = s0; s < s0 + kGroupRows && s < S; ++s) {
        if (s >= s_steady && s < h) {
          steady();
        } else {
          edge(s);
        }
        advance();
      }
    }
  }
}

// h_fixed's shape for a row of w samples and radius r: the mirror-padded
// row of L = w + 2r samples is cut into U = threads * rounds segments of
// kSeg samples; a block of `threads` threads (a multiple of 32, at most
// kMaxRowThreads) takes one segment per thread in each of `rounds` rounds.
// Sample q (segment q / 8, element q % 8) sits at (q % 8) * U + q / 8 of a
// row buffer, so a warp's 32 segments meet no bank conflict, whichever
// element each reads; buffers hold 8U samples (0 past L).
struct HShape {
  int threads, rounds;
  __host__ __device__ int units() const { return threads * rounds; }
  // two row buffers, the segment prefixes and the warps' totals
  __host__ __device__ size_t block_words() const {
    return 2 * (size_t)kSeg * units() + units() + 1 + 32;
  }
};

HShape h_shape(int w, int r) {
  const int segs = (w + 2 * r + kSeg - 1) / kSeg;
  HShape h;
  h.threads = segs < kMaxRowThreads ? (segs + 31) / 32 * 32 : kMaxRowThreads;
  h.rounds = (segs + h.threads - 1) / h.threads;
  return h;
}

// Sample q of row `src` mirror-padded by r: the duplicate-edge mirror, or
// its periodic repeat when r > w (the comptime quirk).
template <typename T>
__device__ __forceinline__ uint32_t padded_at(const T* __restrict__ src, int q, int w, int r) {
  return src[r <= w ? mirror_dup(q - r, w) : mirror_periodic(q - r, w)];
}

// Eight samples of T as one vector load or store: 16 bytes of uint16, 8
// of uint8.
template <typename T>
struct Chunk {
  using V = typename std::conditional<sizeof(T) == 2, uint4, uint2>::type;
  static __device__ __forceinline__ uint32_t get(const V& v, int i) {
    const uint32_t word = reinterpret_cast<const uint32_t*>(&v)[i * sizeof(T) / 4];
    return sizeof(T) == 2 ? (word >> (16 * (i & 1))) & 0xffffu : (word >> (8 * (i & 3))) & 0xffu;
  }
  static __device__ __forceinline__ V pack(const uint32_t* o) {
    V v;
    uint32_t* words = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < (int)(sizeof(V) / 4); ++j) {
      words[j] = sizeof(T) == 2 ? o[2 * j] | (o[2 * j + 1] << 16)
                                : o[4 * j] | (o[4 * j + 1] << 8) | (o[4 * j + 2] << 16) |
                                      (o[4 * j + 3] << 24);
    }
    return v;
  }
};

// The fixed-point output of window sum wx, cast to the plane's type: with
// k0 = C0 - inv2*W0, (C0 + inv2*(wx - W0)) >> 16 is (k0 + inv2*wx) >> 16,
// the same int64 for every wx < 2^32, and one 32x32->64 multiply-add.
template <typename T>
__device__ __forceinline__ uint32_t fixed_out_u(long long k0, uint32_t inv2, uint32_t wx) {
  return (T)(int)((k0 + (long long)((unsigned long long)inv2 * wx)) >> 16);
}

// h_fixed's block design, for the rows the register design leaves (longer rows,
// r > 23, the comptime quirk r > w): one block per row at a time, a
// persistent grid striding over the rows.  The mirror-padded row sits in
// shared memory (HShape's layout), written once from device memory: its
// interior by 16-byte (uint8: 8-byte) loads where the row allows them, the
// pad by mirrored scalar loads; the next
// row's loads are in flight while this row's passes run.  Each pass cuts
// the padded row into segments of 8 samples, one per thread and round:
// - thread k sums its segment;
// - one block scan of the segment totals (a warp scan of 32 totals, then
//   the warps' totals) gives E[u] = P(8u), the exclusive prefix sum P of
//   the padded row at each segment's start;
// - the thread owns the outputs x in [8u, 8u + 8): W(8u) = P(8u + 2r + 1) -
//   E[u], where P at any q is E[q / 8] plus fewer than 8 samples; then
//   W(x + 1) = W(x) + row[x + 2r + 1] - row[x] slides along the segment,
//   its 16 reads issued first (at offsets that are the same for every
//   thread, so the warp's reads meet no bank conflict).
// So no serial chain longer than a segment, one scan per row and pass, and
// no shuffle scan per 32 values.  A pass writes its output into the other
// row buffer, mirror-padded, so passes ping-pong between two row buffers;
// the last pass writes its eight outputs to device memory as one vector
// store.  All passes cost one read and one write of device memory.  P is
// uint32 and wraps; a difference is exact while the window sum stays below
// 2^32, which the wrapper guarantees (r < 32768).  Rows too long for shared
// memory (kGlobal) keep the same buffers in the global scratch `gscratch`,
// one slice per block of the grid; the arithmetic is the same.
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kMaxRowThreads)
    h_fixed_kernel(const T* __restrict__ in, T* __restrict__ out, long long rows, int w,
                   int r, int passes, HShape hs, bool vec, long long inv, int inv2,
                   uint32_t* gscratch) {
  using V = typename Chunk<T>::V;
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x;
  const int U = hs.units(), L = w + 2 * r;
  uint32_t* A = kGlobal ? gscratch + (size_t)blockIdx.x * hs.block_words() : smem;
  uint32_t* B = A + kSeg * U;
  uint32_t* E = B + kSeg * U;  // U + 1 segment prefixes
  uint32_t* wsum = E + U + 1;  // the warps' totals
  auto at = [U](int q) { return (q & 7) * U + (q >> 3); };
  // both buffers read 0 past the padded row
  for (int q = L + tid; q < kSeg * U; q += nt) A[at(q)] = B[at(q)] = 0;
  // where the lead (x + 2r + 1) and the output (x + r) of element i of
  // segment u sit: u plus these
  int off_lead[kSeg], off_out[kSeg];
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    off_lead[i] = at(2 * r + 1 + i);
    off_out[i] = at(r + i);
  }
  const int chunks = vec ? w / kSeg : 0;
  V pre;
  long long row = blockIdx.x;
  if (row < rows && tid < chunks) pre = reinterpret_cast<const V*>(in + row * w)[tid];
  for (; row < rows; row += gridDim.x) {
    const T* src = in + row * w;
    __syncthreads();  // the previous row's last reads of A are done
    if (vec) {
      // chunk t holds x = 8t .. 8t + 7, q = r + x: segment t, offsets off_out
      if (tid < chunks) {
#pragma unroll
        for (int i = 0; i < kSeg; ++i) A[tid + off_out[i]] = Chunk<T>::get(pre, i);
      }
      for (int t = tid + nt; t < chunks; t += nt) {
        const V v = reinterpret_cast<const V*>(src)[t];
#pragma unroll
        for (int i = 0; i < kSeg; ++i) A[t + off_out[i]] = Chunk<T>::get(v, i);
      }
      for (int i = tid; i < 2 * r; i += nt) {
        const int q = i < r ? i : i + w;
        A[at(q)] = padded_at(src, q, w, r);
      }
    } else {
      for (int q = tid; q < L; q += nt) A[at(q)] = padded_at(src, q, w, r);
    }
    __syncthreads();
    const long long next = row + gridDim.x;
    if (next < rows && tid < chunks) pre = reinterpret_cast<const V*>(in + next * w)[tid];
    uint32_t* cur = A;
    uint32_t* nxt = B;
    for (int p = 0; p < passes; ++p) {
      const bool last = p == passes - 1;
      uint32_t carry = 0;
      for (int a = 0; a < hs.rounds; ++a) {
        const int u = a * nt + tid;
        uint32_t inc = 0;
#pragma unroll
        for (int i = 0; i < kSeg; ++i) inc += cur[i * U + u];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t t = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += t;
        }
        if (lane == 31) wsum[warp] = inc;
        __syncthreads();
        for (int j = 0; j < warp; ++j) inc += wsum[j];
        E[u + 1] = carry + inc;
        if (u == 0) E[0] = 0;
        __syncthreads();
        carry = E[(a + 1) * nt];
      }
      // P(q): the segment's prefix and the samples from its start to q
      auto prefix = [&](int q) {
        const int j = q >> 3, n = q & 7;
        uint32_t v = E[j];
#pragma unroll
        for (int i = 0; i < kSeg - 1; ++i) v += i < n ? cur[i * U + j] : 0u;
        return v;
      };
      const uint32_t w0 = prefix(2 * r + 1);  // W(0); P(0) = 0
      const long long k0 = fixed_c0(w0, inv) - (long long)inv2 * w0;
      for (int a = 0; a < hs.rounds; ++a) {
        const int u = a * nt + tid, x0 = kSeg * u;
        if (x0 >= w) break;
        uint32_t wx = prefix(x0 + 2 * r + 1) - E[u];
        if (x0 + kSeg <= w) {
          // a whole segment: its 16 reads first, then the sliding sum
          uint32_t lead[kSeg], trail[kSeg], o[kSeg];
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            lead[i] = cur[u + off_lead[i]];
            trail[i] = cur[i * U + u];
          }
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            o[i] = fixed_out_u<T>(k0, inv2, wx);
            wx += lead[i] - trail[i];
          }
          if (last && vec) {
            reinterpret_cast<V*>(out + row * w)[u] = Chunk<T>::pack(o);
          } else if (last) {
#pragma unroll
            for (int i = 0; i < kSeg; ++i) out[row * w + x0 + i] = (T)o[i];
          } else {
#pragma unroll
            for (int i = 0; i < kSeg; ++i) nxt[u + off_out[i]] = o[i];
            if (r <= w && (x0 < r || x0 + kSeg > w - r)) {
              // the pad positions that mirror these outputs (the periodic
              // quirk fills its pad after a barrier)
#pragma unroll
              for (int i = 0; i < kSeg; ++i) {
                const int x = x0 + i;
                if (x < r) nxt[at(r - 1 - x)] = o[i];
                if (x >= w - r) nxt[at(2 * w + r - 1 - x)] = o[i];
              }
            }
          }
        } else {
          // the row's last, partial segment: one output at a time
          for (int x = x0; x < w; ++x) {
            const uint32_t o = fixed_out_u<T>(k0, inv2, wx);
            if (last) {
              out[row * w + x] = (T)o;
            } else {
              nxt[at(x + r)] = o;
              if (r <= w && x < r) nxt[at(r - 1 - x)] = o;
              if (r <= w && x >= w - r) nxt[at(2 * w + r - 1 - x)] = o;
            }
            wx += cur[at(x + 2 * r + 1)] - cur[at(x)];
          }
        }
      }
      if (!last) {
        __syncthreads();
        if (r > w) {
          for (int i = tid; i < 2 * r; i += nt) {
            const int q = i < r ? i : i + w;
            nxt[at(q)] = nxt[at(r + mirror_periodic(q - r, w))];
          }
          __syncthreads();
        }
      }
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

// h_fixed's register design for a row (the wrapper's h_fixed_warp_shape):
// `chunks` runs of n = 2r + 1 samples a lane; cell s of the warp (lane l,
// chunk c, slot i < n: s = (l * chunks + c) * n + i) holds sample s - a of
// the mirrored row before the first pass; lane l0's first run starts at
// sample -r.
struct HWarp {
  int w, r, chunks, l0, a, passes;
};

template <typename T>
__device__ __forceinline__ uint32_t out_bits(uint32_t x) {
  return sizeof(T) == 2 ? x >> 16 : (x >> 16) & 0xffu;
}

// One warp a row, all passes in registers.  Lane l holds `chunks`
// consecutive runs of n = 2r + 1 samples, one run a chunk of kSlots
// registers (slots n .. kSlots-1 hold 0 for good), so the window of 2r + 1
// samples starting at a cell ends in the same slot of the next run: the
// next chunk of the lane, or the next lane's first chunk (one shuffle).
// Passes alternate:
// - even passes give each cell the window that starts there (output u + r
//   at input u's cell), sliding forward through the lane's runs from the
//   first run's sum;
// - odd passes give each cell the window that ends there (output u - r),
//   sliding backward from the last run's sum, its trail one run back (the
//   previous lane's last chunk for the first).
// So cells drift by r and back, and W(0), which every output's fixed point
// takes, is the sum of lane l0's first run in even passes; in odd passes,
// where that run starts at sample 0, it is x_r + 2 (x_0 + .. + x_{r-1}) of
// it by the mirror.  The cells hold the row's mirror-periodic extension
// (the duplicate-edge mirror repeated), on which each pass gives the
// mirror-periodic extension of its output, so no pass mirrors anything:
// cells past the row carry the margins (a >= passes * r samples before,
// passes * r after), and only the cells nearest the warp's ends read across
// them and go wrong, 2r a pass at one end, all inside those margins.  A
// running sum telescopes, so it is exact wherever its window is (uint32,
// r < 32768).  The output (C0 + inv2*(W - W0)) >> 16 cast to T is
// bits 16.. of k0 + inv2*W with k0 = C0 - inv2*W0 taken mod 2^32: a 3-input
// add, a multiply-add and a shift a sample and pass.  Device memory: the
// row is copied into a per-warp buffer by 16-byte cp.async (element loads
// where rows are not on 16 bytes) while the previous row's passes run, its
// margins are mirrored there, and the output leaves through the same
// buffer by 16-byte stores.  Idle chunks (c < kChunks - chunks) are skipped
// by warp-uniform branches; the last idle one, if any, holds the previous
// lane's last chunk in odd passes.
template <typename T, int kSlots, int kChunks>
__global__ void __launch_bounds__(kRowWarps * 32, warp_run_blocks(kSlots))
    h_fixed_kernel(const T* __restrict__ in, T* __restrict__ out, long long rows, HWarp hw,
                   bool vec, long long inv, uint32_t inv2) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kLive = warp_run_live(kSlots);      // slots 0 .. kLive-1 hold samples
  constexpr int kBuf = 32 * kChunks * kSlots + 64;  // samples of a row buffer
  constexpr int E = 16 / sizeof(T);                 // samples a 16-byte copy
  extern __shared__ uint4 rowbufs[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* const bufs = reinterpret_cast<T*>(rowbufs) + 2 * kBuf * warp;
  const int w = hw.w, r = hw.r, n = 2 * r + 1, c0 = kChunks - hw.chunks, pr = hw.passes * r;
  // a row buffer holds sample 0 at padl, on 16 bytes, and this lane's first
  // cell at base
  const int padl = (hw.a + 15) & ~15, base = lane * hw.chunks * n - hw.a + padl;
  const long long stride = (long long)gridDim.x * kRowWarps;
  auto issue = [&](long long row, T* b) {
    if (row < rows) {
      const T* src = in + row * w;
      for (int k = lane; k < w / E; k += 32) cp_async16(b + padl + k * E, src + k * E);
    }
    cp_async_commit();
  };
  uint32_t a[kChunks][kSlots];
  long long row = (long long)blockIdx.x * kRowWarps + warp;
  if (vec) issue(row, bufs);
  for (int cur = 0; row < rows; row += stride, cur ^= 1) {
    T* const b = bufs + cur * kBuf;
    if (vec) {
      cp_async_wait<0>();
    } else {
      for (int q = lane; q < w; q += 32) b[padl + q] = in[row * w + q];
    }
    __syncwarp();
    for (int j = lane; j < 2 * pr; j += 32) {
      const int u = j < pr ? -1 - j : w + j - pr;
      int m = u < 0 ? -1 - u : 2 * w - 1 - u;  // one reflection, unless pr > w
      if ((unsigned)m >= (unsigned)w) m = mirror_periodic(u, w);
      b[padl + u] = b[padl + m];
    }
    __syncwarp();
    if (vec) issue(row + stride, bufs + (cur ^ 1) * kBuf);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= c0) {
        const T* q = b + base + (c - c0) * n;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) a[c][i] = i < kLive || i < n ? (uint32_t)q[i] : 0u;
      }
    }
    for (int p = 0; p < hw.passes; ++p) {
      uint32_t wx = 0, t = 0, ends[kSlots];
      if ((p & 1) == 0) {
        // the first run's sum starts the slide; the last chunk's leads are
        // the next lane's first run
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (c == c0) {
#pragma unroll
            for (int i = 0; i < kSlots; ++i) {
              wx += a[c][i];
              ends[i] = __shfl_down_sync(kAll, a[c][i], 1);
            }
          }
        }
        const uint32_t w0 = __shfl_sync(kAll, wx, hw.l0);
        const uint32_t k0 = (uint32_t)(fixed_c0(w0, inv) - (long long)inv2 * w0);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (c >= c0) {
#pragma unroll
            for (int i = 0; i < kSlots; ++i) {
              const uint32_t lead = c + 1 < kChunks ? a[c + 1 < kChunks ? c + 1 : c][i] : ends[i];
              const uint32_t o = out_bits<T>(k0 + inv2 * wx);
              wx += lead - a[c][i];
              if (i < kLive || i < n) a[c][i] = o;
            }
          }
        }
      } else {
        // W(0) from lane l0's first run (samples 0 .. 2r): r < kSlots / 2
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (c == c0) {
#pragma unroll
            for (int i = 0; i < kSlots / 2; ++i) {
              if (i < r) t += a[c][i];
              if (i <= r) t += a[c][i];
            }
          }
        }
        const uint32_t w0 = __shfl_sync(kAll, t, hw.l0);
        const uint32_t k0 = (uint32_t)(fixed_c0(w0, inv) - (long long)inv2 * w0);
        // the last run's sum starts the slide; the first chunk's trails are
        // the previous lane's last run, in `ends` or the idle chunk before
#pragma unroll
        for (int i = 0; i < kSlots; ++i) wx += a[kChunks - 1][i];
        if (c0 == 0) {
#pragma unroll
          for (int i = 0; i < kSlots; ++i) ends[i] = __shfl_up_sync(kAll, a[kChunks - 1][i], 1);
        } else {
#pragma unroll
          for (int c = 0; c + 1 < kChunks; ++c) {
            if (c + 1 == c0) {
#pragma unroll
              for (int i = 0; i < kSlots; ++i) {
                a[c][i] = __shfl_up_sync(kAll, a[kChunks - 1][i], 1);
              }
            }
          }
        }
#pragma unroll
        for (int c = kChunks - 1; c >= 0; --c) {
          if (c >= c0) {
#pragma unroll
            for (int i = kSlots - 1; i >= 0; --i) {
              const uint32_t trail = c == 0 ? ends[i] : a[c > 0 ? c - 1 : 0][i];
              const uint32_t o = out_bits<T>(k0 + inv2 * wx);
              wx += trail - a[c][i];
              if (i < kLive || i < n) a[c][i] = o;
            }
          }
        }
      }
    }
    // an odd pass count leaves sample u at the cell of u - r
    const int shift = (hw.passes & 1) ? r : 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= c0) {
        T* q = b + base + (c - c0) * n + shift;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (i < kLive || i < n) q[i] = (T)a[c][i];
        }
      }
    }
    __syncwarp();
    if (vec) {
      uint4* dst = reinterpret_cast<uint4*>(out + row * w);
      const uint4* src = reinterpret_cast<const uint4*>(b + padl);
      for (int k = lane; k < w / E; k += 32) dst[k] = src[k];
    } else {
      for (int q = lane; q < w; q += 32) out[row * w + q] = b[padl + q];
    }
  }
}

// B1's vertical stage on chip: the comptime vertical sums of one 128-byte strip of
// one frame in one warp, lane l on word l of each row, one warp per block:
// v_chip_kernel's one-pass case with the hybrid mirror and the quantised
// output.  Input row s enters at step s, by the
// same 16-byte cp.async copy groups (element loads where rows are not
// 16-byte aligned) into a ring of the last 2r+1+kChipAheadRows rows.  With
// 2r < h the hybrid mirror reads row -k above the top and, for tap offset o
// past the bottom, row h-1-o, so every output row slides from the one
// before (x[k]: input row k, W(y): the sum of row y's 2r+1 taps):
//   W(0)   = x[0] + 2 (x[1] + ... + x[r])
//   W(y+1) = W(y) + x[y+1+r] - x[r-y]   (y < r)
//          = W(y) + x[y+1+r] - x[y-r]   (interior)
//          = W(y) + x[y]     - x[y-r]   (y+1+r > h-1)
// Output row y leaves at step y+r+1; the rows it reads are all in the ring.  The
// output (2W + k) / (2k), k = 2r+1, is (N * m) >> sh with the wrapper's
// per-call multiplier: exact for every N = 2W + k up to k * 131071
// (kernels/boxblur.py quantizer), one 32x32->64 multiply and a shift.  W
// stays below 2^32 (k * 65535, r <= 897).
template <typename T, bool kVec>
__global__ void __launch_bounds__(32)
    ct_v_chip_kernel(const T* __restrict__ in, T* __restrict__ out, int h, int w, int r,
                     int strips, uint32_t m, int sh) {
  using Wd = Word<T>;
  constexpr int K = Wd::K;  // samples per word
  extern __shared__ uint32_t ring[];
  const int lane = threadIdx.x;
  const int R = 2 * r + 1, R0 = R + kChipAheadRows;
  const int f = blockIdx.x / strips, strip = blockIdx.x - f * strips;
  StripWalk<T, kVec> st(in, out, ring, (size_t)f * h * w, strip, h, w, R0, lane);
  auto quant = [&](uint32_t wx) {
    return (uint32_t)(((unsigned long long)(2u * wx + (uint32_t)R) * m) >> sh);
  };

  uint32_t wx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wx[k] = 0;
  int c0 = 0, t0 = R0 - R;  // s mod R0, (s - R) mod R0
  auto advance = [&]() {
    c0 = c0 + 1 == R0 ? 0 : c0 + 1;
    t0 = t0 + 1 == R0 ? 0 : t0 + 1;
  };
  // output row s-r-1 from the ring's rows s and s-2r-1
  auto steady = [&]() {
    const uint32_t lead = ring[c0 * 32 + lane], trail = ring[t0 * 32 + lane];
    uint32_t o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      o[k] = quant(wx[k]);
      wx[k] += Wd::at(lead, k) - Wd::at(trail, k);
    }
    st.store(Wd::join(o));
  };
  // a step that sums W(0), or mirrors at the top or the bottom
  auto edge = [&](int s) {
    const uint32_t row = ring[c0 * 32 + lane];  // row s, while s < h
    if (s <= r) {
      const uint32_t times = s > 0 ? 2u : 1u;
#pragma unroll
      for (int k = 0; k < K; ++k) wx[k] += times * Wd::at(row, k);
      return;
    }
    const int y = s - r - 1;
    const uint32_t lead = s < h ? row : ring[wrap(c0 - r - 1, R0) * 32 + lane];
    const uint32_t trail = y >= r ? ring[t0 * 32 + lane] : ring[(R - s) * 32 + lane];
    uint32_t o[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      o[k] = quant(wx[k]);
      wx[k] += Wd::at(lead, k) - Wd::at(trail, k);
    }
    st.store(Wd::join(o));
  };

  for (int g = 0; g < kAheadGroups; ++g) st.issue(g);
  const int S = h + r + 1;  // steps: the last gives row h-1
  for (int j0 = 0; j0 < S; j0 += kGroupRows) {
    if (j0 < h) {
      __syncwarp();  // every lane is done with the rows the copies overwrite
      st.issue(j0 / kGroupRows + kAheadGroups);
      if (kVec) cp_async_wait<kAheadGroups>();
      __syncwarp();  // rows j0 .. j0+3 are in the ring, for every lane
    }
    // from step R to h-1 no step sums W(0) or mirrors
    if (j0 >= R && j0 + kGroupRows <= h) {
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
        steady();
        advance();
      }
    } else {
#pragma unroll 1
      for (int j = j0; j < j0 + kGroupRows && j < S; ++j) {
        if (j >= R && j < h) {
          steady();
        } else {
          edge(j);
        }
        advance();
      }
    }
  }
}

// B1's shape in one launch (the wrapper's ct_blur_fused_shape and
// ct_blur_bands): frames of h x w samples, `bands` bands of rows a frame,
// rows of `cols` 16-byte chunks, an input ring of `ring` rows, row buffers of
// `rowbuf` cells, and `chunks` runs a lane in the register pass.
struct CtFused {
  int h, w, r, bands, cols, ring, rowbuf, chunks;
};

// The mbarriers of ct_blur's copy groups (kernels/boxblur.py CT_COPY_BARS),
// and its bulk copies of rows (the Tensor Memory Accelerator's plain
// copies, completed on an mbarrier).
constexpr int kCopyBars = 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// the calling thread's arrival, expecting `bytes` of copies on the phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// named barrier `id` of `threads` threads: wait for them, or arrive only
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// B1 in one launch: ct_v_chip's quantised vertical sums and one pass of
// h_fixed's register design, the intermediate plane never in device memory.
// Block b of a frame takes its band of output rows y0 .. y1-1 (b * h / bands
// onwards) at full width, in groups of kFusedWarps rows.  Its warps split
// into two pipelined halves that meet at two sets of row buffers, so the
// vertical sums of one group run beside the horizontal pass of the one
// before (each phase alone is bound by its latencies, not by the SM):
// - Copies: the band's input rows y0-r .. y1-1+r (clamped to the plane)
//   enter a ring of `ring` rows in copy groups (the rows that sum W(y0),
//   then kFusedWarps rows a group), as one or two bulk copies a group (two
//   where it wraps round the ring) completed on the group's mbarrier (where
//   rows are not on 16 bytes, each vertical thread loads its own chunks by
//   elements instead).  The ring holds 2r + 1 rows and kFusedAhead + 1
//   groups: a group's copies go out as soon as the vertical half is done
//   with the trail rows they overwrite, and land kFusedAhead + 1 groups
//   later.
// - Vertical half (the last kFusedWarps / 2 warps): thread t owns the
//   16-byte chunks t and t + 32 * kFusedWarps / 2 of every row and slides
//   their column sums down the band as ct_v_chip does (the hybrid mirror's
//   slide; W(y0) summed from rows y0-r .. y0+r, or under the mirror from
//   rows 0 .. r in the top band).  It writes a group's quantised rows two by
//   two into a set of row buffers, a row buffer holding a pair of rows
//   interleaved: cell x is (sample x of the first row, sample x of the
//   second), a 32-bit word for uint16.
// - Horizontal half (the first kFusedWarps / 2 warps): warp p takes row
//   buffer p of the set, its pair of rows, through h_fixed_kernel's register
//   pass for one pass (passes = 1: l0 = 0, a = r), a cell a register, the
//   two rows' sums slid side by side, and writes both rows out by 16-byte
//   stores.  A cell is one load and one store, and lanes chunks * n cells
//   apart meet no bank conflict in 32-bit cells, where they do in 16-bit
//   samples.  Runs that start past the row's right margin hold nothing the
//   row needs: they are neither loaded nor stored, so a row buffer holds
//   the row and its margins, not every lane's runs.
// The halves hand the sets over by named barriers: the vertical half
// arrives at a set's full barrier, the horizontal half at its empty one.
// The horizontal pass loops over a lane's runs rather than unrolling them
// all: a lane holds the run it slides and the next (its leads, loaded
// before the slide's stores reach it), so its straight-line code stays in
// the instruction cache (fully unrolled, the pass ran at about a third of an
// instruction a cycle), and the kernel takes any count of runs a lane.
// Device memory: the plane read once (a band that does not start at row 0
// also reads the r rows above it, one that does not end at the bottom the r
// below) and written once.
template <typename T, int kSlots>
__global__ void __launch_bounds__(kFusedWarps * 32, 1)
    ct_blur_kernel(const T* __restrict__ in, T* __restrict__ out, CtFused cf, bool vec,
                   long long inv, uint32_t inv2, uint32_t m) {
  using Wd = Word<T>;
  // a cell: the pair of samples of the rows of a row buffer
  using Cell = typename std::conditional<sizeof(T) == 2, uint32_t, uint16_t>::type;
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int K = Wd::K, E = 16 / sizeof(T);  // samples a word, a chunk
  constexpr int B = 8 * sizeof(T), G = kFusedWarps, P = G / 2;  // rows, pairs a group
  constexpr int kHalf = P * 32;                 // threads a half
  constexpr uint32_t kMask = (1u << B) - 1;
  // both rows' outputs (bits 16.. of each sum) as a cell
  constexpr uint32_t kPair = sizeof(T) == 2 ? 0x7632 : 0x0062;
  constexpr int kLive = warp_run_live(kSlots);  // slots 0 .. kLive-1 hold samples
  // named barriers: a set's full (1, 2) and empty (3, 4) ones, the vertical half's (5)
  constexpr int kFull = 1, kEmpty = 3, kVertical = 5;
  extern __shared__ uint4 fused[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = cf.h, w = cf.w, r = cf.r, n = 2 * r + 1, cols = cf.cols, R = cf.ring;
  uint4* const ring = fused;  // R rows of cols chunks
  Cell* const bufs = reinterpret_cast<Cell*>(fused + (size_t)R * cols);  // 2 sets of P
  uint64_t* const bars = reinterpret_cast<uint64_t*>(bufs + (size_t)2 * P * cf.rowbuf);
  const int f = blockIdx.x / cf.bands, band = blockIdx.x - f * cf.bands;
  const int y0 = (int)((long long)band * h / cf.bands);
  const int y1 = (int)((long long)(band + 1) * h / cf.bands);
  const int groups = (y1 - y0 + G - 1) / G;
  const int padl = (r + 15) & ~15;          // a row buffer's sample 0, on 16 cells
  T* const dst = out + (size_t)f * h * w;

  if (vec && tid == kHalf) {
    for (int i = 0; i < kCopyBars; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= P) {
    // ---- the vertical half ----
    const int vt = tid - kHalf;
    const bool top = y0 == 0;
    const int s0 = top ? 0 : y0 - r;          // the band's first input row (ring slot 0)
    const int s1 = min(y1 - 1 + r, h - 1);    // and its last
    const int wu = y0 + r + 1 - s0;           // rows that sum W(y0)
    const T* const src = in + (size_t)f * h * w;
    auto sample = [](const uint4& v, int e) {
      return Wd::at(reinterpret_cast<const uint32_t*>(&v)[e / K], e % K);
    };
    // the next copy group, the next input row to copy and its ring slot
    int cgroup = 0, crow = s0, cslot = 0;
    auto copy = [&](int rows) {
      const int valid = max(0, min(rows, s1 + 1 - crow));
      if (vec) {
        if (vt == 0) {
          uint64_t* const bar = bars + cgroup % kCopyBars;
          const unsigned bytes = (unsigned)cols * 16;
          const int first = min(valid, R - cslot);  // rows before the ring wraps
          mbar_expect(bar, (unsigned)valid * bytes);
          const T* const s = src + (size_t)crow * w;
          if (first > 0) bulk_copy(ring + (size_t)cslot * cols, s, first * bytes, bar);
          if (valid > first) {
            bulk_copy(ring, s + (size_t)first * w, (valid - first) * bytes, bar);
          }
        }
      } else {
        for (int c = vt; c < cols; c += kHalf) {
#pragma unroll 1
          for (int i = 0, slot = cslot; i < valid; ++i, slot = slot + 1 == R ? 0 : slot + 1) {
            const T* s = src + (size_t)(crow + i) * w + c * E;
            uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
            for (int e = 0; e < E; ++e) {
              if (c * E + e < w) v[e / K] |= (uint32_t)s[e] << (B * (e % K));
            }
            ring[(size_t)slot * cols + c] = make_uint4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      ++cgroup;
      crow += rows;
      cslot = (cslot + rows) % R;
    };
    // copy group k is in the ring
    auto landed = [&](int k) {
      if (vec) mbar_wait(bars + k % kCopyBars, (unsigned)(k / kCopyBars) & 1u);
    };

    // chunk j of this thread: vt + j * kHalf; its column sums wx[j]
    uint32_t wx[2][E];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) wx[j][e] = 0;
    }
    copy(wu);
    for (int g = 0; g <= kFusedAhead; ++g) copy(G);
    landed(0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = vt + j * kHalf;
      if (c < cols) {
#pragma unroll 1
        for (int s = 0; s < wu; ++s) {
          const uint4 v = ring[(size_t)s * cols + c];
          const uint32_t times = top && s > 0 ? 2u : 1u;
#pragma unroll
          for (int e = 0; e < E; ++e) wx[j][e] += times * sample(v, e);
        }
      }
    }
    // ring slots of the lead (y+r+1) and trail (y-r) rows of output row y
    int ls = wu, ts = top ? R - r : 0;
    // output row y of chunk j into its quantised samples o, then W(y+1) from
    // its lead and trail rows
    auto vrow = [&](uint32_t* o, uint32_t* sums, const uint4& lead, const uint4& trail) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        o[e] = __umulhi(2u * sums[e] + (uint32_t)n, m);
        sums[e] += sample(lead, e) - sample(trail, e);
      }
    };
    // rows 2i, 2i+1 of chunk c into row buffer i of set `set`
    auto vpair = [&](int set, int i, int c, const uint32_t* oa, const uint32_t* ob) {
      uint32_t v[8];  // E cells (32 bytes) as words
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = sizeof(T) == 2 ? oa[k] | ob[k] << 16
                              : oa[2 * k] | ob[2 * k] << 8 | oa[2 * k + 1] << 16 |
                                    ob[2 * k + 1] << 24;
      }
      uint4* const d =
          reinterpret_cast<uint4*>(bufs + (size_t)(set * P + i) * cf.rowbuf + padl + c * E);
      d[0] = make_uint4(v[0], v[1], v[2], v[3]);
      d[1] = make_uint4(v[4], v[5], v[6], v[7]);
    };

    for (int Y = y0, g = 0; Y < y1; Y += G, ++g) {
      const int set = g & 1;
      landed(g + 1);  // rows up to Y + G + r are in the ring
      if (g >= 2) named_sync(kEmpty + set, 2 * kHalf);  // group g-2 is out of the set
      if (Y >= r && Y + G + r <= h - 1) {
        // no row of the group mirrors: a chunk's leads and trails first
#pragma unroll 1
        for (int j = 0; j < 2; ++j) {
          const int c = vt + j * kHalf;
          if (c >= cols) break;
          uint4 lead[G], trail[G];
#pragma unroll
          for (int i = 0; i < G; ++i) {
            const int l = ls + i < R ? ls + i : ls + i - R, t = ts + i < R ? ts + i : ts + i - R;
            lead[i] = ring[(size_t)l * cols + c];
            trail[i] = ring[(size_t)t * cols + c];
          }
#pragma unroll
          for (int i = 0; i < G; i += 2) {
            uint32_t oa[E], ob[E];
            vrow(oa, wx[j], lead[i], trail[i]);
            vrow(ob, wx[j], lead[i + 1], trail[i + 1]);
            vpair(set, i / 2, c, oa, ob);
          }
        }
        ls = ls + G < R ? ls + G : ls + G - R;
        ts = ts + G < R ? ts + G : ts + G - R;
      } else {
        // rows past y1 take garbage, which no row before them reads
#pragma unroll 1
        for (int i = 0; i < G; i += 2) {
          int l[2], t[2];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int y = Y + i + k;
            // past the bottom the lead is row y; above the top the trail is row r-y
            l[k] = y + r + 1 <= h - 1 ? ls : wrap(y - s0, R);
            t[k] = y >= r ? ts : wrap(r - y - s0, R);
            ls = ls + 1 == R ? 0 : ls + 1;
            ts = ts + 1 == R ? 0 : ts + 1;
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = vt + j * kHalf;
            if (c < cols) {
              uint32_t o[2][E];
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                vrow(o[k], wx[j], ring[(size_t)l[k] * cols + c], ring[(size_t)t[k] * cols + c]);
              }
              vpair(set, i / 2, c, o[0], o[1]);
            }
          }
        }
      }
      named_arrive(kFull + set, 2 * kHalf);  // the group is in the set
      named_sync(kVertical, kHalf);          // and done with its trail rows
      copy(G);                               // into their slots
    }
    return;
  }

  // ---- the horizontal half ----
  // cells at buffer positions from `live` on start no run the row needs
  const int live = padl + w + r;
  for (int Y = y0, g = 0; Y < y1; Y += G, ++g) {
    const int set = g & 1;
    named_sync(kFull + set, 2 * kHalf);  // the group is in the set
    const int ya = Y + 2 * warp;         // the pair's rows ya, ya + 1
    if (ya < y1) {
      Cell* const b = bufs + (size_t)(set * P + warp) * cf.rowbuf;
      // the margins: the duplicate-edge mirror (r <= w)
      for (int j = lane; j < 2 * r; j += 32) {
        const int u = j < r ? -1 - j : w + j - r;
        b[padl + u] = b[padl + (u < 0 ? -1 - u : 2 * w - 1 - u)];
      }
      __syncwarp();
      // the lane's runs from buffer position p: the one it slides (its two
      // rows' samples ca, cb; runs of more than 32 slots as cells, ca, for
      // registers) and the next (its leads, nx); the last run's leads are
      // the next lane's first run (ends)
      constexpr bool kApart = kSlots <= 32;
      int p = lane * cf.chunks * n - r + padl;
      uint32_t ca[kSlots], cb[kApart ? kSlots : 1], nx[kSlots], ends[kSlots];
      // h_fixed's even pass for both rows: the first run's sums start the
      // slides, lane 0's are W(0)
      uint32_t wa = 0, wb = 0;
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const uint32_t v = p < live && (i < kLive || i < n) ? (uint32_t)b[p + i] : 0u;
        ca[i] = kApart ? v & kMask : v;
        if (kApart) cb[kApart ? i : 0] = v >> B;
        wa += v & kMask;
        wb += v >> B;
        ends[i] = __shfl_down_sync(kAll, v, 1);
      }
      const uint32_t w0a = __shfl_sync(kAll, wa, 0), w0b = __shfl_sync(kAll, wb, 0);
      const uint32_t k0a = (uint32_t)(fixed_c0(w0a, inv) - (long long)inv2 * w0a);
      const uint32_t k0b = (uint32_t)(fixed_c0(w0b, inv) - (long long)inv2 * w0b);
#pragma unroll 1
      for (int c = 0; c < cf.chunks && p < live; ++c, p += n) {
        if (c + 1 < cf.chunks) {
          const bool next = p + n < live;
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            nx[i] = next && (i < kLive || i < n) ? (uint32_t)b[p + n + i] : 0u;
          }
        } else {
#pragma unroll
          for (int i = 0; i < kSlots; ++i) nx[i] = ends[i];
        }
        // one pass leaves output x at the cell of input x - r
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const uint32_t la = nx[i] & kMask, lb = nx[i] >> B;
          const uint32_t ta = kApart ? ca[i] : ca[i] & kMask;
          const uint32_t tb = kApart ? cb[kApart ? i : 0] : ca[i] >> B;
          const uint32_t o = __byte_perm(k0a + inv2 * wa, k0b + inv2 * wb, kPair);
          wa += la - ta;
          wb += lb - tb;
          if (i < kLive || i < n) b[p + r + i] = (Cell)o;
          ca[i] = kApart ? la : nx[i];
          if (kApart) cb[kApart ? i : 0] = lb;
        }
      }
      __syncwarp();
      // both rows out: E cells (32 bytes) a step, split into the rows, all
      // of a lane's loads first
      const bool both = ya + 1 < y1;
      T* const ra = dst + (size_t)ya * w;
      T* const rb = ra + w;
      if (vec) {
        constexpr int kSteps = G;  // at most 32 * G chunks a row
        const uint4* s = reinterpret_cast<const uint4*>(b + padl);
        uint4 q[kSteps][2];
#pragma unroll
        for (int it = 0; it < kSteps; ++it) {
          const int k = lane + 32 * it;
          if (k < w / E) {
            q[it][0] = s[2 * k];
            q[it][1] = s[2 * k + 1];
          }
        }
#pragma unroll
        for (int it = 0; it < kSteps; ++it) {
          const int k = lane + 32 * it;
          if (k < w / E) {
            const uint32_t c[8] = {q[it][0].x, q[it][0].y, q[it][0].z, q[it][0].w,
                                   q[it][1].x, q[it][1].y, q[it][1].z, q[it][1].w};
            uint32_t va[4], vb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              va[i] = __byte_perm(c[2 * i], c[2 * i + 1], sizeof(T) == 2 ? 0x5410 : 0x6420);
              vb[i] = __byte_perm(c[2 * i], c[2 * i + 1], sizeof(T) == 2 ? 0x7632 : 0x7531);
            }
            reinterpret_cast<uint4*>(ra)[k] = make_uint4(va[0], va[1], va[2], va[3]);
            if (both) reinterpret_cast<uint4*>(rb)[k] = make_uint4(vb[0], vb[1], vb[2], vb[3]);
          }
        }
      } else {
        for (int k = lane; k < w; k += 32) {
          const uint32_t c = b[padl + k];
          ra[k] = (T)(c & kMask);
          if (both) rb[k] = (T)(c >> B);
        }
      }
    }
    if (g + 2 < groups) named_arrive(kEmpty + set, 2 * kHalf);  // the set is free
  }
}

void fixed_constants(int r, long long* inv, long long* inv2) {
  *inv = ((1LL << 32) + r) / (2 * r + 1);
  *inv2 = *inv >> 16;
}

dim3 column_grid(int n, int w) {
  return dim3((w + kColThreads - 1) / kColThreads, n < kMaxGridY ? n : kMaxGridY);
}

template <typename T>
int launch_v_fixed(const void* in, void* out, void* scratch, int n, int h, int w,
                   int r, int passes, cudaStream_t s) {
  long long inv, inv2;
  fixed_constants(r, &inv, &inv2);
  v_fixed_kernel<T><<<column_grid(n, w), kColThreads, 0, s>>>(
      (const T*)in, (T*)out, (T*)scratch, n, h, w, r, passes, inv, inv2);
  return (int)cudaGetLastError();
}

size_t v_chip_bytes(int r, int passes) {
  return ((size_t)passes * (2 * r + 1) + kChipAheadRows) * kStripBytes;
}

// Words of global scratch h_fixed needs for these rows: 0 when a block's
// buffers fit its shared memory, else one slice per block of a grid of at
// most kScratchBlocks.
long long h_fixed_scratch_words(long long rows, int w, int r) {
  const size_t words = h_shape(w, r).block_words();
  if (words * sizeof(uint32_t) <= kMaxSmemBytes) return 0;
  return (rows < kScratchBlocks ? rows : kScratchBlocks) * (long long)words;
}

// Whether the register design's shape holds rows of hw.w samples at hw.r and
// hw.passes, so that no lane writes past its row buffer: `slots` the first
// run of kWarpRuns whose slots take n = 2r + 1 (the run's slots below
// warp_run_live always hold a sample), at most its chunks a lane, lane l0's
// first run starting at sample -r (a = l0 * chunks * n + r), a >= passes * r
// samples before the row and passes * r after it in the warp's cells.
bool h_warp_holds(int slots, const HWarp& hw) {
  if (hw.r < 1 || hw.r > hw.w || hw.passes < 1 || hw.chunks < 1 || hw.l0 < 0) return false;
  const long long n = 2LL * hw.r + 1, c = hw.chunks, pr = (long long)hw.passes * hw.r;
  for (const auto& run : kWarpRuns) {
    if (n > run[0]) continue;
    return run[0] == slots && c <= run[1] && hw.a == hw.l0 * c * n + hw.r && hw.a >= pr &&
           (long long)hw.a + hw.w + pr <= 32 * c * n;
  }
  return false;
}

// kRowWarps rows in flight a block, a persistent grid of resident blocks.
template <typename T, int kSlots, int kChunks>
int launch_h_warp(const void* in, void* out, long long rows, const HWarp& hw, long long inv,
                  uint32_t inv2, cudaStream_t s) {
  void (*const kernel)(const T*, T*, long long, HWarp, bool, long long, uint32_t) =
      h_fixed_kernel<T, kSlots, kChunks>;
  const size_t bytes = (size_t)kRowWarps * 2 * (32 * kChunks * kSlots + 64) * sizeof(T);
  long long blocks;
  const cudaError_t e =
      resident_blocks(reinterpret_cast<const void*>(kernel), kRowWarps * 32, bytes, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (blocks * kRowWarps > rows) blocks = (rows + kRowWarps - 1) / kRowWarps;
  if (blocks == 0) return 0;
  // 16-byte copies where every row starts on 16 bytes, element loads else
  const bool vec = (size_t)hw.w * sizeof(T) % 16 == 0 && (uintptr_t)in % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  kernel<<<(unsigned)blocks, kRowWarps * 32, bytes, s>>>((const T*)in, (T*)out, rows, hw, vec,
                                                          inv, (uint32_t)inv2);
  return (int)cudaGetLastError();
}

// The register design with the run of kWarpRuns whose slots are `slots`.
template <typename T>
int launch_h_fixed_warp(const void* in, void* out, long long rows, int slots, const HWarp& hw,
                        cudaStream_t s) {
  if (!h_warp_holds(slots, hw)) return (int)cudaErrorInvalidValue;
  long long inv, inv2;
  fixed_constants(hw.r, &inv, &inv2);
  static_assert(sizeof(kWarpRuns) / sizeof(kWarpRuns[0]) == 7, "one case a run");
#define VZ_RUN(k)                                                                 \
  case kWarpRuns[k][0]:                                                           \
    return launch_h_warp<T, kWarpRuns[k][0], kWarpRuns[k][1]>(in, out, rows, hw, inv, \
                                                              (uint32_t)inv2, s);
  switch (slots) {
    VZ_RUN(0) VZ_RUN(1) VZ_RUN(2) VZ_RUN(3) VZ_RUN(4) VZ_RUN(5) VZ_RUN(6)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VZ_RUN
}

// The block design.
template <typename T>
int launch_h_fixed(const void* in, void* out, void* scratch, long long rows, int w, int r,
                   int passes, cudaStream_t s) {
  long long inv, inv2;
  fixed_constants(r, &inv, &inv2);
  const HShape hs = h_shape(w, r);
  // vector loads and stores: 8 samples per chunk, rows on 16-byte (uint8:
  // 8-byte) boundaries
  const size_t align = 8 * sizeof(T);
  const bool vec = w % kSeg == 0 && (uintptr_t)in % align == 0 && (uintptr_t)out % align == 0;
  if (h_fixed_scratch_words(rows, w, r) > 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const long long blocks = rows < kScratchBlocks ? rows : kScratchBlocks;
    h_fixed_kernel<T, true><<<(unsigned)blocks, hs.threads, 0, s>>>(
        (const T*)in, (T*)out, rows, w, r, passes, hs, vec, inv, (int)inv2,
        (uint32_t*)scratch);
    return (int)cudaGetLastError();
  }
  // persistent: as many blocks as stay resident, each striding over rows
  const size_t bytes = hs.block_words() * sizeof(uint32_t);
  void (*const kernel)(const T*, T*, long long, int, int, int, HShape, bool, long long, int,
                       uint32_t*) = h_fixed_kernel<T, false>;
  long long blocks;
  const cudaError_t e =
      resident_blocks(reinterpret_cast<const void*>(kernel), hs.threads, bytes, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (blocks > rows) blocks = rows;
  kernel<<<(unsigned)blocks, hs.threads, bytes, s>>>((const T*)in, (T*)out, rows, w, r, passes,
                                                     hs, vec, inv, (int)inv2, nullptr);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_v_chip_p(const void* in, void* out, int n, int h, int w, int r, cudaStream_t s) {
  long long inv, inv2;
  fixed_constants(r, &inv, &inv2);
  const int cols = kStripBytes / sizeof(T);
  const long long strips = (w + cols - 1) / cols, blocks = n * strips;
  const size_t bytes = v_chip_bytes(r, P);
  if (bytes > kMaxSmemBytes || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  // 16-byte copies where every row starts on 16 bytes, element loads else
  const bool vec = (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (size_t)w * sizeof(T) % 16 == 0;
  const void* kernel = vec ? reinterpret_cast<const void*>(v_chip_kernel<T, P, true>)
                           : reinterpret_cast<const void*>(v_chip_kernel<T, P, false>);
  long long resident;  // sets the kernel's dynamic shared memory allowance
  const cudaError_t e = resident_blocks(kernel, 32, bytes, &resident);
  if (e != cudaSuccess) return (int)e;
  if (vec) {
    v_chip_kernel<T, P, true><<<(unsigned)blocks, 32, bytes, s>>>(
        (const T*)in, (T*)out, h, w, r, (int)strips, inv, (uint32_t)inv2);
  } else {
    v_chip_kernel<T, P, false><<<(unsigned)blocks, 32, bytes, s>>>(
        (const T*)in, (T*)out, h, w, r, (int)strips, inv, (uint32_t)inv2);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_v_chip(const void* in, void* out, int n, int h, int w, int r, int passes,
                  cudaStream_t s) {
  static_assert(kChipPasses == 6, "one case per pass count");
  switch (passes) {
    case 1: return launch_v_chip_p<T, 1>(in, out, n, h, w, r, s);
    case 2: return launch_v_chip_p<T, 2>(in, out, n, h, w, r, s);
    case 3: return launch_v_chip_p<T, 3>(in, out, n, h, w, r, s);
    case 4: return launch_v_chip_p<T, 4>(in, out, n, h, w, r, s);
    case 5: return launch_v_chip_p<T, 5>(in, out, n, h, w, r, s);
    case 6: return launch_v_chip_p<T, 6>(in, out, n, h, w, r, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the ring, two sets of kFusedWarps / 2 row buffers of cells of two
// samples, the copy groups' mbarriers
size_t ct_fused_bytes(const CtFused& cf, size_t elem) {
  return (size_t)cf.ring * cf.cols * 16 + (size_t)2 * kFusedWarps * cf.rowbuf * elem +
         kCopyBars * sizeof(uint64_t);
}

// Whether B1's one launch takes the planes on shape cf with the register
// run `slots`: 2r < h; bands of at least r + 1 rows (so a band that does
// not start at row 0 starts below row r and ends its warm-up above the
// bottom); two chunks a vertical thread; a ring of 2r + 1 rows and the
// groups in flight; row buffers on 16 cells that hold the chunks and what
// the runs that start before the right margin's end load and store; the
// shared memory of a block; and the register pass's shape for one pass
// (h_warp_holds: l0 = 0, a = r).
bool ct_fused_holds(int slots, const CtFused& cf, size_t elem) {
  const int r = cf.r, n = 2 * r + 1, padl = (r + 15) & ~15, e = 16 / (int)elem;
  if (r < 1 || cf.h <= 2 * r || cf.bands < 1 || cf.h / cf.bands < r + 1) return false;
  if (cf.w < 1 || cf.cols != ((long long)cf.w * (long long)elem + 15) / 16 ||
      cf.cols > kFusedWarps * 32) {
    return false;
  }
  if (cf.ring < n + kFusedWarps * (kFusedAhead + 1) || cf.rowbuf % 16 != 0 ||
      cf.rowbuf < padl + cf.w + 2 * r + n || cf.rowbuf < padl + (long long)e * cf.cols) {
    return false;
  }
  if (ct_fused_bytes(cf, elem) > kMaxSmemBytes) return false;
  return h_warp_holds(slots, HWarp{cf.w, r, cf.chunks, 0, r, 1});
}

template <typename T>
using CtBlurKernel = void (*)(const T*, T*, CtFused, bool, long long, uint32_t, uint32_t);

// ct_blur_kernel with the run of kWarpRuns whose slots are `slots`, or null.
template <typename T>
CtBlurKernel<T> ct_blur_of(int slots) {
  static_assert(sizeof(kWarpRuns) / sizeof(kWarpRuns[0]) == 7, "one case a run");
#define VZ_RUN(k) \
  case kWarpRuns[k][0]: return ct_blur_kernel<T, kWarpRuns[k][0]>;
  switch (slots) {
    VZ_RUN(0) VZ_RUN(1) VZ_RUN(2) VZ_RUN(3) VZ_RUN(4) VZ_RUN(5) VZ_RUN(6)
    default: return nullptr;
  }
#undef VZ_RUN
}

// One block a band of a frame: n * bands blocks.
template <typename T>
int launch_ct_blur(const void* in, void* out, int n, const CtFused& cf, int slots, uint32_t m,
                   cudaStream_t s) {
  const CtBlurKernel<T> kernel = ct_blur_of<T>(slots);
  const long long blocks = (long long)n * cf.bands;
  if (kernel == nullptr || !ct_fused_holds(slots, cf, sizeof(T)) || n < 0 ||
      blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks == 0) return 0;
  const size_t bytes = ct_fused_bytes(cf, sizeof(T));
  long long resident;  // sets the kernel's dynamic shared memory allowance
  const cudaError_t e =
      resident_blocks(reinterpret_cast<const void*>(kernel), kFusedWarps * 32, bytes, &resident);
  if (e != cudaSuccess) return (int)e;
  long long inv, inv2;
  fixed_constants(cf.r, &inv, &inv2);
  // 16-byte copies where every row starts on 16 bytes, element loads else
  const bool vec = (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (size_t)cf.w * sizeof(T) % 16 == 0;
  kernel<<<(unsigned)blocks, kFusedWarps * 32, bytes, s>>>((const T*)in, (T*)out, cf, vec, inv,
                                                           (uint32_t)inv2, m);
  return (int)cudaGetLastError();
}

// The resident blocks of ct_blur_kernel with the run `slots` at `bytes` of
// shared memory on the current device (0 for no such run).
template <typename T>
long long ct_blur_blocks(int slots, long long bytes) {
  const CtBlurKernel<T> kernel = ct_blur_of<T>(slots);
  long long blocks;
  if (kernel == nullptr || bytes < 0 || bytes > (long long)kMaxSmemBytes ||
      resident_blocks(reinterpret_cast<const void*>(kernel), kFusedWarps * 32, (size_t)bytes,
                      &blocks) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

template <typename T>
int launch_ct_v_chip(const void* in, void* out, int n, int h, int w, int r, uint32_t m, int sh,
                     cudaStream_t s) {
  const int cols = kStripBytes / sizeof(T);
  const long long strips = (w + cols - 1) / cols;
  const size_t bytes = v_chip_bytes(r, 1);
  const long long blocks = n * strips;
  if (bytes > kMaxSmemBytes || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const bool vec = (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (size_t)w * sizeof(T) % 16 == 0;
  const void* kernel = vec ? reinterpret_cast<const void*>(ct_v_chip_kernel<T, true>)
                           : reinterpret_cast<const void*>(ct_v_chip_kernel<T, false>);
  long long resident;  // sets the kernel's dynamic shared memory allowance
  const cudaError_t e = resident_blocks(kernel, 32, bytes, &resident);
  if (e != cudaSuccess) return (int)e;
  if (vec) {
    ct_v_chip_kernel<T, true><<<(unsigned)blocks, 32, bytes, s>>>(
        (const T*)in, (T*)out, h, w, r, (int)strips, m, sh);
  } else {
    ct_v_chip_kernel<T, false><<<(unsigned)blocks, 32, bytes, s>>>(
        (const T*)in, (T*)out, h, w, r, (int)strips, m, sh);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// elem_bytes: 1 (uint8) or 2 (uint16).  Shapes are (n, h, w), contiguous.

int vz_v_fixed(const void* in, void* out, void* scratch, int elem_bytes, int n,
               int h, int w, int r, int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return elem_bytes == 1
             ? launch_v_fixed<uint8_t>(in, out, scratch, n, h, w, r, passes, s)
             : launch_v_fixed<uint16_t>(in, out, scratch, n, h, w, r, passes, s);
}

// v_fixed on chip (passes <= 6, v_chip_bytes(r, passes) <= kMaxSmemBytes):
// the plane read once and written once, no scratch.
int vz_v_chip(const void* in, void* out, int elem_bytes, int n, int h, int w, int r, int passes,
              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return elem_bytes == 1 ? launch_v_chip<uint8_t>(in, out, n, h, w, r, passes, s)
                         : launch_v_chip<uint16_t>(in, out, n, h, w, r, passes, s);
}

// The uint32 words of scratch vz_h_fixed needs (0: none; pass null).
long long vz_h_fixed_scratch_words(long long rows, int w, int r) {
  return h_fixed_scratch_words(rows, w, r);
}

// h_fixed's block design, any row (scratch as vz_h_fixed_scratch_words says).
int vz_h_fixed(const void* in, void* out, void* scratch, int elem_bytes, long long rows,
               int w, int r, int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return elem_bytes == 1
             ? launch_h_fixed<uint8_t>(in, out, scratch, rows, w, r, passes, s)
             : launch_h_fixed<uint16_t>(in, out, scratch, rows, w, r, passes, s);
}

// h_fixed's register design on the shape the wrapper chose
// (kernels/boxblur.py h_fixed_warp_shape: slots, chunks, l0, a);
// cudaErrorInvalidValue where that shape does not hold the rows
// (h_warp_holds).
int vz_h_fixed_warp(const void* in, void* out, int elem_bytes, long long rows, int w, int r,
                    int passes, int slots, int chunks, int l0, int a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const HWarp hw = {w, r, chunks, l0, a, passes};
  return elem_bytes == 1 ? launch_h_fixed_warp<uint8_t>(in, out, rows, slots, hw, s)
                         : launch_h_fixed_warp<uint16_t>(in, out, rows, slots, hw, s);
}

// B1's vertical stage (v_chip_bytes(r, 1) <= kMaxSmemBytes, r <= 897): (2*col + k) /
// (2k) as (N * m) >> sh, m and sh from the wrapper.
int vz_ct_v_chip(const void* in, void* out, int elem_bytes, int n, int h, int w, int r,
                 unsigned m, int sh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return elem_bytes == 1 ? launch_ct_v_chip<uint8_t>(in, out, n, h, w, r, m, sh, s)
                         : launch_ct_v_chip<uint16_t>(in, out, n, h, w, r, m, sh, s);
}

// B1 in one launch on the shape the wrapper chose (kernels/boxblur.py
// ct_blur_fused_shape: slots, chunks, ring, rowbuf; ct_blur_bands: bands),
// (2*col + k) / (2k) as the high word of N * m (ct_blur_multiplier);
// cudaErrorInvalidValue where that shape does not hold the planes
// (ct_fused_holds).
int vz_ct_blur(const void* in, void* out, int elem_bytes, int n, int h, int w, int r, int bands,
               int slots, int chunks, int ring, int rowbuf, unsigned m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const CtFused cf = {h, w, r, bands, (int)(((long long)w * elem_bytes + 15) / 16), ring, rowbuf,
                      chunks};
  return elem_bytes == 1 ? launch_ct_blur<uint8_t>(in, out, n, cf, slots, m, s)
                         : launch_ct_blur<uint16_t>(in, out, n, cf, slots, m, s);
}

// The blocks of vz_ct_blur's kernel with the run `slots` and `bytes` of
// shared memory resident on the current device (0: no such run or size).
long long vz_ct_blur_blocks(int elem_bytes, int slots, long long bytes) {
  return elem_bytes == 1 ? ct_blur_blocks<uint8_t>(slots, bytes)
                         : ct_blur_blocks<uint16_t>(slots, bytes);
}

}  // extern "C"
