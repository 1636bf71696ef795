// MosquitoNR's smoothing stage for Hopper (sm_90a): steps 1-3 of
// ops/mosquito_nr.py's _mosquito_plane in one launch a plane.  It replaces
// no TPU kernel: the JAX package computes MosquitoNR in plain jnp
// (vszip_tpu/ops/mosquito_nr.py).  Per sample c of an (n, h, w) plane, with
// taps t(dy, dx) over a 2-sample reflect-101 border (row -k is row k, row
// h - 1 + k is row h - 1 - k; columns alike):
//   the work plane is c << 4 for integers, c itself for f32;
//   8 directional SADs at radius 1 or 2 (ops/mosquito_nr.py _sads): a tap
//     costs |t - c|, a pair |((a + b) >> 1) - c| (f32: |(a + b) * 0.5 - c|);
//   the smallest SAD picks the direction, ties keep the lower index, and a
//     smallest SAD of exactly 0 copies the centre;
//   the chosen direction's blend (_blend): at radius 2 a line
//     (c0 c + s sum4 + 64) >> 7 and a bend (c1 c + 2s far2 + s near4 + 128)
//     >> 8 on the lifted plane, c0 = 128 - 4s, c1 = 256 - 8s; at radius 1
//     (c0 c + s sum2 + 32) >> 6 and (c1 c + s near4 + 64) >> 7, c0 = 64 - 2s,
//     c1 = 128 - 4s; f32 multiplies by 1/128, 1/256, 1/64 or 1/128 instead.
// The kernel writes the smoothed plane (int32, or f32) and, where asked,
// the lifted int32 work plane that the restore reads.
//
// Exact arithmetic.  Integers: every SAD of the lifted plane is 8 times one
// of the raw samples (|(16a + 16b) >> 1 - 16c| = 8 |a + b - 2c|), so the
// kernel ranks the raw SADs over 8, each as the key 8 (SAD / 8) + direction:
// the smallest key is the smallest SAD with ties at the lower index, and a
// key below 8 a zero SAD.  Keys stay below 2^22 for 16-bit samples.  Both
// blends are one formula on the raw samples: (c1 c + s N + 2s F + 8) >> 4 at
// radius 2 (a line's (16X + 64) >> 7 is (2X + 8) >> 4, and c1 = 2 c0), and
// (c1 c + s N + 4) >> 3 at radius 1, where N and F sum taps at +-u, +-w and
// +-f of a per-direction table: a bend's near and far taps, a line's near
// taps twice (u = w) and its far pair as F.  f32: -fmad=false keeps every
// add and multiply rounded on its own, each sum in the plain version's
// order (the table lists a direction's taps in that order), both blends are
// computed from the same six taps and one chosen.  |a - b| is |b - a| in
// IEEE arithmetic as in integers, so a vertical line term is computed once
// and used again by the sample below.  So every output equals the plain
// version's on the card bit for bit.
//
// Design.  The plain version runs 236 torch passes over whole int32 planes.
// Here a block of 64 x 4 threads takes a 64 x 32 tile of one frame: it
// stages the tile's samples with their reflected border in shared memory
// (16-byte loads where the row allows, element loads at the border), and
// each thread walks 8 rows of one column with a 5-row (radius 2) or 3-row
// register window, so each sample is read from shared memory once a row of
// the window.  The SADs, the choice and the blend stay in registers; the
// blend reads the chosen direction's taps through a table of offsets, so no
// thread diverges on its direction and no arm is computed behind a select.
// What bounds it: integer operations.  The plain formulas take 137 a sample
// at radius 2 (portbench/reference/mosquito_nr.py work(): 1.09 ms for 64
// frames of 1080p luma at 16.7 T op/s); its bytes (the u16 plane in, the
// int32 smoothed and work planes out, 1.33 GB) take 0.40 ms.
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns a CUDA error
// code (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileW = 64;                  // columns of a tile: two warps across
constexpr int kThreadRows = 4;              // threads down a tile
constexpr int kRows = 8;                    // outputs of a thread, down one column
constexpr int kTileH = kThreadRows * kRows;
constexpr int kThreads = kTileW * kThreadRows;
constexpr int kLeft = 4;                    // the tile's column 0 in shared memory
constexpr int kPitch = kLeft + kTileW + 4;  // words a row: 16-byte aligned rows

struct Args {
  const void* src;
  void* blur;
  int* work;  // the lifted int32 work plane, or null
  int h, w, tiles_x, tiles, strength;
};

// Row or column i of an axis of n, reflected 101 at both ends; indices past
// one reflection (never read) go to 0.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * n - 2 - i : i;
  return i < 0 ? 0 : i;
}

// 16 bytes of samples of type T into consecutive words of shared memory at
// a 16-byte aligned address.
template <typename T>
__device__ __forceinline__ void unpack(const uint4 q, void* dst) {
  if constexpr (std::is_same<T, float>::value) {
    *(uint4*)dst = q;
  } else if constexpr (std::is_same<T, uint16_t>::value) {
    int4* d = (int4*)dst;
    d[0] = make_int4(q.x & 0xffff, q.x >> 16, q.y & 0xffff, q.y >> 16);
    d[1] = make_int4(q.z & 0xffff, q.z >> 16, q.w & 0xffff, q.w >> 16);
  } else {
    int4* d = (int4*)dst;
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d[k] = make_int4(u[k] & 0xff, (u[k] >> 8) & 0xff, (u[k] >> 16) & 0xff, u[k] >> 24);
    }
  }
}

// The block's tile and its border of H samples, as int32 (integers) or f32.
template <typename T, int H, typename S>
__device__ __forceinline__ void load_tile(S (*tile)[kPitch], const T* __restrict__ src, int h,
                                          int w, int x0, int y0) {
  constexpr int kRowsIn = kTileH + 2 * H;
  constexpr int kVec = 16 / sizeof(T);  // samples a 16-byte load
  constexpr int kVecs = kTileW / kVec;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  if (x0 + kTileW <= w && w % kVec == 0 && ((uintptr_t)src & 15) == 0) {
    for (int i = tid; i < kRowsIn * kVecs; i += kThreads) {
      const int r = i / kVecs, v = i - r * kVecs;
      const T* row = src + (size_t)reflect(y0 - H + r, h) * w + x0;
      unpack<T>(__ldg((const uint4*)row + v), &tile[r][kLeft + v * kVec]);
    }
    for (int i = tid; i < kRowsIn * 2 * H; i += kThreads) {
      const int r = i / (2 * H), k = i - r * (2 * H);
      const int col = k < H ? k - H : kTileW + k - H;
      tile[r][kLeft + col] =
          (S)__ldg(src + (size_t)reflect(y0 - H + r, h) * w + reflect(x0 + col, w));
    }
  } else {
    constexpr int kCols = kTileW + 2 * H;
    for (int i = tid; i < kRowsIn * kCols; i += kThreads) {
      const int r = i / kCols, k = i - r * kCols;
      tile[r][kLeft - H + k] =
          (S)__ldg(src + (size_t)reflect(y0 - H + r, h) * w + reflect(x0 - H + k, w));
    }
  }
}

// The direction table: for each direction the (dy, dx) of the taps at +-u,
// +-w and +-f.  Lines d = 0-3 run along e = (0, 1), (1, 1), (1, 0),
// (1, -1); bends 4-7 pair near taps at +-u and +-w with far ones at +-f.
// Integers: a line's u = w = e and f = 2e (the near pair counted twice).
// f32: a line's sum runs t(-u), t(-w), t(w), t(u) with u = 2e and w = e
// (radius 1: t(-w), t(w)); a bend's near sum runs in the same order and its
// far pair t(-f), t(f), as the plain version adds them.
__constant__ int8_t kIntTaps[8][3][2] = {
    {{0, 1}, {0, 1}, {0, 2}},   {{1, 1}, {1, 1}, {2, 2}},  {{1, 0}, {1, 0}, {2, 0}},
    {{1, -1}, {1, -1}, {2, -2}}, {{1, 1}, {0, 1}, {1, 2}},  {{1, 1}, {1, 0}, {2, 1}},
    {{1, -1}, {1, 0}, {2, -1}},  {{1, -1}, {0, -1}, {1, -2}}};
__constant__ int8_t kF32Taps[8][3][2] = {
    {{0, 2}, {0, 1}, {0, 0}},   {{2, 2}, {1, 1}, {0, 0}},  {{2, 0}, {1, 0}, {0, 0}},
    {{2, -2}, {1, -1}, {0, 0}}, {{1, 1}, {0, 1}, {1, 2}},  {{1, 1}, {1, 0}, {2, 1}},
    {{1, -1}, {1, 0}, {2, -1}},  {{1, -1}, {0, -1}, {1, -2}}};

// Direction d's (u, w, f) as offsets in words of the tile at radius H.  An
// f32 line at radius 1 sums t(-w), t(w) alone; its u is read (and not used)
// as w, inside the tile's border.
template <bool kInt, int H>
__device__ __forceinline__ int4 direction_offsets(int d) {
  const int8_t(*t)[2] = kInt ? kIntTaps[d] : kF32Taps[d];
  const int u = !kInt && H == 1 && d < 4 ? 1 : 0;
  return make_int4(t[u][0] * kPitch + t[u][1], t[1][0] * kPitch + t[1][1],
                   t[2][0] * kPitch + t[2][1], 0);
}

// The key 8 (SAD / 8) + direction of the smallest SAD of centre v[H][H]
// (integers, raw samples); a12 .. a42: the vertical line's |t - c| at -1,
// +1, -2, +2 rows (a02, a42 unused at radius 1).
template <int H>
__device__ __forceinline__ int best_key(const int (&v)[2 * H + 1][2 * H + 1], int a12, int a32,
                                        int a02, int a42) {
  constexpr int C = H;
  const int c = v[C][C], c2 = c + c;
  auto ad = [c](int t) { return abs(t - c); };
  auto pr = [c2](int a, int b) { return abs(a + b - c2); };
  const int* r0 = v[C - 1];  // row -1
  const int* r1 = v[C];      // row 0
  const int* r2 = v[C + 1];  // row +1
  if constexpr (H == 1) {
    const int k0 = (ad(r1[0]) + ad(r1[2])) * 16;
    const int k1 = (ad(r0[0]) + ad(r2[2])) * 16 + 1;
    const int k2 = (a12 + a32) * 16 + 2;
    const int k3 = (ad(r0[2]) + ad(r2[0])) * 16 + 3;
    const int k4 = (pr(r1[0], r0[0]) + pr(r1[2], r2[2])) * 8 + 4;
    const int k5 = (pr(r0[0], r0[1]) + pr(r2[2], r2[1])) * 8 + 5;
    const int k6 = (pr(r0[1], r0[2]) + pr(r2[1], r2[0])) * 8 + 6;
    const int k7 = (pr(r1[2], r0[2]) + pr(r1[0], r2[0])) * 8 + 7;
    return min(min(min(k0, k1), min(k2, k3)), min(min(k4, k5), min(k6, k7)));
  } else {
    const int* q0 = v[0];  // row -2
    const int* q4 = v[4];  // row +2
    // rows -1, 0, +1 at columns -2 .. +2 are r0[0..4], r1[0..4], r2[0..4]
    const int k0 = (ad(r1[1]) + ad(r1[3]) + ad(r1[0]) + ad(r1[4])) * 16;
    const int k1 = (ad(r0[1]) + ad(r2[3]) + ad(q0[0]) + ad(q4[4])) * 16 + 1;
    const int k2 = (a12 + a32 + a02 + a42) * 16 + 2;
    const int k3 = (ad(r0[3]) + ad(r2[1]) + ad(q0[4]) + ad(q4[0])) * 16 + 3;
    const int k4 = (ad(r0[0]) + ad(r2[4])) * 16 + (pr(r1[1], r0[1]) + pr(r1[3], r2[3])) * 8 + 4;
    const int k5 = (ad(q0[1]) + ad(q4[3])) * 16 + (pr(r0[1], r0[2]) + pr(r2[3], r2[2])) * 8 + 5;
    const int k6 = (ad(q0[3]) + ad(q4[1])) * 16 + (pr(r0[2], r0[3]) + pr(r2[2], r2[1])) * 8 + 6;
    const int k7 = (ad(r0[4]) + ad(r2[0])) * 16 + (pr(r0[3], r1[3]) + pr(r2[1], r1[1])) * 8 + 7;
    return min(min(min(k0, k1), min(k2, k3)), min(min(k4, k5), min(k6, k7)));
  }
}

// The direction (0-7, 8 flat) of centre v[H][H] (f32), each SAD summed in
// the plain version's order; a12 .. a42 as in best_key.
template <int H>
__device__ __forceinline__ int best_dir(const float (&v)[2 * H + 1][2 * H + 1], float a12,
                                        float a32, float a02, float a42) {
  constexpr int C = H;
  const float c = v[C][C];
  auto A = [c](float t) { return fabsf(t - c); };
  auto P = [c](float a, float b) { return fabsf((a + b) * 0.5f - c); };
  const float* r0 = v[C - 1];
  const float* r1 = v[C];
  const float* r2 = v[C + 1];
  float sad[8];
  if constexpr (H == 1) {
    sad[0] = A(r1[0]) + A(r1[2]);
    sad[1] = A(r0[0]) + A(r2[2]);
    sad[2] = a12 + a32;
    sad[3] = A(r0[2]) + A(r2[0]);
    sad[4] = P(r1[0], r0[0]) + P(r1[2], r2[2]);
    sad[5] = P(r0[0], r0[1]) + P(r2[2], r2[1]);
    sad[6] = P(r0[1], r0[2]) + P(r2[1], r2[0]);
    sad[7] = P(r1[2], r0[2]) + P(r1[0], r2[0]);
  } else {
    const float* q0 = v[0];
    const float* q4 = v[4];
    sad[0] = ((A(r1[1]) + A(r1[3])) + A(r1[0])) + A(r1[4]);
    sad[1] = ((A(r0[1]) + A(r2[3])) + A(q0[0])) + A(q4[4]);
    sad[2] = ((a12 + a32) + a02) + a42;
    sad[3] = ((A(r0[3]) + A(r2[1])) + A(q0[4])) + A(q4[0]);
    sad[4] = ((A(r0[0]) + A(r2[4])) + P(r1[1], r0[1])) + P(r1[3], r2[3]);
    sad[5] = ((A(q0[1]) + A(q4[3])) + P(r0[1], r0[2])) + P(r2[3], r2[2]);
    sad[6] = ((A(q0[3]) + A(q4[1])) + P(r0[2], r0[3])) + P(r2[2], r2[1]);
    sad[7] = ((A(r0[4]) + A(r2[0])) + P(r0[3], r1[3])) + P(r2[1], r1[1]);
  }
  float best = sad[0];
  int dir = 0;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    const bool lt = sad[i] < best;
    dir = lt ? i : dir;
    best = lt ? sad[i] : best;
  }
  return best == 0.f ? 8 : dir;
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads) smooth_kernel(const Args a) {
  constexpr bool kInt = !std::is_same<T, float>::value;
  using S = typename std::conditional<kInt, int, float>::type;
  constexpr int K = 2 * H + 1;  // window rows and columns
  __shared__ __align__(16) S tile[kTileH + 2 * H][kPitch];
  __shared__ int4 table[8];

  const int h = a.h, w = a.w;
  const int f = blockIdx.x / a.tiles, t = blockIdx.x - f * a.tiles;
  const int ty = t / a.tiles_x;
  const int x0 = (t - ty * a.tiles_x) * kTileW, y0 = ty * kTileH;
  const size_t plane = (size_t)h * w;
  if (threadIdx.y == 0 && threadIdx.x < 8) {
    table[threadIdx.x] = direction_offsets<kInt, H>(threadIdx.x);
  }
  load_tile<T, H>(tile, (const T*)a.src + f * plane, h, w, x0, y0);
  __syncthreads();

  const int lx = threadIdx.x, ly0 = threadIdx.y * kRows;
  const int x = x0 + lx;
  if (x >= w) return;
  const int s = a.strength;
  // the blend's weights: integers on the raw samples (see the note above)
  const int ci = H == 2 ? 256 - 8 * s : 128 - 4 * s, s2 = 2 * s;
  const float sf = (float)s, coef0 = H == 2 ? 128.f - 4.f * sf : 64.f - 2.f * sf,
              coef1 = H == 2 ? 256.f - 8.f * sf : 128.f - 4.f * sf, coef3 = 2.f * sf;
  const size_t at0 = f * plane + (size_t)(y0 + ly0) * w + x;
  S* blur = (S*)a.blur + at0;
  int* work = a.work != nullptr ? a.work + at0 : nullptr;

  // rows ly0 .. ly0 + 2H - 1 of the tile (output rows -H .. H - 1)
  S v[K][K];
#pragma unroll
  for (int r = 0; r < K - 1; ++r) {
#pragma unroll
    for (int j = 0; j < K; ++j) v[r][j] = tile[ly0 + r][kLeft + lx - H + j];
  }
  // the vertical line's |t - c| one and two rows down, kept for the rows
  // below: d1 = |x[y] - x[y-1]|, d2a = |x[y] - x[y-2]|, d2b = |x[y+1] - x[y-1]|
  auto absd = [](S p, S q) -> S {
    if constexpr (kInt) return abs(p - q);
    else return fabsf(p - q);
  };
  S d1 = absd(v[H][H], v[H - 1][H]);
  S d2a = 0, d2b = 0;
  if constexpr (H == 2) {
    d2a = absd(v[2][2], v[0][2]);
    d2b = absd(v[3][2], v[1][2]);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) v[K - 1][j] = tile[ly0 + i + K - 1][kLeft + lx - H + j];
    const S c = v[H][H];
    const S down1 = absd(v[H + 1][H], c);
    const S down2 = H == 2 ? absd(v[K - 1][H], c) : S(0);
    const S* p = &tile[ly0 + i + H][kLeft + lx];
    S out;
    if constexpr (kInt) {
      const int key = best_key<H>(v, d1, down1, d2a, down2);
      const int4 o = table[key & 7];
      const int n4 = p[-o.x] + p[-o.y] + p[o.y] + p[o.x];
      int acc;
      if constexpr (H == 2) {
        acc = (ci * c + s * n4 + s2 * (p[-o.z] + p[o.z]) + 8) >> 4;
      } else {
        acc = (ci * c + s * n4 + 4) >> 3;
      }
      out = key < 8 ? c << 4 : acc;
    } else {
      const int dir = best_dir<H>(v, d1, down1, d2a, down2);
      const int4 o = table[dir & 7];
      const float near2 = p[-o.y] + p[o.y];
      const float near4 = ((p[-o.x] + p[-o.y]) + p[o.y]) + p[o.x];
      float line, bend;
      if constexpr (H == 2) {
        line = (coef0 * c + sf * near4) * (1.f / 128.f);
        bend = ((coef1 * c + coef3 * (p[-o.z] + p[o.z])) + sf * near4) * (1.f / 256.f);
      } else {
        line = (coef0 * c + sf * near2) * (1.f / 64.f);
        bend = (coef1 * c + sf * near4) * (1.f / 128.f);
      }
      out = dir == 8 ? c : (dir < 4 ? line : bend);
    }
    if (y0 + ly0 + i < h) {
      blur[(size_t)i * w] = out;
      if constexpr (kInt) {
        if (work != nullptr) work[(size_t)i * w] = c << 4;
      }
    }
    d1 = down1;
    if constexpr (H == 2) {
      d2a = d2b;
      d2b = down2;
    }
#pragma unroll
    for (int r = 0; r < K - 1; ++r) {
#pragma unroll
      for (int j = 0; j < K; ++j) v[r][j] = v[r + 1][j];
    }
  }
}

template <typename T>
int launch(const Args& a, int radius, int blocks, cudaStream_t s) {
  const dim3 threads(kTileW, kThreadRows);
  if (radius == 2) {
    smooth_kernel<T, 2><<<blocks, threads, 0, s>>>(a);
  } else {
    smooth_kernel<T, 1><<<blocks, threads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One plane of n frames of h x w samples (dtype 0 u8, 1 u16, 2 f32; h and w
// at least 4), contiguous on the current device: blur receives the smoothed
// plane (int32 on the lifted scale for integers, f32 for f32) and, where
// work is not null (integers only), work the lifted plane x << 4.
int vz_mosquito_nr_smooth(const void* src, void* blur, void* work, int n, int h, int w,
                          int dtype, int radius, int strength, void* stream) {
  if (n < 0 || h < 4 || w < 4 || dtype < 0 || dtype > 2 || radius < 1 || radius > 2 ||
      strength < 0 || strength > 32 || (dtype == 2 && work != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  Args a{src, blur, (int*)work, h, w, (w + kTileW - 1) / kTileW, 0, strength};
  a.tiles = a.tiles_x * ((h + kTileH - 1) / kTileH);
  const long long blocks = (long long)n * a.tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<uint8_t>(a, radius, (int)blocks, s);
    case 1: return launch<uint16_t>(a, radius, (int)blocks, s);
    case 2: return launch<float>(a, radius, (int)blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
