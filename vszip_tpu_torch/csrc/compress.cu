// Compress's 8x8 block pipeline for Hopper (sm_90a), the CUDA counterpart of
//   compress_kernel  B14 compress_plane_pallas  (vszip_tpu/kernels/compress_pallas.py)
// and of the XLA chain the JAX package runs in the wide regimes
// (_compress_plane, vszip_tpu/ops/compress.py).  Per 8x8 block of an
// (n, h, w) uint8 plane, edge-padded to multiples of 8: the islow forward
// DCT (rows then columns), the MPEG-2 deadzone or JPEG symmetric
// quantize/dequantize, the simple IDCT (rows with the DC-only fast path,
// then columns), clamped back to uint8 (reference src/filters/compress.zig).
//
// Exactness: the reference wraps in i32 with i16 truncation between stages.
// Signed overflow is undefined in C++, so every butterfly runs in uint32
// (wrapping mod 2^32, which is the same sum in any order) and converts to
// int32 only to shift and compare.  The quantizer product is uint32 in the
// narrow regimes and int64 in the wide ones (kWide: MPEG qscale 1-2, JPEG
// luma quality >= 78, chroma >= 87), as the JAX package takes it; Hopper has
// native 64-bit integer arithmetic, so one kernel serves both.
//
// The TPU kernel runs the butterflies as block-diagonal bf16 matmuls on byte
// limbs, the DC-only test and DC broadcast as 15 masked rolls, and reads the
// tables as (64, W) tiles.  Here one thread owns one 8x8 block: its 64
// values stay in registers through all four 8-point passes, with the
// butterflies of the reference, so nothing goes through shared memory and
// no block barrier is taken.  A warp's 32 threads own 32 adjacent blocks of
// a block row, so each of the 8 row loads (one 8-byte word a row) and
// stores moves 256 contiguous bytes.  The grid is one frame's blocks times
// as many frame groups as fill the card's resident blocks in one wave; a
// thread walks its block through every g-th frame and loads the next
// frame's 8 words while this one computes.  The two (64,) tables travel in
// the kernel's arguments (constant bank operands).  The DC-only fast path is
// taken per row, as the reference takes it; a warp skips the full row IDCT
// when all of its 32 blocks' row is DC-only.  Eight lanes per block (one
// row each, the transposes through a per-warp shared tile) held 32-39
// registers and six blocks an SM but ran slower in both regimes: a warp's
// quantizer vote then spans 32 different coefficients and almost never
// skips, and the column pass with the quantizer took most of a lane's life.
//
// Variants: the 8-byte loads and stores need w % 8 == 0 and both planes on
// 8 bytes (kVec, chosen by the launcher); other planes take 8 clamped byte
// loads a row and store only the columns inside the plane.  The bottom
// edge's blocks clamp their row index and store only rows inside, in both.
//
// What bounds it: one u8 read and one u8 write per pixel (199 MB each way
// per 64 frames of 1080p YUV420P8 against 3.35 TB/s) and the integer operations as the
// card issues them (multiply-adds and 3-input adds fused), shared between
// the ALU and the FMA pipe at 64 per SM per clock each: about 28 per pixel
// where most rows take the DC-only path and most coefficients quantize to
// zero, which outweigh the bytes (chip_smoke.py counts both from the data).
// The design adds the byte unpacking and packing (about 3 a pixel); each
// coefficient's quantizer runs only where some lane of the warp may give a
// value other than 0 (a vote on the product's range, about 5 a coefficient
// where the warp skips it).
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

typedef uint32_t u32;

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// islow FDCT constants (CONST_BITS 13, PASS1_BITS 4)
constexpr u32 F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433,
              F0_765366865 = 6270, F0_899976223 = 7373, F1_175875602 = 9633,
              F1_501321110 = 12299, F1_847759065 = 15137, F1_961570560 = 16069,
              F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;
// simple IDCT constants
constexpr u32 W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;
constexpr u32 COL_DC_BIAS = (1u << (COL_SHIFT - 1)) / W4;
// quantizer constants
constexpr int QMAT_SHIFT = 21;
constexpr int MPEG_BIAS = (3 << 5) * (1 << (QMAT_SHIFT - 8));
constexpr int MPEG_THRESH1 = (1 << QMAT_SHIFT) - MPEG_BIAS - 1;
constexpr int MPEG_THRESH2 = MPEG_THRESH1 << 1;
constexpr int JPEG_BIAS = 1 << (QMAT_SHIFT - 1);

struct Tables {
  int32_t qa[64];  // quantizer multipliers, (row in block)*8 + column
  int32_t qb[64];  // dequantizer steps
};

__device__ __forceinline__ int32_t i16(int32_t v) { return (int32_t)((u32)v << 16) >> 16; }

__device__ __forceinline__ int32_t descale(u32 v, int n) {
  return (int32_t)(v + (1u << (n - 1))) >> n;
}

// The islow FDCT's linear part: o[k] before its rounding shift.
__device__ __forceinline__ void fdct_raw(const int32_t (&t)[8], u32 (&o)[8]) {
  const u32 tmp0 = (u32)t[0] + (u32)t[7], tmp7 = (u32)t[0] - (u32)t[7];
  const u32 tmp1 = (u32)t[1] + (u32)t[6], tmp6 = (u32)t[1] - (u32)t[6];
  const u32 tmp2 = (u32)t[2] + (u32)t[5], tmp5 = (u32)t[2] - (u32)t[5];
  const u32 tmp3 = (u32)t[3] + (u32)t[4], tmp4 = (u32)t[3] - (u32)t[4];
  const u32 tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const u32 tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  o[0] = tmp10 + tmp11;
  o[4] = tmp10 - tmp11;
  const u32 ze = (tmp12 + tmp13) * F0_541196100;
  o[2] = ze + tmp13 * F0_765366865;
  o[6] = ze - tmp12 * F1_847759065;
  u32 z1 = tmp4 + tmp7, z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const u32 z5 = (z3 + z4) * F1_175875602;
  const u32 o4 = tmp4 * F0_298631336, o5 = tmp5 * F2_053119869;
  const u32 o6 = tmp6 * F3_072711026, o7 = tmp7 * F1_501321110;
  z1 = 0u - z1 * F0_899976223;
  z2 = 0u - z2 * F2_562915447;
  z3 = z5 - z3 * F1_961570560;
  z4 = z5 - z4 * F0_390180644;
  o[7] = o4 + z1 + z3;
  o[5] = o5 + z2 + z4;
  o[3] = o6 + z2 + z3;
  o[1] = o7 + z1 + z4;
}

// The simple IDCT's linear part (the same for rows and columns).
__device__ __forceinline__ void idct_raw(const int32_t (&m)[8], u32 (&o)[8]) {
  const u32 c0 = m[0], c1 = m[1], c2 = m[2], c3 = m[3], c4 = m[4], c5 = m[5], c6 = m[6],
            c7 = m[7];
  const u32 a0 = W4 * c0 + W2 * c2 + W4 * c4 + W6 * c6;
  const u32 a1 = W4 * c0 + W6 * c2 - W4 * c4 - W2 * c6;
  const u32 a2 = W4 * c0 - W6 * c2 - W4 * c4 + W2 * c6;
  const u32 a3 = W4 * c0 - W2 * c2 + W4 * c4 - W6 * c6;
  const u32 b0 = W1 * c1 + W3 * c3 + W5 * c5 + W7 * c7;
  const u32 b1 = W3 * c1 - W7 * c3 - W1 * c5 - W5 * c7;
  const u32 b2 = W5 * c1 - W1 * c3 + W7 * c5 + W3 * c7;
  const u32 b3 = W7 * c1 - W5 * c3 + W3 * c5 - W1 * c7;
  o[0] = a0 + b0; o[7] = a0 - b0;
  o[1] = a1 + b1; o[6] = a1 - b1;
  o[2] = a2 + b2; o[5] = a2 - b2;
  o[3] = a3 + b3; o[4] = a3 - b3;
}

// The quantizer's rounding shift of a product `lv` (int64 wide, else the
// wrapped int32 `lv32`/`lvu`).
template <bool kWide>
__device__ __forceinline__ int32_t q_shift(long long lv, u32 lvu, int bias, bool jpeg) {
  if (kWide) {
    const long long q = lv > 0 ? (bias + lv) >> QMAT_SHIFT
                               : (lv < 0 || !jpeg ? -((bias - lv) >> QMAT_SHIFT) : 0);
    return (int32_t)(u32)(unsigned long long)q;  // .astype(int32) wraps
  }
  const int32_t l = (int32_t)lvu;
  if (l > 0) return (int32_t)((u32)bias + lvu) >> QMAT_SHIFT;
  if (l < 0 || !jpeg) return (int32_t)(0u - (u32)((int32_t)((u32)bias - lvu) >> QMAT_SHIFT));
  return 0;
}

// Coefficient `c` at table index k -> its dequantized value.
template <bool kJpeg, bool kWide>
__device__ __forceinline__ int32_t quantize(int32_t c, int k, const Tables& t, int dc_prec) {
  const long long lv = kWide ? (long long)c * t.qa[k] : 0;
  const u32 lvu = (u32)c * (u32)t.qa[k];
  if (kJpeg) {
    const int32_t q = q_shift<kWide>(lv, lvu, JPEG_BIAS, true);
    return i16((int32_t)((u32)q * (u32)t.qb[k]));
  }
  if (k == 0) {
    const int dc_scale = 8 >> dc_prec, dc_q = dc_scale << 3;
    return i16((c + (dc_q >> 1)) / dc_q * dc_scale);  // C division truncates
  }
  const bool inrange = kWide ? (unsigned long long)(lv + MPEG_THRESH1) > (unsigned long long)MPEG_THRESH2
                             : lvu + (u32)MPEG_THRESH1 > (u32)MPEG_THRESH2;
  const int32_t ac = inrange ? q_shift<kWide>(lv, lvu, MPEG_BIAS, false) : 0;
  const u32 mag = ac < 0 ? 0u - (u32)ac : (u32)ac;  // abs wraps at INT_MIN
  const int32_t d = (int32_t)(mag * (u32)t.qb[k]) >> 4;
  return i16(ac > 0 ? d : (ac < 0 ? (int32_t)(0u - (u32)d) : 0));
}

// One 8x8 block in registers: the pixels (row r's 8 bytes, column c in byte
// c) in, through both transforms, the pixels out as 8 row words.
// False only where quantize(c, k) is 0: a JPEG product under 2^20 in
// magnitude (it rounds to 0), an MPEG-2 AC product inside the dead zone.
template <bool kJpeg, bool kWide>
__device__ __forceinline__ bool may_quantize_nonzero(int32_t c, int k, const Tables& t) {
  if (!kJpeg && k == 0) return true;  // the DC takes its own path
  const long long lv = kWide ? (long long)c * t.qa[k] : 0;
  const u32 lvu = (u32)c * (u32)t.qa[k];
  if (kJpeg) {
    return kWide ? (unsigned long long)(lv + (JPEG_BIAS - 1))
                       > (unsigned long long)(2 * JPEG_BIAS - 2)
                 : lvu + (u32)(JPEG_BIAS - 1) > (u32)(2 * JPEG_BIAS - 2);
  }
  return kWide ? (unsigned long long)(lv + MPEG_THRESH1) > (unsigned long long)MPEG_THRESH2
               : lvu + (u32)MPEG_THRESH1 > (u32)MPEG_THRESH2;
}

template <bool kJpeg, bool kWide>
__device__ __forceinline__ void block_pipeline(uint64_t (&rw)[8], const Tables& tab,
                                               int dc_prec) {
  const int level = kJpeg ? 128 : 0;
  int32_t b[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) b[r][c] = (int32_t)((rw[r] >> (8 * c)) & 0xFF) - level;
  }
  int32_t t[8];
  u32 raw[8];
  // forward DCT, rows
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    fdct_raw(b[r], raw);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      b[r][k] = i16(k % 4 == 0 ? (int32_t)(raw[k] << 4) : descale(raw[k], 9));
  }
  // forward DCT, columns, then quantize
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int r = 0; r < 8; ++r) t[r] = b[r][c];
    fdct_raw(t, raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int32_t q = i16(k % 4 == 0 ? descale(raw[k], 4) : descale(raw[k], 17));
      // the warp skips the quantizer where it gives 0 in every lane
      const int idx = k * 8 + c;
      const bool any = __any_sync(__activemask(), may_quantize_nonzero<kJpeg, kWide>(q, idx, tab));
      b[k][c] = any ? quantize<kJpeg, kWide>(q, idx, tab, dc_prec) : 0;
    }
  }
  // inverse DCT, rows, with the DC-only fast path
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if ((b[r][1] | b[r][2] | b[r][3] | b[r][4] | b[r][5] | b[r][6] | b[r][7]) == 0) {
      const int32_t dc = i16(b[r][0] * 8);
#pragma unroll
      for (int k = 0; k < 8; ++k) b[r][k] = dc;
    } else {
      idct_raw(b[r], raw);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        b[r][k] = i16((int32_t)(raw[k] + (1u << (ROW_SHIFT - 1))) >> ROW_SHIFT);
    }
  }
  // inverse DCT, columns, to pixels
#pragma unroll
  for (int r = 0; r < 8; ++r) rw[r] = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int r = 0; r < 8; ++r) t[r] = b[r][c];
    idct_raw(t, raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int32_t p = ((int32_t)(raw[k] + W4 * COL_DC_BIAS) >> COL_SHIFT) + level;
      rw[k] |= (uint64_t)min(max(p, 0), 255) << (8 * c);
    }
  }
}

// The 8 rows of the 8x8 block at (y0, x0) of a plane, edge-padded by
// clamping: one 8-byte word a row (kVec: w % 8 == 0 and the plane on 8
// bytes), else 8 clamped byte loads.
template <bool kVec>
__device__ __forceinline__ void load_block(uint64_t (&rw)[8], const uint8_t* plane, int h, int w,
                                           int y0, int x0) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint8_t* row = plane + (size_t)min(y0 + r, h - 1) * w;
    if (kVec) {
      rw[r] = __ldg(reinterpret_cast<const unsigned long long*>(row + x0));
    } else {
      uint64_t v = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) v |= (uint64_t)__ldg(row + min(x0 + c, w - 1)) << (8 * c);
      rw[r] = v;
    }
  }
}

// The pixels of the block at (y0, x0) that lie inside the plane.
template <bool kVec>
__device__ __forceinline__ void store_block(const uint64_t (&rw)[8], uint8_t* plane, int h,
                                            int w, int y0, int x0) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (y0 + r >= h) break;
    uint8_t* row = plane + (size_t)(y0 + r) * w;
    if (kVec) {
      *reinterpret_cast<unsigned long long*>(row + x0) = rw[r];
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (x0 + c < w) row[x0 + c] = (uint8_t)(rw[r] >> (8 * c));
    }
  }
}

// grid (ceil(blocks of a frame / 256), frame groups g): thread j of the
// x-grid owns 8x8 block j of every g-th frame from blockIdx.y, and loads
// the next frame's block while this one computes.
template <bool kJpeg, bool kWide, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    compress_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out, int n, int h,
                    int w, int dc_prec, const Tables tab) {
  const long long bw = (w + 7) / 8, blocks = bw * ((h + 7) / 8);
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= blocks) return;
  const int y0 = (int)(j / bw) * 8, x0 = (int)(j % bw) * 8;
  const size_t plane = (size_t)h * w;
  int f = blockIdx.y;
  if (f >= n) return;
  uint64_t rw[8];
  load_block<kVec>(rw, x + f * plane, h, w, y0, x0);
  for (;;) {
    const int next = f + gridDim.y;
    uint64_t nx[8];
    if (next < n) load_block<kVec>(nx, x + next * plane, h, w, y0, x0);
    block_pipeline<kJpeg, kWide>(rw, tab, dc_prec);
    store_block<kVec>(rw, out + f * plane, h, w, y0, x0);
    if (next >= n) break;
    f = next;
#pragma unroll
    for (int r = 0; r < 8; ++r) rw[r] = nx[r];
  }
}

template <bool kJpeg, bool kWide, bool kVec>
int launch(const uint8_t* x, uint8_t* out, int n, int h, int w, int dc_prec,
           const Tables& tab, cudaStream_t s) {
  long long resident;  // on the current device (cards of a mesh may differ)
  const cudaError_t e = resident_blocks(
      reinterpret_cast<const void*>(compress_kernel<kJpeg, kWide, kVec>), kThreads, 0, &resident);
  if (e != cudaSuccess) return (int)e;
  const long long xblocks = ((long long)((w + 7) / 8) * ((h + 7) / 8) + kThreads - 1) / kThreads;
  if (xblocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // frame groups: as many as fill the resident blocks in one wave
  const long long g = std::max(1LL, std::min<long long>(
      {(long long)n, resident / xblocks, (long long)kMaxGridY}));
  compress_kernel<kJpeg, kWide, kVec><<<dim3((unsigned)xblocks, (unsigned)g), kThreads, 0, s>>>(
      x, out, n, h, w, dc_prec, tab);
  return (int)cudaGetLastError();
}

template <bool kJpeg, bool kWide>
int launch_aligned(const uint8_t* x, uint8_t* out, int n, int h, int w, int dc_prec,
                   const Tables& tab, cudaStream_t s) {
  const bool vec = w % 8 == 0 && (uintptr_t)x % 8 == 0 && (uintptr_t)out % 8 == 0;
  return vec ? launch<kJpeg, kWide, true>(x, out, n, h, w, dc_prec, tab, s)
             : launch<kJpeg, kWide, false>(x, out, n, h, w, dc_prec, tab, s);
}

}  // namespace

extern "C" {

// x, out: (n, h, w) uint8, contiguous, on one device; qa, qb: 64 host int32
// each; jpeg: 0 MPEG-2, 1 JPEG; wide: quantizer products in int64.
int vz_compress(const void* x, const int32_t* qa, const int32_t* qb, void* out, int n, int h,
                int w, int jpeg, int dc_prec, int wide, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  Tables tab;
  for (int k = 0; k < 64; ++k) {
    tab.qa[k] = qa[k];
    tab.qb[k] = qb[k];
  }
  const uint8_t* xs = (const uint8_t*)x;
  uint8_t* os = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (jpeg) {
    return wide ? launch_aligned<true, true>(xs, os, n, h, w, dc_prec, tab, s)
                : launch_aligned<true, false>(xs, os, n, h, w, dc_prec, tab, s);
  }
  return wide ? launch_aligned<false, true>(xs, os, n, h, w, dc_prec, tab, s)
              : launch_aligned<false, false>(xs, os, n, h, w, dc_prec, tab, s);
}

}  // extern "C"
