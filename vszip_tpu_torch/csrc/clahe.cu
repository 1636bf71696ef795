// CLAHE's 8-bit lookup and bilinear blend for Hopper (sm_90a), the CUDA
// counterpart of the Pallas kernel
//   clahe8_chunk_kernel  B7 clahe8_lookup_pallas  (vszip_tpu/kernels/clahe_pallas.py)
// For every pixel: its cell (ry, rx) on the half-tile-shifted grid, the
// packed word tab32[n, ry, rx*256 + value] holding the four neighbour-tile
// LUT entries (one byte each), the row and column fractions at the shifted
// coordinates, and the reference's blend (src/filters/clahe.zig:265-268):
//   oxa = 1 - xa; oya = 1 - ya;
//   t1 = l0*oxa + l1*xa; t2 = l2*oxa + l3*xa; res = t1*oya + t2*ya;
//   out = trunc(res + 0.5)
// The file builds with -fmad=false, so every product and sum rounds to f32
// on its own, as in the plain torch version and the JAX package's strict
// f32 emulation.
//
// The TPU kernel pads the plane into whole cells, keeps each cell's table in
// SMEM and selects the word with a 256-way select chain (a nibble mux),
// because the TPU has no per-lane lookup.  Here the plane stays unpadded
// (nothing outside it is read) and the lookup is one shared-memory load.
//
// Design.  A thread owns kChunk (16) consecutive bytes of a row: one 16-byte
// load in, one 16-byte store out (8- or 4-byte words, or bytes, where rows or
// planes are not on 16 bytes; the last chunk of a row takes only the bytes
// inside it).  A block is bx threads across the row, one chunk each, times
// by rows (kernels.clahe.block_shape; 120 x 4 at 1920 columns, no lane
// idle), and a thread
// keeps its chunk's columns for all its rows.  So the per-column cell table,
// (px / tile_w) * 256, xa[px] and 1 - xa[px], is filled once per block and
// chunk into the registers of the thread that owns those columns: the pixel
// loop has no division and no fraction load.  The cell row follows the rows
// by additions, and a row's ya is one load shared by its threads.  The grid
// is persistent: block b takes a contiguous run of the (frame, row) space
// (`by` rows of a band at a time), and stages a frame's table in shared
// memory when it reaches that frame, one or two frames a block at the bench's
// shape.  Tables past kSmemTableBytes (kernels.clahe.table_on_chip) are read
// through the read-only cache.  A thread loads its next row's chunk before
// it blends this one.  Two blocks an SM (64 registers; the 8-, 4- and
// 1-byte variants spill a little, the 16-byte one does not).
//
// Per pixel: the byte times 4 (a shift and a mask) or-ed into its LUT's
// byte offset (a multiple of 1 KB, so one 3-input logic op), its table word
// (one 4-byte shared load whose bank the byte chooses), each LUT byte as a
// float by
// 2^23 + b - 2^23 (a byte permute and an add: exact), the blend's 9
// operations and the + 0.5, trunc by an add of 2^23 rounding towards zero
// (its low byte is trunc(r) for 0 <= r < 2^23, and r >= 0 here), and a
// quarter of the three byte permutes that pack four outputs into a word.
//
// Bound: about 11 f32 operations per pixel the function needs (0.083 ms at
// the bench's 64 frames of 1080p) against one u8 read and one u8 write
// (0.079 ms).
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kHist = 256;
constexpr uint32_t kLutBytes = kHist * sizeof(int32_t);  // one cell's packed LUT
constexpr int kChunk = 16;        // bytes of a row a thread owns
constexpr int kMaxThreads = 512;  // a block's threads at most (kernels.clahe.MAX_THREADS)
// Tables up to this size are staged in shared memory
// (kernels.clahe.table_on_chip).
constexpr int kSmemTableBytes = 96 * 1024;
constexpr float kTwo23 = 8388608.0f;

// The chunk's bytes [0, valid) from p into four little-endian words, zero
// past them; kVec bytes a load (p and the row on kVec bytes; valid is a
// multiple of kVec unless kVec is 1).
template <int kVec>
__device__ __forceinline__ void load_chunk(uint32_t (&q)[4], const uint8_t* p, int valid) {
  if constexpr (kVec == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    q[0] = v.x, q[1] = v.y, q[2] = v.z, q[3] = v.w;
  } else if constexpr (kVec == 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint2 v = i * 8 < valid ? __ldg(reinterpret_cast<const uint2*>(p) + i) : uint2{0, 0};
      q[2 * i] = v.x, q[2 * i + 1] = v.y;
    }
  } else if constexpr (kVec == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[i] = i * 4 < valid ? __ldg(reinterpret_cast<const uint32_t*>(p) + i) : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * i + k < valid) v |= (uint32_t)__ldg(p + 4 * i + k) << (8 * k);
      q[i] = v;
    }
  }
}

template <int kVec>
__device__ __forceinline__ void store_chunk(uint8_t* p, const uint32_t (&q)[4], int valid) {
  if constexpr (kVec == 16) {
    *reinterpret_cast<uint4*>(p) = uint4{q[0], q[1], q[2], q[3]};
  } else if constexpr (kVec == 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (i * 8 < valid) reinterpret_cast<uint2*>(p)[i] = uint2{q[2 * i], q[2 * i + 1]};
  } else if constexpr (kVec == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i * 4 < valid) reinterpret_cast<uint32_t*>(p)[i] = q[i];
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < valid) p[i] = (uint8_t)(q[i / 4] >> (8 * (i % 4)));
  }
}

// LUT byte k of a packed word as an exact float: 2^23 + b, less 2^23.
__device__ __forceinline__ float lut(uint32_t word, int k) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 + k)) - kTwo23;
}

// grid: persistent, block b on rows [b*rows_per_block, ...) of the n*h rows;
// block: bx*by threads; dynamic shared memory: the table when kSmem.
template <bool kSmem, int kVec>
__global__ void __launch_bounds__(kMaxThreads, 2)
    clahe8_chunk_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ tab,
                        const float* __restrict__ ya, const float* __restrict__ xa,
                        uint8_t* __restrict__ out, int h, int w, int tile_h, int tile_w,
                        int rx_n, int tab_words, int bx, int by, long long rows,
                        long long rows_per_block) {
  extern __shared__ int32_t stab[];
  const int tx = threadIdx.x % bx, ty = threadIdx.x / bx;
  const int thh = tile_h / 2, twh = tile_w / 2;
  const int chunks = (w + kChunk - 1) / kChunk;
  const long long r1 = min(rows, (blockIdx.x + 1) * rows_per_block);
  for (long long r = blockIdx.x * rows_per_block; r < r1;) {
    // one frame's rows [ys, ye) of the block's run
    const int f = (int)(r / h);
    const int ys = (int)(r - (long long)f * h);
    const int ye = (int)min((long long)h, r1 - (long long)f * h);
    r = (long long)f * h + ye;
    const int32_t* table = kSmem ? stab : tab + (size_t)f * tab_words;
    if (kSmem) {
      __syncthreads();  // every thread is done with the previous frame's table
      for (int i = threadIdx.x; i < tab_words; i += blockDim.x)
        stab[i] = __ldg(tab + (size_t)f * tab_words + i);
      __syncthreads();
    }
    for (int cc = tx; cc < chunks; cc += bx) {
      const int c0 = cc * kChunk, valid = w - c0;
      // the chunk's column table: the cell's byte offset in a table row (a
      // multiple of 1 KB), xa and 1 - xa (past the row: cell 0, fractions
      // 0, outputs not stored)
      uint32_t col[kChunk];
      float fx[kChunk], ofx[kChunk];
      int cell = (c0 + twh) / tile_w, rem = (c0 + twh) - cell * tile_w;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const bool in = j < valid;
        col[j] = in ? cell * kLutBytes : 0u;
        fx[j] = in ? __ldg(xa + c0 + twh + j) : 0.0f;
        ofx[j] = 1.0f - fx[j];
        if (++rem == tile_w) rem = 0, ++cell;
      }
      int y = ys + ty;
      if (y >= ye) continue;
      const int py0 = y + thh, cr = py0 / tile_h;
      int py = py0, crem = py0 - cr * tile_h;
      // each column's LUT as a byte offset in the frame's table, which the
      // rows change only when they cross a row of cells
      const uint32_t cells_row = (uint32_t)rx_n * kLutBytes;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) col[j] += cr * cells_row;
      const size_t step = (size_t)by * w;
      const uint8_t* src = x + ((size_t)f * h + y) * w + c0;
      uint8_t* dst = out + ((size_t)f * h + y) * w + c0;
      uint32_t cur[4];
      load_chunk<kVec>(cur, src, valid);
      for (; y < ye; y += by) {
        uint32_t nxt[4] = {0u, 0u, 0u, 0u};
        if (y + by < ye) load_chunk<kVec>(nxt, src + step, valid);
        const float fy = __ldg(ya + py);
        const float oya = 1.0f - fy;
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t q[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * i + k;
            // the byte times 4, or-ed into the LUT's 1 KB-aligned offset
            const uint32_t v4 = (k == 0 ? cur[i] << 2 : cur[i] >> (8 * k - 2)) & 0x3FCu;
            const uint32_t word = *reinterpret_cast<const uint32_t*>(
                reinterpret_cast<const char*>(table) + (col[j] | v4));
            const float t1 = lut(word, 0) * ofx[j] + lut(word, 1) * fx[j];
            const float t2 = lut(word, 2) * ofx[j] + lut(word, 3) * fx[j];
            const float res = t1 * oya + t2 * fy;
            q[k] = __float_as_uint(__fadd_rz(res + 0.5f, kTwo23));
          }
          o[i] = __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040),
                             0x5410);
        }
        store_chunk<kVec>(dst, o, valid);
        src += step;
        dst += step;
        py += by;
        for (crem += by; crem >= tile_h; crem -= tile_h) {
#pragma unroll
          for (int j = 0; j < kChunk; ++j) col[j] += cells_row;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
      }
    }
  }
}

template <bool kSmem, int kVec>
int launch(const uint8_t* x, const int32_t* tab, const float* ya, const float* xa, uint8_t* out,
           int n, int h, int w, int tile_h, int tile_w, int rx_n, int tab_words, int bx, int by,
           cudaStream_t s) {
  const int threads = bx * by;
  const size_t bytes = kSmem ? (size_t)tab_words * sizeof(int32_t) : 0;
  const void* kernel = reinterpret_cast<const void*>(clahe8_chunk_kernel<kSmem, kVec>);
  long long blocks;
  const cudaError_t e = resident_blocks(kernel, threads, bytes, &blocks);
  if (e != cudaSuccess) return (int)e;
  // whole bands of by rows a block, at most one block per band
  const long long rows = (long long)n * h, bands = (rows + by - 1) / by;
  if (blocks > bands) blocks = bands;
  const long long per_block = (bands + blocks - 1) / blocks * by;
  blocks = (rows + per_block - 1) / per_block;
  clahe8_chunk_kernel<kSmem, kVec><<<(unsigned)blocks, threads, bytes, s>>>(
      x, tab, ya, xa, out, h, w, tile_h, tile_w, rx_n, tab_words, bx, by, rows, per_block);
  return (int)cudaGetLastError();
}

template <bool kSmem>
int launch_vec(int vec, const uint8_t* x, const int32_t* tab, const float* ya, const float* xa,
               uint8_t* out, int n, int h, int w, int tile_h, int tile_w, int rx_n,
               int tab_words, int bx, int by, cudaStream_t s) {
  switch (vec) {
    case 16:
      return launch<kSmem, 16>(x, tab, ya, xa, out, n, h, w, tile_h, tile_w, rx_n, tab_words,
                               bx, by, s);
    case 8:
      return launch<kSmem, 8>(x, tab, ya, xa, out, n, h, w, tile_h, tile_w, rx_n, tab_words,
                              bx, by, s);
    case 4:
      return launch<kSmem, 4>(x, tab, ya, xa, out, n, h, w, tile_h, tile_w, rx_n, tab_words,
                              bx, by, s);
    default:
      return launch<kSmem, 1>(x, tab, ya, xa, out, n, h, w, tile_h, tile_w, rx_n, tab_words,
                              bx, by, s);
  }
}

}  // namespace

extern "C" {

// x, out: (n, h, w) uint8; tab: (n, ry_n, rx_n*256) int32; ya: (ry_n, tile_h)
// f32; xa: (1, rx_n*tile_w) f32; all contiguous on one device, with
// ry_n*tile_h >= h + tile_h/2 and rx_n*tile_w >= w + tile_w/2.  smem: stage
// the table in shared memory (at most kSmemTableBytes); vec: 16, 8, 4 or 1,
// bytes a load or store, dividing w and the offsets of x and out; bx, by:
// the block's threads across a row (bx * 16 >= w, or 512) and its rows, at
// most kMaxThreads in all (kernels.clahe.block_shape).
int vz_clahe8_lookup(const void* x, const void* tab, const void* ya, const void* xa,
                     void* out, int n, int h, int w, int tile_h, int tile_w, int ry_n,
                     int rx_n, int smem, int vec, int bx, int by, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  const int tab_words = ry_n * rx_n * kHist;
  if ((smem && (size_t)tab_words * sizeof(int32_t) > (size_t)kSmemTableBytes) || bx < 1 ||
      by < 1 || bx * by > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* xs = (const uint8_t*)x;
  const int32_t* ts = (const int32_t*)tab;
  const float *yas = (const float*)ya, *xas = (const float*)xa;
  uint8_t* os = (uint8_t*)out;
  return smem ? launch_vec<true>(vec, xs, ts, yas, xas, os, n, h, w, tile_h, tile_w, rx_n,
                                 tab_words, bx, by, s)
              : launch_vec<false>(vec, xs, ts, yas, xas, os, n, h, w, tile_h, tile_w, rx_n,
                                  tab_words, bx, by, s);
}

}  // extern "C"
