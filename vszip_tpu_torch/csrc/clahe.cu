// CLAHE's 8-bit lookup and bilinear blend for Hopper (sm_90a), the CUDA
// counterpart of the Pallas kernel
//   clahe8_kernel  B7 clahe8_lookup_pallas  (vszip_tpu/kernels/clahe_pallas.py)
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
// (nothing outside it is read) and the lookup is one shared-memory load:
// each block stages its frame's table (16 cells x 1 KB at 3x3 tiles) in
// shared memory, then walks a band of rows, one thread per output byte.
// Tables too large for shared memory are read through the read-only cache.
//
// What bounds it is device-memory bytes: one u8 read and one u8 write per
// sample (the table is read once per block, from L2 after its first block);
// about 15 f32/int operations per sample.
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHist = 256;
// Tables up to this size are staged in shared memory.
constexpr int kSmemTableBytes = 96 * 1024;

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
    clahe8_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ tab,
                  const float* __restrict__ ya, const float* __restrict__ xa,
                  uint8_t* __restrict__ out, int h, int w, int tile_h, int tile_w,
                  int rx_n, int tab_words, int rows_per_block) {
  extern __shared__ int32_t stab[];
  const int n = blockIdx.y;
  const int32_t* t = tab + (size_t)n * tab_words;
  if (kSmem) {
    for (int i = threadIdx.x; i < tab_words; i += kThreads) stab[i] = t[i];
    __syncthreads();
  }
  const int32_t* table = kSmem ? stab : t;
  const int thh = tile_h / 2, twh = tile_w / 2;
  const int y0 = blockIdx.x * rows_per_block;
  const int y1 = min(h, y0 + rows_per_block);
  for (int y = y0; y < y1; ++y) {
    const int py = y + thh;
    const int cell_row = (py / tile_h) * rx_n;
    const float fy = ya[py];
    const float oya = 1.0f - fy;
    const size_t row = ((size_t)n * h + y) * w;
    for (int c = threadIdx.x; c < w; c += kThreads) {
      const int px = c + twh;
      const float fx = xa[px];
      const int32_t word = table[(cell_row + px / tile_w) * kHist + x[row + c]];
      const float l0 = (float)(word & 255);
      const float l1 = (float)((word >> 8) & 255);
      const float l2 = (float)((word >> 16) & 255);
      const float l3 = (float)((word >> 24) & 255);
      const float oxa = 1.0f - fx;
      const float t1 = l0 * oxa + l1 * fx;
      const float t2 = l2 * oxa + l3 * fx;
      const float res = t1 * oya + t2 * fy;
      out[row + c] = (uint8_t)(int)truncf(res + 0.5f);
    }
  }
}

}  // namespace

extern "C" {

// x, out: (n, h, w) uint8; tab: (n, ry_n, rx_n*256) int32; ya: (ry_n, tile_h)
// f32; xa: (1, rx_n*tile_w) f32; all contiguous on one device, with
// ry_n*tile_h >= h + tile_h/2 and rx_n*tile_w >= w + tile_w/2.
int vz_clahe8_lookup(const void* x, const void* tab, const void* ya, const void* xa,
                     void* out, int n, int h, int w, int tile_h, int tile_w, int ry_n,
                     int rx_n, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  const int tab_words = ry_n * rx_n * kHist;
  const size_t tab_bytes = (size_t)tab_words * sizeof(int32_t);
  // enough rows per block that the pixels outweigh the staged table 4:1
  int rows = (int)((4 * tab_bytes + w - 1) / w);
  rows = rows < 8 ? 8 : (rows > h ? h : rows);
  const dim3 grid((h + rows - 1) / rows, n);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* xs = (const uint8_t*)x;
  const int32_t* ts = (const int32_t*)tab;
  const float *yas = (const float*)ya, *xas = (const float*)xa;
  uint8_t* os = (uint8_t*)out;
  if (tab_bytes <= (size_t)kSmemTableBytes) {
    cudaFuncSetAttribute(clahe8_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemTableBytes);
    clahe8_kernel<true><<<grid, kThreads, tab_bytes, s>>>(xs, ts, yas, xas, os, h, w, tile_h,
                                                         tile_w, rx_n, tab_words, rows);
  } else {
    clahe8_kernel<false><<<grid, kThreads, 0, s>>>(xs, ts, yas, xas, os, h, w, tile_h,
                                                  tile_w, rx_n, tab_words, rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
