// XPSNR's per-block statistics for Hopper (sm_90a), the CUDA counterparts of
// the Pallas kernels
//   block_stats_kernel<T, true>   B11 luma_stats_pallas  (vszip_tpu/kernels/xpsnr_pallas.py)
//   block_stats_kernel<T, false>  B12 chroma_sse_pallas  (vszip_tpu/kernels/xpsnr_pallas.py)
// Per (by x bx) block of a plane (64x64 on luma), exact integer sums of
//   sse = sum (org - rec)^2                       over the block's pixels
//   sa  = sum |12c - 2(l+r+u+d) - (ul+ur+dl+dr)|  over the pixels 1..h-2, 1..w-2
//   ta  = sum |org[i] - org[i-1]|                 (order 1), or
//         sum |org[i] - 2 org[i-1] + org[i-2]|    (order 2), missing frames 0
// (src/filters/xpsnr.zig:214-347); the chroma entry computes sse only.
//
// The TPU kernel splits column sums into 12-bit limbs and reduces them with
// block-indicator f32 matmuls, because the TPU has no 64-bit lanes.  Here the
// maps are int32 and the sums int64: one thread block per output block and
// frame, 256 threads as 64 columns x 4 rows (coalesced 128-byte row reads of
// u16), each thread summing its pixels into int64 registers, then a warp
// shuffle and a shared-memory reduction.  No atomics; integer sums are exact
// in any order, so the result equals the plain torch version bit for bit.
//
// What bounds it is device-memory bytes: org and rec read once (the 3x3 and
// temporal neighbours come from L1/L2), three int64 per block written.
// About 18 integer operations per luma pixel (sse 3, Laplacian 12, temporal
// 3), 3 per chroma pixel.
//
// Plain C interface, loaded with ctypes.  The entries launch on the given
// stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;
constexpr int kRows = 4;
constexpr int kThreads = kCols * kRows;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums of `kSums` per-thread values over the block; thread 0 gets them.
template <int kSums>
__device__ __forceinline__ void block_sum(long long (&v)[kSums]) {
  __shared__ long long part[kSums][kWarps];
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int s = 0; s < kSums; ++s) {
    v[s] = warp_sum(v[s]);
    if (lane == 0) part[s][warp] = v[s];
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kSums; ++s) {
      long long t = 0;
      for (int k = 0; k < kWarps; ++k) t += part[s][k];
      v[s] = t;
    }
  }
}

// grid (nbw, nbh, n), block (64, 4).  out: kLuma ? (3, n, nbh, nbw) : (n, nbh, nbw)
// int64.
template <typename T, bool kLuma>
__global__ void __launch_bounds__(kThreads)
    block_stats_kernel(const T* __restrict__ org, const T* __restrict__ rec,
                       long long* __restrict__ out, int n, int h, int w, int by, int bx,
                       int order, int temporal) {
  const int i = blockIdx.z;
  const int nbh = gridDim.y, nbw = gridDim.x;
  const size_t plane = (size_t)h * w;
  const T* o = org + (size_t)i * plane;
  const T* r = rec + (size_t)i * plane;
  const T* p1 = (kLuma && i >= 1) ? o - plane : nullptr;
  const T* p2 = (kLuma && i >= 2) ? o - 2 * plane : nullptr;
  const int y0 = blockIdx.y * by, x0 = blockIdx.x * bx;
  const int y1 = min(h, y0 + by), x1 = min(w, x0 + bx);
  long long v[kLuma ? 3 : 1] = {};
  for (int y = y0 + threadIdx.y; y < y1; y += kRows) {
    const size_t row = (size_t)y * w;
    const bool inner_y = y >= 1 && y < h - 1;
    for (int x = x0 + threadIdx.x; x < x1; x += kCols) {
      const int c = (int)o[row + x];
      const int d = c - (int)r[row + x];
      v[0] += (long long)d * d;
      if constexpr (kLuma) {
        if (inner_y && x >= 1 && x < w - 1) {
          const T* up = o + row - w + x;
          const T* mid = o + row + x;
          const T* dn = o + row + w + x;
          const int f = 12 * c - 2 * ((int)mid[-1] + (int)mid[1] + (int)up[0] + (int)dn[0]) -
                        ((int)up[-1] + (int)up[1] + (int)dn[-1] + (int)dn[1]);
          v[1] += f < 0 ? -f : f;
        }
        if (temporal) {
          const int a = p1 ? (int)p1[row + x] : 0;
          int t = c - (order == 1 ? a : 2 * a);
          if (order == 2) t += p2 ? (int)p2[row + x] : 0;
          v[2] += t < 0 ? -t : t;
        }
      }
    }
  }
  block_sum(v);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const size_t blk = ((size_t)i * nbh + blockIdx.y) * nbw + blockIdx.x;
    out[blk] = v[0];
    if constexpr (kLuma) {
      const size_t stride = (size_t)n * nbh * nbw;
      out[stride + blk] = v[1];
      out[2 * stride + blk] = v[2];
    }
  }
}

template <bool kLuma>
int launch(const void* org, const void* rec, void* out, int n, int h, int w, int elem_bytes,
           int by, int bx, int order, int temporal, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  const dim3 grid((w + bx - 1) / bx, (h + by - 1) / by, n);
  const dim3 block(kCols, kRows);
  cudaStream_t s = (cudaStream_t)stream;
  long long* os = (long long*)out;
  if (elem_bytes == 1)
    block_stats_kernel<uint8_t, kLuma><<<grid, block, 0, s>>>(
        (const uint8_t*)org, (const uint8_t*)rec, os, n, h, w, by, bx, order, temporal);
  else
    block_stats_kernel<uint16_t, kLuma><<<grid, block, 0, s>>>(
        (const uint16_t*)org, (const uint16_t*)rec, os, n, h, w, by, bx, order, temporal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// org, rec: (n, h, w) uint8 (elem_bytes 1) or uint16 (2), contiguous; out:
// (3, n, ceil(h/64), ceil(w/64)) int64 [sse, sa, ta]; order 1 or 2; ta is 0
// when temporal is 0.
int vz_xpsnr_luma_stats(const void* org, const void* rec, void* out, int n, int h, int w,
                        int elem_bytes, int order, int temporal, void* stream) {
  return launch<true>(org, rec, out, n, h, w, elem_bytes, 64, 64, order, temporal, stream);
}

// org, rec: (n, h, w) uint8/uint16 as above; out: (n, ceil(h/by), ceil(w/bx))
// int64 per-block SSE.
int vz_xpsnr_chroma_sse(const void* org, const void* rec, void* out, int n, int h, int w,
                        int elem_bytes, int by, int bx, void* stream) {
  return launch<false>(org, rec, out, n, h, w, elem_bytes, by, bx, 1, 0, stream);
}

}  // extern "C"
