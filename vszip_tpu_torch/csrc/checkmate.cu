// Checkmate's dot-crawl reducer for Hopper (sm_90a), the CUDA counterpart of
//   checkmate_kernel  B15 checkmate_pallas  (vszip_tpu/kernels/checkmate_pallas.py)
// For every pixel (y, x) of rows 2..h-3 of frame n (reference
// src/filters/checkmate.zig), with xl = max(x-2, 0), xr = min(x+2, w-1) and
// frames n+-1, n+-2 clamped to the clip:
//   cur_col    = c[y-2,x] + 2 c[y,x] + c[y+2,x]
//   curr_value = -c[y-2,xl] - c[y-2,xr] + 2 c[y,xl] + 2 c[y,xr]
//                - c[y+2,xl] - c[y+2,xr] + 2 cur_col + 12 c[y,x]
//   nw, pw     = min(clamp(thr + tmax - |col121(n+-1) - cur_col|, 0, tmax+1)
//                    * (8192 / tmax), 8192),   cw = 16384 - nw - pw
//   out        = clamp((cw * trunc(curr_value / 10) + pw (c + p1) + nw (c + n1)) >> 15,
//                      0, 255)
// and with tthr2 > 0 the temporal smooth (p1 + 2c + n1) >> 2 where
// |p1 - n1|, |p2 - c| and |c - n2| are all below tthr2.  Rows 0, 1, h-2 and
// h-1 pass through.  C's integer division truncates toward zero, as the
// reference's @divTrunc; the TPU kernel divides in f32 instead.
//
// The TPU kernel loads 64-row bands of five frames with 8-row halos through
// clamped block index maps.  Here one thread computes one pixel: the clamped
// frame and column indices are arithmetic, and the 5x5 neighbourhood (nine
// bytes of frame n, three each of n+-1, one each of n+-2) comes through L1,
// where the block's neighbours share it.  What bounds it: one u8 read and
// one u8 write per pixel (398 MB for 64 frames of 1080p YUV420P8, 0.119 ms
// at 3.35 TB/s) when each frame's rows stay in L2 between the blocks that
// read them, and the integer operations as the card issues them (multiply-
// adds and 3-input adds fused): about 21 per pixel on the ALU pipe and 17
// that the FMA pipe can take, 64 per SM per clock each, which outweigh the
// bytes.  The fifteen byte loads per pixel come on top.
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ int col121(const uint8_t* p, size_t y, int w, int x) {
  return p[(y - 2) * w + x] + 2 * p[y * w + x] + p[(y + 2) * w + x];
}

template <bool kTthr2>
__global__ void __launch_bounds__(kThreads)
    checkmate_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, int n, int h,
                     int w, int thr, int tmax, int tthr2) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t plane = (size_t)h * w;
  const int tmax_mult = 8192 / tmax;
  for (int f = blockIdx.z; f < n; f += gridDim.z) {
    const uint8_t* c = src + f * plane;
    const size_t at = (size_t)y * w + x;
    if (y < 2 || y >= h - 2) {
      out[f * plane + at] = c[at];
      continue;
    }
    const uint8_t* p1 = src + (size_t)max(f - 1, 0) * plane;
    const uint8_t* n1 = src + (size_t)min(f + 1, n - 1) * plane;
    const int cv = c[at], pv = p1[at], nv = n1[at];
    if (kTthr2) {
      const int p2 = src[(size_t)max(f - 2, 0) * plane + at];
      const int n2 = src[(size_t)min(f + 2, n - 1) * plane + at];
      if (abs(pv - nv) < tthr2 && abs(p2 - cv) < tthr2 && abs(cv - n2) < tthr2) {
        out[f * plane + at] = (uint8_t)((pv + 2 * cv + nv) >> 2);
        continue;
      }
    }
    const int xl = max(x - 2, 0), xr = min(x + 2, w - 1);
    const size_t up = (size_t)(y - 2) * w, mid = (size_t)y * w, dn = (size_t)(y + 2) * w;
    const int cur_col = c[up + x] + 2 * cv + c[dn + x];
    const int curr_value = -c[up + xl] - c[up + xr] + 2 * c[mid + xl] + 2 * c[mid + xr] -
                           c[dn + xl] - c[dn + xr] + 2 * cur_col + 12 * cv;
    const int nc = thr + tmax - abs(col121(n1, y, w, x) - cur_col);
    const int pc = thr + tmax - abs(col121(p1, y, w, x) - cur_col);
    const int nw = min(min(max(nc, 0), tmax + 1) * tmax_mult, 8192);
    const int pw = min(min(max(pc, 0), tmax + 1) * tmax_mult, 8192);
    const int cw = (1 << 14) - (nw + pw);
    const int res = (cw * (curr_value / 10) + pw * (cv + pv) + nw * (cv + nv)) >> 15;
    out[f * plane + at] = (uint8_t)min(max(res, 0), 255);
  }
}

}  // namespace

extern "C" {

// src, out: (n, h, w) uint8, contiguous, on one device; h >= 5, 1 <= tmax.
int vz_checkmate(const void* src, void* out, int n, int h, int w, int thr, int tmax, int tthr2,
                 void* stream) {
  if (n == 0 || w == 0) return 0;
  const dim3 grid((w + kThreads - 1) / kThreads, h, n < kMaxGridZ ? n : kMaxGridZ);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* x = (const uint8_t*)src;
  uint8_t* o = (uint8_t*)out;
  if (tthr2 > 0) {
    checkmate_kernel<true><<<grid, kThreads, 0, s>>>(x, o, n, h, w, thr, tmax, tthr2);
  } else {
    checkmate_kernel<false><<<grid, kThreads, 0, s>>>(x, o, n, h, w, thr, tmax, tthr2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
