// CombMask's comb detector for Hopper (sm_90a), the CUDA counterpart of
//   comb_mask_kernel  B16 comb_mask_pallas  (vszip_tpu/kernels/comb_mask_pallas.py)
// For every pixel (y, x) of frame n (reference src/filters/comb_mask.zig),
// rows y+-1 and y+-2 mirrored reflect-101 (row -k is row k):
//   metric 0: (c-up > t and c-dn > t) or (c-up < -t and c-dn < -t),
//             and |up2 + 4c + dn2 - 3(up + dn)| > 6t
//   metric 1: (up - c)(dn - c) > t
// With mthresh > 0 the mask is ANDed with |c - prev| > mthresh (prev: frame
// n-1, frame 0 compared with itself) dilated by one row: a zero row above
// the top, the bottom row clamped.  Then, with expand, the horizontal 3-tap
// dilation with the reference's quirks: column 0 is m[0] | m[1], the last
// column keeps its value, a plane under 2 columns is left as it is.
//
// The TPU kernel loads 64-row bands with 8-row halos (and the previous
// frame's) and patches the mirrored rows with global-row selects.  Here a
// 256-thread block takes 254 columns of one row of one frame: each thread
// computes the mask after the motion AND of one column, those 254 and one
// more on each side, into shared memory (taps through L1, mirrored and
// clamped by index arithmetic), then the inner 254 threads expand from
// there, so any width runs, 1 included.
// What bounds it: one u8 read and one u8 write per pixel (398 MB for 64
// frames of 1080p YUV420P8, 0.119 ms at 3.35 TB/s) when the rows stay in L2
// between the blocks that read them: the integer operations as the card
// issues them (about 7 per pixel on the ALU pipe and 2 on either pipe, the
// 5-tap check and the motion test only where the comb metric needs them)
// stay under the bytes.  The taps are byte loads, several per pixel; wider
// words are the first thing to try when it is made faster.
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = kThreads - 2;  // output columns per block; one more each side
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ int reflect101(int k, int h) {
  return k < 0 ? -k : (k > h - 1 ? 2 * (h - 1) - k : k);
}

// The mask of pixel (y, x) before the expand: 0 or 1.
template <bool kMetric1, bool kMotion>
__device__ __forceinline__ int mask_at(const uint8_t* cur, const uint8_t* prev, int y, int x,
                                       int h, int w, int cthresh, int mthresh) {
  const int c = cur[(size_t)y * w + x];
  const int up = cur[(size_t)reflect101(y - 1, h) * w + x];
  const int dn = cur[(size_t)reflect101(y + 1, h) * w + x];
  int m;
  if (kMetric1) {
    m = (up - c) * (dn - c) > cthresh;
  } else {
    const int d1 = c - up, d2 = c - dn;
    const bool pred = (d1 > cthresh && d2 > cthresh) || (d1 < -cthresh && d2 < -cthresh);
    const int up2 = cur[(size_t)reflect101(y - 2, h) * w + x];
    const int dn2 = cur[(size_t)reflect101(y + 2, h) * w + x];
    m = pred && abs((up2 + 4 * c + dn2) - 3 * (up + dn)) > 6 * cthresh;
  }
  if (kMotion && m) {
    const size_t at = (size_t)y * w + x;
    const size_t below = (size_t)min(y + 1, h - 1) * w + x;
    bool moved = abs(c - (int)prev[at]) > mthresh ||
                 abs((int)cur[below] - (int)prev[below]) > mthresh;
    if (y > 0) {
      const size_t above = at - w;
      moved = moved || abs((int)cur[above] - (int)prev[above]) > mthresh;
    }
    m = moved;
  }
  return m;
}

template <bool kMetric1, bool kMotion>
__global__ void __launch_bounds__(kThreads)
    comb_mask_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ out, int n, int h,
                     int w, int cthresh, int mthresh, bool expand) {
  __shared__ uint8_t m[kThreads];
  const int i = threadIdx.x;
  const int x = blockIdx.x * kCols - 1 + i;  // this thread's column
  const int y = blockIdx.y;
  const size_t plane = (size_t)h * w;
  for (int f = blockIdx.z; f < n; f += gridDim.z) {
    const uint8_t* cur = src + f * plane;
    const uint8_t* prev = src + (size_t)max(f - 1, 0) * plane;
    m[i] = (x >= 0 && x < w)
               ? mask_at<kMetric1, kMotion>(cur, prev, y, x, h, w, cthresh, mthresh)
               : 0;
    __syncthreads();
    if (i > 0 && i < kThreads - 1 && x < w) {
      int v = m[i];
      if (expand && w >= 2 && x < w - 1) v = (x > 0 ? m[i - 1] : 0) | v | m[i + 1];
      out[f * plane + (size_t)y * w + x] = (uint8_t)(v ? 255 : 0);
    }
    __syncthreads();
  }
}

template <bool kMetric1, bool kMotion>
void launch(const uint8_t* x, uint8_t* o, int n, int h, int w, int cthresh, int mthresh,
            bool expand, cudaStream_t s) {
  const dim3 grid((w + kCols - 1) / kCols, h, n < kMaxGridZ ? n : kMaxGridZ);
  comb_mask_kernel<kMetric1, kMotion><<<grid, kThreads, 0, s>>>(x, o, n, h, w, cthresh,
                                                                mthresh, expand);
}

}  // namespace

extern "C" {

// src, out: (n, h, w) uint8, contiguous, on one device; h >= 3.
int vz_comb_mask(const void* src, void* out, int n, int h, int w, int cthresh, int mthresh,
                 int metric_1, int expand, void* stream) {
  if (n == 0 || w == 0) return 0;
  const uint8_t* x = (const uint8_t*)src;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const bool e = expand != 0;
  if (metric_1) {
    mthresh > 0 ? launch<true, true>(x, o, n, h, w, cthresh, mthresh, e, s)
                : launch<true, false>(x, o, n, h, w, cthresh, mthresh, e, s);
  } else {
    mthresh > 0 ? launch<false, true>(x, o, n, h, w, cthresh, mthresh, e, s)
                : launch<false, false>(x, o, n, h, w, cthresh, mthresh, e, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
