// BoxBlur integer kernels for Hopper (sm_90a), the CUDA counterparts of the
// Pallas kernels in vszip_tpu/kernels/boxblur_pallas.py.
//
// Three kernels, each exact to the reference's integer arithmetic:
//   v_fixed     runtime vertical fixed-point pass(es)      (B3 rt_blur_v_multi_pallas,
//                                                           B4 rt_blur_v_pallas)
//   h_fixed     runtime horizontal fixed-point pass(es)    (B2 rt_blur_h_pallas, and
//                                                           the H stage of B1)
//   ct_v_quant  comptime vertical column sums, quantised   (V stage of B1
//                                                           ct_blur_int_pallas)
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
// int32/int64 arithmetic.
//
// Plain C interface, loaded with ctypes.  Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;        // rows loaded ahead per step of a column walk
constexpr int kColThreads = 128; // threads per block of a column kernel
constexpr int kMaxGridY = 65535;
// h_fixed: the most dynamic shared memory a Hopper block may take, and the
// grid of the global-scratch variant (4 warps per block, 2 blocks per SM)
constexpr size_t kMaxSmemBytes = 232448;
constexpr int kScratchWarps = 4;
constexpr long long kScratchBlocks = 264;

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

__device__ __forceinline__ int mirror_hybrid(int y, int off, int n) {
  const int k = y + off;
  if (k < 0) return min(-k, n - 1);
  if (k > n - 1) return max(n - 1 - off, 0);
  return k;
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

// One warp per row.  Each pass builds the exclusive prefix sum P of the
// mirror-padded row (w + 2r values) in shared memory with warp scans, then
// W(x) = P[x+2r+1] - P[x] and the fixed-point output.  P is uint32 and wraps;
// a difference is exact while the window sum stays below 2^32, which the
// wrapper guarantees (r < 32768).  Passes after the first read the previous
// pass's row from `xs` in shared memory, so all passes cost one read and one
// write of device memory.  A row too long for shared memory (kGlobal) keeps
// P and xs in the global buffer `gscratch` instead, one slice per warp of
// the grid; the arithmetic is the same.  The variants are separate
// instantiations so that the shared one keeps its shared-memory loads.
template <typename T, bool kGlobal>
__global__ void h_fixed_kernel(const T* in, T* out, long long rows, int w, int r,
                               int passes, long long inv, long long inv2,
                               uint32_t* gscratch) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int padded = w + 2 * r;
  const int per_warp = padded + 1 + (passes > 1 ? w : 0);
  uint32_t* P = kGlobal ? gscratch + ((size_t)blockIdx.x * warps + warp) * per_warp
                       : smem + (size_t)warp * per_warp;
  uint32_t* xs = P + padded + 1;
  for (long long row = (long long)blockIdx.x * warps + warp; row < rows;
       row += (long long)gridDim.x * warps) {
    const T* src = in + row * w;
    for (int p = 0; p < passes; ++p) {
      uint32_t carry = 0;
      for (int q0 = 0; q0 < padded; q0 += 32) {
        const int q = q0 + lane;
        uint32_t v = 0;
        if (q < padded) {
          const int m = r <= w ? mirror_dup(q - r, w) : mirror_periodic(q - r, w);
          v = p == 0 ? (uint32_t)src[m] : xs[m];
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t t = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += t;
        }
        if (q < padded) P[q + 1] = carry + v;
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
      if (lane == 0) P[0] = 0;
      __syncwarp();
      const uint32_t w0 = P[2 * r + 1] - P[0];
      const long long c0 = fixed_c0(w0, inv);
      const bool last = p == passes - 1;
      for (int x = lane; x < w; x += 32) {
        const uint32_t wx = P[x + 2 * r + 1] - P[x];
        const T o = (T)fixed_out(c0, inv2, (long long)wx - (long long)w0);
        if (last) {
          out[row * w + x] = o;
        } else {
          xs[x] = o;
        }
      }
      __syncwarp();
    }
  }
}

// One thread per column: the comptime path's raw vertical window sums under
// the hybrid mirror, quantised to the plane's type.  Edge rows (r at the
// top, r at the bottom) sum their 2r+1 taps directly; the interior runs a
// sliding sum, loaded kChunk rows ahead.
template <typename T>
__global__ void ct_v_quant_kernel(const T* in, T* out, int n, int h, int w,
                                  int r) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int k2 = 2 * (2 * r + 1);
  const long long ws = w;
  for (int f = blockIdx.y; f < n; f += gridDim.y) {
    const long long base = (long long)f * h * w + x;
    const T* src = in + base;
    T* dst = out + base;
    int col = 0;
    for (int y = 0; y <= r; ++y) {
      col = 0;
      for (int o = -r; o <= r; ++o) col += src[mirror_hybrid(y, o, h) * ws];
      dst[y * ws] = (T)((2 * col + k2 / 2) / k2);
    }
    const int end = h - r;  // interior rows r+1 .. h-r-1 slide
    for (int y0 = r + 1; y0 < end; y0 += kChunk) {
      int lead[kChunk], trail[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int y = y0 + j;
        if (y < end) {
          lead[j] = src[(y + r) * ws];
          trail[j] = src[(y - r - 1) * ws];
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int y = y0 + j;
        if (y < end) {
          col += lead[j] - trail[j];
          dst[y * ws] = (T)((2 * col + k2 / 2) / k2);
        }
      }
    }
    for (int y = end; y < h; ++y) {
      col = 0;
      for (int o = -r; o <= r; ++o) col += src[mirror_hybrid(y, o, h) * ws];
      dst[y * ws] = (T)((2 * col + k2 / 2) / k2);
    }
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

size_t h_fixed_words_per_warp(int w, int r, int passes) {
  return (size_t)w + 2 * r + 1 + (passes > 1 ? w : 0);
}

// Words of global scratch h_fixed needs for these rows: 0 when one warp's
// row fits in a block's shared memory (the path every row took before the
// scratch existed), else one slice per warp of a grid of kScratchBlocks.
long long h_fixed_scratch_words(long long rows, int w, int r, int passes) {
  const size_t per_warp = h_fixed_words_per_warp(w, r, passes);
  if (per_warp * sizeof(uint32_t) <= kMaxSmemBytes) return 0;
  long long blocks = (rows + kScratchWarps - 1) / kScratchWarps;
  if (blocks > kScratchBlocks) blocks = kScratchBlocks;
  return blocks * kScratchWarps * (long long)per_warp;
}

template <typename T>
int launch_h_fixed(const void* in, void* out, void* scratch, long long rows, int w,
                   int r, int passes, cudaStream_t s) {
  long long inv, inv2;
  fixed_constants(r, &inv, &inv2);
  if (h_fixed_scratch_words(rows, w, r, passes) > 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    long long blocks = (rows + kScratchWarps - 1) / kScratchWarps;
    if (blocks > kScratchBlocks) blocks = kScratchBlocks;
    h_fixed_kernel<T, true><<<(unsigned)blocks, 32 * kScratchWarps, 0, s>>>(
        (const T*)in, (T*)out, rows, w, r, passes, inv, inv2, (uint32_t*)scratch);
    return (int)cudaGetLastError();
  }
  const size_t per_warp = h_fixed_words_per_warp(w, r, passes) * sizeof(uint32_t);
  int warps = 4;
  while (warps > 1 && per_warp * warps > 200 * 1024) --warps;
  const size_t bytes = per_warp * warps;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        h_fixed_kernel<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (rows + warps - 1) / warps;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  h_fixed_kernel<T, false><<<(unsigned)blocks, 32 * warps, bytes, s>>>(
      (const T*)in, (T*)out, rows, w, r, passes, inv, inv2, nullptr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ct_v_quant(const void* in, void* out, int n, int h, int w, int r,
                      cudaStream_t s) {
  ct_v_quant_kernel<T><<<column_grid(n, w), kColThreads, 0, s>>>(
      (const T*)in, (T*)out, n, h, w, r);
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

// The uint32 words of scratch vz_h_fixed needs (0: none; pass null).
long long vz_h_fixed_scratch_words(long long rows, int w, int r, int passes) {
  return h_fixed_scratch_words(rows, w, r, passes);
}

int vz_h_fixed(const void* in, void* out, void* scratch, int elem_bytes, long long rows,
               int w, int r, int passes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return elem_bytes == 1
             ? launch_h_fixed<uint8_t>(in, out, scratch, rows, w, r, passes, s)
             : launch_h_fixed<uint16_t>(in, out, scratch, rows, w, r, passes, s);
}

int vz_ct_v_quant(const void* in, void* out, int elem_bytes, int n, int h, int w,
                  int r, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return elem_bytes == 1
             ? launch_ct_v_quant<uint8_t>(in, out, n, h, w, r, s)
             : launch_ct_v_quant<uint16_t>(in, out, n, h, w, r, s);
}

}  // extern "C"
