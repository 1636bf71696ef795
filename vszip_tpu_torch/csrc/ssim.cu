// SSIMULACRA2's per-scale plane statistics for Hopper (sm_90a), the CUDA
// counterpart of the Pallas kernel
//   ssim_band_kernel  B13 ssim_sums_pallas  (vszip_tpu/kernels/ssim_pallas.py)
// For one (scale, plane) pair of XYB planes im1, im2 (src/filters/
// ssimulacra2.zig:247-628): four 9-tap separable Gaussian blurs (mu1, mu2,
// im1*im2, (im1-im2)^2; vertical then horizontal), the hybrid edge rule of
// the reference blur
//   leading taps (off < 0) reflect-101:  x[-k] = x[k]  (clamped to n-1),
//   trailing taps past the end read the fixed index n-1-off (clamped to 0),
// then per pixel
//   md = mu1-mu2; num_m = 1 - md*md; s12c = s12 - mu1*mu2; core = s12c+s12c;
//   num_s = core + c2; den_s = (core + (sd - md*md)) + c2;
//   ssim = max(1 - num_m*num_s/den_s, 0);
//   d = (1+|im2-mu2|)/(1+|im1-mu1|) - 1; artifact = max(d, 0); detail = max(-d, 0)
// and the 1- and 4-norm ((m*m)*(m*m)) sums of the three maps.
//
// Design: one block per (frame, band of b rows, strip of columns), b/8
// warps.  Warp g owns rows 8g .. 8g+7 of the band and all of the strip: its
// lane i owns kCols adjacent columns of a 32*kCols-column tile (the strip
// and 4 halo columns on each side).  The warp walks its rows down with the
// last 9 rows of im1 and im2 of its columns in registers (8-byte loads
// where rows are 8-byte aligned, the next row loaded while this one
// computes), so each input element is loaded once per warp plus the 8
// halo rows of its chunk.  For each row it forms the four vertical sums of
// its columns, trades them with its neighbours through a per-warp
// shared-memory row (no block barrier), runs the horizontal pass, forms the
// maps and leaves the SSIM map and the signed error d in a shared band
// buffer.  After one block barrier, one thread per (pair of sums, column)
// adds the band's rows in row order into the six f32 partials of (N, nbh,
// 6, W), which the wrapper folds in f64 with one torch sum.
//
// The edge rule stays off the interior: a warp whose rows are all at least
// 4 from the plane's top and bottom slides its window at fixed offsets;
// the others (rows 0-3 and the last 4) read each tap's row by tap_index.
// A block whose strip is at least 4 from the left and right edges runs
// the horizontal taps at fixed offsets; the first and last strips index
// them by tap_index.  Every tap lies in [max(0, j-4), min(n-1, j+4)], so
// the tile and the rows a warp loads hold it.
//
// Variants, chosen by the launcher (lane_columns below; a caller may force
// one): kCols = 2 (56 output columns a block, three blocks an SM) where
// that grid gives every SM seven blocks, kCols = 1 (24 columns, 2.3x the
// blocks and under half a warp's serial work, four blocks an SM) on the
// small scales; 8-byte loads (`vec`) only at kCols = 2, where W is even
// and both planes start on 8 bytes.  Four columns a lane (120 a block) needed 128 registers, spilled,
// held two blocks an SM and ran slower.
//
// Exactness.  Each pass is acc = K0*x0; acc = acc + Kk*xk in tap order,
// every product and sum rounded on its own (-fmad=false), the maps in the
// order above with IEEE division, each band column's partial the map summed
// over the band's rows in row order from -0.0 (the identity, so the first
// row's value comes through as the plain version's `acc = row0` gives it,
// -0.0 included) and, in a band cut short by the plane, one more + 0.0 for
// the plain version's zero rows.  So the partials equal the plain torch
// version's bit for bit.
//
// Bound: about 173 f32 instructions a pixel (4 sources x 2 passes x 17, the
// maps and norms) against 8 bytes; the operations bound it.  The design
// adds the products im1*im2 and (im1-im2)^2 formed per tap (27 a pixel),
// the window's shift, the halo columns' vertical pass (14% at kCols = 2)
// and the in-order sums' loads.
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 4;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kWarpRows = 8;  // rows of its band a warp walks
constexpr int kMaxThreads = 32 * 64 / kWarpRows;
// 2 columns a lane from 7 blocks an SM: on an H100 the variants cross
// between 6.8 and 8.2 (tools/kernel_spans.py ssim, 270x480 planes)
constexpr int kWideBlocksPerSm = 7;

__constant__ float kK[kTaps] = {
    0.0076144188642501831054687500f, 0.0360749699175357818603515625f,
    0.1095860823988914489746093750f, 0.2134445458650588989257812500f,
    0.2665599882602691650390625000f, 0.2134445458650588989257812500f,
    0.1095860823988914489746093750f, 0.0360749699175357818603515625f,
    0.0076144188642501831054687500f};

// Source index of tap `off` at output position j of a line of n samples.
__device__ __forceinline__ int tap_index(int j, int off, int n) {
  const int i = j + off;
  if (off < 0 && i < 0) return min(-i, n - 1);
  if (off > 0 && i > n - 1) return max(n - 1 - off, 0);
  return i;
}

template <int kCols>
__host__ __device__ constexpr int strip_cols() {
  return 32 * kCols - 2 * kRadius;
}

// Columns col .. col+kCols-1 of `row` (0 outside [0, w)); `vec`: one
// 4*kCols-byte load, all in range and aligned.
template <int kCols>
__device__ __forceinline__ void load_cols(float (&v)[kCols], const float* row, int col, int w,
                                          bool vec) {
  if constexpr (kCols == 2) {
    if (vec) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(row + col));
      v[0] = t.x;
      v[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = col + j;
    v[j] = c >= 0 && c < w ? __ldg(row + c) : 0.f;
  }
}

// One tap of the four vertical sums: sources p, q, p*q and (p-q)^2.
template <bool kSsim, int kCols>
__device__ __forceinline__ void vtap(float (&acc)[4][kCols], const float (&p)[kCols],
                                     const float (&q)[kCols], int k) {
  const float kk = kK[k];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float tp = kk * p[j], tq = kk * q[j];
    acc[0][j] = k ? acc[0][j] + tp : tp;
    acc[1][j] = k ? acc[1][j] + tq : tq;
    if (kSsim) {
      const float d = p[j] - q[j];
      const float tpq = kk * (p[j] * q[j]), tdd = kk * (d * d);
      acc[2][j] = k ? acc[2][j] + tpq : tpq;
      acc[3][j] = k ? acc[3][j] + tdd : tdd;
    }
  }
}

struct Band {
  float* maps;      // [maps][b][strip]: the SSIM map, then the signed error d
  float* vrow;      // this warp's [4][32*kCols] vertical sums of the current row
  int b, c0, w, lane, tc;
  bool edge_strip;  // the strip is within 4 columns of a plane edge
};

// The horizontal pass of row r of the band (its vertical sums v, the
// centre samples pc, qc of this lane's columns) and its maps into the band
// buffer.
template <bool kSsim, bool kErr, int kCols>
__device__ __forceinline__ void row_maps(const Band& B, int r, const float (&v)[4][kCols],
                                         const float (&pc)[kCols], const float (&qc)[kCols]) {
  constexpr int kTile = 32 * kCols, kStrip = strip_cols<kCols>();
  constexpr int kSrc = kSsim ? 4 : 2;
#pragma unroll
  for (int s = 0; s < kSrc; ++s) {
    if constexpr (kCols == 2) {
      reinterpret_cast<float2*>(B.vrow + s * kTile)[B.lane] = make_float2(v[s][0], v[s][1]);
    } else {
      B.vrow[s * kTile + B.tc] = v[s][0];
    }
  }
  __syncwarp();
  if (B.tc >= kRadius && B.tc < kTile - kRadius) {
    float hz[4][kCols];
    if (!B.edge_strip) {
#pragma unroll
      for (int s = 0; s < kSrc; ++s) {
        float e[kCols + 2 * kRadius];
        if constexpr (kCols == 2) {
          const float2* row = reinterpret_cast<const float2*>(B.vrow + s * kTile);
#pragma unroll
          for (int i = 0; i < 5; ++i) {
            const float2 t = row[B.lane - 2 + i];
            e[2 * i] = t.x;
            e[2 * i + 1] = t.y;
          }
        } else {
#pragma unroll
          for (int i = 0; i < kCols + 2 * kRadius; ++i)
            e[i] = B.vrow[s * kTile + B.tc - kRadius + i];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float acc = kK[0] * e[j];
#pragma unroll
          for (int k = 1; k < kTaps; ++k) acc = acc + kK[k] * e[j + k];
          hz[s][j] = acc;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int x = min(B.c0 - kRadius + B.tc + j, B.w - 1);
#pragma unroll
        for (int s = 0; s < kSrc; ++s) {
          const float* row = B.vrow + s * kTile + kRadius - B.c0;
          float acc = kK[0] * row[tap_index(x, -kRadius, B.w)];
#pragma unroll
          for (int k = 1; k < kTaps; ++k) acc = acc + kK[k] * row[tap_index(x, k - kRadius, B.w)];
          hz[s][j] = acc;
        }
      }
    }
    float ms[kCols], me[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float mu1 = hz[0][j], mu2 = hz[1][j];
      if (kSsim) {
        const float s12 = hz[2][j], sd = hz[3][j];
        const float md = mu1 - mu2;
        const float num_m = 1.0f - md * md;
        const float s12c = s12 - mu1 * mu2;
        const float core = s12c + s12c;
        const float num_s = core + 0.0009f;
        const float den_s = (core + (sd - md * md)) + 0.0009f;
        ms[j] = fmaxf(1.0f - (num_m * num_s) / den_s, 0.0f);
      }
      if (kErr) {
        const float n1 = fabsf(pc[j] - mu1);
        const float n2 = fabsf(qc[j] - mu2);
        me[j] = (1.0f + n2) / (1.0f + n1) - 1.0f;
      }
    }
    const int o = B.tc - kRadius;  // this lane's first output column in the strip
    float* m = B.maps + r * kStrip + o;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (kSsim) m[j] = ms[j];
      if (kErr) m[(kSsim ? B.b * kStrip : 0) + j] = me[j];
    }
  }
  __syncwarp();  // the row of vertical sums is free again
}

// grid: strips * nbh * n blocks (the strip fastest), b/8 warps each.
// out: (n, nbh, 6, w) f32.
template <bool kSsim, bool kErr, int kCols>
__global__ void __launch_bounds__(kMaxThreads, kCols == 2 ? 3 : 4)
    ssim_band_kernel(const float* __restrict__ im1, const float* __restrict__ im2,
                     float* __restrict__ out, int h, int w, int b, int strips, bool vec) {
  constexpr int kTile = 32 * kCols, kStrip = strip_cols<kCols>();
  constexpr int kMaps = (kSsim ? 1 : 0) + (kErr ? 1 : 0);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nbh = (h + b - 1) / b;
  const int strip = blockIdx.x % strips, rest = blockIdx.x / strips;
  const int band = rest % nbh, f = rest / nbh;
  const int warp = threadIdx.x >> 5;
  Band B;
  B.maps = smem;
  B.vrow = smem + kMaps * b * kStrip + warp * 4 * kTile;
  B.b = b;
  B.c0 = strip * kStrip;
  B.w = w;
  B.lane = threadIdx.x & 31;
  B.tc = B.lane * kCols;
  B.edge_strip = B.c0 < kRadius || B.c0 + kStrip + kRadius > w;
  const int col = B.c0 - kRadius + B.tc;  // this lane's first column in the plane
  const bool vec_here = vec && !B.edge_strip;
  const size_t plane = (size_t)h * w;
  const float* a1 = im1 + f * plane;
  const float* a2 = im2 + f * plane;
  const int y0 = band * b, y1 = min(h, y0 + b);
  const int ys = y0 + warp * kWarpRows, ye = min(ys + kWarpRows, y1);

  if (ys < ye && ys >= kRadius && ye + kRadius <= h) {
    // every tap at a fixed offset: window rows y-4 .. y+4
    float P[kTaps][kCols], Q[kTaps][kCols];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const size_t at = (size_t)(ys - kRadius + k) * w;
      load_cols<kCols>(P[k], a1 + at, col, w, vec_here);
      load_cols<kCols>(Q[k], a2 + at, col, w, vec_here);
    }
#pragma unroll 1
    for (int y = ys; y < ye; ++y) {
      const bool more = y + 1 < ye;
      float np[kCols], nq[kCols];
      if (more) {
        const size_t at = (size_t)(y + kRadius + 1) * w;
        load_cols<kCols>(np, a1 + at, col, w, vec_here);
        load_cols<kCols>(nq, a2 + at, col, w, vec_here);
      }
      float v[4][kCols];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) vtap<kSsim, kCols>(v, P[k], Q[k], k);
      row_maps<kSsim, kErr, kCols>(B, y - y0, v, P[kRadius], Q[kRadius]);
      if (more) {
#pragma unroll
        for (int k = 0; k < kTaps - 1; ++k) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            P[k][j] = P[k + 1][j];
            Q[k][j] = Q[k + 1][j];
          }
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          P[kTaps - 1][j] = np[j];
          Q[kTaps - 1][j] = nq[j];
        }
      }
    }
  } else if (ys < ye) {
    // rows within 4 of the top or bottom: each tap's row by tap_index
#pragma unroll 1
    for (int y = ys; y < ye; ++y) {
      float v[4][kCols], pc[kCols], qc[kCols];
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const int ry = tap_index(y, k - kRadius, h);
        float p[kCols], q[kCols];
        load_cols<kCols>(p, a1 + (size_t)ry * w, col, w, vec_here);
        load_cols<kCols>(q, a2 + (size_t)ry * w, col, w, vec_here);
        vtap<kSsim, kCols>(v, p, q, k);
        if (k == kRadius) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            pc[j] = p[j];
            qc[j] = q[j];
          }
        }
      }
      row_maps<kSsim, kErr, kCols>(B, y - y0, v, pc, qc);
    }
  }
  __syncthreads();

  // one thread per (sum pair, column): the band's rows in row order.  The
  // pairs are [ssim_1, ssim_4] of the SSIM map, [artifact_1, artifact_4] of
  // max(d, 0) and [detail_1, detail_4] of max(-d, 0); max(m, 0) leaves the
  // SSIM map (never negative, -0.0 or NaN) as it is, so every pair runs the
  // same loop.
  constexpr int kPairs = (kSsim ? 1 : 0) + (kErr ? 2 : 0);
  const int rows = y1 - y0;
  for (int item = threadIdx.x; item < kPairs * kStrip; item += blockDim.x) {
    const int pair = item / kStrip + (kSsim ? 0 : 1), o = item % kStrip, x = B.c0 + o;
    if (x >= w) continue;
    const float* src = smem + (pair == 0 || !kSsim ? 0 : b * kStrip) + o;
    const float sign = pair == 2 ? -1.0f : 1.0f;
    float s1 = -0.0f, s4 = -0.0f;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float v = fmaxf(sign * src[r * kStrip], 0.0f);
      s1 = s1 + v;
      s4 = s4 + (v * v) * (v * v);
    }
    if (rows < b) {
      s1 = s1 + 0.0f;
      s4 = s4 + 0.0f;
    }
    float* dst = out + ((size_t)f * nbh + band) * 6 * w + x;
    dst[(size_t)(2 * pair) * w] = s1;
    dst[(size_t)(2 * pair + 1) * w] = s4;
    if (!kErr) {  // the entries of a map not asked for are 0
#pragma unroll
      for (int k = 2; k < 6; ++k) dst[(size_t)k * w] = 0.0f;
    }
    if (!kSsim && pair == 1) {
      dst[0] = 0.0f;
      dst[w] = 0.0f;
    }
  }
}

template <bool kSsim, bool kErr, int kCols>
size_t smem_bytes(int b) {
  constexpr int kMaps = (kSsim ? 1 : 0) + (kErr ? 1 : 0);
  return ((size_t)kMaps * b * strip_cols<kCols>() + (size_t)(b / kWarpRows) * 4 * 32 * kCols) *
         sizeof(float);
}

template <bool kSsim, bool kErr, int kCols>
int launch(const float* im1, const float* im2, float* out, int n, int h, int w, int b,
           bool vec, cudaStream_t s) {
  const int strips = (w + strip_cols<kCols>() - 1) / strip_cols<kCols>();
  const long long blocks = (long long)strips * ((h + b - 1) / b) * n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // at most (2*64*56 + 8*4*64) * 4 = 36,864 bytes: under the default 48 KB
  ssim_band_kernel<kSsim, kErr, kCols>
      <<<(unsigned)blocks, 32 * (b / kWarpRows), smem_bytes<kSsim, kErr, kCols>(b), s>>>(
          im1, im2, out, h, w, b, strips, vec);
  return (int)cudaGetLastError();
}

// The variant for (n, h, w) planes in bands of b rows on a card of `sms`
// SMs: 2 columns a lane where that grid gives every SM kWideBlocksPerSm
// blocks, else 1.
int lane_columns(int n, int h, int w, int b, int sms) {
  const long long blocks =
      (long long)((w + strip_cols<2>() - 1) / strip_cols<2>()) * ((h + b - 1) / b) * n;
  return blocks >= (long long)kWideBlocksPerSm * sms ? 2 : 1;
}

template <int kCols>
int launch_maps(const float* p, const float* q, float* o, int n, int h, int w, int b,
                int need_ssim, int need_err, bool vec, cudaStream_t s) {
  if (need_ssim && need_err) return launch<true, true, kCols>(p, q, o, n, h, w, b, vec, s);
  if (need_ssim) return launch<true, false, kCols>(p, q, o, n, h, w, b, vec, s);
  return launch<false, true, kCols>(p, q, o, n, h, w, b, vec, s);
}

}  // namespace

extern "C" {

// im1, im2: (n, h, w) f32 contiguous; out: (n, ceil(h/b), 6, w)
// f32 band partials [ssim_1, ssim_4, artifact_1, artifact_4, detail_1,
// detail_4]; the entries of a map not asked for are 0.  b: 64 or 32.
// cols: 2 or 1 (the variant), 0 for lane_columns' choice on the current
// device; vec: W % 2 == 0 and both planes on 8 bytes.
int vz_ssim_partials(const void* im1, const void* im2, void* out, int n, int h, int w, int b,
                     int need_ssim, int need_err, int cols, int vec, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  if ((b != 64 && b != 32) || cols < 0 || cols > 2) return (int)cudaErrorInvalidValue;
  if (cols == 0) {
    int dev, sms;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    cols = lane_columns(n, h, w, b, sms);
  }
  const float *p = (const float*)im1, *q = (const float*)im2;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (!need_ssim && !need_err) {
    cudaMemsetAsync(o, 0, (size_t)n * ((h + b - 1) / b) * 6 * w * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  return cols == 2 ? launch_maps<2>(p, q, o, n, h, w, b, need_ssim, need_err, vec != 0, s)
                   : launch_maps<1>(p, q, o, n, h, w, b, need_ssim, need_err, false, s);
}

// The variant vz_ssim_partials takes for cols = 0 on a card of `sms` SMs.
int vz_ssim_lane_columns(int n, int h, int w, int b, int sms) {
  return lane_columns(n, h, w, b, sms);
}

}  // extern "C"
