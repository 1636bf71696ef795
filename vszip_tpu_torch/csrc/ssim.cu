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
// Design: one block of 128 threads per (frame, band of b rows, strip of 120
// columns).  The block walks its band's rows in order.  For each row, every
// thread computes the vertical pass of the four sources at one column of the
// strip or its 4-column halo (nine loads each of im1 and im2, served by
// L1/L2 after the first row) into shared memory; then the strip's 120
// threads run the horizontal pass from shared memory, form the maps and add
// them to six f32 row sums held in registers.  The trailing-rule index
// always lies in the halo, so the strip needs no other columns.  Each thread
// writes its column's six band sums to (N, nbh, 6, W) f32 partials, which
// the wrapper folds in f64 with one torch sum.  No atomics: the order of
// every sum is fixed, and with -fmad=false and IEEE division every product,
// sum and quotient rounds as the plain torch version's, so the partials
// equal it bit for bit.
//
// Bound: bytes and operations are about even.  im1 and im2 are read once
// from device memory (8 B per pixel) and the partials written; about 185
// f32 operations per pixel (4 sources x 2 passes x 17, the maps and norms).
//
// Plain C interface, loaded with ctypes.  The entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 4;
constexpr int kThreads = 128;
constexpr int kStrip = kThreads - 2 * kRadius;  // output columns per block

__constant__ float kK[9] = {
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

// Horizontal pass at column x from the strip's vertical results v, whose
// slot s holds column c0 - kRadius + s.
__device__ __forceinline__ float hblur(const float* v, int x, int c0, int w) {
  float acc = kK[0] * v[tap_index(x, -kRadius, w) - c0 + kRadius];
#pragma unroll
  for (int k = 1; k < 9; ++k) acc = acc + kK[k] * v[tap_index(x, k - kRadius, w) - c0 + kRadius];
  return acc;
}

// grid (ceil(w / 120), nbh, n), block 128.  out: (n, nbh, 6, w) f32.
template <bool kSsim, bool kErr>
__global__ void __launch_bounds__(kThreads)
    ssim_band_kernel(const float* __restrict__ im1, const float* __restrict__ im2,
                     float* __restrict__ out, int h, int w, int b) {
  __shared__ float vs[4][kThreads];
  const int i = blockIdx.z, band = blockIdx.y, nbh = gridDim.y;
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * kStrip;
  const int xc = c0 - kRadius + t;  // this thread's column in the vertical pass
  const int x = c0 + t;             // and in the horizontal pass
  const bool vcol = xc >= 0 && xc < w;
  const bool hcol = t < kStrip && x < w;
  const size_t plane = (size_t)h * w;
  const float* a1 = im1 + (size_t)i * plane;
  const float* a2 = im2 + (size_t)i * plane;
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int y0 = band * b, y1 = min(h, y0 + b);
  for (int y = y0; y < y1; ++y) {
    if (vcol) {
      float m1 = 0.f, m2 = 0.f, m12 = 0.f, mdd = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const size_t at = (size_t)tap_index(y, k - kRadius, h) * w + xc;
        const float p = a1[at], q = a2[at];
        const float tp = kK[k] * p, tq = kK[k] * q;
        m1 = k ? m1 + tp : tp;
        m2 = k ? m2 + tq : tq;
        if (kSsim) {
          const float d = p - q;
          const float tpq = kK[k] * (p * q), tdd = kK[k] * (d * d);
          m12 = k ? m12 + tpq : tpq;
          mdd = k ? mdd + tdd : tdd;
        }
      }
      vs[0][t] = m1;
      vs[1][t] = m2;
      if (kSsim) {
        vs[2][t] = m12;
        vs[3][t] = mdd;
      }
    }
    __syncthreads();
    if (hcol) {
      const float mu1 = hblur(vs[0], x, c0, w);
      const float mu2 = hblur(vs[1], x, c0, w);
      if (kSsim) {
        const float s12 = hblur(vs[2], x, c0, w);
        const float sd = hblur(vs[3], x, c0, w);
        const float md = mu1 - mu2;
        const float num_m = 1.0f - md * md;
        const float s12c = s12 - mu1 * mu2;
        const float core = s12c + s12c;
        const float num_s = core + 0.0009f;
        const float den_s = (core + (sd - md * md)) + 0.0009f;
        const float d1 = fmaxf(1.0f - (num_m * num_s) / den_s, 0.0f);
        s[0] = s[0] + d1;
        s[1] = s[1] + (d1 * d1) * (d1 * d1);
      }
      if (kErr) {
        const size_t at = (size_t)y * w + x;
        const float n1 = fabsf(a1[at] - mu1);
        const float n2 = fabsf(a2[at] - mu2);
        const float d = (1.0f + n2) / (1.0f + n1) - 1.0f;
        const float art = fmaxf(d, 0.0f), det = fmaxf(-d, 0.0f);
        s[2] = s[2] + art;
        s[3] = s[3] + (art * art) * (art * art);
        s[4] = s[4] + det;
        s[5] = s[5] + (det * det) * (det * det);
      }
    }
    __syncthreads();
  }
  if (hcol) {
    float* o = out + ((size_t)i * nbh + band) * 6 * w + x;
#pragma unroll
    for (int k = 0; k < 6; ++k) o[(size_t)k * w] = s[k];
  }
}

template <bool kSsim, bool kErr>
void launch(const float* im1, const float* im2, float* out, int n, int h, int w, int b,
            cudaStream_t s) {
  const dim3 grid((w + kStrip - 1) / kStrip, (h + b - 1) / b, n);
  ssim_band_kernel<kSsim, kErr><<<grid, kThreads, 0, s>>>(im1, im2, out, h, w, b);
}

}  // namespace

extern "C" {

// im1, im2: (n, h, w) f32 contiguous; out: (n, ceil(h/b), 6, w) f32 band
// partials [ssim_1, ssim_4, artifact_1, artifact_4, detail_1, detail_4];
// the entries of a map not asked for are 0.
int vz_ssim_partials(const void* im1, const void* im2, void* out, int n, int h, int w, int b,
                     int need_ssim, int need_err, void* stream) {
  if (n == 0 || h == 0 || w == 0) return 0;
  const float *p = (const float*)im1, *q = (const float*)im2;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (need_ssim && need_err) launch<true, true>(p, q, o, n, h, w, b, s);
  else if (need_ssim) launch<true, false>(p, q, o, n, h, w, b, s);
  else if (need_err) launch<false, true>(p, q, o, n, h, w, b, s);
  else launch<false, false>(p, q, o, n, h, w, b, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
