// Deband centre kernels for Hopper (sm_90a), the CUDA counterparts of the
// Pallas kernels
//   center_kernel  B5 deband_center_pallas     (vszip_tpu/kernels/deband_pallas.py)
//                  the separable int modes 1, 3, 4, 5, 6: taps x[y±v, x]
//                  (rows) and/or x[y, x±v] (columns) from one per-pixel
//                  magnitude plane v
//   m2_kernel      B6 deband_m2_center_pallas  (vszip_tpu/kernels/deband_m2_pallas.py)
//                  int mode 2: key = (val1+rmax)(2rmax+1) + (val2+rmax) gives
//                  r1 = (y+val2, x+val1), r3 = (y-val2, x-val1),
//                  r2 = (y-val1, x+val2), r4 = (y+val1, x-val2)
// Each writes the mode's pre-grain centre (ops/deband.py _mode_center) as
// int32; the grain and clamp tail runs outside, as in the JAX package.
//
// The TPU kernels resolve the taps as select chains over the offset
// alphabet (15 selects per tap for B5, 961 for B6 at range 15) because the
// TPU has no fast gather.  On Hopper a tap is an indexed load.  A tap
// outside the plane reads as the JAX package's CPU path has it: 0 for B5
// (its zero-padded _sep_taps; 4:2:2 chroma in modes 4-6 reaches there), the
// clamped coordinate for B6 (its _gather).
//
// What bounds them is device-memory bytes: read the u16 plane once
// (2 B/sample), the offset plane once (4 B/pixel, shared by all frames), and
// write the int32 centre (4 B/sample); a few integer operations per sample
// (mode 6 adds the pow polynomial, about 80 f32 operations).  The design:
// one thread per pixel of a 32x8 tile reads its offset once and walks the N
// frames, so the offsets cost one read per call and the taps' addresses are
// computed once.  Centre loads and stores are coalesced across a warp; taps
// are read through the non-coherent path and lie within the offset range of
// the pixel, so L1/L2 serve most of them.
//
// Mode 6 runs the VCL2 pow (ops/vcl.py pow_) in f32 with its order pinned:
// the file is built with -fmad=false, so nvcc does not contract a*b+c into
// FMA and every product and sum rounds as the plain torch version's do.
// Division is IEEE (nvcc's default -prec-div=true).
//
// Plain C interface, loaded with ctypes.  Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

// A double constant rounded once to float, as NumPy's np.float32(v) does.
#define F32(v) static_cast<float>(v)

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Offset of (y+dy, x+dx), clamped into the plane, from the plane's start.
__device__ __forceinline__ long long tap(int y, int x, long long dy, long long dx, int h,
                                         int w) {
  return clampll(y + dy, 0, h - 1) * w + clampll(x + dx, 0, w - 1);
}

// Offset of (y+dy, x+dx) from the plane's start, or -1 outside the plane.
__device__ __forceinline__ long long tap_or_none(int y, int x, long long dy, long long dx,
                                                 int h, int w) {
  const long long yy = y + dy, xx = x + dx;
  return (yy < 0 || yy >= h || xx < 0 || xx >= w) ? -1 : yy * w + xx;
}

__device__ __forceinline__ int load_or_zero(const uint16_t* src, long long o) {
  return o < 0 ? 0 : __ldg(src + o);
}

__device__ __forceinline__ float round_half_away(float x) {
  return truncf(x + (x >= 0.0f ? 0.5f : -0.5f));
}

__device__ __forceinline__ float poly5(float x, float c0, float c1, float c2, float c3,
                                       float c4, float c5) {
  const float x2 = x * x;
  const float x4 = x2 * x2;
  return (c3 * x + c2) * x2 + ((c5 * x + c4) * x4 + (c1 * x + c0));
}

__device__ __forceinline__ float poly8(float x, float c0, float c1, float c2, float c3,
                                       float c4, float c5, float c6, float c7, float c8) {
  const float x2 = x * x;
  const float x4 = x2 * x2;
  const float x8 = x4 * x4;
  const float hi = (c7 * x + c6) * x2 + (c5 * x + c4);
  const float lo = (c3 * x + c2) * x2 + ((c1 * x + c0) + c8 * x8);
  return hi * x4 + lo;
}

// VCL2 pow_template_f, operation for operation as ops/vcl.py pow_.
__device__ float vcl_pow(float x0, float y) {
  const float x1 = fabsf(x0);
  float x = __uint_as_float((__float_as_uint(x1) & 0x007FFFFFu) | 0x3F000000u);
  const bool blend = x > F32(0.7071067811865476);
  x = blend ? x : x + x;
  x = x - 1.0f;

  const float x2 = x * x;
  float lg1 = poly8(x, F32(3.3333331174e-1), F32(-2.4999993993e-1), F32(2.0000714765e-1),
                    F32(-1.6668057665e-1), F32(1.4249322787e-1), F32(-1.2420140846e-1),
                    F32(1.1676998740e-1), F32(-1.1514610310e-1), F32(7.0376836292e-2));
  lg1 = lg1 * (x2 * x);

  float ef = (float)((int)((__float_as_uint(x1) >> 23) & 0xFFu) - 127);
  ef = blend ? ef + 1.0f : ef;

  const float e1 = round_half_away(ef * y);
  const float yr = ef * y - e1;

  const float half = 0.5f;
  const float lg = (half * (-x2) + x) + lg1;
  const float x2err = (half * x) * x + half * (-x2);
  const float lgerr = half * x2 + (lg - x) - lg1;

  const float log2e = F32(1.4426950408889634);
  const float ln2f_hi = F32(0.693359375);
  const float ln2f_lo = F32(-2.12194440e-4);
  const float ln2 = F32(0.6931471805599453);

  const float e2 = round_half_away(lg * y * log2e);
  float v = lg * y + (-e2) * ln2f_hi;
  v = (-e2) * ln2f_lo + v;

  const float correction = (lgerr + x2err) * y + (-yr) * ln2;
  v = v - correction;

  x = v;
  const float e3 = round_half_away(x * log2e);
  x = (-e3) * ln2 + x;

  const float x2e = x * x;
  float z = poly5(x, F32(1.0 / 2.0), F32(1.0 / 6.0), F32(1.0 / 24.0), F32(1.0 / 120.0),
                  F32(1.0 / 720.0), F32(1.0 / 5040.0));
  z = z * x2e + x + 1.0f;

  const float ee = e1 + e2 + e3;
  const int ei = (int)round_half_away(ee);
  z = __uint_as_float(__float_as_uint(z) + ((unsigned)ei << 23));  // wrapping add

  if ((__float_as_uint(x0) & 0x7F800000u) == 0u)
    return y < 0.0f ? __uint_as_float(0x7F800000u) : (y == 0.0f ? 1.0f : 0.0f);
  return z;
}

__device__ __forceinline__ float soft_gate(float dif, float t) {
  return fminf(fmaxf(3.0f * (1.0f - dif / fmaxf(t, F32(1e-5))), 0.0f), 1.0f);
}

// ops/deband.py _mode_center for int planes, on resolved taps.
template <int MODE, bool BLUR_FIRST>
__device__ __forceinline__ int center(int c, int r1, int r3, int r2, int r4, int thr,
                                      int thr1, int thr2) {
  if (MODE == 1 || MODE == 3) {
    const int avg = (r1 + r3 + 1) >> 1;
    const bool use_orig = BLUR_FIRST ? abs(avg - c) >= thr
                                     : (abs(r1 - c) >= thr || abs(r3 - c) >= thr);
    return use_orig ? c : avg;
  }
  if (MODE == 2) {
    int avg1 = (r1 + r3 + 1) >> 1;
    const int avg2 = (r2 + r4 + 1) >> 1;
    avg1 -= avg1 > 0;  // neo's SIMD avg_4 decrement-if-positive quirk
    const int avg = (avg1 + avg2 + 1) >> 1;
    const bool use_orig = BLUR_FIRST ? abs(avg - c) >= thr
                                     : (abs(r1 - c) >= thr || abs(r2 - c) >= thr ||
                                        abs(r3 - c) >= thr || abs(r4 - c) >= thr);
    return use_orig ? c : avg;
  }
  if (MODE == 4) {
    const int avg_v = (r1 + r3 + 1) >> 1;
    const int avg_h = (r2 + r4 + 1) >> 1;
    const bool uo_v = BLUR_FIRST ? abs(avg_v - c) >= thr
                                 : (abs(r1 - c) >= thr || abs(r3 - c) >= thr);
    const bool uo_h = BLUR_FIRST ? abs(avg_h - c) >= thr
                                 : (abs(r2 - c) >= thr || abs(r4 - c) >= thr);
    return ((uo_v ? c : avg_v) + (uo_h ? c : avg_h) + 1) >> 1;
  }
  if (MODE == 5) {
    const int avg = (r1 + r3 + r2 + r4) >> 2;
    const int max_dif = max(max(abs(r1 - c), abs(r3 - c)), max(abs(r2 - c), abs(r4 - c)));
    const bool use_orig = abs(avg - c) >= thr || max_dif >= thr1 ||
                          abs((r1 + r3) - (c << 1)) >= thr2 ||
                          abs((r2 + r4) - (c << 1)) >= thr2;
    return use_orig ? c : avg;
  }
  // MODE == 6: soft blend with factor pow(product of gates, 0.1)
  const float cf = (float)c;
  const float p1 = (float)r1, p2 = (float)r3, p3 = (float)r2, p4 = (float)r4;
  const float avg_refs = (p1 + p2 + p3 + p4) * 0.25f;
  const float diff = avg_refs - cf;
  const float max_dif = fmaxf(fmaxf(fabsf(p1 - cf), fabsf(p2 - cf)),
                              fmaxf(fabsf(p3 - cf), fabsf(p4 - cf)));
  const float two_src = cf * 2.0f;
  const float product = soft_gate(fabsf(diff), (float)thr) * soft_gate(max_dif, (float)thr1) *
                        soft_gate(fabsf((p1 + p2) - two_src), (float)thr2) *
                        soft_gate(fabsf((p3 + p4) - two_src), (float)thr2);
  const float factor = vcl_pow(product, F32(0.1));
  const float blended = cf + diff * factor;
  return (int)truncf(blended + 0.5f);
}

template <int MODE, bool BLUR_FIRST>
__global__ void center_kernel(const uint16_t* __restrict__ x, const int* __restrict__ vmap,
                              int* __restrict__ out, int n, int h, int w, int thr, int thr1,
                              int thr2) {
  const int px = blockIdx.x * kTileX + threadIdx.x;
  const int py = blockIdx.y * kTileY + threadIdx.y;
  if (px >= w || py >= h) return;
  const long long plane = (long long)h * w;
  const long long oc = (long long)py * w + px;
  const long long v = __ldg(vmap + oc);
  // rows for modes 1, 4-6; columns for 3-6 (mode 3 takes them as r1/r3)
  long long o1 = oc, o3 = oc, o2 = oc, o4 = oc;
  if (MODE != 3) {
    o1 = tap_or_none(py, px, v, 0, h, w);
    o3 = tap_or_none(py, px, -v, 0, h, w);
  }
  if (MODE != 1) {
    o2 = tap_or_none(py, px, 0, v, h, w);
    o4 = tap_or_none(py, px, 0, -v, h, w);
  }
  if (MODE == 3) {
    o1 = o2;
    o3 = o4;
    o2 = o4 = oc;
  }
  for (int f = 0; f < n; ++f) {
    const uint16_t* src = x + f * plane;
    const int c = __ldg(src + oc);
    const int r1 = load_or_zero(src, o1);
    const int r3 = load_or_zero(src, o3);
    int r2 = c, r4 = c;
    if (MODE != 1 && MODE != 3) {
      r2 = load_or_zero(src, o2);
      r4 = load_or_zero(src, o4);
    }
    out[f * plane + oc] = center<MODE, BLUR_FIRST>(c, r1, r3, r2, r4, thr, thr1, thr2);
  }
}

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

template <bool BLUR_FIRST>
__global__ void m2_kernel(const uint16_t* __restrict__ x, const int* __restrict__ key,
                          int* __restrict__ out, int n, int h, int w, int rmax, int thr) {
  const int px = blockIdx.x * kTileX + threadIdx.x;
  const int py = blockIdx.y * kTileY + threadIdx.y;
  if (px >= w || py >= h) return;
  const long long plane = (long long)h * w;
  const long long oc = (long long)py * w + px;
  const long long na = 2LL * rmax + 1;
  const long long k = __ldg(key + oc);
  const long long q = floordiv(k, na);
  const long long v1 = q - rmax;
  const long long v2 = (k - q * na) - rmax;
  const long long o1 = tap(py, px, v2, v1, h, w);
  const long long o3 = tap(py, px, -v2, -v1, h, w);
  const long long o2 = tap(py, px, -v1, v2, h, w);
  const long long o4 = tap(py, px, v1, -v2, h, w);
  for (int f = 0; f < n; ++f) {
    const uint16_t* src = x + f * plane;
    out[f * plane + oc] = center<2, BLUR_FIRST>(__ldg(src + oc), __ldg(src + o1),
                                                __ldg(src + o3), __ldg(src + o2),
                                                __ldg(src + o4), thr, 0, 0);
  }
}

dim3 tile_grid(int h, int w) {
  return dim3((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
}

template <int MODE>
void launch_center(const uint16_t* x, const int* vmap, int* out, int n, int h, int w,
                   bool blur_first, int thr, int thr1, int thr2, cudaStream_t s) {
  const dim3 block(kTileX, kTileY);
  if (blur_first)
    center_kernel<MODE, true><<<tile_grid(h, w), block, 0, s>>>(x, vmap, out, n, h, w, thr,
                                                                thr1, thr2);
  else
    center_kernel<MODE, false><<<tile_grid(h, w), block, 0, s>>>(x, vmap, out, n, h, w, thr,
                                                                 thr1, thr2);
}

}  // namespace

extern "C" {

// x: (n, h, w) uint16; vmap/key: (h, w) int32; out: (n, h, w) int32; all
// contiguous on one device.

int vz_deband_center(const void* x, const void* vmap, void* out, int n, int h, int w,
                     int mode, int blur_first, int thr, int thr1, int thr2, void* stream) {
  const uint16_t* xs = (const uint16_t*)x;
  const int* vs = (const int*)vmap;
  int* os = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const bool bf = blur_first != 0;
  switch (mode) {
    case 1: launch_center<1>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    case 3: launch_center<3>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    case 4: launch_center<4>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    case 5: launch_center<5>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    case 6: launch_center<6>(xs, vs, os, n, h, w, bf, thr, thr1, thr2, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int vz_deband_m2_center(const void* x, const void* key, void* out, int n, int h, int w,
                        int rmax, int blur_first, int thr, void* stream) {
  const dim3 block(kTileX, kTileY);
  cudaStream_t s = (cudaStream_t)stream;
  if (blur_first)
    m2_kernel<true><<<tile_grid(h, w), block, 0, s>>>(
        (const uint16_t*)x, (const int*)key, (int*)out, n, h, w, rmax, thr);
  else
    m2_kernel<false><<<tile_grid(h, w), block, 0, s>>>(
        (const uint16_t*)x, (const int*)key, (int*)out, n, h, w, rmax, thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
