// EEDI3 kernels for Hopper (sm_90a), the CUDA counterparts of the Pallas
// kernels
//   eedi3_line_kernel<0, M>  B8  eedi3_fused_pallas     (vszip_tpu/kernels/eedi3_fused_pallas.py)
//   eedi3_line_kernel<1, 0>  B9  eedi3_fused_hp_pallas  (same file)
//   vcheck_kernel            B10 vcheck_pallas          (vszip_tpu/kernels/vcheck_pallas.py)
//
// B8/B9: one block per line runs the reference's interpLine / interpLineHP
// (src/filters/eedi3.zig): the connection cost of every direction t at every
// x, the Viterbi DP across x with +-1 (hp: +-2) transitions, the backtrack,
// and the directional 4-tap (hp: 8-tap) interpolation.  The x axis is cut
// into chunks of kXc positions.  Per chunk the four warps build the cost
// chunk C[t][x] in shared memory, one direction per warp at a time (t_base
// over the chunk's span, then the k-ascending box sums, then the cost);
// then warp 0 walks the DP over the chunk, lanes over directions, with the
// DP state in shared memory.  Each step's backtrack deltas are packed at 2
// bits (hp: 3) into words of 16 (hp: 10) steps per direction, in shared
// memory where the line's deltas fit the block's budget, else in a global
// scratch the wrapper allocates, so any width runs.  Thread 0 then walks the
// backtrack, and all threads interpolate.
//
// B10: one block per frame sweeps the interpolated lines in order; the
// carried updated line lives in shared memory (two buffers, one read and
// one written per line, a __syncthreads between lines); threads over x.
// Every gather clamps its column into [0, w-1], as the edge pad does.
//
// Bit-exactness.  The file builds with -fmad=false, so every product and
// sum rounds to f32 on its own, in the reference's order, as the plain
// torch versions (ops/eedi3.py) round them:
//   tb = (|.|+|.|)+|.|; B(j) = tb(j-nrad) + ... + tb(j+nrad), k ascending;
//   s = (B(x+u)+B(x))+B(x+2u); ip = (.+.)*0.5;
//   cost = (alpha*s + f32(beta*|u|)) + omab*v;
//   the DP's strict-less candidate order, min(bval + cost, BIG);
//   the mclip gating (inactive x carries cost and delta; x==1 resets).
// Rows read 0 past the mirror pad (the JAX package's zero-extended shifts).
// The TPU kernels' one-hot sums, select chains, 8-step x padding and
// fused_fits limit stand in for gathers and VMEM sizes; they are not needed.
//
// What bounds B8/B9 is operations: about 41 (hp 81) directions x ~30 f32
// operations per pixel for the cost and the DP step, against a few bytes
// per pixel.  B10 reads 9 f32/int rows per interpolated pixel and writes
// one: bytes, with only B blocks in flight.
//
// Plain C interface, loaded with ctypes.  Every entry launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPad = 96;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kXc = 64;          // x positions per cost chunk
constexpr int kNradMax = 3;
constexpr int kMaxK = 6;         // directions per DP lane: ceil((4*40+1) / 32)
constexpr size_t kSmemBudget = 64 * 1024;  // backtrack in shared memory up to this
constexpr int kVcheckThreads = 512;

// Shared-memory layout of one line's block, the same on host and device.
struct Plan {
  int tp, cen, bits, per_word, per_warp;
  long long bt_words;  // packed backtrack words of one line
  size_t base_bytes;   // cost chunk + warp buffers + DP state
  bool bt_smem;
};

__host__ __device__ inline Plan plan(int w, int mdis, bool hp) {
  Plan p;
  p.tp = hp ? 4 * mdis + 1 : 2 * mdis + 1;
  p.cen = (p.tp - 1) / 2;
  p.bits = hp ? 3 : 2;
  p.per_word = hp ? 10 : 16;
  p.bt_words = (long long)((w - 1 + p.per_word - 1) / p.per_word) * p.tp;
  // t_base and box buffers of one direction: B spans the chunk plus |2u|
  // (hp: |u|) <= 2*mdis, t_base nrad more each side; hp adds the half-pel
  // t_base and box of odd directions over the chunk
  p.per_warp = (kXc + 2 * mdis + 2 * kNradMax) + (kXc + 2 * mdis) +
               (hp ? (kXc + 2 * kNradMax) + kXc : 0);
  p.base_bytes = sizeof(float) * ((size_t)p.tp * kXc + (size_t)kWarps * p.per_warp +
                                  2 * (size_t)(p.tp + 4));
  p.bt_smem = p.base_bytes + 4 * (size_t)p.bt_words <= kSmemBudget;
  return p;
}

// A padded row at padded position j, 0 outside it.
__device__ __forceinline__ float ldz(const float* row, int j, int wp) {
  return (j >= 0 && j < wp) ? row[j] : 0.0f;
}

// The half-pel row (ops/eedi3.py _hp_row) of a wp-long padded row at j,
// circular at the ends as the roll there.
__device__ __forceinline__ float hp_at(const float* a, int j, int wp) {
  const int jm1 = j == 0 ? wp - 1 : j - 1;
  const int jp1 = j + 1 >= wp ? j + 1 - wp : j + 1;
  const int jp2 = j + 2 >= wp ? j + 2 - wp : j + 2;
  return 0.5625f * (a[j] + a[jp1]) - 0.0625f * (a[jm1] + a[jp2]);
}

__device__ __forceinline__ float hpz(const float* a, int j, int wp) {
  return (j >= 0 && j < wp) ? hp_at(a, j, wp) : 0.0f;
}

// B[i] = tb[i] + tb[i+1] + ... + tb[i+2*nrad], k ascending.
__device__ __forceinline__ void box_sums(const float* tb, float* B, int n, int nrad,
                                         int lane) {
  for (int i = lane; i < n; i += 32) {
    float acc = tb[i];
    for (int k = 1; k <= 2 * nrad; ++k) acc = acc + tb[i + k];
    B[i] = acc;
  }
}

template <bool kHp, bool kMask>
__global__ void __launch_bounds__(kThreads)
    eedi3_line_kernel(const float* __restrict__ r3p_all, const float* __restrict__ r1p_all,
                      const float* __restrict__ r1n_all, const float* __restrict__ r3n_all,
                      const uint8_t* __restrict__ bmask, float* __restrict__ out,
                      int32_t* fpath, uint32_t* bt_global, int w, int mdis, int nrad,
                      float alpha, double beta, float gamma, float omab, float big) {
  const Plan P = plan(w, mdis, kHp);
  const int line = blockIdx.x;
  const int wp = w + 2 * kPad;
  const float* r3p = r3p_all + (size_t)line * wp;
  const float* r1p = r1p_all + (size_t)line * wp;
  const float* r1n = r1n_all + (size_t)line * wp;
  const float* r3n = r3n_all + (size_t)line * wp;
  const uint8_t* bm = kMask ? bmask + (size_t)line * w : nullptr;
  float* orow = out + (size_t)line * w;
  int32_t* frow = fpath + (size_t)line * w;

  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* C = smem;  // (tp, kXc) costs of the chunk
  float* wb = C + (size_t)P.tp * kXc + (size_t)warp * P.per_warp;
  float* pc = C + (size_t)P.tp * kXc + (size_t)kWarps * P.per_warp;  // DP state, t at t+2
  float* pn = pc + P.tp + 4;
  uint32_t* bt = P.bt_smem ? reinterpret_cast<uint32_t*>(pn + P.tp + 4)
                           : bt_global + (size_t)line * P.bt_words;
  if (threadIdx.x < 2) {
    pc[threadIdx.x] = pn[threadIdx.x] = big;
    pc[P.tp + 2 + threadIdx.x] = pn[P.tp + 2 + threadIdx.x] = big;
  }

  // DP state of warp 0's lane: packed words and the previous delta of its
  // directions t = lane + 32k
  uint32_t word[kMaxK];
  int prev[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) word[k] = 0, prev[k] = 0;
  const int off = kHp ? 2 : 1;
  const float g2 = gamma * 0.5f;

  for (int x0 = 0; x0 < w; x0 += kXc) {
    const int cn = min(kXc, w - x0);
    // ---- the chunk's costs, one direction per warp at a time ----
    for (int t = warp; t < P.tp; t += kWarps) {
      const int u = t - P.cen;
      float* tb = wb;
      float* B = tb + (kXc + 2 * mdis + 2 * kNradMax);
      if (!kHp) {
        const int tu = 2 * u;
        const int lo = min(0, tu), hi = max(0, tu);
        const int blen = cn + hi - lo;
        const int jt = kPad + x0 + lo - nrad;  // padded position of tb[0]
        for (int i = lane; i < blen + 2 * nrad; i += 32) {
          const int j = jt + i;
          tb[i] = (j < 0 || j >= wp)
                      ? 0.0f
                      : (fabsf(r3p[j] - ldz(r1p, j - tu, wp)) +
                         fabsf(r1p[j] - ldz(r1n, j - tu, wp))) +
                            fabsf(r1n[j] - ldz(r3n, j - tu, wp));
        }
        __syncwarp();
        box_sums(tb, B, blen, nrad, lane);
        __syncwarp();
        const float bu = (float)(beta * (double)abs(u));
        for (int i = lane; i < cn; i += 32) {
          const int x = x0 + i;
          const float s = (B[i + u - lo] + B[i - lo]) + B[i + tu - lo];
          const float ip = (r1p[kPad + x + u] + r1n[kPad + x - u]) * 0.5f;
          const float v = fabsf(r1p[kPad + x] - ip) + fabsf(r1n[kPad + x] - ip);
          C[t * kXc + i] = (alpha * s + bu) + omab * v;
        }
      } else {
        const int uh = u >> 1;
        const bool odd = (u & 1) != 0;
        const int lo0 = odd ? -uh - 1 : -uh;
        const int lo = min(0, u), hi = max(0, u);
        const int blen = cn + hi - lo;
        float* tb0 = B + (kXc + 2 * mdis);
        float* B0 = tb0 + (kXc + 2 * kNradMax);
        const int jt = kPad + x0 + lo - nrad;
        for (int i = lane; i < blen + 2 * nrad; i += 32) {
          const int j = jt + i;
          tb[i] = (j < 0 || j >= wp)
                      ? 0.0f
                      : (fabsf(r3p[j] - ldz(r1p, j - u, wp)) +
                         fabsf(r1p[j] - ldz(r1n, j - u, wp))) +
                            fabsf(r1n[j] - ldz(r3n, j - u, wp));
        }
        if (odd) {  // half-pel t_base around x + uh
          const int jt0 = kPad + x0 + uh - nrad;
          for (int i = lane; i < cn + 2 * nrad; i += 32) {
            const int j = jt0 + i;
            tb0[i] = (j < 0 || j >= wp)
                         ? 0.0f
                         : (fabsf(hp_at(r3p, j, wp) - hpz(r1p, j - u, wp)) +
                            fabsf(hp_at(r1p, j, wp) - hpz(r1n, j - u, wp))) +
                               fabsf(hp_at(r1n, j, wp) - hpz(r3n, j - u, wp));
          }
        }
        __syncwarp();
        box_sums(tb, B, blen, nrad, lane);
        if (odd) box_sums(tb0, B0, cn, nrad, lane);
        __syncwarp();
        const float bu = (float)(beta * (double)abs(u) * 0.5);
        for (int i = lane; i < cn; i += 32) {
          const int x = x0 + i;
          const float s1 = B[i - lo];
          const float s2 = B[i + u - lo];
          const float s0 = odd ? B0[i] : B[i + uh - lo];
          const float b0v = odd ? hp_at(r1p, kPad + x + uh, wp) : r1p[kPad + x + uh];
          const float c0v = odd ? hp_at(r1n, kPad + x + lo0, wp) : r1n[kPad + x + lo0];
          const float ip = (b0v + c0v) * 0.5f;
          const float v = fabsf(r1p[kPad + x] - ip) + fabsf(r1n[kPad + x] - ip);
          C[t * kXc + i] = (alpha * ((s0 + s1) + s2) + bu) + omab * v;
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- the DP over the chunk: warp 0, lanes over directions ----
    if (warp == 0) {
      int xs = x0;
      if (x0 == 0) {
        for (int t = lane; t < P.tp; t += 32) pc[t + 2] = C[t * kXc];
        __syncwarp();
        xs = 1;
      }
      for (int x = xs; x < x0 + cn; ++x) {
        const int i = x - x0, s = x - 1;
        const int sh = P.bits * (s % P.per_word);
        const bool flush = (s % P.per_word == P.per_word - 1) || (x == w - 1);
        const bool active = !kMask || bm[x] != 0;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          const int t = lane + 32 * k;
          if (t < P.tp) {
            const float tcx = C[t * kXc + i];
            float bval;
            int bd;
            if (!kHp) {
              const float left = pc[t + 1] + gamma;
              const float cent = pc[t + 2];
              const float right = pc[t + 3] + gamma;
              const bool lw = left < cent;
              bval = lw ? left : cent;
              bd = lw ? -1 : 0;
              if (right < bval) bval = right, bd = 1;
            } else {
              bval = pc[t] + gamma;
              bd = -2;
              float cv = pc[t + 1] + g2;
              if (cv < bval) bval = cv, bd = -1;
              cv = pc[t + 2];
              if (cv < bval) bval = cv, bd = 0;
              cv = pc[t + 3] + g2;
              if (cv < bval) bval = cv, bd = 1;
              cv = pc[t + 4] + gamma;
              if (cv < bval) bval = cv, bd = 2;
            }
            float nv = fminf(bval + tcx, big);
            if (kMask && !active) {
              if (x == 1) {
                nv = tcx;
                bd = 0;
              } else {
                nv = pc[t + 2];
                bd = prev[k];
              }
            }
            pn[t + 2] = nv;
            prev[k] = bd;
            word[k] |= (uint32_t)(bd + off) << sh;
            if (flush) {
              bt[(size_t)(s / P.per_word) * P.tp + t] = word[k];
              word[k] = 0;
            }
          }
        }
        __syncwarp();
        float* tmp = pc;
        pc = pn;
        pn = tmp;
      }
    }
    __syncthreads();
  }

  // ---- backtrack: fpath[w-1] = 0, fpath[x] = f(x+1) + delta(x+1) ----
  if (threadIdx.x == 0) {
    int f = 0;
    frow[w - 1] = 0;
    const uint32_t mask = (1u << P.bits) - 1u;
    for (int bx = w - 2; bx >= 0; --bx) {
      int t = P.cen + f;
      if (t < 0 || t >= P.tp) t = 0;  // the JAX select chain's default
      const uint32_t wd = bt[(size_t)(bx / P.per_word) * P.tp + t];
      f += (int)((wd >> (P.bits * (bx % P.per_word))) & mask) - off;
      frow[bx] = (kMask && bm[bx] == 0) ? 0 : f;
    }
  }
  __syncthreads();

  // ---- directional interpolation ----
  const int last = wp - 1;
  for (int x = threadIdx.x; x < w; x += kThreads) {
    const int d = frow[x];
    const int p = kPad + x;
    if (!kHp) {
      const int ad = abs(d);
      const float g1p = r1p[min(max(p + d, 0), last)];
      const float g1n = r1n[min(max(p - d, 0), last)];
      const float g3p = r3p[min(max(p + 3 * d, 0), last)];
      const float g3n = r3n[min(max(p - 3 * d, 0), last)];
      const float four = 0.5625f * (g1p + g1n) - 0.0625f * (g3p + g3n);
      const float two = (g1p + g1n) * 0.5f;
      orow[x] = (x >= 3 * ad && x + 3 * ad <= w - 1) ? four : two;
    } else {
      auto at = [&](const float* r, int o) { return r[min(max(p + o, 0), last)]; };
      const int d2 = d >> 1, d21 = (d + 1) >> 1;
      const int d30 = (3 * d) >> 1, d31 = (3 * d + 1) >> 1;
      const float g1p_e = at(r1p, d2), g1n_e = at(r1n, -d2);
      const float g3p_e = at(r3p, d30), g3n_e = at(r3n, -d30);
      const float g3p_o = at(r3p, d31), g3n_o = at(r3n, -d31);
      const float g1p_o = at(r1p, d21), g1n_o = at(r1n, -d21);
      float res;
      if ((d & 1) == 0) {
        const int ad = abs(d2);
        const float four = 0.5625f * (g1p_e + g1n_e) - 0.0625f * (g3p_e + g3n_e);
        const float two = (g1p_e + g1n_e) * 0.5f;
        res = (x >= ad * 3 && x + ad * 3 <= w - 1) ? four : two;
      } else {
        const int ad = max(abs(d30), abs(d31));
        const float c0 = g3p_e + g3p_o, c1 = g1p_e + g1p_o;
        const float c2 = g1n_e + g1n_o, c3 = g3n_e + g3n_o;
        const float four = 0.28125f * (c1 + c2) - 0.03125f * (c0 + c3);
        const float two = (c1 + c2) * 0.25f;
        res = (x >= ad && x + ad <= w - 1) ? four : two;
      }
      orow[x] = res;
    }
  }
}

template <bool kHp, bool kMask>
int launch_line(const float* r3p, const float* r1p, const float* r1n, const float* r3n,
                const uint8_t* bmask, float* out, int32_t* fpath, uint32_t* scratch,
                int lines, int w, int mdis, int nrad, float alpha, double beta, float gamma,
                float omab, float big, cudaStream_t s) {
  const Plan P = plan(w, mdis, kHp);
  const size_t bytes = P.base_bytes + (P.bt_smem ? 4 * (size_t)P.bt_words : 0);
  cudaError_t err = cudaFuncSetAttribute(eedi3_line_kernel<kHp, kMask>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  eedi3_line_kernel<kHp, kMask><<<lines, kThreads, bytes, s>>>(
      r3p, r1p, r1n, r3n, bmask, out, fpath, scratch, w, mdis, nrad, alpha, beta, gamma,
      omab, big);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <bool kHp>
__global__ void __launch_bounds__(kVcheckThreads)
    vcheck_kernel(const float* __restrict__ dl, const float* __restrict__ nb,
                  const int32_t* __restrict__ dm, const float* __restrict__ cint,
                  const float* __restrict__ init, float* __restrict__ out, int n_off,
                  int nbatch, int w, int mode, float rcp0, float rcp1, float rcp2,
                  float vt2) {
  extern __shared__ float carry[];
  float* cur = carry;  // the line the previous iteration updated (pd-2)
  float* nxt = carry + w;
  const int b = blockIdx.x;
  for (int x = threadIdx.x; x < w; x += kVcheckThreads) cur[x] = init[(size_t)b * w + x];
  __syncthreads();
  const size_t st = (size_t)nbatch * w;  // one (B, W) plane
  for (int li = 0; li < n_off; ++li) {
    const size_t o1 = (size_t)li * st + (size_t)b * w;
    const size_t o3 = (size_t)li * 3 * st + (size_t)b * w;
    const float* DL = dl + o1;
    const float* CI = cint + o1;
    const float* D1P = nb + o3;
    const float* D1N = D1P + st;
    const float* D2N = D1N + st;
    const int32_t* DMP = dm + o3;
    const int32_t* DMC = DMP + st;
    const int32_t* DMN = DMC + st;
    for (int x = threadIdx.x; x < w; x += kVcheckThreads) {
      const int dmc = DMC[x], dmp = DMP[x], dmn = DMN[x];
      bool keep = dmc == 0;
      keep |= (max(dmc * dmp, dmc * dmn) < 0) || (dmp == dmn && dmp == 0);
      const int maxoff = kHp ? ((dmc & 1) == 0 ? abs(dmc >> 1)
                                               : max(abs(dmc >> 1), abs((dmc + 1) >> 1)))
                             : abs(dmc);
      keep |= (x + maxoff >= w) || (x - maxoff < 0);
      // up stack (d2p, d1p, dl) at x + o, down stack (dl, d1n, d2n) at x - o
      auto up0 = [&](int o) { return cur[clampi(x + o, 0, w - 1)]; };
      auto up1 = [&](int o) { return D1P[clampi(x + o, 0, w - 1)]; };
      auto up2 = [&](int o) { return DL[clampi(x + o, 0, w - 1)]; };
      auto dn0 = [&](int o) { return DL[clampi(x - o, 0, w - 1)]; };
      auto dn1 = [&](int o) { return D1N[clampi(x - o, 0, w - 1)]; };
      auto dn2 = [&](int o) { return D2N[clampi(x - o, 0, w - 1)]; };
      float it, ib, vt, vb;
      int dabs;
      if (kHp) {
        const int d20 = dmc >> 1, d21 = (dmc + 1) >> 1;
        const float a0 = up0(d20), a1 = up1(d20), a2 = up2(d20);
        const float b0 = dn0(d20), b1 = dn1(d20), b2 = dn2(d20);
        if ((dmc & 1) == 0) {
          it = (a0 + b0) * 0.5f;
          ib = (a2 + b2) * 0.5f;
          vt = fabsf(a0 - a1) + fabsf(a2 - a1);
          vb = fabsf(b2 - b1) + fabsf(b0 - b1);
        } else {
          const float s2ps = a0 + up0(d21), s1ps = a1 + up1(d21), pa0 = a2 + up2(d21);
          const float ps0 = b0 + dn0(d21), s1ns = b1 + dn1(d21), s2ns = b2 + dn2(d21);
          it = (s2ps + ps0) * 0.25f;
          vt = (fabsf(s2ps - s1ps) + fabsf(pa0 - s1ps)) * 0.5f;
          ib = (pa0 + s2ns) * 0.25f;
          vb = (fabsf(s2ns - s1ns) + fabsf(ps0 - s1ns)) * 0.5f;
        }
        dabs = abs(dmc) >> 1;
      } else {
        const float gu0 = up0(dmc), gu1 = up1(dmc), gu2 = up2(dmc);
        const float gd0 = dn0(dmc), gd1 = dn1(dmc), gd2 = dn2(dmc);
        it = (gu0 + gd0) * 0.5f;
        ib = (gu2 + gd2) * 0.5f;
        vt = fabsf(gu0 - gu1) + fabsf(gu2 - gu1);
        vb = fabsf(gd2 - gd1) + fabsf(gd0 - gd1);
        dabs = abs(dmc);
      }
      const float dlx = DL[x], d1p = D1P[x], d1n = D1N[x], ci = CI[x];
      const float vc = fabsf(dlx - d1p) + fabsf(dlx - d1n);
      const float e0 = fabsf(it - d1p), e1 = fabsf(ib - d1n);
      const float e2 = fabsf(vt - vc), e3 = fabsf(vb - vc);
      float m0, m1;
      if (mode == 1) {
        m0 = fminf(e0, e1);
        m1 = fminf(e2, e3);
      } else if (mode == 2) {
        m0 = (e0 + e1) * 0.5f;
        m1 = (e2 + e3) * 0.5f;
      } else {
        m0 = fmaxf(e0, e1);
        m1 = fmaxf(e2, e3);
      }
      const float a0 = m0 * rcp0;
      const float a1 = m1 * rcp1;
      const float a2 = fmaxf((vt2 - (float)dabs) * rcp2, 0.0f);
      const float a = fminf(fmaxf(a0, fmaxf(a1, a2)), 1.0f);
      float tl = (1.0f - a) * dlx + a * ci;
      tl = keep ? ci : tl;
      out[o1 + x] = tl;
      nxt[x] = tl;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

}  // namespace

extern "C" {

// Words of global backtrack scratch each line needs (0: it fits the block's
// shared memory).
long long vz_eedi3_scratch_words(int w, int mdis, int hp) {
  const Plan P = plan(w, mdis, hp != 0);
  return P.bt_smem ? 0 : P.bt_words;
}

// r3p..r3n: (lines, w + 192) f32; bmask: (lines, w) bool or null (non-hp
// only); out: (lines, w) f32; fpath: (lines, w) int32; scratch: lines x
// vz_eedi3_scratch_words words, or null when that is 0; all contiguous on
// one device.
int vz_eedi3_fused(const void* r3p, const void* r1p, const void* r1n, const void* r3n,
                   const void* bmask, void* out, void* fpath, void* scratch, int lines, int w,
                   int mdis, int nrad, int hp, float alpha, double beta, float gamma,
                   float omab, float big, void* stream) {
  if (lines == 0 || w == 0) return 0;
  if (mdis < 1 || mdis > 40 || nrad < 0 || nrad > kNradMax || (hp && bmask)) {
    return (int)cudaErrorInvalidValue;
  }
  const float *a = (const float*)r3p, *b = (const float*)r1p;
  const float *c = (const float*)r1n, *d = (const float*)r3n;
  const uint8_t* m = (const uint8_t*)bmask;
  float* o = (float*)out;
  int32_t* f = (int32_t*)fpath;
  uint32_t* sc = (uint32_t*)scratch;
  cudaStream_t s = (cudaStream_t)stream;
  if (hp) {
    return launch_line<true, false>(a, b, c, d, m, o, f, sc, lines, w, mdis, nrad, alpha,
                                    beta, gamma, omab, big, s);
  }
  if (m) {
    return launch_line<false, true>(a, b, c, d, m, o, f, sc, lines, w, mdis, nrad, alpha,
                                    beta, gamma, omab, big, s);
  }
  return launch_line<false, false>(a, b, c, d, m, o, f, sc, lines, w, mdis, nrad, alpha,
                                   beta, gamma, omab, big, s);
}

// dl, cint, out: (n_off, B, w) f32; nb: (n_off, 3, B, w) f32; dm: (n_off, 3,
// B, w) int32; init: (B, w) f32; all contiguous on one device.
int vz_vcheck(const void* dl, const void* nb, const void* dm, const void* cint,
              const void* init, void* out, int n_off, int nbatch, int w, int hp, int mode,
              float rcp0, float rcp1, float rcp2, float vt2, void* stream) {
  if (n_off == 0 || nbatch == 0 || w == 0) return 0;
  const size_t bytes = 2 * sizeof(float) * (size_t)w;
  cudaStream_t s = (cudaStream_t)stream;
  const float *pdl = (const float*)dl, *pnb = (const float*)nb;
  const int32_t* pdm = (const int32_t*)dm;
  const float *pci = (const float*)cint, *pin = (const float*)init;
  float* po = (float*)out;
  cudaError_t err;
  if (hp) {
    err = cudaFuncSetAttribute(vcheck_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    vcheck_kernel<true><<<nbatch, kVcheckThreads, bytes, s>>>(
        pdl, pnb, pdm, pci, pin, po, n_off, nbatch, w, mode, rcp0, rcp1, rcp2, vt2);
  } else {
    err = cudaFuncSetAttribute(vcheck_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    vcheck_kernel<false><<<nbatch, kVcheckThreads, bytes, s>>>(
        pdl, pnb, pdm, pci, pin, po, n_off, nbatch, w, mode, rcp0, rcp1, rcp2, vt2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
