// Deband create-time RNG precompute (native runtime component).
//
// The reference (src/vapoursynth/deband.zig:149-431, itself modeled on
// neo_f3kdb's RNG consumption order) builds per-pixel reference-offset
// planes and grain buffers from one strictly sequential PRNG stream.  The
// stream interleaves grain/ref/chroma draws per pixel, so it cannot be
// vectorized; like the reference we run it natively on the host and hand
// the resulting constant tensors to the device compute path.
//
// A copy of vszip_tpu/runtime/native/deband_rng.cpp: the two packages must
// compute the same create-time state, and tests/test_torch_deband_kernels.py
// holds every array of this one against that one's, exactly.
//
// Differences from the reference's encoding: offsets are emitted as
// separate (dy, dx) planes instead of stride-baked linear offsets, so the
// gathers are stride-free.  The i8 wrap/abs quirk (abs(-128) == -128) is
// preserved via refEncode.
//
// Exposed as a tiny C ABI for ctypes (runtime/deband_rng.py);
// tests/oracle/deband_rng_ref.py is an independent pure-Python
// implementation cross-checked against this one.

#include <cstdint>
#include <cmath>
#include <cstring>

namespace {

enum Algo { ALGO_OLD = 0, ALGO_UNIFORM = 1, ALGO_GAUSSIAN = 2 };

double rand_to_double(int32_t rand_num) {
  uint64_t raw = static_cast<uint32_t>(rand_num);
  raw = ((raw << 20) | (raw >> 12)) & 0xffffffffffffffffULL;
  raw |= 0x3ff0000000000000ULL;
  double val;
  std::memcpy(&val, &raw, 8);
  return (val - 1.0) * 2.0 - 1.0;
}

double rand_old(int32_t* seed) {
  uint32_t u = static_cast<uint32_t>(*seed);
  uint32_t tmp = (((u << 13) ^ u) >> 17) ^ (u << 13) ^ u;
  *seed = static_cast<int32_t>(32u * tmp ^ tmp);
  return rand_to_double(*seed);
}

double rand_uniform(int32_t* seed) {
  *seed = static_cast<int32_t>(1664525u * static_cast<uint32_t>(*seed) +
                               1013904223u);
  return rand_to_double(*seed);
}

double rand_gaussian(int32_t* seed, double param) {
  for (;;) {
    double x, y, r2;
    do {
      x = rand_uniform(seed);
      y = rand_uniform(seed);
      r2 = x * x + y * y;
    } while (!(r2 <= 1.0 && r2 != 0.0));
    double value = param * y * std::sqrt(-2.0 * std::log(r2) / r2);
    if (value > -1.0 && value < 1.0) return value;
  }
}

int32_t random_value(int algo, int32_t* seed, int32_t range, double param) {
  double value;
  switch (algo) {
    case ALGO_OLD: value = rand_old(seed); break;
    case ALGO_GAUSSIAN: value = rand_gaussian(seed, param); break;
    default: value = rand_uniform(seed); break;
  }
  return static_cast<int32_t>(std::llround(value * static_cast<double>(range)));
}

float random_value_float(int algo, int32_t* seed, float range, double param) {
  double value;
  switch (algo) {
    case ALGO_OLD: value = rand_old(seed); break;
    case ALGO_GAUSSIAN: value = rand_gaussian(seed, param); break;
    default: value = rand_uniform(seed); break;
  }
  return static_cast<float>(value * range);
}

// neo stores refs as signed char and re-truncates abs(): abs(-128) -> -128.
int32_t ref_encode(int32_t r) {
  int8_t t = static_cast<int8_t>(r);
  int32_t a = t < 0 ? -static_cast<int32_t>(t) : t;  // 0..128
  return static_cast<int8_t>(static_cast<uint8_t>(a));
}

int32_t min_pos(int32_t a, int32_t b) { return a < b ? a : b; }

}  // namespace

extern "C" {

// Fills (dy, dx) ref-offset planes for luma and chroma, grain buffers, and
// dynamic-grain per-frame offsets.  All output buffers are caller-allocated:
//   ref1_dy/ref1_dx/ref2_dy/ref2_dx: int32[h*w]
//   c_ref1_dy/...: int32[ch*cw]  (chroma; may alias luma arrays when ssw==ssh==0
//                                 is false — always pass distinct buffers)
//   grain_y/grain_c: int16[total_items] (int) or float[total_items] (float)
//   grain_offsets: uint32[num_frames] (only read when dynamic != 0)
// total_items = ((w + 255) & ~127) * h * (dynamic ? 3 : 1).
void vszip_deband_precompute(
    int32_t w, int32_t h, int32_t num_frames, int32_t seed_in,
    int32_t sample_mode, int32_t range, int32_t ssw, int32_t ssh,
    int32_t algo_ref, int32_t algo_grain, double param_ref,
    double param_grain, int32_t is_float, int32_t dynamic,
    int32_t add_grain_y, int32_t add_grain_c, int32_t grain_y_range,
    int32_t grain_c_range, float grain_y_rangef, float grain_c_rangef,
    int32_t* ref1_dy, int32_t* ref1_dx, int32_t* ref2_dy, int32_t* ref2_dx,
    int32_t* c_ref1_dy, int32_t* c_ref1_dx, int32_t* c_ref2_dy,
    int32_t* c_ref2_dx, int16_t* grain_y_i, int16_t* grain_c_i,
    float* grain_y_f, float* grain_c_f, uint32_t* grain_offsets) {
  // seed mixing (reference src/vapoursynth/deband.zig:190-193)
  uint32_t useed = 0x92D68CA2u - static_cast<uint32_t>(seed_in);
  useed ^= (static_cast<uint32_t>(w) << 16) ^ static_cast<uint32_t>(h);
  useed ^= (static_cast<uint32_t>(num_frames) << 16) ^
           static_cast<uint32_t>(num_frames);
  int32_t seed = static_cast<int32_t>(useed);

  const int32_t mask_w = (1 << ssw) - 1;
  const int32_t mask_h = (1 << ssh) - 1;
  const int32_t cw = w >> ssw;

  for (int32_t y = 0; y < h; ++y) {
    int64_t yrow = static_cast<int64_t>(y) * w;
    int64_t crow = static_cast<int64_t>(y >> ssh) * cw;
    int32_t cx = 0;
    for (int32_t x = 0; x < w; ++x) {
      int32_t val1 = 0, val2 = 0;
      (void)random_value(algo_grain, &seed, 1, param_grain);  // keep sequence
      int32_t x_range = min_pos(min_pos(range, x), w - x - 1);
      int32_t y_range = min_pos(min_pos(range, y), h - y - 1);
      int32_t cur_range;
      switch (sample_mode) {
        case 1: cur_range = y_range; break;
        case 3: cur_range = x_range; break;
        default: cur_range = min_pos(x_range, y_range); break;
      }
      if (cur_range > 0) {
        int32_t tmp1 = random_value(algo_ref, &seed, cur_range, param_ref);
        int32_t tmp2 = sample_mode == 2
                           ? random_value(algo_ref, &seed, cur_range, param_ref)
                           : 0;
        val1 = ref_encode(tmp1);
        val2 = ref_encode(tmp2);
      }

      int64_t i = yrow + x;
      switch (sample_mode) {
        case 1:
          ref1_dy[i] = val1; ref1_dx[i] = 0;
          ref2_dy[i] = 0; ref2_dx[i] = 0;
          break;
        case 2:
          ref1_dy[i] = val2; ref1_dx[i] = val1;
          ref2_dy[i] = -val1; ref2_dx[i] = val2;
          break;
        case 3:
          ref1_dy[i] = 0; ref1_dx[i] = val1;
          ref2_dy[i] = 0; ref2_dx[i] = 0;
          break;
        default:  // 4..7
          ref1_dy[i] = val1; ref1_dx[i] = 0;
          ref2_dy[i] = 0; ref2_dx[i] = val1;
          break;
      }

      if (((x & mask_w) == 0) && ((y & mask_h) == 0)) {
        int32_t v1w = val1 >> ssw, v1h = val1 >> ssh;
        int32_t v2h = val2 >> ssh, v2w = val2 >> ssw;
        int64_t ci = crow + cx;
        switch (sample_mode) {
          case 1:
            c_ref1_dy[ci] = v1h; c_ref1_dx[ci] = 0;
            c_ref2_dy[ci] = 0; c_ref2_dx[ci] = 0;
            break;
          case 2:
            c_ref1_dy[ci] = v2h; c_ref1_dx[ci] = v1w;
            c_ref2_dy[ci] = -v1h; c_ref2_dx[ci] = v2w;
            break;
          case 3:
            c_ref1_dy[ci] = 0; c_ref1_dx[ci] = v1w;
            c_ref2_dy[ci] = 0; c_ref2_dx[ci] = 0;
            break;
          default:
            c_ref1_dy[ci] = v1h; c_ref1_dx[ci] = 0;
            c_ref2_dy[ci] = 0; c_ref2_dx[ci] = v1w;
            break;
        }
        (void)random_value(algo_grain, &seed, 1, param_grain);
        (void)random_value(algo_grain, &seed, 1, param_grain);
        ++cx;
      }
    }
  }

  int64_t item_count = (static_cast<int64_t>(w) + 255) & ~127LL;
  item_count *= h;
  int64_t total = item_count * (dynamic ? 3 : 1);

  for (int p = 0; p < 2; ++p) {
    int add = p == 0 ? add_grain_y : add_grain_c;
    if (!add) {
      for (int64_t i = 0; i < total; ++i)
        (void)random_value(algo_grain, &seed, 0, param_grain);
      continue;
    }
    if (is_float) {
      float rng = p == 0 ? grain_y_rangef : grain_c_rangef;
      float* buf = p == 0 ? grain_y_f : grain_c_f;
      for (int64_t i = 0; i < total; ++i)
        buf[i] = random_value_float(algo_grain, &seed, rng, param_grain);
    } else {
      int32_t rng = p == 0 ? grain_y_range : grain_c_range;
      int16_t* buf = p == 0 ? grain_y_i : grain_c_i;
      for (int64_t i = 0; i < total; ++i)
        buf[i] = static_cast<int16_t>(
            random_value(algo_grain, &seed, rng, param_grain));
    }
  }

  if (dynamic) {
    for (int32_t n = 0; n < num_frames; ++n) {
      int32_t offset =
          static_cast<int32_t>(item_count) +
          random_value(ALGO_UNIFORM, &seed, static_cast<int32_t>(item_count),
                       1.0);
      grain_offsets[n] = static_cast<uint32_t>(offset) & 0xfffffff0u;
    }
  }
}

}  // extern "C"
