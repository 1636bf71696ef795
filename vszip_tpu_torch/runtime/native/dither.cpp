// Error-diffusion depth demotion (zimg `dither_type="error_diffusion"`
// semantics) used by Deband's <16-bit round trip
// (reference src/vapoursynth/deband.zig:492-497 invokes Resize.Point with
// error_diffusion; the conversion itself is zimg's).
//
// Floyd-Steinberg in gather form, left-to-right, top-to-bottom, f32 error
// accumulation:
//   x   = src[j] * scale
//   err = left*7/16 + top_right*3/16 + top*5/16 + top_left*1/16
//   q   = clamp(lrintf(x + err), 0, peak)      (round half to even)
//   e   = (x + err) - q
// Validated against the reference's goldens/deband.json 8-bit cases
// (GRAY8 / YUV420P8 / YUV422P8 round trips pin the dithered output).
//
// A copy of vszip_tpu/runtime/native/dither.cpp.  Built by
// vszip_tpu_torch/_build.py: g++ -O2 -fPIC -shared into build/vszip_tpu_torch/.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" void vszip_error_diffusion_u16(
    const uint16_t* src, uint16_t* dst, int32_t w, int32_t h,
    float scale, int32_t peak) {
  std::vector<float> err_top(static_cast<size_t>(w) + 2, 0.0f);
  std::vector<float> err_cur(static_cast<size_t>(w) + 2, 0.0f);

  for (int32_t i = 0; i < h; ++i) {
    const uint16_t* src_p = src + static_cast<size_t>(i) * w;
    uint16_t* dst_p = dst + static_cast<size_t>(i) * w;
    float err_left = 0.0f;

    for (int32_t j = 0; j < w; ++j) {
      const int32_t je = j + 1;
      float x = static_cast<float>(src_p[j]) * scale;
      float err = err_left * (7.0f / 16.0f);
      err += err_top[je + 1] * (3.0f / 16.0f);
      err += err_top[je] * (5.0f / 16.0f);
      err += err_top[je - 1] * (1.0f / 16.0f);
      x += err;

      long q = lrintf(x);
      if (q < 0) q = 0;
      if (q > peak) q = peak;
      const float e = x - static_cast<float>(q);

      err_left = e;
      err_cur[je] = e;
      dst_p[j] = static_cast<uint16_t>(q);
    }
    err_top.swap(err_cur);
  }
}
