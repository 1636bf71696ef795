// Native PNG scanline unfilter for ImageRead (a copy of the JAX package's
// runtime/native/png_unfilter.cpp).
//
// The reference decodes images with the zigimg library
// (reference src/vapoursynth/image_read.zig); our decoder keeps chunk
// parsing and inflate in Python (zlib is already C), but the sequential
// per-pixel filter reconstruction (PNG spec 4.5.4, notably Paeth) is a
// dependency chain per scanline byte and belongs in native code.
//
// raw: h * (1 + stride) bytes of inflate output (filter byte + scanline).
// out: h * stride reconstructed bytes.  Returns 0 on success, or the
// offending filter type on error.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" int vszip_png_unfilter(const uint8_t *raw, int32_t h,
                                  int32_t stride, int32_t bpp,
                                  uint8_t *out) {
    std::vector<uint8_t> zero(stride, 0);
    const uint8_t *prev = zero.data();
    const uint8_t *p = raw;
    for (int32_t y = 0; y < h; y++) {
        int ft = *p++;
        uint8_t *cur = out + (size_t)y * stride;
        switch (ft) {
        case 0:
            std::memcpy(cur, p, stride);
            break;
        case 1:  // Sub
            for (int32_t i = 0; i < stride; i++) {
                int left = i >= bpp ? cur[i - bpp] : 0;
                cur[i] = (uint8_t)(p[i] + left);
            }
            break;
        case 2:  // Up
            for (int32_t i = 0; i < stride; i++)
                cur[i] = (uint8_t)(p[i] + prev[i]);
            break;
        case 3:  // Average
            for (int32_t i = 0; i < stride; i++) {
                int left = i >= bpp ? cur[i - bpp] : 0;
                cur[i] = (uint8_t)(p[i] + ((left + prev[i]) >> 1));
            }
            break;
        case 4:  // Paeth
            for (int32_t i = 0; i < stride; i++) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev[i];
                int c = i >= bpp ? prev[i - bpp] : 0;
                int pp = a + b - c;
                int pa = std::abs(pp - a);
                int pb = std::abs(pp - b);
                int pc = std::abs(pp - c);
                int pr = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[i] = (uint8_t)(p[i] + pr);
            }
            break;
        default:
            return ft ? ft : -1;
        }
        prev = cur;
        p += stride;
    }
    return 0;
}
