// Row reconstruction of PNG image data, for codd_torch/data/native.py.
//
// The caller parses the chunks and inflates IDAT with Python's zlib; this
// library takes the inflated, filtered rows and undoes the five filter
// types of the PNG specification (section 9: None, Sub, Up, Average,
// Paeth).  Each byte of an Average or Paeth row depends on the byte
// reconstructed `bpp` to its left, so those rows run byte by byte: here
// in C++, one call an image, with the GIL released by ctypes.
//
// Plain C interface, no zlib and no other library: built with
//   g++ -O3 -shared -fPIC -std=c++17 png_codec.cpp -o png_codec.so

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// raw: height rows of (1 filter byte + stride bytes); px: height x stride
// bytes out.  bpp: bytes a pixel (at least 1).  Returns 0, or y + 1 for
// the first row y whose filter type is not 0-4.
int png_unfilter(const uint8_t* raw, uint8_t* px, int64_t height,
                 int64_t stride, int bpp) {
  const uint8_t* up = nullptr;  // the reconstructed row above; none for row 0
  const int64_t lead = bpp < stride ? bpp : stride;
  for (int64_t y = 0; y < height; y++) {
    const uint8_t* src = raw + y * (stride + 1);
    const uint8_t kind = *src++;
    uint8_t* dst = px + y * stride;
    switch (kind) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        std::memcpy(dst, src, lead);
        for (int64_t x = bpp; x < stride; x++)
          dst[x] = (uint8_t)(src[x] + dst[x - bpp]);
        break;
      case 2:
        if (up) {
          for (int64_t x = 0; x < stride; x++) dst[x] = (uint8_t)(src[x] + up[x]);
        } else {
          std::memcpy(dst, src, stride);
        }
        break;
      case 3:
        if (up) {
          for (int64_t x = 0; x < lead; x++)
            dst[x] = (uint8_t)(src[x] + (up[x] >> 1));
          for (int64_t x = bpp; x < stride; x++)
            dst[x] = (uint8_t)(src[x] + ((dst[x - bpp] + up[x]) >> 1));
        } else {
          std::memcpy(dst, src, lead);
          for (int64_t x = bpp; x < stride; x++)
            dst[x] = (uint8_t)(src[x] + (dst[x - bpp] >> 1));
        }
        break;
      case 4:
        if (up) {  // a = c = 0 in the first pixel: the predictor is b
          for (int64_t x = 0; x < lead; x++) dst[x] = (uint8_t)(src[x] + up[x]);
          for (int64_t x = bpp; x < stride; x++)
            dst[x] = (uint8_t)(src[x] + paeth(dst[x - bpp], up[x], up[x - bpp]));
        } else {   // b = c = 0: the predictor is a, as in Sub
          std::memcpy(dst, src, lead);
          for (int64_t x = bpp; x < stride; x++)
            dst[x] = (uint8_t)(src[x] + dst[x - bpp]);
        }
        break;
      default:
        return (int)(y + 1);
    }
    up = dst;
  }
  return 0;
}

}  // extern "C"
