// PNG scanline unfiltering (host C++, no libraries).
//
// io/png.py inflates a PNG's IDAT stream with zlib and hands it here: one
// filter-type byte, then `stride` bytes, per row. Sub, Average and Paeth
// depend on the reconstructed byte `bpp` to the left, so the row is a
// serial loop; in Python it costs about a second per 480x640 RGB frame.
//
//   long png_unfilter(const uint8_t* src, size_t height, size_t stride,
//                     size_t bpp, uint8_t* dst)
//
// writes height x stride reconstructed bytes to `dst` and returns 0, or
// returns -1 - row for the first row with a filter type other than 0-4.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

long png_unfilter(const uint8_t* src, size_t height, size_t stride, size_t bpp,
                  uint8_t* dst) {
  for (size_t y = 0; y < height; ++y) {
    const uint8_t filter = src[y * (stride + 1)];
    const uint8_t* in = src + y * (stride + 1) + 1;
    uint8_t* out = dst + y * stride;
    const uint8_t* up = y ? out - stride : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(out, in, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0, b = up ? up[x] : 0;
          out[x] = static_cast<uint8_t>(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? out[x - bpp] : 0, b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          out[x] = static_cast<uint8_t>(in[x] + paeth(a, b, c));
        }
        break;
      default:
        return -1 - static_cast<long>(y);
    }
  }
  return 0;
}

}  // extern "C"
