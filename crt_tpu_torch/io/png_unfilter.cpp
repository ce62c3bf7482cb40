// PNG row filters undone in one pass, row by row (PNG spec section 9):
// the native path of crt_tpu_torch/io/png.py's _unfilter.  Built with g++
// into the library scene/native_accel.py compiles at first use.

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

// raw: uint8 [h, 1 + l], each row its filter byte then l filtered bytes;
// bpp: the bytes of a complete pixel (1 below 8 bits); out: uint8 [h, l].
// Returns 0, or the first filter byte above 4 (nothing past its row is
// written).
int32_t crt_png_unfilter(const uint8_t* raw, int64_t h, int64_t l,
                         int32_t bpp, uint8_t* out) {
  const int64_t n = bpp < l ? bpp : l;  // bytes with no left neighbour
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* src = raw + r * (l + 1);
    const uint8_t filter = src[0];
    ++src;
    uint8_t* cur = out + r * l;
    const uint8_t* up = r > 0 ? out + (r - 1) * l : nullptr;
    switch (filter) {
      case 0:  // None
        std::memcpy(cur, src, static_cast<size_t>(l));
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < n; ++i) cur[i] = src[i];
        for (int64_t i = n; i < l; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + cur[i - bpp]);
        break;
      case 2:  // Up
        if (up) {
          for (int64_t i = 0; i < l; ++i)
            cur[i] = static_cast<uint8_t>(src[i] + up[i]);
        } else {
          std::memcpy(cur, src, static_cast<size_t>(l));
        }
        break;
      case 3:  // Average
        if (up) {
          for (int64_t i = 0; i < n; ++i)
            cur[i] = static_cast<uint8_t>(src[i] + (up[i] >> 1));
          for (int64_t i = n; i < l; ++i)
            cur[i] = static_cast<uint8_t>(
                src[i] + ((cur[i - bpp] + up[i]) >> 1));
        } else {
          for (int64_t i = 0; i < n; ++i) cur[i] = src[i];
          for (int64_t i = n; i < l; ++i)
            cur[i] = static_cast<uint8_t>(src[i] + (cur[i - bpp] >> 1));
        }
        break;
      case 4:  // Paeth: with no row above, b = c = 0 and it takes a
        if (up) {
          for (int64_t i = 0; i < n; ++i)
            cur[i] = static_cast<uint8_t>(src[i] + up[i]);
          for (int64_t i = n; i < l; ++i)
            cur[i] = static_cast<uint8_t>(
                src[i] + paeth(cur[i - bpp], up[i], up[i - bpp]));
        } else {
          for (int64_t i = 0; i < n; ++i) cur[i] = src[i];
          for (int64_t i = n; i < l; ++i)
            cur[i] = static_cast<uint8_t>(src[i] + cur[i - bpp]);
        }
        break;
      default:
        return filter;
    }
  }
  return 0;
}

}  // extern "C"
