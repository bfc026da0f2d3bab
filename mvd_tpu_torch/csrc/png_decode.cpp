// PNG scanline decoder of the port's PIL path: host C++, the C++ standard
// library only.
//
// Replaces no TPU kernel. The JAX package opens PNG images with PIL
// (mvd_tpu/utils/images.py:37, mvd_tpu/cli/serve.py:48,
// mvd_tpu/data/objaverse.py:58); the port imports no PIL, so
// mvd_tpu_torch/utils/images.py:decode_png inflates the image data with
// zlib and hands it here. This file undoes the five scanline filters (None,
// Sub, Up, Average, Paeth; the byte to the left is a whole pixel back, or
// one byte at depths below 8) and writes every sample, at any bit depth (1,
// 2, 4, 8 or 16), as one uint16 at its pixel: out is height x width x
// channels. An Adam7 image is unfiltered pass by pass, each pass with its
// own zero row above its first; an empty pass has no bytes. decode_png
// converts the samples to RGB as PIL's convert("RGB") does.
//
// Refused: image data shorter than its rows (at the row it ends in) and an
// unknown filter type, each with a message.
//
// Bound: host work, a few operations per byte; no device part.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct PngError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

inline int paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc) ? b : c;
}

// one row: cur = the filtered bytes in, undone against prev (the row above)
void unfilter_row(int kind, const uint8_t* in, const uint8_t* prev, uint8_t* cur, size_t n, size_t bpp) {
  switch (kind) {
    case 0:
      std::memcpy(cur, in, n);
      break;
    case 1:
      for (size_t i = 0; i < n; ++i) cur[i] = uint8_t(in[i] + (i >= bpp ? cur[i - bpp] : 0));
      break;
    case 2:
      for (size_t i = 0; i < n; ++i) cur[i] = uint8_t(in[i] + prev[i]);
      break;
    case 3:
      for (size_t i = 0; i < n; ++i) cur[i] = uint8_t(in[i] + (((i >= bpp ? cur[i - bpp] : 0) + prev[i]) >> 1));
      break;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        int a = i >= bpp ? cur[i - bpp] : 0, c = i >= bpp ? prev[i - bpp] : 0;
        cur[i] = uint8_t(in[i] + paeth(a, prev[i], c));
      }
      break;
    default:
      throw PngError("unknown filter type " + std::to_string(kind));
  }
}

void copy_error(const char* msg, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// raw: the inflated image data, n bytes; out: h * w * channels uint16.
// Returns 0, or 1 with a message in err.
int mvd_png_samples(const uint8_t* raw, size_t n, int w, int h, int depth, int channels, int interlace,
                    uint16_t* out, char* err, int errlen) {
  try {
    static const int sx[7] = {0, 4, 0, 2, 0, 1, 0}, dx[7] = {8, 8, 4, 4, 2, 2, 1};
    static const int sy[7] = {0, 0, 4, 0, 2, 0, 1}, dy[7] = {8, 8, 8, 4, 4, 2, 2};
    const int passes = interlace ? 7 : 1;
    const size_t bits = size_t(channels) * size_t(depth);
    const size_t bpp = bits >= 8 ? bits / 8 : 1;
    const int mask = (1 << (depth < 8 ? depth : 8)) - 1;
    size_t pos = 0;
    std::vector<uint8_t> prev, cur;
    for (int p = 0; p < passes; ++p) {
      const int x0 = interlace ? sx[p] : 0, ex = interlace ? dx[p] : 1;
      const int y0 = interlace ? sy[p] : 0, ey = interlace ? dy[p] : 1;
      const int pw = w > x0 ? (w - x0 + ex - 1) / ex : 0;
      const int ph = h > y0 ? (h - y0 + ey - 1) / ey : 0;
      if (!pw || !ph) continue;
      const size_t rowbytes = (size_t(pw) * bits + 7) / 8;
      prev.assign(rowbytes, 0);
      cur.assign(rowbytes, 0);
      for (int j = 0; j < ph; ++j) {
        if (pos + 1 + rowbytes > n) throw PngError("PNG image data is truncated");
        try {
          unfilter_row(raw[pos], raw + pos + 1, prev.data(), cur.data(), rowbytes, bpp);
        } catch (const PngError& e) {
          throw PngError("PNG row " + std::to_string(j) + (interlace ? " of pass " + std::to_string(p + 1) : "") +
                         " has " + e.what());
        }
        pos += 1 + rowbytes;
        uint16_t* row = out + (size_t(y0) + size_t(j) * ey) * size_t(w) * channels;
        for (int x = 0; x < pw; ++x) {
          uint16_t* px = row + (size_t(x0) + size_t(x) * ex) * channels;
          for (int c = 0; c < channels; ++c) {
            const size_t i = size_t(x) * channels + c;
            if (depth == 8) {
              px[c] = cur[i];
            } else if (depth == 16) {
              px[c] = uint16_t((cur[2 * i] << 8) | cur[2 * i + 1]);
            } else {
              const size_t bit = i * size_t(depth);
              px[c] = uint16_t((cur[bit >> 3] >> (8 - depth - int(bit & 7))) & mask);
            }
          }
        }
        prev.swap(cur);
      }
    }
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
