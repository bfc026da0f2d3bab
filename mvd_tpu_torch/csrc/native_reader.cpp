// The port's native Objaverse view reader: host C++, the C++ standard
// library only.
//
// Replaces no TPU kernel. Counterpart of the JAX package's C++ reader
// (native/mvd_native.cpp, bound by mvd_tpu/data/native_loader.py), which
// ObjaverseDataset uses whenever g++ and libpng build it. Its function is
// that reader's, split differently: Python's zipfile finds the member (the
// JAX reader's suffix match on a path boundary) and Python's zlib inflates
// IDAT (mvd_tpu_torch/data/native_loader.py); this file does the rest.
//
//   * mvd_png_rgba: the PNG scanline unfilter (Adam7 passes included, as
//     png_read_image handles them) and libpng's expansion to 8-bit RGBA as
//     mvd_native.cpp:153-160 sets it up: strip_16 (the high byte),
//     palette -> RGB, sub-byte gray scaled to 8 bits, tRNS -> alpha (for
//     gray and RGB the sample compared before the strip), gray -> RGB and
//     the filler 0xFF after the colour;
//   * mvd_composite_resize_normalize: mvd_native.cpp:170-200 in the same
//     float order: centre-aligned sampling, the y0/wy and x0/wx clamps,
//     each of the four taps composited over white before the lerps, then
//     v * 2 - 1.
//
// Built with -ffp-contract=off and without -march=native
// (mvd_tpu_torch/kernels/_build.py:HOST_FLAGS): the JAX build's
// -march=native lets GCC contract a*b+c into an FMA where the host has one,
// so its output depends on the machine (up to ~4e-7); this build's is the
// same on every host and bitwise native_loader.load_view_plain's.
//
// Bound: host work; the inflate (zlib, in Python) and this pass over the
// pixels, a few tens of float operations per output value.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct PngError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

int paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc) ? b : c;
}

// Undo the filters of `rows` rows of `rowbytes` bytes read from raw at pos.
void unfilter(const uint8_t* raw, size_t n, size_t& pos, int rows, size_t rowbytes, int bpp,
              std::vector<uint8_t>& out) {
  out.assign(size_t(rows) * rowbytes, 0);
  std::vector<uint8_t> zero(rowbytes, 0);
  for (int y = 0; y < rows; ++y) {
    if (pos + 1 + rowbytes > n) throw PngError("PNG image data is truncated");
    int kind = raw[pos];
    const uint8_t* in = raw + pos + 1;
    uint8_t* cur = out.data() + size_t(y) * rowbytes;
    const uint8_t* up = y ? cur - rowbytes : zero.data();
    for (size_t i = 0; i < rowbytes; ++i) {
      int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
      int b = up[i];
      int c = i >= size_t(bpp) ? up[i - bpp] : 0;
      int pred;
      switch (kind) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: throw PngError("PNG row has unknown filter type " + std::to_string(kind));
      }
      cur[i] = uint8_t(in[i] + pred);
    }
    pos += 1 + rowbytes;
  }
}

struct Format {
  int depth, colour, channels;
  const uint8_t* plte;  // 256 x 3, zero past the PLTE chunk
  const uint8_t* alpha;  // 256 palette alphas, 255 past the tRNS chunk
  bool trns;             // a tRNS chunk for gray or RGB
  int tr, tg, tb;        // its 16-bit samples
};

int sample(const uint8_t* row, int i, int depth) {
  if (depth == 8) return row[i];
  if (depth == 16) return (row[2 * i] << 8) | row[2 * i + 1];
  int bit = i * depth;
  return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
}

// One unfiltered row of w pixels -> RGBA, pixel x to rgba + x * step * 4.
void expand_row(const uint8_t* row, int w, const Format& f, uint8_t* rgba, int step) {
  for (int x = 0; x < w; ++x) {
    uint8_t* o = rgba + size_t(x) * step * 4;
    const int ch = f.channels;
    if (f.colour == 3) {
      int idx = sample(row, x, f.depth);
      o[0] = f.plte[3 * idx];
      o[1] = f.plte[3 * idx + 1];
      o[2] = f.plte[3 * idx + 2];
      o[3] = f.alpha[idx];
      continue;
    }
    int s[4];
    for (int c = 0; c < ch; ++c) s[c] = sample(row, x * ch + c, f.depth);
    int hi[4];
    for (int c = 0; c < ch; ++c) {
      if (f.depth == 16) hi[c] = s[c] >> 8;
      else if (f.depth == 8) hi[c] = s[c];
      else hi[c] = s[c] * (255 / ((1 << f.depth) - 1));  // 1, 2, 4 bits: x255, x85, x17
    }
    if (f.colour == 0 || f.colour == 4) {
      o[0] = o[1] = o[2] = uint8_t(hi[0]);
    } else {
      o[0] = uint8_t(hi[0]);
      o[1] = uint8_t(hi[1]);
      o[2] = uint8_t(hi[2]);
    }
    if (f.colour == 4 || f.colour == 6) {
      o[3] = uint8_t(hi[ch - 1]);
    } else if (!f.trns) {
      o[3] = 255;
    } else if (f.colour == 0) {
      // libpng's png_do_expand: the sample against the tRNS gray, both
      // scaled to 8 bits below 8, the low byte at 8, all 16 bits at 16
      int t = f.tr;
      bool match = f.depth < 8 ? hi[0] == (t & ((1 << f.depth) - 1)) * (255 / ((1 << f.depth) - 1))
                   : f.depth == 8 ? s[0] == (t & 0xFF)
                                  : s[0] == t;
      o[3] = match ? 0 : 255;
    } else {
      bool match = f.depth == 8 ? s[0] == (f.tr & 0xFF) && s[1] == (f.tg & 0xFF) && s[2] == (f.tb & 0xFF)
                                : s[0] == f.tr && s[1] == f.tg && s[2] == f.tb;
      o[3] = match ? 0 : 255;
    }
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

// raw: the inflated IDAT stream of a w x h PNG of the given bit depth,
// colour type and interlace method; plte: nplte RGB entries (palette
// images); trns: the tRNS chunk's bytes (ntrns = 0 without one). Writes
// rgba (h * w * 4). Returns 0, or 1 with a message in err.
int mvd_png_rgba(const uint8_t* raw, size_t n, int w, int h, int depth, int colour, int interlace,
                 const uint8_t* plte, int nplte, const uint8_t* trns, int ntrns, uint8_t* rgba, char* err,
                 int errlen) {
  try {
    static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
    if (colour < 0 || colour > 6 || !kChannels[colour])
      throw PngError("PNG colour type " + std::to_string(colour) + " is not a valid type");
    bool depth_ok = (colour == 0 && (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16)) ||
                    (colour == 3 && (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
                    ((colour == 2 || colour == 4 || colour == 6) && (depth == 8 || depth == 16));
    if (!depth_ok) throw PngError("PNG bit depth " + std::to_string(depth) + " is invalid for its colour type");
    if (interlace != 0 && interlace != 1) throw PngError("PNG interlace method is unknown");
    if (w <= 0 || h <= 0) throw PngError("PNG has no pixels");
    uint8_t pal[256 * 3] = {0};
    uint8_t alpha[256];
    std::memset(alpha, 255, sizeof alpha);
    Format f{depth, colour, kChannels[colour], pal, alpha, false, 0, 0, 0};
    if (colour == 3) {
      if (nplte <= 0) throw PngError("palette PNG has no PLTE chunk");
      std::memcpy(pal, plte, size_t(nplte < 256 ? nplte : 256) * 3);
      // libpng drops a palette tRNS longer than the palette (a benign error)
      if (ntrns > 0 && ntrns <= nplte) std::memcpy(alpha, trns, size_t(ntrns));
    } else if (colour == 0 && ntrns == 2) {
      f.trns = true;
      f.tr = (trns[0] << 8) | trns[1];
    } else if (colour == 2 && ntrns == 6) {
      f.trns = true;
      f.tr = (trns[0] << 8) | trns[1];
      f.tg = (trns[2] << 8) | trns[3];
      f.tb = (trns[4] << 8) | trns[5];
    }
    const int bits = f.channels * depth;
    const int bpp = bits >= 8 ? bits / 8 : 1;
    size_t pos = 0;
    std::vector<uint8_t> rows;
    if (interlace == 0) {
      size_t rowbytes = (size_t(w) * bits + 7) / 8;
      unfilter(raw, n, pos, h, rowbytes, bpp, rows);
      for (int y = 0; y < h; ++y) expand_row(&rows[size_t(y) * rowbytes], w, f, rgba + size_t(y) * w * 4, 1);
      return 0;
    }
    static const int sx[7] = {0, 4, 0, 2, 0, 1, 0}, dx[7] = {8, 8, 4, 4, 2, 2, 1};
    static const int sy[7] = {0, 0, 4, 0, 2, 0, 1}, dy[7] = {8, 8, 8, 4, 4, 2, 2};
    for (int p = 0; p < 7; ++p) {
      int pw = w > sx[p] ? (w - sx[p] + dx[p] - 1) / dx[p] : 0;
      int ph = h > sy[p] ? (h - sy[p] + dy[p] - 1) / dy[p] : 0;
      if (!pw || !ph) continue;
      size_t rowbytes = (size_t(pw) * bits + 7) / 8;
      unfilter(raw, n, pos, ph, rowbytes, bpp, rows);
      for (int j = 0; j < ph; ++j) {
        size_t y = size_t(sy[p]) + size_t(j) * dy[p];
        expand_row(&rows[size_t(j) * rowbytes], pw, f, rgba + (y * w + sx[p]) * 4, dx[p]);
      }
    }
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// RGBA -> white-composited RGB in [0,1], bilinear resize to s x s, then
// [-1, 1]: mvd_native.cpp's composite_resize_normalize, operation for
// operation.
void mvd_composite_resize_normalize(const uint8_t* rgba, int w, int h, int s, float* out) {
  const float inv255 = 1.0f / 255.0f;
  for (int oy = 0; oy < s; ++oy) {
    float fy = (oy + 0.5f) * h / s - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int ox = 0; ox < s; ++ox) {
      float fx = (ox + 0.5f) * w / s - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      float* dst = out + (size_t(oy) * s + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        auto px = [&](int x, int y) {
          const uint8_t* p = &rgba[(size_t(y) * w + x) * 4];
          float a = p[3] * inv255;
          return (p[c] * inv255) * a + (1.0f - a);
        };
        float top = px(x0, y0) * (1 - wx) + px(x1, y0) * wx;
        float bot = px(x0, y1) * (1 - wx) + px(x1, y1) * wx;
        float v = top * (1 - wy) + bot * wy;
        dst[c] = v * 2.0f - 1.0f;
      }
    }
  }
}

}  // extern "C"
