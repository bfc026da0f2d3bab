// BMP and DIB reader of the port's PIL path: host C++, the C++ standard
// library only.
//
// Replaces no TPU kernel. The JAX package opens images with PIL
// (mvd_tpu/utils/images.py:37, mvd_tpu/cli/serve.py:48,
// mvd_tpu/data/objaverse.py:58); the port imports no PIL, so
// mvd_tpu_torch/utils/images.py:decode_bmp hands BMP files (and DIBs, a
// BMP without its 14-byte file header) here. This file reads them as PIL
// 12.1.0's BmpImagePlugin does, into the image PIL holds before
// convert("RGB") (pil_unpack.h: the layout and PIL's unpackers):
//
//   * headers of 12 bytes (OS/2 1: 16-bit sizes, 3-byte palette entries)
//     and of 40, 52, 56, 64, 108 and 124 bytes (32-bit sizes, top-down
//     where the height's top byte is 0xFF, 4-byte palette entries; a
//     40-byte header's bit fields follow it);
//   * 1-, 4- and 8-bit pixels in mode P, or in mode 1 (two entries black
//     and white) or L (entry i is (i, i, i)) read with those modes' own
//     unpackers, as PIL does whatever the depth; the pixel offset moved
//     past a palette the file header's offset does not count;
//   * 16-, 24- and 32-bit BI_RGB (BGR;15, BGR, BGRX: a 32-bit BI_RGB file
//     is RGB, its fourth byte dropped) and BI_BITFIELDS with PIL's table of
//     masks (RGBA only from masks with alpha);
//   * RLE8 and RLE4 as BmpRleDecoder decodes them: runs clipped at the
//     row's end, absolute runs not, end of line padding with index 0, a
//     delta that reads four bytes and uses the last two, word alignment by
//     the file offset, an end of bitmap or of data before the last pixel
//     refused as PIL's "not enough image data";
//   * rows bottom-up or top-down, each padded to 4 bytes.
//
// Refused as PIL refuses: another header size, depth or compression, a
// bit-field layout outside PIL's table, a palette of over 256 entries or
// none, an RLE file in mode 1 or RGB, pixel data shorter than its rows, an
// image of zero or more pixels than PIL's decompression-bomb limit.
//
// Bound: host work, a few operations per pixel; no device part.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "pil_unpack.h"

namespace {

constexpr int64_t kMaxPixels = 2 * int64_t(89478485);  // PIL's bomb limit, twice MAX_IMAGE_PIXELS

struct Fail : std::runtime_error {
  using std::runtime_error::runtime_error;
};
[[noreturn]] void fail(const std::string& what) { throw Fail("BMP: " + what); }

uint32_t le16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
uint32_t le32(const uint8_t* p) { return le16(p) | le16(p + 2) << 16; }

struct Bmp {
  int64_t width = 0, height = 0;
  int bits = 0, direction = -1;
  uint32_t compression = 0;
  std::string mode, rawmode;
  std::vector<uint8_t> palette;  // RGB triplets as PIL stores them (mode P)
  size_t offset = 0;             // the pixel data
  bool rle = false, rle4 = false;
};

Bmp parse(const uint8_t* data, size_t size) {
  size_t pos = 0, offset = 0;
  const bool bm = size >= 2 && data[0] == 'B' && data[1] == 'M';
  if (bm) {
    if (size < 14) fail("the file header is cut");
    offset = le32(data + 10);
    pos = 14;
  }
  if (size < pos + 4) fail("the bitmap header is cut");
  const uint32_t header_size = le32(data + pos);
  pos += 4;
  if (header_size < 4 || size - pos < header_size - 4) fail("Truncated File Read (the bitmap header)");
  const uint8_t* h = data + pos;
  pos += header_size - 4;
  Bmp b;
  int palette_padding = 4;
  uint32_t colors = 0, masks[4] = {0, 0, 0, 0};
  if (header_size == 12) {
    b.width = le16(h);
    b.height = le16(h + 2);
    b.bits = int(le16(h + 6));
    palette_padding = 3;
  } else if (header_size == 40 || header_size == 52 || header_size == 56 || header_size == 64 ||
             header_size == 108 || header_size == 124) {
    const bool flip = h[7] == 0xFF;
    b.direction = flip ? 1 : -1;
    b.width = le32(h);
    b.height = flip ? (int64_t(1) << 32) - le32(h + 4) : int64_t(le32(h + 4));
    b.bits = int(le16(h + 10));
    b.compression = le32(h + 12);
    colors = le32(h + 28);
    if (b.compression == 3) {
      if (header_size - 4 >= 48) {
        for (int k = 0; k < 3; ++k) masks[k] = le32(h + 36 + 4 * k);
        masks[3] = header_size - 4 >= 52 ? le32(h + 48) : 0;
      } else {
        for (int k = 0; k < 3; ++k) {
          if (size < pos + 4) fail("the bit fields are cut");
          masks[k] = le32(data + pos);
          pos += 4;
        }
      }
    }
  } else {
    fail("Unsupported BMP header type (" + std::to_string(header_size) + ")");
  }
  if (!colors) colors = b.bits < 32 ? uint32_t(1) << b.bits : 0;  // 1 << 32: only its use below matters
  if (bm && offset == 14 + header_size && b.bits <= 8) offset += 4 * size_t(colors);
  switch (b.bits) {
    case 1: b.mode = "P", b.rawmode = "P;1"; break;
    case 4: b.mode = "P", b.rawmode = "P;4"; break;
    case 8: b.mode = "P", b.rawmode = "P"; break;
    case 16: b.mode = "RGB", b.rawmode = "BGR;15"; break;
    case 24: b.mode = "RGB", b.rawmode = "BGR"; break;
    case 32: b.mode = "RGB", b.rawmode = "BGRX"; break;
    default: fail("Unsupported BMP pixel depth (" + std::to_string(b.bits) + ")");
  }
  if (b.compression == 3) {
    const uint32_t m0 = masks[0], m1 = masks[1], m2 = masks[2], m3 = masks[3];
    auto is = [&](uint32_t r, uint32_t g, uint32_t bl, uint32_t a) {
      return m0 == r && m1 == g && m2 == bl && m3 == a;
    };
    auto is3 = [&](uint32_t r, uint32_t g, uint32_t bl) { return m0 == r && m1 == g && m2 == bl; };
    const char* raw = nullptr;
    if (b.bits == 32) {
      if (is(0xFF0000, 0xFF00, 0xFF, 0)) raw = "BGRX";
      else if (is(0xFF000000, 0xFF0000, 0xFF00, 0)) raw = "XBGR";
      else if (is(0xFF000000, 0xFF00, 0xFF, 0)) raw = "BGXR";
      else if (is(0xFF000000, 0xFF0000, 0xFF00, 0xFF)) raw = "ABGR";
      else if (is(0xFF, 0xFF00, 0xFF0000, 0xFF000000)) raw = "RGBA";
      else if (is(0xFF0000, 0xFF00, 0xFF, 0xFF000000)) raw = "BGRA";
      else if (is(0xFF000000, 0xFF00, 0xFF, 0xFF0000)) raw = "BGAR";
      else if (is(0, 0, 0, 0)) raw = "BGRA";
      if (raw && std::strchr(raw, 'A')) b.mode = "RGBA";
    } else if (b.bits == 24) {
      if (is3(0xFF0000, 0xFF00, 0xFF)) raw = "BGR";
    } else if (b.bits == 16) {
      if (is3(0xF800, 0x7E0, 0x1F)) raw = "BGR;16";
      else if (is3(0x7C00, 0x3E0, 0x1F)) raw = "BGR;15";
    }
    if (!raw) fail("Unsupported BMP bitfields layout");
    b.rawmode = raw;
  } else if (b.compression == 1 || b.compression == 2) {
    b.rle = true;
    b.rle4 = b.compression == 2;
  } else if (b.compression != 0) {
    fail("Unsupported BMP compression (" + std::to_string(b.compression) + ")");
  }
  if (b.mode == "P") {
    if (colors == 0 || colors > 65536) fail("Unsupported BMP Palette size (" + std::to_string(colors) + ")");
    const size_t want = size_t(palette_padding) * colors;
    const size_t got = pos < size ? std::min(want, size - pos) : 0;
    const uint8_t* pal = data + pos;
    pos += got;
    bool gray = true;
    for (uint32_t i = 0; i < colors && gray; ++i) {
      const uint32_t val = colors == 2 ? (i ? 255 : 0) : i;
      const size_t at = size_t(i) * palette_padding;
      // PIL compares the entry's bytes that were read with (val, val, val)
      if (at + 3 > got) {
        gray = false;
        break;
      }
      for (int k = 0; k < 3; ++k) gray = gray && pal[at + size_t(k)] == uint8_t(val & 255);
    }
    if (gray) {
      b.mode = colors == 2 ? "1" : "L";
      b.rawmode = b.mode;
    } else {
      const size_t entries = got / size_t(palette_padding);
      if (entries > 256) fail("palette of " + std::to_string(entries) + " entries (PIL: invalid palette size)");
      b.palette.resize(entries * 3);
      for (size_t i = 0; i < entries; ++i)
        for (int k = 0; k < 3; ++k) b.palette[3 * i + size_t(k)] = pal[i * palette_padding + size_t(2 - k)];
    }
  }
  if (b.width <= 0 || b.height <= 0) fail("an image of zero width or height");
  if (b.width * b.height > kMaxPixels)
    fail("image of " + std::to_string(b.width) + "x" + std::to_string(b.height) + " pixels is over the limit of " +
         std::to_string(kMaxPixels) + " pixels (PIL's decompression-bomb limit)");
  if (b.rle && b.mode != "P" && b.mode != "L")
    fail("RLE pixels in mode " + b.mode + " (PIL: unknown raw mode)");
  b.offset = offset ? offset : pos;
  return b;
}

// BmpRleDecoder.decode: one index a byte, rows of `width` from the first
// row of the data's order
std::vector<uint8_t> rle_decode(const uint8_t* data, size_t size, const Bmp& b) {
  std::vector<uint8_t> out;
  const size_t w = size_t(b.width), dest = w * size_t(b.height);
  out.reserve(dest);
  size_t pos = b.offset, x = 0;
  auto read = [&](size_t n, size_t* got) {  // fd.read(n): the start, and *got bytes
    size_t at = pos;
    *got = pos < size ? std::min(n, size - pos) : 0;
    pos += *got;
    return at;
  };
  while (out.size() < dest) {
    size_t g1, g2;
    size_t a1 = read(1, &g1), a2 = read(1, &g2);
    if (!g1 || !g2) break;
    size_t num = data[a1];
    const uint8_t byte = data[a2];
    if (num) {
      if (x + num > w) num = x < w ? w - x : 0;
      for (size_t i = 0; i < num; ++i) out.push_back(b.rle4 ? ((i & 1) ? byte & 0x0F : byte >> 4) : byte);
      x += num;
    } else if (byte == 0) {
      while (out.size() % w) out.push_back(0);
      x = 0;
    } else if (byte == 1) {
      break;
    } else if (byte == 2) {
      size_t g;
      read(2, &g);
      if (g < 2) break;
      size_t at = read(2, &g);
      if (g < 2) fail("a delta is cut (PIL: not enough values to unpack)");
      out.insert(out.end(), size_t(data[at]) + size_t(data[at + 1]) * w, 0);
      x = out.size() % w;
    } else {
      size_t count = b.rle4 ? byte / 2 : byte, g;
      size_t at = read(count, &g);
      for (size_t i = 0; i < g; ++i) {
        if (b.rle4) {
          out.push_back(data[at + i] >> 4);
          out.push_back(data[at + i] & 0x0F);
        } else {
          out.push_back(data[at + i]);
        }
      }
      if (g < count) break;
      x += byte;
      if (pos % 2) ++pos;
    }
  }
  if (out.size() < dest) fail("not enough image data (the RLE pixels end before the last row)");
  return out;
}

void decode(const uint8_t* data, size_t size, const Bmp& b, uint8_t* image) {
  const int w = int(b.width), h = int(b.height);
  if (b.rle) {
    std::vector<uint8_t> idx = rle_decode(data, size, b);
    for (int i = 0; i < h; ++i) {
      int y = b.direction < 0 ? h - 1 - i : i;
      std::memcpy(image + size_t(y) * w, idx.data() + size_t(i) * w, size_t(w));
    }
    return;
  }
  pil::Raw u = pil::find(b.mode, b.rawmode);
  if (!u.fn) fail("no unpacker for " + b.rawmode);
  const int64_t stride = ((b.width * b.bits + 31) >> 3) & ~int64_t(3);
  const uint8_t* start = data + std::min(b.offset, size);
  const size_t avail = b.offset < size ? size - b.offset : 0;
  if (!pil::raw_decode(u, start, avail, stride, b.direction, image, w, 0, 0, w, h))
    fail("image file is truncated (the pixel data is shorter than its rows)");
}

void copy_error(const char* what, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", what);
}

}  // namespace

extern "C" {

// The image's size, PIL's mode (up to 7 characters and a zero into
// `mode`) and the palette's entries. Returns 0, or 1 with a message in err.
int mvd_bmp_info(const uint8_t* data, size_t size, int* width, int* height, char* mode, int* entries, char* err,
                 int errlen) {
  try {
    Bmp b = parse(data, size);
    *width = int(b.width);
    *height = int(b.height);
    std::snprintf(mode, 8, "%s", b.mode.c_str());
    *entries = int(b.palette.size() / 3);
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// The tile PIL's BmpImagePlugin sets up: whether its decoder is the raw
// one with the rawmode equal to the mode (the tile ImageFile.load can
// memory-map), the pixel data's offset, its row stride and its direction
// (1 top-down, -1 bottom-up); the palette into `palette` (entries * 3
// bytes). Returns 0, or 1 with a message in err.
int mvd_bmp_layout(const uint8_t* data, size_t size, int* raw_is_mode, int64_t* offset, int64_t* stride,
                   int* direction, uint8_t* palette, char* err, int errlen) {
  try {
    Bmp b = parse(data, size);
    if (!b.palette.empty()) std::memcpy(palette, b.palette.data(), b.palette.size());
    *raw_is_mode = !b.rle && b.rawmode == b.mode;
    *offset = int64_t(b.offset);
    *stride = ((b.width * b.bits + 31) >> 3) & ~int64_t(3);
    *direction = b.direction;
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// The pixels into `image` (zeros, width * height * the mode's pixel size
// bytes) and the palette into `palette` (entries * 3 bytes). Returns 0, or
// 1 with a message in err.
int mvd_bmp_decode(const uint8_t* data, size_t size, uint8_t* image, int width, int height, uint8_t* palette,
                   char* err, int errlen) {
  try {
    Bmp b = parse(data, size);
    if (b.width != width || b.height != height) fail("the image size changed");
    if (!b.palette.empty()) std::memcpy(palette, b.palette.data(), b.palette.size());
    decode(data, size, b, image);
    return 0;
  } catch (const std::bad_alloc&) {
    copy_error("BMP: out of memory", err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
