// GIF reader of the port's PIL path: host C++, the C++ standard library
// only.
//
// Replaces no TPU kernel. The JAX package opens images with PIL
// (mvd_tpu/utils/images.py:37, mvd_tpu/cli/serve.py:48,
// mvd_tpu/data/objaverse.py:58); the port imports no PIL, so
// mvd_tpu_torch/utils/images.py:decode_gif hands GIF files here. This file
// reads the first frame as PIL 12.1.0 does (GifImagePlugin.py and
// GifDecode.c), into the image PIL holds before convert("RGB"):
//
//   * the logical screen, its global colour table and the blocks before
//     the first image descriptor as GifImagePlugin._seek(0) walks them: an
//     extension's sub-blocks read as its `data()` reads them (a graphic
//     control extension of size 0 leaves its terminator to the loop that
//     skips sub-blocks, which then eats the next block's bytes, as PIL
//     does), a comment, an application extension, any other byte skipped;
//   * the mode: P where the frame's colour table (local, else global) is
//     not the identity gray ramp PIL drops, else L; the table as PIL
//     stores it (entries past it are black);
//   * a frame reaching past the screen grows the image to hold it;
//     outside the frame the image is the graphic control extension's
//     transparency index where there is one (GifImagePlugin.py:440-443),
//     else 0;
//   * the LZW stream as GifDecode.c reads it: codes of the initial size +
//     1 bits, least significant first, across sub-blocks; clear and end
//     codes; a table of 4096 entries (no entry is added once it is full;
//     the code size stops at 12 bits); the code equal to the next free
//     entry; an end code that is not at the image's end is read past, as
//     PIL's load loop hands the decoder the rest of the file; rows
//     interlaced in GIF's four passes; decoding ends at the frame's last
//     pixel.
//
// A frame of width 0 at x 0 is the whole image, as PIL's setimage takes
// it. Refused as PIL refuses: no image descriptor, a frame of zero width or
// height elsewhere, an initial code size over 12, a code past the next free entry
// or a first code after a clear above the clear code, a string longer than
// the 4096-byte stack, data ending before the frame's last pixel, an image
// of more pixels than PIL's decompression-bomb limit.
//
// Bound: host work, a few operations per pixel; no device part.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

constexpr int64_t kMaxPixels = 2 * int64_t(89478485);  // PIL's bomb limit, twice MAX_IMAGE_PIXELS
constexpr int kTable = 4096;                           // GIFTABLE

struct Fail : std::runtime_error {
  using std::runtime_error::runtime_error;
};
[[noreturn]] void fail(const std::string& what) { throw Fail("GIF: " + what); }

uint32_t le16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }

struct Frame {
  int width = 0, height = 0;        // the image, grown to hold the frame
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  bool palette_mode = false;        // P, else L
  std::vector<uint8_t> palette;     // RGB triplets as PIL stores them
  int transparency = -1;            // the fill outside the frame, or -1 (0)
  bool interlace = false;
  int bits = 0;                     // LZW's initial code size
  size_t offset = 0;                // the first sub-block of image data
};

// GifImagePlugin._is_palette_needed: false for the identity gray ramp
bool palette_needed(const std::vector<uint8_t>& p) {
  for (size_t i = 0; i < p.size(); i += 3)
    if (!(i / 3 == p[i] && p[i] == p[i + 1] && p[i + 1] == p[i + 2])) return true;
  return false;
}

struct Reader {
  const uint8_t* d;
  size_t n, pos = 0;
  // fp.read(k): at most k bytes
  std::vector<uint8_t> read(size_t k) {
    size_t take = pos < n ? std::min(k, n - pos) : 0;
    std::vector<uint8_t> out(d + pos, d + pos + take);
    pos += take;
    return out;
  }
  int byte() {  // fp.read(1)[0], or -1 at the end
    if (pos >= n) return -1;
    return d[pos++];
  }
  // GifImageFile.data(): a sub-block, or nothing (size 0 or the end)
  bool data(std::vector<uint8_t>* block) {
    int s = byte();
    if (s <= 0) return false;
    *block = read(size_t(s));
    return true;
  }
};

std::vector<uint8_t> colour_table(Reader& r, int bits) {
  std::vector<uint8_t> p = r.read(size_t(3) << bits);
  if (p.size() % 3) fail("a colour table cut inside an entry");  // PIL's IndexError
  return p;
}

Frame parse(const uint8_t* data, size_t size) {
  if (size < 6 || (std::memcmp(data, "GIF87a", 6) && std::memcmp(data, "GIF89a", 6))) fail("not a GIF file");
  if (size < 11) fail("the logical screen descriptor is cut");
  Reader r{data, size};
  r.pos = std::min<size_t>(13, size);
  Frame f;
  f.width = int(le16(data + 6));
  f.height = int(le16(data + 8));
  int flags = data[10];
  std::vector<uint8_t> global;
  bool have_global = false;
  if (flags & 128) {
    if (size < 12) fail("the logical screen descriptor is cut");
    std::vector<uint8_t> p = colour_table(r, (flags & 7) + 1);
    if (palette_needed(p)) {
      global = p;
      have_global = true;
    }
  }
  int s = r.byte();
  if (s < 0 || s == ';') fail("no image in the file");
  int local = -1;  // -1: none; 0: a table PIL drops; 1: a table
  std::vector<uint8_t> local_table;
  bool found = false;
  std::vector<uint8_t> block;
  while (true) {
    if (s == 0x100) s = r.byte();
    if (s < 0 || s == ';') break;
    if (s == '!') {
      int label = r.byte();
      if (label < 0) fail("an extension is cut");  // PIL's IndexError
      bool got = r.data(&block);
      if (label == 249 && got) {
        if (block.size() < 3) fail("a graphic control extension is cut");
        if (block[0] & 1) {
          if (block.size() < 4) fail("a graphic control extension is cut");
          f.transparency = block[3];
        }
      } else if (label == 254) {
        while (got) got = r.data(&block);
        s = 0x100;
        continue;
      } else if (label == 255 && got) {
        if (block.size() >= 11 && std::memcmp(block.data(), "NETSCAPE2.0", 11) == 0) r.data(&block);
      }
      while (r.data(&block)) {
      }
    } else if (s == ',') {
      std::vector<uint8_t> d9 = r.read(9);
      if (d9.size() < 9) fail("an image descriptor is cut");
      f.x0 = int(le16(&d9[0]));
      f.y0 = int(le16(&d9[2]));
      f.x1 = f.x0 + int(le16(&d9[4]));
      f.y1 = f.y0 + int(le16(&d9[6]));
      if (f.x1 > f.width || f.y1 > f.height) {
        f.width = std::max(f.x1, f.width);
        f.height = std::max(f.y1, f.height);
        if (int64_t(f.width) * f.height > kMaxPixels)
          fail("image of " + std::to_string(f.width) + "x" + std::to_string(f.height) +
               " pixels is over the limit of " + std::to_string(kMaxPixels) +
               " pixels (PIL's decompression-bomb limit)");
      }
      int fl = d9[8];
      f.interlace = (fl & 64) != 0;
      if (fl & 128) {
        local_table = colour_table(r, (fl & 7) + 1);
        local = palette_needed(local_table) ? 1 : 0;
      }
      int bits = r.byte();
      if (bits < 0) fail("the image data is missing");  // PIL's IndexError
      f.bits = bits;
      f.offset = r.pos;
      found = true;
      break;
    }
    s = 0x100;
  }
  if (!found) fail("no image in the file");
  if (local == 1) {
    f.palette_mode = true;
    f.palette = local_table;
  } else if (local == -1 && have_global) {
    f.palette_mode = true;
    f.palette = global;
  }
  if (int64_t(f.width) * f.height > kMaxPixels)
    fail("image of " + std::to_string(f.width) + "x" + std::to_string(f.height) + " pixels is over the limit of " +
         std::to_string(kMaxPixels) + " pixels (PIL's decompression-bomb limit)");
  if (f.width <= 0 || f.height <= 0) fail("an image of zero width or height");
  if (f.x0 == 0 && f.x1 == 0) {  // PIL's setimage takes extents (0, y0, 0, y1) for the whole image
    f.y0 = 0;
    f.x1 = f.width;
    f.y1 = f.height;
  }
  if (f.x1 <= f.x0 || f.y1 <= f.y0) fail("a frame of zero width or height");
  return f;
}

// GifDecode.c over the rest of the file, into the frame's rectangle of
// `image` (width `image_w`). PIL's load loop hands the decoder the file in
// reads of 65536 bytes (ImageFile.MAXBLOCK) from the data's start: a
// sub-block starts only when all of it has been read, and after an end
// code the loop reads on, so an end code met when the whole file has been
// read is PIL's "image file is truncated"
void decode(const uint8_t* data, size_t size, const Frame& f, uint8_t* image, int image_w) {
  const int bits = f.bits;
  if (bits < 0 || bits > 12) fail("initial code size " + std::to_string(bits) + " is over 12");
  constexpr size_t kRead = 65536;
  const int clear = 1 << bits, end = clear + 1;
  const int xsize = f.x1 - f.x0, ysize = f.y1 - f.y0;
  int interlace = f.interlace ? 1 : 0, step = f.interlace ? 8 : 1;
  int x = 0, y = 0;
  std::vector<uint8_t> stack(kTable), dat(kTable);
  std::vector<uint16_t> link(kTable);
  int next = 0, codesize = 0, codemask = 0, bufferindex = kTable, state = 1;
  int lastdata = 0, lastcode = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0, blocksize = 0;
  size_t ptr = f.offset, avail = std::min(size, f.offset + kRead);
  auto read_more = [&]() {
    if (avail >= size) fail("image file is truncated");
    avail = std::min(size, avail + kRead);
  };
  uint8_t* out = image + size_t(f.y0) * image_w + f.x0;
  // one decoded byte to the image; false once the frame is complete
  auto put = [&](uint8_t v) -> bool {
    *out++ = v;
    if (++x < xsize) return true;
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (interlace) {
        case 1:
          y = 4;
          interlace = 2;
          break;
        case 2:
          step = 4;
          y = 2;
          interlace = 3;
          break;
        case 3:
          step = 2;
          y = 1;
          interlace = 0;
          break;
        default:
          return false;
      }
    }
    out = image + size_t(f.y0 + y) * image_w + f.x0;
    return true;
  };
  for (;;) {
    if (state == 1) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      bufferindex = kTable;
      state = 2;
    }
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuffer |= uint32_t(data[ptr++]) << bitcount;
        bitcount += 8;
        --blocksize;
      } else {
        while (ptr >= avail || avail - ptr < size_t(data[ptr]) + 1) read_more();
        blocksize = data[ptr++];
      }
    }
    int c = int(bitbuffer & uint32_t(codemask));
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    if (c == end) {
      read_more();
      continue;
    }
    if (state == 2) {
      if (c > clear) fail("broken data stream (a first code above the clear code)");
      lastdata = lastcode = c;
      state = 3;
    } else {
      int thiscode = c;
      if (c > next) fail("broken data stream (a code past the next free entry)");
      if (c == next) {
        if (bufferindex <= 0) fail("broken data stream (a string past the 4096-byte stack)");
        stack[size_t(--bufferindex)] = uint8_t(lastdata);
        c = lastcode;
      }
      while (c >= clear) {
        if (bufferindex <= 0 || c >= kTable) fail("broken data stream (a string past the 4096-byte stack)");
        stack[size_t(--bufferindex)] = dat[size_t(c)];
        c = link[size_t(c)];
      }
      lastdata = c;
      if (next < kTable) {
        dat[size_t(next)] = uint8_t(c);
        link[size_t(next)] = uint16_t(lastcode);
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
    }
    // the string's first byte, then the rest from the stack's right end
    if (!put(uint8_t(lastdata))) return;
    for (; bufferindex < kTable; ++bufferindex)
      if (!put(stack[size_t(bufferindex)])) return;
  }
}

void copy_error(const char* what, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", what);
}

}  // namespace

extern "C" {

// The image's size, its mode (1: P, 0: L), the number of colour-table
// entries PIL stores and the fill index outside the first frame (or -1:
// 0). Returns 0, or 1 with a message in err.
int mvd_gif_info(const uint8_t* data, size_t size, int* width, int* height, int* palette_mode, int* entries,
                 int* transparency, char* err, int errlen) {
  try {
    Frame f = parse(data, size);
    *width = f.width;
    *height = f.height;
    *palette_mode = f.palette_mode ? 1 : 0;
    *entries = int(f.palette.size() / 3);
    *transparency = f.transparency;
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// The first frame's indices into `image` (width * height bytes, filled by
// the caller as mvd_gif_info says) and the colour table into `palette`
// (entries * 3 bytes). Returns 0, or 1 with a message in err.
int mvd_gif_decode(const uint8_t* data, size_t size, uint8_t* image, int width, int height, uint8_t* palette,
                   char* err, int errlen) {
  try {
    Frame f = parse(data, size);
    if (f.width != width || f.height != height) fail("the image size changed");
    if (!f.palette.empty()) std::memcpy(palette, f.palette.data(), f.palette.size());
    decode(data, size, f, image, width);
    return 0;
  } catch (const std::bad_alloc&) {
    copy_error("GIF: out of memory", err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
