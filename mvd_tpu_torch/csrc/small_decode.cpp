// Run-length and QOI decoders of the port's PIL path for PIL's small image
// formats: host C++, the C++ standard library only.
//
// Replaces no TPU kernel. The JAX package opens images with PIL
// (mvd_tpu/utils/images.py:37, mvd_tpu/cli/serve.py:48,
// mvd_tpu/data/objaverse.py:58); the port imports no PIL, so
// mvd_tpu_torch/utils/small_formats.py reads the headers of TGA, PCX, SGI,
// PSD and QOI files as PIL 12.1.0's plugins read them and hands the
// pixel streams here. Each function gives the rows as PIL's decoder hands
// them to its unpacker (the unpacking is numpy in small_formats.py):
//
//   * mvd_tga_rle: TgaRleDecode.c. Packets of a header byte and `depth`
//     bytes a pixel; a run may not cross the end of a row (PIL's buffer
//     overrun), a literal carries on into the next rows; bytes past the
//     last row are left unread.
//   * mvd_pcx_rle: PcxDecode.c. A byte with its two high bits set is a
//     run of its low six bits, any other a literal; a run past the row's
//     end is PIL's buffer overrun; the planes of a row whose stride is
//     padded are moved together as PIL moves them before unpacking.
//   * mvd_sgi_rle: SgiRleDecode.c. The whole file after the 512-byte
//     header read at once, the start and length tables of rows x bands
//     big-endian words, each row and band expanded from its offset with
//     PIL's bounds (one byte short of the buffer's end), the length
//     counting ops, not bytes: a row whose last op is not 0 ends the image
//     there without an error; a row buffer kept from the row before.
//   * mvd_packbits: PackDecode.c (PSD's channels; not libtiff's). 0x80 is
//     skipped, a run or literal past the row's end is cut there.
//   * mvd_qoi: QoiImagePlugin.QoiDecoder (pure Python in PIL): the hash of
//     (r * 3 + g * 5 + b * 7 + a * 11) % 64, an index never written
//     giving (0, 0, 0, 0) and then written at 0, a run repeating the
//     previous pixel without touching the index, decoding until the image
//     is full; the end marker not read.
//
// Every function returns 0, or 1 with a message in err (the image's data
// ends before its last row: PIL's "image file is truncated"; an overrun).
//
// Bound: host work, a few operations per byte; no device part.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Fail : std::runtime_error {
  using std::runtime_error::runtime_error;
};
[[noreturn]] void fail(const std::string& what) { throw Fail(what); }

void copy_error(const char* what, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", what);
}

template <typename F>
int guarded(F&& body, char* err, int errlen) {
  try {
    body();
    return 0;
  } catch (const std::bad_alloc&) {
    copy_error("out of memory", err, errlen);
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
  }
  return 1;
}

uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | uint32_t(p[3]);
}

// SgiRleDecode.c's expandrow (bpc 1) and expandrow2 (bpc 2) over `buf`
// from index `src` (indices, not pointers: an offset may lie far past the
// buffer): -1 an overrun, 1 the image ends here, 0 the row is done; `last`
// the buffer's last index
int expand_row(uint8_t* dest, const uint8_t* buf, int64_t src, int64_t n, int z, int64_t xsize, int64_t last,
               int bpc) {
  int64_t x = 0;
  for (; n > 0; --n) {
    uint8_t pixel;
    if (bpc == 1) {
      if (src > last) return -1;
      pixel = buf[src++];
    } else {
      if (src + 1 > last) return -1;
      pixel = buf[src + 1];
      src += 2;
    }
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + int64_t(bpc) * count > last) return -1;
      while (count--) {
        std::memcpy(dest, buf + src, size_t(bpc));
        src += bpc;
        dest += int64_t(z) * bpc;
      }
    } else {
      if (src + bpc > last) return -1;
      while (count--) {
        std::memcpy(dest, buf + src, size_t(bpc));
        dest += int64_t(z) * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// TGA RLE: `rows` rows of `row_bytes` bytes into `out`, in the file's order.
int mvd_tga_rle(const uint8_t* data, size_t size, int depth, int64_t row_bytes, int rows, uint8_t* out, char* err,
                int errlen) {
  return guarded([&] {
    size_t pos = 0;
    int64_t x = 0;
    int y = 0;
    if (rows <= 0) return;
    while (true) {
      if (pos >= size) fail("TGA: image file is truncated (the RLE packets end before the last row)");
      const uint8_t head = data[pos];
      int64_t n = int64_t(depth) * ((head & 0x7F) + 1), extra = 0;
      if (head & 0x80) {
        if (size - pos < size_t(1 + depth)) fail("TGA: image file is truncated (a run is cut)");
        if (x + n > row_bytes) fail("TGA: buffer overrun when reading image file (a run crosses a row's end)");
        for (int64_t i = 0; i < n; i += depth) std::memcpy(out + int64_t(y) * row_bytes + x + i, data + pos + 1, size_t(depth));
        pos += size_t(1 + depth);
      } else {
        if (int64_t(size - pos) < 1 + n) fail("TGA: image file is truncated (a literal packet is cut)");
        if (x + n > row_bytes) {
          extra = n - (row_bytes - x);
          n = row_bytes - x;
        }
        std::memcpy(out + int64_t(y) * row_bytes + x, data + pos + 1, size_t(n));
        pos += size_t(1 + n + extra);
      }
      const uint8_t* rest = data + pos - extra;
      while (true) {
        x += n;
        if (x >= row_bytes) {
          x = 0;
          if (++y >= rows) return;
        }
        if (extra == 0) break;
        n = std::min(extra, row_bytes);
        std::memcpy(out + int64_t(y) * row_bytes, rest, size_t(n));
        rest += n;
        extra -= n;
      }
    }
  }, err, errlen);
}

// PCX RLE: `rows` rows of `bytes` bytes (planes x stride) into `out`, the
// planes of each row moved together as PIL moves them; `xsize` pixels of
// `bits` bits a row.
int mvd_pcx_rle(const uint8_t* data, size_t size, int64_t xsize, int bits, int64_t bytes, int rows, uint8_t* out,
                char* err, int errlen) {
  return guarded([&] {
    if ((xsize * bits + 7) / 8 > bytes) fail("PCX: buffer overrun when reading image file (the stride is too short)");
    size_t pos = 0;
    int64_t x = 0;
    int y = 0;
    if (rows <= 0) return;
    while (true) {
      if (pos >= size) fail("PCX: image file is truncated (the RLE data end before the last row)");
      uint8_t* row = out + int64_t(y) * bytes;
      if ((data[pos] & 0xC0) == 0xC0) {
        if (size - pos < 2) fail("PCX: image file is truncated (a run is cut)");
        int n = data[pos] & 0x3F;
        if (x + n > bytes) fail("PCX: buffer overrun when reading image file (a run crosses a row's end)");
        std::memset(row + x, data[pos + 1], size_t(n));
        x += n;
        pos += 2;
      } else {
        row[x++] = data[pos++];
      }
      if (x >= bytes) {
        // the planes of a padded stride moved together: bit planes (2 or 4 of
        // 1 bit) by their bytes, byte planes by the width
        int64_t plane, bands, stride = 0;
        if (bits == 2 || bits == 4) {
          plane = (xsize + 7) / 8;
          bands = bits;
          stride = bytes / bits;
        } else {
          plane = xsize;
          bands = bytes / xsize;
          if (bands) stride = bytes / bands;
        }
        if (stride > plane)
          for (int64_t i = 1; i < bands; ++i) std::memmove(row + i * plane, row + i * stride, size_t(plane));
        x = 0;
        if (++y >= rows) return;
      }
    }
  }, err, errlen);
}

// SGI RLE over the whole file: `ysize` rows of xsize x bands x bpc bytes
// (bands interleaved, 16-bit samples big-endian) into `out` in the order
// the tables give them (the file's first row is the image's last);
// *done: the rows written before an early end.
int mvd_sgi_rle(const uint8_t* file, size_t size, int64_t xsize, int64_t ysize, int bands, int bpc, uint8_t* out,
                int64_t* done, char* err, int errlen) {
  return guarded([&] {
    constexpr size_t kHeader = 512;
    *done = 0;
    const int64_t bufsize = int64_t(size) - int64_t(kHeader);
    const int64_t tablen = int64_t(bands) * ysize;
    if (bufsize < 8 * tablen) fail("SGI: buffer overrun when reading image file (the RLE tables are cut)");
    const uint8_t* ptr = file + kHeader;
    const int64_t row_bytes = xsize * bands * bpc;
    std::vector<uint8_t> buffer(size_t(xsize * bands * 2), 0);
    for (int64_t rowno = 0; rowno < ysize; ++rowno) {
      for (int ch = 0; ch < bands; ++ch) {
        const int64_t at = rowno + int64_t(ch) * ysize;
        uint32_t offset = be32(ptr + 4 * at);
        const uint32_t length = be32(ptr + 4 * (tablen + at));
        if (offset < kHeader) fail("SGI: buffer overrun when reading image file (a row's offset is in the header)");
        offset -= uint32_t(kHeader);
        // no check of offset + length: the ops stop at the buffer's end; the
        // length is handed on as an int (past 2^31 - 1 negative: no ops)
        const int status = expand_row(buffer.data() + size_t(ch) * bpc, ptr, offset, int32_t(length), bands, xsize,
                                      bufsize - 1, bpc);
        if (status == -1) fail("SGI: buffer overrun when reading image file (a row's runs reach past it)");
        if (status == 1) return;
      }
      std::memcpy(out + rowno * row_bytes, buffer.data(), size_t(row_bytes));
      *done = rowno + 1;
    }
  }, err, errlen);
}

// PackBits as PIL decodes PSD channels: `rows` rows of `row_bytes` into
// `out`.
int mvd_packbits(const uint8_t* data, size_t size, int64_t row_bytes, int64_t rows, uint8_t* out, char* err,
                 int errlen) {
  return guarded([&] {
    size_t pos = 0;
    int64_t x = 0, y = 0;
    if (rows <= 0) return;
    while (true) {
      if (pos >= size) fail("PSD: image file is truncated (the PackBits data end before the last row)");
      uint8_t* row = out + y * row_bytes;
      const uint8_t head = data[pos];
      if (head & 0x80) {
        if (head == 0x80) {
          ++pos;
          continue;
        }
        if (size - pos < 2) fail("PSD: image file is truncated (a run is cut)");
        for (int n = 257 - head; n > 0 && x < row_bytes; --n) row[x++] = data[pos + 1];
        pos += 2;
      } else {
        const size_t n = size_t(head) + 2;
        if (size - pos < n) fail("PSD: image file is truncated (a literal is cut)");
        for (size_t i = 1; i < n && x < row_bytes; ++i) row[x++] = data[pos + i];
        pos += n;
      }
      if (x >= row_bytes) {
        x = 0;
        if (++y >= rows) return;
      }
    }
  }, err, errlen);
}

// QOI: `pixels` pixels of `channels` (3 or 4) bytes into `out`.
int mvd_qoi(const uint8_t* data, size_t size, int64_t pixels, int channels, uint8_t* out, char* err, int errlen) {
  return guarded([&] {
    uint8_t seen[64][4];
    bool present[64] = {false};
    uint8_t prev[4] = {0, 0, 0, 255};
    const int64_t dest = pixels * channels;
    int64_t n = 0;
    size_t pos = 0;
    auto put = [&](const uint8_t* v) {
      for (int k = 0; k < channels && n < dest; ++k) out[n++] = v[k];
    };
    auto need = [&](size_t k, const char* what) {
      if (size - pos < k) fail(std::string("QOI: ") + what + " is cut (PIL: not enough values to unpack)");
    };
    while (n < dest) {
      if (pos >= size) fail("QOI: the data end before the image is full (PIL: index out of range)");
      const uint8_t byte = data[pos++];
      uint8_t value[4];
      if (byte == 0xFE) {
        need(3, "an RGB pixel");
        std::memcpy(value, data + pos, 3);
        value[3] = prev[3];
        pos += 3;
      } else if (byte == 0xFF) {
        need(4, "an RGBA pixel");
        std::memcpy(value, data + pos, 4);
        pos += 4;
      } else {
        const int op = byte >> 6;
        if (op == 0) {
          const int i = byte & 0x3F;
          if (present[i]) std::memcpy(value, seen[i], 4);
          else std::memset(value, 0, 4);
        } else if (op == 1) {
          value[0] = uint8_t(prev[0] + ((byte >> 4) & 3) - 2);
          value[1] = uint8_t(prev[1] + ((byte >> 2) & 3) - 2);
          value[2] = uint8_t(prev[2] + (byte & 3) - 2);
          value[3] = prev[3];
        } else if (op == 2) {
          if (pos >= size) fail("QOI: a luma pixel is cut (PIL: index out of range)");
          const uint8_t second = data[pos++];
          const int dg = (byte & 0x3F) - 32, dr = (second >> 4) - 8, db = (second & 0x0F) - 8;
          value[0] = uint8_t(prev[0] + dg + dr);
          value[1] = uint8_t(prev[1] + dg);
          value[2] = uint8_t(prev[2] + dg + db);
          value[3] = prev[3];
        } else {
          for (int run = (byte & 0x3F) + 1; run > 0 && n < dest; --run) put(prev);
          continue;
        }
      }
      std::memcpy(prev, value, 4);
      const int h = (value[0] * 3 + value[1] * 5 + value[2] * 7 + value[3] * 11) % 64;
      std::memcpy(seen[h], value, 4);
      present[h] = true;
      put(value);
    }
  }, err, errlen);
}

}  // extern "C"
