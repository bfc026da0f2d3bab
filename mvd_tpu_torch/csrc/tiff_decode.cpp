// TIFF strip and tile decoder of the port's PIL path: host C++, the C++
// standard library only.
//
// Replaces no TPU kernel. The JAX package opens images with PIL
// (mvd_tpu/utils/images.py:37, mvd_tpu/cli/serve.py:48,
// mvd_tpu/data/objaverse.py:58); the port imports no PIL, so
// mvd_tpu_torch/utils/tiff.py reads a TIFF's first IFD, chooses PIL's mode
// and rawmode (TiffImagePlugin.OPEN_INFO) and lays out its strips or
// tiles as PIL does, and hands each one here (pil_unpack.h: the image
// layout and PIL's unpackers). Two paths, as PIL 12.1.0 has them:
//
//   * uncompressed (mvd_tiff_raw): PIL's own raw decoder, rows read from
//     the strip's offset on through the file (the byte counts unread), a
//     tile's rows its full width apart;
//   * compressed (mvd_tiff_coded): libtiff 4.7.1 as PIL drives it, one
//     whole strip or tile at a time: the bytes' bit order reversed under
//     FillOrder 2 (tif_read.c), PackBits (tif_packbits.c) or LZW
//     (tif_lzw.c, new-style codes most significant bit first with the
//     early code-size change, or the old bit-reversed codes, chosen by
//     the first strip as libtiff chooses), or deflate (inflated by
//     tiff.py with zlib: lossless, so every inflater gives its bytes);
//     the horizontal predictor per sample width (8, 16, 32 and 64 bits)
//     or the floating-point one (its byte planes back into samples); the
//     bytes swapped to the host's order where the file's differs (16-,
//     24-, 32- and 64-bit samples); then PIL's unpacker row by row.
//
// Refused as libtiff refuses (the decode fails, PIL raises): a stream
// that ends or an LZW table that breaks before the strip's last byte, an
// LZW strip whose first code is not a clear code,
// a code past the table or a table past 5119 entries, PackBits data
// ending early, a predictor libtiff does not take at the depth; but a
// strip whose data end early is read on libtiff's RGBA path (YCbCr),
// which reads on past it (`read_short`).
//
// Bound: host work, a few operations per byte; no device part.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "pil_unpack.h"

namespace {

struct Fail : std::runtime_error {
  using std::runtime_error::runtime_error;
};
[[noreturn]] void fail(const std::string& what) { throw Fail("TIFF: " + what); }

// tif_packbits.c:PackBitsDecode into occ bytes; returns the bytes it left
// unwritten (the data ran out)
size_t packbits(const uint8_t* in, size_t cc, uint8_t* op, size_t occ) {
  while (cc > 0 && occ > 0) {
    long n = int8_t(*in++);
    --cc;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (occ < size_t(n)) n = long(occ);
      if (cc == 0) break;
      occ -= size_t(n);
      uint8_t b = *in++;
      --cc;
      while (n-- > 0) *op++ = b;
    } else {
      if (occ < size_t(n + 1)) n = long(occ) - 1;
      if (cc < size_t(n + 1)) break;
      std::memcpy(op, in, size_t(++n));
      op += n;
      occ -= size_t(n);
      in += n;
      cc -= size_t(n);
    }
  }
  return occ;
}

// tif_lzw.c: LZWDecode (new-style) and LZWDecodeCompat (old-style codes)
constexpr int kClear = 256, kEOI = 257, kFirst = 258, kBitsMin = 9, kBitsMax = 12;
constexpr int kCSize = ((1 << kBitsMax) - 1) + 1024;

struct Code {
  int next;  // index of the entry before, or -1
  uint16_t length;
  uint8_t value, firstchar;
};

size_t lzw(const uint8_t* in, size_t cc, uint8_t* op, size_t occ, bool compat) {
  std::vector<Code> tab(static_cast<size_t>(kCSize));
  for (int c = 0; c < 256; ++c) tab[size_t(c)] = {-1, 1, uint8_t(c), uint8_t(c)};
  for (int c = 256; c < kCSize; ++c) tab[size_t(c)] = {-1, 0, 0, 0};
  int nbits = kBitsMin, nbitsmask = (1 << kBitsMin) - 1;
  int free_ent = kFirst, maxcode = nbitsmask - 1, oldcode = 0;
  bool cleared = false;
  uint64_t bitsleft = uint64_t(cc) * 8, nextdata = 0;
  int nextbits = 0;
  size_t bp = 0;
  auto next_code = [&]() -> int {
    if (bitsleft < uint64_t(nbits)) return kEOI;  // libtiff: "not terminated with EOI code"
    bitsleft -= uint64_t(nbits);
    int code;
    if (compat) {
      nextdata |= uint64_t(in[bp++]) << nextbits;
      nextbits += 8;
      if (nextbits < nbits) {
        nextdata |= uint64_t(in[bp++]) << nextbits;
        nextbits += 8;
      }
      code = int(nextdata & uint64_t(nbitsmask));
      nextdata >>= nbits;
      nextbits -= nbits;
    } else {
      nextdata = (nextdata << 8) | in[bp++];
      nextbits += 8;
      if (nextbits < nbits) {
        nextdata = (nextdata << 8) | in[bp++];
        nextbits += 8;
      }
      code = int((nextdata >> (nextbits - nbits)) & uint64_t(nbitsmask));
      nextbits -= nbits;
    }
    return code;
  };
  const char* broken = "LZW: corrupted table (libtiff: Corrupted LZW table)";
  while (occ > 0) {
    int code = next_code();
    if (code == kEOI) break;
    if (code == kClear) {
      cleared = true;
      do {
        free_ent = kFirst;
        for (int c = kFirst; c < kCSize; ++c) tab[size_t(c)] = {-1, 0, 0, 0};
        nbits = kBitsMin;
        nbitsmask = (1 << kBitsMin) - 1;
        maxcode = compat ? nbitsmask : nbitsmask - 1;
        code = next_code();
      } while (code == kClear);
      if (code == kEOI) break;
      if (code > kClear) fail(broken);
      *op++ = uint8_t(code);
      --occ;
      oldcode = code;
      continue;
    }
    const int c = code;
    // libtiff 4.7 starts a strip with its free entry before the table: a
    // regular code before the first clear is "not yet in table"
    if (!cleared) fail("LZW: a code before the first clear code (libtiff: Using code not yet in table)");
    if (free_ent >= kCSize) fail(broken);
    Code& e = tab[size_t(free_ent)];
    e.next = oldcode;
    e.firstchar = tab[size_t(oldcode)].firstchar;
    e.length = uint16_t(tab[size_t(oldcode)].length + 1);
    e.value = c < free_ent ? tab[size_t(c)].firstchar : e.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      nbitsmask = (1 << nbits) - 1;
      maxcode = compat ? nbitsmask : nbitsmask - 1;
    }
    oldcode = c;
    if (c >= 256) {
      if (tab[size_t(c)].length == 0)
        fail("LZW: a code past the table (libtiff: Wrong length of decoded string)");
      size_t len = tab[size_t(c)].length;
      int p = c;
      if (len > occ) {  // the string's first occ bytes fill the strip
        while (p >= 0 && tab[size_t(p)].length > occ) p = tab[size_t(p)].next;
        if (p < 0) break;
        len = occ;
        len = std::min<size_t>(len, tab[size_t(p)].length);
      }
      uint8_t* tp = op + len;
      size_t wrote = 0;
      while (p >= 0 && tp > op) {
        *--tp = tab[size_t(p)].value;
        p = tab[size_t(p)].next;
        ++wrote;
      }
      if (p >= 0 && len == tab[size_t(c)].length) fail("LZW: a loop in the code table (libtiff: Bogus encoding)");
      op += len;
      occ -= len;
      (void)wrote;
    } else {
      *op++ = uint8_t(c);
      --occ;
    }
  }
  return occ;
}

// tif_predict.c: horAcc8/16/32/64 over each row, `stride` samples apart
template <typename T>
void hor_acc(uint8_t* row, size_t rowsize, int stride) {
  const size_t n = rowsize / sizeof(T);
  for (size_t i = size_t(stride); i < n; ++i) {
    T a, b;
    std::memcpy(&a, row + (i - size_t(stride)) * sizeof(T), sizeof(T));
    std::memcpy(&b, row + i * sizeof(T), sizeof(T));
    b = T(b + a);
    std::memcpy(row + i * sizeof(T), &b, sizeof(T));
  }
}

void swab(uint8_t* p, size_t n, int bytes) {
  for (size_t i = 0; i + size_t(bytes) <= n; i += size_t(bytes))
    for (int k = 0; k < bytes / 2; ++k) std::swap(p[i + size_t(k)], p[i + size_t(bytes - 1 - k)]);
}

// tif_predict.c:fpAcc: bytes summed along the row, then the row's byte
// planes (most significant first) gathered into native-order samples;
// the sum runs `stride` bytes apart (the samples a pixel, not their bytes)
void fp_acc(uint8_t* row, size_t rowsize, int stride, int bps) {
  for (size_t i = size_t(stride); i < rowsize; ++i) row[i] = uint8_t(row[i] + row[i - size_t(stride)]);
  const size_t wc = rowsize / size_t(bps);
  std::vector<uint8_t> tmp(row, row + rowsize);
  for (size_t count = 0; count < wc; ++count)
    for (int byte = 0; byte < bps; ++byte)
      row[size_t(bps) * count + size_t(byte)] = tmp[size_t(bps - byte - 1) * wc + count];
}

[[noreturn]] void no_unpacker(const char* mode, const char* rawmode) {
  fail(std::string("no unpacker of rawmode ") + rawmode + " into mode " + mode + " (PIL: unknown raw mode)");
}

void copy_error(const char* what, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", what);
}

}  // namespace

extern "C" {

// Whether PIL has an unpacker of `rawmode` into `mode`; its bits a pixel.
int mvd_tiff_unpacker(const char* mode, const char* rawmode, int* bits) {
  pil::Raw u = pil::find(mode, rawmode);
  *bits = u.bits;
  return u.fn ? 1 : 0;
}

// PIL's unpacker of `rawmode` into `mode` on `rows` rows of `pixels`
// samples, `stride` bytes apart in `in`, into packed rows of `out`.
// Returns 1 where PIL has no such unpacker or `stride` is shorter than
// the bytes it reads.
int mvd_tiff_unpack(const char* mode, const char* rawmode, const uint8_t* in, int64_t stride, int rows,
                    uint8_t* out, int pixels) {
  pil::Raw u = pil::find(mode, rawmode);
  if (!u.fn || stride < pil::row_bytes(u, pixels)) return 1;
  for (int y = 0; y < rows; ++y) u.fn(out + size_t(y) * pixels * u.pixelsize, in + y * stride, pixels);
  return 0;
}

// An uncompressed strip or tile through PIL's raw decoder: `data` the
// file from the strip's offset on (`avail` bytes), into the rectangle (x0,
// y0, xsize, ysize) of `image` (width `image_w`). Returns 0, or 1 with a
// message in err.
int mvd_tiff_raw(const uint8_t* data, size_t avail, const char* mode, const char* rawmode, int64_t stride,
                 uint8_t* image, int image_w, int x0, int y0, int xsize, int ysize, char* err, int errlen) {
  try {
    pil::Raw u = pil::find(mode, rawmode);
    if (!u.fn) no_unpacker(mode, rawmode);
    if (!pil::raw_decode(u, data, avail, stride, 1, image, image_w, x0, y0, xsize, ysize))
      fail("image file is truncated (a strip or tile runs past the end of the file)");
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// A compressed strip or tile as libtiff decodes it, then unpacked by PIL:
// `codec` 32773 PackBits, 5 LZW (`*lzw_style`: 0 not chosen yet, 1 new,
// 2 old-style; set by the first strip), 8 deflate already inflated (`seg`
// the occ inflated bytes), 1 none (libtiff's reading of a file PIL reads
// as compressed); `reverse` FillOrder 2's bit reversal of the
// coded bytes; `occ` the strip's or tile's bytes; `predictor` 1, 2 or 3
// on rows of `rowsize` bytes, `stride` samples apart, of `bps`-bit
// samples; `swab_bytes` the sample bytes to swap (0: none); then `rows`
// rows of `xsize` pixels, `rowsize` apart, unpacked into `image` at (x0,
// y0), `unpack_mode` / `unpack_raw` the unpacker. A strip whose data run
// out before occ bytes is refused, or with `read_short` (libtiff's RGBA
// path, which reads on past it) kept as the codec leaves it: the bytes
// decoded, zeros after them, no predictor (PredictorDecodeRow skips a
// failed row). Returns 0, or 1 with a message in err.
int mvd_tiff_coded(const uint8_t* seg, size_t seg_len, int codec, int* lzw_style, int reverse, int64_t occ,
                   int predictor, int64_t rowsize, int stride, int bps, int swab_bytes, const char* unpack_mode,
                   const char* unpack_raw, uint8_t* image, int image_w, int x0, int y0, int xsize, int rows,
                   int read_short, char* err, int errlen) {
  try {
    pil::Raw u = pil::find(unpack_mode, unpack_raw);
    if (!u.fn) no_unpacker(unpack_mode, unpack_raw);
    std::vector<uint8_t> in;
    const uint8_t* src = seg;
    if (reverse && codec != 8) {
      in.assign(seg, seg + seg_len);
      for (auto& b : in) b = pil::bitflip(b);
      src = in.data();
    }
    std::vector<uint8_t> buf(static_cast<size_t>(occ));
    size_t left = 0;
    const char* shortage = nullptr;
    if (codec == 32773) {
      left = packbits(src, seg_len, buf.data(), buf.size());
      shortage = "PackBits: not enough data for the strip (libtiff: Not enough data for scanline)";
    } else if (codec == 5) {
      if (*lzw_style == 0) *lzw_style = (seg_len >= 2 && src[0] == 0 && (src[1] & 1)) ? 2 : 1;
      left = lzw(src, seg_len, buf.data(), buf.size(), *lzw_style == 2);
      shortage = "LZW: not enough data for the strip (libtiff: Not enough data at scanline)";
    } else if (codec == 8 || codec == 1) {  // inflated, or tif_dumpmode.c: the strip's bytes as they are
      const size_t n = std::min(seg_len, buf.size());
      if (n) std::memcpy(buf.data(), codec == 8 ? seg : src, n);
      left = buf.size() - n;
      shortage = codec == 8 ? "deflate: not enough data for the strip"
                            : "not enough data for the strip (libtiff: DumpModeDecode)";
    } else {
      fail("compression " + std::to_string(codec) + " is not decoded here");
    }
    if (left && !read_short) fail(shortage);
    if (left) {
      // a short strip the RGBA path reads on past: as the codec left it
    } else if (predictor == 2 || predictor == 3) {
      if (rowsize <= 0 || occ % rowsize) fail("the predictor's rows do not divide the strip");
      for (int64_t r = 0; r < occ; r += rowsize) {
        uint8_t* row = buf.data() + r;
        if (predictor == 3) {
          fp_acc(row, size_t(rowsize), stride, bps / 8);
          continue;
        }
        if (swab_bytes) swab(row, size_t(rowsize), swab_bytes);
        switch (bps) {
          case 8: hor_acc<uint8_t>(row, size_t(rowsize), stride); break;
          case 16: hor_acc<uint16_t>(row, size_t(rowsize), stride); break;
          case 32: hor_acc<uint32_t>(row, size_t(rowsize), stride); break;
          case 64: hor_acc<uint64_t>(row, size_t(rowsize), stride); break;
          default: fail("horizontal predictor at " + std::to_string(bps) + "-bit samples");
        }
      }
    } else if (swab_bytes) {
      swab(buf.data(), buf.size(), swab_bytes);
    }
    for (int r = 0; r < rows; ++r) {
      if (int64_t(r) * rowsize + (int64_t(xsize) * u.bits + 7) / 8 > occ) fail("a row past the strip");
      u.fn(image + (size_t(y0 + r) * image_w + x0) * u.pixelsize, buf.data() + size_t(r) * size_t(rowsize), xsize);
    }
    return 0;
  } catch (const std::bad_alloc&) {
    copy_error("TIFF: out of memory", err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
