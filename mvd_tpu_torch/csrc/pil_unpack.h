// PIL's raw unpackers and raw decoder (Pillow's Unpack.c and RawDecode.c)
// for the rawmodes the BMP and TIFF readers hand them: host C++, the C++
// standard library only. Included by bmp_decode.cpp and tiff_decode.cpp;
// the small formats (utils/small_formats.py) reach them through
// tiff_decode.cpp's mvd_tiff_unpack.
//
// An image is held as PIL holds it in memory: 1 byte a pixel for modes
// "1" (0 or 255), "L" and "P"; 2 for "I;16" (little-endian) and "I;16B"
// (big-endian); 4 for the rest, band k at byte k ("RGB" and "RGBA"
// R, G, B, A; "CMYK"; "LA" L, L, L, A; "PA" P, 0, 0, A; "I" a native
// int32; "F" a native float). An unpacker turns `pixels` samples of a
// row as the file stores them into that layout; `bits` is the bits one
// pixel takes in the file, from which the raw decoder steps through rows.
// The host is little-endian ("N", native, is "L").

#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>

namespace pil {

using Unpacker = void (*)(uint8_t* out, const uint8_t* in, int pixels);

struct Raw {
  Unpacker fn;
  int bits;
  int pixelsize;   // of the mode it unpacks into
  int planes = 0;  // bit planes of (pixels + 7) / 8 bytes each (P;2L, P;4L), else 0
};

// the bytes of a row the unpacker reads
inline int64_t row_bytes(const Raw& u, int64_t pixels) {
  return u.planes ? u.planes * ((pixels + 7) / 8) : (pixels * u.bits + 7) / 8;
}

inline uint8_t bitflip(uint8_t b) {
  b = uint8_t((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = uint8_t((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return uint8_t((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

inline void put4(uint8_t* o, int a, int b, int c, int d) {
  o[0] = uint8_t(a);
  o[1] = uint8_t(b);
  o[2] = uint8_t(c);
  o[3] = uint8_t(d);
}

// n-bit samples, most significant first; `flip` reverses each byte's bits
// first (FillOrder 2), `invert` maps v to max - v (WhiteIsZero), `scale`
// multiplies (0xFF for 1-bit L/1, 0x55 for 2-bit, 0x11 for 4-bit, 1 for
// palette indices)
template <int N, bool flip, bool invert, int scale>
void unpack_bits(uint8_t* out, const uint8_t* in, int pixels) {
  constexpr int per = 8 / N, mask = (1 << N) - 1;
  for (int i = 0; i < pixels; i += per) {
    uint8_t byte = flip ? bitflip(*in) : *in;
    ++in;
    for (int k = 0; k < per && i + k < pixels; ++k) {
      int v = (byte >> (8 - N * (k + 1))) & mask;
      if (invert) v = mask - v;
      out[i + k] = uint8_t(v * scale);
    }
  }
}

template <bool flip, bool invert>
void unpack_8(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i) {
    uint8_t v = flip ? bitflip(in[i]) : in[i];
    out[i] = invert ? uint8_t(255 - v) : v;
  }
}

// every `step`-th byte, from byte `first` (PX: the index of a two-byte
// pixel)
template <int step, int first>
void unpack_stride(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i) out[i] = in[i * step + first];
}

// Unpack.c:unpackP2L/unpackP4L: bit k of an index from bit plane k, the
// planes (pixels + 7) / 8 bytes apart, most significant bit first
template <int planes>
void unpack_planes(uint8_t* out, const uint8_t* in, int pixels) {
  const int s = (pixels + 7) / 8;
  for (int i = 0; i < pixels; ++i) {
    int v = 0;
    for (int k = 0; k < planes; ++k) v |= (in[k * s + i / 8] >> (7 - i % 8) & 1) << k;
    out[i] = uint8_t(v);
  }
}

// 16-bit gray into I;16 (LE) or I;16B (BE) storage from LE or BE samples
template <bool in_be, bool out_be, bool flip>
void unpack_i16(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i) {
    uint8_t lo = in[2 * i + (in_be ? 1 : 0)], hi = in[2 * i + (in_be ? 0 : 1)];
    if (flip) {
      lo = bitflip(lo);
      hi = bitflip(hi);
    }
    out[2 * i + (out_be ? 1 : 0)] = lo;
    out[2 * i + (out_be ? 0 : 1)] = hi;
  }
}

// two 12-bit samples in three bytes, most significant first, into I;16
inline void unpack_i12(uint8_t* out, const uint8_t* in, int pixels) {
  int i = 0;
  for (; i < pixels - 1; i += 2, in += 3) {
    uint16_t a = uint16_t(in[0] << 4 | in[1] >> 4), b = uint16_t((in[1] & 0x0F) << 8 | in[2]);
    std::memcpy(out + 2 * i, &a, 2);
    std::memcpy(out + 2 * i + 2, &b, 2);
  }
  if (i == pixels - 1) {
    uint16_t a = uint16_t(in[0] << 4 | in[1] >> 4);
    std::memcpy(out + 2 * i, &a, 2);
  }
}

// signed 16- or 32-bit (or unsigned 32-bit, kept as its bits) samples into I
template <int bytes, bool be, bool is_signed>
void unpack_i32(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i, in += bytes) {
    uint32_t v = 0;
    for (int k = 0; k < bytes; ++k) v |= uint32_t(in[be ? bytes - 1 - k : k]) << (8 * k);
    int32_t s = bytes == 2 ? (is_signed ? int32_t(int16_t(v)) : int32_t(v)) : int32_t(v);
    std::memcpy(out + 4 * i, &s, 4);
  }
}

// 32-bit float samples into F, the byte order swapped where `be`
template <bool be>
void unpack_f32(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i)
    for (int k = 0; k < 4; ++k) out[4 * i + k] = in[4 * i + (be ? 3 - k : k)];
}

// `bands` bytes of each `step`-byte pixel, from byte offsets o0..o3, into a
// four-byte pixel; `fill` the fourth byte where there are three bands
template <int step, int o0, int o1, int o2, int o3, bool flip = false>
void unpack_4(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i, in += step, out += 4) {
    uint8_t v[4] = {in[o0], in[o1], in[o2], o3 < 0 ? uint8_t(255) : in[o3 < 0 ? 0 : o3]};
    if (flip)
      for (int k = 0; k < 3; ++k) v[k] = bitflip(v[k]);
    std::memcpy(out, v, 4);
  }
}

// Unpack.c:unpackRGBL: a line-interleaved row, its R, G and B planes one
// after the other
inline void unpack_rgb_lines(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i) put4(out + 4 * i, in[i], in[i + pixels], in[i + 2 * pixels], 255);
}

// premultiplied RGBA from bytes o0..o3 of each `step`-byte pixel (RGBa)
template <int step, int o0, int o1, int o2, int o3>
void unpack_rgba_premul(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i, in += step, out += 4) {
    int a = in[o3];
    if (a == 0)
      put4(out, 0, 0, 0, 0);
    else if (a == 255)
      put4(out, in[o0], in[o1], in[o2], a);
    else
      put4(out, clip8(in[o0] * 255 / a), clip8(in[o1] * 255 / a), clip8(in[o2] * 255 / a), a);
  }
}

inline void unpack_la(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i) put4(out + 4 * i, in[2 * i], in[2 * i], in[2 * i], in[2 * i + 1]);
}

inline void unpack_pa(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i) put4(out + 4 * i, in[2 * i], 0, 0, in[2 * i + 1]);
}

// Unpack.c:unpackLAB: L, and a and b (signed in the file) offset by 128
inline void unpack_lab(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i)
    put4(out + 4 * i, in[3 * i], uint8_t(in[3 * i + 1] ^ 128), uint8_t(in[3 * i + 2] ^ 128), 255);
}

// one band (byte k of a four-byte pixel) from 8-bit samples, or from the
// high byte of native 16-bit ones
template <int k, int step>
void unpack_band(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i) out[4 * i + k] = in[i * step + (step - 1)];
}

// BMP's 16-bit pixels (little-endian): 5-5-5 or 5-6-5, each field scaled
// to 0-255 as v * 255 / max
template <bool six>
void unpack_bgr16(uint8_t* out, const uint8_t* in, int pixels) {
  for (int i = 0; i < pixels; ++i, in += 2, out += 4) {
    int p = in[0] | in[1] << 8;
    int b = (p & 31) * 255 / 31;
    int g = six ? ((p >> 5) & 63) * 255 / 63 : ((p >> 5) & 31) * 255 / 31;
    int r = six ? ((p >> 11) & 31) * 255 / 31 : ((p >> 10) & 31) * 255 / 31;
    put4(out, r, g, b, 255);
  }
}

// Unpack.c:ImagingUnpackBGRA15Z: 5-5-5 as unpack_bgr16, alpha 0 where the
// top bit is set, else 255
inline void unpack_bgra15z(uint8_t* out, const uint8_t* in, int pixels) {
  unpack_bgr16<false>(out, in, pixels);
  for (int i = 0; i < pixels; ++i) out[4 * i + 3] = in[2 * i + 1] & 0x80 ? 0 : 255;
}

// (PIL mode, rawmode) -> its unpacker; fn == nullptr where PIL has none
// (OPEN_INFO names L;IR, P;1R, P;2R and P;4R, which PIL's Unpack.c lacks:
// an uncompressed file of those forms is refused)
inline Raw find(const std::string& mode, const std::string& raw) {
  auto is = [&](const char* m, const char* r) { return mode == m && raw == r; };
  // one-byte modes
  if (mode == "1") {
    if (raw == "1") return {unpack_bits<1, false, false, 255>, 1, 1};
    if (raw == "1;I") return {unpack_bits<1, false, true, 255>, 1, 1};
    if (raw == "1;R") return {unpack_bits<1, true, false, 255>, 1, 1};
    if (raw == "1;IR") return {unpack_bits<1, true, true, 255>, 1, 1};
  }
  if (mode == "L") {
    if (raw == "L;2") return {unpack_bits<2, false, false, 0x55>, 2, 1};
    if (raw == "L;2I") return {unpack_bits<2, false, true, 0x55>, 2, 1};
    if (raw == "L;2R") return {unpack_bits<2, true, false, 0x55>, 2, 1};
    if (raw == "L;2IR") return {unpack_bits<2, true, true, 0x55>, 2, 1};
    if (raw == "L;4") return {unpack_bits<4, false, false, 0x11>, 4, 1};
    if (raw == "L;4I") return {unpack_bits<4, false, true, 0x11>, 4, 1};
    if (raw == "L;4R") return {unpack_bits<4, true, false, 0x11>, 4, 1};
    if (raw == "L;4IR") return {unpack_bits<4, true, true, 0x11>, 4, 1};
    if (raw == "L") return {unpack_8<false, false>, 8, 1};
    if (raw == "L;I") return {unpack_8<false, true>, 8, 1};
    if (raw == "L;R") return {unpack_8<true, false>, 8, 1};
    if (raw == "L;16B") return {unpack_stride<2, 0>, 16, 1};
  }
  if (mode == "P") {
    if (raw == "P;1") return {unpack_bits<1, false, false, 1>, 1, 1};
    if (raw == "P;2") return {unpack_bits<2, false, false, 1>, 2, 1};
    if (raw == "P;4") return {unpack_bits<4, false, false, 1>, 4, 1};
    if (raw == "P" || raw == "L") return {unpack_8<false, false>, 8, 1};
    if (raw == "P;R") return {unpack_8<true, false>, 8, 1};
    if (raw == "PX") return {unpack_stride<2, 0>, 16, 1};
    if (raw == "P;2L") return {unpack_planes<2>, 2, 1, 2};
    if (raw == "P;4L") return {unpack_planes<4>, 4, 1, 4};
  }
  if (is("LA", "LA")) return {unpack_la, 16, 4};
  if (mode == "LAB") {  // a planar file's bands are copied as they are, a and b not offset
    if (raw == "LAB") return {unpack_lab, 24, 4};
    if (raw == "L") return {unpack_band<0, 1>, 8, 4};
    if (raw == "A") return {unpack_band<1, 1>, 8, 4};
    if (raw == "B") return {unpack_band<2, 1>, 8, 4};
  }
  if (is("PA", "PA")) return {unpack_pa, 16, 4};
  if (mode == "I;16") {
    if (raw == "I;16" || raw == "I;16N") return {unpack_i16<false, false, false>, 16, 2};
    if (raw == "I;16R") return {unpack_i16<false, false, true>, 16, 2};
    if (raw == "I;12") return {unpack_i12, 12, 2};
  }
  if (mode == "I;16B") {
    if (raw == "I;16B") return {unpack_i16<true, true, false>, 16, 2};
    if (raw == "I;16N") return {unpack_i16<false, true, false>, 16, 2};
  }
  if (mode == "I") {
    if (raw == "I;16S") return {unpack_i32<2, false, true>, 16, 4};
    if (raw == "I;16BS") return {unpack_i32<2, true, true>, 16, 4};
    if (raw == "I;32N" || raw == "I;32S" || raw == "I") return {unpack_i32<4, false, true>, 32, 4};
    if (raw == "I;32BS") return {unpack_i32<4, true, true>, 32, 4};
  }
  if (mode == "F") {
    if (raw == "F;32F" || raw == "F") return {unpack_f32<false>, 32, 4};
    if (raw == "F;32BF") return {unpack_f32<true>, 32, 4};
  }
  if (mode == "RGB" || mode == "RGBA" || mode == "CMYK") {
    const bool rgb = mode == "RGB", rgba = mode == "RGBA", cmyk = mode == "CMYK";
    // single bands of a planar file (PIL's raw path) or of libtiff's
    // planar reads ("R;16N": the high byte of a native 16-bit sample)
    const char* bands = cmyk ? "CMYK" : "RGBA";
    for (int k = 0; k < (rgb ? 3 : 4); ++k) {
      Unpacker one[4] = {unpack_band<0, 1>, unpack_band<1, 1>, unpack_band<2, 1>, unpack_band<3, 1>};
      Unpacker two[4] = {unpack_band<0, 2>, unpack_band<1, 2>, unpack_band<2, 2>, unpack_band<3, 2>};
      if (raw == std::string(1, bands[k])) return {one[k], 8, 4};
      if (!cmyk && raw == std::string(1, bands[k]) + ";16N") return {two[k], 16, 4};
    }
    if (rgb) {
      if (raw == "RGB") return {unpack_4<3, 0, 1, 2, -1>, 24, 4};
      if (raw == "RGB;R") return {unpack_4<3, 0, 1, 2, -1, true>, 24, 4};
      if (raw == "RGB;L") return {unpack_rgb_lines, 24, 4};
      if (raw == "RGBX") return {unpack_4<4, 0, 1, 2, -1>, 32, 4};
      if (raw == "RGBXX") return {unpack_4<5, 0, 1, 2, -1>, 40, 4};
      if (raw == "RGBXXX") return {unpack_4<6, 0, 1, 2, -1>, 48, 4};
      if (raw == "RGB;16L" || raw == "RGB;16N") return {unpack_4<6, 1, 3, 5, -1>, 48, 4};
      if (raw == "RGB;16B") return {unpack_4<6, 0, 2, 4, -1>, 48, 4};
      if (raw == "RGBX;16L" || raw == "RGBX;16N") return {unpack_4<8, 1, 3, 5, -1>, 64, 4};
      if (raw == "RGBX;16B") return {unpack_4<8, 0, 2, 4, -1>, 64, 4};
      if (raw == "BGR;15") return {unpack_bgr16<false>, 16, 4};
      if (raw == "BGR;16") return {unpack_bgr16<true>, 16, 4};
      if (raw == "BGR") return {unpack_4<3, 2, 1, 0, -1>, 24, 4};
      if (raw == "BGRX") return {unpack_4<4, 2, 1, 0, -1>, 32, 4};
      if (raw == "XBGR") return {unpack_4<4, 3, 2, 1, -1>, 32, 4};
      if (raw == "BGXR") return {unpack_4<4, 3, 1, 0, -1>, 32, 4};
    }
    if (rgba) {
      if (raw == "RGBA") return {unpack_4<4, 0, 1, 2, 3>, 32, 4};
      if (raw == "RGBAX") return {unpack_4<5, 0, 1, 2, 3>, 40, 4};
      if (raw == "RGBAXX") return {unpack_4<6, 0, 1, 2, 3>, 48, 4};
      if (raw == "RGBa") return {unpack_rgba_premul<4, 0, 1, 2, 3>, 32, 4};
      if (raw == "RGBaX") return {unpack_rgba_premul<5, 0, 1, 2, 3>, 40, 4};
      if (raw == "RGBaXX") return {unpack_rgba_premul<6, 0, 1, 2, 3>, 48, 4};
      if (raw == "RGBA;16L" || raw == "RGBA;16N") return {unpack_4<8, 1, 3, 5, 7>, 64, 4};
      if (raw == "RGBA;16B") return {unpack_4<8, 0, 2, 4, 6>, 64, 4};
      if (raw == "RGBa;16L" || raw == "RGBa;16N") return {unpack_rgba_premul<8, 1, 3, 5, 7>, 64, 4};
      if (raw == "RGBa;16B") return {unpack_rgba_premul<8, 0, 2, 4, 6>, 64, 4};
      if (raw == "BGRA") return {unpack_4<4, 2, 1, 0, 3>, 32, 4};
      if (raw == "ABGR") return {unpack_4<4, 3, 2, 1, 0>, 32, 4};
      if (raw == "BGAR") return {unpack_4<4, 3, 1, 0, 2>, 32, 4};
      if (raw == "BGRA;15Z") return {unpack_bgra15z, 16, 4};
    }
    if (cmyk) {
      if (raw == "CMYK") return {unpack_4<4, 0, 1, 2, 3>, 32, 4};
      if (raw == "CMYKX") return {unpack_4<5, 0, 1, 2, 3>, 40, 4};
      if (raw == "CMYKXX") return {unpack_4<6, 0, 1, 2, 3>, 48, 4};
      if (raw == "CMYK;16L" || raw == "CMYK;16N") return {unpack_4<8, 1, 3, 5, 7>, 64, 4};
      if (raw == "CMYK;16B") return {unpack_4<8, 0, 2, 4, 6>, 64, 4};
    }
  }
  return {nullptr, 0, 0};
}

// PIL's raw decoder (RawDecode.c) on one tile: rows of (xsize * bits + 7)
// / 8 bytes from `data`, `stride` bytes apart (0: packed), top to bottom
// or, with ystep -1, bottom to top, into the tile's rectangle of `image`
// (width `image_w`, `pixelsize` bytes a pixel). Returns false, writing
// what the rows it had, when data ends before the last row (PIL's "image
// file is truncated"); throws where PIL's stride is shorter than a row.
inline bool raw_decode(const Raw& u, const uint8_t* data, size_t size, int64_t stride, int ystep, uint8_t* image,
                       int image_w, int x0, int y0, int xsize, int ysize) {
  const int64_t bytes = (int64_t(xsize) * u.bits + 7) / 8;
  int64_t skip = 0;
  if (stride) {
    skip = stride - bytes;
    if (skip < 0) throw std::runtime_error("the tile's row stride is shorter than its rows (PIL's decoder error -8)");
  }
  size_t pos = 0;
  for (int i = 0; i < ysize; ++i) {
    if (i && skip) {
      if (size - pos < size_t(skip)) return false;
      pos += size_t(skip);
    }
    if (size - pos < size_t(bytes)) return false;
    int y = ystep < 0 ? ysize - 1 - i : i;
    u.fn(image + (size_t(y0 + y) * image_w + x0) * u.pixelsize, data + pos, xsize);
    pos += size_t(bytes);
  }
  return true;
}

}  // namespace pil
