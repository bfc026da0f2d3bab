// Block-compressed texture decoder (BC1-BC7, DDS) of the port's PIL path:
// host C++, the C++ standard library only.
//
// Replaces no TPU kernel. The JAX package opens images with PIL
// (mvd_tpu/utils/images.py:37, mvd_tpu/cli/serve.py:48,
// mvd_tpu/data/objaverse.py:58); the port imports no PIL, so
// mvd_tpu_torch/utils/small_formats.py reads a DDS header as PIL 12.1.0's
// DdsImagePlugin reads it and hands the blocks here. The blocks decode as
// PIL's "bcn" decoder (BcnDecode.c) decodes them, held to it by seeded
// random blocks of every mode and partition:
//
//   * BC1 (DXT1): two RGB565 endpoints widened by bit replication; four
//     colours (thirds) where the first endpoint is greater, else three
//     (the half) and transparent black; RGBA.
//   * BC2 (DXT3): BC1's colours always as four, 4-bit alpha widened as
//     (a << 4) | a. BC3 (DXT5): BC1's colours always as four, BC4 alpha.
//   * BC4: two 8-bit endpoints, eight values (sevenths) where the first is
//     greater, else six (fifths), 0 and 255; mode L.
//   * BC5: two BC4 blocks into red and green, blue 0; mode RGB. Signed
//     (BC5S): each endpoint an int8 plus 128, then as unsigned.
//   * BC6H (unsigned and signed half floats): the fourteen modes' endpoint
//     bit layouts, deltas, unquantization to 16 bits, 3- or 4-bit weights,
//     the result scaled by 31/64 (31/32 signed) into a half float, then
//     clamped to [0, 1] and multiplied by 255 and truncated; a reserved
//     mode is black; mode RGB.
//   * BC7: the eight modes (partitions, rotations, index selection,
//     endpoint and shared p-bits, 2-, 3- and 4-bit weights), the 64
//     two- and three-subset partitions and their anchor indices; a block
//     whose first byte is 0 (no mode) is transparent black; RGBA.
//
// A width or height that is not a multiple of 4 keeps a block's pixels
// inside the image. Refused as PIL refuses: data ending before the last
// block (PIL's "image file is truncated").
//
// Bound: host work, tens of operations per pixel; no device part.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

int get_bit(const uint8_t* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

int get_bits(const uint8_t* src, int bit, int count) {
  int v = 0;
  for (int i = 0; i < count; ++i) v |= get_bit(src, bit + i) << i;
  return v;
}

Rgba decode_565(uint16_t x) {
  Rgba c;
  int r = (x & 0xF800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7E0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1F) << 3;
  b |= b >> 5;
  c.r = uint8_t(r), c.g = uint8_t(g), c.b = uint8_t(b), c.a = 0xFF;
  return c;
}

void bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = uint16_t(src[0] | src[1] << 8), c1 = uint16_t(src[2] | src[3] << 8);
  const uint32_t lut = uint32_t(src[4]) | uint32_t(src[5]) << 8 | uint32_t(src[6]) << 16 | uint32_t(src[7]) << 24;
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3), uint8_t((2 * b0 + b1) / 3), 0xFF};
    p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3), uint8_t((b0 + 2 * b1) / 3), 0xFF};
  } else {
    p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 0xFF};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) dst[n] = p[3 & (lut >> (2 * n))];
}

// BC4's eight values into byte `o` of each of the 16 pixels `stride` bytes
// apart
void bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a0 = src[0], a1 = src[1];
  if (sign) {
    a0 = int(int8_t(src[0])) + 128;
    a1 = int(int8_t(src[1])) + 128;
  }
  const int lut1 = src[2] | src[3] << 8 | src[4] << 16, lut2 = src[5] | src[6] << 8 | src[7] << 16;
  uint8_t a[8];
  a[0] = uint8_t(a0);
  a[1] = uint8_t(a1);
  if (a0 > a1) {
    for (int k = 1; k <= 6; ++k) a[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k <= 4; ++k) a[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xFF;
  }
  for (int n = 0; n < 8; ++n) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; ++n) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

// ---------------------------------------------------------------- BC7

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
constexpr Bc7Mode kBc7[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0}, {3, 6, 0, 0, 5, 0, 0, 0, 2, 0},
    {2, 6, 0, 0, 7, 0, 1, 0, 2, 0}, {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// subset of each pixel: two subsets one bit a pixel, three two bits
constexpr uint16_t kSi2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8,
    0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110,
    0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696,
    0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720,
    0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
constexpr uint32_t kSi3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0, 0x5a5a5050,
    0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250,
    0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200,
    0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
    0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
// anchor index of the second subset (two subsets), of the second and the
// third (three subsets)
constexpr uint8_t kAi0[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2,  8, 2,  2, 8,
                              8,  15, 2,  8,  2,  2,  8,  8,  2,  2,  15, 15, 6,  8,  2,  8,  15, 15, 2, 8,  2, 2,
                              2,  15, 15, 6,  6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2, 15};
constexpr uint8_t kAi1[64] = {3,  3, 15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6, 5,  3,  3,  3,  3,  8,  15, 3, 3,
                              6,  10, 5, 8,  8,  6,  8,  5,  15, 15, 8,  15, 3, 5,  6,  10, 8,  15, 15, 3,  15, 5,
                              15, 15, 15, 15, 3, 15, 5,  5,  5,  8,  5,  10, 5, 10, 8,  13, 15, 12, 3,  3};
constexpr uint8_t kAi2[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,  15, 8, 15, 3,  15, 8,
                              15, 8,  3,  15, 6,  10, 15, 15, 10, 8,  15, 3,  15, 10, 10, 8,  9,  10, 6, 15, 8,  15,
                              3,  6,  6,  8,  15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

constexpr uint8_t kW2[4] = {0, 21, 43, 64};
constexpr uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr uint8_t kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) { return bits == 2 ? kW2 : bits == 3 ? kW3 : kW4; }

int subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kSi2[partition] >> n);
  if (ns == 3) return 3 & int(kSi3[partition] >> (2 * n));
  return 0;
}

bool anchor(int ns, int partition, int n) {
  if (n == 0) return true;
  if (ns == 2) return n == kAi0[partition];
  if (ns == 3) return n == kAi1[partition] || n == kAi2[partition];
  return false;
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (src[0] == 0) {  // no mode: PIL's opaque black
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  const Bc7Mode& m = kBc7[mode];
  int bit = mode + 1;
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int rotation = get_bits(src, bit, m.rb);
  bit += m.rb;
  const int index_sel = get_bits(src, bit, m.isb);
  bit += m.isb;
  const int numep = m.ns * 2;
  int ep[6][4];  // r, g, b, a of each endpoint, before the p-bits
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i) {
      ep[i][c] = get_bits(src, bit, m.cb);
      bit += m.cb;
    }
  for (int i = 0; i < numep; ++i) {
    if (m.ab) {
      ep[i][3] = get_bits(src, bit, m.ab);
      bit += m.ab;
    } else {
      ep[i][3] = -1;
    }
  }
  int pbit[6] = {0, 0, 0, 0, 0, 0};
  const bool has_p = m.epb || m.spb;
  if (m.epb)
    for (int i = 0; i < numep; ++i) pbit[i] = get_bit(src, bit++);
  if (m.spb)
    for (int i = 0; i < numep; i += 2) pbit[i] = pbit[i + 1] = get_bit(src, bit++);
  Rgba e[6];
  for (int i = 0; i < numep; ++i) {
    uint8_t v[4];
    for (int c = 0; c < 4; ++c) {
      const int bits = c < 3 ? m.cb : m.ab;
      if (c == 3 && !m.ab) {
        v[c] = 255;
        continue;
      }
      int x = ep[i][c], n = bits;
      if (has_p) {
        x = x << 1 | pbit[i];
        ++n;
      }
      x <<= 8 - n;
      x |= x >> n;
      v[c] = uint8_t(x);
    }
    e[i] = {v[0], v[1], v[2], v[3]};
  }
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights(m.ib2 ? m.ib2 : m.ib);
  const int ib = m.ib, ib2 = m.ib2;
  int cibit = bit, aibit = bit + 16 * ib - 1;  // the second index set follows the first (anchor one bit short)
  for (int n = 0; n < 16; ++n) {
    const int s = subset(m.ns, partition, n);
    const bool anc = anchor(m.ns, partition, n);
    int i0, i1;
    const int cbits = ib - (anc ? 1 : 0);
    i0 = get_bits(src, cibit, cbits);
    cibit += cbits;
    if (ib2) {
      const int abits = ib2 - (n == 0 ? 1 : 0);
      i1 = get_bits(src, aibit, abits);
      aibit += abits;
    } else {
      i1 = i0;
    }
    const uint8_t *wc = cw, *wa = ib2 ? aw : cw;
    int ci = i0, ai = i1;
    if (index_sel) {
      std::swap(ci, ai);
      std::swap(wc, wa);
    }
    const int s0 = wc[ci], s1 = wa[ai];
    const Rgba& a = e[2 * s];
    const Rgba& b = e[2 * s + 1];
    Rgba out;
    out.r = uint8_t(((64 - s0) * a.r + s0 * b.r + 32) >> 6);
    out.g = uint8_t(((64 - s0) * a.g + s0 * b.g + 32) >> 6);
    out.b = uint8_t(((64 - s0) * a.b + s0 * b.b + 32) >> 6);
    out.a = uint8_t(((64 - s1) * a.a + s1 * b.a + 32) >> 6);
    switch (rotation) {
      case 1: std::swap(out.a, out.r); break;
      case 2: std::swap(out.a, out.g); break;
      case 3: std::swap(out.a, out.b); break;
      default: break;
    }
    col[n] = out;
  }
}

// ---------------------------------------------------------------- BC6H

struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
};
constexpr Bc6Mode kBc6[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},  {2, 1, 5, 11, 4, 5, 4},
    {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},   {2, 1, 5, 8, 6, 5, 5},   {2, 1, 5, 8, 5, 6, 5},
    {2, 1, 5, 8, 5, 5, 6},  {2, 0, 5, 6, 6, 6, 6},   {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// each mode's endpoint bits in the order the block stores them (after the
// mode bits): "g2:4" one bit, "r0:0-9" bits 0 to 9, "r0:15-10" bits 15 down
// to 10; the components r0 g0 b0 r1 g1 b1 (region 0's two endpoints) and
// r2 g2 b2 r3 g3 b3 (region 1's)
const char* const kBc6Bits[14] = {
    "g2:4 b2:4 b3:4 r0:0-9 g0:0-9 b0:0-9 r1:0-4 g3:4 g2:0-3 g1:0-4 b3:0 g3:0-3 b1:0-4 b3:1 b2:0-3 r2:0-4 b3:2 "
    "r3:0-4 b3:3",
    "g2:5 g3:4 g3:5 r0:0-6 b3:0 b3:1 b2:4 g0:0-6 b2:5 b3:2 g2:4 b0:0-6 b3:3 b3:5 b3:4 r1:0-5 g2:0-3 g1:0-5 "
    "g3:0-3 b1:0-5 b2:0-3 r2:0-5 r3:0-5",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-4 r0:10 g2:0-3 g1:0-3 g0:10 b3:0 g3:0-3 b1:0-3 b0:10 b3:1 b2:0-3 r2:0-4 b3:2 "
    "r3:0-4 b3:3",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-3 r0:10 g3:4 g2:0-3 g1:0-4 g0:10 g3:0-3 b1:0-3 b0:10 b3:1 b2:0-3 r2:0-3 b3:0 "
    "b3:2 r3:0-3 g2:4 b3:3",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-3 r0:10 b2:4 g2:0-3 g1:0-3 g0:10 b3:0 g3:0-3 b1:0-4 b0:10 b2:0-3 r2:0-3 b3:1 "
    "b3:2 r3:0-3 b3:4 b3:3",
    "r0:0-8 b2:4 g0:0-8 g2:4 b0:0-8 b3:4 r1:0-4 g3:4 g2:0-3 g1:0-4 b3:0 g3:0-3 b1:0-4 b3:1 b2:0-3 r2:0-4 b3:2 "
    "r3:0-4 b3:3",
    "r0:0-7 g3:4 b2:4 g0:0-7 b3:2 g2:4 b0:0-7 b3:3 b3:4 r1:0-5 g2:0-3 g1:0-4 b3:0 g3:0-3 b1:0-4 b3:1 b2:0-3 "
    "r2:0-5 r3:0-5",
    "r0:0-7 b3:0 b2:4 g0:0-7 g2:5 g2:4 b0:0-7 g3:5 b3:4 r1:0-4 g3:4 g2:0-3 g1:0-5 g3:0-3 b1:0-4 b3:1 b2:0-3 "
    "r2:0-4 b3:2 r3:0-4 b3:3",
    "r0:0-7 b3:1 b2:4 g0:0-7 b2:5 g2:4 b0:0-7 b3:5 b3:4 r1:0-4 g3:4 g2:0-3 g1:0-4 b3:0 g3:0-3 b1:0-5 b2:0-3 "
    "r2:0-4 b3:2 r3:0-4 b3:3",
    "r0:0-5 g3:4 b3:0 b3:1 b2:4 g0:0-5 g2:5 b2:5 b3:2 g2:4 b0:0-5 g3:5 b3:3 b3:5 b3:4 r1:0-5 g2:0-3 g1:0-5 "
    "g3:0-3 b1:0-5 b2:0-3 r2:0-5 r3:0-5",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-9 g1:0-9 b1:0-9",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-8 r0:10 g1:0-8 g0:10 b1:0-8 b0:10",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-7 r0:11-10 g1:0-7 g0:11-10 b1:0-7 b0:11-10",
    "r0:0-9 g0:0-9 b0:0-9 r1:0-3 r0:15-10 g1:0-3 g0:15-10 b1:0-3 b0:15-10",
};

struct Layout {
  int n = 0;
  int bits[75];  // (component << 4 | bit) of each stored bit
};

Layout parse_layout(const char* s) {
  Layout l;
  while (*s) {
    if (*s == ' ') {
      ++s;
      continue;
    }
    const int channel = s[0] == 'r' ? 0 : s[0] == 'g' ? 1 : 2;
    const int comp = 3 * (s[1] - '0') + channel;
    s += 3;
    char* end;
    const int hi0 = int(std::strtol(s, &end, 10));
    int last = hi0;
    s = end;
    if (*s == '-') last = int(std::strtol(s + 1, &end, 10)), s = end;
    for (int b = hi0;; b += last >= hi0 ? 1 : -1) {
      l.bits[l.n++] = comp << 4 | b;
      if (b == last) break;
    }
  }
  return l;
}

const Layout& layout(int mode) {
  static const struct Table {
    Layout l[14];
    Table() {
      for (int i = 0; i < 14; ++i) l[i] = parse_layout(kBc6Bits[i]);
    }
  } table;
  return table.l[mode];
}

void sign_extend(int* v, int prec) {
  int x = *v & ((1 << prec) - 1);
  if (x & (1 << (prec - 1))) x -= 1 << prec;
  *v = x;
}

int unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return ((v << 16) + 0x8000) >> bits;
  }
  if (bits >= 16) return v;
  bool s = false;
  int x = v;
  if (x < 0) {
    s = true;
    x = -x;
  }
  if (x == 0) {
    x = 0;
  } else if (x >= (1 << (bits - 1)) - 1) {
    x = 0x7FFF;
  } else {
    x = ((x << 15) + 0x4000) >> (bits - 1);
  }
  return s ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = uint32_t(h & 0x7FFF) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= uint32_t(h & 0x8000) << 16;
  return o.f;
}

float finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float(uint16_t(0x8000 | (((-v) * 31) / 32)));
    return half_to_float(uint16_t((v * 31) / 32));
  }
  return half_to_float(uint16_t((v * 31) / 64));
}

uint8_t clamp8(float value) {
  if (value < 0.0f) return 0;
  if (value > 1.0f) return 255;
  return uint8_t(value * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1F, bit = 5, ib = 3;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
  } else {
    mode = 10 + (mode >> 2);
    ib = 4;
  }
  if (mode >= 14) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  const Bc6Mode& m = kBc6[mode];
  const Layout& lay = layout(mode);
  int ep[12] = {0};
  for (int i = 0; i < lay.n; ++i) {
    const int d = lay.bits[i];
    ep[d >> 4] |= get_bit(src, bit + i) << (d & 15);
  }
  bit += lay.n;
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int numep = m.ns == 2 ? 12 : 6;
  const int db[3] = {m.rb, m.gb, m.bb};
  if (sign)
    for (int c = 0; c < 3; ++c) sign_extend(&ep[c], m.epb);
  if (sign || m.tr)
    for (int i = 3; i < numep; ++i) sign_extend(&ep[i], db[i % 3]);
  if (m.tr) {
    for (int i = 3; i < numep; ++i) {
      ep[i] = (ep[i] + ep[i % 3]) & ((1 << m.epb) - 1);
      // PIL keeps a signed sum unextended, but reads a 16-bit one as int16
      if (sign && m.epb == 16) sign_extend(&ep[i], 16);
    }
  }
  int uq[12];
  for (int i = 0; i < numep; ++i) uq[i] = unquantize(ep[i], m.epb, sign);
  const uint8_t* cw = weights(ib);
  for (int n = 0; n < 16; ++n) {
    const int s = subset(m.ns, partition, n);
    const int bits = ib - ((n == 0 || (m.ns == 2 && n == kAi0[partition])) ? 1 : 0);
    const int w = cw[get_bits(src, bit, bits)];
    bit += bits;
    uint8_t out[3];
    for (int c = 0; c < 3; ++c) {
      const int v = (uq[6 * s + c] * (64 - w) + uq[6 * s + 3 + c] * w) >> 6;  // PIL adds no 32
      out[c] = clamp8(finalize(v, sign));
    }
    col[n] = {out[0], out[1], out[2], 255};
  }
}

void copy_error(const char* what, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", what);
}

}  // namespace

extern "C" {

// `n` 1-7 (BC1..BC7), `sign` for BC5S and BC6HS: the blocks of `data`
// into `out`, a (height, width, channels) image: 4 channels (RGBA) for
// BC1-3 and BC7, 3 (RGB) for BC5 and BC6H, 1 (L) for BC4. Returns 0, or 1
// with a message in err when the data end before the last block.
int mvd_bcn_decode(const uint8_t* data, size_t size, int n, int sign, int width, int height, uint8_t* out, char* err,
                   int errlen) {
  const int block = (n == 1 || n == 4) ? 8 : 16;
  const int channels = (n == 4) ? 1 : (n == 5 || n == 6) ? 3 : 4;
  const int64_t bx = (int64_t(width) + 3) / 4, by = (int64_t(height) + 3) / 4;
  size_t pos = 0;
  for (int64_t j = 0; j < by; ++j) {
    for (int64_t i = 0; i < bx; ++i) {
      if (size - std::min(size, pos) < size_t(block)) {
        copy_error("DDS: image file is truncated (the blocks end before the last one)", err, errlen);
        return 1;
      }
      const uint8_t* src = data + pos;
      pos += size_t(block);
      Rgba col[16];
      std::memset(col, 0, sizeof(col));
      uint8_t lum[16] = {0};
      switch (n) {
        case 1: bc1_color(col, src, false); break;
        case 2:
          bc1_color(col, src + 8, true);
          for (int k = 0; k < 16; ++k) {
            const int av = 0xF & (src[(4 * k) >> 3] >> ((4 * k) & 7));
            col[k].a = uint8_t(av << 4 | av);
          }
          break;
        case 3:
          bc1_color(col, src + 8, true);
          bc3_alpha(reinterpret_cast<uint8_t*>(col), src, 4, 3, false);
          break;
        case 4: bc3_alpha(lum, src, 1, 0, false); break;
        case 5:
          bc3_alpha(reinterpret_cast<uint8_t*>(col), src, 4, 0, sign);
          bc3_alpha(reinterpret_cast<uint8_t*>(col), src + 8, 4, 1, sign);
          if (sign)
            for (int k = 0; k < 16; ++k) col[k].b = 128;
          break;
        case 6: bc6_block(col, src, sign); break;
        default: bc7_block(col, src); break;
      }
      for (int y = 0; y < 4; ++y) {
        const int64_t py = 4 * j + y;
        if (py >= height) continue;
        for (int x = 0; x < 4; ++x) {
          const int64_t px = 4 * i + x;
          if (px >= width) continue;
          uint8_t* o = out + (py * width + px) * channels;
          const int k = 4 * y + x;
          if (channels == 1) {
            o[0] = lum[k];
          } else {
            o[0] = col[k].r, o[1] = col[k].g, o[2] = col[k].b;
            if (channels == 4) o[3] = col[k].a;
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
