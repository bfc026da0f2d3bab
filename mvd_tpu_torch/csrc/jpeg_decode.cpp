// JPEG decoder of the port: host C++, the C++ standard library only.
//
// Replaces no TPU kernel. The JAX package reads every image through PIL
// (mvd_tpu/utils/images.py:33, mvd_tpu/cli/serve.py:45,
// mvd_tpu/data/objaverse.py:56, which CO3D's frames go through); the port
// imports no PIL, so this is its reader of JPEG source images, uploads and
// CO3D frames (mvd_tpu_torch/utils/images.py:decode_jpeg). Its output is
// bitwise what PIL's Image.open(...).convert("RGB") gives, i.e. what
// libjpeg(-turbo) decodes at its defaults: JDCT_ISLOW and fancy upsampling.
// It repeats libjpeg's integer pipeline step by step:
//
//   * Huffman decode of sequential scans (interleaved or not), DC
//     prediction, restart intervals (DRI / RSTn);
//   * progressive scans (SOF2) into the same whole-image coefficient
//     buffer, as jdphuff.c decodes them: DC first and DC refine scans
//     (interleaved or not), AC first scans with end-of-band runs, AC refine
//     scans with libjpeg's correction bits; Huffman tables and restart
//     intervals may change between scans; the scan parameters libjpeg
//     refuses (JERR_BAD_PROGRESSION) are refused; a component's
//     coefficients keep libjpeg's coef_bits (the Al of the last scan of
//     each), which decide whether libjpeg block-smooths the image;
//   * dequantization with the table latched at the component's first scan
//     and the islow IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2, the
//     post-IDCT range-limit table indexed by the value & 1023);
//   * jdsample.c's upsampling: h2v1 "fancy" (biases 1 and 2, edge columns
//     copied), h1v2 fancy (biases 1 and 2), h2v2 fancy (biases 8 and 7,
//     rows above the first and below the last real row replicated, as
//     jdmainct.c's context rows do), box replication where libjpeg takes it
//     (2h with a downsampled width of 2 or less, other integral factors);
//   * jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16, ONE_HALF);
//     a gray image replicated to RGB as convert("RGB") does; three
//     components are YCbCr or RGB by libjpeg's rule (JFIF, then Adobe's
//     transform flag, then the component ids); four components are CMYK,
//     or YCCK where an Adobe marker's transform flag is not 0, converted to
//     CMYK by jdcolor.c's ycck_cmyk_convert; PIL reads CMYK as "CMYK;I"
//     (255 - each sample, with or without an Adobe marker) and its
//     convert("RGB") gives K' - MULDIV255(C', K') per channel, K' = 255 -
//     its K.
//
// EXIF orientation is not applied (PIL's open does not). Arithmetic-coded,
// lossless, hierarchical and 12-bit images are refused with a message
// naming the marker or the feature, as is a progressive image whose scans
// leave one of the first nine AC coefficients of a component unrefined
// (coef_bits not 0; a DC-only file among them): libjpeg decodes such a file
// with block smoothing (jdcoefct.c:decompress_smooth_data, on by default
// and left on by PIL), which is not ported. So is entropy data that runs
// past its end (at the end of the MCU row where it does), a DC Huffman
// table with a symbol above 15 (as libjpeg refuses it), sampling factors
// of more than 10 blocks in an interleaved MCU (as libjpeg refuses them)
// and a header of more pixels than PIL's decompression-bomb limit (refused
// before anything is allocated, as Image.open refuses it).
//
// Bound: host work, a few tens of operations per pixel; no device part.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

// zigzag index -> natural (row-major) index, with libjpeg's 16 extra
// entries that catch a run past the block's end
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int maxcode[18] = {};
  int valoffset[18] = {};
  uint8_t look_len[512] = {};  // 9-bit lookahead: code length, 0 = longer
  uint8_t look_val[512] = {};
  int max_val = 0;  // the largest symbol (a DC table's must be 15 or less)

  // jdhuff.c:jpeg_make_d_derived_tbl
  void build(const uint8_t* bits /* [17], bits[0] unused */, const uint8_t* v, int n) {
    uint8_t size[257];
    int code[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) size[p++] = uint8_t(l);
    size[p] = 0;
    int c = 0, si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code[p++] = c++;
      if (c >= (1 << si)) fail("JPEG Huffman table is invalid");
      c <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - code[p];
        p += bits[l];
        maxcode[l] = code[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    std::memcpy(vals, v, size_t(n));
    max_val = n ? *std::max_element(v, v + n) : 0;
    std::memset(look_len, 0, sizeof look_len);
    p = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int lookbits = code[p] << (9 - l);
        for (int k = 0; k < (1 << (9 - l)); ++k) {
          look_len[lookbits + k] = uint8_t(l);
          look_val[lookbits + k] = v[p];
        }
      }
    }
    defined = true;
  }
};

// Entropy-coded bits: 0xFF 0x00 is a stuffed 0xFF; a marker (or the end
// of the data) stops the input, after which zero bytes are supplied and
// counted, so that a scan that needs them can be refused.
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int cnt = 0;
  int fake = 0;  // zero bytes supplied past a marker or the end
  bool stopped = false;

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!stopped && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;  // fill bytes before a marker
          if (q < n && d[q] == 0) {
            pos = q + 1;
          } else {
            stopped = true;
            pos = q - 1;  // at the 0xFF before the marker's code
            b = 0;
            ++fake;
          }
        } else {
          ++pos;
        }
      } else {
        ++fake;
      }
      acc |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = int(acc >> (64 - k));
    acc <<= k;
    cnt -= k;
    return v;
  }
  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    int peek = int(acc >> (64 - 9));
    int l = h.look_len[peek];
    if (l) {
      acc <<= l;
      cnt -= l;
      return h.look_val[peek];
    }
    int code = int(acc >> (64 - 16));
    for (l = 10; l <= 16; ++l) {
      int c = code >> (16 - l);
      if (c <= h.maxcode[l]) {
        acc <<= l;
        cnt -= l;
        return h.vals[(h.valoffset[l] + c) & 0xFF];
      }
    }
    fail("JPEG entropy data holds a code its Huffman table lacks");
  }
  // whether more bits were consumed than the data held
  bool overran() const { return cnt < 8 * fake; }
  void reset() {
    acc = 0;
    cnt = 0;
    fake = 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int ds_w = 0, ds_h = 0;      // samples that hold image data
  int bw = 0, bh = 0;          // blocks stored (the MCU grid's padding included)
  bool latched = false;        // quant table copied at its first scan
  bool scanned = false;
  int coef_bits[64];           // progressive: Al of the last scan of each zigzag coefficient, -1 before
  int16_t quant[64] = {};      // natural order, as ISLOW_MULT_TYPE (short)
  std::vector<int16_t> coef;   // bh * bw blocks of 64, natural order
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples
};

// libjpeg's post-IDCT range limit: (value & 1023) -> sample, i.e. clamp of
// value + 128 to [0, 255] for |value| < 512 and a wrap beyond
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v = (i < 512 ? i : i - 1024) + 128;
      t[i] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kRange;

// PIL's Image.open refuses an image of more pixels than twice
// Image.MAX_IMAGE_PIXELS (a DecompressionBombError), before any pixel is
// decoded; the header is refused here at the same size
constexpr int64_t kMaxPixels = int64_t(2) * 89478485;

// jidctint.c:jpeg_idct_islow on one block
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  constexpr int CB = 13, P1 = 2;
  constexpr int F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return int((x + (int64_t(1) << (n - 1))) >> n); };
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = int(ip[0]) * int(qp[0]) * (1 << P1);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int(ip[16]) * int(qp[16]), z3 = int(ip[48]) * int(qp[48]);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = int(ip[0]) * int(qp[0]);
    z3 = int(ip[32]) * int(qp[32]);
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int(ip[56]) * int(qp[56]);
    tmp1 = int(ip[40]) * int(qp[40]);
    tmp2 = int(ip[24]) * int(qp[24]);
    tmp3 = int(ip[8]) * int(qp[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = descale(tmp10 + tmp3, CB - P1);
    wp[56] = descale(tmp10 - tmp3, CB - P1);
    wp[8] = descale(tmp11 + tmp2, CB - P1);
    wp[48] = descale(tmp11 - tmp2, CB - P1);
    wp[16] = descale(tmp12 + tmp1, CB - P1);
    wp[40] = descale(tmp12 - tmp1, CB - P1);
    wp[24] = descale(tmp13 + tmp0, CB - P1);
    wp[32] = descale(tmp13 - tmp0, CB - P1);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + size_t(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = kRange.t[descale(wp[0], P1 + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CB);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CB + P1 + 3;
    op[0] = kRange.t[descale(tmp10 + tmp3, S) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, S) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, S) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, S) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, S) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, S) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, S) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, S) & 1023];
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  // Parse up to the frame header (header_only) or decode the whole image.
  void run(bool header_only) {
    if (n_ < 3 || d_[0] != 0xFF || d_[1] != 0xD8 || d_[2] != 0xFF) fail("not a JPEG file (no SOI)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        frame(m);
        if (header_only) return;
        continue;
      }
      if (m == 0xC3) fail("lossless JPEG (SOF3) is not read");
      if (m >= 0xC5 && m <= 0xC7) fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not read");
      if (m >= 0xC9 && m <= 0xCF && m != 0xCC)
        fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ") is not read");
      if (m == 0xCC) fail("arithmetic-coded JPEG (DAC) is not read");
      if (m == 0xDC) fail("JPEG with a DNL marker is not read");
      size_t len = segment_length();
      const uint8_t* s = d_ + pos_ + 2;
      size_t sl = len - 2;
      if (m == 0xC4) {
        dht(s, sl);
      } else if (m == 0xDB) {
        dqt(s, sl);
      } else if (m == 0xDD) {
        if (sl < 2) fail("JPEG DRI segment is too short");
        restart_interval_ = (s[0] << 8) | s[1];
      } else if (m == 0xDA) {
        if (!have_frame_) fail("JPEG scan before its frame header");
        pos_ += len;
        scan(s, sl);
        continue;
      } else if (m == 0xE0 && sl >= 5 && !std::memcmp(s, "JFIF\0", 5)) {
        saw_jfif_ = true;
      } else if (m == 0xEE && sl >= 12 && !std::memcmp(s, "Adobe", 5)) {
        saw_adobe_ = true;
        adobe_transform_ = s[11];
      } else if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xC8 || (m >= 0xF0 && m <= 0xFD))) {
        char buf[64];
        std::snprintf(buf, sizeof buf, "JPEG marker 0xFF%02X is not read", m);
        fail(buf);
      }
      pos_ += len;
    }
    if (!have_frame_) fail("JPEG has no frame header");
    if (header_only) return;
    for (const Component& c : comps_)
      if (!c.scanned) fail("JPEG ends before every component was scanned");
    if (needs_block_smoothing())
      fail("progressive JPEG whose scans leave some of the first nine AC coefficients unrefined: libjpeg "
           "decodes it with block smoothing, which is not read");
  }

  int width() const { return width_; }
  int height() const { return height_; }

  void output(uint8_t* out) {
    for (Component& c : comps_) {
      c.plane.assign(size_t(c.bh) * 8 * c.bw * 8, 0);
      int stride = c.bw * 8;
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                     &c.plane[size_t(by) * 8 * stride + size_t(bx) * 8], stride);
    }
    const size_t W = size_t(width_), H = size_t(height_);
    if (comps_.size() == 1) {
      const Component& c = comps_[0];
      for (size_t y = 0; y < H; ++y)
        for (size_t x = 0; x < W; ++x) {
          uint8_t g = c.plane[y * c.bw * 8 + x];
          uint8_t* o = out + (y * W + x) * 3;
          o[0] = o[1] = o[2] = g;
        }
      return;
    }
    std::vector<uint8_t> full[4];
    for (size_t i = 0; i < comps_.size(); ++i) full[i] = upsample(comps_[i]);
    // jdcolor.c:build_ycc_rgb_table
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return int64_t(x * (1 << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = int((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    if (comps_.size() == 4) {
      // jdapimin.c:default_decompress_parms: YCCK only by an Adobe marker
      const bool ycck = saw_adobe_ && adobe_transform_ != 0;
      // PIL's MULDIV255 (ImagingCore's integer a * b / 255)
      auto muldiv255 = [](int a, int b) {
        int t = a * b + 128;
        return ((t >> 8) + t) >> 8;
      };
      for (size_t i = 0; i < W * H; ++i) {
        int c = full[0][i], m = full[1][i], ye = full[2][i], k = full[3][i];
        if (ycck) {  // jdcolor.c:ycck_cmyk_convert
          int Y = c, cb = m, cr = ye;
          c = clamp(255 - (Y + cr_r[cr]));
          m = clamp(255 - (Y + int((cb_g[cb] + cr_g[cr]) >> SB)));
          ye = clamp(255 - (Y + cb_b[cb]));
        }
        // "CMYK;I" stores 255 - each sample; cmyk2rgb's nk = 255 - that K = k
        uint8_t* o = out + i * 3;
        o[0] = clamp(k - muldiv255(255 - c, k));
        o[1] = clamp(k - muldiv255(255 - m, k));
        o[2] = clamp(k - muldiv255(255 - ye, k));
      }
      return;
    }
    const bool rgb = color_is_rgb();
    for (size_t y = 0; y < H; ++y)
      for (size_t x = 0; x < W; ++x) {
        size_t i = y * W + x;
        uint8_t* o = out + i * 3;
        int Y = full[0][i], cb = full[1][i], cr = full[2][i];
        if (rgb) {
          o[0] = uint8_t(Y);
          o[1] = uint8_t(cb);
          o[2] = uint8_t(cr);
          continue;
        }
        o[0] = clamp(Y + cr_r[cr]);
        o[1] = clamp(Y + int((cb_g[cb] + cr_g[cr]) >> SB));
        o[2] = clamp(Y + cb_b[cb]);
      }
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool have_frame_ = false, saw_jfif_ = false, saw_adobe_ = false, progressive_ = false;
  int adobe_transform_ = 0;
  int width_ = 0, height_ = 0, max_h_ = 1, max_v_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  std::vector<Component> comps_;
  Huffman dc_[4], ac_[4];
  int quant_[4][64] = {};
  bool quant_defined_[4] = {};

  int next_marker() {
    // tolerate bytes between segments, as libjpeg does (with a warning)
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0xFF && d_[pos_ + 1] != 0)) ++pos_;
    if (pos_ + 1 >= n_) fail("JPEG ends before its EOI marker (the file is truncated)");
    int m = d_[pos_ + 1];
    pos_ += 2;
    return m;
  }

  size_t segment_length() {
    if (pos_ + 2 > n_) fail("JPEG segment header is truncated");
    size_t len = (size_t(d_[pos_]) << 8) | d_[pos_ + 1];
    if (len < 2 || pos_ + len > n_) fail("JPEG segment is truncated");
    return len;
  }

  bool color_is_rgb() const {
    // jdapimin.c:default_decompress_parms for three components
    if (saw_jfif_) return false;
    if (saw_adobe_) return adobe_transform_ == 0;
    return comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
  }

  void frame(int m) {
    if (have_frame_) fail("JPEG has two frame headers");
    size_t len = segment_length();
    const uint8_t* s = d_ + pos_ + 2;
    if (len < 8) fail("JPEG frame header is too short");
    if (s[0] != 8)
      fail(std::to_string(s[0]) + "-bit JPEG (SOF" + std::to_string(m - 0xC0) + ") is not read (8-bit only)");
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    int nc = s[5];
    if (height_ == 0) fail("JPEG with a DNL marker (height 0) is not read");
    if (width_ == 0) fail("JPEG width is 0");
    if (int64_t(width_) * height_ > kMaxPixels)
      fail("JPEG of " + std::to_string(width_) + "x" + std::to_string(height_) + " pixels is over the limit of " +
           std::to_string(kMaxPixels) + " pixels (PIL's decompression-bomb limit)");
    if (nc != 1 && nc != 3 && nc != 4) fail("JPEG with " + std::to_string(nc) + " components is not read");
    if (len < size_t(8 + 3 * nc)) fail("JPEG frame header is too short");
    comps_.resize(size_t(nc));
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[size_t(i)];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("JPEG frame header is invalid");
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    mcux_ = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
    mcuy_ = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    for (Component& c : comps_) {
      if (max_h_ % c.h || max_v_ % c.v) fail("JPEG sampling factors that do not divide are not read");
      c.ds_w = int((int64_t(width_) * c.h + max_h_ - 1) / max_h_);
      c.ds_h = int((int64_t(height_) * c.v + max_v_ - 1) / max_v_);
      c.bw = nc == 1 ? (c.ds_w + 7) / 8 : mcux_ * c.h;
      c.bh = nc == 1 ? (c.ds_h + 7) / 8 : mcuy_ * c.v;
    }
    have_frame_ = true;
    progressive_ = m == 0xC2;
    pos_ += len;
  }

  void dht(const uint8_t* s, size_t sl) {
    size_t p = 0;
    while (p < sl) {
      if (p + 17 > sl) fail("JPEG DHT segment is truncated");
      int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) fail("JPEG DHT segment is invalid");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[l] = s[p + size_t(l)];
      if (count > 256 || p + 17 + size_t(count) > sl) fail("JPEG DHT segment is invalid");
      (tc ? ac_ : dc_)[th].build(bits, s + p + 17, count);
      p += 17 + size_t(count);
    }
  }

  void dqt(const uint8_t* s, size_t sl) {
    size_t p = 0;
    while (p < sl) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      if (pq > 1 || tq > 3) fail("JPEG DQT segment is invalid");
      size_t need = 1 + 64 * size_t(pq + 1);
      if (p + need > sl) fail("JPEG DQT segment is truncated");
      for (int i = 0; i < 64; ++i)
        quant_[tq][kNatural[i]] = pq ? (s[p + 1 + 2 * i] << 8) | s[p + 2 + 2 * i] : s[p + 1 + i];
      quant_defined_[tq] = true;
      p += need;
    }
  }

  // the DC prediction plus a difference, refused where it would leave an
  // int as libjpeg refuses it (JERR_BAD_DCT_COEF)
  static int add_dc(int& pred, int diff) {
    int64_t v = int64_t(pred) + diff;
    if (v > INT32_MAX || v < INT32_MIN) fail("JPEG DC coefficient is out of range");
    return pred = int(v);
  }

  void decode_block(BitReader& br, const Huffman& dc, const Huffman& ac, int& pred, int16_t* blk) {
    int t = br.decode(dc);
    int diff = t ? extend(br.get(t), t) : 0;
    blk[0] = int16_t(add_dc(pred, diff));
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.get(sz), sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c:decode_mcu_AC_first on one block
  static void ac_first(BitReader& br, const Huffman& ac, int Ss, int Se, int Al, unsigned& eobrun,
                       int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = Ss; k <= Se; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNatural[k]] = int16_t(unsigned(extend(br.get(sz), sz)) << Al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1u << r) + unsigned(br.get(r)) - 1;
        break;
      }
    }
  }

  // jdphuff.c:decode_mcu_AC_refine on one block: a correction bit for each
  // coefficient already nonzero, a newly nonzero one of +-1 << Al where the
  // run of zeros ends
  static void ac_refine(BitReader& br, const Huffman& ac, int Ss, int Se, int Al, unsigned& eobrun,
                        int16_t* blk) {
    const int p1 = 1 << Al, m1 = -p1;
    auto correct = [&](int16_t* coef) {
      if (br.get(1) && (*coef & p1) == 0) *coef = int16_t(*coef + (*coef >= 0 ? p1 : m1));
    };
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4, sz = rs & 15, v = 0;
        if (sz) {  // a size other than 1 is a warning in libjpeg, read as 1
          v = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = (1u << r) + unsigned(br.get(r));
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= Se);
        if (v) blk[kNatural[k]] = int16_t(v);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void scan(const uint8_t* s, size_t sl) {
    if (sl < 1) fail("JPEG SOS segment is too short");
    int ns = s[0];
    if (ns < 1 || ns > 4 || sl < size_t(4 + 2 * ns)) fail("JPEG SOS segment is invalid");
    const int Ss = s[1 + 2 * ns], Se = s[2 + 2 * ns], Ah = s[3 + 2 * ns] >> 4, Al = s[3 + 2 * ns] & 15;
    if (progressive_) {
      // jdphuff.c:start_pass_phuff_decoder's validation (JERR_BAD_PROGRESSION)
      bool bad = Ss == 0 ? Se != 0 : (Ss > Se || Se > 63 || ns != 1);
      if (Ah != 0 && Al != Ah - 1) bad = true;
      if (Al > 13) bad = true;
      if (bad)
        fail("JPEG has invalid progressive parameters Ss=" + std::to_string(Ss) + " Se=" + std::to_string(Se) +
             " Ah=" + std::to_string(Ah) + " Al=" + std::to_string(Al));
    }
    // which tables the scan decodes with: a progressive DC refine scan none,
    // a DC first scan the DC table, an AC scan the AC table
    const bool use_dc = !progressive_ || (Ss == 0 && Ah == 0), use_ac = !progressive_ || Ss != 0;
    std::vector<Component*> sc;
    std::vector<int> tds, tas;
    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      Component* found = nullptr;
      for (Component& c : comps_)
        if (c.id == id) found = &c;
      if (!found) fail("JPEG scan names a component its frame lacks");
      int td = s[2 + 2 * i] >> 4, ta = s[2 + 2 * i] & 15;
      if ((use_dc && (td > 3 || !dc_[td].defined)) || (use_ac && (ta > 3 || !ac_[ta].defined)))
        fail("JPEG scan uses a Huffman table that is not defined");
      // jdhuff.c:jpeg_make_d_derived_tbl refuses a DC table with a symbol
      // above 15 when a scan takes it (a DC difference has at most 15 bits)
      if (use_dc && dc_[td].max_val > 15) fail("JPEG DC Huffman table holds a symbol above 15");
      if (!found->latched) {
        if (!quant_defined_[found->tq]) fail("JPEG component uses a quantization table that is not defined");
        for (int k = 0; k < 64; ++k) found->quant[k] = int16_t(quant_[found->tq][k]);
        found->latched = true;
        found->coef.assign(size_t(found->bw) * found->bh * 64, 0);
      }
      found->scanned = true;
      if (progressive_) std::fill(found->coef_bits + Ss, found->coef_bits + Se + 1, Al);
      blocks_in_mcu += found->h * found->v;
      sc.push_back(found);
      tds.push_back(td);
      tas.push_back(ta);
    }
    // jdinput.c:per_scan_setup (D_MAX_BLOCKS_IN_MCU)
    if (ns > 1 && blocks_in_mcu > 10) fail("JPEG sampling factors are too large for an interleaved scan");
    BitReader br(d_, n_, pos_);
    std::vector<int> pred(size_t(ns), 0);
    unsigned eobrun = 0;
    auto block = [&](int i, int16_t* blk) {
      if (!progressive_) {
        decode_block(br, dc_[tds[size_t(i)]], ac_[tas[size_t(i)]], pred[size_t(i)], blk);
      } else if (Ss == 0 && Ah == 0) {  // DC first
        int t = br.decode(dc_[tds[size_t(i)]]);
        int diff = t ? extend(br.get(t), t) : 0;
        blk[0] = int16_t(unsigned(add_dc(pred[size_t(i)], diff)) << Al);
      } else if (Ss == 0) {  // DC refine: the next bit of the two's complement value
        if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << Al));
      } else if (Ah == 0) {
        ac_first(br, ac_[tas[0]], Ss, Se, Al, eobrun, blk);
      } else {
        ac_refine(br, ac_[tas[0]], Ss, Se, Al, eobrun, blk);
      }
    };
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = (sc[0]->ds_w + 7) / 8;
      mcus_y = (sc[0]->ds_h + 7) / 8;
    } else {
      mcus_x = mcux_;
      mcus_y = mcuy_;
    }
    int64_t total = int64_t(mcus_x) * mcus_y;
    int rst = 0;
    // refused as soon as a restart or the end of an MCU row finds that the
    // blocks took bits past the data's end, not after decoding the rest
    auto truncated = [&](int64_t row) {
      if (br.overran())
        fail("JPEG entropy data is truncated (in MCU row " + std::to_string(row) + " of " +
             std::to_string(mcus_y) + ")");
    };
    for (int64_t m = 0; m < total; ++m) {
      int mx = int(m % mcus_x), my = int(m / mcus_x);
      if (restart_interval_ && m > 0 && m % restart_interval_ == 0) {
        truncated(my);
        restart(br, rst++);
        std::fill(pred.begin(), pred.end(), 0);
        eobrun = 0;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[size_t(i)];
        if (ns == 1) {
          block(0, &c.coef[(size_t(my) * c.bw + mx) * 64]);
          continue;
        }
        for (int v = 0; v < c.v; ++v)
          for (int h = 0; h < c.h; ++h) {
            size_t by = size_t(my) * c.v + v, bx = size_t(mx) * c.h + h;
            block(i, &c.coef[(by * c.bw + bx) * 64]);
          }
      }
      if (mx == mcus_x - 1) truncated(my);
    }
    pos_ = br.pos;
  }

  // jdcoefct.c:smoothing_ok at the end of the input (libjpeg-turbo 3.1: DC
  // and the first nine AC coefficients, SAVED_COEFS 10): whether libjpeg
  // would decode the image with block smoothing
  bool needs_block_smoothing() const {
    if (!progressive_) return false;
    static const int kSmoothed[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // natural positions
    bool useful = false;
    for (const Component& c : comps_) {
      if (!c.latched) return false;
      for (int p : kSmoothed)
        if (c.quant[p] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void restart(BitReader& br, int count) {
    size_t p = br.pos;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0xFF && d_[p + 1] != 0)) ++p;
    if (p + 1 >= n_ || d_[p + 1] != 0xD0 + (count & 7)) fail("JPEG restart marker is missing");
    br.pos = p + 2;
    br.stopped = false;
    br.reset();
  }

  // the component upsampled to (at least) the image's size, as jdsample.c
  // does it at its defaults; row stride width_
  std::vector<uint8_t> upsample(const Component& c) const {
    const int W = width_, H = height_;
    const int rh = max_h_ / c.h, rv = max_v_ / c.v;
    const int stride = c.bw * 8;
    std::vector<uint8_t> out(size_t(W) * H);
    auto in = [&](int x, int y) -> int { return c.plane[size_t(y) * stride + x]; };
    // context rows: above the first real row and below the last one, the
    // nearest real row (jdmainct.c)
    auto row = [&](int y) { return y < 0 ? 0 : y >= c.ds_h ? c.ds_h - 1 : y; };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[size_t(y) * W], &c.plane[size_t(y) * stride], size_t(W));
    } else if (rh == 2 && rv == 1 && c.ds_w > 2) {  // h2v1_fancy_upsample
      std::vector<uint8_t> line(size_t(c.ds_w) * 2);
      for (int y = 0; y < H; ++y) {
        const int n = c.ds_w;
        line[0] = uint8_t(in(0, y));
        line[1] = uint8_t((in(0, y) * 3 + in(1, y) + 2) >> 2);
        for (int x = 1; x < n - 1; ++x) {
          int v = in(x, y) * 3;
          line[2 * x] = uint8_t((v + in(x - 1, y) + 1) >> 2);
          line[2 * x + 1] = uint8_t((v + in(x + 1, y) + 2) >> 2);
        }
        line[2 * n - 2] = uint8_t((in(n - 1, y) * 3 + in(n - 2, y) + 1) >> 2);
        line[2 * n - 1] = uint8_t(in(n - 1, y));
        std::memcpy(&out[size_t(y) * W], line.data(), size_t(W));
      }
    } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        int iy = y >> 1, near = row(iy), far = row((y & 1) ? iy + 1 : iy - 1), bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x) out[size_t(y) * W + x] = uint8_t((in(x, near) * 3 + in(x, far) + bias) >> 2);
      }
    } else if (rh == 2 && rv == 2 && c.ds_w > 2) {  // h2v2_fancy_upsample
      std::vector<uint8_t> line(size_t(c.ds_w) * 2);
      std::vector<int> sum(size_t(c.ds_w));
      for (int y = 0; y < H; ++y) {
        int iy = y >> 1, near = row(iy), far = row((y & 1) ? iy + 1 : iy - 1);
        const int n = c.ds_w;
        for (int x = 0; x < n; ++x) sum[size_t(x)] = in(x, near) * 3 + in(x, far);
        line[0] = uint8_t((sum[0] * 4 + 8) >> 4);
        line[1] = uint8_t((sum[0] * 3 + sum[1] + 7) >> 4);
        for (int x = 1; x < n - 1; ++x) {
          line[2 * size_t(x)] = uint8_t((sum[size_t(x)] * 3 + sum[size_t(x) - 1] + 8) >> 4);
          line[2 * size_t(x) + 1] = uint8_t((sum[size_t(x)] * 3 + sum[size_t(x) + 1] + 7) >> 4);
        }
        line[2 * size_t(n) - 2] = uint8_t((sum[size_t(n) - 1] * 3 + sum[size_t(n) - 2] + 8) >> 4);
        line[2 * size_t(n) - 1] = uint8_t((sum[size_t(n) - 1] * 4 + 7) >> 4);
        std::memcpy(&out[size_t(y) * W], line.data(), size_t(W));
      }
    } else {  // box replication (h2v1/h2v2 at a width of 2 or less, other integral factors)
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) out[size_t(y) * W + x] = uint8_t(in(x / rh, y / rv));
    }
    return out;
  }
};

void copy_error(const char* msg, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// The image's width and height from its frame header. Returns 0, or 1 with
// a message in err.
int mvd_jpeg_info(const uint8_t* data, size_t size, int* width, int* height, char* err, int errlen) {
  try {
    Decoder dec(data, size);
    dec.run(true);
    *width = dec.width();
    *height = dec.height();
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// Decode into out, height x width x 3 uint8 (the sizes mvd_jpeg_info gave).
// Returns 0, or 1 with a message in err.
int mvd_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height, char* err,
                    int errlen) {
  try {
    Decoder dec(data, size);
    dec.run(false);
    if (dec.width() != width || dec.height() != height) throw JpegError("JPEG size changed between calls");
    dec.output(out);
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
