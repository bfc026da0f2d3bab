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
//     post-IDCT range-limit table indexed by the value & 1023); PIL runs
//     libjpeg-turbo's SIMD form of it, which is the same on every
//     coefficient a conforming encoder writes and saturates where this
//     one wraps on corrupt data (ROADMAP Queue 3, fault 12);
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
//     its K;
//   * arithmetic-coded frames (SOF9 sequential, SOF10 progressive; T.81
//     Annex D, F.1.4 and G.1.3), decoded as jdarith.c decodes them: the C
//     and A registers with jaricom.c's 113-entry Qe table, 64 DC and 256
//     AC statistics bins a table slot, DAC conditioning (L, U, Kx; 0, 1
//     and 5 by default), zeros fed after a marker, statistics and DC
//     contexts reset at each restart, libjpeg's give-up (ct = -1) on a
//     bad code until the next restart;
//   * lossless frames (SOF3, Huffman; jdlossls.c, jddiffct.c, jdlhuff.c of
//     libjpeg-turbo 3): predictors 1-7, the point transform, the initial
//     predictor 2^(P-Pt-1) on the first row and on the first row that
//     libjpeg undifferences after a restart, difference categories 0-16,
//     interleaved MCUs of one sample a sampling unit, samples modulo 2^16
//     shifted left by Pt; upsampling by replication (libjpeg's fancy
//     upsampling needs a DCT size above 1); only the colour spaces libjpeg
//     leaves unconverted in lossless mode (gray, RGB, CMYK);
//   * block smoothing (jdcoefct.c:decompress_smooth_data, libjpeg-turbo
//     3.1, on by default and left on by PIL) of a progressive image whose
//     scans leave one of the first nine AC coefficients of a component
//     unrefined (smoothing_ok on the final coef_bits, as PIL reads every
//     scan before the output pass): the 5x5 DC neighbourhood in libjpeg's
//     sliding registers, its DC-only estimate (change_dc) and the
//     estimates of AC 1-9 rounded against Q00 x Qkl and clamped below
//     2^Al.
//
// EXIF orientation is not applied (PIL's open does not). What PIL refuses
// is refused with a message naming it: hierarchical frames (SOF5-7,
// SOF13-15), lossless arithmetic coding (SOF11), precision other than 8
// bits, a height of 0 (DNL), a lossless frame in a colour space libjpeg
// would convert (YCbCr, YCCK). So is entropy data of a Huffman scan that
// runs past its end (at the end of the MCU row where it does), a DC
// Huffman table with a symbol above 15 (16 in a lossless frame) as libjpeg
// refuses it, sampling factors of more than 10 blocks in an interleaved
// MCU (as libjpeg refuses them) and a header of more pixels than PIL's
// decompression-bomb limit (refused before anything is allocated, as
// Image.open refuses it).
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

// jaricom.c:jpeg_aritab, T.81 Table D.2: Qe_Value << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
#define QE(i, qe, lps, mps, sw) ((uint32_t(qe) << 16) | (uint32_t(mps) << 8) | (uint32_t(sw) << 7) | uint32_t(lps))
const uint32_t kAriTab[114] = {
    QE(0, 0x5a1d, 1, 1, 1),       QE(1, 0x2586, 14, 2, 0),      QE(2, 0x1114, 16, 3, 0),
    QE(3, 0x080b, 18, 4, 0),      QE(4, 0x03d8, 20, 5, 0),      QE(5, 0x01da, 23, 6, 0),
    QE(6, 0x00e5, 25, 7, 0),      QE(7, 0x006f, 28, 8, 0),      QE(8, 0x0036, 30, 9, 0),
    QE(9, 0x001a, 33, 10, 0),     QE(10, 0x000d, 35, 11, 0),    QE(11, 0x0006, 9, 12, 0),
    QE(12, 0x0003, 10, 13, 0),    QE(13, 0x0001, 12, 13, 0),    QE(14, 0x5a7f, 15, 15, 1),
    QE(15, 0x3f25, 36, 16, 0),    QE(16, 0x2cf2, 38, 17, 0),    QE(17, 0x207c, 39, 18, 0),
    QE(18, 0x17b9, 40, 19, 0),    QE(19, 0x1182, 42, 20, 0),    QE(20, 0x0cef, 43, 21, 0),
    QE(21, 0x09a1, 45, 22, 0),    QE(22, 0x072f, 46, 23, 0),    QE(23, 0x055c, 48, 24, 0),
    QE(24, 0x0406, 49, 25, 0),    QE(25, 0x0303, 51, 26, 0),    QE(26, 0x0240, 52, 27, 0),
    QE(27, 0x01b1, 54, 28, 0),    QE(28, 0x0144, 56, 29, 0),    QE(29, 0x00f5, 57, 30, 0),
    QE(30, 0x00b7, 59, 31, 0),    QE(31, 0x008a, 60, 32, 0),    QE(32, 0x0068, 62, 33, 0),
    QE(33, 0x004e, 63, 34, 0),    QE(34, 0x003b, 32, 35, 0),    QE(35, 0x002c, 33, 9, 0),
    QE(36, 0x5ae1, 37, 37, 1),    QE(37, 0x484c, 64, 38, 0),    QE(38, 0x3a0d, 65, 39, 0),
    QE(39, 0x2ef1, 67, 40, 0),    QE(40, 0x261f, 68, 41, 0),    QE(41, 0x1f33, 69, 42, 0),
    QE(42, 0x19a8, 70, 43, 0),    QE(43, 0x1518, 72, 44, 0),    QE(44, 0x1177, 73, 45, 0),
    QE(45, 0x0e74, 74, 46, 0),    QE(46, 0x0bfb, 75, 47, 0),    QE(47, 0x09f8, 77, 48, 0),
    QE(48, 0x0861, 78, 49, 0),    QE(49, 0x0706, 79, 50, 0),    QE(50, 0x05cd, 48, 51, 0),
    QE(51, 0x04de, 50, 52, 0),    QE(52, 0x040f, 50, 53, 0),    QE(53, 0x0363, 51, 54, 0),
    QE(54, 0x02d4, 52, 55, 0),    QE(55, 0x025c, 53, 56, 0),    QE(56, 0x01f8, 54, 57, 0),
    QE(57, 0x01a4, 55, 58, 0),    QE(58, 0x0160, 56, 59, 0),    QE(59, 0x0125, 57, 60, 0),
    QE(60, 0x00f6, 58, 61, 0),    QE(61, 0x00cb, 59, 62, 0),    QE(62, 0x00ab, 61, 63, 0),
    QE(63, 0x008f, 61, 32, 0),    QE(64, 0x5b12, 65, 65, 1),    QE(65, 0x4d04, 80, 66, 0),
    QE(66, 0x412c, 81, 67, 0),    QE(67, 0x37d8, 82, 68, 0),    QE(68, 0x2fe8, 83, 69, 0),
    QE(69, 0x293c, 84, 70, 0),    QE(70, 0x2379, 86, 71, 0),    QE(71, 0x1edf, 87, 72, 0),
    QE(72, 0x1aa9, 87, 73, 0),    QE(73, 0x174e, 72, 74, 0),    QE(74, 0x1424, 72, 75, 0),
    QE(75, 0x119c, 74, 76, 0),    QE(76, 0x0f6b, 74, 77, 0),    QE(77, 0x0d51, 75, 78, 0),
    QE(78, 0x0bb6, 77, 79, 0),    QE(79, 0x0a40, 77, 48, 0),    QE(80, 0x5832, 80, 81, 1),
    QE(81, 0x4d1c, 88, 82, 0),    QE(82, 0x438e, 89, 83, 0),    QE(83, 0x3bdd, 90, 84, 0),
    QE(84, 0x34ee, 91, 85, 0),    QE(85, 0x2eae, 92, 86, 0),    QE(86, 0x299a, 93, 87, 0),
    QE(87, 0x2516, 86, 71, 0),    QE(88, 0x5570, 88, 89, 1),    QE(89, 0x4ca9, 95, 90, 0),
    QE(90, 0x44d9, 96, 91, 0),    QE(91, 0x3e22, 97, 92, 0),    QE(92, 0x3824, 99, 93, 0),
    QE(93, 0x32b4, 99, 94, 0),    QE(94, 0x2e17, 93, 86, 0),    QE(95, 0x56a8, 95, 96, 1),
    QE(96, 0x4f46, 101, 97, 0),   QE(97, 0x47e5, 102, 98, 0),   QE(98, 0x41cf, 103, 99, 0),
    QE(99, 0x3c3d, 104, 100, 0),  QE(100, 0x375e, 99, 93, 0),   QE(101, 0x5231, 105, 102, 0),
    QE(102, 0x4c0f, 106, 103, 0), QE(103, 0x4639, 107, 104, 0), QE(104, 0x415e, 103, 99, 0),
    QE(105, 0x5627, 105, 106, 1), QE(106, 0x50e7, 108, 107, 0), QE(107, 0x4b85, 109, 103, 0),
    QE(108, 0x5597, 110, 109, 0), QE(109, 0x504f, 111, 107, 0), QE(110, 0x5a10, 110, 111, 1),
    QE(111, 0x5522, 112, 109, 0), QE(112, 0x59eb, 112, 111, 1), QE(113, 0x5a1d, 113, 113, 0)};
#undef QE

// jdarith.c's decoder state and arith_decode. Past a marker the input
// supplies zero bytes (legal in arithmetic coding); the position stays at
// the marker's 0xFF so that a restart or the next segment finds it.
// `furthest` is the last byte get_byte has read (the data's end if it ran
// out).
struct ArithDecoder {
  const uint8_t* d;
  size_t n;
  size_t pos;
  size_t furthest;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read before the first decision
  bool stopped = false;

  ArithDecoder(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start), furthest(start) {}

  int byte() {
    if (stopped) return 0;
    if (pos >= n) {
      furthest = n;
      return 0;
    }
    furthest = std::max(furthest, pos);
    int b = d[pos++];
    if (b != 0xFF) return b;
    size_t q = pos;
    while (q < n && d[q] == 0xFF) ++q;  // fill bytes before a marker
    furthest = std::max(furthest, q);
    if (q < n && d[q] == 0) {
      pos = q + 1;
      return 0xFF;
    }
    stopped = true;
    pos = q - 1;
    return 0;
  }
  void reset() {
    c = 0;
    a = 0;
    ct = -16;
    stopped = false;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalization and data input, T.81 D.2.6
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAriTab[sv & 0x7F];
    const uint8_t nl = uint8_t(qe & 0xFF);
    qe >>= 8;
    const uint8_t nm = uint8_t(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - int64_t(qe);
    a = temp;
    temp <<= ct;
    if (c >= temp) {  // the upper subinterval: LPS unless the two were exchanged
      c -= temp;
      if (a < int64_t(qe)) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < int64_t(qe)) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int ds_w = 0, ds_h = 0;      // samples that hold image data
  int bw = 0, bh = 0;          // blocks stored (the MCU grid's padding included)
  bool latched = false;        // quant table copied at its first scan
  bool scanned = false;
  int coef_bits[64];           // progressive: Al of the last scan of each zigzag coefficient, -1 before
  int16_t quant[64] = {};      // natural order, as ISLOW_MULT_TYPE (short)
  int quantval[64] = {};       // natural order, the table's own values (smoothing divides by them)
  std::vector<int16_t> coef;   // bh * bw blocks of 64, natural order
  std::vector<int> samp;       // lossless: ds_h x ds_w undifferenced samples, modulo 2^16
  int pt = 0;                  // lossless: the point transform of the component's scan
  std::vector<uint8_t> plane;  // rows of `stride` samples: (bh * 8) x (bw * 8), or ds_h x ds_w
  int stride = 0;
};

// PIL's Image.open refuses an image of more pixels than twice
// Image.MAX_IMAGE_PIXELS (a DecompressionBombError), before any pixel is
// decoded; the header is refused here at the same size
constexpr int64_t kMaxPixels = int64_t(2) * 89478485;
// the bytes PIL reads of a file at a time (ImageFile.MAXBLOCK)
constexpr size_t kPilBlock = 65536;
// Decoder::output's colour handling
enum { kPil = 0, kYcc = 1, kNone = 2, kPlanes = 3 };

// libjpeg-turbo's SIMD islow IDCT (jidctint-avx2.asm, jidctint-sse2.asm),
// the one PIL's libjpeg-turbo runs, on one block. It is jidctint.c's
// algorithm in 16-bit lanes: each coefficient is dequantized in 16 bits
// (pmullw, the product wraps); the sums in0 + in4, in0 - in4, in3 + in7 and
// in1 + in5 wrap in 16 bits (paddw); the products and butterflies are 32-bit
// (pmaddwd, paddd); pass 1's outputs saturate to int16 (packssdw), and pass
// 2's to [-128, 127] before the +128 (packssdw, packsswb). A block whose
// rows 1-7 are all zero takes pass 1's shortcut: row 0 dequantized and
// shifted left by PASS1_BITS, both in 16 bits (pmullw, psllw).
namespace idct {
constexpr int CB = 13, P1 = 2;
constexpr int F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
              F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int16_t wrap16(int32_t v) { return int16_t(uint16_t(uint32_t(v))); }
inline int16_t sat16(int32_t v) { return int16_t(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }
inline int32_t add(int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); }
inline int32_t sub(int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); }
// pmaddwd: a * ca + b * cb, 32-bit
inline int32_t madd(int16_t a, int ca, int16_t b, int cb) { return add(int32_t(a) * ca, int32_t(b) * cb); }

// one 8-point pass on 16-bit inputs; out holds the 32-bit values before
// the descale
inline void pass(const int16_t* in, int32_t* out) {
  int32_t tmp3 = madd(in[2], F0541 + F0765, in[6], F0541);
  int32_t tmp2 = madd(in[2], F0541, in[6], F0541 - F1847);
  int32_t tmp0 = int32_t(wrap16(int32_t(in[0]) + in[4])) * (1 << CB);
  int32_t tmp1 = int32_t(wrap16(int32_t(in[0]) - in[4])) * (1 << CB);
  int32_t tmp10 = add(tmp0, tmp3), tmp13 = sub(tmp0, tmp3), tmp11 = add(tmp1, tmp2), tmp12 = sub(tmp1, tmp2);
  int16_t z3 = wrap16(int32_t(in[3]) + in[7]), z4 = wrap16(int32_t(in[1]) + in[5]);
  int32_t z3p = madd(z3, F1175 - F1961, z4, F1175);
  int32_t z4p = madd(z3, F1175, z4, F1175 - F0390);
  int32_t o0 = add(madd(in[7], F0298 - F0899, in[1], -F0899), z3p);
  int32_t o3 = add(madd(in[7], -F0899, in[1], F1501 - F0899), z4p);
  int32_t o1 = add(madd(in[5], F2053 - F2562, in[3], -F2562), z4p);
  int32_t o2 = add(madd(in[5], -F2562, in[3], F3072 - F2562), z3p);
  out[0] = add(tmp10, o3);
  out[7] = sub(tmp10, o3);
  out[1] = add(tmp11, o2);
  out[6] = sub(tmp11, o2);
  out[2] = add(tmp12, o1);
  out[5] = sub(tmp12, o1);
  out[3] = add(tmp13, o0);
  out[4] = sub(tmp13, o0);
}

inline int32_t descale(int32_t x, int n) { return add(x, 1 << (n - 1)) >> n; }
}  // namespace idct

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  using namespace idct;
  int16_t ws[64];
  bool ac_rows = false;
  for (int i = 8; i < 64; ++i) ac_rows |= in[i] != 0;
  if (!ac_rows) {
    for (int c = 0; c < 8; ++c) {
      int16_t v = wrap16(int32_t(uint16_t(wrap16(int32_t(in[c]) * q[c]))) << P1);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t col[8];
      int32_t o[8];
      for (int r = 0; r < 8; ++r) col[r] = wrap16(int32_t(in[8 * r + c]) * q[8 * r + c]);
      pass(col, o);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = sat16(descale(o[r], CB - P1));
    }
  }
  for (int r = 0; r < 8; ++r) {
    int32_t o[8];
    pass(ws + 8 * r, o);
    uint8_t* op = out + size_t(r) * stride;
    for (int c = 0; c < 8; ++c) {
      int32_t v = sat16(descale(o[c], CB + P1 + 3));
      op[c] = uint8_t((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
  }
}

class Decoder {
 public:
  // whole: the stream is in memory at once, as libtiff hands a strip to
  // libjpeg (PIL's JPEG plugin feeds it 65536 bytes at a time)
  Decoder(const uint8_t* data, size_t size, bool whole = false) : d_(data), n_(size), whole_(whole) {
    std::fill(arith_dc_L_, arith_dc_L_ + 16, 0);
    std::fill(arith_dc_U_, arith_dc_U_ + 16, 1);
    std::fill(arith_ac_K_, arith_ac_K_ + 16, 5);
  }

  // Parse up to the frame header (header_only) or decode the whole image.
  void run(bool header_only) {
    // PIL opens a file as JPEG by its first three bytes; libjpeg, handed a
    // TIFF strip whole, checks the SOI's two
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8 || (!whole_ && (n_ < 3 || d_[2] != 0xFF)))
      fail("not a JPEG file (no SOI)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      // jdmarker.c:read_markers: a second SOI is JERR_SOI_DUPLICATE
      if (m == 0xD8) fail("JPEG has a second SOI marker (libjpeg refuses it)");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
        frame(m);
        if (header_only) return;
        continue;
      }
      // jdmarker.c:read_markers refuses the rest (JERR_SOF_UNSUPPORTED)
      if ((m >= 0xC5 && m <= 0xC7) || (m >= 0xCD && m <= 0xCF))
        fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not read, as libjpeg does not read it");
      if (m == 0xCB) fail("lossless arithmetic-coded JPEG (SOF11) is not read, as libjpeg does not read it");
      if (m == 0xDC) fail("JPEG with a DNL marker is not read");
      size_t len = segment_length();
      const uint8_t* s = d_ + pos_ + 2;
      size_t sl = len - 2;
      if (m == 0xC4) {
        dht(s, sl);
      } else if (m == 0xCC) {
        dac(s, sl);
      } else if (m == 0xDB) {
        dqt(s, sl);
      } else if (m == 0xDD) {
        if (sl != 2) fail("JPEG DRI segment has a bad length (Bogus marker length)");
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
      } else if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE)) {
        // read_markers' default and its unsupported SOFn: JPG (0xC8), the
        // JPGn extensions (0xF0-0xFD), DHP, EXP and the reserved markers
        // are fatal errors (JERR_UNKNOWN_MARKER, JERR_SOF_UNSUPPORTED)
        char buf[96];
        std::snprintf(buf, sizeof buf, "JPEG marker 0xFF%02X is not read, as libjpeg does not read it", m);
        fail(buf);
      }
      pos_ += len;
    }
    if (!have_frame_) fail("JPEG has no frame header");
    if (header_only) return;
    for (const Component& c : comps_)
      if (!c.scanned) fail("JPEG ends before every component was scanned");
  }

  int width() const { return width_; }
  int height() const { return height_; }
  const std::vector<Component>& components() const { return comps_; }

  // The image's samples after the IDCT (block-smoothed where libjpeg
  // smooths): each component's plane, (bh * 8) x (bw * 8) samples.
  void planes() {
    const bool smooth = block_smoothing();
    for (Component& c : comps_) {
      if (lossless_) {  // jdlossls.c's scaler: the sample shifted left by its scan's Pt, as an 8-bit JSAMPLE
        c.stride = c.ds_w;
        c.plane.resize(c.samp.size());
        for (size_t i = 0; i < c.samp.size(); ++i) c.plane[i] = uint8_t(c.samp[i] << c.pt);
        continue;
      }
      c.stride = c.bw * 8;
      c.plane.assign(size_t(c.bh) * 8 * c.stride, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                     &c.plane[size_t(by) * 8 * c.stride + size_t(bx) * 8], c.stride);
      if (smooth) smooth_blocks(c);
    }
  }

  // The decoded image into out, by `space`: kPil PIL's convert("RGB") of
  // the mode it opens the file in (height x width x 3); kYcc libtiff's
  // JPEGCOLORMODE_RGB, three components taken as YCbCr whatever the
  // markers say and converted to RGB (x 3); kNone libjpeg's JCS_UNKNOWN,
  // each component upsampled and none converted (x components); kPlanes
  // libjpeg's raw_data_out, each component's plane as planes() leaves it,
  // one after another.
  void output(uint8_t* out, int space = kPil) {
    planes();
    const size_t W = size_t(width_), H = size_t(height_);
    if (space == kPlanes) {
      for (const Component& c : comps_) {
        std::memcpy(out, c.plane.data(), c.plane.size());
        out += c.plane.size();
      }
      return;
    }
    if (space == kNone) {
      const size_t nc = comps_.size();
      for (size_t i = 0; i < nc; ++i) {
        std::vector<uint8_t> full = upsample(comps_[i]);
        for (size_t p = 0; p < W * H; ++p) out[p * nc + i] = full[p];
      }
      return;
    }
    if (space == kYcc && comps_.size() != 3) fail("JPEG with " + std::to_string(comps_.size()) + " components is not YCbCr");
    if (comps_.size() == 1) {
      const Component& c = comps_[0];
      for (size_t y = 0; y < H; ++y)
        for (size_t x = 0; x < W; ++x) {
          uint8_t g = c.plane[y * c.stride + x];
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
    const bool rgb = space == kPil && color_is_rgb();
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
  bool whole_;
  size_t pos_ = 0;
  bool have_frame_ = false, saw_jfif_ = false, saw_adobe_ = false, progressive_ = false;
  bool arith_ = false, lossless_ = false, scanned_any_ = false;
  int adobe_transform_ = 0;
  int width_ = 0, height_ = 0, max_h_ = 1, max_v_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  std::vector<Component> comps_;
  Huffman dc_[4], ac_[4];
  int quant_[4][64] = {};
  bool quant_defined_[4] = {};
  // arithmetic coding: DAC conditioning (jdmarker.c's defaults L 0, U 1,
  // Kx 5, set by the constructor) and the statistics bins of each table
  // slot (jdarith.c)
  uint8_t arith_dc_L_[16], arith_dc_U_[16], arith_ac_K_[16];
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  uint8_t fixed_bin_ = 113;

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
    // jdapimin.c:default_decompress_parms for three components; without a
    // JFIF or Adobe marker a lossless frame is RGB whatever its ids
    if (saw_jfif_) return false;
    if (saw_adobe_) return adobe_transform_ == 0;
    if (lossless_) return true;
    return comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
  }

  // jdcolor.c:jinit_color_deconverter allows no colour conversion in
  // lossless mode (JERR_CONVERSION_NOTIMPL): YCbCr -> RGB and YCCK -> CMYK
  // are refused where libjpeg refuses them, before any scan is decoded
  void check_lossless_color() const {
    if (comps_.size() == 3 && !color_is_rgb())
      fail("lossless JPEG in the YCbCr colour space is not read: libjpeg does no colour conversion in "
           "lossless mode");
    if (comps_.size() == 4 && saw_adobe_ && adobe_transform_ != 0)
      fail("lossless JPEG in the YCCK colour space is not read: libjpeg does no colour conversion in "
           "lossless mode");
  }

  void frame(int m) {
    if (have_frame_) fail("JPEG has two frame headers");
    size_t len = segment_length();
    const uint8_t* s = d_ + pos_ + 2;
    if (len < 8) fail("JPEG frame header is too short");
    if (s[0] != 8)
      fail(std::to_string(s[0]) + "-bit " + (m == 0xC3 ? "lossless " : "") + "JPEG (SOF" +
           std::to_string(m - 0xC0) + ") is not read (8-bit only)");
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    int nc = s[5];
    if (height_ == 0) fail("JPEG with a DNL marker (height 0) is not read");
    if (width_ == 0) fail("JPEG width is 0");
    if (int64_t(width_) * height_ > kMaxPixels)
      fail("JPEG of " + std::to_string(width_) + "x" + std::to_string(height_) + " pixels is over the limit of " +
           std::to_string(kMaxPixels) + " pixels (PIL's decompression-bomb limit)");
    if (nc != 1 && nc != 3 && nc != 4) fail("JPEG with " + std::to_string(nc) + " components is not read");
    // jdmarker.c:get_sof: the length must be 8 + 3 Nf (JERR_BAD_LENGTH)
    if (len != size_t(8 + 3 * nc)) fail("JPEG frame header has a bad length (Bogus marker length)");
    comps_.resize(size_t(nc));
    for (int i = 0; i < nc; ++i) {
      Component& c = comps_[size_t(i)];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      // a lossless frame has no quantization tables (libjpeg latches none)
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || (c.tq > 3 && m != 0xC3))
        fail("JPEG frame header is invalid");
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
    progressive_ = m == 0xC2 || m == 0xCA;
    arith_ = m == 0xC9 || m == 0xCA;
    lossless_ = m == 0xC3;
    pos_ += len;
  }

  // jdmarker.c:get_dac
  void dac(const uint8_t* s, size_t sl) {
    if (sl % 2) fail("JPEG DAC segment has a bad length");
    for (size_t p = 0; p < sl; p += 2) {
      int index = s[p], val = s[p + 1];
      if (index >= 32) fail("JPEG DAC segment names table " + std::to_string(index));
      if (index >= 16) {
        arith_ac_K_[index - 16] = uint8_t(val);
      } else {
        arith_dc_L_[index] = uint8_t(val & 15);
        arith_dc_U_[index] = uint8_t(val >> 4);
        if (arith_dc_L_[index] > arith_dc_U_[index]) fail("JPEG DAC segment has L above U");
      }
    }
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
    // jdmarker.c:get_sos: the length must be 6 + 2 Ns (JERR_BAD_LENGTH)
    if (ns < 1 || ns > 4 || sl != size_t(4 + 2 * ns)) fail("JPEG SOS segment is invalid (Bogus marker length)");
    const int Ss = s[1 + 2 * ns], Se = s[2 + 2 * ns], Ah = s[3 + 2 * ns] >> 4, Al = s[3 + 2 * ns] & 15;
    const std::string params = " Ss=" + std::to_string(Ss) + " Se=" + std::to_string(Se) +
                               " Ah=" + std::to_string(Ah) + " Al=" + std::to_string(Al);
    if (lossless_) {
      // jdlossls.c:start_pass_lossless (JERR_BAD_PROGRESSION): Ss is the
      // predictor, Al the point transform
      if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= 8) fail("JPEG has invalid lossless parameters" + params);
      if (!scanned_any_) check_lossless_color();
    } else if (progressive_) {
      // jdphuff.c / jdarith.c start_pass's validation (JERR_BAD_PROGRESSION)
      bool bad = Ss == 0 ? Se != 0 : (Ss > Se || Se > 63 || ns != 1);
      if (Ah != 0 && Al != Ah - 1) bad = true;
      if (Al > 13) bad = true;
      if (bad) fail("JPEG has invalid progressive parameters" + params);
    }
    scanned_any_ = true;
    // which tables the scan decodes with: a progressive DC refine scan none,
    // a DC first scan the DC table, an AC scan the AC table, a lossless
    // scan its DC table
    const bool use_dc = lossless_ || !progressive_ || (Ss == 0 && Ah == 0);
    const bool use_ac = !lossless_ && (!progressive_ || Ss != 0);
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
      if (!arith_) {  // arithmetic coding needs no table: 16 slots of statistics
        if ((use_dc && (td > 3 || !dc_[td].defined)) || (use_ac && (ta > 3 || !ac_[ta].defined)))
          fail("JPEG scan uses a Huffman table that is not defined");
        // jdhuff.c:jpeg_make_d_derived_tbl refuses a DC table with a symbol
        // above 15 when a scan takes it (a DC difference has at most 15
        // bits; a lossless difference category goes to 16)
        if (use_dc && dc_[td].max_val > (lossless_ ? 16 : 15))
          fail("JPEG DC Huffman table holds a symbol above " + std::to_string(lossless_ ? 16 : 15));
      }
      if (!found->latched) {
        if (lossless_) {
          found->samp.assign(size_t(found->ds_w) * found->ds_h, 0);
        } else {
          if (!quant_defined_[found->tq]) fail("JPEG component uses a quantization table that is not defined");
          for (int k = 0; k < 64; ++k) {
            found->quantval[k] = quant_[found->tq][k];
            found->quant[k] = int16_t(quant_[found->tq][k]);
          }
          found->coef.assign(size_t(found->bw) * found->bh * 64, 0);
        }
        found->latched = true;
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
    if (lossless_) {
      lossless_scan(sc, tds, Ss, Al);
      return;
    }
    BitReader br(d_, n_, pos_);
    ArithDecoder ad(d_, n_, pos_);
    // PIL hands libjpeg the file 65536 bytes at a time (ImageFile.load's
    // MAXBLOCK) and jdarith.c's get_byte cannot wait for the next block
    // (JERR_CANT_SUSPEND): an arithmetic scan must read nothing past the
    // block its segment header ends in (nor past the file's end)
    const size_t block_end = whole_ ? n_ : std::min(n_, ((pos_ - 1) / kPilBlock + 1) * kPilBlock);
    std::vector<int> pred(size_t(ns), 0), dc_ctx(size_t(ns), 0);
    unsigned eobrun = 0;
    bool gave_up = false;  // jdarith.c's ct = -1: a bad code ends the decoding until a restart
    // jdarith.c:start_pass and process_restart: the statistics the scan
    // uses, the DC predictions and contexts, the coder's registers
    auto reset_arith = [&]() {
      for (size_t i = 0; i < size_t(ns); ++i) {
        if (!progressive_ || (Ss == 0 && Ah == 0)) {
          std::memset(dc_stats_[tds[i]], 0, sizeof dc_stats_[0]);
          pred[i] = dc_ctx[i] = 0;
        }
        if (!progressive_ || Ss) std::memset(ac_stats_[tas[i]], 0, sizeof ac_stats_[0]);
      }
      ad.reset();
      gave_up = false;
    };
    if (arith_) reset_arith();
    auto block = [&](int i, int16_t* blk) {
      const size_t u = size_t(i);
      if (arith_) {
        if (gave_up) return;
        if (!progressive_) {
          if (!arith_dc(ad, tds[u], dc_ctx[u], pred[u])) {
            gave_up = true;
            return;
          }
          blk[0] = int16_t(uint16_t(pred[u]));
          gave_up = !arith_ac_sequential(ad, tas[u], blk);
        } else if (Ss == 0 && Ah == 0) {
          gave_up = !arith_dc(ad, tds[u], dc_ctx[u], pred[u]);
          if (!gave_up) blk[0] = int16_t(uint32_t(pred[u]) << Al);
        } else if (Ss == 0) {  // DC refine: the next bit at the fixed 0.5 estimate
          if (ad.decode(&fixed_bin_)) blk[0] = int16_t(blk[0] | (1 << Al));
        } else if (Ah == 0) {
          gave_up = !arith_ac_first(ad, tas[0], Ss, Se, Al, blk);
        } else {
          gave_up = !arith_ac_refine(ad, tas[0], Ss, Se, Al, blk);
        }
      } else if (!progressive_) {
        decode_block(br, dc_[tds[u]], ac_[tas[u]], pred[u], blk);
      } else if (Ss == 0 && Ah == 0) {  // DC first
        int t = br.decode(dc_[tds[u]]);
        int diff = t ? extend(br.get(t), t) : 0;
        blk[0] = int16_t(unsigned(add_dc(pred[u], diff)) << Al);
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
    // Huffman blocks took bits past the data's end, not after decoding the
    // rest (arithmetic coding reads zeros past a marker by design)
    auto truncated = [&](int64_t row) {
      if (!arith_ && br.overran())
        fail("JPEG entropy data is truncated (in MCU row " + std::to_string(row) + " of " +
             std::to_string(mcus_y) + ")");
    };
    for (int64_t m = 0; m < total; ++m) {
      int mx = int(m % mcus_x), my = int(m / mcus_x);
      if (restart_interval_ && m > 0 && m % restart_interval_ == 0) {
        truncated(my);
        if (arith_) {
          ad.pos = restart(ad.pos, rst++);
          ad.furthest = std::max(ad.furthest, ad.pos - 1);  // read_restart_marker read up to the marker
          reset_arith();
        } else {
          br.pos = restart(br.pos, rst++);
          br.stopped = false;
          br.reset();
          std::fill(pred.begin(), pred.end(), 0);
          eobrun = 0;
        }
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
    if (arith_ && ad.furthest >= block_end)
      fail("arithmetic-coded JPEG whose scan reads byte " + std::to_string(ad.furthest) + " past byte " +
           std::to_string(block_end) + " is not read, as PIL does not read it (it feeds libjpeg 65536 bytes at "
           "a time, and libjpeg's arithmetic decoder cannot wait for more)");
    pos_ = arith_ ? ad.pos : br.pos;
  }

  // jdarith.c, T.81 Figures F.19 and F.21-F.24: a DC difference added to
  // last (modulo 2^16) in the context ctx of table tbl; false on a
  // magnitude overflow (libjpeg's JWRN_ARITH_BAD_CODE)
  bool arith_dc(ArithDecoder& ad, int tbl, int& ctx, int& last) {
    uint8_t* st = dc_stats_[tbl] + ctx;
    if (ad.decode(st) == 0) {
      ctx = 0;
      return true;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m) {
      st = dc_stats_[tbl] + 20;  // X1
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        ++st;
      }
    }
    // F.1.4.4.1.2: the conditioning category of the next difference
    if (m < ((1 << arith_dc_L_[tbl]) >> 1))
      ctx = 0;
    else if (m > ((1 << arith_dc_U_[tbl]) >> 1))
      ctx = 12 + sign * 4;
    else
      ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last = (last + v) & 0xFFFF;
    return true;
  }

  // the sign, magnitude category and bits of the AC coefficient at k whose
  // nonzero decision was taken in the bins at st (SE)
  bool arith_ac_value(ArithDecoder& ad, int tbl, int k, uint8_t* st, int& v) {
    const int sign = ad.decode(&fixed_bin_);
    st += 2;
    int m = ad.decode(st);
    if (m && ad.decode(st)) {
      m <<= 1;
      st = ac_stats_[tbl] + (k <= arith_ac_K_[tbl] ? 189 : 217);  // X2, by Kx
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        ++st;
      }
    }
    v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }

  // jdarith.c:decode_mcu's AC part (Figure F.20) on one block
  bool arith_ac_sequential(ArithDecoder& ad, int tbl, int16_t* blk) {
    int k = 0;
    do {
      uint8_t* st = ac_stats_[tbl] + 3 * k;
      if (ad.decode(st)) break;  // EOB
      for (;;) {
        ++k;
        if (ad.decode(st + 1)) break;
        st += 3;
        if (k >= 63) return false;  // spectral overflow
      }
      int v;
      if (!arith_ac_value(ad, tbl, k, st, v)) return false;
      blk[kNatural[k]] = int16_t(v);
    } while (k < 63);
    return true;
  }

  // jdarith.c:decode_mcu_AC_first on one block
  bool arith_ac_first(ArithDecoder& ad, int tbl, int Ss, int Se, int Al, int16_t* blk) {
    for (int k = Ss; k <= Se; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (ad.decode(st)) break;  // EOB
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > Se) return false;
      }
      int v;
      if (!arith_ac_value(ad, tbl, k, st, v)) return false;
      blk[kNatural[k]] = int16_t(unsigned(v) << Al);
    }
    return true;
  }

  // jdarith.c:decode_mcu_AC_refine on one block (Figure G.11): below the
  // previous stage's end of block no EOB decision; a correction bit for a
  // coefficient already nonzero, +-1 << Al for a newly nonzero one
  bool arith_ac_refine(ArithDecoder& ad, int tbl, int Ss, int Se, int Al, int16_t* blk) {
    const int p1 = 1 << Al, m1 = -p1;
    int kex = Se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (k > kex && ad.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ad.decode(st + 2)) *coef = int16_t(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ad.decode(st + 1)) {
          *coef = int16_t(ad.decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) return false;
      }
    }
    return true;
  }

  // a lossless scan (jddiffct.c's iMCU rows, jdlhuff.c:decode_mcus,
  // jdlossls.c's undifferencing): the differences of an iMCU row are
  // decoded first, then each of its rows is undifferenced
  void lossless_scan(const std::vector<Component*>& sc, const std::vector<int>& tds, int psv, int pt) {
    const int ns = int(sc.size());
    const bool inter = ns > 1;
    for (Component* c : sc) c->pt = pt;
    const int T = (height_ + max_v_ - 1) / max_v_;  // iMCU rows: a data unit is one sample
    const int per_row = inter ? (width_ + max_h_ - 1) / max_h_ : sc[0]->ds_w;  // MCUs a row
    // jddiffct.c:start_input_pass (JERR_BAD_RESTART)
    if (restart_interval_ % per_row)
      fail("lossless JPEG restart interval " + std::to_string(restart_interval_) + " is not a multiple of the " +
           std::to_string(per_row) + " MCUs of a row");
    const int rows_per_restart = restart_interval_ / per_row;
    auto last_rows = [](const Component& c) { return c.ds_h % c.v ? c.ds_h % c.v : c.v; };
    BitReader br(d_, n_, pos_);
    std::vector<std::vector<int>> diff(sc.size());
    std::vector<int> dw(sc.size());
    for (size_t i = 0; i < size_t(ns); ++i) {
      dw[i] = inter ? per_row * sc[i]->h : sc[i]->ds_w;
      diff[i].assign(size_t(sc[i]->v) * size_t(dw[i]), 0);
    }
    // each component's undifferencer takes its first-row form at the
    // scan's start and at every restart (start_pass_lossless)
    std::vector<char> first(size_t(ns), 1);
    auto difference = [&](const Huffman& h) {
      int t = br.decode(h);
      if (t == 16) return 32768;
      return t ? extend(br.get(t), t) : 0;
    };
    int togo = rows_per_restart, rst = 0;
    for (int r = 0; r < T; ++r) {
      const int mcu_rows = inter ? 1 : (r < T - 1 ? sc[0]->v : last_rows(*sc[0]));
      for (int yo = 0; yo < mcu_rows; ++yo) {
        if (restart_interval_ && togo == 0) {
          if (br.overran()) fail("JPEG entropy data is truncated (in iMCU row " + std::to_string(r) + ")");
          br.pos = restart(br.pos, rst++);
          br.stopped = false;
          br.reset();
          std::fill(first.begin(), first.end(), 1);
          togo = rows_per_restart;
        }
        for (int mx = 0; mx < per_row; ++mx) {
          if (!inter) {
            diff[0][size_t(yo) * dw[0] + mx] = difference(dc_[tds[0]]);
            continue;
          }
          for (size_t i = 0; i < size_t(ns); ++i)
            for (int y = 0; y < sc[i]->v; ++y)
              for (int x = 0; x < sc[i]->h; ++x)
                diff[i][size_t(y) * dw[i] + size_t(mx) * sc[i]->h + x] = difference(dc_[tds[i]]);
        }
        if (restart_interval_) --togo;
        if (br.overran()) fail("JPEG entropy data is truncated (in iMCU row " + std::to_string(r) + ")");
      }
      for (size_t i = 0; i < size_t(ns); ++i) {
        Component& c = *sc[i];
        const int rows = r == T - 1 ? last_rows(c) : c.v;
        for (int row = 0; row < rows; ++row) {
          undifference(c, &diff[i][size_t(row) * dw[i]], r * c.v + row, first[i], psv, pt);
          first[i] = 0;
        }
      }
    }
    pos_ = br.pos;
  }

  // jdlossls.c: row y of c from its differences, modulo 2^16; the first
  // row form predicts its first sample by 2^(P - Pt - 1), every other
  // row's first sample by the one above
  static void undifference(Component& c, const int* diff, int y, bool first, int psv, int pt) {
    int* out = &c.samp[size_t(y) * c.ds_w];
    const int w = c.ds_w;
    if (first) {
      int ra = (diff[0] + (1 << (8 - pt - 1))) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; ++x) out[x] = ra = (diff[x] + ra) & 0xFFFF;
      return;
    }
    const int* prev = out - c.ds_w;
    int64_t rb = prev[0], ra = (diff[0] + rb) & 0xFFFF;
    out[0] = int(ra);
    for (int x = 1; x < w; ++x) {
      const int64_t rc = rb;
      rb = prev[x];
      int64_t p;
      switch (psv) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      out[x] = int(ra = (diff[x] + p) & 0xFFFF);
    }
  }

  // jdcoefct.c:smoothing_ok at the end of the input (libjpeg-turbo 3.1: DC
  // and the first nine AC coefficients, SAVED_COEFS 10): whether libjpeg
  // decodes the image with block smoothing
  bool block_smoothing() const {
    if (!progressive_) return false;
    static const int kSmoothed[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // natural positions
    bool useful = false;
    for (const Component& c : comps_) {
      if (!c.latched) return false;
      for (int p : kSmoothed)
        if (c.quantval[p] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // jdcoefct.c:decompress_smooth_data over c's blocks, iMCU row by iMCU row
  // as libjpeg walks them (its row clamps use block_rows x the iMCU rows,
  // also on a short last iMCU row), the DC neighbourhood in its sliding
  // registers (initialized to column 0, the last two to column 1 at the
  // first block, column +2 loaded only while it is inside the component:
  // a clamp at both edges); each estimate is applied to a
  // coefficient still 0 whose coef_bits is not 0, and the block's IDCT
  // replaces the plain one
  void smooth_blocks(Component& c) const {
    const int* cb = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k)
      if (cb[k] != -1) change_dc = false;
    const int64_t Q00 = c.quantval[0], Q01 = c.quantval[1], Q10 = c.quantval[8], Q20 = c.quantval[16],
                  Q11 = c.quantval[9], Q02 = c.quantval[2], Q03 = c.quantval[3], Q12 = c.quantval[10],
                  Q21 = c.quantval[17], Q30 = c.quantval[24];
    const int T = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    const int hib = (c.ds_h + 7) / 8, last_col = (c.ds_w + 7) / 8 - 1;
    // a block row past the stored ones is one libjpeg keeps zeroed
    auto dc = [&](int row, int col) -> int {
      return row < c.bh && col < c.bw ? c.coef[(size_t(row) * c.bw + col) * 64] : 0;
    };
    // the estimate num / (Q << 8) rounded, its magnitude clamped below 2^Al
    auto est = [](int64_t num, int64_t q, int Al) {
      int pred = int(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
      if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
      return int16_t(num >= 0 ? pred : -pred);
    };
    int16_t ws[64];
    for (int r = 0; r < T; ++r) {
      int block_rows = c.v;
      if (r == T - 1 && hib % c.v) block_rows = hib % c.v;
      const int image_block_rows = block_rows * T;
      for (int br = 0; br < block_rows; ++br) {
        const int ibr = r * block_rows + br, row = r * c.v + br;
        const int prev = ibr > 0 ? row - 1 : row, pprev = ibr > 1 ? row - 2 : prev;
        const int next = ibr < image_block_rows - 1 ? row + 1 : row;
        const int nnext = ibr < image_block_rows - 2 ? row + 2 : next;
        const int rows[5] = {pprev, prev, row, next, nnext};
        int reg[5][5];
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) reg[i][j] = dc(rows[i], 0);
        for (int col = 0; col <= last_col; ++col) {
          std::memcpy(ws, &c.coef[(size_t(row) * c.bw + col) * 64], sizeof ws);
          if (col == 0 && col < last_col)  // DC04 = DC05 = column 1, and so on
            for (int i = 0; i < 5; ++i) reg[i][3] = reg[i][4] = dc(rows[i], col + 1);
          if (col + 1 < last_col)
            for (int i = 0; i < 5; ++i) reg[i][4] = dc(rows[i], col + 2);
          // libjpeg's DC01..DC25: rows from two above to two below, columns
          // from two left to two right
          int D[26];
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 5; ++j) D[5 * i + j + 1] = reg[i][j];
          int Al;
          if ((Al = cb[1]) != 0 && ws[1] == 0)  // AC01
            ws[1] = est(Q00 * (change_dc ? (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
                                            3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] +
                                            13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25])
                                         : (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15])),
                        Q01, Al);
          if ((Al = cb[2]) != 0 && ws[8] == 0)  // AC10
            ws[8] = est(Q00 * (change_dc ? (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] +
                                            38 * D[8] + 13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] -
                                            13 * D[19] + D[20] + D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25])
                                         : (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23])),
                        Q10, Al);
          if ((Al = cb[3]) != 0 && ws[16] == 0)  // AC20
            ws[16] = est(Q00 * (change_dc ? (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] -
                                             5 * D[14] + 2 * D[17] + 7 * D[18] + 2 * D[19] + D[23])
                                          : (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23])),
                         Q20, Al);
          if ((Al = cb[4]) != 0 && ws[9] == 0)  // AC11
            ws[9] = est(Q00 * (change_dc ? (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25])
                                         : (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] +
                                            D[4] - D[6] + 10 * D[7] - 10 * D[9])),
                        Q11, Al);
          if ((Al = cb[5]) != 0 && ws[2] == 0)  // AC02
            ws[2] = est(Q00 * (change_dc ? (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] +
                                            7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19])
                                         : (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15])),
                        Q02, Al);
          if (change_dc) {
            if ((Al = cb[6]) != 0 && ws[3] == 0)  // AC03
              ws[3] = est(Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]), Q03, Al);
            if ((Al = cb[7]) != 0 && ws[10] == 0)  // AC12
              ws[10] = est(Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]), Q12, Al);
            if ((Al = cb[8]) != 0 && ws[17] == 0)  // AC21
              ws[17] = est(Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]), Q21, Al);
            if ((Al = cb[9]) != 0 && ws[24] == 0)  // AC30
              ws[24] = est(Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]), Q30, Al);
            // the DC term, from the whole 5x5 neighbourhood (weights sum to 256)
            ws[0] = est(Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] + 6 * D[7] +
                               42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] + 42 * D[12] + 152 * D[13] +
                               42 * D[14] - 8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] -
                               6 * D[20] - 2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]),
                        Q00, 0);
          }
          idct_islow(ws, c.quant, &c.plane[size_t(row) * 8 * c.stride + size_t(col) * 8], c.stride);
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 4; ++j) reg[i][j] = reg[i][j + 1];
        }
      }
    }
  }

  // the position after restart marker RST(count & 7), which must be the
  // next marker at or after pos
  size_t restart(size_t pos, int count) const {
    size_t p = pos;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0xFF && d_[p + 1] != 0)) ++p;
    if (p + 1 >= n_ || d_[p + 1] != 0xD0 + (count & 7)) fail("JPEG restart marker is missing");
    return p + 2;
  }

  // the component upsampled to (at least) the image's size, as jdsample.c
  // does it at its defaults; row stride width_
  std::vector<uint8_t> upsample(const Component& c) const {
    const int W = width_, H = height_;
    const int rh = max_h_ / c.h, rv = max_v_ / c.v;
    const int stride = c.stride;
    const bool fancy = !lossless_;  // jdsample.c: fancy only at a DCT size above 1
    std::vector<uint8_t> out(size_t(W) * H);
    auto in = [&](int x, int y) -> int { return c.plane[size_t(y) * stride + x]; };
    // context rows: above the first real row and below the last one, the
    // nearest real row (jdmainct.c)
    auto row = [&](int y) { return y < 0 ? 0 : y >= c.ds_h ? c.ds_h - 1 : y; };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[size_t(y) * W], &c.plane[size_t(y) * stride], size_t(W));
    } else if (fancy && rh == 2 && rv == 1 && c.ds_w > 2) {  // h2v1_fancy_upsample
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
    } else if (fancy && rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        int iy = y >> 1, near = row(iy), far = row((y & 1) ? iy + 1 : iy - 1), bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x) out[size_t(y) * W + x] = uint8_t((in(x, near) * 3 + in(x, far) + bias) >> 2);
      }
    } else if (fancy && rh == 2 && rv == 2 && c.ds_w > 2) {  // h2v2_fancy_upsample
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
    } else {  // box replication (lossless, h2v1/h2v2 at a width of 2 or less, other integral factors)
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

// The frame of a stream libtiff hands libjpeg whole (a TIFF strip or
// tile, its tables spliced in): info[0..2] width, height, components;
// info[3 + 4 k + 0..3] component k's h and v sampling factors and its
// plane's blocks across and down (Decoder::planes). Returns 0, or 1 with a
// message in err.
int mvd_jpeg_frame(const uint8_t* data, size_t size, int* info, char* err, int errlen) {
  try {
    Decoder dec(data, size, true);
    dec.run(true);
    info[0] = dec.width();
    info[1] = dec.height();
    info[2] = int(dec.components().size());
    int k = 3;
    for (const Component& c : dec.components()) {
      info[k++] = c.h;
      info[k++] = c.v;
      info[k++] = c.bw;
      info[k++] = c.bh;
    }
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// Decode such a stream into out by `space` (Decoder::output's kYcc,
// kNone or kPlanes); `bytes` the size of out. Returns 0, or 1 with a
// message in err.
int mvd_jpeg_decode_whole(const uint8_t* data, size_t size, int space, uint8_t* out, size_t bytes, char* err,
                          int errlen) {
  try {
    Decoder dec(data, size, true);
    dec.run(false);
    size_t need = size_t(dec.width()) * size_t(dec.height()) * (space == kYcc ? 3 : dec.components().size());
    if (space == kPlanes) {
      need = 0;
      for (const Component& c : dec.components()) need += size_t(c.bw) * 8 * size_t(c.bh) * 8;
    }
    if (space < kYcc || space > kPlanes) throw JpegError("unknown output space");
    if (need != bytes) throw JpegError("JPEG output size differs from the buffer's");
    dec.output(out, space);
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
