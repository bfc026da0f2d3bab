// WebP decoder, bitwise what PIL 12.1.0 returns for a WebP file (its
// WebPAnimDecoder over libwebp 1.6.0, non-premultiplied RGBA): the RIFF
// container as libwebp's demuxer validates it (simple VP8 and VP8L, VP8X
// with ICCP/EXIF/XMP skipped, ALPH, and an animation, of which the first
// frame is placed on a zero canvas); VP8L (RFC 9649: prefix codes, meta
// codes, colour cache, LZ77, the four transforms); VP8 keyframes (RFC 6386:
// the boolean decoder, segments, 1-8 token partitions, intra prediction,
// the WHT and IDCT, the simple and normal loop filters); ALPH (raw or
// VP8L-coded, with its three unfilters); and libwebp's output stage (the
// fancy chroma upsampler and its 14-bit YUV->RGB). Each step follows the
// arithmetic of libwebp's decoder (src/dec, src/dsp, src/demux), including
// its bit readers' end-of-stream behaviour, so that every file libwebp
// decodes gives its pixels and every file it refuses is refused.
//
// Plain C interface for ctypes (utils/images.py:decode_webp); standard
// library only.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "webp_tables.h"

using namespace webp_tables;

namespace {

struct Fail : std::runtime_error {
  using std::runtime_error::runtime_error;
};
[[noreturn]] void fail(const std::string& what) { throw Fail(what); }

uint32_t le16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
uint32_t le24(const uint8_t* p) { return le16(p) | uint32_t(p[2]) << 16; }
uint32_t le32(const uint8_t* p) { return le24(p) | uint32_t(p[3]) << 24; }
bool tag(const uint8_t* p, const char* t) { return std::memcmp(p, t, 4) == 0; }

constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;  // MAX_CHUNK_PAYLOAD
constexpr uint64_t kMaxImageArea = uint64_t(1) << 32;
// PIL's Image.open refuses an image of more pixels than twice
// Image.MAX_IMAGE_PIXELS (a DecompressionBombError), before it decodes
constexpr int64_t kMaxPixels = int64_t(2) * 89478485;
constexpr uint32_t kAlphaFlag = 0x10, kAnimationFlag = 0x02, kAllValidFlags = 0x3e;

// ------------------------------------------------------------ VP8L bits

// vp8l_dec / bit_reader_utils: 64-bit window, bytes shifted in as read;
// the end of stream is a read past the last byte's bits (a stream of fewer
// than 8 bytes reads zeros up to bit 64 first, as libwebp's does)
class LBits {
 public:
  LBits(const uint8_t* p, size_t n) : buf_(p), len_(n) {
    size_t k = std::min<size_t>(n, 8);
    for (size_t i = 0; i < k; ++i) val_ |= uint64_t(p[i]) << (8 * i);
    pos_ = k;
  }
  bool eos() const { return eos_ || (pos_ == len_ && bit_pos_ > 64); }
  bool eos_flag() const { return eos_; }
  void set_eos() {
    eos_ = true;
    bit_pos_ = 0;
  }
  void shift() {
    while (bit_pos_ >= 8 && pos_ < len_) {
      val_ >>= 8;
      val_ |= uint64_t(buf_[pos_]) << 56;
      ++pos_;
      bit_pos_ -= 8;
    }
    if (eos()) set_eos();
  }
  uint32_t prefetch() const { return uint32_t(val_ >> (bit_pos_ & 63)); }
  void advance(int n) { bit_pos_ += n; }
  void fill() {
    if (bit_pos_ >= 32) shift();
  }
  uint32_t read(int n) {
    if (!eos_ && n <= 24) {
      uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos_ += n;
      shift();
      return v;
    }
    set_eos();
    return 0;
  }

 private:
  const uint8_t* buf_;
  size_t len_, pos_ = 0;
  uint64_t val_ = 0;
  int bit_pos_ = 0;
  bool eos_ = false;
};

// ------------------------------------------------------ prefix codes

struct HCode {
  uint8_t bits;
  uint16_t value;
};
constexpr int kMaxCodeLength = 15;

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}
void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}
int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// huffman_utils.c:BuildHuffmanTable: a root table of root_bits and second
// level tables; returns the entries used, 0 for an invalid code (a length
// over 15, no symbol, an over-subscribed or incomplete tree); a null root
// only counts
int build_table(HCode* root, int root_bits, const int* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0}, offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return 0;
    ++count[lengths[s]];
  }
  if (count[0] == n) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(n);
  for (int s = 0; s < n; ++s)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = uint16_t(s);
  int total = 1 << root_bits;
  if (offset[kMaxCodeLength] == 1) {
    if (root) replicate(root, 1, total, HCode{0, sorted[0]});
    return total;
  }
  HCode* table = root;
  uint32_t low = 0xffffffffu, mask = uint32_t(total) - 1, key = 0;
  int num_nodes = 1, num_open = 1, table_bits = root_bits, table_size = 1 << table_bits, sym = 0;
  int len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    if (!root) continue;
    for (; count[len] > 0; --count[len]) {
      replicate(&table[key], step, table_size, HCode{uint8_t(len), sorted[sym++]});
      key = next_key(key, len);
    }
  }
  for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) return 0;
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        if (root) table += table_size;
        table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        total += table_size;
        low = key & mask;
        if (root) {
          root[low].bits = uint8_t(table_bits + root_bits);
          root[low].value = uint16_t((table - root) - low);
        }
      }
      if (root) replicate(&table[key >> root_bits], step, table_size, HCode{uint8_t(len - root_bits), sorted[sym++]});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
  return total;
}

// a built table: empty when the code was invalid
std::vector<HCode> make_table(int root_bits, const int* lengths, int n) {
  int size = build_table(nullptr, root_bits, lengths, n);
  std::vector<HCode> t;
  if (size == 0) return t;
  t.resize(size);
  if (build_table(t.data(), root_bits, lengths, n) != size) t.clear();
  return t;
}

constexpr int kTableBits = 8;  // HUFFMAN_TABLE_BITS

int read_symbol(const HCode* table, LBits& br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kTableBits) - 1);
  int nbits = table->bits - kTableBits;
  if (nbits > 0) {
    br.advance(kTableBits);
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.advance(table->bits);
  return table->value;
}

// ------------------------------------------------------------- VP8L

enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
constexpr int kLiterals = 256, kLengthCodes = 24, kDistanceCodes = 40, kCodeLengthCodes = 19;
constexpr int kAlphabetSize[5] = {kLiterals + kLengthCodes, kLiterals, kLiterals, kLiterals, kDistanceCodes};
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Group {
  std::vector<HCode> trees[5];
  bool trivial_literal = false, trivial_code = false;
  uint32_t literal_arb = 0;
};

struct Meta {
  int cache_bits = 0;
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  std::vector<Group> groups;
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int d = sub3(a >> 24, b >> 24, c >> 24) + sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) + sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}
uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 24; s >= 0; s -= 8) {
    int v = int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) - int((c2 >> s) & 0xff);
    out |= clip255(uint32_t(v)) << s;
  }
  return out;
}
uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t ave = average2(c0, c1), out = 0;
  for (int s = 24; s >= 0; s -= 8) {
    int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
    out |= clip255(uint32_t(a + (a - b) / 2)) << s;
  }
  return out;
}

// lossless.c's predictors 0-13 (14 and 15 are 0); top points at the pixel
// above, top[1] is above-right (the current row's first pixel at the end)
uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return add_sub_full(left, top[0], top[-1]);
    case 13: return add_sub_half(left, top[0], top[-1]);
    default: return 0xff000000u;
  }
}

int delta(int8_t pred, int8_t color) { return (int(pred) * color) >> 5; }

class VP8L {
 public:
  VP8L(const uint8_t* p, size_t n) : br_(p, n) {}

  // the VP8L header (signature, size, alpha bit, version)
  void header(int* w, int* h, int* alpha) {
    if (br_.read(8) != 0x2f) fail("VP8L: bad signature (not 0x2f)");
    *w = int(br_.read(14)) + 1;
    *h = int(br_.read(14)) + 1;
    *alpha = int(br_.read(1));
    if (br_.read(3) != 0) fail("VP8L: unknown version (not 0)");
    if (br_.eos_flag()) fail("VP8L: truncated header");
  }

  // the ARGB image of w x h (after the header, or an ALPH chunk's stream);
  // alpha_stream: libwebp's 8-bit alpha path is taken where it applies,
  // which accepts a stream that ends inside its last symbol
  std::vector<uint32_t> image(int w, int h, bool alpha_stream) {
    int xsize = w;
    while (br_.read(1)) read_transform(&xsize, h);
    Meta meta;
    read_meta(&meta, xsize, h, true);
    bool paletted_alpha = alpha_stream && ntransforms_ == 1 && transforms_[0].type == COLOR_INDEXING &&
                          meta.cache_bits == 0;
    if (paletted_alpha) {
      for (const Group& g : meta.groups)
        if (g.trees[RED][0].bits > 0 || g.trees[BLUE][0].bits > 0 || g.trees[ALPHA][0].bits > 0)
          paletted_alpha = false;
    }
    std::vector<uint32_t> data(size_t(xsize) * h);
    decode_data(data.data(), xsize, h, meta, paletted_alpha);
    for (int n = ntransforms_ - 1; n >= 0; --n) data = inverse(transforms_[n], data);
    return data;
  }

 private:
  void read_transform(int* xsize, int ysize) {
    int type = int(br_.read(2));
    if (seen_ & (1u << type)) fail("VP8L: a transform appears twice");
    seen_ |= 1u << type;
    Transform& t = transforms_[ntransforms_++];
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    if (type == PREDICTOR || type == CROSS_COLOR) {
      t.bits = 2 + int(br_.read(3));
      t.data = sub_image(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits));
    } else if (type == COLOR_INDEXING) {
      int colors = int(br_.read(8)) + 1;
      t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> map = sub_image(colors, 1);
      // ExpandColorMap: deltas summed per byte, then a black tail
      int final_colors = 1 << (8 >> t.bits);
      std::vector<uint32_t> full(final_colors, 0);
      full[0] = map[0];
      for (int i = 1; i < colors; ++i) full[i] = add_pixels(map[i], full[i - 1]);
      t.data = std::move(full);
    }
  }

  std::vector<uint32_t> sub_image(int w, int h) {
    Meta meta;
    read_meta(&meta, w, h, false);
    std::vector<uint32_t> data(size_t(w) * h);
    decode_data(data.data(), w, h, meta, false);
    if (br_.eos_flag()) fail("VP8L: truncated data");
    return data;
  }

  void read_meta(Meta* meta, int xsize, int ysize, bool level0) {
    if (br_.read(1)) {
      meta->cache_bits = int(br_.read(4));
      if (meta->cache_bits < 1 || meta->cache_bits > 11) fail("VP8L: invalid colour cache size");
    }
    int groups = 1;
    if (level0 && br_.read(1)) {
      int bits = 2 + int(br_.read(3));
      int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
      meta->huffman_image = sub_image(hx, hy);
      meta->huffman_bits = bits;
      meta->huffman_xsize = hx;
      for (uint32_t& v : meta->huffman_image) {
        v = (v >> 8) & 0xffff;
        groups = std::max<int>(groups, int(v) + 1);
      }
    }
    if (br_.eos_flag()) fail("VP8L: truncated data");
    // groups the meta image never names are read and checked, then dropped
    // (libwebp's mapping), so that a large index costs no memory
    std::vector<int> slot(groups, -1);
    int used = 0;
    if (meta->huffman_bits == 0) {
      slot[0] = used++;
    } else {
      for (uint32_t& v : meta->huffman_image) {
        if (slot[v] < 0) slot[v] = used++;
        v = uint32_t(slot[v]);
      }
    }
    meta->groups.resize(used);
    std::vector<int> lengths(kAlphabetSize[0] + (meta->cache_bits ? 1 << meta->cache_bits : 0));
    for (int i = 0; i < groups; ++i) {
      Group dropped;
      Group& g = slot[i] < 0 ? dropped : meta->groups[slot[i]];
      int total_bits = 0;
      g.trivial_literal = true;
      for (int j = 0; j < 5; ++j) {
        int size = kAlphabetSize[j] + (j == 0 && meta->cache_bits ? 1 << meta->cache_bits : 0);
        g.trees[j] = read_code(size, lengths.data());
        if (j == RED || j == BLUE || j == ALPHA) g.trivial_literal = g.trivial_literal && g.trees[j][0].bits == 0;
        total_bits += g.trees[j][0].bits;
      }
      if (g.trivial_literal) {
        g.literal_arb = uint32_t(g.trees[ALPHA][0].value) << 24 | uint32_t(g.trees[RED][0].value) << 16 |
                        g.trees[BLUE][0].value;
        if (total_bits == 0 && g.trees[GREEN][0].value < kLiterals) {
          g.trivial_code = true;
          g.literal_arb |= uint32_t(g.trees[GREEN][0].value) << 8;
        }
      }
    }
  }

  std::vector<HCode> read_code(int alphabet, int* lengths) {
    std::fill(lengths, lengths + alphabet, 0);
    if (br_.read(1)) {  // simple code: one or two symbols of length 1
      int n = int(br_.read(1)) + 1;
      int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (n == 2) lengths[br_.read(8)] = 1;
    } else {
      int cl_lengths[kCodeLengthCodes] = {0};
      int ncodes = int(br_.read(4)) + 4;
      for (int i = 0; i < ncodes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = int(br_.read(3));
      read_code_lengths(cl_lengths, alphabet, lengths);
    }
    std::vector<HCode> t;
    if (!br_.eos_flag()) t = make_table(kTableBits, lengths, alphabet);
    if (t.empty()) fail("VP8L: invalid prefix code");
    return t;
  }

  void read_code_lengths(const int* cl_lengths, int alphabet, int* lengths) {
    constexpr int kBits = 7;  // LENGTHS_TABLE_BITS
    std::vector<HCode> table = make_table(kBits, cl_lengths, kCodeLengthCodes);
    if (table.empty()) fail("VP8L: invalid code-length code");
    int max_symbol = alphabet;
    if (br_.read(1)) {
      int nbits = 2 + 2 * int(br_.read(3));
      max_symbol = 2 + int(br_.read(nbits));
      if (max_symbol > alphabet) fail("VP8L: invalid code-length count");
    }
    int prev = 8, symbol = 0;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      br_.fill();
      const HCode& p = table[br_.prefetch() & ((1u << kBits) - 1)];
      br_.advance(p.bits);
      int len = p.value;
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int slot = len - 16;
        int repeat = int(br_.read(kExtra[slot])) + kOffset[slot];
        if (symbol + repeat > alphabet) fail("VP8L: code lengths past the alphabet");
        int v = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = v;
      }
    }
  }

  int copy_distance(int symbol) {
    if (symbol < 4) return symbol + 1;
    int extra = (symbol - 2) >> 1;
    int offset = (2 + (symbol & 1)) << extra;
    return offset + int(br_.read(extra)) + 1;
  }

  static int plane_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    int dc = kCodeToPlane[code - 1];
    int dist = (dc >> 4) * xsize + (8 - (dc & 0xf));
    return dist >= 1 ? dist : 1;
  }

  // vp8l_dec.c:DecodeImageData (and DecodeAlphaData where paletted_alpha)
  void decode_data(uint32_t* data, int width, int height, const Meta& meta, bool paletted_alpha) {
    const int64_t end = int64_t(width) * height;
    const int cache_size = meta.cache_bits ? 1 << meta.cache_bits : 0;
    std::vector<uint32_t> cache(cache_size, 0);
    const int cache_shift = 32 - meta.cache_bits;
    int64_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto insert_upto = [&](int64_t upto) {
      for (; cached < upto; ++cached) cache[(0x1e35a7bdu * data[cached]) >> cache_shift] = data[cached];
    };
    auto group_at = [&](int x, int y) -> const Group& {
      if (meta.huffman_bits == 0) return meta.groups[0];
      return meta.groups[meta.huffman_image[size_t(meta.huffman_xsize) * (y >> meta.huffman_bits) +
                                            (x >> meta.huffman_bits)]];
    };
    bool eos_break = false;
    while (pos < end) {
      const Group& g = group_at(col, row);
      int code;
      if (g.trivial_code) {
        data[pos] = g.literal_arb;
        code = -1;
      } else {
        br_.fill();
        code = read_symbol(g.trees[GREEN].data(), br_);
        if (!paletted_alpha && br_.eos()) {
          eos_break = true;
          break;
        }
      }
      if (code < kLiterals) {
        if (code >= 0) {
          if (g.trivial_literal) {
            data[pos] = g.literal_arb | uint32_t(code) << 8;
          } else {
            int red = read_symbol(g.trees[RED].data(), br_);
            br_.fill();
            int blue = read_symbol(g.trees[BLUE].data(), br_);
            int alpha = read_symbol(g.trees[ALPHA].data(), br_);
            if (br_.eos()) {
              eos_break = true;
              break;
            }
            data[pos] = uint32_t(alpha) << 24 | uint32_t(red) << 16 | uint32_t(code) << 8 | uint32_t(blue);
          }
        }
        ++pos;
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else if (code < kLiterals + kLengthCodes) {
        int length = copy_distance(code - kLiterals);
        int dist_symbol = read_symbol(g.trees[DIST].data(), br_);
        br_.fill();
        int dist = plane_distance(width, copy_distance(dist_symbol));
        if (!paletted_alpha && br_.eos()) {
          eos_break = true;
          break;
        }
        if (pos < dist || end - pos < length) fail("VP8L: a backward reference outside the image");
        for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
        pos += length;
        col += length;
        while (col >= width) {
          col -= width;
          ++row;
        }
      } else if (code < kLiterals + kLengthCodes + cache_size) {
        insert_upto(pos);
        data[pos] = cache[code - kLiterals - kLengthCodes];
        ++pos;
        if (++col >= width) {
          col = 0;
          ++row;
        }
      } else {
        fail("VP8L: invalid symbol");
      }
      if (cache_size) insert_upto(pos);
      if (paletted_alpha && br_.eos()) break;
    }
    if (eos_break || (br_.eos() && (!paletted_alpha || pos < end))) fail("VP8L: truncated data");
  }

  std::vector<uint32_t> inverse(const Transform& t, const std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    std::vector<uint32_t> out(size_t(w) * h);
    if (t.type == PREDICTOR) {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = &in[size_t(y) * w];
        uint32_t* dst = &out[size_t(y) * w];
        if (y == 0) {
          dst[0] = add_pixels(src[0], 0xff000000u);
          for (int x = 1; x < w; ++x) dst[x] = add_pixels(src[x], dst[x - 1]);
          continue;
        }
        const uint32_t* top = dst - w;
        dst[0] = add_pixels(src[0], top[0]);
        const uint32_t* modes = &t.data[size_t(y >> t.bits) * tiles];
        for (int x = 1; x < w; ++x) {
          int mode = (modes[x >> t.bits] >> 8) & 0xf;
          dst[x] = add_pixels(src[x], predict(mode, dst[x - 1], top + x));
        }
      }
    } else if (t.type == CROSS_COLOR) {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          uint32_t code = t.data[size_t(y >> t.bits) * tiles + (x >> t.bits)];
          int8_t g2r = int8_t(code & 0xff), g2b = int8_t((code >> 8) & 0xff), r2b = int8_t((code >> 16) & 0xff);
          uint32_t argb = in[size_t(y) * w + x];
          int8_t green = int8_t(argb >> 8);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + delta(g2r, green)) & 0xff;
          blue = (blue + delta(g2b, green) + delta(r2b, int8_t(red))) & 0xff;
          out[size_t(y) * w + x] = (argb & 0xff00ff00u) | uint32_t(red) << 16 | uint32_t(blue);
        }
      }
    } else if (t.type == SUBTRACT_GREEN) {
      for (size_t i = 0; i < out.size(); ++i) {
        uint32_t argb = in[i], g = (argb >> 8) & 0xff;
        uint32_t rb = ((argb & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
        out[i] = (argb & 0xff00ff00u) | rb;
      }
    } else {  // colour indexing
      const int per_byte_bits = 8 >> t.bits, bw = subsample(w, t.bits);
      const uint32_t mask = (1u << per_byte_bits) - 1;
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = &in[size_t(y) * bw];
        for (int x = 0; x < w; ++x) {
          uint32_t packed = (src[x >> t.bits] >> 8) & 0xff;
          uint32_t idx = (packed >> (per_byte_bits * (x & ((1 << t.bits) - 1)))) & mask;
          out[size_t(y) * w + x] = t.data[idx];
        }
      }
    }
    return out;
  }

  LBits br_;
  Transform transforms_[4];
  int ntransforms_ = 0;
  uint32_t seen_ = 0;
};

// ------------------------------------------------------------ VP8 bits

// bit_reader_utils / bit_reader_inl_utils.h, one byte at a time (the
// arithmetic is the same at any load width); range_ holds range - 1
class Bool {
 public:
  Bool() = default;
  Bool(const uint8_t* p, size_t n) : buf_(p), end_(p + n) { load(); }
  bool eof() const { return eof_; }
  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * uint32_t(prob)) >> 8;
    const uint32_t value = uint32_t(value_ >> pos);
    int bit = value > split;
    if (bit) {
      range -= split;
      value_ -= uint64_t(split + 1) << pos;
    } else {
      range = split + 1;
    }
    int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  // VP8GetSigned: a sign bit at probability 1/2 (libwebp's shortcut,
  // which may leave range_ at 255)
  int sign(int v) {
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = uint32_t(value_ >> pos);
    const int32_t mask = int32_t(split - value) >> 31;
    bits_ -= 1;
    range_ += uint32_t(mask);
    range_ |= 1;
    value_ -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t value(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= uint32_t(bit(0x80)) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    int v = int(value(nbits));
    return bit(0x80) ? -v : v;
  }

 private:
  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = uint64_t(*buf_++) | (value_ << 8);
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 255 - 1;
  int bits_ = -8;
  bool eof_ = false;
};

// ------------------------------------------------------------- VP8 DSP

constexpr int BPS = 32;  // the work buffer's stride (libwebp's)
inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // VP8ksclip2
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// dec.c:TransformOne_C (the DC and AC3 forms libwebp picks by the
// non-zero pattern compute the same)
void transform(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// dec.c:TransformWHT_C, the DCs into each block's coefficient 0
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y, dst += BPS) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
  }
}

enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU, DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT };

void pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = dst[-1 - BPS], I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, int(dc), 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE: {
      const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(X, I, J);
      DST(1, 2) = DST(3, 3) = avg3(I, J, K);
      DST(1, 3) = avg3(J, K, L);
      break;
  }
}
#undef DST

// the 16x16 luma (size 16) and 8x8 chroma (size 8) predictors
void pred_block(int mode, uint8_t* dst, int size) {
  const int lg = size == 16 ? 4 : 3;
  auto put = [&](int v) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
  };
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      put(dc >> (lg + 1));
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      put(dc >> lg);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      put(dc >> lg);
      break;
    }
    case DC_NOTOPLEFT: put(0x80); break;
    case B_TM: true_motion(dst, size); break;
    case B_VE:
      for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case B_HE:
      for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

// the loop filters (dec.c), p at the edge's first pixel on the q side
inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}
inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
inline int hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}
inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) {
      filter2(p, hstride);
    } else if (edge) {
      filter6(p, hstride);
    } else {
      filter4(p, hstride);
    }
  }
}

// ------------------------------------------------------------- VP8 frame

constexpr int Y_OFF = BPS * 1 + 8, U_OFF = Y_OFF + BPS * 16 + BPS, V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

struct Planes {
  int w = 0, h = 0;        // the picture
  int yw = 0, yh = 0;      // the macroblock-aligned frame
  std::vector<uint8_t> y, u, v;
};

class VP8 {
 public:
  // buf: from the frame tag to the end of the chunk's data (its padding
  // byte too, as libwebp reads it)
  VP8(const uint8_t* buf, size_t n) : buf_(buf), n_(n) {}

  Planes decode() {
    headers();
    Planes out;
    out.w = width_;
    out.h = height_;
    out.yw = mb_w_ * 16;
    out.yh = mb_h_ * 16;
    out.y.assign(size_t(out.yw) * out.yh, 0);
    out.u.assign(size_t(out.yw / 2) * (out.yh / 2), 0);
    out.v.assign(out.u.size(), 0);
    frame(out);
    return out;
  }

 private:
  struct MBInfo {
    uint8_t nz = 0, nz_dc = 0;
  };
  struct MBData {
    int16_t coeffs[384];
    uint8_t is_i4x4 = 0, imodes[16] = {}, uvmode = 0, segment = 0, skip = 0;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
  };
  struct FInfo {
    int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
  };

  void headers() {
    const uint8_t* buf = buf_;
    size_t size = n_;
    if (size < 4) fail("VP8: truncated header");
    const uint32_t bits = le24(buf);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t part0 = bits >> 5;
    if (profile > 3) fail("VP8: incorrect keyframe parameters (profile > 3)");
    if (!show) fail("VP8: frame not displayable (show_frame 0)");
    buf += 3;
    size -= 3;
    if (!key_frame) fail("VP8: not a key frame");
    if (size < 7) fail("VP8: truncated picture header");
    if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a)) fail("VP8: bad start code");
    width_ = int(le16(buf + 3) & 0x3fff);
    height_ = int(le16(buf + 5) & 0x3fff);
    buf += 7;
    size -= 7;
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    if (part0 > size) fail("VP8: bad partition length (partition 0 past the data)");
    br_ = Bool(buf, part0);
    buf += part0;
    size -= part0;
    br_.value(1);  // colour space
    br_.value(1);  // clamping type
    // segment header
    use_segment_ = br_.value(1);
    if (use_segment_) {
      update_map_ = br_.value(1);
      if (br_.value(1)) {
        absolute_delta_ = br_.value(1);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.value(1) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.value(1) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s) segment_proba_[s] = br_.value(1) ? uint8_t(br_.value(8)) : 255;
    } else {
      update_map_ = 0;
    }
    if (br_.eof()) fail("VP8: cannot parse segment header");
    // filter header
    simple_ = br_.value(1);
    level_ = int(br_.value(6));
    sharpness_ = int(br_.value(3));
    use_lf_delta_ = br_.value(1);
    if (use_lf_delta_ && br_.value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) ref_lf_delta_[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) mode_lf_delta_[i] = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof()) fail("VP8: cannot parse filter header");
    // token partitions
    num_parts_ = 1 << br_.value(2);
    const size_t last = size_t(num_parts_ - 1);
    if (size < 3 * last) fail("VP8: cannot parse partitions (truncated sizes)");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = le24(sz);
      if (psize > left) psize = left;
      parts_[p] = Bool(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last] = Bool(start, left);
    if (left == 0) fail("VP8: cannot parse partitions (the last token partition is empty)");
    // quantizers
    const int base_q0 = int(br_.value(7));
    const int dqy1_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.value(1) ? br_.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br_.value(1);  // update_proba, ignored on a key frame
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] =
                br_.bit(CoeffsUpdateProba[t][b][c][p]) ? uint8_t(br_.value(8)) : CoeffsProba0[t][b][c][p];
    use_skip_ = br_.value(1);
    if (use_skip_) skip_p_ = int(br_.value(8));
    // frame_dec.c:PrecomputeFilterStrengths
    if (filter_type_ > 0) {
      for (int s = 0; s < 4; ++s) {
        int base = use_segment_ ? filter_strength_[s] + (absolute_delta_ ? 0 : level_) : level_;
        for (int i4 = 0; i4 <= 1; ++i4) {
          FInfo& f = fstrengths_[s][i4];
          int level = base;
          if (use_lf_delta_) {
            level += ref_lf_delta_[0];
            if (i4) level += mode_lf_delta_[0];
          }
          level = level < 0 ? 0 : level > 63 ? 63 : level;
          if (level > 0) {
            int ilevel = level;
            if (sharpness_ > 0) {
              ilevel >>= sharpness_ > 4 ? 2 : 1;
              if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
            }
            if (ilevel < 1) ilevel = 1;
            f.ilevel = ilevel;
            f.limit = 2 * level + ilevel;
            f.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
          } else {
            f.limit = 0;
          }
          f.inner = i4;
        }
      }
    }
  }

  void parse_intra_mode(MBData& b, uint8_t* top, uint8_t* left) {
    if (update_map_) {
      b.segment = !br_.bit(segment_proba_[0]) ? uint8_t(br_.bit(segment_proba_[1]))
                                              : uint8_t(br_.bit(segment_proba_[2]) + 2);
    } else {
      b.segment = 0;
    }
    if (use_skip_) b.skip = uint8_t(br_.bit(skip_p_));
    b.is_i4x4 = !br_.bit(kYModeProbaKeyframe[0]);
    if (!b.is_i4x4) {
      const int ymode = br_.bit(kYModeProbaKeyframe[1]) ? (br_.bit(kYModeProbaKeyframe[3]) ? B_TM : B_HE)
                                                        : (br_.bit(kYModeProbaKeyframe[2]) ? B_VE : B_DC);
      b.imodes[0] = uint8_t(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = uint8_t(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = uint8_t(ymode);
      }
    }
    b.uvmode = !br_.bit(kUVModeProbaKeyframe[0])   ? B_DC
               : !br_.bit(kUVModeProbaKeyframe[1]) ? B_VE
               : br_.bit(kUVModeProbaKeyframe[2])  ? B_TM
                                                   : B_HE;
  }

  int large_value(Bool& br, const uint8_t* p) {
    static const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // vp8_dec.c:GetCoeffsFast: the index past the last non-zero coefficient
  int coeffs(Bool& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const int band_next = kBands[n + 1];
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = proba_[type][band_next][1];
      } else {
        v = large_value(br, p);
        p = proba_[type][band_next][2];
      }
      out[kZigzag[n]] = int16_t(br.sign(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // vp8_dec.c:ParseResiduals; returns whether the macroblock has no
  // non-zero coefficient
  int residuals(Bool& br, MBData& b, MBInfo& mb, MBInfo& left) {
    const Quant& q = dqm_[b.segment];
    int16_t* dst = b.coeffs;
    std::memset(dst, 0, sizeof(b.coeffs));
    int first, ac_type;
    if (!b.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left.nz_dc;
      const int nz = coeffs(br, 1, ctx, q.y2, 0, dc);
      mb.nz_dc = left.nz_dc = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nzc = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = uint8_t((tnz >> 1) | (l << 7));
        nzc = nz_code_bits(nzc, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = uint8_t((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nzc;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nzc = 0;
      tnz = uint8_t(mb.nz >> (4 + ch));
      lnz = uint8_t(left.nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = uint8_t((tnz >> 1) | (l << 3));
          nzc = nz_code_bits(nzc, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = uint8_t((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nzc << (4 * ch);
      out_t_nz |= uint32_t(tnz << 4) << ch;
      out_l_nz |= uint32_t(lnz & 0xf0) << ch;
    }
    mb.nz = uint8_t(out_t_nz);
    left.nz = uint8_t(out_l_nz);
    b.non_zero_y = non_zero_y;
    b.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC) {
      if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mb_y == 0 ? DC_NOTOP : B_DC;
    }
    return mode;
  }

  void frame(Planes& out) {
    std::vector<MBInfo> info(size_t(mb_w_) + 1);  // [0]: the left neighbour
    std::vector<MBData> data(mb_w_);
    std::vector<uint8_t> intra_t(size_t(4) * mb_w_, B_DC);
    std::vector<FInfo> finfo(size_t(mb_w_) * mb_h_);
    struct Top {
      uint8_t y[16], u[8], v[8];
    };
    std::vector<Top> yuv_t(mb_w_);
    uint8_t yuv_b[YUV_SIZE] = {0};
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;
    const int ys = out.yw, uvs = out.yw / 2;

    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      uint8_t intra_l[4];
      std::memset(intra_l, B_DC, 4);
      info[0] = MBInfo();
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(data[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br_.eof()) fail("VP8: premature end of partition 0");
      Bool& tokens = parts_[mb_y & (num_parts_ - 1)];
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MBData& b = data[mb_x];
        MBInfo& mb = info[1 + mb_x];
        MBInfo& left = info[0];
        int skip = use_skip_ ? b.skip : 0;
        if (!skip) {
          skip = residuals(tokens, b, mb, left);
        } else {
          left.nz = mb.nz = 0;
          if (!b.is_i4x4) left.nz_dc = mb.nz_dc = 0;
          b.non_zero_y = 0;
          b.non_zero_uv = 0;
        }
        if (filter_type_ > 0) {
          FInfo f = fstrengths_[b.segment][b.is_i4x4];
          f.inner |= !skip;
          finfo[size_t(mb_y) * mb_w_ + mb_x] = f;
        }
        if (tokens.eof()) fail("VP8: premature end of a token partition");
      }
      // frame_dec.c:ReconstructRow
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const MBData& b = data[mb_x];
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
          for (int j = -1; j < 8; ++j) {
            std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
            std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
          }
        }
        Top& top = yuv_t[mb_x];
        uint32_t bits = b.non_zero_y;
        if (mb_y > 0) {
          std::memcpy(y_dst - BPS, top.y, 16);
          std::memcpy(u_dst - BPS, top.u, 8);
          std::memcpy(v_dst - BPS, top.v, 8);
        }
        if (b.is_i4x4) {
          uint8_t* top_right = y_dst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w_ - 1) {
              std::memset(top_right, top.y[15], 4);
            } else {
              std::memcpy(top_right, yuv_t[mb_x + 1].y, 4);
            }
          }
          for (int k = 1; k <= 3; ++k) std::memcpy(top_right + k * 4 * BPS, top_right, 4);
          for (int n = 0; n < 16; ++n, bits <<= 2) {
            uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            pred4(b.imodes[n], dst);
            if (bits >> 30) transform(b.coeffs + n * 16, dst);
          }
        } else {
          pred_block(check_mode(mb_x, mb_y, b.imodes[0]), y_dst, 16);
          for (int n = 0; n < 16; ++n, bits <<= 2)
            if (bits >> 30) transform(b.coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
        pred_block(uvmode, u_dst, 8);
        pred_block(uvmode, v_dst, 8);
        for (int c = 0; c < 2; ++c) {
          const uint32_t uvbits = b.non_zero_uv >> (8 * c);
          uint8_t* dst = c ? v_dst : u_dst;
          if (!(uvbits & 0xff)) continue;
          for (int n = 0; n < 4; ++n)
            transform(b.coeffs + (16 + 4 * c + n) * 16, dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
        }
        if (mb_y < mb_h_ - 1) {
          std::memcpy(top.y, y_dst + 15 * BPS, 16);
          std::memcpy(top.u, u_dst + 7 * BPS, 8);
          std::memcpy(top.v, v_dst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j)
          std::memcpy(&out.y[size_t(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
          std::memcpy(&out.u[size_t(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
          std::memcpy(&out.v[size_t(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
        }
      }
    }
    if (filter_type_ == 0) return;
    // frame_dec.c:DoFilter, macroblock by macroblock in raster order
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FInfo& f = finfo[size_t(mb_y) * mb_w_ + mb_x];
        if (f.limit == 0) continue;
        uint8_t* yp = &out.y[size_t(mb_y * 16) * ys + mb_x * 16];
        const int limit = f.limit;
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_filter(yp, 1, ys, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yp + 4 * k, 1, ys, limit);
          if (mb_y > 0) simple_filter(yp, ys, 1, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(yp + 4 * k * ys, ys, 1, limit);
          continue;
        }
        uint8_t* up = &out.u[size_t(mb_y * 8) * uvs + mb_x * 8];
        uint8_t* vp = &out.v[size_t(mb_y * 8) * uvs + mb_x * 8];
        const int il = f.ilevel, hv = f.hev_thresh;
        if (mb_x > 0) {
          filter_loop(yp, 1, ys, 16, limit + 4, il, hv, true);
          filter_loop(up, 1, uvs, 8, limit + 4, il, hv, true);
          filter_loop(vp, 1, uvs, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop(yp + 4 * k, 1, ys, 16, limit, il, hv, false);
          filter_loop(up + 4, 1, uvs, 8, limit, il, hv, false);
          filter_loop(vp + 4, 1, uvs, 8, limit, il, hv, false);
        }
        if (mb_y > 0) {
          filter_loop(yp, ys, 1, 16, limit + 4, il, hv, true);
          filter_loop(up, uvs, 1, 8, limit + 4, il, hv, true);
          filter_loop(vp, uvs, 1, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) filter_loop(yp + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
          filter_loop(up + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
          filter_loop(vp + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
        }
      }
    }
  }

  struct Quant {
    int y1[2] = {0, 0}, y2[2] = {0, 0}, uv[2] = {0, 0};
  };

  const uint8_t* buf_;
  size_t n_;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  Bool br_, parts_[8];
  int num_parts_ = 1;
  int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  Quant dqm_[4];
  uint8_t proba_[4][8][3][11];
  int use_skip_ = 0, skip_p_ = 0;
  FInfo fstrengths_[4][2];
};

// ------------------------------------------------------------- output

// yuv.h: 14-bit fixed point, MultHi emulating _mm_mulhi_epu16
inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t yuv_clip8(int v) { return uint8_t((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 0xff;
}

// upsampling.c's UPSAMPLE_FUNC: one or two output rows from two chroma
// rows, u and v packed in one word as libwebp computes them
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](uint8_t u, uint8_t v) { return uint32_t(u) | uint32_t(v) << 16; };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]), l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgba(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgba(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]), uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1, uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgba(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 4);
      yuv_to_rgba(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1, uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgba(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgba(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgba(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 4);
    }
  }
}

// io_dec.c:EmitFancyRGB over the whole picture: row 0 from chroma row 0
// alone, then rows (2k-1, 2k) from chroma rows k-1 and k, and the last row
// of an even height from the last chroma row alone
void emit_fancy(const Planes& p, uint8_t* dst, size_t stride) {
  const int w = p.w, h = p.h, ys = p.yw, uvs = p.yw / 2;
  auto Y = [&](int r) { return &p.y[size_t(r) * ys]; };
  auto U = [&](int r) { return &p.u[size_t(r) * uvs]; };
  auto V = [&](int r) { return &p.v[size_t(r) * uvs]; };
  upsample_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), dst, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const int k = y / 2;
    upsample_pair(Y(y + 1), Y(y + 2), U(k), V(k), U(k + 1), V(k + 1), dst + (y + 1) * stride,
                  dst + (y + 2) * stride, w);
  }
  if (!(h & 1)) {
    const int k = (h - 1) / 2;
    upsample_pair(Y(h - 1), nullptr, U(k), V(k), U(k), V(k), dst + (h - 1) * stride, nullptr, w);
  }
}

// filters.c: the unfilters of an alpha row (0 none, 1 horizontal, 2
// vertical, 3 gradient); the first row (no prev) is unfiltered horizontally
// from 0 whatever the filter
void unfilter(int filter, const uint8_t* prev, const uint8_t* in, uint8_t* out, int width) {
  if (filter == 0) {
    if (in != out) std::memcpy(out, in, width);
  } else if (filter == 1 || prev == nullptr) {
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = uint8_t(pred + in[i]);
      pred = out[i];
    }
  } else if (filter == 2) {
    for (int i = 0; i < width; ++i) out[i] = uint8_t(prev[i] + in[i]);
  } else {
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
      left = uint8_t(in[i] + pred);
      top_left = top;
      out[i] = left;
    }
  }
}

// alpha_dec.c: the ALPH chunk's w x h plane
std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t size, int w, int h) {
  if (size <= 1) fail("ALPH: chunk too short");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) fail("ALPH: invalid header (compression method, pre-processing or reserved bits)");
  std::vector<uint8_t> plane(size_t(w) * h);
  if (method == 0) {
    if (size - 1 < size_t(w) * h) fail("ALPH: uncompressed alpha shorter than the image");
    for (int y = 0; y < h; ++y)
      unfilter(filter, y ? &plane[size_t(y - 1) * w] : nullptr, data + 1 + size_t(y) * w, &plane[size_t(y) * w], w);
    return plane;
  }
  VP8L dec(data + 1, size - 1);
  std::vector<uint32_t> argb = dec.image(w, h, true);
  for (size_t i = 0; i < plane.size(); ++i) plane[i] = uint8_t(argb[i] >> 8);
  for (int y = 0; y < h; ++y) {
    uint8_t* row = &plane[size_t(y) * w];
    unfilter(filter, y ? row - w : nullptr, row, row, w);
  }
  return plane;
}

// ------------------------------------------------------------ container

struct Frame {
  int num = 0, x = 0, y = 0, w = 0, h = 0;
  bool complete = false;
  size_t alpha_off = 0, alpha_size = 0, image_off = 0, image_size = 0;
};

struct Image {
  int canvas_w = 0, canvas_h = 0;
  std::vector<Frame> frames;
};

// webp_dec.c:GetFeatures (VP8GetInfo, VP8LGetInfo) on a VP8/VP8L chunk:
// its size and alpha bit; returns why libwebp refuses the header, or null
const char* chunk_features(const uint8_t* p, size_t n, int* w, int* h, bool* alpha) {
  if (n < 8) return "WebP: truncated image chunk";
  const uint32_t size = le32(p + 4);
  const uint8_t* d = p + 8;
  const size_t avail = n - 8;
  if (tag(p, "VP8L")) {
    if (avail < 5) return "VP8L: truncated header";
    if (d[0] != 0x2f) return "VP8L: bad signature (not 0x2f)";
    if ((d[4] >> 5) != 0) return "VP8L: unknown version (not 0)";
    LBits br(d, avail);
    br.read(8);
    *w = int(br.read(14)) + 1;
    *h = int(br.read(14)) + 1;
    *alpha = br.read(1);
    br.read(3);
    return br.eos_flag() ? "VP8L: truncated header" : nullptr;
  }
  if (avail < 10) return "VP8: truncated frame header";
  if (!(d[3] == 0x9d && d[4] == 0x01 && d[5] == 0x2a)) return "VP8: bad start code (not 9d 01 2a)";
  const uint32_t bits = le24(d);
  if (bits & 1) return "VP8: not a key frame";
  if (((bits >> 1) & 7) > 3) return "VP8: incorrect keyframe parameters (profile > 3)";
  if (!((bits >> 4) & 1)) return "VP8: frame not displayable (show_frame 0)";
  if ((bits >> 5) >= size) return "VP8: partition 0 is longer than the chunk";
  *w = int(le16(d + 6) & 0x3fff);
  *h = int(le16(d + 8) & 0x3fff);
  *alpha = false;
  return *w != 0 && *h != 0 ? nullptr : "VP8: a width or height of 0";
}

// demux.c: WebPDemux on a whole file, as WebPAnimDecoderNew runs it
class Demux {
 public:
  Demux(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  Image run() {
    if (n_ < 12 + 8) fail("WebP: file too short");
    if (!tag(d_, "RIFF") || !tag(d_ + 8, "WEBP")) fail("not a WebP file (no RIFF/WEBP header)");
    const uint32_t riff = le32(d_ + 4);
    if (riff < 8 || riff > kMaxChunkPayload) fail("WebP: invalid RIFF size");
    end_ = size_t(riff) + 8;
    if (n_ < end_) fail("WebP: truncated file (the RIFF size is past the end of the data)");
    pos_ = 12;
    if (tag(d_ + 12, "VP8 ") || tag(d_ + 12, "VP8L")) {
      single_image();
      if (!(img_.canvas_w > 0 && img_.canvas_h > 0) || img_.frames.empty()) fail("WebP: invalid image");
      const Frame& f = img_.frames[0];
      if (f.w <= 0 || f.h <= 0) fail("WebP: invalid image");
    } else if (tag(d_ + 12, "VP8X")) {
      vp8x();
      validate_extended();
    } else {
      fail("WebP: unknown first chunk");
    }
    return img_;
  }

 private:
  size_t left() const { return end_ - pos_; }
  bool size_invalid(size_t size) const { return size > end_ - pos_; }

  // StoreFrame: ALPH and VP8/VP8L chunks from pos_; returns whether the
  // chunks stopped at another chunk or the end
  void store_frame(int num, size_t min_size, Frame* f) {
    if (left() < 8 || left() < min_size) fail("WebP: truncated frame");
    int alpha_chunks = 0, image_chunks = 0;
    bool done = false;
    do {
      const size_t start = pos_;
      const uint8_t* c = d_ + pos_;
      const uint32_t payload = le32(c + 4);
      if (payload > kMaxChunkPayload) fail("WebP: invalid chunk size");
      const size_t padded = size_t(payload) + (payload & 1);
      pos_ += 8;
      if (size_invalid(padded)) fail("WebP: a chunk runs past the RIFF data (truncated chunk)");
      if (tag(c, "ALPH") && alpha_chunks == 0) {
        ++alpha_chunks;
        f->alpha_off = start;
        f->alpha_size = 8 + padded;
        f->num = num;
        pos_ += padded;
      } else if ((tag(c, "VP8L") || tag(c, "VP8 ")) && image_chunks == 0) {
        if (tag(c, "VP8L") && alpha_chunks > 0) fail("WebP: an ALPH chunk before a VP8L chunk");
        int w, h;
        bool alpha;
        if (const char* why = chunk_features(c, 8 + padded, &w, &h, &alpha)) fail(why);
        ++image_chunks;
        f->image_off = start;
        f->image_size = 8 + padded;
        f->w = w;
        f->h = h;
        f->num = num;
        f->complete = true;
        pos_ += padded;
      } else {
        pos_ -= 8;
        done = true;
      }
      if (pos_ == end_) {
        done = true;
      } else if (left() < 8) {
        fail("WebP: truncated chunk header");
      }
    } while (!done);
  }

  void single_image() {
    if (!img_.frames.empty()) fail("WebP: a second image chunk");
    if (size_invalid(8) || left() < 8) fail("WebP: truncated image chunk");
    Frame f;
    store_frame(1, 0, &f);
    if (!(flags_ & kAlphaFlag)) f.alpha_off = f.alpha_size = 0;  // ALPH without the VP8X flag is dropped
    if (!ext_ && f.w > 0 && f.h > 0) {
      img_.canvas_w = f.w;
      img_.canvas_h = f.h;
    }
    if (!img_.frames.empty() && !img_.frames.back().complete) fail("WebP: an incomplete frame");
    img_.frames.push_back(f);
  }

  void vp8x() {
    ext_ = true;
    const uint32_t size = le32(d_ + pos_ + 4);
    pos_ += 8;
    if (size > kMaxChunkPayload || size < 10) fail("WebP: invalid VP8X chunk size");
    const size_t padded = size_t(size) + (size & 1);
    if (size_invalid(padded)) fail("WebP: truncated VP8X chunk");
    flags_ = d_[pos_];
    img_.canvas_w = int(1 + le24(d_ + pos_ + 4));
    img_.canvas_h = int(1 + le24(d_ + pos_ + 7));
    if (uint64_t(img_.canvas_w) * uint64_t(img_.canvas_h) >= kMaxImageArea) fail("WebP: canvas too large");
    pos_ += padded;
    if (size_invalid(8) || left() < 8) fail("WebP: no chunk after VP8X");
    const bool animation = flags_ & kAnimationFlag;
    int anim_chunks = 0;
    for (;;) {
      const size_t start = pos_;
      const uint8_t* c = d_ + pos_;
      const uint32_t csize = le32(c + 4);
      if (csize > kMaxChunkPayload) fail("WebP: invalid chunk size");
      const size_t padded_c = size_t(csize) + (csize & 1);
      pos_ += 8;
      if (size_invalid(padded_c)) fail("WebP: a chunk runs past the RIFF data (truncated chunk)");
      if (tag(c, "VP8X")) {
        fail("WebP: a second VP8X chunk");
      } else if (tag(c, "ALPH") || tag(c, "VP8 ") || tag(c, "VP8L")) {
        if (anim_chunks > 0 || animation) fail("WebP: an image chunk outside ANMF in an animation");
        pos_ = start;
        single_image();
      } else if (tag(c, "ANIM")) {
        if (padded_c < 6) fail("WebP: invalid ANIM chunk");
        anim_chunks = 1;  // its background colour and loop count change no pixel of frame 1
        pos_ += padded_c;
      } else if (tag(c, "ANMF")) {
        if (anim_chunks == 0) fail("WebP: ANMF before ANIM");
        anmf(uint32_t(padded_c));
      } else {  // ICCP, EXIF, XMP and unknown chunks are skipped
        pos_ += padded_c;
      }
      if (pos_ == end_) break;
      if (left() < 8) fail("WebP: truncated chunk header");
    }
  }

  void anmf(uint32_t frame_chunk_size) {
    const bool animation = flags_ & kAnimationFlag;
    if (frame_chunk_size < 16) fail("WebP: invalid ANMF chunk");
    if (size_invalid(frame_chunk_size)) fail("WebP: truncated ANMF chunk");
    const uint32_t payload = frame_chunk_size - 16;
    const uint8_t* p = d_ + pos_;
    Frame f;
    f.x = int(2 * le24(p));
    f.y = int(2 * le24(p + 3));
    f.w = int(1 + le24(p + 6));
    f.h = int(1 + le24(p + 9));
    if (uint64_t(f.w) * uint64_t(f.h) >= kMaxImageArea) fail("WebP: frame too large");
    pos_ += 16;
    const size_t start = pos_;
    store_frame(int(img_.frames.size()) + 1, payload, &f);
    if (pos_ - start > payload) fail("WebP: an ANMF frame's chunks run past the frame");
    if (animation && f.num > 0) {
      if (!img_.frames.empty() && !img_.frames.back().complete) fail("WebP: an incomplete frame");
      img_.frames.push_back(f);
    }
  }

  void validate_extended() {
    const bool animation = flags_ & kAnimationFlag;
    if (img_.canvas_w <= 0 || img_.canvas_h <= 0) fail("WebP: invalid canvas");
    if (img_.frames.empty()) fail("WebP: no frame");
    if (flags_ & ~kAllValidFlags) fail("WebP: reserved VP8X flags set");
    for (const Frame& f : img_.frames) {
      if (!animation && f.num > 1) fail("WebP: several frames without the animation flag");
      if (!f.complete) fail("WebP: a frame without an image");
      if (f.alpha_size > 0 && f.alpha_off > f.image_off) fail("WebP: ALPH after the image chunk");
      if (f.w <= 0 || f.h <= 0) fail("WebP: invalid frame size");
      if (!animation) {
        if (f.x != 0 || f.y != 0 || f.w != img_.canvas_w || f.h != img_.canvas_h)
          fail("WebP: the image size is not the VP8X canvas size");
      } else if (f.x + f.w > img_.canvas_w || f.y + f.h > img_.canvas_h) {
        fail("WebP: a frame outside the canvas");
      }
    }
  }

  const uint8_t* d_;
  size_t n_, end_ = 0, pos_ = 0;
  uint32_t flags_ = 0;
  bool ext_ = false;
  Image img_;
};

// webp_dec.c:ParseHeadersInternal's alpha answer for the whole file, the
// mode PIL opens it in: the VP8X alpha flag (for an animation, alone),
// replaced by a VP8L header's alpha bit, or'ed with an ALPH chunk found
// before the image; a file libwebp's check fails is RGBA
bool pil_has_alpha(const uint8_t* d, size_t n) {
  size_t pos = 12;
  const uint32_t riff = le32(d + 4);
  bool alpha = false, vp8x = false;
  if (n < 20) return true;
  if (tag(d + pos, "VP8X")) {
    if (le32(d + pos + 4) != 10 || n < pos + 18) return true;
    const uint32_t flags = le32(d + pos + 8);
    alpha = flags & kAlphaFlag;
    if (flags & kAnimationFlag) return alpha;
    pos += 18;
    vp8x = true;
  }
  bool alph = false;
  if (vp8x) {
    uint64_t total = 4 + 8 + 10;
    for (;;) {
      if (n - pos < 8) return true;
      const uint32_t size = le32(d + pos + 4);
      if (size > kMaxChunkPayload) return true;
      const uint64_t disk = (uint64_t(8) + size + 1) & ~uint64_t(1);
      total += disk;
      if (riff > 0 && total > riff) return true;
      if (tag(d + pos, "VP8 ") || tag(d + pos, "VP8L")) break;
      if (n - pos < disk) return true;
      if (tag(d + pos, "ALPH")) alph = true;
      pos += size_t(disk);
    }
  }
  if (n - pos < 8 || !(tag(d + pos, "VP8 ") || tag(d + pos, "VP8L"))) return true;
  const uint32_t size = le32(d + pos + 4);
  if (riff >= 12 && size > riff - 12) return true;
  int w, h;
  bool a;
  if (chunk_features(d + pos, n - pos, &w, &h, &a)) return true;
  if (tag(d + pos, "VP8L")) alpha = a;
  return alpha || alph;
}

// WebPDecode of the first frame's ALPH..image chunks into the canvas
void decode_frame(const uint8_t* d, const Frame& f, uint8_t* canvas, int canvas_w) {
  const size_t start = f.alpha_size ? f.alpha_off : f.image_off;
  const uint8_t* frag = d + start;
  const size_t frag_size = f.image_off + f.image_size - start;
  const uint8_t* alpha = nullptr;
  size_t alpha_size = 0;
  size_t pos = 0;
  while (!(tag(frag + pos, "VP8 ") || tag(frag + pos, "VP8L"))) {  // ParseOptionalChunks
    const uint32_t size = le32(frag + pos + 4);
    const size_t disk = (size_t(8) + size + 1) & ~size_t(1);
    if (tag(frag + pos, "ALPH")) {
      alpha = frag + pos + 8;
      alpha_size = size;
    }
    pos += disk;
  }
  const bool lossless = tag(frag + pos, "VP8L");
  const uint8_t* payload = frag + pos + 8;
  const size_t payload_size = frag_size - pos - 8;  // the padding byte too
  const size_t stride = size_t(canvas_w) * 4;
  uint8_t* dst = canvas + size_t(f.y) * stride + size_t(f.x) * 4;
  if (lossless) {
    VP8L dec(payload, payload_size);
    int w, h, has_alpha;
    dec.header(&w, &h, &has_alpha);
    std::vector<uint32_t> argb = dec.image(w, h, false);
    for (int y = 0; y < h; ++y) {
      uint8_t* row = dst + size_t(y) * stride;
      for (int x = 0; x < w; ++x) {
        const uint32_t p = argb[size_t(y) * w + x];
        row[4 * x] = uint8_t(p >> 16);
        row[4 * x + 1] = uint8_t(p >> 8);
        row[4 * x + 2] = uint8_t(p);
        row[4 * x + 3] = uint8_t(p >> 24);
      }
    }
    return;
  }
  VP8 dec(payload, payload_size);
  Planes planes = dec.decode();
  std::vector<uint8_t> plane;
  if (alpha) plane = decode_alpha(alpha, alpha_size, planes.w, planes.h);
  emit_fancy(planes, dst, stride);
  if (alpha) {
    for (int y = 0; y < planes.h; ++y)
      for (int x = 0; x < planes.w; ++x) dst[size_t(y) * stride + 4 * size_t(x) + 3] = plane[size_t(y) * planes.w + x];
  }
}

void copy_error(const char* what, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", what);
}

}  // namespace

extern "C" {

// The canvas size and whether PIL opens the file as RGBA (else RGB).
// Returns 0, or 1 with a message in err: a file libwebp's demuxer refuses,
// or one of more pixels than PIL's decompression-bomb limit.
int mvd_webp_info(const uint8_t* data, size_t size, int* width, int* height, int* has_alpha, char* err, int errlen) {
  try {
    Image img = Demux(data, size).run();
    if (int64_t(img.canvas_w) * img.canvas_h > kMaxPixels) {
      fail("WebP of " + std::to_string(img.canvas_w) + "x" + std::to_string(img.canvas_h) +
           " pixels is over the limit of " + std::to_string(kMaxPixels) + " pixels (PIL's decompression-bomb limit)");
    }
    *width = img.canvas_w;
    *height = img.canvas_h;
    *has_alpha = pil_has_alpha(data, size) ? 1 : 0;
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

// The first frame on a zero canvas of width x height, RGBA (not
// premultiplied), into rgba (width * height * 4 bytes).
int mvd_webp_decode(const uint8_t* data, size_t size, uint8_t* rgba, int width, int height, char* err, int errlen) {
  try {
    Image img = Demux(data, size).run();
    if (img.canvas_w != width || img.canvas_h != height) fail("WebP: the canvas size changed");
    std::memset(rgba, 0, size_t(width) * height * 4);
    decode_frame(data, img.frames[0], rgba, width);
    return 0;
  } catch (const std::bad_alloc&) {
    copy_error("WebP: out of memory", err, errlen);
    return 1;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

}  // extern "C"
