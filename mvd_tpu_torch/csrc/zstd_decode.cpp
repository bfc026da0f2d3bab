// zstd decompressor of the port: host C++, the C++ standard library only,
// written from RFC 8878.
//
// Replaces no TPU kernel. The JAX package saves its checkpoints with orbax
// (mvd_tpu/checkpoint/orbax_io.py), whose OCDBT manifests, B+tree nodes and
// zarr chunks are zstd frames; the port reads them without orbax,
// tensorstore or a zstd library (mvd_tpu_torch/checkpoint/zstd.py wraps
// this file, mvd_tpu_torch/checkpoint/ocdbt.py and orbax_read.py use it).
//
// It decodes:
//
//   * frames one after another, and skippable frames (skipped);
//   * Raw, RLE and Compressed blocks;
//   * literals Raw, RLE, Huffman-compressed (1 or 4 streams, weights given
//     directly or FSE-compressed) and "treeless" (the frame's last table);
//   * sequences with the predefined, RLE, FSE-compressed and repeat modes of
//     each of the three tables, and the three repeat offsets;
//   * a Frame_Content_Size that is present or absent, and the XXH64 content
//     checksum when its flag is set.
//
// Anything else is refused with a message naming it: a dictionary ID other
// than 0, a reserved bit or block type, truncated input, an offset past the
// window or the frame's output so far, output past the declared content size
// or past the caller's buffer, and a stream that does not end where its
// header says. The decoder never returns a short buffer: a caller that
// names the size gets exactly that many bytes or an error.
//
// Bound: host work, a few operations per output byte; no device part.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ZstdError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw ZstdError(msg); }

std::string fmt(const char* f, unsigned long long a = 0, unsigned long long b = 0,
                unsigned long long c = 0) {
  char buf[256];
  std::snprintf(buf, sizeof buf, f, a, b, c);
  return buf;
}

inline uint32_t rd16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | uint32_t(p[2]) << 16; }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | rd16(p + 2) << 16; }
inline uint64_t rd64(const uint8_t* p) { return uint64_t(rd32(p)) | uint64_t(rd32(p + 4)) << 32; }

inline int highbit(uint64_t v) {  // index of the highest set bit; v > 0
  int n = 0;
  while (v >>= 1) ++n;
  return n;
}

constexpr size_t kBlockMax = 128 * 1024;

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t v) { return rotl(acc + v * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (end - p >= 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += n;
  while (end - p >= 8) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= *p++ * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- CRC32C

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable tab;
  const auto& t = tab.t;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo = rd32(p) ^ c, hi = rd32(p + 4);
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
        t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ t[0][(c ^ *p++) & 0xFF];
  return ~c;
}

// ---------------------------------------------------------------- output

// The decoded bytes: a caller's buffer of fixed size, or a vector that grows.
struct Out {
  uint8_t* buf = nullptr;
  size_t size = 0, cap = 0;
  // decoding stops after the block that brings the output to `limit` bytes
  // (libtiff's ZSTDDecode stops once its strip is full)
  size_t limit = SIZE_MAX;
  std::vector<uint8_t>* grow = nullptr;

  void reserve(size_t n) {
    if (size + n <= cap) return;
    if (!grow) fail(fmt("output past the caller's buffer of %llu bytes", cap));
    size_t want = std::max<size_t>({cap * 2, size + n, 1 << 16});
    grow->resize(want);
    buf = grow->data();
    cap = want;
  }
  void put(const uint8_t* p, size_t n) {
    reserve(n);
    if (n) std::memcpy(buf + size, p, n);
    size += n;
  }
  void fill(uint8_t v, size_t n) {
    reserve(n);
    std::memset(buf + size, v, n);
    size += n;
  }
  // ml bytes from offset back; the caller checked the offset
  void match(size_t offset, size_t ml) {
    reserve(ml);
    uint8_t* d = buf + size;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, ml);
    } else {
      for (size_t i = 0; i < ml; ++i) d[i] = s[i];
    }
    size += ml;
  }
};

// ---------------------------------------------------------------- bit streams

// A backward bit stream (RFC 8878 4.1): read from the end, the highest
// set bit of the last byte marks where the data starts. Reads past the
// stream's start yield zeros and leave ``rem`` negative.
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t rem;

  BackBits(const uint8_t* p_, size_t n_, const char* what) : p(p_), n(n_) {
    if (n == 0) fail(std::string(what) + ": empty bit stream");
    if (p[n - 1] == 0) fail(std::string(what) + ": bit stream's last byte is 0 (no end mark)");
    rem = int64_t(n - 1) * 8 + highbit(p[n - 1]);
  }
  // bits [start, start + nb) as an integer, nb <= 56, start >= 0
  uint64_t bits(int64_t start, int nb) const {
    size_t byte = size_t(start >> 3);
    uint64_t w = 0;
    if (byte + 8 <= n) {
      std::memcpy(&w, p + byte, 8);
    } else {
      std::memcpy(&w, p + byte, n - byte);
    }
    return (w >> (start & 7)) & ((uint64_t(1) << nb) - 1);
  }
  uint64_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t start = rem - nb;
    if (start >= 0) return bits(start, nb);
    return rem > 0 ? bits(0, int(rem)) << (-start) : 0;
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    rem -= nb;
    return v;
  }
};

// ---------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t sym;
  uint8_t nbits;
  uint16_t base;
};

struct Fse {
  int al = -1;  // accuracy log; -1: no table yet
  std::vector<FseEntry> t;
};

void build_fse(const int16_t* norm, int max_sym, int al, Fse& f, const char* what) {
  const uint32_t size = 1u << al;
  f.al = al;
  f.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(size_t(max_sym) + 1);
  int64_t high = int64_t(size) - 1;
  for (int s = 0; s <= max_sym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail(std::string(what) + ": FSE table has more low-probability symbols than cells");
      f.t[size_t(high--)].sym = uint16_t(s);
      next[size_t(s)] = 1;
    } else {
      next[size_t(s)] = uint32_t(std::max<int16_t>(norm[s], 0));
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s <= max_sym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      f.t[pos].sym = uint16_t(s);
      do {
        pos = (pos + step) & mask;
      } while (int64_t(pos) > high);
    }
  }
  if (pos != 0) fail(std::string(what) + ": FSE table's spread does not close (corrupt distribution)");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t ns = next[f.t[u].sym]++;
    if (ns == 0) fail(std::string(what) + ": FSE state of a zero-probability symbol");
    int nb = al - highbit(ns);
    f.t[u].nbits = uint8_t(nb);
    f.t[u].base = uint16_t((ns << nb) - size);
  }
}

// Read an FSE table description (RFC 8878 4.1.1) at src[0, n): the
// normalized counts into norm, the last symbol into max_sym (in: the
// largest allowed), the accuracy log into al. Returns the bytes read.
size_t read_ncount(const uint8_t* src, size_t n, int16_t* norm, int& max_sym, int& al, int max_al,
                   const char* what) {
  if (n < 1) fail(std::string(what) + ": truncated FSE table description");
  uint64_t bitpos = 0;
  auto peek = [&](int nb) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i) {
      uint64_t b = bitpos + uint64_t(i);
      uint32_t bit = (b >> 3) < n ? (src[b >> 3] >> (b & 7)) & 1 : 0;
      v |= bit << i;
    }
    return v;
  };
  al = int(peek(4)) + 5;
  bitpos = 4;
  if (al > max_al) fail(std::string(what) + fmt(": FSE accuracy log %llu above the limit %llu", al, max_al));
  int32_t remaining = (1 << al) + 1, threshold = 1 << al;
  int nbits = al + 1, sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = peek(2);
        bitpos += 2;
        n0 += int(r);
        if (r != 3) break;
        if (n0 > max_sym) break;
      }
      if (n0 > max_sym) fail(std::string(what) + ": FSE table's zero run passes the last symbol");
      while (sym < n0) norm[sym++] = 0;
    }
    const int32_t maxv = (2 * threshold - 1) - remaining;
    int32_t count;
    uint32_t low = peek(nbits - 1);
    if (int32_t(low) < maxv) {
      count = int32_t(low);
      bitpos += uint64_t(nbits - 1);
    } else {
      count = int32_t(peek(nbits));
      if (count >= threshold) count -= maxv;
      bitpos += uint64_t(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail(std::string(what) + ": FSE probabilities exceed the table");
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(std::string(what) + ": FSE probabilities do not fill the table");
  size_t used = size_t((bitpos + 7) >> 3);
  if (used > n) fail(std::string(what) + ": truncated FSE table description");
  max_sym = sym - 1;
  return used;
}

// ---------------------------------------------------------------- Huffman

struct Huf {
  int max_bits = 0;  // 0: no table yet
  std::vector<uint8_t> sym, nb;
};

// The Huffman tree description (RFC 8878 4.2.1) at src[0, n) into h;
// returns the bytes read.
size_t read_huffman(const uint8_t* src, size_t n, Huf& h) {
  if (n < 1) fail("Huffman tree description: truncated");
  uint8_t w[256] = {0};
  int nw = 0;
  const uint8_t hb = src[0];
  size_t used;
  if (hb >= 128) {
    nw = hb - 127;
    used = 1 + size_t(nw + 1) / 2;
    if (used > n) fail("Huffman tree description: truncated weights");
    for (int i = 0; i < nw; ++i) w[i] = (i % 2 == 0) ? src[1 + i / 2] >> 4 : src[1 + i / 2] & 15;
  } else {
    used = 1 + size_t(hb);
    if (used > n) fail("Huffman tree description: truncated FSE-compressed weights");
    int16_t norm[256];
    int max_sym = 255, al = 0;
    size_t k = read_ncount(src + 1, hb, norm, max_sym, al, 6, "Huffman weights");
    Fse f;
    build_fse(norm, max_sym, al, f, "Huffman weights");
    if (k >= hb) fail("Huffman weights: no bit stream after the FSE table");
    BackBits br(src + 1 + k, hb - k, "Huffman weights");
    uint32_t s1 = uint32_t(br.read(al)), s2 = uint32_t(br.read(al));
    if (br.rem < 0) fail("Huffman weights: bit stream too short for the initial states");
    for (;;) {
      if (nw > 253) fail("Huffman weights: more than 255 weights");
      w[nw++] = uint8_t(f.t[s1].sym);
      s1 = f.t[s1].base + uint32_t(br.read(f.t[s1].nbits));
      if (br.rem < 0) {
        w[nw++] = uint8_t(f.t[s2].sym);
        break;
      }
      w[nw++] = uint8_t(f.t[s2].sym);
      s2 = f.t[s2].base + uint32_t(br.read(f.t[s2].nbits));
      if (br.rem < 0) {
        w[nw++] = uint8_t(f.t[s1].sym);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail(fmt("Huffman weight %llu above 11", w[i]));
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail(fmt("Huffman code of %llu bits (the limit is 11)", max_bits));
  const uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights do not complete a code (remainder not a power of 2)");
  w[nw++] = uint8_t(highbit(left) + 1);
  uint32_t rank_start[13] = {0}, rank_count[13] = {0};
  for (int i = 0; i < nw; ++i) rank_count[w[i]]++;
  uint32_t next = 0;
  for (int r = 1; r <= max_bits; ++r) {
    rank_start[r] = next;
    next += rank_count[r] << (r - 1);
  }
  const size_t size = size_t(1) << max_bits;
  if (next != size) fail("Huffman weights do not fill the code");
  h.max_bits = max_bits;
  h.sym.assign(size, 0);
  h.nb.assign(size, 0);
  for (int s = 0; s < nw; ++s) {
    const int r = w[s];
    if (!r) continue;
    const uint32_t len = 1u << (r - 1);
    for (uint32_t i = rank_start[r]; i < rank_start[r] + len; ++i) {
      h.sym[i] = uint8_t(s);
      h.nb[i] = uint8_t(max_bits + 1 - r);
    }
    rank_start[r] += len;
  }
  return used;
}

void huffman_stream(const uint8_t* src, size_t n, uint8_t* out, size_t count, const Huf& h) {
  BackBits br(src, n, "Huffman literal stream");
  const int mb = h.max_bits;
  for (size_t i = 0; i < count; ++i) {
    const uint32_t idx = uint32_t(br.peek(mb));
    out[i] = h.sym[idx];
    br.rem -= h.nb[idx];
    if (br.rem < 0) fail("Huffman literal stream: read past its start");
  }
  if (br.rem != 0) fail(fmt("Huffman literal stream: %llu bits left over", uint64_t(br.rem)));
}

// ---------------------------------------------------------------- sequences

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20,  22,  24,  28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,   4,   5,    6,    7,    8,    9,    10,    11,    12,    13,
                              14,  15,  16,   17,   18,   19,   20,   21,    22,    23,    24,
                              25,  26,  27,   28,   29,   30,   31,   32,    33,    34,    35,
                              37,  39,  41,   43,   47,   51,   59,   67,    83,    99,    131,
                              259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct SeqKind {
  const char* name;
  int max_sym, max_al;
  const int16_t* def;
  int def_max, def_al;
};
const SeqKind kLL{"literal-length table", 35, 9, kLLDefault, 35, 6};
const SeqKind kOF{"offset table", 31, 8, kOFDefault, 28, 5};
const SeqKind kML{"match-length table", 52, 9, kMLDefault, 52, 6};

// Per-frame state that later blocks repeat.
struct FrameState {
  Huf huf;
  Fse ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
};

// One table of the sequences section: mode 0 predefined, 1 RLE, 2 FSE, 3
// repeat. Returns the bytes read.
size_t read_table(int mode, const SeqKind& k, const uint8_t* p, size_t n, Fse& f) {
  switch (mode) {
    case 0:
      build_fse(k.def, k.def_max, k.def_al, f, k.name);
      return 0;
    case 1: {
      if (n < 1) fail(std::string(k.name) + ": truncated RLE symbol");
      if (p[0] > k.max_sym) fail(std::string(k.name) + fmt(": RLE symbol %llu above %llu", p[0], k.max_sym));
      f.al = 0;
      f.t.assign(1, FseEntry{p[0], 0, 0});
      return 1;
    }
    case 2: {
      int16_t norm[64];
      int max_sym = k.max_sym, al = 0;
      size_t used = read_ncount(p, n, norm, max_sym, al, k.max_al, k.name);
      build_fse(norm, max_sym, al, f, k.name);
      return used;
    }
    default:
      if (f.al < 0) fail(std::string(k.name) + ": repeat mode with no previous table in the frame");
      return 0;
  }
}

// ---------------------------------------------------------------- blocks

size_t decode_literals(const uint8_t* p, size_t n, FrameState& st, size_t& nlit) {
  if (n < 1) fail("literals section: truncated header");
  const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
  if (type < 2) {
    size_t hs, size;
    if (sf == 0 || sf == 2) {
      hs = 1;
      size = p[0] >> 3;
    } else if (sf == 1) {
      hs = 2;
      if (n < 2) fail("literals section: truncated header");
      size = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      hs = 3;
      if (n < 3) fail("literals section: truncated header");
      size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
    if (size > kBlockMax) fail(fmt("literals section of %llu bytes (the limit is 128 KiB)", size));
    st.lit.resize(size);
    nlit = size;
    if (type == 0) {
      if (n < hs + size) fail("raw literals: truncated");
      if (size) std::memcpy(st.lit.data(), p + hs, size);
      return hs + size;
    }
    if (n < hs + 1) fail("RLE literals: truncated");
    std::memset(st.lit.data(), p[hs], size);
    return hs + 1;
  }
  size_t hs, regen, csize;
  bool single = sf == 0;
  if (sf < 2) {
    hs = 3;
    if (n < 3) fail("compressed literals: truncated header");
    uint32_t h = rd24(p);
    regen = (h >> 4) & 0x3FF;
    csize = (h >> 14) & 0x3FF;
  } else if (sf == 2) {
    hs = 4;
    if (n < 4) fail("compressed literals: truncated header");
    uint32_t h = rd32(p);
    regen = (h >> 4) & 0x3FFF;
    csize = (h >> 18) & 0x3FFF;
  } else {
    hs = 5;
    if (n < 5) fail("compressed literals: truncated header");
    uint64_t h = uint64_t(rd32(p)) | uint64_t(p[4]) << 32;
    regen = size_t((h >> 4) & 0x3FFFF);
    csize = size_t((h >> 22) & 0x3FFFF);
  }
  if (regen > kBlockMax) fail(fmt("literals section of %llu bytes (the limit is 128 KiB)", regen));
  if (n < hs + csize) fail("compressed literals: truncated");
  const uint8_t* q = p + hs;
  size_t left = csize;
  if (type == 2) {
    size_t k = read_huffman(q, left, st.huf);
    q += k;
    left -= k;
  } else if (st.huf.max_bits == 0) {
    fail("treeless literals with no previous Huffman table in the frame");
  }
  st.lit.resize(regen);
  nlit = regen;
  if (single) {
    huffman_stream(q, left, st.lit.data(), regen, st.huf);
  } else {
    if (left < 6) fail("4-stream literals: truncated jump table");
    size_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4);
    if (s1 + s2 + s3 > left - 6) fail("4-stream literals: jump table past the section");
    size_t s4 = left - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail(fmt("4-stream literals of only %llu bytes", regen));
    const uint8_t* d = q + 6;
    uint8_t* o = st.lit.data();
    huffman_stream(d, s1, o, seg, st.huf);
    huffman_stream(d + s1, s2, o + seg, seg, st.huf);
    huffman_stream(d + s1 + s2, s3, o + 2 * seg, seg, st.huf);
    huffman_stream(d + s1 + s2 + s3, s4, o + 3 * seg, regen - 3 * seg, st.huf);
  }
  return hs + csize;
}

void decode_block(const uint8_t* p, size_t n, FrameState& st, Out& out, size_t frame_start,
                  uint64_t window, size_t block_max) {
  size_t nlit = 0;
  size_t used = decode_literals(p, n, st, nlit);
  p += used;
  n -= used;
  const size_t block_start = out.size;
  if (n < 1) fail("sequences section: truncated");
  size_t nseq = p[0], hs = 1;
  if (nseq >= 128) {
    if (nseq < 255) {
      if (n < 2) fail("sequences section: truncated header");
      nseq = ((nseq - 128) << 8) + p[1];
      hs = 2;
    } else {
      if (n < 3) fail("sequences section: truncated header");
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      hs = 3;
    }
  }
  p += hs;
  n -= hs;
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (n < 1) fail("sequences section: truncated modes");
    const uint8_t modes = p[0];
    if (modes & 3) fail("sequences section: reserved bits of the modes byte are set");
    p += 1;
    n -= 1;
    size_t k = read_table(modes >> 6, kLL, p, n, st.ll);
    p += k;
    n -= k;
    k = read_table((modes >> 4) & 3, kOF, p, n, st.of);
    p += k;
    n -= k;
    k = read_table((modes >> 2) & 3, kML, p, n, st.ml);
    p += k;
    n -= k;
    BackBits br(p, n, "sequences bit stream");
    uint32_t sll = uint32_t(br.read(st.ll.al)), sof = uint32_t(br.read(st.of.al)),
             sml = uint32_t(br.read(st.ml.al));
    uint64_t* rep = st.rep;
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry &ell = st.ll.t[sll], &eof = st.of.t[sof], &eml = st.ml.t[sml];
      const int ofc = eof.sym;
      if (ofc > 31) fail(fmt("offset code %llu above 31", ofc));
      const uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
      const uint64_t ml = kMLBase[eml.sym] + br.read(kMLBits[eml.sym]);
      const uint64_t ll = kLLBase[ell.sym] + br.read(kLLBits[ell.sym]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        const int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? rep[0] - 1 : rep[idx];
          if (offset == 0) fail("repeat offset 1 minus 1 is 0");
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = ell.base + uint32_t(br.read(ell.nbits));
        sml = eml.base + uint32_t(br.read(eml.nbits));
        sof = eof.base + uint32_t(br.read(eof.nbits));
      }
      if (br.rem < 0) fail(fmt("sequences bit stream: read past its start at sequence %llu of %llu", i, nseq));
      if (ll > nlit - lit_pos) fail("sequence takes more literals than the block holds");
      if (out.size - block_start + ll + ml > block_max)
        fail(fmt("block decodes past the block maximum of %llu bytes", block_max));
      out.put(st.lit.data() + lit_pos, size_t(ll));
      lit_pos += size_t(ll);
      const size_t have = out.size - frame_start;
      if (offset > have)
        fail(fmt("offset %llu past the %llu bytes decoded so far in the frame", offset, have));
      if (offset > window) fail(fmt("offset %llu past the window of %llu bytes", offset, window));
      out.match(size_t(offset), size_t(ml));
    }
    if (br.rem != 0) fail(fmt("sequences bit stream: %llu bits left over", uint64_t(br.rem)));
  } else if (n != 0) {
    fail("block has bytes after a sequences section of no sequences");
  }
  if (out.size - block_start + (nlit - lit_pos) > block_max)
    fail(fmt("block decodes past the block maximum of %llu bytes", block_max));
  out.put(st.lit.data() + lit_pos, nlit - lit_pos);
}

// ---------------------------------------------------------------- frames

// One zstd frame at src[0, n) (its magic checked); returns the bytes read.
size_t decode_frame(const uint8_t* src, size_t n, Out& out) {
  size_t pos = 4;
  auto need = [&](size_t k, const char* what) {
    if (n - pos < k) fail(std::string("truncated input: ") + what);
  };
  need(1, "frame header");
  const uint8_t fhd = src[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if (fhd & 8) fail("frame header's reserved bit is set");
  uint64_t window = 0;
  if (!single) {
    need(1, "window descriptor");
    const uint8_t wd = src[pos++];
    const int wlog = 10 + (wd >> 3);
    if (wlog > 41) fail(fmt("window log %llu", wlog));
    const uint64_t base = uint64_t(1) << wlog;
    window = base + (base / 8) * (wd & 7);
  }
  if (dict_flag) {
    const size_t k = dict_flag == 3 ? 4 : size_t(dict_flag);
    need(k, "dictionary ID");
    uint32_t id = 0;
    for (size_t i = 0; i < k; ++i) id |= uint32_t(src[pos + i]) << (8 * i);
    pos += k;
    if (id != 0) fail(fmt("dictionary ID %llu: frames that need a dictionary are not read", id));
  }
  const size_t fcs_bytes[4] = {size_t(single ? 1 : 0), 2, 4, 8};
  const size_t fb = fcs_bytes[fcs_flag];
  const bool has_fcs = fb > 0;
  uint64_t fcs = 0;
  if (has_fcs) {
    need(fb, "frame content size");
    for (size_t i = 0; i < fb; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
    if (fb == 2) fcs += 256;
    pos += fb;
  }
  if (single) window = fcs;
  const size_t block_max = size_t(std::min<uint64_t>(window, kBlockMax));
  const size_t frame_start = out.size;
  if (has_fcs && out.grow && fcs <= (uint64_t(1) << 32)) out.reserve(size_t(fcs));
  FrameState st;
  for (;;) {
    need(3, "block header");
    const uint32_t bh = rd24(src + pos);
    pos += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (type == 3) fail("reserved block type");
    const size_t content = type == 1 ? bsize : 0;
    if (bsize > block_max)
      fail(fmt("block of %llu bytes past the block maximum of %llu", bsize, block_max));
    if (has_fcs && (type != 2) && out.size - frame_start + bsize > fcs)
      fail(fmt("output past the declared content size of %llu bytes", fcs));
    if (type == 0) {
      need(bsize, "raw block");
      out.put(src + pos, bsize);
      pos += bsize;
    } else if (type == 1) {
      need(1, "RLE block");
      out.fill(src[pos], content);
      pos += 1;
    } else {
      need(bsize, "compressed block");
      decode_block(src + pos, bsize, st, out, frame_start, window, block_max);
      pos += bsize;
      if (has_fcs && out.size - frame_start > fcs)
        fail(fmt("output past the declared content size of %llu bytes", fcs));
    }
    if (last) break;
    if (out.size >= out.limit) return pos;
  }
  const size_t got = out.size - frame_start;
  if (has_fcs && got != fcs)
    fail(fmt("frame declares %llu bytes of content and decodes to %llu", fcs, got));
  if (checksum) {
    need(4, "content checksum");
    const uint32_t want = rd32(src + pos);
    pos += 4;
    const uint32_t have = uint32_t(xxh64(out.buf + frame_start, got, 0));
    if (want != have) fail(fmt("content checksum 0x%08llx does not match the content's 0x%08llx", want, have));
  }
  return pos;
}

void decode_all(const uint8_t* src, size_t n, Out& out) {
  if (n == 0) fail("no zstd frame: the input is empty");
  size_t pos = 0;
  while (pos < n && out.size < out.limit) {
    if (n - pos < 4) fail(fmt("truncated input: %llu stray bytes after the frames", n - pos));
    const uint32_t magic = rd32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("truncated input: skippable frame header");
      const size_t size = rd32(src + pos + 4);
      if (n - pos - 8 < size) fail("truncated input: skippable frame");
      pos += 8 + size;
      continue;
    }
    if (magic != 0xFD2FB528u) fail(fmt("not a zstd frame: magic 0x%08llx at byte %llu", magic, pos));
    pos += decode_frame(src + pos, n - pos, out);
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

// Decode every frame of src into dst, which holds cap bytes. Returns the
// bytes written, or -1 with a message in err.
long long mvd_zstd_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* err, int errlen) {
  try {
    Out out;
    out.buf = dst;
    out.cap = cap;
    decode_all(src, n, out);
    return (long long)out.size;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return -1;
  }
}

// Decode every frame of src into a buffer of the decoder's own, stopping
// after the block that brings the output to `limit` bytes (SIZE_MAX: no
// limit); nothing past that block is read (libtiff's ZSTDDecode of a strip
// of `limit` bytes). Returns a handle for mvd_zstd_take with the size in
// *size, or null with a message in err.
void* mvd_zstd_decode_alloc(const uint8_t* src, size_t n, size_t limit, size_t* size, char* err, int errlen) {
  auto* v = new std::vector<uint8_t>();
  try {
    Out out;
    out.grow = v;
    out.limit = limit;
    decode_all(src, n, out);
    v->resize(out.size);
    *size = out.size;
    return v;
  } catch (const std::exception& e) {
    delete v;
    copy_error(e.what(), err, errlen);
    return nullptr;
  }
}

// Copy what mvd_zstd_decode_alloc decoded into dst and free it; dst null
// only frees.
void mvd_zstd_take(void* handle, uint8_t* dst) {
  auto* v = static_cast<std::vector<uint8_t>*>(handle);
  if (dst && !v->empty()) std::memcpy(dst, v->data(), v->size());
  delete v;
}

// CRC-32C (Castagnoli) of p[0, n), as OCDBT's manifests and nodes carry it.
uint32_t mvd_crc32c(const uint8_t* p, size_t n) { return crc32c(p, n); }

}  // extern "C"
