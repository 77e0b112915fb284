// Host zstd decoder with a plain C interface (bound with ctypes in
// native/zstd.py). Decode only, written from RFC 8878:
//   - frames (magic 0xFD2FB528) with or without the content size and the
//     XXH64 content checksum (checked when present), windows up to the
//     frame's own; skippable frames (0x184D2A5?) are stepped over, and
//     concatenated frames decode one after another;
//   - raw, RLE and compressed blocks;
//   - literals: raw, RLE, Huffman-compressed and treeless (the previous
//     block's Huffman table), with 1 or 4 streams; Huffman weights sent
//     directly or FSE-compressed;
//   - sequences: literal-length, offset and match-length codes in
//     predefined, RLE, FSE-compressed and repeat modes, the three repeat
//     offsets, matches that overlap their own output.
// Dictionary frames (a nonzero Dictionary_ID) are refused. Corrupt or
// truncated input gives an error message, never a read or write out of
// bounds: every read of the input is bounded, and every match is checked
// against the frame's output so far.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ZstdError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& m) { throw ZstdError(m); }

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kMaxBlock = 128 * 1024;
constexpr int kMaxHuffBits = 11;

inline uint32_t load_le(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint32_t(p[i]) << (8 * i);
  return v;
}

inline uint64_t load_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

// ---- XXH64 ----------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xxh_round(v1, load_le64(p));
      v2 = xxh_round(v2, load_le64(p + 8));
      v3 = xxh_round(v3, load_le64(p + 16));
      v4 = xxh_round(v4, load_le64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h = rotl(h ^ xxh_round(0, load_le64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(load_le(p, 4)) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) h = rotl(h ^ (uint64_t(*p++) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- bit readers ----------------------------------------------------------

// Forward little-endian bits (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  uint64_t pos = 0;  // in bits
  FwdBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int k) const {  // k <= 32; bits past the end read as 0
    uint64_t v = 0;
    size_t b = size_t(pos >> 3);
    for (int i = 0; i < 5 && b + i < n; ++i) v |= uint64_t(p[b + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ull << k) - 1));
  }
  void skip(int k) { pos += uint64_t(k); }
  size_t bytes_used() const { return size_t((pos + 7) >> 3); }
};

// Backward bits (Huffman and FSE streams): the stream is read from its last
// byte down; the highest set bit of the last byte marks its start. Bits
// read past the stream's first byte are zeros, as the reference decoder's.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t left = 0;  // bits not yet consumed; negative past the start
  int64_t total = 0;
  BackBits() = default;
  BackBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    if (n == 0) fail("empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("bitstream has no end marker");
    total = left = int64_t(8 * (n - 1)) + highbit(last);
  }
  // The k (<= 56) bits below the read position, without consuming them.
  inline uint64_t peek(int k) const {
    if (k == 0) return 0;
    int64_t lo = left - k;
    if (lo >= 0) {
      size_t b = size_t(lo >> 3);
      uint64_t w;
      if (b + 8 <= n) {
        w = load_le64(p + b);
      } else {
        w = 0;
        for (size_t i = 0; b + i < n; ++i) w |= uint64_t(p[b + i]) << (8 * i);
      }
      return (w >> (lo & 7)) & ((1ull << k) - 1);
    }
    if (left <= 0) return 0;
    uint64_t w = 0;
    for (size_t i = 0; i < 8 && i < n; ++i) w |= uint64_t(p[i]) << (8 * i);
    return (w & ((1ull << left) - 1)) << (-lo);
  }
  inline void skip(int k) { left -= k; }
  inline uint64_t get(int k) {
    uint64_t v = peek(k);
    left -= k;
    return v;
  }
  bool overflowed() const { return left < 0; }
  bool finished() const { return left == 0; }
};

// ---- FSE ------------------------------------------------------------------

struct FseEntry {
  uint16_t base;
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// Reads an FSE table description (RFC 8878 4.1.1); returns its byte size.
size_t read_ncount(const uint8_t* p, size_t n, int max_symbol, int max_log,
                   std::vector<int16_t>& norm, int& log) {
  if (n == 0) fail("missing FSE table description");
  FwdBits br(p, n);
  log = int(br.peek(4)) + 5;
  br.skip(4);
  if (log > max_log) fail("FSE accuracy log too large");
  norm.assign(size_t(max_symbol) + 1, 0);
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nbits = log + 1;
  int symbol = 0;
  bool previous0 = false;
  while (remaining > 1 && symbol <= max_symbol) {
    if (previous0) {
      int n0 = symbol;
      for (;;) {
        uint32_t r = br.peek(2);
        br.skip(2);
        n0 += int(r);
        if (r != 3) break;
        if (br.pos > 8 * uint64_t(n)) fail("FSE table description truncated");
      }
      if (n0 > max_symbol) fail("FSE table: symbol out of range");
      while (symbol < n0) norm[size_t(symbol++)] = 0;
      if (symbol > max_symbol) break;
    }
    int maxv = (2 * threshold - 1) - remaining;
    uint32_t bits = br.peek(nbits);
    int count;
    if (int(bits & uint32_t(threshold - 1)) < maxv) {
      count = int(bits & uint32_t(threshold - 1));
      br.skip(nbits - 1);
    } else {
      count = int(bits & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= maxv;
      br.skip(nbits);
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[size_t(symbol++)] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
    if (br.pos > 8 * uint64_t(n)) fail("FSE table description truncated");
  }
  if (remaining != 1) fail("FSE table description: bad probabilities");
  norm.resize(size_t(symbol));
  if (br.bytes_used() > n) fail("FSE table description truncated");
  return br.bytes_used();
}

void build_fse(const std::vector<int16_t>& norm, int log, FseTable& out) {
  const uint32_t size = 1u << log;
  out.log = log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  uint32_t high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      out.t[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      out.t[pos].symbol = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table: bad spread");
  for (uint32_t u = 0; u < size; ++u) {
    FseEntry& e = out.t[u];
    uint32_t ns = next[e.symbol]++;
    if (ns == 0) fail("FSE table: bad state");
    int bits = log - highbit(ns);
    e.bits = uint8_t(bits);
    e.base = uint16_t((ns << bits) - size);
  }
}

void build_rle(uint8_t symbol, FseTable& out) {
  out.log = 0;
  out.t.assign(1, FseEntry{0, symbol, 0});
}

// ---- Huffman --------------------------------------------------------------

struct HufTable {
  int bits = 0;
  std::vector<uint16_t> t;  // symbol << 8 | code length
};

// Decodes FSE-compressed Huffman weights (two interleaved states).
size_t fse_weights(const uint8_t* p, size_t n, uint8_t* w) {
  std::vector<int16_t> norm;
  int log;
  size_t hdr = read_ncount(p, n, 255, 6, norm, log);
  FseTable t;
  build_fse(norm, log, t);
  BackBits br(p + hdr, n - hdr);
  uint32_t s1 = uint32_t(br.get(log)), s2 = uint32_t(br.get(log));
  size_t count = 0;
  const size_t cap = 255;
  for (;;) {
    if (count + 2 > cap) fail("Huffman weights: too many symbols");
    w[count++] = t.t[s1].symbol;
    s1 = t.t[s1].base + uint32_t(br.get(t.t[s1].bits));
    if (br.overflowed()) {
      w[count++] = t.t[s2].symbol;
      break;
    }
    w[count++] = t.t[s2].symbol;
    s2 = t.t[s2].base + uint32_t(br.get(t.t[s2].bits));
    if (br.overflowed()) {
      w[count++] = t.t[s1].symbol;
      break;
    }
  }
  return count;
}

// Reads a Huffman tree description; returns its byte size.
size_t read_huffman(const uint8_t* p, size_t n, HufTable& out) {
  if (n == 0) fail("missing Huffman tree description");
  uint8_t w[256] = {0};
  size_t count, used;
  uint8_t hb = p[0];
  if (hb < 128) {
    if (size_t(hb) + 1 > n) fail("Huffman tree description truncated");
    count = fse_weights(p + 1, hb, w);
    used = size_t(hb) + 1;
  } else {
    count = size_t(hb) - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) fail("Huffman tree description truncated");
    for (size_t i = 0; i < count; ++i) {
      uint8_t b = p[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  }
  uint64_t total = 0;
  for (size_t i = 0; i < count; ++i) {
    if (w[i] > kMaxHuffBits) fail("Huffman weight too large");
    if (w[i]) total += 1ull << (w[i] - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int bits = highbit(total) + 1;
  if (bits > kMaxHuffBits) fail("Huffman code too long");
  uint64_t rest = (1ull << bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not complete the tree");
  if (count >= 256) fail("Huffman weights: too many symbols");
  w[count++] = uint8_t(highbit(rest) + 1);
  out.bits = bits;
  out.t.assign(size_t(1) << bits, 0);
  size_t pos = 0;
  for (int weight = 1; weight <= bits; ++weight) {
    for (size_t s = 0; s < count; ++s) {
      if (w[s] != weight) continue;
      size_t len = size_t(1) << (weight - 1);
      uint16_t e = uint16_t((s << 8) | uint32_t(bits + 1 - weight));
      for (size_t i = 0; i < len; ++i) out.t[pos + i] = e;
      pos += len;
    }
  }
  return used;
}

void huffman_stream(const HufTable& h, const uint8_t* p, size_t n,
                    uint8_t* out, size_t count) {
  BackBits br(p, n);
  const uint16_t* t = h.t.data();
  const int bits = h.bits;
  size_t i = 0;
  // While 64 bits lie below the read position, one load serves 4 symbols
  // (at most 44 bits); the rest goes through the bounded reader.
  while (count - i >= 4 && br.left >= 64) {
    size_t b = size_t((br.left - 1) >> 3) - 7;
    int top = int(br.left - 8 * int64_t(b));
    uint64_t w = load_le64(p + b) << (64 - top);
    for (int k = 0; k < 4; ++k) {
      uint16_t e = t[w >> (64 - bits)];
      out[i++] = uint8_t(e >> 8);
      w <<= (e & 0xFF);
      br.left -= e & 0xFF;
    }
  }
  for (; i < count; ++i) {
    uint16_t e = t[br.peek(bits)];
    out[i] = uint8_t(e >> 8);
    br.skip(e & 0xFF);
  }
  if (!br.finished()) fail("Huffman stream not consumed exactly");
}

// ---- sequences ------------------------------------------------------------

const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

enum { kLL = 0, kOF = 1, kML = 2 };
const int kMaxSymbol[3] = {35, 31, 52};
const int kMaxLog[3] = {9, 8, 9};

// The output of one decode call: a caller's fixed buffer, or a heap buffer
// that grows.
struct Out {
  uint8_t* p = nullptr;
  size_t n = 0, cap = 0;
  bool grow = false;
  void reserve(size_t add) {
    if (add <= cap - n) return;
    if (!grow) fail("output larger than the buffer given");
    size_t want = n + add, c = cap ? cap : size_t(1) << 16;
    while (c < want) c *= 2;
    void* q = std::realloc(p, c);
    if (!q) fail("out of memory");
    p = static_cast<uint8_t*>(q);
    cap = c;
  }
};

struct FrameState {
  FseTable tables[3];
  bool have_table[3] = {false, false, false};
  HufTable huf;
  bool have_huf = false;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

struct Decoder {
  Out out;
  FrameState fs;

  // Literals section: fills fs.lits (or points at raw input); returns its
  // byte size.
  size_t literals(const uint8_t* p, size_t n, const uint8_t*& lit,
                  size_t& nlit) {
    if (n == 0) fail("block truncated in the literals header");
    int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
    if (type <= 1) {
      size_t hsize, regen;
      if ((fmt & 1) == 0) {
        hsize = 1;
        regen = p[0] >> 3;
      } else if (fmt == 1) {
        hsize = 2;
        if (n < 2) fail("literals header truncated");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      } else {
        hsize = 3;
        if (n < 3) fail("literals header truncated");
        regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      }
      if (regen > kMaxBlock) fail("literals larger than a block");
      nlit = regen;
      if (type == 0) {
        if (hsize + regen > n) fail("raw literals truncated");
        lit = p + hsize;
        return hsize + regen;
      }
      if (hsize + 1 > n) fail("RLE literals truncated");
      fs.lits.assign(regen, p[hsize]);
      lit = fs.lits.data();
      return hsize + 1;
    }
    size_t hsize, regen, csize;
    int streams = fmt == 0 ? 1 : 4;
    if (fmt <= 1) {
      hsize = 3;
      if (n < 3) fail("literals header truncated");
      uint32_t v = load_le(p, 3);
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
    } else if (fmt == 2) {
      hsize = 4;
      if (n < 4) fail("literals header truncated");
      uint32_t v = load_le(p, 4);
      regen = (v >> 4) & 0x3FFF;
      csize = v >> 18;
    } else {
      hsize = 5;
      if (n < 5) fail("literals header truncated");
      uint64_t v = uint64_t(load_le(p, 4)) | (uint64_t(p[4]) << 32);
      regen = size_t((v >> 4) & 0x3FFFF);
      csize = size_t((v >> 22) & 0x3FFFF);
    }
    if (regen > kMaxBlock) fail("literals larger than a block");
    if (hsize + csize > n) fail("compressed literals truncated");
    const uint8_t* q = p + hsize;
    size_t qn = csize;
    if (type == 2) {
      size_t used = read_huffman(q, qn, fs.huf);
      fs.have_huf = true;
      q += used;
      qn -= used;
    } else if (!fs.have_huf) {
      fail("treeless literals without a previous Huffman table");
    }
    fs.lits.resize(regen);
    if (streams == 1) {
      huffman_stream(fs.huf, q, qn, fs.lits.data(), regen);
    } else {
      if (qn < 6) fail("literals jump table truncated");
      size_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2), s3 = load_le(q + 4, 2);
      if (6 + s1 + s2 + s3 > qn) fail("literals streams truncated");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("literals: bad stream sizes");
      const uint8_t* b = q + 6;
      uint8_t* o = fs.lits.data();
      huffman_stream(fs.huf, b, s1, o, seg);
      huffman_stream(fs.huf, b + s1, s2, o + seg, seg);
      huffman_stream(fs.huf, b + s1 + s2, s3, o + 2 * seg, seg);
      huffman_stream(fs.huf, b + s1 + s2 + s3, s4, o + 3 * seg,
                     regen - 3 * seg);
    }
    lit = fs.lits.data();
    nlit = regen;
    return hsize + csize;
  }

  size_t table(int kind, int mode, const uint8_t* p, size_t n) {
    FseTable& t = fs.tables[kind];
    switch (mode) {
      case 0: {
        std::vector<int16_t> norm;
        if (kind == kLL) norm.assign(kLLDefault, kLLDefault + 36);
        else if (kind == kML) norm.assign(kMLDefault, kMLDefault + 53);
        else norm.assign(kOFDefault, kOFDefault + 29);
        build_fse(norm, kind == kOF ? 5 : 6, t);
        fs.have_table[kind] = true;
        return 0;
      }
      case 1:
        if (n < 1) fail("RLE sequence table truncated");
        if (p[0] > kMaxSymbol[kind]) fail("RLE sequence symbol out of range");
        build_rle(p[0], t);
        fs.have_table[kind] = true;
        return 1;
      case 2: {
        std::vector<int16_t> norm;
        int log;
        size_t used = read_ncount(p, n, kMaxSymbol[kind], kMaxLog[kind], norm,
                                  log);
        build_fse(norm, log, t);
        fs.have_table[kind] = true;
        return used;
      }
      default:
        if (!fs.have_table[kind]) fail("repeat mode without a previous table");
        return 0;
    }
  }

  void block(const uint8_t* p, size_t n, size_t frame_start) {
    const uint8_t* lit;
    size_t nlit;
    size_t used = literals(p, n, lit, nlit);
    p += used;
    n -= used;
    if (n == 0) fail("block truncated before the sequences section");
    size_t nseq = p[0], h = 1;
    if (nseq >= 128) {
      if (nseq == 255) {
        if (n < 3) fail("sequences header truncated");
        nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
        h = 3;
      } else {
        if (n < 2) fail("sequences header truncated");
        nseq = ((nseq - 128) << 8) + p[1];
        h = 2;
      }
    }
    size_t out0 = out.n;
    if (nseq == 0) {
      if (h != n) fail("block has bytes after an empty sequences section");
      out.reserve(nlit);
      std::memcpy(out.p + out.n, lit, nlit);
      out.n += nlit;
      return;
    }
    if (h >= n) fail("sequences header truncated");
    uint8_t modes = p[h++];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    h += table(kLL, modes >> 6, p + h, n - h);
    h += table(kOF, (modes >> 4) & 3, p + h, n - h);
    h += table(kML, (modes >> 2) & 3, p + h, n - h);
    if (h >= n) fail("sequences bitstream missing");
    BackBits br(p + h, n - h);
    const FseTable &tl = fs.tables[kLL], &to = fs.tables[kOF],
                   &tm = fs.tables[kML];
    uint32_t sl = uint32_t(br.get(tl.log)), so = uint32_t(br.get(to.log)),
             sm = uint32_t(br.get(tm.log));
    uint64_t* rep = fs.rep;
    size_t li = 0;
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry &el = tl.t[sl], &eo = to.t[so], &em = tm.t[sm];
      int ocode = eo.symbol;
      uint64_t ov = (1ull << ocode) + br.get(ocode);
      uint64_t ml = kMLBase[em.symbol] + br.get(kMLBits[em.symbol]);
      uint64_t ll = kLLBase[el.symbol] + br.get(kLLBits[el.symbol]);
      uint64_t off;
      if (ov > 3) {
        off = ov - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        int idx = int(ov) - 1 + (ll == 0);
        if (idx == 0) {
          off = rep[0];
        } else {
          off = idx == 3 ? rep[0] - 1 : rep[idx];
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      if (i + 1 < nseq) {
        sl = el.base + uint32_t(br.get(el.bits));
        sm = em.base + uint32_t(br.get(em.bits));
        so = eo.base + uint32_t(br.get(eo.bits));
      }
      if (br.overflowed()) fail("sequences bitstream overrun");
      if (ll > nlit - li) fail("sequence reads past the literals");
      if (out.n - out0 + ll + ml > kMaxBlock) fail("block output too large");
      out.reserve(ll + ml);
      std::memcpy(out.p + out.n, lit + li, ll);
      out.n += ll;
      li += ll;
      if (off == 0 || off > out.n - frame_start)
        fail("match offset outside the frame");
      uint8_t* d = out.p + out.n;
      const uint8_t* s = d - off;
      if (off >= ml) {
        std::memcpy(d, s, ml);
      } else {
        for (uint64_t k = 0; k < ml; ++k) d[k] = s[k];
      }
      out.n += ml;
    }
    if (!br.finished()) fail("sequences bitstream not consumed exactly");
    size_t rest = nlit - li;
    if (out.n - out0 + rest > kMaxBlock) fail("block output too large");
    out.reserve(rest);
    std::memcpy(out.p + out.n, lit + li, rest);
    out.n += rest;
  }

  // Decodes one frame starting at p (after its magic); returns the bytes
  // read from p.
  size_t frame(const uint8_t* p, size_t n) {
    if (n < 1) fail("frame header truncated");
    uint8_t fhd = p[0];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
        did_flag = fhd & 3;
    if (fhd & 8) fail("reserved bit set in the frame header");
    size_t pos = 1;
    if (!single) {
      if (pos >= n) fail("frame header truncated");
      int wd = p[pos++];
      if ((wd >> 3) + 10 > 41) fail("window too large");
    }
    static const int kDid[4] = {0, 1, 2, 4};
    int dsize = kDid[did_flag];
    if (pos + size_t(dsize) > n) fail("frame header truncated");
    if (dsize && load_le(p + pos, dsize) != 0)
      fail("dictionary frames are not supported");
    pos += size_t(dsize);
    int fsize = fcs_flag == 0 ? single : (1 << fcs_flag);
    if (pos + size_t(fsize) > n) fail("frame header truncated");
    bool has_size = fsize > 0;
    uint64_t content = 0;
    if (fsize == 1) content = p[pos];
    else if (fsize == 2) content = load_le(p + pos, 2) + 256;
    else if (fsize == 4) content = load_le(p + pos, 4);
    else if (fsize == 8) content = load_le64(p + pos);
    pos += size_t(fsize);

    fs = FrameState();
    size_t frame_start = out.n;
    if (has_size && out.grow) out.reserve(size_t(std::min<uint64_t>(
                                  content, uint64_t(1) << 30)));
    for (;;) {
      if (pos + 3 > n) fail("block header truncated");
      uint32_t bh = load_le(p + pos, 3);
      pos += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail("reserved block type");
      if (size > kMaxBlock) fail("block larger than 128 KiB");
      if (type == 0) {
        if (pos + size > n) fail("raw block truncated");
        out.reserve(size);
        std::memcpy(out.p + out.n, p + pos, size);
        out.n += size;
        pos += size;
      } else if (type == 1) {
        if (pos + 1 > n) fail("RLE block truncated");
        out.reserve(size);
        std::memset(out.p + out.n, p[pos], size);
        out.n += size;
        pos += 1;
      } else {
        if (pos + size > n) fail("compressed block truncated");
        block(p + pos, size, frame_start);
        pos += size;
      }
      if (has_size && out.n - frame_start > content)
        fail("frame larger than its content size");
      if (last) break;
    }
    if (has_size && out.n - frame_start != content)
      fail("frame size differs from its content size");
    if (checksum) {
      if (pos + 4 > n) fail("content checksum truncated");
      uint32_t want = load_le(p + pos, 4);
      uint32_t got =
          uint32_t(xxh64(out.p + frame_start, out.n - frame_start));
      if (want != got) fail("content checksum mismatch");
      pos += 4;
    }
    return pos;
  }

  void run(const uint8_t* p, size_t n) {
    if (n == 0) fail("no zstd frame in empty input");
    size_t pos = 0;
    while (pos < n) {
      if (n - pos < 4) fail("truncated frame magic");
      uint32_t magic = load_le(p + pos, 4);
      if ((magic & kSkippableMask) == kSkippableMagic) {
        if (n - pos < 8) fail("skippable frame truncated");
        size_t size = load_le(p + pos + 4, 4);
        if (size > n - pos - 8) fail("skippable frame truncated");
        pos += 8 + size;
      } else if (magic == kFrameMagic) {
        pos += 4;
        pos += frame(p + pos, n - pos);
      } else {
        fail("not a zstd frame (bad magic)");
      }
    }
  }
};

void set_msg(char* msg, int32_t cap, const char* text) {
  if (msg && cap > 0) {
    std::strncpy(msg, text, size_t(cap) - 1);
    msg[cap - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decodes every frame of src into dst (capacity cap); *out_len is the
// decoded size. Returns 0, or -1 with a message in msg.
int32_t epic_zstd_decode_into(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap, int64_t* out_len, char* msg,
                              int32_t msg_cap) {
  Decoder d;
  d.out.p = dst;
  d.out.cap = size_t(cap);
  try {
    d.run(src, size_t(n));
  } catch (const std::exception& e) {
    set_msg(msg, msg_cap, e.what());
    return -1;
  }
  *out_len = int64_t(d.out.n);
  return 0;
}

// Decodes every frame of src into a buffer it allocates (*out, freed with
// epic_zstd_free). Returns 0, or -1 with a message in msg.
int32_t epic_zstd_decode(const uint8_t* src, int64_t n, uint8_t** out,
                         int64_t* out_len, char* msg, int32_t msg_cap) {
  Decoder d;
  d.out.grow = true;
  try {
    d.run(src, size_t(n));
  } catch (const std::exception& e) {
    std::free(d.out.p);
    set_msg(msg, msg_cap, e.what());
    return -1;
  }
  *out = d.out.p;
  *out_len = int64_t(d.out.n);
  return 0;
}

void epic_zstd_free(uint8_t* p) { std::free(p); }

}  // extern "C"
