// Host JPEG decoder with a plain C interface (bound with ctypes in
// data/jpeg.py).
//
// Its output is what Pillow's Image.open(path).convert("RGB") gives on a
// Pillow built on libjpeg-turbo (default decompression settings: the
// integer "islow" IDCT, fancy upsampling, block smoothing on), bit for bit.
// It follows libjpeg-turbo's C paths:
//   - markers: SOI, APPn (JFIF and Adobe read, the rest skipped), COM, DQT
//     (8- and 16-bit tables), SOF0 / SOF1 / SOF2, DHT, DRI with RSTn, SOS,
//     EOI; quantisation tables latched at a component's first scan
//     (jdinput.c); the standard Huffman tables (jstdhuff.c) in slots 0 and
//     1 that no DHT segment defined by the first scan;
//   - Huffman entropy decoding, sequential (jdhuff.c) and progressive
//     (jdphuff.c: DC first / refine, AC first / refine, EOB runs),
//     coefficients kept as 16-bit JCOEFs;
//   - block smoothing of progressive files whose scans leave some of the
//     first nine AC coefficients incomplete (jdcoefct.c
//     decompress_smooth_data, libjpeg-turbo 3.1's 5x5 DC window);
//   - dequantisation and the islow IDCT of jidctint.c with its range-limit
//     table (jdmaster.c);
//   - upsampling of jdsample.c: the "fancy" triangle filters h2v1, h2v2
//     and h1v2 with their rounding biases, replication otherwise; edge
//     rows and columns are the component's last real ones (jdmainct.c);
//   - colour conversion of jdcolor.c: YCbCr -> RGB with its fixed-point
//     tables, RGB copied, YCCK -> CMYK; then Pillow's own steps: grey is
//     repeated over three channels, CMYK is read inverted ("CMYK;I") and
//     converted by Pillow's cmyk2rgb.
// Refused with an error naming the feature: arithmetic coding, lossless
// and hierarchical frames, sample precision other than 8 bits, 2-component
// frames and data that ends before EOI.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  int code;
  JpegError(int c, const std::string& m) : std::runtime_error(m), code(c) {}
};

// error codes returned through the C interface
enum : int {
  kErrCorrupt = -1,      // malformed or unsupported structure
  kErrUnsupported = -2,  // a feature this decoder refuses
  kErrTruncated = -3,    // the data ends before EOI
};

[[noreturn]] void fail(int code, const std::string& m) {
  throw JpegError(code, m);
}

// zigzag index -> natural index, padded with 63s as libjpeg's table is, so
// that a corrupt run past the block's end lands on the last coefficient
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // next kLookBits bits -> (code length << 8) | symbol; length 0 = longer
  uint16_t look[1 << kLookBits];

  void build(const uint8_t* counts, const uint8_t* symbols, bool is_dc) {
    // jdhuff.c jpeg_make_d_derived_tbl
    int total = 0;
    for (int l = 1; l <= 16; l++) total += counts[l - 1];
    if (total > 256) fail(kErrCorrupt, "bad Huffman table");
    std::memcpy(vals, symbols, total);
    std::memset(vals + total, 0, 256 - total);
    uint8_t size[257];
    uint32_t codes[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l - 1]; i++) size[p++] = uint8_t(l);
    size[p] = 0;
    uint32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) codes[p++] = code++;
      if (code >= (1u << si)) fail(kErrCorrupt, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l - 1]) {
        valoffset[l] = p - int32_t(codes[p]);
        p += counts[l - 1];
        maxcode[l] = int32_t(codes[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 1; i <= counts[l - 1]; i++, p++) {
        int lookbits = int(codes[p]) << (kLookBits - l);
        for (int c = 1 << (kLookBits - l); c > 0; c--)
          look[lookbits++] = uint16_t((l << 8) | vals[p]);
      }
    }
    if (is_dc)
      for (int i = 0; i < total; i++)
        if (vals[i] > 15) fail(kErrCorrupt, "bad DC Huffman table");
    defined = true;
  }
};

// jstdhuff.c: the standard tables of the JPEG standard's Annex K.3, which
// libjpeg-turbo installs in slots 0 (luminance) and 1 (chrominance) that no
// DHT segment has defined by the first scan (Motion JPEG omits them)
const uint8_t kStdDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                   1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                   5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                     7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Entropy-coded data as jdhuff.c's fill_bit_buffer reads it: 0xFF00 is a
// 0xFF byte, a marker stops the data and zeros are supplied after it.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;  // pos is at the 0xFF of a marker
  bool eof = false;        // the data ended inside the entropy-coded segment

  void reset(const uint8_t* data, size_t size, size_t start) {
    d = data;
    n = size;
    pos = start;
    buf = 0;
    cnt = 0;
    at_marker = false;
    eof = false;
  }

  void fill() {
    while (cnt <= 56) {
      uint32_t c = 0;
      if (!at_marker) {
        if (pos >= n) {
          eof = true;
          at_marker = true;
        } else {
          c = d[pos];
          if (c == 0xFF) {
            size_t q = pos + 1;
            while (q < n && d[q] == 0xFF) q++;
            if (q >= n) {
              eof = true;
              at_marker = true;
              c = 0;
            } else if (d[q] == 0) {
              pos = q + 1;
            } else {
              pos = q - 1;  // the 0xFF just before the marker code
              at_marker = true;
              c = 0;
            }
          } else {
            pos++;
          }
        }
      }
      buf |= uint64_t(c) << (56 - cnt);
      cnt += 8;
    }
  }

  inline int bits(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = int(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }

  inline int bit() { return bits(1); }

  inline int decode(const HuffTable& t) {
    if (cnt < 17) fill();
    int look = int(buf >> (64 - kLookBits));
    int e = t.look[look];
    if (e) {
      int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    int l = kLookBits + 1;
    int code = int(buf >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = int(buf >> (64 - l));
    }
    if (l > 16) {  // jdhuff.c: 17 bits read, a bad code decodes as 0
      buf <<= 17;
      cnt -= 17;
      return 0;
    }
    buf <<= l;
    cnt -= l;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  // drops the buffered bits, as process_restart does
  void discard() {
    buf = 0;
    cnt = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + int((~0u) << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // blocks that hold image samples
  int bw = 0, bh = 0;    // allocated blocks (padded to whole MCUs)
  int dsw = 0, dsh = 0;  // downsampled width and height in samples
  std::vector<int16_t> coef;
  bool latched = false;
  int16_t q[64] = {0};  // natural order, as libjpeg's short multipliers
  int coef_bits[64];
  int dc_tbl = 0, ac_tbl = 0;
  int dc_pred = 0;
  int16_t* block(int bx, int by) {
    return coef.data() + (size_t(by) * bw + bx) * 64;
  }
};

// ----------------------------------------------------------------- IDCT

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// jdmaster.c prepare_range_limit_table, the post-IDCT part: a sample
// x & 1023 read as a signed 10-bit value, plus 128, clamped to 0..255
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; x++) {
      int v = (x < 512 ? x : x - 1024) + 128;
      idct[x] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = int(ip[0]) * int(qp[0]) * (1 << kPass1Bits);
      for (int k = 0; k < 8; k++) wp[8 * k] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16];
    int64_t z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, sh));
    wp[56] = int(descale(tmp10 - tmp3, sh));
    wp[8] = int(descale(tmp11 + tmp2, sh));
    wp[48] = int(descale(tmp11 - tmp2, sh));
    wp[16] = int(descale(tmp12 + tmp1, sh));
    wp[40] = int(descale(tmp12 - tmp1, sh));
    wp[24] = int(descale(tmp13 + tmp0, sh));
    wp[32] = int(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + size_t(r) * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = kRange.idct[int(descale(wp[0], kPass1Bits + 3)) & 1023];
      for (int k = 0; k < 8; k++) op[k] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.idct[int(descale(tmp10 + tmp3, sh)) & 1023];
    op[7] = kRange.idct[int(descale(tmp10 - tmp3, sh)) & 1023];
    op[1] = kRange.idct[int(descale(tmp11 + tmp2, sh)) & 1023];
    op[6] = kRange.idct[int(descale(tmp11 - tmp2, sh)) & 1023];
    op[2] = kRange.idct[int(descale(tmp12 + tmp1, sh)) & 1023];
    op[5] = kRange.idct[int(descale(tmp12 - tmp1, sh)) & 1023];
    op[3] = kRange.idct[int(descale(tmp13 + tmp0, sh)) & 1023];
    op[4] = kRange.idct[int(descale(tmp13 - tmp0, sh)) & 1023];
  }
}

// ------------------------------------------------------ colour conversion

constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t(1) << (kScaleBits - 1);
inline int64_t fix(double x) {
  return int64_t(x * double(int64_t(1) << kScaleBits) + 0.5);
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = int((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// Pillow Convert.c cmyk2rgb on "CMYK;I"-unpacked samples
inline uint8_t cmyk_channel(int c, int nk) {
  int tmp = c * nk + 128;
  int m = ((tmp >> 8) + tmp) >> 8;
  return clamp255(nk - m);
}

// ---------------------------------------------------------------- decoder

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int16_t qt[4][64];
  bool qt_def[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  bool have_frame = false, progressive = false;
  int width = 0, height = 0, maxh = 1, maxv = 1;
  int mcus_x = 0, mcus_y = 0;
  std::vector<Component> comps;
  int scans = 0;
  BitReader br;
  int eobrun = 0;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail(kErrTruncated, "truncated data (file ends inside a marker)");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // jdmarker.c next_marker: skips garbage, then 0xFF fill bytes
  int next_marker() {
    for (;;) {
      if (pos >= n) fail(kErrTruncated, "truncated data (no EOI marker)");
      int c = d[pos++];
      if (c != 0xFF) continue;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) fail(kErrTruncated, "truncated data (no EOI marker)");
      c = d[pos++];
      if (c != 0) return c;
    }
  }

  void skip_segment() {
    int len = u16();
    if (len < 2) fail(kErrCorrupt, "bad marker length");
    if (pos + size_t(len - 2) > n)
      fail(kErrTruncated, "truncated data (file ends inside a marker)");
    pos += size_t(len - 2);
  }

  void read_app(int marker) {
    int len = u16();
    if (len < 2) fail(kErrCorrupt, "bad marker length");
    size_t end = pos + size_t(len - 2);
    if (end > n) fail(kErrTruncated, "truncated data (file ends inside a marker)");
    const uint8_t* p = d + pos;
    size_t dl = size_t(len - 2);
    // jdmarker.c examine_app0 / examine_app14
    if (marker == 0xE0 && dl >= 14 && std::memcmp(p, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && dl >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq_tq = u8();
      len--;
      int prec = pq_tq >> 4, t = pq_tq & 15;
      if (t > 3) fail(kErrCorrupt, "bad quantization table index");
      for (int i = 0; i < 64; i++) {
        int v = prec ? u16() : u8();
        qt[t][kNatural[i]] = int16_t(v);
      }
      len -= prec ? 128 : 64;
      qt_def[t] = true;
    }
    if (len != 0) fail(kErrCorrupt, "bad DQT marker length");
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 16) {
      int idx = u8();
      uint8_t counts[16], syms[256];
      int total = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = uint8_t(u8());
        total += counts[i];
      }
      len -= 17;
      if (total > 256 || total > len) fail(kErrCorrupt, "bad Huffman table");
      for (int i = 0; i < total; i++) syms[i] = uint8_t(u8());
      len -= total;
      int cls = idx >> 4, t = idx & 15;
      if (t > 3 || cls > 1) fail(kErrCorrupt, "bad Huffman table index");
      (cls ? ac[t] : dc[t]).build(counts, syms, cls == 0);
    }
    if (len != 0) fail(kErrCorrupt, "bad DHT marker length");
  }

  void read_sof(int marker) {
    if (have_frame) fail(kErrCorrupt, "more than one frame");
    int len = u16();
    int prec = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (len != 8 + 3 * nc) fail(kErrCorrupt, "bad SOF marker length");
    if (prec != 8)
      fail(kErrUnsupported, std::to_string(prec) + "-bit samples");
    if (height == 0)
      fail(kErrUnsupported, "a zero height (DNL marker)");
    if (width == 0) fail(kErrCorrupt, "empty image");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(kErrUnsupported, std::to_string(nc) + "-component frames");
    progressive = marker == 0xC2;
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail(kErrCorrupt, "bad sampling factors");
      if (c.tq > 3) fail(kErrCorrupt, "bad quantization table index");
      maxh = std::max(maxh, c.h);
      maxv = std::max(maxv, c.v);
    }
    mcus_x = (width + 8 * maxh - 1) / (8 * maxh);
    mcus_y = (height + 8 * maxv - 1) / (8 * maxv);
    for (auto& c : comps) {
      c.wib = int((int64_t(width) * c.h + 8 * maxh - 1) / (8 * maxh));
      c.hib = int((int64_t(height) * c.v + 8 * maxv - 1) / (8 * maxv));
      c.dsw = int((int64_t(width) * c.h + maxh - 1) / maxh);
      c.dsh = int((int64_t(height) * c.v + maxv - 1) / maxv);
      c.bw = std::max(mcus_x * c.h, c.wib);
      c.bh = std::max(mcus_y * c.v, c.hib);
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  // -------------------------------------------------------------- scans

  void decode_block_sequential(Component& c, int16_t* b) {
    const HuffTable& dct = dc[c.dc_tbl];
    const HuffTable& act = ac[c.ac_tbl];
    int s = br.decode(dct);
    if (s) s = extend(br.bits(s), s);
    c.dc_pred += s;
    b[0] = int16_t(c.dc_pred);
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        b[kNatural[k]] = int16_t(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(Component& c, int16_t* b, int al) {
    int s = br.decode(dc[c.dc_tbl]);
    if (s) s = extend(br.bits(s), s);
    c.dc_pred += s;
    b[0] = int16_t(int(unsigned(c.dc_pred) << al));
  }

  void decode_dc_refine(int16_t* b, int al) {
    if (br.bit()) b[0] = int16_t(b[0] | (1 << al));
  }

  void decode_ac_first(Component& c, int16_t* b, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const HuffTable& t = ac[c.ac_tbl];
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        s = extend(br.bits(s), s);
        b[kNatural[k]] = int16_t(int(unsigned(s) << al));
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          eobrun--;
          break;
        }
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine
  void decode_ac_refine(Component& c, int16_t* b, int ss, int se, int al) {
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      const HuffTable& t = ac[c.ac_tbl];
      for (; k <= se; k++) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = b + kNatural[k];
          if (*coef != 0) {
            if (br.bit()) {
              if ((*coef & p1) == 0)
                *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) b[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = b + kNatural[k];
        if (*coef != 0 && br.bit()) {
          if ((*coef & p1) == 0)
            *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
        }
      }
      eobrun--;
    }
  }

  // jdhuff.c / jdmarker.c process_restart + read_restart_marker
  void restart(int& expected) {
    br.discard();
    size_t p = br.pos;
    // skip to the next marker as next_marker does
    for (;;) {
      if (p >= n) fail(kErrTruncated, "truncated data (inside a scan)");
      if (d[p] == 0xFF) {
        size_t q = p + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q >= n) fail(kErrTruncated, "truncated data (inside a scan)");
        if (d[q] != 0) {
          if (d[q] != 0xD0 + expected)
            fail(kErrCorrupt, "restart marker out of sequence");
          p = q + 1;
          break;
        }
        p = q + 1;
      } else {
        p++;
      }
    }
    expected = (expected + 1) & 7;
    br.reset(d, n, p);
    eobrun = 0;
    for (auto& c : comps) c.dc_pred = 0;
  }

  void read_sos() {
    if (!have_frame) fail(kErrCorrupt, "SOS before SOF");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns)
      fail(kErrCorrupt, "bad SOS marker");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = u8(), tt = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail(kErrCorrupt, "scan names an unknown component");
      found->dc_tbl = tt >> 4;
      found->ac_tbl = tt & 15;
      if (found->dc_tbl > 3 || found->ac_tbl > 3)
        fail(kErrCorrupt, "bad Huffman table index");
      sc.push_back(found);
    }
    if (ns > 1) {  // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (Component* c : sc) blocks += c->h * c->v;
      if (blocks > 10) fail(kErrCorrupt, "an MCU of more than 10 blocks");
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (!progressive) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else {
      // jdphuff.c start_pass_phuff_decoder
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (se < ss || se > 63 || ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(kErrCorrupt, "bad progressive scan parameters");
      for (Component* c : sc) {
        for (int k = ss; k <= se; k++) {
          // libjpeg warns about a refinement of a never-sent coefficient
          // and decodes on; so does this decoder
          c->coef_bits[k] = al;
        }
      }
    }
    if (scans == 0) {  // jdhuff.c / jdphuff.c: std_huff_tables
      if (!dc[0].defined) dc[0].build(kStdDcLumBits, kStdDcVals, true);
      if (!dc[1].defined) dc[1].build(kStdDcChromBits, kStdDcVals, true);
      if (!ac[0].defined) ac[0].build(kStdAcLumBits, kStdAcLumVals, false);
      if (!ac[1].defined) ac[1].build(kStdAcChromBits, kStdAcChromVals, false);
    }
    for (Component* c : sc) {
      if (!c->latched) {
        if (!qt_def[c->tq])
          fail(kErrCorrupt, "quantization table not defined");
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss > 0;
      if ((need_dc && !dc[c->dc_tbl].defined) ||
          (need_ac && !ac[c->ac_tbl].defined))
        fail(kErrCorrupt, "a scan without its Huffman table");
      c->dc_pred = 0;
    }
    eobrun = 0;
    br.reset(d, n, pos);
    scans++;

    auto do_block = [&](Component& c, int16_t* b) {
      if (!progressive) {
        decode_block_sequential(c, b);
      } else if (ss == 0) {
        if (ah == 0)
          decode_dc_first(c, b, al);
        else
          decode_dc_refine(b, al);
      } else if (ah == 0) {
        decode_ac_first(c, b, ss, se, al);
      } else {
        decode_ac_refine(c, b, ss, se, al);
      }
    };

    int expected_rst = 0;
    int left = restart_interval;
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.hib; by++) {
        for (int bx = 0; bx < c.wib; bx++) {
          if (restart_interval && left == 0) {
            restart(expected_rst);
            left = restart_interval;
          }
          do_block(c, c.block(bx, by));
          if (restart_interval) left--;
        }
      }
    } else {
      for (int my = 0; my < mcus_y; my++) {
        for (int mx = 0; mx < mcus_x; mx++) {
          if (restart_interval && left == 0) {
            restart(expected_rst);
            left = restart_interval;
          }
          for (Component* cp : sc) {
            Component& c = *cp;
            for (int y = 0; y < c.v; y++)
              for (int x = 0; x < c.h; x++)
                do_block(c, c.block(mx * c.h + x, my * c.v + y));
          }
          if (restart_interval) left--;
        }
      }
    }
    if (br.eof) fail(kErrTruncated, "truncated data (inside a scan)");
    // continue at the marker that ends the scan (next_marker skips any
    // bytes left before it)
    pos = br.pos;
  }

  void parse() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8)
      fail(kErrCorrupt, "not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xFE || m == 0xDC) {
        skip_segment();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDD) {
        int len = u16();
        if (len != 4) fail(kErrCorrupt, "bad DRI marker length");
        restart_interval = u16();
      } else if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m);
      } else if (m == 0xC3) {
        fail(kErrUnsupported, "lossless JPEG (SOF3)");
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xDE ||
                 m == 0xDF) {
        fail(kErrUnsupported, "hierarchical JPEG frames");
      } else if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCC ||
                 m == 0xCD || m == 0xCE || m == 0xCF) {
        fail(kErrUnsupported, "arithmetic coding");
      } else if (m == 0xDA) {
        read_sos();
      } else if (m == 0xD9) {
        break;
      } else if (m >= 0xD0 && m <= 0xD7) {
        // a parameterless marker outside a scan: libjpeg ignores it
      } else if (m == 0xD8) {
        fail(kErrCorrupt, "duplicate SOI marker");
      } else if (m == 0x01) {
        // TEM: parameterless
      } else {
        fail(kErrCorrupt, "unknown marker");
      }
    }
    if (!have_frame) fail(kErrCorrupt, "no SOF marker");
    if (scans == 0) fail(kErrCorrupt, "no scan");
  }

  // ------------------------------------------------------------- output

  // jdcoefct.c smoothing_ok: libjpeg-turbo smooths the blocks of a
  // progressive file when a component's DC is known and one of its first
  // nine AC coefficients is still incomplete
  bool smoothing_ok() const {
    if (!progressive) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const auto& c : comps) {
      if (!c.latched) return false;
      for (int i = 0; i < 10; i++)
        if (c.q[kPos[i]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void idct_plane(Component& c, std::vector<uint8_t>& plane, int& stride,
                  bool smooth) {
    stride = c.wib * 8;
    plane.assign(size_t(stride) * c.hib * 8, 0);
    if (smooth) {
      smooth_plane(c, plane.data(), stride);
      return;
    }
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(c.block(bx, by), c.q,
                   plane.data() + size_t(by) * 8 * stride + bx * 8, stride);
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.1), after the whole
  // file is read: each block's zero coefficients among the first nine AC
  // that its scans left incomplete are estimated from the DC values of the
  // 5x5 blocks around it (the coefficients' Al bounds the estimate); when
  // no AC coefficient was sent at all the DC is interpolated as well. The
  // neighbours' rows follow libjpeg's iMCU-row bookkeeping, quirks and all:
  // on the last iMCU row, whether a row above or below exists is judged by
  // that row's own block count.
  void smooth_plane(Component& c, uint8_t* plane, int stride) {
    const int* cb = c.coef_bits;
    const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 &&
                           cb[4] == -1 && cb[5] == -1 && cb[6] == -1 &&
                           cb[7] == -1 && cb[8] == -1 && cb[9] == -1;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                  Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                  Q21 = c.q[17], Q30 = c.q[24];
    auto estimate = [](int al, int64_t q, int64_t num, bool clamp) {
      int pred;
      if (num >= 0) {
        pred = int(((q << 7) + num) / (q << 8));
        if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = int(((q << 7) - num) / (q << 8));
        if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return int16_t(pred);
    };
    const int R = mcus_y, v = c.v, last_col = c.wib - 1;
    int16_t ws[64];
    for (int r = 0; r < R; r++) {
      int block_rows = v;
      if (r == R - 1) {
        block_rows = c.hib % v;
        if (block_rows == 0) block_rows = v;
      }
      const int image_block_rows = block_rows * R;
      for (int br = 0; br < block_rows; br++) {
        const int row = r * v + br;
        const int ibr = r * block_rows + br;
        const int prev = ibr > 0 ? row - 1 : row;
        const int pprev = ibr > 1 ? row - 2 : prev;
        const int next = ibr < image_block_rows - 1 ? row + 1 : row;
        const int nnext = ibr < image_block_rows - 2 ? row + 2 : next;
        if (pprev < 0 || nnext >= c.bh || row >= c.hib)
          fail(kErrCorrupt, "block smoothing outside the coefficients");
        auto dcv = [&](int rr, int col) { return int(c.block(col, rr)[0]); };
        int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11,
            DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22,
            DC23, DC24, DC25;
        DC01 = DC02 = DC03 = DC04 = DC05 = dcv(pprev, 0);
        DC06 = DC07 = DC08 = DC09 = DC10 = dcv(prev, 0);
        DC11 = DC12 = DC13 = DC14 = DC15 = dcv(row, 0);
        DC16 = DC17 = DC18 = DC19 = DC20 = dcv(next, 0);
        DC21 = DC22 = DC23 = DC24 = DC25 = dcv(nnext, 0);
        for (int bn = 0; bn <= last_col; bn++) {
          std::memcpy(ws, c.block(bn, row), sizeof(ws));
          if (bn == 0 && bn < last_col) {
            DC04 = DC05 = dcv(pprev, 1);
            DC09 = DC10 = dcv(prev, 1);
            DC14 = DC15 = dcv(row, 1);
            DC19 = DC20 = dcv(next, 1);
            DC24 = DC25 = dcv(nnext, 1);
          }
          if (bn + 1 < last_col) {
            DC05 = dcv(pprev, bn + 2);
            DC10 = dcv(prev, bn + 2);
            DC15 = dcv(row, bn + 2);
            DC20 = dcv(next, bn + 2);
            DC25 = dcv(nnext, bn + 2);
          }
          int al;
          int64_t num;
          if ((al = cb[1]) != 0 && ws[1] == 0) {  // AC01
            num = Q00 * (change_dc
                             ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                                13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                                38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                                13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 -
                                DC22 + DC24 + DC25)
                             : (-7 * DC11 + 50 * DC12 - 50 * DC14 +
                                7 * DC15));
            ws[1] = estimate(al, Q01, num, true);
          }
          if ((al = cb[2]) != 0 && ws[8] == 0) {  // AC10
            num = Q00 * (change_dc
                             ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 -
                                DC05 - DC06 + 13 * DC07 + 38 * DC08 +
                                13 * DC09 - DC10 + DC16 - 13 * DC17 -
                                38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                             : (-7 * DC03 + 50 * DC08 - 50 * DC18 +
                                7 * DC23));
            ws[8] = estimate(al, Q10, num, true);
          }
          if ((al = cb[3]) != 0 && ws[16] == 0) {  // AC20
            num = Q00 * (change_dc
                             ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                                5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                                7 * DC18 + 2 * DC19 + DC23)
                             : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                                DC23));
            ws[16] = estimate(al, Q20, num, true);
          }
          if ((al = cb[4]) != 0 && ws[9] == 0) {  // AC11
            num = Q00 * (change_dc
                             ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 -
                                9 * DC17 + 9 * DC19 + DC21 - DC25)
                             : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 -
                                DC20 + DC22 - DC24 + DC04 - DC06 +
                                10 * DC07 - 10 * DC09));
            ws[9] = estimate(al, Q11, num, true);
          }
          if ((al = cb[5]) != 0 && ws[2] == 0) {  // AC02
            num = Q00 * (change_dc
                             ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                                7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                                2 * DC17 - 5 * DC18 + 2 * DC19)
                             : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                                DC15));
            ws[2] = estimate(al, Q02, num, true);
          }
          if (change_dc) {
            if ((al = cb[6]) != 0 && ws[3] == 0) {  // AC03
              num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
              ws[3] = estimate(al, Q03, num, true);
            }
            if ((al = cb[7]) != 0 && ws[10] == 0) {  // AC12
              num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
              ws[10] = estimate(al, Q12, num, true);
            }
            if ((al = cb[8]) != 0 && ws[17] == 0) {  // AC21
              num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
              ws[17] = estimate(al, Q21, num, true);
            }
            if ((al = cb[9]) != 0 && ws[24] == 0) {  // AC30
              num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
              ws[24] = estimate(al, Q30, num, true);
            }
            num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 -
                         2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                         6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                         152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                         6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                         2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                         2 * DC25);
            ws[0] = estimate(0, Q00, num, false);
          }
          idct_islow(ws, c.q, plane + size_t(row) * 8 * stride + bn * 8,
                     stride);
          DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
          DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
          DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
          DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
          DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
        }
      }
    }
  }

  // jdsample.c: the component plane -> width x height samples
  std::vector<uint8_t> upsample(const Component& c,
                                const std::vector<uint8_t>& in, int stride) {
    const int W = width, H = height;
    std::vector<uint8_t> out(size_t(W) * H);
    const int he = maxh / c.h, ve = maxv / c.v;
    if (maxh % c.h || maxv % c.v)
      fail(kErrUnsupported, "fractional sampling factors");
    const int dw = c.dsw, dh = c.dsh;
    auto row = [&](int r) {
      r = r < 0 ? 0 : r >= dh ? dh - 1 : r;
      return in.data() + size_t(r) * stride;
    };
    if (he == 1 && ve == 1) {
      for (int y = 0; y < H; y++) std::memcpy(&out[size_t(y) * W], row(y), W);
    } else if (he == 2 && ve == 1 && dw > 2) {
      // h2v1_fancy_upsample
      for (int y = 0; y < H; y++) {
        const uint8_t* ip = row(y);
        uint8_t* op = &out[size_t(y) * W];
        for (int x = 0; x < W; x++) {
          int j = x >> 1;
          int cur = ip[j] * 3;
          if (x & 1) {
            int nx = ip[j + 1 < dw ? j + 1 : dw - 1];
            op[x] = uint8_t((cur + nx + 2) >> 2);
          } else {
            int pv = ip[j > 0 ? j - 1 : 0];
            op[x] = uint8_t((cur + pv + 1) >> 2);
          }
        }
      }
    } else if (he == 1 && ve == 2) {
      // h1v2_fancy_upsample
      for (int y = 0; y < H; y++) {
        int r = y >> 1;
        const uint8_t* near = row(r);
        const uint8_t* far = row((y & 1) ? r + 1 : r - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t* op = &out[size_t(y) * W];
        for (int x = 0; x < W; x++)
          op[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
      }
    } else if (he == 2 && ve == 2 && dw > 2) {
      // h2v2_fancy_upsample
      std::vector<int> cs(dw);
      for (int y = 0; y < H; y++) {
        int r = y >> 1;
        const uint8_t* near = row(r);
        const uint8_t* far = row((y & 1) ? r + 1 : r - 1);
        for (int j = 0; j < dw; j++) cs[j] = near[j] * 3 + far[j];
        uint8_t* op = &out[size_t(y) * W];
        for (int x = 0; x < W; x++) {
          int j = x >> 1;
          int t = cs[j] * 3;
          if (x & 1)
            op[x] = uint8_t((t + cs[j + 1 < dw ? j + 1 : dw - 1] + 7) >> 4);
          else
            op[x] = uint8_t((t + cs[j > 0 ? j - 1 : 0] + 8) >> 4);
        }
      }
    } else {
      // h2v1_upsample / h2v2_upsample / int_upsample: replication
      for (int y = 0; y < H; y++) {
        const uint8_t* ip = row(y / ve);
        uint8_t* op = &out[size_t(y) * W];
        for (int x = 0; x < W; x++) op[x] = ip[x / he];
      }
    }
    return out;
  }

  void render(uint8_t* rgb) {
    const bool smooth = smoothing_ok();
    const size_t np = size_t(width) * height;
    std::vector<std::vector<uint8_t>> full(comps.size());
    for (size_t i = 0; i < comps.size(); i++) {
      std::vector<uint8_t> plane;
      int stride = 0;
      idct_plane(comps[i], plane, stride, smooth);
      full[i] = upsample(comps[i], plane, stride);
    }
    const int nc = int(comps.size());
    if (nc == 1) {
      const uint8_t* g = full[0].data();
      for (size_t p = 0; p < np; p++)
        rgb[3 * p] = rgb[3 * p + 1] = rgb[3 * p + 2] = g[p];
      return;
    }
    // jdapimin.c default_decompress_parms
    bool ycc;
    if (nc == 3) {
      if (jfif) {
        ycc = true;
      } else if (adobe) {
        ycc = adobe_transform != 0;
      } else {
        bool rgb_ids = comps[0].id == 82 && comps[1].id == 71 &&
                       comps[2].id == 66;
        ycc = !rgb_ids;
      }
    } else {
      ycc = adobe && adobe_transform != 0;
    }
    const uint8_t *c0 = full[0].data(), *c1 = full[1].data(),
                  *c2 = full[2].data();
    if (nc == 3) {
      for (size_t p = 0; p < np; p++) {
        if (ycc) {
          int y = c0[p], cb = c1[p], cr = c2[p];
          rgb[3 * p] = clamp255(y + kYcc.cr_r[cr]);
          rgb[3 * p + 1] = clamp255(
              y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> kScaleBits));
          rgb[3 * p + 2] = clamp255(y + kYcc.cb_b[cb]);
        } else {
          rgb[3 * p] = c0[p];
          rgb[3 * p + 1] = c1[p];
          rgb[3 * p + 2] = c2[p];
        }
      }
      return;
    }
    const uint8_t* c3 = full[3].data();
    for (size_t p = 0; p < np; p++) {
      int cc, mm, yy;
      if (ycc) {  // jdcolor.c ycck_cmyk_convert
        int y = c0[p], cb = c1[p], cr = c2[p];
        cc = clamp255(255 - (y + kYcc.cr_r[cr]));
        mm = clamp255(
            255 - (y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> kScaleBits)));
        yy = clamp255(255 - (y + kYcc.cb_b[cb]));
      } else {
        cc = c0[p];
        mm = c1[p];
        yy = c2[p];
      }
      // Pillow reads CMYK JPEG samples inverted ("CMYK;I"), then cmyk2rgb
      // takes 255 - K' = K
      int nk = c3[p];
      rgb[3 * p] = cmyk_channel(255 - cc, nk);
      rgb[3 * p + 1] = cmyk_channel(255 - mm, nk);
      rgb[3 * p + 2] = cmyk_channel(255 - yy, nk);
    }
  }
};

void set_message(char* msg, int32_t cap, const std::string& m) {
  if (!msg || cap <= 0) return;
  std::snprintf(msg, size_t(cap), "%s", m.c_str());
}

}  // namespace

extern "C" {

// Reads the frame header. dims = {height, width, components}. Returns 0,
// or a negative error code with a message in msg.
int32_t epic_jpeg_info(const uint8_t* data, int64_t size, int32_t* dims,
                       char* msg, int32_t msg_cap) {
  try {
    Decoder dec(data, size_t(size));
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail(kErrCorrupt, "not a JPEG file (no SOI marker)");
    dec.pos = 2;
    while (!dec.have_frame) {
      int m = dec.next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        dec.read_sof(m);
      } else if (m == 0xC3) {
        fail(kErrUnsupported, "lossless JPEG (SOF3)");
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xDE ||
                 m == 0xDF) {
        fail(kErrUnsupported, "hierarchical JPEG frames");
      } else if (m >= 0xC9 && m <= 0xCF && m != 0xCC) {
        fail(kErrUnsupported, "arithmetic coding");
      } else if (m == 0xD9 || m == 0xDA) {
        fail(kErrCorrupt, "no SOF marker");
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      } else {
        dec.skip_segment();
      }
    }
    dims[0] = dec.height;
    dims[1] = dec.width;
    dims[2] = int32_t(dec.comps.size());
    return 0;
  } catch (const JpegError& e) {
    set_message(msg, msg_cap, e.what());
    return e.code;
  } catch (const std::exception& e) {
    set_message(msg, msg_cap, e.what());
    return kErrCorrupt;
  }
}

// Decodes into out, a caller-allocated uint8 [height, width, 3] array of
// out_size bytes. Returns 0, or a negative error code with a message.
int32_t epic_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out,
                         int64_t out_size, char* msg, int32_t msg_cap) {
  try {
    Decoder dec(data, size_t(size));
    dec.parse();
    if (int64_t(dec.width) * dec.height * 3 != out_size)
      fail(kErrCorrupt, "output buffer has the wrong size");
    dec.render(out);
    return 0;
  } catch (const JpegError& e) {
    set_message(msg, msg_cap, e.what());
    return e.code;
  } catch (const std::exception& e) {
    set_message(msg, msg_cap, e.what());
    return kErrCorrupt;
  }
}

}  // extern "C"
