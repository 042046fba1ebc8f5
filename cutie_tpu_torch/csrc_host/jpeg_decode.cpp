// JPEG decoder, bit-equal to libjpeg-turbo 3's default decode as Pillow
// runs it.
//
// Host code (g++ -O3 -shared -fPIC), loaded by cutie_tpu_torch/utils/image_io.py
// through ctypes. Supported, at 8-bit samples:
// - the DCT processes: sequential (SOF0, SOF1) and progressive (SOF2) with
//   Huffman coding, sequential (SOF9) and progressive (SOF10) with
//   arithmetic coding (jdarith.c, the DAC conditioning included);
// - lossless (SOF3, Huffman): predictors 1-7 and the point transform
//   (jdlhuff.c, jddiffct.c, jdlossls.c);
// - 1, 3 or 4 components, any sampling factors 1-4 whose ratios to the
//   largest are integral (jdsample.c refuses the rest), interleaved and
//   non-interleaved scans, restart intervals;
// - the colour space as jdapimin.c:default_decompress_parms guesses it: a
//   JFIF segment means YCbCr; else an Adobe segment's transform (3
//   components: 0 RGB, otherwise YCbCr; 4 components: 0 CMYK, otherwise
//   YCCK); else component ids 'R','G','B' mean RGB and any other ids
//   YCbCr (RGB in a lossless image); 4 components without an Adobe segment
//   are CMYK. Lossless images are not colour-converted (jdcolor.c refuses
//   YCbCr and YCCK there).
// Refused, with a message that names them: hierarchical and lossless
// arithmetic processes, other precisions, 2 components, fractional
// sampling ratios, and what else libjpeg rejects (as Pillow does); a
// restart marker missing from its place, which libjpeg resynchronises
// past.
//
// Every scan writes into a whole-image buffer per component (DCT
// coefficients, or lossless sample differences), and the output stage
// (IDCT, upsampling, colour) runs once all scans are read, as libjpeg's
// buffered-image path does. The progressive scans follow jdphuff.c and
// jdarith.c. A progressive image whose first coefficients are left
// unrefined is smoothed as libjpeg-turbo 3 smooths it
// (jdcoefct.c:decompress_smooth_data).
//
// The arithmetic follows libjpeg's defaults, which Pillow uses:
// - the islow IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2) and the
//   post-IDCT range_limit table of jdmaster.c with its RANGE_MASK wrap;
// - the upsampler jdsample.c:jinit_upsampler picks for each component:
//   fancy h2v1 (biases 1/2), h2v2 (8/7) and h1v2 (1/2) against the last
//   real downsampled column and row (jdmainct.c:set_bottom_pointers
//   duplicates the last real row), box upsampling where the downsampled
//   width is 2 or less, integral replication for the other ratios and for
//   every ratio of a lossless image (no fancy upsampling without a DCT);
// - the table-driven YCbCr->RGB and YCCK->CMYK of jdcolor.c (SCALEBITS 16).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, int a = 0, int b = 0) {
  char buf[256];
  std::snprintf(buf, sizeof buf, fmt, a, b);
  throw Error{buf};
}

// zig-zag position -> natural (row-major) index; the 16 extra entries map
// a corrupt run past the end onto the last coefficient, as jutils.c does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[17];  // index of the first value of each length, less its code
  uint16_t look[1 << kLookBits];  // (length << 8) | value; length 0: longer code

  void build(const uint8_t* counts, const uint8_t* values, int nvals) {
    std::memcpy(vals, values, nvals);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof look);
    for (int len = 1; len <= 16; len++) {
      valoffset[len] = k - code;
      if (counts[len - 1]) {
        for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
          if (len <= kLookBits) {
            int shift = kLookBits - len;
            for (int j = 0; j < (1 << shift); j++)
              look[(code << shift) | j] = static_cast<uint16_t>((len << 8) | vals[k]);
          }
        }
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      if (code > (1 << len)) fail("corrupt Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// T.81 Annex K.3's tables, which libjpeg-turbo installs in slots 0 and 1
// when a file defines none there by its first scan (jstdhuff.c, for Motion
// JPEG): code counts by length, then the symbols
const uint8_t kStdDcLuma[16 + 12] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0,
                                     0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdDcChroma[16 + 12] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0,
                                       0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[16 + 162] = {
    0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d,
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChroma[16 + 162] = {
    0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77,
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

void build_std(Huffman& h, const uint8_t* table, int nvals) {
  if (!h.defined) h.build(table, table + 16, nvals);
}

// the next RSTn marker at or after p: skip to it and past it
const uint8_t* past_restart(const uint8_t* p, const uint8_t* end, int expect) {
  while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) p++;
  if (p + 1 >= end) fail("missing RST%d marker", expect);
  if (p[1] != 0xD0 + expect) fail("found RST%d where RST%d was expected", p[1] - 0xD0, expect);
  return p + 2;
}

// Huffman-coded data: 0xFF00 is a stuffed 0xFF; any other marker ends the
// segment and zeros are fed after it (jdhuff.c's behaviour on a premature
// marker). exhausted() tells when a bit past the segment's end has been
// used: libjpeg then finishes that MCU on the zeros and leaves the MCUs
// after it untouched until the next restart (insufficient_data).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int count = 0;
  bool at_marker = false;
  int64_t used = 0, real_end = INT64_MAX;  // bits used; bits before the marker

  void fill() {
    while (count <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
          } else {
            at_marker = true;
            byte = 0;
          }
        } else {
          p++;
        }
      } else {
        at_marker = true;
      }
      if (at_marker && real_end == INT64_MAX) real_end = used + count;
      buf |= static_cast<uint64_t>(byte) << (56 - count);
      count += 8;
    }
  }
  bool exhausted() const { return used > real_end; }
  uint32_t peek(int n) {
    if (count < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    count -= n;
    used += n;
  }
  int bits(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }
  int decode(const Huffman& h) {
    uint32_t look = h.look[peek(kLookBits)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    uint32_t code16 = peek(16);
    int len = kLookBits + 1;
    while (len <= 16 && static_cast<int32_t>(code16 >> (16 - len)) > h.maxcode[len]) len++;
    if (len > 16) {  // corrupt data: libjpeg reads 17 bits, warns and decodes a zero
      peek(17);
      skip(17);
      return 0;
    }
    int code = static_cast<int>(code16 >> (16 - len));
    skip(len);
    return h.vals[(h.valoffset[len] + code) & 0xFF];
  }
  // the next RSTn marker: drop the bits left in this segment and skip to it
  void restart(int expect) {
    buf = 0;
    count = 0;
    at_marker = false;
    used = 0;
    real_end = INT64_MAX;
    p = past_restart(p, end, expect);
  }
};

// ITU-T T.81 Table D.2: Qe, the next state after an LPS and after an MPS,
// and whether an LPS switches the MPS sense; state 113 is jaricom.c's fixed
// probability 0.5 (never leaves itself)
struct QeEntry {
  uint16_t qe;
  uint8_t nlps, nmps, swtch;
};
const QeEntry kQe[114] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 14, 2, 0},    {0x1114, 16, 3, 0},    {0x080b, 18, 4, 0},
    {0x03d8, 20, 5, 0},    {0x01da, 23, 6, 0},    {0x00e5, 25, 7, 0},    {0x006f, 28, 8, 0},
    {0x0036, 30, 9, 0},    {0x001a, 33, 10, 0},   {0x000d, 35, 11, 0},   {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},   {0x0001, 12, 13, 0},   {0x5a7f, 15, 15, 1},   {0x3f25, 36, 16, 0},
    {0x2cf2, 38, 17, 0},   {0x207c, 39, 18, 0},   {0x17b9, 40, 19, 0},   {0x1182, 42, 20, 0},
    {0x0cef, 43, 21, 0},   {0x09a1, 45, 22, 0},   {0x072f, 46, 23, 0},   {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},   {0x0303, 51, 26, 0},   {0x0240, 52, 27, 0},   {0x01b1, 54, 28, 0},
    {0x0144, 56, 29, 0},   {0x00f5, 57, 30, 0},   {0x00b7, 59, 31, 0},   {0x008a, 60, 32, 0},
    {0x0068, 62, 33, 0},   {0x004e, 63, 34, 0},   {0x003b, 32, 35, 0},   {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 64, 38, 0},   {0x3a0d, 65, 39, 0},   {0x2ef1, 67, 40, 0},
    {0x261f, 68, 41, 0},   {0x1f33, 69, 42, 0},   {0x19a8, 70, 43, 0},   {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0},   {0x0e74, 74, 46, 0},   {0x0bfb, 75, 47, 0},   {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},   {0x0706, 79, 50, 0},   {0x05cd, 48, 51, 0},   {0x04de, 50, 52, 0},
    {0x040f, 50, 53, 0},   {0x0363, 51, 54, 0},   {0x02d4, 52, 55, 0},   {0x025c, 53, 56, 0},
    {0x01f8, 54, 57, 0},   {0x01a4, 55, 58, 0},   {0x0160, 56, 59, 0},   {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},   {0x00cb, 59, 62, 0},   {0x00ab, 61, 63, 0},   {0x008f, 61, 32, 0},
    {0x5b12, 65, 65, 1},   {0x4d04, 80, 66, 0},   {0x412c, 81, 67, 0},   {0x37d8, 82, 68, 0},
    {0x2fe8, 83, 69, 0},   {0x293c, 84, 70, 0},   {0x2379, 86, 71, 0},   {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},   {0x174e, 72, 74, 0},   {0x1424, 72, 75, 0},   {0x119c, 74, 76, 0},
    {0x0f6b, 74, 77, 0},   {0x0d51, 75, 78, 0},   {0x0bb6, 77, 79, 0},   {0x0a40, 77, 48, 0},
    {0x5832, 80, 81, 1},   {0x4d1c, 88, 82, 0},   {0x438e, 89, 83, 0},   {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},   {0x2eae, 92, 86, 0},   {0x299a, 93, 87, 0},   {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1},   {0x4ca9, 95, 90, 0},   {0x44d9, 96, 91, 0},   {0x3e22, 97, 92, 0},
    {0x3824, 99, 93, 0},   {0x32b4, 99, 94, 0},   {0x2e17, 93, 86, 0},   {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0},  {0x47e5, 102, 98, 0},  {0x41cf, 103, 99, 0},  {0x3c3d, 104, 100, 0},
    {0x375e, 99, 93, 0},   {0x5231, 105, 102, 0}, {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415e, 103, 99, 0},  {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};

// The arithmetic decoder of jdarith.c:arith_decode (T.81 D.2). A
// statistics bin is one byte: the MPS sense in bit 7, the state below it.
// A marker inside the data feeds zeros from there on, as libjpeg does.
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read first; -1: corrupt data, decode nothing
  bool at_marker = false;

  int next_byte() {
    if (at_marker || p >= end) return 0;
    int d = *p;
    if (d != 0xFF) {
      p++;
      return d;
    }
    const uint8_t* q = p + 1;
    while (q < end && *q == 0xFF) q++;  // fill bytes
    if (q < end && *q == 0) {
      p = q + 1;
      return 0xFF;  // a stuffed zero
    }
    p = q - 1;  // a marker: stay on its 0xFF
    at_marker = true;
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    const QeEntry& e = kQe[sv & 0x7F];
    int64_t qe = e.qe;
    int nl = e.nlps | (e.swtch << 7), nm = e.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: an MPS after all
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {  // conditional exchange: an LPS after all
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void restart(int expect) {
    c = a = 0;
    ct = -16;
    at_marker = false;
    p = past_restart(p, end, expect);
  }
};

// SOFn markers of processes libjpeg-turbo does not decode
[[noreturn]] void refuse_process(int marker) {
  int n = marker - 0xC0;
  if (n == 11) fail("lossless arithmetic-coded JPEG (SOF11) is not supported");
  fail("hierarchical JPEG (SOF%d) is not supported", n);
}

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int blocks_w, blocks_h;   // allocated: whole MCUs (blocks, or samples when lossless)
  int width, height;        // real downsampled size (jdinput.c)
  int wib, hib;             // width_in_blocks, height_in_blocks: the real ones
  std::vector<int16_t> coef;  // DCT: blocks_h * blocks_w * 64, natural order
  std::vector<int32_t> diff;  // lossless: blocks_h * blocks_w sample differences
  std::vector<uint8_t> imcu_first;  // lossless: iMCU rows whose first row restarts prediction
  uint16_t quant[64];         // latched at the component's first scan (jdinput.c)
  bool latched = false;
  int dc_pred = 0;
  int dc_context = 0;  // arithmetic coding: the DC conditioning category's bin
  int coef_bits[64];  // progressive: the Al of the last scan of each coefficient, -1 before
};

// jdcoefct.c:smoothing_ok looks at the first SAVED_COEFS coefficients in
// zig-zag order (libjpeg-turbo 2.1 and later: 10)
constexpr int kSmoothingCoefs = 10;
const int kSmoothPos[kSmoothingCoefs] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

enum ColorSpace { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

constexpr int kArithTables = 16;  // NUM_ARITH_TBLS

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool frame = false, progressive = false, arithmetic = false, lossless = false;
  bool jfif = false, adobe = false;
  bool std_tables = false;  // the standard Huffman tables are in the empty slots
  int adobe_transform = 0;
  int eobrun = 0;  // progressive Huffman AC scans: blocks left in the current end-of-band run
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  // arithmetic coding: the DAC conditioning (jdmarker.c's defaults) and the
  // statistics bins of each table
  int arith_l[kArithTables], arith_u[kArithTables], arith_k[kArithTables];
  uint8_t dc_stats[kArithTables][64], ac_stats[kArithTables][256];
  uint8_t fixed_bin = 113;
  Component comp[4];

  int u8() {
    if (pos >= size) fail("truncated JPEG");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = u8(), pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("quantization table %d", tq);
      for (int k = 0; k < 64; k++) quant[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      quant_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = u8(), tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("Huffman table class %d id %d", tc, th);
      uint8_t counts[16], values[256];
      int n = 0;
      for (int i = 0; i < 16; i++) n += counts[i] = static_cast<uint8_t>(u8());
      if (n > 256) fail("Huffman table of %d symbols", n);
      for (int i = 0; i < n; i++) values[i] = static_cast<uint8_t>(u8());
      (tc ? ac : dc)[th].build(counts, values, n);
    }
  }

  // jdmarker.c:get_dac: Tc (0 DC, 1 AC) in the high nibble of the index
  void read_dac(size_t end) {
    while (pos < end) {
      int index = u8(), val = u8();
      if (index >= 2 * kArithTables) fail("arithmetic conditioning table index %d", index);
      if (index >= kArithTables) {
        arith_k[index - kArithTables] = val;
      } else {
        arith_l[index] = val & 15;
        arith_u[index] = val >> 4;
        if (arith_l[index] > arith_u[index]) fail("arithmetic DC conditioning L %d > U %d", val & 15, val >> 4);
      }
    }
  }

  void read_sof() {
    if (frame) fail("a second frame header");
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8) fail("%d-bit samples (only 8-bit JPEG is supported)", precision);
    if (height == 0) fail("a DNL marker for the image height");
    if (width == 0) fail("zero image width");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) fail("%d components", ncomp);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad component parameters");
    }
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      hmax = comp[i].h > hmax ? comp[i].h : hmax;
      vmax = comp[i].v > vmax ? comp[i].v : vmax;
    }
    // a lossless "block" is one sample (DCT size 1)
    const int bs = lossless ? 1 : 8;
    mcus_x = (width + bs * hmax - 1) / (bs * hmax);
    mcus_y = (height + bs * vmax - 1) / (bs * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.blocks_w = mcus_x * c.h;
      c.blocks_h = mcus_y * c.v;
      c.width = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) / vmax);
      c.wib = (c.width + bs - 1) / bs;
      c.hib = (c.height + bs - 1) / bs;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
      // jdsample.c refuses ratios that are not integral
      if (hmax % c.h || vmax % c.v)
        fail("fractional sampling: factors %dx%d against the largest, which libjpeg does not upsample",
             c.h, c.v);
    }
    frame = true;
  }

  ColorSpace color_space() const {
    if (ncomp == 1) return kGray;
    if (ncomp == 3) {
      if (jfif) return kYCbCr;
      if (adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
      // libjpeg-turbo 3 guesses RGB for any ids of a lossless image
      if (lossless || (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B')) return kRGB;
      return kYCbCr;
    }
    if (adobe) return adobe_transform == 0 ? kCMYK : kYCCK;
    return kCMYK;
  }

  // ------------------------------------------------ Huffman, sequential

  void decode_block(BitReader& br, Component& c, int16_t* block) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int t = br.decode(hd);
    int diff = t ? extend(br.bits(t), t) : 0;
    c.dc_pred += diff;
    block[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64;) {
      int rs = br.decode(ha), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  // ------------------------------------------------ Huffman, progressive (jdphuff.c)

  static int16_t shifted(int v, int al) {
    return static_cast<int16_t>(static_cast<uint32_t>(v) << al);  // LEFT_SHIFT, then JCOEF
  }

  void dc_first(BitReader& br, Component& c, int16_t* block, int al) {
    int t = br.decode(dc[c.td]);
    int diff = t ? extend(br.bits(t), t) : 0;
    c.dc_pred += diff;
    block[0] = shifted(c.dc_pred, al);
  }

  static void dc_refine(BitReader& br, int16_t* block, int al) {
    if (br.bits(1)) block[0] = static_cast<int16_t>(block[0] | (1 << al));
  }

  void ac_first(BitReader& br, const Huffman& h, int16_t* block, int ss, int se, int al) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(h), r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = shifted(extend(br.bits(s), s), al);
      } else if (r == 15) {
        k += 15;  // ZRL
      } else {    // EOBr: this block and 2^r - 1 + (r bits) more end here
        eobrun = (1 << r) + br.bits(r) - 1;
        break;
      }
    }
  }

  // A correction bit for an already-nonzero coefficient: 1 adds p1 to its
  // magnitude, unless that bit is set already.
  static void correct(BitReader& br, int16_t* coef, int p1) {
    if (br.bits(1) && (*coef & p1) == 0)
      *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef - p1);
  }

  void ac_refine(BitReader& br, const Huffman& h, int16_t* block, int ss, int se, int al) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(h), r = rs >> 4, s = rs & 15;
        if (s) {  // a newly nonzero coefficient (of size 1: libjpeg warns otherwise)
          s = br.bits(1) ? p1 : -p1;
        } else if (r != 15) {  // EOBr; the rest of this block is the EOB run's
          eobrun = (1 << r) + br.bits(r);
          break;
        }
        // pass r zero coefficients (the next one, if s, is the new one),
        // reading a correction bit for each nonzero one on the way
        do {
          int16_t* coef = &block[kNatural[k]];
          if (*coef != 0) {
            correct(br, coef, p1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) block[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {  // in an EOB run: correction bits only
      for (; k <= se; k++)
        if (block[kNatural[k]] != 0) correct(br, &block[kNatural[k]], p1);
      eobrun--;
    }
  }

  // ------------------------------------------------ arithmetic (jdarith.c)

  // a DC difference (sequential, or a progressive DC first scan) into the
  // component's prediction
  void arith_dc(ArithReader& ar, Component& c) {
    int tbl = c.td;
    uint8_t* st = dc_stats[tbl] + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
      return;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;  // magnitude overflow: corrupt data
          return;
        }
        st++;
      }
    }
    if (m < ((1 << arith_l[tbl]) >> 1))
      c.dc_context = 0;
    else if (m > ((1 << arith_u[tbl]) >> 1))
      c.dc_context = 12 + sign * 4;
    else
      c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c.dc_pred = (c.dc_pred + v) & 0xffff;
  }

  // AC coefficients ss..se of one block (sequential: 1..63, al 0)
  void arith_ac_first(ArithReader& ar, int tbl, int16_t* block, int ss, int se, int al) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow: corrupt data
          return;
        }
      }
      int sign = ar.decode(&fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m != 0 && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return;
          }
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      block[kNatural[k]] = shifted(v, al);
    }
  }

  void arith_ac_refine(ArithReader& ar, int tbl, int16_t* block, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (block[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = &block[kNatural[k]];
        if (*coef) {  // previously nonzero: a correction bit
          if (ar.decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(ar.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.ct = -1;
          return;
        }
      }
    }
  }

  // ------------------------------------------------ scans

  // A progressive scan's parameters against jdphuff.c:start_pass_phuff_decoder's
  // (and jdarith.c's) checks; each coefficient's refinement state. A
  // progression out of order is a warning there, decoded as given.
  void check_progression(Component* const* sc, int ns, int ss, int se, int ah, int al) {
    bool dc_band = ss == 0;
    bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) fail("bad progressive scan: spectral selection %d-%d", ss, se);
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
    }
  }

  // the statistics bins a scan starts with, and after each restart (jdarith.c)
  void reset_arith(Component* const* sc, int ns, int ss, int ah) {
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c.td], 0, sizeof dc_stats[0]);
        c.dc_pred = 0;
        c.dc_context = 0;
      }
      if (!progressive || ss) std::memset(ac_stats[c.ta], 0, sizeof ac_stats[0]);
    }
  }

  void read_sos() {
    if (!frame) fail("scan before frame header");
    int ns = u8();
    if (ns < 1 || ns > ncomp) fail("scan of %d components", ns);
    Component* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("scan names component %d", id);
      c->td = t >> 4;
      c->ta = t & 15;
      if (!c->latched) {
        if (lossless) {
          c->diff.assign(static_cast<size_t>(c->blocks_w) * c->blocks_h, 0);
          c->imcu_first.assign(mcus_y, 0);
        } else {
          if (!quant_defined[c->tq]) fail("component uses undefined quantization table %d", c->tq);
          std::memcpy(c->quant, quant[c->tq], sizeof c->quant);
          c->coef.assign(static_cast<size_t>(c->blocks_w) * c->blocks_h * 64, 0);
        }
        c->latched = true;
      }
      c->dc_pred = 0;
      sc[i] = c;
    }
    int ss = u8(), se = u8(), ahal = u8(), ah = ahal >> 4, al = ahal & 15;
    if (!arithmetic && !std_tables) {
      build_std(dc[0], kStdDcLuma, 12);
      build_std(dc[1], kStdDcChroma, 12);
      build_std(ac[0], kStdAcLuma, 162);
      build_std(ac[1], kStdAcChroma, 162);
      std_tables = true;
    }
    if (ns > 1) {  // jdinput.c: at most 10 blocks an MCU
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) fail("an MCU of %d blocks (libjpeg allows 10)", blocks);
    }
    if (arithmetic) {
      for (int i = 0; i < ns; i++)  // jdarith.c: any of the 16 tables, defined or default
        if (sc[i]->td >= kArithTables || sc[i]->ta >= kArithTables)
          fail("scan uses arithmetic table %d", sc[i]->td > sc[i]->ta ? sc[i]->td : sc[i]->ta);
    } else {
      bool need_dc = !progressive || (ss == 0 && ah == 0), need_ac = !lossless && (!progressive || ss != 0);
      for (int i = 0; i < ns; i++) {
        const Component& c = *sc[i];
        if ((need_dc && (c.td > 3 || !dc[c.td].defined)) || (need_ac && (c.ta > 3 || !ac[c.ta].defined)))
          fail("scan uses an undefined Huffman table");
      }
    }
    if (lossless) {
      if (ss < 1 || ss > 7 || se != 0 || ah != 0) fail("lossless scan: predictor %d, Se %d", ss, se);
      if (al > 7) fail("lossless point transform %d", al);
      lossless_scan(sc, ns, ss, al);
    } else {
      if (progressive) check_progression(sc, ns, ss, se, ah, al);
      dct_scan(sc, ns, ss, se, ah, al);
    }
  }

  void dct_scan(Component* const* sc, int ns, int ss, int se, int ah, int al) {
    eobrun = 0;
    if (!progressive) {  // libjpeg ignores a sequential scan's Ss, Se, Ah, Al (a warning)
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    BitReader br{data + pos, data + size};
    ArithReader ar{data + pos, data + size};
    if (arithmetic) reset_arith(sc, ns, ss, ah);
    auto block_of = [&](Component& c, int16_t* block) {
      if (arithmetic) {
        if (ar.ct == -1) return;
        if (ss == 0) {
          if (ah == 0 || !progressive) {
            arith_dc(ar, c);
            block[0] = progressive ? shifted(c.dc_pred, al) : static_cast<int16_t>(c.dc_pred);
          } else if (ar.decode(&fixed_bin)) {
            block[0] = static_cast<int16_t>(block[0] | (1 << al));
          }
          if (!progressive) arith_ac_first(ar, c.ta, block, 1, 63, 0);
        } else if (ah == 0) {
          arith_ac_first(ar, c.ta, block, ss, se, al);
        } else {
          arith_ac_refine(ar, c.ta, block, ss, se, al);
        }
      } else if (!progressive) {
        decode_block(br, c, block);
      } else if (ss == 0) {
        if (ah == 0)
          dc_first(br, c, block, al);
        else
          dc_refine(br, block, al);
      } else if (ah == 0) {
        ac_first(br, ac[c.ta], block, ss, se, al);
      } else {
        ac_refine(br, ac[c.ta], block, ss, se, al);
      }
    };
    // before each MCU: a restart when one is due; whether the Huffman data
    // ran out in an earlier MCU of this restart interval
    int restarts = 0, left = restart_interval;
    bool insufficient = false;
    auto start_mcu = [&]() {
      if (restart_interval) {
        if (left == 0) {
          if (arithmetic) {
            ar.restart(restarts & 7);
            reset_arith(sc, ns, ss, ah);
          } else {
            br.restart(restarts & 7);
            for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
            eobrun = 0;
            insufficient = false;
          }
          restarts++;
          left = restart_interval;
        }
        left--;
      }
      return !insufficient;
    };
    if (ns == 1) {
      // non-interleaved: the component's own blocks
      Component& c = *sc[0];
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++) {
          if (!start_mcu()) continue;
          block_of(c, &c.coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64]);
          insufficient = !arithmetic && br.exhausted();
        }
    } else {
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++) {
          if (!start_mcu()) continue;
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) {
                size_t b = static_cast<size_t>(my * c.v + v) * c.blocks_w + mx * c.h + h;
                block_of(c, &c.coef[b * 64]);
              }
          }
          insufficient = !arithmetic && br.exhausted();
        }
    }
    end_scan(arithmetic ? ar.p : br.p);
  }

  // continue after the entropy-coded segment: at the next marker that is
  // not a restart marker
  void end_scan(const uint8_t* p) {
    while (p + 1 < data + size && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
                                    !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      p++;
    pos = static_cast<size_t>(p - data);
  }

  // A lossless scan's sample differences (jdlhuff.c:decode_mcus). libjpeg
  // restarts in whole MCU rows (jddiffct.c), and the prediction restarts
  // at the first row of the iMCU row being read when a restart marker or
  // the scan begins (the undifferencer is reset then and runs once the
  // iMCU row is read).
  void lossless_scan(Component* const* sc, int ns, int psv, int al) {
    int per_row = ns == 1 ? sc[0]->wib : mcus_x;
    int mcu_rows = ns == 1 ? sc[0]->hib : mcus_y;
    int rows_per_imcu = ns == 1 ? sc[0]->v : 1;
    if (restart_interval % per_row)
      fail("lossless restart interval %d is not a whole number of MCU rows of %d", restart_interval,
           per_row);
    int restart_rows = restart_interval / per_row, rows_to_go = restart_rows, restarts = 0;
    BitReader br{data + pos, data + size};
    for (int i = 0; i < ns; i++) sc[i]->imcu_first[0] = 1;
    auto sample = [&](Component& c, size_t at) {
      int s = br.decode(dc[c.td]);
      if (s == 16)
        s = 32768;
      else if (s)
        s = extend(br.bits(s), s);
      c.diff[at] = s;
    };
    for (int my = 0; my < mcu_rows; my++) {
      if (restart_interval) {
        if (rows_to_go == 0) {
          br.restart(restarts++ & 7);
          rows_to_go = restart_rows;
          for (int i = 0; i < ns; i++) sc[i]->imcu_first[my / rows_per_imcu] = 1;
        }
        rows_to_go--;
      }
      if (ns == 1) {
        Component& c = *sc[0];
        for (int x = 0; x < per_row; x++) sample(c, static_cast<size_t>(my) * c.blocks_w + x);
      } else {
        for (int mx = 0; mx < per_row; mx++)
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                sample(c, static_cast<size_t>(my * c.v + v) * c.blocks_w + mx * c.h + h);
          }
      }
    }
    for (int i = 0; i < ns; i++) undifference(*sc[i], psv, al);
    end_scan(br.p);
  }

  // jdlossls.c: undifference every real row of the component in place
  // (predictor psv, point transform al), then scale to samples
  static void undifference(Component& c, int psv, int al) {
    const int initial = 1 << (8 - al - 1);
    std::vector<int32_t> undiff(c.diff.size());
    for (int y = 0; y < c.height; y++) {
      const int32_t* d = &c.diff[static_cast<size_t>(y) * c.blocks_w];
      int32_t* u = &undiff[static_cast<size_t>(y) * c.blocks_w];
      const int32_t* prev = y ? u - c.blocks_w : nullptr;
      bool first = y % c.v == 0 && c.imcu_first[y / c.v];
      if (first) {
        int ra = (d[0] + initial) & 0xFFFF;
        u[0] = ra;
        for (int x = 1; x < c.width; x++) u[x] = ra = (d[x] + ra) & 0xFFFF;
        continue;
      }
      int rb = prev[0], ra = (d[0] + rb) & 0xFFFF, rc;
      u[0] = ra;
      for (int x = 1; x < c.width; x++) {
        rc = rb;
        rb = prev[x];
        int64_t p;
        switch (psv) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = int64_t(ra) + rb - rc; break;
          case 5: p = int64_t(ra) + ((int64_t(rb) - rc) >> 1); break;
          case 6: p = int64_t(rb) + ((int64_t(ra) - rc) >> 1); break;
          default: p = (int64_t(ra) + rb) >> 1; break;
        }
        u[x] = ra = static_cast<int32_t>((d[x] + static_cast<int>(p)) & 0xFFFF);
      }
    }
    for (size_t i = 0; i < undiff.size(); i++) c.diff[i] = static_cast<uint8_t>(undiff[i] << al);
    std::fill(c.imcu_first.begin(), c.imcu_first.end(), 0);
  }

  // libjpeg-turbo smooths the output of a progressive image when every
  // component's DC is known, its quantizers there are nonzero, and one of
  // the first kSmoothingCoefs coefficients of some component is not fully
  // refined (jdcoefct.c:smoothing_ok)
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (int i = 0; i < ncomp; i++) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k < kSmoothingCoefs; k++)
        if (c.quant[kSmoothPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < kSmoothingCoefs; k++) useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  // Walk the markers: up to the frame header only (header_only), or
  // through every scan to EOI.
  void parse(bool header_only) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (int t = 0; t < kArithTables; t++) {  // jdmarker.c:get_soi
      arith_l[t] = 0;
      arith_u[t] = 1;
      arith_k[t] = 5;
    }
    bool scanned = false;
    while (true) {
      int b = u8();
      if (b != 0xFF) continue;  // libjpeg skips garbage before a marker
      int marker = u8();
      while (marker == 0xFF) marker = u8();
      if (marker == 0xD9) break;  // EOI
      if (marker >= 0xD0 && marker <= 0xD7) continue;
      if (marker == 0x01) continue;
      size_t len = static_cast<size_t>(u16());
      if (len < 2 || pos + len - 2 > size) fail("truncated JPEG segment");
      size_t end = pos + len - 2;
      switch (marker) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          progressive = marker == 0xC2 || marker == 0xCA;
          lossless = marker == 0xC3;
          arithmetic = marker >= 0xC8;
          read_sof();
          if (header_only) return;
          break;
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          refuse_process(marker);
        case 0xC4:
          read_dht(end);
          break;
        case 0xCC:
          read_dac(end);
          break;
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xE0:  // jdmarker.c:examine_app0 (APP0_DATA_LEN 14)
          if (len >= 16 && std::memcmp(data + pos, "JFIF\0", 5) == 0) jfif = true;
          break;
        case 0xEE:  // jdmarker.c:examine_app14 (APP14_DATA_LEN 12)
          if (len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[pos + 11];
          }
          break;
        case 0xDA:
          read_sos();
          scanned = true;
          continue;  // read_sos leaves pos at the next marker
        default:
          break;  // APPn, COM and the rest carry nothing the decode needs
      }
      pos = end;
    }
    if (!frame) fail("JPEG without a frame header");
    if (!scanned) fail("JPEG without a scan");
    ColorSpace cs = color_space();
    if (lossless && cs == kYCbCr) fail("lossless YCbCr JPEG: libjpeg does not colour-convert lossless data");
    if (lossless && cs == kYCCK) fail("lossless YCCK JPEG: libjpeg does not colour-convert lossless data");
  }
};

// ------------------------------------------------------------- islow IDCT

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jdmaster.c's post-IDCT range limit: index (x & 1023), x the descaled value
// before the +128 level shift
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++)
      t[i] = static_cast<uint8_t>(i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896);
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = static_cast<int>(static_cast<int64_t>(ip[0]) * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
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
    constexpr int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    constexpr int n = kConstBits + kPass1Bits + 3;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = kRange.t[descale(wp[0], kPass1Bits + 3) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
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
    op[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// --------------------------------------------------------- block smoothing

// jdcoefct.c's estimate of a coefficient from a weighted sum of DC values
// (num), to the coefficient's quantizer q, clipped below 2^al when al > 0
inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
  int pred = static_cast<int>(((q << 7) + (num >= 0 ? num : -num)) / (q << 8));
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return static_cast<int16_t>(num >= 0 ? pred : -pred);
}

// libjpeg-turbo 3's jdcoefct.c:decompress_smooth_data over one component:
// every real block, its first coefficients estimated where they are zero
// and not known exactly, from the DC values of the 5x5 blocks around it;
// with no AC coefficient known at all (change_dc), the DC too. The block
// rows around a block follow its loop, including the way the last iMCU
// row counts its rows.
void smooth_plane(const Component& c, int total_imcu_rows, uint8_t* plane, int stride) {
  const int* bits = c.coef_bits;  // zig-zag order, as kSmoothPos
  bool change_dc = true;
  for (int k = 1; k < kSmoothingCoefs; k++) change_dc &= bits[k] == -1;
  const uint16_t* qt = c.quant;
  const int64_t Q00 = qt[0], Q01 = qt[1], Q10 = qt[8], Q20 = qt[16], Q11 = qt[9], Q02 = qt[2],
                Q03 = qt[3], Q12 = qt[10], Q21 = qt[17], Q30 = qt[24];
  const int last = total_imcu_rows - 1;
  auto dc_at = [&](int row, int col) {
    col = col < 0 ? 0 : col >= c.wib ? c.wib - 1 : col;
    return static_cast<int64_t>(c.coef[(static_cast<size_t>(row) * c.blocks_w + col) * 64]);
  };
  int16_t ws[64];
  for (int imcu = 0; imcu < total_imcu_rows; imcu++) {
    int block_rows = c.v;
    if (imcu == last && c.hib % c.v) block_rows = c.hib % c.v;
    const int image_block_rows = block_rows * total_imcu_rows;
    for (int br = 0; br < block_rows; br++) {
      const int row = imcu * c.v + br, ibr = imcu * block_rows + br;
      const int prev = ibr > 0 ? row - 1 : row;
      const int prev2 = ibr > 1 ? row - 2 : prev;
      const int next = ibr < image_block_rows - 1 ? row + 1 : row;
      const int next2 = ibr < image_block_rows - 2 ? row + 2 : next;
      const int rows[5] = {prev2, prev, row, next, next2};
      for (int b = 0; b < c.wib; b++) {
        // DC[r][k]: the DC of block row rows[r], column b - 2 + k
        int64_t DC[5][5];
        for (int r = 0; r < 5; r++)
          for (int k = 0; k < 5; k++) DC[r][k] = dc_at(rows[r], b - 2 + k);
        const int64_t DC01 = DC[0][0], DC02 = DC[0][1], DC03 = DC[0][2], DC04 = DC[0][3],
                      DC05 = DC[0][4], DC06 = DC[1][0], DC07 = DC[1][1], DC08 = DC[1][2],
                      DC09 = DC[1][3], DC10 = DC[1][4], DC11 = DC[2][0], DC12 = DC[2][1],
                      DC13 = DC[2][2], DC14 = DC[2][3], DC15 = DC[2][4], DC16 = DC[3][0],
                      DC17 = DC[3][1], DC18 = DC[3][2], DC19 = DC[3][3], DC20 = DC[3][4],
                      DC21 = DC[4][0], DC22 = DC[4][1], DC23 = DC[4][2], DC24 = DC[4][3],
                      DC25 = DC[4][4];
        std::memcpy(ws, &c.coef[(static_cast<size_t>(row) * c.blocks_w + b) * 64], sizeof ws);
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {
          int64_t num = Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                            13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                                            38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                                            13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                                         : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = smooth_pred(num, Q01, al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {
          int64_t num = Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                            13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                            13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                            3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                         : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = smooth_pred(num, Q10, al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {
          int64_t num = Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                            14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                                            2 * DC19 + DC23)
                                         : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = smooth_pred(num, Q20, al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {
          int64_t num = Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                                            9 * DC19 + DC21 - DC25)
                                         : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                                            DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = smooth_pred(num, Q11, al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {
          int64_t num = Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                            14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                                            2 * DC19)
                                         : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = smooth_pred(num, Q02, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)
            ws[3] = smooth_pred(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
          if ((al = bits[7]) != 0 && ws[10] == 0)
            ws[10] = smooth_pred(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
          if ((al = bits[8]) != 0 && ws[17] == 0)
            ws[17] = smooth_pred(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
          if ((al = bits[9]) != 0 && ws[24] == 0)
            ws[24] = smooth_pred(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
          int64_t num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                               6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                               152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 +
                               42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 -
                               6 * DC24 - 2 * DC25);
          ws[0] = smooth_pred(num, Q00, 0);
        }
        idct_islow(ws, qt, plane + static_cast<size_t>(row) * 8 * stride + b * 8, stride);
      }
    }
  }
}

// a component's samples at its real downsampled size, stride blocks_w * 8
// (DCT) or blocks_w (lossless); a component in no scan is mid-grey, as
// libjpeg's zeroed coefficients and multipliers give it
std::vector<uint8_t> component_plane(const Decoder& d, const Component& c, bool smooth, int* stride) {
  if (d.lossless) {
    *stride = c.blocks_w;
    std::vector<uint8_t> plane(static_cast<size_t>(c.blocks_w) * c.blocks_h, 128);
    if (c.latched)
      for (size_t i = 0; i < plane.size(); i++) plane[i] = static_cast<uint8_t>(c.diff[i]);
    return plane;
  }
  *stride = c.blocks_w * 8;
  std::vector<uint8_t> plane(static_cast<size_t>(*stride) * c.blocks_h * 8, 128);
  if (!c.latched) return plane;
  if (smooth) {
    smooth_plane(c, d.mcus_y, plane.data(), *stride);
    return plane;
  }
  for (int by = 0; by < c.hib; by++)
    for (int bx = 0; bx < c.wib; bx++)
      idct_islow(&c.coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64], c.quant,
                 &plane[static_cast<size_t>(by) * 8 * *stride + bx * 8], *stride);
  return plane;
}

// jdsample.c:jinit_upsampler's choice for one component
struct Upsampler {
  enum Kind { kFull, kFancyH2V1, kFancyH1V2, kFancyH2V2, kInt } kind;
  int he, ve;  // kInt: the expansion factors

  Upsampler(const Component& c, int hmax, int vmax, bool fancy) {
    he = hmax / c.h;
    ve = vmax / c.v;
    if (he == 1 && ve == 1)
      kind = kFull;
    else if (he == 2 && ve == 1 && fancy && c.width > 2)
      kind = kFancyH2V1;
    else if (he == 1 && ve == 2 && fancy)
      kind = kFancyH1V2;
    else if (he == 2 && ve == 2 && fancy && c.width > 2)
      kind = kFancyH2V2;
    else
      kind = kInt;  // box h2v1 and h2v2 included
  }

  // output row y (the full width) from the component's plane
  void row(const Component& c, const uint8_t* plane, int stride, int y, int width, int* colsum,
           uint8_t* out) const {
    const int cw = c.width, ch = c.height;
    switch (kind) {
      case kFull:
        std::memcpy(out, plane + static_cast<size_t>(y) * stride, width);
        return;
      case kInt: {
        const uint8_t* in = plane + static_cast<size_t>(y / ve) * stride;
        for (int x = 0; x < width; x++) out[x] = in[x / he];
        return;
      }
      case kFancyH2V1: {
        const uint8_t* in = plane + static_cast<size_t>(y) * stride;
        for (int x = 0; x < width; x++) {
          int i = x >> 1;
          int v3 = in[i] * 3;
          out[x] = static_cast<uint8_t>((x & 1) ? (v3 + in[i + 1 < cw ? i + 1 : cw - 1] + 2) >> 2
                                                : (v3 + in[i > 0 ? i - 1 : 0] + 1) >> 2);
        }
        return;
      }
      default:
        break;
    }
    // the vertical fancy kinds: the nearer row and the next nearer one
    int i = y >> 1;
    int n = (y & 1) ? (i + 1 < ch ? i + 1 : ch - 1) : (i > 0 ? i - 1 : 0);
    const uint8_t* in0 = plane + static_cast<size_t>(i) * stride;
    const uint8_t* in1 = plane + static_cast<size_t>(n) * stride;
    if (kind == kFancyH1V2) {
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; x++) out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    for (int j = 0; j < cw; j++) colsum[j] = in0[j] * 3 + in1[j];
    for (int x = 0; x < width; x++) {
      int j = x >> 1;
      int s3 = colsum[j] * 3;
      out[x] = static_cast<uint8_t>((x & 1) ? (s3 + colsum[j + 1 < cw ? j + 1 : cw - 1] + 7) >> 4
                                            : (s3 + colsum[j > 0 ? j - 1 : 0] + 8) >> 4);
    }
  }
};

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

void write_error(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

void decode_into(Decoder& d, uint8_t* out, size_t out_size) {
  d.parse(false);
  const ColorSpace cs = d.color_space();
  const int n = d.ncomp, w = d.width;
  size_t need = static_cast<size_t>(w) * d.height * n;
  if (out_size < need) fail("output buffer too small");
  const bool smooth = d.smoothing_ok();
  std::vector<uint8_t> planes[4];
  int strides[4];
  std::vector<Upsampler> ups;
  int row_w = w;
  for (int i = 0; i < n; i++) {
    planes[i] = component_plane(d, d.comp[i], smooth, &strides[i]);
    ups.emplace_back(d.comp[i], d.hmax, d.vmax, !d.lossless);
    // the fancy upsamplers write 2 * the downsampled width
    row_w = 2 * d.comp[i].width > row_w ? 2 * d.comp[i].width : row_w;
  }
  std::vector<uint8_t> rows[4];
  for (int i = 0; i < n; i++) rows[i].resize(row_w);
  std::vector<int> colsum(row_w + 2);
  for (int y = 0; y < d.height; y++) {
    for (int i = 0; i < n; i++)
      ups[i].row(d.comp[i], planes[i].data(), strides[i], y, w, colsum.data(), rows[i].data());
    uint8_t* o = out + static_cast<size_t>(y) * w * n;
    const uint8_t *r0 = rows[0].data(), *r1 = n > 1 ? rows[1].data() : nullptr,
                  *r2 = n > 2 ? rows[2].data() : nullptr, *r3 = n > 3 ? rows[3].data() : nullptr;
    switch (cs) {
      case kGray:
        std::memcpy(o, r0, w);
        break;
      case kRGB:
        for (int x = 0; x < w; x++) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        break;
      case kYCbCr:
        for (int x = 0; x < w; x++) {
          int yy = r0[x], b = r1[x], r = r2[x];
          o[3 * x] = clamp255(yy + kColor.cr_r[r]);
          o[3 * x + 1] = clamp255(yy + static_cast<int>((kColor.cb_g[b] + kColor.cr_g[r]) >> 16));
          o[3 * x + 2] = clamp255(yy + kColor.cb_b[b]);
        }
        break;
      case kCMYK:
        for (int x = 0; x < w; x++) {
          o[4 * x] = r0[x];
          o[4 * x + 1] = r1[x];
          o[4 * x + 2] = r2[x];
          o[4 * x + 3] = r3[x];
        }
        break;
      case kYCCK:
        for (int x = 0; x < w; x++) {
          int yy = r0[x], b = r1[x], r = r2[x];
          o[4 * x] = clamp255(255 - (yy + kColor.cr_r[r]));
          o[4 * x + 1] = clamp255(255 - (yy + static_cast<int>((kColor.cb_g[b] + kColor.cr_g[r]) >> 16)));
          o[4 * x + 2] = clamp255(255 - (yy + kColor.cb_b[b]));
          o[4 * x + 3] = r3[x];
        }
        break;
    }
  }
}

}  // namespace

extern "C" {

// The image's size and channel count (1: grayscale, 3: RGB, 4: CMYK) from
// its frame header without decoding it; 0 on success, -1 with a message in
// err.
int jpeg_header(const uint8_t* data, size_t size, int* width, int* height, int* channels,
                char* err, int errlen) {
  try {
    Decoder d{};
    d.data = data;
    d.size = size;
    d.parse(true);
    *width = d.width;
    *height = d.height;
    *channels = d.ncomp;
    return 0;
  } catch (const Error& e) {
    write_error(e.msg, err, errlen);
    return -1;
  }
}

// Decode into out, [height, width, channels] uint8, channels as
// jpeg_header gives them (CMYK as libjpeg outputs it, before Pillow's
// inversion); 0 on success, -1 with a message in err.
int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                int errlen) {
  try {
    Decoder d{};
    d.data = data;
    d.size = size;
    decode_into(d, out, out_size);
    return 0;
  } catch (const Error& e) {
    write_error(e.msg, err, errlen);
    return -1;
  }
}

}  // extern "C"
