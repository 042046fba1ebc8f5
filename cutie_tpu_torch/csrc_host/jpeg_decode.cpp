// Baseline JPEG decoder, bit-equal to libjpeg's default decode.
//
// Host code (g++ -O3 -shared -fPIC), loaded by cutie_tpu_torch/utils/image_io.py
// through ctypes. Supported: sequential Huffman (SOF0, SOF1), 8-bit samples,
// 1 or 3 components, sampling 4:4:4, 4:2:2 (h2v1) and 4:2:0 (h2v2),
// interleaved and non-interleaved scans, restart intervals. Anything else
// (progressive, arithmetic, lossless, 12-bit, CMYK, Adobe transforms, other
// sampling factors) is refused with a message that names it.
//
// The arithmetic follows libjpeg's defaults, which Pillow uses:
// - the islow IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2) and the
//   post-IDCT range_limit table of jdmaster.c with its RANGE_MASK wrap;
// - fancy upsampling of jdsample.c (h2v1: biases 1/2, h2v2: 8/7), against the
//   last real downsampled column and row (jdmainct.c:set_bottom_pointers
//   duplicates the last real row); box upsampling when the downsampled width
//   is 2 or less, as jinit_upsampler chooses;
// - the table-driven YCbCr->RGB of jdcolor.c (SCALEBITS 16).
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

// Entropy-coded data: 0xFF00 is a stuffed 0xFF; any other marker ends the
// segment and zeros are fed after it (jdhuff.c's behaviour on a premature
// marker).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int count = 0;
  bool at_marker = false;

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
      }
      buf |= static_cast<uint64_t>(byte) << (56 - count);
      count += 8;
    }
  }
  uint32_t peek(int n) {
    if (count < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    count -= n;
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
    if (len > 16) {
      skip(16);
      return 0;  // corrupt data: libjpeg warns and decodes a zero
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
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) p++;
    if (p + 1 >= end) fail("missing RST%d marker", expect);
    if (p[1] != 0xD0 + expect) fail("found RST%d where RST%d was expected", p[1] - 0xD0, expect);
    p += 2;
  }
};

// SOFn markers other than sequential Huffman (SOF0, SOF1)
[[noreturn]] void refuse_process(int marker) {
  int n = marker - 0xC0;
  if (n == 2) fail("progressive JPEG (SOF2) is not supported");
  if (n == 3) fail("lossless JPEG (SOF3) is not supported");
  if (n >= 5 && n <= 7) fail("hierarchical JPEG (SOF%d) is not supported", n);
  fail("arithmetic-coded JPEG (SOF%d) is not supported", n);
}

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int blocks_w, blocks_h;   // allocated: whole MCUs
  int width, height;        // real downsampled size (jdinput.c)
  std::vector<int16_t> coef;  // blocks_h * blocks_w * 64, natural order
  uint16_t quant[64];         // latched at the component's first scan (jdinput.c)
  bool latched = false;
  int dc_pred = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool frame = false, adobe = false;
  int adobe_transform = -1;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];

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

  void read_sof() {
    if (frame) fail("a second frame header");
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8) fail("%d-bit samples (only 8-bit JPEG is supported)", precision);
    if (height == 0) fail("a DNL marker for the image height");
    if (width == 0) fail("zero image width");
    if (ncomp == 4) fail("4 components (CMYK/YCCK JPEG is not supported)");
    if (ncomp != 1 && ncomp != 3) fail("%d components", ncomp);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad component parameters");
    }
    if (ncomp == 1) {
      comp[0].h = comp[0].v = 1;  // one component: one block an MCU
    } else {
      bool ok = comp[1].h == 1 && comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1 &&
                ((comp[0].h == 1 && comp[0].v == 1) || (comp[0].h == 2 && comp[0].v == 1) ||
                 (comp[0].h == 2 && comp[0].v == 2));
      if (!ok)
        fail("sampling factors %dx%d (Y); only 4:4:4, 4:2:2 and 4:2:0 are supported",
             comp[0].h, comp[0].v);
    }
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      hmax = comp[i].h > hmax ? comp[i].h : hmax;
      vmax = comp[i].v > vmax ? comp[i].v : vmax;
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.blocks_w = mcus_x * c.h;
      c.blocks_h = mcus_y * c.v;
      c.width = static_cast<int>((static_cast<long>(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>((static_cast<long>(height) * c.v + vmax - 1) / vmax);
    }
    frame = true;
  }

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

  void read_sos() {
    if (!frame) fail("scan before frame header");
    int ns = u8();
    if (ns < 1 || ns > ncomp) fail("scan of %d components", ns);
    Component* sc[3];
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("scan names component %d", id);
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        fail("scan uses an undefined Huffman table");
      if (!c->latched) {
        if (!quant_defined[c->tq]) fail("component uses undefined quantization table %d", c->tq);
        std::memcpy(c->quant, quant[c->tq], sizeof c->quant);
        c->coef.assign(static_cast<size_t>(c->blocks_w) * c->blocks_h * 64, 0);
        c->latched = true;
      }
      c->dc_pred = 0;
      sc[i] = c;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) fail("spectral selection %d-%d in a sequential scan", ss, se);

    BitReader br{data + pos, data + size};
    int restarts = 0, left = restart_interval;
    auto maybe_restart = [&]() {
      if (!restart_interval) return;
      if (left == 0) {
        br.restart(restarts & 7);
        restarts++;
        left = restart_interval;
        for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
      }
      left--;
    };
    if (ns == 1) {
      // non-interleaved: the component's own blocks, ceil(size / 8) of them
      Component& c = *sc[0];
      int bw = (c.width + 7) / 8, bh = (c.height + 7) / 8;
      for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
          maybe_restart();
          decode_block(br, c, &c.coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64]);
        }
    } else {
      for (int my = 0; my < mcus_y; my++)
        for (int mx = 0; mx < mcus_x; mx++) {
          maybe_restart();
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) {
                size_t b = static_cast<size_t>(my * c.v + v) * c.blocks_w + mx * c.h + h;
                decode_block(br, c, &c.coef[b * 64]);
              }
          }
        }
    }
    // continue after the entropy-coded segment: at the next marker that is
    // not a restart marker
    const uint8_t* p = br.p;
    while (p + 1 < data + size && !(p[0] == 0xFF && p[1] != 0x00 && !(p[1] >= 0xD0 && p[1] <= 0xD7)))
      p++;
    pos = static_cast<size_t>(p - data);
  }

  // Walk the markers: up to the frame header only (header_only), or
  // through every scan to EOI.
  void parse(bool header_only) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
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
          read_sof();
          if (header_only) return;
          break;
        case 0xC2:
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          refuse_process(marker);
        case 0xC4:
          read_dht(end);
          break;
        case 0xCC:
          fail("arithmetic-coding conditioning (DAC) is not supported");
        case 0xDB:
          read_dqt(end);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDC:
          fail("DNL marker is not supported");
        case 0xEE:
          if (len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[pos + 11];
          }
          break;
        case 0xDA:
          if (adobe) fail("Adobe APP14 colour transform %d is not supported", adobe_transform);
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

// a component's samples: every allocated block through the IDCT
std::vector<uint8_t> component_plane(const Component& c) {
  if (!c.latched) fail("component %d is in no scan", c.id);
  int stride = c.blocks_w * 8;
  std::vector<uint8_t> plane(static_cast<size_t>(stride) * c.blocks_h * 8);
  const uint16_t* q = c.quant;
  for (int by = 0; by < c.blocks_h; by++)
    for (int bx = 0; bx < c.blocks_w; bx++)
      idct_islow(&c.coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64], q,
                 &plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
  return plane;
}

// one output row of a chroma component at full width, from its plane
// (stride: the plane's row length; cw, ch: the real downsampled size)
// (fh, fv: the upsampling factors, hmax / h and vmax / v)
void upsample_row(const Component& c, int fh, int fv, const uint8_t* plane, int stride, int y,
                  int width, int* colsum, uint8_t* out) {
  int cw = c.width, ch = c.height;
  if (fh == 1 && fv == 1) {  // as many samples as luma
    std::memcpy(out, plane + static_cast<size_t>(y) * stride, width);
    return;
  }
  if (fv == 1) {  // h2v1
    const uint8_t* in = plane + static_cast<size_t>(y) * stride;
    if (cw <= 2) {
      for (int x = 0; x < width; x++) out[x] = in[x >> 1];
      return;
    }
    for (int x = 0; x < width; x++) {
      int i = x >> 1;
      int v3 = in[i] * 3;
      out[x] = static_cast<uint8_t>((x & 1) ? (v3 + in[i + 1 < cw ? i + 1 : cw - 1] + 2) >> 2
                                            : (v3 + in[i > 0 ? i - 1 : 0] + 1) >> 2);
    }
    return;
  }
  // h2v2
  int i = y >> 1;
  const uint8_t* in0 = plane + static_cast<size_t>(i) * stride;
  if (cw <= 2) {
    for (int x = 0; x < width; x++) out[x] = in0[x >> 1];
    return;
  }
  int n = (y & 1) ? (i + 1 < ch ? i + 1 : ch - 1) : (i > 0 ? i - 1 : 0);
  const uint8_t* in1 = plane + static_cast<size_t>(n) * stride;
  for (int j = 0; j < cw; j++) colsum[j] = in0[j] * 3 + in1[j];
  for (int x = 0; x < width; x++) {
    int j = x >> 1;
    int s3 = colsum[j] * 3;
    out[x] = static_cast<uint8_t>((x & 1) ? (s3 + colsum[j + 1 < cw ? j + 1 : cw - 1] + 7) >> 4
                                          : (s3 + colsum[j > 0 ? j - 1 : 0] + 8) >> 4);
  }
}

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

}  // namespace

extern "C" {

// The image's size and channel count (1: grayscale, 3: RGB) without
// decoding it; 0 on success, -1 with a message in err.
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
// jpeg_header gives them; 0 on success, -1 with a message in err.
int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                int errlen) {
  try {
    Decoder d{};
    d.data = data;
    d.size = size;
    d.parse(false);
    size_t need = static_cast<size_t>(d.width) * d.height * d.ncomp;
    if (out_size < need) fail("output buffer too small");
    if (d.ncomp == 1) {
      const Component& c = d.comp[0];
      std::vector<uint8_t> plane = component_plane(c);
      for (int y = 0; y < d.height; y++)
        std::memcpy(out + static_cast<size_t>(y) * d.width,
                    &plane[static_cast<size_t>(y) * c.blocks_w * 8], d.width);
      return 0;
    }
    std::vector<uint8_t> planes[3];
    for (int i = 0; i < 3; i++) planes[i] = component_plane(d.comp[i]);
    int w = d.width;
    // upsampled chroma rows: the upsampler writes 2 * downsampled width
    int row_w = 2 * (d.comp[1].width > d.comp[2].width ? d.comp[1].width : d.comp[2].width);
    row_w = row_w > w ? row_w : w;
    std::vector<uint8_t> cb(row_w), cr(row_w);
    std::vector<int> colsum(row_w + 2);
    int ystride = d.comp[0].blocks_w * 8;
    for (int y = 0; y < d.height; y++) {
      const uint8_t* yrow = &planes[0][static_cast<size_t>(y) * ystride];
      upsample_row(d.comp[1], d.hmax, d.vmax, planes[1].data(), d.comp[1].blocks_w * 8, y, w, colsum.data(),
                   cb.data());
      upsample_row(d.comp[2], d.hmax, d.vmax, planes[2].data(), d.comp[2].blocks_w * 8, y, w, colsum.data(),
                   cr.data());
      uint8_t* o = out + static_cast<size_t>(y) * w * 3;
      for (int x = 0; x < w; x++) {
        int yy = yrow[x], b = cb[x], r = cr[x];
        o[3 * x] = clamp255(yy + kColor.cr_r[r]);
        o[3 * x + 1] = clamp255(yy + static_cast<int>((kColor.cb_g[b] + kColor.cr_g[r]) >> 16));
        o[3 * x + 2] = clamp255(yy + kColor.cb_b[b]);
      }
    }
    return 0;
  } catch (const Error& e) {
    write_error(e.msg, err, errlen);
    return -1;
  }
}

}  // extern "C"
