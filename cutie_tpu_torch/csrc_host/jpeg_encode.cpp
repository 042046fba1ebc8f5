// Baseline JPEG encoder, byte-equal to libjpeg(-turbo)'s default encode.
//
// Host code (g++ -O3 -shared -fPIC), loaded by cutie_tpu_torch/utils/image_io.py
// through ctypes. It writes 8-bit RGB images as JFIF, YCbCr 4:2:0, with the
// markers and arithmetic of libjpeg's defaults, which both Pillow's save and
// cv2.imwrite use (only the quality differs):
// - the Annex K tables scaled by jpeg_quality_scaling and clamped to
//   baseline (jcparam.c), one DQT segment a table;
// - the table-driven RGB->YCbCr of jccolor.c (SCALEBITS 16, Cb/Cr rounded
//   by 0.5 - epsilon);
// - h2v2 downsampling of jcsample.c (biases 1, 2, 1, 2, ... restarting each
//   row), the right edge replicated to whole blocks before it, the last row
//   pair (jcprepct.c) and then the last downsampled row replicated to a
//   whole iMCU row after it;
// - the islow forward DCT of jfdctint.c (CONST_BITS 13, PASS1_BITS 2) and
//   libjpeg-turbo's reciprocal quantisation (jcdctmgr.c:compute_reciprocal);
// - dummy blocks past the right and bottom edges (jccoefct.c): zero AC, the
//   DC of the block before;
// - the standard Huffman tables of jstdhuff.c, 0xFF stuffed with 0x00, the
//   last byte padded with 1-bits.
// No global state: concurrent calls from several threads are safe.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ITU-T T.81 Annex K.1, natural (row-major) order
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: code counts of lengths 1..16, then the values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
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
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
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

// jcparam.c:jpeg_quality_scaling and jpeg_add_quant_table (force_baseline)
void scale_table(const int* basic, int quality, int* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long temp = (static_cast<long>(basic[i]) * scale + 50L) / 100L;
    if (temp <= 0L) temp = 1L;
    if (temp > 255L) temp = 255L;
    out[i] = static_cast<int>(temp);
  }
}

// jcdctmgr.c:compute_reciprocal for 16-bit DCTELEMs: (|x| + corr) * recip
// >> shift equals the rounded quotient by `divisor`
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor;
  uint32_t fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

// jfdctint.c:jpeg_fdct_islow, in place; output scaled up by 8
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8;       // along a row, then a column
    const int next = pass == 0 ? 8 : 1;
    const int shift = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
    int32_t* p = data;
    for (int ctr = 0; ctr < 8; ctr++, p += next) {
      int32_t tmp0 = p[0 * step] + p[7 * step];
      int32_t tmp7 = p[0 * step] - p[7 * step];
      int32_t tmp1 = p[1 * step] + p[6 * step];
      int32_t tmp6 = p[1 * step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step];
      int32_t tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step];
      int32_t tmp4 = p[3 * step] - p[4 * step];

      int32_t tmp10 = tmp0 + tmp3;
      int32_t tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2;
      int32_t tmp12 = tmp1 - tmp2;

      if (pass == 0) {
        p[0 * step] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        p[0 * step] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      }
      int32_t z1 = (tmp12 + tmp13) * 4433;              // FIX_0_541196100
      p[2 * step] = descale(z1 + tmp13 * 6270, shift);  // FIX_0_765366865
      p[6 * step] = descale(z1 + tmp12 * -15137, shift);  // FIX_1_847759065

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6;
      int32_t z3 = tmp4 + tmp6;
      int32_t z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * 9633;  // FIX_1_175875602
      tmp4 *= 2446;    // FIX_0_298631336
      tmp5 *= 16819;   // FIX_2_053119869
      tmp6 *= 25172;   // FIX_3_072711026
      tmp7 *= 12299;   // FIX_1_501321110
      z1 *= -7373;     // FIX_0_899976223
      z2 *= -20995;    // FIX_2_562915447
      z3 *= -16069;    // FIX_1_961570560
      z4 *= -3196;     // FIX_0_390180644
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, shift);
      p[5 * step] = descale(tmp5 + z2 + z4, shift);
      p[3 * step] = descale(tmp6 + z2 + z3, shift);
      p[1 * step] = descale(tmp7 + z1 + z4, shift);
    }
  }
}

struct HuffTable {
  uint16_t code[256];
  uint8_t size[256];

  // jchuff.c:jpeg_make_c_derived_tbl (canonical codes)
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof size);
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; len++) {
      for (int i = 0; i < bits[len - 1]; i++, k++) {
        code[vals[k]] = static_cast<uint16_t>(c++);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  uint8_t* out;
  size_t cap, pos = 0;
  uint64_t buffer = 0;
  int bits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (pos < cap) out[pos] = b; else overflow = true;
    pos++;
  }
  void bytes(const uint8_t* b, size_t n) {
    for (size_t i = 0; i < n; i++) byte(b[i]);
  }
  void word(int v) {
    byte(static_cast<uint8_t>(v >> 8));
    byte(static_cast<uint8_t>(v & 0xff));
  }
  void put(uint32_t value, int n) {
    buffer = (buffer << n) | (value & ((1u << n) - 1));
    bits += n;
    while (bits >= 8) {
      uint8_t b = static_cast<uint8_t>(buffer >> (bits - 8));
      byte(b);
      if (b == 0xff) byte(0);
      bits -= 8;
    }
  }
  void flush() {  // jchuff.c:flush_bits: the last byte padded with 1-bits
    if (bits > 0) put(0x7f, 8 - bits);
  }
};

void encode_block(BitWriter& w, const int16_t* block, int& last_dc, const HuffTable& dc,
                  const HuffTable& ac) {
  int temp = block[0] - last_dc;
  int temp2 = temp;
  last_dc = block[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  w.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) w.put(static_cast<uint32_t>(temp2), nbits);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    temp = block[kNatural[k]];
    if (temp == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      w.put(ac.code[0xf0], ac.size[0xf0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int sym = (run << 4) + nbits;
    w.put(ac.code[sym], ac.size[sym]);
    w.put(static_cast<uint32_t>(temp2), nbits);
    run = 0;
  }
  if (run > 0) w.put(ac.code[0], ac.size[0]);
}

// One 8x8 block of a plane (stride `stride`) at (y0, x0): level shift,
// islow DCT, quantisation
void transform_block(const uint8_t* plane, int stride, int y0, int x0, const Divisor* div,
                     int16_t* out) {
  int32_t ws[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++)
      ws[y * 8 + x] = static_cast<int32_t>(plane[(y0 + y) * stride + x0 + x]) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int32_t t = ws[i];
    bool neg = t < 0;
    uint32_t a = static_cast<uint32_t>(neg ? -t : t);
    uint32_t q = ((a + div[i].corr) * div[i].recip) >> div[i].shift;
    out[i] = static_cast<int16_t>(neg ? -static_cast<int32_t>(q) : static_cast<int32_t>(q));
  }
}

void write_dqt(BitWriter& w, int id, const int* table) {
  w.word(0xffdb);
  w.word(67);
  w.byte(static_cast<uint8_t>(id));
  for (int i = 0; i < 64; i++) w.byte(static_cast<uint8_t>(table[kNatural[i]]));
}

void write_dht(BitWriter& w, int id, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; i++) n += bits[i];
  w.word(0xffc4);
  w.word(2 + 1 + 16 + n);
  w.byte(static_cast<uint8_t>(id));
  w.bytes(bits, 16);
  w.bytes(vals, n);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// A size no encode of a width x height image exceeds: the markers, and
// per 8x8 block 64 coefficients of at most 16 + 11 bits, every byte stuffed.
size_t jpeg_encode_bound(int width, int height) {
  size_t mcus = static_cast<size_t>(ceil_div(width, 16)) * ceil_div(height, 16);
  return 1024 + mcus * 6 * (64 * 27 / 8 + 2) * 2;
}

// rgb: [height, width, 3] uint8, row-major. Writes a JFIF file of the
// quality's tables into out (capacity cap); returns its size, or -1 when
// the arguments are invalid or cap is too small.
long jpeg_encode(const uint8_t* rgb, int width, int height, int quality, uint8_t* out,
                 size_t cap) {
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535) return -1;
  int qtab[2][64];
  scale_table(kLumaQuant, quality, qtab[0]);
  scale_table(kChromaQuant, quality, qtab[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal(static_cast<uint32_t>(qtab[t][i]) << 3);

  const int mcu_cols = ceil_div(width, 16), mcu_rows = ceil_div(height, 16);
  const int y_wblocks = ceil_div(width, 8), y_hblocks = ceil_div(height, 8);
  // full-resolution planes, right edge replicated to the chroma blocks'
  // 2 x 8 columns each (wider than luma's), rows to an even count
  const int fw = mcu_cols * 16, fh = height + (height & 1);
  // jccolor.c's tables (FIX(x) = x * 65536 + 0.5)
  int32_t tab[8][256];
  for (int i = 0; i < 256; i++) {
    tab[0][i] = 19595 * i;                                // R->Y
    tab[1][i] = 38470 * i;                                // G->Y
    tab[2][i] = 7471 * i + 32768;                         // B->Y
    tab[3][i] = -11059 * i;                               // R->Cb
    tab[4][i] = -21709 * i;                               // G->Cb
    tab[5][i] = 32768 * i + (128 << 16) + 32768 - 1;      // B->Cb, R->Cr
    tab[6][i] = -27439 * i;                               // G->Cr
    tab[7][i] = -5329 * i;                                // B->Cr
  }
  std::vector<uint8_t> yp(static_cast<size_t>(mcu_rows) * 16 * fw);
  std::vector<uint8_t> cbf(static_cast<size_t>(fh) * fw), crf(static_cast<size_t>(fh) * fw);
  for (int y = 0; y < fh; y++) {
    const uint8_t* row = rgb + static_cast<size_t>(y < height ? y : height - 1) * width * 3;
    uint8_t* yr = yp.data() + static_cast<size_t>(y) * fw;
    uint8_t* cbr = cbf.data() + static_cast<size_t>(y) * fw;
    uint8_t* crr = crf.data() + static_cast<size_t>(y) * fw;
    for (int x = 0; x < width; x++) {
      int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
      yr[x] = static_cast<uint8_t>((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
      cbr[x] = static_cast<uint8_t>((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
      crr[x] = static_cast<uint8_t>((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
    }
    for (int x = width; x < fw; x++) {
      yr[x] = yr[width - 1];
      cbr[x] = cbr[width - 1];
      crr[x] = crr[width - 1];
    }
  }
  for (int y = fh; y < mcu_rows * 16; y++)
    std::memcpy(yp.data() + static_cast<size_t>(y) * fw,
                yp.data() + static_cast<size_t>(fh - 1) * fw, fw);
  // h2v2 downsampling, then the last chroma row replicated to the iMCU rows
  const int cw = mcu_cols * 8, ch = mcu_rows * 8, crows = fh / 2;
  std::vector<uint8_t> cbp(static_cast<size_t>(ch) * cw), crp(static_cast<size_t>(ch) * cw);
  for (int plane = 0; plane < 2; plane++) {
    const uint8_t* src = plane == 0 ? cbf.data() : crf.data();
    uint8_t* dst = plane == 0 ? cbp.data() : crp.data();
    for (int y = 0; y < ch; y++) {
      uint8_t* d = dst + static_cast<size_t>(y) * cw;
      if (y >= crows) {
        std::memcpy(d, dst + static_cast<size_t>(crows - 1) * cw, cw);
        continue;
      }
      const uint8_t* r0 = src + static_cast<size_t>(2 * y) * fw;
      const uint8_t* r1 = r0 + fw;
      int bias = 1;
      for (int x = 0; x < cw; x++) {
        d[x] = static_cast<uint8_t>((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  BitWriter w{out, cap};
  static const uint8_t kApp0[18] = {0xff, 0xd8, 0xff, 0xe0, 0x00, 0x10, 'J', 'F', 'I',
                                    'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01};
  w.bytes(kApp0, sizeof kApp0);
  w.word(0);  // no thumbnail
  write_dqt(w, 0, qtab[0]);
  write_dqt(w, 1, qtab[1]);
  static const uint8_t kSofTail[10] = {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  w.word(0xffc0);
  w.word(17);
  w.byte(8);
  w.word(height);
  w.word(width);
  w.bytes(kSofTail, sizeof kSofTail);
  write_dht(w, 0x00, kDcLumaBits, kDcVals);
  write_dht(w, 0x10, kAcLumaBits, kAcLumaVals);
  write_dht(w, 0x01, kDcChromaBits, kDcVals);
  write_dht(w, 0x11, kAcChromaBits, kAcChromaVals);
  static const uint8_t kSos[14] = {0xff, 0xda, 0x00, 0x0c, 3,    1, 0x00,
                                   2,    0x11, 3,    0x11, 0x00, 63, 0x00};
  w.bytes(kSos, sizeof kSos);

  HuffTable dc[2], ac[2];
  dc[0].build(kDcLumaBits, kDcVals);
  ac[0].build(kAcLumaBits, kAcLumaVals);
  dc[1].build(kDcChromaBits, kDcVals);
  ac[1].build(kAcChromaBits, kAcChromaVals);
  int last_dc[3] = {0, 0, 0};
  int16_t blocks[4][64];
  int16_t chroma[64];
  for (int my = 0; my < mcu_rows; my++) {
    for (int mx = 0; mx < mcu_cols; mx++) {
      // luma: 2 x 2 blocks; those past the image's blocks are dummies
      for (int yi = 0; yi < 2; yi++) {
        int by = 2 * my + yi;
        for (int xi = 0; xi < 2; xi++) {
          int bx = 2 * mx + xi, n = 2 * yi + xi;
          if (by >= y_hblocks) {  // a dummy row: the DC of the row above's last block
            std::memset(blocks[n], 0, sizeof blocks[n]);
            blocks[n][0] = blocks[2 * yi - 1][0];
          } else if (bx >= y_wblocks) {  // a dummy column: the DC of the block to the left
            std::memset(blocks[n], 0, sizeof blocks[n]);
            blocks[n][0] = blocks[n - 1][0];
          } else {
            transform_block(yp.data(), fw, 8 * by, 8 * bx, div[0], blocks[n]);
          }
        }
      }
      for (int n = 0; n < 4; n++) encode_block(w, blocks[n], last_dc[0], dc[0], ac[0]);
      transform_block(cbp.data(), cw, 8 * my, 8 * mx, div[1], chroma);
      encode_block(w, chroma, last_dc[1], dc[1], ac[1]);
      transform_block(crp.data(), cw, 8 * my, 8 * mx, div[1], chroma);
      encode_block(w, chroma, last_dc[2], dc[1], ac[1]);
    }
  }
  w.flush();
  w.word(0xffd9);
  if (w.overflow) return -1;
  return static_cast<long>(w.pos);
}

}  // extern "C"
