// RGB to palette indices with Floyd-Steinberg dithering, bit-equal to
// Pillow's Image.convert('P') of an RGB image (Convert.c:topalette with its
// default dither over the browser palette).
//
// Host code (g++ -O3 -shared -fPIC), loaded by cutie_tpu_torch/utils/image_io.py
// through ctypes. The arithmetic is Pillow's:
// - each pixel is the input plus (the error carried from its left neighbour
//   + the errors from the row above) / 16, C's truncating division, clipped
//   to 0..255;
// - its entry is Palette.c's cache: the cube of colours is cut into cells of
//   4 levels a channel, and every colour of a cell takes the entry nearest
//   (squared RGB distance) to the cell's low corner, ties to the lower index;
// - the error (colour less entry) goes 7/16 right and 3, 5, 1 /16 below
//   left, below and below right, in Pillow's order of additions; at the end
//   of a row Pillow hands the blue channel's terms to all three channels of
//   the next row's last pixel, and so does this code.
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

inline int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

}  // namespace

extern "C" {

// rgb [h, w, 3] uint8 -> out [h, w] uint8 indices into palette (size
// entries of 3 bytes, 1 <= size <= 256).
void rgb_to_palette(const uint8_t* rgb, int w, int h, const uint8_t* palette, int size,
                    uint8_t* out) {
  std::vector<int16_t> cache(64 * 64 * 64, -1);
  auto nearest = [&](int r, int g, int b) {
    int16_t& slot = cache[(r >> 2) + (g >> 2) * 64 + (b >> 2) * 64 * 64];
    if (slot < 0) {
      int r0 = r & ~3, g0 = g & ~3, b0 = b & ~3;
      unsigned best = ~0u;
      for (int i = 0; i < size; i++) {
        int dr = r0 - palette[3 * i], dg = g0 - palette[3 * i + 1], db = b0 - palette[3 * i + 2];
        unsigned d = static_cast<unsigned>(dr * dr + dg * dg + db * db);
        if (d < best) {
          best = d;
          slot = static_cast<int16_t>(i);
        }
      }
    }
    return slot;
  };
  // errors[3 * (x + 1) + c]: what the row above left for pixel x
  std::vector<int> errors(3 * (static_cast<size_t>(w) + 1), 0);
  for (int y = 0; y < h; y++) {
    const uint8_t* in = rgb + static_cast<size_t>(y) * w * 3;
    uint8_t* o = out + static_cast<size_t>(y) * w;
    int* e = errors.data();
    int r = 0, r0 = 0, r1 = 0, g = 0, g0 = 0, g1 = 0, b = 0, b0 = 0, b1 = 0;
    for (int x = 0; x < w; x++, in += 3, e += 3) {
      r = clip8(in[0] + (r + e[3]) / 16);
      g = clip8(in[1] + (g + e[4]) / 16);
      b = clip8(in[2] + (b + e[5]) / 16);
      int i = nearest(r, g, b);
      o[x] = static_cast<uint8_t>(i);
      r -= palette[3 * i];
      g -= palette[3 * i + 1];
      b -= palette[3 * i + 2];
      // r: the error d; e[0] = 3d + r0 (below left), r0 = 5d + r1 (below,
      // finished by the next pixel), r1 = d (below right), r = 7d (right)
      int d2, d;
      d = r; d2 = r + r; r += d2; e[0] = r + r0; r += d2; r0 = r + r1; r1 = d; r += d2;
      d = g; d2 = g + g; g += d2; e[1] = g + g0; g += d2; g0 = g + g1; g1 = d; g += d2;
      d = b; d2 = b + b; b += d2; e[2] = b + b0; b += d2; b0 = b + b1; b1 = d; b += d2;
    }
    // what the row leaves for the next row's last pixel: Pillow stores the
    // blue channel's three terms (b0, b1 and b2, its last error, which b1
    // equals) in the red, green and blue slots
    e[0] = b0;
    e[1] = b1;
    e[2] = b1;
  }
}

}  // extern "C"
