// RGBA to palette indices, bit-equal to Pillow's Image.convert('P') of an
// RGBA image: Image.quantize(256) by the fast octree (libImaging/Quant.c
// with QuantOctree.c), with the palette Pillow returns.
//
// Host code (g++ -O3 -shared -fPIC), loaded by cutie_tpu_torch/utils/image_io.py
// through ctypes. Pillow's steps, in its order and arithmetic:
// - every fully transparent pixel after the first takes the first one's
//   colour (Quant.c);
// - a fine cube of 3/4/3/3 bits (R, G, B, A) counts the pixels and sums
//   their channels; a coarse cube of 2 bits a channel is its sum;
// - the palette: the coarse cube's used buckets (at most 256), then the
//   fine buckets with most pixels, taken out of the coarse ones they fall
//   in, until the coarse buckets left and the fine ones fill 256 entries;
//   both lists sorted by pixel count, descending, in a stable sort (glibc's
//   qsort is a merge sort), each entry its bucket's mean, channel sums over
//   the count in float, truncated;
// - each pixel's index: the fine bucket's entry if it is one, else its
//   coarse bucket's.
#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Bucket {
  uint32_t count;
  uint64_t r, g, b, a;
};

struct Pixel {
  uint8_t r, g, b, a;
};

struct Cube {
  int bits[4];    // R, G, B, A
  int offset[4];  // each channel's shift in a bucket's index
  std::vector<Bucket> buckets;

  Cube(int rb, int gb, int bb, int ab) : bits{rb, gb, bb, ab} {
    offset[0] = gb + bb + ab;
    offset[1] = bb + ab;
    offset[2] = ab;
    offset[3] = 0;
    buckets.assign(size_t(1) << (rb + gb + bb + ab), Bucket{0, 0, 0, 0, 0});
  }
  size_t index_of(unsigned r, unsigned g, unsigned b, unsigned a) const {
    return (r << offset[0]) | (g << offset[1]) | (b << offset[2]) | (a << offset[3]);
  }
  Bucket& at(const Pixel& p) {
    return buckets[index_of(p.r >> (8 - bits[0]), p.g >> (8 - bits[1]), p.b >> (8 - bits[2]),
                            p.a >> (8 - bits[3]))];
  }
};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// QuantOctree.c:avg_color_from_color_bucket
Pixel mean(const Bucket& b) {
  float count = static_cast<float>(b.count);
  if (count == 0) return Pixel{0, 0, 0, 0};
  return Pixel{clip8(static_cast<int>(static_cast<float>(b.r) / count)),
               clip8(static_cast<int>(static_cast<float>(b.g) / count)),
               clip8(static_cast<int>(static_cast<float>(b.b) / count)),
               clip8(static_cast<int>(static_cast<float>(b.a) / count))};
}

// QuantOctree.c:copy_color_cube: each bucket of `to` is the sum of the
// buckets of `from` it covers (coarser), or a copy of the one covering it
// (finer)
Cube resized(const Cube& from, int rb, int gb, int bb, int ab) {
  Cube to(rb, gb, bb, ab);
  int src_reduce[4] = {0, 0, 0, 0}, dst_reduce[4] = {0, 0, 0, 0}, width[4];
  for (int c = 0; c < 4; c++) {
    if (from.bits[c] > to.bits[c]) {
      dst_reduce[c] = from.bits[c] - to.bits[c];
      width[c] = 1 << from.bits[c];
    } else {
      src_reduce[c] = to.bits[c] - from.bits[c];
      width[c] = 1 << to.bits[c];
    }
  }
  for (int r = 0; r < width[0]; r++)
    for (int g = 0; g < width[1]; g++)
      for (int b = 0; b < width[2]; b++)
        for (int a = 0; a < width[3]; a++) {
          const Bucket& s = from.buckets[from.index_of(r >> src_reduce[0], g >> src_reduce[1],
                                                       b >> src_reduce[2], a >> src_reduce[3])];
          Bucket& d = to.buckets[to.index_of(r >> dst_reduce[0], g >> dst_reduce[1],
                                             b >> dst_reduce[2], a >> dst_reduce[3])];
          d.count += s.count;
          d.r += s.r;
          d.g += s.g;
          d.b += s.b;
          d.a += s.a;
        }
  return to;
}

size_t used_buckets(const Cube& cube) {
  size_t n = 0;
  for (const Bucket& b : cube.buckets) n += b.count > 0;
  return n;
}

std::vector<Bucket> sorted_by_count(const Cube& cube) {
  std::vector<Bucket> out = cube.buckets;
  std::stable_sort(out.begin(), out.end(),
                   [](const Bucket& x, const Bucket& y) { return x.count > y.count; });
  return out;
}

// QuantOctree.c:subtract_color_buckets
void subtract(Cube& cube, const Bucket* buckets, long n) {
  for (long i = 0; i < n; i++) {
    const Bucket& s = buckets[i];
    if (s.count == 0) continue;
    Bucket& m = cube.at(mean(s));
    m.count -= s.count;
    m.r -= s.r;
    m.g -= s.g;
    m.b -= s.b;
    m.a -= s.a;
  }
}

// QuantOctree.c:add_lookup_buckets: the bucket of each entry's mean holds
// its index (in count), the lower index written last
void add_lookup(Cube& cube, const std::vector<Bucket>& palette, long n, long offset) {
  for (long i = offset + n - 1; i >= offset; i--) cube.at(mean(palette[i])).count = static_cast<uint32_t>(i);
}

}  // namespace

extern "C" {

// rgba [n, 4] uint8 -> out [n] uint8 palette indices and palette [256, 4]
// uint8 RGBA, as Image.convert('P') of an RGBA image gives them (the
// palette's 256 entries, unused ones black and transparent).
void rgba_to_octree_palette(const uint8_t* rgba, long n, uint8_t* out, uint8_t* palette) {
  const long colors = 256;
  std::vector<Pixel> px(n);
  bool transparent = false;
  Pixel first{0, 0, 0, 0};
  for (long i = 0; i < n; i++) {
    Pixel p{rgba[4 * i], rgba[4 * i + 1], rgba[4 * i + 2], rgba[4 * i + 3]};
    if (p.a == 0) {
      if (!transparent) {
        transparent = true;
        first = p;
      } else {
        p.r = first.r;
        p.g = first.g;
        p.b = first.b;
      }
    }
    px[i] = p;
  }
  Cube fine(3, 4, 3, 3);
  for (const Pixel& p : px) {
    Bucket& b = fine.at(p);
    b.count++;
    b.r += p.r;
    b.g += p.g;
    b.b += p.b;
    b.a += p.a;
  }
  Cube coarse = resized(fine, 2, 2, 2, 2);
  long n_coarse = static_cast<long>(used_buckets(coarse));
  if (n_coarse > colors) n_coarse = colors;
  long n_fine = colors - n_coarse;
  std::vector<Bucket> fine_sorted = sorted_by_count(fine);
  subtract(coarse, fine_sorted.data(), n_fine);
  while (n_coarse > static_cast<long>(used_buckets(coarse))) {
    long done = n_fine;
    n_coarse = static_cast<long>(used_buckets(coarse));
    n_fine = colors - n_coarse;
    subtract(coarse, fine_sorted.data() + done, n_fine - done);
  }
  std::vector<Bucket> coarse_sorted = sorted_by_count(coarse);
  std::vector<Bucket> entries(coarse_sorted.begin(), coarse_sorted.begin() + n_coarse);
  entries.insert(entries.end(), fine_sorted.begin(), fine_sorted.begin() + n_fine);
  Cube coarse_lookup(2, 2, 2, 2);
  add_lookup(coarse_lookup, entries, n_coarse, 0);
  Cube lookup = resized(coarse_lookup, 3, 4, 3, 3);
  add_lookup(lookup, entries, n_fine, n_coarse);
  for (long i = 0; i < n; i++) out[i] = static_cast<uint8_t>(lookup.at(px[i]).count);
  for (long i = 0; i < colors; i++) {
    Pixel p = mean(entries[i]);
    palette[4 * i] = p.r;
    palette[4 * i + 1] = p.g;
    palette[4 * i + 2] = p.b;
    palette[4 * i + 3] = p.a;
  }
}

}  // extern "C"
