// Click distance-map kernel (CPU path for interactive segmentation).
//
// Native re-implementation of the reference's one non-Python component
// (gui/ritm/utils/cython/_get_dist_maps.pyx — a Cython BFS flood fill):
// for each pixel, the squared normalized Euclidean distance to the nearest
// positive click (layer 0, first half of `points`) and negative click
// (layer 1, second half). Clicks with x < 0 are padding and ignored.
//
// The flood-fill relaxation with 4-connectivity converges to the exact
// per-layer minimum over clicks of ((dx/norm)^2 + (dy/norm)^2); we keep the
// same queue-relaxation scheme (bounded by revisits) rather than a brute
// force O(P*HW) scan so behavior matches for large click counts.
//
// Built with g++ at first use into cutie_tpu_torch/_build/ and loaded
// through ctypes (cutie_tpu_torch/utils/host_build.py,
// cutie_tpu_torch/ritm/dist_maps.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct QNode {
  int32_t row, col, orig_row, orig_col, layer;
};

}  // namespace

extern "C" {

// points: [n_points, 3] float32 (row, col, click_index); first half positive.
// out: [2, height, width] float32, pre-allocated by the caller.
void get_dist_maps(const float* points, int n_points, int height, int width,
                   float norm_delimiter, float* out) {
  const int hw = height * width;
  for (int i = 0; i < 2 * hw; ++i) out[i] = 1e6f;

  std::vector<QNode> queue;
  queue.reserve(static_cast<size_t>(4) * hw + 16);

  for (int i = 0; i < n_points; ++i) {
    const int x = static_cast<int>(points[i * 3 + 0] + 0.5f);
    const int y = static_cast<int>(points[i * 3 + 1] + 0.5f);
    if (points[i * 3] < 0 || x < 0 || x >= height || y < 0 || y >= width)
      continue;
    const int layer = (i >= n_points / 2) ? 1 : 0;
    queue.push_back({x, y, x, y, layer});
    out[layer * hw + x * width + y] = 0.0f;
  }

  static const int dxy[8] = {-1, 0, 0, -1, 0, 1, 1, 0};
  size_t head = 0;
  while (head < queue.size()) {
    const QNode v = queue[head++];
    for (int k = 0; k < 4; ++k) {
      const int x = v.row + dxy[2 * k];
      const int y = v.col + dxy[2 * k + 1];
      if (x < 0 || y < 0 || x >= height || y >= width) continue;
      const float dx = (x - v.orig_row) / norm_delimiter;
      const float dy = (y - v.orig_col) / norm_delimiter;
      const float ndist = dx * dx + dy * dy;
      float* cell = &out[v.layer * hw + x * width + y];
      if (*cell > ndist) {
        *cell = ndist;
        queue.push_back({x, y, v.orig_row, v.orig_col, v.layer});
      }
    }
  }
}

}  // extern "C"
