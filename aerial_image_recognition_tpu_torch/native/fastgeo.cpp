// fastgeo — native host-side geospatial kernels.
//
// The reference delegated its native needs to third-party C++ (rtree/
// libspatialindex for dedup, GEOS for containment — SURVEY.md §2.2). This
// framework owns them: a uniform-hash-grid confidence-greedy dedup (exact
// same semantics as reference simple_detector.py:540-596, built for
// millions of detections), and a vectorized even-odd point-in-polygon.
//
// A copy of native/fastgeo.cpp. Built at first use by
// aerial_image_recognition_tpu_torch/utils/native.py (g++ -O3
// -ffp-contract=off -shared -fPIC, into the repository's build/) and loaded
// there via ctypes.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <numeric>
#include <unordered_map>
#include <vector>

extern "C" {

// Confidence-greedy metric dedup over projected coordinates.
// Inputs: x/y [n] meters (any planar CRS), conf [n].
// Output: keep [n] (0/1), in input order. Ties broken by input order
// (stable sort), matching numpy's stable argsort in the python path.
void dedup_grid(const double* x, const double* y, const float* conf,
                int64_t n, double radius, uint8_t* keep) {
  if (n <= 0) return;
  std::memset(keep, 0, static_cast<size_t>(n));
  if (radius <= 0) {
    std::memset(keep, 1, static_cast<size_t>(n));
    return;
  }
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return conf[a] > conf[b]; });

  const double inv_cell = 1.0 / radius;
  const double r2 = radius * radius;
  // cell -> indices (into the sorted walk) of kept points
  std::unordered_map<uint64_t, std::vector<int64_t>> grid;
  grid.reserve(static_cast<size_t>(n) * 2);
  auto cell_key = [](int64_t cx, int64_t cy) -> uint64_t {
    return (static_cast<uint64_t>(static_cast<uint32_t>(cx)) << 32) |
           static_cast<uint64_t>(static_cast<uint32_t>(cy));
  };

  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = order[k];
    const double xi = x[i], yi = y[i];
    const int64_t cx = static_cast<int64_t>(std::floor(xi * inv_cell));
    const int64_t cy = static_cast<int64_t>(std::floor(yi * inv_cell));
    bool suppressed = false;
    for (int64_t nx = cx - 1; nx <= cx + 1 && !suppressed; ++nx) {
      for (int64_t ny = cy - 1; ny <= cy + 1 && !suppressed; ++ny) {
        auto it = grid.find(cell_key(nx, ny));
        if (it == grid.end()) continue;
        for (int64_t j : it->second) {
          const double dx = xi - x[j];
          const double dy = yi - y[j];
          if (dx * dx + dy * dy <= r2) { suppressed = true; break; }
        }
      }
    }
    if (!suppressed) {
      keep[i] = 1;
      grid[cell_key(cx, cy)].push_back(i);
    }
  }
}

// Even-odd point-in-polygon over one ring. Points [np], ring [nr] (open or
// closed). XORs results into `inside` so multiple rings (holes) compose.
void points_in_ring(const double* px, const double* py, int64_t np,
                    const double* rx, const double* ry, int64_t nr,
                    uint8_t* inside) {
  if (nr >= 2 && rx[0] == rx[nr - 1] && ry[0] == ry[nr - 1]) --nr;
  for (int64_t p = 0; p < np; ++p) {
    const double X = px[p], Y = py[p];
    int cross = 0;
    for (int64_t e = 0; e < nr; ++e) {
      const double x1 = rx[e], y1 = ry[e];
      const double x2 = rx[(e + 1) % nr], y2 = ry[(e + 1) % nr];
      if ((y1 > Y) != (y2 > Y)) {
        const double xint = x1 + (Y - y1) * (x2 - x1) / (y2 - y1);
        if (X < xint) ++cross;
      }
    }
    inside[p] ^= static_cast<uint8_t>(cross & 1);
  }
}

}  // extern "C"
