// Native mask decode ops — first-party C++ replacement for the
// pycocotools C extension the reference called for polygon/RLE -> mask
// (reference: vltk/utils/adapters.py:11, 219-224, 174-192; SURVEY §2.10
// N6). These run per-entry inside ETL and loader workers — host hot path.
//
// C ABI only — bound via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Uncompressed COCO RLE: column-major run lengths starting with zeros.
// Writes a row-major (h, w) uint8 mask.
void vltk_rle_decode(const int64_t* counts, int64_t n, uint8_t* out,
                     int64_t h, int64_t w) {
  std::memset(out, 0, static_cast<size_t>(h * w));
  int64_t pos = 0;
  int val = 0;
  const int64_t total = h * w;
  for (int64_t i = 0; i < n && pos < total; ++i) {
    // a malformed NEGATIVE count must not move pos backwards: a later
    // large count would then write before out[0] (p % h < 0 in C++).
    // Treat it as a zero-length run (still toggles val, like a 0 count).
    int64_t run = counts[i] > 0 ? std::min(counts[i], total - pos) : 0;
    if (val) {
      for (int64_t p = pos; p < pos + run; ++p) {
        // column-major flat index p -> (row = p % h, col = p / h)
        out[(p % h) * w + (p / h)] = 1;
      }
    }
    pos += run;
    val ^= 1;
  }
}

// CLEVR-ref style (start, run) pairs over a row-major flat mask
// (reference: utils/adapters.py:174-192).
void vltk_points_decode(const int64_t* pairs, int64_t n_pairs, uint8_t* out,
                        int64_t hw) {
  std::memset(out, 0, static_cast<size_t>(hw));
  for (int64_t i = 0; i < n_pairs; ++i) {
    int64_t start = pairs[2 * i];
    int64_t run = pairs[2 * i + 1];
    if (start < 0) start = 0;
    if (run <= 0 || start >= hw) continue;
    if (run > hw) run = hw;  // also caps start+run below INT64_MAX
    int64_t end = std::min(start + run, hw);
    if (start < end) std::memset(out + start, 1, static_cast<size_t>(end - start));
  }
}

// Rasterize polygons (flat xy lists, poly_sizes = #floats per polygon)
// into a row-major (h, w) uint8 mask via even-odd scanline fill at pixel
// centers, then mark boundary pixels (outline), matching the
// outline+fill semantics of the PIL/pycocotools paths closely.
void vltk_polygons_fill(const double* xy, const int64_t* poly_sizes,
                        int64_t n_polys, uint8_t* out, int64_t h, int64_t w) {
  std::memset(out, 0, static_cast<size_t>(h * w));
  std::vector<double> xs;
  const double* p = xy;
  for (int64_t k = 0; k < n_polys; ++k) {
    int64_t sz = poly_sizes[k];
    int64_t npts = sz / 2;
    // a NaN/inf vertex poisons every cast below (UB float->int); such a
    // polygon is malformed input — skip it rather than risk anything
    bool finite = true;
    for (int64_t i = 0; i < 2 * npts && finite; ++i) {
      if (!std::isfinite(p[i])) finite = false;
    }
    if (npts >= 3 && finite) {
      // scanline fill at y + 0.5
      double ymin = 1e30, ymax = -1e30;
      for (int64_t i = 0; i < npts; ++i) {
        ymin = std::min(ymin, p[2 * i + 1]);
        ymax = std::max(ymax, p[2 * i + 1]);
      }
      // clamp into the canvas BEFORE the float->int casts: a huge finite
      // coordinate (1e30) overflows the cast, which is UB
      ymin = std::max(ymin, 0.0);
      ymax = std::min(ymax, static_cast<double>(h));
      int64_t y0 = std::max<int64_t>(0, static_cast<int64_t>(std::floor(ymin)));
      int64_t y1 = std::min<int64_t>(h - 1, static_cast<int64_t>(std::ceil(ymax)));
      for (int64_t y = y0; y <= y1; ++y) {
        double yc = static_cast<double>(y) + 0.5;
        xs.clear();
        for (int64_t i = 0; i < npts; ++i) {
          double x1 = p[2 * i], yy1 = p[2 * i + 1];
          double x2 = p[2 * ((i + 1) % npts)], yy2 = p[2 * ((i + 1) % npts) + 1];
          if ((yy1 <= yc && yy2 > yc) || (yy2 <= yc && yy1 > yc)) {
            xs.push_back(x1 + (yc - yy1) / (yy2 - yy1) * (x2 - x1));
          }
        }
        std::sort(xs.begin(), xs.end());
        for (size_t i = 0; i + 1 < xs.size(); i += 2) {
          // clamp intersections into the canvas before casting (exact:
          // spans outside [0, w) are cropped anyway; huge values are UB)
          double xlo = std::min(std::max(xs[i], 0.0), static_cast<double>(w));
          double xhi =
              std::min(std::max(xs[i + 1], -1.0), static_cast<double>(w));
          int64_t xa = std::max<int64_t>(
              0, static_cast<int64_t>(std::ceil(xlo - 0.5)));
          int64_t xb = std::min<int64_t>(
              w - 1, static_cast<int64_t>(std::floor(xhi - 0.5)));
          if (xa <= xb)
            std::memset(out + y * w + xa, 1, static_cast<size_t>(xb - xa + 1));
        }
      }
      // outline: Bresenham-ish edge walk so thin polygons are non-empty
      for (int64_t i = 0; i < npts; ++i) {
        double x1 = p[2 * i], yy1 = p[2 * i + 1];
        double x2 = p[2 * ((i + 1) % npts)], yy2 = p[2 * ((i + 1) % npts) + 1];
        double span = std::max(std::fabs(x2 - x1), std::fabs(yy2 - yy1));
        // bound the walk: an adversarial multi-million-pixel edge would
        // otherwise spin here (and overflow the cast); the interior fill
        // above already covered the canvas, only boundary pixels are lost
        if (span > 4e6) continue;
        int64_t steps = static_cast<int64_t>(span) + 1;
        for (int64_t s = 0; s <= steps; ++s) {
          double t = static_cast<double>(s) / static_cast<double>(steps);
          int64_t px = static_cast<int64_t>(std::lround(x1 + t * (x2 - x1)));
          int64_t py = static_cast<int64_t>(std::lround(yy1 + t * (yy2 - yy1)));
          if (px >= 0 && px < w && py >= 0 && py < h) out[py * w + px] = 1;
        }
      }
    }
    p += sz;
  }
}

}  // extern "C"
