// Region overlap computation for tracker evaluation: the port's copy of
// c2m_tpu/native/region.cc (tests/test_torch_preprocess_tools.py holds the
// code below this comment to the original's).
//
// Rectangle IoU and convex/simple polygon IoU via Sutherland-Hodgman
// clipping against the subject polygon's half-planes, with the polygon area
// by the shoelace formula, in place of the reference's Cython/C region
// library (pysot/toolkit/utils/region.pyx). Exposed with a plain C ABI for
// ctypes; c2m_tpu_torch/native/__init__.py builds it with g++ at first use.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

double polygon_area(const std::vector<Pt>& p) {
  double a = 0.0;
  const size_t n = p.size();
  for (size_t i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    a += u.x * v.y - v.x * u.y;
  }
  return std::abs(a) * 0.5;
}

// Signed area of the triangle (a, b, c); > 0 when c is left of a->b.
double cross(const Pt& a, const Pt& b, const Pt& c) {
  return (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
}

// Ensure counter-clockwise orientation.
void make_ccw(std::vector<Pt>& p) {
  double a = 0.0;
  for (size_t i = 0; i < p.size(); ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % p.size()];
    a += u.x * v.y - v.x * u.y;
  }
  if (a < 0.0) std::reverse(p.begin(), p.end());
}

// Clip polygon `subject` by the half-plane left of edge (a, b).
std::vector<Pt> clip_halfplane(const std::vector<Pt>& subject, const Pt& a,
                               const Pt& b) {
  std::vector<Pt> out;
  const size_t n = subject.size();
  if (n == 0) return out;
  for (size_t i = 0; i < n; ++i) {
    const Pt& cur = subject[i];
    const Pt& nxt = subject[(i + 1) % n];
    const double dc = cross(a, b, cur);
    const double dn = cross(a, b, nxt);
    if (dc >= 0.0) {
      out.push_back(cur);
      if (dn < 0.0) {
        const double t = dc / (dc - dn);
        out.push_back({cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)});
      }
    } else if (dn >= 0.0) {
      const double t = dc / (dc - dn);
      out.push_back({cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)});
    }
  }
  return out;
}

double convex_intersection_area(std::vector<Pt> a, std::vector<Pt> b) {
  make_ccw(a);
  make_ccw(b);
  std::vector<Pt> clipped = a;
  const size_t n = b.size();
  for (size_t i = 0; i < n && !clipped.empty(); ++i) {
    clipped = clip_halfplane(clipped, b[i], b[(i + 1) % n]);
  }
  if (clipped.size() < 3) return 0.0;
  return polygon_area(clipped);
}

}  // namespace

extern "C" {

// Rect IoU. Rects are (x, y, w, h).
double c2m_rect_iou(double x1, double y1, double w1, double h1, double x2,
                    double y2, double w2, double h2) {
  const double ix = std::max(0.0, std::min(x1 + w1, x2 + w2) - std::max(x1, x2));
  const double iy = std::max(0.0, std::min(y1 + h1, y2 + h2) - std::max(y1, y2));
  const double inter = ix * iy;
  const double uni = w1 * h1 + w2 * h2 - inter;
  return uni > 0.0 ? inter / uni : 0.0;
}

// Convex polygon IoU. Points as flat [x0, y0, x1, y1, ...].
double c2m_polygon_iou(const double* poly1, int n1, const double* poly2,
                       int n2) {
  std::vector<Pt> a(n1), b(n2);
  for (int i = 0; i < n1; ++i) a[i] = {poly1[2 * i], poly1[2 * i + 1]};
  for (int i = 0; i < n2; ++i) b[i] = {poly2[2 * i], poly2[2 * i + 1]};
  const double inter = convex_intersection_area(a, b);
  const double uni = polygon_area(a) + polygon_area(b) - inter;
  return uni > 0.0 ? inter / uni : 0.0;
}

// Batched rect IoU: boxes as [n, 4] (x, y, w, h) row-major; out [n1, n2].
void c2m_rect_iou_matrix(const double* boxes1, int n1, const double* boxes2,
                         int n2, double* out) {
  for (int i = 0; i < n1; ++i) {
    const double* p = boxes1 + 4 * i;
    for (int j = 0; j < n2; ++j) {
      const double* q = boxes2 + 4 * j;
      out[i * n2 + j] =
          c2m_rect_iou(p[0], p[1], p[2], p[3], q[0], q[1], q[2], q[3]);
    }
  }
}

}  // extern "C"
