// Native host-side geometry and evaluation routines (the port's copy of
// tmae_tpu/csrc/host_ops.cpp; the code below is the same).
//
// Host C++ for the paths that run on the CPU:
//   * rotated-box BEV intersection / IoU  (augmentor collision tests, eval IoU,
//     the recall bookkeeping of the evaluator)
//   * greedy rotated NMS                  (host NMS of the served candidates)
//   * point-in-rotated-box tests
//   * the ONCE AP matching inner loops    (accumulate_scores /
//     compute_statistics of datasets/once_eval.py)
//
// Exposed as a plain C ABI bound with ctypes (tmae_tpu_torch/utils/native.py,
// which builds it with g++); the algorithms mirror the numpy versions in
// tmae_tpu_torch/ops/geometry_np.py and datasets/once_eval.py, the plain
// versions the tests hold them against.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

constexpr double kEps = 1e-8;

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// CCW corners of a rotated BEV box [x, y, _, dx, dy, _, heading].
inline void box_corners(const double* b, Pt out[4]) {
  const double c = std::cos(b[6]), s = std::sin(b[6]);
  const double hx = b[3] * 0.5, hy = b[4] * 0.5;
  const double lx[4] = {hx, -hx, -hx, hx};
  const double ly[4] = {hy, hy, -hy, -hy};
  for (int i = 0; i < 4; ++i) {
    out[i].x = lx[i] * c - ly[i] * s + b[0];
    out[i].y = lx[i] * s + ly[i] * c + b[1];
  }
}

inline bool point_in_box(const Pt& p, const double* b, double margin = 1e-5) {
  const double c = std::cos(b[6]), s = std::sin(b[6]);
  const double dx = p.x - b[0], dy = p.y - b[1];
  const double u = dx * c + dy * s;
  const double v = -dx * s + dy * c;
  return std::fabs(u) <= b[3] * 0.5 + margin && std::fabs(v) <= b[4] * 0.5 + margin;
}

// Segment intersection; returns true and writes the point if segments cross.
inline bool seg_intersect(const Pt& a1, const Pt& a2, const Pt& b1, const Pt& b2,
                          Pt* out) {
  const double rx = a2.x - a1.x, ry = a2.y - a1.y;
  const double sx = b2.x - b1.x, sy = b2.y - b1.y;
  const double denom = rx * sy - ry * sx;
  if (std::fabs(denom) <= kEps) return false;
  const double qx = b1.x - a1.x, qy = b1.y - a1.y;
  const double t = (qx * sy - qy * sx) / denom;
  const double u = (qx * ry - qy * rx) / denom;
  if (t < -1e-6 || t > 1 + 1e-6 || u < -1e-6 || u > 1 + 1e-6) return false;
  out->x = a1.x + t * rx;
  out->y = a1.y + t * ry;
  return true;
}

// Area of intersection of two rotated BEV boxes (convex-hull-of-candidates,
// same algorithm as geometry_np.py).
double intersection_area(const double* ba, const double* bb) {
  Pt ca[4], cb[4];
  box_corners(ba, ca);
  box_corners(bb, cb);
  Pt cand[24];
  int n = 0;
  for (int i = 0; i < 4; ++i) {
    if (point_in_box(ca[i], bb)) cand[n++] = ca[i];
    if (point_in_box(cb[i], ba)) cand[n++] = cb[i];
  }
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      Pt p;
      if (seg_intersect(ca[i], ca[(i + 1) & 3], cb[j], cb[(j + 1) & 3], &p)) {
        cand[n++] = p;
      }
    }
  }
  if (n < 3) return 0.0;
  Pt centroid{0, 0};
  for (int i = 0; i < n; ++i) {
    centroid.x += cand[i].x;
    centroid.y += cand[i].y;
  }
  centroid.x /= n;
  centroid.y /= n;
  double ang[24];
  int idx[24];
  for (int i = 0; i < n; ++i) {
    ang[i] = std::atan2(cand[i].y - centroid.y, cand[i].x - centroid.x);
    idx[i] = i;
  }
  std::sort(idx, idx + n, [&](int a, int b) { return ang[a] < ang[b]; });
  double area = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = cand[idx[i]];
    const Pt& q = cand[idx[(i + 1) % n]];
    area += (p.x - centroid.x) * (q.y - centroid.y) -
            (p.y - centroid.y) * (q.x - centroid.x);
  }
  return std::fabs(area) * 0.5;
}

}  // namespace

extern "C" {

// boxes: [n|m, 7] row-major doubles; out: [n, m].
void tmae_intersection_area_bev(const double* boxes_a, int64_t n,
                                const double* boxes_b, int64_t m, double* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < m; ++j) {
      out[i * m + j] = intersection_area(boxes_a + i * 7, boxes_b + j * 7);
    }
  }
}

// 3D IoU with optional heading gate (|dtheta| > pi/2 -> 0), matching the ONCE
// evaluation server's iou3d_kernel_with_heading.
void tmae_iou3d(const double* boxes_a, int64_t n, const double* boxes_b,
                int64_t m, int with_heading, double* out) {
  for (int64_t i = 0; i < n; ++i) {
    const double* a = boxes_a + i * 7;
    const double a_lo = a[2] - a[5] * 0.5, a_hi = a[2] + a[5] * 0.5;
    const double vol_a = a[3] * a[4] * a[5];
    for (int64_t j = 0; j < m; ++j) {
      const double* b = boxes_b + j * 7;
      const double b_lo = b[2] - b[5] * 0.5, b_hi = b[2] + b[5] * 0.5;
      const double ih =
          std::max(0.0, std::min(a_hi, b_hi) - std::max(a_lo, b_lo));
      double iou = 0.0;
      if (ih > 0.0) {
        const double inter = intersection_area(a, b) * ih;
        const double vol_b = b[3] * b[4] * b[5];
        iou = inter / std::max(vol_a + vol_b - inter, 1e-6);
      }
      if (with_heading) {
        double d = std::fabs(a[6] - b[6]);
        if (d >= M_PI) d = 2 * M_PI - d;
        if (d > M_PI / 2) iou = 0.0;
      }
      out[i * m + j] = iou;
    }
  }
}

// Greedy rotated-BEV NMS. boxes must be pre-sorted by descending score.
// keep_out: [n] int8 flags; returns number kept (<= post_max).
int64_t tmae_nms_bev(const double* boxes, int64_t n, double thresh,
                     int64_t post_max, int8_t* keep_out) {
  std::vector<uint8_t> suppressed(n, 0);
  std::vector<double> rad(n);  // half-diagonal for the cheap distance reject
  for (int64_t i = 0; i < n; ++i) {
    const double* b = boxes + i * 7;
    rad[i] = 0.5 * std::sqrt(b[3] * b[3] + b[4] * b[4]);
  }
  std::memset(keep_out, 0, n);
  int64_t kept = 0;
  for (int64_t i = 0; i < n && kept < post_max; ++i) {
    if (suppressed[i]) continue;
    keep_out[i] = 1;
    ++kept;
    const double* a = boxes + i * 7;
    const double area_a = a[3] * a[4];
    for (int64_t j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const double* b = boxes + j * 7;
      const double dx = a[0] - b[0], dy = a[1] - b[1];
      const double rr = rad[i] + rad[j];
      if (dx * dx + dy * dy > rr * rr) continue;  // disjoint: iou == 0
      const double inter = intersection_area(a, b);
      const double iou = inter / std::max(area_a + b[3] * b[4] - inter, 1e-6);
      if (iou > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// First box containing each point (3D test), else -1
// (reference roiaware points_in_boxes_cpu semantics).
void tmae_points_in_boxes(const float* points, int64_t n, const double* boxes,
                          int64_t m, double margin, int32_t* box_idx) {
  for (int64_t i = 0; i < n; ++i) {
    box_idx[i] = -1;
    Pt p{points[i * 3 + 0], points[i * 3 + 1]};
    const double z = points[i * 3 + 2];
    for (int64_t j = 0; j < m; ++j) {
      const double* b = boxes + j * 7;
      if (std::fabs(z - b[2]) <= b[5] * 0.5 + margin &&
          point_in_box(p, b, margin)) {
        box_idx[i] = static_cast<int32_t>(j);
        break;
      }
    }
  }
}

// ONCE eval: greedy best-score matching per GT; appends matched scores.
// Returns the number of accumulated scores written to accum (capacity num_gt).
int64_t tmae_accumulate_scores(const double* iou, int64_t num_gt,
                               int64_t num_pred, const double* pred_scores,
                               const int64_t* gt_flag, const int64_t* pred_flag,
                               double iou_threshold, double* accum) {
  std::vector<uint8_t> assigned(num_pred, 0);
  int64_t cnt = 0;
  for (int64_t i = 0; i < num_gt; ++i) {
    if (gt_flag[i] == -1) continue;
    int64_t det = -1;
    double best = -1.0;
    for (int64_t j = 0; j < num_pred; ++j) {
      if (pred_flag[j] == -1 || assigned[j]) continue;
      if (iou[i * num_pred + j] > iou_threshold && pred_scores[j] > best) {
        det = j;
        best = pred_scores[j];
      }
    }
    if (best == -1.0) continue;
    if (gt_flag[i] == 1 || pred_flag[det] == 1) {
      assigned[det] = 1;
    } else {
      accum[cnt++] = pred_scores[det];
      assigned[det] = 1;
    }
  }
  return cnt;
}

// ONCE eval: tp/fp/fn for every threshold at once. out: [num_thresh, 3].
void tmae_compute_statistics(const double* iou, int64_t num_gt,
                             int64_t num_pred, const double* pred_scores,
                             const int64_t* gt_flag, const int64_t* pred_flag,
                             const double* thresholds, int64_t num_thresh,
                             double iou_threshold, int64_t* out) {
  std::vector<uint8_t> assigned(num_pred);
  std::vector<uint8_t> under(num_pred);
  for (int64_t t = 0; t < num_thresh; ++t) {
    const double score_th = thresholds[t];
    std::fill(assigned.begin(), assigned.end(), 0);
    for (int64_t j = 0; j < num_pred; ++j) {
      under[j] = pred_scores[j] < score_th;
    }
    int64_t tp = 0, fp = 0, fn = 0;
    for (int64_t i = 0; i < num_gt; ++i) {
      if (gt_flag[i] == -1) continue;
      int64_t det = -1;
      bool detected = false;
      double best_iou = 0.0;
      bool to_ignore = false;
      for (int64_t j = 0; j < num_pred; ++j) {
        if (pred_flag[j] == -1 || assigned[j] || under[j]) continue;
        const double v = iou[i * num_pred + j];
        if (v > iou_threshold && (v > best_iou || to_ignore) &&
            pred_flag[j] == 0) {
          best_iou = v;
          det = j;
          detected = true;
          to_ignore = false;
        } else if (v > iou_threshold && !detected && pred_flag[j] == 1) {
          det = j;
          detected = true;
          to_ignore = true;
        }
      }
      if (!detected && gt_flag[i] == 0) {
        ++fn;
      } else if (detected && (gt_flag[i] == 1 || pred_flag[det] == 1)) {
        assigned[det] = 1;
      } else if (detected) {
        ++tp;
        assigned[det] = 1;
      }
    }
    for (int64_t j = 0; j < num_pred; ++j) {
      if (!(assigned[j] || pred_flag[j] == -1 || pred_flag[j] == 1 || under[j])) {
        ++fp;
      }
    }
    out[t * 3 + 0] = tp;
    out[t * 3 + 1] = fp;
    out[t * 3 + 2] = fn;
  }
}

}  // extern "C"
