// Rotated-box IoU and greedy rotated NMS on the card.
//
// Replaces no Pallas kernel: the JAX package computes these in plain JAX
// (tmae_tpu/ops/geometry.py: _sh_intersection_area_flat :40, boxes_iou_bev
// :159, boxes_iou3d :166, boxes_iou3d_aligned :179, nms_bev_mask :199),
// where centerpoint_predict(nms_on_device=True) and the IoU-head loss use
// them. The reference runs nms_gpu, a CUDA op, for the same step.
//
// The shared device function clips rectangle A by the four half-planes of
// rectangle B (Sutherland-Hodgman) in 8 vertex slots held in registers, with
// the plain version's arithmetic step for step (tmae_tpu_torch/ops/
// geometry.py): pad slots duplicate the first vertex, so the cyclic next
// vertex of slot s is slot (s + 1) % 8; the crossing's division is guarded
// by |denom| > 1e-12; the emitted points are compacted in order, at most 8;
// fewer than 3 vertices give area 0. Built with -fmad=false, so no product
// and sum is contracted into one rounding where the plain version rounds
// twice.
//
// Kernels:
//   iou_pairs_kernel    one thread per pair of [N] x [M]: BEV (mode 0) or 3D
//                       (mode 1) IoU.
//   iou_aligned_kernel  one aligned pair on 8 lanes, lane s holding vertex
//                       slot s of the clip: 3D IoU.
//   nms_mask_kernel     the suppression mask uint64 [B, K, ceil(K / 64)]:
//                       bit c of word ct of row i is set when column j =
//                       64 ct + c > i, both boxes take part, they share a
//                       class (one class unless labels are given) and their
//                       BEV IoU exceeds that class's threshold; words left
//                       of the diagonal are 0. A block of 256 threads takes
//                       16 row boxes against a tile of 64 column boxes
//                       (four blocks a 64 x 64 tile); blocks left of the
//                       diagonal write their zero words and return. The
//                       block stages both sets' corners, areas, centres,
//                       radii and classes in shared memory once, tests its
//                       1024 pairs (two ballots a row build the word of
//                       pairs to clip), skips pairs of different classes
//                       and pairs whose circumscribed circles lie apart
//                       (IoU exactly 0: the margin covers f32 rounding),
//                       lists the rest and clips the list spread over all
//                       256 threads.
//   nms_scan_kernel     one warp a sample: lane l holds the removed words
//                       l, l + 32, ... in registers; the mask streams
//                       through shared memory in slabs of 64 rows x 32
//                       words (cp.async, two buffers: the next slab loads
//                       while the current one is used); the rows are
//                       decided 64 at a time: the block's removed word
//                       comes from the lane holding it with one shuffle,
//                       two ballots mark the rows whose diagonal word
//                       removes a later row of the block, and the warp
//                       walks only those in order; per-class caps (at
//                       most 32 classes, lane c counts class c) are applied
//                       exactly by walking a block again from the first
//                       row that a full class would have kept; every lane
//                       then ORs the kept rows' words into its own. Row i
//                       is kept when it takes part, is not removed and its
//                       class has kept fewer than its cap.
//
// Bound: operations. At t_mae.yaml's K = 500 candidates a sample, the mask
// clips at most K (K - 1) / 2 pairs, 262 f32 operations each
// (PAIR_CLIP_FLOPS in ops/geometry.py), 33 MFLOP: 0.49 us at 67 TFLOP/s;
// the pairs this data needs (one class, circles that may meet) are far
// fewer (4500 on a served pair: 0.02 us); its bytes (14 KB of boxes in, 32
// KB of mask out) take 0.01 us. The scan is a dependent walk of K steps;
// its bytes are the 32 KB of mask. Design: the mask spreads the pairs that
// need a clip evenly over 144 blocks of 8 warps at K = 500, so what is
// left is the launch, the staging (a sincos a box) and one clip's latency
// a thread: ~7 us at K = 500. The scan's walk stays serial by nature, but
// a step is a few register operations and only the rows that remove a
// later row of their block are walked: ~10 us at K = 500. What holds the
// scan back next is the one warp's latency, ~2.6k cycles a block at K =
// 500 (utils/nms_phases.py --cycles): the slab's 8-byte cp.async copies
// (~750), the ORs' 64 shared-memory loads a lane (~700), the classes
// (~430) and the walk (~350); a second warp that copies the slabs and ORs
// the words past the next block would take the first two off the chain.
// The per-class thresholds and caps go by value in the launch, so no
// launch waits for a host copy.

#include "common.cuh"

namespace {

constexpr int kSlots = 8;
constexpr int kTile = 64;         // columns of a mask tile: one uint64 word
constexpr int kGroupRows = 16;    // row boxes of a mask block
constexpr int kGroups = kTile / kGroupRows;
constexpr int kMaskThreads = 256;
constexpr int kMaxClasses = 32;
constexpr int kScanMaxK = 64 * 32 * 64;  // 64 removed words a lane
constexpr int kSlabStride = 33;  // words a slab row: 32, one of padding
// the circle test's margin: kSkipAbs metres plus kSkipRel of the pair's
// coordinate scale (ops/geometry.py SKIP_ABS, SKIP_REL)
constexpr float kSkipAbs = 1e-3f;
constexpr float kSkipRel = 1e-4f;

// Per-class thresholds and caps, passed by value: no copy to the device
// before a launch, so nothing waits for the stream.
struct ClassParams {
  float thresh[kMaxClasses];
  int post[kMaxClasses];
};

struct Box {
  float x, y, z, dx, dy, dz, ang;
};

__device__ __forceinline__ Box load_box(const float* p) {
  return Box{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
}

// Counter-clockwise BEV corners, as boxes_to_corners_bev computes them.
__device__ __forceinline__ void corners(const Box& b, float cx[4],
                                        float cy[4]) {
  const float tx[4] = {0.5f, -0.5f, -0.5f, 0.5f};
  const float ty[4] = {0.5f, 0.5f, -0.5f, -0.5f};
  const float c = cosf(b.ang), s = sinf(b.ang);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lx = tx[k] * b.dx, ly = ty[k] * b.dy;
    const float rx = lx * c - ly * s;
    const float ry = lx * s + ly * c;
    cx[k] = rx + b.x;
    cy[k] = ry + b.y;
  }
}

// Puts (vx, vy) in slot cnt of (nx, ny) when cnt < kSlots; unrolled selects
// keep the slots in registers.
__device__ __forceinline__ void emit(float nx[kSlots], float ny[kSlots],
                                     int cnt, float vx, float vy) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (k == cnt) {
      nx[k] = vx;
      ny[k] = vy;
    }
  }
}

// BEV intersection area of A (corners ax, ay) clipped by B (bx, by).
__device__ float clip_area(const float ax[4], const float ay[4],
                           const float bx[4], const float by[4]) {
  float px[kSlots], py[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    px[s] = s < 4 ? ax[s] : 0.f;
    py[s] = s < 4 ? ay[s] : 0.f;
  }
  int n = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float fx = px[0], fy = py[0];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (s >= n) {
        px[s] = fx;
        py[s] = fy;
      }
    }
    const float e0x = bx[e], e0y = by[e];
    const float exx = bx[(e + 1) % 4] - e0x, exy = by[(e + 1) % 4] - e0y;
    float d[kSlots];
    bool in[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      d[s] = exx * (py[s] - e0y) - exy * (px[s] - e0x);
      in[s] = d[s] >= 0.f;
    }
    float nx[kSlots], ny[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      nx[s] = 0.f;
      ny[s] = 0.f;
    }
    int cnt = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int t = (s + 1) % kSlots;
      if (s < n) {
        if (in[s]) {
          emit(nx, ny, cnt, px[s], py[s]);
          ++cnt;
        }
        if (in[s] != in[t]) {
          const float denom = d[s] - d[t];
          const float tt = d[s] / (fabsf(denom) > 1e-12f ? denom : 1.f);
          emit(nx, ny, cnt, px[s] + tt * (px[t] - px[s]),
               py[s] + tt * (py[t] - py[s]));
          ++cnt;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      px[s] = nx[s];
      py[s] = ny[s];
    }
    n = cnt < kSlots ? cnt : kSlots;
  }
  // shoelace; pads duplicate the first vertex and close the cycle
  const float fx = px[0], fy = py[0];
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = (s + 1) % kSlots;
    const float qx = t < n ? px[t] : fx, qy = t < n ? py[t] : fy;
    if (s < n) sum += px[s] * qy - py[s] * qx;
  }
  return n >= 3 ? 0.5f * fabsf(sum) : 0.f;
}

__device__ __forceinline__ float iou_bev(float inter, float area_a,
                                         float area_b) {
  return inter / fmaxf(area_a + area_b - inter, 1e-6f);
}

__device__ __forceinline__ float iou_3d(float inter_bev, const Box& a,
                                        const Box& b) {
  const float amax = a.z + a.dz / 2.f, amin = a.z - a.dz / 2.f;
  const float bmax = b.z + b.dz / 2.f, bmin = b.z - b.dz / 2.f;
  const float inter_h = fmaxf(fminf(amax, bmax) - fmaxf(amin, bmin), 0.f);
  const float inter = inter_bev * inter_h;
  const float vol_a = a.dx * a.dy * a.dz, vol_b = b.dx * b.dy * b.dz;
  return inter / fmaxf(vol_a + vol_b - inter, 1e-6f);
}

__device__ __forceinline__ float pair_iou(const Box& a, const Box& b,
                                          int mode) {
  float ax[4], ay[4], bx[4], by[4];
  corners(a, ax, ay);
  corners(b, bx, by);
  const float inter = clip_area(ax, ay, bx, by);
  return mode == 0 ? iou_bev(inter, a.dx * a.dy, b.dx * b.dy)
                   : iou_3d(inter, a, b);
}

__global__ void iou_pairs_kernel(const float* __restrict__ a,
                                 const float* __restrict__ b, int N, int M,
                                 int mode, float* __restrict__ out) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(N) * M) return;
  const int i = static_cast<int>(idx / M), j = static_cast<int>(idx % M);
  out[idx] = pair_iou(load_box(a + 7LL * i), load_box(b + 7LL * j), mode);
}

constexpr int kAlignedThreads = 128;  // IOU_ALIGNED: 16 pairs a block

// IOU_ALIGNED: one pair on 8 lanes of a warp, lane s of the group holding
// vertex slot s of clip_area's polygon. Lanes 0-3 compute A's corners, 4-7
// B's (one cos and one sin a lane), so lane s < 4 starts with A's corner
// s. Each half-plane pass: the pad slots take slot 0 (one shuffle), every
// slot's signed distance and its crossing with the next slot (shuffles
// from lane s + 1) at once, with clip_area's roundings; two ballots mark
// the slots that emit their vertex and their crossing, and output slot k
// takes, from the slot whose prefix of emitted points reaches k, its
// vertex or its crossing: the sequential loop's order. The shoelace's
// terms are summed in clip_area's order by shuffles, and the group's lane
// 0 takes the 3D IoU. A pair's chain is then four passes of a few
// shuffles and one division; 500 pairs run on 125 warps. Measured
// (utils/nms_phases.py, NVIDIA H100 80GB HBM3, 700.00 W, device time):
// 500 pairs 0.0023 ms against 0.0052 for one thread a pair, the same bits.
__global__ void __launch_bounds__(kAlignedThreads)
    iou_aligned_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, int n,
                       float* __restrict__ out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x % 32, s = lane % kSlots;
  const int base = lane - s;  // the group's lane 0
  const long long pair =
      (static_cast<long long>(blockIdx.x) * kAlignedThreads + threadIdx.x) /
      kSlots;
  // a group past n repeats the last pair: every lane takes the shuffles
  const long long i = pair < n ? pair : n - 1;
  const Box own = load_box((s < 4 ? a : b) + 7 * i);
  float cx, cy;  // corner s % 4 of A (s < 4) or of B
  {
    const int k = s % 4;  // corners()' template: (+-0.5, +-0.5)
    const float tx = k == 0 || k == 3 ? 0.5f : -0.5f;
    const float ty = k < 2 ? 0.5f : -0.5f;
    const float c = cosf(own.ang), sn = sinf(own.ang);
    const float lx = tx * own.dx, ly = ty * own.dy;
    cx = (lx * c - ly * sn) + own.x;
    cy = (lx * sn + ly * c) + own.y;
  }
  float px = s < 4 ? cx : 0.f, py = s < 4 ? cy : 0.f;
  const int next = base + (s + 1) % kSlots;
  int nv = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float fx = __shfl_sync(full, px, base);
    const float fy = __shfl_sync(full, py, base);
    if (s >= nv) {
      px = fx;
      py = fy;
    }
    const float e0x = __shfl_sync(full, cx, base + 4 + e);
    const float e0y = __shfl_sync(full, cy, base + 4 + e);
    const float exx = __shfl_sync(full, cx, base + 4 + (e + 1) % 4) - e0x;
    const float exy = __shfl_sync(full, cy, base + 4 + (e + 1) % 4) - e0y;
    const float d = exx * (py - e0y) - exy * (px - e0x);
    const float dn = __shfl_sync(full, d, next);
    const float pxn = __shfl_sync(full, px, next);
    const float pyn = __shfl_sync(full, py, next);
    const bool live = s < nv;
    const bool in = d >= 0.f;
    const unsigned vin = (__ballot_sync(full, live && in) >> base) & 0xffu;
    const unsigned vcr =
        (__ballot_sync(full, live && in != (dn >= 0.f)) >> base) & 0xffu;
    const float denom = d - dn;
    const float tt = d / (fabsf(denom) > 1e-12f ? denom : 1.f);
    const float qx = px + tt * (pxn - px), qy = py + tt * (pyn - py);
    // output slot s: from slot j, whose emitted points start at pos
    int src = 0;
    bool cross = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const unsigned lt = (1u << j) - 1u;
      const int pos = __popc(vin & lt) + __popc(vcr & lt);
      const int vj = (vin >> j) & 1u;
      if (vj && pos == s) {
        src = j;
        cross = false;
      }
      if (((vcr >> j) & 1u) && pos + vj == s) {
        src = j;
        cross = true;
      }
    }
    const int cnt = __popc(vin) + __popc(vcr);
    const float vx = __shfl_sync(full, px, base + src);
    const float vy = __shfl_sync(full, py, base + src);
    const float wx = __shfl_sync(full, qx, base + src);
    const float wy = __shfl_sync(full, qy, base + src);
    px = s < cnt ? (cross ? wx : vx) : 0.f;
    py = s < cnt ? (cross ? wy : vy) : 0.f;
    nv = cnt < kSlots ? cnt : kSlots;
  }
  // shoelace; pads duplicate the first vertex and close the cycle
  const float fx = __shfl_sync(full, px, base);
  const float fy = __shfl_sync(full, py, base);
  float qx = __shfl_sync(full, px, next), qy = __shfl_sync(full, py, next);
  if ((s + 1) % kSlots >= nv) {
    qx = fx;
    qy = fy;
  }
  const float term = s < nv ? px * qy - py * qx : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const float tj = __shfl_sync(full, term, base + j);
    if (j < nv) sum += tj;
  }
  if (s == 0 && pair < n) {
    const float inter = nv >= 3 ? 0.5f * fabsf(sum) : 0.f;
    out[i] = iou_3d(inter, load_box(a + 7 * i), load_box(b + 7 * i));
  }
}

// 0-based class of candidate i, -1 when it takes no part.
__device__ __forceinline__ int class_of(const bool* valid, const int* labels,
                                        long long i, int ncls) {
  if (!valid[i]) return -1;
  if (labels == nullptr) return 0;
  const int c = labels[i] - 1;
  return (c >= 0 && c < ncls) ? c : -1;
}

// A row's validity and label as loaded a block ahead (label 1 without
// labels, 0 past K), and its 0-based class from them, -1 when it takes no
// part: the scan loads the next block's rows and first uses them a block
// later, so nothing waits for the loads.
struct RowTag {
  bool valid;
  int label;
};

__device__ __forceinline__ RowTag load_tag(const bool* valid,
                                           const int* labels, long long i,
                                           bool inside) {
  if (!inside) return RowTag{false, 0};
  return RowTag{valid[i], labels == nullptr ? 1 : labels[i]};
}

__device__ __forceinline__ int tag_class(RowTag t, int ncls) {
  return (t.valid && t.label >= 1 && t.label <= ncls) ? t.label - 1 : -1;
}

// The two 32-lane ballots of a warp as one 64-bit word: lane l's `lo` is bit
// l, its `hi` bit 32 + l (the mask's column order within a word).
__device__ __forceinline__ unsigned long long ballot64(bool lo, bool hi) {
  return static_cast<unsigned long long>(__ballot_sync(~0u, lo)) |
         static_cast<unsigned long long>(__ballot_sync(~0u, hi)) << 32;
}

// True when the circumscribed circles of two boxes (centres x, y; radii the
// half diagonals) lie apart by more than a margin that covers f32 rounding
// of the corners and of the clip: then the clip of the pair leaves no
// vertex inside and its area is exactly 0. NaN gives false.
__device__ __forceinline__ bool circles_apart(float xi, float yi, float ri,
                                              float xj, float yj, float rj) {
  const float dx = xi - xj, dy = yi - yj;
  const float scale =
      fabsf(xi) + fabsf(yi) + fabsf(xj) + fabsf(yj) + ri + rj;
  const float reach = ri + rj + kSkipAbs + kSkipRel * scale;
  return dx * dx + dy * dy > reach * reach;
}

// The BEV corners, area, centre, radius and class of candidate `idx` (class
// -1 past K) into slot s of the block's shared arrays.
struct TileBoxes {
  float cx[4][kTile], cy[4][kTile], area[kTile], x[kTile], y[kTile],
      rad[kTile];
  int cls[kTile];
};

__device__ __forceinline__ void stage_box(TileBoxes& t, int s,
                                          const float* boxes,
                                          const bool* valid,
                                          const int* labels, long long base,
                                          int idx, int K, int ncls) {
  int cls = -1;
  if (idx < K) {
    cls = class_of(valid, labels, base + idx, ncls);
    const Box b = load_box(boxes + 7 * (base + idx));
    float cx[4], cy[4];
    corners(b, cx, cy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t.cx[k][s] = cx[k];
      t.cy[k][s] = cy[k];
    }
    t.area[s] = b.dx * b.dy;
    t.x[s] = b.x;
    t.y[s] = b.y;
    t.rad[s] = 0.5f * sqrtf(b.dx * b.dx + b.dy * b.dy);
  }
  t.cls[s] = cls;
}

// Block (column tile ct, row group g of row tile rt, sample b): rows
// 64 rt + 16 g .. + 16 against the 64 columns of tile ct. Left of the
// diagonal it writes its zero words and returns. Otherwise it stages the
// column and row boxes once, tests the 1024 pairs (warp w: rows 2w, 2w + 1;
// lane l: columns l and 32 + l) for j > i, a shared class and circles that
// may meet, lists the pairs that need a clip with two ballots a row, clips
// the list spread over all 256 threads and ORs each suppression into its
// row's word in shared memory.
__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const bool* __restrict__ valid,
                    const int* __restrict__ labels, const ClassParams cp,
                    int K, int ncls, unsigned long long* __restrict__ mask) {
  const int words = gridDim.y;
  const int ct = blockIdx.x / kGroups, g = blockIdx.x % kGroups;
  const int rt = blockIdx.y, b = blockIdx.z;
  const long long base = static_cast<long long>(b) * K;
  const int row0 = rt * kTile + g * kGroupRows;
  if (row0 >= K) return;
  const int nrows = min(kGroupRows, K - row0);
  const int t = threadIdx.x;
  if (ct < rt) {
    if (t < nrows) mask[(base + row0 + t) * words + ct] = 0ull;
    return;
  }
  __shared__ TileBoxes col;
  __shared__ TileBoxes row;  // the first kGroupRows slots
  __shared__ unsigned short items[kGroupRows * kTile];
  __shared__ unsigned long long res[kGroupRows];
  __shared__ int nitems;
  if (t < kTile) {
    stage_box(col, t, boxes, valid, labels, base, ct * kTile + t, K, ncls);
  } else if (t < kTile + kGroupRows) {
    const int r = t - kTile;
    stage_box(row, r, boxes, valid, labels, base,
              r < nrows ? row0 + r : K, K, ncls);
  }
  if (t < kGroupRows) res[t] = 0ull;
  if (t == 0) nitems = 0;
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int h = 0; h < kGroupRows / (kMaskThreads / 32); ++h) {
    const int r = warp * (kGroupRows / (kMaskThreads / 32)) + h;
    const int i = row0 + r, ci = row.cls[r];
    // a pair of boxes apart has IoU exactly 0, which passes a threshold
    // only when the threshold is negative
    const bool may_skip = ci >= 0 && cp.thresh[ci] >= 0.f;
    bool need[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half;
      need[half] = ci >= 0 && ct * kTile + c > i && col.cls[c] == ci &&
                   !(may_skip && circles_apart(row.x[r], row.y[r],
                                               row.rad[r], col.x[c],
                                               col.y[c], col.rad[c]));
    }
    const unsigned lo = __ballot_sync(~0u, need[0]);
    const unsigned hi = __ballot_sync(~0u, need[1]);
    int at = 0;
    if (lane == 0 && (lo | hi)) at = atomicAdd(&nitems, __popc(lo) + __popc(hi));
    at = __shfl_sync(~0u, at, 0);
    if (need[0]) items[at + __popc(lo & below)] = r * kTile + lane;
    if (need[1])
      items[at + __popc(lo) + __popc(hi & below)] = r * kTile + 32 + lane;
  }
  __syncthreads();

  const int n = nitems;
  for (int k = t; k < n; k += kMaskThreads) {
    const int r = items[k] / kTile, c = items[k] % kTile;
    float ax[4], ay[4], bx[4], by[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ax[q] = row.cx[q][r];
      ay[q] = row.cy[q][r];
      bx[q] = col.cx[q][c];
      by[q] = col.cy[q][c];
    }
    const float inter = clip_area(ax, ay, bx, by);
    if (iou_bev(inter, row.area[r], col.area[c]) > cp.thresh[row.cls[r]])
      atomicOr(&res[r], 1ull << c);
  }
  __syncthreads();
  if (t < nrows) mask[(base + row0 + t) * words + ct] = res[t];
}

// cp.async of 8 bytes from device memory into shared memory, its commit and
// its wait (the scan's mask slabs).
__device__ __forceinline__ void copy_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Starts the copy of one slab of block `blk` (rows [r0, r0 + nrows)):
// the words [max(w0, blk), w0 + 32) of each row, fewer past the last word
// (the block reads no word left of its own), of a sample's mask (mrow,
// `words` a row) into buf at column w - w0, kSlabStride words a row; one
// commit group a lane.
__device__ __forceinline__ void start_slab(unsigned long long* buf,
                                           const unsigned long long* mrow,
                                           int words, int r0, int nrows,
                                           int w0, int blk, int lane) {
  const int lo = max(w0, blk);
  const int nw = min(w0 + 32, words) - lo;
  const int per = 32 / nw;  // rows a pass of the warp
  const int rr = lane / nw, c = lane % nw;
  if (rr < per) {
    unsigned long long* dst = buf + rr * kSlabStride + (lo - w0) + c;
    const unsigned long long* src =
        mrow + static_cast<long long>(r0 + rr) * words + lo + c;
    const int dstep = per * kSlabStride;
    const long long sstep = static_cast<long long>(per) * words;
#pragma unroll 4
    for (int r = rr; r < nrows; r += per) {
      copy_async8(dst, src);
      dst += dstep;
      src += sstep;
    }
  }
  copy_commit();
}

// Bits of the rows after row r of a 64-row block.
__device__ __forceinline__ unsigned long long after(int r) {
  return r >= 63 ? 0ull : ~0ull << (r + 1);
}

// OR of column `col` (a lane's word) over the slab rows in `kept`, 16
// shared-memory loads in flight at a time.
__device__ __forceinline__ unsigned long long or_kept(
    const unsigned long long* col, unsigned long long kept) {
  unsigned long long acc = 0ull;
#pragma unroll
  for (int r0 = 0; r0 < 64; r0 += 16) {
    if (!((kept >> r0) & 0xFFFFull)) continue;
    unsigned long long v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      v[q] = (kept >> (r0 + q)) & 1ull ? col[(r0 + q) * kSlabStride] : 0ull;
#pragma unroll
    for (int q = 0; q < 16; ++q) acc |= v[q];
  }
  return acc;
}

// Position of the (n + 1)-th set bit of x (it has more than n).
__device__ __forceinline__ int nth_bit(unsigned long long x, int n) {
  for (int k = 0; k < n; ++k) x &= x - 1ull;
  return __ffsll(static_cast<long long>(x)) - 1;
}

__device__ __forceinline__ unsigned long long or_warp(unsigned long long v) {
  return static_cast<unsigned long long>(
             __reduce_or_sync(~0u, static_cast<unsigned>(v))) |
         static_cast<unsigned long long>(
             __reduce_or_sync(~0u, static_cast<unsigned>(v >> 32)))
             << 32;
}

// Built with -DTMAE_NMS_PROFILE, lane 0 of each sample's warp adds the
// cycles of each part of a block into g_nms_cycles (read and reset by
// tmae_nms_profile; utils/nms_phases.py --cycles): 0 the block's classes,
// 1 a slab's copy start and wait, 2 the removed word, the ballots of the
// rows that remove, the rooms, 3 the walk and the caps, 4 the keep bytes,
// 5 the ORs.
#ifdef TMAE_NMS_PROFILE
__device__ unsigned long long g_nms_cycles[8];
#define NMS_PART(k)                                         \
  do {                                                      \
    if (lane == 0) {                                        \
      const long long now = clock64();                      \
      atomicAdd(&g_nms_cycles[k],                           \
                static_cast<unsigned long long>(now - t_prev)); \
      t_prev = now;                                         \
    }                                                       \
  } while (0)
#else
#define NMS_PART(k) \
  do {              \
  } while (0)
#endif

// One warp a sample walks its rows in blocks of 64. Lane l holds the
// removed words l, l + 32, ... (M of them) in registers and, for class l,
// its kept count and the block's rows of that class. The mask streams
// through shared memory in slabs of 64 rows x 32 words, two buffers: the
// next slab is copied (cp.async) while the current one is used. For block
// k (its first slab holds word k): the rows that take part and are not in
// removed word k (from the lane holding it, one shuffle) are candidates;
// two ballots mark the rows whose word k removes a later row of the block;
// the warp walks only those rows, in order, from the slab (a dropped
// candidate removes nothing); each class lane finds the first kept row of
// its class beyond the class's room, and the earliest such row and the
// later rows of its class leave the candidates and the walk is repeated
// (at most once more per class that fills in the block). The keep bytes
// of the 64 rows are written, then on each of the block's slabs every lane
// ORs the kept rows' words into its own words past k.
template <int M>
__global__ void __launch_bounds__(32)
    nms_scan_kernel(const unsigned long long* __restrict__ mask,
                    const bool* __restrict__ valid,
                    const int* __restrict__ labels, const ClassParams cp,
                    int K, int ncls, bool* __restrict__ keep) {
  __shared__ unsigned long long slab[2][64 * kSlabStride];
  const int lane = threadIdx.x;
#ifdef TMAE_NMS_PROFILE
  long long t_prev = clock64();
#endif
  const int words = (K + 63) / 64, last = (words - 1) >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * K;
  const unsigned long long* mrow = mask + base * words;
  unsigned long long removed[M];
#pragma unroll
  for (int m = 0; m < M; ++m) removed[m] = 0ull;
  const int cap = lane < ncls ? cp.post[lane] : 0;
  int count = 0;
  RowTag t0 = load_tag(valid, labels, base + lane, lane < K);
  RowTag t1 = load_tag(valid, labels, base + 32 + lane, 32 + lane < K);
  int buf = 0;
  start_slab(slab[0], mrow, words, 0, min(64, K), 0, 0, lane);
  for (int blk = 0; blk < words; ++blk) {
    const int r0 = blk * 64, nrows = min(64, K - r0);
    // rows r0 + lane (low half) and r0 + 32 + lane (high half)
    const int c0 = tag_class(t0, ncls), c1 = tag_class(t1, ncls);
    const unsigned long long take = ballot64(c0 >= 0, c1 >= 0);
    unsigned long long mine = lane == 0 ? take : 0ull;  // one class
    for (int c = 0; ncls > 1 && c < ncls; ++c) {
      const unsigned long long rows = ballot64(c0 == c, c1 == c);
      if (lane == c) mine = rows;
    }
    const int i0 = r0 + lane, i1 = r0 + 32 + lane;
    const int n0 = r0 + 64 + lane, n1 = r0 + 96 + lane;
    t0 = load_tag(valid, labels, base + n0, n0 < K);
    t1 = load_tag(valid, labels, base + n1, n1 < K);
    unsigned long long kept = 0ull;
    NMS_PART(0);
    for (int m = blk >> 5; m <= last; ++m) {
      const int nb = m < last ? blk : blk + 1;
      const int nm = m < last ? m + 1 : (blk + 1) >> 5;
      __syncwarp();  // every lane is done with the buffer copied into next
      if (nb < words)
        start_slab(slab[buf ^ 1], mrow, words, nb * 64,
                   min(64, K - nb * 64), nm * 32, nb, lane);
      else
        copy_commit();
      copy_wait_all_but_one();
      __syncwarp();
      NMS_PART(1);
      const unsigned long long* S = slab[buf];
      if (m == (blk >> 5)) {
        const int cb = blk & 31;
        unsigned long long own = 0ull;
#pragma unroll
        for (int q = 0; q < M; ++q)
          if (q == m) own = removed[q];
        const unsigned long long gone = __shfl_sync(~0u, own, cb);
        const unsigned long long inf = ballot64(
            (S[lane * kSlabStride + cb] & after(lane)) != 0ull,
            (S[(32 + lane) * kSlabStride + cb] & after(32 + lane)) != 0ull);
        const int room = lane < ncls ? max(cap - count, 0) : 64;
        unsigned long long out = or_warp(room == 0 ? mine : 0ull);
        NMS_PART(2);
        for (;;) {
          unsigned long long cand = take & ~gone & ~out;
          for (unsigned long long x = cand & inf; x;) {
            const int r = __ffsll(static_cast<long long>(x)) - 1;
            cand &= ~(S[r * kSlabStride + cb] & after(r));
            x = cand & inf & after(r);
          }
          kept = cand;
          const unsigned long long kc = kept & mine;
          const int over = __popcll(kc) > room ? nth_bit(kc, room) : 64;
          const unsigned first =
              __reduce_min_sync(~0u, static_cast<unsigned>(over));
          if (first == 64u) break;
          const int cls =
              __ffs(__ballot_sync(~0u, over == static_cast<int>(first))) - 1;
          out |= __shfl_sync(~0u, mine, cls) & (~0ull << first);
        }
        NMS_PART(3);
        count += __popcll(kept & mine);
        if (i0 < K) keep[base + i0] = (kept >> lane) & 1ull;
        if (i1 < K) keep[base + i1] = (kept >> (32 + lane)) & 1ull;
        NMS_PART(4);
      }
      const int w = 32 * m + lane;
      if (kept && w > blk && w < words) {
        const unsigned long long acc = or_kept(S + lane, kept);
#pragma unroll
        for (int q = 0; q < M; ++q)
          if (q == m) removed[q] |= acc;
      }
      NMS_PART(5);
      buf ^= 1;
    }
  }
}

}  // namespace

extern "C" int launch_iou_pairs(const float* a, const float* b, int N, int M,
                                int mode, float* out, cudaStream_t stream) {
  const long long n = static_cast<long long>(N) * M;
  const int threads = 256;
  iou_pairs_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                     threads, 0, stream>>>(a, b, N, M, mode, out);
  return tmae_last_error();
}

extern "C" int launch_iou_aligned(const float* a, const float* b, int n,
                                  float* out, cudaStream_t stream) {
  if (n < 1) return 0;
  const long long threads = static_cast<long long>(n) * kSlots;
  iou_aligned_kernel<<<(threads + kAlignedThreads - 1) / kAlignedThreads,
                       kAlignedThreads, 0, stream>>>(a, b, n, out);
  return tmae_last_error();
}

static bool class_params(const float* thresh, const int* post, int ncls,
                         ClassParams* cp) {
  if (ncls < 1 || ncls > kMaxClasses) return false;
  for (int c = 0; c < ncls; ++c) {
    cp->thresh[c] = thresh ? thresh[c] : 0.f;
    cp->post[c] = post ? post[c] : 0;
  }
  return true;
}

// thresh: ncls host floats.
extern "C" int launch_nms_mask(const float* boxes, const bool* valid,
                               const int* labels, const float* thresh, int B,
                               int K, int ncls, unsigned long long* mask,
                               cudaStream_t stream) {
  ClassParams cp{};
  if (!class_params(thresh, nullptr, ncls, &cp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (K + kTile - 1) / kTile;
  nms_mask_kernel<<<dim3(tiles * kGroups, tiles, B), kMaskThreads, 0,
                    stream>>>(boxes, valid, labels, cp, K, ncls, mask);
  return tmae_last_error();
}

template <int M>
static int scan(const unsigned long long* mask, const bool* valid,
                const int* labels, const ClassParams& cp, int B, int K,
                int ncls, bool* keep, cudaStream_t stream) {
  nms_scan_kernel<M><<<B, 32, 0, stream>>>(mask, valid, labels, cp, K, ncls,
                                            keep);
  return tmae_last_error();
}

// posts: ncls host ints. K at most kScanMaxK (64 removed words a lane).
extern "C" int launch_nms_scan(const unsigned long long* mask,
                               const bool* valid, const int* labels,
                               const int* posts, int B, int K, int ncls,
                               bool* keep, cudaStream_t stream) {
  ClassParams cp{};
  if (!class_params(nullptr, posts, ncls, &cp) || K > kScanMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_lane = ((K + 63) / 64 + 31) / 32;
  const auto args = [&](auto fn) {
    return fn(mask, valid, labels, cp, B, K, ncls, keep, stream);
  };
  if (per_lane <= 1) return args(scan<1>);
  if (per_lane <= 2) return args(scan<2>);
  if (per_lane <= 4) return args(scan<4>);
  if (per_lane <= 8) return args(scan<8>);
  if (per_lane <= 16) return args(scan<16>);
  if (per_lane <= 32) return args(scan<32>);
  return args(scan<64>);
}

#ifdef TMAE_NMS_PROFILE
extern "C" int tmae_nms_profile(unsigned long long* out8) {
  static const unsigned long long zero[8] = {};
  const int e = (int)cudaMemcpyFromSymbol(out8, g_nms_cycles, sizeof zero);
  return e ? e : (int)cudaMemcpyToSymbol(g_nms_cycles, zero, sizeof zero);
}
#endif
