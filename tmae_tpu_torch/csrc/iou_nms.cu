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
//   iou_aligned_kernel  one thread per aligned pair: 3D IoU.
//   nms_mask_kernel     one block of 64 threads per tile of 64 row boxes x
//                       64 column boxes of one sample; the column boxes'
//                       corners, areas and classes are staged in shared
//                       memory, each thread takes one row box and writes
//                       one uint64 word: bit c is set when column j = 64 *
//                       tile + c > i, both boxes take part, they share a
//                       class (one class unless labels are given) and the
//                       BEV IoU exceeds that class's threshold. Tiles left
//                       of the diagonal write 0.
//   nms_scan_kernel     one block per sample: stages chunks of mask rows and
//                       the rows' classes in shared memory, then one warp
//                       walks the rows in order with the removed set in
//                       shared memory (no load from device memory in the
//                       walk): row i
//                       is kept when it takes part, is not removed and its
//                       class has kept fewer than its cap; a kept row ORs
//                       its words into the removed set (a word a lane).
//
// Bound: operations. At t_mae.yaml's K = 500 candidates a sample, the mask
// clips K (K - 1) / 2 pairs, 262 f32 operations each (PAIR_CLIP_FLOPS in
// ops/geometry.py), 33 MFLOP: 0.49 us at 67 TFLOP/s; its bytes (14 KB of
// boxes in, 32 KB of mask out) take 0.01 us. The scan is a dependent walk of
// K steps; its bytes are the 32 KB of mask. Design: simple first. One pair a
// thread with no early exit; the scan's walk is serial by nature (the
// reference's nms_gpu runs it on the host). The per-class thresholds and
// caps go by value in the launch, so no launch waits for a host copy.

#include "common.cuh"

namespace {

constexpr int kSlots = 8;
constexpr int kTile = 64;
constexpr int kMaxClasses = 32;

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

__global__ void iou_aligned_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b, int n,
                                   float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = pair_iou(load_box(a + 7 * i), load_box(b + 7 * i), 1);
}

// 0-based class of candidate i, -1 when it takes no part.
__device__ __forceinline__ int class_of(const bool* valid, const int* labels,
                                        long long i, int ncls) {
  if (!valid[i]) return -1;
  if (labels == nullptr) return 0;
  const int c = labels[i] - 1;
  return (c >= 0 && c < ncls) ? c : -1;
}

__global__ void __launch_bounds__(kTile)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const bool* __restrict__ valid,
                    const int* __restrict__ labels, const ClassParams cp,
                    int K, int ncls, unsigned long long* __restrict__ mask) {
  __shared__ float scx[4][kTile], scy[4][kTile], sarea[kTile];
  __shared__ int scls[kTile];
  const int words = gridDim.x;
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  const long long base = static_cast<long long>(b) * K;
  const int j = ct * kTile + threadIdx.x;
  int cls = -1;
  if (j < K) {
    cls = class_of(valid, labels, base + j, ncls);
    const Box bj = load_box(boxes + 7 * (base + j));
    float cx[4], cy[4];
    corners(bj, cx, cy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      scx[k][threadIdx.x] = cx[k];
      scy[k][threadIdx.x] = cy[k];
    }
    sarea[threadIdx.x] = bj.dx * bj.dy;
  }
  scls[threadIdx.x] = cls;
  __syncthreads();
  const int i = rt * kTile + threadIdx.x;
  if (i >= K) return;
  unsigned long long bits = 0ull;
  const int ci = ct >= rt ? class_of(valid, labels, base + i, ncls) : -1;
  if (ci >= 0) {
    const Box bi = load_box(boxes + 7 * (base + i));
    float ax[4], ay[4];
    corners(bi, ax, ay);
    const float area_i = bi.dx * bi.dy;
    const float th = cp.thresh[ci];
    const int cend = min(kTile, K - ct * kTile);
    for (int c = 0; c < cend; ++c) {
      if (ct * kTile + c <= i || scls[c] != ci) continue;
      float bx[4], by[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        bx[k] = scx[k][c];
        by[k] = scy[k][c];
      }
      const float inter = clip_area(ax, ay, bx, by);
      if (iou_bev(inter, area_i, sarea[c]) > th) bits |= 1ull << c;
    }
  }
  mask[(base + i) * words + ct] = bits;
}

constexpr int kScanThreads = 256;
constexpr int kScanSmem = 40 * 1024;  // bytes of mask rows (and classes)

__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const unsigned long long* __restrict__ mask,
                    const bool* __restrict__ valid,
                    const int* __restrict__ labels, const ClassParams cp,
                    int K, int ncls, int chunk_rows,
                    bool* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  const int words = (K + 63) / 64;
  unsigned long long* rows = smem;                          // chunk x words
  unsigned long long* removed = smem + chunk_rows * words;  // words
  int* count = reinterpret_cast<int*>(removed + words);     // ncls
  int* cls = count + kMaxClasses;                           // chunk
  const int b = blockIdx.x;
  const long long base = static_cast<long long>(b) * K;
  const unsigned long long* mrow = mask + base * words;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
  for (int c = threadIdx.x; c < ncls; c += blockDim.x) count[c] = 0;
  for (int r0 = 0; r0 < K; r0 += chunk_rows) {
    const int nr = min(chunk_rows, K - r0);
    __syncthreads();  // the previous chunk's walk is done with rows[]
    for (int w = threadIdx.x; w < nr * words; w += blockDim.x)
      rows[w] = mrow[static_cast<long long>(r0) * words + w];
    for (int r = threadIdx.x; r < nr; r += blockDim.x)
      cls[r] = class_of(valid, labels, base + r0 + r, ncls);
    __syncthreads();
    if (threadIdx.x >= 32) continue;
    const int lane = threadIdx.x;
    for (int r = 0; r < nr; ++r) {
      const int i = r0 + r;
      const int c = cls[r];
      // every lane reads the same words and takes the same decision
      const bool kept = c >= 0 && !((removed[i >> 6] >> (i & 63)) & 1ull) &&
                        count[c] < cp.post[c];
      __syncwarp();
      if (kept) {
        for (int w = lane; w < words; w += 32)
          removed[w] |= rows[r * words + w];
        if (lane == 0) ++count[c];
      }
      if (lane == 0) keep[base + i] = kept;
      __syncwarp();
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
  const int threads = 256;
  iou_aligned_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      a, b, n, out);
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
  nms_mask_kernel<<<dim3(tiles, tiles, B), kTile, 0, stream>>>(
      boxes, valid, labels, cp, K, ncls, mask);
  return tmae_last_error();
}

// posts: ncls host ints.
extern "C" int launch_nms_scan(const unsigned long long* mask,
                               const bool* valid, const int* labels,
                               const int* posts, int B, int K, int ncls,
                               bool* keep, cudaStream_t stream) {
  ClassParams cp{};
  if (!class_params(nullptr, posts, ncls, &cp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (K + 63) / 64;
  const int row_bytes = words * 8 + 4;  // a row's mask words and its class
  int chunk = kScanSmem / row_bytes;
  if (chunk < 1) chunk = 1;
  if (chunk > K) chunk = K;
  const size_t smem = static_cast<size_t>(chunk) * words * 8 +
                      static_cast<size_t>(words) * 8 + kMaxClasses * 4 +
                      static_cast<size_t>(chunk) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_scan_kernel<<<B, kScanThreads, smem, stream>>>(mask, valid, labels, cp,
                                                     K, ncls, chunk, keep);
  return tmae_last_error();
}
