// Kernel K5: per-pillar max over points sorted by pillar slot.
//
// Replaces tmae_tpu/ops/sorted_segments.py:69 sorted_segment_max (its
// pallas_call at :87; kernel _scan_kernel at :42), a segmented running max
// that carries the last slot and its max from one grid step to the next,
// followed by a gather at seg_ends.
//
// Function: feat [B, P, C] f32, rows sorted by slot seg [B, P] (invalid rows
// carry the out-of-range slot V, after every present pillar); pillar v
// covers rows (seg_ends[v-1], seg_ends[v]] (from row 0 for v = 0), as
// voxelize_host(..., sort_points=True) gives them (present slots 0..n-1 in
// ascending order); out [B, V, C] is each present pillar's max and 0 for an
// absent one (mask false). Rows of slot V are never read.
//
// Bound: memory. Each valid row is read once (P x C x 4 bytes, 47 MB for
// the 91811 rows of a served t_mae.yaml frame at C = 128) and each pillar
// row written once (V x C x 4 bytes, 16.8 MB); one max per element.
//
// What held the first port's design back (one warp per pillar walking its
// rows): pillar sizes are skewed (median 3 rows, p99 212, max 551 on a
// served frame), so a few warps, each with ~550 dependent row reads, set
// the time while the card idled; and a warp ran for each of the 32768
// slots.
//
// Design: the work is split by rows, not by pillars, in two launches.
//   1. slice_max_kernel: one warp per slice of kSlice consecutive rows of
//      a batch row, its lanes on the float4 columns (a row read is one
//      coalesced 512-byte transaction at C = 128), 8 rows' loads in flight
//      a lane. The warp takes the segmented max of its slice from the slots
//      in seg. A segment that begins and ends inside the slice is complete:
//      it is stored straight into out (if present). Only the slice's first
//      and last segment can span slices: the max of the first one's rows
//      here, when it began in an earlier slice, goes to part[slice][0]
//      (head), and of the last one's rows, when it goes on into the next
//      slice and began here, to part[slice][1] (tail). A segment that
//      covers the whole slice is its head.
//   2. span_merge_kernel: one warp per pillar. An absent pillar gets 0. A
//      present pillar whose rows lie in two or more slices sf < sl gets
//      max(tail[sf], head[sf + 1], ..., head[sl]); any other was stored by
//      pass 1. Every element of out is written exactly once, with no atomics
//      and no initialisation, and the max is exact: the result equals the
//      plain version bit for bit. (Writing the zeros of the absent pillars
//      in pass 1 instead, a share of the slots a warp, made pass 1 3 us
//      slower and pass 2 1 us faster on an H100, at a served frame's sizes
//      in utils/fwd_phases.py.)

#include "common.cuh"

namespace {

constexpr int kSlice = 64;        // rows a warp
constexpr int kWarps = 4;         // warps a block
constexpr int kBatch = 8;         // row loads in flight a lane

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
    slice_max_kernel(const float* __restrict__ feat,
                     const S* __restrict__ seg,
                     const bool* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ part, int B, int P, int V, int C,
                     int nslice) {
  __shared__ int slots[kWarps][kSlice];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  if (gw >= (long long)B * nslice) return;
  const int b = (int)(gw / nslice);
  const int s = (int)(gw % nslice);
  const int r0 = s * kSlice;
  const int n_rows = min(kSlice, P - r0);
  const S* sg = seg + (long long)b * P;
  int* sl = slots[warp];
  for (int i = lane; i < kSlice; i += 32)
    sl[i] = i < n_rows ? (int)sg[r0 + i] : V;
  __syncwarp();
  // the valid rows are a prefix of the slice: slots are non-decreasing and
  // invalid rows carry V
  int n = 0;
  for (int i = 0; i < n_rows; i += 32) {
    const bool ok = i + lane < n_rows && sl[i + lane] < V;
    n += __popc(__ballot_sync(0xffffffffu, ok));
  }
  if (n == 0) return;
  const int before = r0 > 0 ? (int)sg[r0 - 1] : -1;
  const int after = r0 + n < P ? (int)sg[r0 + n] : V;
  const int c4 = C / 4;
  const float4* rows = reinterpret_cast<const float4*>(feat) +
                       ((long long)b * P + r0) * c4;
  float4* dst = reinterpret_cast<float4*>(out) + (long long)b * V * c4;
  float4* head = reinterpret_cast<float4*>(part) + gw * 2 * c4;
  float4* tail = head + c4;
  for (int j = lane; j < c4; j += 32) {
    int cur = sl[0];
    bool began_here = cur != before;
    float4 m = rows[j];
    for (int i0 = 0; i0 < n; i0 += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u < n) x[u] = rows[(long long)(i0 + u) * c4 + j];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u;
        if (i >= n) break;
        const int si = sl[i];
        if (si == cur) {
          m = max4(m, x[u]);
          continue;
        }
        // segment cur ended at row i - 1
        if (!began_here)
          head[j] = m;
        else if (mask[(long long)b * V + cur])
          dst[(long long)cur * c4 + j] = m;
        cur = si;
        began_here = true;
        m = x[u];
      }
    }
    // the last segment ends here unless the next row continues it
    if (cur == after) {
      if (began_here)
        tail[j] = m;
      else
        head[j] = m;
    } else if (!began_here) {
      head[j] = m;
    } else if (mask[(long long)b * V + cur]) {
      dst[(long long)cur * c4 + j] = m;
    }
  }
}

__global__ void __launch_bounds__(256)
    span_merge_kernel(const int* __restrict__ seg_ends,
                      const bool* __restrict__ mask,
                      const float* __restrict__ part, float* __restrict__ out,
                      int B, int V, int C, int nslice) {
  const int lane = threadIdx.x % 32;
  const long long pillar = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (pillar >= (long long)B * V) return;
  const int b = (int)(pillar / V);
  const int v = (int)(pillar % V);
  const int c4 = C / 4;
  float4* dst = reinterpret_cast<float4*>(out) + pillar * c4;
  if (!mask[pillar]) {
    for (int j = lane; j < c4; j += 32)
      dst[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int* ends = seg_ends + (long long)b * V;
  const int last = ends[v];
  const int first = v == 0 ? 0 : ends[v - 1] + 1;
  const int sf = first / kSlice;
  const int sl = last / kSlice;
  if (sf == sl) return;  // stored by slice_max_kernel
  const float4* pb =
      reinterpret_cast<const float4*>(part) + (long long)b * nslice * 2 * c4;
  for (int j = lane; j < c4; j += 32) {
    float4 m = pb[((long long)sf * 2 + 1) * c4 + j];
    for (int s = sf + 1; s <= sl; ++s)
      m = max4(m, pb[(long long)s * 2 * c4 + j]);
    dst[j] = m;
  }
}

}  // namespace

// out [B, V, C]; seg int32, or int64 when `seg64`; `part` the f32 workspace
// [B, ceil(P / 64), 2, C] (needs no initialisation). Two launches on
// `stream`.
extern "C" int launch_sorted_segment_max(const void* feat, const void* seg,
                                         int seg64, const void* seg_ends,
                                         const void* mask, void* out,
                                         void* part, int B, int P, int V,
                                         int C, void* stream) {
  if (C % 4 || B < 0 || P < 0 || V < 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * V == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nslice = (P + kSlice - 1) / kSlice;
  const long long warps = (long long)B * nslice;
  if (warps > 0) {
    const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
    const float* f = static_cast<const float*>(feat);
    const bool* m = static_cast<const bool*>(mask);
    float* o = static_cast<float*>(out);
    float* pt = static_cast<float*>(part);
    if (seg64)
      slice_max_kernel<<<blocks, kWarps * 32, 0, st>>>(
          f, static_cast<const long long*>(seg), m, o, pt, B, P, V, C,
          nslice);
    else
      slice_max_kernel<<<blocks, kWarps * 32, 0, st>>>(
          f, static_cast<const int*>(seg), m, o, pt, B, P, V, C, nslice);
    const int e = tmae_last_error();
    if (e) return e;
  }
  const long long pillars = (long long)B * V;
  span_merge_kernel<<<(unsigned)((pillars + 7) / 8), 256, 0, st>>>(
      static_cast<const int*>(seg_ends), static_cast<const bool*>(mask),
      static_cast<const float*>(part), static_cast<float*>(out), B, V, C,
      nslice);
  return tmae_last_error();
}
