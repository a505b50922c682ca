// Kernel K5: per-pillar max over points sorted by pillar slot.
//
// Replaces tmae_tpu/ops/sorted_segments.py:sorted_segment_max (Pallas kernel
// _scan_kernel), a segmented running max that carries the last slot and its
// max from one grid step to the next, followed by a gather at seg_ends.
//
// Bound: memory. Each valid point row is read once (P x C x 4 bytes, 64 MB
// at 131072 x 128) and each pillar row written once (V x C x 4 bytes); the
// arithmetic is one max per element.
//
// Design: Hopper blocks run in parallel and in no order, so nothing can carry
// a running max from one block to the next. The host voxelizer already gives
// each pillar's run of rows: pillar v covers rows (seg_ends[v-1], seg_ends[v]]
// (from row 0 for v = 0), because present slots are 0..n-1 in ascending
// order. One warp reduces one pillar; its lanes cover the channels with
// 16-byte loads, so each row read is a coalesced 512-byte transaction at
// C = 128. Absent pillars (mask false) get 0; rows of the out-of-range slot
// lie after the last present pillar and are never read.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void sorted_segment_max_kernel(const float* __restrict__ feat,
                                          const int* __restrict__ seg_ends,
                                          const bool* __restrict__ mask,
                                          float* __restrict__ out,
                                          int B, int P, int V, int C) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long pillar = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (pillar >= (long long)B * V) return;
  const int b = (int)(pillar / V);
  const int v = (int)(pillar % V);
  const int c4 = C / 4;
  float4* dst = reinterpret_cast<float4*>(out + pillar * C);
  if (!mask[pillar]) {
    for (int j = lane; j < c4; j += 32) dst[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int* ends = seg_ends + (long long)b * V;
  const int last = ends[v];
  const int first = v == 0 ? 0 : ends[v - 1] + 1;
  const float4* rows = reinterpret_cast<const float4*>(feat + (long long)b * P * C);
  for (int j = lane; j < c4; j += 32) {
    float4 m = make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F);
    for (int r = first; r <= last; ++r) {
      const float4 x = rows[(long long)r * c4 + j];
      m.x = fmaxf(m.x, x.x);
      m.y = fmaxf(m.y, x.y);
      m.z = fmaxf(m.z, x.z);
      m.w = fmaxf(m.w, x.w);
    }
    dst[j] = m;
  }
}

}  // namespace

extern "C" int launch_sorted_segment_max(const void* feat, const void* seg_ends,
                                         const void* mask, void* out, int B,
                                         int P, int V, int C, void* stream) {
  const long long pillars = (long long)B * V;
  const int blocks = (int)((pillars + kWarpsPerBlock - 1) / kWarpsPerBlock);
  sorted_segment_max_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const int*>(seg_ends),
      static_cast<const bool*>(mask), static_cast<float*>(out), B, P, V, C);
  return tmae_last_error();
}
