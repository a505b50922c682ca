// Kernels K1 and K2: occupied-window gather and scatter against the padded
// BEV carrier.
//
// Replace tmae_tpu/ops/occ_compact.py:_gather_pallas_multi (kernel
// _gather_multi_kernel, entry gather_windows_padded) and
// _scatter_into_pallas_multi (kernel _scatter_multi_kernel, entry
// scatter_windows_into_padded). On the TPU each grid step issued 16 window
// DMAs from scalar-prefetched coordinates.
//
// Bound: memory. Each call moves B x cap x 64 x C bf16 values once in and
// once out (2 x 2 x 960 x 64 x 128 x 2 bytes = 63 MB at stage 1); there is no
// arithmetic.
//
// Design: one block per (window slot, sample) copies one 8 x 8 x C window.
// Its 256 threads walk the window's cells with 16-byte vector loads, so each
// cell row of C channels is a run of contiguous 16-byte transactions. A block
// reads its own window coordinates. Dummy slots (wy >= nwy, the window row
// below the padded grid) produce zeros in the gather and are skipped by the
// scatter, so they never write the carrier; the scatter writes in place into
// the carrier, and windows outside the plan keep their content.

#include "common.cuh"

namespace {

constexpr int kWindow = 8;
constexpr int kCells = kWindow * kWindow;
constexpr int kThreads = 256;

__device__ __forceinline__ bool real_window(int wy, int wx, int nwy, int Hp2,
                                            int Wp) {
  return wy >= 0 && wy < nwy && wx >= 0 && (wy + 1) * kWindow <= Hp2 &&
         (wx + 1) * kWindow <= Wp;
}

__global__ void gather_windows_kernel(const uint4* __restrict__ xp,
                                      const int* __restrict__ idx,
                                      uint4* __restrict__ out, int Hp2, int Wp,
                                      int C, int cap, int nwy) {
  const int slot = blockIdx.x;
  const int b = blockIdx.y;
  const long long s = (long long)b * cap + slot;
  const int wy = idx[2 * s];
  const int wx = idx[2 * s + 1];
  const int vc = C / 8;  // 16-byte vectors per cell
  uint4* dst = out + s * kCells * vc;
  if (!real_window(wy, wx, nwy, Hp2, Wp)) {
    for (int t = threadIdx.x; t < kCells * vc; t += kThreads)
      dst[t] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const uint4* src = xp + (long long)b * Hp2 * Wp * vc;
  for (int t = threadIdx.x; t < kCells * vc; t += kThreads) {
    const int cell = t / vc;
    const int v = t - cell * vc;
    const int y = wy * kWindow + cell / kWindow;
    const int x = wx * kWindow + cell % kWindow;
    dst[t] = src[((long long)y * Wp + x) * vc + v];
  }
}

__global__ void scatter_windows_kernel(const uint4* __restrict__ xw,
                                       const int* __restrict__ idx,
                                       uint4* __restrict__ xp, int Hp2, int Wp,
                                       int C, int cap, int nwy) {
  const int slot = blockIdx.x;
  const int b = blockIdx.y;
  const long long s = (long long)b * cap + slot;
  const int wy = idx[2 * s];
  const int wx = idx[2 * s + 1];
  if (!real_window(wy, wx, nwy, Hp2, Wp)) return;
  const int vc = C / 8;
  const uint4* src = xw + s * kCells * vc;
  uint4* dst = xp + (long long)b * Hp2 * Wp * vc;
  for (int t = threadIdx.x; t < kCells * vc; t += kThreads) {
    const int cell = t / vc;
    const int v = t - cell * vc;
    const int y = wy * kWindow + cell / kWindow;
    const int x = wx * kWindow + cell % kWindow;
    dst[((long long)y * Wp + x) * vc + v] = src[t];
  }
}

}  // namespace

extern "C" int launch_gather_windows(const void* xp, const void* idx, void* out,
                                     int B, int Hp2, int Wp, int C, int cap,
                                     int nwy, void* stream) {
  if (cap == 0 || B == 0) return 0;
  gather_windows_kernel<<<dim3(cap, B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(xp), static_cast<const int*>(idx),
      static_cast<uint4*>(out), Hp2, Wp, C, cap, nwy);
  return tmae_last_error();
}

extern "C" int launch_scatter_windows(const void* xw, const void* idx, void* xp,
                                      int B, int Hp2, int Wp, int C, int cap,
                                      int nwy, void* stream) {
  if (cap == 0 || B == 0) return 0;
  scatter_windows_kernel<<<dim3(cap, B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(xw), static_cast<const int*>(idx),
      static_cast<uint4*>(xp), Hp2, Wp, C, cap, nwy);
  return tmae_last_error();
}
