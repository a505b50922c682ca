// Kernels K1, K2 and K13c: occupied-window gather and scatter against the
// padded BEV carrier, and the scatter-into of the unpadded grid.
//
// K1 and K2 replace tmae_tpu/ops/occ_compact.py:_gather_pallas_multi
// (kernel _gather_multi_kernel, entry gather_windows_padded) and
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
//
// K13c replaces tmae_tpu/ops/occ_compact.py:526 _scatter_into_pallas (its
// pallas_call at :549; kernel _scatter_kernel_init at :339): out [B, H, W,
// C] is init [B, H, W, C] with the plan's windows of the shift's partition
// replaced by xw [B, cap, 64, C]. The TPU kernel aliased the padded init
// into its output and moved only the planned windows; on this card that is
// a pad of init (a zero fill and a copy of the whole grid), the windows,
// and a crop. Bound: memory, the bytes the function must move: read init
// outside the plan and xw's planned windows, write the grid once (224 MB
// at stage 1, 2 x 468 x 468 x 128 bf16). Design: slot_map_kernel, one
// block, writes the slot that names each window of the partition into a
// map [B, nwy, nwx] (-1: no slot); then scatter_into_grid_kernel,
// one block per (window of the partition, sample), copies the window's
// in-grid cells from xw[map] or from init with 16-byte vectors, straight
// into the unpadded, contiguous output. Every output cell is written once.

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

// One block: every entry of map [B, nwy, nwx] set to -1, then, one thread
// per slot s = b cap + j, map[b, wy, wx] = s for each slot that names a
// window of the partition (the plan names each window at most once; its
// dummy slots, wy >= nwy, name none).
__global__ void __launch_bounds__(1024)
    slot_map_kernel(const int* __restrict__ idx, int* __restrict__ map,
                    int n_map, int n, int cap, int nwy, int nwx) {
  for (int i = threadIdx.x; i < n_map; i += blockDim.x) map[i] = -1;
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int wy = idx[2 * s], wx = idx[2 * s + 1];
    if (wy >= 0 && wy < nwy && wx >= 0 && wx < nwx)
      map[((long long)(s / cap) * nwy + wy) * nwx + wx] = s;
  }
}

// One block per (window (wy, wx) of the partition, sample b): the window's
// cells (8 wy - off + iy, 8 wx - off + ix) that lie on the grid, vc 16-byte
// vectors a cell, from slot map[b, wy, wx] of xw or, without one, from init.
// A window row's cells are contiguous in xw, init and out alike.
__global__ void __launch_bounds__(kThreads)
    scatter_into_grid_kernel(const uint4* __restrict__ xw,
                             const int* __restrict__ map,
                             const uint4* __restrict__ init,
                             uint4* __restrict__ out, int H, int W, int vc,
                             int nwy, int nwx, int off) {
  const int b = blockIdx.y;
  const int wy = blockIdx.x / nwx;
  const int wx = blockIdx.x - wy * nwx;
  const int y0 = wy * kWindow - off, x0 = wx * kWindow - off;
  const int ylo = max(y0, 0), yhi = min(y0 + kWindow, H);
  const int xlo = max(x0, 0), xhi = min(x0 + kWindow, W);
  if (ylo >= yhi || xlo >= xhi) return;
  const int s = map[(long long)b * nwy * nwx + blockIdx.x];
  const int span = (xhi - xlo) * vc;  // vectors of a window row on the grid
  const int n = (yhi - ylo) * span;
#pragma unroll 4
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / span;
    const int k = e - r * span;
    const int y = ylo + r;
    const long long g = (((long long)b * H + y) * W + xlo) * vc + k;
    out[g] = s >= 0 ? xw[((long long)s * kCells + (y - y0) * kWindow +
                          (xlo - x0)) * vc + k]
                    : init[g];
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

// K13c: out [B, H, W, C] = init with the windows that idx [B, cap, 2] names
// in the shift's partition (offset `off` = 8 or 4, nwy x nwx windows)
// replaced by xw [B, cap, 64, C]; vc = the 16-byte vectors of a cell's C
// values (any element type). `map`: int32 workspace [B, nwy, nwx].
extern "C" int launch_scatter_into_grid(const void* xw, const void* idx,
                                        const void* init, void* out,
                                        void* map, int B, int H, int W,
                                        int vc, int cap, int nwy, int nwx,
                                        int off, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  slot_map_kernel<<<1, 1024, 0, s>>>(static_cast<const int*>(idx),
                                     static_cast<int*>(map), B * nwy * nwx,
                                     B * cap, cap, nwy, nwx);
  int e = tmae_last_error();
  if (e) return e;
  scatter_into_grid_kernel<<<dim3(nwy * nwx, B), kThreads, 0, s>>>(
      static_cast<const uint4*>(xw), static_cast<const int*>(map),
      static_cast<const uint4*>(init), static_cast<uint4*>(out), H, W, vc,
      nwy, nwx, off);
  return tmae_last_error();
}
