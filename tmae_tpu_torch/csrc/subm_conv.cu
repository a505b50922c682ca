// Kernel K15: the 3x3 submanifold convolution on the occupied 8x8 windows
// of an unshifted plan.
//
// Replaces tmae_tpu/ops/sparse_conv.py:_subm_conv_pallas (kernel
// _conv_kernel), the forward of subm_conv3x3. For every plan slot of every
// sample it computes the SAME 3x3 conv of the window's 64 cells,
// out[c, o] = (bias[o] + sum_{ky,kx,i} x[cell + (ky-1, kx-1), i] *
// w[ky, kx, i, o]) * qmask[c], into the compact [B, cap, 64, Cout] tensor;
// the caller scatters it onto the grid (K2, the JAX package's K13b).
//
// Geometry: window (wy, wx) of the unshifted plan covers grid rows
// 8 (wy - 1) .. 8 wy - 1 and columns 8 (wx - 1) .. 8 wx - 1 (the plan pads
// one window at the top and left). Its 10 x 10 halo starts one cell above
// and left of that; halo cells off the grid read as zero (SAME padding). A
// dummy slot (wy >= nwy, the window row below the padded grid, as the
// plan's padding names it) has qmask 0 on every cell, so its output is
// zero: the block writes zeros and exits.
//
// Bound: operations. Per planned window 2 x 64 x 9 x Cin x Cout flops
// (9.4 MFLOP at Cin = Cout = 128, 38 MFLOP at 256) against its 100-cell
// halo, a bf16 64 x Cout output and the 9 x Cin x Cout bf16 weights, which
// every window shares: at C = 256 about 75 MFLOP per 85 KB of window data,
// far above the card's bf16 ridge of ~295 flops per byte. The weights (295
// KB at 128, 1.2 MB at 256) do not fit in shared memory and are read
// through L2 by every block.
//
// Design, simple first: one block of 8 warps per (plan slot, sample). The
// block loads the window's halo into shared memory (16-byte vectors, zeros
// off the grid), then runs the conv as 9 tap products [64, Cin] x
// [Cin, Cout] on the tensor cores: WMMA m8n32k16 bf16 fragments with f32
// accumulation, one 8-row A fragment per window row, which is a contiguous
// run of 8 halo cells for every tap, so no im2col copy is needed. A warp
// owns a 32-column chunk of the output and R window rows, and reuses each
// weight fragment across its R rows; weight fragments come straight from
// global memory (L2). The epilogue adds the bias, multiplies by the cell's
// qmask and writes 8 bf16 values per 16-byte store. Staging the weights in
// shared memory, several windows per block and wgmma are later work.

#include "wmma_tiles.cuh"

namespace {

constexpr int kWarpsC = 8;
constexpr int kThreadsC = kWarpsC * 32;
constexpr int kHalo = 10;     // halo side of an 8 x 8 window
constexpr int kHaloPad = 16;  // bf16 row padding: keeps rows 32-byte aligned
constexpr int kStC = 36;      // f32 staging row stride (8 x 32 tile)

typedef wmma::fragment<wmma::matrix_a, 8, 32, 16, bf16, wmma::row_major> A8;
typedef wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16, wmma::row_major> B8;
typedef wmma::fragment<wmma::accumulator, 8, 32, 16, float> Acc8;

// R: window rows per warp task; the 8 / R row groups of each 32-column chunk
// are separate tasks.
template <int R>
__global__ void __launch_bounds__(kThreadsC)
    subm_conv_kernel(const bf16* __restrict__ xg, const int* __restrict__ idx,
                     const float* __restrict__ qmask,
                     const bf16* __restrict__ wmat,
                     const float* __restrict__ bias, bf16* __restrict__ out,
                     int H, int W, int Cin, int Cout, int cap, int nwy,
                     int nwx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = Cin + kHaloPad;
  bf16* halo = reinterpret_cast<bf16*>(smem);
  float* st_all = reinterpret_cast<float*>(smem + (size_t)kHalo * kHalo *
                                                      ldh * sizeof(bf16));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long s = (long long)blockIdx.y * cap + blockIdx.x;
  const int wy = idx[2 * s];
  const int wx = idx[2 * s + 1];
  bf16* dst = out + s * 64 * Cout;
  const int vo = Cout / 8;
  if (wy < 0 || wy >= nwy || wx < 0 || wx >= nwx) {
    for (int t = tid; t < 64 * vo; t += kThreadsC)
      reinterpret_cast<uint4*>(dst)[t] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  // ---- the 10 x 10 halo, zeros off the grid -----------------------------
  const int vc = Cin / 8;
  const bf16* frame = xg + (long long)blockIdx.y * H * W * Cin;
  const int y0 = 8 * (wy - 1) - 1;
  const int x0 = 8 * (wx - 1) - 1;
  for (int t = tid; t < kHalo * kHalo * vc; t += kThreadsC) {
    const int cell = t / vc;
    const int v = t - cell * vc;
    const int y = y0 + cell / kHalo;
    const int x = x0 + cell % kHalo;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (y >= 0 && y < H && x >= 0 && x < W)
      val = reinterpret_cast<const uint4*>(
          frame + ((long long)y * W + x) * Cin)[v];
    *reinterpret_cast<uint4*>(halo + cell * ldh + v * 8) = val;
  }
  __syncthreads();

  // ---- 9 tap products on the tensor cores --------------------------------
  constexpr int kGroups = 8 / R;
  const int tasks = (Cout / 32) * kGroups;
  float* st = st_all + warp * 8 * kStC;
  for (int task = warp; task < tasks; task += kWarpsC) {
    const int n0 = 32 * (task / kGroups);
    const int r0 = R * (task % kGroups);
    Acc8 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) wmma::fill_fragment(acc[r], 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap - 3 * ky;
      const bf16* wt = wmat + (long long)tap * Cin * Cout + n0;
      for (int k0 = 0; k0 < Cin; k0 += 16) {
        B8 b;
        wmma::load_matrix_sync(b, wt + (long long)k0 * Cout, Cout);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          A8 a;
          wmma::load_matrix_sync(
              a, halo + ((r0 + r + ky) * kHalo + kx) * ldh + k0, ldh);
          wmma::mma_sync(acc[r], a, b, acc[r]);
        }
      }
    }
    // ---- bias, per-cell mask, bf16 store ---------------------------------
    const int row = lane / 4;       // in-window column of the cell
    const int c0 = (lane % 4) * 8;  // 8 output channels per lane
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wmma::store_matrix_sync(st, acc[r], kStC, wmma::mem_row_major);
      __syncwarp();
      const int cell = (r0 + r) * 8 + row;
      const float qm = qmask[s * 64 + cell];
      uint4 packed;
      bf16* pv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        pv[c] = __float2bfloat16((st[row * kStC + c0 + c] + bias[n0 + c0 + c]) *
                                 qm);
      *reinterpret_cast<uint4*>(dst + (long long)cell * Cout + n0 + c0) =
          packed;
      __syncwarp();
    }
  }
}

template <int R>
int launch(const void* xg, const void* idx, const void* qmask,
           const void* wmat, const void* bias, void* out, int B, int H, int W,
           int Cin, int Cout, int cap, int nwy, int nwx, cudaStream_t stream) {
  const size_t smem = (size_t)kHalo * kHalo * (Cin + kHaloPad) * sizeof(bf16) +
                      (size_t)kWarpsC * 8 * kStC * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      subm_conv_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  subm_conv_kernel<R><<<dim3(cap, B), kThreadsC, smem, stream>>>(
      static_cast<const bf16*>(xg), static_cast<const int*>(idx),
      static_cast<const float*>(qmask), static_cast<const bf16*>(wmat),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W, Cin,
      Cout, cap, nwy, nwx);
  return tmae_last_error();
}

}  // namespace

// out [B, cap, 64, Cout] bf16 = the SubM conv of xg [B, H, W, Cin] bf16 with
// wmat [3, 3, Cin, Cout] bf16 and bias [Cout] f32 on the windows idx
// [B, cap, 2] of the unshifted plan, masked by qmask [B, cap, 64] f32.
extern "C" int launch_subm_conv(const void* xg, const void* idx,
                                const void* qmask, const void* wmat,
                                const void* bias, void* out, int B, int H,
                                int W, int Cin, int Cout, int cap, int nwy,
                                int nwx, void* stream) {
  if (Cin % 16 || Cin > 1024 || Cout % 32 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  if (cap == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = Cout / 32;
  if (chunks >= 8)
    return launch<8>(xg, idx, qmask, wmat, bias, out, B, H, W, Cin, Cout, cap,
                     nwy, nwx, st);
  if (chunks >= 4)
    return launch<4>(xg, idx, qmask, wmat, bias, out, B, H, W, Cin, Cout, cap,
                     nwy, nwx, st);
  if (chunks >= 2)
    return launch<2>(xg, idx, qmask, wmat, bias, out, B, H, W, Cin, Cout, cap,
                     nwy, nwx, st);
  return launch<1>(xg, idx, qmask, wmat, bias, out, B, H, W, Cin, Cout, cap,
                   nwy, nwx, st);
}
