// The window plan shared by the forward encoder kernels
// (encoder_layer_tiled.cu: K3, K4, K6, K8, K10, K12; encoder_layer_narrow.cu:
// NARROW_FWD): the call's parameters, the three addressings of a window's
// cells, the pre-passes (one warp per window: the live flag, and the cells
// a window that is not live gets), and the rows of a tile of 64. A call runs
// a pre-pass, compact_kernel (wgmma_tiles.cuh: the live windows in window
// order, their count, the tile counter at 0), then its persistent kernel,
// which takes tiles of live windows from the counter and finds their rows
// with tile_rows.
#pragma once

#include "wgmma_tiles.cuh"

namespace {

constexpr int kRows = 64;                  // rows of a tile: wgmma's M
constexpr int kCells = 64;                 // cells of an 8 x 8 window

// How a tile finds its rows: window rows of a [.., 64, C] tensor (K3, K4,
// K6, K8), cells of a plan's windows in the padded carrier (K12) or cells of
// the grid's shifted partition (K10).
enum Addr { kWindowRows, kPlanCells, kGridCells };
// What a call computes and where (K8, K4, K6, K3, K10, K12, K16): the
// pre-pass, the addressing, whether the call packs its weights and whether
// the tile stops after the output projection follow.
enum Mode { kSelOut, kSelInPlace, kFullOut, kFullInPlace, kGridOut,
            kPlanInPlace, kAttnOut };

struct FwdParams {
  const bf16 *x, *kv, *pos;
  bf16* out;  // == x for K3, K4 and K12 (in place)
  const int *selq, *selk;
  const float *qmask, *kmask;  // K16: qmask is kmask (every token written)
  const unsigned char *qocc, *kocc;
  const int* widx;  // K12: the plan's windows (wy, wx) [nwin, 2]
  const float *bq, *bk, *bv, *bo, *tau, *ln1s, *ln1b, *b1, *b2, *ln2s, *ln2b;
  const bf16* panels;
  int* flags;    // [nwin] the window has an occupied query cell
  int* list;     // [nwin] the live windows in window order
  int* count;    // the number of live windows
  int* counter;  // the next tile to hand out
  int nwin, cross;
  float tau_min;
  // window rows: window w is row (w / cap) total + row_lo + w % cap of x,
  // kv and out (K6, K8: total = cap = nwin, row_lo = 0); plan cells: window
  // w is frame w / cap of the carrier
  int total, cap, row_lo;
  // K10: the grid [gh, gw] and its partition; K12: the carrier [gh = Hp + 8,
  // gw = Wp] and its nwy = gh / 8 - 1 rows of real windows
  int gh, gw, nwy, nwx, off;
};

__device__ __forceinline__ long long window_row(const FwdParams& p,
                                                long long w) {
  return (w / p.cap) * p.total + p.row_lo + w % p.cap;
}

// K12: slot w of the plan names a window of the carrier, not the dummy row
__device__ __forceinline__ bool plan_real(const FwdParams& p, long long w) {
  const int wy = p.widx[2 * w], wx = p.widx[2 * w + 1];
  return wy >= 0 && wy < p.nwy && wx >= 0 && (wx + 1) * 8 <= p.gw;
}

// The element offset of cell c of window w: in its window row (K3, K4, K6,
// K8), or at carrier cell (8 wy + c / 8, 8 wx + c % 8) of frame w / cap (K12)
template <Addr A, int C>
__device__ __forceinline__ long long cell_offset(const FwdParams& p,
                                                 long long w, int c) {
  if constexpr (A == kPlanCells) {
    const long long b = w / p.cap;
    const long long wy = p.widx[2 * w], wx = p.widx[2 * w + 1];
    return ((b * p.gh + 8 * wy + (c >> 3)) * p.gw + 8 * wx + (c & 7)) * C;
  } else {
    return (window_row(p, w) * kCells + c) * C;
  }
}

// bf16(x + pos), 8 values at a time
__device__ __forceinline__ uint4 add_pos(uint4 x, uint4 ps) {
  const uint32_t* xa = reinterpret_cast<const uint32_t*>(&x);
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&ps);
  uint4 s;
  uint32_t* sa = reinterpret_cast<uint32_t*>(&s);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 xf = unpack2(xa[k]);
    const float2 pf = unpack2(pa[k]);
    sa[k] = pack2(xf.x + pf.x, xf.y + pf.y);
  }
  return s;
}

// 8 elements of a weight row as bf16: copied (bf16 weights), or rounded to
// nearest even as torch's .to(torch.bfloat16) rounds them (f32 weights)
__device__ __forceinline__ uint4 load8(const bf16* src) {
  return *reinterpret_cast<const uint4*>(src);
}

__device__ __forceinline__ uint4 load8(const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y),
                    pack2(b.z, b.w));
}

// The tile's rows: window, query and key cell, offsets and masks of each of
// the 64 rows (threads 0..63). Window rows and plan cells: row r is slot i
// of window j = r / T of the tile, cell sel[i] of that window (K4, K8, K12:
// T = 16, 48) or cell i (K3, K6, K12: T = 64), addressed by cell_offset;
// grid cells (K10): cell r of the tile's window of the partition. Rows of
// no window read zeros, have no query or key and are not written.
template <Addr A, int T, int C>
__device__ __forceinline__ void tile_rows(const FwdParams& p, int tile,
                                          int count, int r, long long* qoff,
                                          long long* koff, int* qcell,
                                          int* kcell, float* qm, float* km) {
  constexpr int WPT = T == 16 ? 4 : 1;
  if constexpr (A == kGridCells) {
    const int win = p.list[tile];
    const int per = p.nwy * p.nwx;
    const int b = win / per;
    const int wy = (win - b * per) / p.nwx;
    const int wx = win - b * per - wy * p.nwx;
    const int y = wy * 8 + (r >> 3) - p.off;
    const int x = wx * 8 + (r & 7) - p.off;
    const bool in = y >= 0 && y < p.gh && x >= 0 && x < p.gw;
    const long long cell = ((long long)b * p.gh + y) * p.gw + x;
    const float q = (in && p.qocc[cell]) ? 1.f : 0.f;
    qm[r] = q;
    km[r] = p.cross ? ((in && p.kocc[cell]) ? 1.f : 0.f) : q;
    qoff[r] = koff[r] = in ? cell * C : -1;
    qcell[r] = kcell[r] = r;
  } else {
    const int j = r / T;
    const int i = r - j * T;
    const int slot = tile * WPT + j;
    if (j < WPT && slot < count) {
      const long long win = p.list[slot];
      const long long e = win * T + i;
      int sq = i, sk = i;
      if constexpr (T != kCells) {
        sq = min(max(p.selq[e], 0), kCells - 1);
        sk = (p.cross && p.selk) ? min(max(p.selk[e], 0), kCells - 1) : sq;
      }
      const float q = p.qmask[e];
      qm[r] = q;
      km[r] = p.cross ? p.kmask[e] : q;
      qoff[r] = cell_offset<A, C>(p, win, sq);
      koff[r] = cell_offset<A, C>(p, win, sk);
      qcell[r] = sq;
      kcell[r] = sk;
    } else {
      qm[r] = km[r] = 0.f;
      qoff[r] = koff[r] = -1;
      qcell[r] = kcell[r] = 0;
    }
  }
}

// K8 pre-pass, one warp per window: the live flag, and every cell the main
// kernel will not write (not both selected and occupied) copied through.
template <int T, int C>
__global__ void __launch_bounds__(256)
    sel_prepass_kernel(const FwdParams p) {
  const int lane = threadIdx.x & 31;
  const long long win = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (win >= p.nwin) return;
  uint32_t lo = 0u, hi = 0u;
  for (int i = lane; i < T; i += 32) {
    if (p.qmask[win * T + i] > 0.f) {
      const int c = min(max(p.selq[win * T + i], 0), kCells - 1);
      if (c < 32)
        lo |= 1u << c;
      else
        hi |= 1u << (c - 32);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo |= __shfl_xor_sync(0xffffffffu, lo, o);
    hi |= __shfl_xor_sync(0xffffffffu, hi, o);
  }
  if (lane == 0) p.flags[win] = (lo | hi) != 0u;
  const uint4* src = reinterpret_cast<const uint4*>(p.x + win * kCells * C);
  uint4* dst = reinterpret_cast<uint4*>(p.out + win * kCells * C);
  for (int e = lane; e < kCells * C / 8; e += 32) {
    const int cell = e / (C / 8);
    const uint32_t bit = cell < 32 ? (lo >> cell) : (hi >> (cell - 32));
    if (!(bit & 1u)) dst[e] = __ldg(src + e);
  }
}

// K10 pre-pass, one warp per window of the partition: the live flag, and
// zeros on the in-grid cells of a window with no occupied query cell.
template <int C>
__global__ void __launch_bounds__(256)
    grid_prepass_kernel(const FwdParams p) {
  const int lane = threadIdx.x & 31;
  const int win = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (win >= p.nwin) return;
  const int per = p.nwy * p.nwx;
  const int b = win / per;
  const int wy = (win - b * per) / p.nwx;
  const int wx = win - b * per - wy * p.nwx;
  const long long frame = (long long)b * p.gh * p.gw;
  bool occ = false;
  for (int i = lane; i < kCells; i += 32) {
    const int y = wy * 8 + (i >> 3) - p.off;
    const int x = wx * 8 + (i & 7) - p.off;
    if (y >= 0 && y < p.gh && x >= 0 && x < p.gw)
      occ |= p.qocc[frame + (long long)y * p.gw + x] != 0;
  }
  const bool live = __any_sync(0xffffffffu, occ);
  if (lane == 0) p.flags[win] = live;
  if (live) return;
  const int x0 = max(wx * 8 - p.off, 0);
  const int x1 = min(wx * 8 + 8 - p.off, p.gw);
  if (x1 <= x0) return;
  const int span = (x1 - x0) * C / 8;  // 16-byte stores a window row
  for (int iy = 0; iy < 8; ++iy) {
    const int y = wy * 8 + iy - p.off;
    if (y < 0 || y >= p.gh) continue;
    uint4* dst = reinterpret_cast<uint4*>(
        p.out + (frame + (long long)y * p.gw + x0) * C);
    for (int e = lane; e < span; e += 32) dst[e] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// K6 / K3 / K4 pre-pass, one warp per window: the live flag from the query
// mask [nwin, T]; with kZero (K6, K3) zeros on all 64 cells of the output
// row of a window that is not live. K4 writes nothing here: a window without
// a query keeps its row, which is already its output.
template <int T, int C, bool kZero>
__global__ void __launch_bounds__(256)
    mask_prepass_kernel(const FwdParams p) {
  const int lane = threadIdx.x & 31;
  const long long win = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (win >= p.nwin) return;
  bool occ = false;
  for (int i = lane; i < T; i += 32) occ |= p.qmask[win * T + i] > 0.f;
  const bool live = __any_sync(0xffffffffu, occ);
  if (lane == 0) p.flags[win] = live;
  if (!kZero || live) return;
  uint4* dst =
      reinterpret_cast<uint4*>(p.out + window_row(p, win) * kCells * C);
  for (int e = lane; e < kCells * C / 8; e += 32)
    dst[e] = make_uint4(0u, 0u, 0u, 0u);
}

// K12 pre-pass, one warp per plan slot: live when the slot names a window of
// the carrier (not the dummy row) with an occupied query cell. At T = 64 a
// real slot that is not live gets zeros on its 64 carrier cells (8 rows of
// 8 C contiguous values), the layer's output there; a dummy slot is never
// written, and at S = 16 or 48 nothing is (such a window keeps its cells).
template <int T, int C>
__global__ void __launch_bounds__(256)
    plan_prepass_kernel(const FwdParams p) {
  const int lane = threadIdx.x & 31;
  const long long win = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (win >= p.nwin) return;
  const bool real = plan_real(p, win);
  bool occ = false;
  if (real)
    for (int i = lane; i < T; i += 32) occ |= p.qmask[win * T + i] > 0.f;
  const bool live = __any_sync(0xffffffffu, occ);
  if (lane == 0) p.flags[win] = live;
  if constexpr (T == kCells) {
    if (!real || live) return;
    for (int iy = 0; iy < 8; ++iy) {
      uint4* dst = reinterpret_cast<uint4*>(
          p.out + cell_offset<kPlanCells, C>(p, win, 8 * iy));
      for (int e = lane; e < C; e += 32) dst[e] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// w: the 17 layer tensors (wq bq wk bk wv bv wo bo tau ln1s ln1b w1 b1 w2 b2
// ln2s ln2b), then w[17] the panels (8 C^2 bf16); `ints` the int32
// workspace [2 nwin + 2] (flags, list, count, counter). The serving modes
// read no matrix of w: those pointers may be null.
FwdParams make_params(const void* x, const void* kv, void* out,
                      const void* pos, const void* const* w, void* ints_,
                      int nwin, int cross, float tau_min) {
  FwdParams p{};
  p.x = static_cast<const bf16*>(x);
  p.kv = static_cast<const bf16*>(kv);
  p.out = static_cast<bf16*>(out);
  p.pos = static_cast<const bf16*>(pos);
  p.bq = static_cast<const float*>(w[1]);
  p.bk = static_cast<const float*>(w[3]);
  p.bv = static_cast<const float*>(w[5]);
  p.bo = static_cast<const float*>(w[7]);
  p.tau = static_cast<const float*>(w[8]);
  p.ln1s = static_cast<const float*>(w[9]);
  p.ln1b = static_cast<const float*>(w[10]);
  p.b1 = static_cast<const float*>(w[12]);
  p.b2 = static_cast<const float*>(w[14]);
  p.ln2s = static_cast<const float*>(w[15]);
  p.ln2b = static_cast<const float*>(w[16]);
  p.panels = static_cast<const bf16*>(w[17]);
  int* ints = static_cast<int*>(ints_);
  p.flags = ints;
  p.list = ints + nwin;
  p.count = ints + 2 * nwin;
  p.counter = ints + 2 * nwin + 1;
  p.nwin = nwin;
  p.cross = cross;
  p.tau_min = tau_min;
  p.total = p.cap = nwin;
  return p;
}

}  // namespace
