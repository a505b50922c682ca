// Kernels K7 and K9: the fused backward of the training encoder layer (K6,
// K8), with the forward recomputed.
//
// Replace tmae_tpu/ops/pallas_encoder.py:696 _pallas_backward (kernel :497
// _bwd_kernel) and :1347 _pallas_backward_sel (kernel :1167
// _bwd_kernel_sel). Given the layer's inputs and the gradient g of its
// output, both return dx and dkv (bf16), the 17 parameter gradients (f32,
// summed over all windows), and for the full variant the gradient of the
// slot positional embedding. The full variant (K7) runs the layer on all 64
// cells of each window; the selected variant (K9) on the S = 16 or 48 cells
// named by sel_q / sel_k, and its dx is g plus the expanded gradient of the
// packed cells (the layer adds its delta onto x, so g passes through).
//
// Numerics follow _bwd_kernel: the forward is recomputed in f32 with bf16
// operands for every matmul (x + pos, q and k normalised per head but not
// scaled, v, p, the attention output, h1, the GELU output), and so is the
// backward (dz2, dff1, dattn, da, ds, dq, dk, dv); products accumulate in f32
// and every elementwise step (LayerNorm statistics and their backward, the
// exact-erf GELU gradient, the softmax backward, the cosine-normalisation
// backward) is f32. dtau = -sum(ds * dots) / tau^2 when tau > tau_min, else
// 0. In self mode the keys and values are the queries: their gradients fold
// into dx and dkv is not written. Every sum runs in a fixed order (no
// atomics), so a call gives the same bits from run to run.
//
// Bound on this card: operations. Per row of a window (C = 128, F = 256) the
// backward does ~1.3 MFLOP of products (the forward recomputed, two
// products per matmul, the six weight-gradient products) on ~2 KB of row
// data: hundreds of operations per byte, above the H100's ~295 bf16
// operations per byte of device memory. What held the earlier design back
// was not the bound: six passes met in a ~300 MB device workspace,
// attention ran as one tiny block per (window, head) that re-read the
// window's rows for every head, every product loaded its operands straight
// from device memory, 26 launches ended a call, and every padding slot of a
// bucket was run. What holds this one back is latency: a block walks its
// tile through some 25 products and 8 + 8 heads in order, each step ending
// in a barrier and most starting with a fetch from L2.
//
// Design (three launches):
//   1. window_bwd_kernel, persistent (one block of 16 warps per SM; tiles
//      handed out by a counter, so blocks that drew dead tiles take more):
//      a block owns a tile of whole windows (64 rows: 4 windows at S = 16
//      and C = 128, 1 window at T = 64; 32 rows, 2 windows, at S = 16 and
//      C = 256; 48 rows, 1 window, at S = 48) and runs the whole layer
//      backward on it: the gather by sel_q / sel_k; v, q and k for all
//      heads as [rows x C] . [C x C] products, normalised in the products'
//      epilogue; attention per head for all the tile's windows at once; the
//      output projection, LN1, the FFN in chunks of 128 hidden units (64 at
//      T = 64, and at S = 48 with C = 256), LN2, and their backward down to
//      da; q and k of all heads again, then the attention and normalisation
//      backward per head; dx (and dkv) through the projections, summed as
//      one pipeline of products; and for K9 the expansion of the packed
//      gradients onto the window's 64 cells (g passes through). Weights
//      stream through shared memory in chunks of 32 along the reduction, up
//      to four chunks in flight (cp.async, one barrier a chunk); every
//      product runs on the tensor cores (WMMA bf16 16x16x16, f32 sums). The
//      tile's row arrays live in nine row units reused phase by phase (the
//      plan is written beside each phase), placed at compile time for the
//      T-MAE widths (C = 128 or 256, 8 heads, FFN 2C): at C = 128 all but
//      the ninth (cross mode only) are in shared memory, at C = 256 the
//      units that do not fit are a per-block scratch slice that stays in
//      L2, as do q and k between their recompute and the attention
//      backward. The bias, LayerNorm and tau sums of a tile stay in shared
//      memory, each column summed over the warps in a fixed order. Only two
//      kinds of thing leave the block: the bf16 operands of the six
//      weight-gradient products (rows of XP, KVP, KV, A, H1, GG and DQ, DK,
//      DV, DATT, DFF1, DZ2) and one row of f32 partials a tile (and the
//      tile's dpos, for K7).
//      A window whose g is 0 on every query cell adds nothing to any output
//      (the layer's VJP is linear in g and masks g with the query mask), so
//      each tile first tests its windows' g; a tile with no live window
//      writes dx = g (K9) or 0 (K7), dkv = 0, and nothing else. The live
//      flags go to device memory for passes 2 and 3.
//   2. wgrad_kernel: the six dY^T X products in one launch; blockIdx.z picks
//      the product and a chunk of the live windows (in window order), x / y
//      a 64 x 128 output tile. Tiles of 32 rows are staged in shared memory
//      by cp.async (double-buffered) and multiplied with WMMA; rows of dead
//      windows are never read, so the workspace needs no zeroing.
//   3. reduce_kernel: one launch sums every partial (the weight-gradient
//      chunks, and the live tiles' vectors, tau and dpos) in a fixed order.
// The tile counter's atomic only decides which block runs a tile; every
// sum is per tile and taken in tile order, so the bits do not depend on it.

#include <type_traits>

#include "wmma_tiles.cuh"

namespace {

constexpr int kCells = 64;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 32;        // reduction chunk of a staged weight
// FFN hidden chunk: 128 where shared memory allows it, else 64
__host__ __device__ constexpr int fc_of(int T, int C) {
  return T == 16 || (T == 48 && C == 128) ? 128 : 64;
}
constexpr int kUnits = 9;      // row units of a tile
constexpr int kLdSt = 20;      // per-warp staging tile [16][20] f32
constexpr size_t kStageBytes = 40960;  // the weight stages
constexpr size_t kSmemMax = 232448;    // 227 KB, a block's limit on the H100

// ---------------------------------------------------------------------------
// parameters and layout
// ---------------------------------------------------------------------------

struct BwdParams {
  // inputs
  const bf16 *x, *kv, *g, *pos;
  const int *selq, *selk;
  const float *qmask, *kmask;
  const bf16 *wq, *wk, *wv, *wo, *w1, *w2;
  const float *bq, *bk, *bv, *bo, *tau, *ln1s, *ln1b, *b1, *b2, *ln2s, *ln2b;
  int N, cross, want_dpos, ntiles;
  float tau_min;
  // weight-gradient operands [N * T, width] bf16
  bf16 *wXP, *wKVP, *wKV, *wA, *wH1, *wGG, *wDQ, *wDK, *wDV, *wDATT, *wDFF1,
      *wDZ2;
  int* live;     // [N] the window has a nonzero cotangent on a query cell
  int* tlive;    // [ntiles] the tile has a live window
  int* counter;  // the next tile to hand out (0 before the launch)
  float* part;   // [ntiles, part_stride] per-tile partials
  long long part_stride;
  // the blocks' scratch slices (Place(T, C).scratch bytes a block)
  unsigned char* scratch;
  // outputs
  bf16 *dx, *dkv;
};

// Per-tile partials (f32): [6C + F] row-pass vectors (ln2s ln2b b2 ln1s
// ln1b bo | b1), [3C] attention biases (bq bk bv), [4] tau, then [64 C] dpos
// when wanted. A tile with no live window writes none (tlive says so).
__host__ __device__ inline long long part_size(int C, int F, int dpos) {
  return 9LL * C + F + 4 + (dpos ? (long long)kCells * C : 0);
}

__host__ __device__ constexpr size_t up128(size_t b) {
  return (b + 127) / 128 * 128;
}

// Shared-memory layout (bytes) for width C, FFN width F, T, RT rows a tile,
// head width D: [uni: the weight stages, or else the attention scratch][hid:
// the FFN chunk][small arrays and the block's partial sums], then the row
// units that fit. The per-warp staging tiles (st) alias S1 / S3 where those
// are large enough: a phase uses one or the other, and st's users finish
// before the weight stages are refilled.
struct Layout {
  int ldb = 0, ldq = 0, ldqf = 0, ldS = 0, ldP = 0;
  size_t unit = 0;  // bytes of one row unit: [RT][C + 8] bf16 (an f32
                    // array [RT][C + 8] takes two)
  size_t a_qh = 0, a_kh = 0, a_qf = 0, a_kf = 0, a_s1 = 0, a_s3 = 0,
         a_pb = 0, a_db = 0, a_cp = 0, a_st = 0;
  size_t uni = 0, hid = 0, small = 0, fixed = 0;
  constexpr __host__ __device__ Layout(int C, int F, int T, int RT, int D) {
    const int FC = fc_of(T, C);
    ldb = C + 8;
    ldq = D + 8;
    ldqf = D + 4;
    ldS = T + 4;
    ldP = T + 8;
    unit = (size_t)RT * ldb * 2;
    const size_t st = (size_t)kWarps * 16 * kLdSt * 4;
    a_qh = 0;
    a_kh = a_qh + up128((size_t)RT * ldq * 2);
    a_qf = a_kh + up128((size_t)RT * ldq * 2);
    a_kf = a_qf + up128((size_t)RT * ldqf * 4);
    a_s1 = a_kf + up128((size_t)RT * ldqf * 4);
    a_s3 = a_s1 + up128((size_t)RT * ldS * 4);
    a_pb = a_s3 + up128((size_t)RT * ldS * 4);
    a_db = a_pb + up128((size_t)RT * ldP * 2);
    a_cp = a_db + up128((size_t)RT * ldP * 2);
    size_t end = a_cp + up128((size_t)3 * (RT / 16) * 32 * 4);
    if (a_pb - a_s1 >= st) {
      a_st = a_s1;
    } else {
      a_st = end;
      end += st;
    }
    uni = up128(kStageBytes > end ? kStageBytes : end);
    hid = up128((size_t)RT * (FC + 8) * 2);
    // cell bit masks [2][4][64] (u64), wlive haskey [4] and the next tile
    // (int), qm km rstd1 rq rk [RT], the tile's sums [6C + F] and [3C], cs
    // [16][16] (f32)
    small = up128(2 * 4 * kCells * 8 + 16 * 4 +
                  ((size_t)5 * RT + 9 * C + F + 16 * 16) * 4);
    fixed = uni + hid + small;
  }
};

// windows a tile: 4 at S = 16 and C = 128, 2 at S = 16 and C = 256, else 1
__host__ __device__ constexpr int wpb_of(int T, int C) {
  return T == 16 ? (C > 128 ? 2 : 4) : 1;
}

// Where a tile's row units live, for width C (8 heads, FFN width 2C) and T:
// shared memory for units 0 .. n - 1 (as many as fit after the fixed
// regions, never splitting the f32 pairs (0,1) (3,4) (5,6)), the block's
// scratch slice for the rest, then q, k and their 1 / norm (at qk_off).
// off[u] >= 0: an offset in shared memory; < 0: -(offset + 1) in the
// slice.
struct Place {
  int off[kUnits] = {};
  long long qk_off = 0, scratch = 0;  // the slice's bytes a block
  size_t smem = 0;                    // shared memory a block takes
  constexpr __host__ __device__ Place(int T, int C) {
    const int RT = wpb_of(T, C) * T;
    const Layout L(C, 2 * C, T, RT, C / 8);
    int n = L.fixed < kSmemMax ? (int)((kSmemMax - L.fixed) / L.unit) : 0;
    n = n > kUnits ? kUnits : n;
    if (n == 1 || n == 4 || n == 6) --n;  // keep each f32 pair in one place
    for (int u = 0; u < kUnits; ++u)
      off[u] = u < n ? (int)(L.fixed + u * L.unit)
                     : -(int)((u - n) * L.unit) - 1;
    smem = L.fixed + n * L.unit;
    qk_off = (long long)(kUnits - n) * L.unit;
    scratch = qk_off + ((long long)2 * RT * C + 2 * RT * 16) * 4;
  }
};

template <int T, int WPB>
struct Tile {
  static constexpr int RT = WPB * T;  // rows a tile
  static constexpr int MT = RT / 16;  // 16-row tiles
  static constexpr int TT = T / 16;   // 16-row tiles a window
  static constexpr int NWT = WPB * TT;
};

__device__ __forceinline__ float gelu_exact(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float u) {
  const float phi = expf(-0.5f * u * u) * 0.3989422804014327f;
  return 0.5f * (1.f + erff(u * 0.70710678118654752f)) + u * phi;
}

__device__ __forceinline__ int clamp_cell(int c) {
  return min(max(c, 0), kCells - 1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 16 bytes, or 16 zero bytes when !valid (a source size of 0 reads nothing).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 bf16 <-> 8 f32
__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const bf16* a = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = __bfloat162float(a[k]);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  bf16* a = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = __float2bfloat16(f[k]);
  return v;
}

// ---------------------------------------------------------------------------
// block GEMM: acc += A [rows x K] . B [K x N], B streamed from a weight in
// chunks of kKC through up to four shared-memory stages
// ---------------------------------------------------------------------------

// The output tiles warp `warp` owns for N columns (N = 64, 128 or 256): row
// tiles wm + WM * i, column tiles NJ * wn + jj (adjacent, so a warp holds
// whole heads).
template <int N>
struct WarpMap {
  static constexpr int NT = N / 16;
  static constexpr int WN = NT < 8 ? NT : 8;
  static constexpr int WM = kWarps / WN;
  static constexpr int NJ = NT / WN;
  int wm, wn;
  __device__ explicit WarpMap(int warp) : wm(warp / WN), wn(warp % WN) {}
};

template <int N, int MT>
struct Frags {
  static constexpr int MI = (MT + WarpMap<N>::WM - 1) / WarpMap<N>::WM;
  static constexpr int NJ = WarpMap<N>::NJ;
  AccFrag f[MI][NJ];
};

// Stage chunk [k0, k0 + kKC) of B: B(k, n) = w[n * ldw + k] when NT (a
// Linear weight [out, in], A . W^T), else w[k * ldw + n] (A . W).
template <bool NT, int N>
__device__ __forceinline__ void stage_b(bf16* buf, const bf16* w, int ldw,
                                        int k0) {
  if constexpr (NT) {
    for (int e = threadIdx.x; e < N * (kKC / 8); e += kThreads) {
      const int n = e / (kKC / 8), kk = (e % (kKC / 8)) * 8;
      cp_async16(buf + n * (kKC + 8) + kk, w + (long long)n * ldw + k0 + kk);
    }
  } else {
    for (int e = threadIdx.x; e < kKC * (N / 8); e += kThreads) {
      const int kk = e / (N / 8), n = (e % (N / 8)) * 8;
      cp_async16(buf + kk * (N + 8) + n, w + (long long)(k0 + kk) * ldw + n);
    }
  }
}

template <int N, int MT>
__device__ __forceinline__ void zero_frags(Frags<N, MT>& a) {
#pragma unroll
  for (int i = 0; i < Frags<N, MT>::MI; ++i)
#pragma unroll
    for (int j = 0; j < Frags<N, MT>::NJ; ++j)
      wmma::fill_fragment(a.f[i][j], 0.f);
}

__device__ __forceinline__ const bf16* pick3(const bf16* a, const bf16* b,
                                             const bf16* c, int s) {
  return s == 0 ? a : (s == 1 ? b : c);
}

// acc += sum over the nseg segments s of A_s . B_s, each over K (a
// multiple of kKC), for the tiles the warp owns; the segments' chunks run
// as one pipeline. A_s: bf16 rows (shared or device memory), row stride
// lda; W_s as stage_b takes them. Every thread of the block calls it; it
// begins and ends in step.
template <bool NT, int N, int MT>
__device__ __forceinline__ void block_mma_seg(Frags<N, MT>& acc, const bf16* A0,
                              const bf16* A1, const bf16* A2, int lda,
                              const bf16* W0, const bf16* W1, const bf16* W2,
                              int ldw, int nseg, int K, bf16* stage,
                              int warp) {
  using WP = WarpMap<N>;
  constexpr int MI = Frags<N, MT>::MI, NJ = WP::NJ;
  constexpr int sz = NT ? N * (kKC + 8) : kKC * (N + 8);
  constexpr int ns0 = (int)(kStageBytes / 2 / sz);
  constexpr int ns = ns0 > 4 ? 4 : ns0;
  static_assert(ns >= 2, "two weight stages at least");
  const WP wp(warp);
  const int cps = K / kKC, nch = nseg * cps;
  auto load = [&](int c) {
    const int sg = c / cps;
    stage_b<NT, N>(stage + (c % ns) * sz, pick3(W0, W1, W2, sg), ldw,
                   (c - sg * cps) * kKC);
  };
#pragma unroll
  for (int c = 0; c < ns - 1; ++c) {
    if (c < nch) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    // chunk c has landed; past the barrier every warp is done with chunk
    // c - 1, whose stage the load of chunk c + ns - 1 refills
    cp_async_wait<ns - 2>();
    __syncthreads();
    if (c + ns - 1 < nch) load(c + ns - 1);
    cp_async_commit();
    const bf16* cur = stage + (c % ns) * sz;
    const int sg = c / cps;
    const bf16* Ac = pick3(A0, A1, A2, sg) + (c - sg * cps) * kKC;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      typename std::conditional<NT, BColFrag, BRowFrag>::type b[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int j = NJ * wp.wn + jj;
        if constexpr (NT)
          wmma::load_matrix_sync(b[jj], cur + 16 * j * (kKC + 8) + kk,
                                 kKC + 8);
        else
          wmma::load_matrix_sync(b[jj], cur + kk * (N + 8) + 16 * j, N + 8);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int m = wp.wm + WP::WM * i;
        if (m < MT) {
          AFrag a;
          wmma::load_matrix_sync(a, Ac + (long long)16 * m * lda + kk, lda);
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
            wmma::mma_sync(acc.f[i][jj], a, b[jj], acc.f[i][jj]);
        }
      }
    }
  }
  __syncthreads();  // the stages are free again
}

template <bool NT, int N, int MT>
__device__ __forceinline__ void block_mma(Frags<N, MT>& acc, const bf16* A,
                                          int lda, const bf16* w, int ldw,
                                          int K, bf16* stage, int warp) {
  block_mma_seg<NT>(acc, A, A, A, lda, w, w, w, ldw, 1, K, stage, warp);
}

// Store / load the warp's tiles of an [rows x N] f32 array (stride ld).
template <int N, int MT>
__device__ __forceinline__ void store_frags(Frags<N, MT>& acc, float* d,
                                            int ld, int warp) {
  using WP = WarpMap<N>;
  const WP wp(warp);
#pragma unroll
  for (int i = 0; i < Frags<N, MT>::MI; ++i) {
    const int m = wp.wm + WP::WM * i;
    if (m < MT)
#pragma unroll
      for (int jj = 0; jj < WP::NJ; ++jj)
        wmma::store_matrix_sync(
            d + (long long)16 * m * ld + 16 * (WP::NJ * wp.wn + jj),
            acc.f[i][jj], ld, wmma::mem_row_major);
  }
}

template <int N, int MT>
__device__ __forceinline__ void load_frags(Frags<N, MT>& acc, const float* s,
                                           int ld, int warp) {
  using WP = WarpMap<N>;
  const WP wp(warp);
#pragma unroll
  for (int i = 0; i < Frags<N, MT>::MI; ++i) {
    const int m = wp.wm + WP::WM * i;
    if (m < MT)
#pragma unroll
      for (int jj = 0; jj < WP::NJ; ++jj)
        wmma::load_matrix_sync(
            acc.f[i][jj],
            s + (long long)16 * m * ld + 16 * (WP::NJ * wp.wn + jj), ld,
            wmma::mem_row_major);
  }
}

// One 16 x 16 tile into the warp's staging tile; lane (rr, c0) then reads
// row rr, columns c0 + [0, 8).
__device__ __forceinline__ void stage_tile(const AccFrag& a, float* st) {
  __syncwarp();
  wmma::store_matrix_sync(st, a, kLdSt, wmma::mem_row_major);
  __syncwarp();
}

__device__ __forceinline__ void read8(const float* st, int rr, int c0,
                                      float (&f)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = st[rr * kLdSt + c0 + k];
}

// ---------------------------------------------------------------------------
// row helpers (one warp per row, lane holds columns lane + 32 u)
// ---------------------------------------------------------------------------

template <int NC>
__device__ __forceinline__ void ln_stats(const float (&v)[NC], float& mu,
                                         float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < NC; ++u) s += v[u];
  mu = warp_sum(s) / (32 * NC);
  float q = 0.f;
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    const float d = v[u] - mu;
    q += d * d;
  }
  rstd = rsqrtf(warp_sum(q) / (32 * NC) + 1e-5f);
}

template <int NC>
__device__ __forceinline__ void ln_bwd_row(float (&out)[NC],
                                           const float (&g)[NC],
                                           const float (&xh)[NC],
                                           const float* scale, float inv,
                                           int lane) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    const float gs = g[u] * scale[lane + 32 * u];
    s1 += gs;
    s2 += gs * xh[u];
  }
  const float m1 = warp_sum(s1) / (32 * NC), m2 = warp_sum(s2) / (32 * NC);
#pragma unroll
  for (int u = 0; u < NC; ++u) {
    const float gs = g[u] * scale[lane + 32 * u];
    out[u] = inv * (gs - m1 - xh[u] * m2);
  }
}

// dst[c] += the warps' column sums s (columns lane + 32 u), summed over the
// warps in order; red: kWarps * 32 * NC floats of shared memory.
template <int NC>
__device__ __forceinline__ void block_colsum(float* red, const float (&s)[NC],
                                             float* dst, int warp, int lane) {
  constexpr int C = 32 * NC;
#pragma unroll
  for (int u = 0; u < NC; ++u) red[warp * C + lane + 32 * u] = s[u];
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w * C + c];
    dst[c] += t;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// pass 1: the fused window pass
// ---------------------------------------------------------------------------

// Built with -DTMAE_BWD_PROFILE, each block adds the clock cycles of every
// phase into tmae_bwd_phase_cycles (read by tmae_bwd_profile); otherwise
// PHASE does nothing.
#ifdef TMAE_BWD_PROFILE
__device__ unsigned long long tmae_bwd_phase_cycles[1024][16];
#define PHASE(k)                                              \
  do {                                                        \
    __syncthreads();                                          \
    if (threadIdx.x == 0) {                                   \
      const long long now = clock64();                        \
      tmae_bwd_phase_cycles[blockIdx.x][k] += now - phase_t0; \
      phase_t0 = now;                                         \
    }                                                         \
  } while (0)
#else
#define PHASE(k) \
  do {           \
  } while (0)
#endif

// What one tile needs to find its rows.
struct TileRef {
  int n0, nw;    // first window, windows present
  long long r0;  // first slot row
  bool sel;
};

// The cell of slot row r of the tile (query side, or key side with key).
template <int T>
__device__ __forceinline__ int cell_of(const BwdParams& p, const TileRef& t,
                                       int r, bool key) {
  if (!t.sel) return r % T;
  if (r / T >= t.nw) return 0;
  return clamp_cell((key ? p.selk : p.selq)[t.r0 + r]);
}

// The window row of slot row r in a [N, 64, C] tensor.
template <int T, int C>
__device__ __forceinline__ const bf16* row_of(const BwdParams& p,
                                              const TileRef& t,
                                              const bf16* base, int r,
                                              bool key) {
  const int w = r / T < t.nw ? r / T : 0;
  return base + ((long long)(t.n0 + w) * kCells + cell_of<T>(p, t, r, key)) * C;
}

// x + pos into xp, kv + pos into kvp (cross), x (self) or kv (cross) into
// xkv when given; with ws the same rows into the workspace.
template <int T, int RT, int C>
__device__ void gather_rows(const BwdParams& p, const TileRef& t, bf16* xp,
                            bf16* kvp, bf16* xkv, bool ws) {
  constexpr int cv = C / 8, ldb = C + 8;
  for (int e = threadIdx.x; e < RT * cv; e += kThreads) {
    const int r = e / cv, v = (e % cv) * 8;
    const bool in = r / T < t.nw;
    const long long wr = (t.r0 + r) * C + v;
    float a[8], b[8];
    uint4 xv = make_uint4(0, 0, 0, 0);
    if (in)
      xv = *reinterpret_cast<const uint4*>(row_of<T, C>(p, t, p.x, r, false) +
                                           v);
    unpack8(xv, a);
    unpack8(*reinterpret_cast<const uint4*>(
                p.pos + cell_of<T>(p, t, r, false) * C + v),
            b);
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] += b[k];
    const uint4 o = pack8(a);
    *reinterpret_cast<uint4*>(xp + r * ldb + v) = o;
    if (in && ws) *reinterpret_cast<uint4*>(p.wXP + wr) = o;
    if (!p.cross) {
      if (xkv) *reinterpret_cast<uint4*>(xkv + r * ldb + v) = xv;
      if (in && ws) *reinterpret_cast<uint4*>(p.wKV + wr) = xv;
      continue;
    }
    uint4 kvv = make_uint4(0, 0, 0, 0);
    if (in)
      kvv = *reinterpret_cast<const uint4*>(row_of<T, C>(p, t, p.kv, r, true) +
                                            v);
    unpack8(kvv, a);
    unpack8(*reinterpret_cast<const uint4*>(
                p.pos + cell_of<T>(p, t, r, true) * C + v),
            b);
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] += b[k];
    const uint4 ok = pack8(a);
    *reinterpret_cast<uint4*>(kvp + r * ldb + v) = ok;
    if (xkv) *reinterpret_cast<uint4*>(xkv + r * ldb + v) = kvv;
    if (in && ws) {
      *reinterpret_cast<uint4*>(p.wKVP + wr) = ok;
      *reinterpret_cast<uint4*>(p.wKV + wr) = kvv;
    }
  }
  __syncthreads();
}

template <int T, int WPB, int C>
__global__ void __launch_bounds__(kThreads, 1)
    window_bwd_kernel(const BwdParams p) {
  using TL = Tile<T, WPB>;
  constexpr int RT = TL::RT, MT = TL::MT, TT = TL::TT, NWT = TL::NWT;
  constexpr int FCk = fc_of(T, C);  // FFN chunk
  constexpr int NC = C / 32, ldb = C + 8, ldf = C + 8, ldh = FCk + 8;
  using WC = WarpMap<C>;
  using WF = WarpMap<FCk>;
  using FC = Frags<C, MT>;
  using FF = Frags<FCk, MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int F = 2 * C, H = 8, D = C / H, DT = D / 16;
  constexpr Layout L(C, F, T, RT, D);
  constexpr Place PL(T, C);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rr = lane >> 1, c0 = (lane & 1) * 8;  // staging tile element map
  constexpr int ldq = L.ldq, ldqf = L.ldqf, ldS = L.ldS, ldP = L.ldP;
  const WC wc(warp);
  const WF wf(warp);

  unsigned char* uni = smem;
  bf16* stage = reinterpret_cast<bf16*>(uni);
  bf16* qh = reinterpret_cast<bf16*>(uni + L.a_qh);
  bf16* kh = reinterpret_cast<bf16*>(uni + L.a_kh);
  float* qf = reinterpret_cast<float*>(uni + L.a_qf);
  float* kf = reinterpret_cast<float*>(uni + L.a_kf);
  float* S1 = reinterpret_cast<float*>(uni + L.a_s1);
  float* S3 = reinterpret_cast<float*>(uni + L.a_s3);
  bf16* Pb = reinterpret_cast<bf16*>(uni + L.a_pb);
  bf16* Db = reinterpret_cast<bf16*>(uni + L.a_db);
  float* colpart = reinterpret_cast<float*>(uni + L.a_cp);  // [3][NWT][32]
  float* st_all = reinterpret_cast<float*>(uni + L.a_st);
  float* st = st_all + warp * 16 * kLdSt;
  bf16* hid = reinterpret_cast<bf16*>(smem + L.uni);
  unsigned long long* qbits =
      reinterpret_cast<unsigned long long*>(smem + L.uni + L.hid);
  unsigned long long* kbits = qbits + 4 * kCells;
  int* wlive = reinterpret_cast<int*>(kbits + 4 * kCells);  // [4]
  int* haskey = wlive + 4;                                   // [4]
  int* next_tile = haskey + 4;
  float* qm_s = reinterpret_cast<float*>(haskey + 8);
  float* km_s = qm_s + RT;
  float* rstd1 = km_s + RT;
  float* rq = rstd1 + RT;
  float* rk = rq + RT;
  float* pvs = rk + RT;         // [6C + F] the tile's row-pass sums
  float* pbias = pvs + 6 * C + F;  // [3C] bq bk bv
  float* cs = pbias + 3 * C;    // [16][16] per-warp sums of a chunk

  // the row units (u0..u8); f32 arrays take the pairs (u0,u1), (u3,u4),
  // (u5,u6)
  unsigned char* mine = p.scratch + (long long)blockIdx.x * PL.scratch;
  unsigned char* ub[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
    ub[u] = PL.off[u] >= 0 ? smem + PL.off[u] : mine + (-(PL.off[u] + 1));
  bf16* const U0 = reinterpret_cast<bf16*>(ub[0]);
  bf16* const U1 = reinterpret_cast<bf16*>(ub[1]);
  bf16* const U2 = reinterpret_cast<bf16*>(ub[2]);
  bf16* const U3 = reinterpret_cast<bf16*>(ub[3]);
  bf16* const U4 = reinterpret_cast<bf16*>(ub[4]);
  bf16* const U7 = reinterpret_cast<bf16*>(ub[7]);
  bf16* const U8 = reinterpret_cast<bf16*>(ub[8]);
  float* const F01 = reinterpret_cast<float*>(ub[0]);
  float* const F34 = reinterpret_cast<float*>(ub[3]);
  float* const F56 = reinterpret_cast<float*>(ub[5]);

  // q and k of all heads, normalised (f32), and their 1 / norm [2][RT][16]
  float* const QG = reinterpret_cast<float*>(mine + PL.qk_off);
  float* const KG = QG + RT * C;
  float* const RSG = KG + RT * C;
  float tau_acc = 0.f;
  const float scale = 1.f / fmaxf(p.tau[0], p.tau_min);
  const bool sel = p.selq != nullptr;
#ifdef TMAE_BWD_PROFILE
  long long phase_t0 = clock64();
#endif

  // Tiles are handed out by a counter, so a block that drew dead tiles
  // takes more; every sum is kept per tile and summed in tile order, so the
  // bits do not depend on which block ran a tile.
  for (;;) {
    __syncthreads();  // the previous tile is done with every buffer
    if (tid == 0) *next_tile = atomicAdd(p.counter, 1);
    if (tid < 4) wlive[tid] = 0;
    for (int e = tid; e < 9 * C + F; e += kThreads) pvs[e] = 0.f;
    tau_acc = 0.f;
    __syncthreads();
    const int tile = *next_tile;
    if (tile >= p.ntiles) break;
    TileRef t;
    t.n0 = tile * WPB;
    t.nw = min(WPB, p.N - t.n0);
    t.r0 = (long long)t.n0 * T;
    t.sel = sel;
    const int nw = t.nw;
    const long long r0 = t.r0;
    float* const part = p.part + (long long)tile * p.part_stride;
    for (int r = tid; r < RT; r += kThreads) {
      const bool in = r / T < nw;
      qm_s[r] = in ? p.qmask[r0 + r] : 0.f;
      km_s[r] = in ? (p.cross ? p.kmask[r0 + r] : p.qmask[r0 + r]) : 0.f;
    }
    __syncthreads();
    if (tid < WPB) {
      int hk = 0;
      for (int s = 0; s < T; ++s) hk |= km_s[tid * T + s] > 0.f;
      haskey[tid] = hk;
    }
    // P0: which windows have a nonzero cotangent on a query cell
    for (int r = warp; r < RT; r += kWarps) {
      if (!(qm_s[r] > 0.f)) continue;
      const uint4* gr =
          reinterpret_cast<const uint4*>(row_of<T, C>(p, t, p.g, r, false));
      bool nz = false;
      for (int v = lane; v < C / 8; v += 32) {
        const uint4 q = gr[v];
        // a bf16 is 0 when its bits are 0x0000 or 0x8000
        nz |= ((q.x | q.y | q.z | q.w) & 0x7fff7fffu) != 0u;
      }
      if (__any_sync(0xffffffffu, nz) && lane == 0) atomicOr(&wlive[r / T], 1);
    }
    __syncthreads();
    const bool tile_live = (wlive[0] | wlive[1] | wlive[2] | wlive[3]) != 0;
    if (tid < nw) p.live[t.n0 + tid] = wlive[tid];
    if (tid == 0) p.tlive[tile] = tile_live;
    if (!tile_live) {  // dx = g (K9) or 0 (K7); dkv = 0
      const long long base = (long long)t.n0 * kCells * C / 8;
      const long long cnt = (long long)nw * kCells * C / 8;
      const uint4 z = make_uint4(0, 0, 0, 0);
      for (long long e = tid; e < cnt; e += kThreads) {
        reinterpret_cast<uint4*>(p.dx)[base + e] =
            sel ? reinterpret_cast<const uint4*>(p.g)[base + e] : z;
        if (p.cross) reinterpret_cast<uint4*>(p.dkv)[base + e] = z;
      }
      PHASE(14);
      continue;
    }
    PHASE(0);

    // P1: XP -> u0, KVP -> u1 (cross), X (self) / KV (cross) -> u2
    gather_rows<T, RT, C>(p, t, U0, U1, U2, true);
    PHASE(1);

    // P2: V = bf16(u2 Wv^T + bv) -> u3; QN = u0 Wq^T normalised -> u2;
    // KN -> u4 (bf16 of the normalised, unscaled q and k)
    {
      FC acc;
      zero_frags(acc);
      block_mma<true>(acc, U2, ldb, p.wv, C, C, stage, warp);
#pragma unroll
      for (int i = 0; i < FC::MI; ++i) {
        const int m = wc.wm + WC::WM * i;
        if (m >= MT) continue;
#pragma unroll
        for (int jj = 0; jj < WC::NJ; ++jj) {
          stage_tile(acc.f[i][jj], st);
          const int col = 16 * (WC::NJ * wc.wn + jj) + c0;
          float f[8];
          read8(st, rr, c0, f);
#pragma unroll
          for (int k = 0; k < 8; ++k) f[k] += p.bv[col + k];
          *reinterpret_cast<uint4*>(U3 + (16 * m + rr) * ldb + col) = pack8(f);
        }
      }
      __syncthreads();
    }
    for (int which = 0; which < 2; ++which) {
      const bf16* A = which == 0 ? U0 : (p.cross ? U1 : U0);
      const float* bias = which == 0 ? p.bq : p.bk;
      bf16* out = which == 0 ? U2 : U4;
      FC acc;
      zero_frags(acc);
      block_mma<true>(acc, A, ldb, which == 0 ? p.wq : p.wk, C, C, stage,
                      warp);
      // a warp's NJ column tiles hold whole heads (D = 16 or 16 NJ)
#pragma unroll
      for (int i = 0; i < FC::MI; ++i) {
        const int m = wc.wm + WC::WM * i;
        if (m >= MT) continue;
        float f[WC::NJ][8], ss[WC::NJ];
#pragma unroll
        for (int jj = 0; jj < WC::NJ; ++jj) {
          stage_tile(acc.f[i][jj], st);
          read8(st, rr, c0, f[jj]);
          const int col = 16 * (WC::NJ * wc.wn + jj) + c0;
          ss[jj] = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            f[jj][k] += bias[col + k];
            ss[jj] += f[jj][k] * f[jj][k];
          }
          ss[jj] += __shfl_xor_sync(0xffffffffu, ss[jj], 1);
        }
        if (WC::NJ == 2 && D == 32) {
          const float s = ss[0] + ss[WC::NJ - 1];
          ss[0] = ss[WC::NJ - 1] = s;
        }
#pragma unroll
        for (int jj = 0; jj < WC::NJ; ++jj) {
          const float rs = rsqrtf(ss[jj] + 1e-24f);
#pragma unroll
          for (int k = 0; k < 8; ++k) f[jj][k] *= rs;
          *reinterpret_cast<uint4*>(out + (16 * m + rr) * ldb +
                                    16 * (WC::NJ * wc.wn + jj) + c0) =
              pack8(f[jj]);
        }
      }
      __syncthreads();
    }
    PHASE(2);

    // P3: attention forward per head (QN u2, KN u4, V u3) -> A u0
    for (int h = 0; h < H; ++h) {
      for (int it = warp; it < WPB * TT * TT; it += kWarps) {
        const int w = it / (TT * TT), i = (it / TT) % TT, j = it % TT;
        AccFrag acc;
        wmma::fill_fragment(acc, 0.f);
        for (int k0 = 0; k0 < D; k0 += 16) {
          AFrag fa;
          BColFrag fb;
          wmma::load_matrix_sync(fa, U2 + (w * T + 16 * i) * ldb + h * D + k0,
                                 ldb);
          wmma::load_matrix_sync(fb, U4 + (w * T + 16 * j) * ldb + h * D + k0,
                                 ldb);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(S1 + (w * T + 16 * i) * ldS + 16 * j, acc,
                                ldS, wmma::mem_row_major);
      }
      __syncthreads();
      for (int r = warp; r < RT; r += kWarps) {
        const int w = r / T;
        float l[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          l[u] = j < T ? (km_s[w * T + j] > 0.f ? S1[r * ldS + j] * scale
                                                : -30000.f)
                       : -CUDART_INF_F;
        }
        const float mx = warp_max(fmaxf(l[0], l[1]));
        float e[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          e[u] = lane + 32 * u < T ? expf(l[u] - mx) : 0.f;
        const float inv = haskey[w] ? 1.f / warp_sum(e[0] + e[1]) : 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (lane + 32 * u < T)
            Pb[r * ldP + lane + 32 * u] = __float2bfloat16(e[u] * inv);
      }
      __syncthreads();
      for (int it = warp; it < NWT * DT; it += kWarps) {
        const int w = it / (TT * DT), i = (it / DT) % TT, dj = it % DT;
        AccFrag acc;
        wmma::fill_fragment(acc, 0.f);
        for (int k = 0; k < TT; ++k) {
          AFrag a;
          BRowFrag b;
          wmma::load_matrix_sync(a, Pb + (w * T + 16 * i) * ldP + 16 * k, ldP);
          wmma::load_matrix_sync(
              b, U3 + (w * T + 16 * k) * ldb + h * D + 16 * dj, ldb);
          wmma::mma_sync(acc, a, b, acc);
        }
        stage_tile(acc, st);
        const int r = w * T + 16 * i + rr, col = h * D + 16 * dj + c0;
        float f[8];
        read8(st, rr, c0, f);
        const uint4 v = pack8(f);
        *reinterpret_cast<uint4*>(U0 + r * ldb + col) = v;
        if (r / T < nw)
          *reinterpret_cast<uint4*>(p.wA + (r0 + r) * C + col) = v;
      }
      __syncthreads();
    }
    PHASE(3);

    // P4: o = A Wo^T -> (u5,u6); z1 = x + qm (o + bo); LN1: xh1 in place,
    // H1 = bf16(h1) -> u4
    {
      FC acc;
      zero_frags(acc);
      block_mma<true>(acc, U0, ldb, p.wo, C, C, stage, warp);
      store_frags(acc, F56, ldf, warp);
      __syncthreads();
    }
    for (int r = warp; r < RT; r += kWarps) {
      const bool in = r / T < nw, occ = qm_s[r] > 0.f;
      const bf16* xr = row_of<T, C>(p, t, p.x, r, false);
      float v[NC];
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const int c = lane + 32 * u;
        const float x = in ? __bfloat162float(xr[c]) : 0.f;
        v[u] = x + (occ ? F56[r * ldf + c] + p.bo[c] : 0.f);
      }
      float mu, rstd;
      ln_stats(v, mu, rstd);
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const int c = lane + 32 * u;
        const float xh = (v[u] - mu) * rstd;
        F56[r * ldf + c] = xh;
        const bf16 hb = __float2bfloat16(occ ? xh * p.ln1s[c] + p.ln1b[c] : 0.f);
        U4[r * ldb + c] = hb;
        if (in) p.wH1[(r0 + r) * C + c] = hb;
      }
      if (lane == 0) rstd1[r] = rstd;
    }
    __syncthreads();
    PHASE(4);

    // P5: FFN forward: (u0,u1) = sum over chunks gelu(H1 W1c^T + b1) W2c^T
    // (h1 and b2 are added in P6)
    {
      FC acc;
      zero_frags(acc);
      for (int f0 = 0; f0 < F; f0 += FCk) {
        FF au;
        zero_frags(au);
        block_mma<true>(au, U4, ldb, p.w1 + (long long)f0 * C, C, C, stage,
                        warp);
#pragma unroll
        for (int i = 0; i < FF::MI; ++i) {
          const int m = wf.wm + WF::WM * i;
          if (m >= MT) continue;
          stage_tile(au.f[i][0], st);
          const int r = 16 * m + rr, fl = 16 * wf.wn + c0;
          float f[8];
          read8(st, rr, c0, f);
#pragma unroll
          for (int k = 0; k < 8; ++k) f[k] = gelu_exact(f[k] + p.b1[f0 + fl + k]);
          const uint4 v = pack8(f);
          *reinterpret_cast<uint4*>(hid + r * ldh + fl) = v;
          if (r / T < nw)
            *reinterpret_cast<uint4*>(p.wGG + (r0 + r) * F + f0 + fl) = v;
        }
        __syncthreads();
        block_mma<true>(acc, hid, ldh, p.w2 + f0, F, FCk, stage, warp);
      }
      store_frags(acc, F01, ldf, warp);
      __syncthreads();
    }
    PHASE(5);

    // P6: LN2 forward and backward: z2 = h1 + ffn + b2; dz2 (f32) ->
    // (u0,u1) in place, DZ2 -> u2
    {
      float s_ln2s[NC], s_ln2b[NC], s_b2[NC];
#pragma unroll
      for (int u = 0; u < NC; ++u) s_ln2s[u] = s_ln2b[u] = s_b2[u] = 0.f;
      for (int r = warp; r < RT; r += kWarps) {
        const bool in = r / T < nw, occ = qm_s[r] > 0.f;
        const bf16* gr = row_of<T, C>(p, t, p.g, r, false);
        float v[NC], xh[NC], go[NC], dz[NC];
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const int c = lane + 32 * u;
          const float h1 = occ ? F56[r * ldf + c] * p.ln1s[c] + p.ln1b[c] : 0.f;
          v[u] = F01[r * ldf + c] + h1 + p.b2[c];
          go[u] = occ && in ? __bfloat162float(gr[c]) : 0.f;
        }
        float mu, rstd;
        ln_stats(v, mu, rstd);
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          xh[u] = (v[u] - mu) * rstd;
          s_ln2s[u] += go[u] * xh[u];
          s_ln2b[u] += go[u];
        }
        ln_bwd_row(dz, go, xh, p.ln2s, rstd, lane);
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const int c = lane + 32 * u;
          s_b2[u] += dz[u];
          F01[r * ldf + c] = dz[u];
          const bf16 d = __float2bfloat16(dz[u]);
          U2[r * ldb + c] = d;
          if (in) p.wDZ2[(r0 + r) * C + c] = d;
        }
      }
      block_colsum(st_all, s_ln2s, pvs + 0 * C, warp, lane);
      block_colsum(st_all, s_ln2b, pvs + 1 * C, warp, lane);
      block_colsum(st_all, s_b2, pvs + 2 * C, warp, lane);
    }
    PHASE(6);

    // P7: FFN backward: dff1 = (DZ2 W2c) * gelu'(H1 W1c^T + b1) (hid), then
    // (u0,u1) += dff1 W1c
    {
      FC acc;
      load_frags(acc, F01, ldf, warp);
      for (int f0 = 0; f0 < F; f0 += FCk) {
        FF au, ag;
        zero_frags(au);
        zero_frags(ag);
        block_mma<true>(au, U4, ldb, p.w1 + (long long)f0 * C, C, C, stage,
                        warp);
        block_mma<false>(ag, U2, ldb, p.w2 + f0, F, C, stage, warp);
        float colsum[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) colsum[k] = 0.f;
#pragma unroll
        for (int i = 0; i < FF::MI; ++i) {
          const int m = wf.wm + WF::WM * i;
          if (m >= MT) continue;
          const int r = 16 * m + rr, fl = 16 * wf.wn + c0;
          float u[8], f[8];
          stage_tile(au.f[i][0], st);
          read8(st, rr, c0, u);
          stage_tile(ag.f[i][0], st);
          read8(st, rr, c0, f);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            f[k] *= gelu_grad(u[k] + p.b1[f0 + fl + k]);
            colsum[k] += f[k];
          }
          const uint4 v = pack8(f);
          *reinterpret_cast<uint4*>(hid + r * ldh + fl) = v;
          if (r / T < nw)
            *reinterpret_cast<uint4*>(p.wDFF1 + (r0 + r) * F + f0 + fl) = v;
        }
        // lanes of equal (lane & 1) hold the same 8 columns
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float v = colsum[k];
          for (int o = 2; o < 32; o <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane < 2) cs[warp * 16 + c0 + k] = v;
        }
        __syncthreads();
        // the chunk's b1 sums: column tile wn, over the warps wm in order
        if (tid < FCk) {
          const int wn = tid / 16;
          float s = 0.f;
          for (int wm = 0; wm < WF::WM; ++wm)
            s += cs[(wm * WF::WN + wn) * 16 + tid % 16];
          pvs[6 * C + f0 + tid] += s;
        }
        block_mma<false>(acc, hid, ldh, p.w1 + (long long)f0 * C, C, FCk,
                         stage, warp);
      }
      store_frags(acc, F01, ldf, warp);
      __syncthreads();
    }
    PHASE(7);

    // P8: LN1 backward: dh1 = qm (u0,u1); dz1 -> (u5,u6) over xh1; DATT =
    // bf16(qm dz1) -> u2
    {
      float s_ln1s[NC], s_ln1b[NC], s_bo[NC];
#pragma unroll
      for (int u = 0; u < NC; ++u) s_ln1s[u] = s_ln1b[u] = s_bo[u] = 0.f;
      for (int r = warp; r < RT; r += kWarps) {
        const bool in = r / T < nw, occ = qm_s[r] > 0.f;
        float dh[NC], xh[NC], dz[NC];
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const int c = lane + 32 * u;
          dh[u] = occ ? F01[r * ldf + c] : 0.f;
          xh[u] = F56[r * ldf + c];
          s_ln1s[u] += dh[u] * xh[u];
          s_ln1b[u] += dh[u];
        }
        ln_bwd_row(dz, dh, xh, p.ln1s, rstd1[r], lane);
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          const int c = lane + 32 * u;
          F56[r * ldf + c] = dz[u];
          const float da = occ ? dz[u] : 0.f;
          s_bo[u] += da;
          const bf16 d = __float2bfloat16(da);
          U2[r * ldb + c] = d;
          if (in) p.wDATT[(r0 + r) * C + c] = d;
        }
      }
      block_colsum(st_all, s_ln1s, pvs + 3 * C, warp, lane);
      block_colsum(st_all, s_ln1b, pvs + 4 * C, warp, lane);
      block_colsum(st_all, s_bo, pvs + 5 * C, warp, lane);
    }
    PHASE(8);

    // P9: dA = bf16(DATT Wo) -> u0
    {
      FC acc;
      zero_frags(acc);
      block_mma<false>(acc, U2, ldb, p.wo, C, C, stage, warp);
#pragma unroll
      for (int i = 0; i < FC::MI; ++i) {
        const int m = wc.wm + WC::WM * i;
        if (m >= MT) continue;
#pragma unroll
        for (int jj = 0; jj < WC::NJ; ++jj) {
          stage_tile(acc.f[i][jj], st);
          float f[8];
          read8(st, rr, c0, f);
          *reinterpret_cast<uint4*>(U0 + (16 * m + rr) * ldb +
                                    16 * (WC::NJ * wc.wn + jj) + c0) = pack8(f);
        }
      }
      __syncthreads();
    }
    PHASE(9);

    // P10: XP -> u1, KVP -> u4 (cross) again; q and k of all heads,
    // normalised, into the block's scratch (QG, KG f32 [RT][C]; 1 / norm
    // RSG [2][RT][16])
    gather_rows<T, RT, C>(p, t, U1, U4, nullptr, false);
    for (int which = 0; which < 2; ++which) {
      const bf16* A = which == 0 ? U1 : (p.cross ? U4 : U1);
      const float* bias = which == 0 ? p.bq : p.bk;
      float* outg = which == 0 ? QG : KG;
      float* rsg = RSG + which * RT * 16;
      FC acc;
      zero_frags(acc);
      block_mma<true>(acc, A, ldb, which == 0 ? p.wq : p.wk, C, C, stage,
                      warp);
#pragma unroll
      for (int i = 0; i < FC::MI; ++i) {
        const int m = wc.wm + WC::WM * i;
        if (m >= MT) continue;
        const int r = 16 * m + rr;
        float f[WC::NJ][8], ss[WC::NJ];
#pragma unroll
        for (int jj = 0; jj < WC::NJ; ++jj) {
          stage_tile(acc.f[i][jj], st);
          read8(st, rr, c0, f[jj]);
          const int col = 16 * (WC::NJ * wc.wn + jj) + c0;
          ss[jj] = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            f[jj][k] += bias[col + k];
            ss[jj] += f[jj][k] * f[jj][k];
          }
          ss[jj] += __shfl_xor_sync(0xffffffffu, ss[jj], 1);
        }
        if (WC::NJ == 2 && D == 32) {
          const float s = ss[0] + ss[WC::NJ - 1];
          ss[0] = ss[WC::NJ - 1] = s;
        }
#pragma unroll
        for (int jj = 0; jj < WC::NJ; ++jj) {
          const int col0 = 16 * (WC::NJ * wc.wn + jj);
          const float rs = rsqrtf(ss[jj] + 1e-24f);
          float4* o = reinterpret_cast<float4*>(outg + r * C + col0 + c0);
          o[0] = make_float4(f[jj][0] * rs, f[jj][1] * rs, f[jj][2] * rs,
                             f[jj][3] * rs);
          o[1] = make_float4(f[jj][4] * rs, f[jj][5] * rs, f[jj][6] * rs,
                             f[jj][7] * rs);
          if (c0 == 0 && col0 % D == 0) rsg[r * 16 + col0 / D] = rs;
        }
      }
      __syncthreads();
    }
    PHASE(10);

    // P11: attention backward per head: q and k of the head again (from XP
    // u1, KVP u4 or XP), dA u0, V u3 -> DQ u2, DK u4 (self) / u7 (cross),
    // DV u7 (self) / u8 (cross)
    bf16* const DQ = U2;
    bf16* const DK = p.cross ? U7 : U4;
    bf16* const DV = p.cross ? U8 : U7;
    for (int h = 0; h < H; ++h) {
      // q_h, k_h of P10: f32 into qf / kf, bf16 into qh / kh, 1 / norm
      // into rq / rk
      for (int e = tid; e < 2 * RT * (D / 4); e += kThreads) {
        const int isk = e / (RT * (D / 4)), u = e % (RT * (D / 4));
        const int r = u / (D / 4), d = (u % (D / 4)) * 4;
        const float4 v =
            *reinterpret_cast<const float4*>((isk ? KG : QG) + r * C + h * D + d);
        *reinterpret_cast<float4*>((isk ? kf : qf) + r * ldqf + d) = v;
        bf16* nb = (isk ? kh : qh) + r * ldq + d;
        nb[0] = __float2bfloat16(v.x);
        nb[1] = __float2bfloat16(v.y);
        nb[2] = __float2bfloat16(v.z);
        nb[3] = __float2bfloat16(v.w);
      }
      for (int e = tid; e < 2 * RT; e += kThreads) {
        const int isk = e / RT, r = e % RT;
        (isk ? rk : rq)[r] = RSG[(isk * RT + r) * 16 + h];
      }
      __syncthreads();
      // dots (S1) and dp = dA_h V_h^T (S3), per window
      for (int it = warp; it < 2 * WPB * TT * TT; it += kWarps) {
        const bool isdp = it >= WPB * TT * TT;
        const int u = it % (WPB * TT * TT);
        const int w = u / (TT * TT), i = (u / TT) % TT, j = u % TT;
        const bf16* a = isdp ? U0 + h * D : qh;
        const bf16* b = isdp ? U3 + h * D : kh;
        const int la = isdp ? ldb : ldq;
        AccFrag acc;
        wmma::fill_fragment(acc, 0.f);
        for (int k0 = 0; k0 < D; k0 += 16) {
          AFrag fa;
          BColFrag fb;
          wmma::load_matrix_sync(fa, a + (w * T + 16 * i) * la + k0, la);
          wmma::load_matrix_sync(fb, b + (w * T + 16 * j) * la + k0, la);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(
            (isdp ? S3 : S1) + (w * T + 16 * i) * ldS + 16 * j, acc, ldS,
            wmma::mem_row_major);
      }
      __syncthreads();
      // p, ds = p (dp - sum(dp p)); the dtau partial sum(ds dots)
      for (int r = warp; r < RT; r += kWarps) {
        const int w = r / T;
        float l[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          l[u] = j < T ? (km_s[w * T + j] > 0.f ? S1[r * ldS + j] * scale
                                                : -30000.f)
                       : -CUDART_INF_F;
        }
        const float mx = warp_max(fmaxf(l[0], l[1]));
        float e[2], dp[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          e[u] = j < T ? expf(l[u] - mx) : 0.f;
          dp[u] = j < T ? S3[r * ldS + j] : 0.f;
        }
        const float inv = haskey[w] ? 1.f / warp_sum(e[0] + e[1]) : 0.f;
        const float pv[2] = {e[0] * inv, e[1] * inv};
        const float sdp = warp_sum(pv[0] * dp[0] + pv[1] * dp[1]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          if (j < T) {
            const float ds = pv[u] * (dp[u] - sdp);
            tau_acc += ds * S1[r * ldS + j];
            Pb[r * ldP + j] = __float2bfloat16(pv[u]);
            Db[r * ldP + j] = __float2bfloat16(ds);
          }
        }
      }
      __syncthreads();
      // per window and 16 rows: dv = p^T dA_h, dqn = ds kn, dkn = ds^T qn;
      // then the normalisation backward, the bf16 outputs and the bias
      // column sums of the 16 rows
      for (int it = warp; it < 3 * NWT; it += kWarps) {
        const int which = it / NWT, wi = it % NWT;  // 0 dv, 1 dq, 2 dk
        const int w = wi / TT, i = wi % TT;
        AccFrag acc[2];
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          wmma::fill_fragment(acc[dj], 0.f);
          if (dj >= DT) continue;
          for (int k = 0; k < TT; ++k) {
            BRowFrag b;
            if (which == 1) {
              AFrag a;
              wmma::load_matrix_sync(a, Db + (w * T + 16 * i) * ldP + 16 * k,
                                     ldP);
              wmma::load_matrix_sync(b, kh + (w * T + 16 * k) * ldq + 16 * dj,
                                     ldq);
              wmma::mma_sync(acc[dj], a, b, acc[dj]);
            } else {
              AColFrag a;
              wmma::load_matrix_sync(
                  a, (which == 0 ? Pb : Db) + (w * T + 16 * k) * ldP + 16 * i,
                  ldP);
              if (which == 0)
                wmma::load_matrix_sync(
                    b, U0 + (w * T + 16 * k) * ldb + h * D + 16 * dj, ldb);
              else
                wmma::load_matrix_sync(
                    b, qh + (w * T + 16 * k) * ldq + 16 * dj, ldq);
              wmma::mma_sync(acc[dj], a, b, acc[dj]);
            }
          }
        }
        const int r = w * T + 16 * i + rr;
        float f[2][8];
#pragma unroll
        for (int dj = 0; dj < 2; ++dj)
          if (dj < DT) {
            stage_tile(acc[dj], st);
            read8(st, rr, c0, f[dj]);
          }
        if (which != 0) {
          const float* nrm = (which == 1 ? qf : kf) + r * ldqf;
          const float rs = (which == 1 ? rq : rk)[r];
          float sdot = 0.f;
#pragma unroll
          for (int dj = 0; dj < 2; ++dj)
            if (dj < DT)
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                f[dj][k] *= scale;
                sdot += f[dj][k] * nrm[16 * dj + c0 + k];
              }
          sdot += __shfl_xor_sync(0xffffffffu, sdot, 1);
#pragma unroll
          for (int dj = 0; dj < 2; ++dj)
            if (dj < DT)
#pragma unroll
              for (int k = 0; k < 8; ++k)
                f[dj][k] = rs * (f[dj][k] - nrm[16 * dj + c0 + k] * sdot);
        }
        bf16* out = which == 0 ? DV : (which == 1 ? DQ : DK);
        bf16* wout = which == 0 ? p.wDV : (which == 1 ? p.wDQ : p.wDK);
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          if (dj >= DT) continue;
          const int col = h * D + 16 * dj + c0;
          const uint4 v = pack8(f[dj]);
          *reinterpret_cast<uint4*>(out + r * ldb + col) = v;
          if (r / T < nw)
            *reinterpret_cast<uint4*>(wout + (r0 + r) * C + col) = v;
          // column sums of the 16 rows: lanes of equal (lane & 1) share them
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float s = f[dj][k];
            for (int o = 2; o < 32; o <<= 1)
              s += __shfl_xor_sync(0xffffffffu, s, o);
            if (lane < 2)
              colpart[(which * NWT + wi) * 32 + 16 * dj + c0 + k] = s;
          }
        }
      }
      __syncthreads();
      // bias sums: the tiles' column sums in order (dbv, dbq, dbk)
      for (int e = tid; e < 3 * D; e += kThreads) {
        const int which = e / D, d = e % D;
        float s = 0.f;
        for (int wi = 0; wi < NWT; ++wi)
          s += colpart[(which * NWT + wi) * 32 + d];
        const int seg = which == 0 ? 2 : which - 1;  // bq bk bv
        pbias[seg * C + h * D + d] += s;
      }
    }
    PHASE(11);

    // P12: dx and dkv through the projections: self dX = DQ Wq + DK Wk
    // (= dXP, kept in (u0,u1) for dpos) + DV Wv; cross dX = DQ Wq (kept for
    // dpos), dKV = DK Wk (kept in (u3,u4) for dpos) + DV Wv. K7 adds dz1
    // and writes the rows; K9 keeps the packed rows in (u0,u1) / (u3,u4)
    // for the expansion.
    {
      auto finish = [&](FC& acc, bool is_dx) {
        float* keep = is_dx ? F01 : F34;
#pragma unroll
        for (int i = 0; i < FC::MI; ++i) {
          const int m = wc.wm + WC::WM * i;
          if (m >= MT) continue;
          const int r = 16 * m + rr;
#pragma unroll
          for (int jj = 0; jj < WC::NJ; ++jj) {
            stage_tile(acc.f[i][jj], st);
            if (r / T >= nw) continue;
            const int col = 16 * (WC::NJ * wc.wn + jj) + c0;
            float f[8];
            read8(st, rr, c0, f);
            if (is_dx) {
#pragma unroll
              for (int k = 0; k < 8; ++k) f[k] += F56[r * ldf + col + k];
              if (sel && qm_s[r] > 0.f) {
                float g8[8];
                unpack8(*reinterpret_cast<const uint4*>(
                            row_of<T, C>(p, t, p.g, r, false) + col),
                        g8);
#pragma unroll
                for (int k = 0; k < 8; ++k) f[k] -= g8[k];
              }
            }
            if (sel) {
#pragma unroll
              for (int k = 0; k < 8; ++k) keep[r * ldf + col + k] = f[k];
            } else {
              const long long o = ((long long)t.n0 * T + r) * C + col;
              *reinterpret_cast<uint4*>((is_dx ? p.dx : p.dkv) + o) = pack8(f);
            }
          }
        }
        __syncthreads();
      };
      // the tile's dpos (K7: one window, a row a cell): dXP (+ dKVP)
      auto put_dpos = [&](bool both) {
        __syncthreads();
        float* pdpos = part + 9 * C + F + 4;
        for (int e = tid; e < RT * (C / 4); e += kThreads) {
          const int r = e / (C / 4), c = (e % (C / 4)) * 4;
          float4 d = *reinterpret_cast<const float4*>(F01 + r * ldf + c);
          if (both) {
            const float4 b =
                *reinterpret_cast<const float4*>(F34 + r * ldf + c);
            d.x += b.x;
            d.y += b.y;
            d.z += b.z;
            d.w += b.w;
          }
          *reinterpret_cast<float4*>(pdpos + (r % T) * C + c) = d;
        }
        __syncthreads();
      };
      // products that are summed run as segments of one pipeline
      FC acc;
      zero_frags(acc);
      if (!p.cross && !p.want_dpos) {
        block_mma_seg<false>(acc, DQ, DK, DV, ldb, p.wq, p.wk, p.wv, C, 3, C,
                             stage, warp);
        finish(acc, true);
      } else if (!p.cross) {
        block_mma_seg<false>(acc, DQ, DK, DK, ldb, p.wq, p.wk, p.wk, C, 2, C,
                             stage, warp);
        store_frags(acc, F01, ldf, warp);
        block_mma<false>(acc, DV, ldb, p.wv, C, C, stage, warp);
        put_dpos(false);
        finish(acc, true);
      } else {
        block_mma<false>(acc, DQ, ldb, p.wq, C, C, stage, warp);
        if (p.want_dpos) store_frags(acc, F01, ldf, warp);
        finish(acc, true);
        zero_frags(acc);
        if (!p.want_dpos) {
          block_mma_seg<false>(acc, DK, DV, DV, ldb, p.wk, p.wv, p.wv, C, 2,
                               C, stage, warp);
        } else {
          block_mma<false>(acc, DK, ldb, p.wk, C, C, stage, warp);
          store_frags(acc, F34, ldf, warp);
          block_mma<false>(acc, DV, ldb, p.wv, C, C, stage, warp);
          put_dpos(true);
        }
        finish(acc, false);
      }
    }
    PHASE(12);

    if (sel) {
      // K9: dx[cell] = g[cell] + the packed dx of the slots selecting the
      // cell, in slot order; dkv likewise (cross)
      if (tid < WPB * kCells) {
        const int w = tid / kCells, cl = tid % kCells;
        unsigned long long qb = 0, kb = 0;
        if (w < nw)
          for (int s = 0; s < T; ++s) {
            if (clamp_cell(p.selq[r0 + w * T + s]) == cl) qb |= 1ull << s;
            if (p.cross && clamp_cell(p.selk[r0 + w * T + s]) == cl)
              kb |= 1ull << s;
          }
        qbits[tid] = qb;
        kbits[tid] = kb;
      }
      __syncthreads();
      constexpr int cv = C / 8;
      for (int e = tid; e < nw * kCells * cv; e += kThreads) {
        const int w = e / (kCells * cv), cl = (e / cv) % kCells;
        const int c = (e % cv) * 8;
        const long long o = ((long long)(t.n0 + w) * kCells + cl) * C + c;
        float d[8];
        unpack8(*reinterpret_cast<const uint4*>(p.g + o), d);
        for (unsigned long long b = qbits[w * kCells + cl]; b; b &= b - 1) {
          const float* src = F01 + (w * T + __ffsll(b) - 1) * ldf + c;
#pragma unroll
          for (int k = 0; k < 8; ++k) d[k] += src[k];
        }
        *reinterpret_cast<uint4*>(p.dx + o) = pack8(d);
        if (p.cross) {
#pragma unroll
          for (int k = 0; k < 8; ++k) d[k] = 0.f;
          for (unsigned long long b = kbits[w * kCells + cl]; b; b &= b - 1) {
            const float* src = F34 + (w * T + __ffsll(b) - 1) * ldf + c;
#pragma unroll
            for (int k = 0; k < 8; ++k) d[k] += src[k];
          }
          *reinterpret_cast<uint4*>(p.dkv + o) = pack8(d);
        }
      }
    }
    PHASE(13);

    // the tile's partials: the row-pass and bias sums, and dtau (per
    // thread, then the warps in order)
    __syncthreads();
    for (int e = tid; e < 9 * C + F; e += kThreads) part[e] = pvs[e];
    const float tw = warp_sum(tau_acc);
    if (lane == 0) cs[warp] = tw;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += cs[w];
      part[9 * C + F] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: the six weight-gradient products
// ---------------------------------------------------------------------------

constexpr int kGM = 64, kGN = 128, kGR = 32;  // output tile, rows a stage
constexpr int kGWarps = 8, kGThreads = kGWarps * 32;
constexpr int kMaxList = 4096;  // live windows of one chunk

struct WgradParams {
  const bf16* Y[6];
  const bf16* X[6];
  int M[6], Nc[6];
  float* part;  // product q, chunk z at part + poff[q] + z * M * N
  long long poff[6];
  const int* live;
  int nwin, T, splits;
};

__global__ void __launch_bounds__(kGThreads) wgrad_kernel(const WgradParams p) {
  __shared__ __align__(128) bf16 ys[2][kGR][kGM + 8];
  __shared__ __align__(128) bf16 xs[2][kGR][kGN + 8];
  __shared__ int list[kMaxList];
  __shared__ int wsum[kGWarps];
  const int prod = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int M = p.M[prod], N = p.Nc[prod];
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  if (m0 >= M || n0 >= N) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* Y = p.Y[prod];
  const bf16* X = p.X[prod];
  const int T = p.T;

  // rank the live windows in window order and keep this chunk's
  const int per = (p.nwin + kGThreads - 1) / kGThreads;
  const int lo_w = min(p.nwin, tid * per), hi_w = min(p.nwin, lo_w + per);
  int cnt = 0;
  for (int n = lo_w; n < hi_w; ++n) cnt += p.live[n] != 0;
  int inc = cnt;  // inclusive scan over the warp's lanes
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kGWarps; ++w) {
    if (w < warp) before += wsum[w];
    total += wsum[w];
  }
  const int chunk = (total + p.splits - 1) / p.splits;
  const int lo = min(total, split * chunk), hi = min(total, lo + chunk);
  int rank = before + inc - cnt;
  for (int n = lo_w; n < hi_w; ++n)
    if (p.live[n]) {
      if (rank >= lo && rank < hi) list[rank - lo] = n;
      ++rank;
    }
  __syncthreads();
  const int nsteps = (hi - lo) * (T / 16);  // 16-row steps

  // warp w: rows 16 (w / 2) and columns 64 (w % 2) of the 64 x 128 tile
  const int wm = warp / 2, wn = warp % 2;
  AccFrag acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  constexpr int kV = kGM / 8 + kGN / 8;  // 16-byte pieces of a staged row
  auto load = [&](int buf, int step0) {
    for (int e = tid; e < kGR * kV; e += kGThreads) {
      const int row = e / kV, v = e % kV;
      const int step = step0 + row / 16;
      const bool ok = step < nsteps;
      long long r = 0;
      if (ok) {
        const int wi = step / (T / 16), sub = step % (T / 16);
        r = (long long)list[wi] * T + sub * 16 + row % 16;
      }
      if (v < kGM / 8)
        cp_async16_zfill(&ys[buf][row][v * 8], Y + r * M + m0 + v * 8, ok);
      else
        cp_async16_zfill(&xs[buf][row][(v - kGM / 8) * 8],
                         X + r * N + n0 + (v - kGM / 8) * 8, ok);
    }
    cp_async_commit();
  };
  const int nst = (nsteps + 1) / 2;
  if (nst > 0) load(0, 0);
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      load((s + 1) & 1, 2 * (s + 1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b = s & 1;
#pragma unroll
    for (int kk = 0; kk < kGR; kk += 16) {
      AColFrag a;  // A(m, k) = Y[k][m]
      wmma::load_matrix_sync(a, &ys[b][kk][16 * wm], kGM + 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        BRowFrag bx;
        wmma::load_matrix_sync(bx, &xs[b][kk][64 * wn + 16 * j], kGN + 8);
        wmma::mma_sync(acc[j], a, bx, acc[j]);
      }
    }
    __syncthreads();
  }
  float* out = p.part + p.poff[prod] + (long long)split * M * N;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(
        out + (long long)(m0 + 16 * wm) * N + n0 + 64 * wn + 16 * j, acc[j], N,
        wmma::mem_row_major);
}

// ---------------------------------------------------------------------------
// pass 3: every fixed-order sum in one launch
// ---------------------------------------------------------------------------

struct ReduceParams {
  const float* wpart;  // the weight-gradient chunks
  long long poff[6];
  int wsize[6];       // M * N of each product
  float* wout[6];     // dWq dWk dWv dWo dW1 dW2
  const float* part;  // per-tile partials
  const int* tlive;   // the tiles that wrote them
  long long part_stride;
  int ntiles, C, F, splits;
  float* vout[10];  // ln2s ln2b b2 ln1s ln1b bo b1 bq bk bv
  float* dtau;
  float* dpos;  // or null
  const float* tau;
  float tau_min;
  long long nw, nv;  // weight elements (a thread each), the rest (a warp each)
  int wblocks;
};

__global__ void reduce_kernel(const ReduceParams p) {
  if ((int)blockIdx.x < p.wblocks) {  // weight gradients: over the chunks
    long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= p.nw) return;
    for (int q = 0; q < 6; ++q) {
      if (k < p.wsize[q]) {
        const float* src = p.wpart + p.poff[q] + k;
        float s = 0.f;
        for (int i = 0; i < p.splits; ++i) s += src[(long long)i * p.wsize[q]];
        p.wout[q][k] = s;
        return;
      }
      k -= p.wsize[q];
    }
    return;
  }
  // the rest, a warp an element: lane l sums the live tiles among l,
  // l + 32, ..., then the lanes add in a fixed tree
  const int lane = threadIdx.x % 32;
  const long long k = (long long)(blockIdx.x - p.wblocks) * (blockDim.x / 32) +
                      threadIdx.x / 32;
  if (k >= p.nv) return;
  const int C = p.C, F = p.F;
  const long long nvec = 6LL * C + F, tau_at = nvec + 3 * C;
  // row-pass vectors, attention biases, tau at their index; dpos after the
  // four floats of tau
  const long long off = k > tau_at ? k + 3 : k;
  float s = 0.f;
  for (int b = lane; b < p.ntiles; b += 32)
    if (p.tlive[b]) s += p.part[(long long)b * p.part_stride + off];
  s = warp_sum(s);
  if (lane) return;
  if (k < 6 * C) {
    p.vout[k / C][k % C] = s;
  } else if (k < nvec) {
    p.vout[6][k - 6 * C] = s;
  } else if (k < tau_at) {
    const long long j = k - nvec;
    p.vout[7 + j / C][j % C] = s;
  } else if (k == tau_at) {
    const float t = p.tau[0];
    p.dtau[0] = t > p.tau_min ? -s / (t * t) : 0.f;
  } else {
    p.dpos[k - tau_at - 1] = s;
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

int num_sms() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

int grid_of(int N, int T, int C) {
  const int tiles = (N + wpb_of(T, C) - 1) / wpb_of(T, C);
  return tiles < num_sms() ? tiles : num_sms();
}

template <int T, int C>
int launch_window(const BwdParams& p, int grid, cudaStream_t s) {
  constexpr Place PL(T, C);
  constexpr int WPB = wpb_of(T, C);
  const int e = (int)cudaFuncSetAttribute(
      window_bwd_kernel<T, WPB, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)PL.smem);
  if (e) return e;
  window_bwd_kernel<T, WPB, C><<<grid, kThreads, PL.smem, s>>>(p);
  return tmae_last_error();
}

Place place_of(int T, int C) {
  if (T == 16) return C == 128 ? Place(16, 128) : Place(16, 256);
  if (T == 48) return C == 128 ? Place(48, 128) : Place(48, 256);
  return C == 128 ? Place(64, 128) : Place(64, 256);
}

// in:  x kv g pos selq selk qmask kmask
// w:   wq bq wk bk wv bv wo bo tau ln1s ln1b w1 b1 w2 b2 ln2s ln2b
// ws:  the 12 operand arrays [N * T, width] bf16 (XP KVP KV A H1 GG DQ DK
//      DV DATT DFF1 DZ2; KVP null in self mode), live [N] (int32), part
//      and scratch (sized by encoder_bwd_sizes), wpart [splits * (4 C^2 +
//      2 C F)] (f32)
// out: dx dkv dpos, then the 17 gradients in the order of w
int launch_bwd(const void* const* in, const void* const* w, void* const* ws,
               void* const* out, int N, int T, int C, int F, int H, int cross,
               float tau_min, int splits, cudaStream_t s) {
  // C = 128 or 256 with 8 heads and an FFN width of 2C: the widths of the
  // T-MAE configs, which the kernel's layout is compiled for
  if ((C != 128 && C != 256) || H != 8 || F != 2 * C || N <= 0 ||
      splits <= 0 || (N + splits - 1) / splits > kMaxList)
    return (int)cudaErrorInvalidValue;
  BwdParams p{};
  p.x = static_cast<const bf16*>(in[0]);
  p.kv = static_cast<const bf16*>(in[1]);
  p.g = static_cast<const bf16*>(in[2]);
  p.pos = static_cast<const bf16*>(in[3]);
  p.selq = static_cast<const int*>(in[4]);
  p.selk = static_cast<const int*>(in[5]);
  p.qmask = static_cast<const float*>(in[6]);
  p.kmask = static_cast<const float*>(in[7]);
  const bf16* const* wm = reinterpret_cast<const bf16* const*>(w);
  const float* const* wf = reinterpret_cast<const float* const*>(w);
  p.wq = wm[0];
  p.bq = wf[1];
  p.wk = wm[2];
  p.bk = wf[3];
  p.wv = wm[4];
  p.bv = wf[5];
  p.wo = wm[6];
  p.bo = wf[7];
  p.tau = wf[8];
  p.ln1s = wf[9];
  p.ln1b = wf[10];
  p.w1 = wm[11];
  p.b1 = wf[12];
  p.w2 = wm[13];
  p.b2 = wf[14];
  p.ln2s = wf[15];
  p.ln2b = wf[16];
  p.N = N;
  p.cross = cross;
  p.tau_min = tau_min;
  bf16* const* wb = reinterpret_cast<bf16* const*>(ws);
  p.wXP = wb[0];
  p.wKVP = cross ? wb[1] : wb[0];
  p.wKV = wb[2];
  p.wA = wb[3];
  p.wH1 = wb[4];
  p.wGG = wb[5];
  p.wDQ = wb[6];
  p.wDK = wb[7];
  p.wDV = wb[8];
  p.wDATT = wb[9];
  p.wDFF1 = wb[10];
  p.wDZ2 = wb[11];
  p.live = static_cast<int*>(ws[12]);
  p.counter = p.live + N;
  p.tlive = p.live + N + 1;
  p.part = static_cast<float*>(ws[13]);
  p.scratch = static_cast<unsigned char*>(ws[14]);
  float* wpart = static_cast<float*>(ws[15]);
  p.dx = static_cast<bf16*>(out[0]);
  p.dkv = static_cast<bf16*>(out[1]);
  float* dpos = static_cast<float*>(out[2]);
  p.want_dpos = dpos != nullptr && T == kCells;
  float* const* gr = reinterpret_cast<float* const*>(out + 3);
  const int wpb = wpb_of(T, C);
  p.ntiles = (N + wpb - 1) / wpb;
  const int grid = grid_of(N, T, C);
  p.part_stride = part_size(C, F, p.want_dpos);

  int e = (int)cudaMemsetAsync(p.counter, 0, sizeof(int), s);
  if (e) return e;
  if (T == 16 && C == 128) e = launch_window<16, 128>(p, grid, s);
  else if (T == 16) e = launch_window<16, 256>(p, grid, s);
  else if (T == 48 && C == 128) e = launch_window<48, 128>(p, grid, s);
  else if (T == 48) e = launch_window<48, 256>(p, grid, s);
  else if (T == 64 && C == 128) e = launch_window<64, 128>(p, grid, s);
  else if (T == 64) e = launch_window<64, 256>(p, grid, s);
  else return (int)cudaErrorInvalidValue;
  if (e) return e;

  // pass 2: dW = dY^T X, in the layout of the weights ([out, in])
  WgradParams g{};
  const bf16* Ys[6] = {p.wDQ, p.wDK, p.wDV, p.wDATT, p.wDFF1, p.wDZ2};
  const bf16* Xs[6] = {p.wXP, p.wKVP, p.wKV, p.wA, p.wH1, p.wGG};
  const int Ms[6] = {C, C, C, C, F, C};
  const int Ns[6] = {C, C, C, C, C, F};
  long long off = 0;
  for (int q = 0; q < 6; ++q) {
    g.Y[q] = Ys[q];
    g.X[q] = Xs[q];
    g.M[q] = Ms[q];
    g.Nc[q] = Ns[q];
    g.poff[q] = off;
    off += (long long)splits * Ms[q] * Ns[q];
  }
  g.part = wpart;
  g.live = p.live;
  g.nwin = N;
  g.T = T;
  g.splits = splits;
  wgrad_kernel<<<dim3(F / kGN, F / kGM, 6 * splits), kGThreads, 0, s>>>(g);
  if ((e = tmae_last_error())) return e;

  // pass 3: the sums
  ReduceParams r{};
  r.wpart = wpart;
  long long nwel = 0;
  const int wo[6] = {0, 2, 4, 6, 11, 13};
  for (int q = 0; q < 6; ++q) {
    r.poff[q] = g.poff[q];
    r.wsize[q] = Ms[q] * Ns[q];
    r.wout[q] = gr[wo[q]];
    nwel += r.wsize[q];
  }
  r.part = p.part;
  r.tlive = p.tlive;
  r.part_stride = p.part_stride;
  r.ntiles = p.ntiles;
  r.C = C;
  r.F = F;
  r.splits = splits;
  const int vo[10] = {15, 16, 14, 9, 10, 7, 12, 1, 3, 5};
  for (int q = 0; q < 10; ++q) r.vout[q] = gr[vo[q]];
  r.dtau = gr[8];
  r.dpos = p.want_dpos ? dpos : nullptr;
  r.tau = p.tau;
  r.tau_min = tau_min;
  r.nw = nwel;
  r.nv = 9LL * C + F + 1 + (r.dpos ? (long long)kCells * C : 0);
  r.wblocks = (int)((nwel + 255) / 256);
  reduce_kernel<<<(unsigned)(r.wblocks + (r.nv + 7) / 8), 256, 0, s>>>(r);
  return tmae_last_error();
}

}  // namespace

// The sizes of a call's workspace that depend on the card: sizes[0] the
// per-tile partials (bytes), sizes[1] the blocks' scratch (bytes),
// sizes[2] the ints of `live` (the windows' flags, the tile counter, the
// tiles' flags).
extern "C" int encoder_bwd_sizes(int N, int T, int C, int F, int H, int dpos,
                                 long long* sizes) {
  if ((T != 16 && T != 48 && T != 64) || N <= 0 || (C != 128 && C != 256) ||
      H != 8 || F != 2 * C)
    return (int)cudaErrorInvalidValue;
  const Place pl = place_of(T, C);
  const int grid = grid_of(N, T, C);
  const int ntiles = (N + wpb_of(T, C) - 1) / wpb_of(T, C);
  sizes[0] = (long long)ntiles * part_size(C, F, dpos && T == kCells) * 4;
  sizes[1] = (long long)grid * pl.scratch;
  sizes[2] = (long long)N + 1 + ntiles;
  return 0;
}

#ifdef TMAE_BWD_PROFILE
// The phase cycles summed over blocks (16 phases), then zeroed.
extern "C" int tmae_bwd_profile(unsigned long long* out16) {
  static unsigned long long h[1024][16];
  int e = (int)cudaMemcpyFromSymbol(h, tmae_bwd_phase_cycles, sizeof(h));
  if (e) return e;
  for (int k = 0; k < 16; ++k) {
    out16[k] = 0;
    for (int b = 0; b < 1024; ++b) out16[k] += h[b][k];
  }
  static unsigned long long z[1024][16];
  return (int)cudaMemcpyToSymbol(tmae_bwd_phase_cycles, z, sizeof(z));
}
#endif

// K7: the full-window layer (T = 64). Pointer arrays as in launch_bwd; selq,
// selk may be null there. dpos (out[2]) is optional.
extern "C" int launch_encoder_bwd_full(const void* const* in,
                                       const void* const* w, void* const* ws,
                                       void* const* out, int N, int C, int F,
                                       int H, int cross, float tau_min,
                                       int splits, void* stream) {
  const void* ins[8] = {in[0], in[1], in[2], in[3], nullptr, nullptr, in[6],
                        in[7]};
  return launch_bwd(ins, w, ws, out, N, kCells, C, F, H, cross, tau_min,
                    splits, static_cast<cudaStream_t>(stream));
}

// K9: the selected-cells layer (T = S = 16 or 48).
extern "C" int launch_encoder_bwd_sel(const void* const* in,
                                      const void* const* w, void* const* ws,
                                      void* const* out, int N, int S, int C,
                                      int F, int H, int cross, float tau_min,
                                      int splits, void* stream) {
  if ((S != 16 && S != 48) || in[4] == nullptr)
    return (int)cudaErrorInvalidValue;
  if (cross && in[5] == nullptr) return (int)cudaErrorInvalidValue;
  return launch_bwd(in, w, ws, out, N, S, C, F, H, cross, tau_min, splits,
                    static_cast<cudaStream_t>(stream));
}
