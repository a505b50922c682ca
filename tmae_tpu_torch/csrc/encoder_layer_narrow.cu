// NARROW_FWD and NARROW_BWD for Hopper: the cosine-attention encoder layer
// at the narrow widths, (C, heads) = (32, 4), (64, 4) and (64, 8) with FFN
// width 2C (head width 8 or 16): the stages of t_mae_mini.yaml and
// t_mae_ssl_mini.yaml, and the previous frame's stage 1 under
// ASYMMETRIC.HALF_CHANNELS (C = 64, 8 heads).
//
// They replace no Pallas kernel. tmae_tpu/ops/pallas_encoder.py takes its
// kernels only when C % 128 == 0 (:402, :1063, :1109; models/sst.py:171,
// :262) and computes these widths in XLA: reference_encoder_layer (:280),
// reference_encoder_layer_sel (:944) and reference_encoder_layer_grid
// (:1559) forward, _bwd_recompute (:418), _bwd_sel_recompute (:1125) and
// _grid_bwd (:1528) backward. The tiled kernel (encoder_layer_tiled.cu)
// cannot run them: its weight panels hold 128 output rows, so C / 128
// passes is 0 below C = 128, and its heads are 8. NARROW_FWD computes the
// function of K3, K4, K6, K8, K10 and K12 in each of their addressings
// (window rows in place and out of place, S = 16 / 48 packed, the grid's
// shifted partition, a plan's windows in the padded carrier); NARROW_BWD
// that of K7 / K9 (dx, dkv, the 17 parameter gradients, and dpos for the
// full variant; the grid backward runs it on the windows with a query, as
// it runs K7).
//
// Numerics: those of the tiled kernel and K7 / K9 (csrc headers there):
// bf16 matmul operands with f32 sums, x + pos rounded to bf16, per-head L2
// normalisation rsqrt(sum^2 + 1e-24) in f32, q scaled by 1/max(tau,
// tau_min), masked keys at -30000 before a per-head softmax, p = 0 in a
// window without a key, p and the attention output in bf16, the attention
// delta on occupied query cells only, LayerNorm (eps 1e-5) in f32 and 0 on
// unoccupied cells, the exact-erf GELU, the f32 residual. The backward
// recomputes the forward (with q and k normalised but unscaled in bf16, the
// scale applied to their f32 dot, as K7 does) and rounds the operands of
// every backward product (dz2, dz1, do, datt, p, ds, dq, dk, dv) to bf16.
// Every sum runs in a fixed order: a call gives the same bits twice.
//
// Bound on this card. A 64-row window does 2 T C^2 4 + 2 T C F 2 + 2 T^2 C 2
// = 9.4 MFLOP at C = 64 (2.6 at C = 32) on 8 KiB (4 KiB) of rows in and
// out: 300-600 operations a byte, about the H100's balance point, so the
// work on the live windows of a call is microseconds either way. What holds
// it back is latency: a call with fewer tiles than SMs takes one block's
// walk of a tile through some 20 small products one after another.
//
// Design. At these widths the six matrices take 8 C^2 bf16 = 64 KiB (C =
// 64) or 16 KiB (C = 32), so a persistent block loads the whole layer into
// shared memory once (bf16: the wrappers hand kernel_params' tensors, or a
// served layer's bf16 copy made once a forward) and keeps it for every
// tile it takes; nothing streams. Forward: the pre-pass and compaction of
// the tiled kernel (encoder_fwd_plan.cuh: live flags, the live windows in
// order, an atomic tile counter), then one block of 8 warps an SM takes
// tiles of 64 rows (4 windows at S = 16, one window at S = 48 padded to 64
// rows, one at T = 64) and finds their rows with tile_rows; a block's
// first tile is its own index (no atomic), the counter hands out the
// rest. Two warps own a row group of 16 rows from their load to their
// store, and split the output columns of every product: the q, k, v and
// output projections and both FFN products are mma.sync m16n8k16 products
// of the group's rows against the resident weights (ldmatrix fragments
// from padded row buffers, no bank conflicts); each half of q and k holds
// whole heads, so the head normalisation stays in the warp; LayerNorm's
// row sums add the two halves' partials (half 0's then half 1's) at a
// named barrier of the pair; the only exchange between row groups is the
// tile's keys and values before attention. Attention: each warp its
// half's heads for its 16 query rows, q k^T and p v on mma.sync; a head of
// width 8 has its products' upper 8 of 16 reduction columns set to 0 in
// the fragments. A tile is a chain of latencies on one SM, bound by its
// issue and exponential rates more than by any one warp: four warps a
// row group (the columns in quarters) took as long (utils/fwd_phases.py
// --narrow --cycles: attention about 30% of a tile's cycles, the tile's
// start 25%). The first tile's rows are found (warps 0 and 1) while the
// other warps request the vectors and wq, wk, wv (cp.async, 16 bytes a
// copy), then wo, w1, w2, which land during q, k, v and attention; the
// rows (cp.async, zeros for no row) land with the first group; once a
// tile's keys and values are in, warps 0 and 1 find the next tile's rows
// and start their copies into the other row buffers, which land while
// this tile runs.
// Backward (three launches after its own pre-pass and the compaction): the
// same tiles recompute the forward and run the layer's backward down to
// dx, dkv and dpos, with the weight-gradient operands of each row written
// to device memory (bf16, a row of the workspace per tile row) and the
// bias, LayerNorm and tau sums of each tile as one row of partials; a
// second kernel multiplies the six dY^T X products over chunks of rows into
// chunk partials, and a third sums every partial in a fixed order. A window
// whose cotangent is 0 on all its query cells adds nothing to any output
// (the layer's VJP is linear in g and masks g with the query mask): its
// pre-pass writes dx = 0 (g at S = 16, 48) and dkv = 0, and it takes no
// tile.
//
// The backward's time (utils/bwd_phases.py --narrow, H100 SXM at 700 W, 109
// live tiles at C = 64 with 8 heads, the first design): the window pass
// 0.054-0.076 ms, the weight gradients 0.070-0.109 (64 blocks, each
// summing up to 4096 rows one 64-row step after another), the sums
// 0.006-0.009, the pre-pass and compaction 0.005; and a call with fewer
// tiles than SMs is a tile's latency. So the backward fills the SM and
// the card as the forward does, and more:
// - the window pass runs 8 warps a tile, two a row group of 16 rows, and
//   the two split the output columns of every product (each half of q and
//   k holds whole heads, so their normalisation stays in the warp);
//   LayerNorm's row statistics and its backward's row sums add the two
//   halves' partials through shared memory (half 0's then half 1's: both
//   warps hold the same bits) at a named barrier of the pair; the
//   attention backward takes one head of each half a round, each half with
//   its own P and dS tiles, so H / 2 rounds of two block barriers;
// - the weight gradients take chunks of at least 256 rows (4 tiles; at
//   most 64 chunks), each block loading the next 64 rows into registers
//   while it multiplies the current ones;
// - the sums take each output in 8 runs of consecutive partials, each run
//   by a warp in order, then the 8 run sums in order.
// Every sum keeps a fixed order, so a call gives the same bits twice.
// The forward's time (utils/fwd_phases.py --narrow, H100 SXM at 700 W, the
// tile kernel's device time against the first design's, one warp a row
// group with its weights converted before the first row): 0.0145 against
// 0.0199 ms at (64, 8) on a served full bucket with 109 of 256 slots live,
// 0.0122 against 0.0163 at (64, 4), 0.0092 against 0.0118 at (32, 4); a
// call's event time is its host enqueue time (~0.03 ms). More in PERF.md
// and utils/bwd_phases.py --narrow.

#include <algorithm>

#include "encoder_fwd_plan.cuh"

namespace {

constexpr int kFWarps = 8;               // NARROW_FWD: two a row group
constexpr int kFThreads = 32 * kFWarps;
constexpr int kBWarps = 8;               // NARROW_BWD: two a row group
constexpr int kBThreads = 32 * kBWarps;
constexpr int kRuns = 8;  // runs of a gradient's fixed-order sum

// Sizes at width C (FFN 2C) and the byte sizes of the row buffers.
template <int C>
struct Narrow {
  static constexpr int F = 2 * C;
  static constexpr int NC = C / 8;      // 8-column tiles of a row of C
  static constexpr int NF = F / 8;
  static constexpr int LC = C + 8;      // row stride of a [64 x C] buffer
  static constexpr int LF = F + 8;
  static constexpr int LP = kRows + 8;  // of a [64 x 64] probability tile
  static constexpr int kBufC = kRows * LC * 2;
  static constexpr int kBufF = kRows * LF * 2;
  static constexpr int kBufP = kRows * LP * 2;
  // the weights, bf16: wq wk wv wo [C][LC], w1 [F][LC], w2 [C][LF]
  static constexpr int kWElems = 4 * C * LC + F * LC + C * LF;
  static constexpr int kWBytes = 2 * kWElems;
  // the backward's per-tile sums: bq bk bv bo ln1s ln1b [C each], b1 [F],
  // b2 ln2s ln2b [C each], tau
  static constexpr int kVec = 9 * C + F + 1;
  static_assert(kBufF <= 2 * kBufC, "the FFN hidden spans two row buffers");
  static_assert(kWBytes % 16 == 0 && kBufC % 16 == 0, "misaligned plan");
};

// offsets in the backward's per-tile sums
template <int C>
struct Vec {
  static constexpr int bq = 0, bk = C, bv = 2 * C, bo = 3 * C, ln1s = 4 * C,
                       ln1b = 5 * C, b1 = 6 * C, b2 = 8 * C, ln2s = 9 * C,
                       ln2b = 10 * C, tau = 11 * C;
};

// The metadata of a tile's 64 rows (tile_rows) and the tile index.
struct RowMeta {
  long long qoff[kRows], koff[kRows];
  int qcell[kRows], kcell[kRows];
  float qm[kRows], km[kRows];
  int tile;
};

// The six Linear weights [out, in] of a layer (wq wk wv wo w1 w2), bf16.
struct Mats {
  const void* m[6];
};

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p))
      : "memory");
}

// d += a b: m16n8k16, bf16 operands, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// the sum over the 8 row groups of a warp (lanes with the same lane % 4)
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ float warp_sum(float v) {
  return rows_sum(v + __shfl_xor_sync(0xffffffffu, v, 1) +
                  __shfl_xor_sync(0xffffffffu, v, 2) +
                  __shfl_xor_sync(0xffffffffu, v, 3));
}

template <int NT>
__device__ __forceinline__ void zero(float (&a)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// A thread's fragment of a warp's 16 rows: rows g and g + 8, columns 8 j +
// t2 and 8 j + t2 + 1 of each 8-column tile j.
__device__ __forceinline__ void st2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2(lo, hi);
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return unpack2(*reinterpret_cast<const uint32_t*>(p));
}

// bf16 fragments of a warp's rows into a row buffer (`dst` at its row r0)
template <int NT>
__device__ __forceinline__ void store_frag(bf16* dst, int ld,
                                           const float (&v)[NT][4], int g,
                                           int t2) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    st2(dst + g * ld + 8 * j + t2, v[j][0], v[j][1]);
    st2(dst + (g + 8) * ld + 8 * j + t2, v[j][2], v[j][3]);
  }
}

// acc += A W^T: A the warp's 16 rows (`a` at its first row, stride la) by
// K columns, W [8 NT rows][K] (stride lw), both in shared memory.
template <int NT, int K>
__device__ __forceinline__ void mm_wt(float (&acc)[NT][4], const bf16* a,
                                      int la, const bf16* w, int lw,
                                      int lane) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm4(af, a + (lane & 15) * la + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4(b, w + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * lw + k0 +
                   ((lane >> 3) & 1) * 8);
      mma(acc[j], af, b[0], b[1]);
      if constexpr (NT > 1) mma(acc[j + 1], af, b[2], b[3]);
    }
  }
}

// acc += A M: A as for mm_wt, M [K][8 NT] (stride lm).
template <int NT, int K>
__device__ __forceinline__ void mm_m(float (&acc)[NT][4], const bf16* a,
                                     int la, const bf16* m, int lm,
                                     int lane) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm4(af, a + (lane & 15) * la + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4t(b, m + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * lm + 8 * j +
                    (lane >> 4) * 8);
      mma(acc[j], af, b[0], b[1]);
      if constexpr (NT > 1) mma(acc[j + 1], af, b[2], b[3]);
    }
  }
}

// acc += S^T M: S [K][16] (the warp's 16 output rows are S's columns from
// `s`, stride ls), M [K][8 NT] (stride lm).
template <int NT, int K>
__device__ __forceinline__ void mm_tm(float (&acc)[NT][4], const bf16* s,
                                      int ls, const bf16* m, int lm,
                                      int lane) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm4t(af, s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ls +
                   ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4t(b, m + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * lm + 8 * j +
                    (lane >> 4) * 8);
      mma(acc[j], af, b[0], b[1]);
      if constexpr (NT > 1) mma(acc[j + 1], af, b[2], b[3]);
    }
  }
}

// s = the dots of the warp's 16 rows of `a` with NK rows of `b` over D
// columns (both at their first row and column, stride ld); at D = 8 the
// upper 8 reduction columns of the m16n8k16 fragments are 0.
template <int NK, int D>
__device__ __forceinline__ void row_dots(float (&s)[NK / 8][4], const bf16* a,
                                         const bf16* b, int ld, int lane) {
  zero(s);
  uint32_t af[4];
  ldsm4(af, a + (lane & 15) * ld + (lane >> 4) * 8);
  if constexpr (D == 8) af[2] = af[3] = 0u;
#pragma unroll
  for (int np = 0; np < NK / 16; ++np) {
    uint32_t bf[4];
    ldsm4(bf, b + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * ld +
                  ((lane >> 3) & 1) * 8);
    if constexpr (D == 8) bf[1] = bf[3] = 0u;
    mma(s[2 * np], af, bf[0], bf[1]);
    mma(s[2 * np + 1], af, bf[2], bf[3]);
  }
}

// In place: the masked softmax of each row of s over NK keys (key mask
// `km` at the first key); p = 0 when the window has no key (`hk` false).
template <int NK>
__device__ __forceinline__ void softmax_rows(float (&s)[NK / 8][4],
                                             const float* km, bool hk,
                                             int t2) {
  float ma = -CUDART_INF_F, mb = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!(km[8 * n + t2 + e] > 0.f)) s[n][e] = s[n][2 + e] = -30000.f;
      ma = fmaxf(ma, s[n][e]);
      mb = fmaxf(mb, s[n][2 + e]);
    }
  }
  ma = quad_max(ma);
  mb = quad_max(mb);
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[n][e] = expf(s[n][e] - ma);
      s[n][2 + e] = expf(s[n][2 + e] - mb);
      sa += s[n][e];
      sb += s[n][2 + e];
    }
  }
  const float ia = hk ? 1.f / quad_sum(sa) : 0.f;
  const float ib = hk ? 1.f / quad_sum(sb) : 0.f;
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
    s[n][0] *= ia;
    s[n][1] *= ia;
    s[n][2] *= ib;
    s[n][3] *= ib;
  }
}

// The A fragment of k-step kt from a row of probabilities in registers.
template <int NK>
__device__ __forceinline__ void p_frag(uint32_t (&a)[4],
                                       const float (&p)[NK / 8][4], int kt) {
  a[0] = pack2(p[2 * kt][0], p[2 * kt][1]);
  a[1] = pack2(p[2 * kt][2], p[2 * kt][3]);
  a[2] = pack2(p[2 * kt + 1][0], p[2 * kt + 1][1]);
  a[3] = pack2(p[2 * kt + 1][2], p[2 * kt + 1][3]);
}

// o += p M over NK keys: p in registers, M [NK][D] (`m` at the first key
// and the head's first column, stride ld).
template <int NK, int D>
__device__ __forceinline__ void p_times(float (&o)[D / 8][4],
                                        const float (&p)[NK / 8][4],
                                        const bf16* m, int ld, int lane) {
#pragma unroll
  for (int kt = 0; kt < NK / 16; ++kt) {
    uint32_t a[4], b[4];
    p_frag<NK>(a, p, kt);
    ldsm4t(b, m + (16 * kt + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                  (lane >> 4) * 8);
    mma(o[0], a, b[0], b[1]);
    if constexpr (D == 16) mma(o[1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Pointers into the resident weights.
template <int C>
struct WPtr {
  const bf16 *q, *k, *v, *o, *w1, *w2;
  __device__ explicit WPtr(const bf16* w) {
    constexpr int LC = C + 8;
    q = w;
    k = q + C * LC;
    v = k + C * LC;
    o = v + C * LC;
    w1 = o + C * LC;
    w2 = w1 + 2 * C * LC;
  }
};

// The forward of one tile's attention for the warp's 16 query rows (from
// r0): heads h0 .. h0 + nh (all by default), bf16(p v) into `out` (its rows
// r0..r0 + 15). The query block sees NK keys from key0 (its own window's 16
// at T = 16).
template <int T, int C, int H>
__device__ __forceinline__ void attention_fwd(const bf16* qn, const bf16* kn,
                                              const bf16* vb, bf16* out,
                                              const float* km, float mult,
                                              int r0, int lane, int h0 = 0,
                                              int nh = H) {
  constexpr int D = C / H, LC = C + 8, NK = T == 16 ? 16 : T;
  const int key0 = T == 16 ? r0 : 0;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  bool hk = false;
  for (int k = lane; k < NK; k += 32) hk |= km[key0 + k] > 0.f;
  hk = __any_sync(0xffffffffu, hk);
#pragma unroll 1
  for (int h = h0; h < h0 + nh; ++h) {
    float s[NK / 8][4];
    row_dots<NK, D>(s, qn + r0 * LC + h * D, kn + key0 * LC + h * D, LC,
                    lane);
    if (mult != 1.f) {
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= mult;
    }
    softmax_rows<NK>(s, km + key0, hk, t2);
    float o[D / 8][4];
    zero(o);
    p_times<NK, D>(o, s, vb + key0 * LC + h * D, LC, lane);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = h * D + 8 * n + t2;
      st2(out + (r0 + g) * LC + c, o[n][0], o[n][1]);
      st2(out + (r0 + g + 8) * LC + c, o[n][2], o[n][3]);
    }
  }
}

bool narrow_ok(int C, int F, int H) {
  return F == 2 * C && ((C == 32 && H == 4) || (C == 64 && (H == 4 || H == 8)));
}

// ---------------------------------------------------------------------------
// NARROW_BWD
// ---------------------------------------------------------------------------

struct BwdParams {
  FwdParams f;  // window rows of flat [N, 64, C] windows; list, count, ...
  const bf16* g;
  bf16 *dx, *dkv;
  // weight-gradient operands [rows, width] bf16, row 64 tile + r: the
  // products' inputs x + pos, kv + pos (self mode: x + pos), kv (self: x),
  // the attention output, h1, the GELU output, and their output gradients
  // dq, dk, dv, do, dz1, dz2
  bf16 *oXP, *oKP, *oKR, *oA, *oHB, *oUB, *oDQ, *oDK, *oDV, *oDO, *oDZ1,
      *oDZ2;
  float* part_v;  // [tiles, Narrow<C>::kVec] per-tile sums
  float* part_p;  // [tiles, 64 C] per-tile dpos (null unless wanted)
};

// sums[8 j + t2 (+1)] += the sum of v over the warp's 16 rows (lanes 0-3
// write: a fixed order)
template <int NT>
__device__ __forceinline__ void col_sums(float* sums, const float (&v)[NT][4],
                                         int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float a = rows_sum(v[j][0] + v[j][2]);
    const float b = rows_sum(v[j][1] + v[j][3]);
    if (lane < 4) {
      sums[8 * j + 2 * lane] += a;
      sums[8 * j + 2 * lane + 1] += b;
    }
  }
}

// the g rows of the warp's fragments (0 where offs < 0)
template <int NT>
__device__ __forceinline__ void load_g(float (&v)[NT][4], const bf16* g,
                                       const long long* offs, int r0, int gi,
                                       int t2) {
  const long long oa = offs[r0 + gi], ob = offs[r0 + gi + 8];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 a = oa >= 0 ? ld2(g + oa + 8 * j + t2) : make_float2(0, 0);
    const float2 b = ob >= 0 ? ld2(g + ob + 8 * j + t2) : make_float2(0, 0);
    v[j][0] = a.x;
    v[j][1] = a.y;
    v[j][2] = b.x;
    v[j][3] = b.y;
  }
}

// Matrices m0 .. m1 - 1 of the six (wq wk wv wo w1 w2, bf16) into shared
// memory (the plan of Narrow<C>) by cp.async, 16 bytes a copy, by threads
// t of nth; no commit.
template <int C>
__device__ __forceinline__ void copy_weights_async(const Mats& mats,
                                                   bf16* dst, int t, int nth,
                                                   int m0, int m1) {
  constexpr int F = 2 * C;
  for (int m = m0; m < m1; ++m) {
    const int rows = m == 4 ? F : C, cols = m == 5 ? F : C;
    const int off = m < 5 ? m * C * (C + 8) : 4 * C * (C + 8) + F * (C + 8);
    const bf16* src = static_cast<const bf16*>(mats.m[m]);
    for (int e = t; e < rows * cols / 8; e += nth) {
      const int r = e / (cols / 8), c8 = e % (cols / 8);
      asm volatile(
          "cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
              saddr(dst + off + r * (cols + 8) + c8 * 8)),
          "l"(src + (long long)r * cols + c8 * 8)
          : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The six matrices in one group: they land while the block does other
// work, and cp_async_wait makes them visible.
template <int C, int NTH>
__device__ __forceinline__ void load_weights_async(const Mats& mats,
                                                   bf16* dst, int tid) {
  copy_weights_async<C>(mats, dst, tid, NTH, 0, 6);
  cp_async_commit();
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// every group of this thread but the most recent one has landed
__device__ __forceinline__ void cp_async_wait_but_last() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// The layer's ten bias and LayerNorm vectors into shared memory as Vec<C>
// lays them out (bq .. ln2b; not tau), by cp.async 16 bytes a copy; the
// next commit takes them into its group.
template <int C, int NTH>
__device__ __forceinline__ void load_vectors_async(const FwdParams& f,
                                                   float* vs, int tid) {
  const float* const src[10] = {f.bq, f.bk, f.bv, f.bo, f.ln1s,
                                f.ln1b, f.b1, f.b2, f.ln2s, f.ln2b};
  for (int i = tid; i < (Narrow<C>::kVec - 1) / 4; i += NTH) {
    const int e = 4 * i;  // 16 bytes of one vector a copy
    const int k = e < 6 * C ? e / C : (e < 8 * C ? 6 : 7 + (e - 8 * C) / C);
    const int at = k < 7 ? k * C : 8 * C + (k - 7) * C;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     saddr(vs + e)),
                 "l"(src[k] + (e - at))
                 : "memory");
  }
}

// 16 bytes from global memory into shared memory by cp.async; zeros when
// `full` is false (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   saddr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// v += bias, per column, the bias in shared memory
template <int NT>
__device__ __forceinline__ void add_bias_s(float (&v)[NT][4], const float* b,
                                           int t2) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bi = *reinterpret_cast<const float2*>(b + 8 * j + t2);
    v[j][0] += bi.x;
    v[j][1] += bi.y;
    v[j][2] += bi.x;
    v[j][3] += bi.y;
  }
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// gelu(v) into v and gelu'(v) into d, one erf for both (gelu's bits)
__device__ __forceinline__ void gelu_and_grad(float& v, float& d) {
  const float e = erff(v * 0.70710678118654752f);
  d = 0.5f * (1.f + e) + v * 0.39894228040143268f * expf(-0.5f * v * v);
  v = 0.5f * v * (1.f + e);
}

// The two warps of a row group meet (named barrier 1 + rg: 64 threads).
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;" ::"r"(rg + 1) : "memory");
}

// A warp pair's 16 rows of a row buffer to the workspace rows row0 ..
// (`pl`: the thread's place in the pair, 0-63)
template <int W>
__device__ __forceinline__ void put_rows_pair(bf16* dst, long long row0,
                                              const bf16* src, int ld,
                                              int pl) {
  for (int e = pl; e < 16 * (W / 8); e += 64) {
    const int r = e / (W / 8), ch = e % (W / 8);
    *reinterpret_cast<uint4*>(dst + (row0 + r) * W + ch * 8) =
        *reinterpret_cast<const uint4*>(src + r * ld + ch * 8);
  }
}

// A warp pair's 16 rows of a tile into row buffers (`pl`: the thread's
// place in the pair, 0-63): `raw` the bf16 row at base + offs[r] (zeros
// where offs[r] < 0), `with_pos` bf16(row + pos[cells[r]]); either may be
// null.
template <int C>
__device__ __forceinline__ void load_rows_pair(bf16* raw, bf16* with_pos,
                                               const bf16* base,
                                               const long long* offs,
                                               const int* cells,
                                               const bf16* pos, int r0,
                                               int pl) {
  constexpr int NC = C / 8, LC = C + 8;
  for (int e = pl; e < 16 * NC; e += 64) {
    const int r = r0 + e / NC, ch = e % NC;
    const long long o = offs[r];
    const uint4 x = o >= 0
                        ? *reinterpret_cast<const uint4*>(base + o + ch * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
    if (raw) *reinterpret_cast<uint4*>(raw + r * LC + ch * 8) = x;
    if (with_pos)
      *reinterpret_cast<uint4*>(with_pos + r * LC + ch * 8) = add_pos(
          x, __ldg(reinterpret_cast<const uint4*>(pos + cells[r] * C +
                                                  ch * 8)));
  }
}

constexpr int kXSlots = 6;  // row-sum exchanges of a warp pair a tile

// The sums over a pair's two column halves of NV per-row partials, rows g
// (a) and g + 8 (b), through exchange slot `slot`: half 0's plus half 1's,
// so both warps hold the same bits. The pair meets once.
template <int NV>
__device__ __forceinline__ void pair_rowsum(float (&a)[NV], float (&b)[NV],
                                            float* xch, int rg, int half,
                                            int slot, int g, int lane) {
  static_assert(NV <= 2, "two partials a row at most");
  float* const base = xch + (rg * kXSlots + slot) * 2 * 2 * 16;
  if ((lane & 3) == 0) {
    float* const mine = base + half * 2 * 16;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      mine[v * 16 + g] = a[v];
      mine[v * 16 + g + 8] = b[v];
    }
  }
  pair_sync(rg);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    a[v] = base[v * 16 + g] + base[2 * 16 + v * 16 + g];
    b[v] = base[v * 16 + g + 8] + base[2 * 16 + v * 16 + g + 8];
  }
}

// LayerNorm's row statistics (eps 1e-5) over a row whose C columns are
// split between a warp pair, mean and 1 / std of rows g (a) and g + 8 (b):
// the thread's NT column tiles here, the other half's through the
// exchange (slots `slot` and `slot` + 1).
template <int NT, int C>
__device__ __forceinline__ void ln_stats_pair(const float (&v)[NT][4],
                                              float& ma, float& mb, float& ra,
                                              float& rb, float* xch, int rg,
                                              int half, int slot, int g,
                                              int lane) {
  constexpr float inv = 1.f / C;
  float sa[1] = {0.f}, sb[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sa[0] += v[j][0] + v[j][1];
    sb[0] += v[j][2] + v[j][3];
  }
  sa[0] = quad_sum(sa[0]);
  sb[0] = quad_sum(sb[0]);
  pair_rowsum<1>(sa, sb, xch, rg, half, slot, g, lane);
  ma = sa[0] * inv;
  mb = sb[0] * inv;
  float qa[1] = {0.f}, qb[1] = {0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float da = v[j][e] - ma, db = v[j][2 + e] - mb;
      qa[0] += da * da;
      qb[0] += db * db;
    }
  }
  qa[0] = quad_sum(qa[0]);
  qb[0] = quad_sum(qb[0]);
  pair_rowsum<1>(qa, qb, xch, rg, half, slot + 1, g, lane);
  ra = rsqrtf(qa[0] * inv + 1e-5f);
  rb = rsqrtf(qb[0] * inv + 1e-5f);
}

// The H / 2 heads of one column half (v: its C / 16 column tiles; bias
// and dst at the half's first column; its first head h0): the bias added,
// each head of width D normalised per row, out = bf16(v / |v| * mult) into
// `dst`, with each row's 1 / |v| of each head into rinv when it is given.
template <int C, int H>
__device__ __forceinline__ void heads_half(float (&v)[C / 16][4],
                                           const float* bias, bf16* dst,
                                           float* rinv, int r0, int h0, int g,
                                           int t2, float mult = 1.f) {
  constexpr int D = C / H, CPH = D / 8;
  add_bias_s(v, bias, t2);
#pragma unroll
  for (int h = 0; h < H / 2; ++h) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int u = 0; u < CPH; ++u) {
      const float* a = v[h * CPH + u];
      sa += a[0] * a[0] + a[1] * a[1];
      sb += a[2] * a[2] + a[3] * a[3];
    }
    const float ra = rsqrtf(quad_sum(sa) + 1e-24f);
    const float rb = rsqrtf(quad_sum(sb) + 1e-24f);
    if (rinv && t2 == 0) {
      rinv[(r0 + g) * H + h0 + h] = ra;
      rinv[(r0 + g + 8) * H + h0 + h] = rb;
    }
#pragma unroll
    for (int u = 0; u < CPH; ++u) {
      float* a = v[h * CPH + u];
      a[0] *= ra * mult;
      a[1] *= ra * mult;
      a[2] *= rb * mult;
      a[3] *= rb * mult;
    }
  }
  store_frag(dst, C + 8, v, g, t2);
}

// Shared memory of the backward: the weights, nine row buffers R0..R8 (their
// use phase by phase in the kernel), P and DS [64 x LP] for each column
// half, RQ and RK (1 / |q|, 1 / |k| per row and head, f32), each row
// group's column sums (and the second half's tau), the pairs' row-sum
// exchanges, the layer's bias and LayerNorm vectors (as Vec<C> lays out the
// sums), the RowMeta.
template <int C, int H>
constexpr int bwd_smem() {
  using N = Narrow<C>;
  return N::kWBytes + 9 * N::kBufC + 4 * N::kBufP + 2 * kRows * H * 4 +
         5 * (N::kVec + 1) * 4 + 4 * kXSlots * 2 * 2 * 16 * 4 +
         (int)sizeof(RowMeta);
}

// Built with -DTMAE_NARROW_PROFILE, thread 0 of each block (warp 0: row
// group 0, column half 0) adds the clock cycles of every phase of its
// tiles into tmae_narrow_cycles (read by tmae_narrow_profile); otherwise
// NARROW_PHASE does nothing.
#ifdef TMAE_NARROW_PROFILE
__device__ unsigned long long tmae_narrow_cycles[256][16];
#define NARROW_PHASE(k)                                         \
  do {                                                          \
    if (threadIdx.x == 0) {                                     \
      const long long now = clock64();                          \
      tmae_narrow_cycles[blockIdx.x % 256][k] += now - phase_t0; \
      phase_t0 = now;                                           \
    }                                                           \
  } while (0)
#else
#define NARROW_PHASE(k) \
  do {                  \
  } while (0)
#endif

// ---------------------------------------------------------------------------
// NARROW_FWD
// ---------------------------------------------------------------------------

// The 64 rows of a tile into a row buffer by cp.async (`t` of `nth`
// threads): x at rm.qoff (and kv at rm.koff in cross mode), zeros for a
// row of no window. One commit.
template <int C>
__device__ __forceinline__ void fetch_rows(bf16* xs, bf16* kr,
                                           const FwdParams& p,
                                           const RowMeta& rm, int t,
                                           int nth) {
  constexpr int NC = C / 8, LC = C + 8;
  for (int e = t; e < kRows * NC; e += nth) {
    const int r = e / NC, ch = e % NC;
    const long long qo = rm.qoff[r];
    cp_async16(xs + r * LC + ch * 8, p.x + (qo >= 0 ? qo + ch * 8 : 0),
               qo >= 0);
    if (p.cross) {
      const long long ko = rm.koff[r];
      cp_async16(kr + r * LC + ch * 8, p.kv + (ko >= 0 ? ko + ch * 8 : 0),
                 ko >= 0);
    }
  }
  cp_async_commit();
}

// A warp pair's 16 rows of `src` plus pos[cells[r]], in bf16, into `dst`
template <int C>
__device__ __forceinline__ void pos_rows_pair(bf16* dst, const bf16* src,
                                              const int* cells,
                                              const bf16* pos, int r0,
                                              int pl) {
  constexpr int NC = C / 8, LC = C + 8;
  for (int e = pl; e < 16 * NC; e += 64) {
    const int r = r0 + e / NC, ch = e % NC;
    *reinterpret_cast<uint4*>(dst + r * LC + ch * 8) = add_pos(
        *reinterpret_cast<const uint4*>(src + r * LC + ch * 8),
        __ldg(reinterpret_cast<const uint4*>(pos + cells[r] * C + ch * 8)));
  }
}

// Shared memory of the forward: the weights, XS [2] (the raw rows of this
// tile and of the next), KR [2] (cross mode: the raw key rows), A0 (x +
// pos; the attention output; the output tile), KP (cross: kv + pos), QN
// (normalised, scaled q; then bf16(h1)), KN, VB, UB (the FFN hidden [64 x
// F]), the vectors (as Vec<C> lays them out), the pairs' row-sum
// exchanges, the RowMeta of this tile and of the next.
template <int C>
constexpr int fwd_smem() {
  using N = Narrow<C>;
  return N::kWBytes + 9 * N::kBufC + N::kBufF + (N::kVec + 1) * 4 +
         4 * kXSlots * 2 * 2 * 16 * 4 + 2 * (int)sizeof(RowMeta);
}

template <Addr A, int T, int C, int H>
__global__ void __launch_bounds__(kFThreads, 1)
    narrow_fwd_kernel(const FwdParams p, const Mats mats) {
  using N = Narrow<C>;
  using V = Vec<C>;
  constexpr int WPT = T == 16 ? 4 : 1;
  constexpr int LC = N::LC, LF = N::LF, NC = N::NC;
  constexpr int HC = N::NC / 2, HF = N::NF / 2, HH = H / 2;
  static_assert((N::kVec + 1) % 2 == 0, "the exchanges stay 8-aligned");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const W = reinterpret_cast<bf16*>(smem);
  bf16* const XS0 = reinterpret_cast<bf16*>(smem + N::kWBytes);
  bf16* const KR0 = XS0 + 2 * kRows * LC;
  bf16* const A0 = KR0 + 2 * kRows * LC;
  bf16* const KP = A0 + kRows * LC;
  bf16* const QN = KP + kRows * LC;
  bf16* const KN = QN + kRows * LC;
  bf16* const VB = KN + kRows * LC;
  bf16* const UB = VB + kRows * LC;
  float* const VS = reinterpret_cast<float*>(UB + kRows * LF);
  float* const xch = VS + N::kVec + 1;
  RowMeta* const meta =
      reinterpret_cast<RowMeta*>(xch + 4 * kXSlots * 2 * 2 * 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a row group's two warps split every product's output columns: this
  // warp's half `half` of them, from column c0 (FFN width: f0), and the
  // heads h0 .. h0 + H / 2
  const int rg = warp & 3, half = warp >> 2;
  const int r0 = 16 * rg, g = lane >> 2, t2 = 2 * (lane & 3);
  const int pl = lane + 32 * half;  // the thread's place in the pair
  const int c0 = half * (C / 2), f0 = half * N::F / 2, h0 = half * HH;
#ifdef TMAE_NARROW_PROFILE
  long long phase_t0 = clock64();
#endif
  // The first tile is the block's own (the counter hands out the tiles
  // after the first gridDim.x). Warps 0 and 1 find its rows while the
  // other warps ask for the vectors and wq, wk, wv (group 1); then every
  // thread asks for its rows (group 2), and the other warps for wo, w1, w2
  // (group 3), which land while the tile's q, k, v and attention run.
  constexpr int kWeightThreads = kFThreads - 64;
  const WPtr<C> w(W);
  const int first = blockIdx.x;
  const int count = *p.count;
  const int ntiles = (count + WPT - 1) / WPT;
  const float scale = 1.f / fmaxf(p.tau[0], p.tau_min);
  const bool copier = warp >= 2;
  if (!copier) {
    if (tid == 0) meta[0].tile = first;
    if (first < ntiles)
      tile_rows<A, T, C>(p, first, count, tid, meta[0].qoff, meta[0].koff,
                         meta[0].qcell, meta[0].kcell, meta[0].qm,
                         meta[0].km);
  } else {
    load_vectors_async<C, kWeightThreads>(p, VS, tid - 64);
    copy_weights_async<C>(mats, W, tid - 64, kWeightThreads, 0, 3);
    cp_async_commit();
  }
  __syncthreads();
  if (first < ntiles) fetch_rows<C>(XS0, KR0, p, meta[0], tid, kFThreads);
  if (copier) {
    copy_weights_async<C>(mats, W, tid - 64, kWeightThreads, 3, 6);
    cp_async_commit();
  }
  bool weights_in = false;  // group 3 has landed
  NARROW_PHASE(1);
  for (int b = 0;; b ^= 1) {
    const RowMeta& rm = meta[b];
    const int tile = rm.tile;
    if (tile >= ntiles) break;
    bf16* const XS = XS0 + b * kRows * LC;
    bf16* const KR = KR0 + b * kRows * LC;
    // the next tile's index, claimed early, used once this one's keys and
    // values are in
    int next = 0;
    if (tid == 0) next = gridDim.x + atomicAdd(p.counter, 1);
    // this tile's rows (the first tile: with the vectors, wq, wk, wv)
    if (copier && !weights_in)
      cp_async_wait_but_last();
    else
      cp_async_wait();
    __syncthreads();  // ... for every thread; the last tile is done
    NARROW_PHASE(2);

    // 1. x + pos (kv + pos); this half's heads of q (scaled) and k,
    // normalised, and its columns of v
    pos_rows_pair<C>(A0, XS, rm.qcell, p.pos, r0, pl);
    if (p.cross) pos_rows_pair<C>(KP, KR, rm.kcell, p.pos, r0, pl);
    pair_sync(rg);
    {
      float a[HC][4];
      zero(a);
      mm_wt<HC, C>(a, A0 + r0 * LC, LC, w.q + c0 * LC, LC, lane);
      heads_half<C, H>(a, VS + V::bq + c0, QN + r0 * LC + c0, nullptr, r0,
                       h0, g, t2, scale);
      zero(a);
      mm_wt<HC, C>(a, (p.cross ? KP : A0) + r0 * LC, LC, w.k + c0 * LC, LC,
                   lane);
      heads_half<C, H>(a, VS + V::bk + c0, KN + r0 * LC + c0, nullptr, r0,
                       h0, g, t2);
      zero(a);
      mm_wt<HC, C>(a, (p.cross ? KR : XS) + r0 * LC, LC, w.v + c0 * LC, LC,
                   lane);
      add_bias_s(a, VS + V::bv + c0, t2);
      store_frag(VB + r0 * LC + c0, LC, a, g, t2);
    }
    NARROW_PHASE(3);
    // 2. the next tile: warps 0 and 1 find its rows and start their
    // copies into the other buffers, which land while this tile runs
    if (warp < 2) {
      RowMeta& nm = meta[b ^ 1];
      if (tid == 0) nm.tile = next;
      asm volatile("bar.sync 9, 64;" ::: "memory");
      if (nm.tile < ntiles) {
        tile_rows<A, T, C>(p, nm.tile, count, tid, nm.qoff, nm.koff,
                           nm.qcell, nm.kcell, nm.qm, nm.km);
        asm volatile("bar.sync 9, 64;" ::: "memory");
        fetch_rows<C>(XS0 + (b ^ 1) * kRows * LC, KR0 + (b ^ 1) * kRows * LC,
                      p, nm, tid, 64);
      }
    }
    NARROW_PHASE(9);
    if (copier && !weights_in) cp_async_wait();  // wo, w1, w2
    weights_in = true;
    __syncthreads();  // every warp's keys and values (first: the weights)

    // 3. attention of this half's heads
    attention_fwd<T, C, H>(QN, KN, VB, A0, rm.km, 1.f, r0, lane, h0, HH);
    pair_sync(rg);
    NARROW_PHASE(4);

    // 4. output projection, the residual on occupied query cells, LN1; h1
    // stays in registers (f32) to the end
    const bool oa = rm.qm[r0 + g] > 0.f, ob = rm.qm[r0 + g + 8] > 0.f;
    float h[HC][4];
    zero(h);
    mm_wt<HC, C>(h, A0 + r0 * LC, LC, w.o + c0 * LC, LC, lane);
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int c = c0 + 8 * j + t2;
      const float2 bo = lds2(VS + V::bo + c);
      const float2 xa = ld2(XS + (r0 + g) * LC + c);
      const float2 xb = ld2(XS + (r0 + g + 8) * LC + c);
      h[j][0] = xa.x + (oa ? h[j][0] + bo.x : 0.f);
      h[j][1] = xa.y + (oa ? h[j][1] + bo.y : 0.f);
      h[j][2] = xb.x + (ob ? h[j][2] + bo.x : 0.f);
      h[j][3] = xb.y + (ob ? h[j][3] + bo.y : 0.f);
    }
    {
      float ma, mb, ra, rb;
      ln_stats_pair<HC, C>(h, ma, mb, ra, rb, xch, rg, half, 0, g, lane);
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const int c = c0 + 8 * j + t2;
        const float2 sc = lds2(VS + V::ln1s + c), bi = lds2(VS + V::ln1b + c);
        h[j][0] = oa ? (h[j][0] - ma) * ra * sc.x + bi.x : 0.f;
        h[j][1] = oa ? (h[j][1] - ma) * ra * sc.y + bi.y : 0.f;
        h[j][2] = ob ? (h[j][2] - mb) * rb * sc.x + bi.x : 0.f;
        h[j][3] = ob ? (h[j][3] - mb) * rb * sc.y + bi.y : 0.f;
      }
    }
    store_frag(QN + r0 * LC + c0, LC, h, g, t2);
    pair_sync(rg);
    NARROW_PHASE(5);

    // 5. FFN first product and GELU, this half's F / 2 columns
    {
      float z[HF][4];
      zero(z);
      mm_wt<HF, C>(z, QN + r0 * LC, LC, w.w1 + f0 * LC, LC, lane);
      add_bias_s(z, VS + V::b1 + f0, t2);
#pragma unroll
      for (int j = 0; j < HF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) z[j][e] = gelu(z[j][e]);
      store_frag(UB + r0 * LF + f0, LF, z, g, t2);
    }
    pair_sync(rg);
    NARROW_PHASE(6);

    // 6. FFN second product onto h1 + b2, LN2
    add_bias_s(h, VS + V::b2 + c0, t2);
    mm_wt<HC, N::F>(h, UB + r0 * LF, LF, w.w2 + c0 * LF, LF, lane);
    {
      float ma, mb, ra, rb;
      ln_stats_pair<HC, C>(h, ma, mb, ra, rb, xch, rg, half, 2, g, lane);
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const int c = c0 + 8 * j + t2;
        const float2 sc = lds2(VS + V::ln2s + c), bi = lds2(VS + V::ln2b + c);
        h[j][0] = (h[j][0] - ma) * ra * sc.x + bi.x;
        h[j][1] = (h[j][1] - ma) * ra * sc.y + bi.y;
        h[j][2] = (h[j][2] - mb) * rb * sc.x + bi.x;
        h[j][3] = (h[j][3] - mb) * rb * sc.y + bi.y;
      }
    }
    NARROW_PHASE(7);
    // 7. the output rows into A0: y on occupied cells and 0 elsewhere (T =
    // 64), or x + bf16(y - x) (S = 16, 48); then the pair's rows out
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int c = c0 + 8 * j + t2;
      float v[4] = {h[j][0], h[j][1], h[j][2], h[j][3]};
      if constexpr (T == kCells) {
        if (!oa) v[0] = v[1] = 0.f;
        if (!ob) v[2] = v[3] = 0.f;
      } else {
        const float2 xa = ld2(XS + (r0 + g) * LC + c);
        const float2 xb = ld2(XS + (r0 + g + 8) * LC + c);
        const float xs[4] = {xa.x, xa.y, xb.x, xb.y};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = xs[e] + __bfloat162float(__float2bfloat16(v[e] - xs[e]));
      }
      st2(A0 + (r0 + g) * LC + c, v[0], v[1]);
      st2(A0 + (r0 + g + 8) * LC + c, v[2], v[3]);
    }
    pair_sync(rg);
    for (int e = pl; e < 16 * NC; e += 64) {
      const int r = r0 + e / NC, ch = e % NC;
      if (rm.qoff[r] >= 0 && (T == kCells || rm.qm[r] > 0.f))
        *reinterpret_cast<uint4*>(p.out + rm.qoff[r] + ch * 8) =
            *reinterpret_cast<const uint4*>(A0 + r * LC + ch * 8);
    }
    NARROW_PHASE(8);
  }
  cp_async_wait();  // a block without a tile leaves no copy in flight
}

// [pre-pass, compact, layer] of one mode; a cudaError_t.
template <Mode M, int T, int C, int H>
int launch_fwd(const FwdParams& p, const Mats& mats, cudaStream_t s) {
  constexpr Addr A = M == kGridOut       ? kGridCells
                     : M == kPlanInPlace ? kPlanCells
                                         : kWindowRows;
  constexpr int WPT = T == 16 ? 4 : 1;
  if (p.nwin == 0) return 0;
  const int warps = (p.nwin + 7) / 8;  // one warp per window
  if constexpr (M == kGridOut)
    grid_prepass_kernel<C><<<warps, 256, 0, s>>>(p);
  else if constexpr (M == kSelOut)
    sel_prepass_kernel<T, C><<<warps, 256, 0, s>>>(p);
  else if constexpr (M == kPlanInPlace)
    plan_prepass_kernel<T, C><<<warps, 256, 0, s>>>(p);
  else
    mask_prepass_kernel<T, C, M == kFullOut || M == kFullInPlace>
        <<<warps, 256, 0, s>>>(p);
  int e = tmae_last_error();
  if (e) return e;
  compact_kernel<<<1, 1024, 0, s>>>(p.flags, p.list, p.count, p.counter,
                                   p.nwin);
  if ((e = tmae_last_error())) return e;
  static unsigned long long set_on = 0;  // for each instance
  if ((e = smem_limit_once((const void*)narrow_fwd_kernel<A, T, C, H>,
                           fwd_smem<C>(), set_on)))
    return e;
  const int blocks = std::min(sm_count(), (p.nwin + WPT - 1) / WPT);
  narrow_fwd_kernel<A, T, C, H>
      <<<blocks, kFThreads, fwd_smem<C>(), s>>>(p, mats);
  return tmae_last_error();
}

template <int C, int H>
int fwd_mode(int mode, int T, const FwdParams& p, const Mats& m,
             cudaStream_t s) {
  switch (mode) {
    case kSelOut:
      return T == 16 ? launch_fwd<kSelOut, 16, C, H>(p, m, s)
                     : launch_fwd<kSelOut, 48, C, H>(p, m, s);
    case kSelInPlace:
      return T == 16 ? launch_fwd<kSelInPlace, 16, C, H>(p, m, s)
                     : launch_fwd<kSelInPlace, 48, C, H>(p, m, s);
    case kFullOut:
      return launch_fwd<kFullOut, kCells, C, H>(p, m, s);
    case kFullInPlace:
      return launch_fwd<kFullInPlace, kCells, C, H>(p, m, s);
    case kGridOut:
      return launch_fwd<kGridOut, kCells, C, H>(p, m, s);
    case kPlanInPlace:
      if (T == 16) return launch_fwd<kPlanInPlace, 16, C, H>(p, m, s);
      if (T == 48) return launch_fwd<kPlanInPlace, 48, C, H>(p, m, s);
      return launch_fwd<kPlanInPlace, kCells, C, H>(p, m, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int T, int C, int H>
__global__ void __launch_bounds__(kBThreads, 1)
    narrow_bwd_kernel(const BwdParams p, const Mats mats) {
  using N = Narrow<C>;
  using V = Vec<C>;
  constexpr int WPT = T == 16 ? 4 : 1;
  constexpr int LC = N::LC, LF = N::LF, LP = N::LP;
  constexpr int HC = N::NC / 2, HF = N::NF / 2;  // column tiles of a half
  constexpr int D = C / H, NK = T == 16 ? 16 : T, HH = H / 2;
  constexpr int NS = N::kVec + 1;  // a row group's sums, then half 1's tau
  static_assert(NS % 2 == 0, "the RowMeta after the vectors is 8-aligned");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* const W = reinterpret_cast<bf16*>(smem);
  bf16* const R0 = reinterpret_cast<bf16*>(smem + N::kWBytes);
  bf16* const R1 = R0 + kRows * LC;
  bf16* const R2 = R1 + kRows * LC;
  bf16* const R3 = R2 + kRows * LC;
  bf16* const QH = R3 + kRows * LC;  // normalised q, k (unscaled), v
  bf16* const KH = QH + kRows * LC;
  bf16* const VB = KH + kRows * LC;
  bf16* const R7 = VB + kRows * LC;
  bf16* const DV = R7 + kRows * LC;
  bf16* const PB = DV + kRows * LC;  // [2 halves][64 x LP]
  bf16* const DS = PB + 2 * kRows * LP;
  float* const RQ = reinterpret_cast<float*>(DS + 2 * kRows * LP);
  float* const RK = RQ + kRows * H;
  float* const sums_all = RK + kRows * H;
  float* const xch = sums_all + 4 * NS;
  float* const VS = xch + 4 * kXSlots * 2 * 2 * 16;
  RowMeta& rm = *reinterpret_cast<RowMeta*>(VS + NS);  // NS: even
  // phase by phase: R0 x, then dz2, then dr1 (f32, with R1: a row group's
  // rows g in its rows of R0, rows g + 8 in its rows of R1); R1 x + pos,
  // then bf16(h1); R2 kv + pos, then (with R3) the GELU output, then dz1,
  // then R2 datt; R3 kv, then dk; R7 the attention output, then do, then dq
  bf16* const XS = R0;
  bf16* const XP = R1;
  bf16* const KP = R2;
  bf16* const KR = R3;
  bf16* const HB = R1;
  bf16* const UB = R2;
  bf16* const DZ2 = R0;
  bf16* const DZ1 = R2;
  bf16* const DA = R2;
  bf16* const DK = R3;
  bf16* const AT = R7;
  bf16* const DO = R7;
  bf16* const DQ = R7;

  const FwdParams& f = p.f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a row group's two warps split every product's output columns: this
  // warp's half `half` of them, from column c0 (FFN width: f0), and the
  // heads h0 .. h0 + H / 2
  const int rg = warp & 3, half = warp >> 2;
  const int r0 = 16 * rg, g = lane >> 2, t2 = 2 * (lane & 3);
  const int pl = lane + 32 * half;
  const int c0 = half * (C / 2), f0 = half * N::F / 2, h0 = half * HH;
  float* const sums = sums_all + rg * NS;
#ifdef TMAE_NARROW_PROFILE
  long long phase_t0 = clock64();
#endif
  // the weights and vectors land while the first tile's rows load (bf16
  // matrices: the wrapper hands kernel_params' tensors)
  load_vectors_async<C, kBThreads>(f, VS, tid);
  load_weights_async<C, kBThreads>(mats, W, tid);
  bool weights_in = false;
  const WPtr<C> w(W);
  const int count = *f.count;
  const int ntiles = (count + WPT - 1) / WPT;
  const float tau = f.tau[0];
  const float scale = 1.f / fmaxf(tau, f.tau_min);
  NARROW_PHASE(0);
  for (;;) {
    __syncthreads();
    if (tid == 0) rm.tile = atomicAdd(f.counter, 1);
    __syncthreads();
    const int tile = rm.tile;
    if (tile >= ntiles) break;
    if (tid < kRows)
      tile_rows<kWindowRows, T, C>(f, tile, count, tid, rm.qoff, rm.koff,
                                   rm.qcell, rm.kcell, rm.qm, rm.km);
    for (int i = tid; i < 4 * NS; i += kBThreads) sums_all[i] = 0.f;
    __syncthreads();
    const long long wrow = (long long)tile * kRows + r0;  // workspace row
    const bool oa = rm.qm[r0 + g] > 0.f, ob = rm.qm[r0 + g + 8] > 0.f;
    // the cotangent of this half's columns, long before LN2's backward
    float gy[HC][4];
    load_g(gy, p.g, rm.qoff, r0, g, c0 + t2);
    NARROW_PHASE(1);

    // 1. the rows; the products' inputs to the workspace
    load_rows_pair<C>(XS, XP, f.x, rm.qoff, rm.qcell, f.pos, r0, pl);
    if (f.cross)
      load_rows_pair<C>(KR, KP, f.kv, rm.koff, rm.kcell, f.pos, r0, pl);
    if (!weights_in) {
      cp_async_wait();
      __syncthreads();
      weights_in = true;
    }
    pair_sync(rg);
    put_rows_pair<C>(p.oXP, wrow, XP + r0 * LC, LC, pl);
    if (f.cross) put_rows_pair<C>(p.oKP, wrow, KP + r0 * LC, LC, pl);
    put_rows_pair<C>(p.oKR, wrow, (f.cross ? KR : XS) + r0 * LC, LC, pl);
    NARROW_PHASE(2);

    // 2. this half's heads of q and k normalised (unscaled), its columns
    // of v
    {
      float a[HC][4];
      zero(a);
      mm_wt<HC, C>(a, XP + r0 * LC, LC, w.q + c0 * LC, LC, lane);
      heads_half<C, H>(a, VS + V::bq + c0, QH + r0 * LC + c0, RQ, r0, h0, g,
                       t2);
      zero(a);
      mm_wt<HC, C>(a, (f.cross ? KP : XP) + r0 * LC, LC, w.k + c0 * LC, LC,
                   lane);
      heads_half<C, H>(a, VS + V::bk + c0, KH + r0 * LC + c0, RK, r0, h0, g,
                       t2);
      zero(a);
      mm_wt<HC, C>(a, (f.cross ? KR : XS) + r0 * LC, LC, w.v + c0 * LC, LC,
                   lane);
      add_bias_s(a, VS + V::bv + c0, t2);
      store_frag(VB + r0 * LC + c0, LC, a, g, t2);
    }
    __syncthreads();
    NARROW_PHASE(3);

    // 3. attention (s = scale q.k) of this half's heads
    attention_fwd<T, C, H>(QH, KH, VB, AT, rm.km, scale, r0, lane, h0, HH);
    pair_sync(rg);
    put_rows_pair<C>(p.oA, wrow, AT + r0 * LC, LC, pl);
    NARROW_PHASE(4);

    // 4. output projection, residual, LN1: xhat1 and 1/std kept
    float xh1[HC][4], hh[HC][4];
    float rs1a, rs1b;
    zero(xh1);
    mm_wt<HC, C>(xh1, AT + r0 * LC, LC, w.o + c0 * LC, LC, lane);
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int c = c0 + 8 * j + t2;
      const float2 b = lds2(VS + V::bo + c);
      const float2 xa = ld2(XS + (r0 + g) * LC + c);
      const float2 xb = ld2(XS + (r0 + g + 8) * LC + c);
      xh1[j][0] = xa.x + (oa ? xh1[j][0] + b.x : 0.f);
      xh1[j][1] = xa.y + (oa ? xh1[j][1] + b.y : 0.f);
      xh1[j][2] = xb.x + (ob ? xh1[j][2] + b.x : 0.f);
      xh1[j][3] = xb.y + (ob ? xh1[j][3] + b.y : 0.f);
    }
    {
      float ma, mb;
      ln_stats_pair<HC, C>(xh1, ma, mb, rs1a, rs1b, xch, rg, half, 0, g,
                           lane);
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const int c = c0 + 8 * j + t2;
        const float2 sc = lds2(VS + V::ln1s + c), bi = lds2(VS + V::ln1b + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          xh1[j][e] = (xh1[j][e] - ma) * rs1a;
          xh1[j][2 + e] = (xh1[j][2 + e] - mb) * rs1b;
        }
        hh[j][0] = oa ? xh1[j][0] * sc.x + bi.x : 0.f;
        hh[j][1] = oa ? xh1[j][1] * sc.y + bi.y : 0.f;
        hh[j][2] = ob ? xh1[j][2] * sc.x + bi.x : 0.f;
        hh[j][3] = ob ? xh1[j][3] * sc.y + bi.y : 0.f;
      }
    }
    store_frag(HB + r0 * LC + c0, LC, hh, g, t2);
    pair_sync(rg);
    put_rows_pair<C>(p.oHB, wrow, HB + r0 * LC, LC, pl);
    NARROW_PHASE(5);

    // 5. FFN first product and GELU, this half's F / 2 columns; GELU's
    // derivative kept for the FFN's backward
    float gz[HF][4];
    {
      float z[HF][4];
      zero(z);
      mm_wt<HF, C>(z, HB + r0 * LC, LC, w.w1 + f0 * LC, LC, lane);
      add_bias_s(z, VS + V::b1 + f0, t2);
#pragma unroll
      for (int j = 0; j < HF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gelu_and_grad(z[j][e], gz[j][e]);
      store_frag(UB + r0 * LF + f0, LF, z, g, t2);
    }
    pair_sync(rg);
    put_rows_pair<N::F>(p.oUB, wrow, UB + r0 * LF, LF, pl);
    NARROW_PHASE(6);

    // 6. FFN second product, LN2, and LN2's backward: dr2 = dz2 = dh
    {
      float r2[HC][4];
      zero(r2);
      mm_wt<HC, N::F>(r2, UB + r0 * LF, LF, w.w2 + c0 * LF, LF, lane);
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const float2 b = lds2(VS + V::b2 + c0 + 8 * j + t2);
        r2[j][0] += hh[j][0] + b.x;
        r2[j][1] += hh[j][1] + b.y;
        r2[j][2] += hh[j][2] + b.x;
        r2[j][3] += hh[j][3] + b.y;
      }
      float ma, mb, ra, rb;
      ln_stats_pair<HC, C>(r2, ma, mb, ra, rb, xch, rg, half, 2, g, lane);
      float da[2] = {0.f, 0.f}, db[2] = {0.f, 0.f};  // sum dxhat, dxhat xhat
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const float2 sc = lds2(VS + V::ln2s + c0 + 8 * j + t2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!oa) gy[j][e] = 0.f;
          if (!ob) gy[j][2 + e] = 0.f;
          r2[j][e] = (r2[j][e] - ma) * ra;  // xhat2
          r2[j][2 + e] = (r2[j][2 + e] - mb) * rb;
        }
        // sums: ln2s += gy xhat2, ln2b += gy
        float prod[1][4] = {{gy[j][0] * r2[j][0], gy[j][1] * r2[j][1],
                             gy[j][2] * r2[j][2], gy[j][3] * r2[j][3]}};
        float gj[1][4] = {{gy[j][0], gy[j][1], gy[j][2], gy[j][3]}};
        col_sums<1>(sums + V::ln2s + c0 + 8 * j, prod, lane);
        col_sums<1>(sums + V::ln2b + c0 + 8 * j, gj, lane);
        // dxhat = gy * scale, kept in gy
        gy[j][0] *= sc.x;
        gy[j][1] *= sc.y;
        gy[j][2] *= sc.x;
        gy[j][3] *= sc.y;
        da[0] += gy[j][0] + gy[j][1];
        db[0] += gy[j][2] + gy[j][3];
        da[1] += gy[j][0] * r2[j][0] + gy[j][1] * r2[j][1];
        db[1] += gy[j][2] * r2[j][2] + gy[j][3] * r2[j][3];
      }
      constexpr float inv = 1.f / C;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        da[v] = quad_sum(da[v]);
        db[v] = quad_sum(db[v]);
      }
      pair_rowsum<2>(da, db, xch, rg, half, 4, g, lane);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        da[v] *= inv;
        db[v] *= inv;
      }
#pragma unroll
      for (int j = 0; j < HC; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          hh[j][e] = ra * (gy[j][e] - da[0] - r2[j][e] * da[1]);
          hh[j][2 + e] = rb * (gy[j][2 + e] - db[0] - r2[j][2 + e] * db[1]);
        }
      }
      // hh is now dr2: dz2, and the gradient of h1 through the residual
      col_sums<HC>(sums + V::b2 + c0, hh, lane);
      store_frag(DZ2 + r0 * LC + c0, LC, hh, g, t2);
    }
    pair_sync(rg);
    put_rows_pair<C>(p.oDZ2, wrow, DZ2 + r0 * LC, LC, pl);
    NARROW_PHASE(7);

    // 7. dz1 = (dz2 W2) gelu'(z1) on this half's F / 2 columns
    {
      float du[HF][4];
      zero(du);
      mm_m<HF, C>(du, DZ2 + r0 * LC, LC, w.w2 + f0, LF, lane);
#pragma unroll
      for (int j = 0; j < HF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) du[j][e] *= gz[j][e];
      col_sums<HF>(sums + V::b1 + f0, du, lane);
      store_frag(DZ1 + r0 * LF + f0, LF, du, g, t2);
    }
    // both halves are also past their reads of dz2 (R0) and h1 (R1): dr1
    // may take their place
    pair_sync(rg);
    put_rows_pair<N::F>(p.oDZ1, wrow, DZ1 + r0 * LF, LF, pl);
    NARROW_PHASE(8);

    // 8. dh1 += dz1 W1; 9. LN1's backward, masked by the query cells
    mm_m<HC, N::F>(hh, DZ1 + r0 * LF, LF, w.w1 + c0, LC, lane);
    {
      float da[2] = {0.f, 0.f}, db[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const float2 sc = lds2(VS + V::ln1s + c0 + 8 * j + t2);
        if (!oa) hh[j][0] = hh[j][1] = 0.f;
        if (!ob) hh[j][2] = hh[j][3] = 0.f;
        float prod[1][4] = {{hh[j][0] * xh1[j][0], hh[j][1] * xh1[j][1],
                             hh[j][2] * xh1[j][2], hh[j][3] * xh1[j][3]}};
        float hj[1][4] = {{hh[j][0], hh[j][1], hh[j][2], hh[j][3]}};
        col_sums<1>(sums + V::ln1s + c0 + 8 * j, prod, lane);
        col_sums<1>(sums + V::ln1b + c0 + 8 * j, hj, lane);
        hh[j][0] *= sc.x;
        hh[j][1] *= sc.y;
        hh[j][2] *= sc.x;
        hh[j][3] *= sc.y;
        da[0] += hh[j][0] + hh[j][1];
        db[0] += hh[j][2] + hh[j][3];
        da[1] += hh[j][0] * xh1[j][0] + hh[j][1] * xh1[j][1];
        db[1] += hh[j][2] * xh1[j][2] + hh[j][3] * xh1[j][3];
      }
      constexpr float inv = 1.f / C;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        da[v] = quad_sum(da[v]);
        db[v] = quad_sum(db[v]);
      }
      pair_rowsum<2>(da, db, xch, rg, half, 5, g, lane);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        da[v] *= inv;
        db[v] *= inv;
      }
#pragma unroll
      for (int j = 0; j < HC; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          hh[j][e] = rs1a * (hh[j][e] - da[0] - xh1[j][e] * da[1]);
          hh[j][2 + e] = rs1b * (hh[j][2 + e] - db[0] - xh1[j][2 + e] * db[1]);
        }
      }
    }
    // hh is dr1: dx through the residual; do = dr1 on occupied cells
    float* const dr1a = reinterpret_cast<float*>(R0 + r0 * LC) + g * C;
    float* const dr1b = reinterpret_cast<float*>(R1 + r0 * LC) + g * C;
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int c = c0 + 8 * j + t2;
      *reinterpret_cast<float2*>(dr1a + c) = make_float2(hh[j][0], hh[j][1]);
      *reinterpret_cast<float2*>(dr1b + c) = make_float2(hh[j][2], hh[j][3]);
      if (!oa) hh[j][0] = hh[j][1] = 0.f;
      if (!ob) hh[j][2] = hh[j][3] = 0.f;
    }
    col_sums<HC>(sums + V::bo + c0, hh, lane);
    store_frag(DO + r0 * LC + c0, LC, hh, g, t2);
    pair_sync(rg);
    put_rows_pair<C>(p.oDO, wrow, DO + r0 * LC, LC, pl);
    NARROW_PHASE(9);

    // 10. datt = do Wo (into R2: every warp is past its dz1 reads)
    zero(hh);
    mm_m<HC, C>(hh, DO + r0 * LC, LC, w.o + c0, LC, lane);
    __syncthreads();
    store_frag(DA + r0 * LC + c0, LC, hh, g, t2);
    __syncthreads();
    NARROW_PHASE(10);

    // 11. attention backward: the two halves' heads side by side, one
    // head of each a round, each half with its own P and DS
    {
      const int key0 = T == 16 ? r0 : 0;
      bool hk = false;
      for (int k = lane; k < NK; k += 32) hk |= rm.km[key0 + k] > 0.f;
      hk = __any_sync(0xffffffffu, hk);
      // this warp's key rows r0.. are keys of its window (not at T = 48's
      // padding rows), seen by the queries q0 .. q0 + NQ
      const bool keys = r0 < (T == 16 ? kRows : T);
      const int q0 = T == 16 ? r0 : 0;
      constexpr int NQ = T == 16 ? 16 : T;
      bf16* const PBh = PB + half * kRows * LP;
      bf16* const DSh = DS + half * kRows * LP;
      float tau_part = 0.f;
#pragma unroll 1
      for (int hs = 0; hs < HH; ++hs) {
        const int h = h0 + hs, hc = h * D;
        {
          float pr[NK / 8][4], dp[NK / 8][4];
          row_dots<NK, D>(pr, QH + r0 * LC + hc, KH + key0 * LC + hc, LC,
                          lane);
#pragma unroll
          for (int n = 0; n < NK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pr[n][e] *= scale;
          softmax_rows<NK>(pr, rm.km + key0, hk, t2);
          row_dots<NK, D>(dp, DA + r0 * LC + hc, VB + key0 * LC + hc, LC,
                          lane);
          float sa = 0.f, sb = 0.f;
#pragma unroll
          for (int n = 0; n < NK / 8; ++n) {
            sa += pr[n][0] * dp[n][0] + pr[n][1] * dp[n][1];
            sb += pr[n][2] * dp[n][2] + pr[n][3] * dp[n][3];
          }
          sa = quad_sum(sa);
          sb = quad_sum(sb);
#pragma unroll
          for (int n = 0; n < NK / 8; ++n) {
            dp[n][0] = pr[n][0] * (dp[n][0] - sa);
            dp[n][1] = pr[n][1] * (dp[n][1] - sa);
            dp[n][2] = pr[n][2] * (dp[n][2] - sb);
            dp[n][3] = pr[n][3] * (dp[n][3] - sb);
            const int c = key0 + 8 * n + t2;
            st2(PBh + (r0 + g) * LP + c, pr[n][0], pr[n][1]);
            st2(PBh + (r0 + g + 8) * LP + c, pr[n][2], pr[n][3]);
            st2(DSh + (r0 + g) * LP + c, dp[n][0], dp[n][1]);
            st2(DSh + (r0 + g + 8) * LP + c, dp[n][2], dp[n][3]);
          }
          // dq: dqhat = scale ds khat, then through the normalisation
          float dq[D / 8][4];
          zero(dq);
          p_times<NK, D>(dq, dp, KH + key0 * LC + hc, LC, lane);
          float pa = 0.f, pb = 0.f;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const int c = hc + 8 * n + t2;
            const float2 qa = ld2(QH + (r0 + g) * LC + c);
            const float2 qb = ld2(QH + (r0 + g + 8) * LC + c);
#pragma unroll
            for (int e = 0; e < 4; ++e) dq[n][e] *= scale;
            pa += qa.x * dq[n][0] + qa.y * dq[n][1];
            pb += qb.x * dq[n][2] + qb.y * dq[n][3];
          }
          tau_part += pa + pb;
          pa = quad_sum(pa);
          pb = quad_sum(pb);
          const float rqa = RQ[(r0 + g) * H + h];
          const float rqb = RQ[(r0 + g + 8) * H + h];
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const int c = hc + 8 * n + t2;
            const float2 qa = ld2(QH + (r0 + g) * LC + c);
            const float2 qb = ld2(QH + (r0 + g + 8) * LC + c);
            dq[n][0] = rqa * (dq[n][0] - pa * qa.x);
            dq[n][1] = rqa * (dq[n][1] - pa * qa.y);
            dq[n][2] = rqb * (dq[n][2] - pb * qb.x);
            dq[n][3] = rqb * (dq[n][3] - pb * qb.y);
          }
          col_sums<D / 8>(sums + V::bq + hc, dq, lane);
          store_frag(DQ + r0 * LC + hc, LC, dq, g, t2);
        }
        __syncthreads();  // every query row's p and ds of the round's heads
        {
          float dv[D / 8][4], dk[D / 8][4];
          zero(dv);
          zero(dk);
          if (keys) {
            mm_tm<D / 8, NQ>(dv, PBh + q0 * LP + r0, LP, DA + q0 * LC + hc,
                             LC, lane);
            mm_tm<D / 8, NQ>(dk, DSh + q0 * LP + r0, LP, QH + q0 * LC + hc,
                             LC, lane);
            float pa = 0.f, pb = 0.f;
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
              const int c = hc + 8 * n + t2;
              const float2 ka = ld2(KH + (r0 + g) * LC + c);
              const float2 kb = ld2(KH + (r0 + g + 8) * LC + c);
#pragma unroll
              for (int e = 0; e < 4; ++e) dk[n][e] *= scale;
              pa += ka.x * dk[n][0] + ka.y * dk[n][1];
              pb += kb.x * dk[n][2] + kb.y * dk[n][3];
            }
            pa = quad_sum(pa);
            pb = quad_sum(pb);
            const float rka = RK[(r0 + g) * H + h];
            const float rkb = RK[(r0 + g + 8) * H + h];
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
              const int c = hc + 8 * n + t2;
              const float2 ka = ld2(KH + (r0 + g) * LC + c);
              const float2 kb = ld2(KH + (r0 + g + 8) * LC + c);
              dk[n][0] = rka * (dk[n][0] - pa * ka.x);
              dk[n][1] = rka * (dk[n][1] - pa * ka.y);
              dk[n][2] = rkb * (dk[n][2] - pb * kb.x);
              dk[n][3] = rkb * (dk[n][3] - pb * kb.y);
            }
          }
          col_sums<D / 8>(sums + V::bv + hc, dv, lane);
          col_sums<D / 8>(sums + V::bk + hc, dk, lane);
          store_frag(DV + r0 * LC + hc, LC, dv, g, t2);
          store_frag(DK + r0 * LC + hc, LC, dk, g, t2);
        }
        __syncthreads();  // p and ds are rewritten by the next round
      }
      tau_part = warp_sum(tau_part);
      if (lane == 0) sums[V::tau + half] += tau_part;
    }
    put_rows_pair<C>(p.oDQ, wrow, DQ + r0 * LC, LC, pl);
    put_rows_pair<C>(p.oDK, wrow, DK + r0 * LC, LC, pl);
    put_rows_pair<C>(p.oDV, wrow, DV + r0 * LC, LC, pl);
    NARROW_PHASE(11);

    // 12. dx, dkv and dpos through the projections, this half's columns
    {
      float dxp[HC][4], dkp[HC][4], dvp[HC][4];
      zero(dxp);
      mm_m<HC, C>(dxp, DQ + r0 * LC, LC, w.q + c0, LC, lane);
      zero(dkp);
      mm_m<HC, C>(dkp, DK + r0 * LC, LC, w.k + c0, LC, lane);
      zero(dvp);
      mm_m<HC, C>(dvp, DV + r0 * LC, LC, w.v + c0, LC, lane);
      const float* const dr1a =
          reinterpret_cast<const float*>(R0 + r0 * LC) + g * C;
      const float* const dr1b =
          reinterpret_cast<const float*>(R1 + r0 * LC) + g * C;
      const long long qa = rm.qoff[r0 + g], qb = rm.qoff[r0 + g + 8];
      const long long ka = rm.koff[r0 + g], kb = rm.koff[r0 + g + 8];
      float* const pp = p.part_p == nullptr
                            ? nullptr
                            : p.part_p + ((long long)tile * kRows + r0 + g) * C;
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const int c = c0 + 8 * j + t2;
        const float2 ra = *reinterpret_cast<const float2*>(dr1a + c);
        const float2 rb = *reinterpret_cast<const float2*>(dr1b + c);
        const float res[4] = {ra.x, ra.y, rb.x, rb.y};
        float dx[4], dkv[4], dpos[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // x + pos feeds q (and k in self mode), kv + pos k, kv v; at T =
          // 64 a row's query and key cell are both cell r
          dpos[e] = dxp[j][e] + dkp[j][e];
          dkv[e] = dkp[j][e] + dvp[j][e];
          dx[e] = res[e] + dxp[j][e] + (f.cross ? 0.f : dkv[e]);
        }
        if constexpr (T != kCells) {
          // the packed cells' gradient lands on g: dx = g + dx_row - gy,
          // i.e. dx_row on occupied cells and g + dx_row on the others
          if (!oa && qa >= 0) {
            const float2 gg = ld2(p.g + qa + c);
            dx[0] += gg.x;
            dx[1] += gg.y;
          }
          if (!ob && qb >= 0) {
            const float2 gg = ld2(p.g + qb + c);
            dx[2] += gg.x;
            dx[3] += gg.y;
          }
        }
        if (qa >= 0) st2(p.dx + qa + c, dx[0], dx[1]);
        if (qb >= 0) st2(p.dx + qb + c, dx[2], dx[3]);
        if (f.cross) {
          if (ka >= 0) st2(p.dkv + ka + c, dkv[0], dkv[1]);
          if (kb >= 0) st2(p.dkv + kb + c, dkv[2], dkv[3]);
        }
        if (pp != nullptr) {
          *reinterpret_cast<float2*>(pp + c) = make_float2(dpos[0], dpos[1]);
          *reinterpret_cast<float2*>(pp + 8 * C + c) =
              make_float2(dpos[2], dpos[3]);
        }
      }
    }
    NARROW_PHASE(12);
    __syncthreads();
    // the cells of a packed window that no row writes: dx = g, dkv = 0
    if constexpr (T != kCells) {
      const int j = WPT == 4 ? warp : 0;
      const int slot = tile * WPT + j;
      if ((WPT == 4 ? warp < 4 : warp == kBWarps - 1) && slot < count) {
        const long long win = f.list[slot];
        uint32_t qlo = 0u, qhi = 0u, klo = 0u, khi = 0u;
        for (int i = lane; i < T; i += 32) {
          const int qc = rm.qcell[j * T + i], kc = rm.kcell[j * T + i];
          if (qc < 32) qlo |= 1u << qc; else qhi |= 1u << (qc - 32);
          if (kc < 32) klo |= 1u << kc; else khi |= 1u << (kc - 32);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          qlo |= __shfl_xor_sync(0xffffffffu, qlo, o);
          qhi |= __shfl_xor_sync(0xffffffffu, qhi, o);
          klo |= __shfl_xor_sync(0xffffffffu, klo, o);
          khi |= __shfl_xor_sync(0xffffffffu, khi, o);
        }
        for (int e = lane; e < kCells * N::NC; e += 32) {
          const int cell = e / N::NC;
          const long long off = (win * kCells + cell) * C + (e % N::NC) * 8;
          const uint32_t qbit = cell < 32 ? qlo >> cell : qhi >> (cell - 32);
          const uint32_t kbit = cell < 32 ? klo >> cell : khi >> (cell - 32);
          if (!(qbit & 1u))
            *reinterpret_cast<uint4*>(p.dx + off) =
                *reinterpret_cast<const uint4*>(p.g + off);
          if (f.cross && !(kbit & 1u))
            *reinterpret_cast<uint4*>(p.dkv + off) = make_uint4(0, 0, 0, 0);
        }
      }
    }
    // the tile's sums, the row groups in order (tau: then half 1's)
    float* const pv = p.part_v + (long long)tile * N::kVec;
    for (int i = tid; i < N::kVec; i += kBThreads) {
      float v = sums_all[i] + sums_all[NS + i] + sums_all[2 * NS + i] +
                sums_all[3 * NS + i];
      if (i == V::tau)
        v += sums_all[i + 1] + sums_all[NS + i + 1] +
             sums_all[2 * NS + i + 1] + sums_all[3 * NS + i + 1];
      pv[i] = v;
    }
    NARROW_PHASE(13);
  }
  if (!weights_in) cp_async_wait();  // a block that drew no tile
}

// K7/K9's pre-pass for the narrow widths, one warp per window: live when
// the cotangent is nonzero on an occupied query cell; a window that is not
// gets dx = 0 (T = 64) or g (S = 16, 48) and dkv = 0 on its 64 cells.
template <int T, int C>
__global__ void __launch_bounds__(256) bwd_prepass_kernel(const BwdParams p) {
  const FwdParams& f = p.f;
  const int lane = threadIdx.x & 31;
  const long long win = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (win >= f.nwin) return;
  constexpr int NC = C / 8;
  bool nz = false;
  for (int e = lane; e < T * NC; e += 32) {
    const int i = e / NC;
    if (!(f.qmask[win * T + i] > 0.f)) continue;
    const int cell =
        T == kCells ? i : min(max(f.selq[win * T + i], 0), kCells - 1);
    const uint4 v = *reinterpret_cast<const uint4*>(
        p.g + (win * kCells + cell) * C + (e % NC) * 8);
    nz |= ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) != 0u;
  }
  const bool live = __any_sync(0xffffffffu, nz);
  if (lane == 0) f.flags[win] = live;
  if (live) return;
  for (int e = lane; e < kCells * NC; e += 32) {
    const long long off = win * kCells * C + e * 8;
    *reinterpret_cast<uint4*>(p.dx + off) =
        T == kCells ? make_uint4(0, 0, 0, 0)
                    : *reinterpret_cast<const uint4*>(p.g + off);
    if (f.cross)
      *reinterpret_cast<uint4*>(p.dkv + off) = make_uint4(0, 0, 0, 0);
  }
}

// The six dY^T X products over one chunk of `chunk` workspace rows
// (blockIdx.y; a multiple of 64 rows, from the wrapper), one 32 x 32
// output tile a block (blockIdx.x over the matrices in order: wq wk wv wo
// [C][C], w1 [F][C], w2 [C][F]); each warp a 16 x 16 quarter. The next
// 64 rows are loaded into registers while the current ones are multiplied.
// Chunk partials [chunk][8 C^2].
struct Wgrad {
  const bf16* dy[6];
  const bf16* x[6];
  float* part;
};

template <int C>
__global__ void __launch_bounds__(128)
    wgrad_kernel(const Wgrad wg, const int* count, int wpt, int chunk) {
  constexpr int F = 2 * C, L = 40;
  __shared__ __align__(16) bf16 sdy[kRows * L], sx[kRows * L];
  const int rows = (*count + wpt - 1) / wpt * kRows;
  const long long lo = (long long)blockIdx.y * chunk;
  if (lo >= rows) return;
  const long long hi = min(lo + chunk, (long long)rows);
  int t = blockIdx.x, m = 0;
  for (;; ++m) {
    const int nt = (m == 4 ? F : C) / 32 * ((m == 5 ? F : C) / 32);
    if (t < nt) break;
    t -= nt;
  }
  const int nout = m == 4 ? F : C, nin = m == 5 ? F : C;
  const int o0 = (t / (nin / 32)) * 32, i0 = (t % (nin / 32)) * 32;
  const long long moff =
      m < 4 ? (long long)m * C * C
            : (m == 4 ? 4LL * C * C : 4LL * C * C + F * C);
  const bf16* dy = wg.dy[m];
  const bf16* x = wg.x[m];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mo = 16 * (warp >> 1), ni = 16 * (warp & 1);
  // a thread's two 8-column pieces of each 64-row step
  uint4 ndy[2], nx[2];
  const auto fetch = [&](long long r) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + 128 * u, rr = e >> 2, ch = e & 3;
      ndy[u] = *reinterpret_cast<const uint4*>(dy + (r + rr) * nout + o0 +
                                               ch * 8);
      nx[u] = *reinterpret_cast<const uint4*>(x + (r + rr) * nin + i0 +
                                              ch * 8);
    }
  };
  float acc[2][4];
  zero(acc);
  fetch(lo);
  for (long long r = lo; r < hi; r += kRows) {
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + 128 * u, rr = e >> 2, ch = e & 3;
      *reinterpret_cast<uint4*>(sdy + rr * L + ch * 8) = ndy[u];
      *reinterpret_cast<uint4*>(sx + rr * L + ch * 8) = nx[u];
    }
    __syncthreads();
    if (r + kRows < hi) fetch(r + kRows);
    mm_tm<2, kRows>(acc, sdy + mo, L, sx + ni, L, lane);
  }
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  float* out = wg.part + blockIdx.y * 8LL * C * C + moff;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = i0 + ni + 8 * n + t2;
    *reinterpret_cast<float2*>(out + (o0 + mo + g) * nin + c) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(out + (o0 + mo + g + 8) * nin + c) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// The 17 layer gradients (LayerParams order), then dpos.
struct Outs {
  float* p[18];
};

// Every gradient from its partials: out[0..16] the 17 layer gradients
// (LayerParams order), out[17] dpos. Element e of the partials' three
// regions (the weights' chunk partials, the per-tile sums, the per-tile
// dpos) sums its n partials in a fixed order: kRuns runs of consecutive
// partials, each summed in order by one thread, then the run sums in
// order. A block takes 32 elements, one warp a run.
template <int C>
__global__ void __launch_bounds__(32 * kRuns)
    reduce_kernel(const float* part_w, const float* part_v,
                  const float* part_p, const int* count, int wpt, int chunk,
                  const float* tau, float tau_min, const Outs out) {
  using N = Narrow<C>;
  using V = Vec<C>;
  constexpr int F = 2 * C, NW = 8 * C * C;
  __shared__ float red[kRuns][32];
  const int ntiles = (*count + wpt - 1) / wpt;
  const int nchunks = (ntiles * kRows + chunk - 1) / chunk;
  const int col = threadIdx.x % 32, run = threadIdx.x / 32;
  int e = blockIdx.x * 32 + col;
  // the element's region: its partials, their count and stride
  const float* part = nullptr;
  int n = 0, stride = 0, k = e;
  if (k < NW) {
    part = part_w, n = nchunks, stride = NW;
  } else if ((k -= NW) < N::kVec) {
    part = part_v, n = ntiles, stride = N::kVec;
  } else if ((k -= N::kVec) < kCells * C && part_p != nullptr) {
    part = part_p, n = ntiles, stride = kCells * C;
  }
  float s = 0.f;
  if (part != nullptr) {
    const int len = (n + kRuns - 1) / kRuns;
    const int hi = min(n, (run + 1) * len);
#pragma unroll 4
    for (int t = run * len; t < hi; ++t) s += part[(long long)t * stride + k];
  }
  red[run][col] = s;
  __syncthreads();
  if (run != 0 || part == nullptr) return;
  s = red[0][col];
#pragma unroll
  for (int r = 1; r < kRuns; ++r) s += red[r][col];
  if (part == part_w) {
    if (e < 4 * C * C)
      out.p[2 * (e / (C * C))][e % (C * C)] = s;
    else if (e < 4 * C * C + F * C)
      out.p[11][e - 4 * C * C] = s;
    else
      out.p[13][e - 4 * C * C - F * C] = s;
  } else if (part == part_v) {
    // (offset, output) of each run of the sums
    const int starts[11] = {V::bq, V::bk, V::bv, V::bo, V::ln1s, V::ln1b,
                            V::b1, V::b2, V::ln2s, V::ln2b, V::tau};
    const int outs[11] = {1, 3, 5, 7, 9, 10, 12, 14, 15, 16, 8};
    int j = 10;
    while (k < starts[j]) --j;
    if (j == 10) {
      // s = sum q.dq = scale dL/dscale; scale = 1 / max(tau, tau_min)
      const float t = tau[0];
      out.p[8][0] = t > tau_min ? -s * t / (t * t) : 0.f;
    } else {
      out.p[outs[j]][k - starts[j]] = s;
    }
  } else {
    out.p[17][k] = s;
  }
}

template <int T, int C, int H>
int launch_bwd(const BwdParams& p, const Mats& mats, float* part_w,
               int nchunks, int chunk, const Outs& outs, cudaStream_t s) {
  constexpr int WPT = T == 16 ? 4 : 1;
  using N = Narrow<C>;
  static_assert(bwd_smem<C, H>() <= 232448, "over the shared memory");
  const int n = p.f.nwin;
  int e;
  if (n > 0) {
    bwd_prepass_kernel<T, C><<<(n + 7) / 8, 256, 0, s>>>(p);
    if ((e = tmae_last_error())) return e;
  }
  compact_kernel<<<1, 1024, 0, s>>>(p.f.flags, p.f.list, p.f.count,
                                   p.f.counter, n);
  if ((e = tmae_last_error())) return e;
  if (n > 0) {
    static unsigned long long set_on = 0;  // for each instance
    if ((e = smem_limit_once((const void*)narrow_bwd_kernel<T, C, H>,
                             bwd_smem<C, H>(), set_on)))
      return e;
    const int blocks = std::min(sm_count(), (n + WPT - 1) / WPT);
    narrow_bwd_kernel<T, C, H>
        <<<blocks, kBThreads, bwd_smem<C, H>(), s>>>(p, mats);
    if ((e = tmae_last_error())) return e;
  }
  if (nchunks > 0) {
    Wgrad wg;
    const bf16* dys[6] = {p.oDQ, p.oDK, p.oDV, p.oDO, p.oDZ1, p.oDZ2};
    const bf16* xs[6] = {p.oXP, p.oKP, p.oKR, p.oA, p.oHB, p.oUB};
    for (int i = 0; i < 6; ++i) {
      wg.dy[i] = dys[i];
      wg.x[i] = xs[i];
    }
    wg.part = part_w;
    constexpr int tiles = 4 * (C / 32) * (C / 32) + 2 * (N::F / 32) * (C / 32);
    wgrad_kernel<C><<<dim3(tiles, nchunks), 128, 0, s>>>(wg, p.f.count, WPT,
                                                        chunk);
    if ((e = tmae_last_error())) return e;
  }
  const int total = 8 * C * C + N::kVec + (p.part_p ? kCells * C : 0);
  reduce_kernel<C><<<(total + 31) / 32, 32 * kRuns, 0, s>>>(
      part_w, p.part_v, p.part_p, p.f.count, WPT, chunk, p.f.tau,
      p.f.tau_min, outs);
  return tmae_last_error();
}

template <int C, int H>
int bwd_width(int T, const BwdParams& p, const Mats& m, float* part_w,
              int nchunks, int chunk, const Outs& o, cudaStream_t s) {
  if (T == 16)
    return launch_bwd<16, C, H>(p, m, part_w, nchunks, chunk, o, s);
  if (T == 48)
    return launch_bwd<48, C, H>(p, m, part_w, nchunks, chunk, o, s);
  return launch_bwd<kCells, C, H>(p, m, part_w, nchunks, chunk, o, s);
}

}  // namespace

// NARROW_FWD: the layer at a narrow width in one of the tiled kernel's
// modes (`mode`: Mode of encoder_fwd_plan.cuh, kSelOut .. kPlanInPlace:
// K8, K4, K6, K3, K10, K12). io: x kv out pos selq selk qmask kmask qocc
// kocc widx (out unused in place); w: the 17 layer tensors (bf16
// matrices, every tensor but tau 16-byte aligned); ints the int32
// workspace [2 nwin + 2]; dims: C F
// H T cross B total cap row_lo gh gw shift, where B is N for the flat
// modes, the batch otherwise; (gh, gw) the carrier (Hp + 8, Wp) or the grid
// (H, W). Three launches: pre-pass, compact, layer.
extern "C" int launch_narrow_fwd(int mode, const void* const* io,
                                 const void* const* w, void* ints,
                                 const int* dims, float tau_min,
                                 void* stream) {
  const int C = dims[0], F = dims[1], H = dims[2], T = dims[3];
  const int cross = dims[4], B = dims[5], total = dims[6], cap = dims[7];
  const int row_lo = dims[8], gh = dims[9], gw = dims[10], shift = dims[11];
  const bool sel = mode == kSelOut || mode == kSelInPlace;
  const bool full = mode == kFullOut || mode == kFullInPlace ||
                    mode == kGridOut;
  const bool grid = mode == kGridOut, plan = mode == kPlanInPlace;
  const bool in_place = mode == kSelInPlace || mode == kFullInPlace || plan;
  if (!narrow_ok(C, F, H) || mode < kSelOut || mode > kPlanInPlace ||
      (sel && T != 16 && T != 48) || (full && T != kCells) ||
      (plan && T != 16 && T != 48 && T != kCells) ||
      ((sel || (plan && T != kCells)) && io[4] == nullptr) ||
      (grid ? io[8] == nullptr : io[6] == nullptr) ||
      (cross && (io[1] == nullptr ||
                 (grid ? io[9] == nullptr : io[7] == nullptr) ||
                 (in_place && io[1] == io[0]))) ||
      (plan && (io[10] == nullptr || gh % 8 || gw % 8)) ||
      ((mode == kSelInPlace || mode == kFullInPlace) &&
       (row_lo < 0 || cap < 0 || row_lo + cap > total)))
    return (int)cudaErrorInvalidValue;
  const void* w18[18];
  for (int i = 0; i < 17; ++i) {
    // the layer copies every layer tensor but tau 16 bytes at a time
    if (i != 8 && reinterpret_cast<uintptr_t>(w[i]) % 16)
      return (int)cudaErrorMisalignedAddress;
    w18[i] = w[i];
  }
  w18[17] = nullptr;
  const int nwy = grid ? (gh + 7) / 8 + 1 : gh / 8 - 1;
  const int nwx = (gw + 7) / 8 + 1;
  const int nwin = grid ? B * nwy * nwx
                        : (mode == kSelOut || mode == kFullOut ? B : B * cap);
  FwdParams p =
      make_params(io[0], io[1], in_place ? const_cast<void*>(io[0])
                                         : const_cast<void*>(io[2]),
                  io[3], w18, ints, nwin, cross, tau_min);
  p.selq = static_cast<const int*>(io[4]);
  p.selk = static_cast<const int*>(io[5]);
  p.qmask = static_cast<const float*>(io[6]);
  p.kmask = static_cast<const float*>(io[7]);
  if (mode == kSelInPlace || mode == kFullInPlace) {
    p.total = total;
    p.cap = cap;
    p.row_lo = row_lo;
  } else if (plan) {
    p.cap = cap;
    p.widx = static_cast<const int*>(io[10]);
    p.gh = gh;
    p.gw = gw;
    p.nwy = nwy;
  } else if (grid) {
    p.qocc = static_cast<const unsigned char*>(io[8]);
    p.kocc = cross ? static_cast<const unsigned char*>(io[9]) : nullptr;
    p.gh = gh;
    p.gw = gw;
    p.nwy = nwy;
    p.nwx = nwx;
    p.off = shift ? 4 : 8;
  }
  const Mats m{{w[0], w[2], w[4], w[6], w[11], w[13]}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 32) return fwd_mode<32, 4>(mode, T, p, m, s);
  return H == 4 ? fwd_mode<64, 4>(mode, T, p, m, s)
                : fwd_mode<64, 8>(mode, T, p, m, s);
}

// NARROW_BWD: the gradients of the flat layer (K6 at T = 64, K8 at S = 16,
// 48) for the cotangent g. in: x kv g pos selq selk qmask kmask ([N, 64, C]
// bf16 windows, f32 masks and int32 selections [N, T]); w: the 17 layer
// tensors (bf16 matrices); ws: the workspace, the operand rows XP KP KR A HB
// UB DQ DK DV DO DZ1 DZ2 ([tiles 64, width] bf16; KP null in self mode),
// the int32 [2 N + 2], the per-tile sums [tiles, 9 C + F + 1], the per-tile
// dpos [tiles, 64 C] (when wanted) and the chunk partials [nchunks, 8 C^2]
// (f32); out: dx dkv (bf16) dpos, then the 17 gradients (f32). dims: N T C
// F H cross want_dpos nchunks. Up to six launches: pre-pass, compact, the
// window pass, the weight gradients, the sums.
extern "C" int launch_narrow_bwd(const void* const* in, const void* const* w,
                                 void* const* ws, void* const* out,
                                 const int* dims, float tau_min,
                                 void* stream) {
  const int N = dims[0], T = dims[1], C = dims[2], F = dims[3], H = dims[4];
  const int cross = dims[5], want_dpos = dims[6], nchunks = dims[7];
  const int chunk = dims[8];
  if (!narrow_ok(C, F, H) || (T != 16 && T != 48 && T != kCells) ||
      chunk < kRows || chunk % kRows ||
      (long long)nchunks * chunk < (T == 16 ? (N + 3) / 4 : N) * 64LL ||
      (want_dpos && (T != kCells || out[2] == nullptr)) ||
      in[0] == nullptr || in[2] == nullptr || in[6] == nullptr ||
      (T != kCells && in[4] == nullptr) ||
      (cross && (in[1] == nullptr || in[7] == nullptr || out[1] == nullptr)))
    return (int)cudaErrorInvalidValue;
  const void* w18[18];
  for (int i = 0; i < 17; ++i) {
    // the window pass copies every layer tensor but tau 16 bytes at a time
    if (i != 8 && reinterpret_cast<uintptr_t>(w[i]) % 16)
      return (int)cudaErrorMisalignedAddress;
    w18[i] = w[i];
  }
  w18[17] = nullptr;
  BwdParams p{};
  p.f = make_params(in[0], in[1], nullptr, in[3], w18, ws[12], N, cross,
                    tau_min);
  p.f.selq = static_cast<const int*>(in[4]);
  p.f.selk = static_cast<const int*>(in[5]);
  p.f.qmask = static_cast<const float*>(in[6]);
  p.f.kmask = static_cast<const float*>(in[7]);
  p.g = static_cast<const bf16*>(in[2]);
  p.dx = static_cast<bf16*>(out[0]);
  p.dkv = static_cast<bf16*>(out[1]);
  bf16* o[12];
  for (int i = 0; i < 12; ++i) o[i] = static_cast<bf16*>(ws[i]);
  p.oXP = o[0];
  p.oKP = cross ? o[1] : o[0];
  p.oKR = o[2];
  p.oA = o[3];
  p.oHB = o[4];
  p.oUB = o[5];
  p.oDQ = o[6];
  p.oDK = o[7];
  p.oDV = o[8];
  p.oDO = o[9];
  p.oDZ1 = o[10];
  p.oDZ2 = o[11];
  p.part_v = static_cast<float*>(ws[13]);
  p.part_p = want_dpos ? static_cast<float*>(ws[14]) : nullptr;
  Outs outs;
  for (int i = 0; i < 17; ++i) outs.p[i] = static_cast<float*>(out[3 + i]);
  outs.p[17] = static_cast<float*>(out[2]);
  const Mats m{{w[0], w[2], w[4], w[6], w[11], w[13]}};
  float* part_w = static_cast<float*>(ws[15]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 32)
    return bwd_width<32, 4>(T, p, m, part_w, nchunks, chunk, outs, s);
  return H == 4 ? bwd_width<64, 4>(T, p, m, part_w, nchunks, chunk, outs, s)
                : bwd_width<64, 8>(T, p, m, part_w, nchunks, chunk, outs, s);
}

#ifdef TMAE_NARROW_PROFILE
// NARROW_BWD's window-pass cycles by phase (16), summed over blocks, then
// zeroed.
extern "C" int tmae_narrow_profile(unsigned long long* out16) {
  static unsigned long long h[256][16];
  int e = (int)cudaMemcpyFromSymbol(h, tmae_narrow_cycles, sizeof(h));
  if (e) return e;
  for (int k = 0; k < 16; ++k) {
    out16[k] = 0;
    for (int b = 0; b < 256; ++b) out16[k] += h[b][k];
  }
  static unsigned long long z[256][16];
  return (int)cudaMemcpyToSymbol(tmae_narrow_cycles, z, sizeof(z));
}
#endif
