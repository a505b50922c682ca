// Kernels K3, K4, K6, K8, K10, K12 and K16: the cosine-attention SST encoder
// layer on gathered windows (K3-K8), on the dense BEV grid (K10) and on the
// windows of a plan straight in the padded carrier (K12); and its attention
// stage alone (K16).
//
// Replace tmae_tpu/ops/pallas_encoder.py:encoder_layer_rows_full (kernel
// _kernel_rows_full -> _layer_body) and encoder_layer_rows_sel (kernel
// _kernel_rows_sel -> _layer_body_sel), which update rows
// [row_lo, row_lo + cap) of the gathered window tensor [B, total, 64, C] in
// place (K3, K4: serving), and _pallas_forward (kernel _kernel ->
// _layer_body) and _pallas_forward_sel (kernel _kernel_sel ->
// _layer_body_sel), the same functions out of place on a flat [N, 64, C]
// window tensor (K6, K8: the training forward, launched as B = 1,
// total = cap = N, row_lo = 0 with a separate output). K3/K6 run the layer on
// all 64 cells of a window and mask its output by the query mask; K4/K8 run
// it on S selected cells (S = 16 or 48) and add the masked delta back onto
// those cells, so unselected cells pass through (K8 copies them to its
// output first).
//
// K10 replaces tmae_tpu/ops/pallas_encoder.py:_grid_forward (kernel
// _grid_kernel -> _layer_body): the K6 layer on every 8x8 window of a dense
// [B, H, W, C] grid, the window partition and its inverse done by the
// addressing. The partition has ceil(H/8) + 1 rows and ceil(W/8) + 1 columns
// of windows, offset by 8 cells (shift 0) or 4 (shift 1): cell (iy, ix) of
// window (wy, wx) is grid cell (8 wy + iy - off, 8 wx + ix - off), and a cell
// off the grid reads as zero and unoccupied. The query and key masks are the
// occupancy bytes of the grid cells. One block per window; each in-grid cell
// lies in exactly one window, so the blocks write disjoint cells of the new
// output grid. A window with no occupied query cell has an all-zero output
// (it is masked by the query mask), so its block writes zeros and exits: on
// a LiDAR frame most windows of the stride-1 grid are empty.
//
// K12 replaces tmae_tpu/ops/pallas_encoder.py:encoder_layer_fused_pipelined
// (kernel _kernel_fused_piped) and closes encoder_layer_fused_inplace
// (kernels _kernel_fused_full, _kernel_fused_sel), which compute the same
// function: gather DMA, the K3 (full) or K4 (S selected cells) layer, scatter
// DMA, over the windows of one bucket plan against the padded carrier
// [B, Hp + 8, Wp, C], aliased. Here the gather and scatter are the
// addressing: one block per (plan slot, sample) reads its window (wy, wx)
// from the plan, and token i, a window cell c (c = i, or sel[i]), is the row
// at carrier cell (8 wy + c / 8, 8 wx + c % 8) of its frame, in kv's carrier
// at the same offset in cross mode. The block reads every token before it
// writes (below), and the plan's windows are disjoint, so the update is in
// place; the full layer writes all 64 cells, the packed one x + delta on its
// occupied selected cells only, so every other cell keeps its content (the
// TPU kernel writes the whole window back from VMEM, with the same result).
// A dummy slot (wy >= nwy: the padding of a plan, which names the window row
// below the padded grid) exits without writing. The TPU kernel
// double-buffers its window DMAs across grid steps; here each block loads
// its own window, and overlapping loads with compute (cp.async / TMA) is
// later work.
//
// K16 replaces tmae_tpu/ops/pallas_attn.py:_pallas_forward (kernel _kernel):
// the attention of K6 on flat windows [N, 64, C] without the residual,
// LayerNorms and FFN, attn Wo + bo written on all 64 tokens of a window (no
// query mask), with the attention output rounded to bf16 before Wo as the
// TPU kernel rounds it to x's dtype. A window with no key gets p = 0, so its
// output is bo on every token: its block writes bo and exits (most windows
// of a stride-1 LiDAR grid are empty). One block per window: the TPU
// kernel's 16-window tiles and their padding have no counterpart. Bound:
// operations on windows with a key (2*64*C*C*4 + 2*64*64*C*2 flops, ~19
// MFLOP at C=128), bytes on the empty ones.
//
// Bound: operations. Per window the layer does 2*T*C*C*4 (q, k, v, out) +
// 2*T*C*F*2 (FFN) + 2*T*T*C*2 (logits, p.v) multiply-adds-as-2-flops,
// ~19 MFLOP at T=64, C=128 and ~71 MFLOP at C=256, against ~34 KB to 66 KB
// of window data: hundreds of operations per byte, above the card's
// bf16 ridge. K10 reads and writes the whole grid but runs the layer only on
// windows with an occupied query cell, so on a sparse stride-1 LiDAR grid it
// is bound by those bytes instead.
//
// Design, simple first: one block of 8 warps per window. The block reads its
// whole window (the S or 64 token rows it needs) into shared memory before it
// writes anything, which makes the in-place update safe: no other block
// touches its rows. Every matmul takes bf16 inputs and accumulates in f32 on
// the tensor cores through WMMA 16x16x16 fragments, as the TPU kernel feeds
// bf16 to the MXU with f32 accumulation. Activations stay in shared memory
// in bf16 where the TPU kernel casts (x + pos, normalised q and k, v, p, the
// attention output, the FFN input and hidden), in f32 where it does not (the
// LayerNorm residual h). Shared memory is the limit at C=256, T=64, F=512:
// the buffers are reused phase by phase, heads run one after another, and
// the FFN runs in chunks of 128 hidden units that accumulate into the f32
// residual. Weights are read through L2 for every window, each warp reusing
// a weight fragment across all token rows; keeping them resident (TMA,
// wgmma, several windows per block) is later work.
//
// Numerics held to the TPU kernel: q = (x+pos)Wq+bq and k = (kv+pos)Wk+bk
// with x+pos rounded to bf16; per-head L2 normalisation rsqrt(sum^2+1e-24)
// in f32; logits scaled by 1/max(tau, tau_min); masked keys filled with
// -30000 before the softmax; a window with no key gets p = 0; the delta lands
// on occupied query cells only, then LayerNorm (eps 1e-5) and a zero for
// unoccupied cells; exact-erf GELU FFN; residual; LayerNorm. The softmax is
// per head (the TPU packed variant shares one row max across heads, which is
// the same function where exp does not underflow).

#include "wmma_tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFC = 128;     // FFN hidden chunk width
constexpr int kPadB = 8;     // bf16 row padding (elements)
constexpr int kPadF = 4;     // f32 row padding (elements)
constexpr int kCells = 64;   // cells of an 8 x 8 window
constexpr int kMaxC = 256;   // LayerNorm passes keep C / 32 values per lane

struct Params {
  const bf16* xw;
  bf16* out;  // == xw for the in-place serving kernels
  const bf16* kvw;
  const int* selq;
  const int* selk;
  const float* qmask;
  const float* kmask;
  const bf16* pos;
  const bf16 *wq, *wk, *wv, *wo, *w1, *w2;
  const float *bq, *bk, *bv, *bo, *tau, *ln1s, *ln1b, *b1, *b2, *ln2s, *ln2b;
  int total, cap, row_lo, C, F, H, cross;
  float tau_min;
  // K10 only (qocc != nullptr): occupancy bytes [B, gh, gw] of the query
  // (and, in cross mode, key) grid, the grid size, the windows per row and
  // the partition offset
  const unsigned char *qocc, *kocc;
  int gh, gw, nwx, off;
  // K12 only (widx != nullptr): the plan's window coordinates [B, cap, 2]
  // (wy, wx) into the padded carrier [B, gh, gw, C] (gh = Hp + 8 rows,
  // gw = Wp columns) whose real window rows are 0 .. nwy - 1
  const int* widx;
  int nwy;
};

// Copies T token rows into shared memory: token i is the row at
// base + offs[i] (zeros where offs[i] < 0, a cell off the grid); `raw` gets
// the bf16 values, `with_pos` gets bf16(x + pos[cells[i]]). Either may be
// null.
__device__ __forceinline__ void load_tokens(bf16* raw, bf16* with_pos,
                                            const bf16* base, const int* offs,
                                            const int* cells,
                                            const bf16* pos, int C, int ld,
                                            int T) {
  const int vc = C / 8;
  for (int t = threadIdx.x; t < T * vc; t += kThreads) {
    const int i = t / vc;
    const int v = t - i * vc;
    const int o = offs[i];
    const uint4 x = o >= 0
                        ? *reinterpret_cast<const uint4*>(base + o + v * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
    if (raw) *reinterpret_cast<uint4*>(raw + i * ld + v * 8) = x;
    if (with_pos) {
      const uint4 ps =
          *reinterpret_cast<const uint4*>(pos + cells[i] * C + v * 8);
      uint4 o;
      const bf16* xa = reinterpret_cast<const bf16*>(&x);
      const bf16* pa = reinterpret_cast<const bf16*>(&ps);
      bf16* oa = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        oa[k] = __float2bfloat16(__bfloat162float(xa[k]) +
                                 __bfloat162float(pa[k]));
      *reinterpret_cast<uint4*>(with_pos + i * ld + v * 8) = o;
    }
  }
}

// dst = bf16(normalise_per_head(A W^T + bias) * mult); one warp per head.
template <int MT>
__device__ void project_heads(bf16* dst, const bf16* A, int ld,
                              const bf16* W, const float* bias, int C, int D,
                              int H, float mult, float* st, int warp,
                              int lane) {
  const int nj = D / 16;
  const int hw = D / 2;  // columns per lane: two lanes share a row
  const int rr = lane >> 1;
  const int c0 = (lane & 1) * hw;
  for (int h = warp; h < H; h += kWarps) {
    AccFrag acc[MT][2];
    zero_acc<MT>(acc);
    gemm_rows<MT>(acc, nj, A, ld, W, C, h * D, C);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nj)
          wmma::store_matrix_sync(st + 16 * j, acc[m][j], kStLd,
                                  wmma::mem_row_major);
      __syncwarp();
      float vals[16];
      float ss = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        if (c < hw) {
          const float v = st[rr * kStLd + c0 + c] + bias[h * D + c0 + c];
          vals[c] = v;
          ss += v * v;
        }
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      const float rs = rsqrtf(ss + 1e-24f);
#pragma unroll
      for (int c = 0; c < 16; ++c)
        if (c < hw)
          dst[(16 * m + rr) * ld + h * D + c0 + c] =
              __float2bfloat16(vals[c] * rs * mult);
      __syncwarp();
    }
  }
}

// dst = bf16(A W^T + bias), 16 output columns per warp step.
template <int MT>
__device__ void project_plain(bf16* dst, const bf16* A, int ld, const bf16* W,
                              const float* bias, int C, float* st, int warp,
                              int lane) {
  const int rr = lane >> 1;
  const int c0 = (lane & 1) * 8;
  for (int s = warp; s < C / 16; s += kWarps) {
    AccFrag acc[MT][2];
    zero_acc<MT>(acc);
    gemm_rows<MT>(acc, 1, A, ld, W, C, 16 * s, C);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      wmma::store_matrix_sync(st, acc[m][0], kStLd, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 8; ++c)
        dst[(16 * m + rr) * ld + 16 * s + c0 + c] = __float2bfloat16(
            st[rr * kStLd + c0 + c] + bias[16 * s + c0 + c]);
      __syncwarp();
    }
  }
}

// LayerNorm of one row held as C / 32 values per lane (value c = lane + 32i).
__device__ __forceinline__ void layer_norm_row(float (&v)[kMaxC / 32], int nc,
                                               const float* scale,
                                               const float* bias, int lane,
                                               int C) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxC / 32; ++i)
    if (i < nc) s += v[i];
  const float mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxC / 32; ++i)
    if (i < nc) {
      const float d = v[i] - mu;
      q += d * d;
    }
  const float rstd = rsqrtf(warp_sum(q) / C + 1e-5f);
#pragma unroll
  for (int i = 0; i < kMaxC / 32; ++i)
    if (i < nc) {
      const int c = lane + 32 * i;
      v[i] = (v[i] - mu) * rstd * scale[c] + bias[c];
    }
}

// kAttn (K16): the attention stage alone, out = attn(x) Wo + bo on every
// token, written to p.out; qmask holds the key mask (see
// launch_window_attention).
template <int T, bool kAttn = false>
__global__ void __launch_bounds__(kThreads)
    encoder_rows_kernel(const Params p) {
  constexpr int MT = T / 16;
  constexpr int ldl = T + 4;
  constexpr int ldp = T + 8;
  constexpr int ldh = kFC + kPadB;
  extern __shared__ __align__(128) unsigned char smem[];

  const int C = p.C;
  const int H = p.H;
  const int D = C / H;
  const int ldb = C + kPadB;
  const int ldf = C + kPadF;
  const int nc = C / 32;
  const size_t buf = (size_t)T * ldb * sizeof(bf16);

  bf16* xs = reinterpret_cast<bf16*>(smem);            // raw tokens
  bf16* a0 = reinterpret_cast<bf16*>(smem + buf);      // matmul input
  bf16* qn = reinterpret_cast<bf16*>(smem + 2 * buf);
  bf16* kn = reinterpret_cast<bf16*>(smem + 3 * buf);
  bf16* vb = reinterpret_cast<bf16*>(smem + 4 * buf);
  float* lg = reinterpret_cast<float*>(smem + 5 * buf);
  bf16* pb = reinterpret_cast<bf16*>(lg + T * ldl);
  float* st_all = reinterpret_cast<float*>(pb + T * ldp);
  float* qm_s = st_all + kWarps * 16 * kStLd;
  float* km_s = qm_s + T;
  int* sq_s = reinterpret_cast<int*>(km_s + T);  // query / key cell (pos row)
  int* sk_s = sq_s + T;
  int* qoff_s = sk_s + T;  // element offset of each token's row from its base
  int* koff_s = qoff_s + T;
  // reuse after attention
  float* h32 = reinterpret_cast<float*>(qn);  // spans qn and kn
  bf16* hb = vb;
  bf16* hid = a0;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* st = st_all + warp * 16 * kStLd;
  const bool grid = p.qocc != nullptr;  // K10 (T == 64)
  const bf16* xbase;   // query tokens: xbase + qoff_s[i]
  const bf16* kvbase;  // key tokens (cross): kvbase + koff_s[i]
  bf16* obase;         // output rows: obase + qoff_s[i]
  if (grid) {
    const long long frame = (long long)blockIdx.y * p.gh * p.gw;
    xbase = p.xw + frame * C;
    kvbase = p.cross ? p.kvw + frame * C : nullptr;
    obase = p.out + frame * C;
    const int wy = blockIdx.x / p.nwx;
    const int wx = blockIdx.x - wy * p.nwx;
    for (int i = tid; i < T; i += kThreads) {
      const int y = wy * 8 + i / 8 - p.off;
      const int x = wx * 8 + i % 8 - p.off;
      const bool in = y >= 0 && y < p.gh && x >= 0 && x < p.gw;
      const int cell = in ? y * p.gw + x : 0;
      const float qm = (in && p.qocc[frame + cell]) ? 1.f : 0.f;
      qm_s[i] = qm;
      km_s[i] = p.cross ? ((in && p.kocc[frame + cell]) ? 1.f : 0.f) : qm;
      sq_s[i] = sk_s[i] = i;
      qoff_s[i] = koff_s[i] = in ? cell * C : -1;
    }
  } else {
    const long long slot = (long long)blockIdx.y * p.cap + blockIdx.x;
    // element offset of window cell c from the base: the window row of the
    // gathered tensor (K3-K8), or the carrier cell (K12)
    int origin = 0, cell_ld = 8;
    if (p.widx) {  // K12
      const int wy = p.widx[2 * slot];
      const int wx = p.widx[2 * slot + 1];
      if (wy < 0 || wy >= p.nwy || wx < 0 || (wx + 1) * 8 > p.gw)
        return;  // a dummy slot: no window to update
      const long long frame = (long long)blockIdx.y * p.gh * p.gw;
      xbase = p.xw + frame * C;
      obase = p.out + frame * C;
      kvbase = p.cross ? p.kvw + frame * C : nullptr;
      origin = wy * 8 * p.gw + wx * 8;
      cell_ld = p.gw;
    } else {
      const long long row =
          (long long)blockIdx.y * p.total + p.row_lo + blockIdx.x;
      xbase = p.xw + row * kCells * C;
      obase = p.out + row * kCells * C;
      if (p.selq && obase != xbase) {  // K8: unselected cells pass through
        for (int t = tid; t < kCells * C / 8; t += kThreads)
          reinterpret_cast<uint4*>(obase)[t] =
              reinterpret_cast<const uint4*>(xbase)[t];
      }
      kvbase = p.cross ? p.kvw + row * kCells * C : nullptr;
    }
    for (int i = tid; i < T; i += kThreads) {
      const float qm = p.qmask[slot * T + i];
      qm_s[i] = qm;
      km_s[i] = p.cross ? p.kmask[slot * T + i] : qm;
      const int sq =
          p.selq ? min(max(p.selq[slot * T + i], 0), kCells - 1) : i;
      const int sk = (p.cross && p.selk)
                         ? min(max(p.selk[slot * T + i], 0), kCells - 1)
                         : sq;
      sq_s[i] = sq;
      sk_s[i] = sk;
      qoff_s[i] = (origin + (sq >> 3) * cell_ld + (sq & 7)) * C;
      koff_s[i] = (origin + (sk >> 3) * cell_ld + (sk & 7)) * C;
    }
  }
  __syncthreads();
  if (grid && !__syncthreads_or(tid < T && qm_s[tid] > 0.f)) {
    // no occupied query cell: the masked output is zero everywhere
    const int vc = C / 8;
    for (int t = tid; t < T * vc; t += kThreads) {
      const int i = t / vc;
      if (qoff_s[i] >= 0)
        *reinterpret_cast<uint4*>(obase + qoff_s[i] + (t - i * vc) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int has_key = __syncthreads_or(tid < T && km_s[tid] > 0.f);
  const float scale = 1.f / fmaxf(p.tau[0], p.tau_min);
  if (kAttn && !has_key) {
    // no key: p = 0, so every token's output is bo
    const int vc = C / 8;
    for (int t = tid; t < T * vc; t += kThreads) {
      const int i = t / vc;
      const int v = t - i * vc;
      uint4 packed;
      bf16* pv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int c = 0; c < 8; ++c) pv[c] = __float2bfloat16(p.bo[v * 8 + c]);
      *reinterpret_cast<uint4*>(obase + qoff_s[i] + v * 8) = packed;
    }
    return;
  }

  // ---- projections ------------------------------------------------------
  load_tokens(xs, a0, xbase, qoff_s, sq_s, p.pos, C, ldb, T);
  __syncthreads();
  project_heads<MT>(qn, a0, ldb, p.wq, p.bq, C, D, H, scale, st, warp, lane);
  if (!p.cross) {
    project_heads<MT>(kn, a0, ldb, p.wk, p.bk, C, D, H, 1.f, st, warp, lane);
    project_plain<MT>(vb, xs, ldb, p.wv, p.bv, C, st, warp, lane);
    __syncthreads();
  } else {
    __syncthreads();
    load_tokens(a0, nullptr, kvbase, koff_s, sk_s, p.pos, C, ldb, T);
    __syncthreads();
    project_plain<MT>(vb, a0, ldb, p.wv, p.bv, C, st, warp, lane);
    __syncthreads();
    load_tokens(nullptr, a0, kvbase, koff_s, sk_s, p.pos, C, ldb, T);
    __syncthreads();
    project_heads<MT>(kn, a0, ldb, p.wk, p.bk, C, D, H, 1.f, st, warp, lane);
    __syncthreads();
  }

  // ---- attention, one head at a time; output into a0 ----------------------
  for (int h = 0; h < H; ++h) {
    for (int t = warp; t < MT * MT; t += kWarps) {
      const int mi = t / MT;
      const int ni = t % MT;
      AccFrag acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < D; k0 += 16) {
        AFrag a;
        BColFrag bk;
        wmma::load_matrix_sync(a, qn + 16 * mi * ldb + h * D + k0, ldb);
        wmma::load_matrix_sync(bk, kn + 16 * ni * ldb + h * D + k0, ldb);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(lg + 16 * mi * ldl + 16 * ni, acc, ldl,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = warp; i < T; i += kWarps) {
      float l[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        l[u] = j < T ? (km_s[j] > 0.f ? lg[i * ldl + j] : -30000.f)
                     : -CUDART_INF_F;
      }
      const float mx = warp_max(fmaxf(l[0], l[1]));
      float e[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) e[u] = lane + 32 * u < T ? expf(l[u] - mx) : 0.f;
      const float inv = has_key ? 1.f / warp_sum(e[0] + e[1]) : 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        if (j < T) pb[i * ldp + j] = __float2bfloat16(e[u] * inv);
      }
    }
    __syncthreads();
    const int nd = D / 16;
    for (int t = warp; t < MT * nd; t += kWarps) {
      const int mi = t / nd;
      const int nj = t % nd;
      AccFrag acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < T; k0 += 16) {
        AFrag a;
        BRowFrag bv;
        wmma::load_matrix_sync(a, pb + 16 * mi * ldp + k0, ldp);
        wmma::load_matrix_sync(bv, vb + k0 * ldb + h * D + 16 * nj, ldb);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(st, acc, kStLd, wmma::mem_row_major);
      __syncwarp();
      const int rr = lane >> 1;
      const int c0 = (lane & 1) * 8;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        a0[(16 * mi + rr) * ldb + h * D + 16 * nj + c0 + c] =
            __float2bfloat16(st[rr * kStLd + c0 + c]);
      __syncwarp();
    }
    __syncthreads();
  }

  if constexpr (kAttn) {
    // ---- K16: output projection of every token, no residual ----------------
    const int rr = lane >> 1;
    const int c0 = (lane & 1) * 8;
    for (int s = warp; s < C / 16; s += kWarps) {
      AccFrag acc[MT][2];
      zero_acc<MT>(acc);
      gemm_rows<MT>(acc, 1, a0, ldb, p.wo, C, 16 * s, C);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        wmma::store_matrix_sync(st, acc[m][0], kStLd, wmma::mem_row_major);
        __syncwarp();
        const int i = 16 * m + rr;
        uint4 packed;
        bf16* pv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          pv[c] = __float2bfloat16(st[rr * kStLd + c0 + c] +
                                   p.bo[16 * s + c0 + c]);
        *reinterpret_cast<uint4*>(obase + qoff_s[i] + 16 * s + c0) = packed;
        __syncwarp();
      }
    }
    return;
  }

  // ---- output projection, residual on occupied query cells ---------------
  {
    const int rr = lane >> 1;
    const int c0 = (lane & 1) * 8;
    for (int s = warp; s < C / 16; s += kWarps) {
      AccFrag acc[MT][2];
      zero_acc<MT>(acc);
      gemm_rows<MT>(acc, 1, a0, ldb, p.wo, C, 16 * s, C);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        wmma::store_matrix_sync(st, acc[m][0], kStLd, wmma::mem_row_major);
        __syncwarp();
        const int i = 16 * m + rr;
        const bool occ = qm_s[i] > 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = 16 * s + c0 + c;
          const float x = __bfloat162float(xs[i * ldb + n]);
          h32[i * ldf + n] = x + (occ ? st[rr * kStLd + c0 + c] + p.bo[n] : 0.f);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int i = warp; i < T; i += kWarps) {
    float v[kMaxC / 32];
#pragma unroll
    for (int u = 0; u < kMaxC / 32; ++u)
      if (u < nc) v[u] = h32[i * ldf + lane + 32 * u];
    layer_norm_row(v, nc, p.ln1s, p.ln1b, lane, C);
    const bool occ = qm_s[i] > 0.f;
#pragma unroll
    for (int u = 0; u < kMaxC / 32; ++u)
      if (u < nc) {
        const float hv = occ ? v[u] : 0.f;
        h32[i * ldf + lane + 32 * u] = hv;
        hb[i * ldb + lane + 32 * u] = __float2bfloat16(hv);
      }
  }
  __syncthreads();

  // ---- FFN in chunks of kFC hidden units, accumulated into h32 ------------
  for (int f0 = 0; f0 < p.F; f0 += kFC) {
    {
      const int rr = lane >> 1;
      const int c0 = (lane & 1) * 8;
      for (int s = warp; s < kFC / 16; s += kWarps) {
        AccFrag acc[MT][2];
        zero_acc<MT>(acc);
        gemm_rows<MT>(acc, 1, hb, ldb, p.w1, C, f0 + 16 * s, C);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          wmma::store_matrix_sync(st, acc[m][0], kStLd, wmma::mem_row_major);
          __syncwarp();
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float u = st[rr * kStLd + c0 + c] + p.b1[f0 + 16 * s + c0 + c];
            const float g = 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
            hid[(16 * m + rr) * ldh + 16 * s + c0 + c] = __float2bfloat16(g);
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    for (int s = warp; s < C / 16; s += kWarps) {
      AccFrag acc[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        wmma::load_matrix_sync(acc[m][0], h32 + 16 * m * ldf + 16 * s, ldf,
                               wmma::mem_row_major);
      gemm_rows<MT>(acc, 1, hid, ldh, p.w2 + f0, p.F, 16 * s, kFC);
#pragma unroll
      for (int m = 0; m < MT; ++m)
        wmma::store_matrix_sync(h32 + 16 * m * ldf + 16 * s, acc[m][0], ldf,
                                wmma::mem_row_major);
    }
    __syncthreads();
  }

  // ---- second LayerNorm and the in-place write ---------------------------
  const bool sel = p.selq != nullptr;
  for (int i = warp; i < T; i += kWarps) {
    float v[kMaxC / 32];
#pragma unroll
    for (int u = 0; u < kMaxC / 32; ++u)
      if (u < nc) {
        const int c = lane + 32 * u;
        v[u] = h32[i * ldf + c] + p.b2[c];
      }
    layer_norm_row(v, nc, p.ln2s, p.ln2b, lane, C);
    const bool occ = qm_s[i] > 0.f;
    bf16* dst = obase + qoff_s[i];
    if (qoff_s[i] < 0) {
      // K10: a cell off the grid is padding, not output
    } else if (!sel) {
#pragma unroll
      for (int u = 0; u < kMaxC / 32; ++u)
        if (u < nc) dst[lane + 32 * u] = __float2bfloat16(occ ? v[u] : 0.f);
    } else if (occ) {
#pragma unroll
      for (int u = 0; u < kMaxC / 32; ++u)
        if (u < nc) {
          const int c = lane + 32 * u;
          const float x = __bfloat162float(xs[i * ldb + c]);
          const float delta = __bfloat162float(__float2bfloat16(v[u] - x));
          dst[c] = __float2bfloat16(x + delta);
        }
    }
  }
}

size_t smem_bytes(int T, int C) {
  const size_t buf = (size_t)T * (C + kPadB) * sizeof(bf16);
  return 5 * buf + (size_t)T * (T + 4) * sizeof(float) +
         (size_t)T * (T + 8) * sizeof(bf16) +
         (size_t)kWarps * 16 * kStLd * sizeof(float) + 6 * (size_t)T * 4;
}

template <int T, bool kAttn = false>
int launch_rows(const Params& p, int B, cudaStream_t stream) {
  if (p.cap == 0 || B == 0) return 0;
  const size_t smem = smem_bytes(T, p.C);
  cudaError_t e = cudaFuncSetAttribute(
      encoder_rows_kernel<T, kAttn>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  encoder_rows_kernel<T, kAttn><<<dim3(p.cap, B), kThreads, smem, stream>>>(p);
  return tmae_last_error();
}

int launch_sel(const Params& p, int B, int S, cudaStream_t s) {
  switch (S) {
    case 16: return launch_rows<16>(p, B, s);
    case 48: return launch_rows<48>(p, B, s);
    case 64: return launch_rows<64>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool shape_ok(int C, int F, int H) {
  if (H <= 0 || C % H) return false;
  const int D = C / H;
  return C % 32 == 0 && C <= kMaxC && (D == 16 || D == 32) && F % kFC == 0;
}

Params make_params(const void* xw, void* out, const void* kvw,
                   const void* selq,
                   const void* selk, const void* qmask, const void* kmask,
                   const void* pos, const void* const* w, int total, int cap,
                   int row_lo, int C, int F, int H, int cross, float tau_min) {
  Params p;
  p.xw = static_cast<const bf16*>(xw);
  p.out = static_cast<bf16*>(out);
  p.kvw = static_cast<const bf16*>(kvw);
  p.selq = static_cast<const int*>(selq);
  p.selk = static_cast<const int*>(selk);
  p.qmask = static_cast<const float*>(qmask);
  p.kmask = static_cast<const float*>(kmask);
  p.pos = static_cast<const bf16*>(pos);
  // w: wq bq wk bk wv bv wo bo tau ln1s ln1b w1 b1 w2 b2 ln2s ln2b
  p.wq = static_cast<const bf16*>(w[0]);
  p.bq = static_cast<const float*>(w[1]);
  p.wk = static_cast<const bf16*>(w[2]);
  p.bk = static_cast<const float*>(w[3]);
  p.wv = static_cast<const bf16*>(w[4]);
  p.bv = static_cast<const float*>(w[5]);
  p.wo = static_cast<const bf16*>(w[6]);
  p.bo = static_cast<const float*>(w[7]);
  p.tau = static_cast<const float*>(w[8]);
  p.ln1s = static_cast<const float*>(w[9]);
  p.ln1b = static_cast<const float*>(w[10]);
  p.w1 = static_cast<const bf16*>(w[11]);
  p.b1 = static_cast<const float*>(w[12]);
  p.w2 = static_cast<const bf16*>(w[13]);
  p.b2 = static_cast<const float*>(w[14]);
  p.ln2s = static_cast<const float*>(w[15]);
  p.ln2b = static_cast<const float*>(w[16]);
  p.total = total;
  p.cap = cap;
  p.row_lo = row_lo;
  p.C = C;
  p.F = F;
  p.H = H;
  p.cross = cross;
  p.tau_min = tau_min;
  p.qocc = p.kocc = nullptr;
  p.gh = p.gw = p.nwx = p.off = 0;
  p.widx = nullptr;
  p.nwy = 0;
  return p;
}

}  // namespace

// `w` points at 17 device pointers in the order of make_params.
extern "C" int launch_encoder_rows_full(void* xw, const void* kvw,
                                        const void* qmask, const void* kmask,
                                        const void* pos, const void* const* w,
                                        int B, int total, int cap, int row_lo,
                                        int C, int F, int H, int cross,
                                        float tau_min, void* stream) {
  if (!shape_ok(C, F, H)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(xw, xw, kvw, nullptr, nullptr, qmask, kmask,
                               pos, w, total, cap, row_lo, C, F, H, cross,
                               tau_min);
  return launch_rows<kCells>(p, B, static_cast<cudaStream_t>(stream));
}

extern "C" int launch_encoder_rows_sel(void* xw, const void* kvw,
                                       const void* selq, const void* selk,
                                       const void* qmask, const void* kmask,
                                       const void* pos, const void* const* w,
                                       int B, int total, int cap, int row_lo,
                                       int C, int F, int H, int S, int cross,
                                       float tau_min, void* stream) {
  if (!shape_ok(C, F, H)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(xw, xw, kvw, selq, selk, qmask, kmask, pos, w,
                               total, cap, row_lo, C, F, H, cross, tau_min);
  return launch_sel(p, B, S, static_cast<cudaStream_t>(stream));
}

// K6: out [N, 64, C] = layer(xw [N, 64, C]).
extern "C" int launch_encoder_fwd_full(const void* xw, const void* kvw,
                                       void* out, const void* qmask,
                                       const void* kmask, const void* pos,
                                       const void* const* w, int N, int C,
                                       int F, int H, int cross, float tau_min,
                                       void* stream) {
  if (!shape_ok(C, F, H)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(xw, out, kvw, nullptr, nullptr, qmask, kmask,
                               pos, w, N, N, 0, C, F, H, cross, tau_min);
  return launch_rows<kCells>(p, 1, static_cast<cudaStream_t>(stream));
}

// K8: out [N, 64, C] = xw + the layer's delta on the S selected cells.
extern "C" int launch_encoder_fwd_sel(const void* xw, const void* kvw,
                                      void* out, const void* selq,
                                      const void* selk, const void* qmask,
                                      const void* kmask, const void* pos,
                                      const void* const* w, int N, int C,
                                      int F, int H, int S, int cross,
                                      float tau_min, void* stream) {
  if (!shape_ok(C, F, H)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(xw, out, kvw, selq, selk, qmask, kmask, pos, w,
                               N, N, 0, C, F, H, cross, tau_min);
  return launch_sel(p, 1, S, static_cast<cudaStream_t>(stream));
}

// K10: out [B, H, W, C] = the layer on every 8x8 window of the shift's
// partition of xg [B, H, W, C] (kvg likewise in cross mode), with masks from
// the occupancy bytes qocc / kocc [B, H, W].
extern "C" int launch_encoder_grid(const void* xg, const void* kvg, void* out,
                                   const void* qocc, const void* kocc,
                                   const void* pos, const void* const* w,
                                   int B, int H, int W, int C, int F, int nh,
                                   int cross, int shift, float tau_min,
                                   void* stream) {
  if (!shape_ok(C, F, nh) || qocc == nullptr || (cross && kocc == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nwy = (H + 7) / 8 + 1;
  const int nwx = (W + 7) / 8 + 1;
  Params p = make_params(xg, out, kvg, nullptr, nullptr, nullptr, nullptr,
                         pos, w, nwy * nwx, nwy * nwx, 0, C, F, nh, cross,
                         tau_min);
  p.qocc = static_cast<const unsigned char*>(qocc);
  p.kocc = cross ? static_cast<const unsigned char*>(kocc) : nullptr;
  p.gh = H;
  p.gw = W;
  p.nwx = nwx;
  p.off = shift ? 4 : 8;
  return launch_rows<kCells>(p, B, static_cast<cudaStream_t>(stream));
}

// K12: the layer over the windows of one bucket plan idx [B, cap, 2] of the
// padded carrier xp [B, Hp2, Wp, C], in place (kvp likewise in cross mode,
// never xp itself): T = 64 (selq null, masks [B, cap, 64]) or the S = T
// selected cells (selq / selk and masks [B, cap, S]).
extern "C" int launch_encoder_inplace(void* xp, const void* kvp,
                                      const void* idx, const void* selq,
                                      const void* selk, const void* qmask,
                                      const void* kmask, const void* pos,
                                      const void* const* w, int B, int Hp2,
                                      int Wp, int cap, int C, int F, int H,
                                      int T, int cross, float tau_min,
                                      void* stream) {
  if (!shape_ok(C, F, H) || idx == nullptr || Hp2 % 8 || Wp % 8 ||
      (T != kCells && selq == nullptr) || (cross && kvp == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(xp, xp, kvp, selq, selk, qmask, kmask, pos, w, cap,
                         cap, 0, C, F, H, cross, tau_min);
  p.widx = static_cast<const int*>(idx);
  p.gh = Hp2;
  p.gw = Wp;
  p.nwy = Hp2 / 8 - 1;
  return launch_sel(p, B, T, static_cast<cudaStream_t>(stream));
}

// K16: out [N, 64, C] = the cosine window attention of xw [N, 64, C] (keys
// and values from kvw in cross mode) with key mask kmask [N, 64], then
// attn Wo + bo on every token; no LayerNorm, FFN or residual. `w` points at
// the 9 device pointers wq bq wk bk wv bv wo bo tau (Linear weights
// [out, in] bf16, the rest f32).
extern "C" int launch_window_attention(const void* xw, const void* kvw,
                                       void* out, const void* kmask,
                                       const void* pos, const void* const* w,
                                       int N, int C, int H, int cross,
                                       float tau_min, void* stream) {
  if (H <= 0 || C % H || C % 32 || C > kMaxC ||
      (C / H != 16 && C / H != 32) || (cross && kvw == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* w17[17] = {w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8],
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr};
  // the key mask stands in for the query mask: in self mode the kernel
  // takes its key mask from qmask
  const Params p = make_params(xw, out, kvw, nullptr, nullptr, kmask, kmask,
                               pos, w17, N, N, 0, C, 0, H, cross, tau_min);
  return launch_rows<kCells, true>(p, 1, static_cast<cudaStream_t>(stream));
}
