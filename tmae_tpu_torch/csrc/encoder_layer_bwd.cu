// Kernels K7 and K9: the fused backward of the training encoder layer (K6,
// K8), with the forward recomputed.
//
// Replace tmae_tpu/ops/pallas_encoder.py:_pallas_backward (kernel
// _bwd_kernel) and _pallas_backward_sel (kernel _bwd_kernel_sel). Given the
// layer's inputs and the gradient g of its output, both return dx and dkv
// (bf16), the 17 parameter gradients (f32, summed over all windows), and
// for the full variant the gradient of the slot positional embedding. The
// full variant (K7) runs the layer on all 64 cells of each window; the
// selected variant (K9) on the S = 16 or 48 cells named by sel_q / sel_k, and
// its dx is g plus the expanded gradient of the packed cells (the layer adds
// its delta onto x, so g passes through).
//
// Numerics follow _bwd_kernel: the forward is recomputed in f32 with bf16
// operands for every matmul (x + pos, q and k normalised per head but not
// scaled, v, p, the attention output, h1, the GELU output), and so is the
// backward (dz2, dff1, dattn, da, ds, dq, dk, dv); products accumulate in f32
// and every elementwise step (LayerNorm statistics and their backward, the
// exact-erf GELU gradient, the softmax backward, the cosine-normalisation
// backward) is f32. dtau = -sum(ds * dots) / tau^2 when tau > tau_min, else
// 0. In self mode the keys and values are the queries: their gradients fold
// into dx and dkv is not written.
//
// Design. The TPU kernel keeps a tile of windows in VMEM and carries the
// weight gradients across a sequential grid; a Hopper block has 227 KB of
// shared memory and blocks run in no order. So the work is split into
// passes that meet in device memory (a workspace of rows, R = N * T of them,
// each a packed token of one window):
//   P0 pack      per window: the token rows (x, x + pos, g, and kv, kv + pos
//                in cross mode) gathered by the cell selection, as bf16 rows.
//   P1 attn fwd  per (window, head): q, k, v of the head, the cosine
//                normalisation (normalised q, k and their 1/norm kept in
//                f32), softmax attention; writes the attention output rows.
//   P2 rows      per 64 rows: output projection, LayerNorm 1, FFN (chunks of
//                128 hidden units), LayerNorm 2, then the backward of those
//                down to da, the gradient of the attention output.
//   P3 attn bwd  per (window, head): recomputes the logits and p, softmax
//                backward, dq, dk, dv through the normalisation.
//   P4 out rows  per 64 rows: dx (and dkv) through the q, k, v projections.
//   P4b expand   (K9) per window: dx = g + the packed gradients summed onto
//                their cells, dkv likewise.
//   P5 weights   the six weight gradients as dY^T X over all rows: a split
//                over row chunks into f32 partials, then
//   P6 sums      a fixed-order sum over the chunks (and over per-tile
//                partials for the bias, LayerNorm and tau gradients), so the
//                result is the same from run to run without atomics.
// Every matmul is WMMA bf16 16x16x16 with f32 accumulation; operands are read
// from shared memory or straight from the workspace through L2.
//
// Bound: operations. The backward does about twice the forward's products
// (about 2.5x with the recompute): hundreds of operations per byte of window
// data. The workspace adds ~14 bytes x C per row of traffic, which is what
// bounds this simple design today; fusing P1-P4 is later work.

#include "wmma_tiles.cuh"

namespace {

constexpr int kFC = 128;     // FFN hidden chunk width
constexpr int kRowTile = 64; // rows per P2 / P4 block
constexpr int kCells = 64;
constexpr int kMaxC = 256;
constexpr int kHeadWarps = 4;  // P1 / P3 blocks

struct BwdParams {
  // inputs
  const bf16 *x, *kv, *g, *pos;
  const int *selq, *selk;
  const float *qmask, *kmask;
  const bf16 *wq, *wk, *wv, *wo, *w1, *w2;
  const float *bq, *bk, *bv, *bo, *tau, *ln1s, *ln1b, *b1, *b2, *ln2s, *ln2b;
  int N, T, C, F, H, D, cross, R;
  float tau_min;
  // workspace rows [R (padded to kRowTile), width]
  bf16 *X, *XP, *G, *KV, *KVP, *V, *A, *H1, *GG, *DZ2, *DFF1, *DATT, *DA,
      *DQ, *DK, *DV;
  float *QN, *KN, *RQ, *RK, *X1H, *DZ1, *DX16, *DKV16, *DP;
  float *PV2;  // [R / kRowTile tiles, 6C + F]: P2 per-tile vector partials
  float *PV3;  // [N, 3C]: dbq, dbk, dbv per window
  float *PT;   // [N * H]: dtau partial per (window, head)
  // outputs
  bf16 *dx, *dkv;
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

// ---------------------------------------------------------------------------
// P0: pack the token rows of each window
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 add_pos(uint4 x, uint4 ps) {
  uint4 o;
  const bf16* xa = reinterpret_cast<const bf16*>(&x);
  const bf16* pa = reinterpret_cast<const bf16*>(&ps);
  bf16* oa = reinterpret_cast<bf16*>(&o);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    oa[k] = __float2bfloat16(__bfloat162float(xa[k]) + __bfloat162float(pa[k]));
  return o;
}

__global__ void pack_kernel(const BwdParams p) {
  const int n = blockIdx.x;
  const int T = p.T, C = p.C, vc = C / 8;
  for (int t = threadIdx.x; t < T * vc; t += blockDim.x) {
    const int s = t / vc;
    const int v = t - s * vc;
    const long long r = (long long)n * T + s;
    const int cq = p.selq ? clamp_cell(p.selq[r]) : s;
    const long long src = ((long long)n * kCells + cq) * C + v * 8;
    const long long dst = r * C + v * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(p.x + src);
    *reinterpret_cast<uint4*>(p.X + dst) = x;
    *reinterpret_cast<uint4*>(p.G + dst) =
        *reinterpret_cast<const uint4*>(p.g + src);
    *reinterpret_cast<uint4*>(p.XP + dst) = add_pos(
        x, *reinterpret_cast<const uint4*>(p.pos + cq * C + v * 8));
    if (p.cross) {
      const int ck = p.selk ? clamp_cell(p.selk[r]) : s;
      const long long ksrc = ((long long)n * kCells + ck) * C + v * 8;
      const uint4 kv = *reinterpret_cast<const uint4*>(p.kv + ksrc);
      *reinterpret_cast<uint4*>(p.KV + dst) = kv;
      *reinterpret_cast<uint4*>(p.KVP + dst) = add_pos(
          kv, *reinterpret_cast<const uint4*>(p.pos + ck * C + v * 8));
    }
  }
}

// ---------------------------------------------------------------------------
// P1 / P3 shared pieces: one block of 4 warps per (window, head)
// ---------------------------------------------------------------------------

// dst[t][d] (f32, row stride ldd) = rows[T, C] . W[h*D + d, :]^T for one head.
template <int T>
__device__ void head_proj(float* dst, int ldd, const bf16* rows, int C,
                          const bf16* W, int h, int D, int warp) {
  constexpr int MT = T / 16;
  const int nd = D / 16;
  for (int t = warp; t < MT * nd; t += kHeadWarps) {
    const int m = t / nd, j = t % nd;
    AccFrag acc;
    wmma::fill_fragment(acc, 0.f);
    AFrag a;
    BColFrag b;
    for (int k0 = 0; k0 < C; k0 += 16) {
      wmma::load_matrix_sync(a, rows + (long long)16 * m * C + k0, C);
      wmma::load_matrix_sync(b, W + (long long)(h * D + 16 * j) * C + k0, C);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(dst + 16 * m * ldd + 16 * j, acc, ldd,
                            wmma::mem_row_major);
  }
}

// dst[T, T] (f32) = a[T, D] . b[T, D]^T with both bf16 row-major (stride ld).
template <int T>
__device__ void tt_product(float* dst, int ldd, const bf16* a, const bf16* b,
                           int ld, int D, int warp) {
  constexpr int MT = T / 16;
  for (int t = warp; t < MT * MT; t += kHeadWarps) {
    const int mi = t / MT, ni = t % MT;
    AccFrag acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < D; k0 += 16) {
      AFrag fa;
      BColFrag fb;
      wmma::load_matrix_sync(fa, a + 16 * mi * ld + k0, ld);
      wmma::load_matrix_sync(fb, b + 16 * ni * ld + k0, ld);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(dst + 16 * mi * ldd + 16 * ni, acc, ldd,
                            wmma::mem_row_major);
  }
}

// dst[T, D] (f32) = P . Bm where P [T, T] bf16 (row stride ldp; transposed
// when `trans`) and Bm [T, D] bf16 row-major (stride ld).
template <int T>
__device__ void td_product(float* dst, int ldd, const bf16* P, int ldp,
                           bool trans, const bf16* Bm, int ld, int D,
                           int warp) {
  constexpr int MT = T / 16;
  const int nd = D / 16;
  for (int t = warp; t < MT * nd; t += kHeadWarps) {
    const int mi = t / nd, nj = t % nd;
    AccFrag acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < T; k0 += 16) {
      BRowFrag fb;
      wmma::load_matrix_sync(fb, Bm + k0 * ld + 16 * nj, ld);
      if (trans) {
        AColFrag fa;
        wmma::load_matrix_sync(fa, P + k0 * ldp + 16 * mi, ldp);
        wmma::mma_sync(acc, fa, fb, acc);
      } else {
        AFrag fa;
        wmma::load_matrix_sync(fa, P + 16 * mi * ldp + k0, ldp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(dst + 16 * mi * ldd + 16 * nj, acc, ldd,
                            wmma::mem_row_major);
  }
}

// Row softmax of the masked, scaled logits (one warp per row): p (f32 and
// bf16) from dots; a window without keys gets p = 0.
template <int T>
__device__ void softmax_rows(float* pf, bf16* pb, const float* dots, int ldS,
                             int ldp, const float* km, float scale,
                             bool has_key, int warp, int lane) {
  for (int i = warp; i < T; i += kHeadWarps) {
    float l[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      l[u] = j < T ? (km[j] > 0.f ? dots[i * ldS + j] * scale : -30000.f)
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
      if (j < T) {
        pf[i * ldS + j] = e[u] * inv;
        pb[i * ldp + j] = __float2bfloat16(e[u] * inv);
      }
    }
  }
}

template <int T>
struct HeadSmem {
  static constexpr int ldh = 32 + 8;  // bf16 head rows (D <= 32)
  static constexpr int ldS = (T > 32 ? T : 32) + 4;
  static constexpr int ldp = T + 8;
  static constexpr size_t head_tile = (size_t)T * ldh * sizeof(bf16);
  static constexpr size_t s_tile = (size_t)T * ldS * sizeof(float);
  static constexpr size_t p_tile = (size_t)T * ldp * sizeof(bf16);
  static constexpr size_t bytes =
      4 * head_tile + 3 * s_tile + 2 * p_tile + 2 * T * sizeof(float) + 64;
};

// ---------------------------------------------------------------------------
// P1: attention forward per (window, head)
// ---------------------------------------------------------------------------

template <int T>
__global__ void __launch_bounds__(kHeadWarps * 32)
    attn_fwd_kernel(const BwdParams p) {
  using L = HeadSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qh = reinterpret_cast<bf16*>(smem);
  bf16* kh = reinterpret_cast<bf16*>(smem + L::head_tile);
  bf16* vh = reinterpret_cast<bf16*>(smem + 2 * L::head_tile);
  float* S1 = reinterpret_cast<float*>(smem + 4 * L::head_tile);
  float* S2 = reinterpret_cast<float*>(smem + 4 * L::head_tile + L::s_tile);
  float* S3 = reinterpret_cast<float*>(smem + 4 * L::head_tile + 2 * L::s_tile);
  bf16* pb = reinterpret_cast<bf16*>(smem + 4 * L::head_tile + 3 * L::s_tile);
  float* km_s = reinterpret_cast<float*>(smem + 4 * L::head_tile +
                                         3 * L::s_tile + 2 * L::p_tile);
  const int n = blockIdx.x, h = blockIdx.y;
  const int C = p.C, D = p.D, H = p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long r0 = (long long)n * T;
  constexpr int ldh = L::ldh, ldS = L::ldS;

  for (int i = tid; i < T; i += blockDim.x)
    km_s[i] = p.cross ? p.kmask[r0 + i] : p.qmask[r0 + i];
  const int has_key = __syncthreads_or(tid < T && (p.cross ? p.kmask[r0 + tid]
                                                           : p.qmask[r0 + tid]) > 0.f);
  const float scale = 1.f / fmaxf(p.tau[0], p.tau_min);

  // q, k, v of this head (f32, before bias) into S1, S2, S3 ([T, D] at ldS)
  head_proj<T>(S1, ldS, p.XP + r0 * C, C, p.wq, h, D, warp);
  head_proj<T>(S2, ldS, p.KVP + r0 * C, C, p.wk, h, D, warp);
  head_proj<T>(S3, ldS, p.KV + r0 * C, C, p.wv, h, D, warp);
  __syncthreads();
  // normalise q, k per row (thread per row); bias v
  for (int i = tid; i < 2 * T; i += blockDim.x) {
    const bool isq = i < T;
    const int t = isq ? i : i - T;
    float* src = (isq ? S1 : S2) + t * ldS;
    const float* bias = (isq ? p.bq : p.bk) + h * D;
    float ss = 0.f;
    for (int d = 0; d < D; ++d) {
      const float v = src[d] + bias[d];
      src[d] = v;
      ss += v * v;
    }
    const float rs = rsqrtf(ss + 1e-24f);
    float* nrm = (isq ? p.QN : p.KN) + (r0 + t) * C + h * D;
    bf16* hb = (isq ? qh : kh) + t * ldh;
    for (int d = 0; d < D; ++d) {
      const float v = src[d] * rs;
      nrm[d] = v;
      hb[d] = __float2bfloat16(v);
    }
    (isq ? p.RQ : p.RK)[(r0 + t) * H + h] = rs;
  }
  for (int e = tid; e < T * D; e += blockDim.x) {
    const int t = e / D, d = e - t * D;
    const bf16 v = __float2bfloat16(S3[t * ldS + d] + p.bv[h * D + d]);
    vh[t * ldh + d] = v;
    p.V[(r0 + t) * C + h * D + d] = v;
  }
  __syncthreads();
  // dots, softmax, attention output of this head
  tt_product<T>(S1, ldS, qh, kh, ldh, D, warp);
  __syncthreads();
  softmax_rows<T>(S2, pb, S1, ldS, L::ldp, km_s, scale, has_key, warp, lane);
  __syncthreads();
  td_product<T>(S3, ldS, pb, L::ldp, false, vh, ldh, D, warp);
  __syncthreads();
  for (int e = tid; e < T * D; e += blockDim.x) {
    const int t = e / D, d = e - t * D;
    p.A[(r0 + t) * C + h * D + d] = __float2bfloat16(S3[t * ldS + d]);
  }
}

// ---------------------------------------------------------------------------
// P3: attention backward per (window, head)
// ---------------------------------------------------------------------------

template <int T>
__global__ void __launch_bounds__(kHeadWarps * 32)
    attn_bwd_kernel(const BwdParams p) {
  using L = HeadSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qh = reinterpret_cast<bf16*>(smem);
  bf16* kh = reinterpret_cast<bf16*>(smem + L::head_tile);
  bf16* vh = reinterpret_cast<bf16*>(smem + 2 * L::head_tile);
  bf16* dah = reinterpret_cast<bf16*>(smem + 3 * L::head_tile);
  float* S1 = reinterpret_cast<float*>(smem + 4 * L::head_tile);
  float* S2 = reinterpret_cast<float*>(smem + 4 * L::head_tile + L::s_tile);
  float* S3 = reinterpret_cast<float*>(smem + 4 * L::head_tile + 2 * L::s_tile);
  bf16* pb = reinterpret_cast<bf16*>(smem + 4 * L::head_tile + 3 * L::s_tile);
  bf16* dsb = pb + T * L::ldp;
  float* km_s = reinterpret_cast<float*>(smem + 4 * L::head_tile +
                                         3 * L::s_tile + 2 * L::p_tile);
  float* red = km_s + T;  // kHeadWarps partial dtau sums
  const int n = blockIdx.x, h = blockIdx.y;
  const int C = p.C, D = p.D, H = p.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long r0 = (long long)n * T;
  constexpr int ldh = L::ldh, ldS = L::ldS, ldp = L::ldp;

  for (int i = tid; i < T; i += blockDim.x)
    km_s[i] = p.cross ? p.kmask[r0 + i] : p.qmask[r0 + i];
  const int has_key = __syncthreads_or(tid < T && (p.cross ? p.kmask[r0 + tid]
                                                           : p.qmask[r0 + tid]) > 0.f);
  const float scale = 1.f / fmaxf(p.tau[0], p.tau_min);
  for (int e = tid; e < T * D; e += blockDim.x) {
    const int t = e / D, d = e - t * D;
    const long long off = (r0 + t) * C + h * D + d;
    qh[t * ldh + d] = __float2bfloat16(p.QN[off]);
    kh[t * ldh + d] = __float2bfloat16(p.KN[off]);
    vh[t * ldh + d] = p.V[off];
    dah[t * ldh + d] = p.DA[off];
  }
  __syncthreads();
  tt_product<T>(S1, ldS, qh, kh, ldh, D, warp);    // dots
  tt_product<T>(S3, ldS, dah, vh, ldh, D, warp);   // dp
  __syncthreads();
  softmax_rows<T>(S2, pb, S1, ldS, ldp, km_s, scale, has_key, warp, lane);
  __syncwarp();
  // ds = p * (dp - sum(dp * p)); dtau partial sum(ds * dots)
  float tau_part = 0.f;
  for (int i = warp; i < T; i += kHeadWarps) {
    float pv[2], dp[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      pv[u] = j < T ? S2[i * ldS + j] : 0.f;
      dp[u] = j < T ? S3[i * ldS + j] : 0.f;
    }
    const float sdp = warp_sum(pv[0] * dp[0] + pv[1] * dp[1]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      if (j < T) {
        const float ds = pv[u] * (dp[u] - sdp);
        tau_part += ds * S1[i * ldS + j];
        dsb[i * ldp + j] = __float2bfloat16(ds);
      }
    }
  }
  tau_part = warp_sum(tau_part);
  if (lane == 0) red[warp] = tau_part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kHeadWarps; ++w) s += red[w];
    p.PT[(long long)n * H + h] = s;
  }
  // dv = p^T da (S2), dqn = ds kn (S3), dkn = ds^T qn (S1); S* are free now
  td_product<T>(S2, ldS, pb, ldp, true, dah, ldh, D, warp);
  td_product<T>(S3, ldS, dsb, ldp, false, kh, ldh, D, warp);
  td_product<T>(S1, ldS, dsb, ldp, true, qh, ldh, D, warp);
  __syncthreads();
  // normalisation backward, one thread per (q or k) row
  for (int i = tid; i < 2 * T; i += blockDim.x) {
    const bool isq = i < T;
    const int t = isq ? i : i - T;
    float* dn = (isq ? S3 : S1) + t * ldS;
    const float* nrm = (isq ? p.QN : p.KN) + (r0 + t) * C + h * D;
    const float rs = (isq ? p.RQ : p.RK)[(r0 + t) * H + h];
    float sdot = 0.f;
    for (int d = 0; d < D; ++d) {
      dn[d] *= scale;
      sdot += dn[d] * nrm[d];
    }
    bf16* out = (isq ? p.DQ : p.DK) + (r0 + t) * C + h * D;
    for (int d = 0; d < D; ++d) {
      const float v = rs * (dn[d] - nrm[d] * sdot);
      dn[d] = v;
      out[d] = __float2bfloat16(v);
    }
  }
  for (int e = tid; e < T * D; e += blockDim.x) {
    const int t = e / D, d = e - t * D;
    p.DV[(r0 + t) * C + h * D + d] = __float2bfloat16(S2[t * ldS + d]);
  }
  __syncthreads();
  // bias partials: column sums in fixed row order
  for (int e = tid; e < 3 * D; e += blockDim.x) {
    const int which = e / D, d = e - which * D;  // 0 dbq, 1 dbk, 2 dbv
    const float* src = which == 0 ? S3 : (which == 1 ? S1 : S2);
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += src[t * ldS + d];
    p.PV3[(long long)n * 3 * C + which * C + h * D + d] = s;
  }
}

// ---------------------------------------------------------------------------
// P2: rows forward (output projection, LN1, FFN, LN2) and backward to da
// ---------------------------------------------------------------------------

constexpr int kRowWarps = 8;
constexpr int kRowThreads = kRowWarps * 32;

struct RowSmem {
  int ldf, ldb, ldh;
  size_t acc, hb, db, hid, st, red, small, total;
  __host__ __device__ RowSmem(int C) {
    ldf = C + 4;
    ldb = C + 8;
    ldh = kFC + 8;
    acc = (size_t)kRowTile * ldf * 4;
    hb = (size_t)kRowTile * ldb * 2;
    db = hb;
    hid = (size_t)kRowTile * ldh * 2;
    st = (size_t)kRowWarps * 2 * 16 * kStLd * 4;
    red = (size_t)kRowWarps * C * 4;
    small = 3 * kRowTile * 4;
    total = acc + hb + db + hid + st + red + small;
  }
};

// Per-column sums over the rows each warp handled (v[u] is column
// lane + 32u), reduced across warps in fixed order into dst[c].
__device__ void reduce_cols(float* red, const float (&v)[kMaxC / 32], int nc,
                            int C, float* dst, int warp, int lane) {
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kMaxC / 32; ++u)
    if (u < nc) red[warp * C + lane + 32 * u] = v[u];
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kRowThreads) {
    float s = 0.f;
    for (int w = 0; w < kRowWarps; ++w) s += red[w * C + c];
    dst[c] = s;
  }
}

__device__ __forceinline__ void ln_stats(const float (&v)[kMaxC / 32], int nc,
                                         int C, float& mu, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxC / 32; ++u)
    if (u < nc) s += v[u];
  mu = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxC / 32; ++u)
    if (u < nc) {
      const float d = v[u] - mu;
      q += d * d;
    }
  rstd = rsqrtf(warp_sum(q) / C + 1e-5f);
}

// LayerNorm backward of one row: g, xhat per lane (columns lane + 32u).
__device__ __forceinline__ void ln_bwd_row(float (&out)[kMaxC / 32],
                                           const float (&g)[kMaxC / 32],
                                           const float (&xh)[kMaxC / 32],
                                           const float* scale, float inv,
                                           int nc, int C, int lane) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxC / 32; ++u)
    if (u < nc) {
      const float gs = g[u] * scale[lane + 32 * u];
      s1 += gs;
      s2 += gs * xh[u];
    }
  const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
  for (int u = 0; u < kMaxC / 32; ++u)
    if (u < nc) {
      const float gs = g[u] * scale[lane + 32 * u];
      out[u] = inv * (gs - m1 - xh[u] * m2);
    }
}

__global__ void __launch_bounds__(kRowThreads) rows_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C, F = p.F, nc = C / 32;
  const RowSmem L(C);
  float* acc = reinterpret_cast<float*>(smem);
  bf16* hb = reinterpret_cast<bf16*>(smem + L.acc);
  bf16* db = reinterpret_cast<bf16*>(smem + L.acc + L.hb);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.acc + L.hb + L.db);
  float* st_all = reinterpret_cast<float*>(smem + L.acc + L.hb + L.db + L.hid);
  float* red = reinterpret_cast<float*>(smem + L.acc + L.hb + L.db + L.hid +
                                        L.st);
  float* qm_s = red + kRowWarps * C;
  float* inv1_s = qm_s + kRowTile;
  const int ldf = L.ldf, ldb = L.ldb, ldh = L.ldh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* st = st_all + warp * 2 * 16 * kStLd;
  float* st2 = st + 16 * kStLd;
  const long long r0 = (long long)blockIdx.x * kRowTile;
  const int nvalid = (int)min((long long)kRowTile, p.R - r0);
  float* pv = p.PV2 + (long long)blockIdx.x * (6 * C + F);
  const int rr = lane >> 1, c0 = (lane & 1) * 8;

  for (int i = tid; i < kRowTile; i += kRowThreads)
    qm_s[i] = i < nvalid ? p.qmask[r0 + i] : 0.f;

  // (a) attn = A Wo^T; z1 = x + qm * (attn + bo); LN1 -> h1
  for (int s = warp; s < C / 16; s += kRowWarps) {
    AccFrag a4[4][2];
    zero_acc<4>(a4);
    gemm_rows<4>(a4, 1, p.A + r0 * C, C, p.wo, C, 16 * s, C);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      wmma::store_matrix_sync(acc + 16 * m * ldf + 16 * s, a4[m][0], ldf,
                              wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = warp; i < nvalid; i += kRowWarps) {
    const long long r = r0 + i;
    const bool occ = qm_s[i] > 0.f;
    float v[kMaxC / 32];
#pragma unroll
    for (int u = 0; u < kMaxC / 32; ++u)
      if (u < nc) {
        const int c = lane + 32 * u;
        const float x = __bfloat162float(p.X[r * C + c]);
        v[u] = x + (occ ? acc[i * ldf + c] + p.bo[c] : 0.f);
      }
    float mu, rstd;
    ln_stats(v, nc, C, mu, rstd);
#pragma unroll
    for (int u = 0; u < kMaxC / 32; ++u)
      if (u < nc) {
        const int c = lane + 32 * u;
        const float xh = (v[u] - mu) * rstd;
        p.X1H[r * C + c] = xh;
        const float h1 = occ ? xh * p.ln1s[c] + p.ln1b[c] : 0.f;
        acc[i * ldf + c] = h1;
        const bf16 hbv = __float2bfloat16(h1);
        hb[i * ldb + c] = hbv;
        p.H1[r * C + c] = hbv;
      }
    if (lane == 0) inv1_s[i] = rstd;
  }
  __syncthreads();

  // (b) FFN forward: acc = h1 + sum_chunks gelu(h1 W1^T + b1) W2^T
  for (int f0 = 0; f0 < F; f0 += kFC) {
    for (int s = warp; s < kFC / 16; s += kRowWarps) {
      AccFrag a4[4][2];
      zero_acc<4>(a4);
      gemm_rows<4>(a4, 1, hb, ldb, p.w1, C, f0 + 16 * s, C);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        wmma::store_matrix_sync(st, a4[m][0], kStLd, wmma::mem_row_major);
        __syncwarp();
        const int i = 16 * m + rr;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int f = f0 + 16 * s + c0 + c;
          const bf16 gv =
              __float2bfloat16(gelu_exact(st[rr * kStLd + c0 + c] + p.b1[f]));
          hid[i * ldh + 16 * s + c0 + c] = gv;
          if (i < nvalid) p.GG[(r0 + i) * F + f] = gv;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int s = warp; s < C / 16; s += kRowWarps) {
      AccFrag a4[4][2];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        wmma::load_matrix_sync(a4[m][0], acc + 16 * m * ldf + 16 * s, ldf,
                               wmma::mem_row_major);
      gemm_rows<4>(a4, 1, hid, ldh, p.w2 + f0, F, 16 * s, kFC);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        wmma::store_matrix_sync(acc + 16 * m * ldf + 16 * s, a4[m][0], ldf,
                                wmma::mem_row_major);
    }
    __syncthreads();
  }

  // (c) LN2 forward and backward: dz2 into acc (f32) and db (bf16)
  {
    float s_ln2s[kMaxC / 32], s_ln2b[kMaxC / 32], s_b2[kMaxC / 32];
#pragma unroll
    for (int u = 0; u < kMaxC / 32; ++u) s_ln2s[u] = s_ln2b[u] = s_b2[u] = 0.f;
    for (int i = warp; i < kRowTile; i += kRowWarps) {
      if (i >= nvalid) {  // padding rows: zero operands for the GEMMs below
#pragma unroll
        for (int u = 0; u < kMaxC / 32; ++u)
          if (u < nc) {
            acc[i * ldf + lane + 32 * u] = 0.f;
            db[i * ldb + lane + 32 * u] = __float2bfloat16(0.f);
          }
        continue;
      }
      const long long r = r0 + i;
      const bool occ = qm_s[i] > 0.f;
      float v[kMaxC / 32], xh[kMaxC / 32], go[kMaxC / 32], dz[kMaxC / 32];
#pragma unroll
      for (int u = 0; u < kMaxC / 32; ++u)
        if (u < nc) {
          const int c = lane + 32 * u;
          v[u] = acc[i * ldf + c] + p.b2[c];
          go[u] = occ ? __bfloat162float(p.G[r * C + c]) : 0.f;
        }
      float mu, rstd;
      ln_stats(v, nc, C, mu, rstd);
#pragma unroll
      for (int u = 0; u < kMaxC / 32; ++u)
        if (u < nc) {
          xh[u] = (v[u] - mu) * rstd;
          s_ln2s[u] += go[u] * xh[u];
          s_ln2b[u] += go[u];
        }
      ln_bwd_row(dz, go, xh, p.ln2s, rstd, nc, C, lane);
#pragma unroll
      for (int u = 0; u < kMaxC / 32; ++u)
        if (u < nc) {
          const int c = lane + 32 * u;
          s_b2[u] += dz[u];
          acc[i * ldf + c] = dz[u];
          const bf16 d = __float2bfloat16(dz[u]);
          db[i * ldb + c] = d;
          p.DZ2[r * C + c] = d;
        }
    }
    reduce_cols(red, s_ln2s, nc, C, pv + 0 * C, warp, lane);
    reduce_cols(red, s_ln2b, nc, C, pv + 1 * C, warp, lane);
    reduce_cols(red, s_b2, nc, C, pv + 2 * C, warp, lane);
  }
  __syncthreads();

  // (d) FFN backward: dff1 = (dz2 W2) * gelu'(h1 W1^T + b1); acc += dff1 W1
  for (int f0 = 0; f0 < F; f0 += kFC) {
    for (int s = warp; s < kFC / 16; s += kRowWarps) {
      AccFrag au[4][2], ag[4][2];
      zero_acc<4>(au);
      zero_acc<4>(ag);
      gemm_rows<4>(au, 1, hb, ldb, p.w1, C, f0 + 16 * s, C);
      gemm_rows_rm<4>(ag, 1, db, ldb, p.w2, F, f0 + 16 * s, C);
      float colsum[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) colsum[c] = 0.f;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        wmma::store_matrix_sync(st, au[m][0], kStLd, wmma::mem_row_major);
        wmma::store_matrix_sync(st2, ag[m][0], kStLd, wmma::mem_row_major);
        __syncwarp();
        const int i = 16 * m + rr;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int f = f0 + 16 * s + c0 + c;
          const float u = st[rr * kStLd + c0 + c] + p.b1[f];
          const float d = i < nvalid ? st2[rr * kStLd + c0 + c] * gelu_grad(u)
                                     : 0.f;
          const bf16 dbf = __float2bfloat16(d);
          hid[i * ldh + 16 * s + c0 + c] = dbf;
          if (i < nvalid) p.DFF1[(r0 + i) * F + f] = dbf;
          colsum[c] += d;
        }
        __syncwarp();
      }
      // lanes with equal (lane & 1) hold the same 8 columns
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float v = colsum[c];
        for (int o = 2; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        colsum[c] = v;
      }
      if (lane < 2) {
#pragma unroll
        for (int c = 0; c < 8; ++c) pv[6 * C + f0 + 16 * s + c0 + c] = colsum[c];
      }
    }
    __syncthreads();
    for (int s = warp; s < C / 16; s += kRowWarps) {
      AccFrag a4[4][2];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        wmma::load_matrix_sync(a4[m][0], acc + 16 * m * ldf + 16 * s, ldf,
                               wmma::mem_row_major);
      gemm_rows_rm<4>(a4, 1, hid, ldh, p.w1 + (long long)f0 * C, C, 16 * s,
                      kFC);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        wmma::store_matrix_sync(acc + 16 * m * ldf + 16 * s, a4[m][0], ldf,
                                wmma::mem_row_major);
    }
    __syncthreads();
  }

  // (e) LN1 backward: dh1 = qm * acc; dz1; dattn = qm * dz1 into hb
  {
    float s_ln1s[kMaxC / 32], s_ln1b[kMaxC / 32], s_bo[kMaxC / 32];
#pragma unroll
    for (int u = 0; u < kMaxC / 32; ++u) s_ln1s[u] = s_ln1b[u] = s_bo[u] = 0.f;
    for (int i = warp; i < kRowTile; i += kRowWarps) {
      if (i >= nvalid) {
#pragma unroll
        for (int u = 0; u < kMaxC / 32; ++u)
          if (u < nc) hb[i * ldb + lane + 32 * u] = __float2bfloat16(0.f);
        continue;
      }
      const long long r = r0 + i;
      const bool occ = qm_s[i] > 0.f;
      float dh[kMaxC / 32], xh[kMaxC / 32], dz[kMaxC / 32];
#pragma unroll
      for (int u = 0; u < kMaxC / 32; ++u)
        if (u < nc) {
          const int c = lane + 32 * u;
          dh[u] = occ ? acc[i * ldf + c] : 0.f;
          xh[u] = p.X1H[r * C + c];
          s_ln1s[u] += dh[u] * xh[u];
          s_ln1b[u] += dh[u];
        }
      ln_bwd_row(dz, dh, xh, p.ln1s, inv1_s[i], nc, C, lane);
#pragma unroll
      for (int u = 0; u < kMaxC / 32; ++u)
        if (u < nc) {
          const int c = lane + 32 * u;
          p.DZ1[r * C + c] = dz[u];
          const float da = occ ? dz[u] : 0.f;
          s_bo[u] += da;
          const bf16 d = __float2bfloat16(da);
          hb[i * ldb + c] = d;
          p.DATT[r * C + c] = d;
        }
    }
    reduce_cols(red, s_ln1s, nc, C, pv + 3 * C, warp, lane);
    reduce_cols(red, s_ln1b, nc, C, pv + 4 * C, warp, lane);
    reduce_cols(red, s_bo, nc, C, pv + 5 * C, warp, lane);
  }
  __syncthreads();

  // (f) da = dattn Wo
  for (int s = warp; s < C / 16; s += kRowWarps) {
    AccFrag a4[4][2];
    zero_acc<4>(a4);
    gemm_rows_rm<4>(a4, 1, hb, ldb, p.wo, C, 16 * s, C);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wmma::store_matrix_sync(st, a4[m][0], kStLd, wmma::mem_row_major);
      __syncwarp();
      const int i = 16 * m + rr;
      if (i < nvalid)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          p.DA[(r0 + i) * C + 16 * s + c0 + c] =
              __float2bfloat16(st[rr * kStLd + c0 + c]);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// P4: dx, dkv through the projections
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kRowThreads) out_rows_kernel(const BwdParams p) {
  __shared__ __align__(128) float st_all[kRowWarps * 16 * kStLd];
  __shared__ float qm_s[kRowTile];
  const int C = p.C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* st = st_all + warp * 16 * kStLd;
  const long long r0 = (long long)blockIdx.x * kRowTile;
  const int nvalid = (int)min((long long)kRowTile, p.R - r0);
  const int rr = lane >> 1, c0 = (lane & 1) * 8;
  const bool sel = p.selq != nullptr;
  for (int i = tid; i < kRowTile; i += kRowThreads)
    qm_s[i] = i < nvalid ? p.qmask[r0 + i] : 0.f;
  __syncthreads();

  // emit(kind, a4): 0 = dx rows, 1 = dkv rows, 2 = DP store, 3 = DP add
  auto emit = [&](int kind, AccFrag (&a4)[4][2], int s) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wmma::store_matrix_sync(st, a4[m][0], kStLd, wmma::mem_row_major);
      __syncwarp();
      const int i = 16 * m + rr;
      if (i < nvalid) {
        const long long r = r0 + i;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = 16 * s + c0 + c;
          const long long o = r * C + col;
          const float v = st[rr * kStLd + c0 + c];
          if (kind == 0) {
            float d = p.DZ1[o] + v;
            if (sel && qm_s[i] > 0.f) d -= __bfloat162float(p.G[o]);
            if (sel) p.DX16[o] = d;
            else p.dx[o] = __float2bfloat16(d);
          } else if (kind == 1) {
            if (sel) p.DKV16[o] = v;
            else p.dkv[o] = __float2bfloat16(v);
          } else if (kind == 2) {
            p.DP[o] = v;
          } else {
            p.DP[o] += v;
          }
        }
      }
      __syncwarp();
    }
  };

  for (int s = warp; s < C / 16; s += kRowWarps) {
    AccFrag a4[4][2];
    zero_acc<4>(a4);
    gemm_rows_rm<4>(a4, 1, p.DQ + r0 * C, C, p.wq, C, 16 * s, C);
    if (!p.cross) {
      gemm_rows_rm<4>(a4, 1, p.DK + r0 * C, C, p.wk, C, 16 * s, C);
      if (p.DP) emit(2, a4, s);
      gemm_rows_rm<4>(a4, 1, p.DV + r0 * C, C, p.wv, C, 16 * s, C);
      emit(0, a4, s);
    } else {
      if (p.DP) emit(2, a4, s);
      emit(0, a4, s);
      zero_acc<4>(a4);
      gemm_rows_rm<4>(a4, 1, p.DK + r0 * C, C, p.wk, C, 16 * s, C);
      if (p.DP) emit(3, a4, s);
      gemm_rows_rm<4>(a4, 1, p.DV + r0 * C, C, p.wv, C, 16 * s, C);
      emit(1, a4, s);
    }
  }
}

// P4b (K9): dx[cell] = g[cell] + sum of DX16 over the slots selecting cell;
// dkv[cell] = sum of DKV16 over the key slots selecting cell (cross).
__global__ void expand_kernel(const BwdParams p) {
  __shared__ unsigned long long qbits[kCells], kbits[kCells];
  const int n = blockIdx.x, T = p.T, C = p.C;
  const long long r0 = (long long)n * T;
  if (threadIdx.x < kCells) {
    unsigned long long qb = 0, kb = 0;
    for (int s = 0; s < T; ++s) {
      if (clamp_cell(p.selq[r0 + s]) == (int)threadIdx.x) qb |= 1ull << s;
      if (p.cross && clamp_cell(p.selk[r0 + s]) == (int)threadIdx.x)
        kb |= 1ull << s;
    }
    qbits[threadIdx.x] = qb;
    kbits[threadIdx.x] = kb;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kCells * C; e += blockDim.x) {
    const int cell = e / C, c = e - cell * C;
    const long long o = ((long long)n * kCells + cell) * C + c;
    float d = __bfloat162float(p.g[o]);
    for (unsigned long long b = qbits[cell]; b; b &= b - 1)
      d += p.DX16[(r0 + __ffsll(b) - 1) * C + c];
    p.dx[o] = __float2bfloat16(d);
    if (p.cross) {
      float k = 0.f;
      for (unsigned long long b = kbits[cell]; b; b &= b - 1)
        k += p.DKV16[(r0 + __ffsll(b) - 1) * C + c];
      p.dkv[o] = __float2bfloat16(k);
    }
  }
}

// ---------------------------------------------------------------------------
// P5 / P6: weight gradients and fixed-order sums
// ---------------------------------------------------------------------------

// part[split][m][n] = sum over rows r of chunk `split` of Y[r][m] * X[r][n];
// Y [R, M], X [R, N] bf16 row-major, M and N multiples of 64. One block per
// 64 x 64 output tile and row chunk; warp w owns rows 16 (w / 2) and columns
// 32 (w % 2) of the tile.
__global__ void __launch_bounds__(256) wgrad_kernel(const bf16* Y, int M,
                                                    const bf16* X, int N,
                                                    int R, int chunk,
                                                    float* part) {
  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.y * 64 + 16 * (warp / 2);
  const int n0 = blockIdx.x * 64 + 32 * (warp % 2);
  const int split = blockIdx.z;
  const int lo = split * chunk, hi = min(R, lo + chunk);
  AccFrag acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int r = lo; r < hi; r += 16) {
    AColFrag a;
    wmma::load_matrix_sync(a, Y + (long long)r * M + m0, M);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      BRowFrag b;
      wmma::load_matrix_sync(b, X + (long long)r * N + n0 + 16 * j, N);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
  float* out = part + (long long)split * M * N;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(out + (long long)m0 * N + n0 + 16 * j, acc[j], N,
                            wmma::mem_row_major);
}

// out[j] = sum over i < rows of in[i * ld + j], in order of i.
__global__ void colsum_kernel(const float* in, int rows, long long ld,
                              int ncols, float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ncols) return;
  float s = 0.f;
  for (int i = 0; i < rows; ++i) s += in[(long long)i * ld + j];
  out[j] = s;
}

// dtau = -sum(partials) / tau^2 when tau > tau_min, else 0 (fixed order).
__global__ void dtau_kernel(const float* part, int count, const float* tau,
                            float tau_min, float* out) {
  __shared__ float red[256];
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += 256) s += part[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float t = tau[0];
    out[0] = t > tau_min ? -red[0] / (t * t) : 0.f;
  }
}

int colsum(const float* in, int rows, long long ld, int ncols, float* out,
           cudaStream_t s) {
  colsum_kernel<<<(ncols + 255) / 256, 256, 0, s>>>(in, rows, ld, ncols, out);
  return tmae_last_error();
}

int wgrad(const bf16* Y, int M, const bf16* X, int N, int R, int chunk,
          int splits, float* part, float* out, cudaStream_t s) {
  wgrad_kernel<<<dim3(N / 64, M / 64, splits), 256, 0, s>>>(Y, M, X, N, R,
                                                             chunk, part);
  int e = tmae_last_error();
  if (e) return e;
  return colsum(part, splits, (long long)M * N, M * N, out, s);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int T>
int launch_heads(const BwdParams& p, bool forward, cudaStream_t s) {
  const size_t bytes = HeadSmem<T>::bytes;
  if (forward) {
    int e = set_smem(attn_fwd_kernel<T>, bytes);
    if (e) return e;
    attn_fwd_kernel<T><<<dim3(p.N, p.H), kHeadWarps * 32, bytes, s>>>(p);
  } else {
    int e = set_smem(attn_bwd_kernel<T>, bytes);
    if (e) return e;
    attn_bwd_kernel<T><<<dim3(p.N, p.H), kHeadWarps * 32, bytes, s>>>(p);
  }
  return tmae_last_error();
}

int launch_heads_t(const BwdParams& p, bool forward, cudaStream_t s) {
  switch (p.T) {
    case 16: return launch_heads<16>(p, forward, s);
    case 48: return launch_heads<48>(p, forward, s);
    case 64: return launch_heads<64>(p, forward, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// in:  x kv g pos selq selk qmask kmask
// w:   wq bq wk bk wv bv wo bo tau ln1s ln1b w1 b1 w2 b2 ln2s ln2b
// ws:  X XP G KV KVP V A H1 GG DZ2 DFF1 DATT DA DQ DK DV (bf16)
//      QN KN RQ RK X1H DZ1 DX16 DKV16 DP PV2 PV3 PT WPART (f32)
// out: dx dkv dpos, then the 17 gradients in the order of w
int launch_bwd(const void* const* in, const void* const* w, void* const* ws,
               void* const* out, int N, int T, int C, int F, int H, int cross,
               float tau_min, int splits, cudaStream_t s) {
  if (H <= 0 || C % H || C % 64 || C > kMaxC || F % kFC || N <= 0)
    return (int)cudaErrorInvalidValue;
  const int D = C / H;
  if (D != 16 && D != 32) return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.x = static_cast<const bf16*>(in[0]);
  p.kv = static_cast<const bf16*>(in[1]);
  p.g = static_cast<const bf16*>(in[2]);
  p.pos = static_cast<const bf16*>(in[3]);
  p.selq = static_cast<const int*>(in[4]);
  p.selk = static_cast<const int*>(in[5]);
  p.qmask = static_cast<const float*>(in[6]);
  p.kmask = static_cast<const float*>(in[7]);
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
  p.N = N;
  p.T = T;
  p.C = C;
  p.F = F;
  p.H = H;
  p.D = D;
  p.cross = cross;
  p.R = N * T;
  p.tau_min = tau_min;
  bf16* const* wb = reinterpret_cast<bf16* const*>(ws);
  p.X = wb[0];
  p.XP = wb[1];
  p.G = wb[2];
  p.KV = cross ? wb[3] : wb[0];
  p.KVP = cross ? wb[4] : wb[1];
  p.V = wb[5];
  p.A = wb[6];
  p.H1 = wb[7];
  p.GG = wb[8];
  p.DZ2 = wb[9];
  p.DFF1 = wb[10];
  p.DATT = wb[11];
  p.DA = wb[12];
  p.DQ = wb[13];
  p.DK = wb[14];
  p.DV = wb[15];
  float* const* wf = reinterpret_cast<float* const*>(ws + 16);
  p.QN = wf[0];
  p.KN = wf[1];
  p.RQ = wf[2];
  p.RK = wf[3];
  p.X1H = wf[4];
  p.DZ1 = wf[5];
  p.DX16 = wf[6];
  p.DKV16 = wf[7];
  p.DP = wf[8];
  p.PV2 = wf[9];
  p.PV3 = wf[10];
  p.PT = wf[11];
  float* wpart = wf[12];
  p.dx = static_cast<bf16*>(out[0]);
  p.dkv = static_cast<bf16*>(out[1]);
  float* dpos = static_cast<float*>(out[2]);
  float* const* gr = reinterpret_cast<float* const*>(out + 3);

  const int R = p.R;
  const int tiles = (R + kRowTile - 1) / kRowTile;
  const int chunk = ((R + splits - 1) / splits + 15) / 16 * 16;
  int e;
  pack_kernel<<<N, 256, 0, s>>>(p);
  if ((e = tmae_last_error())) return e;
  if ((e = launch_heads_t(p, true, s))) return e;
  const RowSmem rs(C);
  if ((e = set_smem(rows_kernel, rs.total))) return e;
  rows_kernel<<<tiles, kRowThreads, rs.total, s>>>(p);
  if ((e = tmae_last_error())) return e;
  if ((e = launch_heads_t(p, false, s))) return e;
  out_rows_kernel<<<tiles, kRowThreads, 0, s>>>(p);
  if ((e = tmae_last_error())) return e;
  if (p.selq) {
    expand_kernel<<<N, 256, 0, s>>>(p);
    if ((e = tmae_last_error())) return e;
  }
  // weight gradients in the layout of the weights ([out, in])
  const bf16* KVP = p.KVP;
  const bf16* KV = p.KV;
  if ((e = wgrad(p.DQ, C, p.XP, C, R, chunk, splits, wpart, gr[0], s))) return e;
  if ((e = wgrad(p.DK, C, KVP, C, R, chunk, splits, wpart, gr[2], s))) return e;
  if ((e = wgrad(p.DV, C, KV, C, R, chunk, splits, wpart, gr[4], s))) return e;
  if ((e = wgrad(p.DATT, C, p.A, C, R, chunk, splits, wpart, gr[6], s))) return e;
  if ((e = wgrad(p.DFF1, F, p.H1, C, R, chunk, splits, wpart, gr[11], s))) return e;
  if ((e = wgrad(p.DZ2, C, p.GG, F, R, chunk, splits, wpart, gr[13], s))) return e;
  // vector gradients: PV2 = [ln2s ln2b b2 ln1s ln1b bo | b1], PV3 = [bq bk bv]
  const long long ld2 = 6LL * C + F;
  const int seg2[6] = {15, 16, 14, 9, 10, 7};
  for (int k = 0; k < 6; ++k)
    if ((e = colsum(p.PV2 + k * C, tiles, ld2, C, gr[seg2[k]], s))) return e;
  if ((e = colsum(p.PV2 + 6 * C, tiles, ld2, F, gr[12], s))) return e;
  const int seg3[3] = {1, 3, 5};
  for (int k = 0; k < 3; ++k)
    if ((e = colsum(p.PV3 + k * C, N, 3LL * C, C, gr[seg3[k]], s))) return e;
  dtau_kernel<<<1, 256, 0, s>>>(p.PT, N * H, p.tau, tau_min, gr[8]);
  if ((e = tmae_last_error())) return e;
  if (dpos && p.DP)
    if ((e = colsum(p.DP, N, (long long)kCells * C, kCells * C, dpos, s)))
      return e;
  return 0;
}

}  // namespace

// K7: the full-window layer (T = 64). Pointer arrays as in launch_bwd; selq,
// selk may be null there. dpos (out[2]) and the DP workspace are optional.
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
