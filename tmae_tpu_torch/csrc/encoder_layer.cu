// Kernel K16: the attention stage of the cosine-attention SST encoder layer
// alone, on flat windows. The whole layer (K3, K4, K6, K8, K10, K12) runs on
// the persistent tiled kernel of encoder_layer_tiled.cu.
//
// K16 replaces tmae_tpu/ops/pallas_attn.py:_pallas_forward (kernel _kernel):
// the attention of the full-window layer on flat windows [N, 64, C] without
// the residual, LayerNorms and FFN, attn Wo + bo written on all 64 tokens of
// a window (no query mask), with the attention output rounded to bf16
// before Wo as the TPU kernel rounds it to x's dtype. A window with no key
// gets p = 0, so its output is bo on every token: its block writes bo and
// exits (most windows of a stride-1 LiDAR grid are empty). One block per
// window: the TPU kernel's 16-window tiles and their padding have no
// counterpart.
//
// Bound: operations on windows with a key (2*64*C*C*4 + 2*64*64*C*2 flops,
// ~19 MFLOP at C=128: hundreds of operations per byte of window data, above
// the card's bf16 ridge), bytes on the empty ones.
//
// Design, simple first: one block of 8 warps per window. The block reads its
// window's 64 token rows (and kv's in cross mode) into shared memory. Every
// matmul takes bf16 inputs and accumulates in f32 on the tensor cores through
// WMMA 16x16x16 fragments, as the TPU kernel feeds bf16 to the MXU with f32
// accumulation. Activations stay in shared memory in bf16 where the TPU
// kernel casts (x + pos, normalised q and k, v, p, the attention output);
// heads run one after another. Weights are read through L2 for every window,
// each warp reusing a weight fragment across all token rows.
//
// Numerics held to the TPU kernel: q = (x+pos)Wq+bq and k = (kv+pos)Wk+bk
// with x+pos rounded to bf16; per-head L2 normalisation rsqrt(sum^2+1e-24)
// in f32; logits scaled by 1/max(tau, tau_min); masked keys filled with
// -30000 before a per-head softmax; a window with no key gets p = 0.

#include "wmma_tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPadB = 8;     // bf16 row padding (elements)
constexpr int kCells = 64;   // cells (tokens) of an 8 x 8 window
constexpr int kMaxC = 256;

struct Params {
  const bf16* xw;
  bf16* out;
  const bf16* kvw;
  const float* kmask;
  const bf16* pos;
  const bf16 *wq, *wk, *wv, *wo;
  const float *bq, *bk, *bv, *bo, *tau;
  int C, H, cross;
  float tau_min;
};

// Copies the 64 token rows of a window into shared memory: `raw` gets the
// bf16 values, `with_pos` bf16(x + pos[i]). Either may be null.
__device__ __forceinline__ void load_tokens(bf16* raw, bf16* with_pos,
                                            const bf16* base,
                                            const bf16* pos, int C, int ld) {
  const int vc = C / 8;
  for (int t = threadIdx.x; t < kCells * vc; t += kThreads) {
    const int i = t / vc;
    const int v = t - i * vc;
    const uint4 x =
        *reinterpret_cast<const uint4*>(base + (long long)i * C + v * 8);
    if (raw) *reinterpret_cast<uint4*>(raw + i * ld + v * 8) = x;
    if (with_pos) {
      const uint4 ps =
          *reinterpret_cast<const uint4*>(pos + i * C + v * 8);
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

// out = attn(x) Wo + bo on every token of window blockIdx.x.
__global__ void __launch_bounds__(kThreads)
    window_attention_kernel(const Params p) {
  constexpr int T = kCells;
  constexpr int MT = T / 16;
  constexpr int ldl = T + 4;
  constexpr int ldp = T + 8;
  extern __shared__ __align__(128) unsigned char smem[];

  const int C = p.C;
  const int H = p.H;
  const int D = C / H;
  const int ldb = C + kPadB;
  const size_t buf = (size_t)T * ldb * sizeof(bf16);

  bf16* xs = reinterpret_cast<bf16*>(smem);            // raw tokens
  bf16* a0 = reinterpret_cast<bf16*>(smem + buf);      // matmul input
  bf16* qn = reinterpret_cast<bf16*>(smem + 2 * buf);
  bf16* kn = reinterpret_cast<bf16*>(smem + 3 * buf);
  bf16* vb = reinterpret_cast<bf16*>(smem + 4 * buf);
  float* lg = reinterpret_cast<float*>(smem + 5 * buf);
  bf16* pb = reinterpret_cast<bf16*>(lg + T * ldl);
  float* st_all = reinterpret_cast<float*>(pb + T * ldp);
  float* km_s = st_all + kWarps * 16 * kStLd;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* st = st_all + warp * 16 * kStLd;
  const long long win = blockIdx.x;
  const bf16* xbase = p.xw + win * kCells * C;
  const bf16* kvbase = p.cross ? p.kvw + win * kCells * C : nullptr;
  bf16* obase = p.out + win * kCells * C;
  for (int i = tid; i < T; i += kThreads) km_s[i] = p.kmask[win * T + i];
  __syncthreads();
  const int has_key = __syncthreads_or(tid < T && km_s[tid] > 0.f);
  const float scale = 1.f / fmaxf(p.tau[0], p.tau_min);
  if (!has_key) {
    // no key: p = 0, so every token's output is bo
    const int vc = C / 8;
    for (int t = tid; t < T * vc; t += kThreads) {
      const int i = t / vc;
      const int v = t - i * vc;
      uint4 packed;
      bf16* pv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int c = 0; c < 8; ++c) pv[c] = __float2bfloat16(p.bo[v * 8 + c]);
      *reinterpret_cast<uint4*>(obase + (long long)i * C + v * 8) = packed;
    }
    return;
  }

  // ---- projections ------------------------------------------------------
  load_tokens(xs, a0, xbase, p.pos, C, ldb);
  __syncthreads();
  project_heads<MT>(qn, a0, ldb, p.wq, p.bq, C, D, H, scale, st, warp, lane);
  if (!p.cross) {
    project_heads<MT>(kn, a0, ldb, p.wk, p.bk, C, D, H, 1.f, st, warp, lane);
    project_plain<MT>(vb, xs, ldb, p.wv, p.bv, C, st, warp, lane);
    __syncthreads();
  } else {
    __syncthreads();
    load_tokens(a0, nullptr, kvbase, p.pos, C, ldb);
    __syncthreads();
    project_plain<MT>(vb, a0, ldb, p.wv, p.bv, C, st, warp, lane);
    __syncthreads();
    load_tokens(nullptr, a0, kvbase, p.pos, C, ldb);
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
        l[u] = km_s[j] > 0.f ? lg[i * ldl + j] : -30000.f;
      }
      const float mx = warp_max(fmaxf(l[0], l[1]));
      float e[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) e[u] = expf(l[u] - mx);
      const float inv = 1.f / warp_sum(e[0] + e[1]);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        pb[i * ldp + lane + 32 * u] = __float2bfloat16(e[u] * inv);
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

  // ---- output projection of every token, no residual ----------------------
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
      *reinterpret_cast<uint4*>(obase + (long long)i * C + 16 * s + c0) =
          packed;
      __syncwarp();
    }
  }
}

size_t smem_bytes(int C) {
  constexpr int T = kCells;
  const size_t buf = (size_t)T * (C + kPadB) * sizeof(bf16);
  return 5 * buf + (size_t)T * (T + 4) * sizeof(float) +
         (size_t)T * (T + 8) * sizeof(bf16) +
         (size_t)kWarps * 16 * kStLd * sizeof(float) + (size_t)T * 4;
}

}  // namespace

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
  if (N == 0) return 0;
  Params p;
  p.xw = static_cast<const bf16*>(xw);
  p.out = static_cast<bf16*>(out);
  p.kvw = static_cast<const bf16*>(kvw);
  p.kmask = static_cast<const float*>(kmask);
  p.pos = static_cast<const bf16*>(pos);
  p.wq = static_cast<const bf16*>(w[0]);
  p.bq = static_cast<const float*>(w[1]);
  p.wk = static_cast<const bf16*>(w[2]);
  p.bk = static_cast<const float*>(w[3]);
  p.wv = static_cast<const bf16*>(w[4]);
  p.bv = static_cast<const float*>(w[5]);
  p.wo = static_cast<const bf16*>(w[6]);
  p.bo = static_cast<const float*>(w[7]);
  p.tau = static_cast<const float*>(w[8]);
  p.C = C;
  p.H = H;
  p.cross = cross;
  p.tau_min = tau_min;
  const size_t smem = smem_bytes(C);
  const cudaError_t e = cudaFuncSetAttribute(
      window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  window_attention_kernel<<<N, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return tmae_last_error();
}
