// WMMA tile helpers shared by the encoder-layer kernels (encoder_layer.cu,
// encoder_layer_bwd.cu): bf16 16x16x16 fragments with f32 accumulation, row
// GEMMs against a weight matrix, and warp reductions.
#pragma once

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kStLd = 36;  // per-warp f32 staging row stride (16 x up to 32)

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> AFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> AColFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> BColFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BRowFrag;

// acc[m][j] += A[16m.., k] * W^T over k < K for output columns n0 + 16j..,
// where W is a Linear weight [out, in] with row stride ldw (so B(k, n) =
// W[(n0 + n) * ldw + k], a column-major B). One weight fragment is reused
// across all MT row blocks.
template <int MT>
__device__ __forceinline__ void gemm_rows(AccFrag (&acc)[MT][2], int nj,
                                          const bf16* A, int lda,
                                          const bf16* W, int ldw, int n0,
                                          int K) {
  AFrag a;
  BColFrag bw[2];
  for (int k0 = 0; k0 < K; k0 += 16) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (j < nj)
        wmma::load_matrix_sync(bw[j], W + (long long)(n0 + 16 * j) * ldw + k0,
                               ldw);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      wmma::load_matrix_sync(a, A + 16 * m * lda + k0, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nj) wmma::mma_sync(acc[m][j], a, bw[j], acc[m][j]);
    }
  }
}

// As gemm_rows with a row-major B: B(k, n) = W[k * ldw + n0 + n], i.e.
// acc += A * W for W [K, N] (a Linear weight [out, in] used untransposed,
// as a backward pass needs it).
template <int MT>
__device__ __forceinline__ void gemm_rows_rm(AccFrag (&acc)[MT][2], int nj,
                                             const bf16* A, int lda,
                                             const bf16* W, int ldw, int n0,
                                             int K) {
  AFrag a;
  BRowFrag bw[2];
  for (int k0 = 0; k0 < K; k0 += 16) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (j < nj)
        wmma::load_matrix_sync(bw[j], W + (long long)k0 * ldw + n0 + 16 * j,
                               ldw);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      wmma::load_matrix_sync(a, A + (long long)16 * m * lda + k0, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nj) wmma::mma_sync(acc[m][j], a, bw[j], acc[m][j]);
    }
  }
}

template <int MT>
__device__ __forceinline__ void zero_acc(AccFrag (&acc)[MT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    wmma::fill_fragment(acc[m][0], 0.f);
    wmma::fill_fragment(acc[m][1], 0.f);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace
