// Kernels DFPS, FFPS and BALL_QUERY: PointNet++'s point sampling and
// grouping for the point-based detectors (SSD3D's fusion-sampling backbone
// and its vote head).
//
// They replace no Pallas kernel: the JAX package computes these functions
// in XLA (tmae_tpu/ops/pointnet2.py: farthest_point_sample :31,
// farthest_point_sample_matrix :61 with calc_dist_matrix_for_sampling :86,
// ball_query :96), as a fori_loop of one step a sample and as [B, M, N, 3]
// and [B, N, N, C] broadcasts. Eager PyTorch would launch several kernels
// a step of the loop (some 25k launches for the 4096-point D-FPS of one
// frame) and would need 805 MB a sample for one radius of the first level's
// ball query and 4.3 GB for the second level's F-FPS; the reference
// computes them with its own CUDA extension (pointnet2_batch).
//
// Exactness: the callers compare the indices bit for bit with the plain
// versions (tmae_tpu_torch/ops/pointnet2.py), so every distance is summed in
// the plain versions' written-out order, x, y, z, then the feature channels
// in order, then xyz + gamma * feat, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn; the file is also built with -fmad=false). An
// argmax tie takes the smallest index.
//
// DFPS (farthest_point_sample): one block of 1024 threads a sample. The
// sample's coordinates sit in shared memory as x, y and z rows (16384
// points: 196,608 bytes), the running minimum distances in registers (at
// most 16 a thread). Each of the S - 1 steps reads the last chosen point,
// updates the distances of the thread's points, and takes the block's
// argmax: a warp shuffle reduction, one __syncthreads, then every warp
// reduces the 32 warps' winners itself (double-buffered, so one barrier a
// step). Bound: the S sequential steps, each a block-wide reduction on one
// SM, and not bytes or operations; the batch's samples run side by side.
//
// FFPS (farthest_point_sample_ffps): two kernels in one call. The distance
// matrix [B, N, N] (67 MB a sample at N = 4096) is computed in 32 x 32
// tiles with both tiles' features staged in shared memory 32 channels at a
// time; then the walk of DFPS reads one row of it a step (a sample's
// features, 1 MB at N = 4096 and C = 64, do not fit in shared memory, and
// reading them all from L2 at every step would cost a megabyte a step on one
// SM). The matrix is exactly symmetric ((a - b)^2 = (b - a)^2), so the walk
// reads the row of the last chosen point.
//
// BALL_QUERY (ball_query, dilated when min_radius > 0): one warp a centre,
// 8 centres a block, scanning the points in index order through tiles of
// 512 points staged in shared memory; a ballot gives each chunk of 32 its
// in-ball lanes, their ranks place the first K indices in the warp's
// buffer, and the scan goes on to the end because cnt counts every in-ball
// point. The buffer is then written out wrap-repeated (slot s takes entry
// s % min(cnt, K)); an empty ball or an invalid centre gives zeros. Bound:
// the M x N distances (operations).

#include "common.cuh"

namespace {

constexpr int kFpsThreads = 1024;        // 32 warps: one winner a lane
constexpr int kFpsMaxPer = 16;           // points a thread: N <= 16384
constexpr float kBig = 1e10f;
constexpr int kTile = 32;                // distance-matrix tile
constexpr int kTileThreads = 256;
constexpr int kBqWarps = 8;              // centres a ball-query block
constexpr int kBqTile = 512;             // points a shared-memory tile

__device__ __forceinline__ float sq_dist3(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) beats (w, j): greater value, or equal value and smaller index
__device__ __forceinline__ bool beats(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// the block's argmax of every thread's (v, i); every thread gets it. One
// barrier: the warps' winners go to buffer `par`, which the caller
// alternates from one call to the next.
__device__ __forceinline__ int block_argmax(float v, int i, float (*red_v)[32],
                                            int (*red_i)[32], int par) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  warp_argmax(v, i);
  if (lane == 0) {
    red_v[par][warp] = v;
    red_i[par][warp] = i;
  }
  __syncthreads();
  v = red_v[par][lane];
  i = red_i[par][lane];
  warp_argmax(v, i);
  return i;
}

// The FPS walk of one sample. Row(last, j) is the distance of point j from
// the last chosen point. Running distances: 1e10 for a valid point, -1e10
// for an invalid one (never updated), -inf for a slot past N.
template <int PER, typename Row>
__device__ void fps_walk(const bool* __restrict__ mask, int N, int S,
                         int* __restrict__ out, Row row) {
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];
  const int tid = threadIdx.x;
  float dist[PER];
  float fv = -CUDART_INF_F;
  int fi = N;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = tid + k * kFpsThreads;
    const bool ok = j < N;
    const bool valid = ok && mask[j];
    dist[k] = valid ? kBig : (ok ? -kBig : -CUDART_INF_F);
    // the first valid point: the argmax of the mask
    const float mv = ok ? (valid ? 1.f : 0.f) : -CUDART_INF_F;
    if (beats(mv, j, fv, fi)) {
      fv = mv;
      fi = j;
    }
  }
  int par = 0;
  int last = block_argmax(fv, fi, red_v, red_i, par);
  if (tid == 0) out[0] = last;
  for (int s = 1; s < S; ++s) {
    par ^= 1;
    float bv = -CUDART_INF_F;
    int bi = N;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = tid + k * kFpsThreads;
      if (dist[k] >= 0.f) dist[k] = fminf(dist[k], row(last, j));
      if (beats(dist[k], j, bv, bi)) {
        bv = dist[k];
        bi = j;
      }
    }
    last = block_argmax(bv, bi, red_v, red_i, par);
    if (tid == 0) out[s] = last;
  }
}

template <int PER>
__global__ void __launch_bounds__(kFpsThreads)
    dfps_kernel(const float* __restrict__ xyz, const bool* __restrict__ mask,
                int N, int S, int* __restrict__ out) {
  extern __shared__ float coords[];  // x row, y row, z row of the sample
  const int b = blockIdx.x;
  const float* p = xyz + (long long)b * N * 3;
  float* sx = coords;
  float* sy = coords + N;
  float* sz = coords + 2 * N;
  for (int j = threadIdx.x; j < N; j += kFpsThreads) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
  }
  __syncthreads();
  fps_walk<PER>(mask + (long long)b * N, N, S, out + (long long)b * S,
                [&](int last, int j) {
                  return sq_dist3(sx[j], sy[j], sz[j], sx[last], sy[last],
                                  sz[last]);
                });
}

template <int PER>
__global__ void __launch_bounds__(kFpsThreads)
    matrix_walk_kernel(const float* __restrict__ dm,
                       const bool* __restrict__ mask, int N, int S,
                       int* __restrict__ out) {
  const int b = blockIdx.x;
  const float* m = dm + (long long)b * N * N;
  fps_walk<PER>(mask + (long long)b * N, N, S, out + (long long)b * S,
                [&](int last, int j) {
                  return __ldg(m + (long long)last * N + j);
                });
}

// dm[b, i, j] = |xyz_i - xyz_j|^2 + gamma * |feat_i - feat_j|^2 (the
// feature term only when C > 0), for a 32 x 32 tile of (i, j) a block.
__global__ void __launch_bounds__(kTileThreads)
    dist_matrix_kernel(const float* __restrict__ xyz,
                       const float* __restrict__ feat, int N, int C,
                       float gamma, float* __restrict__ dm) {
  __shared__ float fi[kTile][kTile + 1];
  __shared__ float fj[kTile][kTile + 1];
  constexpr int kRows = kTile * kTile / kTileThreads;  // 4 pairs a thread
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int j = j0 + lane;
  const float* f = feat + (long long)b * N * C;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int cw = min(kTile, C - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < kTile * kTile; t += kTileThreads) {
      const int row = t / kTile, c = t % kTile;
      const bool in_c = c < cw;
      fi[row][c] = (in_c && i0 + row < N)
                       ? f[(long long)(i0 + row) * C + c0 + c] : 0.f;
      fj[row][c] = (in_c && j0 + row < N)
                       ? f[(long long)(j0 + row) * C + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int il = ty + r * (kTileThreads / 32);
      float a = acc[r];
      for (int c = 0; c < cw; ++c) {
        // from 0: the first square is the sum's start exactly (0 + x = x)
        const float d = __fsub_rn(fi[il][c], fj[lane][c]);
        a = __fadd_rn(a, __fmul_rn(d, d));
      }
      acc[r] = a;
    }
  }
  if (j >= N) return;
  const float* p = xyz + (long long)b * N * 3;
  const float jx = p[3 * j], jy = p[3 * j + 1], jz = p[3 * j + 2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + ty + r * (kTileThreads / 32);
    if (i >= N) continue;
    float d = sq_dist3(p[3 * i], p[3 * i + 1], p[3 * i + 2], jx, jy, jz);
    if (C > 0) d = __fadd_rn(d, __fmul_rn(acc[r], gamma));
    dm[((long long)b * N + i) * N + j] = d;
  }
}

__global__ void __launch_bounds__(kBqWarps * 32)
    ball_query_kernel(const float* __restrict__ xyz,
                      const bool* __restrict__ xyz_mask,
                      const float* __restrict__ centers,
                      const bool* __restrict__ center_mask, int N, int M,
                      int K, float r2, float min_r2, int dilated,
                      int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ int first[];  // K indices a warp
  __shared__ float tx[kBqTile], ty[kBqTile], tz[kBqTile];
  __shared__ bool tm[kBqTile];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * kBqWarps + warp;
  const bool live = m < M;
  int* buf = first + warp * K;
  const float* p = xyz + (long long)b * N * 3;
  const bool* pm = xyz_mask + (long long)b * N;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (live) {
    const float* c = centers + ((long long)b * M + m) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int t0 = 0; t0 < N; t0 += kBqTile) {
    const int tn = min(kBqTile, N - t0);
    __syncthreads();
    for (int t = threadIdx.x; t < tn; t += kBqWarps * 32) {
      const long long q = t0 + t;
      tx[t] = p[3 * q];
      ty[t] = p[3 * q + 1];
      tz[t] = p[3 * q + 2];
      tm[t] = pm[q];
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < tn; s += 32) {
      const int t = s + lane;
      bool in = false;
      if (t < tn && tm[t]) {
        const float d2 = sq_dist3(cx, cy, cz, tx[t], ty[t], tz[t]);
        in = d2 <= r2 && (!dilated || d2 > min_r2);
      }
      const unsigned hits = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int rank = count + __popc(hits & below);
        if (rank < K) buf[rank] = t0 + t;
      }
      count += __popc(hits);
    }
  }
  if (!live) return;
  __syncwarp();
  const long long row = (long long)b * M + m;
  const bool keep = count > 0 && center_mask[row];
  const int n = max(1, min(count, K));
  for (int s = lane; s < K; s += 32)
    idx[row * K + s] = keep ? buf[s % n] : 0;
  if (lane == 0) cnt[row] = count;
}

template <int PER>
int dfps_launch(const float* xyz, const bool* mask, int B, int N, int S,
                int* out, cudaStream_t stream) {
  const int smem = 3 * N * static_cast<int>(sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      dfps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dfps_kernel<PER><<<B, kFpsThreads, smem, stream>>>(xyz, mask, N, S, out);
  return tmae_last_error();
}

template <int PER>
int walk_launch(const float* dm, const bool* mask, int B, int N, int S,
                int* out, cudaStream_t stream) {
  matrix_walk_kernel<PER><<<B, kFpsThreads, 0, stream>>>(dm, mask, N, S, out);
  return tmae_last_error();
}

// the smallest of 1, 2, 4, 8, 16 points a thread that covers N; 0 past it
int points_per_thread(int N) {
  for (int per = 1; per <= kFpsMaxPer; per *= 2)
    if (N <= per * kFpsThreads) return per;
  return 0;
}

}  // namespace

extern "C" int launch_dfps(const float* xyz, const bool* mask, int B, int N,
                           int S, int* out, cudaStream_t stream) {
  if (B < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (points_per_thread(N)) {
    case 1: return dfps_launch<1>(xyz, mask, B, N, S, out, stream);
    case 2: return dfps_launch<2>(xyz, mask, B, N, S, out, stream);
    case 4: return dfps_launch<4>(xyz, mask, B, N, S, out, stream);
    case 8: return dfps_launch<8>(xyz, mask, B, N, S, out, stream);
    case 16: return dfps_launch<16>(xyz, mask, B, N, S, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int launch_ffps(const float* xyz, const float* feat,
                           const bool* mask, int B, int N, int C, int S,
                           float gamma, float* dm, int* out,
                           cudaStream_t stream) {
  const int per = points_per_thread(N);
  if (B < 1 || S < 1 || per == 0 || C < 0 || (C > 0 && !feat))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (N + kTile - 1) / kTile;
  dist_matrix_kernel<<<dim3(tiles, tiles, B), kTileThreads, 0, stream>>>(
      xyz, feat, N, C, gamma, dm);
  const int e = tmae_last_error();
  if (e) return e;
  switch (per) {
    case 1: return walk_launch<1>(dm, mask, B, N, S, out, stream);
    case 2: return walk_launch<2>(dm, mask, B, N, S, out, stream);
    case 4: return walk_launch<4>(dm, mask, B, N, S, out, stream);
    case 8: return walk_launch<8>(dm, mask, B, N, S, out, stream);
    default: return walk_launch<16>(dm, mask, B, N, S, out, stream);
  }
}

extern "C" int launch_ball_query(const float* xyz, const bool* xyz_mask,
                                 const float* centers,
                                 const bool* center_mask, int B, int N, int M,
                                 int K, float r2, float min_r2, int dilated,
                                 int* idx, int* cnt, cudaStream_t stream) {
  if (B < 1 || M < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kBqWarps * K * static_cast<int>(sizeof(int));
  const cudaError_t e = cudaFuncSetAttribute(
      ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ball_query_kernel<<<dim3((M + kBqWarps - 1) / kBqWarps, B),
                      kBqWarps * 32, smem, stream>>>(
      xyz, xyz_mask, centers, center_mask, N, M, K, r2, min_r2, dilated, idx,
      cnt);
  return tmae_last_error();
}
