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
// DFPS (farthest_point_sample): one thread-block cluster a sample. The
// sample's N points are split over a cluster of R CTAs (R <= 16; R, the
// threads a CTA and the points a thread come from dfps_plan in
// ops/pointnet2.py: 8 x 256 x 8 at N = 16384), and each thread keeps its
// points' x, y, z and running minimum distances in registers, so a step
// reads nothing from memory but the last step's winner. Each of the S - 1
// steps: every thread updates its points and takes its own argmax; the
// warp's winner comes from two redux.sync (the value's order key, then the
// index where lanes tie), its owning lane hands over the coordinates;
// lanes 0 .. R - 1 write the warp's record (value, index, x, y, z) into
// slot rank * W + warp of every CTA of the cluster with st.async, whose
// bytes land on the receiving CTA's mbarrier (24 a record, expected by one
// arrive.expect_tx of that CTA); every warp waits on its own CTA's
// mbarrier, reduces the R x W records to the same winner and reads its
// coordinates from the record. Records and mbarriers are double-buffered:
// a CTA writes buffer s % 2 again only after every warp of the cluster has
// sent its record of step s + 1, which each sends after reading step s.
// The first valid point (the mask's argmax) is reduced the same way. An
// argmax over any tree gives the plain version's index: `beats` is a
// total order. Bound: the S sequential steps, each one DSMEM round trip
// and three warp reductions, not bytes or operations. Measured
// (utils/pn2_phases.py, H100 SXM at 700 W): 0.84 us a step at 16384 ->
// 4096 (3.43 ms; the one-block walk this replaced: 2.83 us, 11.58 ms),
// 0.58 at 4096 -> 512, 0.48 at 512 -> 256; of a step's ~1800 cycles at 8
// x 256 x 8 (--cycles) ~600 go to the points and the thread's argmax, ~320
// to the warp's, ~330 to the exchange, ~560 to the records' argmax. A
// cluster barrier a step in place of the mbarrier (its release waits on
// the DSMEM stores) took ~1200 cycles for the exchange alone.

// FFPS (farthest_point_sample_ffps): the walk of DFPS on the distance
// |xyz_i - xyz_j|^2 + gamma |feat_i - feat_j|^2, under the plan of
// ffps_plan in ops/pointnet2.py, one of two routes:
// - cluster (above 2048 points, a sample whose features fit 16 CTAs'
//   shared memory: 4096 x 64, SSD3D's level 1): one
//   thread-block cluster of R CTAs a sample, no distance matrix. Point j
//   lives as in DFPS (thread j % G, register k = j / G); each CTA keeps its
//   points' features in shared memory ([C][P + 1] floats, P its points: a
//   warp reads a channel of 32 points from 32 banks), and each thread also
//   the first CREG channels of its points in registers. Each step computes
//   every point's distance from the last winner afresh, in the plain
//   version's order (x, y, z; the channels from a 0 start; then xyz +
//   gamma * feat), so it equals the matrix entry bit for bit ((a - b)^2 =
//   (b - a)^2). The step's winner: each thread's argmax, each warp's
//   (redux.sync), then the CTA's (one __syncthreads, warp 0 over the W
//   warps' winners); warp 0 stores the CTA winner's record (value, index,
//   x, y, z; 32 bytes) into slot `rank` of every CTA with st.async, the
//   bytes counted on that CTA's mbarrier (double-buffered, as DFPS's
//   records); every warp waits on its own mbarrier and takes the argmax
//   of the R records, and the next step's distances read the winner's C
//   features from device memory (L2; broadcast loads). Four ways to hand
//   the features over were timed (utils/pn2_phases.py --cycles on builds
//   that held each, on an H100 SXM at 700 W, 4096 x 64 at 16 x 256, cycles
//   a step of thread 0): in every record by st.async (3844: the CTA's 288
//   16-byte stores ~1650), in every record by cp.async.bulk (3399), pulled
//   once a CTA from the winner's CTA by ld.shared::cluster and a
//   __syncthreads (4176: the pull ~1790), read by every warp from L2
//   (3028: ~650 more in the distances): the last is this design (asking
//   the R candidates' rows into L1 while the records are reduced made a
//   call 0.18 ms slower). Bound: the S steps, each C
//   sequential adds of a point's channels (about 256 cycles at C = 64),
//   the L2 read, the exchange and the reductions; not bytes.
// - matrix (up to 2048 points, where the matrix, 16 MiB a sample at most,
//   is cheaper to build than the cluster's longer steps: 512 x 128,
//   SSD3D's level 2, takes 0.200 ms here against 0.370 on the cluster,
//   and 4096 x 64 0.922 here against 0.718; and a sample whose features
//   do not fit: e.g. 16384 x 64, 4 MiB of features against 16 CTAs' 3.6
//   MiB of shared memory): the distance matrix [B, N, N] into a scratch
//   buffer (32 x 32 tiles, both tiles' features staged 32 channels at a
//   time), then one block of 1024 threads a sample walks its rows, one row
//   a step.
// Measured (utils/pn2_phases.py, H100 SXM at 700 W): 4096 -> 512 at C =
// 64 on the cluster 0.714 ms (1.39 us a step, no scratch; the matrix
// route 0.920: its matrix 0.331, its walk 0.584), bit-equal indices;
// 512 -> 256 at C = 128 on the matrix route 0.200. More in PERF.md.
//
// BALL_QUERY (ball_query_multi: every radius of a multi-scale grouping in
// one launch, each radius's shell min_r < d <= r when dilated; ball_query
// is its one-radius call): a cluster of S CTAs takes 8 warps of CW
// centres, CTA `rank` the rank-th index-ordered slice of the points.
// A ninth warp streams the slice's tiles (x, y, z as stored and the mask,
// by cp.async.bulk on an mbarrier a tile, in a ring that the centre warps
// release tile by tile), so no warp waits at a __syncthreads; each centre
// warp keeps its CW centres in registers, so a point read from shared
// memory serves CW centres; each pair's distance is computed once and a
// chunk of 32 points goes further only when some lane's point lies in
// some centre's largest ball (one redux.sync), then one ballot a shell
// ranks the in-ball lanes: the first K of the slice go to the centre's
// buffer, and the count covers every point in the ball. The slices meet by
// DSMEM: each CTA reads the other slices' counts, places its entries after
// the earlier slices' and writes the output slots that the wrap-repeat
// (slot s takes entry s % min(cnt, K)) maps onto them; rank 0 writes the
// count, and zeros for an empty ball or an invalid centre. The indices and
// counts are the plain version's bit for bit. The plan (CW, S) comes from
// ops/pointnet2.ball_query_plan, after a sweep on the card: CW 1 for a few
// million pairs, up to 8 for 10^8; 2 slices from 4096 points, 1 below
// (4 and 8 slices were slower: the cluster's merge and a shorter scan a
// CTA). Bound: 8 operations a (centre, valid point) pair and 2 a shell's
// test, the 67 TFLOP/s of f32 (0.014 ms at level 0's three radii); what
// holds it at ~4x that is the issue rate of the pairs' ~12 instructions a
// centre and chunk of the unfused squared distance (-fmad=false) and its
// test. Measured (utils/pn2_phases.py --ball, NVIDIA H100 80GB HBM3,
// 700.00 W, device time, frame-like points): level 0's three radii
// 0.0596 ms (the one-radius kernel this replaced: 0.3650 in three
// launches), 4096 x 16384 at r 0.8, K 64 alone 0.0544 (0.1219); a served
// frame's four groupings 0.0864 ms (0.4511 in eleven launches).

#include "common.cuh"

namespace {

constexpr int kFpsThreads = 1024;        // 32 warps: one winner a lane
constexpr int kFpsMaxPer = 16;           // points a thread: N <= 16384
constexpr int kClusterMax = 16;          // DFPS: CTAs of a sample
constexpr int kWarpsMax = 8;             // DFPS: warps of a CTA
constexpr int kRecords = kClusterMax * kWarpsMax;
constexpr float kBig = 1e10f;
constexpr int kTile = 32;                // distance-matrix tile
constexpr int kTileThreads = 256;
constexpr int kBqWarps = 8;              // BALL_QUERY: centre warps a CTA
constexpr int kBqTileN = 1024;           // points a staged tile
constexpr int kBqStages = 3;             // tiles in the ring
constexpr int kBqMaxRadii = 4;           // radii of one call
constexpr int kBqMaxSlices = 8;          // CTAs of a cluster

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

// A warp's record of its winner, as the other CTAs of the cluster see it.
struct __align__(8) Best {
  float v;
  int i;
};

__device__ __forceinline__ uint32_t cta_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the same slot in the shared memory of CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(a), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// An mbarrier of this CTA expecting `count` arrivals a phase, its
// initialisation made visible to the cluster.
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :
               : "r"(bar), "r"(count)
               : "memory");
}

// This thread's arrival on this CTA's mbarrier, which then expects `bytes`
// more to be written to this CTA by st.async before its phase completes.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
      :
      : "r"(bar), "r"(bytes)
      : "memory");
}

// Stores into another CTA's shared memory (shared::cluster addresses) that
// count their bytes on that CTA's mbarrier `bar` when they land.
__device__ __forceinline__ void st_async2(uint32_t a, uint32_t x, uint32_t y,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];"
      :
      : "r"(a), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async4(uint32_t a, float x, float y,
                                          float z, float w, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      :
      : "r"(a), "f"(x), "f"(y), "f"(z), "f"(w), "r"(bar)
      : "memory");
}

// Wait for the phase of parity `parity` of this CTA's mbarrier to
// complete: the bytes it expected have landed. A wait that outlasts any
// step by far (2^28 polls) traps: the call fails instead of hanging.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  unsigned polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A float as an unsigned key in the same order (-0 taken as +0; no NaN
// reaches it), and back.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The lane that holds the warp's argmax of (v, i) (greater value, then
// smaller index; indices >= 0): redux.sync of the value's key, and of the
// index only when several lanes hold the largest value. `lane_of` maps the
// winning index to its lane; v becomes the largest value.
template <typename LaneOf>
__device__ __forceinline__ int warp_winner(float& v, int i, LaneOf lane_of) {
  const unsigned key = order_key(v);
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  const unsigned at = __ballot_sync(0xffffffffu, key == top);
  v = key_value(top);
  if ((at & (at - 1u)) == 0u) return __ffs(at) - 1;
  return lane_of(static_cast<int>(__reduce_min_sync(
      0xffffffffu, key == top ? static_cast<unsigned>(i) : 0xffffffffu)));
}

#ifdef TMAE_DFPS_PROFILE
// cycles of thread 0 of CTA 0, summed over the steps of a call, by part:
// the points' update and the thread's argmax, the warp's, the records'
// stores and the cluster barrier, the records' argmax and the winner's
// coordinates
__device__ unsigned long long dfps_cycles[4];
#define DFPS_TICK(part)                                             \
  do {                                                              \
    if (prof) {                                                     \
      const long long now = clock64();                              \
      atomicAdd(&dfps_cycles[part], (unsigned long long)(now - t0)); \
      t0 = now;                                                     \
    }                                                               \
  } while (0)
#else
#define DFPS_TICK(part) \
  do {                  \
  } while (0)
#endif

// DFPS, one cluster of R CTAs a sample (blockIdx.x / R), PER points a
// thread: point j lives in thread j % G of the cluster (G = R threads, the
// cluster's threads in rank order), in its register k = j / G, so that
// its lane is j % 32. Running distances: 1e10 for a valid point, -1e10
// for an invalid one (never updated), -inf for a slot past N. Each step:
// the thread's argmax over its points (k ascending: a strict > keeps the
// smaller index), the warp's (warp_winner), the warp's record (value,
// index, x, y, z) into slot rank * W + warp of every CTA's buffer `par`,
// one cluster barrier, then every warp's argmax over the R W records, the
// winner's coordinates from its record.
template <int PER>
__global__ void __launch_bounds__(32 * kWarpsMax)
    dfps_cluster_kernel(const float* __restrict__ xyz,
                        const bool* __restrict__ mask, int N, int S, int R,
                        int* __restrict__ out) {
  __shared__ Best rec[2][kRecords];
  __shared__ float4 pos[2][kRecords];
  __shared__ __align__(8) unsigned long long full[2];  // records arrived
  const int threads = blockDim.x, W = threads / 32, nrec = R * W;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rank = blockIdx.x % R, b = blockIdx.x / R;
  const int G = R * threads, gt = rank * threads + threadIdx.x;
  const float* p = xyz + (long long)b * N * 3;
  const bool* m = mask + (long long)b * N;
#ifdef TMAE_DFPS_PROFILE
  const bool prof = blockIdx.x == 0 && threadIdx.x == 0;
  long long t0 = clock64();
#endif
  float px[PER], py[PER], pz[PER], dist[PER];
  float first[PER];  // the mask as values: the first valid point wins
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = gt + k * G;
    const bool ok = j < N;
    const bool valid = ok && m[j];
    px[k] = ok ? p[3 * j] : 0.f;
    py[k] = ok ? p[3 * j + 1] : 0.f;
    pz[k] = ok ? p[3 * j + 2] : 0.f;
    dist[k] = valid ? kBig : (ok ? -kBig : -CUDART_INF_F);
    first[k] = ok ? (valid ? 1.f : 0.f) : -CUDART_INF_F;
  }
  // this lane's slot in every CTA: lane r < R writes CTA r's
  const int slot = rank * W + warp, to = lane < R ? lane : 0;
  const uint32_t rec_at = cluster_addr(cta_addr(&rec[0][slot]), to);
  const uint32_t pos_at = cluster_addr(cta_addr(&pos[0][slot]), to);
  const uint32_t full_at = cluster_addr(cta_addr(&full[0]), to);
  constexpr uint32_t rec_buf = sizeof(rec[0]), pos_buf = sizeof(pos[0]);
  int* o = out + (long long)b * S;
  const bool writer = rank == 0 && threadIdx.x == 0;
  float lx = 0.f, ly = 0.f, lz = 0.f;
  // step s: the argmax of vals over the cluster into o[s], its
  // coordinates into lx, ly, lz
  const auto pick = [&](const float (&vals)[PER], int s) {
    const int par = s & 1;
    // this step's records: nrec of them, 24 bytes each
    if (threadIdx.x == 0) bar_expect(cta_addr(&full[par]), nrec * 24);
    // the thread's argmax (k ascending: a strict > keeps the smaller
    // index), then its coordinates (selects off that chain)
    float bv = vals[0];
    int bk = 0;
#pragma unroll
    for (int k = 1; k < PER; ++k)
      if (vals[k] > bv) {
        bv = vals[k];
        bk = k;
      }
    float bx = px[0], by = py[0], bz = pz[0];
#pragma unroll
    for (int k = 1; k < PER; ++k)
      if (bk == k) {
        bx = px[k];
        by = py[k];
        bz = pz[k];
      }
    const int bi = gt + bk * G;
    DFPS_TICK(0);
    // the warp's winner: its lane is its index % 32
    const int src = warp_winner(bv, bi, [](int i) { return i & 31; });
    const int wi = __shfl_sync(0xffffffffu, bi, src);
    bx = __shfl_sync(0xffffffffu, bx, src);
    by = __shfl_sync(0xffffffffu, by, src);
    bz = __shfl_sync(0xffffffffu, bz, src);
    DFPS_TICK(1);
    if (lane < R) {
      st_async2(rec_at + par * rec_buf, __float_as_uint(bv), wi,
                full_at + par * 8);
      st_async4(pos_at + par * pos_buf, bx, by, bz, 0.f, full_at + par * 8);
    }
    // every warp's record of this step is in buffer `par`: phase (s / 2) %
    // 2 of `full[par]` is complete
    bar_wait(cta_addr(&full[par]), (s >> 1) & 1);
    DFPS_TICK(2);
    // the records' argmax; each lane reads its best record's coordinates
    // while the warp finds the winner
    float rv = -CUDART_INF_F;
    int ri = 0x7fffffff, rk = 0;
    for (int k = lane; k < nrec; k += 32) {
      const Best r = rec[par][k];
      if (beats(r.v, r.i, rv, ri)) {
        rv = r.v;
        ri = r.i;
        rk = k;
      }
    }
    const float4 q = pos[par][rk];
    // a record's index is unique: the lane that read it holds it
    const int win = warp_winner(rv, ri, [&](int i) {
      return __ffs(__ballot_sync(0xffffffffu, ri == i)) - 1;
    });
    const int last = __shfl_sync(0xffffffffu, ri, win);
    lx = __shfl_sync(0xffffffffu, q.x, win);
    ly = __shfl_sync(0xffffffffu, q.y, win);
    lz = __shfl_sync(0xffffffffu, q.z, win);
    if (writer) o[s] = last;
    DFPS_TICK(3);
  };
  if (threadIdx.x == 0) {
    bar_init(cta_addr(&full[0]), 1);
    bar_init(cta_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster has started, and set up its mbarriers, before
  // its shared memory is written from another
  cluster_barrier();
  pick(first, 0);
  for (int s = 1; s < S; ++s) {
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (dist[k] >= 0.f)
        dist[k] = fminf(dist[k], sq_dist3(px[k], py[k], pz[k], lx, ly, lz));
    pick(dist, s);
  }
  // no CTA leaves while another may still write to it
  cluster_barrier();
}

// F-FPS's cluster route: a CTA's features in shared memory, [C][P + 1]
// floats (its P = threads * PER points, padded to 4), then its points'
// coordinates [P][4].
constexpr int kFfpsWarpsMax = 16;  // threads a CTA up to 512
// dynamic shared memory a CTA may take: 227 KiB less the static arrays
constexpr int kFfpsSmemMax = 227 * 1024 - 2048;

__host__ __device__ constexpr int ffps_feat_floats(int C, int P) {
  return 4 * ((C * (P + 1) + 3) / 4);
}

__host__ __device__ constexpr int ffps_smem_bytes(int C, int P) {
  return 4 * (ffps_feat_floats(C, P) + 4 * P);
}

// a + (w - f)^2, each step rounded
__device__ __forceinline__ float sq_add(float a, float w, float f) {
  const float d = __fsub_rn(w, f);
  return __fadd_rn(a, __fmul_rn(d, d));
}

#ifdef TMAE_FFPS_PROFILE
// cycles of thread 0 of CTA 0 (warp 0: it also does the CTA's reduction
// and the record's stores), summed over the steps of a call, by part: the
// points' distances and the thread's argmax, the warp's argmax, the CTA's
// argmax and the record's stores, the wait for the R records, the
// records' argmax
__device__ unsigned long long ffps_cycles[5];
#define FFPS_TICK(part)                                             \
  do {                                                              \
    if (prof) {                                                     \
      const long long now = clock64();                              \
      atomicAdd(&ffps_cycles[part], (unsigned long long)(now - t0)); \
      t0 = now;                                                     \
    }                                                               \
  } while (0)
#else
#define FFPS_TICK(part) \
  do {                  \
  } while (0)
#endif

// F-FPS, one cluster of R CTAs a sample (blockIdx.x / R), PER points a
// thread laid out as DFPS's, their first CREG channels also in registers.
// A thread's point k is local point tid + k threads of its CTA.
template <int PER, int CREG>
__global__ void __launch_bounds__(32 * (PER * CREG >= 128 ? 8 : kFfpsWarpsMax))
    ffps_cluster_kernel(const float* __restrict__ xyz,
                        const float* __restrict__ feat,
                        const bool* __restrict__ mask, int N, int C, int S,
                        int R, float gamma, int* __restrict__ out) {
  extern __shared__ __align__(16) float dsm[];
  __shared__ float2 wrec[2][kFfpsWarpsMax];  // the warps' winners
  // the CTAs' winners: (value, index bits, x, y), (z, -, -, -)
  __shared__ float4 rec[2][kClusterMax][2];
  __shared__ __align__(8) unsigned long long full[2];  // records arrived
  const int threads = blockDim.x, W = threads / 32, P = threads * PER;
  const int LD = P + 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rank = blockIdx.x % R, b = blockIdx.x / R;
  const int G = R * threads, gt = rank * threads + threadIdx.x;
  float* const fs = dsm;
  float4* const pxyz =
      reinterpret_cast<float4*>(dsm + ffps_feat_floats(C, P));
  const float* p = xyz + (long long)b * N * 3;
  const bool* m = mask + (long long)b * N;
  const float* f = feat + (long long)b * N * C;
#ifdef TMAE_FFPS_PROFILE
  const bool prof = blockIdx.x == 0 && threadIdx.x == 0;
  long long t0 = clock64();
#endif
  // the CTA's features, row by row of each register k's `threads` points
  for (int k = 0; k < PER; ++k) {
    const long long j0 = rank * threads + (long long)k * G;
    for (int e = threadIdx.x; e < threads * C; e += threads) {
      const int r = e / C, c = e % C;
      fs[c * LD + k * threads + r] = j0 + r < N ? f[(j0 + r) * C + c] : 0.f;
    }
  }
  float px[PER], py[PER], pz[PER], dist[PER];
  float first[PER];  // the mask as values: the first valid point wins
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = gt + k * G;
    const bool ok = j < N;
    const bool valid = ok && m[j];
    px[k] = ok ? p[3 * j] : 0.f;
    py[k] = ok ? p[3 * j + 1] : 0.f;
    pz[k] = ok ? p[3 * j + 2] : 0.f;
    dist[k] = valid ? kBig : (ok ? -kBig : -CUDART_INF_F);
    first[k] = ok ? (valid ? 1.f : 0.f) : -CUDART_INF_F;
    pxyz[threadIdx.x + k * threads] = make_float4(px[k], py[k], pz[k], 0.f);
  }
  if (threadIdx.x == 0) {
    bar_init(cta_addr(&full[0]), 1);
    bar_init(cta_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster has started, set up its mbarriers and loaded
  // its features and coordinates before another reads or writes them
  cluster_barrier();
  float fr[PER][CREG > 0 ? CREG : 1];
#pragma unroll
  for (int k = 0; k < PER; ++k)
#pragma unroll
    for (int c = 0; c < CREG; ++c)
      fr[k][c] = fs[c * LD + threadIdx.x + k * threads];
  const uint32_t rec_at = cta_addr(&rec[0][rank][0]);
  const uint32_t full_at = cta_addr(&full[0]);
  int* o = out + (long long)b * S;
  const bool writer = rank == 0 && threadIdx.x == 0;
  float lx = 0.f, ly = 0.f, lz = 0.f;
  const float* wsrc = f;  // the last winner's features, in device memory
  // step s: the argmax of vals over the cluster into o[s], its
  // coordinates into lx, ly, lz and its features' address into wsrc
  const auto pick = [&](const float (&vals)[PER], int s) {
    const int par = s & 1;
    if (threadIdx.x == 0) bar_expect(full_at + par * 8, R * 32);
    float bv = vals[0];
    int bk = 0;
#pragma unroll
    for (int k = 1; k < PER; ++k)
      if (vals[k] > bv) {
        bv = vals[k];
        bk = k;
      }
    const int bi = gt + bk * G;
    FFPS_TICK(0);
    const int src = warp_winner(bv, bi, [](int i) { return i & 31; });
    if (lane == src) wrec[par][warp] = make_float2(bv, __int_as_float(bi));
    FFPS_TICK(1);
    __syncthreads();
    if (warp == 0) {
      // the CTA's winner into slot `rank` of every CTA's buffer `par`
      float v = -CUDART_INF_F;
      int i = 0x7fffffff;
      if (lane < W) {
        const float2 h = wrec[par][lane];
        v = h.x;
        i = __float_as_int(h.y);
      }
      const int win = warp_winner(v, i, [&](int ii) {
        return __ffs(__ballot_sync(0xffffffffu, i == ii)) - 1;
      });
      const int ci = __shfl_sync(0xffffffffu, i, win);
      // ci's local index in this CTA (a CTA without a point below N sends
      // -inf, which never wins)
      const int k = ci / G, l = ci % G - rank * threads + k * threads;
      const float4 q = ci < N ? pxyz[l] : make_float4(0.f, 0.f, 0.f, 0.f);
      if (lane < R) {
        const uint32_t to = cluster_addr(rec_at + par * kClusterMax * 32, lane);
        const uint32_t bar = cluster_addr(full_at + par * 8, lane);
        st_async4(to, v, __int_as_float(ci), q.x, q.y, bar);
        st_async4(to + 16, q.z, 0.f, 0.f, 0.f, bar);
      }
    }
    FFPS_TICK(2);
    // every CTA's record of this step is in buffer `par`: phase (s / 2) %
    // 2 of `full[par]` is complete
    bar_wait(full_at + par * 8, (s >> 1) & 1);
    FFPS_TICK(3);
    float rv = -CUDART_INF_F;
    int ri = 0x7fffffff;
    if (lane < R) {
      const float4 h = rec[par][lane][0];
      rv = h.x;
      ri = __float_as_int(h.y);
    }
    const int win = warp_winner(rv, ri, [&](int ii) {
      return __ffs(__ballot_sync(0xffffffffu, ri == ii)) - 1;
    });
    const float4 h0 = rec[par][win][0];
    const int last = __float_as_int(h0.y);
    lx = h0.z;
    ly = h0.w;
    lz = rec[par][win][1].x;
    if (writer) o[s] = last;
    // every warp reads the winner's features from device memory (L2)
    wsrc = f + (long long)last * C;
    FFPS_TICK(4);
  };
  pick(first, 0);
  for (int s = 1; s < S; ++s) {
    float acc[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) acc[k] = 0.f;
    // from a 0 start: the first square is the sum's start exactly
#pragma unroll
    for (int c = 0; c < CREG; c += 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(wsrc + c));
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        acc[k] = sq_add(acc[k], w.x, fr[k][c]);
        acc[k] = sq_add(acc[k], w.y, fr[k][c + 1]);
        acc[k] = sq_add(acc[k], w.z, fr[k][c + 2]);
        acc[k] = sq_add(acc[k], w.w, fr[k][c + 3]);
      }
    }
    for (int c = CREG; c < C; ++c) {
      const float w = __ldg(wsrc + c);
      const float* const fc = fs + c * LD + threadIdx.x;
#pragma unroll
      for (int k = 0; k < PER; ++k) acc[k] = sq_add(acc[k], w, fc[k * threads]);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (dist[k] >= 0.f) {
        float d = sq_dist3(px[k], py[k], pz[k], lx, ly, lz);
        dist[k] = fminf(dist[k], __fadd_rn(d, __fmul_rn(acc[k], gamma)));
      }
    pick(dist, s);
  }
  // no CTA leaves while another may still read or write it
  cluster_barrier();
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

// dm[b, i, j] = |xyz_i - xyz_j|^2 + gamma * |feat_i - feat_j|^2, for a
// 32 x 32 tile of (i, j) a block.
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
    dm[((long long)b * N + i) * N + j] =
        __fadd_rn(d, __fmul_rn(acc[r], gamma));
  }
}

// BALL_QUERY's parameters: R radii (R <= kBqMaxRadii) tested on one pass
// over the points. Radius r: r2[r] = radius^2, min2[r] the dilated shell's
// lower bound (-1: none), K[r] its slots; kpre[r] = K[0] + ... + K[r - 1]
// places its idx block [B, M, K[r]] in `idx` (at B M kpre[r]) and its K[r]
// slots in a centre's shared-memory buffer; its counts at cnt + r B M.
struct BqArgs {
  const float* xyz;
  const bool* mask;
  const float* centers;
  const bool* center_mask;
  int* idx;
  int* cnt;
  int B, N, M, S, mblocks, ksum;
  int tile, stages;  // points a staged tile, tiles in the ring
  float rmax2;
  float r2[kBqMaxRadii], min2[kBqMaxRadii];
  int K[kBqMaxRadii], kpre[kBqMaxRadii];
};

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::
          "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ int ld_cluster(uint32_t a) {
  int v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// BALL_QUERY: a cluster of S CTAs takes kBqWarps * CW centres of a sample,
// CTA `rank` the rank-th slice of its points, in index order. Warp
// kBqWarps stages the slice's tiles (x, y, z as stored, and the mask) by
// cp.async.bulk into a ring of kBqStages, each counted on its mbarrier
// `full`; the other warps each hold CW centres in registers and read each
// point once from shared memory for all of them, then hand the tile back
// on `empty`. A chunk of 32 points: each lane its point's CW squared
// distances (sq_dist3, the plain order) and a bit a centre whose largest
// ball holds it; one redux.sync names the centres with any such point, and
// only for those each shell's ballot ranks the in-ball lanes after the
// count so far: the first K[r] indices go to the centre's buffer, and the
// count goes on to the slice's end. The slices' counts then meet by DSMEM:
// each CTA places its entries after the earlier slices' counts and writes
// the output slots that the wrap-repeat maps onto them; rank 0 writes the
// count, and zeros for an empty ball or an invalid centre.
template <int CW, int R>
__global__ void __launch_bounds__((kBqWarps + 1) * 32, CW <= 4 ? 4 : 2)
    ball_query_kernel(const BqArgs a) {
  extern __shared__ __align__(16) unsigned char bq_smem[];
  __shared__ __align__(8) unsigned long long bars[2 * kBqStages];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = a.S;
  const int cid = blockIdx.x / S;  // the cluster: a sample's block of centres
  const int b = cid / a.mblocks;
  const int rank = S > 1 ? cluster_rank() : 0;
  const int N = a.N;
  // the slice: a multiple of 16 points (a bulk copy moves 16-byte blocks)
  const int per = ((N + S - 1) / S + 15) / 16 * 16;
  const int lo = min(N, rank * per), hi = min(N, lo + per);
  const int tile = a.tile, stages = a.stages;
  const int ntiles = (hi - lo + tile - 1) / tile;
  float* stage_xyz = reinterpret_cast<float*>(bq_smem);
  bool* stage_mask = reinterpret_cast<bool*>(bq_smem + stages * tile * 12);
  int* buf = reinterpret_cast<int*>(bq_smem + stages * tile * 13);
  int* xcnt = buf + kBqWarps * CW * a.ksum;
  const uint32_t full0 = cta_addr(&bars[0]);
  const uint32_t empty0 = cta_addr(&bars[kBqStages]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full0 + 8 * s, 1);
      bar_init(empty0 + 8 * s, kBqWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int m0 = (cid % a.mblocks) * kBqWarps * CW + warp * CW;
  float cx[CW], cy[CW], cz[CW];
  int count[CW][R] = {};
  if (warp == kBqWarps) {  // the producer
    if (lane == 0)
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % stages;
        if (t >= stages) bar_wait(empty0 + 8 * s, (t / stages - 1) & 1);
        const int n0 = lo + t * tile, nn = min(tile, hi - n0);
        bar_expect(full0 + 8 * s, 13 * nn);
        const long long q = (long long)b * N + n0;
        bulk_load(cta_addr(stage_xyz + s * tile * 3), a.xyz + 3 * q, 12 * nn,
                  full0 + 8 * s);
        bulk_load(cta_addr(stage_mask + s * tile), a.mask + q, nn,
                  full0 + 8 * s);
      }
  } else {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int m = m0 + c;
      cx[c] = cy[c] = cz[c] = CUDART_NAN_F;  // past M: no point in its ball
      if (m < a.M) {
        const float* p = a.centers + ((long long)b * a.M + m) * 3;
        cx[c] = p[0];
        cy[c] = p[1];
        cz[c] = p[2];
      }
    }
    int* wbuf = buf + warp * CW * a.ksum;
    const unsigned below = (1u << lane) - 1u;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % stages;
      bar_wait(full0 + 8 * s, (t / stages) & 1);
      const int n0 = lo + t * tile, nn = min(tile, hi - n0);
      const float* tx = stage_xyz + s * tile * 3;
      const bool* tm = stage_mask + s * tile;
      for (int c0 = 0; c0 < nn; c0 += 32) {
        const int j = c0 + lane;
        const int jc = min(j, nn - 1);  // a lane past the tile reads a point
        const bool valid = j < nn && tm[jc];
        const float px = tx[3 * jc], py = tx[3 * jc + 1], pz = tx[3 * jc + 2];
        float d2[CW];
        unsigned bits = 0;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          d2[c] = sq_dist3(cx[c], cy[c], cz[c], px, py, pz);
          bits |= (valid && d2[c] <= a.rmax2) ? 1u << c : 0u;
        }
        const unsigned any = __reduce_or_sync(0xffffffffu, bits);
        if (!any) continue;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          if (!((any >> c) & 1u)) continue;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const bool in = ((bits >> c) & 1u) && d2[c] <= a.r2[r] &&
                            d2[c] > a.min2[r];
            const unsigned hits = __ballot_sync(0xffffffffu, in);
            if (in) {
              const int k = count[c][r] + __popc(hits & below);
              if (k < a.K[r]) wbuf[c * a.ksum + a.kpre[r] + k] = n0 + j;
            }
            count[c][r] += __popc(hits);
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty0 + 8 * s);
    }
    if (S > 1 && lane == 0)
#pragma unroll
      for (int c = 0; c < CW; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) xcnt[(warp * CW + c) * R + r] = count[c][r];
  }
  __syncwarp();
  if (S > 1) cluster_barrier();  // every slice's counts are in place
  if (warp < kBqWarps) {
    const int* wbuf = buf + warp * CW * a.ksum;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int m = m0 + c;
      if (m >= a.M) continue;
      const long long row = (long long)b * a.M + m;
      const bool valid_centre = a.center_mask[row];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // the earlier slices' count, and all of them
        int pre = 0, total = count[c][r];
        if (S > 1) {
          const int v = lane < S ? ld_cluster(cluster_addr(
                                       cta_addr(&xcnt[(warp * CW + c) * R + r]),
                                       lane))
                                 : 0;
          total = __reduce_add_sync(0xffffffffu, v);
          pre = __reduce_add_sync(0xffffffffu, lane < rank ? v : 0);
        }
        const int K = a.K[r];
        int* out = a.idx + (long long)a.B * a.M * a.kpre[r] + row * K;
        if (total > 0 && valid_centre) {
          const int n = min(total, K);
          const int own = pre < K ? min(count[c][r], K - pre) : 0;
          for (int s = lane; s < K; s += 32) {
            const int e = s % n - pre;
            if (e >= 0 && e < own) out[s] = wbuf[c * a.ksum + a.kpre[r] + e];
          }
        } else if (rank == 0) {
          for (int s = lane; s < K; s += 32) out[s] = 0;
        }
        if (rank == 0 && lane == 0)
          a.cnt[(long long)r * a.B * a.M + row] = total;
      }
    }
  }
  if (S > 1) cluster_barrier();  // no CTA leaves while its counts are read
}

// One launch of `kern` as B clusters of R CTAs of `threads` with `smem`
// bytes of dynamic shared memory, through cudaLaunchKernelEx. A cluster of
// more than 8 CTAs is allowed explicitly, and the first launch of each
// (kernel, R, threads, smem) asks the card how many such clusters it can
// hold: none is an error.
template <typename... KArgs, typename... Args>
int cluster_launch(void (*kern)(KArgs...), int B, int R, int threads,
                   int smem, cudaStream_t stream, Args... args) {
  struct Seen {
    const void* kern;
    long long key;
  };
  static Seen seen[256];
  static int nseen = 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * R);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const long long key = R + 32LL * threads + (1LL << 20) * smem;
  bool done = false;
  for (int k = 0; k < nseen && !done; ++k)
    done = seen[k].kern == (const void*)kern && seen[k].key == key;
  // the limit is the kernel's: another size may have set it lower
  cudaError_t e = cudaSuccess;
  if (smem > 0)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!done) {
    if (R > 8)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (nseen < 256) seen[nseen++] = {(const void*)kern, key};
  }
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
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

// DFPS under the plan (R, threads, per) of ops/pointnet2.dfps_plan: R in
// 1..16, threads a multiple of 32 up to 256, per 1, 2, 4, 8 or 16,
// covering N.
extern "C" int launch_dfps_cluster(const float* xyz, const bool* mask, int B,
                                   int N, int S, int R, int threads, int per,
                                   int* out, cudaStream_t stream) {
  if (B < 1 || S < 1 || N < 1 || R < 1 || R > kClusterMax || threads < 32 ||
      threads > 32 * kWarpsMax || threads % 32 ||
      (long long)R * threads * per < N)
    return static_cast<int>(cudaErrorInvalidValue);
#define DFPS_CASE(P_)                                                       \
  case P_:                                                                  \
    return cluster_launch(dfps_cluster_kernel<P_>, B, R, threads, 0, stream, \
                          xyz, mask, N, S, R, out);
  switch (per) {
    DFPS_CASE(1) DFPS_CASE(2) DFPS_CASE(4) DFPS_CASE(8) DFPS_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DFPS_CASE
}

#ifdef TMAE_DFPS_PROFILE
// DFPS's cycles by part since the last read (dfps_cycles), then reset
extern "C" int tmae_dfps_profile(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, dfps_cycles, sizeof(dfps_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[4] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(dfps_cycles, zero, sizeof(dfps_cycles)));
}
#endif

// FFPS, C >= 1 channels (ops/pointnet2 sends a call without features to
// DFPS), under the plan of ops/pointnet2.ffps_plan: route 1, the cluster
// walk (R in 1..16, threads a multiple of 32 up to 512, or 256 when a
// thread holds 128 channels in registers; per 1, 2, 4, 8 or 16 covering
// N; creg 0, 32, 64 or 128 with per * creg <= 128, creg <= C, and C % 4
// == 0 when creg > 0); route 0, the distance matrix into `dm` [B, N, N]
// and the one-block walk over its rows (N <= 16384).
extern "C" int launch_ffps(const float* xyz, const float* feat,
                           const bool* mask, int B, int N, int C, int S,
                           float gamma, int route, int R, int threads,
                           int per, int creg, float* dm, int* out,
                           cudaStream_t stream) {
  if (B < 1 || S < 1 || N < 1 || C < 1 || !feat || route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) {
    const int mper = points_per_thread(N);
    if (mper == 0 || !dm) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (N + kTile - 1) / kTile;
    dist_matrix_kernel<<<dim3(tiles, tiles, B), kTileThreads, 0, stream>>>(
        xyz, feat, N, C, gamma, dm);
    const int e = tmae_last_error();
    if (e) return e;
    switch (mper) {
      case 1: return walk_launch<1>(dm, mask, B, N, S, out, stream);
      case 2: return walk_launch<2>(dm, mask, B, N, S, out, stream);
      case 4: return walk_launch<4>(dm, mask, B, N, S, out, stream);
      case 8: return walk_launch<8>(dm, mask, B, N, S, out, stream);
      default: return walk_launch<16>(dm, mask, B, N, S, out, stream);
    }
  }
  const int smem = ffps_smem_bytes(C, threads * per);
  if (R < 1 || R > kClusterMax || threads < 32 || threads % 32 ||
      threads > 32 * (per * creg >= 128 ? 8 : kFfpsWarpsMax) ||
      (long long)R * threads * per < N || creg > C || per * creg > 128 ||
      smem > kFfpsSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  // the registers' channels are read 16 bytes at a time
  if (creg && (C % 4 || reinterpret_cast<uintptr_t>(feat) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
#define FFPS_CASE(P_, C_)                                                  \
  if (per == P_ && creg == C_)                                             \
    return cluster_launch(ffps_cluster_kernel<P_, C_>, B, R, threads, smem, \
                          stream, xyz, feat, mask, N, C, S, R, gamma, out);
  FFPS_CASE(1, 0) FFPS_CASE(1, 32) FFPS_CASE(1, 64) FFPS_CASE(1, 128)
  FFPS_CASE(2, 0) FFPS_CASE(2, 32) FFPS_CASE(2, 64)
  FFPS_CASE(4, 0) FFPS_CASE(4, 32)
  FFPS_CASE(8, 0) FFPS_CASE(16, 0)
#undef FFPS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef TMAE_FFPS_PROFILE
// FFPS's cycles by part since the last read (ffps_cycles), then reset
extern "C" int tmae_ffps_profile(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ffps_cycles, sizeof(ffps_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[5] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(ffps_cycles, zero, sizeof(ffps_cycles)));
}
#endif

// BALL_QUERY for R radii in one pass (ops/pointnet2.ball_query_multi):
// r2, min2 (-1: no lower bound) and K are host arrays of R; CW centres a
// warp (1, 2, 4 or 8), S point slices a cluster (1..8), from
// ops/pointnet2.ball_query_plan. N a multiple of 16 and 16-byte aligned
// xyz and mask rows (the wrapper pads), so each tile is one bulk copy.
extern "C" int launch_ball_query(const float* xyz, const bool* xyz_mask,
                                 const float* centers,
                                 const bool* center_mask, int B, int N, int M,
                                 int R, const float* r2, const float* min2,
                                 const int* K, int cw, int S, int* idx,
                                 int* cnt, cudaStream_t stream) {
  if (B < 1 || M < 1 || N < 16 || N % 16 || R < 1 || R > kBqMaxRadii ||
      S < 1 || S > kBqMaxSlices ||
      reinterpret_cast<uintptr_t>(xyz) % 16 ||
      reinterpret_cast<uintptr_t>(xyz_mask) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  BqArgs a = {};
  a.xyz = xyz;
  a.mask = xyz_mask;
  a.centers = centers;
  a.center_mask = center_mask;
  a.idx = idx;
  a.cnt = cnt;
  a.B = B;
  a.N = N;
  a.M = M;
  a.S = S;
  a.rmax2 = -1.f;
  for (int r = 0; r < R; ++r) {
    if (K[r] < 1) return static_cast<int>(cudaErrorInvalidValue);
    a.r2[r] = r2[r];
    a.min2[r] = min2[r];
    a.K[r] = K[r];
    a.kpre[r] = a.ksum;
    a.ksum += K[r];
    a.rmax2 = fmaxf(a.rmax2, r2[r]);
  }
  // the ring: tiles of up to kBqTileN points, as many as a slice needs up
  // to kBqStages (the kernel's slice: a multiple of 16 points)
  const int per = ((N + S - 1) / S + 15) / 16 * 16;
  a.tile = min(kBqTileN, per);
  a.stages = min(kBqStages, (per + a.tile - 1) / a.tile);
  const int smem = a.stages * a.tile * 13 +
                   kBqWarps * cw * (a.ksum + R) * static_cast<int>(sizeof(int));
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  a.mblocks = (M + kBqWarps * cw - 1) / (kBqWarps * cw);
  const int threads = (kBqWarps + 1) * 32;
#define BQ_CASE(CW_, R_)                                                     \
  if (cw == CW_ && R == R_)                                                  \
    return cluster_launch(ball_query_kernel<CW_, R_>, B * a.mblocks, S,      \
                          threads, smem, stream, a);
#define BQ_RADII(CW_) BQ_CASE(CW_, 1) BQ_CASE(CW_, 2) BQ_CASE(CW_, 3) BQ_CASE(CW_, 4)
  BQ_RADII(1) BQ_RADII(2) BQ_RADII(4) BQ_RADII(8)
#undef BQ_RADII
#undef BQ_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
