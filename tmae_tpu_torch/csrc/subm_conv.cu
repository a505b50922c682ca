// Kernel K15 for Hopper: the 3x3 submanifold convolution on the occupied
// 8x8 windows of an unshifted plan, as a persistent kernel over tiles of
// live windows.
//
// Replaces tmae_tpu/ops/sparse_conv.py:67 _subm_conv_pallas (its
// pallas_call at :101; kernel _conv_kernel at :41), the forward of
// subm_conv3x3. For every plan slot s of every sample it computes the SAME
// 3x3 conv of the window's 64 cells,
//   out[s, c, o] = (bias[o] + sum_{ky,kx,i} x[cell c + (ky - 1, kx - 1), i]
//                  * w[ky, kx, i, o]) * qmask[s, c],
// into the compact [B, cap, 64, Cout] tensor; the caller scatters it onto
// the grid (K2 into a zero carrier, the JAX package's K13b).
//
// Geometry: window (wy, wx) of the unshifted plan covers grid rows
// 8 (wy - 1) .. 8 wy - 1 and columns 8 (wx - 1) .. 8 wx - 1 (the plan pads
// one window at the top and left). Its 10 x 10 halo starts one cell above
// and left of that; halo cells off the grid read as zero (SAME padding). A
// slot is live when it names a window of the partition (0 <= wy < nwy and
// 0 <= wx < nwx: the plan's padding names the dummy row wy = nwy) and its
// qmask has a nonzero cell. Every other slot's output is zero, as the TPU
// kernel's is (qmask 0 on every cell).
//
// Bound on this card: operations. A live window costs 2 x 64 x 9 x Cin x
// Cout FLOPs (9.4 M at C = 128, 38 M at C = 256) against its 100-cell halo
// and 64-cell output; the weights (9 C^2 bf16: 295 KB at 128, 1.18 MB at
// 256) are shared by every window.
// What held the earlier design (one block of 8 warps per slot, WMMA) back:
// a block for every slot, dummy ones too; all 9 taps of the weights read
// from L2 by every block; WMMA fragments loaded through registers.
//
// Design (4 launches on the caller's stream, no host synchronisation):
//   1. conv_pack_kernel: wmat [3, 3, C, C] into 16 KiB wgmma panels
//      (layout in wgmma_tiles.cuh), W_t[n, k] = wmat[t, k, n], in the
//      order the products use them: pass of 128 output columns, then tap,
//      then 64-channel chunk (18 panels at C = 128, 72 at C = 256).
//   2. conv_prepass_kernel, one warp per slot: the live flag, and zeros on
//      the 64 x C output row of a slot that is not live.
//   3. compact_kernel (wgmma_tiles.cuh): the live slots in slot order into
//      a device-side list, their count, the tile counter set to 0.
//   4. conv_kernel, persistent: one block per SM of two consumer
//      warpgroups and a producer warp takes tiles of two live windows from
//      the counter, one window a warpgroup (a partial last tile has one).
//      Each warpgroup loads its window's halo into shared memory in
//      core-matrix order [C / 8][100 cells][16 B] (cp.async, zeros off the
//      grid). The producer streams the panels through a cp.async.bulk
//      ring on mbarriers, so each weight byte is read from L2 once per tile
//      and used by both windows. For tap (ky, kx) and 8-channel chunk v,
//      window row r's A operand is halo cells (r + ky) 10 + kx + 0..7: 8
//      consecutive 16-byte rows, a no-swizzle core matrix. So A for the
//      whole 64-row tap is one descriptor at halo + ((ky 10 + kx) + v 100)
//      16 bytes, leading byte offset 1600 (the next 8 channels), stride
//      byte offset 160 (the next window row): no im2col copy. Each
//      warpgroup runs wgmma m64n128k16 over the 9 taps x C / 16 k-steps
//      into 64 f32 accumulators a thread, one pass of 128 output columns
//      at a time (two at C = 256). The epilogue adds the bias and
//      multiplies by qmask in f32, rounds to bf16, and stores 16-byte
//      vectors through a staging tile in shared memory.
//
// Shared memory: the panel ring (8 stages at C = 128, 5 at C = 256), two
// halos (25.6 / 51.2 KB each) and two staging tiles [64][136] bf16: 212
// KiB at C = 128, 214 KiB at C = 256 (subm_conv_smem).
//
// Every sum runs in a fixed order (taps, then channels), so a call gives
// the same bits from run to run, whichever windows share a tile. Compiled
// for Cin = Cout = 128 or 256 (the T-MAE stage widths).

#include <algorithm>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kRows = 64;                  // cells of a window: wgmma's M
constexpr int kHalo = 10;                  // halo side of an 8 x 8 window
constexpr int kHaloCells = kHalo * kHalo;
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp

// Sizes and the shared-memory plan (byte offsets) at width C.
template <int C>
struct ConvPlan {
  static constexpr int NP = C / kPass;  // passes of 128 output columns
  static constexpr int KQ = C / kKP;    // panels of a tap along the input
  static constexpr int kPanels = NP * 9 * KQ;
  static constexpr int kStages = C == 128 ? 8 : 5;
  static constexpr int kHaloBytes = (C / 8) * kHaloCells * 16;
  static constexpr int kLd = kPass + 8;  // staging row (bf16)
  static constexpr int kStageBytes = kRows * kLd * 2;
  static constexpr int oHalo = kStages * kPanel;
  static constexpr int oStage = oHalo + 2 * kHaloBytes;
  static constexpr int oBar = oStage + 2 * kStageBytes;  // full, empty
                                                         // [kStages], tile
                                                         // full, empty [2]
  static constexpr int oTile = oBar + 8 * (2 * kStages + 4);  // int [2]
  static constexpr int kSmem = oTile + 16;
  static_assert(kSmem <= 232448, "shared memory plan exceeds 227 KB");
};

struct ConvParams {
  const bf16* x;       // [B, H, W, C]
  const int* idx;      // [B, cap, 2] (wy, wx)
  const float* qmask;  // [B, cap, 64]
  const float* bias;   // [C]
  const bf16* panels;  // 9 C^2, written by conv_pack_kernel
  bf16* out;           // [B, cap, 64, C]
  int* flags;          // [nslots] the slot is live
  int* list;           // [nslots] the live slots in slot order
  int* count;          // the number of live slots
  int* counter;        // the next tile to hand out
  int nslots, cap, H, W, nwy, nwx;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup g (named barrier 2 + g)
__device__ __forceinline__ void bar_group(int g) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + g) : "memory");
}

// The m64n128k16 bf16 product with f32 accumulators; A and B from shared
// memory (K-major descriptors), D += A B when `accumulate`, else D = A B.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Window s's 10 x 10 halo into shared memory at `halo`, 16-byte row
// (v, cell) at (v * 100 + cell) * 16: item e is cell (e / 2) % 100, chunk
// 2 ((e / 2) / 100) + e % 2, so a lane pair reads 32 bytes of one cell and
// 8 lanes store to distinct banks. Cells off the grid are zero-filled.
template <int C>
__device__ __forceinline__ void load_halo(const ConvParams& p, long long s,
                                          uint32_t halo, int t) {
  constexpr int VC = C / 8;
  const long long b = s / p.cap;
  const int y0 = 8 * (p.idx[2 * s] - 1) - 1;
  const int x0 = 8 * (p.idx[2 * s + 1] - 1) - 1;
  const bf16* frame = p.x + b * p.H * p.W * C;
  for (int e = t; e < kHaloCells * VC; e += 128) {
    const int cell = (e >> 1) % kHaloCells;
    const int v = 2 * ((e >> 1) / kHaloCells) + (e & 1);
    const int y = y0 + cell / kHalo;
    const int x = x0 + cell % kHalo;
    const bool in = y >= 0 && y < p.H && x >= 0 && x < p.W;
    cp_async16(halo + (v * kHaloCells + cell) * 16,
               in ? frame + ((long long)y * p.W + x) * C + v * 8 : p.x,
               in ? 16 : 0);
  }
  cp_async_wait_all();
}

// One pass of 128 output columns: acc = sum over the 9 taps and C / 64
// panels of the ring of A(tap, chunk) W_t. A panel is released once the
// products reading it have completed; the next panel's products are issued
// first. A warpgroup without a window (the partial last tile) runs the
// products on its stale halo all the same and discards them: no wgmma, and
// no wait on one, sits in a branch.
template <int C>
__device__ __forceinline__ void conv_pass(float (&acc)[64], uint32_t halo,
                                          Ring& rg, int lane) {
  using P = ConvPlan<C>;
  wgmma_fence();
  fence_acc(acc);
  int prev = 0;
#pragma unroll 1
  for (int q = 0; q < 9 * P::KQ; ++q) {
    const int tap = q / P::KQ;
    const int kq = q - tap * P::KQ;
    const int slot = rg.pc % P::kStages;
    mbar_wait(rg.full + 8 * slot, (rg.pc / P::kStages) & 1);
    __syncwarp();
    const uint32_t a =
        halo + ((tap / 3) * kHalo + tap % 3 + kq * 8 * kHaloCells) * 16;
    const uint32_t b = rg.ring + slot * kPanel;
#pragma unroll
    for (int k = 0; k < kKP / 16; ++k)
      wgmma_n128(acc,
                 gdesc(a + 2 * k * kHaloCells * 16, kHalo * 16,
                       kHaloCells * 16),
                 gdesc(b + 2 * k * 128, (kKP / 8) * 128),
                 (q > 0 || k > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (q > 0) release(rg.empty + 8 * prev, lane);
    prev = slot;
    ++rg.pc;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(rg.empty + 8 * prev, lane);
}

// (acc + bias) * qmask in f32, rounded to bf16, into the staging tile, then
// its rows to out[s, cell, 128 pass ..] as 16-byte vectors. Thread rows rA
// and rA + 8 (the window's cells), column pair 8 j + c2 of group j.
template <int C>
__device__ __forceinline__ void epilogue(const ConvParams& p,
                                         const float (&acc)[64], long long s,
                                         int pass, bf16* stage, int rA,
                                         int c2, int t, int g) {
  using P = ConvPlan<C>;
  const float qa = p.qmask[s * kRows + rA];
  const float qb = p.qmask[s * kRows + rA + 8];
#pragma unroll
  for (int j = 0; j < kPass / 8; ++j) {
    const int c = 8 * j + c2;
    const float2 b = ldg2(p.bias + pass * kPass + c);
    *reinterpret_cast<uint32_t*>(stage + rA * P::kLd + c) =
        pack2((acc[4 * j] + b.x) * qa, (acc[4 * j + 1] + b.y) * qa);
    *reinterpret_cast<uint32_t*>(stage + (rA + 8) * P::kLd + c) =
        pack2((acc[4 * j + 2] + b.x) * qb, (acc[4 * j + 3] + b.y) * qb);
  }
  bar_group(g);
  bf16* dst = p.out + s * kRows * C + pass * kPass;
  for (int e = t; e < kRows * kPass / 8; e += 128) {
    const int r = e / (kPass / 8);
    const int ch = e - r * (kPass / 8);
    *reinterpret_cast<uint4*>(dst + (long long)r * C + ch * 8) =
        *reinterpret_cast<const uint4*>(stage + r * P::kLd + ch * 8);
  }
  bar_group(g);  // the next pass or tile overwrites the staging tile
}

// Built with -DTMAE_CONV_PROFILE, consumer thread 0 of each block adds the
// clock cycles of each phase of its tiles (tile handoff, halo, products,
// epilogue; barrier waits included) and its tile count into g_conv_cycles
// (read and reset by tmae_conv_profile; utils/conv_phases.py).
#ifdef TMAE_CONV_PROFILE
__device__ unsigned long long g_conv_cycles[8];
#define PHASE(k)                                  \
  do {                                            \
    if (tid == 0) {                               \
      const long long now = clock64();            \
      prof[k] += now - t_prev;                    \
      t_prev = now;                               \
    }                                             \
  } while (0)
#else
#define PHASE(k) \
  do {           \
  } while (0)
#endif

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    conv_kernel(const ConvParams p) {
  using P = ConvPlan<C>;
  extern __shared__ __align__(1024) unsigned char smem[];
  volatile int* const tile_q = reinterpret_cast<volatile int*>(smem + P::oTile);
  const uint32_t full = saddr(smem + P::oBar);
  const uint32_t empty = full + 8 * P::kStages;
  const uint32_t tfull = empty + 8 * P::kStages;
  const uint32_t tempty = tfull + 16;
  const int tid = threadIdx.x;
  const int count = *p.count;
  const int ntiles = (count + 1) / 2;

  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(tfull + 8 * s, 1);
      mbar_init(tempty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: tile indices, and the panels of every tile -----------
    if (tid != kConsumers) return;
    const uint32_t ring = saddr(smem);
    int pc = 0;
    for (int tc = 0;; ++tc) {
      const int tile = atomicAdd(p.counter, 1);
      mbar_wait(tempty + 8 * (tc & 1), ((tc >> 1) & 1) ^ 1);
      tile_q[tc & 1] = tile;
      mbar_arrive(tfull + 8 * (tc & 1));
      if (tile >= ntiles) return;
      for (int q = 0; q < P::kPanels; ++q, ++pc) {
        const int slot = pc % P::kStages;
        mbar_wait(empty + 8 * slot, ((pc / P::kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * slot, kPanel);
        bulk_load(ring + slot * kPanel, p.panels + (long long)q * (kPanel / 2),
                  kPanel, full + 8 * slot);
      }
    }
  }

  // ---- consumers: warpgroup g takes window 2 tile + g of the list -------
  const int g = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  const int rA = 16 * (t >> 5) + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const uint32_t halo = saddr(smem + P::oHalo + g * P::kHaloBytes);
  bf16* const stage =
      reinterpret_cast<bf16*>(smem + P::oStage + g * P::kStageBytes);
  Ring rg{saddr(smem), full, empty, 0};
#ifdef TMAE_CONV_PROFILE
  long long prof[5] = {0}, t_prev = clock64();
#endif
  for (int tc = 0;; ++tc) {
    mbar_wait(tfull + 8 * (tc & 1), (tc >> 1) & 1);
    const int tile = tile_q[tc & 1];
    release(tempty + 8 * (tc & 1), lane);
    PHASE(0);
    if (tile >= ntiles) break;
    const int j = 2 * tile + g;
    const bool has = j < count;
    const long long s = has ? p.list[j] : 0;
    if (has) load_halo<C>(p, s, halo, t);
    fence_async_smem();
    bar_group(g);
    PHASE(1);
#pragma unroll 1
    for (int pass = 0; pass < P::NP; ++pass) {
      float acc[64];
      conv_pass<C>(acc, halo, rg, lane);
      PHASE(2);
      if (has) epilogue<C>(p, acc, s, pass, stage, rA, c2, t, g);
      PHASE(3);
    }
#ifdef TMAE_CONV_PROFILE
    if (tid == 0) ++prof[4];
#endif
  }
#ifdef TMAE_CONV_PROFILE
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 5; ++k)
      atomicAdd(&g_conv_cycles[k], (unsigned long long)prof[k]);
  }
#endif
}

// One warp per slot: the live flag, and zeros on the output row of a slot
// that is not live (the dummy row, or no query).
template <int C>
__global__ void __launch_bounds__(256)
    conv_prepass_kernel(const ConvParams p) {
  const int lane = threadIdx.x & 31;
  const long long s = blockIdx.x * 8LL + (threadIdx.x >> 5);
  if (s >= p.nslots) return;
  const int wy = p.idx[2 * s], wx = p.idx[2 * s + 1];
  bool q = false;
  if (wy >= 0 && wy < p.nwy && wx >= 0 && wx < p.nwx)
    for (int i = lane; i < kRows; i += 32) q |= p.qmask[s * kRows + i] != 0.f;
  const bool live = __any_sync(0xffffffffu, q);
  if (lane == 0) p.flags[s] = live;
  if (live) return;
  uint4* dst = reinterpret_cast<uint4*>(p.out + s * kRows * C);
  for (int e = lane; e < kRows * C / 8; e += 32)
    dst[e] = make_uint4(0u, 0u, 0u, 0u);
}

// wmat [9, C, C] into the panels (layout in wgmma_tiles.cuh), panel q =
// (pass 9 + tap) KQ + kq: one thread per 16-byte core-matrix row (n, 8
// channels kc), n fastest, so a warp reads 32 consecutive output columns
// of each of its 8 weight rows.
template <int C>
__global__ void __launch_bounds__(256)
    conv_pack_kernel(const bf16* __restrict__ wmat,
                     bf16* __restrict__ out) {
  using P = ConvPlan<C>;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P::kPanels * (kPanel / 16)) return;
  const int n = e % kPass;
  const int kc = (e / kPass) % (kKP / 8);
  const int q = e / (kPass * (kKP / 8));
  const int kq = q % P::KQ;
  const int tap = (q / P::KQ) % 9;
  const int pass = q / (P::KQ * 9);
  const bf16* src =
      wmat + ((long long)tap * C + kq * kKP + kc * 8) * C + pass * kPass + n;
  uint4 v;
  bf16* pv = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) pv[i] = src[i * C];
  reinterpret_cast<uint4*>(out + (long long)q * (kPanel / 2))
      [((n / 8) * 8 + kc) * 8 + n % 8] = v;
}

// pack, pre-pass, compact, main kernel; a cudaError_t, 0 when all launched
template <int C>
int launch(ConvParams p, const bf16* wmat, bf16* panels, cudaStream_t s) {
  using P = ConvPlan<C>;
  constexpr int rows = P::kPanels * (kPanel / 16);
  conv_pack_kernel<C><<<(rows + 255) / 256, 256, 0, s>>>(wmat, panels);
  int e = tmae_last_error();
  if (e) return e;
  conv_prepass_kernel<C><<<(p.nslots + 7) / 8, 256, 0, s>>>(p);
  if ((e = tmae_last_error())) return e;
  compact_kernel<<<1, 1024, 0, s>>>(p.flags, p.list, p.count, p.counter,
                                   p.nslots);
  if ((e = tmae_last_error())) return e;
  static unsigned long long set_on = 0;  // for each instance
  if ((e = smem_limit_once((const void*)conv_kernel<C>, P::kSmem, set_on)))
    return e;
  const int blocks = std::min(sm_count(), (p.nslots + 1) / 2);
  conv_kernel<C><<<blocks, kThreads, P::kSmem, s>>>(p);
  return tmae_last_error();
}

}  // namespace

#ifdef TMAE_CONV_PROFILE
// Copies the phase cycle sums into out[8] and resets them.
extern "C" int tmae_conv_profile(unsigned long long* out8) {
  static const unsigned long long zero[8] = {};
  const int e = (int)cudaMemcpyFromSymbol(out8, g_conv_cycles, sizeof zero);
  return e ? e : (int)cudaMemcpyToSymbol(g_conv_cycles, zero, sizeof zero);
}
#endif

// The dynamic shared memory of the main kernel at width C (-1: not built).
extern "C" int subm_conv_smem(int C) {
  return C == 128 ? ConvPlan<128>::kSmem
                  : C == 256 ? ConvPlan<256>::kSmem : -1;
}

// out [B, cap, 64, C] bf16 = the SubM conv of xg [B, H, W, C] bf16 with
// wmat [3, 3, C, C] bf16 and bias [C] f32 on the windows idx [B, cap, 2]
// of the unshifted plan, masked by qmask [B, cap, 64] f32. Workspaces:
// `panels` 9 C^2 bf16, `ints` int32 [2 B cap + 2]. C = 128 or 256.
extern "C" int launch_subm_conv(const void* xg, const void* idx,
                                const void* qmask, const void* wmat,
                                const void* bias, void* out, void* panels,
                                void* ints, int B, int H, int W, int C,
                                int cap, int nwy, int nwx, void* stream) {
  if (C != 128 && C != 256) return (int)cudaErrorInvalidValue;
  if (cap == 0 || B == 0) return 0;
  ConvParams p{};
  p.x = static_cast<const bf16*>(xg);
  p.idx = static_cast<const int*>(idx);
  p.qmask = static_cast<const float*>(qmask);
  p.bias = static_cast<const float*>(bias);
  p.panels = static_cast<const bf16*>(panels);
  p.out = static_cast<bf16*>(out);
  p.nslots = B * cap;
  int* w = static_cast<int*>(ints);
  p.flags = w;
  p.list = w + p.nslots;
  p.count = w + 2 * p.nslots;
  p.counter = w + 2 * p.nslots + 1;
  p.cap = cap;
  p.H = H;
  p.W = W;
  p.nwy = nwy;
  p.nwx = nwx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* wm = static_cast<const bf16*>(wmat);
  bf16* pn = static_cast<bf16*>(panels);
  return C == 128 ? launch<128>(p, wm, pn, s) : launch<256>(p, wm, pn, s);
}
