// Kernels K3, K4, K6, K8, K10 and K12 for Hopper: the cosine-attention
// encoder layer as one persistent kernel over tiles of live windows, with
// three addressings. Every call computes one of two functions on 8x8
// windows: the full-window layer (T = 64 cells, the output masked to zero
// where no query: K3, K6, K10, K12 on a full plan) or the packed layer on S =
// 16 or 48 selected cells (x plus the layer's masked delta on those cells,
// every other cell kept: K4, K8, K12 on a small or mid plan).
//
// K8 replaces tmae_tpu/ops/pallas_encoder.py:995 _pallas_forward_sel (its
// pallas_call at :1038; kernel _kernel_sel -> _layer_body_sel): out [N, 64,
// C] is xw [N, 64, C] plus the layer's delta on the S cells that sel_q
// [N, S] names, masked by the query mask; every other cell passes through.
// K6 replaces :314 _pallas_forward (its pallas_call at :346; kernel _kernel
// -> _layer_body): out [N, 64, C] is the full-window layer of xw [N, 64, C]
// with f32 masks [N, 64]. K4 replaces :1696 encoder_layer_rows_sel (its
// pallas_call at :1724; kernel _kernel_rows_sel -> _layer_body_sel): K8's
// function in place on rows [row_lo, row_lo + cap) of the gathered window
// tensor xw_all [B, total, 64, C], masks and selections [B, cap, S]: window
// w = b cap + j is row b total + row_lo + j, and only its occupied selected
// cells are written. K3 replaces :1654 encoder_layer_rows_full (its
// pallas_call at :1680; kernel _kernel_rows_full -> _layer_body): K6's
// function in place on K4's rows, masks [B, cap, 64]. K12 replaces :2066
// encoder_layer_fused_pipelined (its pallas_call at :2121; kernel
// _kernel_fused_piped) and closes :1875 encoder_layer_fused_inplace (:1933),
// which compute the same function: the K3 (T = 64) or K4 (S = 16, 48) layer
// on the windows of one bucket plan idx [B, cap, 2], read and written
// straight in the padded carrier [B, Hp + 8, Wp, C]: window w = b cap + j is
// (wy, wx) = idx[b, j], and its cell c is carrier cell (8 wy + c / 8, 8 wx +
// c % 8) of frame b (kv's carrier at the same cell in cross mode). A dummy
// slot (wy >= nwy = (Hp + 8) / 8 - 1: the plan's padding, which names the
// window row below the grid) is never a window here: never read, never
// written. The in-place updates (K3, K4, K12) are safe because a tile loads
// all its rows into shared memory (load_rows) before it writes any, the
// windows are disjoint, and kv (cross mode) is another tensor. K10 replaces
// :1440 _grid_forward (its pallas_call at :1483; kernel _grid_kernel ->
// _layer_body): the full-window layer on every 8x8 window of the shift's
// partition of a [B, H, W, C] grid. The partition has ceil(H/8) + 1 rows and
// ceil(W/8) + 1 columns of windows, offset by 8 cells (shift 0) or 4 (shift
// 1): cell (iy, ix) of window (wy, wx) is grid cell (8 wy + iy - off, 8 wx +
// ix - off); a cell off the grid reads as zero and unoccupied and is never
// written. The masks are the grid's occupancy bytes.
//
// Bound on this card. The layer does ~19 MFLOP on a 64-row window at
// C = 128 (2*T*C*C*4 + 2*T*C*F*2 + 2*T*T*C*2), so the work on live windows is
// microseconds of tensor time: K3, K4, K6 and K12 are bound by those
// operations on the training and serving buckets, K8 and K10 by the bytes
// they must move (K8 copies every unselected cell through, 42 MB read and
// written on the training batch's 2560 slots at C = 128; K10 writes the
// whole output grid).
// What held the earlier design (one block of 8 warps per window,
// encoder_layer.cu) back: a block for every window, live or not (K10 ran
// 14400 blocks for 1399 live windows; K3, K4, K6, K8 and K12 ran every
// padding slot); every weight fragment read from L2 per window (256 KiB at
// C = 128); WMMA fragments loaded through registers; 16-row products at
// S = 16.
//
// Design (launches on the caller's stream, no host synchronisation):
//   1. pack_kernel: the six Linear weights into 16 KiB panels in wgmma's
//      core-matrix layout (below), in the order the products use them. The
//      training calls (K6, K8, K10) pack their bf16 weights in every call;
//      a served layer packs its f32 master weights once per forward
//      (launch_pack_panels, rounding each to bf16 to nearest even) for all
//      its bucket calls, and K3, K4 and K12 take the panels as they are.
//   2. A pre-pass, one warp per window, that flags the window live when it
//      has an occupied query cell: sel_prepass_kernel (K8) reads the query
//      mask and copies through every cell the main kernel will not write (all
//      64 when the window is not live); grid_prepass_kernel (K10) reads the
//      occupancy bytes and writes zeros on the in-grid cells of a window that
//      is not live; mask_prepass_kernel reads the query mask and writes
//      zeros on all 64 cells of such a window (K6, K3) or nothing (K4: its
//      output is its input); plan_prepass_kernel (K12) also never flags a
//      dummy slot, and at T = 64 writes zeros on the 64 carrier cells of a
//      real slot without a query (at S = 16, 48 nothing). Empty windows cost
//      their bytes and nothing else.
//   3. compact_kernel, one block: the live windows in window order into a
//      list, their count, and the tile counter set to 0; both stay on the
//      device.
//   4. tiled_kernel, persistent: one block of two consumer warpgroups and a
//      producer warp per SM takes tiles of 64 rows from the counter: four
//      live windows at S = 16 (block-diagonal attention: each window's
//      queries see only its own keys and key mask), one window padded to 64
//      rows at S = 48 (16 rows of zeros with no query or key: the simple
//      choice; three windows in four tiles would need rows of one window in
//      two tiles), one window at T = 64. A partial last tile has rows of no
//      window, also zeros with no query or key. Rows of no window are never
//      written. The addressing (window rows, plan cells or grid cells) is a
//      template parameter, decided once per tile in tile_rows; nothing else
//      in the tile depends on it.
//      The producer thread streams the weight panels through a ring in shared
//      memory with cp.async.bulk (completion counted on an mbarrier), the
//      same panel sequence for every tile, so each weight byte is read from
//      L2 once per tile and used by its 64 rows; the ring runs ahead into
//      the next tile while the consumers finish this one. The tile index
//      goes from producer to consumers through a two-slot mbarrier ring.
//      The consumers run the q, k, v and output projections and both FFN
//      products as wgmma m64n64k16 (bf16 in, f32 accumulators in
//      registers), with A (the tile's rows) and B (the panel) in shared
//      memory, in passes of 128 output columns, 64 for each warpgroup: 32
//      accumulators a thread a pass keep a thread of the 288-thread block
//      within its 168 registers at C = 256 (m64n128 products, 64 a thread,
//      spilled). Epilogues run on the accumulator fragments: bias, per-head
//      L2 normalisation (a head's columns lie in one thread quad), GELU,
//      and the LayerNorm rows (quad shuffles, then one exchange of row sums
//      between the two warpgroups through shared memory). The residual h1
//      stays in the accumulator registers across the FFN, and the second
//      FFN product accumulates onto it. Attention (q k^T per head, softmax,
//      p v) is small (16 to 64 keys, head width 16 or 32): one warp per
//      (16 query rows, head) with mma.sync m16n8k16 on ldmatrix fragments,
//      p kept in registers between the two products.
//
// Panel layout (bf16): a panel is the 128 output rows [128 pass, 128 pass +
// 128) of one Linear weight W [out, in] by the 64 input columns [64 kq, 64 kq
// + 64), 16 KiB. Element (n, k) of a panel is at ((n / 8) * 8 + k / 8) * 64
// + (n % 8) * 8 + k % 8: 8 x 8 core matrices of 128 contiguous bytes,
// K-adjacent ones 128 bytes apart (the descriptor's leading byte offset),
// 8-row groups 1 KiB apart (its stride byte offset), no swizzle. Warpgroup
// g reads rows [64 g, 64 g + 64). Order: for q, k, v, o, the FFN's first and
// second product in turn, pass by pass, the panels along the input: 16
// panels a tile at C = 128, 64 at C = 256.
// The tile's row buffers [64 x width] use the same core-matrix layout, so
// every wgmma operand is a descriptor into shared memory.
//
// Shared memory: the panel ring (6 stages at C = 128, 3 at C = 256) and five
// row buffers of [64 x C] bf16 (XS: the raw tokens; A0: x + pos, then the
// key tokens in cross mode, then the attention output; QN, KN, VB: the
// normalised q and k and v; after attention QN holds h1 in bf16 and KN..VB
// the FFN hidden [64 x 2C], then the output tile): 176 KiB at C = 128, 208
// KiB at C = 256.
//
// Numerics held to the TPU kernel: q = (x+pos)Wq+bq and k = (kv+pos)Wk+bk
// with x+pos rounded to bf16; per-head L2 normalisation rsqrt(sum^2 + 1e-24)
// in f32, q scaled by 1/max(tau, tau_min), both rounded to bf16; masked keys
// filled with -30000 before a per-head softmax; a window with no key gets
// p = 0; p and the attention output rounded to bf16; the attention delta
// lands on occupied query cells only, then LayerNorm (eps 1e-5) in f32 and
// a zero for unoccupied cells; exact-erf GELU on bf16 operands; the f32
// residual; LayerNorm. The packed
// layer (K4, K8, K12 at S = 16, 48) writes x + bf16(y - x) on its occupied
// selected cells, the full-window layer (K3, K6, K10, K12 at T = 64) y on
// occupied cells and 0 on the other (in-grid) cells. No sum crosses a
// window, and every sum runs in a fixed order, so a call gives the same bits
// from run to run.
//
// Compiled for the T-MAE widths only: C = 128 or 256, 8 heads, FFN 2C, and
// S = 16 or 48 (K4, K8, K12) or T = 64 (K3, K6, K10, K12).

#include <algorithm>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;                  // rows of a tile: wgmma's M
constexpr int kCells = 64;                 // cells of an 8 x 8 window
constexpr int kHeads = 8;
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kPanel = 16384;              // bytes of a weight panel:
constexpr int kPass = 128;                 // its output rows (64 a warpgroup)
constexpr int kKP = 64;                    // by its input columns

// Sizes and the shared-memory plan (byte offsets) at width C.
template <int C>
struct Plan {
  static constexpr int F = 2 * C;
  static constexpr int D = C / kHeads;
  static constexpr int NPC = C / kPass;  // passes of a product to C outputs
  static constexpr int NA = 32 * NPC;    // a row of C: f32 a thread
  static constexpr int PC = C / kKP;     // panels of a pass over C inputs
  static constexpr int PF = F / kKP;     // ... over F inputs
  // q k v o: NPC passes of PC panels; the FFN: F / kPass passes of PC, then
  // NPC passes of PF
  static constexpr int kPanels = 4 * NPC * PC + (F / kPass) * PC + NPC * PF;
  static constexpr int kStages = C == 128 ? 6 : 3;
  static constexpr int kBuf = kRows * C * 2;
  static constexpr int oXS = kStages * kPanel;
  static constexpr int oA0 = oXS + kBuf;
  static constexpr int oQN = oA0 + kBuf;
  static constexpr int oKN = oQN + kBuf;  // KN..VB: the FFN hidden, the output
  static constexpr int oVB = oKN + kBuf;
  static constexpr int oQoff = oVB + kBuf;  // long long [64] each
  static constexpr int oKoff = oQoff + 8 * kRows;
  static constexpr int oQcell = oKoff + 8 * kRows;  // int [64] each
  static constexpr int oKcell = oQcell + 4 * kRows;
  static constexpr int oQm = oKcell + 4 * kRows;  // float [64] each
  static constexpr int oKm = oQm + 4 * kRows;
  static constexpr int oRed = oKm + 4 * kRows;  // float [2 stats][2 wg][64]
  static constexpr int oBar = oRed + 16 * kRows;  // full, empty [kStages],
                                                  // tile full, empty [2]
  static constexpr int oTile = oBar + 8 * (2 * kStages + 4);  // int [2]
  static constexpr int kSmem = oTile + 16;
  static_assert(kSmem <= 232448, "shared memory plan exceeds 227 KB");
  static_assert((C + 8) * 2 * kRows <= 2 * kBuf, "output tile does not fit");
};

// How a tile finds its rows: window rows of a [.., 64, C] tensor (K3, K4,
// K6, K8), cells of a plan's windows in the padded carrier (K12) or cells of
// the grid's shifted partition (K10).
enum Addr { kWindowRows, kPlanCells, kGridCells };
// What a call computes and where (K8, K4, K6, K3, K10, K12): the pre-pass,
// the addressing and whether the call packs its weights follow.
enum Mode { kSelOut, kSelInPlace, kFullOut, kFullInPlace, kGridOut,
            kPlanInPlace };

struct FwdParams {
  const bf16 *x, *kv, *pos;
  bf16* out;  // == x for K3, K4 and K12 (in place)
  const int *selq, *selk;
  const float *qmask, *kmask;
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

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
          bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed. A
// phase that never completes (a fault in the pipeline) traps after ~2^34
// cycles, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 34))
      __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the 256 consumer threads (named barrier 1; the producer never joins it)
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across a wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major: 8 x 16-byte core
// matrices, K-adjacent ones 128 bytes apart, 8-row groups `sbo` apart.
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}


// The m64n64k16 bf16 product with f32 accumulators; A and B from shared
// memory (K-major descriptors), D += A B when `accumulate`, else D = A B.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// byte offset of element (r, c) of a core-matrix row buffer with `ch`
// 8-column chunks a row
__device__ __forceinline__ uint32_t core(int r, int c, int ch) {
  return ((r >> 3) * ch + (c >> 3)) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

// the bf16 pair at (r, c), (r, c + 1) of a core-matrix row buffer with
// `ch` chunks a row, as floats; and the store of one
__device__ __forceinline__ float2 ld_pair(const unsigned char* buf, int r,
                                          int c, int ch) {
  return unpack2(*reinterpret_cast<const uint32_t*>(buf + core(r, c, ch)));
}

__device__ __forceinline__ void st_pair(unsigned char* buf, int r, int c,
                                        int ch, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(buf + core(r, c, ch)) = pack2(lo, hi);
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// What one consumer thread is: its warpgroup g (which owns output columns
// [128 p + 64 g, 128 p + 64 g + 64) of pass p of a product), its rows rA and
// rB = rA + 8 of every accumulator, and its column pair 2 * (lane % 4)
// within each 8-column chunk.
struct Who {
  int cw, g, lane, rA, rB, c2;
};

// The column of 4-value group j of a thread's accumulators (j / 8: the
// pass; j % 8: the 8-column chunk within the warpgroup's 64)
__device__ __forceinline__ int col(int j, const Who& w) {
  return (j >> 3) * kPass + w.g * (kPass / 2) + 8 * (j & 7) + w.c2;
}

// the 32 accumulators of pass `pass` within a thread's row of NA
template <int NA>
__device__ __forceinline__ float (&pass_acc(float (&acc)[NA], int pass))[32] {
  return *reinterpret_cast<float(*)[32]>(acc + 32 * pass);
}

// The weight-panel ring as the consumers walk it: `pc` counts the panels
// taken so far (the producer streams the same sequence).
struct Ring {
  uint32_t ring, full, empty;
  int pc;
};

__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// One pass: acc (+)= A W^T over `npanels` panels of the ring: A is the row
// buffer at `a` with `a_ch` 8-column chunks a row; each panel holds this
// pass's 128 rows of W (64 for each warpgroup) by 64 input columns. A panel
// is released once the products reading it have completed; the next
// panel's products are issued first.
template <int C>
__device__ __forceinline__ void product(float (&acc)[32], uint32_t a,
                                        int a_ch, int npanels,
                                        bool accumulate, Ring& rg,
                                        const Who& w) {
  using P = Plan<C>;
  constexpr int KP = kKP;
  wgmma_fence();
  fence_acc(acc);
  const uint32_t b_half = w.g * (kPass / 16) * (KP / 8) * 128;
  int prev = -1;
  for (int q = 0; q < npanels; ++q) {
    const int slot = rg.pc % P::kStages;
    mbar_wait(rg.full + 8 * slot, (rg.pc / P::kStages) & 1);
    __syncwarp();
    const uint32_t b = rg.ring + slot * kPanel + b_half;
#pragma unroll
    for (int s = 0; s < KP / 16; ++s)
      wgmma_n64(acc, gdesc(a + (q * (KP / 8) + 2 * s) * 128, a_ch * 128),
                gdesc(b + 2 * s * 128, (KP / 8) * 128),
                (accumulate || q > 0 || s > 0) ? 1 : 0);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      release(rg.empty + 8 * prev, w.lane);
    }
    prev = slot;
    ++rg.pc;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(rg.empty + 8 * prev, w.lane);
}

// dst = bf16(normalise_per_head(acc + bias) * mult) for pass `pass`: a
// warpgroup's 64 columns hold 64 / D heads of D = C / 8, each in D / 8
// chunks of a thread quad.
template <int C>
__device__ __forceinline__ void epi_heads(const float (&acc)[32], int pass,
                                          unsigned char* dst,
                                          const float* bias, float mult,
                                          const Who& w) {
  using P = Plan<C>;
  constexpr int CPH = P::D / 8;
#pragma unroll
  for (int h = 0; h < 64 / P::D; ++h) {
    float v[CPH][4];
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int t = 0; t < CPH; ++t) {
      const int j = h * CPH + t;
      const float2 b = ldg2(bias + col(8 * pass + j, w));
      v[t][0] = acc[4 * j] + b.x;
      v[t][1] = acc[4 * j + 1] + b.y;
      v[t][2] = acc[4 * j + 2] + b.x;
      v[t][3] = acc[4 * j + 3] + b.y;
      sa += v[t][0] * v[t][0] + v[t][1] * v[t][1];
      sb += v[t][2] * v[t][2] + v[t][3] * v[t][3];
    }
    const float ra = rsqrtf(quad_sum(sa) + 1e-24f);
    const float rb = rsqrtf(quad_sum(sb) + 1e-24f);
#pragma unroll
    for (int t = 0; t < CPH; ++t) {
      const int c = col(8 * pass + h * CPH + t, w);
      st_pair(dst, w.rA, c, C / 8, v[t][0] * ra * mult, v[t][1] * ra * mult);
      st_pair(dst, w.rB, c, C / 8, v[t][2] * rb * mult, v[t][3] * rb * mult);
    }
  }
}

// dst = bf16(acc + bias), or with `gelu` bf16(gelu(acc + bias)), for pass
// `pass` of a product; dst has `ch` chunks a row.
template <bool kGelu>
__device__ __forceinline__ void epi_plain(const float (&acc)[32], int pass,
                                          unsigned char* dst, int ch,
                                          const float* bias, const Who& w) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = col(8 * pass + j, w);
    const float2 b = ldg2(bias + c);
    float v[4] = {acc[4 * j] + b.x, acc[4 * j + 1] + b.y,
                  acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y};
    if constexpr (kGelu) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = 0.5f * v[e] * (1.f + erff(v[e] * 0.70710678118654752f));
    }
    st_pair(dst, w.rA, c, ch, v[0], v[1]);
    st_pair(dst, w.rB, c, ch, v[2], v[3]);
  }
}

// LayerNorm of the accumulator rows in place (each row's C columns are
// split between the two warpgroups): row sums over the thread's columns,
// the quad, then the two warpgroups through `red` [2 stats][2 wg][64].
// acc holds the NPC passes of a product with C outputs.
template <int C>
__device__ __forceinline__ void layer_norm(float (&acc)[Plan<C>::NA],
                                           const float* scale,
                                           const float* bias, float* red,
                                           const Who& w) {
  using P = Plan<C>;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < P::NA / 4; ++j) {
    sa += acc[4 * j] + acc[4 * j + 1];
    sb += acc[4 * j + 2] + acc[4 * j + 3];
  }
  sa = quad_sum(sa);
  sb = quad_sum(sb);
  if ((w.lane & 3) == 0) {
    red[w.g * kRows + w.rA] = sa;
    red[w.g * kRows + w.rB] = sb;
  }
  bar_consumers();
  const float ma = (red[w.rA] + red[kRows + w.rA]) * (1.f / C);
  const float mb = (red[w.rB] + red[kRows + w.rB]) * (1.f / C);
  float qa = 0.f, qb = 0.f;
#pragma unroll
  for (int j = 0; j < P::NA / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float da = acc[4 * j + e] - ma;
      const float db = acc[4 * j + 2 + e] - mb;
      qa += da * da;
      qb += db * db;
    }
  }
  qa = quad_sum(qa);
  qb = quad_sum(qb);
  float* red2 = red + 2 * kRows;
  if ((w.lane & 3) == 0) {
    red2[w.g * kRows + w.rA] = qa;
    red2[w.g * kRows + w.rB] = qb;
  }
  bar_consumers();
  const float ra =
      rsqrtf((red2[w.rA] + red2[kRows + w.rA]) * (1.f / C) + 1e-5f);
  const float rb =
      rsqrtf((red2[w.rB] + red2[kRows + w.rB]) * (1.f / C) + 1e-5f);
#pragma unroll
  for (int j = 0; j < P::NA / 4; ++j) {
    const int c = col(j, w);
    const float2 s = ldg2(scale + c);
    const float2 b = ldg2(bias + c);
    acc[4 * j] = (acc[4 * j] - ma) * ra * s.x + b.x;
    acc[4 * j + 1] = (acc[4 * j + 1] - ma) * ra * s.y + b.y;
    acc[4 * j + 2] = (acc[4 * j + 2] - mb) * rb * s.x + b.x;
    acc[4 * j + 3] = (acc[4 * j + 3] - mb) * rb * s.y + b.y;
  }
}

// Copies the 64 token rows of a tile into row buffers (core-matrix layout):
// row r is the row at base + offs[r] (zeros where offs[r] < 0); `raw` gets
// the bf16 values, `with_pos` bf16(x + pos[cells[r]]). Either may be null.
// A warp takes 8 rows x 4 chunks: 64 contiguous bytes of each row from
// device memory, 8 rows of one core matrix at a time into shared memory.
// Plain loads, not the read-only path: K3's, K4's and K12's rows are also
// their output.
template <int C>
__device__ __forceinline__ void load_rows(unsigned char* raw,
                                          unsigned char* with_pos,
                                          const bf16* base,
                                          const long long* offs,
                                          const int* cells, const bf16* pos,
                                          int ctid) {
  constexpr int CH = C / 8;
  for (int e = ctid; e < kRows * CH; e += kConsumers) {
    const int l = e & 31;
    const int u = e >> 5;
    const int r = (u / (CH / 4)) * 8 + (l & 7);
    const int ch = (u % (CH / 4)) * 4 + (l >> 3);
    const long long o = offs[r];
    const uint4 x = o >= 0 ? *reinterpret_cast<const uint4*>(base + o +
                                                             ch * 8)
                           : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t so = ((r >> 3) * CH + ch) * 128 + (r & 7) * 16;
    if (raw) *reinterpret_cast<uint4*>(raw + so) = x;
    if (with_pos) {
      const uint4 ps = __ldg(
          reinterpret_cast<const uint4*>(pos + cells[r] * C + ch * 8));
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
      *reinterpret_cast<uint4*>(with_pos + so) = s;
    }
  }
}

// Attention of the tile: the 4 blocks of 16 query rows x 8 heads, one warp
// per (block, head). A query block sees NK keys from key0: its own window's
// 16 at T = 16, the window's T otherwise. Writes bf16(p v) into att.
template <int T, int C>
__device__ __forceinline__ void attention(uint32_t qn, uint32_t kn,
                                          uint32_t vb, unsigned char* att,
                                          const float* km, const Who& w) {
  constexpr int D = C / kHeads;
  constexpr int CH = C / 8;
  constexpr int NK = T == 16 ? 16 : T;
  const int lane = w.lane;
  const int q4 = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int l8 = lane & 7;
  const int h = w.cw;
#pragma unroll 1
  for (int m = 0; m < 4; ++m) {
    const int key0 = T == 16 ? 16 * m : 0;
    bool hk = false;
    for (int k = lane; k < NK; k += 32) hk |= km[key0 + k] > 0.f;
    hk = __any_sync(0xffffffffu, hk);
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      const int row = 16 * m + 8 * (q4 & 1) + l8;
      const int chunk = (h * D + 16 * t) / 8 + (q4 >> 1);
      ldsm_x4(qa[t], qn + ((row >> 3) * CH + chunk) * 128 + (row & 7) * 16);
    }
    float s[NK / 8][4];
#pragma unroll
    for (int n = 0; n < NK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int np = 0; np < NK / 16; ++np) {
#pragma unroll
      for (int t = 0; t < D / 16; ++t) {
        uint32_t b[4];
        const int key = key0 + 16 * np + 8 * (q4 >> 1) + l8;
        const int chunk = (h * D + 16 * t) / 8 + (q4 & 1);
        ldsm_x4(b, kn + ((key >> 3) * CH + chunk) * 128 + (key & 7) * 16);
        mma16816(s[2 * np], qa[t], b[0], b[1]);
        mma16816(s[2 * np + 1], qa[t], b[2], b[3]);
      }
    }
    float ma = -CUDART_INF_F, mb = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!(km[key0 + 8 * n + w.c2 + e] > 0.f)) {
          s[n][e] = -30000.f;
          s[n][2 + e] = -30000.f;
        }
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
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int t = 0; t < NK / 16; ++t) {
      const uint32_t pa[4] = {
          pack2(s[2 * t][0] * ia, s[2 * t][1] * ia),
          pack2(s[2 * t][2] * ib, s[2 * t][3] * ib),
          pack2(s[2 * t + 1][0] * ia, s[2 * t + 1][1] * ia),
          pack2(s[2 * t + 1][2] * ib, s[2 * t + 1][3] * ib)};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        const int key = key0 + 16 * t + 8 * (q4 & 1) + l8;
        const int chunk = h * D / 8 + 2 * dp + (q4 >> 1);
        ldsm_x4_t(b, vb + ((key >> 3) * CH + chunk) * 128 + (key & 7) * 16);
        mma16816(o[2 * dp], pa, b[0], b[1]);
        mma16816(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    const int ra = 16 * m + (lane >> 2);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = h * D + 8 * n + w.c2;
      st_pair(att, ra, c, CH, o[n][0], o[n][1]);
      st_pair(att, ra + 8, c, CH, o[n][2], o[n][3]);
    }
  }
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

// Built with -DTMAE_FWD_PROFILE, consumer thread 0 of each block adds the
// clock cycles of every phase of its tiles (its own view: a phase ends when
// that thread leaves it, barrier waits included) and its tile count into
// g_fwd_cycles (read and reset by tmae_fwd_profile; utils/fwd_phases.py).
#ifdef TMAE_FWD_PROFILE
__device__ unsigned long long g_fwd_cycles[16];
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

template <Addr A, int T, int C>
__global__ void __launch_bounds__(kThreads, 1)
    tiled_kernel(const FwdParams p) {
  using P = Plan<C>;
  constexpr int WPT = T == 16 ? 4 : 1;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* const XS = smem + P::oXS;
  unsigned char* const A0 = smem + P::oA0;
  unsigned char* const QN = smem + P::oQN;
  unsigned char* const KN = smem + P::oKN;
  long long* const qoff = reinterpret_cast<long long*>(smem + P::oQoff);
  long long* const koff = reinterpret_cast<long long*>(smem + P::oKoff);
  int* const qcell = reinterpret_cast<int*>(smem + P::oQcell);
  int* const kcell = reinterpret_cast<int*>(smem + P::oKcell);
  float* const qm = reinterpret_cast<float*>(smem + P::oQm);
  float* const km = reinterpret_cast<float*>(smem + P::oKm);
  float* const red = reinterpret_cast<float*>(smem + P::oRed);
  volatile int* const tile_q = reinterpret_cast<volatile int*>(smem + P::oTile);
  const uint32_t full = saddr(smem + P::oBar);
  const uint32_t empty = full + 8 * P::kStages;
  const uint32_t tfull = empty + 8 * P::kStages;
  const uint32_t tempty = tfull + 16;
  const int tid = threadIdx.x;
  const int count = *p.count;
  const int ntiles = (count + WPT - 1) / WPT;

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

  // ---- consumers ----------------------------------------------------------
  Who w;
  w.cw = tid >> 5;
  w.g = tid >> 7;
  w.lane = tid & 31;
  w.rA = 16 * (w.cw & 3) + (w.lane >> 2);
  w.rB = w.rA + 8;
  w.c2 = 2 * (w.lane & 3);
  Ring rg{saddr(smem), full, empty, 0};
  const float scale = 1.f / fmaxf(p.tau[0], p.tau_min);
  const uint32_t aA0 = saddr(A0), aXS = saddr(XS), aQN = saddr(QN),
                 aKN = saddr(KN), aVB = saddr(smem + P::oVB);
#ifdef TMAE_FWD_PROFILE
  long long prof[11] = {0}, t_prev = clock64();
#endif
  for (int tc = 0;; ++tc) {
    mbar_wait(tfull + 8 * (tc & 1), (tc >> 1) & 1);
    const int tile = tile_q[tc & 1];
    release(tempty + 8 * (tc & 1), w.lane);
    PHASE(0);
    if (tile >= ntiles) break;

    if (tid < kRows)
      tile_rows<A, T, C>(p, tile, count, tid, qoff, koff, qcell, kcell, qm,
                         km);
    bar_consumers();
    load_rows<C>(XS, A0, p.x, qoff, qcell, p.pos, tid);
    fence_async_smem();
    bar_consumers();
    PHASE(1);

    // q, k, v for all heads (cross mode: the key tokens replace A0)
#pragma unroll 1
    for (int pass = 0; pass < P::NPC; ++pass) {
      float a[32];
      product<C>(a, aA0, C / 8, P::PC, false, rg, w);
      epi_heads<C>(a, pass, QN, p.bq, scale, w);
    }
    PHASE(2);
    if (p.cross) {
      bar_consumers();  // both warpgroups are done with A0
      load_rows<C>(nullptr, A0, p.kv, koff, kcell, p.pos, tid);
      fence_async_smem();
      bar_consumers();
    }
#pragma unroll 1
    for (int pass = 0; pass < P::NPC; ++pass) {
      float a[32];
      product<C>(a, aA0, C / 8, P::PC, false, rg, w);
      epi_heads<C>(a, pass, KN, p.bk, 1.f, w);
    }
    PHASE(3);
    if (p.cross) {
      bar_consumers();
      load_rows<C>(A0, nullptr, p.kv, koff, kcell, p.pos, tid);
      fence_async_smem();
      bar_consumers();
    }
#pragma unroll 1
    for (int pass = 0; pass < P::NPC; ++pass) {
      float a[32];
      product<C>(a, p.cross ? aA0 : aXS, C / 8, P::PC, false, rg, w);
      epi_plain<false>(a, pass, smem + P::oVB, C / 8, p.bv, w);
    }
    bar_consumers();
    PHASE(4);

    // attention into A0
    attention<T, C>(aQN, aKN, aVB, A0, km, w);
    fence_async_smem();
    bar_consumers();
    PHASE(5);

    // output projection, the residual on occupied query cells, LN1; h1
    // stays in acc (f32) to the end of the tile
    float acc[P::NA];
#pragma unroll
    for (int pass = 0; pass < P::NPC; ++pass)
      product<C>(pass_acc(acc, pass), aA0, C / 8, P::PC, false, rg, w);
#pragma unroll
    for (int j = 0; j < P::NA / 4; ++j) {
      const int c = col(j, w);
      const float2 b = ldg2(p.bo + c);
      const float2 xa = ld_pair(XS, w.rA, c, C / 8);
      const float2 xb = ld_pair(XS, w.rB, c, C / 8);
      const bool oa = qm[w.rA] > 0.f, ob = qm[w.rB] > 0.f;
      acc[4 * j] = xa.x + (oa ? acc[4 * j] + b.x : 0.f);
      acc[4 * j + 1] = xa.y + (oa ? acc[4 * j + 1] + b.y : 0.f);
      acc[4 * j + 2] = xb.x + (ob ? acc[4 * j + 2] + b.x : 0.f);
      acc[4 * j + 3] = xb.y + (ob ? acc[4 * j + 3] + b.y : 0.f);
    }
    layer_norm<C>(acc, p.ln1s, p.ln1b, red, w);
    {
      const bool oa = qm[w.rA] > 0.f, ob = qm[w.rB] > 0.f;
#pragma unroll
      for (int j = 0; j < P::NA / 4; ++j) {
        const int c = col(j, w);
        if (!oa) acc[4 * j] = acc[4 * j + 1] = 0.f;
        if (!ob) acc[4 * j + 2] = acc[4 * j + 3] = 0.f;
        st_pair(QN, w.rA, c, C / 8, acc[4 * j], acc[4 * j + 1]);
        st_pair(QN, w.rB, c, C / 8, acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    fence_async_smem();
    bar_consumers();
    PHASE(6);

    // FFN: passes of 128 hidden units into KN..VB, then the second product
    // accumulated onto h1 + b2
#pragma unroll 1
    for (int pass = 0; pass < P::F / kPass; ++pass) {
      float hid[32];
      product<C>(hid, aQN, C / 8, P::PC, false, rg, w);
      epi_plain<true>(hid, pass, KN, P::F / 8, p.b1, w);
    }
    PHASE(7);
#pragma unroll
    for (int j = 0; j < P::NA / 4; ++j) {
      const float2 b = ldg2(p.b2 + col(j, w));
      acc[4 * j] += b.x;
      acc[4 * j + 1] += b.y;
      acc[4 * j + 2] += b.x;
      acc[4 * j + 3] += b.y;
    }
    fence_async_smem();
    bar_consumers();
#pragma unroll
    for (int pass = 0; pass < P::NPC; ++pass)
      product<C>(pass_acc(acc, pass), aKN, P::F / 8, P::PF, true, rg, w);
    layer_norm<C>(acc, p.ln2s, p.ln2b, red, w);
    PHASE(8);

    // the output tile [64][C + 8] over KN..VB (both warpgroups are past
    // the FFN: layer_norm's barriers), then its rows to device memory
    {
      bf16* const stage = reinterpret_cast<bf16*>(KN);
      constexpr int ld = C + 8;
      const bool oa = qm[w.rA] > 0.f, ob = qm[w.rB] > 0.f;
#pragma unroll
      for (int j = 0; j < P::NA / 4; ++j) {
        const int c = col(j, w);
        float v[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                      acc[4 * j + 3]};
        if constexpr (T == kCells) {  // K6, K10: zero on unoccupied cells
          if (!oa) v[0] = v[1] = 0.f;
          if (!ob) v[2] = v[3] = 0.f;
        } else {  // K4, K8: x + bf16(y - x)
          const float2 xa = ld_pair(XS, w.rA, c, C / 8);
          const float2 xb = ld_pair(XS, w.rB, c, C / 8);
          const float xs[4] = {xa.x, xa.y, xb.x, xb.y};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = xs[e] + __bfloat162float(__float2bfloat16(v[e] - xs[e]));
        }
        *reinterpret_cast<uint32_t*>(stage + w.rA * ld + c) = pack2(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(stage + w.rB * ld + c) = pack2(v[2], v[3]);
      }
      bar_consumers();
      for (int e = tid; e < kRows * C / 8; e += kConsumers) {
        const int r = e / (C / 8);
        const int ch = e - r * (C / 8);
        const bool write =
            qoff[r] >= 0 && (T == kCells || qm[r] > 0.f);
        if (write)
          *reinterpret_cast<uint4*>(p.out + qoff[r] + ch * 8) =
              *reinterpret_cast<const uint4*>(stage + r * ld + ch * 8);
      }
      bar_consumers();  // the next tile overwrites the rows and buffers
    }
    PHASE(9);
#ifdef TMAE_FWD_PROFILE
    if (tid == 0) ++prof[10];
#endif
  }
#ifdef TMAE_FWD_PROFILE
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 11; ++k)
      atomicAdd(&g_fwd_cycles[k], (unsigned long long)prof[k]);
  }
#endif
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

// One block of 1024 threads: the live windows in window order into `list`
// (each thread takes a run of consecutive windows; one block-wide scan
// places the runs), their count, and the tile counter set to 0.
__global__ void __launch_bounds__(1024)
    compact_kernel(const FwdParams p) {
  __shared__ int sums[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (p.nwin + 1023) / 1024;
  const int lo = min(p.nwin, tid * per);
  const int hi = min(p.nwin, lo + per);
  int n = 0;
  for (int i = lo; i < hi; ++i) n += p.flags[i] != 0;
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += v;
    }
    sums[lane] = s;
  }
  __syncthreads();
  int k = (warp ? sums[warp - 1] : 0) + incl - n;
  for (int i = lo; i < hi; ++i)
    if (p.flags[i]) p.list[k++] = i;
  if (tid == 1023) {
    *p.count = k;
    *p.counter = 0;
  }
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

// The six Linear weights [out, in] (bf16 or f32) into bf16 panels (layout in
// the header), one 16-byte core-matrix row a thread.
template <typename W, int C>
__global__ void __launch_bounds__(256)
    pack_kernel(const W* wq, const W* wk, const W* wv, const W* wo,
                const W* w1, const W* w2, bf16* out) {
  using P = Plan<C>;
  constexpr int kRowsPerPanel = kPanel / 16;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P::kPanels * kRowsPerPanel) return;
  const int q = e / kRowsPerPanel;  // the panel, in stream order
  const int u = e - q * kRowsPerPanel;
  const int t = u >> 3;  // the core matrix: (n / 8) * (kKP / 8) + k / 8
  const int n = (t / (kKP / 8)) * 8 + (u & 7);
  const int kc = t % (kKP / 8);
  // the matrix, its input width and panels a pass, and q within it
  const W* Wm;
  int ld = C, per = P::PC, r = q;
  if (r < 4 * P::NPC * P::PC) {
    const W* ws[4] = {wq, wk, wv, wo};
    Wm = ws[r / (P::NPC * P::PC)];
    r %= P::NPC * P::PC;
  } else if ((r -= 4 * P::NPC * P::PC) < (P::F / kPass) * P::PC) {
    Wm = w1;
  } else {
    r -= (P::F / kPass) * P::PC;
    Wm = w2;
    ld = P::F;
    per = P::PF;
  }
  const int pass = r / per;
  const int kq = r % per;
  reinterpret_cast<uint4*>(out)[e] =
      load8(Wm + (long long)(pass * kPass + n) * ld + kq * kKP + kc * 8);
}

template <typename W, int C>
int launch_pack(const void* const* m, void* out, cudaStream_t s) {
  constexpr int packs = Plan<C>::kPanels * (kPanel / 16);
  pack_kernel<W, C><<<(packs + 255) / 256, 256, 0, s>>>(
      static_cast<const W*>(m[0]), static_cast<const W*>(m[1]),
      static_cast<const W*>(m[2]), static_cast<const W*>(m[3]),
      static_cast<const W*>(m[4]), static_cast<const W*>(m[5]),
      static_cast<bf16*>(out));
  return tmae_last_error();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// [pack,] pre-pass, compact, main kernel; a cudaError_t, 0 when all
// launched. The training modes (K8, K6, K10) pack the bf16 weights w[0],
// w[2], w[4], w[6], w[11], w[13] into p.panels; the serving modes (K4, K3,
// K12) take panels packed once per forward (launch_pack_panels).
template <Mode M, int T, int C>
int launch_tiled(FwdParams p, const void* const* w, cudaStream_t s) {
  using P = Plan<C>;
  constexpr int WPT = T == 16 ? 4 : 1;
  constexpr Addr A = M == kGridOut       ? kGridCells
                     : M == kPlanInPlace ? kPlanCells
                                         : kWindowRows;
  constexpr bool kFull = M == kFullOut || M == kFullInPlace || M == kGridOut;
  static_assert(kFull ? T == kCells : (M == kPlanInPlace || T != kCells),
                "K3 / K6 / K10 run T = 64, K4 / K8 S = 16 or 48");
  if (p.nwin == 0) return 0;
  int e = 0;
  if constexpr (M == kSelOut || M == kFullOut || M == kGridOut) {
    const void* m[6] = {w[0], w[2], w[4], w[6], w[11], w[13]};
    if ((e = launch_pack<bf16, C>(m, const_cast<bf16*>(p.panels), s)))
      return e;
  }
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
  if ((e = tmae_last_error())) return e;
  compact_kernel<<<1, 1024, 0, s>>>(p);
  if ((e = tmae_last_error())) return e;
  // the shared-memory limit, set once per device for each instance
  static unsigned long long set_on = 0;
  int dev = 0;
  if ((e = (int)cudaGetDevice(&dev))) return e;
  if (dev >= 64 || !(set_on >> dev & 1ULL)) {
    e = (int)cudaFuncSetAttribute(tiled_kernel<A, T, C>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  P::kSmem);
    if (e) return e;
    if (dev < 64) set_on |= 1ULL << dev;
  }
  const int blocks = std::min(sm_count(), (p.nwin + WPT - 1) / WPT);
  tiled_kernel<A, T, C><<<blocks, kThreads, P::kSmem, s>>>(p);
  return tmae_last_error();
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

bool widths_ok(int C, int F, int H) {
  return (C == 128 || C == 256) && F == 2 * C && H == kHeads;
}

}  // namespace

#ifdef TMAE_FWD_PROFILE
// Copies the phase cycle sums into out[16] and resets them.
extern "C" int tmae_fwd_profile(unsigned long long* out16) {
  static const unsigned long long zero[16] = {};
  const int e = (int)cudaMemcpyFromSymbol(out16, g_fwd_cycles, sizeof zero);
  return e ? e : (int)cudaMemcpyToSymbol(g_fwd_cycles, zero, sizeof zero);
}
#endif

// The panels of a served layer, once per forward: m points at the six
// Linear weights wq wk wv wo w1 w2 ([out, in], contiguous; f32 when `f32`,
// else bf16), `out` at 8 C^2 bf16. K3, K4 and K12 read them.
extern "C" int launch_pack_panels(const void* const* m, int f32, void* out,
                                  int C, void* stream) {
  if (C != 128 && C != 256) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return C == 128 ? launch_pack<float, 128>(m, out, s)
                    : launch_pack<float, 256>(m, out, s);
  return C == 128 ? launch_pack<bf16, 128>(m, out, s)
                  : launch_pack<bf16, 256>(m, out, s);
}

// K8: out [N, 64, C] = xw + the layer's delta on the S selected cells.
// `w`: the 17 layer tensors, the panels' workspace and the int32 workspace
// (make_params, ints = w[18]).
extern "C" int launch_encoder_fwd_sel(const void* xw, const void* kvw,
                                      void* out, const void* selq,
                                      const void* selk, const void* qmask,
                                      const void* kmask, const void* pos,
                                      const void* const* w, int N, int C,
                                      int F, int H, int S, int cross,
                                      float tau_min, void* stream) {
  if (!widths_ok(C, F, H) || (S != 16 && S != 48) || qmask == nullptr ||
      selq == nullptr || (cross && (kvw == nullptr || kmask == nullptr)))
    return (int)cudaErrorInvalidValue;
  FwdParams p = make_params(xw, kvw, out, pos, w, const_cast<void*>(w[18]),
                            N, cross, tau_min);
  p.selq = static_cast<const int*>(selq);
  p.selk = static_cast<const int*>(selk);
  p.qmask = static_cast<const float*>(qmask);
  p.kmask = static_cast<const float*>(kmask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 128)
    return S == 16 ? launch_tiled<kSelOut, 16, 128>(p, w, s)
                   : launch_tiled<kSelOut, 48, 128>(p, w, s);
  return S == 16 ? launch_tiled<kSelOut, 16, 256>(p, w, s)
                 : launch_tiled<kSelOut, 48, 256>(p, w, s);
}

// K6: out [N, 64, C] = the full-window layer of xw [N, 64, C] (keys and
// values from kvw in cross mode) with masks qmask / kmask [N, 64], zero on
// cells without a query. `w` as for K8.
extern "C" int launch_encoder_fwd_full(const void* xw, const void* kvw,
                                       void* out, const void* qmask,
                                       const void* kmask, const void* pos,
                                       const void* const* w, int N, int C,
                                       int F, int H, int cross, float tau_min,
                                       void* stream) {
  if (!widths_ok(C, F, H) || qmask == nullptr ||
      (cross && (kvw == nullptr || kmask == nullptr)))
    return (int)cudaErrorInvalidValue;
  FwdParams p = make_params(xw, kvw, out, pos, w, const_cast<void*>(w[18]),
                            N, cross, tau_min);
  p.qmask = static_cast<const float*>(qmask);
  p.kmask = static_cast<const float*>(kmask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C == 128 ? launch_tiled<kFullOut, kCells, 128>(p, w, s)
                  : launch_tiled<kFullOut, kCells, 256>(p, w, s);
}

// K4: K8's layer in place on rows [row_lo, row_lo + cap) of xw [B, total,
// 64, C] (kvw likewise in cross mode, another tensor), selections and masks
// [B, cap, S]. `w`: the 17 layer tensors (matrices unused) and the packed
// panels; `ints` the int32 workspace [2 B cap + 2].
extern "C" int launch_encoder_rows_sel(void* xw, const void* kvw,
                                       const void* selq, const void* selk,
                                       const void* qmask, const void* kmask,
                                       const void* pos, const void* const* w,
                                       void* ints, int B, int total, int cap,
                                       int row_lo, int C, int F, int H, int S,
                                       int cross, float tau_min,
                                       void* stream) {
  if (!widths_ok(C, F, H) || (S != 16 && S != 48) || qmask == nullptr ||
      selq == nullptr || row_lo < 0 || cap < 0 || row_lo + cap > total ||
      (cross && (kvw == nullptr || kmask == nullptr || kvw == xw)))
    return (int)cudaErrorInvalidValue;
  FwdParams p = make_params(xw, kvw, xw, pos, w, ints, B * cap, cross,
                            tau_min);
  p.total = total;
  p.cap = cap;
  p.row_lo = row_lo;
  p.selq = static_cast<const int*>(selq);
  p.selk = static_cast<const int*>(selk);
  p.qmask = static_cast<const float*>(qmask);
  p.kmask = static_cast<const float*>(kmask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 128)
    return S == 16 ? launch_tiled<kSelInPlace, 16, 128>(p, w, s)
                   : launch_tiled<kSelInPlace, 48, 128>(p, w, s);
  return S == 16 ? launch_tiled<kSelInPlace, 16, 256>(p, w, s)
                 : launch_tiled<kSelInPlace, 48, 256>(p, w, s);
}

// K3: K6's layer in place on rows [row_lo, row_lo + cap) of xw [B, total,
// 64, C] (kvw likewise in cross mode, another tensor), masks [B, cap, 64];
// a window without a query gets zeros. `w` and `ints` as for K4.
extern "C" int launch_encoder_rows_full(void* xw, const void* kvw,
                                        const void* qmask, const void* kmask,
                                        const void* pos, const void* const* w,
                                        void* ints, int B, int total, int cap,
                                        int row_lo, int C, int F, int H,
                                        int cross, float tau_min,
                                        void* stream) {
  if (!widths_ok(C, F, H) || qmask == nullptr || row_lo < 0 || cap < 0 ||
      row_lo + cap > total ||
      (cross && (kvw == nullptr || kmask == nullptr || kvw == xw)))
    return (int)cudaErrorInvalidValue;
  FwdParams p = make_params(xw, kvw, xw, pos, w, ints, B * cap, cross,
                            tau_min);
  p.total = total;
  p.cap = cap;
  p.row_lo = row_lo;
  p.qmask = static_cast<const float*>(qmask);
  p.kmask = static_cast<const float*>(kmask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C == 128 ? launch_tiled<kFullInPlace, kCells, 128>(p, w, s)
                  : launch_tiled<kFullInPlace, kCells, 256>(p, w, s);
}

// K12: the layer over the windows of one bucket plan idx [B, cap, 2] of the
// padded carrier xp [B, Hp2, Wp, C], in place (kvp likewise in cross mode,
// never xp itself): T = 64 (selq null, masks [B, cap, 64]) or the S = T
// selected cells (selq / selk and masks [B, cap, S]). `w` and `ints` as for
// K4, with nwin = B cap.
extern "C" int launch_encoder_inplace(void* xp, const void* kvp,
                                      const void* idx, const void* selq,
                                      const void* selk, const void* qmask,
                                      const void* kmask, const void* pos,
                                      const void* const* w, void* ints, int B,
                                      int Hp2, int Wp, int cap, int C, int F,
                                      int H, int T, int cross, float tau_min,
                                      void* stream) {
  if (!widths_ok(C, F, H) || idx == nullptr || qmask == nullptr ||
      Hp2 % 8 || Wp % 8 || (T != 16 && T != 48 && T != kCells) ||
      (T != kCells && selq == nullptr) ||
      (cross && (kvp == nullptr || kmask == nullptr || kvp == xp)))
    return (int)cudaErrorInvalidValue;
  FwdParams p = make_params(xp, kvp, xp, pos, w, ints, B * cap, cross,
                            tau_min);
  p.cap = cap;
  p.widx = static_cast<const int*>(idx);
  p.gh = Hp2;
  p.gw = Wp;
  p.nwy = Hp2 / 8 - 1;
  p.selq = static_cast<const int*>(selq);
  p.selk = static_cast<const int*>(selk);
  p.qmask = static_cast<const float*>(qmask);
  p.kmask = static_cast<const float*>(kmask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 128) {
    if (T == 16) return launch_tiled<kPlanInPlace, 16, 128>(p, w, s);
    if (T == 48) return launch_tiled<kPlanInPlace, 48, 128>(p, w, s);
    return launch_tiled<kPlanInPlace, kCells, 128>(p, w, s);
  }
  if (T == 16) return launch_tiled<kPlanInPlace, 16, 256>(p, w, s);
  if (T == 48) return launch_tiled<kPlanInPlace, 48, 256>(p, w, s);
  return launch_tiled<kPlanInPlace, kCells, 256>(p, w, s);
}

// K10: out [B, H, W, C] = the layer on every 8x8 window of the shift's
// partition of xg [B, H, W, C] (kvg likewise in cross mode), with masks from
// the occupancy bytes qocc / kocc [B, H, W]. `w` as for K8, with nwin = B
// (ceil(H/8) + 1) (ceil(W/8) + 1) windows.
extern "C" int launch_encoder_grid(const void* xg, const void* kvg, void* out,
                                   const void* qocc, const void* kocc,
                                   const void* pos, const void* const* w,
                                   int B, int H, int W, int C, int F, int nh,
                                   int cross, int shift, float tau_min,
                                   void* stream) {
  if (!widths_ok(C, F, nh) || qocc == nullptr ||
      (cross && (kvg == nullptr || kocc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int nwy = (H + 7) / 8 + 1;
  const int nwx = (W + 7) / 8 + 1;
  FwdParams p = make_params(xg, kvg, out, pos, w, const_cast<void*>(w[18]),
                            B * nwy * nwx, cross, tau_min);
  p.qocc = static_cast<const unsigned char*>(qocc);
  p.kocc = cross ? static_cast<const unsigned char*>(kocc) : nullptr;
  p.gh = H;
  p.gw = W;
  p.nwy = nwy;
  p.nwx = nwx;
  p.off = shift ? 4 : 8;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return C == 128 ? launch_tiled<kGridOut, kCells, 128>(p, w, s)
                  : launch_tiled<kGridOut, kCells, 256>(p, w, s);
}
