// Hopper tile helpers shared by the persistent tiled kernels
// (encoder_layer_tiled.cu, subm_conv.cu): mbarriers, the cp.async.bulk
// panel ring, wgmma descriptors and fences, the compaction of live work
// items into a device-side list, and the SM count.
//
// A weight panel (bf16, 16 KiB) holds 128 output rows by 64 input columns
// of a weight W [out, in]; element (n, k) is at ((n / 8) * 8 + k / 8) * 64 +
// (n % 8) * 8 + k % 8: 8 x 8 core matrices of 128 contiguous bytes,
// K-adjacent ones 128 bytes apart (a descriptor's leading byte offset),
// 8-row groups 1 KiB apart (its stride byte offset), no swizzle.
#pragma once

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPanel = 16384;  // bytes of a weight panel:
constexpr int kPass = 128;     // its output rows
constexpr int kKP = 64;        // by its input columns

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
// matrices, K-adjacent ones `lbo` bytes apart, 8-row groups `sbo` apart
// (both multiples of 16, as is `addr`).
__device__ __forceinline__ uint64_t gdesc(uint32_t addr, uint32_t sbo,
                                          uint32_t lbo = 128) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
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

// One block of 1024 threads: the items i < n with flags[i] set, in order,
// into `list` (each thread takes a run of consecutive items; one block-wide
// scan places the runs), their count, and the tile counter set to 0.
__global__ void __launch_bounds__(1024)
    compact_kernel(const int* __restrict__ flags, int* __restrict__ list,
                   int* __restrict__ count, int* __restrict__ counter,
                   int n_items) {
  __shared__ int sums[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (n_items + 1023) / 1024;
  const int lo = min(n_items, tid * per);
  const int hi = min(n_items, lo + per);
  int n = 0;
  for (int i = lo; i < hi; ++i) n += flags[i] != 0;
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
    if (flags[i]) list[k++] = i;
  if (tid == 1023) {
    *count = k;
    *counter = 0;
  }
}

inline int sm_count() {
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

// Sets a kernel's dynamic shared-memory limit once per device (bit `dev`
// of `set_on`, one mask per kernel instance); a cudaError_t.
inline int smem_limit_once(const void* kernel, int bytes,
                           unsigned long long& set_on) {
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e) return e;
  if (dev < 64 && (set_on >> dev & 1ULL)) return 0;
  e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!e && dev < 64) set_on |= 1ULL << dev;
  return e;
}

}  // namespace
