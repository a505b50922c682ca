// Kernels DCN_COLS, DCN_COORD_BWD, BILINEAR_GRAD and POINT_SAMPLE: the
// bilinear sampling of GraphRCNN's camera branch, forward and backward.
//
// They replace no Pallas kernel. The JAX package computes these functions
// in XLA as a dense bilinear gather (tmae_tpu/ops/dcn.py: _bilinear_sample
// :17, deform_conv2d :37, and models/point_sample.py's img_grid_sample :29
// on it) and lets autodiff make the backward; the reference ran its own
// CUDA op (pcdet/ops/dcn: a modulated im2col forward, an input backward and
// a parameter backward; fusion_layers/point_sample's grid_sample).
//
// DCN_COLS (ops/dcn.dcn_cols): the modulated deformable im2col of DCNv2.
// For each (b, ho, wo, tap k, channel c) it writes
//   cols = mask * bilinear(x[b], ho * stride - pad + (k / kw) * dil + dy,
//                                wo * stride - pad + (k % kw) * dil + dx)
// into cols [B, Ho, Wo, K, C], each of the four corners zero outside the
// map, the corners summed in the order (0, 0), (0, 1), (1, 0), (1, 1). One
// warp a (pixel, tap), its lanes on neighbouring channels: the tap's
// coordinates and corners are found once a warp, and the corner reads and
// the write of a warp are 128-byte runs of one row of x and of cols. (The
// first version, a thread an element, found them once an element, 64-bit
// index arithmetic and all: 0.513 ms at 2 x 136 x 240 x 9 x 64 on the
// H100.) Bound: bytes, the cols it writes (K C floats a pixel, nine times
// x's bytes); the tap contraction that reads cols is a torch matmul, as
// the JAX package's einsum is an XLA product.
//
// DCN_COORD_BWD (ops/dcn.dcn_coord_bwd): d offset and d mask from d cols
// (= d out @ weight^T, a torch matmul): d mask = sum_c dcols * sampled,
// d (dy, dx) = mask * sum_c dcols * d sampled / d (y, x). One warp a (pixel,
// tap): each lane sums its channels c = lane, lane + 32, ... in order, then
// a butterfly of shuffles sums the lanes: the same order every run, no
// atomics. Bound: bytes (dcols read once, x's four corners).
//
// BILINEAR_GRAD (ops/dcn.bilinear_grad): the gradient of a bilinear sample
// with respect to the sampled map, for DCN's d x and PointSample's d image
// features. Every sample gives four (target pixel, contribution) pairs;
// the wrapper sorts their keys (the pixel's flat index, or B H W for a
// corner outside the map or a sample left out) with a stable sort, so each
// pixel's list holds its contributions in sample order. One warp a target
// pixel finds its list by binary search and sums g[s, c] * scale[s] *
// w_corner over it in that order, lanes on channels. Deterministic, with
// no float atomics: a step repeats bit for bit. Every pixel is written (0
// where nothing lands). Bound: bytes (g read once, the map written once);
// a row of g is read by each of its sample's corners that land.
//
// POINT_SAMPLE (ops/dcn.point_sample): the same bilinear gather at given
// coordinates, [B, H, W, C] at [B, N] points -> [B, N, C], 0 where the
// point is not valid (PointSample's in-image test). A kernel of its own
// beside DCN_COLS (the same sampler, absolute coordinates, no taps). Bound:
// bytes.
//
// Exactness: DCN_COLS and POINT_SAMPLE repeat the plain versions'
// arithmetic op by op (the file is built with -fmad=false), so they give
// their bits; the two reductions sum in another order than the plain
// versions' torch sums, and are held to them within a stated tolerance.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The four corner weights of a sample at (ys, xs), and its top-left corner.
struct Corners {
  float y0, x0;
  float w[4];
};

__device__ __forceinline__ Corners corners(float ys, float xs) {
  Corners q;
  q.y0 = floorf(ys);
  q.x0 = floorf(xs);
  const float wy = ys - q.y0, wx = xs - q.x0;
  const float ay = 1.f - wy, ax = 1.f - wx;
  q.w[0] = ay * ax;
  q.w[1] = ay * wx;
  q.w[2] = wy * ax;
  q.w[3] = wy * wx;
  return q;
}

// The flat pixel (y W + x) of corner k, or -1 outside the H x W map.
__device__ __forceinline__ long long corner_pixel(const Corners& q, int k,
                                                  int H, int W) {
  const float yy = q.y0 + static_cast<float>(k >> 1);
  const float xx = q.x0 + static_cast<float>(k & 1);
  const bool in = yy >= 0.f && yy < static_cast<float>(H) && xx >= 0.f &&
                  xx < static_cast<float>(W);
  return in ? static_cast<long long>(yy) * W + static_cast<long long>(xx)
            : -1;
}

// Channel c of the bilinear sample of img [H, W, C] at the corners q.
__device__ __forceinline__ float sample(const float* __restrict__ img,
                                        const long long (&pix)[4],
                                        const Corners& q, int C, int c) {
  float out = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = pix[k] >= 0 ? __ldg(img + pix[k] * C + c) : 0.f;
    out = out + v * q.w[k];
  }
  return out;
}

struct TapGeometry {
  int H, W, C, Ho, Wo, kw, K, stride, pad, dil;
};

// Sample coordinates of group g = ((b Ho + ho) Wo + wo) K + k; returns b.
__device__ __forceinline__ int tap_coords(const TapGeometry& t,
                                          const float* __restrict__ off,
                                          long long g, float* ys, float* xs) {
  const int k = static_cast<int>(g % t.K);
  const long long pix = g / t.K;
  const int wo = static_cast<int>(pix % t.Wo);
  const long long bh = pix / t.Wo;
  const int ho = static_cast<int>(bh % t.Ho);
  const int b = static_cast<int>(bh / t.Ho);
  const int y = ho * t.stride - t.pad + (k / t.kw) * t.dil;
  const int x = wo * t.stride - t.pad + (k % t.kw) * t.dil;
  const float by = static_cast<float>(y), bx = static_cast<float>(x);
  *ys = by + __ldg(off + 2 * g);
  *xs = bx + __ldg(off + 2 * g + 1);
  return b;
}

__global__ void __launch_bounds__(kThreads)
    dcn_cols_kernel(const float* __restrict__ x, const float* __restrict__ off,
                    const float* __restrict__ mask, float* __restrict__ cols,
                    TapGeometry t, long long groups) {
  const long long g = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= groups) return;
  float ys, xs;
  const int b = tap_coords(t, off, g, &ys, &xs);
  const Corners q = corners(ys, xs);
  long long pix[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pix[k] = corner_pixel(q, k, t.H, t.W);
  const float* img = x + static_cast<long long>(b) * t.H * t.W * t.C;
  const float m = __ldg(mask + g);
  float* out = cols + g * t.C;
  for (int c = lane; c < t.C; c += 32)
    out[c] = sample(img, pix, q, t.C, c) * m;
}

__global__ void __launch_bounds__(kThreads)
    dcn_coord_bwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ off,
                         const float* __restrict__ mask,
                         const float* __restrict__ dcols,
                         float* __restrict__ doff, float* __restrict__ dmask,
                         TapGeometry t, long long groups) {
  const long long g = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= groups) return;  // the whole warp: g is the warp's
  float ys, xs;
  const int b = tap_coords(t, off, g, &ys, &xs);
  const Corners q = corners(ys, xs);
  const float wy = ys - q.y0, wx = xs - q.x0;
  const float ay = 1.f - wy, ax = 1.f - wx;
  long long pix[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pix[k] = corner_pixel(q, k, t.H, t.W);
  const float* img = x + static_cast<long long>(b) * t.H * t.W * t.C;
  const float* gc = dcols + g * t.C;
  float sm = 0.f, sy = 0.f, sx = 0.f;
  for (int c = lane; c < t.C; c += 32) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = pix[k] >= 0 ? __ldg(img + pix[k] * t.C + c) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) s = s + v[k] * q.w[k];
    const float dy = (v[2] - v[0]) * ax + (v[3] - v[1]) * wx;
    const float dx = (v[1] - v[0]) * ay + (v[3] - v[2]) * wy;
    const float d = __ldg(gc + c);
    sm = sm + d * s;
    sy = sy + d * dy;
    sx = sx + d * dx;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    sm = sm + __shfl_xor_sync(kFull, sm, o);
    sy = sy + __shfl_xor_sync(kFull, sy, o);
    sx = sx + __shfl_xor_sync(kFull, sx, o);
  }
  if (lane == 0) {
    const float m = __ldg(mask + g);
    dmask[g] = sm;
    doff[2 * g] = sy * m;
    doff[2 * g + 1] = sx * m;
  }
}

// The first index of keys[0, n) not below v (keys ascending).
__device__ __forceinline__ long long lower_bound(const int* __restrict__ keys,
                                                 long long n, long long v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(__ldg(keys + mid)) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    bilinear_grad_kernel(const float* __restrict__ g,
                         const float* __restrict__ scale,
                         const float* __restrict__ ys,
                         const float* __restrict__ xs,
                         const int* __restrict__ keys,
                         const long long* __restrict__ order,
                         float* __restrict__ dimg, int C, long long pixels,
                         long long n) {
  const long long p = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= pixels) return;
  const long long lo = lower_bound(keys, n, p);
  const long long hi = lower_bound(keys, n, p + 1);
  float* out = dimg + p * C;
  for (int c = lane; c < C; c += 32) {
    float acc = 0.f;
    for (long long j = lo; j < hi; ++j) {
      const long long src = __ldg(order + j);
      const long long s = src >> 2;
      const Corners q = corners(__ldg(ys + s), __ldg(xs + s));
      float gs = __ldg(g + s * C + c);
      if (scale) gs = gs * __ldg(scale + s);
      acc = acc + gs * q.w[src & 3];
    }
    out[c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    point_sample_kernel(const float* __restrict__ feats,
                        const float* __restrict__ ys,
                        const float* __restrict__ xs,
                        const unsigned char* __restrict__ valid,
                        float* __restrict__ out, int N, int H, int W, int C,
                        long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  const long long s = i / C;  // b N + n
  if (!__ldg(valid + s)) {
    out[i] = 0.f;
    return;
  }
  const int b = static_cast<int>(s / N);
  const Corners q = corners(__ldg(ys + s), __ldg(xs + s));
  long long pix[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pix[k] = corner_pixel(q, k, H, W);
  out[i] = sample(feats + static_cast<long long>(b) * H * W * C, pix, q, C, c);
}

inline unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

// x [B, H, W, C], off [B, Ho, Wo, K, 2] (dy, dx), mask [B, Ho, Wo, K] ->
// cols [B, Ho, Wo, K, C]; K = kh kw.
extern "C" int launch_dcn_cols(const float* x, const float* off,
                               const float* mask, float* cols, int B, int H,
                               int W, int C, int Ho, int Wo, int kh, int kw,
                               int stride, int pad, int dil,
                               cudaStream_t stream) {
  const long long groups = static_cast<long long>(B) * Ho * Wo * kh * kw;
  if (groups <= 0 || C <= 0) return 0;
  const TapGeometry t{H, W, C, Ho, Wo, kw, kh * kw, stride, pad, dil};
  dcn_cols_kernel<<<blocks_for(groups * 32), kThreads, 0, stream>>>(
      x, off, mask, cols, t, groups);
  return tmae_last_error();
}

// dcols [B, Ho, Wo, K, C] -> doff [B, Ho, Wo, K, 2], dmask [B, Ho, Wo, K].
extern "C" int launch_dcn_coord_bwd(const float* x, const float* off,
                                    const float* mask, const float* dcols,
                                    float* doff, float* dmask, int B, int H,
                                    int W, int C, int Ho, int Wo, int kh,
                                    int kw, int stride, int pad, int dil,
                                    cudaStream_t stream) {
  const long long groups = static_cast<long long>(B) * Ho * Wo * kh * kw;
  if (groups <= 0) return 0;
  const TapGeometry t{H, W, C, Ho, Wo, kw, kh * kw, stride, pad, dil};
  dcn_coord_bwd_kernel<<<blocks_for(groups * 32), kThreads, 0, stream>>>(
      x, off, mask, dcols, doff, dmask, t, groups);
  return tmae_last_error();
}

// g [S, C] (scale [S] or null), ys / xs [S], keys / order [4 S] sorted ->
// dimg [pixels, C].
extern "C" int launch_bilinear_grad(const float* g, const float* scale,
                                    const float* ys, const float* xs,
                                    const int* keys, const long long* order,
                                    float* dimg, long long pixels, int C,
                                    long long n, cudaStream_t stream) {
  if (pixels <= 0 || C <= 0) return 0;
  bilinear_grad_kernel<<<blocks_for(pixels * 32), kThreads, 0, stream>>>(
      g, scale, ys, xs, keys, order, dimg, C, pixels, n);
  return tmae_last_error();
}

// feats [B, H, W, C] at ys / xs [B, N] (valid [B, N] bytes) -> [B, N, C].
extern "C" int launch_point_sample(const float* feats, const float* ys,
                                   const float* xs,
                                   const unsigned char* valid, float* out,
                                   int B, int N, int H, int W, int C,
                                   cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * N * C;
  if (total <= 0) return 0;
  point_sample_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
      feats, ys, xs, valid, out, N, H, W, C, total);
  return tmae_last_error();
}
