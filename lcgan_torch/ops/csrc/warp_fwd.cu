// Forward bicubic feature warp for Hopper (sm_90a).
//
// Computes torch F.grid_sample(x, grid, mode='bicubic', padding_mode='zeros',
// align_corners=False) on channels_last (NHWC) features:
//
//   out[b,r,l,c] = sum_j K(fy - j) sum_s K(fx - s) X[b,j,s,c],   A = -0.75
//
// It replaces the TPU kernel _fwd_kernel (lcgan_tpu/ops/warp_pallas.py), which
// evaluates the same sum as banded dense matmuls because gathers are slow on a
// TPU. On Hopper the direct 16-tap gather is the natural form, and it is exact
// for any grid: no displacement bound, no band.
//
// What bounds it on this card: not the arithmetic (32 flops per output value)
// and, for one read of x and one write of out, not device memory either, but
// the taps' re-reads: each x value is read by the ~16 output pixels whose taps
// cover it, 16 loads of 16 bytes and their conversions and multiply-adds per
// output vector, served from L1/L2 at about a third of the byte bound on
// i.i.d. and on smooth flows alike.
//
// Design:
//   * one thread block per (batch, output row, tile of TW output columns);
//   * the TW pixels' tap origins and 4+4 cubic weights are computed once, in
//     fp32, into shared memory;
//   * threads stride over (pixel, channel vector) pairs: on NHWC data one
//     pixel's channels are contiguous, so neighbouring threads load
//     neighbouring 16-byte vectors of the same tap (8 bf16 or 4 fp32) and each
//     tap's loads are coalesced. Taps shared by neighbouring pixels and rows
//     come from L1/L2, so x is read from device memory about once;
//   * TW is chosen by the host so that a block has about one vector per
//     thread (TW = 256 / (C / VEC), at most the row width);
//   * fp32 accumulation, taps outside the image skipped, output in the input
//     dtype; no atomics, so results are deterministic.
//
// Measured and not kept (PERF.md, Findings): 2D output tiles that copy the
// window of x their taps read into shared memory with cp.async. On maps of at
// most 64² they gained a few microseconds a launch; above that the window
// rarely fits, a 64 KB buffer leaves three blocks an SM and little L1 for the
// tiles that read global memory, and 2D tiles without a window hold about
// twice the registers: 0.5-0.95x of this kernel on every flow tried, and no
// gain over the six warps of a generated batch.
//
// C interface (ctypes): lcgan_warp_fwd returns cudaGetLastError() after the
// launch, 0 on success.

#include "warp_common.cuh"

namespace {

using namespace lcgan;

constexpr int kThreads = 256;
constexpr int kMaxTile = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
warp_fwd_kernel(const T* __restrict__ x, const float* __restrict__ grid, T* __restrict__ out,
                int C, int H, int W, int Hg, int Wg, int tile, int ntiles) {
  __shared__ float s_wx[kMaxTile][4];
  __shared__ float s_wy[kMaxTile][4];
  __shared__ int s_ix[kMaxTile];
  __shared__ int s_iy[kMaxTile];

  const long long bid = blockIdx.x;
  const int t = (int)(bid % ntiles);
  const long long br = bid / ntiles;  // b * Hg + r
  const int b = (int)(br / Hg);
  const int col0 = t * tile;
  const int npix = min(tile, Wg - col0);
  const long long pix0 = br * Wg + col0;  // flat index of the tile's first output pixel

  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const float* g = grid + 2 * (pix0 + p);
    const float fx = unnormalize(g[0], W);
    const float fy = unnormalize(g[1], H);
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float tx = fx - x0, ty = fy - y0;
    cubic_weights(tx, s_wx[p]);
    cubic_weights(ty, s_wy[p]);
    s_ix[p] = (int)x0 - 1;
    s_iy[p] = (int)y0 - 1;
  }
  __syncthreads();

  const int nvec = C / VEC;
  const T* xb = x + (long long)b * H * W * C;
  for (int item = threadIdx.x; item < npix * nvec; item += blockDim.x) {
    const int p = item / nvec;
    const int c = (item - p * nvec) * VEC;
    const int ix = s_ix[p], iy = s_iy[p];
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int yy = iy + j;
      if (yy < 0 || yy >= H) continue;
      const T* row = xb + (long long)yy * W * C + c;
      const float wy = s_wy[p][j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xx = ix + i;
        if (xx < 0 || xx >= W) continue;
        const float wgt = wy * s_wx[p][i];
        float v[VEC];
        Vec<T, VEC>::load(row + (long long)xx * C, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[k] * wgt;
      }
    }
    Vec<T, VEC>::store(out + (pix0 + p) * C + c, acc);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* grid, void* out, int B, int C, int H, int W, int Hg,
           int Wg, cudaStream_t stream) {
  const int nvec = C / VEC;
  int tile = kThreads / nvec;
  tile = tile < 1 ? 1 : tile;
  tile = tile > Wg ? Wg : tile;
  const int ntiles = (Wg + tile - 1) / tile;
  const long long blocks = (long long)B * Hg * ntiles;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  warp_fwd_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(grid), static_cast<T*>(out), C, H, W,
      Hg, Wg, tile, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: (B, H, W, C) NHWC contiguous; grid:
// (B, Hg, Wg, 2) fp32 contiguous; out: (B, Hg, Wg, C) NHWC contiguous.
// vec: 1 to force scalar loads (C not a multiple of the vector width, or
// pointers not 16-byte aligned), else 16-byte vectors.
extern "C" int lcgan_warp_fwd(const void* x, const void* grid, void* out, int dtype, int vec,
                              int B, int C, int H, int W, int Hg, int Wg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, grid, out, B, C, H, W, Hg, Wg, s)
               : launch<float, 1>(x, grid, out, B, C, H, W, Hg, Wg, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, grid, out, B, C, H, W, Hg, Wg, s)
               : launch<__nv_bfloat16, 1>(x, grid, out, B, C, H, W, Hg, Wg, s);
  }
  return (int)cudaErrorInvalidValue;
}
