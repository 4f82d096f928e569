// Grid gradient of the bicubic feature warp, for Hopper (sm_90a).
//
// For each output pixel p of out = F.grid_sample(x, grid, mode='bicubic',
// padding_mode='zeros', align_corners=False), with cotangent g:
//
//   dfx[p] = sum_c g[p,c] sum_j sum_s K(fy - j) K'(fx - s) X[j,s,c]
//   dfy[p] = sum_c g[p,c] sum_j sum_s K'(fy - j) K(fx - s) X[j,s,c]
//
// and dgrid[p] = (dfx * W/2, dfy * H/2), the chain through the
// align_corners=False unnormalization. Taps off the image contribute 0.
//
// It replaces the TPU kernel _dgrid_kernel (lcgan_tpu/ops/warp_pallas.py),
// which sweeps a displacement-bounded band of input rows with [K' | K]
// matmuls because TPU gathers are slow. Here it is the forward's direct
// 16-tap gather with derivative weights, plus a reduction over channels:
// exact for any grid, no band.
//
// What bounds it: device-memory bytes (one read of x, of g and of the grid,
// 64 flops per (pixel, channel)), far below the card's flop-per-byte balance.
//
// Design:
//   * a group of G lanes of one warp per output pixel (G the power of two
//     >= C / VEC, at most 32); the lanes stride over the pixel's 16-byte
//     channel vectors, so each tap's loads, and the cotangent's, coalesce;
//   * every lane computes the pixel's weights and derivative weights in fp32
//     itself (a few dozen flops against 16 vector loads);
//   * each lane sums its channels in fp32, then the group reduces with xor
//     shuffles in a fixed order. No atomics: the result is bitwise the same
//     on every run.
//
// C interface (ctypes): lcgan_warp_dgrid returns cudaGetLastError() after
// the launch, 0 on success.

#include "warp_common.cuh"

namespace {

using namespace lcgan;

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
warp_dgrid_kernel(const T* __restrict__ x, const float* __restrict__ grid, const T* __restrict__ g,
                  float* __restrict__ dgrid, int C, int H, int W, int Hg, int Wg, int G,
                  long long npix) {
  const int group = threadIdx.x / G;
  const int gl = threadIdx.x - group * G;
  const long long pix = (long long)blockIdx.x * (kThreads / G) + group;
  float sx = 0.f, sy = 0.f;
  if (pix < npix) {
    const int b = (int)(pix / ((long long)Hg * Wg));
    const float fx = unnormalize(grid[2 * pix], W);
    const float fy = unnormalize(grid[2 * pix + 1], H);
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float tx = fx - x0, ty = fy - y0;
    float wx[4], wy[4], dwx[4], dwy[4];
    cubic_weights(tx, wx);
    cubic_weights(ty, wy);
    cubic_weight_derivatives(tx, dwx);
    cubic_weight_derivatives(ty, dwy);
    const int ix = (int)x0 - 1, iy = (int)y0 - 1;
    const T* xb = x + (long long)b * H * W * C;
    const T* gp = g + pix * C;
    const int nvec = C / VEC;
    for (int cv = gl; cv < nvec; cv += G) {
      const int c = cv * VEC;
      float ax[VEC], ay[VEC];  // d/dfx and d/dfy of the sample, per channel
#pragma unroll
      for (int k = 0; k < VEC; ++k) ax[k] = ay[k] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int yy = iy + j;
        if (yy < 0 || yy >= H) continue;
        const T* row = xb + (long long)yy * W * C + c;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int xx = ix + i;
          if (xx < 0 || xx >= W) continue;
          const float wdx = wy[j] * dwx[i];
          const float wdy = dwy[j] * wx[i];
          float v[VEC];
          Vec<T, VEC>::load(row + (long long)xx * C, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            ax[k] += v[k] * wdx;
            ay[k] += v[k] * wdy;
          }
        }
      }
      float gv[VEC];
      Vec<T, VEC>::load(gp + c, gv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sx += gv[k] * ax[k];
        sy += gv[k] * ay[k];
      }
    }
  }
  // fixed-order butterfly over the G lanes of the group; every lane of the
  // warp takes part, so the full mask is right even past the last pixel
  for (int off = G >> 1; off > 0; off >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
  }
  if (pix < npix && gl == 0) {
    dgrid[2 * pix] = sx * (0.5f * (float)W);
    dgrid[2 * pix + 1] = sy * (0.5f * (float)H);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* grid, const void* g, void* dgrid, int B, int C, int H,
           int W, int Hg, int Wg, cudaStream_t stream) {
  const int nvec = C / VEC;
  int G = 1;
  while (G < nvec && G < 32) G <<= 1;
  const long long npix = (long long)B * Hg * Wg;
  const long long per_block = kThreads / G;
  const long long blocks = (npix + per_block - 1) / per_block;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  warp_dgrid_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(grid), static_cast<const T*>(g),
      static_cast<float*>(dgrid), C, H, W, Hg, Wg, G, npix);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: (B, H, W, C) NHWC contiguous; grid:
// (B, Hg, Wg, 2) fp32 contiguous; g: (B, Hg, Wg, C) NHWC contiguous in x's
// dtype; dgrid: (B, Hg, Wg, 2) fp32 contiguous. vec: 1 to force scalar loads
// (C not a multiple of the vector width, or pointers not 16-byte aligned),
// else 16-byte vectors.
extern "C" int lcgan_warp_dgrid(const void* x, const void* grid, const void* g, void* dgrid,
                                int dtype, int vec, int B, int C, int H, int W, int Hg, int Wg,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, grid, g, dgrid, B, C, H, W, Hg, Wg, s)
               : launch<float, 1>(x, grid, g, dgrid, B, C, H, W, Hg, Wg, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, grid, g, dgrid, B, C, H, W, Hg, Wg, s)
               : launch<__nv_bfloat16, 1>(x, grid, g, dgrid, B, C, H, W, Hg, Wg, s);
  }
  return (int)cudaErrorInvalidValue;
}
