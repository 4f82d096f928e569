// Grid gradient of the bicubic feature warp at small maps (at most 64²), for
// Hopper (sm_90a).
//
// For each output pixel p of out = F.grid_sample(x, grid, mode='bicubic',
// padding_mode='zeros', align_corners=False), with cotangent g, as
// warp_dgrid.cu computes it:
//
//   dfx[p] = sum_c g[p,c] sum_j sum_s K(fy - j) K'(fx - s) X[j,s,c]
//   dfy[p] = sum_c g[p,c] sum_j sum_s K'(fy - j) K(fx - s) X[j,s,c]
//
// and dgrid[p] = (dfx * W/2, dfy * H/2). Taps off the image contribute 0.
//
// It replaces the TPU kernel _dgrid_small_kernel (lcgan_tpu/ops/warp_pallas.py,
// called from _bwd_small_call), which sweeps a band of the VMEM-resident
// packed map with [K' | K] matmuls per lane tile of packed rows, and the host
// sum of its per-group partials. Here it is the direct 16-tap gather with
// derivative weights, exact for any grid.
//
// What bounds it: device-memory bytes (one read of x, g and the grid, one
// write of dgrid; 64 flops per (pixel, channel)), plus the per-group partial
// sums, which go through device memory (groups x B*Hg*Wg*2 fp32). At these
// sizes the launch and the first bytes' latency weigh as much.
//
// Design:
//   1. warp_dgrid_small_kernel: one block per (channel group, batch element).
//      The block copies its group's whole map of x into shared memory with
//      16-byte cp.async copies (each x byte leaves device memory once), then
//      one thread per output pixel computes the pixel's weights and
//      derivative weights in fp32, gathers the 16 taps of each channel vector
//      from shared memory and sums g times them over the group's channels in
//      a fixed order. g is read straight from device memory: each of its
//      bytes is used once, so shared memory would not save a byte. With one
//      group the block writes dgrid itself; else the group's partial sums.
//   2. warp_dgrid_small_sum_kernel: the sum over channels crosses groups, so
//      one thread per pixel adds the groups' partials in group order and
//      applies the (W/2, H/2) scale, as the JAX package sums its groups'
//      partials on the host.
// No atomics: the result is bitwise the same on every run.
//
// C interface (ctypes): lcgan_warp_dgrid_small returns cudaGetLastError()
// after the launches, 0 on success.

#include "warp_small.cuh"

namespace {

using namespace lcgan;

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
warp_dgrid_small_kernel(const T* __restrict__ x, const float* __restrict__ grid, const T* __restrict__ g,
                        float* __restrict__ partial, float* __restrict__ dgrid, int B, int C, int H, int W, int Hg,
                        int Wg, int cg) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_x = reinterpret_cast<T*>(smem);  // [H*W][cw]
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * cg;
  const int cw = min(cg, C - c0);
  stage_group<T, VEC>(x + (long long)b * H * W * C + c0, s_x, H * W, C, cw);
  stage_wait<VEC>();
  __syncthreads();

  const int nvec = cw / VEC;
  const int nout = Hg * Wg;
  const long long pix0 = (long long)b * nout;  // the batch element's first output pixel
  for (int p = threadIdx.x; p < nout; p += blockDim.x) {
    const float fx = unnormalize(grid[2 * (pix0 + p)], W);
    const float fy = unnormalize(grid[2 * (pix0 + p) + 1], H);
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float tx = fx - x0, ty = fy - y0;
    float wx[4], wy[4], dwx[4], dwy[4];
    cubic_weights(tx, wx);
    cubic_weights(ty, wy);
    cubic_weight_derivatives(tx, dwx);
    cubic_weight_derivatives(ty, dwy);
    const int ix = (int)x0 - 1, iy = (int)y0 - 1;
    const T* gp = g + (pix0 + p) * C + c0;
    float sx = 0.f, sy = 0.f;
    for (int cv = 0; cv < nvec; ++cv) {
      const int c = cv * VEC;
      float ax[VEC], ay[VEC];  // d/dfx and d/dfy of the sample, per channel
#pragma unroll
      for (int k = 0; k < VEC; ++k) ax[k] = ay[k] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int yy = iy + j;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int xx = ix + i;
          if (xx < 0 || xx >= W) continue;
          const float wdx = wy[j] * dwx[i];
          const float wdy = dwy[j] * wx[i];
          float v[VEC];
          Vec<T, VEC>::load(s_x + (yy * W + xx) * cw + c, v);
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
    if (gridDim.x == 1) {
      dgrid[2 * (pix0 + p)] = sx * (0.5f * (float)W);
      dgrid[2 * (pix0 + p) + 1] = sy * (0.5f * (float)H);
    } else {
      const long long q = (long long)blockIdx.x * B * nout + pix0 + p;  // partial[group][b][p]
      reinterpret_cast<float2*>(partial)[q] = make_float2(sx, sy);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
warp_dgrid_small_sum_kernel(const float* __restrict__ partial, float* __restrict__ dgrid, int groups,
                            long long npix, int H, int W) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  const float2* part = reinterpret_cast<const float2*>(partial);
  float sx = 0.f, sy = 0.f;
  for (int k = 0; k < groups; ++k) {  // group order: the same on every run
    const float2 v = part[k * npix + p];
    sx += v.x;
    sy += v.y;
  }
  dgrid[2 * p] = sx * (0.5f * (float)W);
  dgrid[2 * p + 1] = sy * (0.5f * (float)H);
}

template <typename T, int VEC>
int launch(const void* x, const void* grid, const void* g, void* partial, void* dgrid, int B, int C, int H,
           int W, int Hg, int Wg, int cg, cudaStream_t stream) {
  if (cg < 1 || cg % VEC || C % VEC || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)H * W * cg * sizeof(T);
  int err = allow_smem(warp_dgrid_small_kernel<T, VEC>, smem);
  if (err) return err;
  const int groups = (C + cg - 1) / cg;
  if (groups > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  warp_dgrid_small_kernel<T, VEC><<<dim3(groups, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(grid), static_cast<const T*>(g),
      static_cast<float*>(partial), static_cast<float*>(dgrid), B, C, H, W, Hg, Wg, cg);
  if (groups > 1) {
    const long long npix = (long long)B * Hg * Wg;
    warp_dgrid_small_sum_kernel<<<(unsigned)((npix + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        static_cast<const float*>(partial), static_cast<float*>(dgrid), groups, npix, H, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: (B, H, W, C) NHWC contiguous, H*W at
// most 64²; grid: (B, Hg, Wg, 2) fp32 contiguous; g: (B, Hg, Wg, C) NHWC
// contiguous in x's dtype; partial: fp32 scratch of groups * B*Hg*Wg*2
// (groups = ceil(C / cg); unused, may be null, with one group); dgrid:
// (B, Hg, Wg, 2) fp32 contiguous. cg: channels per block (a multiple of the
// vector width when vec). vec: 1 for 16-byte vectors, else scalar loads.
extern "C" int lcgan_warp_dgrid_small(const void* x, const void* grid, const void* g, void* partial, void* dgrid,
                                      int dtype, int vec, int B, int C, int H, int W, int Hg, int Wg, int cg,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, grid, g, partial, dgrid, B, C, H, W, Hg, Wg, cg, s)
               : launch<float, 1>(x, grid, g, partial, dgrid, B, C, H, W, Hg, Wg, cg, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, grid, g, partial, dgrid, B, C, H, W, Hg, Wg, cg, s)
               : launch<__nv_bfloat16, 1>(x, grid, g, partial, dgrid, B, C, H, W, Hg, Wg, cg, s);
  }
  return (int)cudaErrorInvalidValue;
}
