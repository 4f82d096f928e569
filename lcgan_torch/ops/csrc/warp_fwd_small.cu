// Forward bicubic feature warp at small maps (at most 64²), for Hopper
// (sm_90a).
//
// Computes torch F.grid_sample(x, grid, mode='bicubic', padding_mode='zeros',
// align_corners=False) on channels_last (NHWC) features, as warp_fwd.cu does:
//
//   out[b,r,l,c] = sum_j K(fy - j) sum_s K(fx - s) X[b,j,s,c],   A = -0.75
//
// It replaces the TPU kernel _fwd_small_kernel and its host _fwd_small_call
// (lcgan_tpu/ops/warp_pallas.py), which keeps one batch element's whole
// padded map in VMEM, packs output rows onto the 128 lanes and sweeps a band
// of rows with matmuls. None of that layout is kept: on Hopper the direct
// 16-tap gather is the natural form, exact for any grid (no band, no
// displacement bound).
//
// What bounds it: device-memory bytes (one read of x and the grid, one write
// of out; 32 flops per output value). But the maps are small: a 64²·C512
// batch of 8 in bf16 is 67 MB, 20 us at the card's rate, and an 8² one under
// 1 us, so the launch and the first bytes' latency weigh as much.
//
// Design: what VMEM residency gave the TPU kernel, shared memory gives here.
//   * one block per (channel group, batch element); the host sizes the
//     groups so that the grid has about two blocks per SM;
//   * the block copies its group's whole map into shared memory with 16-byte
//     cp.async copies, so each input byte leaves device memory once
//     (warp_fwd.cu re-reads taps through L2);
//   * threads stride over (output pixel, channel vector) pairs, compute the
//     pixel's weights in fp32 and gather the 16 taps from shared memory;
//   * fp32 sums, taps outside the image skipped, output in the input dtype;
//     no atomics, so results are deterministic.
//
// C interface (ctypes): lcgan_warp_fwd_small returns cudaGetLastError() after
// the launch, 0 on success.

#include "warp_small.cuh"

namespace {

using namespace lcgan;

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
warp_fwd_small_kernel(const T* __restrict__ x, const float* __restrict__ grid, T* __restrict__ out, int C,
                      int H, int W, int Hg, int Wg, int cg) {
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
  const float* gb = grid + 2LL * b * nout;
  T* ob = out + (long long)b * nout * C + c0;
  for (int item = threadIdx.x; item < nout * nvec; item += blockDim.x) {
    const int p = item / nvec;
    const int c = (item - p * nvec) * VEC;
    const float fx = unnormalize(gb[2 * p], W);
    const float fy = unnormalize(gb[2 * p + 1], H);
    const float x0 = floorf(fx), y0 = floorf(fy);
    float wx[4], wy[4];
    cubic_weights(fx - x0, wx);
    cubic_weights(fy - y0, wy);
    const int ix = (int)x0 - 1, iy = (int)y0 - 1;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int yy = iy + j;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xx = ix + i;
        if (xx < 0 || xx >= W) continue;
        const float wgt = wy[j] * wx[i];
        float v[VEC];
        Vec<T, VEC>::load(s_x + (yy * W + xx) * cw + c, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[k] * wgt;
      }
    }
    Vec<T, VEC>::store(ob + (long long)p * C + c, acc);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* grid, void* out, int B, int C, int H, int W, int Hg, int Wg, int cg,
           cudaStream_t stream) {
  if (cg < 1 || cg % VEC || C % VEC || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)H * W * cg * sizeof(T);
  int err = allow_smem(warp_fwd_small_kernel<T, VEC>, smem);
  if (err) return err;
  const dim3 blocks((C + cg - 1) / cg, B);
  warp_fwd_small_kernel<T, VEC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(grid), static_cast<T*>(out), C, H, W, Hg, Wg, cg);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: (B, H, W, C) NHWC contiguous, H*W at
// most 64²; grid: (B, Hg, Wg, 2) fp32 contiguous; out: (B, Hg, Wg, C) NHWC
// contiguous. cg: channels per block (a multiple of the vector width when
// vec). vec: 1 for 16-byte vectors (C a multiple of the vector width,
// pointers 16-byte aligned), else scalar loads.
extern "C" int lcgan_warp_fwd_small(const void* x, const void* grid, void* out, int dtype, int vec, int B,
                                    int C, int H, int W, int Hg, int Wg, int cg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, grid, out, B, C, H, W, Hg, Wg, cg, s)
               : launch<float, 1>(x, grid, out, B, C, H, W, Hg, Wg, cg, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, grid, out, B, C, H, W, Hg, Wg, cg, s)
               : launch<__nv_bfloat16, 1>(x, grid, out, B, C, H, W, Hg, Wg, cg, s);
  }
  return (int)cudaErrorInvalidValue;
}
