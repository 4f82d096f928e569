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
// of out; 32 flops per output value): a 64²·C512 batch of 8 in bf16 is 67 MB,
// 20 us at the card's rate, an 8² one under 1 us. What costs the time is the
// 16 taps of every output vector, read through L1 and L2 (16 times x's
// bytes), and the instructions of their conversions and multiply-adds; at
// 8²-16² the launch and the first bytes' latency.
//
// Design (warp_small.cuh):
//   * one block per (image, tile of th x tw output pixels, chunk of cv
//     channel vectors): tiles of 8 x 8 pixels, halved while the grid has
//     fewer blocks than the card has SMs, then 1024 bytes of a pixel halved
//     to 512 the same way (lcgan_torch/ops/warp.py _small_tile_geometry);
//   * each pixel's tap origin and 4 + 4 weights are computed once, in fp32,
//     into shared memory;
//   * a warp takes a pixel: its 32 lanes take 32 consecutive 16-byte
//     vectors of the chunk (a second round for a 1024-byte chunk), so each
//     tap's read is one 512-byte run and each output store a whole run;
//     every lane issues its 16 taps' loads before the first multiply-add
//     (two blocks an SM at up to 128 registers a thread);
//   * per channel the taps in the order j, then i, fp32 multiply-adds, taps
//     outside the image skipped, one rounding to the output dtype: the sum
//     warp_fwd.cu computes, bit for bit. No atomics, so results are
//     deterministic, and exact for any grid.
//
// Measured and not kept (PERF.md, Findings): a window of x staged in shared
// memory per tile with cp.async, cut from the extent of the tile's taps or
// from the tile's own taps and the tanh bound around them, any tap outside it
// read from device memory: windows of 48-200 KB took 1.00-1.87x the time of
// the same build without one over the four maps of a 256² batch (bf16, iid
// flow); and loading a row of four taps at a time, or each as it is summed,
// at 32-80 registers a thread.
//
// C interface (ctypes): lcgan_warp_fwd_small returns cudaGetLastError() after
// the launch, 0 on success.

#include "warp_small.cuh"

namespace {

using namespace lcgan;

constexpr int kMinBlocks = 2;  // blocks an SM: at most 128 registers a thread, for the 16 taps in flight

template <typename T, int VEC>
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
warp_fwd_small_kernel(const T* __restrict__ x, const float* __restrict__ grid, T* __restrict__ out, int C, int H,
                      int W, int Hg, int Wg, int th, int tw, int tiles_x, int ntiles, int cv, int nchunks) {
  __shared__ float4 s_wy[kMaxTilePx], s_wx[kMaxTilePx];
  __shared__ int s_iy[kMaxTilePx], s_ix[kMaxTilePx];

  const TileBlock t = tile_block(Hg, Wg, th, tw, tiles_x, ntiles, cv, nchunks, C / VEC);
  const int npx = t.th * t.tw;

  // 1. each pixel's taps and weights, once
  for (int p = threadIdx.x; p < npx; p += kTileThreads) {
    const long long pix = ((long long)t.b * Hg + t.r0 + p / t.tw) * Wg + t.q0 + p % t.tw;
    const float fx = unnormalize(grid[2 * pix], W);
    const float fy = unnormalize(grid[2 * pix + 1], H);
    const float x0 = floorf(fx), y0 = floorf(fy);
    float wx[4], wy[4];
    cubic_weights(fx - x0, wx);
    cubic_weights(fy - y0, wy);
    s_wx[p] = make_float4(wx[0], wx[1], wx[2], wx[3]);
    s_wy[p] = make_float4(wy[0], wy[1], wy[2], wy[3]);
    s_ix[p] = (int)x0 - 1;
    s_iy[p] = (int)y0 - 1;
  }
  __syncthreads();

  // 2. a warp per pixel, its lanes across the chunk's vectors
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xc = x + (long long)t.b * H * W * C + t.v0 * VEC;  // the chunk's first channel
  for (int p = warp; p < npx; p += kTileWarps) {
    const int iy = s_iy[p], ix = s_ix[p];
    const float4 wy4 = s_wy[p], wx4 = s_wx[p];
    const float wy[4] = {wy4.x, wy4.y, wy4.z, wy4.w}, wx[4] = {wx4.x, wx4.y, wx4.z, wx4.w};
    const long long opix = ((long long)t.b * Hg + t.r0 + p / t.tw) * Wg + t.q0 + p % t.tw;
    T* op = out + opix * C + t.v0 * VEC;
    for (int v = lane; v < t.cw; v += 32) {
      const T* xv = xc + v * VEC;
      typename Raw<T, VEC>::type raw[16];  // every tap's 16 bytes first, all in flight at once
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (iy + j >= 0 && iy + j < H && ix + i >= 0 && ix + i < W)
            raw[4 * j + i] = Raw<T, VEC>::load(xv + ((long long)(iy + j) * W + ix + i) * C);
        }
      }
      // per channel: taps in the order j, then i
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
          float val[VEC];
          Raw<T, VEC>::to_float(raw[4 * j + i], val);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += val[k] * wgt;
        }
      }
      Vec<T, VEC>::store(op + v * VEC, acc);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* grid, void* out, int B, int C, int H, int W, int Hg, int Wg, int th, int tw,
           int cv, cudaStream_t stream) {
  const int nvec = C / VEC;
  if (C % VEC || nvec < 1 || H < 1 || W < 1 || H > 64 || W > 64 || th < 1 || tw < 1 || th * tw > kMaxTilePx || cv < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (Wg + tw - 1) / tw, ntiles = tiles_x * ((Hg + th - 1) / th), nchunks = (nvec + cv - 1) / cv;
  const long long blocks = (long long)B * ntiles * nchunks;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  warp_fwd_small_kernel<T, VEC><<<(unsigned)blocks, kTileThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(grid), static_cast<T*>(out), C, H, W, Hg, Wg, th, tw,
      tiles_x, ntiles, cv, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: (B, H, W, C) NHWC contiguous, H and W
// at most 64; grid: (B, Hg, Wg, 2) fp32 contiguous; out: (B, Hg, Wg, C) NHWC
// contiguous. vec: 1 for 16-byte vectors (C a multiple of the vector width,
// pointers 16-byte aligned), else scalar loads. th x tw: a block's tile of
// output pixels (at most 64); cv: vectors (VEC channels, or one on the scalar
// path) of a block's chunk (lcgan_torch/ops/warp.py _small_tile_geometry).
extern "C" int lcgan_warp_fwd_small(const void* x, const void* grid, void* out, int dtype, int vec, int B, int C,
                                    int H, int W, int Hg, int Wg, int th, int tw, int cv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, grid, out, B, C, H, W, Hg, Wg, th, tw, cv, s)
               : launch<float, 1>(x, grid, out, B, C, H, W, Hg, Wg, th, tw, cv, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, grid, out, B, C, H, W, Hg, Wg, th, tw, cv, s)
               : launch<__nv_bfloat16, 1>(x, grid, out, B, C, H, W, Hg, Wg, th, tw, cv, s);
  }
  return (int)cudaErrorInvalidValue;
}
