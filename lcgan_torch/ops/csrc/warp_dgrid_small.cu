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
// write of dgrid; 64 flops per (pixel, channel)). What costs the time is, as
// in the forward, the 16 taps of every channel vector, read through L1 and
// L2; at 8²-16² the launch and the first bytes' latency.
//
// Design (warp_small.cuh), one launch:
//   * one block per (image, tile of th x tw output pixels), all C channels:
//     the sum over channels stays inside the block, so there are no partial
//     sums in device memory and no second launch; tiles of 8 x 8 pixels,
//     halved while the grid has fewer blocks than the card has SMs
//     (lcgan_torch/ops/warp.py _small_tile_geometry);
//   * each pixel's tap origin, 4 + 4 weights and 4 + 4 derivative weights
//     are computed once, in fp32, into shared memory;
//   * a warp takes a pixel: its 32 lanes take consecutive 16-byte vectors of
//     the pixel's channels (lane l: vectors l, l + 32, ...), so each tap's
//     read and g's are 512-byte runs; every lane issues its 16 taps' loads
//     before the first multiply-add (two blocks an SM at up to 128
//     registers a thread);
//   * dot products first: each lane converts its vectors of g once and sums
//     d_t = sum_c g[c] X[t,c] over its channels for the 16 taps t (one
//     multiply-add per tap element), then dfx = sum_j wy_j sum_i dwx_i d_ji
//     and dfy = sum_j dwy_j sum_i wx_i d_ji; the 32 lanes reduce with xor
//     shuffles in a fixed order and lane 0 writes the pixel's dgrid.
// Every sum is fp32 in a fixed order, and no atomics are used: the result is
// bitwise the same on every run, and exact for any grid.
//
// Measured and not kept (PERF.md, Findings): a window of x staged in shared
// memory per tile (0.98-1.64x the time of the same build without one over
// the four maps of a 256² batch, bf16, iid flow), and loading fewer taps
// ahead at 32-80 registers a thread.
//
// C interface (ctypes): lcgan_warp_dgrid_small returns cudaGetLastError()
// after the launch, 0 on success.

#include "warp_small.cuh"

namespace {

using namespace lcgan;

constexpr int kMinBlocks = 2;  // blocks an SM: at most 128 registers a thread, for the 16 taps in flight

template <typename T, int VEC>
__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
warp_dgrid_small_kernel(const T* __restrict__ x, const float* __restrict__ grid, const T* __restrict__ g,
                        float* __restrict__ dgrid, int C, int H, int W, int Hg, int Wg, int th, int tw, int tiles_x,
                        int ntiles) {
  __shared__ float4 s_w[kMaxTilePx][4];  // wy, wx, dwy, dwx
  __shared__ int s_iy[kMaxTilePx], s_ix[kMaxTilePx];

  const int nvec = C / VEC;
  const TileBlock t = tile_block(Hg, Wg, th, tw, tiles_x, ntiles, nvec, 1, nvec);
  const int npx = t.th * t.tw;

  // 1. each pixel's taps, weights and derivative weights, once
  for (int p = threadIdx.x; p < npx; p += kTileThreads) {
    const long long pix = ((long long)t.b * Hg + t.r0 + p / t.tw) * Wg + t.q0 + p % t.tw;
    const float fx = unnormalize(grid[2 * pix], W);
    const float fy = unnormalize(grid[2 * pix + 1], H);
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float tx = fx - x0, ty = fy - y0;
    float wx[4], wy[4], dwx[4], dwy[4];
    cubic_weights(tx, wx);
    cubic_weights(ty, wy);
    cubic_weight_derivatives(tx, dwx);
    cubic_weight_derivatives(ty, dwy);
    s_w[p][0] = make_float4(wy[0], wy[1], wy[2], wy[3]);
    s_w[p][1] = make_float4(wx[0], wx[1], wx[2], wx[3]);
    s_w[p][2] = make_float4(dwy[0], dwy[1], dwy[2], dwy[3]);
    s_w[p][3] = make_float4(dwx[0], dwx[1], dwx[2], dwx[3]);
    s_ix[p] = (int)x0 - 1;
    s_iy[p] = (int)y0 - 1;
  }
  __syncthreads();

  // 2. a warp per pixel, its lanes across the pixel's vectors: the 16 dot
  // products of g with the taps, then the weights
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xb = x + (long long)t.b * H * W * C;
  for (int p = warp; p < npx; p += kTileWarps) {
    const int iy = s_iy[p], ix = s_ix[p];
    const long long pix = ((long long)t.b * Hg + t.r0 + p / t.tw) * Wg + t.q0 + p % t.tw;
    const T* gp = g + pix * C;
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      const T* xv = xb + v * VEC;
      float gv[VEC];
      Vec<T, VEC>::load(gp + v * VEC, gv);
      typename Raw<T, VEC>::type raw[16];  // every tap's 16 bytes first, all in flight at once
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (iy + j >= 0 && iy + j < H && ix + i >= 0 && ix + i < W)
            raw[4 * j + i] = Raw<T, VEC>::load(xv + ((long long)(iy + j) * W + ix + i) * C);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int yy = iy + j;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int xx = ix + i;
          if (xx < 0 || xx >= W) continue;
          float val[VEC];
          Raw<T, VEC>::to_float(raw[4 * j + i], val);
#pragma unroll
          for (int k = 0; k < VEC; ++k) d[4 * j + i] = fmaf(gv[k], val[k], d[4 * j + i]);
        }
      }
    }
    const float4 wy = s_w[p][0], wx = s_w[p][1], dwy = s_w[p][2], dwx = s_w[p][3];
    const float wyj[4] = {wy.x, wy.y, wy.z, wy.w}, wxi[4] = {wx.x, wx.y, wx.z, wx.w};
    const float dwyj[4] = {dwy.x, dwy.y, dwy.z, dwy.w}, dwxi[4] = {dwx.x, dwx.y, dwx.z, dwx.w};
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float rx = 0.f, ry = 0.f;  // row j's sums over i, against dwx and wx
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rx = fmaf(dwxi[i], d[4 * j + i], rx);
        ry = fmaf(wxi[i], d[4 * j + i], ry);
      }
      sx = fmaf(wyj[j], rx, sx);
      sy = fmaf(dwyj[j], ry, sy);
    }
    // fixed-order butterfly over the warp's 32 lanes
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sx += __shfl_xor_sync(0xffffffffu, sx, off);
      sy += __shfl_xor_sync(0xffffffffu, sy, off);
    }
    if (lane == 0) reinterpret_cast<float2*>(dgrid)[pix] = make_float2(sx * (0.5f * (float)W), sy * (0.5f * (float)H));
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* grid, const void* g, void* dgrid, int B, int C, int H, int W, int Hg, int Wg,
           int th, int tw, cudaStream_t stream) {
  const int nvec = C / VEC;
  if (C % VEC || nvec < 1 || H < 1 || W < 1 || H > 64 || W > 64 || th < 1 || tw < 1 || th * tw > kMaxTilePx)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (Wg + tw - 1) / tw, ntiles = tiles_x * ((Hg + th - 1) / th);
  const long long blocks = (long long)B * ntiles;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  warp_dgrid_small_kernel<T, VEC><<<(unsigned)blocks, kTileThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(grid), static_cast<const T*>(g),
      static_cast<float*>(dgrid), C, H, W, Hg, Wg, th, tw, tiles_x, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: (B, H, W, C) NHWC contiguous, H and W
// at most 64; grid: (B, Hg, Wg, 2) fp32 contiguous; g: (B, Hg, Wg, C) NHWC
// contiguous in x's dtype; dgrid: (B, Hg, Wg, 2) fp32 contiguous. vec: 1 for
// 16-byte vectors, else scalar loads. th x tw: a block's tile of output
// pixels (at most 64; lcgan_torch/ops/warp.py _small_tile_geometry).
extern "C" int lcgan_warp_dgrid_small(const void* x, const void* grid, const void* g, void* dgrid, int dtype, int vec,
                                      int B, int C, int H, int W, int Hg, int Wg, int th, int tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, grid, g, dgrid, B, C, H, W, Hg, Wg, th, tw, s)
               : launch<float, 1>(x, grid, g, dgrid, B, C, H, W, Hg, Wg, th, tw, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, grid, g, dgrid, B, C, H, W, Hg, Wg, th, tw, s)
               : launch<__nv_bfloat16, 1>(x, grid, g, dgrid, B, C, H, W, Hg, Wg, th, tw, s);
  }
  return (int)cudaErrorInvalidValue;
}
