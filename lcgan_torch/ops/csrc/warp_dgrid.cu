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
// 16-tap gather, exact for any grid, no band.
//
// What bounds it: not device-memory bytes (one read of x, of g and of the
// grid take a fifth of its time): the 16 gathered taps of every channel,
// served from L1 and L2, and the instructions spent on each tap element. A
// direct gather spends a conversion (bf16) and two FMAs per tap element, and
// each lane of a pixel would redo the pixel's weights and tap addresses. So
// the design cuts instructions:
//   * dot products first: each lane sums d_t = sum_c g[c] X[t,c] over its
//     channels for the 16 taps t (one FMA per tap element; g converted once
//     per pixel and kept in registers), then ax = sum_t wy_j dwx_i d_t and
//     ay = sum_t dwy_j wx_i d_t (32 FMAs per lane and pixel);
//   * weights once per pixel: one thread per pixel of the block's tile
//     computes its tap base, the mask of its taps on the image and the 16 + 16
//     weight products into shared memory; the lanes of the pixel read them;
//   * 2D output tiles of 8 columns by 8 rows (more where the groups are
//     narrow, fewer where the map would give too few blocks), walked one
//     tile row at a time by the block's groups, so that neighbouring rows'
//     taps meet in L1.
// A group of G lanes of one warp takes a pixel (G the power of two >= C / VEC,
// at most 32); the lanes stride over the pixel's 16-byte channel vectors, so
// each tap's loads, and the cotangent's, coalesce. The footprint of a tile is
// not staged in shared memory: at the path's widths (C >= 64) it overflows a
// block's shared memory for any but the smallest flows, and L1 serves the
// reuse within a tile.
//
// Each lane sums in fp32 in a fixed order (its channel vectors, then the
// taps), then the group reduces with xor shuffles in a fixed order. No
// atomics: the result is bitwise the same on every run.
//
// C interface (ctypes): lcgan_warp_dgrid returns cudaGetLastError() after
// the launch, 0 on success.

#include "warp_common.cuh"

namespace {

using namespace lcgan;

constexpr int kThreads = 256;
constexpr int kTileW = 8;       // columns of an output tile
constexpr int kMaxPerGroup = 8;  // pixels a group takes in a tile, at most
constexpr int kMinBlocks = 264;  // about two blocks per SM of an H100

template <typename T, int VEC, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
warp_dgrid_kernel(const T* __restrict__ x, const float* __restrict__ grid, const T* __restrict__ g,
                  float* __restrict__ dgrid, int C, int H, int W, int Hg, int Wg, int G, int tile_h,
                  int tiles_x) {
  extern __shared__ float smem[];
  const int npx = tile_h * kTileW;
  float* s_w = smem;                       // [32][npx]: wy_j dwx_i (t = 4j + i), then dwy_j wx_i
  int* s_iy = reinterpret_cast<int*>(s_w + 32 * npx);  // each pixel's first tap row
  int* s_ix = s_iy + npx;                  // and column
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_ix + npx);  // bit t: tap t on the image

  const int b = blockIdx.y;
  const int ty = blockIdx.x / tiles_x;
  const int r0 = ty * tile_h, q0 = (blockIdx.x - ty * tiles_x) * kTileW;
  const long long bpix = (long long)b * Hg * Wg;

  // 1. each pixel's taps and weights, once
  for (int i = threadIdx.x; i < npx; i += kThreads) {
    const int r = r0 + i / kTileW, q = q0 + i % kTileW;
    unsigned mask = 0;
    int iy = 0, ix = 0;
    if (r < Hg && q < Wg) {
      const long long pix = bpix + (long long)r * Wg + q;
      const float fx = unnormalize(grid[2 * pix], W);
      const float fy = unnormalize(grid[2 * pix + 1], H);
      const float x0 = floorf(fx), y0 = floorf(fy);
      const float tx = fx - x0, ty2 = fy - y0;
      float wx[4], wy[4], dwx[4], dwy[4];
      cubic_weights(tx, wx);
      cubic_weights(ty2, wy);
      cubic_weight_derivatives(tx, dwx);
      cubic_weight_derivatives(ty2, dwy);
      iy = (int)y0 - 1;
      ix = (int)x0 - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = 4 * j + k;
          s_w[t * npx + i] = wy[j] * dwx[k];
          s_w[(16 + t) * npx + i] = dwy[j] * wx[k];
          if (iy + j >= 0 && iy + j < H && ix + k >= 0 && ix + k < W) mask |= 1u << t;
        }
      }
    }
    s_iy[i] = iy;
    s_ix[i] = ix;
    s_mask[i] = mask;
  }
  __syncthreads();

  // 2. a group of G lanes per pixel; npx is a multiple of the group count,
  // so every lane of a warp runs the same number of pixels
  const int ngroups = kThreads / G;
  const int group = threadIdx.x / G;
  const int gl = threadIdx.x - group * G;
  const T* xb = x + (long long)b * H * W * C;
  const long long row_stride = (long long)W * C;
  const int nvec = C / VEC;
  for (int i = group; i < npx; i += ngroups) {
    const unsigned mask = s_mask[i];
    const int r = r0 + i / kTileW, q = q0 + i % kTileW;
    float sx = 0.f, sy = 0.f;
    if (mask) {
      const T* gp = g + (bpix + (long long)r * Wg + q) * C;
      const long long base = ((long long)s_iy[i] * W + s_ix[i]) * C;  // tap (0, 0); read only where on the image
      float d[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) d[t] = 0.f;
      for (int cv = gl; cv < nvec; cv += G) {
        const int c = cv * VEC;
        float gv[VEC];
        Vec<T, VEC>::load(gp + c, gv);
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          if (mask & (1u << t)) {
            float v[VEC];
            Vec<T, VEC>::load(xb + base + (t >> 2) * row_stride + (long long)(t & 3) * C + c, v);
#pragma unroll
            for (int k = 0; k < VEC; ++k) d[t] = fmaf(gv[k], v[k], d[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        sx = fmaf(s_w[t * npx + i], d[t], sx);
        sy = fmaf(s_w[(16 + t) * npx + i], d[t], sy);
      }
    }
    // fixed-order butterfly over the G lanes of the group; every lane of the
    // warp takes part, so the full mask is right for any group
    for (int off = G >> 1; off > 0; off >>= 1) {
      sx += __shfl_xor_sync(0xffffffffu, sx, off);
      sy += __shfl_xor_sync(0xffffffffu, sy, off);
    }
    if (gl == 0 && r < Hg && q < Wg) {
      const long long pix = bpix + (long long)r * Wg + q;
      dgrid[2 * pix] = sx * (0.5f * (float)W);
      dgrid[2 * pix + 1] = sy * (0.5f * (float)H);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* grid, const void* g, void* dgrid, int B, int C, int H, int W, int Hg,
           int Wg, cudaStream_t stream) {
  const int nvec = C / VEC;
  int G = 1;
  while (G < nvec && G < 32) G <<= 1;
  const int ngroups = kThreads / G;
  // each group takes ppg pixels of the tile: up to kMaxPerGroup (at most 256
  // pixels a tile), fewer where the map gives too few tiles to fill the card
  int ppg = kMaxPerGroup * 8 / ngroups > 1 ? kMaxPerGroup * 8 / ngroups : 1;
  const long long tiles_x = (Wg + kTileW - 1) / kTileW;
  auto count = [&](int p) { return tiles_x * ((Hg + ngroups * p / kTileW - 1) / (ngroups * p / kTileW)); };
  while (ppg > 1 && count(ppg) * B < kMinBlocks) ppg >>= 1;
  const int npx = ngroups * ppg;
  const int tile_h = npx / kTileW;
  const long long tiles = count(ppg);
  if (tiles < 1 || tiles > 0x7fffffffLL || B < 1 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)npx * (32 * sizeof(float) + 3 * sizeof(int));
  // bf16 at up to 32 vectors a pixel (C <= 256) runs faster with its
  // registers capped for three blocks an SM; fp32, and bf16 at C = 512,
  // slower (chip_smoke.py --time-backward; PERF.md)
  auto kernel = sizeof(T) == 2 && nvec <= 32 ? warp_dgrid_kernel<T, VEC, 3> : warp_dgrid_kernel<T, VEC, 1>;
  kernel<<<dim3((unsigned)tiles, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(grid), static_cast<const T*>(g),
      static_cast<float*>(dgrid), C, H, W, Hg, Wg, G, tile_h, (int)tiles_x);
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
