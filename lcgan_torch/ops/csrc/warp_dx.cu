// Feature gradient of the bicubic feature warp, for Hopper (sm_90a).
//
// For out = F.grid_sample(x, grid, mode='bicubic', padding_mode='zeros',
// align_corners=False) with cotangent g, on maps where the grid has the
// features' size (Hg = H, Wg = W, the generator's only use):
//
//   dX[b,u,v,c] = sum_{output p} K(fy_p - u) K(fx_p - v) g[b,p,c]
//
// where only the 16 taps of each p count, as in the forward.
//
// It replaces the TPU kernel _dx_gather_kernel (lcgan_tpu/ops/warp_pallas.py).
// The sum is a scatter from output pixels to their taps; written as one, it
// needs float atomics and gives other bits on every run. So, as the TPU
// kernel does, it is computed as a GATHER: each input pixel owns its sum and
// scans the output pixels that can reach it. The TPU kernel sweeps a band of
// 2M+1 output rows with matmuls, M the static tanh bound; here the window
// comes from the grid itself:
//
//   1. warp_disp_kernel: the largest |f - position| over the grid's pixels,
//      per block, into a small device buffer (no host sync);
//   2. warp_dx_kernel: every block reduces those partial maxima to d, and an
//      output pixel (r, q) can reach input pixel (u, v) only if
//      |r - u| <= ceil(d) + 2 and |q - v| <= ceil(d) + 2 (the cubic support
//      is 2). So the result is exact for any grid, like the forward.
//
// warp_dx_kernel, one block per (batch, input row u, tile of TW input
// columns, chunk of channel vectors):
//   * threads own one (column, 16-byte channel vector) each and keep its sum
//     in fp32 registers;
//   * the block walks the window's candidate output pixels in row-major
//     order, 256 at a time: each thread evaluates one candidate's taps (the
//     same rounded coordinate math as the forward) and whether one of them
//     lands on row u and the tile's columns; hits are compacted into shared
//     memory in candidate order (warp ballots, then a prefix over the 8
//     warps), with the candidate's row weight and four column weights;
//   * every thread then adds, for each hit whose column taps include its
//     column, weight * g of that output pixel, in hit order.
// The order of every sum is fixed by the shapes: the result is bitwise the
// same on every run. No atomics.
//
// What bounds it: at large flows, the candidate scan. At s = 0.1 and 256²
// the window is about 33 rows by TW + 32 columns, of which about 4 rows by
// TW + 3 columns hit; the bound (bytes: one read of g and the grid, one
// write of dx) is far below that. A faster design is later work.
//
// C interface (ctypes): lcgan_warp_dx returns cudaGetLastError() after the
// launches, 0 on success.

#include "warp_common.cuh"

namespace {

using namespace lcgan;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDispBlocks = 128;  // partial maxima of the displacement pass; _DX_SCRATCH in ops/warp.py

// Per-block max over output pixels of max(|fx - q|, |fy - r|).
__global__ void __launch_bounds__(kThreads)
warp_disp_kernel(const float* __restrict__ grid, float* __restrict__ partial, int H, int W,
                 long long npix) {
  __shared__ float s_max[kThreads];
  float dm = 0.f;
  for (long long pix = (long long)blockIdx.x * kThreads + threadIdx.x; pix < npix;
       pix += (long long)gridDim.x * kThreads) {
    const int q = (int)(pix % W);
    const int r = (int)((pix / W) % H);
    const float fx = unnormalize(grid[2 * pix], W);
    const float fy = unnormalize(grid[2 * pix + 1], H);
    dm = fmaxf(dm, fmaxf(fabsf(fx - (float)q), fabsf(fy - (float)r)));
  }
  s_max[threadIdx.x] = dm;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) s_max[threadIdx.x] = fmaxf(s_max[threadIdx.x], s_max[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[blockIdx.x] = s_max[0];
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
warp_dx_kernel(const float* __restrict__ grid, const T* __restrict__ g,
               const float* __restrict__ partial, int npartial, T* __restrict__ dx, int C, int H,
               int W, int tile, int ntiles, int nvecc, int nchunks) {
  __shared__ float s_max[kThreads];
  __shared__ int s_count[kWarps];
  __shared__ int s_pix[kThreads];    // r * W + q of each hit
  __shared__ int s_ix[kThreads];     // its first column tap
  __shared__ float s_wy[kThreads];   // its weight for row u
  __shared__ float s_wx[kThreads][4];

  const int tid = threadIdx.x;
  long long bid = blockIdx.x;
  const int chunk = (int)(bid % nchunks);
  bid /= nchunks;
  const int t = (int)(bid % ntiles);
  bid /= ntiles;
  const int u = (int)(bid % H);
  const int b = (int)(bid / H);
  const int v0 = t * tile;
  const int npix = min(tile, W - v0);

  // the window half-width R from the displacement pass
  float dm = 0.f;
  for (int i = tid; i < npartial; i += kThreads) dm = fmaxf(dm, partial[i]);
  s_max[tid] = dm;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) s_max[tid] = fmaxf(s_max[tid], s_max[tid + s]);
    __syncthreads();
  }
  const int R = (int)ceilf(s_max[0]) + 2;
  const int r0 = max(0, u - R), r1 = min(H - 1, u + R);
  const int q0 = max(0, v0 - R), q1 = min(W - 1, v0 + npix - 1 + R);
  const int ncols = q1 - q0 + 1;
  const long long ncand = (long long)(r1 - r0 + 1) * ncols;

  // this thread's (column, channel vector)
  const int col = tid / nvecc;
  const int cv = chunk * nvecc + (tid - col * nvecc);
  const int v = v0 + col;
  const bool owner = col < npix && cv * VEC < C;
  const int c = cv * VEC;

  const long long batch_pix = (long long)b * H * W;
  const float* gridb = grid + 2 * batch_pix;
  const T* gb = g + batch_pix * C;
  const int warp = tid >> 5, lane = tid & 31;

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  for (long long start = 0; start < ncand; start += kThreads) {
    // 1. evaluate one candidate output pixel per thread
    bool hit = false;
    int pix = 0, ix = 0;
    float wyu = 0.f, wx[4] = {0.f, 0.f, 0.f, 0.f};
    const long long cand = start + tid;
    if (cand < ncand) {
      const int r = r0 + (int)(cand / ncols);
      const int q = q0 + (int)(cand % ncols);
      pix = r * W + q;
      const float fx = unnormalize(gridb[2 * pix], W);
      const float fy = unnormalize(gridb[2 * pix + 1], H);
      const float y0 = floorf(fy);
      const int dy = u - ((int)y0 - 1);
      const float x0 = floorf(fx);
      ix = (int)x0 - 1;
      hit = dy >= 0 && dy < 4 && ix + 3 >= v0 && ix <= v0 + npix - 1;
      if (hit) {
        float wy[4];
        cubic_weights(fy - y0, wy);
        wyu = wy[dy];
        cubic_weights(fx - x0, wx);
      }
    }
    // 2. compact the hits into shared memory, in candidate order
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(mask);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) {
      const int n = s_count[w2];
      base += w2 < warp ? n : 0;
      total += n;
    }
    if (hit) {
      const int slot = base + __popc(mask & ((1u << lane) - 1u));
      s_pix[slot] = pix;
      s_ix[slot] = ix;
      s_wy[slot] = wyu;
#pragma unroll
      for (int i = 0; i < 4; ++i) s_wx[slot][i] = wx[i];
    }
    __syncthreads();
    // 3. accumulate the hits that reach this thread's column
    if (owner) {
      for (int h = 0; h < total; ++h) {
        const int i = v - s_ix[h];
        if (i < 0 || i > 3) continue;
        const float w = s_wy[h] * s_wx[h][i];
        float gv[VEC];
        Vec<T, VEC>::load(gb + (long long)s_pix[h] * C + c, gv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += gv[k] * w;
      }
    }
    __syncthreads();  // the next round overwrites the hit list
  }
  if (owner) Vec<T, VEC>::store(dx + (batch_pix + (long long)u * W + v) * C + c, acc);
}

template <typename T, int VEC>
int launch(const void* grid, const void* g, void* partial, void* dx, int B, int C, int H, int W,
           cudaStream_t stream) {
  const long long npix = (long long)B * H * W;
  const long long disp_blocks_needed = (npix + kThreads - 1) / kThreads;
  const int disp_blocks = (int)(disp_blocks_needed < kDispBlocks ? disp_blocks_needed : kDispBlocks);
  warp_disp_kernel<<<disp_blocks, kThreads, 0, stream>>>(static_cast<const float*>(grid),
                                                          static_cast<float*>(partial), H, W, npix);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const int nvec = C / VEC;
  const int nvecc = nvec < kThreads ? nvec : kThreads;
  const int nchunks = (nvec + nvecc - 1) / nvecc;
  int tile = kThreads / nvecc;
  tile = tile > W ? W : tile;
  const int ntiles = (W + tile - 1) / tile;
  const long long blocks = (long long)B * H * ntiles * nchunks;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  warp_dx_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(grid), static_cast<const T*>(g), static_cast<const float*>(partial),
      disp_blocks, static_cast<T*>(dx), C, H, W, tile, ntiles, nvecc, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. grid: (B, H, W, 2) fp32 contiguous; g:
// (B, H, W, C) NHWC contiguous; partial: kDispBlocks fp32; dx:
// (B, H, W, C) NHWC contiguous in g's dtype. vec: 1 to force scalar loads
// (C not a multiple of the vector width, or pointers not 16-byte aligned),
// else 16-byte vectors.
extern "C" int lcgan_warp_dx(const void* grid, const void* g, void* partial, void* dx, int dtype,
                             int vec, int B, int C, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(grid, g, partial, dx, B, C, H, W, s)
               : launch<float, 1>(grid, g, partial, dx, B, C, H, W, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(grid, g, partial, dx, B, C, H, W, s)
               : launch<__nv_bfloat16, 1>(grid, g, partial, dx, B, C, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}
