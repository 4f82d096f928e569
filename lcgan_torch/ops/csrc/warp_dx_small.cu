// Feature gradient of the bicubic feature warp at small maps (at most 64²),
// for Hopper (sm_90a).
//
// For out = F.grid_sample(x, grid, mode='bicubic', padding_mode='zeros',
// align_corners=False) with cotangent g, on maps where the grid has the
// features' size (Hg = H, Wg = W, the generator's only use):
//
//   dX[b,u,v,c] = sum_{output p} K(fy_p - u) K(fx_p - v) g[b,p,c]
//
// over the 16 taps of each p, as in the forward.
//
// It replaces the TPU kernel _dx_small_kernel (lcgan_tpu/ops/warp_pallas.py,
// called from _bwd_small_call), which scatters each packed lane tile of g
// into one whole-map fp32 slab in VMEM with banded matmuls, after which the
// host crops the halo. Here the scatter is inverted into a gather, as
// warp_dx_scatter.cu does, but inside one block's shared memory, in one
// launch:
//
//   1. the block starts copying its channel group of g's whole map into
//      shared memory (16-byte cp.async copies, each byte read once) and,
//      while they fly, buckets the output pixels by their base tap
//      (floor(fy) - 1, floor(fx) - 1), rounded as the forward rounds it
//      (warp_common.cuh), with an integer histogram in shared memory. A pixel
//      whose taps all miss the map gets no bucket;
//   2. an exclusive scan of the counts gives each bucket its range of a list;
//      each pixel takes a slot of its bucket's range with an integer atomic,
//      then each range is sorted by pixel index (sort_ascending), so the
//      list is the same on every run;
//   3. one thread per (input pixel, channel vector) sums over the 16 buckets
//      whose pixels can tap it. The four buckets (by, v-3 .. v) of one bucket
//      row are adjacent in the list, so it walks four ranges, bucket rows in
//      ascending order, then bucket, then pixel, reading g from shared
//      memory, and writes its dx vector once.
//
// The index (steps 1-2) is rebuilt by every group's block: a few thousand
// integer operations, overlapped with the copy of g. Shared memory per
// block: the group's map of g, 16 bytes per pixel (its fractional offsets,
// bucket and list slot) and one int per bucket ((H+3)(W+3) + 1 of them),
// 210 KB at 64² for a bf16 group of 16 channels: one block per SM, so the
// host makes the groups as wide as about one block per SM allows, and so
// rebuilds the index as few times as it can.
//
// The sums are fp32, in a fixed order, and no float atomics are used: the
// result is exact for any grid and bitwise the same on every run. A grid that
// gathers every pixel onto one spot puts the whole map in one bucket, which
// is heap-sorted.
//
// What bounds it: device-memory bytes (one read of g and the grid, one write
// of dx; 32 flops per (pixel, channel)); at these sizes the launch and the
// first bytes' latency weigh as much.
//
// C interface (ctypes): lcgan_warp_dx_small returns cudaGetLastError() after
// the launch, 0 on success.

#include "warp_small.cuh"

namespace {

using namespace lcgan;

constexpr int kThreads = 512;

// In-place exclusive prefix sum of a[0, n) in shared memory by the whole
// block (blockDim.x a multiple of 32): each thread scans a contiguous chunk.
__device__ void block_exclusive_scan(int* a, int n) {
  __shared__ int s_warp[kThreads / 32];
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += s_warp[w];
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
warp_dx_small_kernel(const float* __restrict__ grid, const T* __restrict__ g, T* __restrict__ dx, int C, int H,
                     int W, int cg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * cg;
  const int cw = min(cg, C - c0);
  const int npix = H * W;
  const int nkeys = (H + 3) * (W + 3);  // buckets (by + 3, bx + 3): every base with a tap on the map
  T* s_g = reinterpret_cast<T*>(smem);  // [npix][cw]
  float2* s_t = reinterpret_cast<float2*>(smem + (((size_t)npix * cw * sizeof(T) + 15) & ~(size_t)15));
  int* s_key = reinterpret_cast<int*>(s_t + npix);  // each pixel's bucket (or -1), then its bx + 3
  int* s_list = s_key + npix;                       // pixel indices, grouped by bucket
  int* s_end = s_list + npix;                       // [nkeys + 1]: counts, then offsets

  stage_group<T, VEC>(g + (long long)b * npix * C + c0, s_g, npix, C, cw);
  for (int k = threadIdx.x; k <= nkeys; k += blockDim.x) s_end[k] = 0;
  __syncthreads();

  const float* gb = grid + 2LL * b * npix;
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const float fx = unnormalize(gb[2 * p], W);
    const float fy = unnormalize(gb[2 * p + 1], H);
    const float x0 = floorf(fx), y0 = floorf(fy);
    const int by = (int)y0 - 1, bx = (int)x0 - 1;
    s_t[p] = make_float2(fx - x0, fy - y0);
    int k = -1;
    if (by >= -3 && by < H && bx >= -3 && bx < W) {
      k = (by + 3) * (W + 3) + bx + 3;
      atomicAdd(&s_end[k], 1);
    }
    s_key[p] = k;
  }
  __syncthreads();
  block_exclusive_scan(s_end, nkeys + 1);  // s_end[k]: bucket k's first slot
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int k = s_key[p];
    if (k < 0) continue;
    s_list[atomicAdd(&s_end[k], 1)] = p;
    s_key[p] = k - (k / (W + 3)) * (W + 3);  // from here on: the pixel's bx + 3
  }
  __syncthreads();
  // s_end[k] is now bucket k's end, and bucket k spans [k ? s_end[k-1] : 0, s_end[k])
  for (int k = threadIdx.x; k < nkeys; k += blockDim.x) {
    const int lo = k ? s_end[k - 1] : 0;
    sort_ascending(s_list + lo, s_end[k] - lo);
  }
  stage_wait<VEC>();
  __syncthreads();

  const int nvec = cw / VEC;
  T* db = dx + (long long)b * npix * C + c0;
  for (int item = threadIdx.x; item < npix * nvec; item += blockDim.x) {
    const int pix = item / nvec;  // the input pixel (u, v)
    const int c = (item - pix * nvec) * VEC;
    const int u = pix / W, v = pix - (pix / W) * W;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
#pragma unroll
    for (int dy = 3; dy >= 0; --dy) {  // bucket rows by = u - dy, ascending
      const int k0 = (u - dy + 3) * (W + 3) + v;  // buckets (by, v - 3 .. v)
      const int hi = s_end[k0 + 3];
      for (int e = k0 ? s_end[k0 - 1] : 0; e < hi; ++e) {
        const int p = s_list[e];
        const float2 t = s_t[p];
        const int i = v + 3 - s_key[p];  // the tap's column in p's 4x4 window
        const float wgt = cubic_tap(t.y, dy) * cubic_tap(t.x, i);
        float gv[VEC];
        Vec<T, VEC>::load(s_g + p * cw + c, gv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += gv[k] * wgt;
      }
    }
    Vec<T, VEC>::store(db + (long long)pix * C + c, acc);
  }
}

template <typename T, int VEC>
int launch(const void* grid, const void* g, void* dx, int B, int C, int H, int W, int cg, cudaStream_t stream) {
  if (cg < 1 || cg % VEC || C % VEC || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t npix = (size_t)H * W;
  const size_t smem = ((npix * cg * sizeof(T) + 15) & ~(size_t)15) + npix * 16 + ((size_t)(H + 3) * (W + 3) + 1) * 4;
  int err = allow_smem(warp_dx_small_kernel<T, VEC>, smem);
  if (err) return err;
  warp_dx_small_kernel<T, VEC><<<dim3((C + cg - 1) / cg, B), kThreads, smem, stream>>>(
      static_cast<const float*>(grid), static_cast<const T*>(g), static_cast<T*>(dx), C, H, W, cg);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. grid: (B, H, W, 2) fp32 contiguous; g:
// (B, H, W, C) NHWC contiguous, H and W at most 64; dx: (B, H, W, C) NHWC
// contiguous in g's dtype. cg: channels per block (a multiple of the vector
// width when vec). vec: 1 for 16-byte vectors, else scalar loads.
extern "C" int lcgan_warp_dx_small(const void* grid, const void* g, void* dx, int dtype, int vec, int B, int C,
                                   int H, int W, int cg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(grid, g, dx, B, C, H, W, cg, s) : launch<float, 1>(grid, g, dx, B, C, H, W, cg, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(grid, g, dx, B, C, H, W, cg, s)
               : launch<__nv_bfloat16, 1>(grid, g, dx, B, C, H, W, cg, s);
  }
  return (int)cudaErrorInvalidValue;
}
