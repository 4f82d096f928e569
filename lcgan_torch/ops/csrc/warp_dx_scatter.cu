// Feature gradient of the bicubic feature warp at narrow maps (C < 128), for
// Hopper (sm_90a).
//
// For out = F.grid_sample(x, grid, mode='bicubic', padding_mode='zeros',
// align_corners=False) with cotangent g, on maps where the grid has the
// features' size (Hg = H, Wg = W, the generator's only use):
//
//   dX[b,u,v,c] = sum_{output p} K(fy_p - u) K(fx_p - v) g[b,p,c]
//
// over the 16 taps of each p, as in the forward.
//
// It replaces the TPU kernel _dx_scatter_kernel and its overlap-add
// _overlap_add (lcgan_tpu/ops/warp_pallas.py), which scatter output tiles
// into fp32 slabs with banded matmuls because a TPU gathers slowly. Here the
// scatter is inverted through an index instead:
//
//   1. warp_dxs_bucket_kernel: each output pixel's bucket is its base tap
//      (floor(fy) - 1, floor(fx) - 1), rounded as the forward rounds it
//      (warp_common.cuh); an integer histogram counts each bucket. A pixel
//      whose taps all miss the map gets no bucket.
//   2. warp_dxs_scan_tiles_kernel, warp_dxs_scan_carry_kernel: an exclusive
//      prefix of the counts gives each bucket its range of a list (CSR).
//   3. warp_dxs_place_kernel: each pixel takes a slot of its bucket's range
//      with an integer atomic; warp_dxs_sort_kernel then sorts each range by
//      pixel index, so the list is the same on every run (a stable counting
//      sort).
//   4. warp_dxs_gather_kernel: one block per tile of input pixels (8 x 16 at
//      C64 bf16) and chunk of channels (dx_gather_tile, warp_dx_gather.cuh,
//      shared with warp_dx_small.cu).
//
// What bounds it on this card: the gather's re-reads. Its byte bound is one
// read of g and the grid and one write of dx, but each output pixel's row of
// g is read by the 16 input pixels it taps, and each hit's weights are
// needed by every channel vector of those pixels. Read per thread from L2,
// with the weights recomputed per lane from the grid behind a chain of three
// dependent loads (list, grid, g), the gather took 90% of the kernel's time
// at 512² (PERF.md). The tiled gather computes each hit's weights once per
// block, copies each hit's row of g once per block into shared memory
// (about 1.6 times per row over the map, not 16), and sums out of shared
// memory only, two hits at a time. The index (six launches) is left as it
// was: it takes about a sixth of the new kernel's time at 512² (PERF.md §6).
//
// The result is exact for any grid and needs no bound on the flow. Every
// sum has a fixed order, the index list's (bucket rows ascending, then
// bucket, then pixel), and no float atomics are used: the result is bitwise
// the same on every run.
//
// C interface (ctypes): lcgan_warp_dx_scatter returns cudaGetLastError()
// after the launches, 0 on success.

#include <algorithm>
#include <climits>

#include "warp_dx_gather.cuh"

namespace {

using namespace lcgan;

constexpr int kThreads = kGatherThreads;
constexpr int kScanItems = 4;
constexpr int kScanTile = kThreads * kScanItems;  // counts scanned by one block
constexpr int kItems = 1024;        // (pixel, vector) items of a gather block at most
constexpr int kChunkBytes = 256;    // channel bytes of a pixel a gather block takes
constexpr long long kBufferBytes = 52 * 1024;  // the gather's hit buffer: four blocks an SM
constexpr int kMinBlocks = 264;     // about two blocks per SM of an H100

// A bucket's key: (b, by + 3, bx + 3) row-major over (B, H + 3, W + 3). Every
// base with a tap on the map lies in [-3, size - 1].
__device__ __forceinline__ int bucket_key(int b, int by, int bx, int H, int W) {
  return (b * (H + 3) + by + 3) * (W + 3) + bx + 3;
}

__global__ void __launch_bounds__(kThreads)
warp_dxs_bucket_kernel(const float* __restrict__ grid, int* __restrict__ key, int* __restrict__ count, int H,
                       int W, int npix) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= npix) return;
  const int b = pix / (H * W);
  const int by = (int)floorf(unnormalize(grid[2 * (long long)pix + 1], H)) - 1;
  const int bx = (int)floorf(unnormalize(grid[2 * (long long)pix], W)) - 1;
  int k = -1;
  if (by >= -3 && by < H && bx >= -3 && bx < W) {
    k = bucket_key(b, by, bx, H, W);
    atomicAdd(&count[k], 1);
  }
  key[pix] = k;
}

// Exclusive prefix of count[0, n) within each tile of kScanTile; each tile's
// total into tile_sum.
__global__ void __launch_bounds__(kThreads)
warp_dxs_scan_tiles_kernel(const int* __restrict__ count, int* __restrict__ offset, int* __restrict__ tile_sum,
                           int n) {
  __shared__ int s_warp[kThreads / 32];
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = base + i < n ? count[base + i] : 0;
    sum += v[i];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int warp_base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int t = s_warp[w];
    warp_base += w < warp ? t : 0;
    total += t;
  }
  int run = warp_base + incl - sum;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < n) offset[base + i] = run;
    run += v[i];
  }
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// Adds to each tile's prefixes the totals of the tiles before it.
__global__ void __launch_bounds__(kThreads)
warp_dxs_scan_carry_kernel(int* __restrict__ offset, const int* __restrict__ tile_sum, int n) {
  __shared__ int s_sum[kThreads];
  int c = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += kThreads) c += tile_sum[i];
  s_sum[threadIdx.x] = c;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) s_sum[threadIdx.x] += s_sum[threadIdx.x + s];
    __syncthreads();
  }
  const int carry = s_sum[0];
  const int base = blockIdx.x * kScanTile;
  for (int i = threadIdx.x; i < kScanTile && base + i < n; i += kThreads) offset[base + i] += carry;
}

// Each bucketed pixel takes one slot of its bucket's range; count[k] falls
// back to 0.
__global__ void __launch_bounds__(kThreads)
warp_dxs_place_kernel(const int* __restrict__ key, const int* __restrict__ offset, int* __restrict__ count,
                      int* __restrict__ list, int npix) {
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= npix) return;
  const int k = key[pix];
  if (k < 0) return;
  list[offset[k] + atomicSub(&count[k], 1) - 1] = pix;
}

// Sorts each bucket's range ascending (sort_ascending, warp_common.cuh).
__global__ void __launch_bounds__(kThreads)
warp_dxs_sort_kernel(const int* __restrict__ offset, int* __restrict__ list, int nkeys) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= nkeys) return;
  const int lo = offset[k];
  sort_ascending(list + lo, offset[k + 1] - lo);
}

// One block per (batch, TH x TW tile of input pixels, chunk of channels):
// dx_gather_tile (warp_dx_gather.cuh) over the whole batch's index.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
warp_dxs_gather_kernel(const float* __restrict__ grid, const T* __restrict__ g, const int* __restrict__ offset,
                       const int* __restrict__ list, T* __restrict__ dx, int C, int H, int W, int th, int tw,
                       int tiles_x, int ntiles, int cv, int nchunks, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long bid = blockIdx.x;
  const int chunk = (int)(bid % nchunks);
  bid /= nchunks;
  const int tile = (int)(bid % ntiles);
  const int b = (int)(bid / ntiles);
  const int ty = tile / tiles_x;
  dx_gather_tile<T, VEC>(grid, g, offset + bucket_key(b, -3, -3, H, W), list, dx, smem, b, C, H, W, ty * th,
                         (tile - ty * tiles_x) * tw, th, tw, chunk, cv, nbuf);
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename T, int VEC>
int launch(const void* grid_, const void* g, int* scratch, long long scratch_ints, void* dx, int B, int C,
           int H, int W, cudaStream_t stream) {
  const long long npix = (long long)B * H * W;
  const long long nkeys = (long long)B * (H + 3) * (W + 3);
  const long long ncount = nkeys + 1;  // count[nkeys] stays 0: offset[nkeys] is the total
  const long long ntiles = (ncount + kScanTile - 1) / kScanTile;
  const int nvec = C / VEC;
  if (nvec < 1 || npix > INT_MAX || ncount > INT_MAX - kScanTile) return (int)cudaErrorInvalidValue;
  if (scratch_ints < 2 * npix + 2 * ncount + ntiles) return (int)cudaErrorInvalidValue;
  int* key = scratch;
  int* list = key + npix;
  int* count = list + npix;
  int* offset = count + ncount;
  int* tile_sum = offset + ncount;
  const float* grid = static_cast<const float*>(grid_);

  int err = (int)cudaMemsetAsync(count, 0, ncount * sizeof(int), stream);
  if (err) return err;
  warp_dxs_bucket_kernel<<<blocks_for(npix), kThreads, 0, stream>>>(grid, key, count, H, W, (int)npix);
  warp_dxs_scan_tiles_kernel<<<(unsigned)ntiles, kThreads, 0, stream>>>(count, offset, tile_sum, (int)ncount);
  warp_dxs_scan_carry_kernel<<<(unsigned)ntiles, kThreads, 0, stream>>>(offset, tile_sum, (int)ncount);
  warp_dxs_place_kernel<<<blocks_for(npix), kThreads, 0, stream>>>(key, offset, count, list, (int)npix);
  warp_dxs_sort_kernel<<<blocks_for(nkeys), kThreads, 0, stream>>>(offset, list, (int)nkeys);
  err = (int)cudaGetLastError();
  if (err) return err;

  // the gather's launch: chunks of up to kChunkBytes of a pixel's channels;
  // tiles of at most kItems items, smaller while the grid is short of about
  // two blocks per SM and a block keeps a round of items
  const int cv = std::min(nvec, std::max(1, kChunkBytes / (int)(VEC * sizeof(T))));
  const long long nchunks = cdiv(nvec, cv);
  int tw = std::min(W, kMaxTile), th = std::min(H, kMaxTile);
  while (th * tw * cv > kItems) {
    if (th >= tw) th = (th + 1) / 2; else tw = (tw + 1) / 2;
  }
  auto count_blocks = [&] { return B * cdiv(W, tw) * cdiv(H, th) * nchunks; };
  while (count_blocks() < kMinBlocks && th * tw * cv > kThreads && th * tw > 1) {
    if (th >= tw) th = (th + 1) / 2; else tw = (tw + 1) / 2;
  }
  const int tiles_x = (int)cdiv(W, tw);
  const long long gtiles = tiles_x * cdiv(H, th);
  const long long blocks = count_blocks();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // the hit buffer: as many hits as kBufferBytes holds (a row of g, 8 weights
  // and the pixel each), and no more than the map has
  const long long per_hit = (long long)cv * VEC * sizeof(T) + 8 * sizeof(float) + sizeof(int);
  const int nbuf = (int)((std::max(1LL, std::min(kBufferBytes / per_hit, npix)) + 3) & ~3LL);
  const size_t smem = (size_t)nbuf * per_hit;
  err = (int)cudaFuncSetAttribute(warp_dxs_gather_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  warp_dxs_gather_kernel<T, VEC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      grid, static_cast<const T*>(g), offset, list, static_cast<T*>(dx), C, H, W, th, tw, tiles_x, (int)gtiles, cv,
      (int)nchunks, nbuf);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. grid: (B, H, W, 2) fp32 contiguous; g:
// (B, H, W, C) NHWC contiguous; scratch: int32 workspace of scratch_ints
// (2 B*H*W + 2 (nkeys + 1) + ceil((nkeys + 1) / 1024), nkeys = B (H+3) (W+3));
// dx: (B, H, W, C) NHWC contiguous in g's dtype. vec: 1 to force scalar loads
// (C not a multiple of the vector width, or pointers not 16-byte aligned),
// else 16-byte vectors.
extern "C" int lcgan_warp_dx_scatter(const void* grid, const void* g, void* scratch, long long scratch_ints,
                                     void* dx, int dtype, int vec, int B, int C, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ws = static_cast<int*>(scratch);
  if (dtype == 0) {
    return vec ? launch<float, 4>(grid, g, ws, scratch_ints, dx, B, C, H, W, s)
               : launch<float, 1>(grid, g, ws, scratch_ints, dx, B, C, H, W, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(grid, g, ws, scratch_ints, dx, B, C, H, W, s)
               : launch<__nv_bfloat16, 1>(grid, g, ws, scratch_ints, dx, B, C, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}
