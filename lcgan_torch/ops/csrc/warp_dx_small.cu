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
// host crops the halo. Here the scatter is inverted into a gather through a
// bucket index of the output pixels, as in warp_dx_scatter.cu. The index:
// each output pixel's bucket is its base tap (floor(fy) - 1, floor(fx) - 1),
// rounded as the forward rounds it (warp_common.cuh); an integer histogram in
// shared memory, an exclusive scan, each pixel placed in its bucket's range
// with an integer atomic, then each range sorted by pixel index, so the list
// is the same on every run. A pixel whose taps all miss the map gets no
// bucket. Two designs, by map size (the host's choice, "local"):
//
//   - maps of more than 256 pixels (32², 64²), two launches: one block per
//     image builds its index once and writes it to a scratch buffer
//     (warp_dxsm_index_kernel: 34 KB per 64² image, read back from L2); then
//     the gather, one block per tile of input pixels (4 x 8 at 64²) and
//     chunk of 512 bytes of channels (a warp's lanes are one pixel's 32
//     16-byte vectors, so they walk the same hits), dx_gather_tile
//     (warp_dx_gather.cuh, shared with warp_dx_scatter.cu): each hit's
//     4 + 4 weights computed once and its row of g copied once (cp.async)
//     into a 52 KB buffer, four blocks an SM, so that one block's copy
//     overlaps another's sums; the sums walk the buffer, two hits at a time;
//   - maps of at most 256 pixels (8², 16²), one launch (warp_dxsm_map_kernel):
//     one block per image and group of channels (16 at C512: about one block
//     per SM, so that few blocks build each image's index) copies the group's
//     whole map of g into shared memory (cp.async) while it builds the
//     image's index and each pixel's 4 + 4 weights beside it (a few hundred
//     integer operations, cheaper than a second launch); then one thread per
//     input pixel and channel vector (up to 512 threads) sums over its 16
//     buckets' hits, two hits at a time.
//
// What bounds it: device-memory bytes (one read of g and the grid, one write
// of dx; 32 flops per (pixel, channel)); on this card the walk over the hits
// (PERF.md), and at 8²-16² the launch and the first bytes' latency.
//
// The sums are fp32, in a fixed order (for each input pixel: bucket rows
// ascending, then bucket, then pixel), and no float atomics are used: the
// result is exact for any grid and bitwise the same on every run. A grid
// that gathers every pixel onto one spot puts the whole map in one bucket,
// which is heap-sorted, and its tile walks the hits one buffer at a time (on
// a small map the block holds them all).
//
// C interface (ctypes): lcgan_warp_dx_small returns cudaGetLastError() after
// the launches, 0 on success.

#include <algorithm>
#include <climits>

#include "warp_dx_gather.cuh"
#include "warp_small.cuh"

namespace {

using namespace lcgan;

constexpr int kIndexThreads = 512;
constexpr int kMapThreads = 512;  // a whole-map block's threads at most: one per (pixel, vector)

// In-place exclusive prefix sum of a[0, n) in shared memory by the whole
// block (blockDim.x a multiple of 32, at most 1024): each thread scans a
// contiguous chunk.
__device__ void block_exclusive_scan(int* a, int n) {
  __shared__ int s_warp[32];
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

// Shared-memory ints of one image's index: each pixel's bucket and the
// list (npix each), the bucket starts (nkeys + 1) and counts (nkeys).
__host__ __device__ inline int index_ints(int H, int W) { return 2 * H * W + 2 * (H + 3) * (W + 3) + 1; }

// Builds the bucket index of one image in shared memory (s: index_ints(H, W)
// ints) by the whole block; returns s_start (s_start[k]: bucket k's first
// slot of s_list, s_start[nkeys]: the image's hits) and sets *list to s_list
// (the bucketed pixels, as pix_base + pixel, by bucket, ascending in each).
// With weights, also each pixel's 4 row and 4 column tap weights there
// ([H W][8] floats).
__device__ int* build_index(const float* __restrict__ grid_b, int H, int W, int pix_base, int* s, int** list,
                            float* weights = nullptr) {
  const int npix = H * W;
  const int nkeys = (H + 3) * (W + 3);  // buckets (by + 3, bx + 3)
  int* s_key = s;                       // [npix]: each pixel's bucket, or -1
  int* s_list = s_key + npix;           // [npix]
  int* s_start = s_list + npix;         // [nkeys + 1]: counts, then starts
  int* s_count = s_start + nkeys + 1;   // [nkeys]: counts, counted down by the placement
  for (int k = threadIdx.x; k <= nkeys; k += blockDim.x) s_start[k] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const float fx = unnormalize(grid_b[2 * p], W);
    const float fy = unnormalize(grid_b[2 * p + 1], H);
    const float x0 = floorf(fx), y0 = floorf(fy);
    if (weights) {
      float wy[4], wx[4];
      cubic_weights(fy - y0, wy);
      cubic_weights(fx - x0, wx);
      reinterpret_cast<float4*>(weights)[2 * p] = make_float4(wy[0], wy[1], wy[2], wy[3]);
      reinterpret_cast<float4*>(weights)[2 * p + 1] = make_float4(wx[0], wx[1], wx[2], wx[3]);
    }
    const int by = (int)y0 - 1, bx = (int)x0 - 1;
    int k = -1;
    if (by >= -3 && by < H && bx >= -3 && bx < W) {
      k = (by + 3) * (W + 3) + bx + 3;
      atomicAdd(&s_start[k], 1);
    }
    s_key[p] = k;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nkeys; k += blockDim.x) s_count[k] = s_start[k];
  block_exclusive_scan(s_start, nkeys + 1);  // its first barrier orders the copy before the scan's writes
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int k = s_key[p];
    if (k >= 0) s_list[s_start[k] + atomicSub(&s_count[k], 1) - 1] = pix_base + p;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nkeys; k += blockDim.x) sort_ascending(s_list + s_start[k], s_start[k + 1] - s_start[k]);
  __syncthreads();
  *list = s_list;
  return s_start;
}

// One block per image: its index into key_start[b (nkeys + 1) + k] (slots of
// `list`, whose image b part starts at b H W) and list.
__global__ void __launch_bounds__(kIndexThreads)
warp_dxsm_index_kernel(const float* __restrict__ grid, int* __restrict__ key_start, int* __restrict__ list, int H,
                       int W) {
  extern __shared__ __align__(16) int s_index[];
  const int b = blockIdx.x;
  const int npix = H * W, nkeys = (H + 3) * (W + 3);
  int* s_list;
  const int* s_start = build_index(grid + 2LL * b * npix, H, W, b * npix, s_index, &s_list);
  for (int k = threadIdx.x; k <= nkeys; k += blockDim.x) key_start[b * (nkeys + 1) + k] = b * npix + s_start[k];
  for (int e = threadIdx.x; e < s_start[nkeys]; e += blockDim.x) list[b * npix + e] = s_list[e];
}

// One block per (batch, th x tw tile of input pixels, chunk of cv vectors):
// dx_gather_tile over the image's index in the scratch buffer.
template <typename T, int VEC>
__global__ void __launch_bounds__(kGatherThreads)
warp_dx_small_kernel(const float* __restrict__ grid, const T* __restrict__ g, const int* __restrict__ key_start,
                     const int* __restrict__ list, T* __restrict__ dx, int C, int H, int W, int th, int tw,
                     int tiles_x, int ntiles, int cv, int nchunks, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  int bid = blockIdx.x;
  const int chunk = bid % nchunks;
  bid /= nchunks;
  const int tile = bid % ntiles;
  const int b = bid / ntiles;
  const int ty = tile / tiles_x;
  dx_gather_tile<T, VEC>(grid, g, key_start + b * ((H + 3) * (W + 3) + 1), list, dx, smem, b, C, H, W, ty * th,
                         (tile - ty * tiles_x) * tw, th, tw, chunk, cv, nbuf);
}

// Bytes of a map block's copy of g: npix pixels of cw channels, rounded up
// to 16.
__host__ __device__ inline size_t map_g_bytes(int npix, int cw, size_t elem) {
  return ((size_t)npix * cw * elem + 15) & ~(size_t)15;
}

// One block per (batch, group of cg channels; the group fastest), on maps of
// at most 256 pixels: the group's map of g copied into shared memory while
// the block builds the image's index and each pixel's weights; then one
// thread per (input pixel, channel vector) sums over the 16 buckets whose
// pixels can tap it: the four buckets (by, v - 3 .. v) of one bucket row are
// adjacent in the list, so it walks four runs, bucket rows ascending, then
// bucket, then pixel, two hits at a time, and writes its dx vector once.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMapThreads)
warp_dxsm_map_kernel(const float* __restrict__ grid, const T* __restrict__ g, T* __restrict__ dx, int C, int H,
                     int W, int cg, int ngroups) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = (blockIdx.x % ngroups) * cg;
  const int b = blockIdx.x / ngroups;
  const int cw = min(cg, C - c0);
  const int npix = H * W;
  T* s_g = reinterpret_cast<T*>(smem);  // [npix][cw]
  float* s_wt = reinterpret_cast<float*>(smem + map_g_bytes(npix, cw, sizeof(T)));  // [npix][8]: row, column weights
  int* s_index = reinterpret_cast<int*>(s_wt + 8 * npix);

  stage_group<T, VEC>(g + (long long)b * npix * C + c0, s_g, npix, C, cw);
  int* s_list;  // pixels of image b, 0 .. H W - 1
  const int* s_start = build_index(grid + 2LL * b * npix, H, W, 0, s_index, &s_list, s_wt);
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
    for (int dy = 3; dy >= 0; --dy) {  // bucket rows u - dy, ascending
      const int* bs = s_start + (u - dy + 3) * (W + 3) + v;  // buckets (u - dy, v - 3 .. v), and the next's start
      const int b1 = bs[1], b2 = bs[2], b3 = bs[3], hi = bs[4];
      int e = bs[0];
      // a hit of bucket v - 3 + q taps v with its column weight 3 - q
      for (; e + 1 < hi; e += 2) {
        const int p0 = s_list[e], p1 = s_list[e + 1];
        const int q0 = (e >= b1) + (e >= b2) + (e >= b3);
        const int q1 = (e + 1 >= b1) + (e + 1 >= b2) + (e + 1 >= b3);
        const float w0 = s_wt[8 * p0 + dy] * s_wt[8 * p0 + 7 - q0];
        const float w1 = s_wt[8 * p1 + dy] * s_wt[8 * p1 + 7 - q1];
        float g0[VEC], g1[VEC];
        Vec<T, VEC>::load(s_g + p0 * cw + c, g0);
        Vec<T, VEC>::load(s_g + p1 * cw + c, g1);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += g0[k] * w0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += g1[k] * w1;
      }
      if (e < hi) {
        const int p0 = s_list[e];
        const int q0 = (e >= b1) + (e >= b2) + (e >= b3);
        const float w0 = s_wt[8 * p0 + dy] * s_wt[8 * p0 + 7 - q0];
        float g0[VEC];
        Vec<T, VEC>::load(s_g + p0 * cw + c, g0);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += g0[k] * w0;
      }
    }
    Vec<T, VEC>::store(db + (long long)pix * C + c, acc);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int VEC>
int launch(const void* grid_, const void* g, int* scratch, void* dx, int B, int C, int H, int W, int th, int tw,
           int cv, int nbuf, int local, cudaStream_t stream) {
  const int nvec = C / VEC;
  if (C % VEC || nvec < 1 || H < 1 || W < 1 || H > 64 || W > 64 || cv < 1 ||
      (!local && (th < 1 || tw < 1 || th > kMaxTile || tw > kMaxTile || nbuf < 4 || nbuf % 4 || !scratch)))
    return (int)cudaErrorInvalidValue;
  const int nchunks = cdiv(nvec, cv);
  const float* grid = static_cast<const float*>(grid_);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const size_t index_bytes = (size_t)index_ints(H, W) * sizeof(int);
  if (local) {  // one launch: a block per (image, group of cv vectors)
    if ((long long)B * nchunks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    const int cg = cv * VEC;
    const size_t smem = map_g_bytes(H * W, cg, sizeof(T)) + (size_t)H * W * 8 * sizeof(float) + index_bytes;
    const int threads = std::min(kMapThreads, (H * W * cv + 31) / 32 * 32);  // one (pixel, vector) each
    int err = allow_smem(warp_dxsm_map_kernel<T, VEC>, smem);
    if (err) return err;
    warp_dxsm_map_kernel<T, VEC><<<B * nchunks, threads, smem, stream>>>(grid, gt, dxt, C, H, W, cg, nchunks);
    return (int)cudaGetLastError();
  }
  const int tiles_x = cdiv(W, tw), ntiles = tiles_x * cdiv(H, th);
  if ((long long)B * ntiles * nchunks > INT_MAX || (long long)B * ((H + 3) * (W + 3) + 1 + H * W) > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  const size_t hit_bytes = (size_t)nbuf * (9 * sizeof(float) + cv * VEC * sizeof(T));
  // scratch: the key starts (B (nkeys + 1)), then the list (B H W)
  int* key_start = scratch;
  int* list = key_start + B * ((H + 3) * (W + 3) + 1);
  int err = allow_smem(warp_dxsm_index_kernel, index_bytes);
  if (err) return err;
  warp_dxsm_index_kernel<<<B, kIndexThreads, index_bytes, stream>>>(grid, key_start, list, H, W);
  err = allow_smem(warp_dx_small_kernel<T, VEC>, hit_bytes);
  if (err) return err;
  warp_dx_small_kernel<T, VEC><<<B * ntiles * nchunks, kGatherThreads, hit_bytes, stream>>>(
      grid, gt, key_start, list, dxt, C, H, W, th, tw, tiles_x, ntiles, cv, nchunks, nbuf);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. grid: (B, H, W, 2) fp32 contiguous; g:
// (B, H, W, C) NHWC contiguous, H and W at most 64; scratch: int32, B ((H+3)
// (W+3) + 1 + H W) of them unless local (then unused); dx: (B, H, W, C) NHWC
// contiguous in g's dtype. vec: 1 for 16-byte vectors, else scalar loads.
// cv: vectors (VEC channels, or one on the scalar path) of a block's chunk;
// local: 1 for the one-launch design of maps of at most 256 pixels (a block
// per image and chunk), 0 for the index and the gather, with th x tw the
// input tile of a gather block (at most 16 x 16) and nbuf the hits of its
// buffer, a multiple of 4 (lcgan_torch/ops/warp.py _dx_small_geometry).
extern "C" int lcgan_warp_dx_small(const void* grid, const void* g, void* scratch, void* dx, int dtype, int vec,
                                   int B, int C, int H, int W, int th, int tw, int cv, int nbuf, int local,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ws = static_cast<int*>(scratch);
  if (dtype == 0) {
    return vec ? launch<float, 4>(grid, g, ws, dx, B, C, H, W, th, tw, cv, nbuf, local, s)
               : launch<float, 1>(grid, g, ws, dx, B, C, H, W, th, tw, cv, nbuf, local, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(grid, g, ws, dx, B, C, H, W, th, tw, cv, nbuf, local, s)
               : launch<__nv_bfloat16, 1>(grid, g, ws, dx, B, C, H, W, th, tw, cv, nbuf, local, s);
  }
  return (int)cudaErrorInvalidValue;
}
