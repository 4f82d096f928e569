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
// collects the output pixels that reach it. The TPU kernel sweeps a band of
// 2M+1 output rows with matmuls, M the static tanh bound; here the window is
// measured from the grid itself, so the result is exact for any grid:
//
//   1. warp_dx_rows_kernel, one warp per (batch, output row r): over the
//      row's pixels whose taps touch the map, the least and the largest first
//      tap row (floor(fy) - 1) and the largest left and right reach of the
//      first tap column against the pixel's own column, into a scratch int4
//      per row (no host sync). Maps of at most 1024 pixels skip it;
//   2. warp_dx_kernel, one block per (batch, TH x TW tile of input pixels,
//      group of channel chunks):
//      * the candidates: every output row whose tap rows can meet the tile,
//        each with the columns its own reach allows. One stray pixel widens
//        only the windows of the tiles its own row can reach. On a map of at
//        most 1024 pixels, every pixel of the image: at most four rounds of
//        the block's threads, cheaper there than a second launch and its wait;
//      * the hits: the block evaluates the candidates 256 at a time (the same
//        rounded coordinate math as the forward) and compacts those whose taps
//        meet the tile into shared memory, in candidate order (warp ballots,
//        then a prefix over the 8 warps), with their row and column weights;
//      * the index: hits bucketed by their first tap (row, column) relative
//        to the tile, (TH+3) x (TW+3) buckets, 256 hits at a time: per-warp
//        counts (match_any, then a rank within the warp), one block scan, then
//        placement by rank. No atomics and no sort, and hits keep their
//        candidate order inside a bucket;
//      * the gather: a thread takes one (input pixel, 16-byte channel vector)
//        item at a time, the lanes of a warp the vectors of one pixel (of a
//        few where a chunk is narrower than 32 vectors), and walks only the 16
//        buckets whose hits tap its pixel (four runs of four adjacent
//        buckets), in step with its warp, adding weight * g of each hit's
//        output pixel in fp32 registers; then it writes its dx vector once.
//      The index is built once per tile and serves every item of the block,
//      unless the tile's hits overflow the hit buffer (a grid that gathers
//      many pixels onto one spot); then each round of 256 items walks the
//      candidates again, one buffer at a time.
// The order of every sum is fixed by the shapes and the grid: the result is
// bitwise the same on every run. No float atomics.
//
// What bounds it: the candidate scan and the gather's re-reads of g (each
// output pixel is read by the 16 input pixels it taps). Its byte bound (one
// read of g and the grid, one write of dx) is far below either. A 2D tile
// scans its window once for TH x TW pixels, and a thread walks only the hits
// of its own pixel.
//
// The launch picks the tile (16 columns by 8 rows; narrower maps take taller
// tiles of at most 128 pixels and 16 rows), the channel vectors per chunk (up
// to 32, so that a warp's lanes walk one pixel's hits together, each load a
// contiguous run of g) and the chunks per block: a block builds its tile's
// hit index once for its chunks. Where the grid of blocks would be short of
// about two per SM, the chunks per block are halved, then the tile, as long
// as a block keeps a round of 256 items.
//
// C interface (ctypes): lcgan_warp_dx returns cudaGetLastError() after the
// launches, 0 on success.

#include <algorithm>

#include "warp_common.cuh"

namespace {

using namespace lcgan;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// hits a buffer holds: at 512 (22.5 KB) the SM keeps room in L1 for the
// gather's re-reads of g; measured faster than 1024 at every path shape
constexpr int kHits = 512;
constexpr int kSub = kHits / kThreads;  // index passes per buffer
constexpr int kUnroll = 4;  // hits of a bucket run in flight
// registers capped at 64 for four blocks an SM: the gather hides its loads'
// latency with warps; measured faster than 1-3 blocks at every path shape
// from 64² up (PERF.md §6)
constexpr int kMinBlocksPerSM = 4;
constexpr int kMinBlocks = 264;  // about two blocks per SM of an H100
constexpr int kTileW = 16, kTileH = 8, kTileMaxH = 16;
constexpr int kEveryPixels = 1024;  // maps whose every pixel is a candidate (no row pass)
constexpr int kIntMax = 0x7fffffff;

// Per (batch, output row): x = least first tap row, y = largest first tap row,
// z = largest q - (first tap column), w = largest (first tap column) - q, over
// the row's pixels with a tap on the map; a row with none gets an empty range.
__global__ void __launch_bounds__(kThreads)
warp_dx_rows_kernel(const float* __restrict__ grid, int4* __restrict__ rows, int H, int W, int nrows) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= nrows) return;
  const float* gr = grid + 2LL * row * W;
  int ylo = kIntMax, yhi = -kIntMax, left = -kIntMax, right = -kIntMax;
  for (int q = lane; q < W; q += 32) {
    const int ix = (int)floorf(unnormalize(gr[2 * q], W)) - 1;
    const int iy = (int)floorf(unnormalize(gr[2 * q + 1], H)) - 1;
    if (iy + 3 >= 0 && iy < H && ix + 3 >= 0 && ix < W) {
      ylo = min(ylo, iy);
      yhi = max(yhi, iy);
      left = max(left, q - ix);
      right = max(right, ix - q);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ylo = min(ylo, __shfl_xor_sync(0xffffffffu, ylo, off));
    yhi = max(yhi, __shfl_xor_sync(0xffffffffu, yhi, off));
    left = max(left, __shfl_xor_sync(0xffffffffu, left, off));
    right = max(right, __shfl_xor_sync(0xffffffffu, right, off));
  }
  if (lane == 0) rows[row] = make_int4(ylo, yhi, left, right);
}

// In-place exclusive prefix sum of a[0, n) in shared memory by the whole
// block; returns the total to every thread.
__device__ int block_exclusive_scan(int* a, int n) {
  __shared__ int s_warp[kWarps];
  const int per = (n + kThreads - 1) / kThreads;
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
  int run = incl - sum, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    run += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
warp_dx_kernel(const float* __restrict__ grid, const T* __restrict__ g, const int4* __restrict__ rows,
               T* __restrict__ dx, int C, int H, int W, int th, int tw, int tiles_x, int ntiles, int cv,
               int cpb, int ncg) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bw = tw + 3;            // buckets per bucket row
  const int nb = (th + 3) * bw;     // buckets: first tap (u0 - 3 .. u0 + th - 1, v0 - 3 .. v0 + tw - 1)
  float* s_hw = reinterpret_cast<float*>(smem);  // [kHits][8]: a hit's row weights, then column weights
  int* s_hpix = reinterpret_cast<int*>(s_hw + 8 * kHits);  // its output pixel r * W + q
  int* s_hk = s_hpix + kHits;                              // its bucket
  int* s_order = s_hk + kHits;      // [kHits]: hit slot | bucket column << 16, by bucket within each pass
  int* s_bstart = s_order + kHits;  // [kSub][nb + 1]: each bucket's first entry of s_order
  int* s_scan = s_bstart + kSub * (nb + 1);  // [nb * kWarps + 1]: per (bucket, warp) counts, then offsets
  int* s_roff = s_scan + nb * kWarps + 1;    // [H]: each row's first candidate
  int* s_rqlo = s_roff + H;                  // [H]: each row's first candidate column
  __shared__ int s_count[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long bid = blockIdx.x;
  const int cg = (int)(bid % ncg);
  bid /= ncg;
  const int tile = (int)(bid % ntiles);
  const int b = (int)(bid / ntiles);
  const int ty = tile / tiles_x;
  const int u0 = ty * th, v0 = (tile - ty * tiles_x) * tw;
  const int th_in = min(th, H - u0), tw_in = min(tw, W - v0);  // the tile's pixels on the map

  const long long batch_pix = (long long)b * H * W;
  const float* gridb = grid + 2 * batch_pix;
  const T* gb = g + batch_pix * C;

  // 1. the candidates: rows whose tap rows can meet the tile, and their
  // columns; on a small map (no row windows), every pixel
  const bool every = rows == nullptr;
  int ncand = H * W;
  if (!every) {
    const int4* rb = rows + (long long)b * H;
    for (int r = tid; r < H; r += kThreads) {
      const int4 s = rb[r];
      int n = 0, qlo = 0;
      if (s.y + 3 >= u0 && s.x <= u0 + th_in - 1) {
        qlo = max(0, v0 - 3 - s.w);
        n = max(0, min(W - 1, v0 + tw_in - 1 + s.z) - qlo + 1);
      }
      s_roff[r] = n;
      s_rqlo[r] = qlo;
    }
    __syncthreads();
    ncand = block_exclusive_scan(s_roff, H);
  }

  // fills the hit buffer from candidate `start` on; returns the next candidate
  int nh = 0;
  auto fill = [&](int start) {
    __syncthreads();  // the buffer's last readers are done
    nh = 0;
    while (start < ncand && nh + kThreads <= kHits) {
      const int c = start + tid;
      bool hit = false;
      int pix = 0, k = 0;
      float wy[4], wx[4];
      if (c < ncand) {
        pix = c;
        if (!every) {
          int lo = 0, hi = H - 1;  // the last row whose first candidate is <= c
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_roff[mid] <= c) lo = mid; else hi = mid - 1;
          }
          pix = lo * W + s_rqlo[lo] + (c - s_roff[lo]);
        }
        const float fx = unnormalize(gridb[2 * pix], W);
        const float fy = unnormalize(gridb[2 * pix + 1], H);
        const float x0 = floorf(fx), y0 = floorf(fy);
        const int iy = (int)y0 - 1, ix = (int)x0 - 1;
        hit = iy <= u0 + th_in - 1 && iy + 3 >= u0 && ix <= v0 + tw_in - 1 && ix + 3 >= v0;
        if (hit) {
          k = (iy - u0 + 3) * bw + (ix - v0 + 3);
          cubic_weights(fy - y0, wy);
          cubic_weights(fx - x0, wx);
        }
      }
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_count[warp] = __popc(mask);
      __syncthreads();
      int base = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int n = s_count[w];
        base += w < warp ? n : 0;
        total += n;
      }
      if (hit) {
        const int slot = nh + base + __popc(mask & ((1u << lane) - 1u));
        s_hpix[slot] = pix;
        s_hk[slot] = k;
        reinterpret_cast<float4*>(s_hw)[2 * slot] = make_float4(wy[0], wy[1], wy[2], wy[3]);
        reinterpret_cast<float4*>(s_hw)[2 * slot + 1] = make_float4(wx[0], wx[1], wx[2], wx[3]);
      }
      nh += total;
      start += kThreads;
      __syncthreads();  // s_count is rewritten by the next round
    }
    // the index: per pass of 256 hits, counts per (bucket, warp), their scan,
    // and placement by rank within the warp
    for (int s = 0; s * kThreads < nh; ++s) {
      for (int i = tid; i <= nb * kWarps; i += kThreads) s_scan[i] = 0;
      __syncthreads();
      const int slot = s * kThreads + tid;
      const int k = slot < nh ? s_hk[slot] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, k);
      const int rank = __popc(same & ((1u << lane) - 1u));
      if (k >= 0 && rank == 0) s_scan[k * kWarps + warp] = __popc(same);
      __syncthreads();
      block_exclusive_scan(s_scan, nb * kWarps + 1);
      if (k >= 0) s_order[s * kThreads + s_scan[k * kWarps + warp] + rank] = slot | ((k % bw) << 16);
      for (int i = tid; i <= nb; i += kThreads) s_bstart[s * (nb + 1) + i] = s * kThreads + s_scan[i * kWarps];
      __syncthreads();
    }
    return start;
  };

  // 2. the gather, chunk by chunk of cv channel vectors, one item a thread
  // at a time; cv = 32 gives each warp one pixel, whose hits its lanes walk
  // in step, each loading 16 bytes of the hit's row of g
  const int nvec = C / VEC;
  const int nchunks = (nvec + cv - 1) / cv;
  const int ch0 = cg * cpb, ch1 = min(nchunks, ch0 + cpb);
  int next = fill(0);
  const bool single = next >= ncand;  // every hit of the tile in one buffer
  bool fresh = true;                  // the buffer holds the tile's first hits
  for (int ch = ch0; ch < ch1; ++ch) {
    const int cw = min(cv, nvec - ch * cv);  // vectors in this chunk
    const int nitems = th * tw * cw;
    for (int i0 = 0; i0 < nitems; i0 += kThreads) {
      if (!fresh) next = fill(0);  // only where the hits overflow one buffer
      fresh = single;
      const int item = i0 + tid;
      const int p = item / cw;
      const int tu = p / tw, tv = p - (p / tw) * tw;  // the pixel in the tile
      const bool mine = item < nitems && tu < th_in && tv < tw_in;
      const int c = (ch * cv + item - p * cw) * VEC;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      while (true) {
        const int npass = mine ? (nh + kThreads - 1) / kThreads : 0;
        for (int s = 0; s < npass; ++s) {
          const int* bs = s_bstart + s * (nb + 1);
#pragma unroll
          for (int j = 3; j >= 0; --j) {  // first tap row u - j, ascending
            const int k0 = (tu + 3 - j) * bw + tv;  // buckets (u - j, v - 3 .. v)
            const int end = bs[k0 + 4];
#pragma unroll kUnroll
            for (int e = bs[k0]; e < end; ++e) {
              const int o = s_order[e];
              const int h = o & 0xffff;
              const int i = tv + 3 - (o >> 16);  // the tap's column in the hit's 4x4 window
              const float w = s_hw[8 * h + j] * s_hw[8 * h + 4 + i];
              float gv[VEC];
              Vec<T, VEC>::load(gb + (long long)s_hpix[h] * C + c, gv);
#pragma unroll
              for (int e2 = 0; e2 < VEC; ++e2) acc[e2] = fmaf(gv[e2], w, acc[e2]);
            }
          }
        }
        if (next >= ncand) break;
        next = fill(next);
      }
      if (mine) Vec<T, VEC>::store(dx + (batch_pix + (long long)(u0 + tu) * W + v0 + tv) * C + c, acc);
    }
  }
}

// Dynamic shared memory of a warp_dx_kernel block: the hit buffer (weights,
// pixel, bucket, order), the bucket starts of its passes, the per-(bucket,
// warp) counts, and each candidate row's offset and first column.
size_t dx_smem(int H, int th, int tw) {
  const size_t nb = (size_t)(th + 3) * (tw + 3);
  return kHits * (8 * sizeof(float) + 3 * sizeof(int)) + (kSub * (nb + 1) + nb * kWarps + 1 + 2 * (size_t)H) * sizeof(int);
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename T, int VEC>
int launch(const void* grid, const void* g, void* rows, void* dx, int B, int C, int H, int W, cudaStream_t stream) {
  const int nvec = C / VEC;
  if (nvec < 1) return (int)cudaErrorInvalidValue;
  const long long nrows = (long long)B * H;
  if (nrows > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool every = (long long)H * W <= kEveryPixels;
  if (!every) {
    warp_dx_rows_kernel<<<(unsigned)((nrows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
        static_cast<const float*>(grid), static_cast<int4*>(rows), H, W, (int)nrows);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }

  int tw = W < kTileW ? W : kTileW;
  int th = std::min(H, std::min(kTileMaxH, kTileW * kTileH / tw));
  const int cv = std::min(nvec, 32);
  long long cpb = cdiv(nvec, cv);
  auto count = [&] { return B * cdiv(W, tw) * cdiv(H, th) * cdiv(cdiv(nvec, cv), cpb); };
  while (count() < kMinBlocks) {
    if (cpb > 1) {
      cpb = cdiv(cpb, 2);
    } else if (th * tw * cv > kThreads && th * tw > 1) {  // smaller tiles, while a block keeps a round of items
      if (th >= tw) th = (th + 1) / 2; else tw = (tw + 1) / 2;
    } else {
      break;
    }
  }
  const int tiles_x = (W + tw - 1) / tw;
  const long long ntiles = (long long)tiles_x * cdiv(H, th);
  const long long ncg = cdiv(cdiv(nvec, cv), cpb);
  const long long blocks = B * ntiles * ncg;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = dx_smem(H, th, tw);  // too much for a block: the attribute call fails
  int err = (int)cudaFuncSetAttribute(warp_dx_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  warp_dx_kernel<T, VEC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(grid), static_cast<const T*>(g), every ? nullptr : static_cast<const int4*>(rows),
      static_cast<T*>(dx), C, H, W, th, tw, tiles_x, (int)ntiles, cv, (int)cpb, (int)ncg);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. grid: (B, H, W, 2) fp32 contiguous; g:
// (B, H, W, C) NHWC contiguous; rows: B * H int4 of scratch; dx: (B, H, W, C)
// NHWC contiguous in g's dtype. vec: 1 to force scalar loads (C not a
// multiple of the vector width, or pointers not 16-byte aligned), else
// 16-byte vectors.
extern "C" int lcgan_warp_dx(const void* grid, const void* g, void* rows, void* dx, int dtype, int vec, int B,
                             int C, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(grid, g, rows, dx, B, C, H, W, s)
               : launch<float, 1>(grid, g, rows, dx, B, C, H, W, s);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(grid, g, rows, dx, B, C, H, W, s)
               : launch<__nv_bfloat16, 1>(grid, g, rows, dx, B, C, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}
