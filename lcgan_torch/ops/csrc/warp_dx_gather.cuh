// The tiled gather of the feature gradient, shared by warp_dx_scatter.cu
// (narrow maps, C < 128) and warp_dx_small.cu (maps of at most 64²): one
// block sums dx over one tile of input pixels and one chunk of channels,
// from a bucket index of the output pixels (CSR: each bucket's range of a
// list of pixels, bucket rows ascending, then bucket, then pixel).
//
// A bucket is an output pixel's base tap (floor(fy) - 1, floor(fx) - 1),
// rounded as the forward rounds it (warp_common.cuh); bucket (by, bx) of an
// image is key (by + 3) * (W + 3) + bx + 3, and key (H + 3) * (W + 3) ends
// the image's last bucket (every base with a tap on the map lies in
// [-3, size - 1]).

#pragma once

#include "warp_common.cuh"

namespace lcgan {

constexpr int kGatherThreads = 256;  // threads of a gather block
constexpr int kMaxTile = 16;         // input rows and columns of a gather tile at most

// One block's share of dx: batch element b, the th x tw tile of input pixels
// at (u0, v0) and channel chunk `chunk` (cv vectors of VEC channels):
//   1. the block reads the CSR starts of its (TH + 3) x (TW + 4) buckets
//      (the first taps that can reach the tile, and each bucket row's end):
//      each bucket row's hits are one contiguous range of the list, and the
//      block numbers them row after row, its hit list L;
//   2. it copies L into shared memory, a buffer of nbuf hits at a time: each
//      hit's four row and four column tap weights, computed once from the
//      grid, and its row of g for the chunk, copied with cp.async, 16 bytes a
//      thread, coalesced;
//   3. a thread takes one (input pixel, channel vector) item at a time, the
//      lanes of a warp the chunk's vectors of a few neighbouring pixels, and
//      walks the four runs of four adjacent buckets whose hits tap its pixel,
//      in L's order, out of shared memory only, adding weight * g in fp32
//      registers (a hit's bucket gives its tap column); then it writes its
//      dx vector once.
// L keeps the index list's order (bucket rows ascending, then bucket, then
// pixel), so each dx element is the same fp32 sum in the same order, whether
// the tile's hits fit one buffer or take several: where they overflow it (a
// grid that gathers many pixels onto one spot), each round of items walks L
// one buffer at a time, and the sums carry over in registers.
//
// key_start: image b's bucket starts (key_start[k], k <= (H + 3)(W + 3), in
// global or shared memory), positions in `list`; list: the output pixels, as
// indices into grid and g (pixel p's coordinates at grid[2 p], grid[2 p + 1],
// its channels at g[p C]; grid may be a copy in shared memory). smem: the hit
// buffer, nbuf (a multiple of 4) hits of 8 floats, an int and cv VEC-vectors
// of T. Called by all kGatherThreads threads of the block.
template <typename T, int VEC>
__device__ __forceinline__ void dx_gather_tile(const float* __restrict__ grid, const T* __restrict__ g,
                                               const int* __restrict__ key_start, const int* __restrict__ list,
                                               T* __restrict__ dx,
                                               unsigned char* smem, int b, int C, int H, int W, int u0, int v0,
                                               int th, int tw, int chunk, int cv, int nbuf) {
  float* s_w = reinterpret_cast<float*>(smem);          // [nbuf][8]: a hit's row, then column weights
  int* s_pix = reinterpret_cast<int*>(s_w + 8 * nbuf);  // [nbuf]: its output pixel
  T* s_g = reinterpret_cast<T*>(s_pix + nbuf);          // [nbuf][cv * VEC]: its row of g (nbuf a multiple of 4)
  __shared__ int s_start[kMaxTile + 3][kMaxTile + 4];   // each bucket's first hit in L
  __shared__ int s_row0[kMaxTile + 3];                  // each bucket row's first list entry
  __shared__ int s_rowbase[kMaxTile + 4];               // each bucket row's first hit in L

  const int tid = threadIdx.x;
  const int th_in = min(th, H - u0), tw_in = min(tw, W - v0);  // the tile's pixels on the map
  const int nbr = th_in + 3, nbc = tw_in + 4;  // bucket rows; bucket starts per row (and its end)

  // 1. the bucket starts; the end of a row's last bucket is the next key's start
  for (int i = tid; i < nbr * nbc; i += kGatherThreads) {
    const int r = i / nbc, col = i - r * nbc;
    s_start[r][col] = key_start[(u0 + r) * (W + 3) + v0 + col];  // bucket (u0 - 3 + r, v0 - 3 + col)
  }
  __syncthreads();
  if (tid < 32) {  // each bucket row's hits, and their prefix over the rows (nbr <= 19)
    const int n = tid < nbr ? s_start[tid][nbc - 1] - s_start[tid][0] : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (tid >= d) incl += t;
    }
    if (tid < nbr) {
      s_rowbase[tid] = incl - n;
      s_row0[tid] = s_start[tid][0];
    }
    if (tid == 31) s_rowbase[nbr] = incl;
  }
  __syncthreads();
  for (int i = tid; i < nbr * nbc; i += kGatherThreads) {
    const int r = i / nbc, col = i - r * nbc;
    s_start[r][col] += s_rowbase[r] - s_row0[r];
  }
  const int total = s_rowbase[nbr];  // hits of the tile
  __syncthreads();

  const int nvec = C / VEC;
  const int cw = min(cv, nvec - chunk * cv);  // vectors in this chunk
  const int c0 = chunk * cv * VEC;

  // 2. L[s, s + nbuf) into the buffer
  auto fill = [&](int s) {
    __syncthreads();  // the buffer's last readers are done
    const int n = min(nbuf, total - s);
    for (int i = tid; i < n; i += kGatherThreads) {
      const int e = s + i;
      int r = 0;
      while (s_rowbase[r + 1] <= e) ++r;
      const long long p = list[s_row0[r] + e - s_rowbase[r]];
      const float fx = unnormalize(grid[2 * p], W);
      const float fy = unnormalize(grid[2 * p + 1], H);
      const float y0 = floorf(fy), x0 = floorf(fx);
      float wy[4], wx[4];
      cubic_weights(fy - y0, wy);
      cubic_weights(fx - x0, wx);
      reinterpret_cast<float4*>(s_w)[2 * i] = make_float4(wy[0], wy[1], wy[2], wy[3]);
      reinterpret_cast<float4*>(s_w)[2 * i + 1] = make_float4(wx[0], wx[1], wx[2], wx[3]);
      s_pix[i] = (int)p;
    }
    __syncthreads();
    for (int i = tid; i < n * cw; i += kGatherThreads) {
      const int h = i / cw, v = i - h * cw;
      copy_to_shared<T, VEC>(s_g + (long long)(h * cv + v) * VEC, g + (long long)s_pix[h] * C + c0 + v * VEC);
    }
    cp_async_wait_all();
    __syncthreads();
  };

  // 3. the gather
  const bool single = total <= nbuf;
  if (single) fill(0);
  const int nitems = th * tw * cw;
  for (int i0 = 0; i0 < nitems; i0 += kGatherThreads) {
    const int item = i0 + tid;
    const int p = item / cw, v = item - p * cw;
    const int tu = p / tw, tv = p - (p / tw) * tw;  // the pixel in the tile
    const bool mine = item < nitems && tu < th_in && tv < tw_in;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    for (int s = 0; s < total; s += nbuf) {
      if (!single) fill(s);
      if (!mine) continue;
      const int end = min(total, s + nbuf);
#pragma unroll
      for (int dy = 3; dy >= 0; --dy) {  // bucket rows u - dy, ascending
        const int* bs = s_start[tu + 3 - dy] + tv;  // buckets (u - dy, v - 3 .. v)
        const int b1 = bs[1], b2 = bs[2], b3 = bs[3], hi = min(bs[4], end);
        int e = max(bs[0], s);
        const float* wp = s_w + 8 * (e - s);
        const T* gp = s_g + ((long long)(e - s) * cv + v) * VEC;
        // two hits at a time, in order; a hit of bucket v - 3 + q taps v with
        // its column weight 3 - q
        for (; e + 1 < hi; e += 2, wp += 16, gp += 2 * cv * VEC) {
          const int q0 = (e >= b1) + (e >= b2) + (e >= b3);
          const int q1 = (e + 1 >= b1) + (e + 1 >= b2) + (e + 1 >= b3);
          const float w0 = wp[dy] * wp[7 - q0], w1 = wp[8 + dy] * wp[15 - q1];
          float g0[VEC], g1[VEC];
          Vec<T, VEC>::load(gp, g0);
          Vec<T, VEC>::load(gp + cv * VEC, g1);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += g0[k] * w0;
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += g1[k] * w1;
        }
        if (e < hi) {
          const int q = (e >= b1) + (e >= b2) + (e >= b3);
          const float w = wp[dy] * wp[7 - q];
          float gv[VEC];
          Vec<T, VEC>::load(gp, gv);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += gv[k] * w;
        }
      }
    }
    if (mine) Vec<T, VEC>::store(dx + (((long long)b * H + u0 + tu) * W + v0 + tv) * C + c0 + v * VEC, acc);
  }
}

}  // namespace lcgan
