// Shared pieces of the small-map warp kernels (maps of at most 64²):
//
//   * warp_dx_small.cu on maps of at most 256 pixels: each block holds one
//     channel group of one batch element's whole map in dynamic shared
//     memory (stage_group; the host picks the group's width,
//     lcgan_torch/ops/warp.py _dx_small_geometry; group g takes channels
//     [g·cg, min(C, (g+1)·cg))).
//   * warp_fwd_small.cu and warp_dgrid_small.cu: each block takes a tile of
//     output pixels and a chunk of channel vectors of one image (TileBlock)
//     and computes each pixel's taps and weights once; a warp takes a
//     pixel, its lanes across the chunk's 16-byte vectors, and reads the
//     taps from device memory (L2). The host picks the tile and the chunk
//     (lcgan_torch/ops/warp.py _small_tile_geometry).

#pragma once

#include "warp_common.cuh"

namespace lcgan {

// Dynamic shared memory a small-map block may take: 224 KB of the 227 KB a
// Hopper block can have, leaving room for the kernels' static arrays.
// _SMALL_SMEM in lcgan_torch/ops/warp.py.
constexpr int kMaxSmem = 229376;

// Raises the kernel's dynamic shared-memory limit where it needs more than
// the default 48 KB; returns the cudaError.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Copies cw channels of npix NHWC pixels (src: the group's first channel of
// pixel 0, pixels C elements apart) into dst[npix][cw]. With 16-byte vectors
// (VEC > 1) the copies are cp.async and still in flight on return: call
// stage_wait, then __syncthreads, before reading dst.
template <typename T, int VEC>
__device__ __forceinline__ void stage_group(const T* __restrict__ src, T* dst, int npix, int C, int cw) {
  if constexpr (VEC > 1) {
    const int nv = cw / VEC;
    for (int i = threadIdx.x; i < npix * nv; i += blockDim.x) {
      const int p = i / nv;
      const int v = i - p * nv;
      const T* s = src + (long long)p * C + v * VEC;
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + p * cw + v * VEC);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(s) : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < npix * cw; i += blockDim.x) {
      const int p = i / cw;
      dst[i] = src[(long long)p * C + (i - p * cw)];
    }
  }
}

template <int VEC>
__device__ __forceinline__ void stage_wait() {
  if constexpr (VEC > 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Tiles of output pixels (warp_fwd_small.cu, warp_dgrid_small.cu)
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256;  // threads of a tile block: 8 warps, a warp per pixel
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kMaxTilePx = 64;  // output pixels of a tile at most: _SMALL_TILE_PX in warp.py

// The block's tile and chunk. blockIdx.x = (image · ntiles + tile) · nchunks
// + chunk; tiles are th x tw output pixels, row-major over the map, clipped
// at its edges; a chunk is cv vectors (the last one cw <= cv).
struct TileBlock {
  int b;       // image
  int r0, q0;  // first output row and column
  int th, tw;  // rows and columns of the tile (clipped)
  int v0, cw;  // first vector of the chunk, and its vectors
};

__device__ __forceinline__ TileBlock tile_block(int Hg, int Wg, int th, int tw, int tiles_x, int ntiles, int cv,
                                                int nchunks, int nvec) {
  int bid = blockIdx.x;
  TileBlock t;
  const int chunk = bid % nchunks;
  bid /= nchunks;
  const int tile = bid % ntiles;
  t.b = bid / ntiles;
  const int ty = tile / tiles_x;
  t.r0 = ty * th;
  t.q0 = (tile - ty * tiles_x) * tw;
  t.th = min(th, Hg - t.r0);
  t.tw = min(tw, Wg - t.q0);
  t.v0 = chunk * cv;
  t.cw = min(cv, nvec - t.v0);
  return t;
}

// 16 bytes of T (VEC of them), or one element on the scalar path, loaded
// raw; Raw<T, VEC>::to_float converts them.
template <typename T, int VEC>
struct Raw {
  using type = uint4;
  static __device__ __forceinline__ type load(const T* p) { return *reinterpret_cast<const uint4*>(p); }
  static __device__ __forceinline__ void to_float(const type& q, float (&v)[VEC]) {
    if constexpr (sizeof(T) == 4) {
      v[0] = __uint_as_float(q.x);
      v[1] = __uint_as_float(q.y);
      v[2] = __uint_as_float(q.z);
      v[3] = __uint_as_float(q.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  }
};

template <typename T>
struct Raw<T, 1> {
  using type = T;
  static __device__ __forceinline__ type load(const T* p) { return *p; }
  static __device__ __forceinline__ void to_float(const type& q, float (&v)[1]) {
    if constexpr (sizeof(T) == 4)
      v[0] = q;
    else
      v[0] = __bfloat162float(q);
  }
};

}  // namespace lcgan
