// Shared pieces of the small-map warp kernels (warp_fwd_small.cu,
// warp_dgrid_small.cu, and warp_dx_small.cu on maps of at most 256 pixels):
// each block holds one channel group of one batch element's whole map (at
// most 64² pixels) in dynamic shared memory. The host picks the group's width
// (lcgan_torch/ops/warp.py _small_channels, _dx_small_geometry); group g
// takes channels [g·cg, min(C, (g+1)·cg)).

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

}  // namespace lcgan
