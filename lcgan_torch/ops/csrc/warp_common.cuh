// Shared pieces of the bicubic warp kernels (csrc/warp_*.cu): the cubic
// convolution weights and their derivatives, the coordinate
// unnormalization, 16-byte vector loads and stores of NHWC channel runs, and
// the sort of a bucket's pixel list.
//
// Every kernel computes a pixel's taps and weights exactly as the plain
// PyTorch version does (lcgan_torch/ops/grid_sample.py): the coordinate is
// rounded step by step, so tap indices agree at integer boundaries, and the
// four weights come from the fractional offset t = f - floor(f).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lcgan {

constexpr float kA = -0.75f;  // torch's cubic convolution constant

__device__ __forceinline__ float cubic_near(float x) {  // |x| <= 1
  return ((kA + 2.f) * x - (kA + 3.f)) * x * x + 1.f;
}

__device__ __forceinline__ float cubic_far(float x) {  // 1 < |x| < 2
  return ((kA * x - 5.f * kA) * x + 8.f * kA) * x - 4.f * kA;
}

__device__ __forceinline__ float dcubic_near(float x) {  // d/dx cubic_near
  return (3.f * (kA + 2.f) * x - 2.f * (kA + 3.f)) * x;
}

__device__ __forceinline__ float dcubic_far(float x) {  // d/dx cubic_far
  return (3.f * kA * x - 10.f * kA) * x + 8.f * kA;
}

// align_corners=False unnormalization, rounded step by step as the plain
// PyTorch version does (no fma contraction), clamped to [-3, size + 2] where
// every tap is off the image either way.
__device__ __forceinline__ float unnormalize(float g, int size) {
  float f = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), (float)size), 1.f), 0.5f);
  return fminf(fmaxf(f, -3.f), (float)size + 2.f);
}

// The 4 tap weights of fractional offset t in [0, 1).
__device__ __forceinline__ void cubic_weights(float t, float (&w)[4]) {
  w[0] = cubic_far(t + 1.f);
  w[1] = cubic_near(t);
  w[2] = cubic_near(1.f - t);
  w[3] = cubic_far(2.f - t);
}

// Their derivatives with respect to the sample coordinate.
__device__ __forceinline__ void cubic_weight_derivatives(float t, float (&w)[4]) {
  w[0] = dcubic_far(t + 1.f);
  w[1] = dcubic_near(t);
  w[2] = -dcubic_near(1.f - t);
  w[3] = -dcubic_far(2.f - t);
}

// Tap weight i (0..3) of fractional offset t: cubic_weights(t)[i].
__device__ __forceinline__ float cubic_tap(float t, int i) {
  return i == 0 ? cubic_far(t + 1.f) : i == 1 ? cubic_near(t) : i == 2 ? cubic_near(1.f - t) : cubic_far(2.f - t);
}

__device__ inline void sift_down(int* a, int root, int n) {
  while (true) {
    int child = 2 * root + 1;
    if (child >= n) return;
    if (child + 1 < n && a[child + 1] > a[child]) ++child;
    if (a[root] >= a[child]) return;
    const int t = a[root];
    a[root] = a[child];
    a[child] = t;
    root = child;
  }
}

// Sorts a[0, n) ascending, in one thread: insertion sort for short runs
// (nearly every bucket of a warp's pixel lists), heap sort for long ones (a
// grid that gathers many pixels onto one spot).
__device__ inline void sort_ascending(int* a, int n) {
  constexpr int kInsertionMax = 32;
  if (n < 2) return;
  if (n <= kInsertionMax) {
    for (int i = 1; i < n; ++i) {
      const int x = a[i];
      int j = i - 1;
      while (j >= 0 && a[j] > x) {
        a[j + 1] = a[j];
        --j;
      }
      a[j + 1] = x;
    }
    return;
  }
  for (int i = n / 2 - 1; i >= 0; --i) sift_down(a, i, n);
  for (int end = n - 1; end > 0; --end) {
    const int t = a[0];
    a[0] = a[end];
    a[end] = t;
    sift_down(a, 0, end);
  }
}

template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// Asynchronous 16-byte copy from device to shared memory (cp.async, L1
// bypassed).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// Waits for every cp.async this thread issued; a __syncthreads() after it
// makes the block's copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Copies VEC elements of T into shared memory: 16 bytes asynchronously on the
// vector path, one element on the scalar path.
template <typename T, int VEC>
__device__ __forceinline__ void copy_to_shared(T* smem, const T* gmem) {
  if constexpr (VEC * sizeof(T) == 16) {
    cp_async16(smem, gmem);
  } else {
    static_assert(VEC == 1, "vector copies are 16 bytes");
    *smem = *gmem;
  }
}

}  // namespace lcgan
