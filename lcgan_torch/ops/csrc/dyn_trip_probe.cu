// A sum of packed matrix products with a static or a device-loaded trip
// count, for Hopper (sm_90a): the port of the trip-count probe.
//
//   out = sum_{i < n} x[i] @ w
//
// x: (packs, 256, 256) fp32, w: (256, 256) fp32, out: (256, 256) fp32, all
// contiguous, x 16-byte aligned. One body, two entry points:
//   lcgan_dyn_trip_static  n is a template argument (1, 2, 4, ..., 64): the
//                          port of _static_kernel (tools/dyn_trip_probe.py:31);
//   lcgan_dyn_trip_dyn     n is read inside the kernel from an int32 in device
//                          memory, with no host sync and no copy to the host:
//                          the port of _dyn_kernel (:40), which reads it from
//                          SMEM. A count outside [0, packs] is outside the
//                          contract; the kernel clamps it so that it never
//                          reads past x.
// The body is one function, compiled once and called by both kernels
// (__noinline__, n an argument), so the compiler lays out the same loop
// whether the kernel knows n or not: the two arms differ only in where n
// comes from, and dyn(n) equals static(n) bit for bit. The probe asks
// whether a loop bound loaded at run time costs more than one the compiler
// knows, and whether the time follows the count. (Inlined into each kernel,
// the body was scheduled one way for a known n and another for a loaded one,
// 80 and 118 registers, and the known count ran 1.4 times slower: the ratio
// measured code generation, not the trip count; PERF.md.)
//
// Products are fp32 fused multiply-adds (the TPU kernel's
// precision=HIGHEST), no TF32, in a fixed order: each thread sums its slice
// of the inner dimension over the packs, then the slices are summed in
// slice order.
//
// Tiles: the output is only 256 x 256, so a block takes a 16 x 32 tile and
// the grid has 128 blocks, one per SM on 128 of the H100's 132 (a 64 x 64
// tile would leave 116 of them idle). The cost of so small a tile: a block
// reads its 16 rows of every pack from L2 (x is read 8 times over, once per
// column tile: 2 MB a pack), and the 32 columns give each value of x that a
// block loads only 32 uses. Each block keeps its 256 x 32 slice of w in
// registers for the whole loop (each of its 256 threads two columns of one
// 16-deep slice of the inner dimension), so only x streams: two buffers of
// 16 rows in shared memory, filled by 16-byte cp.async copies one pack ahead.
// A thread reads four values of x with one 16-byte broadcast load and makes
// eight multiply-adds with them; the 16 slices' partial tiles are summed
// through shared memory at the end.
//
// What bounds it: fp32 operations, 2 * 256^3 * n flops (0.537 GFLOP at
// n = 16: 8.0 us at 67 TFLOP/s); the bytes (n packs, w, out: 4.7 MB at
// n = 16) take 1.4 us at 3.35 TB/s. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (PERF.md), a pack takes about 1.0 us here against the bound's 0.5:
// 4 x 8 and 8 x 8 register tiles, w in registers or in shared memory, and
// 64 x 64 tiles summed over a cluster of 8 blocks through distributed shared
// memory all ran 1.5 to 1.7 us a pack, and the cluster's reduction added 2
// to 6 us a call.
//
// C interface (ctypes): each entry point returns cudaGetLastError() after the
// launch, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 256;                        // x[i], w and out are kN x kN
constexpr int kTM = 16;                        // output rows per block
constexpr int kTN = 32;                        // output columns per block
constexpr int kThreads = 256;
constexpr int kColPairs = kTN / 2;             // threads across a tile's columns, two columns each
constexpr int kSlices = kThreads / kColPairs;  // slices of the inner dimension
constexpr int kSlice = kN / kSlices;           // inner indices per slice
constexpr int kTile = kTM * kN;                // floats of x a block reads per pack

// the partial tiles of the end, [kSlices][kTM][kTN], reuse the two x buffers
static_assert(kSlices * kTM * kTN == 2 * kTile, "partials and buffers differ in size");
static_assert(kSlice % 4 == 0, "a slice is read in 16-byte vectors");

// Starts copying one pack's kTM contiguous rows of x into dst.
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst) {
  for (int v = threadIdx.x; v < kTile / 4; v += kThreads) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * v);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + 4 * v) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __noinline__ void packed_sum(const float* __restrict__ x, const float* __restrict__ w,
                                        float* __restrict__ out, int n) {
  __shared__ __align__(16) float smem[2 * kTile];
  const int row0 = blockIdx.y * kTM;
  const int col0 = blockIdx.x * kTN;
  const int cp = threadIdx.x % kColPairs;  // columns col0 + 2cp and col0 + 2cp + 1
  const int ks = threadIdx.x / kColPairs;  // inner indices [ks * kSlice, (ks + 1) * kSlice)

  float wr[kSlice][2];
#pragma unroll
  for (int j = 0; j < kSlice; ++j) {
    const float* wp = w + (ks * kSlice + j) * kN + col0 + 2 * cp;
    wr[j][0] = wp[0];
    wr[j][1] = wp[1];
  }
  float acc[kTM][2];
#pragma unroll
  for (int r = 0; r < kTM; ++r) acc[r][0] = acc[r][1] = 0.f;

  const float* xt = x + (long long)row0 * kN;
  if (n > 0) load_rows(xt, smem);
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      load_rows(xt + (long long)(i + 1) * kN * kN, smem + ((i + 1) & 1) * kTile);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* buf = smem + (i & 1) * kTile + ks * kSlice;
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
      const float4* xr = reinterpret_cast<const float4*>(buf + r * kN);
#pragma unroll
      for (int q = 0; q < kSlice / 4; ++q) {
        const float4 v = xr[q];
        const int j = 4 * q;
        acc[r][0] = fmaf(v.x, wr[j][0], acc[r][0]);
        acc[r][1] = fmaf(v.x, wr[j][1], acc[r][1]);
        acc[r][0] = fmaf(v.y, wr[j + 1][0], acc[r][0]);
        acc[r][1] = fmaf(v.y, wr[j + 1][1], acc[r][1]);
        acc[r][0] = fmaf(v.z, wr[j + 2][0], acc[r][0]);
        acc[r][1] = fmaf(v.z, wr[j + 2][1], acc[r][1]);
        acc[r][0] = fmaf(v.w, wr[j + 3][0], acc[r][0]);
        acc[r][1] = fmaf(v.w, wr[j + 3][1], acc[r][1]);
      }
    }
    __syncthreads();  // the buffer is refilled two packs on
  }

  float* part = smem;  // [kSlices][kTM][kTN]
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    part[(ks * kTM + r) * kTN + 2 * cp] = acc[r][0];
    part[(ks * kTM + r) * kTN + 2 * cp + 1] = acc[r][1];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kTM * kTN; o += kThreads) {
    const int r = o / kTN;
    const int c = o - r * kTN;
    float s = part[o];
    for (int k = 1; k < kSlices; ++k) s += part[k * kTM * kTN + o];
    out[(row0 + r) * kN + col0 + c] = s;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
dyn_trip_static_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out) {
  packed_sum(x, w, out, N);
}

__global__ void __launch_bounds__(kThreads)
dyn_trip_dyn_kernel(const int* __restrict__ n, int packs, const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out) {
  packed_sum(x, w, out, min(max(*n, 0), packs));
}

inline dim3 grid() { return dim3(kN / kTN, kN / kTM); }  // 8 x 16 = 128 blocks

template <int N>
int launch_static(const void* x, const void* w, void* out, cudaStream_t stream) {
  dyn_trip_static_kernel<N><<<grid(), kThreads, 0, stream>>>(static_cast<const float*>(x),
                                                              static_cast<const float*>(w), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// x: the first npk of its packs are summed; npk one of 1, 2, 4, ..., 64.
extern "C" int lcgan_dyn_trip_static(const void* x, const void* w, void* out, int npk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (npk) {
    case 1: return launch_static<1>(x, w, out, s);
    case 2: return launch_static<2>(x, w, out, s);
    case 4: return launch_static<4>(x, w, out, s);
    case 8: return launch_static<8>(x, w, out, s);
    case 16: return launch_static<16>(x, w, out, s);
    case 32: return launch_static<32>(x, w, out, s);
    case 64: return launch_static<64>(x, w, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// n: one int32 in device memory, the count of packs to sum; packs: x's.
extern "C" int lcgan_dyn_trip_dyn(const void* n, int packs, const void* x, const void* w, void* out, void* stream) {
  if (packs < 0) return (int)cudaErrorInvalidValue;
  dyn_trip_dyn_kernel<<<grid(), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(n), packs, static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
