// Gather along rows out of shared memory, for Hopper (sm_90a): the port of
// the gather probe.
//
//   out[i, j] = x[idx[i, j], j]        (take_along_axis along axis 0)
//
// x: (R, C) fp32, idx: (M, C) int32 with every index in [0, R), out: (M, C)
// fp32, all row-major and contiguous, x 16-byte aligned; C a multiple of 32
// and R at most 384.
// The probe's shape is R = M = 256, C = 128.
//
// It replaces the Pallas kernel pk of tools/gather_probe.py (in main,
// :39-50), which holds the whole (256, 128) tile in VMEM and gathers along
// its sublanes. Columns are independent, so here no block holds the whole
// tile: block (s, r) copies the 32-column strip s of x, all R rows, into
// shared memory as xs[R][32], then gathers output rows [32r, 32r + 32) of
// that strip. The 32 lanes of a warp run across the strip's 32 columns, so
// lane j reads xs[idx][j], which lies in bank j whatever idx is: a warp's 32
// loads hit 32 different banks for any indices. (A strip narrower than 32
// columns would put lanes across rows, and random rows would then collide in
// a bank.) Every block copies its whole strip, so the strip is read from
// L2 once per 32 output rows; the copy is 16-byte vectors, several in flight
// per thread, and the idx and out rows are 128-byte warp-wide accesses.
//
// The contract is indices in range, as the probe draws them; the kernel does
// not check them.
//
// What bounds it: device-memory bytes (x, idx and out once each: 384 KiB at
// the probe's shape, 0.12 us at 3.35 TB/s). At that size the launch takes
// longer than the work.
//
// C interface (ctypes): lcgan_gather_probe returns cudaGetLastError() after
// the launch, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 32;    // columns per block: one per lane
constexpr int kRows = 32;     // output rows per block
constexpr int kThreads = 256;
constexpr int kMaxRows = 48 * 1024 / (kStrip * 4);  // rows of x a strip may have: 48 KB of shared memory

__global__ void __launch_bounds__(kThreads)
gather_probe_kernel(const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out, int R,
                    int M, int C) {
  extern __shared__ float4 xs4[];  // [R][kStrip / 4]
  const float* xs = reinterpret_cast<const float*>(xs4);  // [R][kStrip]
  const int col0 = blockIdx.x * kStrip;
  // the strip in 16-byte vectors, a few in flight per thread
  const float4* src = reinterpret_cast<const float4*>(x + col0);
  constexpr int kVecs = kStrip / 4;
#pragma unroll 8
  for (int i = threadIdx.x; i < R * kVecs; i += kThreads) {
    const int r = i / kVecs;
    xs4[i] = src[(long long)r * (C / 4) + (i - r * kVecs)];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int row_end = min(M, (int)(blockIdx.y + 1) * kRows);
  for (int i = blockIdx.y * kRows + threadIdx.x / 32; i < row_end; i += kThreads / 32) {
    const long long at = (long long)i * C + col0 + lane;
    out[at] = xs[idx[at] * kStrip + lane];
  }
}

}  // namespace

extern "C" int lcgan_gather_probe(const void* x, const void* idx, void* out, int R, int M, int C, void* stream) {
  if (R < 1 || R > kMaxRows || M < 1 || C < kStrip || C % kStrip) return (int)cudaErrorInvalidValue;
  const dim3 grid(C / kStrip, (M + kRows - 1) / kRows);
  gather_probe_kernel<<<grid, kThreads, (size_t)R * kStrip * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(out), R, M, C);
  return (int)cudaGetLastError();
}
