// The 3x3 box filter and the 2x2 average pool, forward and gradient, for
// Hopper (sm_90a):
//
//   box_filter_kernel    out = avg_pool2d(x, 3, stride 1, padding 1) with
//                        count_include_pad: zero padding, divisor always 9
//                        (its own gradient: the filter is self-adjoint)
//   pool2x2_kernel       out = avg_pool2d(x, 2, stride 2)
//   pool2x2_grad_kernel  its gradient: g / 4 at each of the four inputs of
//                        g's window, 0 on an odd map's last row or column
//
// They replace ATen's avg_pool2d and avg_pool2d_backward on the card
// (avg_pool2d_out_cuda_frame_nhwc and its backward, ATen's generic channels_last
// pooling kernels, which the port reached through F.avg_pool2d). No TPU kernel
// stands behind them: the JAX package leaves both pools to XLA
// (lcgan_tpu/ops/filters.py).
//
// What bounds them on this card: bytes, one read of the input and one write of
// the output. Nine fp32 adds and a division per output value are far below the
// card's fp32 rate. ATen's kernels take one 2-byte element a thread and work
// out its (n, h, w, c) by 64-bit divisions, per element.
//
// Design:
//   * a thread owns a unit of V channels of one pixel column, neighbouring
//     threads neighbouring units, so that a warp's loads and stores are
//     coalesced. The path follows the tensor (lcgan_torch/ops/filters.py,
//     pool_path): "vector", V = 16 bytes of channels (8 bf16, 4 fp32) where
//     the map is channels_last, C * itemsize % 16 == 0 and both pointers are
//     16-byte aligned; "narrow", V = 1 on any other channels_last map (the
//     generator's 2-channel flow); "strided", V = 1 on an NCHW-contiguous map,
//     where a unit is one element and neighbouring threads take neighbouring
//     columns;
//   * the box filter's thread slides down a strip of at most kStrip output
//     rows. Each input row's three taps are loaded once and kept as loaded (a
//     16-byte vector is four registers), with kAhead rows in flight beyond the
//     two the current output needs, so an input row is read (rows + 2) / rows
//     times from L2, and the horizontal neighbours' loads come from L1. The
//     host picks the strip's rows (filters.box_rows): fewer where the grid
//     would not fill the card;
//   * sums in fp32 in ATen's order, row by row and left to right, from +0
//     (a tap off the image adds a zero, which leaves the sum as it is), then
//     divided by 9 (by 4) once and rounded once to the output's type: bitwise
//     equal to ATen's forward, and its 2x2 gradient, 0 + g / 4. The division
//     by 9 is div9, IEEE's quotient without the slow-path call, whose saved
//     registers spilled;
//   * deterministic, no atomics, no scratch: the wrapper allocates the output,
//     in the input's memory format, with torch.empty.
//
// Measured on an H100 (512²·C64 bf16, batch 8; bound 0.160 ms; PERF.md):
// one output a thread with its nine loads, 0.317 ms; the strip with its rows
// converted to fp32 and one row ahead, 0.322 ms (123 registers, two blocks an
// SM); rows as loaded, one ahead, four blocks an SM, 0.238 ms; strips of 4 or
// 16 rows, 0.250-0.254 ms (spills); this design, 0.207 ms.
//
// C interface (ctypes): each lcgan_* entry returns cudaGetLastError() after its
// launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 8;  // output rows a box-filter thread slides over at most (filters._STRIP)
constexpr int kAhead = 2;  // input rows a box-filter thread has in flight beyond the two its output needs
constexpr int kBoxBlocks = 3;  // box-filter blocks an SM holds: at most 85 registers a thread
enum Path { kVector = 0, kNarrow = 1, kStrided = 2 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// V channels of one pixel, stored as one access (16 bytes on the vector path)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  Pack<T, V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = from_float<T>(f[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = r;
}

// V channels of one pixel as loaded, in 32-bit registers: 16 bytes on the
// vector path (bf16 pairs or fp32 values), one element on the others.
template <typename T, int V>
struct Raw;

template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 r;
  __device__ __forceinline__ float operator[](int i) const {  // i known at compile time
    const unsigned w = i < 2 ? r.x : i < 4 ? r.y : i < 6 ? r.z : r.w;
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
};

template <>
struct Raw<float, 4> {
  float4 r;
  __device__ __forceinline__ float operator[](int i) const { return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w; }
};

template <typename T>
struct Raw<T, 1> {
  T r;
  __device__ __forceinline__ float operator[](int) const { return to_float(r); }
};

// V channels of one pixel, loaded as one access
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> fetch(const T* p) {
  Raw<T, V> t;
  t.r = *reinterpret_cast<const decltype(t.r)*>(p);
  return t;
}

// The three taps (left, centre, right) of input row h as loaded, zero off the
// image and where h < 0 (a row the strip does not need).
template <typename T, int V>
__device__ __forceinline__ void row_taps(const T* col, int h, int H, int row, int pixel, bool left, bool right,
                                         Raw<T, V> (&t)[3]) {
  const decltype(t[0].r) zero{};
  t[0].r = t[1].r = t[2].r = zero;
  if (h < 0 || h >= H) return;
  const T* p = col + h * row;
  if (left) t[0] = fetch<T, V>(p - pixel);
  t[1] = fetch<T, V>(p);
  if (right) t[2] = fetch<T, V>(p + pixel);
}

// a / 9 rounded once, as IEEE division (and ATen's a / 9) gives it, without
// its slow-path call: q = a * RN(1/9) is within an ulp, r = a - 9 q is exact,
// and q + r * RN(1/9) rounds to a / 9 (Markstein's correction; checked for
// every float of a binade, so for every a whose q and r stay normal). Outside
// that range, and for inf and NaN, a double quotient rounded to float: its
// error, under 2^-28 ulp, cannot cross a float rounding boundary, which a / 9
// misses by at least 1/18 ulp.
__device__ __forceinline__ float div9(float a) {
  constexpr float kNinth = 1.f / 9.f;
  const float m = fabsf(a);
  if (m >= 0x1p-100f && m <= 0x1p+100f) {
    const float q = a * kNinth;
    return fmaf(fmaf(-9.f, q, a), kNinth, q);
  }
  return (float)((double)a * (1.0 / 9.0));
}

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads, kBoxBlocks)
box_filter_kernel(const T* __restrict__ x, T* __restrict__ out, int C, int H, int W, int rows, int groups,
                  int units) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= units) return;
  // CL (channels_last): threads run over (n, row group, column, unit of V
  // channels), the unit fastest, pixels C elements apart; otherwise (NCHW,
  // V = 1) over (n * C + c, row group, column), the column fastest. `col`
  // points at the unit in row 0 of its column.
  int w, group, pixel, row, col;  // element offsets: the wrapper keeps the map under 2^31 elements
  if (CL) {
    const int per_pixel = C / V;
    const int k = idx % per_pixel;
    int rest = idx / per_pixel;
    w = rest % W;
    rest /= W;
    group = rest % groups;
    const int n = rest / groups;
    pixel = C;
    row = W * C;
    col = n * H * row + w * C + k * V;
  } else {
    w = idx % W;
    const int rest = idx / W;
    group = rest % groups;
    const int plane = rest / groups;  // n * C + c
    pixel = 1;
    row = W;
    col = plane * H * W + w;
  }
  const bool left = w > 0, right = w + 1 < W;
  const T* src = x + col;
  T* dst = out + col;
  const int h0 = group * rows;
  const int count = min(rows, H - h0);  // output rows of this strip; it reads rows h0 - 1 to h0 + count

  // the window's first row, summed as ATen sums it: ((0 + left) + centre) + right
  float top[V];
  {
    Raw<T, V> up[3];
    row_taps<T, V>(src, h0 - 1, H, row, pixel, left, right, up);
#pragma unroll
    for (int i = 0; i < V; ++i) top[i] = ((0.f + up[0][i]) + up[1][i]) + up[2][i];
  }
  // rows h, h + 1 (the output row and the one below) and kAhead more in flight, as loaded
  Raw<T, V> win[2 + kAhead][3];
#pragma unroll
  for (int j = 0; j < 2 + kAhead; ++j) row_taps<T, V>(src, j <= count ? h0 + j : -1, H, row, pixel, left, right, win[j]);
#pragma unroll
  for (int k = 0; k < kStrip; ++k) {
    if (k >= count) break;
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float m0 = win[0][0][i], m1 = win[0][1][i], m2 = win[0][2][i];
      float acc = top[i];
      acc += m0;
      acc += m1;
      acc += m2;
      acc += win[1][0][i];
      acc += win[1][1][i];
      acc += win[1][2][i];
      o[i] = div9(acc);
      top[i] = ((0.f + m0) + m1) + m2;  // the next output's first row
    }
    store<T, V>(dst + (h0 + k) * row, o);
#pragma unroll
    for (int j = 0; j < 1 + kAhead; ++j) {
#pragma unroll
      for (int t = 0; t < 3; ++t) win[j][t].r = win[j + 1][t].r;
    }
    const int next = k + 2 + kAhead;  // the strip's row after the last in flight
    row_taps<T, V>(src, next <= count ? h0 + next : -1, H, row, pixel, left, right, win[1 + kAhead]);
  }
}

// One output unit a thread: the four taps of its window, at (2 ph, 2 pw). The
// output is dense in the input's format, so unit idx lies at idx * V.
template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads)
pool2x2_kernel(const T* __restrict__ x, T* __restrict__ out, int C, int H, int W, int PH, int PW, int units) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= units) return;
  long long in;
  int pixel, row;
  if (CL) {  // idx over (n, ph, pw, unit of V channels)
    const int per_pixel = C / V;
    const int k = idx % per_pixel;
    int rest = idx / per_pixel;
    const int pw = rest % PW;
    rest /= PW;
    const int ph = rest % PH;
    const int n = rest / PH;
    in = (((long long)n * H + 2 * ph) * W + 2 * pw) * C + k * V;
    pixel = C;
    row = W * C;
  } else {  // idx over (n * C + c, ph, pw)
    const int pw = idx % PW;
    const int rest = idx / PW;
    const int ph = rest % PH;
    const int plane = rest / PH;
    in = ((long long)plane * H + 2 * ph) * W + 2 * pw;
    pixel = 1;
    row = W;
  }
  const T* p = x + in;
  const Raw<T, V> a = fetch<T, V>(p), b = fetch<T, V>(p + pixel), c = fetch<T, V>(p + row),
                  d = fetch<T, V>(p + row + pixel);
  float r[V];
#pragma unroll
  for (int i = 0; i < V; ++i) r[i] = ((((0.f + a[i]) + b[i]) + c[i]) + d[i]) / 4.f;
  store<T, V>(out + (long long)idx * V, r);
}

// One unit of the gradient, shaped as the pool's input, a thread: 0 + g / 4
// from the window that holds it, or 0 where none does (an odd map's last row
// or column). The output is dense: unit idx lies at idx * V.
template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads)
pool2x2_grad_kernel(const T* __restrict__ g, T* __restrict__ out, int C, int H, int W, int PH, int PW, int units) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= units) return;
  int h, w;
  long long image;  // g's element offset of (n, 0, 0, unit), or of plane n * C + c
  if (CL) {  // idx over (n, h, w, unit of V channels)
    const int per_pixel = C / V;
    const int k = idx % per_pixel;
    int rest = idx / per_pixel;
    w = rest % W;
    rest /= W;
    h = rest % H;
    const int n = rest / H;
    image = (long long)n * PH * PW * C + k * V;
  } else {  // idx over (n * C + c, h, w)
    w = idx % W;
    const int rest = idx / W;
    h = rest % H;
    image = (long long)(rest / H) * PH * PW;
  }
  float r[V];
#pragma unroll
  for (int i = 0; i < V; ++i) r[i] = 0.f;
  const int ph = h >> 1, pw = w >> 1;
  if (ph < PH && pw < PW) {
    const Raw<T, V> v = fetch<T, V>(g + image + ((long long)ph * PW + pw) * (CL ? C : 1));
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = 0.f + v[i] / 4.f;
  }
  store<T, V>(out + (long long)idx * V, r);
}

int blocks(int units) { return (units + kThreads - 1) / kThreads; }

// units of V channels over n pixels and C channels, or -1 past an int's range
int units_of(long long pixels, int C, int V) {
  const long long units = pixels * (C / V);
  return units > INT_MAX ? -1 : (int)units;
}

struct BoxFilter {
  template <typename T, int V, bool CL>
  static int run(const void* x, void* out, int N, int C, int H, int W, int rows, cudaStream_t s) {
    const int groups = (H + rows - 1) / rows;
    const int units = units_of((long long)N * groups * W, C, V);
    if (units < 0 || rows < 1 || rows > kStrip) return (int)cudaErrorInvalidValue;
    box_filter_kernel<T, V, CL><<<blocks(units), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), C, H, W, rows, groups, units);
    return (int)cudaGetLastError();
  }
};

struct Pool2x2 {
  template <typename T, int V, bool CL>
  static int run(const void* x, void* out, int N, int C, int H, int W, int, cudaStream_t s) {
    const int units = units_of((long long)N * (H / 2) * (W / 2), C, V);
    if (units < 0) return (int)cudaErrorInvalidValue;
    pool2x2_kernel<T, V, CL><<<blocks(units), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), C, H, W, H / 2, W / 2, units);
    return (int)cudaGetLastError();
  }
};

struct Pool2x2Grad {  // H, W: the gradient's (the pool's input's) map; g is (H / 2, W / 2)
  template <typename T, int V, bool CL>
  static int run(const void* g, void* out, int N, int C, int H, int W, int, cudaStream_t s) {
    const int units = units_of((long long)N * H * W, C, V);
    if (units < 0) return (int)cudaErrorInvalidValue;
    pool2x2_grad_kernel<T, V, CL><<<blocks(units), kThreads, 0, s>>>(
        static_cast<const T*>(g), static_cast<T*>(out), C, H, W, H / 2, W / 2, units);
    return (int)cudaGetLastError();
  }
};

template <typename Op>
int dispatch(const void* in, void* out, int dtype, int path, int N, int C, int H, int W, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (path) {
      case kVector: return C % 4 ? (int)cudaErrorInvalidValue : Op::template run<float, 4, true>(in, out, N, C, H, W, rows, s);
      case kNarrow: return Op::template run<float, 1, true>(in, out, N, C, H, W, rows, s);
      case kStrided: return Op::template run<float, 1, false>(in, out, N, C, H, W, rows, s);
    }
  } else if (dtype == 1) {
    switch (path) {
      case kVector:
        return C % 8 ? (int)cudaErrorInvalidValue : Op::template run<__nv_bfloat16, 8, true>(in, out, N, C, H, W, rows, s);
      case kNarrow: return Op::template run<__nv_bfloat16, 1, true>(in, out, N, C, H, W, rows, s);
      case kStrided: return Op::template run<__nv_bfloat16, 1, false>(in, out, N, C, H, W, rows, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: (N, C, H, W) in one memory format (the path's); dtype 0 fp32, 1 bf16;
// path 0 vector, 1 narrow, 2 strided; rows: output rows a thread slides over (1..8)
extern "C" int lcgan_box_filter(const void* x, void* out, int dtype, int path, int N, int C, int H, int W, int rows,
                                void* stream) {
  return dispatch<BoxFilter>(x, out, dtype, path, N, C, H, W, rows, stream);
}

// x: (N, C, H, W); out: (N, C, H / 2, W / 2)
extern "C" int lcgan_pool2x2(const void* x, void* out, int dtype, int path, int N, int C, int H, int W,
                             void* stream) {
  return dispatch<Pool2x2>(x, out, dtype, path, N, C, H, W, 1, stream);
}

// g: (N, C, H / 2, W / 2); out: (N, C, H, W)
extern "C" int lcgan_pool2x2_grad(const void* g, void* out, int dtype, int path, int N, int C, int H, int W,
                                  void* stream) {
  return dispatch<Pool2x2Grad>(g, out, dtype, path, N, C, H, W, 1, stream);
}
