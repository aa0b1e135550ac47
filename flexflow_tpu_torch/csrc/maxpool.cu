// Stride-2 max pool for Hopper (sm_90a): a one-pass forward that writes
// the pooled output y and the selection plane sel together, and the
// backward that routes dy through sel.  Plain CUDA C++ with a C interface
// (loaded with ctypes by flexflow_tpu_torch/ops/kernels/maxpool.py).
//
// The backward replaces flexflow_tpu/ops/pallas/maxpool.py:_bwd_kernel,
// the Pallas TPU kernel that _make_maxpool's bwd_call launches.  The
// forward does the work of that module's fwd_xla (plain XLA there).
// Geometry: NHWC, stride 2, square window k in {2, 3}, padding p in
// {0, 1} on both axes (-inf fill), optional fused ReLU.
//
//   forward   y[n,t,u,c]   = max over the window of x   (relu: max(y, 0))
//             sel[n,t,u,c] = window rank jh*k + jw of the FIRST max in
//                            window order, 255 where the fused ReLU
//                            clamps (y <= 0) or the window holds a NaN
//   backward  dx[n,h,w,c]  = sum of dy[n,t,u,c] over the windows (t, u)
//                            whose sel names (h, w), in float32, in
//                            ascending rank order, cast once
//
// The first-max rule is the one XLA's select_and_scatter applies and the
// Pallas kernel reproduces; ReLU outputs feed these pools, so ties among
// zeros are common and the rule decides where the gradient goes.
//
// What bounds it on an H100: both passes do a handful of compares or
// adds per byte, so memory bounds them.  At Inception's pool1 (N 256,
// 147x147x64 in, 73x73x64 out, bf16) the backward moves dy + sel + dx =
// 175 + 87 + 708 MB, 0.29 ms at 3.35 TB/s; the forward x + y + sel.
//
// Design, simple and right first:
//   * the backward is a gather: one thread per dx element visits the at
//     most ceil(k/2)^2 windows that cover it, so no two threads write one
//     address: no atomics, and the result does not depend on the run;
//   * C is the fastest axis, so neighbouring threads read and write
//     neighbouring addresses on every access;
//   * sel is one byte per output (the Pallas kernel keeps it in bf16), so
//     the forward writes and the backward reads a quarter of a float32
//     plane less;
//   * the backward reads dy through (n, h, w) strides with C contiguous,
//     so the channel slice a concat hands back needs no copy.
// Vector loads of several channels per thread, and keeping x's tile in
// shared memory across overlapping windows, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr uint8_t kSentinel = 255;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       uint8_t* __restrict__ sel, int n, int h, int w, int c,
                       int oh, int ow, int pad, int relu) {
  // unsigned: i + stride stays below 2^32 for planes below 2^31
  const unsigned total = static_cast<unsigned>(n * oh * ow * c);
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    const int ci = static_cast<int>(i % static_cast<unsigned>(c));
    int r = static_cast<int>(i / static_cast<unsigned>(c));
    const int u = r % ow;
    r /= ow;
    const int t = r % oh;
    const int ni = r / oh;
    const int h0 = 2 * t - pad;
    const int w0 = 2 * u - pad;
    float m = -CUDART_INF_F;
    int best = kSentinel;
    bool nan = false;
#pragma unroll
    for (int jh = 0; jh < K; ++jh) {
      const int hh = h0 + jh;
      if (hh < 0 || hh >= h) continue;
#pragma unroll
      for (int jw = 0; jw < K; ++jw) {
        const int ww = w0 + jw;
        if (ww < 0 || ww >= w) continue;
        const float v = to_f32(x[((ni * h + hh) * w + ww) * c + ci]);
        if (v != v) {  // NaN
          nan = true;
        } else if (v > m) {  // strict: the first max in window order stays
          m = v;
          best = jh * K + jw;
        }
      }
    }
    if (nan) {
      m = CUDART_NAN_F;
      best = kSentinel;
    }
    if (relu && !(m > 0.f)) {
      best = kSentinel;
      if (!nan) m = 0.f;
    }
    y[i] = from_f32<T>(m);
    sel[i] = static_cast<uint8_t>(best);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    maxpool_bwd_kernel(const T* __restrict__ dy,
                       const uint8_t* __restrict__ sel, T* __restrict__ dx,
                       int n, int h, int w, int c, int oh, int ow, int pad,
                       long long dy_sn, long long dy_sh, long long dy_sw) {
  // unsigned: i + stride stays below 2^32 for planes below 2^31
  const unsigned total = static_cast<unsigned>(n * h * w * c);
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    const int ci = static_cast<int>(i % static_cast<unsigned>(c));
    int r = static_cast<int>(i / static_cast<unsigned>(c));
    const int wi = r % w;
    r /= w;
    const int hi = r % h;
    const int ni = r / h;
    float acc = 0.f;
    // window t covers rows 2t - pad .. 2t - pad + K - 1, so (hi, wi) sits
    // at offset jh = hi + pad - 2t; ascending jh, jw is ascending rank
#pragma unroll
    for (int jh = 0; jh < K; ++jh) {
      const int th = hi + pad - jh;
      if (th < 0 || (th & 1)) continue;
      const int t = th >> 1;
      if (t >= oh) continue;
#pragma unroll
      for (int jw = 0; jw < K; ++jw) {
        const int tw = wi + pad - jw;
        if (tw < 0 || (tw & 1)) continue;
        const int u = tw >> 1;
        if (u >= ow) continue;
        const int o = ((ni * oh + t) * ow + u) * c + ci;
        if (sel[o] == jh * K + jw) {
          acc += to_f32(dy[ni * dy_sn + t * dy_sh + u * dy_sw + ci]);
        }
      }
    }
    dx[i] = from_f32<T>(acc);
  }
}

int blocks_for(long long total) {
  const long long b = (total + kThreads - 1) / kThreads;
  return static_cast<int>(b < (1 << 20) ? b : (1 << 20));
}

bool geometry_ok(int n, int h, int w, int c, int oh, int ow, int k,
                 int pad) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) {
    return false;
  }
  if ((k != 2 && k != 3) || (pad != 0 && pad != 1)) return false;
  if (oh != 1 + (h + 2 * pad - k) / 2 || ow != 1 + (w + 2 * pad - k) / 2) {
    return false;
  }
  // int indexing: every plane must stay below 2^31 elements
  const long long big = 1LL << 31;
  return static_cast<long long>(n) * h * w * c < big;
}

}  // namespace

// Launches the forward on ``stream`` and returns cudaGetLastError() after
// the launch (0 on success).  x (n, h, w, c) contiguous; the caller
// allocates y (n, oh, ow, c) of x's type and sel (n, oh, ow, c) uint8.
extern "C" int ff_maxpool_fwd(const void* x, void* y, void* sel, int n,
                              int h, int w, int c, int oh, int ow, int k,
                              int pad, int relu, int is_bf16, void* stream) {
  if (!geometry_ok(n, h, w, c, oh, ow, k, pad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(static_cast<long long>(n) * oh * ow * c);
  uint8_t* s = static_cast<uint8_t*>(sel);
  if (is_bf16) {
    const auto* xt = static_cast<const __nv_bfloat16*>(x);
    auto* yt = static_cast<__nv_bfloat16*>(y);
    if (k == 3) {
      maxpool_fwd_kernel<__nv_bfloat16, 3><<<blocks, kThreads, 0, st>>>(
          xt, yt, s, n, h, w, c, oh, ow, pad, relu);
    } else {
      maxpool_fwd_kernel<__nv_bfloat16, 2><<<blocks, kThreads, 0, st>>>(
          xt, yt, s, n, h, w, c, oh, ow, pad, relu);
    }
  } else {
    const auto* xt = static_cast<const float*>(x);
    auto* yt = static_cast<float*>(y);
    if (k == 3) {
      maxpool_fwd_kernel<float, 3><<<blocks, kThreads, 0, st>>>(
          xt, yt, s, n, h, w, c, oh, ow, pad, relu);
    } else {
      maxpool_fwd_kernel<float, 2><<<blocks, kThreads, 0, st>>>(
          xt, yt, s, n, h, w, c, oh, ow, pad, relu);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward on ``stream`` and returns cudaGetLastError()
// after the launch.  dy (n, oh, ow, c) with unit channel stride and the
// given n, h, w strides (in elements); sel (n, oh, ow, c) uint8
// contiguous; the caller allocates dx (n, h, w, c) of dy's type.
extern "C" int ff_maxpool_bwd(const void* dy, const void* sel, void* dx,
                              int n, int h, int w, int c, int oh, int ow,
                              int k, int pad, long long dy_sn,
                              long long dy_sh, long long dy_sw, int is_bf16,
                              void* stream) {
  if (!geometry_ok(n, h, w, c, oh, ow, k, pad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(static_cast<long long>(n) * h * w * c);
  const uint8_t* s = static_cast<const uint8_t*>(sel);
  if (is_bf16) {
    const auto* g = static_cast<const __nv_bfloat16*>(dy);
    auto* d = static_cast<__nv_bfloat16*>(dx);
    if (k == 3) {
      maxpool_bwd_kernel<__nv_bfloat16, 3><<<blocks, kThreads, 0, st>>>(
          g, s, d, n, h, w, c, oh, ow, pad, dy_sn, dy_sh, dy_sw);
    } else {
      maxpool_bwd_kernel<__nv_bfloat16, 2><<<blocks, kThreads, 0, st>>>(
          g, s, d, n, h, w, c, oh, ow, pad, dy_sn, dy_sh, dy_sw);
    }
  } else {
    const auto* g = static_cast<const float*>(dy);
    auto* d = static_cast<float*>(dx);
    if (k == 3) {
      maxpool_bwd_kernel<float, 3><<<blocks, kThreads, 0, st>>>(
          g, s, d, n, h, w, c, oh, ow, pad, dy_sn, dy_sh, dy_sw);
    } else {
      maxpool_bwd_kernel<float, 2><<<blocks, kThreads, 0, st>>>(
          g, s, d, n, h, w, c, oh, ow, pad, dy_sn, dy_sh, dy_sw);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
