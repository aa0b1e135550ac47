// Non-overlapping average-pool backward for Hopper (sm_90a), plain CUDA
// C++ with a C interface (loaded with ctypes by
// flexflow_tpu_torch/ops/kernels/avgpool.py).
//
// Replaces flexflow_tpu/ops/pallas/avgpool.py:_bwd_kernel, the Pallas TPU
// kernel that _make_avgpool's bwd_call launches.  For the geometries
// whose windows tile the input exactly (stride == window, padding 0, or
// the global pool), every input position lies in one window, so
//
//     dx[n,h,w,c] = dy[n, h/kh, w/kw, c] * (1 / (kh*kw))
//
// with dy zeroed first where the fused ReLU clamped the pooled output
// (y <= 0).  Arithmetic is float32, cast once at the store, as in the
// Pallas kernel.  NHWC throughout.
//
// What bounds it on an H100: one multiply per element, so memory.  At
// Inception's global tail (N 256, 8x8x2048, bf16, ReLU off) it reads dy
// (1 MB) and writes dx (67 MB): 0.020 ms at 3.35 TB/s.
//
// Design: one thread per dx element, C fastest, so neighbouring threads
// write neighbouring addresses; the dy (and y) element a thread reads is
// shared by the kh*kw threads of its window and comes from L1/L2 after
// the first.  dy is read through (n, h, w) strides with C contiguous, so
// a channel slice needs no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    avgpool_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                       T* __restrict__ dx, int n, int h, int w, int c,
                       int oh, int ow, int kh, int kw, float scale,
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
    const int t = hi / kh;
    const int u = wi / kw;
    float g = to_f32(dy[ni * dy_sn + t * dy_sh + u * dy_sw + ci]);
    if (y != nullptr && !(to_f32(y[((ni * oh + t) * ow + u) * c + ci]) > 0.f)) {
      g = 0.f;
    }
    dx[i] = from_f32<T>(g * scale);
  }
}

}  // namespace

// Launches the kernel on ``stream`` and returns cudaGetLastError() after
// the launch (0 on success).  dy (n, oh, ow, c) with unit channel stride
// and the given n, h, w strides (in elements); y (n, oh, ow, c)
// contiguous, or null when no ReLU is fused; the caller allocates dx
// (n, h, w, c) of dy's type.  Needs oh*kh == h and ow*kw == w.
extern "C" int ff_avgpool_bwd(const void* dy, const void* y, void* dx, int n,
                              int h, int w, int c, int oh, int ow, int kh,
                              int kw, long long dy_sn, long long dy_sh,
                              long long dy_sw, int is_bf16, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || kh <= 0 || kw <= 0 ||
      oh * kh != h || ow * kw != w ||
      static_cast<long long>(n) * h * w * c >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(n) * h * w * c;
  const long long b = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(b < (1 << 20) ? b : (1 << 20));
  const float scale = 1.0f / static_cast<float>(kh * kw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    avgpool_bwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(dx), n, h, w, c, oh, ow, kh, kw, scale,
        dy_sn, dy_sh, dy_sw);
  } else {
    avgpool_bwd_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(y),
        static_cast<float*>(dx), n, h, w, c, oh, ow, kh, kw, scale, dy_sn,
        dy_sh, dy_sw);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
