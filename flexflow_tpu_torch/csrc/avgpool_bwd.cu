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
// Pallas kernel; 1/(kh*kw) is rounded to float32 from a double, as the
// plain version's Python scalar is.  NHWC throughout.
//
// What bounds it on an H100: one multiply per element, so memory.  At
// Inception's global tail (N 256, 8x8x2048, bf16, ReLU off) it reads dy
// (1 MB) and writes dx (67 MB): 0.020 ms at 3.35 TB/s.
//
// Design: a thread owns V adjacent channels of one window row: V = 8 in
// bf16, 4 in float32 (one 16-byte access) where C, dy's strides and every
// pointer allow it, else V = 1 (the same template; the wrapper picks V).
// It reads its dy vector (and y's) once, scales it once and stores the
// same vector to the kw positions of its row.  The grid is x over (output
// column, channel vector), y over dx rows, z over the batch: each window
// row has threads of its own, so even the global pool (one window per
// image) fills the card.  A thread's index math is one division by the
// channel vectors and one by kh, once.  dy is read through (n, h, w)
// strides with C contiguous, so a channel slice needs no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridYZ = 65535;

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

// V adjacent elements, loaded and stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    avgpool_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                       T* __restrict__ dx, int n, int h, int w, int cvecs,
                       int oh, int ow, int kh, int kw, float scale,
                       long long dy_sn, long long dy_sh, long long dy_sw) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= ow * cvecs) return;
  const int u = i / cvecs;
  const int c = cvecs * V;
  const int c0 = (i - u * cvecs) * V;
  // gridDim.y is a multiple of kh: a block keeps its window row jh and
  // steps over output rows gridDim.y / kh apart
  const int jh = blockIdx.y % kh;
  const int t_step = gridDim.y / kh;
  for (int ni = blockIdx.z; ni < n; ni += gridDim.z) {
    for (int t = blockIdx.y / kh; t < oh; t += t_step) {
      const Pack<T, V> g = *reinterpret_cast<const Pack<T, V>*>(
          dy + ni * dy_sn + t * dy_sh + u * dy_sw + c0);
      Pack<T, V> m;
      if (y != nullptr) {
        m = *reinterpret_cast<const Pack<T, V>*>(
            y + ((ni * oh + t) * ow + u) * c + c0);
      }
      Pack<T, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = to_f32(g.v[e]);
        if (y != nullptr && !(to_f32(m.v[e]) > 0.f)) v = 0.f;
        out.v[e] = from_f32<T>(v * scale);
      }
      T* d = dx + ((ni * h + t * kh + jh) * w + u * kw) * c + c0;
      for (int jw = 0; jw < kw; ++jw) {
        *reinterpret_cast<Pack<T, V>*>(d + jw * c) = out;
      }
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const void* dy, const void* y, void* dx, int n, int h, int w,
           int c, int oh, int ow, int kh, int kw, long long sn, long long sh,
           long long sw, int vec, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const int bytes = vec * sizeof(T);
  if ((vec != 1 && vec != kVec) || c % vec || sn % vec || sh % vec ||
      sw % vec || !aligned(dy, bytes) || !aligned(y, bytes) ||
      !aligned(dx, bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cv = c / vec;
  // rows: all of them, or the most below the grid's limit that keep
  // every block on one window row
  const int rows = h <= kMaxGridYZ ? h : kMaxGridYZ / kh * kh;
  const dim3 grid((ow * cv + kThreads - 1) / kThreads, rows,
                  n < kMaxGridYZ ? n : kMaxGridYZ);
  const float scale = static_cast<float>(1.0 / (static_cast<double>(kh) * kw));
  const auto* g = static_cast<const T*>(dy);
  const auto* m = static_cast<const T*>(y);
  auto* d = static_cast<T*>(dx);
  if (vec == kVec) {
    avgpool_bwd_kernel<T, kVec><<<grid, kThreads, 0, st>>>(
        g, m, d, n, h, w, cv, oh, ow, kh, kw, scale, sn, sh, sw);
  } else {
    avgpool_bwd_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        g, m, d, n, h, w, cv, oh, ow, kh, kw, scale, sn, sh, sw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on ``stream`` and returns cudaGetLastError() after
// the launch (0 on success).  dy (n, oh, ow, c) with unit channel stride
// and the given n, h, w strides (in elements); y (n, oh, ow, c)
// contiguous, or null when no ReLU is fused; the caller allocates dx
// (n, h, w, c) of dy's type.  Needs oh*kh == h and ow*kw == w.  ``vec``
// channels per thread: 1, or 16 bytes of them where c, the strides and
// every pointer allow it (an invalid argument error otherwise).
extern "C" int ff_avgpool_bwd(const void* dy, const void* y, void* dx, int n,
                              int h, int w, int c, int oh, int ow, int kh,
                              int kw, long long dy_sn, long long dy_sh,
                              long long dy_sw, int is_bf16, int vec,
                              void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || kh <= 0 || kw <= 0 ||
      oh * kh != h || ow * kw != w || kh > kMaxGridYZ ||
      static_cast<long long>(n) * h * w * c >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(dy, y, dx, n, h, w, c, oh, ow, kh,
                                         kw, dy_sn, dy_sh, dy_sw, vec, st)
                 : launch<float>(dy, y, dx, n, h, w, c, oh, ow, kh, kw, dy_sn,
                                 dy_sh, dy_sw, vec, st);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
