// Stride-2 max pool for Hopper (sm_90a): a one-pass forward that writes
// the pooled output y and the selection plane sel together, and the
// backward that routes dy through sel.  Plain CUDA C++ with a C interface
// (loaded with ctypes by flexflow_tpu_torch/ops/kernels/maxpool.py).
//
// The backward replaces flexflow_tpu/ops/pallas/maxpool.py:_bwd_kernel,
// the Pallas TPU kernel that _make_maxpool's bwd_call launches.  The
// forward does the work of that module's fwd_xla (plain XLA there).
// Geometry: NHWC, stride 2, square window k and padding p (-inf fill) in
// {(3, 0), (3, 1), (2, 0)}, optional fused ReLU.
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
// Design:
//   * a thread owns V adjacent channels, read and written as one access:
//     V = 8 in bf16, 4 in float32 (16 bytes, and V bytes of sel), where C,
//     dy's strides and every pointer allow it, else V = 1 (the same
//     template; the wrapper picks V before the launch);
//   * the grid is x over (output or cell column, channel vector), y over
//     rows, z over the batch, so a thread's index math is one division by
//     the channel vectors, once; y and z loop only past 65535 rows or
//     images, with no division;
//   * the forward: a thread loads its k x k window as k*k vectors, all in
//     flight together; the column a window shares with its neighbour
//     comes from L1, the row from L2;
//   * the backward is a gather over stride cells: padded rows 2th, 2th+1
//     and columns 2tw, 2tw+1 form cell (th, tw), covered only by windows
//     (th - dh, tw - dw), dh, dw in {0, 1} (k = 3) or dh = dw = 0 (k = 2).
//     Cell position (a, b) sits at window offset (a + 2dh, b + 2dw), so
//     each position's ranks are known at compile time, and ascending
//     (dh, dw) is ascending rank.  A thread reads those at most 4 dy and 4
//     sel vectors once and writes the cell's at most 4 dx vectors: no two
//     threads write one address, no atomics, the same bits every run;
//   * dy is read through (n, h, w) strides with C contiguous, so the
//     channel slice a concat hands back needs no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr uint8_t kSentinel = 255;
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
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& q) {
  *reinterpret_cast<Pack<T, V>*>(p) = q;
}

template <typename T, int K, int PAD, int V>
__global__ void __launch_bounds__(kThreads)
    maxpool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       uint8_t* __restrict__ sel, int n, int h, int w,
                       int cvecs, int oh, int ow, int relu) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= ow * cvecs) return;
  const int u = i / cvecs;
  const int c = cvecs * V;
  const int c0 = (i - u * cvecs) * V;
  const int w0 = 2 * u - PAD;
  for (int ni = blockIdx.z; ni < n; ni += gridDim.z) {
    for (int t = blockIdx.y; t < oh; t += gridDim.y) {
      const int h0 = 2 * t - PAD;
      // pad 0 windows lie inside the input; pad 1 ones may not: a
      // position outside loads its nearest inside one (every load stays
      // unconditional, so all k*k are in flight together) and takes the
      // -inf fill, which never wins a compare
      Pack<T, V> win[K][K];
#pragma unroll
      for (int jh = 0; jh < K; ++jh) {
#pragma unroll
        for (int jw = 0; jw < K; ++jw) {
          const int hh = h0 + jh;
          const int ww = w0 + jw;
          const int hc = PAD == 0 ? hh : min(max(hh, 0), h - 1);
          const int wc = PAD == 0 ? ww : min(max(ww, 0), w - 1);
          win[jh][jw] = load<T, V>(x + ((ni * h + hc) * w + wc) * c + c0);
          if (PAD != 0 && (hh != hc || ww != wc)) {
#pragma unroll
            for (int e = 0; e < V; ++e) {
              win[jh][jw].v[e] = from_f32<T>(-CUDART_INF_F);
            }
          }
        }
      }
      Pack<T, V> out;
      Pack<uint8_t, V> s;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float m = -CUDART_INF_F;
        int best = kSentinel;
        bool nan = false;
#pragma unroll
        for (int jh = 0; jh < K; ++jh) {
#pragma unroll
          for (int jw = 0; jw < K; ++jw) {
            const float v = to_f32(win[jh][jw].v[e]);
            if (v != v) {  // NaN
              nan = true;
            } else if (v > m) {  // strict: the first max in window order
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
        out.v[e] = from_f32<T>(m);
        s.v[e] = static_cast<uint8_t>(best);
      }
      const int o = ((ni * oh + t) * ow + u) * c + c0;
      store<T, V>(y + o, out);
      store<uint8_t, V>(sel + o, s);
    }
  }
}

template <typename T, int K, int PAD, int V>
__global__ void __launch_bounds__(kThreads)
    maxpool_bwd_kernel(const T* __restrict__ dy,
                       const uint8_t* __restrict__ sel, T* __restrict__ dx,
                       int n, int h, int w, int cvecs, int oh, int ow,
                       long long dy_sn, long long dy_sh, long long dy_sw) {
  // windows per axis that reach a stride cell
  constexpr int D = K == 3 ? 2 : 1;
  const int cells_h = (h + PAD + 1) >> 1;
  const int cells_w = (w + PAD + 1) >> 1;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= cells_w * cvecs) return;
  const int tw = i / cvecs;
  const int c = cvecs * V;
  const int c0 = (i - tw * cvecs) * V;
  for (int ni = blockIdx.z; ni < n; ni += gridDim.z) {
    for (int th = blockIdx.y; th < cells_h; th += gridDim.y) {
      Pack<T, V> g[D][D];
      Pack<uint8_t, V> s[D][D];
#pragma unroll
      for (int dh = 0; dh < D; ++dh) {
#pragma unroll
        for (int dw = 0; dw < D; ++dw) {
          const int t = th - dh;
          const int u = tw - dw;
          if (t >= 0 && t < oh && u >= 0 && u < ow) {
            g[dh][dw] = load<T, V>(dy + ni * dy_sn + t * dy_sh + u * dy_sw +
                                   c0);
            s[dh][dw] = load<uint8_t, V>(sel + ((ni * oh + t) * ow + u) * c +
                                         c0);
          } else {  // no window: a rank no position has
#pragma unroll
            for (int e = 0; e < V; ++e) s[dh][dw].v[e] = kSentinel;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int hh = 2 * th - PAD + a;
        if (hh < 0 || hh >= h) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int ww = 2 * tw - PAD + b;
          if (ww < 0 || ww >= w) continue;
          Pack<T, V> out;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            float acc = 0.f;
            // ascending (dh, dw) is ascending rank (a+2dh)*K + (b+2dw)
#pragma unroll
            for (int dh = 0; dh < D; ++dh) {
#pragma unroll
              for (int dw = 0; dw < D; ++dw) {
                constexpr int kNone = -1;
                const int jh = a + 2 * dh;
                const int jw = b + 2 * dw;
                const int rank = (jh < K && jw < K) ? jh * K + jw : kNone;
                if (s[dh][dw].v[e] == rank) acc += to_f32(g[dh][dw].v[e]);
              }
            }
            out.v[e] = from_f32<T>(acc);
          }
          store<T, V>(dx + ((ni * h + hh) * w + ww) * c + c0, out);
        }
      }
    }
  }
}

bool geometry_ok(int n, int h, int w, int c, int oh, int ow, int k,
                 int pad) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) {
    return false;
  }
  if (!((k == 3 && (pad == 0 || pad == 1)) || (k == 2 && pad == 0))) {
    return false;
  }
  if (oh != 1 + (h + 2 * pad - k) / 2 || ow != 1 + (w + 2 * pad - k) / 2) {
    return false;
  }
  // int indexing: every plane must stay below 2^31 elements
  const long long big = 1LL << 31;
  return static_cast<long long>(n) * h * w * c < big;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// V is 1 or 16 bytes of T, divides C, and every vector access is aligned
bool vec_ok(int vec, int esize, int c) {
  return (vec == 1 || vec * esize == 16) && c % vec == 0;
}

dim3 grid_for(int columns, int cvecs, int rows, int n) {
  return dim3((columns * cvecs + kThreads - 1) / kThreads,
              rows < kMaxGridYZ ? rows : kMaxGridYZ,
              n < kMaxGridYZ ? n : kMaxGridYZ);
}

template <typename T, int V>
void launch_fwd(const T* x, T* y, uint8_t* sel, int n, int h, int w, int c,
                int oh, int ow, int k, int pad, int relu, cudaStream_t st) {
  const int cv = c / V;
  const dim3 grid = grid_for(ow, cv, oh, n);
  if (k == 3 && pad == 0) {
    maxpool_fwd_kernel<T, 3, 0, V><<<grid, kThreads, 0, st>>>(
        x, y, sel, n, h, w, cv, oh, ow, relu);
  } else if (k == 3) {
    maxpool_fwd_kernel<T, 3, 1, V><<<grid, kThreads, 0, st>>>(
        x, y, sel, n, h, w, cv, oh, ow, relu);
  } else {
    maxpool_fwd_kernel<T, 2, 0, V><<<grid, kThreads, 0, st>>>(
        x, y, sel, n, h, w, cv, oh, ow, relu);
  }
}

template <typename T, int V>
void launch_bwd(const T* dy, const uint8_t* sel, T* dx, int n, int h, int w,
                int c, int oh, int ow, int k, int pad, long long sn,
                long long sh, long long sw, cudaStream_t st) {
  const int cv = c / V;
  const dim3 grid = grid_for((w + pad + 1) / 2, cv, (h + pad + 1) / 2, n);
  if (k == 3 && pad == 0) {
    maxpool_bwd_kernel<T, 3, 0, V><<<grid, kThreads, 0, st>>>(
        dy, sel, dx, n, h, w, cv, oh, ow, sn, sh, sw);
  } else if (k == 3) {
    maxpool_bwd_kernel<T, 3, 1, V><<<grid, kThreads, 0, st>>>(
        dy, sel, dx, n, h, w, cv, oh, ow, sn, sh, sw);
  } else {
    maxpool_bwd_kernel<T, 2, 0, V><<<grid, kThreads, 0, st>>>(
        dy, sel, dx, n, h, w, cv, oh, ow, sn, sh, sw);
  }
}

template <typename T>
int fwd(const void* x, void* y, void* sel, int n, int h, int w, int c,
        int oh, int ow, int k, int pad, int relu, int vec, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (!vec_ok(vec, sizeof(T), c) || !aligned(x, vec * sizeof(T)) ||
      !aligned(y, vec * sizeof(T)) || !aligned(sel, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xt = static_cast<const T*>(x);
  auto* yt = static_cast<T*>(y);
  auto* s = static_cast<uint8_t*>(sel);
  if (vec == kVec) {
    launch_fwd<T, kVec>(xt, yt, s, n, h, w, c, oh, ow, k, pad, relu, st);
  } else {
    launch_fwd<T, 1>(xt, yt, s, n, h, w, c, oh, ow, k, pad, relu, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* dy, const void* sel, void* dx, int n, int h, int w,
        int c, int oh, int ow, int k, int pad, long long sn, long long sh,
        long long sw, int vec, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (!vec_ok(vec, sizeof(T), c) || sn % vec || sh % vec || sw % vec ||
      !aligned(dy, vec * sizeof(T)) || !aligned(dx, vec * sizeof(T)) ||
      !aligned(sel, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* g = static_cast<const T*>(dy);
  const auto* s = static_cast<const uint8_t*>(sel);
  auto* d = static_cast<T*>(dx);
  if (vec == kVec) {
    launch_bwd<T, kVec>(g, s, d, n, h, w, c, oh, ow, k, pad, sn, sh, sw, st);
  } else {
    launch_bwd<T, 1>(g, s, d, n, h, w, c, oh, ow, k, pad, sn, sh, sw, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the forward on ``stream`` and returns cudaGetLastError() after
// the launch (0 on success).  x (n, h, w, c) contiguous; the caller
// allocates y (n, oh, ow, c) of x's type and sel (n, oh, ow, c) uint8.
// ``vec`` channels per thread: 1, or 16 bytes of them where c and every
// pointer allow it (an invalid argument error otherwise).
extern "C" int ff_maxpool_fwd(const void* x, void* y, void* sel, int n,
                              int h, int w, int c, int oh, int ow, int k,
                              int pad, int relu, int is_bf16, int vec,
                              void* stream) {
  if (!geometry_ok(n, h, w, c, oh, ow, k, pad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<__nv_bfloat16>(x, y, sel, n, h, w, c, oh, ow, k, pad,
                                      relu, vec, st)
                 : fwd<float>(x, y, sel, n, h, w, c, oh, ow, k, pad, relu,
                              vec, st);
}

// Launches the backward on ``stream`` and returns cudaGetLastError()
// after the launch.  dy (n, oh, ow, c) with unit channel stride and the
// given n, h, w strides (in elements); sel (n, oh, ow, c) uint8
// contiguous; the caller allocates dx (n, h, w, c) of dy's type.  ``vec``
// as for the forward, and it must divide dy's strides too.
extern "C" int ff_maxpool_bwd(const void* dy, const void* sel, void* dx,
                              int n, int h, int w, int c, int oh, int ow,
                              int k, int pad, long long dy_sn,
                              long long dy_sh, long long dy_sw, int is_bf16,
                              int vec, void* stream) {
  if (!geometry_ok(n, h, w, c, oh, ow, k, pad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd<__nv_bfloat16>(dy, sel, dx, n, h, w, c, oh, ow, k,
                                      pad, dy_sn, dy_sh, dy_sw, vec, st)
                 : bwd<float>(dy, sel, dx, n, h, w, c, oh, ow, k, pad, dy_sn,
                              dy_sh, dy_sw, vec, st);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
