// Fused batch-norm normalize + ReLU for Hopper (sm_90a), plain CUDA C++
// with a C interface (loaded with ctypes by
// flexflow_tpu_torch/ops/kernels/bn_act.py).
//
// Replaces flexflow_tpu/ops/pallas/bn_act.py: _fwd_kernel (kernel 9) and
// _bwd_kernel (kernel 10), the Pallas TPU pair that _make_bn_act's
// fwd_call and bwd_call launch.  Over x flattened to (M, C), channels
// fastest, with BatchNorm's folded per-channel float32 vectors inv and
// shift:
//
//     forward   y = relu(x*inv + shift)                   f32, cast once
//     backward  g' = g where x*inv + shift > 0, else 0    mask recomputed
//               dx = g'*inv (cast to x's type),
//               d_inv = sum over M of g'*x,  d_shift = sum over M of g'
//
// x*inv + shift is a rounded multiply, then a rounded add (__fmul_rn,
// __fadd_rn), never a contracted FMA: the forward then equals the plain
// version (aten's separate mul and add) bit for bit, and the backward's
// mask equals the forward's where the pre-activation is near 0.
//
// What bounds it on an H100: a few flops per element, so memory.  The
// forward reads x and writes y; the backward reads x and g and writes dx.
// DenseNet-121's 117 BNs per step at batch 64 in bf16 move 0.91 G
// elements: 3.6 GB forward, 5.5 GB backward, 1.09 and 1.63 ms at
// 3.35 TB/s.
//
// Design.  Both kernels tile (M, C) alike.  A block of 256 threads is TX
// column threads by TY row threads.  A column thread owns V adjacent
// channels: V = 8 bf16 or 4 float32 (one 16-byte load) where C % V == 0
// and the rows are 16-byte aligned, else V = 1.  It keeps their inv and
// shift in registers and walks its block's rows TY apart, kUnroll rows at
// a time with all their loads issued first.  The Pallas backward sums
// d_inv and d_shift by revisiting a (1, C) block over a sequential row
// grid; Hopper's blocks run in no order.  Here each block adds its row
// threads' sums in shared memory and writes them as one row of a
// (row blocks, C) float32 workspace; a second small kernel
// (bn_act_sum_kernel) adds the workspace's rows in a fixed order.  No
// atomics: the sums are the same in every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;
constexpr int kUnroll = 4;
constexpr int kSumChannels = 32;  // bn_act_sum_kernel: channels per block
constexpr int kSumLanes = 16;     // ... and threads per channel

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

// the pre-activation, rounded after the multiply and after the add
__device__ __forceinline__ float pre_act(float x, float inv, float shift) {
  return __fadd_rn(__fmul_rn(x, inv), shift);
}

template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_act_fwd_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                      const float* __restrict__ shift, T* __restrict__ y,
                      long long m, int c, int rows_per_block) {
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (col >= c) return;
  float a[V], b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    a[v] = inv[col + v];
    b[v] = shift[col + v];
  }
  const int ty = blockDim.y;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(m, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.y; r < r1; r += kUnroll * ty) {
    Pack<T, V> p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + static_cast<long long>(u) * ty;
      if (ru < r1) {
        p[u] = *reinterpret_cast<const Pack<T, V>*>(x + ru * c + col);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long ru = r + static_cast<long long>(u) * ty;
      if (ru < r1) {
        Pack<T, V> q;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float s = pre_act(to_f32(p[u].v[v]), a[v], b[v]);
          if (kRelu) s = s < 0.f ? 0.f : s;  // NaN passes, as in torch.relu
          q.v[v] = from_f32<T>(s);
        }
        *reinterpret_cast<Pack<T, V>*>(y + ru * c + col) = q;
      }
    }
  }
}

template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
    bn_act_bwd_kernel(const T* __restrict__ x, const float* __restrict__ inv,
                      const float* __restrict__ shift,
                      const T* __restrict__ g, T* __restrict__ dx,
                      float* __restrict__ part_inv,
                      float* __restrict__ part_shift, long long m, int c,
                      int rows_per_block) {
  __shared__ float s_inv[kThreads * kMaxVec];
  __shared__ float s_shift[kThreads * kMaxVec];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int width = blockDim.x * V;  // channels of this block
  const int c0 = blockIdx.y * width;
  const int col = c0 + tx * V;
  float acc_inv[V], acc_shift[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc_inv[v] = 0.f;
    acc_shift[v] = 0.f;
  }
  if (col < c) {
    float a[V], b[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      a[v] = inv[col + v];
      b[v] = shift[col + v];
    }
    const int rows = blockDim.y;
    const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
    const long long r1 = min(m, r0 + rows_per_block);
    for (long long r = r0 + ty; r < r1; r += kUnroll * rows) {
      Pack<T, V> px[kUnroll], pg[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + static_cast<long long>(u) * rows;
        if (ru < r1) {
          px[u] = *reinterpret_cast<const Pack<T, V>*>(x + ru * c + col);
          pg[u] = *reinterpret_cast<const Pack<T, V>*>(g + ru * c + col);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long ru = r + static_cast<long long>(u) * rows;
        if (ru < r1) {
          Pack<T, V> q;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float xf = to_f32(px[u].v[v]);
            float gf = to_f32(pg[u].v[v]);
            if (kRelu && !(pre_act(xf, a[v], b[v]) > 0.f)) gf = 0.f;
            q.v[v] = from_f32<T>(__fmul_rn(gf, a[v]));
            acc_inv[v] += gf * xf;
            acc_shift[v] += gf;
          }
          *reinterpret_cast<Pack<T, V>*>(dx + ru * c + col) = q;
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s_inv[ty * width + tx * V + v] = acc_inv[v];
    s_shift[ty * width + tx * V + v] = acc_shift[v];
  }
  __syncthreads();
  // one thread per channel of the block adds the row threads' sums in
  // order and writes the block's row of the workspace
  for (int t = ty * blockDim.x + tx; t < width;
       t += blockDim.x * blockDim.y) {
    if (c0 + t < c) {
      float si = 0.f, ss = 0.f;
      for (int k = 0; k < static_cast<int>(blockDim.y); ++k) {
        si += s_inv[k * width + t];
        ss += s_shift[k * width + t];
      }
      part_inv[static_cast<long long>(blockIdx.x) * c + c0 + t] = si;
      part_shift[static_cast<long long>(blockIdx.x) * c + c0 + t] = ss;
    }
  }
}

// d_inv[ch], d_shift[ch]: the p workspace rows of channel ch added in a
// fixed order — kSumLanes threads each take every kSumLanes-th row, then
// one adds the lanes in turn
__global__ void __launch_bounds__(kSumChannels * kSumLanes)
    bn_act_sum_kernel(const float* __restrict__ part_inv,
                      const float* __restrict__ part_shift,
                      float* __restrict__ d_inv, float* __restrict__ d_shift,
                      int p, int c) {
  __shared__ float s_inv[kSumLanes][kSumChannels + 1];
  __shared__ float s_shift[kSumLanes][kSumChannels + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int ch = blockIdx.x * kSumChannels + tx;
  float si = 0.f, ss = 0.f;
  if (ch < c) {
    for (int i = ty; i < p; i += kSumLanes) {
      si += part_inv[static_cast<long long>(i) * c + ch];
      ss += part_shift[static_cast<long long>(i) * c + ch];
    }
  }
  s_inv[ty][tx] = si;
  s_shift[ty][tx] = ss;
  __syncthreads();
  if (ty == 0 && ch < c) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < kSumLanes; ++k) {
      a += s_inv[k][tx];
      b += s_shift[k][tx];
    }
    d_inv[ch] = a;
    d_shift[ch] = b;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// The grid of an (m, c) tiling with column threads of vec channels, or
// false for arguments the kernels do not take.
bool make_grid(long long m, int c, int vec, int tx, int ty,
               int rows_per_block, int esize, dim3* grid, dim3* block) {
  if (m <= 0 || c <= 0 || tx <= 0 || ty <= 0 || tx * ty > kThreads ||
      rows_per_block <= 0) {
    return false;
  }
  if (vec != 1 && (vec * esize != 16 || c % vec != 0)) return false;
  const long long row_blocks = (m + rows_per_block - 1) / rows_per_block;
  const long long ctiles = (c / vec + tx - 1) / tx;
  if (row_blocks > 0x7fffffffLL || ctiles > 65535) return false;
  *grid = dim3(static_cast<unsigned>(row_blocks),
               static_cast<unsigned>(ctiles));
  *block = dim3(tx, ty);
  return true;
}

template <typename T, int V>
void launch_fwd(const void* x, const void* inv, const void* shift, void* y,
                long long m, int c, int rows_per_block, bool relu, dim3 grid,
                dim3 block, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const float* it = static_cast<const float*>(inv);
  const float* sh = static_cast<const float*>(shift);
  T* yt = static_cast<T*>(y);
  if (relu) {
    bn_act_fwd_kernel<T, V, true>
        <<<grid, block, 0, st>>>(xt, it, sh, yt, m, c, rows_per_block);
  } else {
    bn_act_fwd_kernel<T, V, false>
        <<<grid, block, 0, st>>>(xt, it, sh, yt, m, c, rows_per_block);
  }
}

template <typename T, int V>
void launch_bwd(const void* x, const void* inv, const void* shift,
                const void* g, void* dx, float* part_inv, float* part_shift,
                long long m, int c, int rows_per_block, bool relu, dim3 grid,
                dim3 block, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const float* it = static_cast<const float*>(inv);
  const float* sh = static_cast<const float*>(shift);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  if (relu) {
    bn_act_bwd_kernel<T, V, true><<<grid, block, 0, st>>>(
        xt, it, sh, gt, dxt, part_inv, part_shift, m, c, rows_per_block);
  } else {
    bn_act_bwd_kernel<T, V, false><<<grid, block, 0, st>>>(
        xt, it, sh, gt, dxt, part_inv, part_shift, m, c, rows_per_block);
  }
}

}  // namespace

// Kernel 9.  x and the caller-allocated y are (m, c) row-major of one type
// (float32, or bf16 when is_bf16); inv and shift (c,) float32.  The block
// is tx by ty threads, each column thread owning vec channels (1, or 16
// bytes of them: then c % vec == 0 and x, y 16-byte aligned); a block
// covers rows_per_block rows.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int ff_bn_act_fwd(const void* x, const void* inv,
                             const void* shift, void* y, long long m, int c,
                             int vec, int tx, int ty, int rows_per_block,
                             int relu, int is_bf16, void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  dim3 grid, block;
  if (!make_grid(m, c, vec, tx, ty, rows_per_block, esize, &grid, &block) ||
      (vec != 1 && !(aligned16(x) && aligned16(y)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && vec == 8) {
    launch_fwd<__nv_bfloat16, 8>(x, inv, shift, y, m, c, rows_per_block,
                                 relu, grid, block, st);
  } else if (is_bf16) {
    launch_fwd<__nv_bfloat16, 1>(x, inv, shift, y, m, c, rows_per_block,
                                 relu, grid, block, st);
  } else if (vec == 4) {
    launch_fwd<float, 4>(x, inv, shift, y, m, c, rows_per_block, relu, grid,
                         block, st);
  } else {
    launch_fwd<float, 1>(x, inv, shift, y, m, c, rows_per_block, relu, grid,
                         block, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 10, first pass: dx (m, c) of x's type, and one row of float32
// sums per block of rows into part_inv and part_shift, each
// (ceil(m / rows_per_block), c).  x, g and dx share a type and the tiling
// arguments of ff_bn_act_fwd (vec > 1 also needs g and dx aligned).
extern "C" int ff_bn_act_bwd_partial(const void* x, const void* inv,
                                     const void* shift, const void* g,
                                     void* dx, void* part_inv,
                                     void* part_shift, long long m, int c,
                                     int vec, int tx, int ty,
                                     int rows_per_block, int relu,
                                     int is_bf16, void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  dim3 grid, block;
  if (!make_grid(m, c, vec, tx, ty, rows_per_block, esize, &grid, &block) ||
      (vec != 1 && !(aligned16(x) && aligned16(g) && aligned16(dx)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pi = static_cast<float*>(part_inv);
  float* ps = static_cast<float*>(part_shift);
  if (is_bf16 && vec == 8) {
    launch_bwd<__nv_bfloat16, 8>(x, inv, shift, g, dx, pi, ps, m, c,
                                 rows_per_block, relu, grid, block, st);
  } else if (is_bf16) {
    launch_bwd<__nv_bfloat16, 1>(x, inv, shift, g, dx, pi, ps, m, c,
                                 rows_per_block, relu, grid, block, st);
  } else if (vec == 4) {
    launch_bwd<float, 4>(x, inv, shift, g, dx, pi, ps, m, c, rows_per_block,
                         relu, grid, block, st);
  } else {
    launch_bwd<float, 1>(x, inv, shift, g, dx, pi, ps, m, c, rows_per_block,
                         relu, grid, block, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel 10, finishing pass: d_inv and d_shift (c,) float32, the sums of
// the p rows of part_inv and part_shift (p, c) float32.
extern "C" int ff_bn_act_bwd_sum(const void* part_inv, const void* part_shift,
                                 void* d_inv, void* d_shift, int p, int c,
                                 void* stream) {
  if (p <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + kSumChannels - 1) / kSumChannels);
  const dim3 block(kSumChannels, kSumLanes);
  bn_act_sum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_inv),
      static_cast<const float*>(part_shift), static_cast<float*>(d_inv),
      static_cast<float*>(d_shift), p, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
