// Fused vocab projection + softmax cross-entropy forward for Hopper
// (sm_90a), plain CUDA C++ with a C interface (loaded with ctypes by
// flexflow_tpu_torch/ops/kernels/fused_ce.py).
//
// Replaces the Pallas TPU kernel _fwd_kernel of flexflow_tpu/ops/pallas/
// fused_ce.py; the backward kernels (_bwd_dx_kernel, _bwd_dw_kernel) are
// in fused_ce_bwd.cu.  With logits = x w + b (x (N, d), w (d, V), b (V,)
// float32, labels (N,) int32), per token row n:
//     lse_n = log sum_v exp(logits_nv)
//     nll_n = lse_n - logits_n,label_n    (a label < 0 or >= V matches
//                                          nothing: nll_n = lse_n)
// The (N, V) logits never reach device memory: the kernel recomputes its
// logits tiles from x and w.  x and w are float32 or bfloat16 (one
// dtype), every sum is float32, and the outputs are float32.
//
// What bounds it on an H100: at the LM training shape (N = 16 x 512 =
// 8192 tokens, d 768, V 32768) the forward is 2*N*d*V = 412 GFLOP against
// ~126 MB of inputs (6.2 ms at the card's 67 TFLOP/s float32 rate outside
// the tensor cores, 0.04 ms at 3.35 TB/s): bound by operations.
//
// Design, simple and right first.  The Pallas grid carries the running
// max / sum / correct logit across its innermost axis in VMEM scratch;
// blocks on Hopper run in no order, so that axis becomes a loop inside one
// block:
//   * one block of 256 threads per 64 token rows loops over the 64-wide
//     vocab tiles;
//   * each 64 x 64 logits tile is a shared-memory tiled product over d in
//     steps of 32, a 4 x 4 register micro-tile per thread;
//   * the kernel keeps a running max (all-reduced over the 16 threads of
//     a row with warp shuffles), per-thread partial sums rescaled to it,
//     and the correct logit, reduced once at the end;
//   * the ragged edges (rows >= N, columns >= V, depth >= d) are masked,
//     not padded.
// The float32 FMA rate and shared-memory bandwidth are the limits this
// design leaves; fused_ce_bwd.cu's tensor-core main loop is its successor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;        // token rows per tile
constexpr int kBV = 64;        // vocab columns per tile
constexpr int kBD = 32;        // depth of one step of the logits product
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct GemmSmem {
  float x[kBN][kBD + 1];
  float w[kBD][kBV];
};

// acc[a][b] = sum_k x[n0 + ti + 16a][k] * w[k][v0 + tj + 16b] over the
// whole depth d; ragged rows, columns and depth read as 0.  Starts with a
// barrier, so the caller may reuse the shared memory it aliases.
template <typename T>
__device__ __forceinline__ void logits_tile(GemmSmem& sm,
                                            const T* __restrict__ x,
                                            const T* __restrict__ w, int n0,
                                            int v0, int n, int d, int V,
                                            float acc[4][4]) {
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }
  for (int k0 = 0; k0 < d; k0 += kBD) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBN * kBD; e += kThreads) {
      const int r = e / kBD;
      const int c = e % kBD;
      const int row = n0 + r;
      const int col = k0 + c;
      sm.x[r][c] = (row < n && col < d)
                       ? to_f32(x[static_cast<size_t>(row) * d + col])
                       : 0.f;
    }
    for (int e = threadIdx.x; e < kBD * kBV; e += kThreads) {
      const int r = e / kBV;
      const int c = e % kBV;
      const int kk = k0 + r;
      const int col = v0 + c;
      sm.w[r][c] = (kk < d && col < V)
                       ? to_f32(w[static_cast<size_t>(kk) * V + col])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBD; ++kk) {
      float xa[4], wb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xa[a] = sm.x[ti + 16 * a][kk];
#pragma unroll
      for (int b = 0; b < 4; ++b) wb[b] = sm.w[kk][tj + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xa[a], wb[b], acc[a][b]);
      }
    }
  }
}

// all-reduce over the 16 threads (tj = 0..15) that share a row: they are
// one half of a warp
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias,
                  const int32_t* __restrict__ labels,
                  float* __restrict__ nll, float* __restrict__ lse, int n,
                  int d, int V) {
  __shared__ GemmSmem sm;
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  const int n0 = blockIdx.x * kBN;

  int lab[4];
  float m[4], l[4], corr[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = n0 + ti + 16 * a;
    lab[a] = row < n ? labels[row] : -1;
    m[a] = -CUDART_INF_F;
    l[a] = 0.f;
    corr[a] = 0.f;
  }

  for (int v0 = 0; v0 < V; v0 += kBV) {
    float acc[4][4];
    logits_tile<T>(sm, x, w, n0, v0, n, d, V, acc);
    float bcol[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = v0 + tj + 16 * b;
      bcol[b] = col < V ? bias[col] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float tile_max = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = v0 + tj + 16 * b;
        const float s = col < V ? acc[a][b] + bcol[b] : -CUDART_INF_F;
        acc[a][b] = s;
        tile_max = fmaxf(tile_max, s);
        if (col < V && col == lab[a]) corr[a] += s;
      }
      // the tile holds at least one column < V, so m_new is finite
      const float m_new = fmaxf(m[a], row_max(tile_max));
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) sum += expf(acc[a][b] - m_new);
      l[a] = l[a] * expf(m[a] - m_new) + sum;  // 0 * 0 on the first tile
      m[a] = m_new;
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float tot = row_sum(l[a]);
    const float c = row_sum(corr[a]);
    const int row = n0 + ti + 16 * a;
    if (tj == 0 && row < n) {
      const float L = m[a] + logf(fmaxf(tot, 1e-30f));
      lse[row] = L;
      nll[row] = L - c;
    }
  }
}

bool bad_dims(int n, int d, int V) {
  return n < 0 || d < 0 || V <= 0;
}

}  // namespace

// nll, lse (n,) float32.  Launches on ``stream`` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ff_fused_ce_fwd(const void* x, const void* w, const void* bias,
                               const void* labels, void* nll, void* lse,
                               int n, int d, int V, int is_bf16,
                               void* stream) {
  if (bad_dims(n, d, V)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const dim3 grid((n + kBN - 1) / kBN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  if (is_bf16) {
    ce_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), b, lab,
        static_cast<float*>(nll), static_cast<float*>(lse), n, d, V);
  } else {
    ce_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b, lab,
        static_cast<float*>(nll), static_cast<float*>(lse), n, d, V);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
