// Fused vocab projection + softmax cross-entropy for Hopper (sm_90a), plain
// CUDA C++ with a C interface (loaded with ctypes by flexflow_tpu_torch/
// ops/kernels/fused_ce.py).
//
// Replaces the three Pallas TPU kernels of flexflow_tpu/ops/pallas/
// fused_ce.py: _fwd_kernel (forward), _bwd_dx_kernel (dx) and
// _bwd_dw_kernel (dw, db); the two backward kernels share _tile_dlogits.
// With logits = x w + b (x (N, d), w (d, V), b (V,) float32, labels (N,)
// int32), per token row n:
//     lse_n = log sum_v exp(logits_nv)
//     nll_n = lse_n - logits_n,label_n    (a label < 0 or >= V matches
//                                          nothing: nll_n = lse_n)
// and, for a cotangent g (N,) of nll,
//     t_nv = g_n * (exp(logits_nv - lse_n) - [v == label_n])
//     dx = t w^T,   dw = x^T t,   db = sum_n t_nv.
// The (N, V) logits never reach device memory: every kernel recomputes
// its logits tiles from x and w.  x and w are float32 or bfloat16 (one
// dtype), every sum is float32, and the outputs are float32.  With
// bfloat16 inputs t is rounded to bfloat16 before the dx and dw products,
// as the Pallas kernels cast it to the operand dtype; db sums it unrounded.
//
// What bounds it on an H100: at the LM training shape (N = 16 x 512 =
// 8192 tokens, d 768, V 32768) the forward is 2*N*d*V = 412 GFLOP against
// ~126 MB of inputs (6.2 ms at the card's 67 TFLOP/s float32 rate outside
// the tensor cores, 0.04 ms at 3.35 TB/s), and each backward kernel twice
// that (the logits recomputed, then one product): bound by operations.
//
// Design, simple and right first.  The Pallas grids carry the running
// max / sum / correct logit, the dx block and the dw block across their
// innermost axis in VMEM scratch; blocks on Hopper run in no order, so
// that axis becomes a loop inside one block:
//   * forward and dx: one block of 256 threads per 64 token rows loops
//     over the 64-wide vocab tiles; dw/db: one block per 64-wide vocab
//     tile loops over the 64-row token blocks;
//   * each 64 x 64 logits tile is a shared-memory tiled product over d in
//     steps of 32, a 4 x 4 register micro-tile per thread;
//   * the forward keeps a running max (all-reduced over the 16 threads of
//     a row with warp shuffles), per-thread partial sums rescaled to it,
//     and the correct logit, reduced once at the end;
//   * dx and dw stage the t tile in shared memory and multiply it with 64
//     rows of w (dx) or 64 columns of x (dw) at a time; each block owns
//     its rows of dx (columns of dw) alone, so it accumulates them in
//     place in device memory (L2-resident), with no atomics and no limit
//     on d from the shared memory;
//   * the ragged edges (rows >= N, columns >= V, depth >= d) are masked,
//     not padded.
// The float32 FMA rate and shared-memory bandwidth are the limits this
// design leaves; tensor cores (mma.sync / wgmma), TMA staging and more
// blocks for the row-parallel kernels at small N are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;        // token rows per tile
constexpr int kBV = 64;        // vocab columns per tile
constexpr int kBD = 32;        // depth of one step of the logits product
constexpr int kDC = 64;        // depth rows of w (dx) / x columns (dw) per step
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// t = g (softmax - onehot) for this thread's 4 x 4 entries of the tile
// (rows n0 + ti + 16a, columns v0 + tj + 16b), 0 outside the matrix
__device__ __forceinline__ void dlogits(float acc[4][4], int n0, int v0,
                                        int n, int V,
                                        const float* __restrict__ bias,
                                        const float row_lse[4],
                                        const float row_g[4],
                                        const int row_lab[4]) {
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int col = v0 + tj + 16 * b;
    const float bc = col < V ? bias[col] : 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = n0 + ti + 16 * a;
      const bool valid = row < n && col < V;
      const float p = valid ? expf(acc[a][b] + bc - row_lse[a]) : 0.f;
      const float onehot = (valid && col == row_lab[a]) ? 1.f : 0.f;
      acc[a][b] = row_g[a] * p - row_g[a] * onehot;
    }
  }
}

__device__ __forceinline__ void load_row_stats(int n0, int n,
                                               const int32_t* labels,
                                               const float* lse,
                                               const float* g,
                                               float row_lse[4],
                                               float row_g[4],
                                               int row_lab[4]) {
  const int ti = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = n0 + ti + 16 * a;
    const bool in = row < n;
    row_lse[a] = in ? lse[row] : 0.f;
    row_g[a] = in ? g[row] : 0.f;
    row_lab[a] = in ? labels[row] : -1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias,
                     const int32_t* __restrict__ labels,
                     const float* __restrict__ lse,
                     const float* __restrict__ g, float* __restrict__ dx,
                     int n, int d, int V) {
  __shared__ union {
    GemmSmem gemm;
    float wc[kDC][kBV + 1];  // w[c0 + c][v0 + j]
  } sm;
  __shared__ float t_s[kBN][kBV + 1];
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  const int n0 = blockIdx.x * kBN;

  float row_lse[4], row_g[4];
  int row_lab[4];
  load_row_stats(n0, n, labels, lse, g, row_lse, row_g, row_lab);

  for (int v0 = 0; v0 < V; v0 += kBV) {
    float acc[4][4];
    logits_tile<T>(sm.gemm, x, w, n0, v0, n, d, V, acc);
    dlogits(acc, n0, v0, n, V, bias, row_lse, row_g, row_lab);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        t_s[ti + 16 * a][tj + 16 * b] = round_to<T>(acc[a][b]);
      }
    }
    // dx[rows, c0:c0+64] += t . w[c0:c0+64, v0:v0+64]^T
    for (int c0 = 0; c0 < d; c0 += kDC) {
      __syncthreads();  // t_s written; the previous w rows consumed
      for (int e = threadIdx.x; e < kDC * kBV; e += kThreads) {
        const int r = e / kBV;
        const int j = e % kBV;
        const int c = c0 + r;
        const int col = v0 + j;
        sm.wc[r][j] = (c < d && col < V)
                          ? to_f32(w[static_cast<size_t>(c) * V + col])
                          : 0.f;
      }
      __syncthreads();
      float part[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int m = 0; m < 4; ++m) part[a][m] = 0.f;
      }
#pragma unroll 8
      for (int j = 0; j < kBV; ++j) {
        float ta[4], wm[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ta[a] = t_s[ti + 16 * a][j];
#pragma unroll
        for (int m = 0; m < 4; ++m) wm[m] = sm.wc[tj + 16 * m][j];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int m = 0; m < 4; ++m) part[a][m] = fmaf(ta[a], wm[m], part[a][m]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = n0 + ti + 16 * a;
        if (row >= n) continue;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int c = c0 + tj + 16 * m;
          if (c >= d) continue;
          float* out = dx + static_cast<size_t>(row) * d + c;
          *out = v0 == 0 ? part[a][m] : *out + part[a][m];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias,
                     const int32_t* __restrict__ labels,
                     const float* __restrict__ lse,
                     const float* __restrict__ g, float* __restrict__ dw,
                     float* __restrict__ db, int n, int d, int V) {
  __shared__ union {
    GemmSmem gemm;
    float xc[kBN][kDC + 1];  // x[n0 + i][c0 + c]
    float red[16][kBV];      // db partial sums by ti, at the end
  } sm;
  __shared__ float t_s[kBN][kBV + 1];
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  const int v0 = blockIdx.x * kBV;

  float db_part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < n; n0 += kBN) {
    float row_lse[4], row_g[4];
    int row_lab[4];
    load_row_stats(n0, n, labels, lse, g, row_lse, row_g, row_lab);
    float acc[4][4];
    logits_tile<T>(sm.gemm, x, w, n0, v0, n, d, V, acc);
    dlogits(acc, n0, v0, n, V, bias, row_lse, row_g, row_lab);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        db_part[b] += acc[a][b];
        t_s[ti + 16 * a][tj + 16 * b] = round_to<T>(acc[a][b]);
      }
    }
    // dw[c0:c0+64, columns] += x[rows, c0:c0+64]^T . t; thread (tc, tj)
    // owns depth rows tc + 16m and columns tj + 16b
    const int tc = ti;
    for (int c0 = 0; c0 < d; c0 += kDC) {
      __syncthreads();  // t_s written; the previous x columns consumed
      for (int e = threadIdx.x; e < kBN * kDC; e += kThreads) {
        const int i = e / kDC;
        const int c = e % kDC;
        const int row = n0 + i;
        const int col = c0 + c;
        sm.xc[i][c] = (row < n && col < d)
                          ? to_f32(x[static_cast<size_t>(row) * d + col])
                          : 0.f;
      }
      __syncthreads();
      float part[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int b = 0; b < 4; ++b) part[m][b] = 0.f;
      }
#pragma unroll 8
      for (int i = 0; i < kBN; ++i) {
        float xm[4], tb[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) xm[m] = sm.xc[i][tc + 16 * m];
#pragma unroll
        for (int b = 0; b < 4; ++b) tb[b] = t_s[i][tj + 16 * b];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int b = 0; b < 4; ++b) part[m][b] = fmaf(xm[m], tb[b], part[m][b]);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c = c0 + tc + 16 * m;
        if (c >= d) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = v0 + tj + 16 * b;
          if (col >= V) continue;
          float* out = dw + static_cast<size_t>(c) * V + col;
          *out = n0 == 0 ? part[m][b] : *out + part[m][b];
        }
      }
    }
  }

  // db: the 16 partial sums of each column, added in ti order
  __syncthreads();
#pragma unroll
  for (int b = 0; b < 4; ++b) sm.red[ti][tj + 16 * b] = db_part[b];
  __syncthreads();
  if (threadIdx.x < kBV) {
    const int col = v0 + static_cast<int>(threadIdx.x);
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) s += sm.red[r][threadIdx.x];
    if (col < V) db[col] = s;
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

// dx (n, d) float32, every element written.  Launches on ``stream`` and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int ff_fused_ce_bwd_dx(const void* x, const void* w,
                                  const void* bias, const void* labels,
                                  const void* lse, const void* g, void* dx,
                                  int n, int d, int V, int is_bf16,
                                  void* stream) {
  if (bad_dims(n, d, V)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || d == 0) return 0;
  const dim3 grid((n + kBN - 1) / kBN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  if (is_bf16) {
    ce_bwd_dx_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), b, lab, l, gg,
        static_cast<float*>(dx), n, d, V);
  } else {
    ce_bwd_dx_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b, lab, l,
        gg, static_cast<float*>(dx), n, d, V);
  }
  return static_cast<int>(cudaGetLastError());
}

// dw (d, V) and db (V,) float32, every element written (the caller passes
// n > 0).  Launches on ``stream`` and returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int ff_fused_ce_bwd_dw(const void* x, const void* w,
                                  const void* bias, const void* labels,
                                  const void* lse, const void* g, void* dw,
                                  void* db, int n, int d, int V, int is_bf16,
                                  void* stream) {
  if (bad_dims(n, d, V) || n == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((V + kBV - 1) / kBV);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  if (is_bf16) {
    ce_bwd_dw_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), b, lab, l, gg,
        static_cast<float*>(dw), static_cast<float*>(db), n, d, V);
  } else {
    ce_bwd_dw_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b, lab, l,
        gg, static_cast<float*>(dw), static_cast<float*>(db), n, d, V);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
