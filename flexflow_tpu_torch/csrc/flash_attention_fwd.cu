// Flash-attention forward for Hopper (sm_90a), plain CUDA C++ with a C
// interface (loaded with ctypes by flexflow_tpu_torch/ops/kernels/
// flash_attention.py).
//
// Replaces flexflow_tpu/ops/pallas/flash_attention.py:_fwd_kernel, the
// Pallas TPU kernel that _fwd_call launches.  For each (batch*head) and
// query row i it computes
//     s_ij  = (q_i . k_j) * scale, masked where j >= sk or (causal, j > i)
//     o_i   = sum_j softmax(s_i)_j v_j              (float32)
//     lse_i = log sum_j exp(s_ij)                   (float32)
// with a fully masked row giving o_i = 0 and lse_i = -inf, as the Pallas
// kernel does.  q, k, v are float32 or bfloat16, (B*H, S, d) contiguous;
// all arithmetic is float32.
//
// What bounds it on an H100: at the serving shape (B 8, H 12, S 512,
// d 64, causal, float32) the work is about 3.2 GFLOP (4*d per unmasked
// score) against about 50 MB of inputs and outputs.  At the card's
// 67 TFLOP/s float32 rate outside the tensor cores that is 48 us of
// arithmetic against 15 us of memory traffic at 3.35 TB/s, so the kernel
// is bound by operations.
//
// Design, simple and right first:
//   * one thread block per (batch*head, 64-row Q tile), one thread per
//     query row; the row's q, its output accumulator and its running
//     max and denominator live in registers;
//   * a loop over 32-key K/V tiles staged in shared memory as float32;
//     every thread reads the same key at the same time, a broadcast with
//     no bank conflicts, so each fused multiply-add costs at most one
//     shared load (four with a 16-byte load);
//   * K/V tiles wholly above the causal diagonal of the Q tile are never
//     loaded; the ragged edge (j >= sk) is masked, not padded;
//   * the scores never leave registers, so device memory sees the
//     inputs (re-read from L2 by each Q tile) and the outputs once.
// The float32 FMA rate is the limit this design leaves; tensor cores
// (mma.sync / wgmma) and TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockQ = 64;  // query rows per block, one thread each
constexpr int kBlockK = 32;  // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int causal,
                     float scale) {
  __shared__ __align__(16) float k_tile[kBlockK][D];
  __shared__ __align__(16) float v_tile[kBlockK][D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int row = q0 + static_cast<int>(threadIdx.x);
  const bool live = row < sq;

  const T* q_bh = q + static_cast<size_t>(bh) * sq * D;
  const T* k_bh = k + static_cast<size_t>(bh) * sk * D;
  const T* v_bh = v + static_cast<size_t>(bh) * sk * D;

  float q_row[D];
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    q_row[c] = live ? to_f32(q_bh[static_cast<size_t>(row) * D + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F;
  float l = 0.f;

  // keys past the last row of this Q tile are masked for every row of it
  const int k_end = causal ? min(sk, q0 + kBlockQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBlockK * D; i += kBlockQ) {
      const int r = i / D;
      const int c = i % D;
      const int key = k0 + r;
      const bool in = key < sk;
      k_tile[r][c] = in ? to_f32(k_bh[static_cast<size_t>(key) * D + c]) : 0.f;
      v_tile[r][c] = in ? to_f32(v_bh[static_cast<size_t>(key) * D + c]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;

    float s[kBlockK];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(q_row[c], k_tile[j][c], dot);
      const int key = k0 + j;
      const bool valid = key < sk && (!causal || key <= row);
      s[j] = valid ? dot * scale : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new == -CUDART_INF_F) continue;  // no unmasked key yet
    const float corr = expf(m - m_new);     // 0 while m is still -inf
    l *= corr;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);  // a masked score gives 0
      l += p;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, v_tile[j][c], acc[c]);
    }
    m = m_new;
  }
  if (!live) return;

  const float denom = fmaxf(l, 1e-30f);
  float* o_row = o + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) o_row[c] = acc[c] / denom;
  lse[static_cast<size_t>(bh) * sq + row] =
      m == -CUDART_INF_F ? -CUDART_INF_F : m + logf(denom);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, float* o,
                   float* lse, int bh, int sq, int sk, int causal,
                   int is_bf16, float scale, cudaStream_t stream) {
  const dim3 grid(bh, (sq + kBlockQ - 1) / kBlockQ);
  if (is_bf16) {
    flash_fwd_kernel<__nv_bfloat16, D><<<grid, kBlockQ, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), o, lse, sq, sk, causal, scale);
  } else {
    flash_fwd_kernel<float, D><<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), o, lse, sq, sk, causal, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on ``stream`` and returns cudaGetLastError() after
// the launch (0 on success).  The caller allocates o (bh, sq, d) and
// lse (bh, sq), both float32.
extern "C" int ff_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bh, int sq, int sk, int d,
                                      int causal, int is_bf16, float scale,
                                      void* stream) {
  if (bh < 0 || sq < 0 || sk < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || sq == 0) return 0;
  if ((sq + kBlockQ - 1) / kBlockQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d) {
    case 8:
      err = launch<8>(q, k, v, of, lf, bh, sq, sk, causal, is_bf16, scale, st);
      break;
    case 16:
      err = launch<16>(q, k, v, of, lf, bh, sq, sk, causal, is_bf16, scale, st);
      break;
    case 32:
      err = launch<32>(q, k, v, of, lf, bh, sq, sk, causal, is_bf16, scale, st);
      break;
    case 64:
      err = launch<64>(q, k, v, of, lf, bh, sq, sk, causal, is_bf16, scale, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
