// Flash-attention backward for Hopper (sm_90a), plain CUDA C++ with a C
// interface (loaded with ctypes by flexflow_tpu_torch/ops/kernels/
// flash_attention.py).
//
// Replaces the two Pallas TPU kernels of flexflow_tpu/ops/pallas/
// flash_attention.py:_bwd_call: _bwd_dkv_kernel (dk, dv) and
// _bwd_dq_kernel (dq), which share _p_ds.  For each (batch*head) and each
// unmasked pair (query row i, key j) they recompute
//     p_ij  = exp(s_ij - lse_i),  s_ij = (q_i . k_j) * scale
//     dp_ij = do_i . v_j
//     ds_ij = p_ij * (dp_ij - delta_i) * scale
// from the forward's saved per-row lse (a fully masked row, lse = -inf,
// is read as lse = 0, as the Pallas kernel does; its p is 0 anyway) and
// delta_i = rowsum(do_i * o_i), which the caller computes in float32, and
// accumulate
//     dv_j += p_ij do_i,   dk_j += ds_ij q_i,   dq_i += ds_ij k_j.
// A pair is masked where j >= sk, i >= sq, or (causal) j > i.  q, k, v and
// do are float32 or bfloat16, (B*H, S, d) contiguous; lse and delta are
// float32 (B*H, Sq); dq, dk, dv are written in float32.  With bfloat16
// inputs p and ds are rounded to bfloat16 before the products that read
// them, as the Pallas kernel casts them to the operand dtype; every sum is
// float32.
//
// What bounds it on an H100: at the LM training shape (B 16, H 12, S 512,
// d 64, causal) the dkv kernel does ~12.9 GFLOP (8*d per unmasked pair)
// and the dq kernel ~9.7 GFLOP (6*d) against ~25-38 MB of inputs and
// outputs: at the card's 67 TFLOP/s float32 rate outside the tensor cores
// that is 0.19 ms and 0.14 ms of arithmetic against ~0.01 ms of memory
// traffic, so both are bound by operations.
//
// Design, simple and right first.  The Pallas grid carries dk/dv (and dq)
// across its innermost grid axis in VMEM scratch; blocks on Hopper run in
// no order, so that axis becomes a loop inside one block:
//   * dkv: one block of 256 threads per (batch*head, 64-key tile) holds
//     its k and v tile in shared memory and loops over the 64-row query
//     tiles that can see a key of it (causal: from the diagonal down);
//   * dq: one block per (batch*head, 64-row query tile) holds q, do, lse
//     and delta and loops over the key tiles its rows can see;
//   * both recompute the 64 x 64 p / ds tile with a 4 x 4 register
//     micro-tile per thread (two 16-float rows of fragments per depth
//     step), stage it in shared memory, and then accumulate the
//     (64 x d) gradient tile with a 4 x (d/16) register micro-tile per
//     thread -- the head dimension is split across threads, so no thread
//     holds a whole row (kernel 1's one-row-per-thread layout would need
//     4*d registers here);
//   * shared tiles are float32 with a row stride of d+1 (or 65), so the
//     strided reads of one warp hit distinct banks;
//   * the ragged edges (i >= sq, j >= sk) are masked, not padded, and no
//     sum crosses blocks: no atomics, deterministic.
// The float32 FMA rate and shared-memory bandwidth are the limits this
// design leaves; tensor cores (mma.sync / wgmma) and TMA staging are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 64;     // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads over a 64 x 64 score tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the operand type T of the product that reads it
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
struct Smem {
  float q[kBlock][D + 1];
  float dout[kBlock][D + 1];
  float k[kBlock][D + 1];
  float v[kBlock][D + 1];
  float p[kBlock][kBlock + 1];
  float ds[kBlock][kBlock + 1];
  float lse[kBlock];
  float delta[kBlock];
};

// Layout of the (64 x D) gradient accumulation: kCols threads along the
// head dimension, each owning kRows rows and kPer columns, strided so that
// a warp reads consecutive columns.
template <int D>
struct Acc {
  static constexpr int kCols = D < 16 ? D : 16;
  static constexpr int kRowThreads = kThreads / kCols;
  static constexpr int kRows = kBlock / kRowThreads;
  static constexpr int kPer = D / kCols;
};

// rows [r0, r0 + 64) of a (rows x D) matrix into a float32 tile, rows past
// n_rows as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1],
                                          const T* __restrict__ src, int r0,
                                          int n_rows) {
  for (int e = threadIdx.x; e < kBlock * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int row = r0 + r;
    dst[r][c] =
        row < n_rows ? to_f32(src[static_cast<size_t>(row) * D + c]) : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void load_rows(Smem<D>& sm,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int q0, int sq) {
  if (threadIdx.x < kBlock) {
    const int row = q0 + static_cast<int>(threadIdx.x);
    sm.lse[threadIdx.x] = row < sq ? lse[row] : 0.f;
    sm.delta[threadIdx.x] = row < sq ? delta[row] : 0.f;
  }
}

// _p_ds for one (64 query rows x 64 keys) tile: p (if wanted) and ds into
// shared memory, rounded to the operand type T.  Thread (ti, tj) owns
// query rows ti + 16a and keys tj + 16b.
template <typename T, int D>
__device__ __forceinline__ void tile_p_ds(Smem<D>& sm, int q0, int k0, int sq,
                                          int sk, int causal, float scale,
                                          bool want_p) {
  const int ti = threadIdx.x / 16;
  const int tj = threadIdx.x % 16;
  float s[4][4];
  float dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      s[a][b] = 0.f;
      dp[a][b] = 0.f;
    }
  }
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = sm.q[ti + 16 * a][c];
      da[a] = sm.dout[ti + 16 * a][c];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = sm.k[tj + 16 * b][c];
      vb[b] = sm.v[tj + 16 * b][c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        dp[a][b] = fmaf(da[a], vb[b], dp[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti + 16 * a;
    const int qpos = q0 + i;
    const float lse = sm.lse[i];
    const float safe_lse = isfinite(lse) ? lse : 0.f;
    const float delta = sm.delta[i];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tj + 16 * b;
      const int kpos = k0 + j;
      const bool valid = qpos < sq && kpos < sk && (!causal || qpos >= kpos);
      const float p = valid ? expf(s[a][b] * scale - safe_lse) : 0.f;
      const float ds = p * (dp[a][b] - delta) * scale;
      if (want_p) sm.p[i][j] = round_to<T>(p);
      sm.ds[i][j] = round_to<T>(ds);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int sq, int sk, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  using L = Acc<D>;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  const T* q_bh = q + static_cast<size_t>(bh) * sq * D;
  const T* do_bh = dout + static_cast<size_t>(bh) * sq * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * sq;
  const float* delta_bh = delta + static_cast<size_t>(bh) * sq;

  load_tile<T, D>(sm.k, k + static_cast<size_t>(bh) * sk * D, k0, sk);
  load_tile<T, D>(sm.v, v + static_cast<size_t>(bh) * sk * D, k0, sk);

  const int tr = threadIdx.x / L::kCols;
  const int tc = threadIdx.x % L::kCols;
  float acc_dk[L::kRows][L::kPer];
  float acc_dv[L::kRows][L::kPer];
#pragma unroll
  for (int a = 0; a < L::kRows; ++a) {
#pragma unroll
    for (int m = 0; m < L::kPer; ++m) {
      acc_dk[a][m] = 0.f;
      acc_dv[a][m] = 0.f;
    }
  }

  // causal: query tiles above this key tile see none of its keys
  for (int q0 = causal ? k0 : 0; q0 < sq; q0 += kBlock) {
    __syncthreads();  // every thread is done with the previous tiles
    load_tile<T, D>(sm.q, q_bh, q0, sq);
    load_tile<T, D>(sm.dout, do_bh, q0, sq);
    load_rows<D>(sm, lse_bh, delta_bh, q0, sq);
    __syncthreads();
    tile_p_ds<T, D>(sm, q0, k0, sq, sk, causal, scale, true);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kBlock; ++i) {
      float pr[L::kRows], dsr[L::kRows], dor[L::kPer], qr[L::kPer];
#pragma unroll
      for (int a = 0; a < L::kRows; ++a) {
        pr[a] = sm.p[i][tr + L::kRowThreads * a];
        dsr[a] = sm.ds[i][tr + L::kRowThreads * a];
      }
#pragma unroll
      for (int m = 0; m < L::kPer; ++m) {
        dor[m] = sm.dout[i][tc + L::kCols * m];
        qr[m] = sm.q[i][tc + L::kCols * m];
      }
#pragma unroll
      for (int a = 0; a < L::kRows; ++a) {
#pragma unroll
        for (int m = 0; m < L::kPer; ++m) {
          acc_dv[a][m] = fmaf(pr[a], dor[m], acc_dv[a][m]);
          acc_dk[a][m] = fmaf(dsr[a], qr[m], acc_dk[a][m]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < L::kRows; ++a) {
    const int key = k0 + tr + L::kRowThreads * a;
    if (key >= sk) continue;
    const size_t base = (static_cast<size_t>(bh) * sk + key) * D;
#pragma unroll
    for (int m = 0; m < L::kPer; ++m) {
      dk[base + tc + L::kCols * m] = acc_dk[a][m];
      dv[base + tc + L::kCols * m] = acc_dv[a][m];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int sq, int sk, int causal,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);
  using L = Acc<D>;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlock;
  const T* k_bh = k + static_cast<size_t>(bh) * sk * D;
  const T* v_bh = v + static_cast<size_t>(bh) * sk * D;

  load_tile<T, D>(sm.q, q + static_cast<size_t>(bh) * sq * D, q0, sq);
  load_tile<T, D>(sm.dout, dout + static_cast<size_t>(bh) * sq * D, q0, sq);
  load_rows<D>(sm, lse + static_cast<size_t>(bh) * sq,
               delta + static_cast<size_t>(bh) * sq, q0, sq);

  const int tr = threadIdx.x / L::kCols;
  const int tc = threadIdx.x % L::kCols;
  float acc[L::kRows][L::kPer];
#pragma unroll
  for (int a = 0; a < L::kRows; ++a) {
#pragma unroll
    for (int m = 0; m < L::kPer; ++m) acc[a][m] = 0.f;
  }

  // keys past the last row of this query tile are masked for all of it
  const int k_end = causal ? min(sk, q0 + kBlock) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlock) {
    __syncthreads();  // q/do/lse/delta staged, or previous k/v consumed
    load_tile<T, D>(sm.k, k_bh, k0, sk);
    load_tile<T, D>(sm.v, v_bh, k0, sk);
    __syncthreads();
    tile_p_ds<T, D>(sm, q0, k0, sq, sk, causal, scale, false);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float dsr[L::kRows], kr[L::kPer];
#pragma unroll
      for (int a = 0; a < L::kRows; ++a) {
        dsr[a] = sm.ds[tr + L::kRowThreads * a][j];
      }
#pragma unroll
      for (int m = 0; m < L::kPer; ++m) kr[m] = sm.k[j][tc + L::kCols * m];
#pragma unroll
      for (int a = 0; a < L::kRows; ++a) {
#pragma unroll
        for (int m = 0; m < L::kPer; ++m) {
          acc[a][m] = fmaf(dsr[a], kr[m], acc[a][m]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < L::kRows; ++a) {
    const int row = q0 + tr + L::kRowThreads * a;
    if (row >= sq) continue;
    const size_t base = (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int m = 0; m < L::kPer; ++m) dq[base + tc + L::kCols * m] = acc[a][m];
  }
}

// the dynamic shared memory of a kernel above 48 KB needs an opt-in once
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int bh,
                       int sq, int sk, int causal, float scale,
                       cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem<D>));
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sk + kBlock - 1) / kBlock);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dk,
      dv, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      float* dq, int bh, int sq, int sk, int causal,
                      float scale, cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(Smem<D>));
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + kBlock - 1) / kBlock);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      sq, sk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dkv(int d, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, float* dk, float* dv, int bh,
                         int sq, int sk, int causal, float scale,
                         cudaStream_t st) {
  switch (d) {
    case 8:
      return launch_dkv<T, 8>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                              causal, scale, st);
    case 16:
      return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                               causal, scale, st);
    case 32:
      return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                               causal, scale, st);
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                               causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dq(int d, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, float* dq, int bh, int sq, int sk,
                        int causal, float scale, cudaStream_t st) {
  switch (d) {
    case 8:
      return launch_dq<T, 8>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                             causal, scale, st);
    case 16:
      return launch_dq<T, 16>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                              causal, scale, st);
    case 32:
      return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                              causal, scale, st);
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                              causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_grid(int bh, int rows) {
  return bh < 0 || rows < 0 || (rows + kBlock - 1) / kBlock > 65535;
}

}  // namespace

// dk, dv (bh, sk, d) float32.  Launches on ``stream`` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ff_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int bh, int sq,
                                          int sk, int d, int causal,
                                          int is_bf16, float scale,
                                          void* stream) {
  if (sq < 0 || bad_grid(bh, sk)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || sk == 0) return 0;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_dkv<__nv_bfloat16>(d, q, k, v, dout, l, dl, dkf, dvf,
                                            bh, sq, sk, causal, scale, st)
              : dispatch_dkv<float>(d, q, k, v, dout, l, dl, dkf, dvf, bh, sq,
                                    sk, causal, scale, st);
  return static_cast<int>(err);
}

// dq (bh, sq, d) float32.  Launches on ``stream`` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ff_flash_attention_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, int bh, int sq, int sk,
                                         int d, int causal, int is_bf16,
                                         float scale, void* stream) {
  if (sk < 0 || bad_grid(bh, sq)) return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || sq == 0) return 0;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqf = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_dq<__nv_bfloat16>(d, q, k, v, dout, l, dl, dqf, bh,
                                           sq, sk, causal, scale, st)
              : dispatch_dq<float>(d, q, k, v, dout, l, dl, dqf, bh, sq, sk,
                                   causal, scale, st);
  return static_cast<int>(err);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
