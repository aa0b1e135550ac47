// Flash-attention forward for Hopper (sm_90a) on the tensor cores, plain
// CUDA C++ with a C interface (loaded with ctypes by flexflow_tpu_torch/
// ops/kernels/flash_attention.py).
//
// Replaces flexflow_tpu/ops/pallas/flash_attention.py:_fwd_kernel, the
// Pallas TPU kernel that _fwd_call launches.  For each (batch*head) and
// query row i it computes
//     s_ij  = (q_i . k_j) * scale, masked where j >= sk or (causal, j > i)
//     o_i   = sum_j softmax(s_i)_j v_j              (float32)
//     lse_i = log sum_j exp(s_ij)                   (float32)
// with a fully masked row giving o_i = 0 and lse_i = -inf, as the Pallas
// kernel does; the backward kernels read this lse.  q, k, v are float32
// or bfloat16, (B*H, S, d) contiguous with 16-byte aligned rows; the head
// dim d is 8, 16, 32, 64 or 128.
//
// What bounds it on an H100: at the serving shape (B 8, H 12, S 512,
// d 64, causal) the work is 3.23 GFLOP (4*d per unmasked score).  In
// float32 both products run as 3xTF32 on the tensor cores (three TF32
// products at 495 TFLOP/s: 0.0196 ms), bound by operations; with
// bfloat16 inputs the products are bf16 mma.sync at 989 TFLOP/s and the
// ~22 MB of inputs and outputs at 3.35 TB/s bound it (0.0066 ms).
//
// Design:
//   * one block of 4 warps per (batch*head, 64-row Q tile), 16 query rows
//     per warp; the causal Q tiles are launched heaviest first (the grid's
//     y index counts down the tiles), and K/V tiles wholly above the
//     causal diagonal are never loaded;
//   * the Q tile and a 2-stage ring of 64-key K/V tiles are copied into
//     shared memory by cp.async (16 bytes a copy, rows past the end
//     zero-filled), one barrier per K/V tile;
//   * S = Q K^T on mma.sync: in float32 m16n8k8 TF32, each operand split
//     into big = rna(a) and small = rna(a - big) and the product taken as
//     small*big + big*small + big*big (one TF32 pass keeps ~3 digits and
//     misses the 1e-4 gate); with bfloat16 inputs m16n8k16 bf16, whose
//     products are exact.  Q's fragments stay in registers (split once)
//     except for float32 at d = 128, which reloads them per tile;
//   * the online softmax runs on the accumulator fragments in base 2: row
//     max over the thread's columns, then over the quad by
//     __shfl_xor_sync; the O accumulator is rescaled in registers;
//   * O += P V on mma.sync.  float32: 3xTF32 again; P's accumulator
//     fragment is the A fragment of m16n8k8 once the 8 keys of a step are
//     taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (V's rows are read in that
//     order too), so P never leaves registers.  bfloat16: the C fragments
//     of two 8-key tiles are the A fragment of m16n8k16; P, float32 in
//     meaning, is split into bf16 hi = bf16(p) and lo = bf16(p - hi) and
//     both are multiplied with V (exact in bf16), since one bf16 rounding
//     of P would move o by ~4e-3;
//   * shared-memory rows are padded (d + 4 floats, d + 8 bf16) so that
//     ldmatrix and the paired V row loads fall in distinct banks.

#include <math_constants.h>

#include "mma_sm90.cuh"
#include "smem_optin.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;           // keys per K/V tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D>
struct Layout {
  static constexpr bool BF16 = sizeof(T) == 2;
  // the depth of Q and K rows: a bf16 product takes 16 at a time, so
  // d = 8 is zero-padded to 16
  static constexpr int DK = BF16 && D < 16 ? 16 : D;
  static constexpr int LD = DK + (BF16 ? 8 : 4);  // row stride, elements
  static constexpr int QT = kBlockQ * LD;         // the Q tile
  static constexpr int KT = kBlockK * LD;         // one K or V tile
  static constexpr int NT_D = D / 8;              // 8-wide tiles of d
  // float32 Q fragments in registers, split: 2 * d / 2 registers
  static constexpr bool Q_REGS = BF16 || D <= 64;
  static constexpr size_t bytes() {
    return static_cast<size_t>(QT + 2 * kStages * KT) * sizeof(T);
  }
};

// dst[r][0..D) = src[r0 + r][0..D) for ROWS rows, zero past rlim
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int r0, int rlim) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = D / E;  // 16-byte copies per row
  constexpr int LD = Layout<T, D>::LD;
#pragma unroll
  for (int q = threadIdx.x; q < ROWS * CPR; q += kThreads) {
    const int r = q / CPR;
    const int c = (q % CPR) * E;
    const bool ok = r0 + r < rlim;
    cp_async16(dst + r * LD + c,
               ok ? src + static_cast<size_t>(r0 + r) * D + c : src, ok);
  }
}

// K/V tile i into its ring slot
template <typename T, int D>
__device__ __forceinline__ void load_kv(T* kv, const T* __restrict__ k,
                                        const T* __restrict__ v, int i,
                                        int sk) {
  using L = Layout<T, D>;
  T* ks = kv + (i % kStages) * 2 * L::KT;
  load_rows<T, D, kBlockK>(ks, k, i * kBlockK, sk);
  load_rows<T, D, kBlockK>(ks + L::KT, v, i * kBlockK, sk);
}

// The 16 rows x 64 keys of a warp's scores, the accumulator of S = Q K^T
// (8 tiles of 8 keys; element e of tile nt is row g + 8 (e / 2), key
// 8 nt + 2 t + e % 2)
using Scores = float[8][4];

template <int D>
struct QFrags {
  uint32_t big[D / 8][4], small[D / 8][4];
};

// S = Q K^T of one K tile, float32 operands in 3xTF32
template <int D>
__device__ __forceinline__ void scores_tf32(const float* qs, const float* ks,
                                            const QFrags<D>& qf,
                                            Scores acc) {
  using L = Layout<float, D>;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ab[4], as[4];
    if constexpr (L::Q_REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ab[e] = qf.big[kk][e];
        as[e] = qf.small[kk][e];
      }
    } else {
      a_frag_tf32(qs + kk * 8, L::LD, ab, as);
    }
    uint32_t bb[8][2], bs[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      // matrices (depth +0 / +4) x (keys +0 / +8): b0, b1 of nt, nt + 1
      uint32_t raw[4];
      ldmatrix4<false>(raw, ks + (nt * 8 + lane % 8 + 8 * (q / 2)) * L::LD +
                                kk * 8 + 4 * (q % 2));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split_tf32(__uint_as_float(raw[e]), bb[nt + e / 2][e % 2],
                   bs[nt + e / 2][e % 2]);
      }
    }
    // three passes, so that 8 independent products stand between two that
    // add into one accumulator
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[nt], as, bb[nt]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[nt], ab, bs[nt]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_tf32(acc[nt], ab, bb[nt]);
  }
}

// S = Q K^T of one K tile, bf16 operands; qa holds Q's A fragments
template <int D>
__device__ __forceinline__ void scores_bf16(
    const __nv_bfloat16* ks, const uint32_t qa[Layout<__nv_bfloat16, D>::DK / 16][4],
    Scores acc) {
  using L = Layout<__nv_bfloat16, D>;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;
#pragma unroll
  for (int kk = 0; kk < L::DK / 16; ++kk) {
    uint32_t b[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      // matrices (keys +0 / +8) x (depth +0 / +8): b0, b1 of nt, nt + 1
      uint32_t r[4];
      ldmatrix4<false>(r, ks + (nt * 8 + 8 * (q / 2) + lane % 8) * L::LD +
                              kk * 16 + 8 * (q % 2));
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[nt], qa[kk], b[nt]);
  }
}

// O += P V of one V tile in 3xTF32.  Step kk takes the keys 8 kk + (0, 2,
// 4, 6, 1, 3, 5, 7) as its depth 0..7, so that P's accumulator elements
// (keys 2t, 2t + 1 of rows g, g + 8) are its A fragment as they stand.
template <int D>
__device__ __forceinline__ void pv_tf32(const float* vs, const Scores p,
                                        float o[D / 8][4]) {
  using L = Layout<float, D>;
  constexpr int GROUP = L::NT_D < 8 ? L::NT_D : 8;  // d tiles per pass
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(p[kk][0], ab[0], as[0]);  // (g, key 2t)
    split_tf32(p[kk][2], ab[1], as[1]);  // (g + 8, key 2t)
    split_tf32(p[kk][1], ab[2], as[2]);  // (g, key 2t + 1)
    split_tf32(p[kk][3], ab[3], as[3]);  // (g + 8, key 2t + 1)
    const float* v0 = vs + (kk * 8 + 2 * t) * L::LD + g;
#pragma unroll
    for (int n0 = 0; n0 < L::NT_D; n0 += GROUP) {
      uint32_t bb[GROUP][2], bs[GROUP][2];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        split_tf32(v0[(n0 + j) * 8], bb[j][0], bs[j][0]);
        split_tf32(v0[L::LD + (n0 + j) * 8], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int j = 0; j < GROUP; ++j) mma_tf32(o[n0 + j], as, bb[j]);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) mma_tf32(o[n0 + j], ab, bs[j]);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) mma_tf32(o[n0 + j], ab, bb[j]);
    }
  }
}

// O += P V of one V tile with bf16 V: P split into bf16 hi and lo parts,
// both multiplied with V in m16n8k16 bf16
template <int D>
__device__ __forceinline__ void pv_bf16(const __nv_bfloat16* vs,
                                        const Scores p, float o[D / 8][4]) {
  using L = Layout<__nv_bfloat16, D>;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // a0..a3: (g, keys 2t..) and (g + 8, keys 2t..) of key tiles 2kk and
    // 2kk + 1
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* c = p[2 * kk + e / 2] + 2 * (e % 2);
      hi[e] = pack_bf16(c[0], c[1]);
      lo[e] = pack_bf16(c[0] - __uint_as_float(hi[e] << 16),
                        c[1] - __uint_as_float(hi[e] & 0xFFFF0000u));
    }
#pragma unroll
    for (int nt = 0; nt < L::NT_D; nt += 2) {
      // matrices (keys +0 / +8) x (d +0 / +8): b0, b1 of nt, nt + 1; at
      // d = 8 the second pair reads the first again and is not used
      const int dn = L::NT_D > 1 ? 8 * (q / 2) : 0;
      uint32_t r[4];
      ldmatrix4<true>(r, vs + (kk * 16 + 8 * (q % 2) + lane % 8) * L::LD +
                             nt * 8 + dn);
      const uint32_t b0[2] = {r[0], r[1]};
      mma_bf16(o[nt], hi, b0);
      mma_bf16(o[nt], lo, b0);
      if (nt + 1 < L::NT_D) {
        const uint32_t b1[2] = {r[2], r[3]};
        mma_bf16(o[nt + 1], hi, b1);
        mma_bf16(o[nt + 1], lo, b1);
      }
    }
  }
}

// Two blocks per SM are the target (the float32 d <= 64 tiles fit twice
// in shared memory); the bound also keeps ptxas from spilling a few
// bytes at d = 16 and bf16 d = 128, which it does without it.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int causal,
                     float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kv = qs + L::QT;  // stage i: K at kv + 2 i KT, V after it

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr0 = q0 + warp * 16;  // the warp's first query row

  const T* q_bh = q + static_cast<size_t>(bh) * sq * D;
  const T* k_bh = k + static_cast<size_t>(bh) * sk * D;
  const T* v_bh = v + static_cast<size_t>(bh) * sk * D;

  if constexpr (L::DK != D) {
    // bf16 at d = 8: the Q and K rows' padding columns are zero
    for (int r = threadIdx.x; r < kBlockQ + kStages * kBlockK; r += kThreads) {
      T* row = r < kBlockQ ? qs + r * L::LD
                           : kv + ((r - kBlockQ) / kBlockK) * 2 * L::KT +
                                 ((r - kBlockQ) % kBlockK) * L::LD;
#pragma unroll
      for (int c = D; c < L::DK; ++c) row[c] = T(0.f);
    }
  }

  // keys past the last row of this Q tile are masked for every row of it
  const int k_end = causal ? min(sk, q0 + kBlockQ) : sk;
  const int ntiles = (k_end + kBlockK - 1) / kBlockK;

  load_rows<T, D, kBlockQ>(qs, q_bh, q0, sq);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ntiles) load_kv<T, D>(kv, k_bh, v_bh, i, sk);
    cp_async_commit();
  }

  float oacc[L::NT_D][4];
#pragma unroll
  for (int nt = 0; nt < L::NT_D; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[nt][e] = 0.f;
  }
  // rows g (h = 0) and g + 8 (h = 1): running max in base 2 (the same in
  // the quad) and this thread's part of the rescaled sum
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  const float scale2 = scale * kLog2e;

  QFrags<D> qf;                   // float32 Q fragments, split
  uint32_t qa[L::DK / 16 + 1][4];  // bf16 Q fragments

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < ntiles) {
      load_kv<T, D>(kv, k_bh, v_bh, i + kStages - 1, sk);
    }
    cp_async_commit();
    if (i == 0) {
      if constexpr (L::BF16) {
        const int q8 = lane / 8;
#pragma unroll
        for (int kk = 0; kk < L::DK / 16; ++kk) {
          ldmatrix4<false>(qa[kk], qs + (warp * 16 + 8 * (q8 % 2) + lane % 8) *
                                            L::LD + kk * 16 + 8 * (q8 / 2));
        }
      } else if constexpr (L::Q_REGS) {
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          a_frag_tf32(reinterpret_cast<const float*>(qs) + warp * 16 * L::LD +
                          kk * 8,
                      L::LD, qf.big[kk], qf.small[kk]);
        }
      }
    }
    const int k0 = i * kBlockK;
    // a warp whose rows all lie above this tile's first key sees none of it
    if (causal && k0 > wr0 + 15) continue;
    const T* ks = kv + (i % kStages) * 2 * L::KT;

    Scores s;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
    if constexpr (L::BF16) {
      scores_bf16<D>(ks, qa, s);
    } else {
      scores_tf32<D>(reinterpret_cast<const float*>(qs) + warp * 16 * L::LD,
                     ks, qf, s);
    }

    // online softmax in base 2 on the fragments.  Element (nt, e) holds
    // key k0 + 2t + 8 nt + e % 2 of row wr0 + g + 8 (e / 2); it is masked
    // past the row's last key, sk - 1 or (causal) the row itself, taken
    // relative to k0 + 2t
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int last = causal ? min(sk - 1, wr0 + g + 8 * h) : sk - 1;
      lim[h] = last - (k0 + 2 * t);
    }
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = nt * 8 + e % 2 > lim[e / 2] ? -CUDART_INF_F
                                                    : s[nt][e] * scale2;
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      // a row with no unmasked key yet keeps m = -inf; exp2 of -inf - 0
      // gives its p = 0 and its rescale 0
      mu[h] = mn == -CUDART_INF_F ? 0.f : mn;
      const float alpha = exp2f(m[h] - mu[h]);
      m[h] = mn;
      l[h] *= alpha;
#pragma unroll
      for (int nt = 0; nt < L::NT_D; ++nt) {
        oacc[nt][2 * h] *= alpha;
        oacc[nt][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - mu[e / 2]);
        s[nt][e] = pe;
        l[e / 2] += pe;
      }
    }

    if constexpr (L::BF16) {
      pv_bf16<D>(ks + L::KT, s, oacc);
    } else {
      pv_tf32<D>(reinterpret_cast<const float*>(ks) + L::KT, s, oacc);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = wr0 + g + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    float* orow = o + (static_cast<size_t>(bh) * sq + row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < L::NT_D; ++nt) {
      *reinterpret_cast<float2*>(orow + nt * 8) =
          make_float2(oacc[nt][2 * h] / denom, oacc[nt][2 * h + 1] / denom);
    }
    if (t == 0) {
      lse[static_cast<size_t>(bh) * sq + row] =
          m[h] == -CUDART_INF_F ? -CUDART_INF_F
                                : (m[h] + log2f(denom)) * kLn2;
    }
  }
}

template <typename T, int D>
int smem_attr() {
  static std::atomic<int> slots[kMaxDevices];
  return once_per_device(slots, [] {
    return static_cast<int>(cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Layout<T, D>::bytes())));
  });
}

template <int D>
int launch(const void* q, const void* k, const void* v, float* o, float* lse,
           int bh, int sq, int sk, int causal, int is_bf16, float scale,
           cudaStream_t stream) {
  const dim3 grid(bh, (sq + kBlockQ - 1) / kBlockQ);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const int attr = smem_attr<T, D>();
    if (attr != 0) return attr;
    flash_fwd_kernel<T, D><<<grid, kThreads, Layout<T, D>::bytes(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), o, lse, sq, sk, causal, scale);
  } else {
    const int attr = smem_attr<float, D>();
    if (attr != 0) return attr;
    flash_fwd_kernel<float, D>
        <<<grid, kThreads, Layout<float, D>::bytes(), stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), o, lse, sq, sk, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
size_t smem_bytes(int is_bf16) {
  return is_bf16 ? Layout<__nv_bfloat16, D>::bytes()
                 : Layout<float, D>::bytes();
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
  switch (d) {
    case 8:
      return launch<8>(q, k, v, of, lf, bh, sq, sk, causal, is_bf16, scale, st);
    case 16:
      return launch<16>(q, k, v, of, lf, bh, sq, sk, causal, is_bf16, scale, st);
    case 32:
      return launch<32>(q, k, v, of, lf, bh, sq, sk, causal, is_bf16, scale, st);
    case 64:
      return launch<64>(q, k, v, of, lf, bh, sq, sk, causal, is_bf16, scale, st);
    case 128:
      return launch<128>(q, k, v, of, lf, bh, sq, sk, causal, is_bf16, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of the kernel for head dim ``d``, in bytes (0 for
// a head dim it is not built for)
extern "C" int ff_flash_attention_fwd_smem(int d, int is_bf16) {
  switch (d) {
    case 8: return static_cast<int>(smem_bytes<8>(is_bf16));
    case 16: return static_cast<int>(smem_bytes<16>(is_bf16));
    case 32: return static_cast<int>(smem_bytes<32>(is_bf16));
    case 64: return static_cast<int>(smem_bytes<64>(is_bf16));
    case 128: return static_cast<int>(smem_bytes<128>(is_bf16));
    default: return 0;
  }
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
