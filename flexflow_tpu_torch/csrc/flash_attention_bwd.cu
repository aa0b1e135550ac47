// Flash-attention backward for Hopper (sm_90a) on the tensor cores, plain
// CUDA C++ with a C interface (loaded with ctypes by flexflow_tpu_torch/
// ops/kernels/flash_attention.py).
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
// do are float32 or bfloat16, (B*H, S, d) contiguous with 16-byte aligned
// rows, d in {8, 16, 32, 64, 128}; lse and delta are float32 (B*H, Sq);
// dq, dk, dv are written in float32.  With bfloat16 inputs p and ds are
// rounded to bfloat16 once before the products that read them, as the
// Pallas kernel casts them to the operand dtype; every sum is float32.
//
// What bounds it on an H100: at the LM training shape (B 16, H 12, S 512,
// d 64, causal) the dkv kernel does 12.9 GFLOP (8*d per unmasked pair:
// four products) and the dq kernel 9.7 GFLOP (6*d: three) against 25-38
// MB of inputs and outputs.  In float32 every product runs as 3xTF32 on
// the tensor cores (three TF32 products at the data sheet's 495 TFLOP/s:
// 0.078 and 0.059 ms), bound by operations; with bfloat16 inputs the
// products are bf16 mma.sync at 989 TFLOP/s and the bytes bound them.
//
// Design (kernel 1's, flash_attention_fwd.cu, carried over to the two
// backward passes).  The Pallas grid carries dk/dv (and dq) across its
// innermost axis in VMEM scratch; blocks on Hopper run in no order, so
// that axis is a loop inside one block that owns its output tile, and no
// sum crosses blocks (no atomics: two calls give the same bits):
//   * dq: one block of 4 warps per (batch*head, 64-row Q tile), 16 query
//     rows per warp.  Q and dO are staged once by cp.async, K and V
//     stream through a 2-stage cp.async ring (one barrier per tile); the
//     causal Q tiles are launched heaviest first and K/V tiles wholly
//     above the diagonal are never loaded.  S = Q K^T and dP = dO V^T run
//     on mma.sync, p and ds on their accumulator fragments, and dQ += dS K
//     takes dS's C fragment as its A fragment (below), so dS never leaves
//     registers;
//   * dkv: one block of 4 warps per (batch*head, 64-key tile), 16 keys
//     per warp; K and V are staged once, Q, dO, lse and delta stream
//     through the ring, from the causal diagonal down (key tile 0, which
//     sees the most query tiles, is launched first).  The warp computes
//     the transposed tiles S^T = K Q^T and dP^T = V dO^T, so that its
//     accumulator rows are its own keys; P^T and dS^T are then the A
//     fragments of dV += P^T dO and dK += dS^T Q.  lse and delta are per
//     column in this layout and are read from the staged vectors;
//   * C fragment as A fragment.  float32: m16n8k8 TF32, each operand split
//     into big = rna(a) and small = rna(a - big) and the product taken as
//     small*big + big*small + big*big (one TF32 pass keeps ~3 digits and
//     misses the 1e-4 gate).  The C fragment holds columns 2t, 2t + 1 of
//     rows g, g + 8; the A fragment wants depth t, t + 4.  A step takes
//     its 8 columns (keys for dq, queries for dkv) in the order 0, 2, 4,
//     6, 1, 3, 5, 7 and reads the B rows (K; dO and Q) in that order, so
//     the C fragment is the A fragment as it stands.  bfloat16: the C
//     fragments of two 8-column tiles are the A fragment of m16n8k16 bf16,
//     p or ds rounded to bf16 once (the reference's one rounding), B read
//     by ldmatrix.trans;
//   * registers: the A fragments of the block's resident operands (Q and
//     dO for dq, K and V for dkv) stay in registers where they fit
//     (float32 split up to d = 32, bf16 up to d = 64) and are reloaded
//     from shared memory per tile above that, one depth step at a time (a
//     rolled loop: unrolled, ptxas spilled at float32 d = 128 and the
//     d = 64 kernels ran slower).  At d = 128 dK and dV take 128 float32
//     registers a thread on their own, so the dkv warp takes a Q tile as
//     two steps of 32 queries, which halves S^T and dP^T;
//   * shared-memory rows are padded (d + 4 floats, d + 8 bf16) so that
//     ldmatrix and the paired B row loads fall in distinct banks; d = 8 in
//     bf16 is zero-padded to the bf16 product's depth of 16;
//   * the ragged edges (i >= sq, j >= sk) are masked, not padded: rows
//     past the end load as zeros, and a compare per element against a
//     per-row (dq) or per-column (dkv) limit masks p.

#include <math_constants.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "smem_optin.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlock = 16 * kWarps;  // rows of every tile, 16 per warp
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Layout {
  static constexpr bool BF16 = sizeof(T) == 2;
  // the depth of the S and dP products: a bf16 product takes 16 at a
  // time, so d = 8 is zero-padded to 16
  static constexpr int DK = BF16 && D < 16 ? 16 : D;
  static constexpr int LD = DK + (BF16 ? 8 : 4);  // row stride, elements
  static constexpr int TILE = kBlock * LD;        // one 64-row tile
  static constexpr int NT_D = D / 8;              // 8-wide tiles of d
  // the resident operands' A fragments in registers (float32: split)
  static constexpr bool A_REGS = BF16 ? D <= 64 : D <= 32;
  // queries per step of the dkv warp: at d = 128 dK and dV take 128
  // registers, so a step takes half a Q tile
  static constexpr int DKV_STEP = D == 128 ? 32 : 64;
  // six tiles: two resident, a ring of two per stage; dkv adds lse and
  // delta per stage
  static constexpr size_t dq_bytes() {
    return static_cast<size_t>((2 + 2 * kStages) * TILE) * sizeof(T);
  }
  static constexpr size_t dkv_bytes() {
    return dq_bytes() + static_cast<size_t>(kStages * 2 * kBlock) * sizeof(float);
  }
};

// dst[r][0..D) = src[r0 + r][0..D) for 64 rows, zero past rlim
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int r0, int rlim) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = D / E;  // 16-byte copies per row
  constexpr int LD = Layout<T, D>::LD;
#pragma unroll
  for (int c = threadIdx.x; c < kBlock * CPR; c += kThreads) {
    const int r = c / CPR;
    const int col = (c % CPR) * E;
    const bool ok = r0 + r < rlim;
    cp_async16(dst + r * LD + col,
               ok ? src + static_cast<size_t>(r0 + r) * D + col : src, ok);
  }
}

// lse[r0..r0 + 64) and delta[r0..r0 + 64) into dst, zero past rlim
__device__ __forceinline__ void load_stats(float* dst,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int r0, int rlim) {
  for (int c = threadIdx.x; c < 2 * kBlock; c += kThreads) {
    const int r = c % kBlock;
    const float* src = c < kBlock ? lse : delta;
    const bool ok = r0 + r < rlim;
    cp_async4(dst + c, ok ? src + r0 + r : src, ok);
  }
}

// A fragments of a warp's 16 rows x DK, held in registers when A_REGS
template <typename T, int D>
struct AFrags {
  using L = Layout<T, D>;
  static constexpr int N = !L::A_REGS ? 1 : L::BF16 ? L::DK / 16 : D / 8;
  uint32_t big[N][4];
  uint32_t small[L::BF16 ? 1 : N][4];
};

// A fragment (16 rows x 16 deep) of a bf16 [m][k] tile
__device__ __forceinline__ void a_frag_bf16(const __nv_bfloat16* s, int ld,
                                            uint32_t a[4]) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;
  ldmatrix4<false>(a, s + (8 * (q % 2) + lane % 8) * ld + 8 * (q / 2));
}

template <typename T, int D>
__device__ __forceinline__ void load_afrags(const T* s, AFrags<T, D>& f) {
  using L = Layout<T, D>;
  if constexpr (L::A_REGS) {
    if constexpr (L::BF16) {
#pragma unroll
      for (int kk = 0; kk < L::DK / 16; ++kk) {
        a_frag_bf16(s + kk * 16, L::LD, f.big[kk]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        a_frag_tf32(s + kk * 8, L::LD, f.big[kk], f.small[kk]);
      }
    }
  }
}

// acc += A B^T in 3xTF32 for one 8-deep step: A split into ab, as_, B
// the 8 NT rows of `bs` from the step's first column
template <int D, int NT>
__device__ __forceinline__ void abt_step_tf32(const uint32_t ab[4],
                                              const uint32_t as_[4],
                                              const float* bs,
                                              float acc[NT][4]) {
  using L = Layout<float, D>;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;
  uint32_t bb[NT][2], bsm[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    // matrices (depth +0 / +4) x (rows +0 / +8): b0, b1 of nt, nt + 1
    uint32_t raw[4];
    ldmatrix4<false>(raw, bs + (nt * 8 + lane % 8 + 8 * (q / 2)) * L::LD +
                              4 * (q % 2));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(__uint_as_float(raw[e]), bb[nt + e / 2][e % 2],
                 bsm[nt + e / 2][e % 2]);
    }
  }
  // three passes, so that NT independent products stand between two that
  // add into one accumulator
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], as_, bb[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], ab, bsm[nt]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[nt], ab, bb[nt]);
}

// acc += A B^T in 3xTF32: A the warp's 16 rows of `as` (or f), B the
// 8 NT rows of `bs`, both d deep
template <int D, int NT>
__device__ __forceinline__ void product_abt_tf32(const float* as,
                                                 const AFrags<float, D>& f,
                                                 const float* bs,
                                                 float acc[NT][4]) {
  using L = Layout<float, D>;
  if constexpr (L::A_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      abt_step_tf32<D, NT>(f.big[kk], f.small[kk], bs + kk * 8, acc);
    }
  } else {
#pragma unroll 1
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ab[4], as_[4];
      a_frag_tf32(as + kk * 8, L::LD, ab, as_);
      abt_step_tf32<D, NT>(ab, as_, bs + kk * 8, acc);
    }
  }
}

// acc += A B^T in bf16, as product_abt_tf32
template <int D, int NT>
__device__ __forceinline__ void product_abt_bf16(
    const __nv_bfloat16* as, const AFrags<__nv_bfloat16, D>& f,
    const __nv_bfloat16* bs, float acc[NT][4]) {
  using L = Layout<__nv_bfloat16, D>;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;
#pragma unroll
  for (int kk = 0; kk < L::DK / 16; ++kk) {
    uint32_t a[4];
    if constexpr (L::A_REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = f.big[kk][e];
    } else {
      a_frag_bf16(as + kk * 16, L::LD, a);
    }
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      // matrices (rows +0 / +8) x (depth +0 / +8): b0, b1 of nt, nt + 1
      uint32_t r[4];
      ldmatrix4<false>(r, bs + (nt * 8 + 8 * (q / 2) + lane % 8) * L::LD +
                              kk * 16 + 8 * (q % 2));
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, b[nt]);
  }
}

template <typename T, int D, int NT>
__device__ __forceinline__ void product_abt(const T* as,
                                            const AFrags<T, D>& f,
                                            const T* bs, float acc[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  if constexpr (Layout<T, D>::BF16) {
    product_abt_bf16<D, NT>(as, f, bs, acc);
  } else {
    product_abt_tf32<D, NT>(as, f, bs, acc);
  }
}

// out += C B in 3xTF32: C the warp's 16 x 8 NK accumulator fragments, B
// the 8 NK rows of `bs` (d wide).  Step kk takes the rows 8 kk + (0, 2, 4,
// 6, 1, 3, 5, 7) as its depth 0..7, so that C's elements (columns 2t,
// 2t + 1 of rows g, g + 8) are its A fragment as they stand.
template <int D, int NK>
__device__ __forceinline__ void product_cb_tf32(const float* bs,
                                                const float c[NK][4],
                                                float out[D / 8][4]) {
  using L = Layout<float, D>;
  constexpr int GROUP = L::NT_D < 8 ? L::NT_D : 8;  // d tiles per pass
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t ab[4], as_[4];
    split_tf32(c[kk][0], ab[0], as_[0]);  // (g, column 2t)
    split_tf32(c[kk][2], ab[1], as_[1]);  // (g + 8, column 2t)
    split_tf32(c[kk][1], ab[2], as_[2]);  // (g, column 2t + 1)
    split_tf32(c[kk][3], ab[3], as_[3]);  // (g + 8, column 2t + 1)
    const float* b0 = bs + (kk * 8 + 2 * t) * L::LD + g;
#pragma unroll
    for (int n0 = 0; n0 < L::NT_D; n0 += GROUP) {
      uint32_t bb[GROUP][2], bsm[GROUP][2];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        split_tf32(b0[(n0 + j) * 8], bb[j][0], bsm[j][0]);
        split_tf32(b0[L::LD + (n0 + j) * 8], bb[j][1], bsm[j][1]);
      }
#pragma unroll
      for (int j = 0; j < GROUP; ++j) mma_tf32(out[n0 + j], as_, bb[j]);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) mma_tf32(out[n0 + j], ab, bsm[j]);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) mma_tf32(out[n0 + j], ab, bb[j]);
    }
  }
}

// out += bf16(C) B in m16n8k16 bf16: the C fragments of 8-column tiles
// 2kk and 2kk + 1 are the A fragment of step kk; B by ldmatrix.trans
template <int D, int NK>
__device__ __forceinline__ void product_cb_bf16(const __nv_bfloat16* bs,
                                                const float c[NK][4],
                                                float out[D / 8][4]) {
  using L = Layout<__nv_bfloat16, D>;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    // a0..a3: (g, columns 2t..) and (g + 8, columns 2t..) of tiles 2kk
    // and 2kk + 1
    uint32_t a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* ce = c[2 * kk + e / 2] + 2 * (e % 2);
      a[e] = pack_bf16(ce[0], ce[1]);
    }
#pragma unroll
    for (int nt = 0; nt < L::NT_D; nt += 2) {
      // matrices (rows +0 / +8) x (d +0 / +8): b0, b1 of nt, nt + 1; at
      // d = 8 the second pair reads the first again and is not used
      const int dn = L::NT_D > 1 ? 8 * (q / 2) : 0;
      uint32_t r[4];
      ldmatrix4<true>(r, bs + (kk * 16 + 8 * (q % 2) + lane % 8) * L::LD +
                             nt * 8 + dn);
      const uint32_t b0[2] = {r[0], r[1]};
      mma_bf16(out[nt], a, b0);
      if (nt + 1 < L::NT_D) {
        const uint32_t b1[2] = {r[2], r[3]};
        mma_bf16(out[nt + 1], a, b1);
      }
    }
  }
}

template <typename T, int D, int NK>
__device__ __forceinline__ void product_cb(const T* bs, const float c[NK][4],
                                           float out[D / 8][4]) {
  if constexpr (Layout<T, D>::BF16) {
    product_cb_bf16<D, NK>(bs, c, out);
  } else {
    product_cb_tf32<D, NK>(bs, c, out);
  }
}

// bf16 at d = 8: the padding columns of every tile row are zero
template <typename T, int D>
__device__ __forceinline__ void zero_padding(T* tiles) {
  using L = Layout<T, D>;
  if constexpr (L::DK != D) {
    for (int r = threadIdx.x; r < (2 + 2 * kStages) * kBlock; r += kThreads) {
#pragma unroll
      for (int c = D; c < L::DK; ++c) tiles[r * L::LD + c] = T(0.f);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float acc[D / 8][4], int r0,
                                           int rlim) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= rlim) continue;
    float* orow = out + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<float2*>(orow + nt * 8) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
  }
}

// Two blocks per SM where the tiles fit twice (all but float32 d = 128);
// the bound lets a thread take up to 255 registers.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int sq, int sk, int causal,
                        float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + L::TILE;
  T* kv = dos + L::TILE;  // stage i: K at kv + 2 i TILE, V after it

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr0 = q0 + warp * 16;  // the warp's first query row

  const T* k_bh = k + static_cast<size_t>(bh) * sk * D;
  const T* v_bh = v + static_cast<size_t>(bh) * sk * D;
  zero_padding<T, D>(qs);

  // keys past the last row of this Q tile are masked for every row of it
  const int k_end = causal ? min(sk, q0 + kBlock) : sk;
  const int ntiles = (k_end + kBlock - 1) / kBlock;

  load_rows<T, D>(qs, q + static_cast<size_t>(bh) * sq * D, q0, sq);
  load_rows<T, D>(dos, dout + static_cast<size_t>(bh) * sq * D, q0, sq);
  if (ntiles > 0) {
    load_rows<T, D>(kv, k_bh, 0, sk);
    load_rows<T, D>(kv + L::TILE, v_bh, 0, sk);
  }
  cp_async_commit();

  // rows g (h = 0) and g + 8 (h = 1): lse in base 2 (a fully masked row
  // read as 0) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wr0 + g + 8 * h;
    const size_t at = static_cast<size_t>(bh) * sq + row;
    const float l = row < sq ? lse[at] : 0.f;
    lse2[h] = l == -CUDART_INF_F ? 0.f : l * kLog2e;
    dl[h] = row < sq ? delta[at] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  float acc[L::NT_D][4];
#pragma unroll
  for (int nt = 0; nt < L::NT_D; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
  AFrags<T, D> qf, df;
  const T* qw = qs + warp * 16 * L::LD;
  const T* dow = dos + warp * 16 * L::LD;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + 1 < ntiles) {
      T* next = kv + ((i + 1) % kStages) * 2 * L::TILE;
      load_rows<T, D>(next, k_bh, (i + 1) * kBlock, sk);
      load_rows<T, D>(next + L::TILE, v_bh, (i + 1) * kBlock, sk);
    }
    cp_async_commit();
    if (i == 0) {
      load_afrags<T, D>(qw, qf);
      load_afrags<T, D>(dow, df);
    }
    const int k0 = i * kBlock;
    // a warp whose rows all lie above this tile's first key sees none of it
    if (causal && k0 > wr0 + 15) continue;
    const T* ks = kv + (i % kStages) * 2 * L::TILE;

    float s[8][4];
    product_abt<T, D, 8>(qw, qf, ks, s);
    // element (nt, e) holds key k0 + 2t + 8 nt + e % 2 of row wr0 + g +
    // 8 (e / 2); it is masked past the row's last key, sk - 1 or (causal)
    // the row itself, taken relative to k0 + 2t
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int last = causal ? min(sk - 1, wr0 + g + 8 * h) : sk - 1;
      lim[h] = last - (k0 + 2 * t);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = nt * 8 + e % 2 > lim[e / 2]
                       ? 0.f
                       : exp2f(s[nt][e] * scale2 - lse2[e / 2]);
      }
    }
    float dp[8][4];
    product_abt<T, D, 8>(dow, df, ks + L::TILE, dp);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[nt][e] = s[nt][e] * (dp[nt][e] - dl[e / 2]) * scale;
      }
    }
    product_cb<T, D, 8>(ks, dp, acc);
  }
  cp_async_wait<0>();
  store_rows<D>(dq + static_cast<size_t>(bh) * sq * D, acc, wr0, sq);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int sq, int sk, int causal, float scale) {
  using L = Layout<T, D>;
  constexpr int NT_Q = L::DKV_STEP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + L::TILE;
  T* ring = vs + L::TILE;  // stage i: Q at ring + 2 i TILE, dO after it
  // stage i: lse at stats + 2 i 64, delta after it
  float* stats = reinterpret_cast<float*>(ring + 2 * kStages * L::TILE);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlock;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + warp * 16;  // the warp's first key

  const T* q_bh = q + static_cast<size_t>(bh) * sq * D;
  const T* do_bh = dout + static_cast<size_t>(bh) * sq * D;
  const float* lse_bh = lse + static_cast<size_t>(bh) * sq;
  const float* delta_bh = delta + static_cast<size_t>(bh) * sq;
  zero_padding<T, D>(ks);

  // causal: query tiles above this key tile see none of its keys
  const int first = causal ? k0 / kBlock : 0;
  const int ntiles = max((sq + kBlock - 1) / kBlock - first, 0);

  load_rows<T, D>(ks, k + static_cast<size_t>(bh) * sk * D, k0, sk);
  load_rows<T, D>(vs, v + static_cast<size_t>(bh) * sk * D, k0, sk);
  if (ntiles > 0) {
    load_rows<T, D>(ring, q_bh, first * kBlock, sq);
    load_rows<T, D>(ring + L::TILE, do_bh, first * kBlock, sq);
    load_stats(stats, lse_bh, delta_bh, first * kBlock, sq);
  }
  cp_async_commit();

  float dka[L::NT_D][4], dva[L::NT_D][4];
#pragma unroll
  for (int nt = 0; nt < L::NT_D; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[nt][e] = 0.f;
      dva[nt][e] = 0.f;
    }
  }
  const float scale2 = scale * kLog2e;
  AFrags<T, D> kf, vf;
  const T* kw = ks + warp * 16 * L::LD;
  const T* vw = vs + warp * 16 * L::LD;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + 1 < ntiles) {
      const int r0 = (first + i + 1) * kBlock;
      const int st = (i + 1) % kStages;
      load_rows<T, D>(ring + st * 2 * L::TILE, q_bh, r0, sq);
      load_rows<T, D>(ring + (st * 2 + 1) * L::TILE, do_bh, r0, sq);
      load_stats(stats + st * 2 * kBlock, lse_bh, delta_bh, r0, sq);
    }
    cp_async_commit();
    if (i == 0) {
      load_afrags<T, D>(kw, kf);
      load_afrags<T, D>(vw, vf);
    }
    const int st = i % kStages;
    const T* qs = ring + st * 2 * L::TILE;
    const T* dos = qs + L::TILE;
    const float* lse_s = stats + st * 2 * kBlock;
    const float* dl_s = lse_s + kBlock;
    const int q0 = (first + i) * kBlock;

#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += L::DKV_STEP) {
      const int qh0 = q0 + c0;  // this step's first query
      // a warp whose keys all lie below this step's last query sees none
      // of it
      if (causal && qh0 + L::DKV_STEP - 1 < kw0) continue;
      float s[NT_Q][4];
      product_abt<T, D, NT_Q>(kw, kf, qs + c0 * L::LD, s);
      // element (nt, e) holds query qh0 + 2t + 8 nt + e % 2 of key kw0 +
      // g + 8 (e / 2); it is masked past sq - 1 and (causal) before the
      // key, both taken relative to qh0 + 2t
      const int hi = sq - 1 - (qh0 + 2 * t);
      int lo[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lo[h] = causal ? kw0 + g + 8 * h - (qh0 + 2 * t) : -kBlock;
      }
#pragma unroll
      for (int nt = 0; nt < NT_Q; ++nt) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse_s + c0 + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + e % 2;
          const float l = e % 2 ? l2.y : l2.x;
          const float lb = l == -CUDART_INF_F ? 0.f : l * kLog2e;
          s[nt][e] = col > hi || col < lo[e / 2]
                         ? 0.f
                         : exp2f(s[nt][e] * scale2 - lb);
        }
      }
      float dp[NT_Q][4];
      product_abt<T, D, NT_Q>(vw, vf, dos + c0 * L::LD, dp);
#pragma unroll
      for (int nt = 0; nt < NT_Q; ++nt) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dl_s + c0 + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[nt][e] = s[nt][e] * (dp[nt][e] - (e % 2 ? d2.y : d2.x)) * scale;
        }
      }
      product_cb<T, D, NT_Q>(dos + c0 * L::LD, s, dva);
      product_cb<T, D, NT_Q>(qs + c0 * L::LD, dp, dka);
    }
  }
  cp_async_wait<0>();
  const size_t base = static_cast<size_t>(bh) * sk * D;
  store_rows<D>(dk + base, dka, kw0, sk);
  store_rows<D>(dv + base, dva, kw0, sk);
}

// the dynamic shared memory of a kernel above 48 KB needs an opt-in, once
// per device (``smem_optin.cuh``)
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dk, float* dv,
               int bh, int sq, int sk, int causal, float scale,
               cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::dkv_bytes();
  static std::atomic<int> slots[kMaxDevices];
  const int attr = once_per_device(
      slots, [&] { return allow_smem(flash_bwd_dkv_kernel<T, D>, bytes); });
  if (attr != 0) return attr;
  // y counts the key tiles up: tile 0, which sees the most causal query
  // tiles, starts first
  const dim3 grid(bh, (sk + kBlock - 1) / kBlock);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dk,
      dv, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, float* dq, int bh,
              int sq, int sk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::dq_bytes();
  static std::atomic<int> slots[kMaxDevices];
  const int attr = once_per_device(
      slots, [&] { return allow_smem(flash_bwd_dq_kernel<T, D>, bytes); });
  if (attr != 0) return attr;
  // y counts the Q tiles down: the causal tiles with the most keys first
  const dim3 grid(bh, (sq + kBlock - 1) / kBlock);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// F(D) for the head dims the kernels are built for; -1 for another
template <typename F>
int by_head_dim(int d, F&& f) {
  switch (d) {
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return -1;
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
  const int code = by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return is_bf16 ? launch_dkv<__nv_bfloat16, D>(q, k, v, dout, l, dl, dkf,
                                                  dvf, bh, sq, sk, causal,
                                                  scale, st)
                   : launch_dkv<float, D>(q, k, v, dout, l, dl, dkf, dvf, bh,
                                          sq, sk, causal, scale, st);
  });
  return code < 0 ? static_cast<int>(cudaErrorInvalidValue) : code;
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
  const int code = by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    return is_bf16 ? launch_dq<__nv_bfloat16, D>(q, k, v, dout, l, dl, dqf,
                                                 bh, sq, sk, causal, scale, st)
                   : launch_dq<float, D>(q, k, v, dout, l, dl, dqf, bh, sq,
                                         sk, causal, scale, st);
  });
  return code < 0 ? static_cast<int>(cudaErrorInvalidValue) : code;
}

// Dynamic shared memory of the dkv (which = 0) or dq (which = 1) kernel
// for head dim ``d``, in bytes (0 for a head dim it is not built for)
extern "C" int ff_flash_attention_bwd_smem(int which, int d, int is_bf16) {
  const int bytes = by_head_dim(d, [&](auto dim) {
    constexpr int D = decltype(dim)::value;
    const size_t b =
        is_bf16 ? (which ? Layout<__nv_bfloat16, D>::dq_bytes()
                         : Layout<__nv_bfloat16, D>::dkv_bytes())
                : (which ? Layout<float, D>::dq_bytes()
                         : Layout<float, D>::dkv_bytes());
    return static_cast<int>(b);
  });
  return bytes < 0 ? 0 : bytes;
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
