// The tile machinery of the fused vocab projection + cross-entropy kernels
// on Hopper's tensor cores (sm_90a), shared by the forward (fused_ce.cu,
// kernel 4) and the backward (fused_ce_bwd.cu, kernels 5-6): the product
// tiles' geometry, their shared-memory layouts, the cp.async tile loads of
// the 3-stage ring, one 32-deep step of a warp's products (3xTF32 in
// float32, bf16 mma.sync in bfloat16) and the per-row statistics.  The
// logits product x w is the same in all three kernels; fused_ce_bwd.cu's
// header comment sets out the design.

#pragma once

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBK = 32;        // depth of one pipeline step
constexpr int kStages = 3;
// dw rows that 16-byte accesses cannot reach go through an 8 x 32 float
// tile per warp (row stride 33)
constexpr int kStageLd = 33;
constexpr size_t kDwStageBytes = (kThreads / 32) * 8 * kStageLd * 4;

// A product tile of BM x BN over 8 warps, WARPS_M along its rows: each
// warp owns WM x WN, MT x NT mma tiles of 16 x 8
template <int BM_, int BN_, int WARPS_M_>
struct Geo {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = 8 / WARPS_M_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(MT * NT == 16 && NT % 2 == 0, "16 mma tiles per warp");
};
using DxGeo = Geo<64, 256, 2>;   // warps 32 x 64: 2 x 8 mma tiles
using DwGeo = Geo<256, 64, 4>;   // warps 64 x 32: 4 x 4 mma tiles

// Shared memory of a kernel in elements of T: a ring of kStages stages,
// each the larger of a logits step (x [BM][LDK], w [kBK][LDW]) and a
// second-product step (dx: w [BN][LDK]; dw: x [kBK][LDX]), then the t
// tile [BM][LDT].  Row strides are padded so that a warp's fragment loads
// fall in 32 distinct banks: [m][k] tiles (depth contiguous) at 4 words
// mod 32, [k][n] tiles (width contiguous) at 8.
template <typename T, typename G, bool DX>
struct Smem {
  static constexpr int LDK = kBK + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int LDW = G::BN + 8;
  static constexpr int LDX = G::BM + 8;
  static constexpr int LOGITS = G::BM * LDK + kBK * LDW;
  static constexpr int SECOND = DX ? G::BN * LDK : kBK * LDX;
  static constexpr int STAGE = LOGITS > SECOND ? LOGITS : SECOND;
  // t is A ([m][k]) in dx, B ([k][n]) in dw
  static constexpr int LDT = DX && sizeof(T) == 4 ? G::BN + 4 : G::BN + 8;
  static constexpr size_t bytes() {
    return (static_cast<size_t>(kStages) * STAGE + G::BM * LDT) * sizeof(T) +
           (DX ? 0 : kDwStageBytes);
  }
};

// One element of a tile that takes no 16-byte copy: float32 by a 4-byte
// cp.async, bfloat16 by a plain load (cp.async has no 2-byte form).
__device__ __forceinline__ void copy_one(float* dst, const float* src,
                                         bool ok) {
  cp_async4(dst, src, ok);
}
__device__ __forceinline__ void copy_one(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, bool ok) {
  *reinterpret_cast<uint16_t*>(dst) =
      ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
}

// dst[r][c] = src[r0 + r][c0 + c] for a ROWS x COLS tile, 0 outside
// rlim x clim.  ``vec``: 16-byte copies (the caller checked that clim and
// the row stride are multiples of 16 bytes and the base is aligned).
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ldd,
                                          const T* __restrict__ src,
                                          int lds, int r0, int c0, int rlim,
                                          int clim, bool vec) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = COLS / E;
  constexpr int CHUNKS = ROWS * CPR;
  static_assert(CHUNKS % kThreads == 0, "tile does not split evenly");
  if (vec && r0 + ROWS <= rlim && c0 + COLS <= clim) {  // inside: no masks
#pragma unroll
    for (int i = 0; i < CHUNKS / kThreads; ++i) {
      const int q = static_cast<int>(threadIdx.x) + i * kThreads;
      const int r = q / CPR;
      const int c = (q % CPR) * E;
      cp_async16(dst + r * ldd + c,
                 src + static_cast<size_t>(r0 + r) * lds + c0 + c, true);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < CHUNKS / kThreads; ++i) {
    const int q = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = q / CPR;
    const int c = (q % CPR) * E;
    const int gr = r0 + r;
    const int gc = c0 + c;
    T* d = dst + r * ldd + c;
    const T* s = src + static_cast<size_t>(gr) * lds + gc;
    if (vec) {
      const bool ok = gr < rlim && gc < clim;
      cp_async16(d, ok ? s : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool ok = gr < rlim && gc + e < clim;
        copy_one(d + e, ok ? s + e : src, ok);
      }
    }
  }
}

template <typename G>
struct Warp {
  int wm, wn, g, t;  // warp row / column, lane row group, lane column
  __device__ Warp()
      : wm(static_cast<int>(threadIdx.x) / (32 * G::WARPS_N)),
        wn((static_cast<int>(threadIdx.x) / 32) % G::WARPS_N),
        g((static_cast<int>(threadIdx.x) % 32) / 4),
        t(static_cast<int>(threadIdx.x) % 4) {}
};

// A(m, k) of a tile stored [m][k] (A_MK) or [k][m]; B(k, n) stored [k][n]
// (B_KN) or [n][k].
template <bool A_MK, typename E>
__device__ __forceinline__ E a_at(const E* s, int ld, int m, int k) {
  return A_MK ? s[m * ld + k] : s[k * ld + m];
}
template <bool B_KN, typename E>
__device__ __forceinline__ E b_at(const E* s, int ld, int k, int n) {
  return B_KN ? s[k * ld + n] : s[n * ld + k];
}

// acc += A (this warp's WM rows, kBK deep) . B (kBK deep, its WN columns)
// in 3xTF32: small*big, big*small, then big*big.
template <typename G, bool A_MK, bool B_KN>
__device__ __forceinline__ void step_mma(const float* As, int lda,
                                         const float* Bs, int ldb,
                                         const Warp<G>& w,
                                         float acc[G::MT][G::NT][4]) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;  // the ldmatrix matrix this lane addresses
#pragma unroll
  for (int k = 0; k < kBK; k += 8) {
    uint32_t ab[G::MT][4], as[G::MT][4], bb[G::NT][2], bs[G::NT][2];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const int m0 = w.wm * G::WM + mt * 16;
      if (A_MK) {
        // matrices (rows +0 / +8) x (k +0 / +4): a0..a3
        uint32_t raw[4];
        ldmatrix4<false>(raw, As + (m0 + lane % 8 + 8 * (q % 2)) * lda + k +
                                  4 * (q / 2));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(__uint_as_float(raw[e]), ab[mt][e], as[mt][e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(a_at<A_MK>(As, lda, m0 + w.g + 8 * (e % 2),
                                k + w.t + 4 * (e / 2)),
                     ab[mt][e], as[mt][e]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < G::NT; nt += 2) {
      const int n0 = w.wn * G::WN + nt * 8;
      if (!B_KN) {
        // matrices (k +0 / +4) x (columns +0 / +8): b0, b1 of nt, nt + 1
        uint32_t raw[4];
        ldmatrix4<false>(raw, Bs + (n0 + lane % 8 + 8 * (q / 2)) * ldb + k +
                                  4 * (q % 2));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(__uint_as_float(raw[e]), bb[nt + e / 2][e % 2],
                     bs[nt + e / 2][e % 2]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(b_at<B_KN>(Bs, ldb, k + w.t + 4 * (e % 2),
                                n0 + 8 * (e / 2) + w.g),
                     bb[nt + e / 2][e % 2], bs[nt + e / 2][e % 2]);
        }
      }
    }
    // three passes over the 16 tiles, so that 16 independent products
    // stand between two that add into one accumulator
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        mma_tf32(acc[mt][nt], as[mt], bb[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        mma_tf32(acc[mt][nt], ab[mt], bs[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        mma_tf32(acc[mt][nt], ab[mt], bb[nt]);
      }
    }
  }
}

template <typename G, bool A_MK, bool B_KN>
__device__ __forceinline__ void step_mma(const __nv_bfloat16* As, int lda,
                                         const __nv_bfloat16* Bs, int ldb,
                                         const Warp<G>& w,
                                         float acc[G::MT][G::NT][4]) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int q = lane / 8;  // the ldmatrix matrix this lane addresses
#pragma unroll
  for (int k = 0; k < kBK; k += 16) {
    uint32_t a[G::MT][4], b[G::NT][2];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      // matrices (rows +0 / +8) x (k +0 / +8): a0..a3; stored [k][m] the
      // transposed load gathers the k pairs
      const int m0 = w.wm * G::WM + mt * 16 + 8 * (q % 2);
      const int k0 = k + 8 * (q / 2);
      if (A_MK) {
        ldmatrix4<false>(a[mt], As + (m0 + lane % 8) * lda + k0);
      } else {
        ldmatrix4<true>(a[mt], As + (k0 + lane % 8) * lda + m0);
      }
    }
#pragma unroll
    for (int nt = 0; nt < G::NT; nt += 2) {
      // matrices (k +0 / +8) x (columns +0 / +8): b0, b1 of nt, nt + 1
      const int n0 = w.wn * G::WN + nt * 8 + 8 * (q / 2);
      const int k0 = k + 8 * (q % 2);
      uint32_t r[4];
      if (B_KN) {
        ldmatrix4<true>(r, Bs + (k0 + lane % 8) * ldb + n0);
      } else {
        ldmatrix4<false>(r, Bs + (n0 + lane % 8) * ldb + k0);
      }
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }
}

template <typename G>
__device__ __forceinline__ void zero(float acc[G::MT][G::NT][4]) {
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }
}

// lse, the two cotangent rows gp (softmax term) and goh (one-hot term)
// and the label of this thread's 2 MT rows (n0 + wm*WM + mt*16 + g + 8h
// at index 2 mt + h); rows >= n get gp = goh = 0 and no label
template <typename G>
struct RowStats {
  float lse[2 * G::MT], gp[2 * G::MT], goh[2 * G::MT];
  int lab[2 * G::MT];
  __device__ void load(const Warp<G>& w, int n0, int n,
                       const float* __restrict__ lse_p,
                       const float* __restrict__ gp_p,
                       const float* __restrict__ goh_p,
                       const int32_t* __restrict__ lab_p) {
#pragma unroll
    for (int r = 0; r < 2 * G::MT; ++r) {
      const int row = n0 + w.wm * G::WM + (r / 2) * 16 + w.g + (r % 2) * 8;
      const bool in = row < n;
      lse[r] = in ? lse_p[row] : 0.f;
      gp[r] = in ? gp_p[row] : 0.f;
      goh[r] = in ? goh_p[row] : 0.f;
      lab[r] = in ? lab_p[row] : -1;
    }
  }
};

// (tile, step within the tile) of a flat step index, advanced one step at
// a time, so the loop divides nothing
struct StepPos {
  int tile = 0, step = 0;
  __device__ void next(int per) {
    if (++step == per) {
      step = 0;
      ++tile;
    }
  }
};

template <typename T, typename G, typename S>
__device__ __forceinline__ void load_logits_step(T* buf, const T* x,
                                                 const T* w, int n0, int v0,
                                                 int k0, int n, int d, int V,
                                                 bool xvec, bool wvec) {
  load_tile<T, G::BM, kBK>(buf, S::LDK, x, d, n0, k0, n, d, xvec);
  load_tile<T, kBK, G::BN>(buf + G::BM * S::LDK, S::LDW, w, V, k0, v0, d, V,
                           wvec);
}

}  // namespace
