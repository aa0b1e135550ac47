// Fused vocab projection + softmax cross-entropy forward for Hopper
// (sm_90a) on the tensor cores, plain CUDA C++ with a C interface (loaded
// with ctypes by flexflow_tpu_torch/ops/kernels/fused_ce.py).
//
// Replaces the Pallas TPU kernel _fwd_kernel of flexflow_tpu/ops/pallas/
// fused_ce.py; the backward kernels (_bwd_dx_kernel, _bwd_dw_kernel) are
// in fused_ce_bwd.cu.  With logits = x w + b (x (N, d), w (d, V), b (V,)
// float32, labels (N,) int32), per token row n:
//     lse_n = log sum_v exp(logits_nv)
//     nll_n = lse_n - logits_n,label_n    (a label < 0 or >= V matches
//                                          nothing: nll_n = lse_n)
// The (N, V) logits never reach device memory: each tile of them lives in
// the accumulator registers of one product and is folded into a running
// softmax there.  x and w are float32 or bfloat16 (one dtype), every sum
// is float32, and the outputs are float32.
//
// What bounds it on an H100: at the LM training shape (N = 16 x 512 =
// 8192 tokens, d 768, V 32768) the forward is 2*N*d*V = 412 GFLOP against
// ~126 MB of inputs, so operations bound it.  The product runs on the
// tensor cores with mma.sync, as the backward's does (fused_ce_mma.cuh):
//   * float32 operands: 3xTF32 (small*big + big*small + big*big in float32
//     accumulators, operands split by round-to-nearest-away), three TF32
//     products at 495 TFLOP/s, 2.50 ms at the LM shape;
//   * bfloat16 operands: one m16n8k16 bf16 product, 0.42 ms at 989
//     TFLOP/s.
//
// Design:
//   * a block of 8 warps owns 64 token rows and walks the 256-column vocab
//     tiles s, s + S, s + 2S, ... of its vocab slice s; each tile is the
//     backward's logits product (DxGeo: warps of 32 rows x 64 columns, a
//     3-stage cp.async ring of 32-deep steps that runs two steps ahead
//     across tile boundaries);
//   * after a tile's last step every thread adds the bias to its
//     accumulator fragments (-inf past V), and folds them into a running
//     max, a sum rescaled to it and the label's logit, per fragment row
//     and per thread: no shuffle, no shared memory and no second product
//     inside the loop;
//   * at the end the 4 lanes of a quad merge their states by
//     __shfl_xor_sync, the 4 warps that share a row merge theirs through
//     shared memory in warp order, and the block writes the slice's
//     partial (m, l, label logit) per row to a float32 workspace (S, N,
//     3);
//   * ce_fwd_combine_kernel merges the S partials of a row in slice order
//     into lse and nll.  A thread, warp or slice that saw no column < V
//     holds m = -inf, l = 0 and adds nothing.  No atomics: two calls give
//     the same bits.
// S is chosen by the caller from the SM count so that at least one block
// falls on every SM (ops/kernels/fused_ce.py:fwd_splits).

#include <math_constants.h>

#include "fused_ce_mma.cuh"
#include "smem_optin.cuh"

namespace {

using G = DxGeo;  // 64 token rows x 256 vocab columns, warps 2 x 4

// The forward's shared memory: the ring of logits steps alone
template <typename T>
struct FwdSmem {
  using S = Smem<T, G, true>;
  static constexpr int LDK = S::LDK, LDW = S::LDW, STAGE = S::LOGITS;
  static constexpr size_t bytes() {
    return static_cast<size_t>(kStages) * STAGE * sizeof(T);
  }
};

// Running softmax state of a set of vocab columns of one row: the max m,
// the sum l of exp(logit - m) and the label's logit c (0 if the label is
// not among the columns)
struct Run {
  float m, l, c;
};

// a and b merged: the larger max, each sum rescaled to it; a state with
// m = -inf (no column seen) adds nothing
__device__ __forceinline__ Run merge(Run a, Run b) {
  const float m = fmaxf(a.m, b.m);
  const float la = a.m == -CUDART_INF_F ? 0.f : a.l * __expf(a.m - m);
  const float lb = b.m == -CUDART_INF_F ? 0.f : b.l * __expf(b.m - m);
  return {m, la + lb, a.c + b.c};
}

// Fold the tile at vocab column v0 (acc = x w of this thread's fragments)
// into the thread's running states, one per fragment row r = 2 mt + h.
// lab[r] is the row's label if it lies in 0..V-1, else -1.
__device__ __forceinline__ void fold_tile(const float acc[G::MT][G::NT][4],
                                          const Warp<G>& w, int v0, int V,
                                          const float* __restrict__ bias,
                                          const int lab[2 * G::MT],
                                          Run st[2 * G::MT]) {
  const int c0 = v0 + w.wn * G::WN + 2 * w.t;  // column of nt = 0, j = 0
  float bc[G::NT][2];
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = c0 + nt * 8 + j;
      bc[nt][j] = col < V ? __ldg(bias + col) : -CUDART_INF_F;
    }
  }
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * mt + h;
      float s[G::NT][2];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[nt][j] = acc[mt][nt][2 * h + j] + bc[nt][j];
          mx = fmaxf(mx, s[nt][j]);
        }
      }
      // this thread's columns of the tile hold the label: pick up its logit
      const int lc = lab[r] - c0;
      if (lc >= 0 && lc < 8 * G::NT && (lc & 6) == 0) {
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (lc == nt * 8 + j) st[r].c += s[nt][j];
          }
        }
      }
      const float m = fmaxf(st[r].m, mx);
      if (m == -CUDART_INF_F) continue;  // no column < V yet
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) sum += __expf(s[nt][j] - m);
      }
      // a first finite max rescales l = 0 by exp(-inf) = 0
      st[r].l = st[r].l * __expf(st[r].m - m) + sum;
      st[r].m = m;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias,
                  const int32_t* __restrict__ labels,
                  float* __restrict__ part, int n, int d, int V, int splits,
                  bool xvec, bool wvec) {
  using S = FwdSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const Warp<G> wp;
  const int n0 = blockIdx.x * G::BM;
  const int s = blockIdx.y;

  int lab[2 * G::MT];
  Run st[2 * G::MT];
#pragma unroll
  for (int r = 0; r < 2 * G::MT; ++r) {
    const int row = n0 + wp.wm * G::WM + (r / 2) * 16 + wp.g + (r % 2) * 8;
    const int l = row < n ? labels[row] : -1;
    lab[r] = l >= 0 && l < V ? l : -1;
    st[r] = {-CUDART_INF_F, 0.f, 0.f};
  }

  const int vt = (V + G::BN - 1) / G::BN;
  const int ntile = (vt - s + splits - 1) / splits;
  const int kt = d > 0 ? (d + kBK - 1) / kBK : 1;  // steps per vocab tile
  const int total = ntile * kt;

  // load step i, at position (tile j, step st), into its ring slot
  auto load_step = [&](int i, StepPos at) {
    load_logits_step<T, G, S>(ring + (i % kStages) * S::STAGE, x, w, n0,
                              (s + at.tile * splits) * G::BN,
                              at.step * kBK, n, d, V, xvec, wvec);
  };
  StepPos load_at;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) load_step(i, load_at);
    load_at.next(kt);
    cp_async_commit();
  }

  float acc[G::MT][G::NT][4];
  zero<G>(acc);
  StepPos at;
  for (int i = 0; i < total; ++i, at.next(kt)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < total) load_step(i + kStages - 1, load_at);
    load_at.next(kt);
    cp_async_commit();
    const T* buf = ring + (i % kStages) * S::STAGE;
    step_mma<G, true, true>(buf, S::LDK, buf + G::BM * S::LDK, S::LDW, wp,
                            acc);
    if (at.step == kt - 1) {
      fold_tile(acc, wp, (s + at.tile * splits) * G::BN, V, bias, lab, st);
      zero<G>(acc);
    }
  }

  // merge the quad's lanes, then the WARPS_N warps of each row in warp
  // order, and write the slice's partial
#pragma unroll
  for (int r = 0; r < 2 * G::MT; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const Run o = {__shfl_xor_sync(0xffffffffu, st[r].m, off),
                     __shfl_xor_sync(0xffffffffu, st[r].l, off),
                     __shfl_xor_sync(0xffffffffu, st[r].c, off)};
      st[r] = merge(st[r], o);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  Run* red = reinterpret_cast<Run*>(smem);  // [WARPS_N][BM]
  if (wp.t == 0) {
#pragma unroll
    for (int r = 0; r < 2 * G::MT; ++r) {
      red[wp.wn * G::BM + wp.wm * G::WM + (r / 2) * 16 + wp.g +
          (r % 2) * 8] = st[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < G::BM && n0 + static_cast<int>(threadIdx.x) < n) {
    Run a = red[threadIdx.x];
#pragma unroll
    for (int k = 1; k < G::WARPS_N; ++k) a = merge(a, red[k * G::BM + threadIdx.x]);
    float* p = part + (static_cast<size_t>(s) * n + n0 + threadIdx.x) * 3;
    p[0] = a.m;
    p[1] = a.l;
    p[2] = a.c;
  }
}

// lse, nll of each row from the ``splits`` partials, merged in slice order
__global__ void ce_fwd_combine_kernel(const float* __restrict__ part,
                                      float* __restrict__ nll,
                                      float* __restrict__ lse, int n,
                                      int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float* p = part + static_cast<size_t>(row) * 3;
  const size_t plane = static_cast<size_t>(n) * 3;
  float m = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, p[s * plane]);
  float l = 0.f, c = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ms = p[s * plane];
    if (ms != -CUDART_INF_F) l += p[s * plane + 1] * expf(ms - m);
    c += p[s * plane + 2];
  }
  const float L = m + logf(fmaxf(l, 1e-30f));
  lse[row] = L;
  nll[row] = L - c;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int fwd_attr() {
  static std::atomic<int> slots[kMaxDevices];
  return once_per_device(slots, [] {
    return static_cast<int>(cudaFuncSetAttribute(
        ce_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(FwdSmem<T>::bytes())));
  });
}

template <typename T>
int launch_fwd(const void* x, const void* w, const float* b,
               const int32_t* lab, float* part, int n, int d, int V,
               int splits, cudaStream_t st) {
  const int attr = fwd_attr<T>();
  if (attr != 0) return attr;
  constexpr int E = 16 / sizeof(T);
  const bool xvec = d % E == 0 && aligned16(x);
  const bool wvec = V % E == 0 && aligned16(w);
  const dim3 grid((n + G::BM - 1) / G::BM, splits);
  ce_fwd_kernel<T><<<grid, kThreads, FwdSmem<T>::bytes(), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b, lab, part, n, d,
      V, splits, xvec, wvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The slices' partials (m, l, label logit) into ``work`` float32
// (splits, n, 3), every element written; ``splits`` in 1..ceil(V/256).
// Launches on ``stream`` and returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int ff_fused_ce_fwd(const void* x, const void* w, const void* bias,
                               const void* labels, void* work, int n, int d,
                               int V, int splits, int is_bf16, void* stream) {
  if (n < 0 || d < 0 || V <= 0 || splits < 1 ||
      splits > (V + G::BN - 1) / G::BN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* part = static_cast<float*>(work);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(x, w, b, lab, part, n, d, V,
                                             splits, st)
                 : launch_fwd<float>(x, w, b, lab, part, n, d, V, splits,
                                     st);
}

// nll, lse (n,) float32 from the partials in ``work``.  Launches on
// ``stream`` and returns the CUDA error code.
extern "C" int ff_fused_ce_fwd_combine(const void* work, void* nll,
                                       void* lse, int n, int splits,
                                       void* stream) {
  if (n < 0 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  ce_fwd_combine_kernel<<<(n + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(work), static_cast<float*>(nll),
      static_cast<float*>(lse), n, splits);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the forward kernel for one dtype, in bytes
extern "C" int ff_fused_ce_fwd_smem(int is_bf16) {
  return static_cast<int>(is_bf16 ? FwdSmem<__nv_bfloat16>::bytes()
                                  : FwdSmem<float>::bytes());
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
