// Backward of the fused vocab projection + softmax cross-entropy for Hopper
// (sm_90a) on the tensor cores, plain CUDA C++ with a C interface (loaded
// with ctypes by flexflow_tpu_torch/ops/kernels/fused_ce.py).
//
// Replaces the Pallas TPU kernels _bwd_dx_kernel and _bwd_dw_kernel of
// flexflow_tpu/ops/pallas/fused_ce.py.  With logits = x w + b (x (N, d),
// w (d, V), b (V,) float32, labels (N,) int32), lse (N,) from the forward
// and two cotangent rows gp, goh (N,) (_tile_dlogits, fused_ce.py:112-124):
//     t_nv = gp_n * exp(logits_nv - lse_n) - goh_n * [v == label_n]
//     dx = t w^T,   dw = x^T t,   db = sum_n t_nv
// (a label < 0 or >= V matches nothing).  For a cotangent g of the
// per-token nll gp = goh = g; the vocab-slice form, whose lse is an output
// too, has gp = g_nll + g_lse and goh = g_nll.  Each kernel recomputes its
// logits tiles from x and w, as the Pallas kernels do; the (N, V) logits
// never reach device memory.  With bfloat16 operands t is rounded to
// bfloat16 before the dx and dw products; db sums it unrounded.
//
// What bounds it on an H100: each kernel does 4 N d V FLOPs (the logits,
// then one product), 1.65 TFLOP for the pair at the LM head's N 8192,
// d 768, V 32768.  Float32 FMAs outside the tensor cores (67 TFLOP/s)
// cannot come near the unfused cuBLAS pair, so every product runs on the
// tensor cores with mma.sync:
//   * float32 operands: 3xTF32.  Each operand a is split into
//     big = cvt.rna.tf32(a) and small = cvt.rna.tf32(a - big), and the
//     product is small*big + big*small + big*big in float32 accumulators
//     (m16n8k8 TF32), which keeps close to a float32 FMA's error; three
//     TF32 products at 495 TFLOP/s bound a kernel at 5.0 ms at the LM
//     shape.  The tiles land in shared memory raw, by cp.async; each
//     fragment is split when it is loaded, in integer ops that give
//     cvt.rna.tf32.f32's bits.
//   * bfloat16 operands: m16n8k16 bf16 products, float32 accumulators.
// TF32 wgmma takes only K-major operands from shared memory, and w (d, V)
// is V-major in the logits product, so mma.sync with this file's own
// shared-memory layouts is the route; wgmma for bf16 is later work.
//
// Design:
//   * a block of 8 warps owns a product tile of 64 token rows x 256
//     vocab columns (dx) or 256 token rows x 64 vocab columns (dw), each
//     warp a 16-mma sub-tile (2 x 8 or 4 x 4 mma tiles of 16 x 8);
//   * one ring of 3 shared-memory stages is fed by cp.async (16 bytes a
//     copy where the row length and base allow, else 4-byte copies for
//     float32 and plain loads for bfloat16; interior tiles skip the
//     masks) and walks a flat sequence of steps: per vocab tile (dx) or
//     token block (dw) first the logits' 32-deep slices of x and w, then
//     the second product's 32-deep slices of w (dx) or x (dw).  Loads run
//     two steps ahead, across phase and tile boundaries; one barrier per
//     step;
//   * after the last logits step t is formed in registers and stored to a
//     shared tile, the second product's A (dx) or B (dw) operand; its
//     row statistics (lse, gp, goh, label) and the bias are read there;
//   * the second product's output has the logits tile's shape: 64 rows x
//     256 dx columns per chunk over the tile's 256 vocab columns (dx), or
//     256 dw rows x 64 vocab columns per chunk over its 256 token rows
//     (dw), so both phases share one accumulator layout;
//   * dx: block (row block r, split s) walks the vocab tiles s, s + S,
//     ... and adds each chunk's sum to a float32 workspace (S, Npad,
//     Dpad) with 16-byte accesses (stored on its first tile);
//     ce_bwd_dx_sum_kernel then adds the S partials in a fixed order.  S
//     is chosen by the caller so that about two blocks fall on each SM;
//   * dw: block v walks the 256-row token blocks and adds each chunk's sum
//     into dw (16-byte accesses where V % 4 == 0, else each warp stages 8
//     rows at a time in shared memory and adds them a row of 32 columns
//     per access); db: per-thread column sums, added in a fixed order at
//     the end;
//   * no float atomics anywhere: every output element has one owner and a
//     fixed order of sums, so two calls give the same bits.
// The accumulator goes through device memory once per 256 vocab columns
// (dx) or token rows (dw): 6.45 GB of read-modify-write per call at the
// LM shape, from a live set of one 196 KB slice per resident block (~26
// MB) that fits in the 50 MB L2.  Each chunk's targets are prefetched
// into L2 when the chunk starts, and each thread starts all its reads of
// a chunk before its stores.
//
// The tiles, the ring, the warp products and the row statistics are in
// fused_ce_mma.cuh, which the forward (fused_ce.cu) shares.

#include "fused_ce_mma.cuh"
#include "smem_optin.cuh"

namespace {

__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc holds logits - b of the tile (rows n0.., vocab columns v0..): store
// t = gp softmax - goh onehot, rounded to T, to ts[row][col]; 0 outside the
// matrix.  db (if given) gets this thread's unrounded column sums.
template <typename T, typename G, int LDT>
__device__ __forceinline__ void write_t(const float acc[G::MT][G::NT][4],
                                        T* ts, const Warp<G>& w,
                                        const RowStats<G>& rs, int n0,
                                        int v0, int n, int V,
                                        const float* __restrict__ bias,
                                        float db[G::NT][2]) {
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = w.wn * G::WN + nt * 8 + 2 * w.t + j;
      const int gc = v0 + col;
      const float bc = gc < V ? bias[gc] : 0.f;
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 2 * mt + h;
          const int row = w.wm * G::WM + mt * 16 + w.g + 8 * h;
          const bool valid = n0 + row < n && gc < V;
          const float p =
              valid ? expf(acc[mt][nt][2 * h + j] + bc - rs.lse[r]) : 0.f;
          const float onehot = (valid && gc == rs.lab[r]) ? 1.f : 0.f;
          const float tv = rs.gp[r] * p - rs.goh[r] * onehot;
          if (db != nullptr) db[nt][j] += tv;
          store_t(ts + row * LDT + col, tv);
        }
      }
    }
  }
}

// The 16-byte access of this lane: lanes t and t ^ 1 trade halves so
// that the even lane holds row g, columns 4(t/2)..+3 of the 8-column mma
// tile and the odd lane the same columns of row g + 8.
__device__ __forceinline__ float4 pair_lanes(const float c[4], int t,
                                             int* row_off) {
  const bool odd = t & 1;
  const float s0 = odd ? c[0] : c[2];
  const float s1 = odd ? c[1] : c[3];
  const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  *row_off = odd ? 8 : 0;
  return odd ? make_float4(r0, r1, c[2], c[3])
             : make_float4(c[0], c[1], r0, r1);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// out (+)= this lane's float4s of the warp's sum: p[mt][nt] (null:
// outside the matrix) and v[mt][nt] from pair_lanes.  Every old value is
// loaded before the first store, so the reads are in flight together
// rather than one round trip after another.
template <typename G>
__device__ __forceinline__ void add_tile(float4* p[G::MT][G::NT],
                                         float4 v[G::MT][G::NT], bool first) {
  if (!first) {
    float4 o[G::MT][G::NT];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        o[mt][nt] = p[mt][nt] ? __ldcg(p[mt][nt]) : make_float4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        v[mt][nt].x = o[mt][nt].x + v[mt][nt].x;
        v[mt][nt].y = o[mt][nt].y + v[mt][nt].y;
        v[mt][nt].z = o[mt][nt].z + v[mt][nt].z;
        v[mt][nt].w = o[mt][nt].w + v[mt][nt].w;
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      if (p[mt][nt]) *p[mt][nt] = v[mt][nt];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ce_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias,
                     const int32_t* __restrict__ labels,
                     const float* __restrict__ lse,
                     const float* __restrict__ gp,
                     const float* __restrict__ goh, float* __restrict__ part,
                     int n, int d, int V, int splits, int npad, int dpad,
                     bool xvec, bool wvec) {
  using G = DxGeo;
  using S = Smem<T, G, true>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* ts = ring + kStages * S::STAGE;
  const Warp<G> wp;
  const int n0 = blockIdx.x * G::BM;
  const int s = blockIdx.y;
  RowStats<G> rs;
  rs.load(wp, n0, n, lse, gp, goh, labels);

  const int vt = (V + G::BN - 1) / G::BN;
  const int ntile = (vt - s + splits - 1) / splits;
  const int kt = d > 0 ? (d + kBK - 1) / kBK : 1;
  constexpr int VS = G::BN / kBK;              // steps per dx column chunk
  const int per = kt + (dpad / G::BN) * VS;    // steps per vocab tile
  const int total = ntile * per;
  float* out = part + static_cast<size_t>(s) * npad * dpad;

  // load step i, at position (tile j, step st), into its ring slot
  auto load_step = [&](int i, StepPos at) {
    const int v0 = (s + at.tile * splits) * G::BN;
    const int st = at.step;
    T* buf = ring + (i % kStages) * S::STAGE;
    if (st < kt) {
      load_logits_step<T, G, S>(buf, x, w, n0, v0, st * kBK, n, d, V, xvec,
                                wvec);
    } else {
      const int q = st - kt;
      // w[c0 + c][v0 + kk + k], stored [c][k]
      load_tile<T, G::BN, kBK>(buf, S::LDK, w, V, (q / VS) * G::BN,
                               v0 + (q % VS) * kBK, d, V, wvec);
    }
  };
  StepPos load_at;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) load_step(i, load_at);
    load_at.next(per);
    cp_async_commit();
  }

  float acc[G::MT][G::NT][4];
  zero<G>(acc);
  StepPos at;
  for (int i = 0; i < total; ++i, at.next(per)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < total) load_step(i + kStages - 1, load_at);
    load_at.next(per);
    cp_async_commit();
    const int j = at.tile;
    const int st = at.step;
    const T* buf = ring + (i % kStages) * S::STAGE;
    if (st < kt) {
      step_mma<G, true, true>(buf, S::LDK, buf + G::BM * S::LDK, S::LDW, wp,
                              acc);
      if (st == kt - 1) {
        write_t<T, G, S::LDT>(acc, ts, wp, rs, n0, (s + j * splits) * G::BN,
                              n, V, bias, nullptr);
        zero<G>(acc);
      }
    } else {
      const int q = st - kt;
      const int sub = q % VS;
      const int c0 = (q / VS) * G::BN;
      if (sub == 0 && j > 0) {
        // bring the partial sums this chunk adds to into L2 now, the
        // chunk's steps before they are read
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < G::NT; ++nt) {
            const int row =
                n0 + wp.wm * G::WM + mt * 16 + wp.g + 8 * (wp.t & 1);
            const int col = c0 + wp.wn * G::WN + nt * 8 + 4 * (wp.t / 2);
            prefetch_l2(out + static_cast<size_t>(row) * dpad + col);
          }
        }
      }
      // acc += t[:, sub*kBK..] . w[c0.., v0 + sub*kBK..]^T
      step_mma<G, true, false>(ts + sub * kBK, S::LDT, buf, S::LDK, wp, acc);
      if (sub == VS - 1) {
        float4* p[G::MT][G::NT];
        float4 v[G::MT][G::NT];
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < G::NT; ++nt) {
            int ro;
            v[mt][nt] = pair_lanes(acc[mt][nt], wp.t, &ro);
            const int row = n0 + wp.wm * G::WM + mt * 16 + wp.g + ro;
            const int col = c0 + wp.wn * G::WN + nt * 8 + 4 * (wp.t / 2);
            p[mt][nt] = reinterpret_cast<float4*>(
                out + static_cast<size_t>(row) * dpad + col);
          }
        }
        add_tile<G>(p, v, j == 0);
        zero<G>(acc);
      }
    }
  }
  cp_async_wait<0>();
}

// dx[row][c] = sum over s = 0..splits-1, in that order, of part[s][row][c]
__global__ void ce_bwd_dx_sum_kernel(const float* __restrict__ part,
                                     float* __restrict__ dx, int n, int d,
                                     int splits, int npad, int dpad) {
  const size_t total = static_cast<size_t>(n) * d;
  const size_t plane = static_cast<size_t>(npad) * dpad;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = e / d;
    const size_t c = e - row * d;
    const float* p = part + row * dpad + c;
    float acc = p[0];
    for (int s = 1; s < splits; ++s) acc += p[s * plane];
    dx[e] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ce_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias,
                     const int32_t* __restrict__ labels,
                     const float* __restrict__ lse,
                     const float* __restrict__ gp,
                     const float* __restrict__ goh, float* __restrict__ dw,
                     float* __restrict__ db, int n, int d, int V, bool xvec,
                     bool wvec, bool dwvec) {
  using G = DwGeo;
  using S = Smem<T, G, false>;
  static_assert(G::WN == 32, "the staging path adds 32 columns a warp");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* ts = ring + kStages * S::STAGE;
  float* stage = reinterpret_cast<float*>(ts + G::BM * S::LDT) +
                 (threadIdx.x / 32) * 8 * kStageLd;
  const Warp<G> wp;
  const int v0 = blockIdx.x * G::BN;

  const int nb = (n + G::BM - 1) / G::BM;
  const int kt = d > 0 ? (d + kBK - 1) / kBK : 1;
  constexpr int RS = G::BM / kBK;                       // steps per chunk
  const int per = kt + ((d + G::BM - 1) / G::BM) * RS;  // per row block
  const int total = nb * per;

  // load step i, at position (row block r, step st), into its ring slot
  auto load_step = [&](int i, StepPos at) {
    const int n0 = at.tile * G::BM;
    const int st = at.step;
    T* buf = ring + (i % kStages) * S::STAGE;
    if (st < kt) {
      load_logits_step<T, G, S>(buf, x, w, n0, v0, st * kBK, n, d, V, xvec,
                                wvec);
    } else {
      const int q = st - kt;
      // x[n0 + kk + k][c0 + c], stored [k][c]
      load_tile<T, kBK, G::BM>(buf, S::LDX, x, d, n0 + (q % RS) * kBK,
                               (q / RS) * G::BM, n, d, xvec);
    }
  };
  StepPos load_at;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) load_step(i, load_at);
    load_at.next(per);
    cp_async_commit();
  }

  float acc[G::MT][G::NT][4];
  float dbp[G::NT][2] = {};
  RowStats<G> rs;
  zero<G>(acc);
  StepPos at;
  for (int i = 0; i < total; ++i, at.next(per)) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < total) load_step(i + kStages - 1, load_at);
    load_at.next(per);
    cp_async_commit();
    const int r = at.tile;
    const int st = at.step;
    const int n0 = r * G::BM;
    const T* buf = ring + (i % kStages) * S::STAGE;
    if (st < kt) {
      step_mma<G, true, true>(buf, S::LDK, buf + G::BM * S::LDK, S::LDW, wp,
                              acc);
      if (st == kt - 1) {
        rs.load(wp, n0, n, lse, gp, goh, labels);
        write_t<T, G, S::LDT>(acc, ts, wp, rs, n0, v0, n, V, bias, dbp);
        zero<G>(acc);
      }
    } else {
      const int q = st - kt;
      const int sub = q % RS;
      const int c0 = (q / RS) * G::BM;
      if (sub == 0 && r > 0) {
        // bring the dw rows this chunk adds to into L2 now, the chunk's
        // steps before they are read
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < G::NT; ++nt) {
            const int c =
                c0 + wp.wm * G::WM + mt * 16 + wp.g + 8 * (wp.t & 1);
            const int col = v0 + wp.wn * G::WN + nt * 8 + 4 * (wp.t / 2);
            if (c < d && col < V) {
              prefetch_l2(dw + static_cast<size_t>(c) * V + col);
            }
          }
        }
      }
      // acc += x[n0 + sub*kBK.., c0..]^T . t[sub*kBK.., :]
      step_mma<G, false, true>(buf, S::LDX, ts + sub * kBK * S::LDT, S::LDT,
                               wp, acc);
      if (sub == RS - 1) {
        if (dwvec) {
          float4* p[G::MT][G::NT];
          float4 v[G::MT][G::NT];
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
            for (int nt = 0; nt < G::NT; ++nt) {
              int ro;
              v[mt][nt] = pair_lanes(acc[mt][nt], wp.t, &ro);
              const int c = c0 + wp.wm * G::WM + mt * 16 + wp.g + ro;
              const int col = v0 + wp.wn * G::WN + nt * 8 + 4 * (wp.t / 2);
              p[mt][nt] = c < d && col < V
                              ? reinterpret_cast<float4*>(
                                    dw + static_cast<size_t>(c) * V + col)
                              : nullptr;
            }
          }
          add_tile<G>(p, v, r == 0);
        } else {
          // rows of dw that 16-byte accesses cannot reach: the warp
          // stages 8 x 32 of its tile at a time and adds it a row at a
          // time, lane = column, so each access covers 128 contiguous
          // bytes
          const int lane = static_cast<int>(threadIdx.x) % 32;
          const int col = v0 + wp.wn * G::WN + lane;
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              __syncwarp();
#pragma unroll
              for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  stage[wp.g * kStageLd + nt * 8 + 2 * wp.t + e] =
                      acc[mt][nt][2 * h + e];
                }
              }
              __syncwarp();
              const int c1 = c0 + wp.wm * G::WM + mt * 16 + 8 * h;
              float* p = dw + static_cast<size_t>(c1) * V + col;
              float o[8];
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                o[k] = (r > 0 && c1 + k < d && col < V)
                           ? __ldcg(p + static_cast<size_t>(k) * V)
                           : 0.f;
              }
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                if (c1 + k < d && col < V) {
                  p[static_cast<size_t>(k) * V] =
                      o[k] + stage[k * kStageLd + lane];
                }
              }
            }
          }
        }
        zero<G>(acc);
      }
    }
  }

  // db: the WARPS_M * 8 partial sums of each column (8 row lanes x the
  // warp rows), added in a fixed order
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [WARPS_M * 8][BN]
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      red[(wp.wm * 8 + wp.g) * G::BN + wp.wn * G::WN + nt * 8 + 2 * wp.t +
          j] = dbp[nt][j];
    }
  }
  __syncthreads();
  if (threadIdx.x < G::BN) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < G::WARPS_M * 8; ++k) {
      sum += red[k * G::BN + threadIdx.x];
    }
    const int col = v0 + static_cast<int>(threadIdx.x);
    if (col < V) db[col] = sum;
  }
}

bool bad_dims(int n, int d, int V) { return n < 0 || d < 0 || V <= 0; }

int round_up(int a, int b) { return (a + b - 1) / b * b; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// cudaFuncSetAttribute for the dynamic shared memory, once per instance
// and device (``smem_optin.cuh``)
template <typename K>
int smem_attr(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
template <typename T>
int dx_attr() {
  static std::atomic<int> slots[kMaxDevices];
  return once_per_device(slots, [] {
    return smem_attr(ce_bwd_dx_kernel<T>, Smem<T, DxGeo, true>::bytes());
  });
}
template <typename T>
int dw_attr() {
  static std::atomic<int> slots[kMaxDevices];
  return once_per_device(slots, [] {
    return smem_attr(ce_bwd_dw_kernel<T>, Smem<T, DwGeo, false>::bytes());
  });
}

template <typename T>
int launch_dx(const void* x, const void* w, const float* b,
              const int32_t* lab, const float* l, const float* gp,
              const float* goh, float* part, int n, int d, int V, int splits,
              cudaStream_t st) {
  const int attr = dx_attr<T>();
  if (attr != 0) return attr;
  constexpr int E = 16 / sizeof(T);
  const bool xvec = d % E == 0 && aligned16(x);
  const bool wvec = V % E == 0 && aligned16(w);
  const dim3 grid((n + DxGeo::BM - 1) / DxGeo::BM, splits);
  ce_bwd_dx_kernel<T><<<grid, kThreads, Smem<T, DxGeo, true>::bytes(), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b, lab, l, gp, goh,
      part, n, d, V, splits, round_up(n, DxGeo::BM), round_up(d, DxGeo::BN),
      xvec, wvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dw(const void* x, const void* w, const float* b,
              const int32_t* lab, const float* l, const float* gp,
              const float* goh, float* dw, float* db, int n, int d, int V,
              cudaStream_t st) {
  const int attr = dw_attr<T>();
  if (attr != 0) return attr;
  constexpr int E = 16 / sizeof(T);
  const bool xvec = d % E == 0 && aligned16(x);
  const bool wvec = V % E == 0 && aligned16(w);
  const bool dwvec = V % 4 == 0 && aligned16(dw);
  const dim3 grid((V + DwGeo::BN - 1) / DwGeo::BN);
  ce_bwd_dw_kernel<T><<<grid, kThreads, Smem<T, DwGeo, false>::bytes(), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b, lab, l, gp, goh,
      dw, db, n, d, V, xvec, wvec, dwvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Partial dx sums into ``work`` float32 (splits, round_up(n, 64),
// round_up(d, 256)), every element written; ``splits`` in
// 1..ceil(V/256).  Launches on ``stream`` and returns the CUDA error code
// (0 on success).
extern "C" int ff_fused_ce_bwd_dx(const void* x, const void* w,
                                  const void* bias, const void* labels,
                                  const void* lse, const void* gp,
                                  const void* goh, void* work, int n, int d,
                                  int V, int splits,
                                  int is_bf16, void* stream) {
  if (bad_dims(n, d, V) || splits < 1 ||
      splits > (V + DxGeo::BN - 1) / DxGeo::BN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || d == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gpp = static_cast<const float*>(gp);
  const float* gohp = static_cast<const float*>(goh);
  float* part = static_cast<float*>(work);
  return is_bf16 ? launch_dx<__nv_bfloat16>(x, w, b, lab, l, gpp, gohp, part,
                                            n, d, V, splits, st)
                 : launch_dx<float>(x, w, b, lab, l, gpp, gohp, part, n, d,
                                    V, splits, st);
}

// dx (n, d) float32 = the sum of the ``splits`` partials in ``work``, in
// split order.  Launches on ``stream`` and returns the CUDA error code.
extern "C" int ff_fused_ce_bwd_dx_sum(const void* work, void* dx, int n,
                                      int d, int splits, void* stream) {
  if (n < 0 || d < 0 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || d == 0) return 0;
  const size_t total = static_cast<size_t>(n) * d;
  const unsigned blocks =
      static_cast<unsigned>(total / 256 + 1 < 8192 ? total / 256 + 1 : 8192);
  ce_bwd_dx_sum_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(work), static_cast<float*>(dx), n, d, splits,
      round_up(n, DxGeo::BM), round_up(d, DxGeo::BN));
  return static_cast<int>(cudaGetLastError());
}

// dw (d, V) and db (V,) float32, every element written (the caller passes
// n > 0).  Launches on ``stream`` and returns the CUDA error code.
extern "C" int ff_fused_ce_bwd_dw(const void* x, const void* w,
                                  const void* bias, const void* labels,
                                  const void* lse, const void* gp,
                                  const void* goh, void* dw, void* db, int n,
                                  int d, int V, int is_bf16, void* stream) {
  if (bad_dims(n, d, V) || n == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* gpp = static_cast<const float*>(gp);
  const float* gohp = static_cast<const float*>(goh);
  float* dwp = static_cast<float*>(dw);
  float* dbp = static_cast<float*>(db);
  return is_bf16 ? launch_dw<__nv_bfloat16>(x, w, b, lab, l, gpp, gohp, dwp,
                                            dbp, n, d, V, st)
                 : launch_dw<float>(x, w, b, lab, l, gpp, gohp, dwp, dbp, n, d,
                                    V, st);
}

extern "C" const char* ff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
