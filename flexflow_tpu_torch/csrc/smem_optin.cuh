// The opt-in of a kernel to more than 48 KB of dynamic shared memory
// (cudaFuncSetAttribute) holds for the device current at the call, so a
// process that launches on several cards (the disaggregated serving
// pools, a replica a card) opts in once on each.  Included by kernels
// 1-6's sources; their wrappers make the tensors' device current.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxDevices = 64;

// ``set()``'s code, run once per device for the call site owning
// ``slots``, a static array of its own (a zero slot: not run yet;
// otherwise the code + 1).  Two threads racing on a device's first launch
// may both run ``set``, which is idempotent.
template <typename F>
int once_per_device(std::atomic<int> (&slots)[kMaxDevices], F set) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return set();
  int v = slots[dev].load(std::memory_order_acquire);
  if (v == 0) {
    v = set() + 1;
    slots[dev].store(v, std::memory_order_release);
  }
  return v - 1;
}

}  // namespace
