// Helpers shared by the port's kernels: the SM count, and for those that use
// Hopper's asynchronous copies or more than 48 KB of shared memory, shared
// addresses and the shared-memory limit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro {

constexpr int kMaxDevices = 64;  // devices whose attributes are cached

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The device's SM count, read once per device (132 if it cannot be read).
inline int sm_count(int device) {
  static std::atomic<int> cache[kMaxDevices];
  const bool cached = device >= 0 && device < kMaxDevices;
  int v = cached ? cache[device].load(std::memory_order_relaxed) : 0;
  if (v == 0) {
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        v <= 0)
      v = 132;
    if (cached) cache[device].store(v, std::memory_order_relaxed);
  }
  return v;
}

// Raise `Kernel`'s dynamic shared-memory limit to `bytes` (needed above
// 48 KB).  The size is fixed for each kernel, so it is raised once per
// device.
template <auto Kernel>
cudaError_t allow_smem(int bytes, int device) {
  static std::atomic<bool> raised[kMaxDevices];
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && raised[device].load(std::memory_order_acquire))
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && cached)
    raised[device].store(true, std::memory_order_release);
  return err;
}

}  // namespace repro
