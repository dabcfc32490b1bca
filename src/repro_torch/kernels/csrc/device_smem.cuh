// The opt-in past 48 KB of dynamic shared memory, kept per device.
//
// cudaFuncSetAttribute acts on the device current when it is called, so a
// limit set for a kernel on one card says nothing of another: a process
// that launches on cuda:0 and then on cuda:1 (a mesh placed round-robin
// over the cards) must set it on each. allow_smem keeps the limit set so
// far in a table indexed by the device.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace repro {

constexpr int kMaxDevices = 64;

// Let `kernel` take `bytes` of dynamic shared memory on the current device.
// `sized` is the caller's static table of kMaxDevices entries (zeroed); a
// device past the table sets the attribute on every call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* sized) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && sized[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && kept) sized[dev] = bytes;
  return err;
}

}  // namespace repro
