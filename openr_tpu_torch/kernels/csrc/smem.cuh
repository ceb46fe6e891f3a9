// Dynamic shared memory past the default 48 KiB, granted once.
//
// A kernel takes more than 48 KiB of dynamic shared memory only after
// cudaFuncSetAttribute raises its limit.  That call costs host time on
// every launch that makes it, so allow_smem makes it once per kernel and
// device, and again only when a launch asks for more than was granted.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr size_t kDefaultSmem = 48 * 1024;

template <auto kKernel>
cudaError_t allow_smem(size_t smem) {
  constexpr int kDevices = 64;
  static size_t granted[kDevices] = {};  // bytes granted so far, per device
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && granted[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kDevices) granted[dev] = smem;
  return err;
}

}  // namespace
