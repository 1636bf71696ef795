// What the port's CUDA libraries share: the shared-memory limit, the 16-byte
// cp.async copy and the resident-block query.  Each csrc/*.cu that needs them
// includes this file; _build hashes it with every source that does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

// A block's dynamic shared memory at most on sm_90 (227 KB; the wrappers'
// size rules read it as _build.MAX_SMEM_BYTES).
constexpr size_t kMaxSmemBytes = 232448;

// One 16-byte copy from device memory into shared memory, in the calling
// thread's current cp.async group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The blocks of `kernel` (`threads` threads, `bytes` of dynamic shared
// memory) that stay resident on the current device, at least one per SM;
// queried once per (device, kernel, threads, bytes).  The kernel is allowed
// the most dynamic shared memory any of its queries asked for, so every
// shape queried before stays launchable.
inline cudaError_t resident_blocks(const void* kernel, int threads, size_t bytes,
                                   long long* blocks) {
  struct Seen {
    int dev;
    const void* kernel;
    int threads;
    size_t bytes;
    long long blocks;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  size_t allow = bytes;
  for (const Seen& s : seen) {
    if (s.dev != dev || s.kernel != kernel) continue;
    if (s.threads == threads && s.bytes == bytes) {
      *blocks = s.blocks;
      return cudaSuccess;
    }
    if (s.bytes > allow) allow = s.bytes;
  }
  int sms, per_sm;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)allow);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  }
  if (e != cudaSuccess) return e;
  *blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  seen.push_back({dev, kernel, threads, bytes, *blocks});
  return cudaSuccess;
}

}  // namespace
