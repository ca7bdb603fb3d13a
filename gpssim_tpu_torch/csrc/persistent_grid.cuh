// The persistent grid of K1 (synth_k1.cu) and K2 (synth_k2.cu), host side,
// so that the two launches cannot drift apart.
//
// Both kernels launch as many CTAs as are resident on the card at once (the
// SM count times the occupancy at the launch's shared memory) and give each
// one contiguous range of the rows to compute; a range may cross block
// boundaries. Fewer rows than resident CTAs gives one row per CTA.
//
// The kernel's attributes are set and its occupancy queried once per
// kernel, device and channel count, under a mutex, so that launches from
// several threads (the mesh) share one cache and a launch makes no CUDA
// attribute or occupancy call after the first. The functions are static:
// each kernel's library keeps its own cache. (No anonymous namespace here:
// the kernels' own anonymous namespaces use this one, and nvcc's generated
// registration code would then find two.)

#pragma once

#include <algorithm>
#include <mutex>
#include <vector>
#include <cuda_runtime.h>

#include "stage_b.cuh"

namespace gpssim {

struct PersistentGrid {
  int resident;       // CTAs resident on the device at once
  int ctas;           // CTAs launched
  long long per_cta;  // rows per CTA; the last CTA may have fewer
};

// `total` rows in equal contiguous ranges, one per CTA, at most `resident`
// CTAs.
static inline PersistentGrid partition(long long total, int resident) {
  const long long ctas = std::min(total, static_cast<long long>(resident));
  const long long per = (total + ctas - 1) / ctas;
  return {resident, static_cast<int>((total + per - 1) / per), per};
}

// The CTAs of `kernel` (`threads` threads and gain_table_bytes(C) of
// dynamic shared memory per CTA) resident on the current device at once.
static inline cudaError_t resident_ctas(const void* kernel, int threads,
                                        int C, int* ctas) {
  struct Entry {
    const void* kernel;
    int dev, C, ctas;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.kernel == kernel && e.dev == dev && e.C == C) {
      *ctas = e.ctas;
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(gain_table_bytes(MAX_C)));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, gain_table_bytes(C));
  }
  if (err != cudaSuccess) return err;
  if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
  cache.push_back({kernel, dev, C, sms * per_sm});
  *ctas = sms * per_sm;
  return cudaSuccess;
}

// The grid that `kernel` launches over `total` rows (total >= 1, 1 <= C <=
// MAX_C) in *g.
static inline cudaError_t persistent_grid(const void* kernel, int threads,
                                          int C, long long total,
                                          PersistentGrid* g) {
  int resident = 0;
  const cudaError_t err = resident_ctas(kernel, threads, C, &resident);
  if (err == cudaSuccess) *g = partition(total, resident);
  return err;
}

}  // namespace gpssim
