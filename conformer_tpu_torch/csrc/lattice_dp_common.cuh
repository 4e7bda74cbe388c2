// Shared by the CTC and transducer lattice DP kernels (ctc_dp.cu,
// rnnt_lattice.cu): one block per batch row whose threads walk the DP's
// states with a block stride, NS states a thread.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <set>
#include <utility>

namespace lattice_dp {

constexpr float kNeg = -1e30f;
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// steps staged in registers per chunk: NS * CH <= 16 values per array
template <int NS>
__host__ __device__ constexpr int chunk() {
  return NS >= 16 ? 1 : 16 / NS;
}

// states per thread (a power of two) and threads (a multiple of 32) for n
// states
inline void shape_for(int n, int* ns, int* threads) {
  int k = 1;
  while (k * MAX_THREADS < n) k *= 2;
  *ns = k;
  *threads = ((n + k - 1) / k + 31) / 32 * 32;
}

constexpr int SMEM_OPT_IN = 232448;     // bytes of shared memory a block may use on Hopper

// Lets ``kernel`` take up to SMEM_OPT_IN bytes of dynamic shared memory on
// the current device: once per kernel and device, not at every launch (a
// runtime call at every launch costs host time in a loop of launches).
inline cudaError_t allow_large_smem(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<int, const void*>> done;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({dev, kernel})) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
  if (e == cudaSuccess) done.insert({dev, kernel});
  return e;
}

template <typename F, typename... Args>
cudaError_t run_kernel(F kernel, int B, int threads, size_t smem, cudaStream_t st,
                       Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = allow_large_smem(reinterpret_cast<const void*>(kernel));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace lattice_dp

// returns run(KERNEL<ns>) for the states-per-thread count ns
#define LATTICE_DP_DISPATCH(KERNEL)          \
  switch (ns) {                              \
    case 1: return run(KERNEL<1>);           \
    case 2: return run(KERNEL<2>);           \
    case 4: return run(KERNEL<4>);           \
    case 8: return run(KERNEL<8>);           \
    case 16: return run(KERNEL<16>);         \
    case 32: return run(KERNEL<32>);         \
    case 64: return run(KERNEL<64>);         \
    default: return cudaErrorInvalidValue;   \
  }
