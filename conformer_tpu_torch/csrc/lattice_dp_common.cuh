// Shared by the CTC and transducer lattice DP kernels (ctc_dp.cu,
// rnnt_lattice.cu): one block per batch row whose threads walk the DP's
// states with a block stride, NS states a thread.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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

template <typename F, typename... Args>
cudaError_t run_kernel(F kernel, int B, int threads, size_t smem, cudaStream_t st,
                       Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
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
