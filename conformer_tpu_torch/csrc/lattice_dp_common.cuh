// Shared by the CTC and transducer lattice DP kernels (ctc_dp.cu,
// rnnt_lattice.cu): the block path (one block per batch row whose threads
// walk the DP's states with a block stride, NS states a thread), the MUFU
// logaddexp of the faster paths, and 4-byte cp.async.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the MUFU operations behind __expf and __logf, without their fix-ups for
// subnormal numbers (none reaches them here: lg2 takes 1 + y in [1, 2], and
// an ex2 result below 2^-126, flushed to 0, adds nothing to 1 + y or to a
// gradient)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp_fast(float x) { return ex2(x * LOG2E); }

// logaddexp(a, b) = max + lg2(1 + ex2(-|a - b| log2 e)) ln 2: within ~6.6e-7
// of the accurate form (tests/test_torch_losses.py emulates it)
__device__ __forceinline__ float lae_fast(float a, float b) {
  const float m = fmaxf(a, b);
  return fmaf(lg2(1.f + ex2(fabsf(a - b) * -LOG2E)), LN2, m);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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
