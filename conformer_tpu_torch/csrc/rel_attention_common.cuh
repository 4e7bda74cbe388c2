// Shared by the relative-position flash-attention kernels
// (rel_flash_attention.cu, forward; rel_flash_attention_bwd.cu, backward):
// constants, float conversions, and the dropout keep-mask hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rel_attn {

constexpr float NEG_INF = -1e30f;
constexpr float LSE_BIG = 1e30f;   // lse of a fully masked row: exp(s - lse) = 0

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dropout keep-mask of one attention probability, the counter hash of the
// TPU kernel's _tile_keep_mask (conformer_tpu/ops/pallas/attention_kernel.py
// :41) in uint32 arithmetic: a function of (seed, b*H + h, global query row,
// global key column) alone, so the forward and both backward kernels, which
// walk the tiles in different orders, regenerate the same mask, and the
// probability matrix never exists in memory. Keep where x >= thr, thr =
// uint32(rate * 2^32), so the keep rate is 1 - rate within 2^-32.
__device__ __forceinline__ bool keep_prob(uint32_t seed, uint32_t bh, uint32_t row,
                                          uint32_t col, uint32_t thr) {
  uint32_t x = ((seed * 0x9E3779B9u + bh * 0x85EBCA6Bu) ^ (row * 0xC2B2AE35u)) ^
               (col * 0x27D4EB2Fu);
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return x >= thr;
}

}  // namespace rel_attn
