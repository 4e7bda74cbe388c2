// Kaldi log-mel filterbank features on the card, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/fbank_kernel.py
// (fbank_pallas / _fbank_kernel). Per frame of ws samples (snip_edges
// framing, shift samples apart) of a waveform already scaled by 2^15:
// dither, DC removal, preemphasis 0.97 with the first sample replicated,
// the povey window, the real DFT as two products against [ws x F] cos and
// sin matrices (F = padded / 2 bins), the power spectrum, the [F x M] mel
// product and log(max(., float32 epsilon)). All float32, no TF32.
//
// Dither: the TPU kernel draws from the TPU's own generator, which no other
// machine reproduces. Here each (seed, b, frame, sample) is hashed into two
// uniforms and Box-Muller gives the normal; ops/fbank_kernel.py's plain
// version implements the same hash, so that kernel and plain version agree
// with dither on.
//
// Bound: the products, 2 ws F 2 + 2 F M flops per frame, 3.2e10 at 48
// utterances of 15 s (71,904 frames): 0.48 ms at the card's float32 rate;
// the bytes (waveform in, features out: ~69 MB) take ~0.02 ms.
//
// Design: one block of 256 threads per (utterance, tile of 16 frames)
// reads its frames straight from the waveform (the TPU kernel let XLA
// gather them first) into shared memory, dithers, and conditions each
// frame with one warp. For the DFT thread k owns bin k of the tile's 16
// frames: it streams column k of the cos and sin matrices (the matrices,
// 800 KB, stay in L2; neighbouring threads read neighbouring columns) and
// broadcasts the frames' samples from shared memory, 32 FMAs per pair of
// loads. The power spectrum stays in shared memory for the mel product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TF = 16;                 // frames per block
constexpr int kMaxPerLane = 32;        // samples per lane when a warp conditions a frame
constexpr float kEps = 1.1920928955078125e-07f;
constexpr float kTwoPi = 6.283185307179586f;

// two uniforms per (seed, b, frame, sample): counter hash, stream 0 and 1
__device__ __forceinline__ uint32_t dither_hash(uint32_t seed, uint32_t b, uint32_t t,
                                                uint32_t n, uint32_t stream) {
  uint32_t x = ((seed * 0x9E3779B9u + b * 0x85EBCA6Bu) ^ (t * 0xC2B2AE35u)) ^
               (n * 0x27D4EB2Fu) ^ (stream * 0x165667B1u);
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float dither_normal(uint32_t seed, uint32_t b, uint32_t t,
                                               uint32_t n) {
  const float u1 = (float)((dither_hash(seed, b, t, n, 0u) >> 8) + 1u) * (1.0f / 16777216.0f);
  const float u2 = (float)(dither_hash(seed, b, t, n, 1u) >> 8) * (1.0f / 16777216.0f);
  return sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
}

__global__ void __launch_bounds__(kThreads)
fbank_kernel(const float* __restrict__ wave, const float* __restrict__ window,
             const float* __restrict__ cosm, const float* __restrict__ sinm,
             const float* __restrict__ melt, float* __restrict__ out, int N, int T, int ws,
             int shift, int nf, int nmel, float dither, uint32_t seed) {
  extern __shared__ float smem[];
  float* fr = smem;                    // [TF][ws] frames
  float* pw = smem + TF * ws;          // [TF][nf] power spectrum
  const int b = blockIdx.y, t0 = blockIdx.x * TF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* wb = wave + (size_t)b * N;

  for (int i = threadIdx.x; i < TF * ws; i += kThreads) {
    const int f = i / ws, n = i - f * ws, t = t0 + f;
    float x = 0.f;
    if (t < T) {
      x = wb[(size_t)t * shift + n];
      if (dither != 0.f) x += dither * dither_normal(seed, b, t, n);
    }
    fr[i] = x;
  }
  __syncthreads();

  // DC removal, preemphasis, window: one warp per frame
  for (int f = warp; f < TF; f += kWarps) {
    float* x = fr + f * ws;
    float s = 0.f;
    for (int n = lane; n < ws; n += 32) s += x[n];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mean = s / (float)ws;
    float y[kMaxPerLane];
#pragma unroll
    for (int q = 0; q < kMaxPerLane; ++q) {
      const int n = lane + 32 * q;
      if (n < ws) {
        const float cur = x[n] - mean;
        const float prev = x[n > 0 ? n - 1 : 0] - mean;
        y[q] = (cur - 0.97f * prev) * window[n];
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kMaxPerLane; ++q) {
      const int n = lane + 32 * q;
      if (n < ws) x[n] = y[q];
    }
  }
  __syncthreads();

  // real DFT and power: thread k owns bin k of the tile's frames
  for (int k = threadIdx.x; k < nf; k += kThreads) {
    float re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) re[f] = im[f] = 0.f;
    for (int n = 0; n < ws; ++n) {
      const float c = cosm[(size_t)n * nf + k], s = sinm[(size_t)n * nf + k];
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        const float x = fr[f * ws + n];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < TF; ++f) pw[f * nf + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  // mel product and log
  for (int i = threadIdx.x; i < TF * nmel; i += kThreads) {
    const int f = i / nmel, m = i - f * nmel, t = t0 + f;
    if (t >= T) continue;
    const float* p = pw + f * nf;
    float s = 0.f;
    for (int k = 0; k < nf; ++k) s = fmaf(p[k], melt[(size_t)k * nmel + m], s);
    out[((size_t)b * T + t) * nmel + m] = logf(fmaxf(s, kEps));
  }
}

}  // namespace

// wave [B, N] float32 (x 2^15), window [ws], cosm / sinm [ws, nf], melt
// [nf, nmel] -> out [B, T, nmel] float32. ws <= 1024.
extern "C" int fbank_features(const void* wave, const void* window, const void* cosm,
                              const void* sinm, const void* melt, void* out, void* stream, int B,
                              int N, int T, int ws, int shift, int nf, int nmel, int seed,
                              float dither) {
  if (ws > 32 * kMaxPerLane) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * TF * (size_t)(ws + nf);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T + TF - 1) / TF, B);
  fbank_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(wave), static_cast<const float*>(window),
      static_cast<const float*>(cosm), static_cast<const float*>(sinm),
      static_cast<const float*>(melt), static_cast<float*>(out), N, T, ws, shift, nf, nmel,
      dither, static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}
