// Fused Conformer convolution block, inference forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/conv_kernel.py
// (conv_block_fused, _conv_kernel). Per sequence of length T with `length`
// valid frames it computes
//
//   y   = LN_pre(x), zeroed for frames >= length, rounded to x's dtype
//   g   = GLU(y W1 + b1)               (frames in [length, T) keep bias-GLU)
//   z   = depthwise_K(g) + bd          (SAME: ctx//2 left, ctx - ctx//2 right,
//                                       zeros only outside [0, T))
//   out = x + mask(pw2(swish(LN(z))))  (swish output rounded to x's dtype)
//   cache = the trailing K-1 frames of g, zero-left-padded when T < K-1
//
// with float32 math throughout, as the TPU kernel does.
//
// Bound: at the decode shape (B=48, T=374, D=256, K=15, bf16) the two
// pointwise products need about 7.1 GFLOP (~7 us at the bf16 tensor rate)
// and the inputs and outputs move about 18 MB (~5.5 us at 3.35 TB/s).
//
// Design (simple and right first): the TPU kernel kept a whole sequence
// and its [T, 2D] pw1 result in VMEM. Here it is two launches. The first
// computes LN_pre + pw1 + GLU for a tile of 64 frames and 32 GLU channels
// (the matching a and b columns of W1) and writes g to a float32 scratch
// [B,T,D]. The second takes a 32-frame tile with its K-1 frame halo of g
// into shared memory, runs the depthwise taps, LN, swish, the pw2 product
// with W2 streamed through shared memory in 16-row slices, the length mask
// and the residual. Products are float32 FMAs on the CUDA cores; D must be
// a multiple of 32 and at most 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round a float32 value through the activation dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// ---------------------------------------------------------------- launch 1
constexpr int P1_M = 64;   // frames per block
constexpr int P1_C = 32;   // GLU channels per block (64 columns of W1)
constexpr int P1_K = 32;   // k-slice

template <typename T>
__global__ void __launch_bounds__(NT) pw1_glu_kernel(
    const T* __restrict__ x, const int* __restrict__ lengths,
    const float* __restrict__ pre_s, const float* __restrict__ pre_b,
    const T* __restrict__ w1, const float* __restrict__ b1, float* __restrict__ glu,
    int Tlen, int D) {
  __shared__ float sMean[P1_M], sRstd[P1_M];
  __shared__ float sA[P1_M][P1_K + 1];
  __shared__ float sW[P1_K][2 * P1_C + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * P1_M, c0 = blockIdx.y * P1_C, b = blockIdx.z;
  const int len = lengths[b];
  const T* xb = x + (size_t)b * Tlen * D;

  for (int r = warp; r < P1_M; r += NT / 32) {  // LN_pre statistics
    const int t = t0 + r;
    float mean = 0.f, rstd = 0.f;
    if (t < Tlen) {
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s += to_f(xb[(size_t)t * D + c]);
      mean = warp_sum(s) / D;
      float q = 0.f;
      for (int c = lane; c < D; c += 32) {
        const float dv = to_f(xb[(size_t)t * D + c]) - mean;
        q += dv * dv;
      }
      rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
    }
    if (lane == 0) {
      sMean[r] = mean;
      sRstd[r] = rstd;
    }
  }
  __syncthreads();

  const int tx = tid & 15, ty = tid >> 4;
  float acc_a[4][2], acc_b[4][2];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q) acc_a[r][q] = acc_b[r][q] = 0.f;

  for (int k0 = 0; k0 < D; k0 += P1_K) {
    for (int e = tid; e < P1_M * P1_K; e += NT) {
      const int r = e / P1_K, kk = e - r * P1_K, t = t0 + r, kc = k0 + kk;
      float val = 0.f;
      if (t < Tlen && t < len) {
        const float xv = to_f(xb[(size_t)t * D + kc]);
        val = round_to<T>((xv - sMean[r]) * sRstd[r] * pre_s[kc] + pre_b[kc]);
      }
      sA[r][kk] = val;
    }
    for (int e = tid; e < P1_K * 2 * P1_C; e += NT) {
      const int kk = e / (2 * P1_C), q = e - kk * 2 * P1_C;
      const int col = q < P1_C ? c0 + q : D + c0 + (q - P1_C);
      sW[kk][q] = to_f(w1[(size_t)(k0 + kk) * 2 * D + col]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < P1_K; ++kk) {
      float a[4], wa[2], wb[2];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sA[ty + 16 * r][kk];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        wa[q] = sW[kk][tx + 16 * q];
        wb[q] = sW[kk][P1_C + tx + 16 * q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          acc_a[r][q] = fmaf(a[r], wa[q], acc_a[r][q]);
          acc_b[r][q] = fmaf(a[r], wb[q], acc_b[r][q]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + ty + 16 * r;
    if (t >= Tlen) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = c0 + tx + 16 * q;
      const float ha = acc_a[r][q] + b1[c];
      const float hb = acc_b[r][q] + b1[D + c];
      glu[((size_t)b * Tlen + t) * D + c] = ha * sigmoidf(hb);
    }
  }
}

// ---------------------------------------------------------------- launch 2
constexpr int P2_T = 32;   // frames per block
constexpr int P2_K = 16;   // W2 k-slice

template <typename T>
__global__ void __launch_bounds__(NT) dw_ln_pw2_kernel(
    const T* __restrict__ x, const int* __restrict__ lengths,
    const float* __restrict__ glu, const float* __restrict__ wd,
    const float* __restrict__ bd, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ out, T* __restrict__ cache,
    int Tlen, int D, int K) {
  extern __shared__ float smem[];
  const int ctx = K - 1, lpad = ctx / 2;
  float* sG = smem;                    // [P2_T + ctx][D] g with halo
  float* sZ = sG + (P2_T + ctx) * D;   // [P2_T][D]
  float* sW = sZ + P2_T * D;           // [P2_K][D]
  float* sWd = sW + P2_K * D;          // [K][D] taps

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * P2_T, b = blockIdx.y;
  const int len = lengths[b];
  const float* gb = glu + (size_t)b * Tlen * D;

  for (int e = tid; e < (P2_T + ctx) * D; e += NT) {
    const int r = e / D, c = e - r * D, t = t0 - lpad + r;
    sG[e] = (t >= 0 && t < Tlen) ? gb[(size_t)t * D + c] : 0.f;
  }
  for (int e = tid; e < K * D; e += NT) sWd[e] = wd[e];
  __syncthreads();

  for (int c = tid; c < D; c += NT) {  // depthwise taps
    const float bias = bd[c];
    for (int r = 0; r < P2_T; ++r) {
      float acc = 0.f;
      for (int tap = 0; tap < K; ++tap)
        acc = fmaf(sG[(r + tap) * D + c], sWd[tap * D + c], acc);
      sZ[r * D + c] = acc + bias;
    }
  }
  __syncthreads();

  for (int r = warp; r < P2_T; r += NT / 32) {  // LN, swish, round
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += sZ[r * D + c];
    const float mean = warp_sum(s) / D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float dv = sZ[r * D + c] - mean;
      q += dv * dv;
    }
    const float rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
    for (int c = lane; c < D; c += 32) {
      const float z = (sZ[r * D + c] - mean) * rstd * ln_s[c] + ln_b[c];
      sZ[r * D + c] = round_to<T>(z * sigmoidf(z));
    }
  }
  __syncthreads();

  // pw2: rows warp + 8r (r < 4), columns lane + 32cc (cc < 8)
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) acc[r][cc] = 0.f;
  for (int k0 = 0; k0 < D; k0 += P2_K) {
    for (int e = tid; e < P2_K * D; e += NT) sW[e] = to_f(w2[(size_t)k0 * D + e]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < P2_K; ++kk) {
      float a[4], w[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sZ[(warp + 8 * r) * D + k0 + kk];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int c = lane + 32 * cc;
        w[cc] = c < D ? sW[kk * D + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) acc[r][cc] = fmaf(a[r], w[cc], acc[r][cc]);
    }
    __syncthreads();
  }

  const T* xb = x + (size_t)b * Tlen * D;
  T* ob = out + (size_t)b * Tlen * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + warp + 8 * r;
    if (t >= Tlen) continue;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int c = lane + 32 * cc;
      if (c >= D) continue;
      const float z = t < len ? acc[r][cc] + b2[c] : 0.f;
      ob[(size_t)t * D + c] = from_f<T>(to_f(xb[(size_t)t * D + c]) + z);
    }
  }

  if (blockIdx.x == 0) {  // trailing ctx GLU frames, zero-left-padded
    for (int e = tid; e < ctx * D; e += NT) {
      const int j = e / D, c = e - j * D, t = Tlen - ctx + j;
      cache[(size_t)b * ctx * D + e] = from_f<T>(t >= 0 ? gb[(size_t)t * D + c] : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* lengths, const void* pre_s,
                   const void* pre_b, const void* w1, const void* b1, const void* wd,
                   const void* bd, const void* ln_s, const void* ln_b, const void* w2,
                   const void* b2, void* out, void* cache, void* glu,
                   cudaStream_t stream, int B, int Tlen, int D, int K) {
  dim3 grid1((Tlen + P1_M - 1) / P1_M, D / P1_C, B);
  pw1_glu_kernel<T><<<grid1, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(lengths),
      static_cast<const float*>(pre_s), static_cast<const float*>(pre_b),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<float*>(glu), Tlen, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = sizeof(float) * (size_t)D * (P2_T + (K - 1) + P2_T + P2_K + K);
  err = cudaFuncSetAttribute(dw_ln_pw2_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid2((Tlen + P2_T - 1) / P2_T, B);
  dw_ln_pw2_kernel<T><<<grid2, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(lengths),
      static_cast<const float*>(glu), static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out), static_cast<T*>(cache),
      Tlen, D, K);
  return cudaGetLastError();
}

}  // namespace

// x [B,T,D] (dtype T); lengths int32 [B]; pre_s, pre_b, b2, bd, ln_s, ln_b
// float32 [D]; w1 [D,2D] and w2 [D,D] (dtype T); b1 float32 [2D]; wd float32
// [K,D]; out [B,T,D] and cache [B,K-1,D] (dtype T); glu float32 scratch
// [B,T,D]. All contiguous. Returns the CUDA error code (0 on success).
extern "C" int conv_block_fwd(const void* x, const void* lengths, const void* pre_s,
                              const void* pre_b, const void* w1, const void* b1,
                              const void* wd, const void* bd, const void* ln_s,
                              const void* ln_b, const void* w2, const void* b2,
                              void* out, void* cache, void* glu, void* stream, int B,
                              int Tlen, int D, int K, int is_bf16) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, lengths, pre_s, pre_b, w1, b1, wd, bd, ln_s,
                                      ln_b, w2, b2, out, cache, glu, s, B, Tlen, D, K)
              : launch<float>(x, lengths, pre_s, pre_b, w1, b1, wd, bd, ln_s, ln_b, w2,
                              b2, out, cache, glu, s, B, Tlen, D, K);
  return static_cast<int>(err);
}
