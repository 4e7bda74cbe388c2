// Fused int8 feed-forward half of a macaron Conformer layer, inference, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/ffn_kernel.py
// (int8_ffn_fused, _kernel). For x [M, D] (float32 or bfloat16), int8
// weights W1 [D, H], W2 [H, D] with per-column float32 scales s1 [H],
// s2 [D] and float32 biases b1 [H], b2 [D] it computes, per row,
//
//   xn      = LN(x) (float32 statistics, scale and bias)
//   xq, s_x = per-row int8 of xn (absmax * f32(1/127), round half to even)
//   h       = swish(float(xq W1) * s_x * s1 + b1)
//   hq, s_h = per-row int8 of h, over all H columns
//   y       = float(hq W2) * s_h * s2 + b2
//   out     = x + half * y                      in x's dtype
//
// Bound: at route B's shape (M = 48 x 374 = 17952, D = 256, H = 2048) the
// two products are 37.6 G integer operations (~19 us at the 1979 TOPS int8
// tensor rate) while x, the weights and out move ~19 MB (~6 us at
// 3.35 TB/s): the function is bound by operations.
//
// Design (simple and right first). The hidden row must be whole before it
// can be quantized: its scale is the absmax over all H columns. A block of
// 512 threads owns 16 rows and keeps their whole float32 hidden in shared
// memory (16 x 2048 x 4 B = 128 KiB at Conformer-M; with x, the int8 rows
// and the scales ~181 KiB, one block per SM), so each product runs once;
// the alternative, a first pass over W1 for the row maxima and a second to
// recompute h, costs the W1 product twice. The [M, H] hidden never leaves
// the SM. Steps per block: x to shared in float32; one warp per row for the
// LayerNorm and the row's int8 (packed 4 to a word along D); the W1
// product with __dp4a, one hidden column per thread and 16 row sums each,
// dequant, bias and swish (expf, IEEE division), into shared memory with
// each thread's running row maxima; the maxima reduced over warps; the
// hidden quantized into shared memory; the W2 product, one output column
// and 8 rows per thread; dequant, bias and the residual. The wrapper hands
// both int8 weights packed along K (ops/int8_matmul.pack_k4, in whole
// groups of 4 words), so each thread reads 4 words of its column as 4
// coalesced 32-bit loads (0.5 MiB per weight, resident in the 50 MB L2)
// and each row's 4 activation words as one 16-byte shared-memory load,
// for 4 __dp4a per row. Products on the CUDA cores (a dp4a kernel tops out
// near 134 TOPS on 132 SMs); tensor cores (mma.sync s8 / wgmma), TMA and a
// smaller footprint for more blocks per SM are later work. Every multiply and add that the plain
// version rounds on its own is rounded here too (__fmul_rn, __fadd_rn), so
// the two differ only where a sum is taken in another order or expf and
// torch.sigmoid differ by an ulp; near a rounding boundary that flips one
// int8 value. Any M >= 1; the shared memory limits H (D = 256: H <= ~2500).

#include "int8_common.cuh"

namespace {

using namespace int8k;

constexpr int FT = 512;            // threads per block
constexpr int NW = FT / 32;        // warps per block
constexpr int TM = 16;             // rows per block
constexpr int OC = 256;            // output columns per pass of the W2 product
constexpr int RG = TM / (FT / OC); // rows per thread in the W2 product

// words of a packed row of K int8 values, padded to a multiple of 4 words
// (the rows of ops/int8_matmul.pack_k4)
__host__ __device__ int packed_words(int K) { return ((K + 15) / 16) * 4; }

size_t smem_bytes(int D, int H) {
  return sizeof(float) *
         (TM * ((size_t)D + packed_words(D) + H + packed_words(H)) + 2 * TM + (size_t)NW * TM);
}

// acc += dot of four packed activation words with four packed weight words
__device__ __forceinline__ int dp16(const int4 a, const int (&w)[4], int acc) {
  return __dp4a(a.w, w[3], __dp4a(a.z, w[2], __dp4a(a.y, w[1], __dp4a(a.x, w[0], acc))));
}

template <typename T>
__global__ void __launch_bounds__(FT)
int8_ffn_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, const int* __restrict__ w1p,
                const float* __restrict__ s1, const float* __restrict__ b1,
                const int* __restrict__ w2p, const float* __restrict__ s2,
                const float* __restrict__ b2, T* __restrict__ out, int M, int D, int H,
                float half, float eps) {
  extern __shared__ float smem[];
  const int DW = packed_words(D), HW = packed_words(H);
  float* x_s = smem;                                    // [TM, D]
  int* xq_s = reinterpret_cast<int*>(x_s + TM * D);     // [TM, DW]
  float* h_s = reinterpret_cast<float*>(xq_s + TM * DW);  // [TM, H]
  int* hq_s = reinterpret_cast<int*>(h_s + TM * H);     // [TM, HW]
  float* xs_s = reinterpret_cast<float*>(hq_s + TM * HW);  // [TM]
  float* hs_s = xs_s + TM;                              // [TM]
  float* red = hs_s + TM;                               // [NW, TM]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TM;

  // x to shared, float32; rows past M are zeros and are never written
  for (int i = tid; i < TM * D; i += FT) {
    const int row = row0 + i / D;
    x_s[i] = row < M ? to_f(x[(size_t)row * D + i % D]) : 0.f;
  }
  __syncthreads();

  // LayerNorm and the row's int8, one warp per row
  for (int r = warp; r < TM; r += NW) {
    const float* xr = x_s + r * D;
    float sum = 0.f;
    for (int c = lane; c < D; c += 32) sum = __fadd_rn(sum, xr[c]);
    const float mean = __fdiv_rn(warp_sum(sum), (float)D);
    float sq = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __fsub_rn(xr[c], mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
    const float rs = __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(sq), (float)D), eps));
    auto ln_at = [&](int c) {
      return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xr[c], mean), rs), ln_s[c]), ln_b[c]);
    };
    float am = 0.f;
    for (int c = lane; c < D; c += 32) am = fmaxf(am, fabsf(ln_at(c)));
    const float s = row_scale(warp_max(am));
    if (lane == 0) xs_s[r] = s;
    for (int kw = lane; kw < DW; kw += 32) {
      uint32_t b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = 4 * kw + j < D ? quant_byte(ln_at(4 * kw + j), s) : 0u;
      xq_s[r * DW + kw] = pack4(b[0], b[1], b[2], b[3]);
    }
  }
  __syncthreads();

  // h = swish(dequant(xq W1) + b1) into shared memory, with row maxima
  float am[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) am[r] = 0.f;
  for (int n0 = 0; n0 < H; n0 += FT) {
    const int n = n0 + tid;
    int acc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = 0;
    for (int kw = 0; kw < DW; kw += 4) {
      int wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = n < H ? w1p[(size_t)(kw + j) * H + n] : 0;
#pragma unroll
      for (int r = 0; r < TM; ++r)
        acc[r] = dp16(*reinterpret_cast<const int4*>(xq_s + r * DW + kw), wv, acc[r]);
    }
    if (n < H) {
      const float sc = s1[n], bb = b1[n];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        float h = __fadd_rn(dequant(acc[r], xs_s[r], sc), bb);
        h = __fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-h))));
        h_s[r * H + n] = h;
        am[r] = fmaxf(am[r], fabsf(h));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const float v = warp_max(am[r]);
    if (lane == 0) red[warp * TM + r] = v;
  }
  __syncthreads();
  if (tid < TM) {
    float m = 0.f;
    for (int w = 0; w < NW; ++w) m = fmaxf(m, red[w * TM + tid]);
    hs_s[tid] = row_scale(m);
  }
  __syncthreads();

  // the hidden's int8, packed 4 to a word along H
  for (int i = tid; i < TM * HW; i += FT) {
    const int r = i / HW, kw = i % HW;
    const float s = hs_s[r];
    uint32_t b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * kw + j;
      b[j] = c < H ? quant_byte(h_s[r * H + c], s) : 0u;
    }
    hq_s[i] = pack4(b[0], b[1], b[2], b[3]);
  }
  __syncthreads();

  // y = dequant(hq W2) + b2; out = x + half * y
  const int g = tid / OC;
  for (int c0 = 0; c0 < D; c0 += OC) {
    const int n = c0 + tid % OC;
    int acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0;
    for (int kw = 0; kw < HW; kw += 4) {
      int wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = n < D ? w2p[(size_t)(kw + j) * D + n] : 0;
#pragma unroll
      for (int i = 0; i < RG; ++i)
        acc[i] = dp16(*reinterpret_cast<const int4*>(hq_s + (g * RG + i) * HW + kw), wv, acc[i]);
    }
    if (n >= D) continue;
    const float sc = s2[n], bb = b2[n];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = g * RG + i, row = row0 + r;
      if (row >= M) continue;
      const float y = __fadd_rn(dequant(acc[i], hs_s[r], sc), bb);
      out[(size_t)row * D + n] = from_f<T>(__fadd_rn(x_s[r * D + n], __fmul_rn(half, y)));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                   const void* s1, const void* b1, const void* w2, const void* s2,
                   const void* b2, void* out, cudaStream_t s, int M, int D, int H, float half,
                   float eps) {
  const size_t smem = smem_bytes(D, H);
  cudaError_t err = cudaFuncSetAttribute(
      int8_ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int8_ffn_kernel<T><<<(M + TM - 1) / TM, FT, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const int*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(out), M, D, H, half, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_ffn_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                            const void* s1, const void* b1, const void* w2, const void* s2,
                            const void* b2, void* out, void* stream, int M, int D, int H,
                            int is_bf16, float half, float eps) {
  if (M < 1 || D < 1 || H < 1 || smem_bytes(D, H) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, ln_s, ln_b, w1, s1, b1, w2, s2, b2, out, s, M, D, H,
                                      half, eps)
              : launch<float>(x, ln_s, ln_b, w1, s1, b1, w2, s2, b2, out, s, M, D, H, half, eps);
  return static_cast<int>(err);
}
