// Dynamic int8 matmul for Hopper (sm_90a): per-row int8 quantization of x,
// int8 x int8 -> int32 product with per-output-channel int8 weights, and
// the rescale.
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/quant_kernel.py
// (int8_matmul_dynamic, _kernel). For x [M, K] (float32 or bfloat16),
// w_q [K, N] int8 (given packed, see below) and w_scale [N] float32 it
// computes
//
//   s_x[m]  = max(max_k |x[m, k]| * f32(1/127), 1e-12)
//   q[m, k] = clip(round_half_even(x[m, k] / s_x[m]), -127, 127)
//   y[m, n] = float(sum_k q[m, k] w_q[k, n]) * s_x[m] * w_scale[n]
//
// in x's dtype. The bias is added by the caller, outside the kernel.
//
// Bound: at the serving shape (M = 48 x 374 = 17952, K = 256, N = 2048,
// bf16) the product is 18.8 G integer operations (~9.5 us at the 1979 TOPS
// int8 tensor rate), and x, w_q and y move ~83 MB (~25 us at 3.35 TB/s):
// the function is bound by bytes, mostly the [M, N] output.
//
// Design (simple and right first): two launches. The first quantizes each
// row of x once (one warp per row: the absmax, then IEEE division and
// rintf) into an int32-packed scratch [M, ceil(K/4)] (4 int8 per word,
// zero past K) and the row scales [M]. The second is a tiled product with
// __dp4a on the CUDA cores: a 256-thread block owns a 64 x 64 tile of y,
// each thread 4 x 4 outputs, and walks K in slices of 64 (16 words). The
// wrapper hands w_q packed along K (ops/int8_matmul.pack_k4: int32
// [ceil(K/16) * 4, N], rows 4kw..4kw+3 of column n in the bytes of word
// (kw, n)), so a slice is one coalesced 32-bit load per word; w_q is
// 0.5 MB and stays in the 50 MB L2. A dp4a
// kernel tops out near 134 TOPS on 132 SMs (0.14 ms here, six times the
// bound); the tensor cores (mma.sync s8 or wgmma), TMA and a fused quantization are
// later work. The int32 sum is exact, and the rescale is two rounded
// multiplies with no add, so the result equals the plain version's bit
// for bit. Any M >= 1, K >= 1 and N >= 1.

#include "int8_common.cuh"

namespace {

using namespace int8k;

constexpr int QROWS = 8;    // rows per block of the quantization launch (a warp each)
constexpr int BM = 64, BN = 64, BKW = 16;   // product tile: rows, columns, K words
constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(QROWS * 32)
quant_rows_kernel(const T* __restrict__ x, int* __restrict__ xq, float* __restrict__ xs,
                  int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * QROWS + (threadIdx.x >> 5);
  if (row >= M) return;                       // whole warps leave together
  const T* xr = x + (size_t)row * K;
  float m = 0.f;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(to_f(xr[k])));
  const float s = row_scale(warp_max(m));
  if (lane == 0) xs[row] = s;
  const int KW = (K + 3) / 4;
  for (int kw = lane; kw < KW; kw += 32) {
    uint32_t b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * kw + j;
      b[j] = k < K ? quant_byte(to_f(xr[k]), s) : 0u;
    }
    xq[(size_t)row * KW + kw] = pack4(b[0], b[1], b[2], b[3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
int8_gemm_kernel(const int* __restrict__ xq, const float* __restrict__ xs,
                 const int* __restrict__ wp, const float* __restrict__ ws,
                 T* __restrict__ out, int M, int K, int N) {
  __shared__ int As[BM][BKW + 1];
  __shared__ int Bs[BKW][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KW = (K + 3) / 4;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kw0 = 0; kw0 < KW; kw0 += BKW) {
    for (int i = tid; i < BM * BKW; i += NT) {
      const int r = i / BKW, c = i % BKW, row = m0 + r, kw = kw0 + c;
      As[r][c] = (row < M && kw < KW) ? xq[(size_t)row * KW + kw] : 0;
    }
    for (int i = tid; i < BKW * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      Bs[r][c] = (kw0 + r < KW && n0 + c < N) ? wp[(size_t)(kw0 + r) * N + n0 + c] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKW; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
    const float s_row = xs[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[(size_t)row * N + col] = from_f<T>(dequant(acc[i][j], s_row, ws[col]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* ws, void* out, void* xq, void* xs,
                   cudaStream_t s, int M, int K, int N) {
  quant_rows_kernel<T><<<(M + QROWS - 1) / QROWS, QROWS * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<int*>(xq), static_cast<float*>(xs), M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<T><<<grid, NT, 0, s>>>(
      static_cast<const int*>(xq), static_cast<const float*>(xs), static_cast<const int*>(w),
      static_cast<const float*>(ws), static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int int8_matmul_fwd(const void* x, const void* w_q, const void* w_scale, void* out,
                               void* x_q, void* x_scale, void* stream, int M, int K, int N,
                               int is_bf16) {
  if (M < 1 || K < 1 || N < 1 || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w_q, w_scale, out, x_q, x_scale, s, M, K, N)
              : launch<float>(x, w_q, w_scale, out, x_q, x_scale, s, M, K, N);
  return static_cast<int>(err);
}
