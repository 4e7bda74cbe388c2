// Dynamic int8 matmul for Hopper (sm_90a): per-row int8 quantization of x,
// int8 x int8 -> int32 product with per-output-channel int8 weights, and
// the rescale, in one launch.
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/quant_kernel.py
// (int8_matmul_dynamic, _kernel). For x [M, K] (float32 or bfloat16),
// w_q [K, N] int8 (given as its kernel layout, see below) and w_scale [N]
// float32 it computes
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
// Design. Integer wgmma on the tensor cores; it takes both operands
// K-major, so the weight comes as its kernel layout W^T [N, K_pad] int8 (K
// zero-padded to a multiple of 32, made once per weight by
// ops/int8_matmul.kernel_layout), and TMA streams 128 x 128-byte tiles of
// it into a ring of up to 6 stages whose size does not grow with K. A
// block is one producer warpgroup (one thread issues the TMA copies) and
// four consumer warpgroups, each a 64 x 64 quarter of a 128 x 128 output
// tile (m64n64k32 s32.s8.s8): sixteen warps hide each other's latency
// where eight, on 64 x 128 quarters, left the SM mostly waiting (a fifth
// slower end to end).
//   Grid. Tiles are numbered row tile first; each of the card's SMs takes
// one block, and each block a contiguous run of tiles (route A's M = 374
// is 48 tiles, one a block; M = 17952 is 2256, ~17 a block). A whole row
// tile a block would balance no better than 141 row tiles over 132 SMs do.
//   Quantization. Where its run enters a new row tile, the two consumers
// of each 64-row half quantize it: the absmax (one warp a row, two rows in
// flight), then the IEEE division by the row's scale (its fast path with
// one reciprocal a row, int8_common.cuh) and round half to even, straight
// into the swizzled K-major A tile (zero past K; K <= 1024). A row tile
// is quantized again by each block whose run touches it, about twice at
// M = 17952: no int32 scratch, no second launch. Quantizing on the
// producer warpgroup's three idle warps into double-buffered A tiles, to
// overlap it with the products, was slower (three warps could not keep
// up with the consumers).
//   Epilogue. The int32 sum is converted with round-to-nearest (exactly,
// by adds, where K <= 260) and multiplied by the two scales, each product
// rounded, so the result equals the plain version's bit for bit. Each
// consumer writes its 64 x 64 quarter into a swizzled staging tile and one
// of its threads stores it with TMA (128-byte boxes; rows and columns past
// the ends are not written); the stores drain while the next tile's
// products run. Where a row of N elements is not a multiple of 16 bytes
// (TMA's row stride), each warp stages its 16 rows and stores them element
// by element instead.
//   Time (scripts/torch_int8_ablation.py, PERF.md): the rows' quantization
// is the largest stage, then the products and the staging.

#include "hopper_common.cuh"
#include "int8_common.cuh"

namespace {

using namespace int8k;

constexpr int THREADS = 640;             // producer warpgroup + 4 consumer warpgroups
constexpr int CONSUMERS = 512;
// registers: the block holds 96 a thread (65536 / 640, rounded down to a
// multiple of 8); the producer warpgroup gives up all but 40 and the
// consumers take what that frees, in multiples of 8: 128 * 40 + 512 * 104
// <= 640 * 96 (setmaxnreg.inc waits until the registers are free)
constexpr int REG_PRODUCER = 40, REG_CONSUMER = 104;
constexpr int BM = 128, BN = 128;        // output tile (64 x 64 per consumer)
constexpr int KMAX = 1024;               // K the A tiles hold
constexpr int MAX_KC = KMAX / 128;
constexpr uint32_t ATOM = 8192;          // 64 rows x 128 K bytes, swizzled
constexpr uint32_t STAGE = 16384;        // 128 rows of W^T x 128 K bytes
constexpr int STG_ROW = 144;             // staging row: 128 B + 16 against bank conflicts
constexpr uint32_t STG_WARP = 16 * STG_ROW;
constexpr uint32_t STG_BYTES = 65536;    // staging: four 64 x 64 float32 tiles, swizzled,
                                         // or sixteen warps' rows (16 STG_WARP)
constexpr int MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;

__host__ __device__ constexpr int kpad32(int K) { return (K + 31) / 32 * 32; }
__host__ __device__ constexpr int kchunks(int K) { return (kpad32(K) + 127) / 128; }
// A tiles, ring, staging, row scales, barriers, room to align to 1024 B
__host__ __device__ constexpr size_t smem_bytes(int K, int S) {
  return 1024 + 2 * (size_t)kchunks(K) * ATOM + (size_t)S * (STAGE + 16) + STG_BYTES +
         2 * 64 * sizeof(float);
}
__host__ __device__ constexpr int stages(int K) {
  return (SMEM_LIMIT - (int)smem_bytes(K, 0)) / (int)(STAGE + 16) > MAX_STAGES
             ? MAX_STAGES
             : (SMEM_LIMIT - (int)smem_bytes(K, 0)) / (int)(STAGE + 16);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the low `n` elements of a 16-byte chunk to o, one by one
__device__ __forceinline__ uint32_t word(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void store_part(float* o, uint4 v, int n) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < n) o[u] = __uint_as_float(word(v, u));
}
__device__ __forceinline__ void store_part(__nv_bfloat16* o, uint4 v, int n) {
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (u < n)
      o[u] = __ushort_as_bfloat16(static_cast<unsigned short>(word(v, u >> 1) >> (16 * (u & 1))));
}

// rows m0 .. m0 + 63 of x as int8 into the swizzled A tile `a`, their
// scales into xs: warp w (of the row half's eight) takes rows 8 R i + R w
// .. + R - 1, R rows at a time (their loads and reductions in flight
// together), lane l holding K
// elements 128 j + 4 l .. + 3 of each (j < MKC), loaded as one vector
// where `vec` (K a multiple of 4, x aligned); no branch per element
template <int R, int MKC, typename T>
__device__ __forceinline__ void quantize_rows(const T* __restrict__ x, unsigned char* a,
                                              float* xs, int m0, int M, int K, int KC, bool vec,
                                              int warp, int lane) {
  for (int r0 = R * warp; r0 < 64; r0 += 8 * R) {
    float v[R][MKC][4];
    float am[R];
    if (vec) {
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int j = 0; j < MKC; ++j) {
          const int m = m0 + r0 + q, k = 128 * j + 4 * lane;
          v[q][j][0] = v[q][j][1] = v[q][j][2] = v[q][j][3] = 0.f;
          if (j < KC && m < M && k < K) load4(x + (size_t)m * K + k, v[q][j]);
        }
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int j = 0; j < MKC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + r0 + q, k = 128 * j + 4 * lane + e;
            v[q][j][e] = (j < KC && m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
          }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      am[q] = 0.f;
#pragma unroll
      for (int j = 0; j < MKC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) am[q] = fmaxf(am[q], fabsf(v[q][j][e]));
    }
#pragma unroll
    for (int q = 0; q < R; ++q) am[q] = warp_max(am[q]);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const RowDiv d = row_div(row_scale(am[q]));
      if (lane == 0) xs[r0 + q] = d.s;
#pragma unroll
      for (int j = 0; j < MKC; ++j)
        if (j < KC)
          *reinterpret_cast<int*>(a + j * ATOM + hopper::swz(r0 + q, 4 * lane)) =
              pack4(quant_bits(v[q][j][0], d), quant_bits(v[q][j][1], d),
                    quant_bits(v[q][j][2], d), quant_bits(v[q][j][3], d));
    }
  }
}

// SMALL: K <= SMALL_K, so that dequant<true> takes the int32 sums
template <typename T, bool SMALL>
__global__ void __launch_bounds__(THREADS, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap omap, const T* __restrict__ x,
                   const float* __restrict__ ws, T* __restrict__ out, int M, int K, int N,
                   int n_tiles, int total, int S, int tma_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  const int KC = kchunks(K);
  unsigned char* a_s = smem;                         // [2 consumers][KC][ATOM]
  unsigned char* ring = a_s + 2 * KC * ATOM;         // [S][STAGE]
  unsigned char* stg = ring + S * STAGE;             // staging, STG_BYTES
  float* xs_s = reinterpret_cast<float*>(stg + STG_BYTES);      // [2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(xs_s + 128);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, wg = tid >> 7;
  // this block's run of tiles, [t0, t1) in row-tile-major order
  const int t0 = (int)((long long)blockIdx.x * total / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * total / gridDim.x);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hopper::setmaxnreg_dec<REG_PRODUCER>();
    if (tid == 0) {
      int g = 0;
      for (int t = t0; t < t1; ++t) {
        const int n0 = (t % n_tiles) * BN;
        for (int kc = 0; kc < KC; ++kc, ++g) {
          const int st = g % S;
          hopper::mbar_wait(&empty[st], ((g / S) & 1) ^ 1);
          hopper::mbar_expect(&full[st], STAGE);
          hopper::tma_load(ring + st * STAGE, &wmap, &full[st], 128 * kc, n0);
        }
      }
    }
    return;
  }

  // consumer c: rows 64 rh .. + 63 and columns 64 ch .. + 63 of each tile
  hopper::setmaxnreg_inc<REG_CONSUMER>();
  const int c = wg - 1, rh = c & 1, ch = c >> 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int rl = lane >> 2;
  unsigned char* a_h = a_s + rh * KC * ATOM;                  // the row half's A tile
  unsigned char* stg_w = stg + (4 * c + warp) * STG_WARP;     // the fallback's rows
  unsigned char* stg_c = stg + c * (STG_BYTES / 4);           // the TMA store's tile
  float* xs = xs_s + 64 * rh;
  const uint32_t aa = hopper::saddr(a_h);
  const bool vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  constexpr int CPH = 128 / sizeof(T);    // columns per staging pass of the fallback
  int acc[32];
  float srow[2] = {0.f, 0.f};
  int g = 0, prev = 0, m_cur = -1;
  for (int t = t0; t < t1; ++t) {
    const int mt = t / n_tiles, n0 = (t - mt * n_tiles) * BN + 64 * ch;
    const int m0 = mt * BM + 64 * rh;
    if (mt != m_cur) {               // both consumers of the row half quantize it
      m_cur = mt;
      hopper::bar_sync(1 + rh, 256);     // the last tile's readers of A and xs are done
      if (KC <= 4)
        quantize_rows<2, 4>(x, a_h, xs, m0, M, K, KC, vec_x, 4 * ch + warp, lane);
      else
        quantize_rows<1, MAX_KC>(x, a_h, xs, m0, M, K, KC, vec_x, 4 * ch + warp, lane);
      hopper::fence_view_async();
      hopper::bar_sync(1 + rh, 256);
      srow[0] = xs[16 * warp + rl];
      srow[1] = xs[16 * warp + rl + 8];
    }

    hopper::fence_regs(acc);
    hopper::wg_fence();
    for (int kc = 0; kc < KC; ++kc, ++g) {
      const int st = g % S;
      hopper::mbar_wait(&full[st], (g / S) & 1);
      const uint32_t wa = hopper::saddr(ring + st * STAGE) + ch * ATOM;   // its 64 W^T rows
      if (kc > 0) hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)    // whole chunks: A and W^T are zero past K
        hopper::wgmma_s8_n64(acc, hopper::desc(aa + kc * ATOM + kk * 32),
                             hopper::desc(wa + kk * 32), (kc | kk) != 0);
      hopper::wg_commit();
      if (kc > 0) {
        hopper::wg_wait<1>();
        hopper::mbar_arrive(&empty[prev]);
      }
      prev = st;
    }
    hopper::wg_wait0();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[prev]);

    if (tma_out) {
      // epilogue: the consumer's 64 x 64 tile into its swizzled staging
      // tile, boxes of 128 bytes a row, then TMA stores of the boxes; the
      // stores drain while the next tile's products run
      constexpr int PER_BOX = 128 / sizeof(T);
      if (warp == 0 && lane == 0) hopper::bulk_wait_read<0>();   // the last stores read it
      hopper::bar_sync(3 + c, 128);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 8 * i + 2 * (lane & 3);
        const int n = n0 + col;
        const float2 w = make_float2(n < N ? ws[n] : 0.f, n + 1 < N ? ws[n + 1] : 0.f);
        const int off = (col % PER_BOX) * (int)sizeof(T);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * warp + rl + 8 * hh;
          store2(reinterpret_cast<T*>(stg_c + (col / PER_BOX) * ATOM + r * 128 +
                                      ((((off >> 4) ^ r) & 7) << 4) + (off & 15)),
                 dequant<SMALL>(acc[4 * i + 2 * hh], srow[hh], w.x),
                 dequant<SMALL>(acc[4 * i + 2 * hh + 1], srow[hh], w.y));
        }
      }
      hopper::fence_view_async();
      hopper::bar_sync(3 + c, 128);
      if (warp == 0 && lane == 0) {
#pragma unroll
        for (int b = 0; b < 64 / PER_BOX; ++b)
          hopper::tma_store(&omap, stg_c + b * ATOM, n0 + b * PER_BOX, m0);
        hopper::bulk_commit();
      }
      continue;
    }
    // epilogue where TMA cannot store (a row of N elements is not a multiple
    // of 16 bytes): the warp's 16 rows through its staging rows, CPH columns
    // a pass, element by element
#pragma unroll
    for (int p = 0; p < 64 / CPH; ++p) {
#pragma unroll
      for (int i = p * CPH / 8; i < (p + 1) * CPH / 8; ++i) {
        const int col = 8 * i + 2 * (lane & 3);
        const int n = n0 + col;
        const float2 w = make_float2(n < N ? ws[n] : 0.f, n + 1 < N ? ws[n + 1] : 0.f);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          store2(reinterpret_cast<T*>(stg_w + (rl + 8 * hh) * STG_ROW) + (col - p * CPH),
                 dequant<SMALL>(acc[4 * i + 2 * hh], srow[hh], w.x),
                 dequant<SMALL>(acc[4 * i + 2 * hh + 1], srow[hh], w.y));
      }
      __syncwarp();
      // 8 lanes a row, 16 B each; four rows a step
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = 4 * q + (lane >> 3), c16 = lane & 7;
        const int m = m0 + 16 * warp + rr;
        const int nc = n0 + p * CPH + c16 * (16 / (int)sizeof(T));
        if (m < M && nc < N) {
          const uint4 val = *reinterpret_cast<const uint4*>(stg_w + rr * STG_ROW + c16 * 16);
          store_part(out + (size_t)m * N + nc, val, N - nc);
        }
      }
      __syncwarp();
    }
  }
  if (tma_out && warp == 0 && lane == 0) hopper::bulk_wait<0>();   // the last stores done
}

template <typename T, bool SMALL>
cudaError_t launch(const void* x, const void* w_t, const void* ws, void* out, cudaStream_t s,
                   int M, int K, int N) {
  CUtensorMap wmap, omap = {};
  cudaError_t e = hopper::int8_map(&wmap, w_t, N, kpad32(K));
  if (e != cudaSuccess) return e;
  // the output by TMA stores where its rows are whole 16-byte units
  const int tma_out = (static_cast<size_t>(N) * sizeof(T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (tma_out) {
    e = hopper::tile_map(&omap,
                         sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         sizeof(T), out, M, N, 64);
    if (e != cudaSuccess) return e;
  }
  const int S = stages(K);
  const size_t smem = smem_bytes(K, S);
  static int sms = 0;          // once per process and kernel: the limit and the SM count
  if (sms == 0) {
    int dev = 0, n = 0;
    e = cudaFuncSetAttribute(int8_matmul_kernel<T, SMALL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms = n;
  }
  const int n_tiles = (N + BN - 1) / BN;
  const long long total = (long long)((M + BM - 1) / BM) * n_tiles;
  if (total > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = total < sms ? (int)total : sms;
  int8_matmul_kernel<T, SMALL><<<grid, THREADS, smem, s>>>(
      wmap, omap, static_cast<const T*>(x), static_cast<const float*>(ws), static_cast<T*>(out),
      M, K, N, n_tiles, (int)total, S, tma_out);
  return cudaGetLastError();
}

}  // namespace

// w_t: the kernel layout of w_q, int8 [N, K_pad], K_pad = K rounded up to a
// multiple of 32, zero past K
extern "C" int int8_matmul_fwd(const void* x, const void* w_t, const void* w_scale, void* out,
                               void* stream, int M, int K, int N, int is_bf16) {
  if (M < 1 || K < 1 || K > KMAX || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = kpad32(K) <= SMALL_K;
  cudaError_t err =
      is_bf16 ? (small ? launch<__nv_bfloat16, true>(x, w_t, w_scale, out, s, M, K, N)
                       : launch<__nv_bfloat16, false>(x, w_t, w_scale, out, s, M, K, N))
              : (small ? launch<float, true>(x, w_t, w_scale, out, s, M, K, N)
                       : launch<float, false>(x, w_t, w_scale, out, s, M, K, N));
  return static_cast<int>(err);
}
