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
// 3.35 TB/s): the function is bound by operations. The elementwise work is
// a floor of its own: 37 M swish evaluations (an exp and a reciprocal on
// the special-function unit each) and as many divisions for the hidden's
// int8 (the IEEE division's fast path with one reciprocal a row, rounding
// by adds: int8_common.cuh).
//
// Design: a cluster of 4 blocks per 64-row tile, each block owning a
// quarter of the H hidden columns (at most 512), so that the whole hidden
// row is held once, in registers, and never reaches device memory (the
// alternative, one block per tile with a first pass over W1 for the row
// maxima and a second to recompute h, costs the W1 product and the swish
// twice). A block is one producer warpgroup and two consumer warpgroups;
// two producer threads issue TMA copies of 128 x 128-byte weight tiles,
// one 3-stage ring per consumer warpgroup (16 KB stages, whatever D and
// H). Both weights come as their kernel layouts, K-major as integer wgmma
// takes them: W1^T [H, D_pad] and W2^T [D, H_pad] (made once per weight by
// ops/int8_matmul.kernel_layout), so each weight is read from L2 once per
// 64 rows (1 MiB at Conformer-M, 280 MB a call at route B's shape).
//   1. LayerNorm and the int8 of the tile's 64 rows, 16 a block, two a
//      warp, each row written into all four blocks' swizzled K-major A
//      tile through distributed shared memory (D zero-padded to a multiple
//      of 32); an mbarrier of each block counts the four writers.
//   2. W1 product on int8 wgmma (m64n128k32): consumer c takes the block's
//      hidden tiles c and c + 2 of 128 columns; the int32 accumulators
//      become h = swish(dequant + b1) in place, with each row's absmax
//      (int32 to float by adds where D <= 256). No element takes a branch:
//      ptxas serializes the products, and the elementwise work runs far
//      slower, where a product or a per-element branch is on a path that
//      differs between threads.
//   3. The row maxima meet through distributed shared memory: each block
//      reads the other three's after a cluster barrier, so all four take
//      the same scale s_h (a max is exact in any order).
//   4. Each block quantizes its h into a second swizzled A tile (its hidden
//      columns as K; columns outside its quarter zero) and takes the W2
//      product over them: partial int32 sums [64, D], consumer c the output
//      tiles c and c + 2, written to shared memory over the finished tiles.
//   5. After a second cluster barrier block r sums the four partials of
//      rows 16 r .. 16 r + 15 in a fixed order (exact: integers), then
//      dequant, bias and the residual, and stores them; a third barrier
//      keeps every block's partials alive until all are read.
// No float atomics; the result is bitwise repeatable. Every multiply and
// add that the plain version rounds on its own is rounded here too
// (__fmul_rn, __fadd_rn); the two differ only where a sum is taken in
// another order (LayerNorm's statistics, taken with a multiply by 1/D and
// rsqrtf) or expf and the fast division of the swish differ from
// torch.sigmoid by an ulp or two, and near a rounding boundary that flips
// one int8 value.
// Limits: D <= 512, H <= 2048 (a quarter of at most 512 columns), any M;
// wider FFNs take the wide route at the end of this file.
// Time (scripts/torch_int8_ablation.py, PERF.md): the swish and the
// cluster's reduction and stores are the largest stages; each block's
// phases run in series, one block per SM.

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper_common.cuh"
#include "hopper_gemm.cuh"
#include "int8_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace int8k;

constexpr int CLUSTER = 4;             // blocks per 64-row tile
constexpr int THREADS = 384;           // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int REG_PRODUCER = 40, REG_CONSUMER = 232;
constexpr int TM = 64;                 // rows per tile
constexpr int DMAX = 512, HQMAX = 512; // D, and hidden columns per block
constexpr uint32_t ATOM = 8192;        // 64 rows x 128 K bytes, swizzled
constexpr uint32_t STAGE = 16384;      // 128 weight rows x 128 K bytes
constexpr int S = 3;                   // ring stages per consumer warpgroup
// shared memory: A1 (4 atoms), A2 (4 atoms), two rings; the partial sums
// [64][PSTRIDE] int32 reuse that region once the products are done
constexpr uint32_t A1_OFF = 0, A2_OFF = 4 * ATOM, RING_OFF = 8 * ATOM;
constexpr uint32_t PROD_BYTES = RING_OFF + 2 * S * STAGE;
constexpr size_t SMEM = 1024 + PROD_BYTES + HQMAX * sizeof(float2) + 5 * TM * sizeof(float) +
                        (4 * S + 1) * sizeof(uint64_t);

__host__ __device__ constexpr int pad32(int n) { return (n + 31) / 32 * 32; }
// hidden columns per block: a quarter of H, rounded up to a multiple of 32
__host__ __device__ constexpr int quarter(int H) { return pad32((H + CLUSTER - 1) / CLUSTER); }
__host__ __device__ constexpr int pstride(int D) { return (D + 127) / 128 * 128 + 8; }
static_assert(TM * pstride(DMAX) * 4 <= PROD_BYTES, "partial sums overflow their region");

// z * sigmoid(z) without a branch: expf, and the division by the fast
// reciprocal (2 ulp; 0 where 1 + exp(-z) overflows)
__device__ __forceinline__ float swish(float z) {
  return __fdividef(z, __fadd_rn(1.f, expf(-z)));
}

// the next weight tile of a ring: the box at (k0, n0) of `map` into stage g
__device__ __forceinline__ void issue(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                      int& g, const CUtensorMap* map, int k0, int n0) {
  const int st = g % S;
  hopper::mbar_wait(&empty[st], ((g / S) & 1) ^ 1);
  hopper::mbar_expect(&full[st], STAGE);
  hopper::tma_load(ring + st * STAGE, map, &full[st], k0, n0);
  ++g;
}

// acc = A (64 rows, `ksteps` >= 1 steps of 32 K from shared address a, in
// whole chunks of 4 steps) times the next tiles of this warpgroup's ring
__device__ __forceinline__ void ring_product(int (&acc)[64], uint32_t a, int ksteps,
                                             unsigned char* ring, uint64_t* full,
                                             uint64_t* empty, int& g) {
  const int chunks = (ksteps + 3) / 4;
  int prev = 0;
  hopper::fence_regs(acc);
  hopper::wg_fence();
  for (int kc = 0; kc < chunks; ++kc, ++g) {
    const int st = g % S;
    hopper::mbar_wait(&full[st], (g / S) & 1);
    const uint32_t wa = hopper::saddr(ring + st * STAGE);
    if (kc > 0) hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)      // whole chunks: A and W are zero past K
      hopper::wgmma_s8_n128(acc, hopper::desc(a + kc * ATOM + kk * 32),
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
}

// LayerNorm of R rows of x and their int8 into the A tile of every block
// of the cluster (distributed shared memory), with their scales: R rows a
// warp in flight together, lane l holding columns 128 j + 4 l .. + 3,
// loaded as one vector where `vec`; no branch per element
template <int R, typename T>
__device__ __forceinline__ void norm_rows(const T* __restrict__ x, const float (&lns)[DMAX / 128][4],
                                          const float (&lnb)[DMAX / 128][4],
                                          unsigned char* const (&a1)[CLUSTER],
                                          float* const (&xs)[CLUSTER], int r0, int m0, int M,
                                          int D, int kc1, float eps, bool vec, int lane) {
  constexpr int J = DMAX / 128;
  const float inv_d = 1.f / static_cast<float>(D);
  float v[R][J][4], sum[R], sq[R], am[R];
  if (vec) {
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int m = m0 + r0 + q, k = 128 * j + 4 * lane;
        v[q][j][0] = v[q][j][1] = v[q][j][2] = v[q][j][3] = 0.f;
        if (m < M && k < D) load4(x + (size_t)m * D + k, v[q][j]);
      }
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + r0 + q, k = 128 * j + 4 * lane + e;
          v[q][j][e] = (m < M && k < D) ? to_f(x[(size_t)m * D + k]) : 0.f;
        }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    sum[q] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[q] = __fadd_rn(sum[q], v[q][j][e]);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) sum[q] = __fmul_rn(warp_sum(sum[q]), inv_d);   // the mean
#pragma unroll
  for (int q = 0; q < R; ++q) {
    sq[q] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = 128 * j + 4 * lane + e < D ? __fsub_rn(v[q][j][e], sum[q]) : 0.f;
        sq[q] = __fadd_rn(sq[q], __fmul_rn(d, d));
      }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const float rs = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq[q]), inv_d), eps));
    const bool live = m0 + r0 + q < M;
    am[q] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[q][j][e], sum[q]), rs),
                                            lns[j][e]), lnb[j][e]);
        v[q][j][e] = live && 128 * j + 4 * lane + e < D ? y : 0.f;
        am[q] = fmaxf(am[q], fabsf(v[q][j][e]));
      }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) am[q] = warp_max(am[q]);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const RowDiv d = row_div(row_scale(am[q]));
#pragma unroll
    for (int p = 0; p < CLUSTER; ++p)
      if (lane == 0) xs[p][r0 + q] = d.s;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (j < kc1) {
        const int w = pack4(quant_bits(v[q][j][0], d), quant_bits(v[q][j][1], d),
                            quant_bits(v[q][j][2], d), quant_bits(v[q][j][3], d));
#pragma unroll
        for (int p = 0; p < CLUSTER; ++p)
          *reinterpret_cast<int*>(a1[p] + j * ATOM + hopper::swz(r0 + q, 4 * lane)) = w;
      }
  }
}

// N1, N2: product slots of each consumer warpgroup in the W1 and W2
// products (1 or 2 tiles of 128 columns each), fixed at compile time and
// the same for both warpgroups, so that no product sits on a path that
// differs between threads (ptxas would serialize the products); a slot
// past a block's last tile multiplies what its copy brings, and its
// columns are masked
template <typename T, int N1, int N2>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
int8_ffn_kernel(const __grid_constant__ CUtensorMap w1map, const __grid_constant__ CUtensorMap w2map,
                const T* __restrict__ x, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, const float* __restrict__ s1,
                const float* __restrict__ b1, const float* __restrict__ s2,
                const float* __restrict__ b2, T* __restrict__ out, int M, int D, int H,
                float half, float eps) {
  // the W1 product's depth is D: at most 256 where N2 == 1 (D <= 256)
  constexpr bool SMALL = N2 == 1;
  static_assert(!SMALL || 256 <= SMALL_K, "dequant<true> needs |acc| < 2^22");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  unsigned char* a1 = smem + A1_OFF;              // LN(x) int8, [kc1][64 x 128]
  unsigned char* a2 = smem + A2_OFF;              // the hidden's int8, [4][64 x 128]
  unsigned char* rings = smem + RING_OFF;         // [2][S][STAGE]
  int* part = reinterpret_cast<int*>(smem);       // [64][pstride(D)], after the products
  float2* sb1 = reinterpret_cast<float2*>(smem + PROD_BYTES);   // (s1, b1) of the quarter
  float* xs = reinterpret_cast<float*>(sb1 + HQMAX);           // [64] s_x
  float* wmax = xs + TM;                          // [2][64] row maxima per consumer
  float* cmax = wmax + 2 * TM;                    // [64] the block's row maxima
  float* hs = cmax + TM;                          // [64] s_h
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + TM);    // [2][S]
  uint64_t* empty = full + 2 * S;                            // [2][S]
  uint64_t* a1_full = empty + 2 * S;              // A1 and s_x written by all 4 blocks

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int m0 = (blockIdx.x / CLUSTER) * TM;
  const int hq = quarter(H), h0 = rank * hq;
  const int hlen = H - h0 < hq ? (H - h0 > 0 ? H - h0 : 0) : hq;   // this block's hidden columns
  const int nth = hlen > 128 ? (hlen + 127) / 128 : 1;   // hidden tiles of 128 (1..4)
  const int ks1 = pad32(D) / 32, kc1 = (ks1 + 3) / 4;
  const int ntd = (D + 127) / 128;                // output tiles of 128 (<= 4)
  const int tid = threadIdx.x, wg = tid >> 7;
  // whole 4-element vectors of x, out, s2 and b2 (D a multiple of 4, aligned)
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(s2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b2) % 16 == 0;
  if (tid == 0) {
    for (int i = 0; i < 2 * S; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 128);
    }
    hopper::mbar_init(a1_full, CLUSTER);
    hopper::mbar_fence_init();
  }
  for (int i = tid; i < HQMAX; i += THREADS)
    sb1[i] = i < hlen ? make_float2(s1[h0 + i], b1[h0 + i]) : make_float2(0.f, 0.f);
  __syncthreads();
  hopper::cluster_arrive();          // every block's barriers initialised before
  hopper::cluster_wait();            // any block arrives on them

  if (wg == 0) {
    hopper::setmaxnreg_dec<REG_PRODUCER>();
    hopper::cluster_arrive();                     // nothing of this warpgroup to publish
    if ((tid & 31) == 0 && tid < 64) {            // one thread per ring, in the
      const int c = tid >> 5;                     // order its warpgroup consumes them
      unsigned char* ring = rings + c * S * STAGE;
      int g = 0;
      for (int s = 0; s < N1; ++s)                // the W1 product's hidden tiles
        for (int kc = 0; kc < kc1; ++kc)
          issue(ring, full + c * S, empty + c * S, g, &w1map, 128 * kc, h0 + 128 * (c + 2 * s));
      for (int s = 0; s < N2; ++s)                // the W2 product's output tiles
        for (int kc = 0; kc < nth; ++kc)
          issue(ring, full + c * S, empty + c * S, g, &w2map, h0 + 128 * kc, 128 * (c + 2 * s));
    }
    hopper::cluster_wait();
    hopper::cluster_arrive();
    hopper::cluster_wait();
    hopper::cluster_arrive();
    hopper::cluster_wait();
    return;
  }

  hopper::setmaxnreg_inc<REG_CONSUMER>();
  const int c = wg - 1, cw = (tid >> 5) - 4, warp = cw & 3, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);         // this thread's accumulator rows r0, r0 + 8
  unsigned char* ring = rings + c * S * STAGE;
  uint64_t* fb = full + c * S;
  uint64_t* eb = empty + c * S;

  // 1. LayerNorm and int8 of the tile's 64 rows, shared out over the
  //    cluster: block r takes rows 16 r .. + 15 (consumer warp w two of
  //    them) and writes their int8 and scales into all four blocks' A1;
  //    each block then waits until all four have written
  {
    float lns[DMAX / 128][4], lnb[DMAX / 128][4];
#pragma unroll
    for (int j = 0; j < DMAX / 128; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 128 * j + 4 * lane + e;
        lns[j][e] = k < D ? ln_s[k] : 0.f;
        lnb[j][e] = k < D ? ln_b[k] : 0.f;
      }
    unsigned char* a1s[CLUSTER];
    float* xss[CLUSTER];
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      a1s[q] = cluster.map_shared_rank(a1, q);
      xss[q] = cluster.map_shared_rank(xs, q);
    }
    norm_rows<2>(x, lns, lnb, a1s, xss, 16 * rank + 2 * cw, m0, M, D, kc1, eps, vec, lane);
  }
  hopper::fence_proxy_async_all();
  hopper::bar_sync(1, CONSUMERS);
  if (tid == 128)
    for (int q = 0; q < CLUSTER; ++q) hopper::mbar_arrive_remote(a1_full, q);
  hopper::mbar_wait_cluster(a1_full, 0);
  hopper::fence_view_async();

  // 2. W1 product of this warpgroup's hidden tiles c, c + 2; h =
  //    swish(dequant + b1) in place (0 past the block's columns), row maxima
  int acc[2][64];
  int g = 0;
#pragma unroll
  for (int s = 0; s < N1; ++s) ring_product(acc[s], hopper::saddr(a1), ks1, ring, fb, eb, g);
  const float sx[2] = {xs[r0], xs[r0 + 8]};
  float am[2] = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < N1; ++s) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 128 * (c + 2 * s) + 8 * i + 2 * (lane & 3);   // local hidden column
      const float2 sb[2] = {sb1[col], sb1[col + 1]};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int& a = acc[s][4 * i + 2 * hh + e];
          float h = swish(__fadd_rn(dequant<SMALL>(a, sx[hh], sb[e].x), sb[e].y));
          h = col + e < hlen ? h : 0.f;
          am[hh] = fmaxf(am[hh], fabsf(h));
          a = __float_as_int(h);
        }
    }
  }

  // 3. row maxima: the quad's lanes, the two warpgroups, the four blocks
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    am[hh] = fmaxf(am[hh], __shfl_xor_sync(0xffffffffu, am[hh], 1));
    am[hh] = fmaxf(am[hh], __shfl_xor_sync(0xffffffffu, am[hh], 2));
  }
  if ((lane & 3) == 0) {
    wmax[c * TM + r0] = am[0];
    wmax[c * TM + r0 + 8] = am[1];
  }
  hopper::bar_sync(1, CONSUMERS);
  if (tid - 128 < TM) cmax[tid - 128] = fmaxf(wmax[tid - 128], wmax[TM + tid - 128]);
  hopper::cluster_arrive();
  hopper::cluster_wait();
  float mh[2] = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) {
    const float* rm = cluster.map_shared_rank(cmax, q);
    mh[0] = fmaxf(mh[0], rm[r0]);
    mh[1] = fmaxf(mh[1], rm[r0 + 8]);
  }
  const RowDiv sh[2] = {row_div(row_scale(mh[0])), row_div(row_scale(mh[1]))};
  if ((lane & 3) == 0) {
    hs[r0] = sh[0].s;
    hs[r0 + 8] = sh[1].s;
  }

  // 4. the hidden's int8 into A2 (its tiles' columns as K, zero past the
  //    block's), then the partial W2 product of this warpgroup's output
  //    tiles c, c + 2 over the block's hidden columns
#pragma unroll
  for (int s = 0; s < N1; ++s) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = 8 * i + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t q0 = quant_bits(__int_as_float(acc[s][4 * i + 2 * hh]), sh[hh]);
        const uint32_t q1 = quant_bits(__int_as_float(acc[s][4 * i + 2 * hh + 1]), sh[hh]);
        *reinterpret_cast<uint16_t*>(a2 + (c + 2 * s) * ATOM + hopper::swz(r0 + 8 * hh, k)) =
            pack2(q0, q1);
      }
    }
  }
  hopper::fence_view_async();
  hopper::bar_sync(1, CONSUMERS);
  const int ks2 = 4 * nth;                        // whole tiles of A2 (zero past hlen)
#pragma unroll
  for (int s = 0; s < N2; ++s) ring_product(acc[s], hopper::saddr(a2), ks2, ring, fb, eb, g);

  // 5. partial sums to shared memory (over A1, A2 and the rings, which
  //    both warpgroups are done with), then rows 16 rank .. + 15 of the
  //    tile from the four blocks' partials
  hopper::bar_sync(1, CONSUMERS);
  const int ps = pstride(D);
#pragma unroll
  for (int s = 0; s < N2; ++s) {
    const int t = c + 2 * s;
    if (t >= ntd) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<int2*>(part + (r0 + 8 * hh) * ps + 128 * t + 8 * i + 2 * (lane & 3)) =
            make_int2(acc[s][4 * i + 2 * hh], acc[s][4 * i + 2 * hh + 1]);
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();
  const int* parts[CLUSTER];
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) parts[q] = cluster.map_shared_rank(part, q);
  const int d4 = (D + 3) / 4;
  for (int idx = tid - 128; idx < 16 * d4; idx += CONSUMERS) {
    const int rl = 16 * rank + idx / d4, col = 4 * (idx % d4), m = m0 + rl;
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      const int4 p = *reinterpret_cast<const int4*>(parts[q] + rl * ps + col);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    if (m >= M) continue;
    const int sv[4] = {sum.x, sum.y, sum.z, sum.w};
    const float shr = hs[rl];
    if (vec) {
      float xv[4], o[4];
      load4(x + (size_t)m * D + col, xv);
      const float4 sc = __ldg(reinterpret_cast<const float4*>(s2 + col));
      const float4 bb = __ldg(reinterpret_cast<const float4*>(b2 + col));
      const float scv[4] = {sc.x, sc.y, sc.z, sc.w}, bbv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = __fadd_rn(xv[e], __fmul_rn(half, __fadd_rn(dequant(sv[e], shr, scv[e]), bbv[e])));
      store4(out + (size_t)m * D + col, o);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = col + e;
      if (n >= D) break;
      const float y = __fadd_rn(dequant(sv[e], shr, s2[n]), b2[n]);
      out[(size_t)m * D + n] = from_f<T>(__fadd_rn(to_f(x[(size_t)m * D + n]), __fmul_rn(half, y)));
    }
  }
  hopper::cluster_arrive();                       // keep the partials until all are read
  hopper::cluster_wait();
}

template <typename T, int N1, int N2>
cudaError_t launch_slots(const CUtensorMap& w1map, const CUtensorMap& w2map, const void* x,
                         const void* ln_s, const void* ln_b, const void* s1, const void* b1,
                         const void* s2, const void* b2, void* out, cudaStream_t s, int M, int D,
                         int H, float half, float eps) {
  static bool smem_set = false;     // once per process and kernel
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(int8_ffn_kernel<T, N1, N2>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long long grid = (long long)((M + TM - 1) / TM) * CLUSTER;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  int8_ffn_kernel<T, N1, N2><<<(int)grid, THREADS, SMEM, s>>>(
      w1map, w2map, static_cast<const T*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(out), M, D, H, half, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* ln_s, const void* ln_b, const void* w1t,
                   const void* s1, const void* b1, const void* w2t, const void* s2,
                   const void* b2, void* out, cudaStream_t s, int M, int D, int H, float half,
                   float eps) {
  CUtensorMap w1map, w2map;
  cudaError_t err = hopper::int8_map(&w1map, w1t, H, pad32(D));
  if (err == cudaSuccess) err = hopper::int8_map(&w2map, w2t, D, pad32(H));
  if (err != cudaSuccess) return err;
  // slots: half the hidden tiles of the widest block, half the output tiles
  const bool two1 = (quarter(H) + 127) / 128 > 2, two2 = (D + 127) / 128 > 2;
  auto go = [&](auto k1, auto k2) {
    return launch_slots<T, decltype(k1)::value, decltype(k2)::value>(
        w1map, w2map, x, ln_s, ln_b, s1, b1, s2, b2, out, s, M, D, H, half, eps);
  };
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  if (two1) return two2 ? go(Two{}, Two{}) : go(Two{}, One{});
  return two2 ? go(One{}, Two{}) : go(One{}, One{});
}

// ------------------------------------------------ wide: D > 512 or H > 2048
//
// Above the cluster kernel's widths (Conformer XL's D 1024 / H 4096 and
// beyond) the function runs in four launches, h in float32 through device
// memory. The cluster kernel holds a row's whole hidden in the registers
// of 4 blocks; at H 4096 that would need 8 blocks of 512 columns and the
// W2 partials of D 1024 reduced across them, more shared memory than a
// block has at D 2048. Through device memory the hidden's scale s_h is
// exact by construction: every h of a row is written before its absmax is
// taken, and nothing is quantized before that.
//   1. ffn_norm_quant_kernel: LayerNorm and the per-row int8 of x, one warp
//      a row, x read as 16-byte pieces (lane l the pieces l + 32 j, sums in
//      that order), into xq [M, pad32(D)] and s_x [M].
//   2. ffn_gemm_kernel<HIDDEN>: h = swish(float(xq W1) s_x s1 + b1) into h
//      [M, pad32(H)] (zero past H), and each (row, 128-column tile)'s max
//      |h| into pmax [M, H / 128]: a max is exact in any order, so the row
//      absmax leaves the pass over h.
//   3. ffn_hidden_quant_kernel: s_h = row_scale of the row's partial maxima,
//      then hq [M, pad32(H)] from one read of h, one warp a row, 16-byte
//      loads and stores.
//   4. ffn_gemm_kernel<OUT>: out = x + half (float(hq W2) s_h s2 + b2), x
//      read and out written as 16-byte vectors.
// The GEMMs are the persistent skeleton of hopper_gemm.cuh on int8 wgmma
// (m64n128k32, both operands K-major: the int8 rows and the weight's kernel
// layout), 192 x 128 tiles, epilogues staged through shared memory. At 6d
// (d)'s batch (M = 2992, D 1024 / H 4096) that is 512 hidden tiles (four
// rounds on 132 SMs) and 128 output tiles (one round), where the first
// design's 128 x 128 tiles ran the W2 product in 1.45 waves (192 blocks)
// and its epilogues stored 4- and 2-byte scalars. Bound there: the
// products' 50 G integer operations, 0.0254 ms at the int8 tensor rate;
// h's 49 MB written and read once more (~30 us at 3.35 TB/s if none of it
// stays in the 50 MB L2). The first design took 0.15-0.19 ms of device
// time, its hidden GEMM's scalar stores and the two passes over h the
// largest pieces by ablation; this one ~0.10 ms on an H100 at 700 W (the
// launches ~10, ~43, ~20 and ~26 us; the swish ~5 us of the hidden GEMM
// once no element branches around it; PERF.md,
// scripts/torch_int8_ablation.py). Every output element is one block's:
// bitwise repeatable. Limits: none on D, H or M.

constexpr int EPI_HIDDEN = 0, EPI_OUT = 1;

// the 16 bytes at p (aligned) as float32: 4 float32 or 8 bf16 values
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) { load4(p, v); }
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  pg::unpack8(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

// LayerNorm and int8 of rows of x, one warp a row: xq [M][kp], s_x [M].
// REG_D (1024 or 2048, D <= REG_D): the lane's pieces held in registers, x
// read once and each element normalised once (the loops run REG_D
// columns, so each width takes the smallest); REG_D = 0: every pass reads
// the row again (any D).
template <typename T, int REG_D>
__global__ void __launch_bounds__(256, 2)
ffn_norm_quant_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b, int8_t* __restrict__ xq,
                      float* __restrict__ sx, int M, int D, int kp, float eps) {
  constexpr bool REG = REG_D > 0;
  constexpr int V = 16 / sizeof(T);    // elements of a 16-byte piece
  constexpr int P = REG ? REG_D / (32 * V) : 1;   // REG: pieces a lane
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  const T* xr = x + (size_t)m * D;
  const bool vec = D % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // the V elements of piece p (columns V p ..), zero past D
  auto piece = [&](int p, float (&v)[V]) {
    const int k0 = V * p;
    if (vec && k0 < D) {
      load16(xr + k0, v);
      return;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = k0 + e < D ? to_f(xr[k0 + e]) : 0.f;
  };
  const int np = (D + V - 1) / V;
  const float inv_d = 1.f / static_cast<float>(D);
  float sum = 0.f, sq = 0.f, am = 0.f;
  int8_t* qr = xq + (size_t)m * kp;
  auto norm = [&](float v, int k, float mean, float rs) {
    return k < D ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rs), ln_s[k]), ln_b[k])
                 : 0.f;
  };
  auto store = [&](int p, const uint32_t (&b)[8]) {
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(qr + V * p) =
          make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
    else
      *reinterpret_cast<int*>(qr + V * p) = pack4(b[0], b[1], b[2], b[3]);
  };
  if constexpr (REG) {
    float v[P][V];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      piece(lane + 32 * j, v[j]);       // zeros past D
#pragma unroll
      for (int e = 0; e < V; ++e) sum = __fadd_rn(sum, v[j][e]);
    }
    const float mean = __fmul_rn(warp_sum(sum), inv_d);
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = V * (lane + 32 * j) + e < D ? __fsub_rn(v[j][e], mean) : 0.f;
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    const float rs = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps));
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[j][e] = norm(v[j][e], V * (lane + 32 * j) + e, mean, rs);
        am = fmaxf(am, fabsf(v[j][e]));
      }
    const RowDiv d = row_div(row_scale(warp_max(am)));
    if (lane == 0) sx[m] = d.s;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int p = lane + 32 * j;
      if (p >= kp / V) break;            // kp a multiple of 32: whole pieces, zero past D
      uint32_t b[8];
#pragma unroll
      for (int e = 0; e < V; ++e) b[e] = quant_bits(v[j][e], d);
      store(p, b);
    }
  } else {
    for (int p = lane; p < np; p += 32) {
      float v[V];
      piece(p, v);
#pragma unroll
      for (int e = 0; e < V; ++e) sum = __fadd_rn(sum, v[e]);
    }
    const float mean = __fmul_rn(warp_sum(sum), inv_d);
    for (int p = lane; p < np; p += 32) {
      float v[V];
      piece(p, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = V * p + e < D ? __fsub_rn(v[e], mean) : 0.f;
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
    const float rs = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps));
    for (int p = lane; p < np; p += 32) {
      float v[V];
      piece(p, v);
#pragma unroll
      for (int e = 0; e < V; ++e) am = fmaxf(am, fabsf(norm(v[e], V * p + e, mean, rs)));
    }
    const RowDiv d = row_div(row_scale(warp_max(am)));
    if (lane == 0) sx[m] = d.s;
    for (int p = lane; p < kp / V; p += 32) {
      float v[V];
      piece(p, v);
      uint32_t b[8];
#pragma unroll
      for (int e = 0; e < V; ++e) b[e] = quant_bits(norm(v[e], V * p + e, mean, rs), d);
      store(p, b);
    }
  }
}

// s_h = row_scale(max |h|) over all H columns of each row, from the GEMM's
// partial maxima pmax [M][tiles], then the row's int8 from one read of h
// [M][hp] (zero past H), one warp a row, 16 columns a lane a step: hq
// [M][hp], sh [M]
__global__ void __launch_bounds__(256)
ffn_hidden_quant_kernel(const float* __restrict__ h, const float* __restrict__ pmax,
                        int8_t* __restrict__ hq, float* __restrict__ sh, int M, int hp,
                        int tiles) {
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  float am = 0.f;
  for (int j = lane; j < tiles; j += 32) am = fmaxf(am, pmax[(size_t)m * tiles + j]);
  const RowDiv d = row_div(row_scale(warp_max(am)));
  if (lane == 0) sh[m] = d.s;
  const float* hr = h + (size_t)m * hp;
  uint4* qr = reinterpret_cast<uint4*>(hq + (size_t)m * hp);
  for (int p = lane; p < hp / 16; p += 32) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float f[4];
      load4(hr + 16 * p + 4 * u, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * u + e] = f[e];
    }
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w[u] = static_cast<uint32_t>(pack4(quant_bits(v[4 * u], d), quant_bits(v[4 * u + 1], d),
                                         quant_bits(v[4 * u + 2], d), quant_bits(v[4 * u + 3], d)));
    qr[p] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// C [M, N] = A [M, K] B^T on int8 wgmma, persistent (hopper_gemm.cuh): A
// int8 rows by amap (boxes of 128 K bytes x 192 rows), B^T the weight's
// kernel layout [N, K] by bmap (128 x 128), kc 128-byte chunks of K; tile
// (mt, nt) is rows 192 mt.. x columns 128 nt... The epilogue EPI, with the
// plain version's rounding points and no per-element branch:
//   HIDDEN: hout[m, n] = swish(float(C) s_row[m] s_col[n] + bias[n]) for
//           n < N, 0 for N <= n < ldo (hout [M][ldo]), and the tile's max
//           |h| of each row into pmax[m][nt];
//   OUT:    out[m, n] = x[m, n] + half (float(C) s_row[m] s_col[n] + bias[n]).
template <int EPI, typename T>
__global__ void __launch_bounds__(pg::THREADS, 1)
ffn_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                const float* __restrict__ s_row, const float* __restrict__ s_col,
                const float* __restrict__ bias, const T* __restrict__ x, float* __restrict__ hout,
                float* __restrict__ pmax, T* __restrict__ out, int M, int N, int ldo, int kc,
                float half) {
  extern __shared__ unsigned char smem_raw[];
  const pg::Smem sm = pg::setup(smem_raw);
  __syncthreads();
  const int tn = (N + 127) / 128, tiles = (M + pg::TM - 1) / pg::TM * tn;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (wg == 0) {
    hopper::setmaxnreg_dec<pg::REG_PRODUCER>();
    if (tid == 0)
      pg::produce(sm, tiles, tn, kc, [&](unsigned char* dst, uint64_t* bar, int mt, int nt, int k) {
        hopper::tma_load(dst, &amap, bar, 128 * k, pg::TM * mt);
        hopper::tma_load(dst + pg::A_BYTES, &bmap, bar, 128 * k, 128 * nt);
      });
    return;
  }

  hopper::setmaxnreg_inc<pg::REG_CONSUMER>();
  const int c = wg - 1, ct = tid & 127, w = ct >> 5, q = tid & 3;
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int acc[64];
  int g = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tn) * pg::TM + 64 * c, nt = t % tn, n0 = 128 * nt;
    pg::consume(acc, sm, kc, g, c, [](int (&a)[64], uint32_t sa, uint32_t sb, int k) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_s8_n128(a, hopper::desc(sa + kk * 32), hopper::desc(sb + kk * 32),
                              (k | kk) != 0);
    });
    // y (HIDDEN: h) in place of the int32 sums, as float bits
    float am[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float sr = s_row[min(m0 + 16 * w + (ct & 31) / 4 + 8 * hh, M - 1)];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * i + 2 * q + e, nc = min(n, N - 1);
          int& a = acc[4 * i + 2 * hh + e];
          const float y = __fadd_rn(dequant(a, sr, s_col[nc]), bias[nc]);
          if constexpr (EPI == EPI_HIDDEN) {
            const float hv = swish(y) * (n < N ? 1.f : 0.f);   // no branch
            am[hh] = fmaxf(am[hh], fabsf(hv));
            a = __float_as_int(hv);
          } else {
            a = __float_as_int(y);
          }
        }
    }
    if constexpr (EPI == EPI_HIDDEN) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = fmaxf(am[hh], __shfl_xor_sync(0xffffffffu, am[hh], 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const int m = m0 + 16 * w + (ct & 31) / 4 + 8 * hh;
        if (q == 0 && m < M) pmax[(size_t)m * tn + nt] = mx;
      }
    }
#pragma unroll   // whole: acc is indexed by hf, so it stays in registers
    for (int hf = 0; hf < 2; ++hf) {
      const float* stg = pg::stage(sm.stg, c, hf, [&](int i, int hh, int e) {
        return __int_as_float(acc[4 * i + 2 * hh + e]);
      });
      const int nb = n0 + 64 * hf;
      if constexpr (EPI == EPI_HIDDEN) {
        for (int j = ct; j < 64 * 16; j += 128) {   // 64 rows x 16 float4
          const int r = j >> 4, cc = (j & 15) * 4, m = m0 + r;
          if (m < M && nb + cc < ldo)
            *reinterpret_cast<float4*>(hout + (size_t)m * ldo + nb + cc) =
                *reinterpret_cast<const float4*>(stg + r * pg::EPI_LD + cc);
        }
      } else if (vec) {
        for (int j = ct; j < 64 * 8; j += 128) {    // 64 rows x 8 pieces of 8 columns
          const int r = j >> 3, cc = (j & 7) * 8, m = m0 + r, n = nb + cc;
          if (m >= M || n >= N) continue;
          float xv[8];
          pg::load8(x + (size_t)m * N + n, xv);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            xv[e] = __fadd_rn(xv[e], __fmul_rn(half, stg[r * pg::EPI_LD + cc + e]));
          pg::store8(out + (size_t)m * N + n, xv);
        }
      } else {
        for (int j = ct; j < 64 * 64; j += 128) {
          const int r = j >> 6, cc = j & 63, m = m0 + r, n = nb + cc;
          if (m >= M || n >= N) continue;
          const size_t o = (size_t)m * N + n;
          out[o] = from_f<T>(__fadd_rn(to_f(x[o]), __fmul_rn(half, stg[r * pg::EPI_LD + cc])));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_wide(const void* x, const void* ln_s, const void* ln_b, const void* w1t,
                        const void* s1, const void* b1, const void* w2t, const void* s2,
                        const void* b2, void* out, void* xq, void* sx, void* h, void* pmax,
                        void* hq, void* sh, cudaStream_t s, int M, int D, int H, float half,
                        float eps) {
  const int dp = pad32(D), hp = pad32(H), tn1 = (H + 127) / 128, mt = (M + pg::TM - 1) / pg::TM;
  static bool smem_set = false;     // once per process and type
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(ffn_gemm_kernel<EPI_HIDDEN, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)pg::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ffn_gemm_kernel<EPI_OUT, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pg::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  constexpr auto U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap xmap, w1map, hmap, w2map;
  cudaError_t err = hopper::tile_map(&xmap, U8, 1, xq, M, dp, pg::TM);
  if (err == cudaSuccess) err = hopper::weight_map(&w1map, U8, 1, w1t, H, dp, 128);
  if (err == cudaSuccess) err = hopper::tile_map(&hmap, U8, 1, hq, M, hp, pg::TM);
  if (err == cudaSuccess) err = hopper::weight_map(&w2map, U8, 1, w2t, D, hp, 128);
  if (err != cudaSuccess) return err;
  const int rows = (M + 7) / 8;
  auto norm = D <= 1024   ? ffn_norm_quant_kernel<T, 1024>
              : D <= 2048 ? ffn_norm_quant_kernel<T, 2048>
                          : ffn_norm_quant_kernel<T, 0>;
  norm<<<rows, 256, 0, s>>>(static_cast<const T*>(x), static_cast<const float*>(ln_s),
                            static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
                            static_cast<float*>(sx), M, D, dp, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ffn_gemm_kernel<EPI_HIDDEN, T><<<pg::grid_size(mt * tn1), pg::THREADS, pg::SMEM, s>>>(
      xmap, w1map, static_cast<const float*>(sx), static_cast<const float*>(s1),
      static_cast<const float*>(b1), nullptr, static_cast<float*>(h), static_cast<float*>(pmax),
      nullptr, M, H, hp, (dp + 127) / 128, half);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ffn_hidden_quant_kernel<<<rows, 256, 0, s>>>(static_cast<const float*>(h),
                                               static_cast<const float*>(pmax),
                                               static_cast<int8_t*>(hq), static_cast<float*>(sh),
                                               M, hp, tn1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ffn_gemm_kernel<EPI_OUT, T><<<pg::grid_size(mt * ((D + 127) / 128)), pg::THREADS, pg::SMEM, s>>>(
      hmap, w2map, static_cast<const float*>(sh), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const T*>(x), nullptr, nullptr,
      static_cast<T*>(out), M, D, D, (hp + 127) / 128, half);
  return cudaGetLastError();
}

}  // namespace

// w1t, w2t: the kernel layouts of W1 and W2, int8 [H, D_pad] and [D, H_pad]
// (ops/int8_matmul.kernel_layout: K rounded up to a multiple of 32, zero
// past it)
extern "C" int int8_ffn_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w1t,
                            const void* s1, const void* b1, const void* w2t, const void* s2,
                            const void* b2, void* out, void* stream, int M, int D, int H,
                            int is_bf16, float half, float eps) {
  if (M < 1 || D < 1 || D > DMAX || H < 1 || quarter(H) > HQMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, out, s, M, D, H,
                                      half, eps)
              : launch<float>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, out, s, M, D, H, half, eps);
  return static_cast<int>(err);
}

// The wide route (D > 512 or H > 2048; any widths): the same inputs, and
// scratch (16-byte aligned) xq int8 [M, pad32(D)], sx float32 [M], h
// float32 [M, pad32(H)], pmax float32 [M, ceil(H / 128)], hq int8 [M,
// pad32(H)], sh float32 [M]. Four launches (see "wide" above).
extern "C" int int8_ffn_wide_fwd(const void* x, const void* ln_s, const void* ln_b,
                                 const void* w1t, const void* s1, const void* b1, const void* w2t,
                                 const void* s2, const void* b2, void* out, void* xq, void* sx,
                                 void* h, void* pmax, void* hq, void* sh, void* stream, int M,
                                 int D, int H, int is_bf16, float half, float eps) {
  if (M < 1 || D < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_wide<__nv_bfloat16>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, out, xq, sx,
                                           h, pmax, hq, sh, s, M, D, H, half, eps)
              : launch_wide<float>(x, ln_s, ln_b, w1t, s1, b1, w2t, s2, b2, out, xq, sx, h, pmax,
                                   hq, sh, s, M, D, H, half, eps);
  return static_cast<int>(err);
}
