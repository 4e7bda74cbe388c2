// Fused transducer joint over the full lattice, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel conformer_tpu/ops/pallas/joint_kernel.py:
// _forward / _fwd_kernel (joint_lattice_fwd), and _backward's two calls,
// _bwd_xp_kernel (joint_lattice_bwd_xp) and _bwd_w_kernel
// (joint_lattice_bwd_w). For every lattice cell m = (b, t, u), with
// x = tanh(enc[b,t] + pred[b,u]) in enc's dtype (the sum in the wider of
// the two dtypes: rounded to bf16 when both are bf16, as the TPU kernel
// does; the model gives bf16 enc and float32 pred) and logits = x W + bias
// (float32 sums, W in enc's dtype, bias float32):
//
//   logZ = logsumexp_v logits,  lp_blank = logits[blank] - logZ,
//   lp_emit = logits[lab[b,u]] - logZ   (0 - logZ for a label outside [0, V));
//
// and, from the saved logZ and the cotangents g_b, g_e,
//
//   dl[m,v] = -(g_b + g_e) p + g_b [v = blank] + g_e [v = lab],  p = exp(logits - logZ)
//   dpre = (dl W^T) (1 - x^2),  d enc[b,t] = sum_u dpre,  d pred[b,u] = sum_t dpre,
//   dW = sum_m x^T dl,  dbias = sum_m dl.
//
// The [B, T, U+1, V] logits never exist: each block holds a tile of them.
//
// Bound: the products. One product is 2 M J V flops (M = B T (U+1) cells):
// 3.0e12 at the training shape (B=24, T'=374, U+1=65, J=512, V=5002), 3.0 ms
// at the bf16 tensor rate; float32 runs each product as 3xTF32 (three tf32
// products, 18 ms at 495 TFLOP/s). The forward is one product; bwd_xp two
// (the logits again, and dl W^T); bwd_w two (the logits again, and x^T dl).
// The bytes (enc, pred, W, the lattice outputs) are tens of MB, far below.
// The exps (M V per pass, 2.9e9) take ~0.7 ms on the special-function units.
//
// Design. The TPU kernel kept a (16 t x 128-padded u) x J tile and all of W
// in VMEM; neither fits a block's 227 KB here. The cells are flattened into
// M rows and a block owns a fixed tile of rows (64 or 128) whatever U is:
// the block shape never depends on U (a block that held every u was refused
// at U+1 = 201 in the simple lattice's backward). Two routes, by dtype and
// J: the narrow kernels (bf16 enc only, the model's path, at the shipped
// join widths), each a fused block that computes its own x tile and keeps
// it in shared memory; and the wide route (float32 at every J, bf16 above
// the narrow widths), which writes its operands once in the layouts the
// tensor cores read and runs every product on one kernel,
// joint_gemm_kernel ("wide route" below). float32 has no narrow kernels:
// on the wide route's 3xTF32 it runs 4-6x faster than fused FMA kernels
// on the CUDA cores did at J 512 (PERF.md).
//
// The forward in bf16 (bf16 enc, float32 or bf16 pred), joint_fwd_wg_kernel,
// redesigned for Hopper: one block = 128 cells, two consumer warpgroups
// with a 64-row x tile each (x computed in the block, 128-byte swizzled)
// and a producer warpgroup whose one thread streams W by TMA into a ring
// that both consumers read. W streams in V tiles of 128 columns, each in
// J / 64 stages of [64 rows x 128 columns] (16 KB), so the stage does not
// grow with J: the two x tiles take 128 KB at J = 512 and 160 KB at
// J = 640, and the ring the rest of 224 KB (6 stages at J = 512, 4 at 640;
// a [J x 64] stage would be 80 KB at J = 640, and two of them and the x
// tiles would not fit). A consumer accumulates its 64 x 128 logits tile in
// registers (wgmma m64n128k16, x K-major, W MN-major, float32 sums),
// releasing each stage when the products that read it are done, and runs
// the epilogue on the accumulators: the bias, a per-thread online max and
// rescaled sum of exps per row (the four lanes of a row combine once, at
// the end), the blank and label picks. Logits never reach shared memory.
// The consumers share stages but not a barrier, so one's epilogue can run
// while the other's products do. The 128-row block reads W from L2 once
// for 128 cells: 32 GB at B=32 (M = 777,920), where 64-row blocks would
// read 64 GB. Bound: one product, 2 M J V flops (4.03 ms at B=32).
//
// The backward in bf16 (bf16 enc, float32 or bf16 pred: the model's path),
// joint_bwd_xp_wg_kernel and joint_bwd_w_wg_kernel, redesigned for Hopper:
//  - wgmma (m64nNk16, bf16 operands from 128-byte-swizzled shared memory,
//    float32 accumulators in registers) for both products. One W tile
//    [J x 64] serves both: MN-major (transposed) as x W's B operand, K-major
//    as dl W^T's; in bwd_w the x tile is x W's K-major A and x^T dl's
//    MN-major A, and dl is K-major A (bwd_xp) or MN-major B (bwd_w).
//  - A producer warpgroup (one thread, setmaxnreg 40) fills a 2-stage ring
//    by TMA (tensor maps built per call through the driver entry point),
//    completing on mbarriers; two consumer warpgroups (setmaxnreg 232) run
//    the products and the epilogue and release each stage with an arrive.
//    bwd_xp streams W tiles past its x tile (computed in the block from enc
//    and pred); bwd_w keeps its W tile and streams 64-row x tiles of the x
//    buffer.
//  - The logits tile never leaves registers: each consumer warpgroup
//    computes half of its V columns (m64n32k16, depth J), turns them into
//    dl on the accumulators (exp, picks), and writes dl as bf16 into its
//    half of a swizzled 64 x 64 tile; after a named barrier between the
//    two warpgroups (dl double-buffered, so one barrier per step orders
//    everything) each runs its half of the second product on the whole dl
//    tile: bwd_xp the 256 columns of dX it owns (m64n256k16, 128 float32
//    accumulators a thread), bwd_w 256 rows of the dW tile (4 x m64n64k16).
//  - Bytes: per call at B=32 (M = 777,920, Vp = 5056) bwd_xp streams W
//    12,155 times (62.9 GB) and bwd_w its x buffer 79 times (62.9 GB), both
//    from L2; the dpre scratch adds 1.6 GB each way and bwd_w's x buffer
//    and partials ~1.8 GB of device memory. Against the products' bound
//    (two products, 8.06 ms at 989 TFLOP/s) the re-reads need ~2.9 TB/s
//    of L2 at 22 ms. Taking the TMA copies out of a copy of the kernel saves
//    0.1 ms (scripts/torch_joint_ablation.py): the ring hides them, so
//    cluster multicast, which would halve those bytes, would not move the
//    time, and none is used. What holds the kernels is the serial order
//    within a V step (logits product, exp epilogue, hand-off barrier,
//    second product), each stage waiting on the last; overlapping the next
//    step's logits with this step's epilogue needs a third ring stage
//    (272 KB), and with two it exposed the TMA latency (slower: PERF.md).
//  - The exps: M V per pass (3.9e9), ~0.9 ms on the special-function units.

// Reductions across blocks take no atomics, so the backward is bitwise
// repeatable. bwd_xp: each block accumulates its rows' dX = dl W^T over all
// of V in registers, writes dpre [M, J] float32, and a second grid sums it
// over u (d enc) and over t (d pred) in a fixed order. bwd_w: a first grid
// writes x [M, J] in the inputs' dtype; the main grid's block owns (a V
// tile, a chunk of rows) and accumulates that chunk's dW tile [J x 64] in
// registers; a last grid sums the chunks' partial dW and dbias in order.
// The C entries report the grids they launched (the narrow kernels 1, 2
// and 3; the wide route's forward 2 per chunk of cells and 2, its
// backward 3 per chunk and 2).
//
// The wide route (float32 at every J, bf16 above the narrow widths): per
// chunk of cells the products on wgmma fed by a TMA ring (3xTF32 in
// float32). Bound at B=8, T'=374, U+1=65, V=5002 (M = 194,480): one
// product is 2 M J V flops: bf16 J = 1024 2.01 ms at 989 TFLOP/s; float32
// J = 640 as 3xTF32 (three tf32 products) 7.55 ms at 495 TFLOP/s. The
// forward runs one, each backward entry two. Bytes, all from L2 but dl: a
// product's 128 x BN tiles read their A and B slabs once per tile,
// (1/128 + 1/BN) M N K operand values a product: bf16 J 1024 (BN 256)
// ~24 GB, float32 J 640 (BN 128, hi and lo, 8 bytes a value) ~80 GB,
// ~5 and ~16 ms at ~5 TB/s of L2, against the products' 2.0 and 7.6 ms.
//  - The forward: the logits product x W^T with a logsumexp epilogue on
//    the accumulators: per row of the 128 x BN tile the max of its logits
//    and the sum of their exps about that max (bias added, columns past V
//    masked; the four lanes of a row combine by shuffles), written as one
//    (max, sum) pair per (V tile, cell), [2][Vp / BN][M] float32: 31 MB in
//    bf16 and 62 MB in float32 at B=8. The tile that holds the blank or the
//    row's label writes that logit. The logits never reach device memory.
//    A last grid folds each cell's V tiles in tile order into logZ and
//    subtracts it from the picks: no atomics, bitwise repeatable.
//  - The backward: the logits product once per cell at every J, dl between
//    the two products in device memory. dl is written once and read once
//    (W^T x chunks in the bf16 dW product read it J / 128 times,
//    consecutive tiles sharing it in L2): 2.0 GB each way in bf16, 7.9 GB
//    (hi and lo) in float32, 1.2 and 4.7 ms of device memory at 3.35 TB/s.
// What it does about the bytes: 128-row tiles, BN 256 in bf16 (the A slab
// read once per 256 columns), consecutive blocks sharing one A tile (x in
// the logits products; W or W^T, 10-26 MB, stays in L2), 4-6 ring stages,
// no second pass over the logits. Its times against these: PERF.md.
//
// Limits: J a multiple of 128 (the wrapper pads J with zeros, which is
// exact: x = tanh(0) = 0 in the padded columns and W's padded rows are 0),
// any J; V padded by the caller to Vp, a multiple of 64, and of 128 for the
// forward (W's padded columns are never read into a result). Routes by
// dtype and J: bf16, the forward on joint_fwd_wg_kernel up to J = 640, the
// backward on the narrow wgmma kernels up to J = 512 (214 KB of shared
// memory there; at J = 640 its x tile, a 2-stage ring of [J x 64] W tiles
// and the dl tiles would need 240 KB; the wide backward, faster at 640,
// takes it: PERF.md), the wide route above; float32, the wide route at
// every J. The wide route's chunk of cells is the wrapper's (dl within
// 512 MiB); its ring takes 192 KB of shared memory.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int WG_ROWS = 64;            // cells of a narrow bwd_w tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// x = tanh(e + p) in T, the sum in the wider of T and TP (rounded to bf16
// when both are bf16)
template <typename T, typename TP> __device__ __forceinline__ T joint_x(T e, TP p) {
  float s = to_f(e) + to_f(p);
  if constexpr (std::is_same<T, bf16>::value && std::is_same<TP, bf16>::value)
    s = to_f(from_f<bf16>(s));
  return from_f<T>(tanhf(s));
}

// lab of cell m = (b, t, u): lab[b, u]
__device__ __forceinline__ int cell_label(const int* lab, int m, int Tn, int U1) {
  const int bt = m / U1;
  return lab[(bt / Tn) * U1 + (m - bt * U1)];
}

// d enc[b,t] = sum_u dpre[b,t,u] (blocks [0, B T)); d pred[b,u] = sum_t
// dpre[b,t,u] (blocks [B T, B T + B U1)); in order, no atomics
__global__ void joint_reduce_xp_kernel(const float* __restrict__ dpre, float* __restrict__ d_enc,
                                       float* __restrict__ d_pred, int B, int Tn, int U1, int J) {
  const int blk = blockIdx.x;
  if (blk < B * Tn) {
    const float* src = dpre + (size_t)blk * U1 * J;
    for (int j = threadIdx.x; j < J; j += blockDim.x) {
      float s = 0.f;
      for (int u = 0; u < U1; ++u) s += src[(size_t)u * J + j];
      d_enc[(size_t)blk * J + j] = s;
    }
  } else {
    const int bu = blk - B * Tn, b = bu / U1, u = bu - b * U1;
    const float* src = dpre + ((size_t)b * Tn * U1 + u) * J;
    for (int j = threadIdx.x; j < J; j += blockDim.x) {
      float s = 0.f;
      for (int t = 0; t < Tn; ++t) s += src[(size_t)t * U1 * J + j];
      d_pred[(size_t)bu * J + j] = s;
    }
  }
}

// x [M][J] in the inputs' dtype, one warp per row
template <typename T, typename TP>
__global__ void joint_x_kernel(const T* __restrict__ enc, const TP* __restrict__ pred,
                               T* __restrict__ X, int M, int Tn, int U1, int J) {
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (m >= M) return;
  const int bt = m / U1, u = m - bt * U1, b = bt / Tn;
  const T* e = enc + (size_t)bt * J;
  const TP* p = pred + ((size_t)b * U1 + u) * J;
  for (int j = lane; j < J; j += 32) X[(size_t)m * J + j] = joint_x<T, TP>(e[j], p[j]);
}

// dW = the sum of the n_part partials, dbias of the n_dbpart ones, in order
__global__ void joint_reduce_w_kernel(const float* __restrict__ part,
                                      const float* __restrict__ dbpart, float* __restrict__ dw,
                                      float* __restrict__ db, int n_part, int n_dbpart, size_t JV,
                                      int Vp) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < JV) {
    float s = 0.f;
    for (int c = 0; c < n_part; ++c) s += part[(size_t)c * JV + i];
    dw[i] = s;
  } else if (i < JV + Vp) {
    const size_t v = i - JV;
    float s = 0.f;
    for (int c = 0; c < n_dbpart; ++c) s += dbpart[(size_t)c * Vp + v];
    db[v] = s;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ------------------------------------------------------------ Hopper pieces
// wgmma (warpgroup MMA: bf16 operands from 128-byte-swizzled shared memory,
// float32 accumulators in registers), TMA copies into shared memory that
// complete on mbarriers, and the named barriers and fences around them.

namespace hop {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Matrix descriptor of an operand tile at shared address a, 128-byte
// swizzle. Every tile is built of 8-row groups of 128-byte rows (1024 B,
// 1024-aligned), the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B:
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8). The stride
// between 8-row groups (1024 B) goes in both offset fields: K-major
// operands step it along M/N, MN-major ones along K, and no operand here
// is wider than one 64-element row in its contiguous dimension. A start
// inside a row (+32, +64, +96 B) selects a K slice (K-major) or an N
// slice (MN-major); the swizzle applies to the full address, so the
// base-offset field stays 0.
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) | (kGroup << 16) | (kGroup << 32) |
         (1ull << 62);
}

// byte offset of bf16 element (r, c), c < 64, in a swizzled tile of 128-byte rows
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2);
}

__device__ __forceinline__ void fence_view_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 inner, c1 outer) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups of products are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Descriptor of an MN-major operand wider than one 128-byte row: 64-element
// column blocks `lbo` bytes apart (the leading-byte-offset field), 8-row
// groups 1024 B apart along K, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_mn(uint32_t a, uint32_t lbo) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (kGroup << 32) | (1ull << 62);
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N, float32) = [d +] A (64 x 16) B (16 x N); TA / TB: A / B
// MN-major (1) or K-major (0). The accumulator's element (row, col) of
// warp w, lane l: row 16 w + l / 4 (+8 for d[4i+2], d[4i+3]), column
// 8 i + 2 (l % 4) (+1 for d[4i+1], d[4i+3]).

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 32) wgmma_n32<TA, TB>(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_n64<TA, TB>(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_n128<TA, TB>(d, a, b, scale_d);
  else if constexpr (N == 192) wgmma_n192<TA, TB>(d, a, b, scale_d);
  else wgmma_n256<TA, TB>(d, a, b, scale_d);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (saddr(p) & 1023)) & 1023);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace hop

// ------------------------------------------------ bf16 backward on wgmma
//
// One block = 3 warpgroups: warpgroup 0 is the producer (one thread issues
// the TMA copies, 40 registers), warpgroups 1 and 2 the consumers (232
// registers). Per 64-row tile of cells and 64-column V tile v0 each consumer
// warpgroup c computes half of the logits tile, S[:, 32c, 32c + 32) = x W
// (m64n32k16, depth J; x K-major, W's tile MN-major through the +64 B
// N slice), turns it into dl in registers (the epilogue on the
// accumulators; no float32 round trip through shared memory), writes dl
// as bf16 into its half of a swizzled 64 x 64 tile, and after a named
// barrier between the two consumer warpgroups runs its half of the second
// product on the whole dl tile. dl is double-buffered, so one barrier per
// V step orders everything.

constexpr int WG_THREADS = 384;
constexpr int WG_CONSUMERS = 256;
constexpr int WG_REG_PRODUCER = 40, WG_REG_CONSUMER = 232;
constexpr uint32_t ATOM = 8192;   // bytes of one 64 x 64 bf16 swizzled tile

// shared memory of the wgmma kernels: three J x 64 bf16 tiles (x and two
// ring stages, or W and two ring stages), two dl tiles, mbarriers, and
// room to align the base to 1024 B
__host__ __device__ constexpr size_t wg_smem(int J) {
  return 3 * (size_t)J * 128 + 2 * ATOM + 64 + 1024;
}

// the row constants of cell m: logZ, g_b, g_e, label (g = 0 and no label
// past `end`)
struct RowC {
  float lz, gb, ge;
  int lb;
};
__device__ __forceinline__ RowC row_consts(const float* __restrict__ logz,
                                           const float* __restrict__ gb,
                                           const float* __restrict__ ge,
                                           const int* __restrict__ lab, int m, int end, int Tn,
                                           int U1) {
  if (m >= end) return {0.f, 0.f, 0.f, -1};
  return {logz[m], gb[m], ge[m], cell_label(lab, m, Tn, U1)};
}

// S = this warpgroup's 64 x 32 half of the logits, bias not yet added: x
// (K-major, J / 64 swizzled atoms at xa) times columns [32 c, 32 c + 32)
// of the W tile at wa (J rows of 128 B, MN-major)
template <int J>
__device__ __forceinline__ void logits_half(float (&s)[16], uint32_t xa, uint32_t wa, int c) {
  hop::fence_regs(s);
  hop::wg_fence();
#pragma unroll
  for (int k = 0; k < J / 16; ++k)
    hop::wgmma<32, 0, 1>(s, hop::desc(xa + (k >> 2) * ATOM + (k & 3) * 32),
                         hop::desc(wa + k * 2048 + c * 64), k > 0);
  hop::wg_commit();
  hop::wg_wait0();
  hop::fence_regs(s);
}

// dl of this thread's logits (rows r0 and r0 + 8, columns 32 c + 8 i +
// 2 (l % 4) + e) into the swizzled bf16 tile at dl; with `dbias`, the
// float32 dl added to the thread's column sums db[2 i + e]
template <bool kSum>
__device__ __forceinline__ void dl_half(const float (&s)[16], unsigned char* dl,
                                        const RowC (&rc)[2], const float (&bias)[8], int r0,
                                        int c, int v0, int V, int blank, float (&db)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const RowC& q = rc[h];
    const int r = r0 + 8 * h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = 32 * c + 8 * i + 2 * (lane & 3);
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = v0 + col + e;
        d[e] = 0.f;
        if (v < V) {
          const float p = __expf(s[4 * i + 2 * h + e] + bias[2 * i + e] - q.lz);
          d[e] = -(q.gb + q.ge) * p + (v == blank ? q.gb : 0.f) + (v == q.lb ? q.ge : 0.f);
        }
        if (kSum) db[2 * i + e] += d[e];
      }
      __nv_bfloat162 pr = __floats2bfloat162_rn(d[0], d[1]);
      *reinterpret_cast<__nv_bfloat162*>(dl + hop::swz(r, col)) = pr;
    }
  }
}

// d enc / d pred: block = one 64-row tile of cells; dpre [M][J] float32
template <int NJ, typename TP>
__global__ void __launch_bounds__(WG_THREADS, 1)
joint_bwd_xp_wg_kernel(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ enc,
                       const TP* __restrict__ pred, const float* __restrict__ bias,
                       const int* __restrict__ lab, const float* __restrict__ logz,
                       const float* __restrict__ gb, const float* __restrict__ ge,
                       float* __restrict__ dpre, int M, int Tn, int U1, int V, int Vp,
                       int blank) {
  constexpr int J = 128 * NJ, JH = J / 2;   // dX columns of each consumer warpgroup
  constexpr uint32_t TILE = J * 128;        // bytes of a J x 64 bf16 tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* xs = smem;                 // x [64][J]: J / 64 atoms
  unsigned char* ws = xs + TILE;            // W ring [2][J][64]
  unsigned char* dls = ws + 2 * TILE;       // dl [2][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + 2 * ATOM);
  uint64_t* empty = full + 2;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * 64, nv = Vp / 64;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], WG_CONSUMERS);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hop::setmaxnreg_dec<WG_REG_PRODUCER>();
    if (tid == 0) {
      for (int s = 0; s < nv; ++s) {
        const int st = s & 1;
        hop::mbar_wait(&empty[st], ((s >> 1) & 1) ^ 1);
        hop::mbar_expect(&full[st], TILE);
        unsigned char* dst = ws + st * TILE;
        hop::tma_load(dst, &wmap, &full[st], s * 64, 0);
        hop::tma_load(dst + JH * 128, &wmap, &full[st], s * 64, JH);
      }
    }
  } else {
    hop::setmaxnreg_inc<WG_REG_CONSUMER>();
    const int ct = tid - 128, c = wg - 1;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int r0 = 16 * warp + (lane >> 2);
    // x = tanh(enc + pred) of the tile's rows into the swizzled x atoms
    for (int r = ct >> 5; r < 64; r += WG_CONSUMERS / 32) {
      const int m = m0 + r;
      int bt = 0, u = 0, b = 0;
      if (m < M) {
        bt = m / U1;
        u = m - bt * U1;
        b = bt / Tn;
      }
#pragma unroll
      for (int a = 0; a < J / 64; ++a) {
        const int j = 64 * a + 2 * lane;
        float x0 = 0.f, x1 = 0.f;
        if (m < M) {
          const bf16* e = enc + (size_t)bt * J + j;
          const TP* p = pred + ((size_t)b * U1 + u) * J + j;
          x0 = to_f(joint_x<bf16, TP>(e[0], p[0]));
          x1 = to_f(joint_x<bf16, TP>(e[1], p[1]));
        }
        *reinterpret_cast<__nv_bfloat162*>(xs + a * ATOM + hop::swz(r, 2 * lane)) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
    RowC rc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rc[h] = row_consts(logz, gb, ge, lab, m0 + r0 + 8 * h, M, Tn, U1);
    hop::fence_view_async();
    hop::bar_sync(1, WG_CONSUMERS);

    const uint32_t xa = hop::saddr(xs);
    float acc[JH / 2];
#pragma unroll
    for (int i = 0; i < JH / 2; ++i) acc[i] = 0.f;
    float db[8];   // unused: no bias sums here
    for (int s = 0; s < nv; ++s) {
      const int st = s & 1, v0 = s * 64;
      float bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + 32 * c + 8 * i + 2 * (lane & 3) + e;
          bv[2 * i + e] = v < V ? bias[v] : 0.f;
        }
      hop::mbar_wait(&full[st], (s >> 1) & 1);
      const uint32_t wa = hop::saddr(ws + st * TILE);
      float sl[16] = {};
      logits_half<J>(sl, xa, wa, c);
      unsigned char* dl = dls + st * ATOM;
      dl_half<false>(sl, dl, rc, bv, r0, c, v0, V, blank, db);
      hop::fence_view_async();
      hop::bar_sync(1, WG_CONSUMERS);
      // dX[:, JH c, JH c + JH) += dl (64 x 64, K-major) W_tile^T (K-major rows JH c ..)
      hop::fence_regs(acc);
      hop::wg_fence();
      const uint32_t da = hop::saddr(dl);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hop::wgmma<JH, 0, 0>(acc, hop::desc(da + k * 32), hop::desc(wa + c * JH * 128 + k * 32),
                             1);
      hop::wg_commit();
      hop::wg_wait0();
      hop::fence_regs(acc);
      hop::mbar_arrive(&empty[st]);
    }
    // dpre = dX (1 - x^2)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, m = m0 + r;
      if (m >= M) continue;
#pragma unroll
      for (int i = 0; i < JH / 8; ++i) {
        const int j = JH * c + 8 * i + 2 * (lane & 3);
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            xs + (j >> 6) * ATOM + hop::swz(r, j & 63)));
        *reinterpret_cast<float2*>(dpre + (size_t)m * J + j) =
            make_float2(acc[4 * i + 2 * h] * (1.f - x.x * x.x),
                        acc[4 * i + 2 * h + 1] * (1.f - x.y * x.y));
      }
    }
  }
}

// dW / dbias: block = (V tile, chunk of rows); part [n_chunks][J][Vp],
// dbpart [n_chunks][Vp] float32
template <int NJ>
__global__ void __launch_bounds__(WG_THREADS, 1)
joint_bwd_w_wg_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap xmap, const float* __restrict__ bias,
                      const int* __restrict__ lab, const float* __restrict__ logz,
                      const float* __restrict__ gb, const float* __restrict__ ge,
                      float* __restrict__ part, float* __restrict__ dbpart, int M, int Tn,
                      int U1, int V, int Vp, int blank, int rows_per_chunk) {
  constexpr int J = 128 * NJ, JH = J / 2;   // dW rows of each consumer warpgroup
  constexpr uint32_t TILE = J * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* ws = smem;                 // W tile [J][64], resident
  unsigned char* xs = ws + TILE;            // x ring [2][64][J]: J / 64 atoms each
  unsigned char* dls = xs + 2 * TILE;       // dl [2][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + 2 * ATOM);
  uint64_t* empty = full + 2;
  uint64_t* wbar = empty + 2;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int v0 = blockIdx.x * 64, chunk = blockIdx.y;
  const int begin = chunk * rows_per_chunk, end = min(M, begin + rows_per_chunk);
  const int ntile = end > begin ? (end - begin + 63) / 64 : 0;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], WG_CONSUMERS);
    }
    hop::mbar_init(wbar, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hop::setmaxnreg_dec<WG_REG_PRODUCER>();
    if (tid == 0) {
      hop::mbar_expect(wbar, TILE);
      hop::tma_load(ws, &wmap, wbar, v0, 0);
      hop::tma_load(ws + JH * 128, &wmap, wbar, v0, JH);
      for (int s = 0; s < ntile; ++s) {
        const int st = s & 1;
        hop::mbar_wait(&empty[st], ((s >> 1) & 1) ^ 1);
        hop::mbar_expect(&full[st], TILE);
        unsigned char* dst = xs + st * TILE;
#pragma unroll
        for (int a = 0; a < J / 64; ++a)
          hop::tma_load(dst + a * ATOM, &xmap, &full[st], 64 * a, begin + 64 * s);
      }
    }
  } else {
    hop::setmaxnreg_inc<WG_REG_CONSUMER>();
    const int c = wg - 1;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int r0 = 16 * warp + (lane >> 2);
    float bv[8], db[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = v0 + 32 * c + 8 * i + 2 * (lane & 3) + e;
        bv[2 * i + e] = v < V ? bias[v] : 0.f;
        db[2 * i + e] = 0.f;
      }
    float acc[NJ][32];   // dW rows JH c + 64 mb + ..., the V tile's 64 columns
#pragma unroll
    for (int mb = 0; mb < NJ; ++mb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
    const uint32_t wa = hop::saddr(ws);
    hop::mbar_wait(wbar, 0);
    for (int s = 0; s < ntile; ++s) {
      const int st = s & 1, m0 = begin + 64 * s;
      RowC rc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) rc[h] = row_consts(logz, gb, ge, lab, m0 + r0 + 8 * h, end, Tn, U1);
      hop::mbar_wait(&full[st], (s >> 1) & 1);
      const uint32_t xa = hop::saddr(xs + st * TILE);
      float sl[16] = {};
      logits_half<J>(sl, xa, wa, c);
      unsigned char* dl = dls + st * ATOM;
      dl_half<true>(sl, dl, rc, bv, r0, c, v0, V, blank, db);
      hop::fence_view_async();
      hop::bar_sync(1, WG_CONSUMERS);
      // dW[JH c + 64 mb .., :] += x^T (MN-major: x's atom, rows as K) dl (MN-major)
      const uint32_t da = hop::saddr(dl);
#pragma unroll
      for (int mb = 0; mb < NJ; ++mb) hop::fence_regs(acc[mb]);
      hop::wg_fence();
#pragma unroll
      for (int mb = 0; mb < NJ; ++mb)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          hop::wgmma<64, 1, 1>(acc[mb], hop::desc(xa + (c * NJ + mb) * ATOM + k * 2048),
                               hop::desc(da + k * 2048), 1);
      hop::wg_commit();
      hop::wg_wait0();
#pragma unroll
      for (int mb = 0; mb < NJ; ++mb) hop::fence_regs(acc[mb]);
      hop::mbar_arrive(&empty[st]);
    }
    float* pc = part + (size_t)chunk * J * Vp;
#pragma unroll
    for (int mb = 0; mb < NJ; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = JH * c + 64 * mb + r0 + 8 * h;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float2*>(pc + (size_t)j * Vp + v0 + 8 * i + 2 * (lane & 3)) =
              make_float2(acc[mb][4 * i + 2 * h], acc[mb][4 * i + 2 * h + 1]);
      }
    // dbias: the column sums over the 8 rows of the lanes that share l % 4,
    // then over the four warps in order, through the (now idle) dl tiles
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) db[i] += __shfl_xor_sync(0xffffffffu, db[i], o);
    hop::bar_sync(1, WG_CONSUMERS);
    float* red = reinterpret_cast<float*>(dls);   // [2 warpgroups][4 warps][32 columns]
    if (lane < 4)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) red[(c * 4 + warp) * 32 + 8 * i + 2 * lane + e] = db[2 * i + e];
    hop::bar_sync(1, WG_CONSUMERS);
    const int ct = tid - 128;
    if (ct < 64) {
      const int cc = ct >> 5, col = ct & 31;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += red[(cc * 4 + w) * 32 + col];
      dbpart[(size_t)chunk * Vp + v0 + 32 * cc + col] = sum;
    }
  }
}

// ------------------------------------------------ bf16 forward on wgmma
//
// One block = 128 cells and 3 warpgroups: warpgroup 0 the producer (one
// thread issues the TMA copies of W), warpgroups 1 and 2 the consumers,
// each with its own 64-row x tile. Stage g of the ring holds rows
// [64 k, 64 k + 64) of W's V tile t (g = t J / 64 + k) as two swizzled
// 64 x 64 atoms (columns 0-63, then 64-127); its empty barrier counts the
// threads of both consumers.

constexpr int FWD_VT = 128;                 // V columns per tile
constexpr uint32_t FWD_STAGE = 2 * ATOM;    // bytes of one ring stage
constexpr int FWD_SMEM = 229376;            // x tiles and ring, at most (224 KB)

__host__ __device__ constexpr int fwd_stages(int J) {
  return (FWD_SMEM - 2 * J * 128) / (int)FWD_STAGE > 8 ? 8
                                                        : (FWD_SMEM - 2 * J * 128) / (int)FWD_STAGE;
}
__host__ __device__ constexpr size_t fwd_smem(int J) {
  return 2 * (size_t)J * 128 + (size_t)fwd_stages(J) * FWD_STAGE + 2 * 8 * 8 + 1024;
}

// the logit of relative column `col` (< FWD_VT) of row half h, if this
// thread holds it (lanes with l % 4 == (col % 8) / 2), else 0
__device__ __forceinline__ float fwd_pick(const float (&acc)[64], int col, int h) {
  const int lane = threadIdx.x & 31;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (8 * i + 2 * (lane & 3) + e == col) v = acc[4 * i + 2 * h + e];
  return v;
}

// lp_blank, lp_emit, logZ of the block's 128 cells
template <int NJ, typename TP>
__global__ void __launch_bounds__(WG_THREADS, 1)
joint_fwd_wg_kernel(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ enc,
                    const TP* __restrict__ pred, const float* __restrict__ bias,
                    const int* __restrict__ lab, float* __restrict__ lpb,
                    float* __restrict__ lpe, float* __restrict__ logz, int M, int Tn, int U1,
                    int V, int Vp, int blank) {
  constexpr int J = 128 * NJ, KCH = J / 64, S = fwd_stages(J);
  constexpr uint32_t XT = J * 128;          // bytes of a 64-row x tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop::align1024(smem_raw);
  unsigned char* xs = smem;                 // x [2][64][J]: J / 64 atoms each
  unsigned char* ring = xs + 2 * XT;        // W stages [S][64][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * FWD_STAGE);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x, wg = tid >> 7, nvt = Vp / FWD_VT;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], WG_CONSUMERS);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hop::setmaxnreg_dec<WG_REG_PRODUCER>();
    if (tid == 0) {
      int g = 0;
      for (int t = 0; t < nvt; ++t)
        for (int k = 0; k < KCH; ++k, ++g) {
          const int st = g % S;
          hop::mbar_wait(&empty[st], ((g / S) & 1) ^ 1);
          hop::mbar_expect(&full[st], FWD_STAGE);
          unsigned char* stage = ring + st * FWD_STAGE;
          hop::tma_load(stage, &wmap, &full[st], t * FWD_VT, 64 * k);
          hop::tma_load(stage + ATOM, &wmap, &full[st], t * FWD_VT + 64, 64 * k);
        }
    }
  } else {
    hop::setmaxnreg_inc<WG_REG_CONSUMER>();
    const int c = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    const int r0 = 16 * warp + (lane >> 2);
    const int m0 = blockIdx.x * 128 + 64 * c;
    unsigned char* xt = xs + c * XT;
    // x = tanh(enc + pred) of this consumer's 64 rows into its swizzled atoms
    for (int r = warp; r < 64; r += 4) {
      const int m = m0 + r;
      int bt = 0, u = 0, b = 0;
      if (m < M) {
        bt = m / U1;
        u = m - bt * U1;
        b = bt / Tn;
      }
#pragma unroll
      for (int a = 0; a < KCH; ++a) {
        const int j = 64 * a + 2 * lane;
        float x0 = 0.f, x1 = 0.f;
        if (m < M) {
          const bf16* e = enc + (size_t)bt * J + j;
          const TP* p = pred + ((size_t)b * U1 + u) * J + j;
          x0 = to_f(joint_x<bf16, TP>(e[0], p[0]));
          x1 = to_f(joint_x<bf16, TP>(e[1], p[1]));
        }
        *reinterpret_cast<__nv_bfloat162*>(xt + a * ATOM + hop::swz(r, 2 * lane)) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
    int lb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
      lb[h] = m < M ? cell_label(lab, m, Tn, U1) : -1;
    }
    hop::fence_view_async();
    hop::bar_sync(1 + c, 128);

    const uint32_t xa = hop::saddr(xt);
    float acc[64];
    float rm[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f}, bl[2] = {0.f, 0.f},
          em[2] = {0.f, 0.f};
    int g = 0, prev = 0;
    for (int t = 0; t < nvt; ++t) {
      const int v0 = t * FWD_VT;
      float bv[32];   // bias of this thread's columns 8 i + 2 (l % 4) + e; -inf past V
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + 8 * i + 2 * (lane & 3) + e;
          bv[2 * i + e] = v < V ? bias[v] : -INFINITY;
        }
      hop::fence_regs(acc);
      hop::wg_fence();
#pragma unroll
      for (int k = 0; k < KCH; ++k, ++g) {
        const int st = g % S;
        hop::mbar_wait(&full[st], (g / S) & 1);
        const uint32_t wa = hop::saddr(ring + st * FWD_STAGE);
        if (k > 0) hop::wg_fence();
        // 16 rows of the stage a step: one m64n128k16 over both atoms, the
        // second one ATOM bytes on (the leading-byte offset)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma<128, 0, 1>(acc, hop::desc(xa + k * ATOM + kk * 32),
                                hop::desc_mn(wa + kk * 2048, ATOM), k + kk > 0);
        hop::wg_commit();
        if (k > 0) {
          hop::wg_wait<1>();
          hop::mbar_arrive(&empty[prev]);
        }
        prev = st;
      }
      hop::wg_wait0();
      hop::fence_regs(acc);
      hop::mbar_arrive(&empty[prev]);

      // epilogue on the accumulators: logits = acc + bias, then per row
      // half h (rows r0 and r0 + 8) the online max and rescaled sum
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[4 * i + x] += bv[2 * i + (x & 1)];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = -INFINITY;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          tmax = fmaxf(tmax, fmaxf(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]));
        const float mn = fmaxf(rm[h], tmax);
        if (mn != -INFINITY) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            s += __expf(acc[4 * i + 2 * h] - mn) + __expf(acc[4 * i + 2 * h + 1] - mn);
          rs[h] = rs[h] * __expf(rm[h] - mn) + s;
          rm[h] = mn;
        }
        if (blank >= v0 && blank < v0 + FWD_VT) bl[h] = fwd_pick(acc, blank - v0, h);
        if (lb[h] >= v0 && lb[h] < v0 + FWD_VT && lb[h] < V) em[h] = fwd_pick(acc, lb[h] - v0, h);
      }
    }
    // combine the four lanes of each row (l % 4), in a fixed order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mh = rm[h], sh = rs[h], bh = bl[h], eh = em[h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mh, off);
        const float os = __shfl_xor_sync(0xffffffffu, sh, off);
        const float mn = fmaxf(mh, om);
        sh = mn == -INFINITY ? 0.f : sh * __expf(mh - mn) + os * __expf(om - mn);
        mh = mn;
        bh += __shfl_xor_sync(0xffffffffu, bh, off);   // one lane of the four holds each pick
        eh += __shfl_xor_sync(0xffffffffu, eh, off);
      }
      const int m = m0 + r0 + 8 * h;
      if ((lane & 3) == 0 && m < M) {
        const float lz = mh + logf(sh);
        lpb[m] = bh - lz;
        lpe[m] = eh - lz;
        logz[m] = lz;
      }
    }
  }
}

// ------------------------------------------------ wide route
//
// float32 at every J and bf16 above the narrow kernels' widths. The
// forward runs one product per chunk of cells: the logits product S = x W
// with the logsumexp epilogue (LseEpi: per (V tile, cell) the max and the
// sum of exps about it, and the picks), then one grid folds each cell's
// tiles into logZ. Each backward entry runs two products per chunk of
// cells, with dl between them in device memory:
//  - the logits product S = x W (once per cell at every J), whose epilogue
//    turns S into dl on the accumulators (bias, exp, picks, g) and writes
//    dl once, in the layout and precision of the second product's operand;
//  - the second product: dX = dl W^T (bwd_xp; its epilogue writes
//    dpre = dX (1 - x^2)) or dW = x^T dl (bwd_w; its epilogue adds the
//    chunk's partial dW).
// Every product is one kernel, joint_gemm_kernel: C [rows x cols] = A [rows x K]
// B [cols x K]^T, both operands K-major (tf32 wgmma takes no other), a
// block one 128 x BN tile of C: a producer warpgroup whose one thread keeps
// a ring of K slabs (128 bytes of K: 64 bf16 or 32 float32 values) in
// flight by TMA, and two consumer warpgroups of 64 rows that release each
// stage on an mbarrier once the products that read it are done, one group
// of products in flight. bf16: m64nBNk16, one copy of each operand.
// float32: 3xTF32, each operand as tf32 hi and lo copies (cvt.rna), and
// hi*hi + hi*lo + lo*hi (m64n128k8) summed on the tensor cores over 128 K
// values at a time, each such partial then added to the float32
// accumulators: the tensor cores' accumulation truncates, and summed there
// over all of K (Vp ~ 5000 in dl W^T) its bias put bwd_xp 5.9e-4 from the
// plain float32 version on an H100 (3.3e-5 promoted). The operands'
// layouts: x [cells][J] and W^T [Vp][J] for the logits; dl [cells][Vp] and
// W [J][Vp] for dX; x^T [J][cells] and dl^T [Vp][cells] for dW.
// joint_tile_kernel writes W^T (and, float32, W's hi / lo) once per call
// and x (and x^T) per chunk, rounded or split as the products read them.

constexpr int GM_BM = 128;               // rows of C a block computes
constexpr int GM_RING = 196608;          // bytes of the ring, at most (192 KB)
constexpr int GM_PROMOTE = 4;            // float32: slabs (32 K values each) per promotion

template <bool kTf32, int BN> struct Gemm {
  static constexpr int KS = kTf32 ? 32 : 64;                  // K values of a slab
  static constexpr uint32_t A_BYTES = GM_BM * 128, B_BYTES = BN * 128;
  static constexpr uint32_t COPY = A_BYTES + B_BYTES;         // one copy of a slab
  static constexpr uint32_t STAGE = (kTf32 ? 2 : 1) * COPY;   // float32: hi, then lo
  static constexpr int STAGES = GM_RING / STAGE > 6 ? 6 : GM_RING / STAGE;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * 8 * STAGES + 1024;
};

// v as element idx in T, or, split, as tf32 hi at out[idx] and lo at
// out[lo + idx]
template <typename T, bool kSplit>
__device__ __forceinline__ void put_val(T* out, size_t idx, size_t lo, float v) {
  if constexpr (kSplit) {
    float h, l;
    hopper::split_tf32(v, &h, &l);
    out[idx] = h;
    out[lo + idx] = l;
  } else {
    out[idx] = from_f<T>(v);
  }
}
// (v0, v1) as elements idx and idx + 1, as put_val
template <typename T, bool kSplit>
__device__ __forceinline__ void put_pair(T* out, size_t idx, size_t lo, float v0, float v1) {
  if constexpr (kSplit) {
    float2 h, l;
    hopper::split_tf32(v0, &h.x, &l.x);
    hopper::split_tf32(v1, &h.y, &l.y);
    *reinterpret_cast<float2*>(out + idx) = h;
    *reinterpret_cast<float2*>(out + lo + idx) = l;
  } else if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<__nv_bfloat162*>(out + idx) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
  }
}

// W's element (j, v)
template <typename T> struct WSrc {
  const T* w;
  int Vp;
  __device__ float operator()(int j, int v) const { return to_f(w[(size_t)j * Vp + v]); }
};
// x's element (cell row0 + r, j), rounded to T
template <typename T, typename TP> struct XSrc {
  const T* enc;
  const TP* pred;
  int row0, Tn, U1, J;
  __device__ float operator()(int r, int j) const {
    const int m = row0 + r, bt = m / U1, u = m - bt * U1, b = bt / Tn;
    return to_f(joint_x<T, TP>(enc[(size_t)bt * J + j], pred[((size_t)b * U1 + u) * J + j]));
  }
};

// src [R x C] into out [R][ld] and / or out_t [C][ld_t] (either may be
// null), in T or split (the lo copies lo / lo_t elements on); 32 x 32
// tiles, the transpose through shared memory
template <typename T, bool kSplit, class Src>
__global__ void __launch_bounds__(256)
joint_tile_kernel(Src src, T* __restrict__ out, T* __restrict__ out_t, size_t lo, size_t lo_t,
                  int R, int C, int ld, int ld_t) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int k = ty; k < 32; k += 8) {
    const int r = r0 + k, c = c0 + tx;
    float v = 0.f;
    if (r < R && c < C) {
      v = src(r, c);
      if (out != nullptr) put_val<T, kSplit>(out, (size_t)r * ld + c, lo, v);
    }
    tile[k][tx] = v;
  }
  if (out_t == nullptr) return;
  __syncthreads();
  for (int k = ty; k < 32; k += 8) {
    const int c = c0 + k, r = r0 + tx;
    if (r < R && c < C) put_val<T, kSplit>(out_t, (size_t)c * ld_t + r, lo_t, tile[tx][k]);
  }
}

// C = A B^T over K [k0, k0 + k_split) (k0 = blockIdx.z k_split) for the
// tile of rows blockIdx.y * 128, columns blockIdx.x * BN; then epi(acc,
// first row of the warpgroup's 64, first column, the freed ring)
template <bool kTf32, int BN, class Epi>
__global__ void __launch_bounds__(WG_THREADS, 1)
joint_gemm_kernel(const __grid_constant__ CUtensorMap a_hi, const __grid_constant__ CUtensorMap a_lo,
                  const __grid_constant__ CUtensorMap b_hi, const __grid_constant__ CUtensorMap b_lo,
                  int k_len, int k_split, Epi epi) {
  using G = Gemm<kTf32, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE);
  uint64_t* empty = full + G::STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * GM_BM;
  const int k0 = blockIdx.z * k_split, k1 = min(k_len, k0 + k_split);
  const int ns = k1 > k0 ? (k1 - k0 + G::KS - 1) / G::KS : 0;
  if (tid == 0) {
    for (int i = 0; i < G::STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], WG_CONSUMERS);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    hop::setmaxnreg_dec<WG_REG_PRODUCER>();
    if (tid == 0) {
      for (int s = 0; s < ns; ++s) {
        const int st = s % G::STAGES, kc = k0 + s * G::KS;
        hop::mbar_wait(&empty[st], ((s / G::STAGES) & 1) ^ 1);
        hop::mbar_expect(&full[st], G::STAGE);
        unsigned char* d = ring + st * G::STAGE;
        hop::tma_load(d, &a_hi, &full[st], kc, m0);
        hop::tma_load(d + G::A_BYTES, &b_hi, &full[st], kc, n0);
        if constexpr (kTf32) {
          hop::tma_load(d + G::COPY, &a_lo, &full[st], kc, m0);
          hop::tma_load(d + G::COPY + G::A_BYTES, &b_lo, &full[st], kc, n0);
        }
      }
    }
  } else {
    hop::setmaxnreg_inc<WG_REG_CONSUMER>();
    const int c = wg - 1;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    if constexpr (kTf32) {
      // 3xTF32 (hi*hi + hi*lo + lo*hi) into `part`, which the first product
      // of every GM_PROMOTE slabs overwrites; part is then added into acc
      // with float32 adds, so that the tensor cores' truncating
      // accumulation never runs over more than 128 K values
      float part[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
      int pending = -1;   // the ring stage of the one group still in flight
      for (int s = 0; s < ns; ++s) {
        const int st = s % G::STAGES;
        hop::mbar_wait(&full[st], (s / G::STAGES) & 1);
        const uint32_t a = hop::saddr(ring + st * G::STAGE) + c * 8192;
        const uint32_t b = hop::saddr(ring + st * G::STAGE) + G::A_BYTES;
        const int fresh = s % GM_PROMOTE == 0;
        hop::fence_regs(part);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::wgmma_tf32_n128(part, hop::desc(a + kk * 32), hop::desc(b + kk * 32),
                                  !(fresh && kk == 0));
          hopper::wgmma_tf32_n128(part, hop::desc(a + kk * 32),
                                  hop::desc(b + G::COPY + kk * 32), 1);
          hopper::wgmma_tf32_n128(part, hop::desc(a + G::COPY + kk * 32),
                                  hop::desc(b + kk * 32), 1);
        }
        hop::wg_commit();
        if (s % GM_PROMOTE == GM_PROMOTE - 1 || s == ns - 1) {
          hop::wg_wait0();
          if (pending >= 0) hop::mbar_arrive(&empty[pending]);
          hop::mbar_arrive(&empty[st]);
          pending = -1;
          hop::fence_regs(part);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
        } else {
          if (pending >= 0) {
            hop::wg_wait<1>();
            hop::mbar_arrive(&empty[pending]);
          }
          pending = st;
        }
      }
    } else {
      int prev = 0;
      for (int s = 0; s < ns; ++s) {
        const int st = s % G::STAGES;
        hop::mbar_wait(&full[st], (s / G::STAGES) & 1);
        const uint32_t a = hop::saddr(ring + st * G::STAGE) + c * 8192;
        const uint32_t b = hop::saddr(ring + st * G::STAGE) + G::A_BYTES;
        hop::fence_regs(acc);
        hop::wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hop::wgmma<BN, 0, 0>(acc, hop::desc(a + kk * 32), hop::desc(b + kk * 32), 1);
        hop::wg_commit();
        if (s > 0) {
          hop::wg_wait<1>();
          hop::mbar_arrive(&empty[prev]);
        }
        prev = st;
      }
      hop::wg_wait0();
    }
    hop::fence_regs(acc);
    // both consumers' products are done: the ring is free for the epilogue
    hop::bar_sync(1, WG_CONSUMERS);
    epi(acc, m0 + 64 * c, n0, ring);
  }
}

// In the epilogues this thread's accumulator element acc[4 i + 2 h + e] is
// row r0 + 8 h of the warpgroup's 64 (r0 = 16 warp + lane / 4) and column
// 8 i + 2 (lane % 4) + e of the tile.

// The logits epilogue: dl of cells row0 + m (m < rows) and columns v, in T
// (or tf32 hi / lo) at dl[m][v] (ld = Vp) or, kTrans, dl[v][m] (ld = the
// chunk's rows); kTrans also writes the tile's column sums of dl (float32,
// before rounding) into dbpart[blockIdx.y][v]
template <typename T, bool kSplit, bool kTrans> struct DlEpi {
  const float* bias;
  const int* lab;
  const float* logz;
  const float* gb;
  const float* ge;
  T* dl;
  float* dbpart;
  size_t lo;
  int row0, rows, ld, Tn, U1, V, Vp, blank;

  template <int NA>
  __device__ void operator()(float (&acc)[NA], int m, int n0, unsigned char* smem) const {
    constexpr int N = 2 * NA;   // the tile's columns
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, q = lane & 3;
    const int r0 = 16 * warp + (lane >> 2);
    RowC rc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rc[h] = row_consts(logz, gb, ge, lab, row0 + m + r0 + 8 * h, row0 + rows, Tn, U1);
    float* red = reinterpret_cast<float*>(smem);   // kTrans: [8 warps][N columns]
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int v = n0 + 8 * i + 2 * q;
      float d[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = v + e < V;
        const float bv = live ? bias[v + e] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const RowC& k = rc[h];
          float x = 0.f;
          if (live) {
            const float p = __expf(acc[4 * i + 2 * h + e] + bv - k.lz);
            x = -(k.gb + k.ge) * p + (v + e == blank ? k.gb : 0.f) + (v + e == k.lb ? k.ge : 0.f);
          }
          d[h][e] = x;
        }
      }
      if (v < Vp) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m + r0 + 8 * h;
          if (r >= rows) continue;
          if constexpr (kTrans) {
            put_val<T, kSplit>(dl, (size_t)v * ld + r, lo, d[h][0]);
            put_val<T, kSplit>(dl, (size_t)(v + 1) * ld + r, lo, d[h][1]);
          } else {
            put_pair<T, kSplit>(dl, (size_t)r * ld + v, lo, d[h][0], d[h][1]);
          }
        }
      }
      if constexpr (kTrans) {
        // the column sums of the warp's 16 rows: over h, then over the 8
        // lanes that share lane % 4
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float cs = d[0][e] + d[1][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) cs += __shfl_xor_sync(0xffffffffu, cs, o);
          if (lane < 4) red[(threadIdx.x / 32 - 4) * N + 8 * i + 2 * q + e] = cs;
        }
      }
    }
    if constexpr (kTrans) {
      // the 8 warps' sums in order (warps 4-7: consumer 0's rows, 8-11: consumer 1's)
      hop::bar_sync(1, WG_CONSUMERS);
      const int col = threadIdx.x - 128;
      if (col < N && n0 + col < Vp) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += red[w * N + col];
        dbpart[(size_t)blockIdx.y * Vp + n0 + col] = sum;
      }
    }
  }
};

// bwd_xp's second epilogue: dpre[row0 + m][j] = dX (1 - x^2), x from the
// chunk's x buffer [rows][J] (float32: hi + lo)
template <typename T, bool kSplit> struct DpreEpi {
  const T* x;
  float* dpre;
  size_t lo;
  int row0, rows, J;

  template <int NA>
  __device__ void operator()(float (&acc)[NA], int m, int n0, unsigned char*) const {
    constexpr int N = 2 * NA;   // the tile's columns
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, q = lane & 3;
    const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m + r0 + 8 * h;
      if (r >= rows) continue;
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const int j = n0 + 8 * i + 2 * q;
        const size_t idx = (size_t)r * J + j;
        float2 xv;
        if constexpr (kSplit) {
          const float2 hi = *reinterpret_cast<const float2*>(x + idx);
          const float2 lw = *reinterpret_cast<const float2*>(x + lo + idx);
          xv = make_float2(hi.x + lw.x, hi.y + lw.y);
        } else {
          xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + idx));
        }
        *reinterpret_cast<float2*>(dpre + (size_t)(row0 + r) * J + j) =
            make_float2(acc[4 * i + 2 * h] * (1.f - xv.x * xv.x),
                        acc[4 * i + 2 * h + 1] * (1.f - xv.y * xv.y));
      }
    }
  }
};

// bwd_w's second epilogue: part[blockIdx.z][j][v] (+)= the chunk's partial dW
struct PartEpi {
  float* part;
  int J, Vp, accumulate;

  template <int NA>
  __device__ void operator()(float (&acc)[NA], int m, int n0, unsigned char*) const {
    constexpr int N = 2 * NA;   // the tile's columns
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, q = lane & 3;
    const int r0 = 16 * warp + (lane >> 2);
    float* pz = part + (size_t)blockIdx.z * J * Vp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = m + r0 + 8 * h;
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const int v = n0 + 8 * i + 2 * q;
        if (v >= Vp) continue;
        float2* p = reinterpret_cast<float2*>(pz + (size_t)j * Vp + v);
        float2 val = make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        if (accumulate) {
          const float2 old = *p;
          val = make_float2(old.x + val.x, old.y + val.y);
        }
        *p = val;
      }
    }
  }
};

// The forward's epilogue: per cell row0 + m (m < rows) of the tile, the max
// of its logits (bias added; columns at or past V -inf) and the sum of
// their exps about that max into pmax / psum [n_tiles][M] at (V tile
// blockIdx.x, cell); the tile that holds the blank or the cell's label (in
// [0, V)) writes that logit into lpb / lpe, from which the combine grid
// subtracts logZ
struct LseEpi {
  const float* bias;
  const int* lab;
  float* pmax;
  float* psum;
  float* lpb;
  float* lpe;
  int row0, rows, M, Tn, U1, V, blank;

  template <int NA>
  __device__ void operator()(float (&acc)[NA], int m, int n0, unsigned char*) const {
    constexpr int N = 2 * NA;   // the tile's columns
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, q = lane & 3;
    const int r0 = 16 * warp + (lane >> 2);
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = n0 + 8 * i + 2 * q + e;
        const float bv = v < V ? bias[v] : -INFINITY;
        acc[4 * i + e] += bv;
        acc[4 * i + 2 + e] += bv;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the row's max over the four lanes that hold it, then each lane's
      // sum of exps about it, summed over the four
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
        mx = fmaxf(mx, fmaxf(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float s = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int i = 0; i < N / 8; ++i)
          s += __expf(acc[4 * i + 2 * h] - mx) + __expf(acc[4 * i + 2 * h + 1] - mx);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int r = m + r0 + 8 * h;
      if (r >= rows) continue;
      const int cell = row0 + r;
      if (q == 0) {
        pmax[(size_t)blockIdx.x * M + cell] = mx;
        psum[(size_t)blockIdx.x * M + cell] = s;
      }
      const int lb = cell_label(lab, cell, Tn, U1);
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = n0 + 8 * i + 2 * q + e;
          if (v == blank) lpb[cell] = acc[4 * i + 2 * h + e];
          if (v == lb && v < V) lpe[cell] = acc[4 * i + 2 * h + e];
        }
    }
  }
};

// the forward's last grid, one thread a cell: logZ from the cell's n_tiles
// (max, sum) pairs, folded in tile order; lp_blank and lp_emit from the
// picks in lpb / lpe (0 - logZ for a label outside [0, V))
__global__ void joint_lse_combine_kernel(const float* __restrict__ pmax,
                                         const float* __restrict__ psum,
                                         const int* __restrict__ lab, float* __restrict__ lpb,
                                         float* __restrict__ lpe, float* __restrict__ logz, int M,
                                         int n_tiles, int Tn, int U1, int V) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float mx = -INFINITY;
  for (int k = 0; k < n_tiles; ++k) mx = fmaxf(mx, pmax[(size_t)k * M + m]);
  float s = 0.f;
  for (int k = 0; k < n_tiles; ++k)
    s += psum[(size_t)k * M + m] * __expf(pmax[(size_t)k * M + m] - mx);
  const float lz = mx + logf(s);
  const int lb = cell_label(lab, m, Tn, U1);
  logz[m] = lz;
  lpb[m] -= lz;
  lpe[m] = (lb >= 0 && lb < V ? lpe[m] : 0.f) - lz;
}

// ------------------------------------------------ host side of the wgmma kernels

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no -lcuda
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// map of a row-major matrix [rows][cols] of `elem`-byte elements, rows `ld`
// elements apart, boxes of 128 bytes x box_rows rows, 128-byte swizzle;
// rows and columns past the ends read as zero
cudaError_t mat_map(CUtensorMap* map, CUtensorMapDataType type, uint32_t elem, const void* ptr,
                    uint64_t rows, uint64_t cols, uint64_t ld, uint32_t box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {ld * elem};
  cuuint32_t box[2] = {128 / elem, box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a row-major bf16 matrix [rows][cols] in boxes of 64 columns x box_rows rows
cudaError_t bf16_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                     uint32_t box_rows) {
  return mat_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), ptr, rows, cols, cols,
                 box_rows);
}

template <int NJ, typename TP>
cudaError_t launch_bwd_xp_wg(const void* enc, const void* pred, const void* w, const void* bias,
                             const void* lab, const void* logz, const void* gb, const void* ge,
                             void* dpre, cudaStream_t st, int M, int Tn, int U1, int V, int Vp,
                             int blank) {
  constexpr int J = 128 * NJ;
  CUtensorMap wmap;
  cudaError_t e = bf16_map(&wmap, w, J, Vp, J / 2);
  if (e != cudaSuccess) return e;
  const size_t smem = wg_smem(J);
  e = set_smem(joint_bwd_xp_wg_kernel<NJ, TP>, smem);
  if (e != cudaSuccess) return e;
  joint_bwd_xp_wg_kernel<NJ, TP><<<(M + 63) / 64, WG_THREADS, smem, st>>>(
      wmap, static_cast<const bf16*>(enc), static_cast<const TP*>(pred),
      static_cast<const float*>(bias), static_cast<const int*>(lab),
      static_cast<const float*>(logz), static_cast<const float*>(gb),
      static_cast<const float*>(ge), static_cast<float*>(dpre), M, Tn, U1, V, Vp, blank);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_bwd_w_wg(const void* xbuf, const void* w, const void* bias, const void* lab,
                            const void* logz, const void* gb, const void* ge, void* part,
                            void* dbpart, cudaStream_t st, int M, int Tn, int U1, int V, int Vp,
                            int blank, int n_chunks, int rows_per_chunk) {
  constexpr int J = 128 * NJ;
  CUtensorMap wmap, xmap;
  cudaError_t e = bf16_map(&wmap, w, J, Vp, J / 2);
  if (e == cudaSuccess) e = bf16_map(&xmap, xbuf, M, J, 64);
  if (e != cudaSuccess) return e;
  const size_t smem = wg_smem(J);
  e = set_smem(joint_bwd_w_wg_kernel<NJ>, smem);
  if (e != cudaSuccess) return e;
  joint_bwd_w_wg_kernel<NJ><<<dim3(Vp / 64, n_chunks), WG_THREADS, smem, st>>>(
      wmap, xmap, static_cast<const float*>(bias), static_cast<const int*>(lab),
      static_cast<const float*>(logz), static_cast<const float*>(gb),
      static_cast<const float*>(ge), static_cast<float*>(part), static_cast<float*>(dbpart), M,
      Tn, U1, V, Vp, blank, rows_per_chunk);
  return cudaGetLastError();
}

template <int NJ, typename TP>
cudaError_t launch_fwd_wg(const void* enc, const void* pred, const void* w, const void* bias,
                          const void* lab, void* lpb, void* lpe, void* logz, cudaStream_t st,
                          int M, int Tn, int U1, int V, int Vp, int blank) {
  constexpr int J = 128 * NJ;
  CUtensorMap wmap;
  cudaError_t e = bf16_map(&wmap, w, J, Vp, 64);
  if (e != cudaSuccess) return e;
  const size_t smem = fwd_smem(J);
  e = set_smem(joint_fwd_wg_kernel<NJ, TP>, smem);
  if (e != cudaSuccess) return e;
  joint_fwd_wg_kernel<NJ, TP><<<(M + 127) / 128, WG_THREADS, smem, st>>>(
      wmap, static_cast<const bf16*>(enc), static_cast<const TP*>(pred),
      static_cast<const float*>(bias), static_cast<const int*>(lab), static_cast<float*>(lpb),
      static_cast<float*>(lpe), static_cast<float*>(logz), M, Tn, U1, V, Vp, blank);
  return cudaGetLastError();
}

// ------------------------------------------------ host side of the wide backward

// an operand of joint_gemm_kernel: a row-major [rows][K] matrix of T, rows
// `ld` elements apart; float32: the tf32 lo copy `lo` elements on
struct Operand {
  const void* p;
  size_t lo;
  uint64_t rows, ld;
};

template <typename T, int BN, class Epi>
cudaError_t launch_gemm(const Operand& a, const Operand& b, int k_len, int n_split, Epi epi,
                        cudaStream_t st) {
  constexpr bool kTf32 = std::is_same<T, float>::value;
  static_assert(!kTf32 || BN == 128, "the tf32 product is m64n128k8");
  using G = Gemm<kTf32, BN>;
  const CUtensorMapDataType dt =
      kTf32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap maps[4];
  const T* ap = static_cast<const T*>(a.p);
  const T* bp = static_cast<const T*>(b.p);
  cudaError_t e = mat_map(&maps[0], dt, sizeof(T), ap, a.rows, k_len, a.ld, GM_BM);
  if (e == cudaSuccess) e = mat_map(&maps[2], dt, sizeof(T), bp, b.rows, k_len, b.ld, BN);
  if (e == cudaSuccess && kTf32) e = mat_map(&maps[1], dt, sizeof(T), ap + a.lo, a.rows, k_len, a.ld, GM_BM);
  if (e == cudaSuccess && kTf32) e = mat_map(&maps[3], dt, sizeof(T), bp + b.lo, b.rows, k_len, b.ld, BN);
  if (e != cudaSuccess) return e;
  if (!kTf32) {
    maps[1] = maps[0];
    maps[3] = maps[2];
  }
  auto kernel = joint_gemm_kernel<kTf32, BN, Epi>;
  e = set_smem(kernel, G::SMEM);
  if (e != cudaSuccess) return e;
  const int k_split = ((k_len + n_split - 1) / n_split + G::KS - 1) / G::KS * G::KS;
  const dim3 grid(static_cast<unsigned>((b.rows + BN - 1) / BN),
                  static_cast<unsigned>((a.rows + GM_BM - 1) / GM_BM), n_split);
  kernel<<<grid, WG_THREADS, G::SMEM, st>>>(maps[0], maps[1], maps[2], maps[3], k_len, k_split,
                                            epi);
  return cudaGetLastError();
}

template <typename T, bool kSplit, class Src>
cudaError_t launch_tile(Src src, T* out, T* out_t, size_t lo, size_t lo_t, int R, int C, int ld,
                        int ld_t, cudaStream_t st) {
  joint_tile_kernel<T, kSplit, Src><<<dim3((C + 31) / 32, (R + 31) / 32), 256, 0, st>>>(
      src, out, out_t, lo, lo_t, R, C, ld, ld_t);
  return cudaGetLastError();
}

// W^T [Vp][J] (and, with wn, W [J][Vp]) in T, float32 as tf32 hi / lo
// (lo J Vp elements on)
template <typename T>
cudaError_t prep_w(const void* w, void* wt, void* wn, int J, int Vp, cudaStream_t st) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  const size_t lo = (size_t)J * Vp;
  return launch_tile<T, kSplit>(WSrc<T>{static_cast<const T*>(w), Vp}, static_cast<T*>(wn),
                                static_cast<T*>(wt), lo, lo, J, Vp, Vp, J, st);
}

// d enc / d pred on the wide route: per chunk of `chunk` cells x, the logits
// product with dl [rows][Vp], dX = dl W^T with dpre; then the sums over u
// and t. wt: W^T; wn: float32 W's hi / lo (bf16: W itself is the operand);
// xbuf [chunk][J], dlbuf [chunk][Vp] (float32: hi, then lo)
template <typename T, typename TP>
cudaError_t launch_bwd_xp_wide(const void* enc, const void* pred, const void* w,
                               const void* bias, const void* lab, const void* logz,
                               const void* gb, const void* ge, void* wt, void* wn, void* xbuf,
                               void* dlbuf, void* dpre, void* d_enc, void* d_pred, int* launched,
                               cudaStream_t st, int B, int Tn, int U1, int J, int V, int Vp,
                               int blank, int chunk) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int M = B * Tn * U1;
  const size_t wlo = (size_t)J * Vp, xlo = (size_t)chunk * J, dlo = (size_t)chunk * Vp;
  cudaError_t e = prep_w<T>(w, wt, kF32 ? wn : nullptr, J, Vp, st);
  if (e != cudaSuccess) return e;
  ++*launched;
  const Operand wt_op{wt, wlo, (uint64_t)Vp, (uint64_t)J};
  const Operand w_op{kF32 ? wn : w, wlo, (uint64_t)J, (uint64_t)Vp};
  for (int row0 = 0; row0 < M; row0 += chunk) {
    const int rows = min(chunk, M - row0);
    T* x = static_cast<T*>(xbuf);
    T* dl = static_cast<T*>(dlbuf);
    e = launch_tile<T, kF32>(XSrc<T, TP>{static_cast<const T*>(enc), static_cast<const TP*>(pred),
                                         row0, Tn, U1, J},
                             x, static_cast<T*>(nullptr), xlo, 0, rows, J, J, 0, st);
    if (e != cudaSuccess) return e;
    ++*launched;
    const DlEpi<T, kF32, false> dl_epi{
        static_cast<const float*>(bias), static_cast<const int*>(lab),
        static_cast<const float*>(logz), static_cast<const float*>(gb),
        static_cast<const float*>(ge), dl, nullptr, dlo, row0, rows, Vp, Tn, U1, V, Vp, blank};
    const Operand x_op{x, xlo, (uint64_t)rows, (uint64_t)J};
    if constexpr (kF32) e = launch_gemm<T, 128>(x_op, wt_op, J, 1, dl_epi, st);
    else e = launch_gemm<T, 256>(x_op, wt_op, J, 1, dl_epi, st);
    if (e != cudaSuccess) return e;
    ++*launched;
    const DpreEpi<T, kF32> dpre_epi{x, static_cast<float*>(dpre), xlo, row0, rows, J};
    const Operand dl_op{dl, dlo, (uint64_t)rows, (uint64_t)Vp};
    if constexpr (kF32) e = launch_gemm<T, 128>(dl_op, w_op, Vp, 1, dpre_epi, st);
    else if (J % 256) e = launch_gemm<T, 128>(dl_op, w_op, Vp, 1, dpre_epi, st);
    else e = launch_gemm<T, 256>(dl_op, w_op, Vp, 1, dpre_epi, st);
    if (e != cudaSuccess) return e;
    ++*launched;
  }
  joint_reduce_xp_kernel<<<B * Tn + B * U1, 128, 0, st>>>(
      static_cast<const float*>(dpre), static_cast<float*>(d_enc), static_cast<float*>(d_pred),
      B, Tn, U1, J);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// dW / dbias on the wide route: per chunk of `chunk` cells x and x^T, the
// logits product with dl^T [Vp][rows] and the tiles' dbias sums, the
// chunk's dW = x^T dl added into part [n_split][J][Vp] (K split n_split
// ways); then the sums over the splits and the row tiles, in order.
// xbuf [chunk][J], xtbuf [J][chunk], dlbuf [Vp][chunk] (float32: hi, then
// lo); dbpart [ceil(M / 128)][Vp]
template <typename T, typename TP>
cudaError_t launch_bwd_w_wide(const void* enc, const void* pred, const void* w, const void* bias,
                              const void* lab, const void* logz, const void* gb, const void* ge,
                              void* wt, void* xbuf, void* xtbuf, void* dlbuf, void* part,
                              void* dbpart, void* dw, void* db, int* launched, cudaStream_t st,
                              int B, int Tn, int U1, int J, int V, int Vp, int blank, int chunk,
                              int n_split) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int M = B * Tn * U1;
  const size_t wlo = (size_t)J * Vp, xlo = (size_t)chunk * J, dlo = (size_t)chunk * Vp;
  cudaError_t e = prep_w<T>(w, wt, nullptr, J, Vp, st);
  if (e != cudaSuccess) return e;
  ++*launched;
  const Operand wt_op{wt, wlo, (uint64_t)Vp, (uint64_t)J};
  for (int row0 = 0; row0 < M; row0 += chunk) {
    const int rows = min(chunk, M - row0);
    T* x = static_cast<T*>(xbuf);
    T* xt = static_cast<T*>(xtbuf);
    T* dl = static_cast<T*>(dlbuf);
    e = launch_tile<T, kF32>(XSrc<T, TP>{static_cast<const T*>(enc), static_cast<const TP*>(pred),
                                         row0, Tn, U1, J},
                             x, xt, xlo, xlo, rows, J, J, chunk, st);
    if (e != cudaSuccess) return e;
    ++*launched;
    const DlEpi<T, kF32, true> dl_epi{
        static_cast<const float*>(bias), static_cast<const int*>(lab),
        static_cast<const float*>(logz), static_cast<const float*>(gb),
        static_cast<const float*>(ge), dl, static_cast<float*>(dbpart) + (size_t)(row0 / GM_BM) * Vp,
        dlo, row0, rows, chunk, Tn, U1, V, Vp, blank};
    const Operand x_op{x, xlo, (uint64_t)rows, (uint64_t)J};
    if constexpr (kF32) e = launch_gemm<T, 128>(x_op, wt_op, J, 1, dl_epi, st);
    else e = launch_gemm<T, 256>(x_op, wt_op, J, 1, dl_epi, st);
    if (e != cudaSuccess) return e;
    ++*launched;
    const PartEpi part_epi{static_cast<float*>(part), J, Vp, row0 > 0};
    const Operand xt_op{xt, xlo, (uint64_t)J, (uint64_t)chunk};
    const Operand dl_op{dl, dlo, (uint64_t)Vp, (uint64_t)chunk};
    if constexpr (kF32) e = launch_gemm<T, 128>(xt_op, dl_op, rows, n_split, part_epi, st);
    else e = launch_gemm<T, 256>(xt_op, dl_op, rows, n_split, part_epi, st);
    if (e != cudaSuccess) return e;
    ++*launched;
  }
  const size_t jv = (size_t)J * Vp, n = jv + Vp;
  joint_reduce_w_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(dbpart), static_cast<float*>(dw),
      static_cast<float*>(db), n_split, (M + GM_BM - 1) / GM_BM, jv, Vp);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// the wide forward: W^T [Vp][J] once; per chunk of `chunk` cells x, then
// the logits product with the logsumexp epilogue into part (pmax, then
// psum, [Vp / BN][M] each); then the combine. wt, xbuf as the wide
// backward's (float32: hi, then lo)
template <typename T, typename TP>
cudaError_t launch_fwd_wide(const void* enc, const void* pred, const void* w, const void* bias,
                            const void* lab, void* wt, void* xbuf, void* part, void* lpb,
                            void* lpe, void* logz, int* launched, cudaStream_t st, int B, int Tn,
                            int U1, int J, int V, int Vp, int blank, int chunk) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int BN = kF32 ? 128 : 256;
  const int M = B * Tn * U1, n_tiles = (Vp + BN - 1) / BN;
  const size_t wlo = (size_t)J * Vp, xlo = (size_t)chunk * J;
  cudaError_t e = prep_w<T>(w, wt, nullptr, J, Vp, st);
  if (e != cudaSuccess) return e;
  ++*launched;
  const Operand wt_op{wt, wlo, (uint64_t)Vp, (uint64_t)J};
  float* pmax = static_cast<float*>(part);
  float* psum = pmax + (size_t)n_tiles * M;
  for (int row0 = 0; row0 < M; row0 += chunk) {
    const int rows = min(chunk, M - row0);
    T* x = static_cast<T*>(xbuf);
    e = launch_tile<T, kF32>(XSrc<T, TP>{static_cast<const T*>(enc), static_cast<const TP*>(pred),
                                         row0, Tn, U1, J},
                             x, static_cast<T*>(nullptr), xlo, 0, rows, J, J, 0, st);
    if (e != cudaSuccess) return e;
    ++*launched;
    const LseEpi epi{static_cast<const float*>(bias), static_cast<const int*>(lab), pmax, psum,
                     static_cast<float*>(lpb), static_cast<float*>(lpe), row0, rows, M, Tn, U1,
                     V, blank};
    const Operand x_op{x, xlo, (uint64_t)rows, (uint64_t)J};
    e = launch_gemm<T, BN>(x_op, wt_op, J, 1, epi, st);
    if (e != cudaSuccess) return e;
    ++*launched;
  }
  joint_lse_combine_kernel<<<(M + 255) / 256, 256, 0, st>>>(
      pmax, psum, static_cast<const int*>(lab), static_cast<float*>(lpb), static_cast<float*>(lpe),
      static_cast<float*>(logz), M, n_tiles, Tn, U1, V);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return e;
}

// The narrow kernels' widths (J a multiple of 128, after the wrappers'
// padding), bf16 enc only: the forward up to 640, the backward up to 512.
// float32 has none: the wide route takes it at every J.
constexpr int NARROW_FWD_J_BF16 = 640, NARROW_BWD_J_BF16 = 512;
bool fwd_narrow(int J, bool is_bf16) { return is_bf16 && J <= NARROW_FWD_J_BF16; }
bool bwd_narrow(int J, bool is_bf16) { return is_bf16 && J <= NARROW_BWD_J_BF16; }

// the narrow forward: joint_fwd_wg_kernel
template <typename TP>
cudaError_t launch_fwd(const void* enc, const void* pred, const void* w, const void* bias,
                       const void* lab, void* lpb, void* lpe, void* logz, cudaStream_t st, int M,
                       int Tn, int U1, int J, int V, int Vp, int blank) {
  switch (J / 128) {
#define FWD_WG(NJ)                                                                              \
  case NJ:                                                                                      \
    return launch_fwd_wg<NJ, TP>(enc, pred, w, bias, lab, lpb, lpe, logz, st, M, Tn, U1, V, Vp, \
                                 blank);
    FWD_WG(1) FWD_WG(2) FWD_WG(3) FWD_WG(4) FWD_WG(5)
#undef FWD_WG
    default: return cudaErrorInvalidValue;
  }
}

// the narrow backward: joint_bwd_xp_wg_kernel, then the sums over u and t
template <typename TP>
cudaError_t launch_bwd_xp(const void* enc, const void* pred, const void* w, const void* bias,
                          const void* lab, const void* logz, const void* gb, const void* ge,
                          void* dpre, void* d_enc, void* d_pred, int* launched, cudaStream_t st,
                          int B, int Tn, int U1, int J, int V, int Vp, int blank) {
  const int M = B * Tn * U1;
  cudaError_t e;
  switch (J / 128) {
#define XP_WG(NJ)                                                                               \
  case NJ:                                                                                      \
    e = launch_bwd_xp_wg<NJ, TP>(enc, pred, w, bias, lab, logz, gb, ge, dpre, st, M, Tn, U1, V, \
                                 Vp, blank);                                                    \
    break;
    XP_WG(1) XP_WG(2) XP_WG(3) XP_WG(4)
#undef XP_WG
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  *launched = 1;
  joint_reduce_xp_kernel<<<B * Tn + B * U1, 128, 0, st>>>(
      static_cast<const float*>(dpre), static_cast<float*>(d_enc), static_cast<float*>(d_pred),
      B, Tn, U1, J);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched = 2;
  return e;
}

// the narrow backward: x, joint_bwd_w_wg_kernel, then the sums over chunks
template <typename TP>
cudaError_t launch_bwd_w(const void* enc, const void* pred, const void* w, const void* bias,
                         const void* lab, const void* logz, const void* gb, const void* ge,
                         void* xbuf, void* part, void* dbpart, void* dw, void* db, int* launched,
                         cudaStream_t st, int B, int Tn, int U1, int J, int V, int Vp, int blank,
                         int n_chunks) {
  const int M = B * Tn * U1;
  joint_x_kernel<bf16, TP><<<(M + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const bf16*>(enc), static_cast<const TP*>(pred), static_cast<bf16*>(xbuf), M,
      Tn, U1, J);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  *launched = 1;
  const int tiles = (M + WG_ROWS - 1) / WG_ROWS;
  const int rows_per_chunk = (tiles + n_chunks - 1) / n_chunks * WG_ROWS;
  switch (J / 128) {
#define W_WG(NJ)                                                                              \
  case NJ:                                                                                    \
    e = launch_bwd_w_wg<NJ>(xbuf, w, bias, lab, logz, gb, ge, part, dbpart, st, M, Tn, U1, V, \
                            Vp, blank, n_chunks, rows_per_chunk);                             \
    break;
    W_WG(1) W_WG(2) W_WG(3) W_WG(4)
#undef W_WG
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  *launched = 2;
  const size_t jv = (size_t)J * Vp;
  const size_t n = jv + Vp;
  joint_reduce_w_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(dbpart), static_cast<float*>(dw),
      static_cast<float*>(db), n_chunks, n_chunks, jv, Vp);
  e = cudaGetLastError();
  if (e == cudaSuccess) *launched = 3;
  return e;
}

// J that the entries route: any positive multiple of 128
bool j_routed(int J) { return J > 0 && J % 128 == 0; }

}  // namespace

// The C entries: enc in bf16 or float32 (is_bf16), pred likewise
// (pred_bf16); w [J,Vp] in enc's dtype, bias [Vp] float32, lab [B,U1] int32.
// J a multiple of 128; each entry returns cudaErrorInvalidValue before any
// launch for a (dtype, J) outside its route. Routes by dtype and J (padded):
//   narrow, bf16 enc only (joint_lattice_fwd, joint_lattice_bwd_xp, joint_lattice_bwd_w):
//     forward J <= 640: joint_fwd_wg_kernel (wgmma, TMA; Vp a multiple of 128)
//     backward J <= 512: joint_bwd_xp_wg_kernel, joint_bwd_w_wg_kernel (wgmma, TMA)
//   wide, float32 at every J and bf16 above (joint_lattice_fwd_wide,
//     joint_lattice_bwd_xp_wide, joint_lattice_bwd_w_wide): joint_gemm_kernel's
//     products per chunk of cells (wgmma, TMA; 3xTF32 in float32), one in the
//     forward, two in each backward entry
// *grids: the grids each entry launched.

// -> lpb, lpe, logz [B,T,U1] float32. *grids: 1.
extern "C" int joint_lattice_fwd(const void* enc, const void* pred, const void* w,
                                 const void* bias, const void* lab, void* lpb, void* lpe,
                                 void* logz, void* grids, void* stream, int B, int T, int U1,
                                 int J, int V, int Vp, int blank, int is_bf16, int pred_bf16) {
  int* launched = static_cast<int*>(grids);
  *launched = 0;
  if (!j_routed(J) || !fwd_narrow(J, is_bf16) || Vp % FWD_VT) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T * U1;
  const cudaError_t e =
      pred_bf16 ? launch_fwd<bf16>(enc, pred, w, bias, lab, lpb, lpe, logz, st, M, T, U1, J, V,
                                   Vp, blank)
                : launch_fwd<float>(enc, pred, w, bias, lab, lpb, lpe, logz, st, M, T, U1, J, V,
                                    Vp, blank);
  if (e == cudaSuccess) *launched = 1;
  return static_cast<int>(e);
}

// float32 at any J, bf16 J > 640. -> lpb, lpe, logz as joint_lattice_fwd;
// scratch in enc's dtype, each twice as long in float32 (tf32 hi, then lo):
// wt [Vp,J], xbuf [chunk,J]; float32 part [2, ceil(Vp / BN), B*T*U1] (BN
// 128 in float32, 256 in bf16). chunk: cells per chunk, a multiple of 128;
// Vp a multiple of 128. *grids: 2 per chunk and 2.
extern "C" int joint_lattice_fwd_wide(const void* enc, const void* pred, const void* w,
                                      const void* bias, const void* lab, void* lpb, void* lpe,
                                      void* logz, void* wt, void* xbuf, void* part, void* grids,
                                      void* stream, int B, int T, int U1, int J, int V, int Vp,
                                      int blank, int chunk, int is_bf16, int pred_bf16) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* launched = static_cast<int*>(grids);
  *launched = 0;
  if (!j_routed(J) || fwd_narrow(J, is_bf16) || Vp % FWD_VT || chunk <= 0 || chunk % GM_BM)
    return cudaErrorInvalidValue;
#define JOINT_FWD(T_, TP_)                                                                      \
  launch_fwd_wide<T_, TP_>(enc, pred, w, bias, lab, wt, xbuf, part, lpb, lpe, logz, launched, \
                           st, B, T, U1, J, V, Vp, blank, chunk)
  return static_cast<int>(is_bf16 ? (pred_bf16 ? JOINT_FWD(bf16, bf16) : JOINT_FWD(bf16, float))
                                  : (pred_bf16 ? JOINT_FWD(float, bf16) : JOINT_FWD(float, float)));
#undef JOINT_FWD
}

// bf16 J <= 512. -> d_enc [B,T,J], d_pred [B,U1,J] float32; dpre [B*T*U1, J]
// float32 scratch. *grids: 2.
extern "C" int joint_lattice_bwd_xp(const void* enc, const void* pred, const void* w,
                                    const void* bias, const void* lab, const void* logz,
                                    const void* gb, const void* ge, void* dpre, void* d_enc,
                                    void* d_pred, void* grids, void* stream, int B, int T, int U1,
                                    int J, int V, int Vp, int blank, int is_bf16, int pred_bf16) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* launched = static_cast<int*>(grids);
  *launched = 0;
  if (!j_routed(J) || !bwd_narrow(J, is_bf16)) return cudaErrorInvalidValue;
#define JOINT_XP(TP_)                                                                         \
  launch_bwd_xp<TP_>(enc, pred, w, bias, lab, logz, gb, ge, dpre, d_enc, d_pred, launched, st, \
                     B, T, U1, J, V, Vp, blank)
  return static_cast<int>(pred_bf16 ? JOINT_XP(bf16) : JOINT_XP(float));
#undef JOINT_XP
}

// bf16 J <= 512. -> dw [J,Vp], db [Vp] float32; scratch: xbuf [B*T*U1, J]
// bf16, part [n_chunks, J, Vp] and dbpart [n_chunks, Vp] float32.
// *grids: 3.
extern "C" int joint_lattice_bwd_w(const void* enc, const void* pred, const void* w,
                                   const void* bias, const void* lab, const void* logz,
                                   const void* gb, const void* ge, void* xbuf, void* part,
                                   void* dbpart, void* dw, void* db, void* grids, void* stream,
                                   int B, int T, int U1, int J, int V, int Vp, int blank,
                                   int n_chunks, int is_bf16, int pred_bf16) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* launched = static_cast<int*>(grids);
  *launched = 0;
  if (!j_routed(J) || !bwd_narrow(J, is_bf16)) return cudaErrorInvalidValue;
#define JOINT_W(TP_)                                                                          \
  launch_bwd_w<TP_>(enc, pred, w, bias, lab, logz, gb, ge, xbuf, part, dbpart, dw, db,         \
                    launched, st, B, T, U1, J, V, Vp, blank, n_chunks)
  return static_cast<int>(pred_bf16 ? JOINT_W(bf16) : JOINT_W(float));
#undef JOINT_W
}


// float32 at any J, bf16 J > 512. -> d_enc, d_pred as joint_lattice_bwd_xp;
// scratch in enc's dtype, each twice as long in float32 (tf32 hi, then lo):
// wt [Vp,J], wn [J,Vp] (float32 only; null in bf16), xbuf [chunk,J], dlbuf
// [chunk,Vp]; dpre [B*T*U1, J] float32. chunk: cells per chunk, a multiple
// of 128. *grids: the grids launched (3 per chunk and 2).
extern "C" int joint_lattice_bwd_xp_wide(const void* enc, const void* pred, const void* w,
                                         const void* bias, const void* lab, const void* logz,
                                         const void* gb, const void* ge, void* wt, void* wn,
                                         void* xbuf, void* dlbuf, void* dpre, void* d_enc,
                                         void* d_pred, void* grids, void* stream, int B, int T,
                                         int U1, int J, int V, int Vp, int blank, int chunk,
                                         int is_bf16, int pred_bf16) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* launched = static_cast<int*>(grids);
  *launched = 0;
  if (!j_routed(J) || bwd_narrow(J, is_bf16) || chunk <= 0 || chunk % GM_BM)
    return cudaErrorInvalidValue;
#define JOINT_XP(T_, TP_)                                                                       \
  launch_bwd_xp_wide<T_, TP_>(enc, pred, w, bias, lab, logz, gb, ge, wt, wn, xbuf, dlbuf, dpre, \
                              d_enc, d_pred, launched, st, B, T, U1, J, V, Vp, blank, chunk)
  return static_cast<int>(is_bf16 ? (pred_bf16 ? JOINT_XP(bf16, bf16) : JOINT_XP(bf16, float))
                                  : (pred_bf16 ? JOINT_XP(float, bf16) : JOINT_XP(float, float)));
#undef JOINT_XP
}

// float32 at any J, bf16 J > 512. -> dw, db as joint_lattice_bwd_w;
// scratch in enc's dtype, each twice as long in float32: wt [Vp,J], xbuf
// [chunk,J], xtbuf [J,chunk], dlbuf [Vp,chunk]; float32 part [n_split,J,Vp],
// dbpart [ceil(B*T*U1 / 128), Vp]. *grids: the grids launched (3 per chunk and 2).
extern "C" int joint_lattice_bwd_w_wide(const void* enc, const void* pred, const void* w,
                                        const void* bias, const void* lab, const void* logz,
                                        const void* gb, const void* ge, void* wt, void* xbuf,
                                        void* xtbuf, void* dlbuf, void* part, void* dbpart,
                                        void* dw, void* db, void* grids, void* stream, int B,
                                        int T, int U1, int J, int V, int Vp, int blank, int chunk,
                                        int n_split, int is_bf16, int pred_bf16) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* launched = static_cast<int*>(grids);
  *launched = 0;
  if (!j_routed(J) || bwd_narrow(J, is_bf16) || chunk <= 0 || chunk % GM_BM || n_split <= 0)
    return cudaErrorInvalidValue;
#define JOINT_W(T_, TP_)                                                                         \
  launch_bwd_w_wide<T_, TP_>(enc, pred, w, bias, lab, logz, gb, ge, wt, xbuf, xtbuf, dlbuf, part, \
                             dbpart, dw, db, launched, st, B, T, U1, J, V, Vp, blank, chunk,      \
                             n_split)
  return static_cast<int>(is_bf16 ? (pred_bf16 ? JOINT_W(bf16, bf16) : JOINT_W(bf16, float))
                                  : (pred_bf16 ? JOINT_W(float, bf16) : JOINT_W(float, float)));
#undef JOINT_W
}
