// Simple-lattice scoring of the pruned RNN-T loss, forward and backward, for
// Hopper (sm_90a), as float32 products of the factored logsumexp.
//
// Replaces the Pallas TPU kernel
// conformer_tpu/ops/pallas/simple_lattice_kernel.py (_forward / _fwd_kernel
// and _backward / _bwd_kernel). For the additive "simple" joint
// logits[b,t,u,v] = am[b,t,v] + lm[b,u,v] the forward gives, per (b, t, u),
//
//   logZ = logsumexp_v logits,  lp_blank = logits[.., blank] - logZ,
//   lp_emit = logits[.., lab[u]] - logZ,
//
// and the backward, from the saved logZ and the cotangents g_b, g_e,
//
//   dl[t,u,v] = -(g_b+g_e) p + g_b [v=blank] + g_e [v=lab_u],  p = exp(logits - logZ)
//   d am[t,v] = sum_u dl,   d lm[u,v] = sum_t dl.
//
// No [B,T,U+1,V] tensor exists at any point. Inputs are float32; lab[u] is
// blank at u = U (the caller pads it), a label outside [0, V) picks 0.
//
// The factored form. With the row maxima ma[t] = max_v am[t,v] and
// ml[u] = max_v lm[u,v], ea = exp(am - ma) and el = exp(lm - ml) (each <= 1),
//
//   s[t,u] = sum_v ea[t,v] el[u,v],   logZ = ma + ml + log s,
//   W[t,u] = (g_b+g_e) exp(ma + ml - logZ) = (g_b+g_e) / s,
//   d am = -ea * (W el) + sparse,   d lm = -el * (W^T ea) + sparse,
//
// so the work is one product of depth V (forward) and two, of depths U+1
// and T (backward), and (T+U+1) V exps per batch row instead of one per
// (t, u, v). The products run on the tensor cores (wgmma) as 3xTF32: each
// operand x = hi + lo, both rounded to TF32, and hi*hi + hi*lo + lo*hi in
// float32 accumulators keeps float32 accuracy (single TF32 would not: ~3
// digits of s put logZ outside 2e-4).
//
// Bound, at the training shape (B=32, T'=374, U+1=65, V=5002): forward
// 2 B T (U+1) V = 7.8 GFLOP, 0.047 ms as 3xTF32 at 495/3 TFLOP/s; its
// bytes (am 239 MB, lm 42 MB) take 0.084 ms: bound by bytes. Backward
// 15.6 GFLOP, 0.094 ms; bytes 564 MB (am, lm read, d am, d lm written),
// 0.17 ms: bound by bytes.
//
// The guard. The factored sum loses the result where s underflows: where
// the maxima of am and lm fall on different v, every term ea el can be
// tiny or 0 (200 nats apart: s ~ e^-200, 0 in float32), while the direct
// logsumexp is exact. A cell is guarded when s < 2^-60 (log2 s < -60, or s
// not finite): below it, a term lost to an exp that underflows (< 2^-126)
// weighs < V 2^-126 / 2^-60 ~ 2^-53 of s, so above it the factored logZ is
// as good as the direct one, and in the backward W = g/s <= g 2^60 stays
// finite. Guarded cells are computed exactly: in the forward by the direct
// online logsumexp over V inside the merge kernel (one warp per guarded
// cell), in the backward by a guard kernel after the products (W = 0
// there) that adds the cells' exact -g exp(am + lm - logZ) rows. The
// backward recognises a guarded cell from logZ, ma and ml alone (logZ log2e
// - ma log2e - ml log2e < -60, evaluated the same way, without contraction,
// wherever it is tested). Random or recipe-shaped inputs never reach it;
// the guard kernel then only reads one flag per row.
//
// Staging. Rows of am and lm are only 8-byte aligned (V = 5002), and TMA
// takes neither such rows (tensor maps need 16-byte strides, one-dimensional
// boxes 16-byte starts), so the 16-byte chunks that cover a row segment are
// copied by cp.async into a shared row 4 floats wider, and the reader skips
// the row's misalignment (stage_rows16).
//
// Forward (2 launches). fwd_partial: one block of two warpgroups per (b,
// tile of 128 t, tile of 72 u, split of V); 2 blocks per SM. V streams in
// tiles of 32 columns, one tile ahead. One thread per row finds the tile's
// row maximum, raises the row's running maximum (online, as flash attention
// does: no extra pass over am), and writes exp2(x log2e - max) as tf32 hi
// and lo planes in the 128-byte swizzled layout wgmma reads; each warpgroup
// rescales its float32 accumulators (64 t x 72 u) by the rows' factors and
// issues 3 x 4 wgmma m64n72k8. Filling 132 SMs: at B=32 there are only 96
// (t, u) tiles, so V is split into S chunks, each with its own maxima, S
// chosen from the occupancy query to fill whole waves (S = 5 at the
// training shape). fwd_combine, one thread per cell, merges
// the S partial sums in a fixed order, each rescaled from its chunk's
// maxima to the global ones (deterministic), takes logZ, tests the guard,
// computes the guarded cells exactly, writes the picks, lp_blank, lp_emit,
// logZ, and counts the guarded cells.
//
// Backward (4 launches). rowmax: ma, ml (one warp per row; one more read of
// am and lm, ~0.1 ms: a product block owns a tile of v and cannot see a
// row's maximum). prep: W per cell (0 where guarded) in rows padded to a
// multiple of 4 (16-byte aligned), the blank column's row terms, the
// column sums of g_b and g_e, the guarded cells per row and column, all in
// fixed orders. main: one block of two warpgroups per (b, tile of 64 v), 2
// per SM. Per chunk of 72 u, warpgroup 0 keeps el^T (64 v x 72 u) as tf32
// A fragments in registers; per tile of 32 t the block stages am, W and the
// label terms by cp.async, builds the ea^T, W and W^T planes, and then
// warpgroup 0 forms P^T = el^T W^T (wgmma m64n32k8, A in registers) and
// d am = -ea P plus the blank and label terms, written through shared
// memory in coalesced rows, while warpgroup 1 adds ea^T W (m64n72k8) to its
// d lm accumulator; the next tile's loads are issued before the products.
// After the last t tile, d lm = -el acc plus its sparse terms. am is read
// once per u chunk (one at U+1 = 65), every sum has a fixed order and no
// atomics: the result is deterministic. guard: one block per row of d am
// and of d lm; rows with no guarded cell return at once.
//
// Limits: the forward's grid has at most 65535 (u tile, V split) pairs
// (U+1 <= 65535 * 72, ops/simple_lattice.py max_u1); the backward has none
// beyond memory. Shared memory: forward 108 KB, backward 108 KB a block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kGuardLog2 = -60.f;   // guard: log2 s below this
constexpr float kGuardS = 8.673617379884035e-19f;   // 2^-60
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}
// 16 bytes, of which the first `n` (0-16) come from src and the rest are 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Rows [row0, row0 + rows) of a row-major float32 matrix (row stride ld),
// columns [c0, c0 + ncols) (ncols a multiple of 4): rows of am and lm are
// only 8-byte aligned (V = 5002), so the 16-byte chunks that cover the
// columns are copied, into shared rows of ncols + 4 floats; column c0 + k of
// row r then sits at k + row_offset(base_o, (row0 + r) * ld + c0), base_o
// being the matrix's own misalignment in floats. Columns from cend on, and
// rows from nr on, read as 0 (nothing past cend is read).
__device__ __forceinline__ int row_offset(int base_o, size_t idx) {
  return static_cast<int>((base_o + idx) & 3);
}
__device__ __forceinline__ int base_offset(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}
__device__ __forceinline__ void stage_rows16(float* dst, const float* base, int base_o,
                                             size_t row0, size_t ld, int rows, int nr, int c0,
                                             int ncols, int cend, int tid, int nthr) {
  const int nch = ncols / 4 + 1;
  for (int i = tid; i < rows * nch; i += nthr) {
    const int r = i / nch, q = i % nch;
    const size_t idx = (row0 + r) * ld + c0;
    const int cs = c0 - row_offset(base_o, idx) + 4 * q;   // the chunk's first column
    const int n = r < nr ? min(16, max(0, 4 * (cend - cs))) : 0;
    cp_async16(dst + r * (ncols + 4) + 4 * q, n ? base + (row0 + r) * ld + cs : base, n);
  }
}

// log2 of the factored sum at (t, u) from logZ and the log2 maxima, rounded
// the same way wherever it is evaluated (no contraction into FMAs)
__device__ __forceinline__ bool guarded_cell(float logz, float ma2, float ml2, float* d) {
  *d = __fsub_rn(__fsub_rn(__fmul_rn(logz, kLog2e), ma2), ml2);
  return !(*d >= kGuardLog2);
}

// ------------------------------------------------------- tensor cores

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Matrix descriptor of a K-major tf32 operand at shared address a: rows of
// 32 floats (128 bytes) in 8-row groups of 1024 B (1024-aligned), 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)). A start inside
// a row (+32, +64, +96 B) selects the k-step of 8 floats; the swizzle
// applies to the full address, so the base-offset field stays 0.
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) | (kGroup << 16) | (kGroup << 32) |
         (1ull << 62);
}

// A plane holds a [rows][K] operand as K atoms of 32 floats, each atom a
// swizzled [rows][32] tile (rows a multiple of 8): byte offset of (r, k)
__device__ __forceinline__ uint32_t plane_off(int rows, int r, int k) {
  return static_cast<uint32_t>((k >> 5) * rows * 128 + r * 128 +
                               ((((k >> 2) & 7) ^ (r & 7)) << 4) + (k & 3) * 4);
}

// descriptor of k-step s (8 floats of K) of the plane at shared address a
__device__ __forceinline__ uint64_t desc_k(uint32_t a, int rows, int s) {
  return desc(a + (s >> 2) * rows * 128 + (s & 3) * 32);
}

// 3xTF32's split (hopper_common.cuh)
using hopper::split_tf32;

__device__ __forceinline__ void fence_view_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N, float32) [+]= A (64 x 8) B (8 x N), tf32, both K-major in
// shared memory. The accumulator's element (row, col) of warp w, lane l:
// row 16 w + l / 4 (+8 for d[4i+2], d[4i+3]), column 8 i + 2 (l % 4) (+1
// for d[4i+1], d[4i+3]).
__device__ __forceinline__ void wgmma_tf32_n72(float (&d)[36], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
      "}, %36, %37, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(a), "l"(b), "r"(scale_d));
}


// the same with A (64 x 8) in registers: warp w, lane l holds a[0] = A[16w + l/4][l%4],
// a[1] = A[16w + l/4 + 8][l%4], a[2] = A[16w + l/4][l%4 + 4], a[3] = A[16w + l/4 + 8][l%4 + 4]
__device__ __forceinline__ void wgmma_tf32_n32_ra(float (&d)[16], const float* a, uint64_t b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])), "r"(__float_as_uint(a[2])),
        "r"(__float_as_uint(a[3])), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (saddr(p) & 1023)) & 1023);
}

// ------------------------------------------------------------ forward

constexpr int F_TM = 128;                // t rows per block: two warpgroups of M = 64
constexpr int F_UN = 72;                 // u rows per block: the product's N
constexpr int F_VT = 32;                 // v columns per staged tile (one 128-byte row)
constexpr int F_ROWS = F_TM + F_UN;      // rows of a staged tile: am's, then lm's
constexpr int F_LD = F_VT + 4;           // a raw row: the 16-byte chunks covering 32 columns
constexpr int F_ST = 2;                  // stages of the raw ring
constexpr int F_MIN_CHUNK = 256;         // v columns per split, at least
constexpr int F_PLANE = F_ROWS * 128;    // a tf32 plane of one tile, bytes
constexpr int F_OFF_HI = 0, F_OFF_LO = F_PLANE, F_OFF_RAW = 2 * F_PLANE;
constexpr int F_OFF_SC = F_OFF_RAW + 4 * F_ST * F_ROWS * F_LD;   // [F_ROWS] rescale factors
constexpr size_t F_SMEM = F_OFF_SC + 4 * F_ROWS + 1024;          // + alignment slack

// Two warpgroups per (tile of 128 t, b, tile of 72 u, split of V); the
// partial sums s_k and the chunk's maxima (log2 units) go to part, pma, pml.
// Raw tiles arrive by cp.async one tile ahead; one thread per row turns
// its row into tf32 hi and lo planes in the swizzled layout wgmma reads.
__global__ void __launch_bounds__(256, 2)
fwd_partial_kernel(const float* __restrict__ am, const float* __restrict__ lm,
                   float* __restrict__ part, float* __restrict__ pma, float* __restrict__ pml,
                   int B, int T, int U1, int V, int n_ut, int vchunk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sbase = saddr(sm);
  float* raw = reinterpret_cast<float*>(sm + F_OFF_RAW);   // [F_ST][F_ROWS][F_LD]
  float* rsc = reinterpret_cast<float*>(sm + F_OFF_SC);
  const int b = blockIdx.y, t0 = blockIdx.x * F_TM;
  const int ut = blockIdx.z % n_ut, k = blockIdx.z / n_ut;
  const int u0 = ut * F_UN;
  const int v0 = k * vchunk, v1 = min(V, v0 + vchunk);
  const int ntile = (v1 - v0 + F_VT - 1) / F_VT;
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int am_o = base_offset(am), lm_o = base_offset(lm);
  // this thread's row of the staged tiles (tid < F_ROWS): its matrix's
  // misalignment and its index of (row, column 0)
  const int my_o = tid < F_TM ? am_o : lm_o;
  const size_t my_idx = tid < F_TM ? ((size_t)b * T + t0 + tid) * V
                                   : ((size_t)b * U1 + u0 + tid - F_TM) * V;

  auto load = [&](int tile) {
    float* dst = raw + (tile % F_ST) * F_ROWS * F_LD;
    const int vb = v0 + tile * F_VT;
    stage_rows16(dst, am, am_o, (size_t)b * T + t0, V, F_TM, T - t0, vb, F_VT, v1, tid, 256);
    stage_rows16(dst + F_TM * F_LD, lm, lm_o, (size_t)b * U1 + u0, V, F_UN, U1 - u0, vb, F_VT,
                 v1, tid, 256);
  };

  float acc[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) acc[i] = 0.f;
  float rmax = -INFINITY;   // the running maximum of row tid (log2 units)

  load(0);
  cp_commit();
  for (int it = 0; it < ntile; ++it) {
    if (it + 1 < ntile) load(it + 1);   // its slot's tile was consumed before the last sync
    cp_commit();
    cp_wait1();          // tile `it` has landed
    __syncthreads();     // ... for every thread
    if (tid < F_ROWS) {
      // row tid: its maximum, then exps against the raised maximum, split
      // into tf32 hi and lo
      const int vb = v0 + it * F_VT, nv = v1 - vb;
      const int o = row_offset(my_o, my_idx + vb);
      const float4* rr = reinterpret_cast<const float4*>(raw + (it % F_ST) * F_ROWS * F_LD +
                                                         tid * F_LD);
      float x[F_LD];
#pragma unroll
      for (int q = 0; q < F_LD / 4; ++q) {
        const float4 y = rr[q];
        x[4 * q] = y.x;
        x[4 * q + 1] = y.y;
        x[4 * q + 2] = y.z;
        x[4 * q + 3] = y.w;
      }
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < F_VT; ++j) {
        const float y = o == 0 ? x[j] : o == 1 ? x[j + 1] : o == 2 ? x[j + 2] : x[j + 3];
        x[j] = j < nv ? y * kLog2e : -INFINITY;
        m = fmaxf(m, x[j]);
      }
      const float mn = fmaxf(rmax, m);
      rsc[tid] = exp2f(rmax - mn);
      rmax = mn;
#pragma unroll
      for (int q = 0; q < F_VT / 4; ++q) {
        float4 h, l;
        split_tf32(exp2f(x[4 * q] - mn), &h.x, &l.x);
        split_tf32(exp2f(x[4 * q + 1] - mn), &h.y, &l.y);
        split_tf32(exp2f(x[4 * q + 2] - mn), &h.z, &l.z);
        split_tf32(exp2f(x[4 * q + 3] - mn), &h.w, &l.w);
        *reinterpret_cast<float4*>(sm + F_OFF_HI + plane_off(F_ROWS, tid, 4 * q)) = h;
        *reinterpret_cast<float4*>(sm + F_OFF_LO + plane_off(F_ROWS, tid, 4 * q)) = l;
      }
    }
    fence_view_async();   // the planes, written by threads, are read by wgmma
    __syncthreads();
    const int row = 64 * wg + 16 * w + g;
    const float sa0 = rsc[row], sa1 = rsc[row + 8];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const float s0 = rsc[F_TM + 8 * i + 2 * c], s1 = rsc[F_TM + 8 * i + 2 * c + 1];
      acc[4 * i] *= sa0 * s0;
      acc[4 * i + 1] *= sa0 * s1;
      acc[4 * i + 2] *= sa1 * s0;
      acc[4 * i + 3] *= sa1 * s1;
    }
    const uint32_t ahi = sbase + F_OFF_HI + wg * 64 * 128, alo = sbase + F_OFF_LO + wg * 64 * 128;
    const uint32_t bhi = sbase + F_OFF_HI + F_TM * 128, blo = sbase + F_OFF_LO + F_TM * 128;
    wg_fence();
#pragma unroll
    for (int s = 0; s < F_VT / 8; ++s) {
      wgmma_tf32_n72(acc, desc(alo + 32 * s), desc(bhi + 32 * s), 1);
      wgmma_tf32_n72(acc, desc(ahi + 32 * s), desc(blo + 32 * s), 1);
      wgmma_tf32_n72(acc, desc(ahi + 32 * s), desc(bhi + 32 * s), 1);
    }
    wg_commit();
    wg_wait0();
    fence_regs(acc);
  }
  const size_t cells = (size_t)B * T * U1;
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + 64 * wg + 16 * w + g + 8 * (j >> 1), u = u0 + 8 * i + 2 * c + (j & 1);
      if (t < T && u < U1) part[k * cells + ((size_t)b * T + t) * U1 + u] = acc[4 * i + j];
    }
  if (tid < F_TM && ut == 0 && t0 + tid < T) pma[((size_t)k * B + b) * T + t0 + tid] = rmax;
  if (tid >= F_TM && tid < F_ROWS && blockIdx.x == 0 && u0 + tid - F_TM < U1)
    pml[((size_t)k * B + b) * U1 + u0 + tid - F_TM] = rmax;
}

// merges the S partial sums of one cell (one thread each), takes logZ and
// the picks; guarded cells get the direct logsumexp, one warp per cell
__global__ void __launch_bounds__(256)
fwd_combine_kernel(const float* __restrict__ am, const float* __restrict__ lm,
                   const int* __restrict__ lab, const float* __restrict__ part,
                   const float* __restrict__ pma, const float* __restrict__ pml,
                   float* __restrict__ lpb, float* __restrict__ lpe, float* __restrict__ logz,
                   int* __restrict__ count, int B, int T, int U1, int V, int S, int blank) {
  const size_t cells = (size_t)B * T * U1;
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const bool act = o < cells;
  int b = 0, t = 0, u = 0;
  float lz2 = 0.f;
  bool gd = false;
  if (act) {
    u = static_cast<int>(o % U1);
    const size_t bt = o / U1;
    t = static_cast<int>(bt % T);
    b = static_cast<int>(bt / T);
    float ma = -INFINITY, ml = -INFINITY;
    for (int k = 0; k < S; ++k) {
      ma = fmaxf(ma, pma[((size_t)k * B + b) * T + t]);
      ml = fmaxf(ml, pml[((size_t)k * B + b) * U1 + u]);
    }
    float s = 0.f;
    for (int k = 0; k < S; ++k)
      s += part[k * cells + o] *
           exp2f(pma[((size_t)k * B + b) * T + t] - ma + pml[((size_t)k * B + b) * U1 + u] - ml);
    gd = !(s >= kGuardS);
    lz2 = ma + ml + log2f(s);
  }
  const unsigned flagged = __ballot_sync(kFull, act && gd);
  for (unsigned m = flagged; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const int gb_ = __shfl_sync(kFull, b, src), gt = __shfl_sync(kFull, t, src),
              gu = __shfl_sync(kFull, u, src);
    const float* ar = am + ((size_t)gb_ * T + gt) * V;
    const float* lr = lm + ((size_t)gb_ * U1 + gu) * V;
    float mx = -INFINITY, sum = 0.f;
    for (int v = lane; v < V; v += 32) {
      const float x = (ar[v] + lr[v]) * kLog2e;
      if (x > mx) {
        sum = sum * exp2f(mx - x) + 1.f;
        mx = x;
      } else {
        sum += exp2f(x - mx);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float mo = __shfl_xor_sync(kFull, mx, off), so = __shfl_xor_sync(kFull, sum, off);
      const float mn = fmaxf(mx, mo);
      if (mn != -INFINITY) {
        sum = sum * exp2f(mx - mn) + so * exp2f(mo - mn);
        mx = mn;
      }
    }
    if (lane == src) lz2 = mx + log2f(sum);
  }
  if (lane == 0 && flagged) atomicAdd(count, __popc(flagged));
  if (!act) return;
  const float lz = lz2 * kLn2;
  const float* ar = am + ((size_t)b * T + t) * V;
  const float* lr = lm + ((size_t)b * U1 + u) * V;
  const int lb = lab[(size_t)b * U1 + u];
  const float em = (lb >= 0 && lb < V) ? ar[lb] + lr[lb] : 0.f;
  lpb[o] = ar[blank] + lr[blank] - lz;
  lpe[o] = em - lz;
  logz[o] = lz;
}

struct FwdGeom {
  int n_ut, n_tt;
};

FwdGeom fwd_geom(int T, int U1) {
  return {(U1 + F_UN - 1) / F_UN, (T + F_TM - 1) / F_TM};
}

cudaError_t fwd_prepare() {
  return cudaFuncSetAttribute(fwd_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(F_SMEM));
}

int fwd_vchunk(int V, int splits) {
  return ((V + splits - 1) / splits + F_VT - 1) / F_VT * F_VT;
}

// ----------------------------------------------------------- backward

// row maxima of am and lm, in log2 units; one warp per row
__global__ void __launch_bounds__(256)
rowmax_kernel(const float* __restrict__ am, const float* __restrict__ lm, float* __restrict__ ma2,
              float* __restrict__ ml2, int rows_a, int rows_l, int V) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= rows_a + rows_l) return;
  const float* row = w < rows_a ? am + (size_t)w * V : lm + (size_t)(w - rows_a) * V;
  float m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
  int v = lane;
  for (; v + 96 < V; v += 128) {
    m0 = fmaxf(m0, row[v]);
    m1 = fmaxf(m1, row[v + 32]);
    m2 = fmaxf(m2, row[v + 64]);
    m3 = fmaxf(m3, row[v + 96]);
  }
  for (; v < V; v += 32) m0 = fmaxf(m0, row[v]);
  float m = fmaxf(fmaxf(m0, m1), fmaxf(m2, m3));
#pragma unroll
  for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) {
    if (w < rows_a)
      ma2[w] = m * kLog2e;
    else
      ml2[w - rows_a] = m * kLog2e;
  }
}

// blocks [0, row_blocks): one warp per (b, t) row: W, the blank column's
// sparse term (the row sum of g_b and of g_e where the label is blank), the
// row's guarded cells; the rest: one block per (b, 32 u columns), its
// 8 warps over t: the column sums of g_b and g_e and guarded cells
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const float* __restrict__ logz, const float* __restrict__ gb,
                const float* __restrict__ ge, const int* __restrict__ lab,
                const float* __restrict__ ma2,
                const float* __restrict__ ml2, float* __restrict__ W, float* __restrict__ gbrow,
                float* __restrict__ gbcol, float* __restrict__ gecol, int* __restrict__ rowflag,
                int* __restrict__ colflag, int B, int T, int U1, int U1p, int blank,
                int row_blocks) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int r = blockIdx.x * 8 + w;   // b * T + t
    if (r >= B * T) return;
    const int b = r / T;
    const float a2 = ma2[r];
    float sb = 0.f;
    int n = 0;
    for (int u = lane; u < U1; u += 32) {
      const size_t o = (size_t)r * U1 + u;
      float d;
      const bool gd = guarded_cell(logz[o], a2, ml2[(size_t)b * U1 + u], &d);
      const float g = gb[o] + ge[o];
      W[(size_t)r * U1p + u] = gd ? 0.f : g * exp2f(-d);
      sb += gb[o] + (lab[(size_t)b * U1 + u] == blank ? ge[o] : 0.f);
      n += gd;
    }
    for (int u = U1 + lane; u < U1p; u += 32) W[(size_t)r * U1p + u] = 0.f;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      sb += __shfl_xor_sync(kFull, sb, off);
      n += __shfl_xor_sync(kFull, n, off);
    }
    if (lane == 0) {
      gbrow[r] = sb;
      rowflag[r] = n;
    }
    return;
  }
  __shared__ float s_b[8][32], s_e[8][32];
  __shared__ int s_n[8][32];
  const int cb = blockIdx.x - row_blocks, nub = (U1 + 31) / 32;
  const int b = cb / nub, u = (cb % nub) * 32 + lane;
  float sb = 0.f, se = 0.f;
  int n = 0;
  if (u < U1) {
    const float l2 = ml2[(size_t)b * U1 + u];
    for (int t = w; t < T; t += 8) {
      const size_t o = ((size_t)b * T + t) * U1 + u;
      float d;
      n += guarded_cell(logz[o], ma2[(size_t)b * T + t], l2, &d);
      sb += gb[o];
      se += ge[o];
    }
  }
  s_b[w][lane] = sb;
  s_e[w][lane] = se;
  s_n[w][lane] = n;
  __syncthreads();
  if (w == 0 && u < U1) {
    sb = se = 0.f;
    n = 0;
    for (int k = 0; k < 8; ++k) {
      sb += s_b[k][lane];
      se += s_e[k][lane];
      n += s_n[k][lane];
    }
    gbcol[(size_t)b * U1 + u] = sb;
    gecol[(size_t)b * U1 + u] = se;
    colflag[(size_t)b * U1 + u] = n;
  }
}

constexpr int B_VT = 64;     // v columns per block: both products' M
constexpr int B_TT = 32;     // t rows per tile: N of the d am product, K of the d lm one
constexpr int B_UC = 72;     // u rows per chunk: K of the d am product, N of the d lm one
constexpr int B_HITS = 8;    // label columns of a v tile whose g_e rows are staged
constexpr int B_P_EAT = B_VT * 128;       // ea^T: rows v, K = t (one atom)
constexpr int B_P_W = B_TT * 128 * 3;     // W:    rows t, K = u (three atoms)
constexpr int B_P_WT = B_UC * 128;        // W^T:  rows u, K = t (one atom)
constexpr int B_OFF_EAT = 0, B_OFF_W = 2 * B_P_EAT, B_OFF_WT = B_OFF_W + 2 * B_P_W,
              B_OFF_EA = B_OFF_WT + 2 * B_P_WT,          // ea, then d am [32 t][64 v]
              B_OFF_RA = B_OFF_EA + 4 * B_TT * B_VT,     // raw am tile [32 t][64 + 4 v]
              B_OFF_RW = B_OFF_RA + 4 * B_TT * (B_VT + 4),   // raw W tile [32 t][72 + 4 u]
              B_OFF_RL = B_OFF_RW + 4 * B_TT * (B_UC + 4),   // raw lm chunk [72 u][64 + 4 v]
              B_OFF_RM = B_OFF_RL + 4 * B_UC * (B_VT + 4),   // ma2 of the t tile [32]
              B_OFF_GE = B_OFF_RM + 4 * B_TT,            // [2][B_HITS + 1][32]: g_e, g_b sums
              B_OFF_RX = B_OFF_GE + 4 * 2 * (B_HITS + 1) * B_TT,   // ml2, lab, gbcol, gecol
              B_OFF_HIT = B_OFF_RX + 4 * 4 * B_UC;       // label hits: u [72], column [72], count
constexpr size_t B_SMEM = B_OFF_HIT + 4 * (2 * B_UC + 1) + 1024;   // + alignment slack
static_assert(4 * B_UC * B_VT <= B_OFF_EA - B_OFF_W, "d lm staging fits in the W planes");
static_assert(2 * (B_SMEM + 1024) <= 233472, "two blocks per SM");

// four consecutive k of one row (a 16-byte chunk at off) into a hi plane and
// the lo plane plane_bytes after it
__device__ __forceinline__ void put_split4(unsigned char* hi_plane, int plane_bytes, uint32_t off,
                                           const float (&x)[4]) {
  float4 h, l;
  split_tf32(x[0], &h.x, &l.x);
  split_tf32(x[1], &h.y, &l.y);
  split_tf32(x[2], &h.z, &l.z);
  split_tf32(x[3], &h.w, &l.w);
  *reinterpret_cast<float4*>(hi_plane + off) = h;
  *reinterpret_cast<float4*>(hi_plane + plane_bytes + off) = l;
}

// One block per (tile of 64 v, b), two warpgroups, two blocks per SM. Per
// chunk of 72 u, warpgroup 0 holds el^T (64 v x 72 u) as tf32 hi and lo A
// fragments in registers. Per tile of 32 t: the ea^T, W and W^T planes;
// warpgroup 0 forms P^T = el^T W^T (64 v x 32 t, depth 72) and writes
// d am = -ea P through shared memory, while warpgroup 1 adds ea^T W
// (64 v x 72 u, depth 32) to its d lm accumulator (the first 36 of the same
// registers); the next t tile's am, W, maxima and label terms arrive by
// cp.async meanwhile. After the last t tile, d lm = -el acc.
__global__ void __launch_bounds__(256, 2)
bwd_main_kernel(const float* __restrict__ am, const float* __restrict__ lm,
                const int* __restrict__ lab, const float* __restrict__ W,
                const float* __restrict__ ma2, const float* __restrict__ ml2,
                const float* __restrict__ gbrow, const float* __restrict__ gbcol,
                const float* __restrict__ gecol, const float* __restrict__ ge,
                float* __restrict__ dam, float* __restrict__ dlm, int T, int U1, int U1p, int V,
                int blank) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  const uint32_t sbase = saddr(sm);
  float* Ea = reinterpret_cast<float*>(sm + B_OFF_EA);
  float* Dl = reinterpret_cast<float*>(sm + B_OFF_W);    // [72 u][64 v]: d lm (after the t loop)
  const float* RA = reinterpret_cast<const float*>(sm + B_OFF_RA);
  const float* RW = reinterpret_cast<const float*>(sm + B_OFF_RW);
  const float* RL = reinterpret_cast<const float*>(sm + B_OFF_RL);
  const float* RM = reinterpret_cast<const float*>(sm + B_OFF_RM);
  float* x_ml = reinterpret_cast<float*>(sm + B_OFF_RX);
  int* x_lab = reinterpret_cast<int*>(x_ml + B_UC);
  float* x_gbc = reinterpret_cast<float*>(x_lab + B_UC);
  float* x_gec = x_gbc + B_UC;
  int* hit_u = reinterpret_cast<int*>(sm + B_OFF_HIT);
  int* hit_c = hit_u + B_UC;
  int* n_hit = hit_c + B_UC;
  const int b = blockIdx.y, v0 = blockIdx.x * B_VT;
  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const bool has_blank = blank >= v0 && blank < v0 + B_VT;
  const float* Wb = W + (size_t)b * T * U1p;   // rows 16-byte aligned: no offset
  const int n_uc = (U1 + B_UC - 1) / B_UC;
  const int am_o = base_offset(am), lm_o = base_offset(lm);

  // am, W and ma2 of the t tile at t0 into the raw buffers; the g_e rows of
  // the first B_HITS label hits and the blank column's row terms (where
  // blank is in the v tile, first chunk) into buffer (t0 / 32) % 2
  auto stage_t = [&](int t0, int u0, int ch) {
    stage_rows16(reinterpret_cast<float*>(sm + B_OFF_RA), am, am_o, (size_t)b * T + t0, V, B_TT,
                 T - t0, v0, B_VT, V, tid, 256);
    stage_rows16(reinterpret_cast<float*>(sm + B_OFF_RW), Wb, 0, t0, U1p, B_TT, T - t0, u0, B_UC,
                 U1, tid, 256);
    if (tid < B_TT)
      cp_async4(reinterpret_cast<float*>(sm + B_OFF_RM) + tid,
                t0 + tid < T ? ma2 + (size_t)b * T + t0 + tid : ma2, t0 + tid < T);
    float* gx = reinterpret_cast<float*>(sm + B_OFF_GE) + ((t0 / B_TT) % 2) * (B_HITS + 1) * B_TT;
    const int nq = min(*n_hit, B_HITS);
    for (int i = tid; i < nq * B_TT; i += 256) {
      const int q = i / B_TT, r = i % B_TT;
      const bool ok = t0 + r < T;
      cp_async4(gx + i, ok ? ge + ((size_t)b * T + t0 + r) * U1 + hit_u[q] : ge, ok);
    }
    if (ch == 0 && has_blank && tid < B_TT)
      cp_async4(gx + B_HITS * B_TT + tid, t0 + tid < T ? gbrow + (size_t)b * T + t0 + tid : gbrow,
                t0 + tid < T);
  };

  for (int ch = 0; ch < n_uc; ++ch) {
    const int u0 = ch * B_UC;
    __syncthreads();   // the previous chunk's d lm is out of Dl, the raw buffers are free
    stage_rows16(reinterpret_cast<float*>(sm + B_OFF_RL), lm, lm_o, (size_t)b * U1 + u0, V, B_UC,
                 U1 - u0, v0, B_VT, V, tid, 256);
    if (tid < B_UC) {
      const bool ok = u0 + tid < U1;
      const size_t bu = (size_t)b * U1 + u0 + tid;
      cp_async4(x_ml + tid, ml2 + (ok ? bu : 0), ok);
      cp_async4(reinterpret_cast<float*>(x_lab) + tid,
                reinterpret_cast<const float*>(lab) + (ok ? bu : 0), ok);
      cp_async4(x_gbc + tid, gbcol + (ok ? bu : 0), ok);
      cp_async4(x_gec + tid, gecol + (ok ? bu : 0), ok);
    }
    cp_commit();
    cp_wait0();
    __syncthreads();
    if (tid < 32) {   // the label hits of the v tile, in u order
      int n = 0;
      for (int r0 = 0; r0 < B_UC; r0 += 32) {
        const int r = r0 + tid, l = r < B_UC && u0 + r < U1 ? x_lab[r] : -1;
        const bool hit = l >= v0 && l < v0 + B_VT && l < V && l != blank;
        const unsigned m = __ballot_sync(kFull, hit);
        if (hit) {
          const int pos = n + __popc(m & ((1u << tid) - 1));
          hit_u[pos] = u0 + r;
          hit_c[pos] = l - v0;
        }
        n += __popc(m);
      }
      if (tid == 0) *n_hit = n;
    }
    // warpgroup 0: el^T fragments, hi in frag[0..35], lo in frag[36..71];
    // warpgroup 1: the d lm accumulator in frag[0..35]
    float frag[72];
#pragma unroll
    for (int i = 0; i < 72; ++i) frag[i] = 0.f;
    if (wg == 0) {
#pragma unroll
      for (int s = 0; s < B_UC / 8; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = 16 * w + g + 8 * (j & 1), u = 8 * s + c + 4 * (j >> 1);
          const int o = row_offset(lm_o, ((size_t)b * U1 + u0 + u) * V + v0);
          const float e = (u0 + u < U1 && v0 + v < V)
                              ? exp2f(RL[u * (B_VT + 4) + o + v] * kLog2e - x_ml[u]) : 0.f;
          split_tf32(e, &frag[4 * s + j], &frag[36 + 4 * s + j]);
        }
    }
    float(&acc)[36] = *reinterpret_cast<float(*)[36]>(frag);
    __syncthreads();   // the hits are listed
    stage_t(0, u0, ch);
    cp_commit();

    for (int t0 = 0; t0 < T; t0 += B_TT) {
      cp_wait0();
      __syncthreads();   // the t tile has landed; the previous tile's d am is out of Ea
      for (int i = tid; i < B_TT / 4 * B_VT; i += 256) {   // (v, 4 t) per thread
        const int cc = i % B_VT, r = 4 * (i / B_VT);
        const int o0 = row_offset(am_o, ((size_t)b * T + t0 + r) * V + v0);
        float e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (o0 + j * V) & 3;
          e[j] = (t0 + r + j < T && v0 + cc < V)
                     ? exp2f(RA[(r + j) * (B_VT + 4) + o + cc] * kLog2e - RM[r + j]) : 0.f;
          Ea[(r + j) * B_VT + cc] = e[j];
        }
        put_split4(sm + B_OFF_EAT, B_P_EAT, plane_off(B_VT, cc, r), e);
      }
      for (int i = tid; i < B_TT * B_UC / 4; i += 256) {   // (t, 4 u) per thread
        const int r = i / (B_UC / 4), cc = 4 * (i % (B_UC / 4));
        const float4 x = *reinterpret_cast<const float4*>(&RW[r * (B_UC + 4) + cc]);
        const float e[4] = {x.x, x.y, x.z, x.w};
        put_split4(sm + B_OFF_W, B_P_W, plane_off(B_TT, r, cc), e);
      }
      for (int i = tid; i < B_UC * B_TT / 4; i += 256) {   // (u, 4 t) per thread
        const int cc = i % B_UC, r = 4 * (i / B_UC);
        constexpr int L = B_UC + 4;
        const float e[4] = {RW[r * L + cc], RW[(r + 1) * L + cc], RW[(r + 2) * L + cc],
                            RW[(r + 3) * L + cc]};
        put_split4(sm + B_OFF_WT, B_P_WT, plane_off(B_UC, cc, r), e);
      }
      fence_view_async();   // the planes, written by threads, are read by wgmma
      __syncthreads();      // ... and the raw buffers are free
      if (t0 + B_TT < T) stage_t(t0 + B_TT, u0, ch);
      cp_commit();
      if (wg == 0) {
        float p[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) p[i] = 0.f;
        wg_fence();
#pragma unroll
        for (int s = 0; s < B_UC / 8; ++s) {
          const uint64_t bhi = desc_k(sbase + B_OFF_W, B_TT, s);
          const uint64_t blo = desc_k(sbase + B_OFF_W + B_P_W, B_TT, s);
          wgmma_tf32_n32_ra(p, &frag[36 + 4 * s], bhi, s > 0);
          wgmma_tf32_n32_ra(p, &frag[4 * s], blo, 1);
          wgmma_tf32_n32_ra(p, &frag[4 * s], bhi, 1);
        }
        wg_commit();
        wg_wait0();
        fence_regs(p);
        // p[4i+j] = P^T[v][t], v = 16w+g (+8), t = 8i+2c (+1): d am = -ea P
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* e = &Ea[(8 * i + 2 * c + (j & 1)) * B_VT + 16 * w + g + 8 * (j >> 1)];
            *e = -*e * p[4 * i + j];
          }
        bar_sync(1, 128);   // warpgroup 0's d am is in Ea
        // the blank and label terms, one thread per t row, in u order
        if (tid < B_TT) {
          const float* gx = reinterpret_cast<const float*>(sm + B_OFF_GE) +
                            ((t0 / B_TT) % 2) * (B_HITS + 1) * B_TT;
          float* row = Ea + tid * B_VT;
          if (ch == 0 && has_blank) row[blank - v0] += gx[B_HITS * B_TT + tid];
          const int nh = *n_hit;
          for (int q = 0; q < nh; ++q) {
            float x;
            if (q < B_HITS)
              x = gx[q * B_TT + tid];
            else
              x = t0 + tid < T ? ge[((size_t)b * T + t0 + tid) * U1 + hit_u[q]] : 0.f;
            row[hit_c[q]] += x;
          }
        }
      } else {
        wg_fence();
#pragma unroll
        for (int s = 0; s < B_TT / 8; ++s) {
          const uint32_t a = sbase + B_OFF_EAT + 32 * s, bb = sbase + B_OFF_WT + 32 * s;
          wgmma_tf32_n72(acc, desc(a + B_P_EAT), desc(bb), 1);
          wgmma_tf32_n72(acc, desc(a), desc(bb + B_P_WT), 1);
          wgmma_tf32_n72(acc, desc(a), desc(bb), 1);
        }
        wg_commit();
        wg_wait0();
        fence_regs(acc);
      }
      __syncthreads();   // d am is complete in Ea, warpgroup 1's products are done
      for (int i = tid; i < B_TT * B_VT; i += 256) {
        const int r = i / B_VT, cc = i % B_VT, t = t0 + r, v = v0 + cc;
        if (t >= T || v >= V) continue;
        float* out = dam + ((size_t)b * T + t) * V + v;
        if (ch == 0)
          *out = Ea[i];
        else
          *out += Ea[i];
      }
    }
    __syncthreads();   // the W planes are free: d lm goes there
    if (wg == 1) {
      // acc[4i+j] = (W^T ea)[u][v], v = 16w+g (+8), u = 8i+2c (+1)
#pragma unroll
      for (int i = 0; i < 9; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Dl[(8 * i + 2 * c + (j & 1)) * B_VT + 16 * w + g + 8 * (j >> 1)] = acc[4 * i + j];
    }
    __syncthreads();
    for (int i = tid; i < B_UC * B_VT; i += 256) {   // d lm = -el acc + its sparse terms
      const int r = i / B_VT, cc = i % B_VT, u = u0 + r, v = v0 + cc;
      if (u >= U1 || v >= V) continue;
      const size_t bu = (size_t)b * U1 + u;
      const int o = row_offset(lm_o, bu * V + v0);
      float d = -exp2f(RL[r * (B_VT + 4) + o + cc] * kLog2e - x_ml[r]) * Dl[i];
      if (v == blank) d += x_gbc[r];
      if (x_lab[r] == v) d += x_gec[r];
      dlm[bu * V + v] = d;
    }
  }
}

// one block per row of d am (b, t) and of d lm (b, u): adds the exact
// -g exp(am + lm - logZ) terms of the row's guarded cells, in a fixed order
__global__ void __launch_bounds__(256)
bwd_guard_kernel(const float* __restrict__ am, const float* __restrict__ lm,
                 const float* __restrict__ logz, const float* __restrict__ gb,
                 const float* __restrict__ ge, const float* __restrict__ ma2,
                 const float* __restrict__ ml2, const int* __restrict__ rowflag,
                 const int* __restrict__ colflag, float* __restrict__ dam,
                 float* __restrict__ dlm, int T, int U1, int V) {
  const int b = blockIdx.x / (T + U1), r = blockIdx.x % (T + U1);
  const bool is_row = r < T;
  if ((is_row ? rowflag[(size_t)b * T + r] : colflag[(size_t)b * U1 + r - T]) == 0) return;
  __shared__ int pid[256], pf[256];
  __shared__ float pz[256], pg[256];
  __shared__ int n_s;
  const int np = is_row ? U1 : T;
  const float* x_row = is_row ? am + ((size_t)b * T + r) * V : lm + ((size_t)b * U1 + r - T) * V;
  const float* y_base = is_row ? lm + (size_t)b * U1 * V : am + (size_t)b * T * V;
  float* out = is_row ? dam + ((size_t)b * T + r) * V : dlm + ((size_t)b * U1 + r - T) * V;
  const int tid = threadIdx.x;
  for (int p0 = 0; p0 < np; p0 += 256) {
    __syncthreads();
    const int p = p0 + tid;
    int f = 0;
    float z = 0.f, g = 0.f;
    if (p < np) {
      const int t = is_row ? r : p, u = is_row ? p : r - T;
      const size_t o = ((size_t)b * T + t) * U1 + u;
      float d;
      f = guarded_cell(logz[o], ma2[(size_t)b * T + t], ml2[(size_t)b * U1 + u], &d);
      z = logz[o];
      g = gb[o] + ge[o];
    }
    pf[tid] = f;
    pz[tid] = z;
    pg[tid] = g;
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int k = 0; k < 256; ++k)
        if (pf[k]) {
          pid[n] = p0 + k;
          pz[n] = pz[k];
          pg[n] = pg[k];
          ++n;
        }
      n_s = n;
    }
    __syncthreads();
    const int n = n_s;
    for (int v = tid; v < V; v += 256) {
      const float xv = x_row[v];
      float a = 0.f;
      for (int k = 0; k < n; ++k)
        a -= pg[k] * expf(xv + y_base[(size_t)pid[k] * V + v] - pz[k]);
      out[v] += a;
    }
  }
}

}  // namespace

// The number of V splits of the forward at this shape. Each split is a
// block per (t, u) tile; with `slots` blocks resident on the card at once
// (the occupancy query), s splits take ceil(tiles s / slots) waves of 1/s
// of the work each: the s of least waves / s (+1% per split for the merge),
// each split at least 256 columns.
extern "C" int simple_lattice_fwd_splits(int B, int T, int U1, int V) {
  static int sms = 0;
  const FwdGeom g = fwd_geom(T, U1);
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) sms = 1;
  }
  int occ = 1;
  if (fwd_prepare() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fwd_partial_kernel, 256, F_SMEM) !=
          cudaSuccess || occ < 1)
    occ = 1;
  const long tiles = (long)g.n_tt * B * g.n_ut, slots = (long)occ * sms;
  long max_s = (V + F_MIN_CHUNK - 1) / F_MIN_CHUNK;
  if (max_s > 16) max_s = 16;
  if (max_s * g.n_ut > 65535) max_s = 65535 / g.n_ut;
  int best = 1;
  double best_cost = 1e30;
  for (long s = 1; s <= max_s; ++s) {
    const double cost = (double)((tiles * s + slots - 1) / slots) / s + 0.01 * s;
    if (cost < best_cost) {
      best_cost = cost;
      best = static_cast<int>(s);
    }
  }
  const int chunk = fwd_vchunk(V, best);
  return (V + chunk - 1) / chunk;
}

// work: splits * B * (T*U1 + T + U1) floats; count: one int (guarded cells);
// *launched: kernels launched.
extern "C" int simple_lattice_fwd(const void* am, const void* lm, const void* lab, void* lpb,
                                  void* lpe, void* logz, void* work, void* count, void* launched,
                                  void* stream, int B, int T, int U1, int V, int blank,
                                  int splits) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* nl = static_cast<int*>(launched);
  *nl = 0;
  const FwdGeom g = fwd_geom(T, U1);
  if (splits < 1 || (long)splits * g.n_ut > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = fwd_prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunk = fwd_vchunk(V, splits);
  const int s = (V + chunk - 1) / chunk;
  const size_t cells = (size_t)B * T * U1;
  float* part = static_cast<float*>(work);
  float* pma = part + (size_t)s * cells;
  float* pml = pma + (size_t)s * B * T;
  dim3 grid(g.n_tt, B, g.n_ut * s);
  fwd_partial_kernel<<<grid, 256, F_SMEM, st>>>(static_cast<const float*>(am),
                                                static_cast<const float*>(lm), part, pma, pml, B,
                                                T, U1, V, g.n_ut, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *nl = 1;
  e = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_combine_kernel<<<static_cast<unsigned>((cells + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(am), static_cast<const float*>(lm), static_cast<const int*>(lab),
      part, pma, pml, static_cast<float*>(lpb), static_cast<float*>(lpe),
      static_cast<float*>(logz), static_cast<int*>(count), B, T, U1, V, s, blank);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *nl = 2;
  return 0;
}

// work: B * (T*U1p + 2T + 3U1) floats, U1p = U+1 rounded up to a multiple
// of 4 (W first: its rows stay 16-byte aligned); iwork: B * (T + U1) ints
// (the guarded cells per row, then per column); *launched: kernels launched.
extern "C" int simple_lattice_bwd(const void* am, const void* lm, const void* lab,
                                  const void* logz, const void* gb, const void* ge, void* dam,
                                  void* dlm, void* work, void* iwork, void* launched,
                                  void* stream, int B, int T, int U1, int V, int blank) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* nl = static_cast<int*>(launched);
  *nl = 0;
  const int U1p = (U1 + 3) / 4 * 4;
  float* Wm = static_cast<float*>(work);
  float* ma2 = Wm + (size_t)B * T * U1p;
  float* ml2 = ma2 + (size_t)B * T;
  float* gbrow = ml2 + (size_t)B * U1;
  float* gbcol = gbrow + (size_t)B * T;
  float* gecol = gbcol + (size_t)B * U1;
  int* rowflag = static_cast<int*>(iwork);
  int* colflag = rowflag + (size_t)B * T;
  const float* fam = static_cast<const float*>(am);
  const float* flm = static_cast<const float*>(lm);
  const float* flz = static_cast<const float*>(logz);
  const float* fgb = static_cast<const float*>(gb);
  const float* fge = static_cast<const float*>(ge);

  const int rows = B * T + B * U1;
  rowmax_kernel<<<(rows + 7) / 8, 256, 0, st>>>(fam, flm, ma2, ml2, B * T, B * U1, V);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *nl = 1;

  const int row_blocks = (B * T + 7) / 8;
  const int col_blocks = B * ((U1 + 31) / 32);
  bwd_prep_kernel<<<row_blocks + col_blocks, 256, 0, st>>>(
      flz, fgb, fge, static_cast<const int*>(lab), ma2, ml2, Wm, gbrow, gbcol, gecol, rowflag,
      colflag, B, T, U1, U1p, blank, row_blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *nl = 2;

  e = cudaFuncSetAttribute(bwd_main_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(B_SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((V + B_VT - 1) / B_VT, B);
  bwd_main_kernel<<<grid, 256, B_SMEM, st>>>(
      fam, flm, static_cast<const int*>(lab), Wm, ma2, ml2, gbrow, gbcol, gecol, fge,
      static_cast<float*>(dam), static_cast<float*>(dlm), T, U1, U1p, V, blank);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *nl = 3;

  bwd_guard_kernel<<<B * (T + U1), 256, 0, st>>>(fam, flm, flz, fgb, fge, ma2, ml2, rowflag,
                                                 colflag, static_cast<float*>(dam),
                                                 static_cast<float*>(dlm), T, U1, V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *nl = 4;
  return 0;
}
