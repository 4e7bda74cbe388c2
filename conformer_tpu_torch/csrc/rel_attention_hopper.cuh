// Hopper (sm_90a) pieces of the wide bf16 attention kernels, forward
// (rel_flash_attention.cu) and backward (rel_flash_attention_bwd.cu): TMA
// boxes of 64 bf16 columns (128 bytes, 128-byte swizzle) that complete on
// mbarriers, a 4-stage ring of 32 KB stages filled by one producer thread
// and drained by two consumer warpgroups of 64 rows each, and the bf16
// warpgroup products (wgmma m64nNk16, N = 64 or 128, float32 accumulators)
// with A from shared memory (K-major or MN-major) or from registers.
//
// Layouts in a stage (A half, then B half, HALF bytes each):
//  - K-major (a row of the box is 64 depth values): an A half holds 128
//    rows, consumer warpgroup c's 64 at c * ATOM; a product step of 16
//    depth values is +32 bytes.
//  - MN-major (a row of the box is 64 values along M or N, rows run along
//    the depth): 64-wide column blocks `lbo` bytes apart; a product step of
//    16 depth rows is +2048 bytes. Consumer c's A block sits at c * ATOM.
#pragma once

#include "hopper_common.cuh"
#include "rel_attention_common.cuh"

namespace wq {

using rel_attn::bf16;

constexpr int THREADS = 384;             // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMERS = 128;           // threads of one consumer warpgroup
constexpr int REG_PRODUCER = 40, REG_CONSUMER = 232;
constexpr int TQ = 128;                  // query rows of a block (forward, dq)
constexpr int TK = 128;                  // keys of a score tile / of a dkv block
constexpr int TN = 128;                  // output columns of a dS [K | F] tile
constexpr int STAGES = 4;
constexpr uint32_t ATOM = 8192;          // 64 rows x 128 bytes, 128-byte swizzle
constexpr uint32_t HALF = 2 * ATOM;      // a stage's A (128 rows) or B (128 rows / 2 atoms)
constexpr uint32_t STAGE = 2 * HALF;
constexpr size_t SMEM = 1024 + STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);

using hopper::desc;   // K-major operand (128-byte swizzle, 8-row groups 1024 B apart)

// MN-major operand: 64-element column blocks `lbo` bytes apart, 8-row
// groups 1024 B apart along K
__device__ __forceinline__ uint64_t desc_mn(uint32_t a, uint32_t lbo) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) | (kGroup << 32) | (1ull << 62);
}

// keep the compiler from moving reads or writes of these registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WQ_D32                                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),   \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WQ_D64                                                                                 \
  WQ_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),        \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), \
      "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WQ_R32                                                                                \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WQ_R64                                                                                \
  WQ_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
         "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N, float32) = [d +] A (64 x 16) B (16 x N), bf16, N = 64 or 128,
// A and B from shared memory; TA / TB: A / B MN-major (1) or K-major (0).
// The accumulator's element (row, col) of warp w, lane l: row 16 w + l / 4
// (+8 for d[4i+2], d[4i+3]), column 8 i + 2 (l % 4) (+1 for d[4i+1],
// d[4i+3]).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WQ_R64 "}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : WQ_D64
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WQ_R32 "}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : WQ_D32
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// the same with A (64 x 16) from registers: the m16n8k16 A fragment of
// warp w's rows 16 w .. 16 w + 15 (a0: row l / 4, columns 2 (l % 4) and
// +1; a1: row + 8; a2, a3: columns + 8), B from shared memory
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  if constexpr (N == 128)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WQ_R64 "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : WQ_D64
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d), "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WQ_R32 "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WQ_D32
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d), "n"(TB));
}

#undef WQ_D32
#undef WQ_D64
#undef WQ_R32
#undef WQ_R64

// TMA: the box at (c0 inner, c1, c2 outer) of a 3-d `map` into shared memory at dst
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(hopper::saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hopper::saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the ring's barriers: full (the producer's copies, by bytes), empty (the
// threads of the `consumers` warpgroups that read the stages)
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int consumers = 2) {
  for (int i = 0; i < STAGES; ++i) {
    hopper::mbar_init(&full[i], 1);
    hopper::mbar_init(&empty[i], CONSUMERS * consumers);
  }
  hopper::mbar_fence_init();
}

// producer: wait for stage g's slot and arm its barrier for `bytes`
__device__ __forceinline__ unsigned char* claim(unsigned char* ring, uint64_t* full,
                                                uint64_t* empty, int g,
                                                uint32_t bytes = STAGE) {
  const int st = g % STAGES;
  hopper::mbar_wait(&empty[st], ((g / STAGES) & 1) ^ 1);
  hopper::mbar_expect(&full[st], bytes);
  return ring + st * STAGE;
}

// consumer: wait until stage g has arrived; its shared address
__device__ __forceinline__ uint32_t await_stage(unsigned char* ring, uint64_t* full, int g) {
  const int st = g % STAGES;
  hopper::mbar_wait(&full[st], (g / STAGES) & 1);
  return hopper::saddr(ring + st * STAGE);
}

// consumer warpgroup c: acc = (its 64 rows of the stages' A) x (their B)
// over the next n stages of the ring (g counts stages), 4 product steps of
// 16 depth values a stage; TA / TB as wgmma_ss (an MN-major B's column
// blocks ATOM apart). Each stage is released once the products that read
// it are done.
template <int N, int TA, int TB>
__device__ __forceinline__ void ring_products(float (&acc)[N / 2], int n, unsigned char* ring,
                                              uint64_t* full, uint64_t* empty, int& g, int c) {
  int prev = 0;
  fence_regs(acc);
  hopper::wg_fence();
  for (int i = 0; i < n; ++i, ++g) {
    const uint32_t s = await_stage(ring, full, g);
    const uint32_t a = s + c * ATOM, b = s + HALF;
    if (i > 0) hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<N, TA, TB>(acc, TA ? desc_mn(a + kk * 2048, ATOM) : desc(a + kk * 32),
                          TB ? desc_mn(b + kk * 2048, ATOM) : desc(b + kk * 32), (i | kk) != 0);
    hopper::wg_commit();
    if (i > 0) {
      hopper::wg_wait<1>();
      hopper::mbar_arrive(&empty[prev]);
    }
    prev = g % STAGES;
  }
  hopper::wg_wait0();
  fence_regs(acc);
  hopper::mbar_arrive(&empty[prev]);
}

// bytes [b0, b1) of a 16-byte word: is any of them nonzero?
__device__ __forceinline__ bool any_byte(uint4 v, int b0, int b1) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  bool any = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int lo = min(max(b0 - 4 * q, 0), 4), hi = min(max(b1 - 4 * q, 0), 4);
    any |= hi > lo && (w[q] & ((0xFFFFFFFFu >> (32 - 8 * (hi - lo))) << (8 * lo))) != 0u;
  }
  return any;
}

// Which key tiles of TK keys hold a live (query, key) pair of the mask
// [Tq, Tk] at mg for rows [q0, q0 + TQ): live[kt] = 1 or 0, for all kt <
// nkt. Every thread of the block calls it (it ends on a barrier). A row's
// bytes are read as the aligned 16-byte words that hold them, TK / 16 + 1
// at most, the bytes outside the tile masked out (a word that holds one
// byte of the mask lies within the mask's allocation granule); a thread
// ORs its words' verdicts into a bit a tile, 64 tiles a pass, so that its
// loads do not wait on each other.
__device__ __forceinline__ void live_tiles(uint8_t* live, const uint8_t* mg, int q0, int Tq,
                                           int Tk, int nkt) {
  constexpr int NW = TK / 16 + 1, PER = TQ * NW;
  const int tid = threadIdx.x;
  for (int t = tid; t < nkt; t += blockDim.x) live[t] = 0;
  __syncthreads();
  for (int t0 = 0; t0 < nkt; t0 += 64) {
    const int nt = min(nkt - t0, 64);
    uint64_t bits = 0;
#pragma unroll 4
    for (int e = tid; e < nt * PER; e += blockDim.x) {
      const int t = e / PER, f = e - t * PER, r = f / NW, w = f - r * NW;
      const int i = q0 + r, jb = (t0 + t) * TK;
      const int span = min(jb + TK, Tk) - jb;
      if (i < Tq && span > 0) {
        const uintptr_t lo = reinterpret_cast<uintptr_t>(mg + (size_t)i * Tk + jb);
        const uintptr_t a = (lo & ~uintptr_t(15)) + 16 * w, hi = lo + span;
        if (a < hi && any_byte(*reinterpret_cast<const uint4*>(a), lo > a ? (int)(lo - a) : 0,
                               hi - a < 16 ? (int)(hi - a) : 16))
          bits |= 1ull << t;
      }
    }
    for (; bits != 0; bits &= bits - 1) live[t0 + __ffsll((long long)bits) - 1] = 1;
  }
  __syncthreads();
}

// ------------------------------------------------------------- host side

// map of a bf16 tensor [depth][rows][cols] (cols and the strides multiples
// of 8 elements), boxes of 64 columns x box_rows rows x 1, 128-byte
// swizzle; a load reads zeros past any end
inline cudaError_t bf16_map3(CUtensorMap* map, const void* ptr, uint64_t cols, uint64_t rows,
                             uint64_t depth, uint32_t box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = hopper::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  if (cols % 8 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  cuuint64_t dims[3] = {cols, rows, depth};
  cuuint64_t strides[2] = {cols * sizeof(bf16), cols * rows * sizeof(bf16)};
  cuuint32_t box[3] = {64, box_rows, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wq
