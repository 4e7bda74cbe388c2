// Hopper (sm_90a) pieces shared by the int8 serving kernels (int8_matmul.cu,
// int8_ffn.cu), the simple lattice (simple_lattice.cu) and the joint's wide
// route (joint_lattice.cu): TMA copies of tiles into 128-byte-swizzled
// shared memory that complete on mbarriers, the int8 and tf32 warpgroup
// products (wgmma ... s32.s8.s8, f32.tf32.tf32), the 3xTF32 split, TMA
// stores from shared memory, the named and cluster barriers around them,
// and on the host the tensor maps.
//
// Layout of an operand tile: 8-row groups of 128-byte rows (1024 B,
// 1024-aligned), the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8). Integer wgmma takes
// both operands K-major, so a row holds 128 int8 values along K, one
// product step reads 32 of them (+32 B a step), and the 8-row groups step
// along M (A) or N (B).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace hopper {

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// descriptor of a K-major operand tile at shared address a (128-byte
// swizzle, 8-row groups 1024 B apart)
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) | (kGroup << 16) | (kGroup << 32) |
         (1ull << 62);
}

// byte offset of int8 element (r, k), k < 128, in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int k) {
  return static_cast<uint32_t>(r * 128 + ((((k >> 4) ^ r) & 7) << 4) + (k & 15));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (saddr(p) & 1023)) & 1023);
}

// make generic-proxy writes to shared memory visible to wgmma and TMA
__device__ __forceinline__ void fence_view_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// every thread of the cluster arrives (release), then waits (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
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

// arrive on the mbarrier at `bar`'s offset in the shared memory of cluster
// block `rank`, releasing this thread's writes at cluster scope
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::"r"(saddr(bar)),
      "r"(rank)
      : "memory");
}
// wait for phase `parity` of a local mbarrier that other blocks of the
// cluster arrive on, acquiring their writes
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// make this thread's generic-proxy writes, to any state space, visible to
// the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
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

// TMA: shared memory at src to the box at (c0 inner, c1 outer) of `map`
// (parts past the tensor's ends are not written), in the thread's current
// bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(saddr(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// wait until at most N of this thread's bulk groups are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, int32) = [d +] A (64 x 32 int8) B (32 x 128 int8), both
// K-major; exact. The accumulator's element (row, col) of warp w, lane l:
// row 16 w + l / 4 (+8 for d[4i+2], d[4i+3]), column 8 i + 2 (l % 4) (+1
// for d[4i+1], d[4i+3]).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, int32) = [d +] A (64 x 32 int8) B (32 x 64 int8), as
// wgmma_s8_n128 for 64 columns
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// 3xTF32: x = hi + lo, both rounded to tf32; hi*hi + hi*lo + lo*hi keeps
// float32 accuracy (the dropped lo*lo and lo's rounding are ~2^-22 of x)
__device__ __forceinline__ void split_tf32(float x, float* hi, float* lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  const float hf = __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(x - hf));
  *hi = hf;
  *lo = __uint_as_float(l);
}

// d (64 x 128, float32) [+]= A (64 x 8) B (8 x 128), tf32, both K-major in
// shared memory (rows of 32 floats, 128-byte swizzle: a k-step is +32 B);
// the accumulator's layout as wgmma_s8_n128's
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ------------------------------------------------------------- host side

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no -lcuda
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
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

// map of a row-major matrix [rows][cols] of `elem`-byte elements (the row
// stride a multiple of 16 bytes, as TMA takes it), boxes of 128 bytes x
// box_rows rows, 128-byte swizzle; a load reads zeros past either end, a
// store writes nothing there
inline cudaError_t tile_map(CUtensorMap* map, CUtensorMapDataType type, uint32_t elem,
                            const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  if ((cols * elem) % 16 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return cudaErrorInvalidValue;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {cols * elem};
  cuuint32_t box[2] = {128 / elem, box_rows};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// tile_map of a matrix that outlives the call (a weight), encoded once: a
// map is a function of these arguments alone, not of the data, so an entry
// stays right whatever later lies at its address. Up to 1024 entries (a
// weight each, two a layer and product), then the table starts again.
inline cudaError_t weight_map(CUtensorMap* map, CUtensorMapDataType type, uint32_t elem,
                              const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows) {
  using Key = std::tuple<const void*, int, uint32_t, uint64_t, uint64_t, uint32_t>;
  static std::map<Key, CUtensorMap> maps;
  static std::mutex mu;
  const Key key{ptr, static_cast<int>(type), elem, rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return cudaSuccess;
  }
  cudaError_t err = tile_map(map, type, elem, ptr, rows, cols, box_rows);
  if (err != cudaSuccess) return err;
  if (maps.size() >= 1024) maps.clear();
  maps.emplace(key, *map);
  return cudaSuccess;
}

// an int8 matrix [rows][cols] (cols a multiple of 16) in 128 x 128 boxes
inline cudaError_t int8_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rows, cols, 128);
}

}  // namespace hopper
