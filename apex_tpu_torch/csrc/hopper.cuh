// Hopper (sm_90a) building blocks of the tensor-core kernels and the
// peer puts, as inline PTX: TMA tensor maps and loads, bulk copies of
// contiguous bytes, mbarriers, proxy fences, the wgmma shared-memory
// descriptor, the m64n64k16 / m64n32k16 / m64n128k16 / m64n256k16 bf16
// products with fp32 sums, and a named barrier.
//
// Tiles are rows of 64 bf16 (128 bytes) brought into shared memory by TMA
// with the 128-byte swizzle, the widest row a swizzled box may have; a
// row of head dim d (64, 128 or 256) arrives as d / 64 such boxes, columns
// 0..63, 64..127, ..., each its own run of 128-byte rows (a "chunk" of the
// tile, chunk c lying c x `rows` x 128 bytes after the first). Every chunk
// starts on a 1024-byte boundary, so one descriptor form serves all of
// them:
// - K-major operand (the product's depth, d, runs along the row): 8-row
//   groups 1024 bytes apart (SBO), the next 16 columns of depth 32 bytes
//   further in the start address; every fourth step of 16 moves on to the
//   next chunk;
// - MN-major operand (rows are the depth, the 64 columns the product's N):
//   one 128-byte swizzle atom across N, 8-row depth groups 1024 bytes
//   apart (SBO), the next 16 rows of depth 2048 bytes further. An N of
//   128 (two chunks) is one product whose descriptor steps from the first
//   chunk's atom to the second's by the chunk stride (LBO); a wider N is
//   several such products, one on each pair of chunks (or N = 64 products,
//   one on each chunk).
// The accumulator of a warpgroup's m64nN product (N / 2 fp32 a thread):
// warp w holds rows 16w + lane/4 and 16w + lane/4 + 8; element 4j + {0, 1}
// is the first row at columns 8j + (lane % 4) * 2 + {0, 1}, 4j + {2, 3} the
// second row at the same columns. Packed to bf16 pairs, the fragment of columns
// 16kk..16kk+15 is the A operand of a register-sourced product of depth
// 16 as it stands (elements 8kk .. 8kk + 7).

#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (no libcuda link)
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace apex_port {
namespace hopper {

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library needs no -lcuda; null where the entry point is missing
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                         12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 (bh, s, d) tensor, d a multiple of 64,
// dimensions (d, s, bh) innermost first, box (64, rows, 1): a 64-column
// chunk of `rows` rows (tma_load_rows loads every chunk), 128-byte swizzle.
// Rows past s of one (b * h) slice arrive as zeros, never as the next
// slice's rows. The base must be 16-byte aligned (the wrapper checks).
// False on failure.
inline bool make_map_bf16(CUtensorMap* map, const void* base, int s,
                          int bh, int rows, int d) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || s < 1 || bh < 1 || d % 64 != 0) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------- device side

// A stamp of a tile's phase: nothing in the port's build;
// tools/flash_bwd_split.py defines it in a copy of a kernel to read the
// SM's clock there (slot `slot` of tile `tile`, a phase named `phase`)
#ifndef APEX_SPLIT
#define APEX_SPLIT(slot, tile, phase)
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// the inits visible to the other threads and to the TMA unit
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Wait for the completion of the phase of parity `parity`. Bounded: past
// limit_ns (by default kWaitLimitNs, far beyond any tile's load, time
// slices of other processes included) the block traps, so a pipeline
// fault is a CUDA error on the stream, never a hung card.
constexpr uint64_t kWaitLimitNs = 20ull * 1000 * 1000 * 1000;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity,
                                          uint64_t limit_ns = kWaitLimitNs) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(a, parity))
    if (globaltimer() - t0 > limit_ns) __trap();
}

// The same wait, ending a stalled pipeline with a store to address 0 (an
// illegal-address error on the stream, as sticky as a trap) instead of a
// trap: ptxas gives a warpgroup the registers of its setmaxnreg.inc above
// the launch bound's only in a kernel without a trap instruction (with one,
// the tensor-core kernels' consumers kept the launch bound's 168, spilling
// at d = 128 and 256). Every tensor-core flash kernel waits with it.
__device__ __forceinline__ void mbar_wait_nt(uint64_t* bar, uint32_t parity,
                                             uint64_t limit_ns = kWaitLimitNs) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(a, parity))
    if (globaltimer() - t0 > limit_ns)
      asm volatile("st.global.u32 [%0], %1;" ::"l"(0ull), "r"(0u) : "memory");
}

// TMA: box at coordinates (c0, c1, c2) of `map` into shared memory at
// `dst`; completion counts on `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// rows [row, row + rows) of (b * h) slice bh of a map of head dim kD into
// shared memory at `dst`, a 64-column chunk after another (chunk h at dst +
// h * rows * 128); completion on `bar`, kD * rows * 2 bytes in all
template <int kD>
__device__ __forceinline__ void tma_load_rows(void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int rows,
                                              int row, int bh) {
#pragma unroll
  for (int h = 0; h < kD / 64; ++h)
    tma_load_3d(static_cast<uint8_t*>(dst) + h * rows * 128, map, bar,
                64 * h, row, bh);
}

// Bulk copies of contiguous bytes (the TMA's untiled form): both
// addresses and the size multiples of 16. A load into shared memory
// counts on `bar`'s transaction bytes; a store to global memory joins the
// issuing thread's open bulk group.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Until at most kN of this thread's bulk groups are pending: with `.read`
// until the others' shared-memory sources are read (the stage may be
// refilled), without it until their writes are complete.
template <int kN> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kN) : "memory");
}
template <int kN> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(kN) : "memory");
}
// Order this thread's generic-proxy accesses (plain loads and stores,
// flags) against its async-proxy ones (bulk copies), in global or in
// shared memory.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// warpgroup register budgets: the producer gives registers back, the
// consumers take them (a block of three warpgroups launched at 168)
template <int kRegs> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// Named barrier `id` (1 .. 15; 0 is __syncthreads') completing once
// `threads` threads (a multiple of 32) have arrived: bar_sync arrives and
// waits, bar_arrive arrives without waiting (a producer's side; the
// memory accesses before it are seen by the threads its completion
// releases)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`
// (see the header), layout SWIZZLE_128B. SBO, the stride of 8-row groups,
// is 1024 bytes. LBO is the stride between 64-column atoms of an MN-major
// operand (`lbo`: a product of N = 128 reads two chunks of the tile), not
// read at N = 64 nor for a K-major operand, where it is left at the same
// 1024 bytes, so either reading of the two fields meets the tile as it
// lies.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo = 1024) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int kN> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kN) : "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int kSteps>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[kSteps][4]) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define APEX_WGMMA_D32                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}"
#define APEX_WGMMA_D16                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define APEX_WGMMA_OUT16(d)                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define APEX_WGMMA_OUT32(d)                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define APEX_WGMMA_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define APEX_WGMMA_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define APEX_WGMMA_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"
#define APEX_WGMMA_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (+)= A B, m64n64k16, bf16 in, fp32 sums; A and B from shared memory,
// both K-major. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " APEX_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : APEX_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// the same at m64n32k16 (d: 16 fp32 a thread)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " APEX_WGMMA_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}"
      : APEX_WGMMA_OUT16(d)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d += A B, m64n64k16; A from registers (four bf16 pairs a thread, the
// accumulator layout packed), B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " APEX_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : APEX_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// the same at m64n128k16 (d: 64 fp32 a thread): B's 128 columns two
// 64-column atoms, the second LBO bytes after the first (desc_sw128's lbo)
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " APEX_WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : APEX_WGMMA_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// the same at m64n256k16 (d: 128 fp32 a thread): B's 256 columns four
// 64-column atoms, each LBO bytes after the one before
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " APEX_WGMMA_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"
      : APEX_WGMMA_OUT128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef APEX_WGMMA_D128
#undef APEX_WGMMA_OUT128
#undef APEX_WGMMA_D64
#undef APEX_WGMMA_OUT64
#undef APEX_WGMMA_D16
#undef APEX_WGMMA_OUT16
#undef APEX_WGMMA_D32
#undef APEX_WGMMA_OUT32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 64 x N S = A Bᵀ of one warpgroup over depth kD (64, 128 or 256), N
// 64 (d of 32 fp32) or 32 (16): K-major steps of 16, A and B tiles at
// shared addresses a and b, whose 64-column chunks lie a_chunk and b_chunk
// bytes apart. kFresh (N = 64): each step's descriptors are formed here
// from the two base descriptors (a step's offset added to the address
// field, which no shared address carries past its 14 bits), and the bases
// pass through an empty asm, so the compiler cannot hoist a resident
// tile's kD / 16 descriptors out of a kernel's tile loop and hold them in
// registers.
template <int kD, bool kFresh = false, int kN>
__device__ __forceinline__ void product_ss(float (&d)[kN], uint32_t a,
                                           uint32_t a_chunk, uint32_t b,
                                           uint32_t b_chunk) {
  if constexpr (kFresh) {
    uint64_t da = desc_sw128(a), db = desc_sw128(b);
    asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(d, da + (((kk / 4) * a_chunk + (kk % 4) * 32) >> 4),
               db + (((kk / 4) * b_chunk + (kk % 4) * 32) >> 4), kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(d, desc_sw128(a + (kk / 4) * a_chunk + (kk % 4) * 32),
               desc_sw128(b + (kk / 4) * b_chunk + (kk % 4) * 32), kk > 0);
  }
}
// d += P B over depth 16 kSteps (64 or 32): P from registers (p[kk] the
// columns 16kk..+15), B an MN-major tile at shared address b (16 rows of
// depth a step), its 64 columns of N one chunk of the tile
template <int kSteps>
__device__ __forceinline__ void product_rs(float (&d)[32],
                                           const uint32_t (&p)[kSteps][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_rs_bt(d, p[kk], desc_sw128(b + kk * 2048));
}
// the same with the chunk stride of a wider N (below), unused at N = 64
template <int kSteps>
__device__ __forceinline__ void product_rs(float (&d)[32],
                                           const uint32_t (&p)[kSteps][4],
                                           uint32_t b, uint32_t) {
  product_rs(d, p, b);
}
// d += P B at N = 128 (d of 64 fp32): B an MN-major tile whose two 64-column
// chunks lie b_chunk bytes apart, one product a step of depth instead of one
// on each chunk
template <int kSteps>
__device__ __forceinline__ void product_rs(float (&d)[64],
                                           const uint32_t (&p)[kSteps][4],
                                           uint32_t b, uint32_t b_chunk) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_rs_bt(d, p[kk], desc_sw128(b + kk * 2048, b_chunk));
}
// the same at N = 256 (d of 128 fp32): B's four 64-column chunks b_chunk
// bytes apart
template <int kSteps>
__device__ __forceinline__ void product_rs(float (&d)[128],
                                           const uint32_t (&p)[kSteps][4],
                                           uint32_t b, uint32_t b_chunk) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_rs_bt(d, p[kk], desc_sw128(b + kk * 2048, b_chunk));
}
// an accumulator of N columns packed to the A operand of a product of
// depth N
template <int kN>
__device__ __forceinline__ void to_a_operand(const float (&d)[kN],
                                             uint32_t (&p)[kN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kN / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

}  // namespace hopper
}  // namespace apex_port
