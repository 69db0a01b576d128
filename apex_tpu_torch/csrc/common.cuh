// Helpers shared by the port's kernels: fp32 <-> IO-dtype conversion and
// warp reductions. Every kernel computes in fp32 and reads / writes its IO
// dtype (float32, bfloat16, or float16 for the softmax kernels) through
// these.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace apex_port {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
// v rounded through T (the TPU kernels' `x.astype(T)` before a product)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Four consecutive elements j*4 .. j*4+3 as fp32: one 16-byte access for
// float, two 4-byte bf16 pairs for bfloat16 (the pointer aligned to the
// access, which the flat optimizer buffers are).
__device__ __forceinline__ float4 load4(const float* p, long long j) {
  return reinterpret_cast<const float4*>(p)[j];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p,
                                        long long j) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[2 * j]);
  const float2 b = __bfloat1622float2(p2[2 * j + 1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, long long j, float4 v) {
  reinterpret_cast<float4*>(p)[j] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long j,
                                       float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[2 * j] = __floats2bfloat162_rn(v.x, v.y);
  p2[2 * j + 1] = __floats2bfloat162_rn(v.z, v.w);
}

// 16 bytes of bf16 or fp32 (one vector access) as fp32 and back
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack16(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}
__device__ __forceinline__ uint4 pack16(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// Asynchronous copies into shared memory (cp.async): 16 bytes at a time,
// cached in L2 only; where `valid` is false nothing is read and the 16
// bytes are zeroed. A thread's copies are committed in groups, and
// cp_async_wait<kN> returns once at most kN of its groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kN> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kN) : "memory");
}

// The flat optimizer kernels' launch: 256 threads a block, a grid-stride
// loop over `work` items, at most 8 blocks on each of the 132 SMs.
constexpr int kFlatThreads = 256;
inline int flat_blocks(long long work) {
  const long long b = (work + kFlatThreads - 1) / kFlatThreads;
  return (int)(b < 1 ? 1 : (b > 132 * 8 ? 132 * 8 : b));
}
inline bool is_aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
// The sum of v over the block (blockDim.x a multiple of 32, at most 1024
// threads), the warps' sums added in warp order, so every run gives the
// same bits; every thread gets the total. `red` is 32 floats of shared
// memory, free for the next call on return.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // the previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The bf16 flash backward's p = exp(s - lse) (`_bwd_p`), taken as
// 2^(s log2(e) - l2) by the MUFU's ex2 (relative error ~2^-22, far inside
// the bf16 gradients' tolerance; two instructions an element instead of
// expf's eight and the masks' tests): l2 = lse log2(e) of a row (`bwd_lse2`,
// once a row), +inf where the row is masked (lse <= -0.5e30: padded and
// fully masked rows), which gives p = 0. A score s <= -0.5e30 (only a bias
// gives one) differs from any unmasked lse by more than 3e22, so its power
// is 0 as `_bwd_p` has it.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float bwd_lse2(float lse) {
  return lse <= -0.5e30f ? __int_as_float(0x7f800000) : lse * kLog2e;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// p of score s (already scaled, biased) against l2: the power alone
__device__ __forceinline__ float bwd_p2(float s, float l2) {
  return ex2_approx(fmaf(s, kLog2e, -l2));
}

// The flash kernels' flat batch * head index: grid.y and grid.z together
// carry it, since one grid dimension above x holds at most 65535 blocks.
__device__ __forceinline__ long long batch_head() {
  return (long long)blockIdx.z * gridDim.y + blockIdx.y;
}
// grid_y x grid_z covers bh with no z-slice left empty, each dimension
// within the hardware's 65535 (fa_batch_heads_grid in ops/tiling.py)
inline bool bh_grid_ok(int bh, int grid_y, int grid_z) {
  return bh <= 0 ||
         (grid_y >= 1 && grid_y <= 65535 && grid_z >= 1 && grid_z <= 65535 &&
          (long long)grid_y * grid_z >= bh &&
          (long long)grid_y * (grid_z - 1) < bh);
}

// An additive fp32 score bias broadcastable to (batch, head, q, k), read
// through one stride per dimension (0 on a broadcast dimension), so a
// (b, 1, 1, sk) padding mask is never expanded. `p` is null without one.
struct ScoreBias {
  const float* p;
  int heads;                 // h: the flat batch * head index is b * h + h'
  long long sb, sh, sq, sk;  // strides in elements
  // the (batch, head) slice of flat index bh, or null without a bias
  __device__ __forceinline__ const float* slice(long long bh) const {
    return p == nullptr ? nullptr : p + (bh / heads) * sb + (bh % heads) * sh;
  }
  // entry (row, key) of a slice; the caller keeps row < sq, key < sk
  __device__ __forceinline__ float at(const float* s, int row,
                                      int key) const {
    return s[(long long)row * sq + (long long)key * sk];
  }
};

// Attention dropout, the TPU kernels' `_dropout_keep`: a stateless hash of
// (seed, flat batch * head, query row, key) in uint32 arithmetic, kept
// where it reaches `threshold` (min(p * 2^32, 2^32 - 1)), a kept entry
// scaled by `scale` (1 / (1 - p) in fp32). It reads global rows and keys
// only, so every kernel, route and tile size draws one mask, JAX's bit for
// bit, and the backward kernels regenerate the forward's. The int32 seed
// lies in device memory (`seed` null: no dropout), so a per-step seed
// tensor costs the host no sync.
struct Dropout {
  const int* seed;
  unsigned threshold;
  float scale;
  // the hash's (batch * head, seed) term, once a block
  __device__ __forceinline__ uint32_t head(long long bh) const {
    return (uint32_t)bh * 0x85EBCA6Bu ^ (uint32_t)__ldg(seed) * 0x9E3779B9u;
  }
  // the hash's (key, batch * head, seed) term of a key of the slice whose
  // term is `h`
  __device__ __forceinline__ uint32_t key_term(uint32_t h, int key) const {
    return (uint32_t)key * 0xCD9E8D57u ^ h;
  }
  // whether (row, key) is kept, the key's term `kt` (key_term)
  __device__ __forceinline__ bool kept_at(uint32_t kt, int row) const {
    uint32_t x = (uint32_t)row * 0xD2511F53u ^ kt;
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x >= threshold;
  }
  // whether (row, key) of the slice whose term is `h` is kept
  __device__ __forceinline__ bool kept(uint32_t h, int row, int key) const {
    return kept_at(key_term(h, key), row);
  }
  // its keep factor: scale or 0
  __device__ __forceinline__ float keep(uint32_t h, int row, int key) const {
    return kept(h, row, key) ? scale : 0.f;
  }
};

}  // namespace apex_port
