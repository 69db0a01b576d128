// Building blocks of the fp32 flash kernels on the FMA pipes
// (flash_attention.cu, flash_attention_bwd.cu): asynchronous copies of
// rows of a (s, d) fp32 matrix (d 64, 128 or 256) into a shared-memory tile
// whose rows are padded to kStride floats (which the split-TF32 forward,
// flash_fwd_tf32.cu, takes too), and the register-blocked
// products over such tiles. A lane's micro-tile holds kMI rows (kRowStep
// apart) by kNJ columns (kColStep apart) of a score, or by 4 d columns of
// an output; every operand is a 16-byte float4 load, and every sum runs in
// order: a score over d = 0..d-1, an output over the tile's rows.

#pragma once

#include "common.cuh"

namespace apex_port {

__device__ __forceinline__ float part(const float4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// 4 bytes by cp.async (cached in L1 too; common.cuh has the 16-byte copy,
// the commit and the wait), zeros where `valid` is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// rows [row0, row0 + kRows) of a (s, kD) fp32 matrix into a kRows x
// kStride tile by asynchronous copies of kThreads threads, zeros past s;
// `vec`: the matrix's base is 16-byte aligned
template <int kRows, int kThreads, int kD, int kStride>
__device__ __forceinline__ void copy_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int s, bool vec) {
  static_assert(kRows * kD % (4 * kThreads) == 0, "whole rounds of copies");
  if (vec) {
#pragma unroll
    for (int n = 0; n < kRows * kD / 4 / kThreads; ++n) {
      const int i = threadIdx.x + n * kThreads;
      const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
      const bool ok = row0 + r < s;
      cp_async16(dst + r * kStride + c,
                 ok ? src + (long long)(row0 + r) * kD + c : src, ok);
    }
  } else {
#pragma unroll 4
    for (int n = 0; n < kRows * kD / kThreads; ++n) {
      const int i = threadIdx.x + n * kThreads;
      const int r = i / kD, c = i % kD;
      const bool ok = row0 + r < s;
      cp_async4(dst + r * kStride + c,
                ok ? src + (long long)(row0 + r) * kD + c : src, ok);
    }
  }
}

// acc[i][j] += a_i . b_j over the kD columns in column order; a_i is row
// kRowStep * i of `a`, b_j row kColStep * j of `b` (both kStride-strided)
template <int kMI, int kRowStep, int kColStep, int kD, int kStride,
          int kUnroll, int kNJ>
__device__ __forceinline__ void score_product(float (&acc)[kMI][kNJ],
                                              const float* a,
                                              const float* b) {
#pragma unroll (kUnroll)
  for (int c = 0; c < kD; c += 4) {
    float4 av[kMI], bv[kNJ];
#pragma unroll
    for (int i = 0; i < kMI; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + kRowStep * i * kStride + c);
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + kColStep * j * kStride + c);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          acc[i][j] = fmaf(part(av[i], t), part(bv[j], t), acc[i][j]);
  }
}

// acc[i][u] += sum over the kN tile rows n, in order, of e_i[n] * f[n][u]:
// e_i is row kRowStep * i of the strip `e` (rows kEStride floats apart),
// f the streamed tile (rows kStride apart) at the thread's 4 columns
template <int kMI, int kRowStep, int kN, int kStride, int kUnroll,
          int kEStride = kStride>
__device__ __forceinline__ void out_product(float (&acc)[kMI][4],
                                            const float* e, const float* f) {
#pragma unroll (kUnroll)
  for (int n = 0; n < kN; n += 4) {
    float4 ev[kMI], fv[4];
#pragma unroll
    for (int i = 0; i < kMI; ++i)
      ev[i] =
          *reinterpret_cast<const float4*>(e + kRowStep * i * kEStride + n);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      fv[t] = *reinterpret_cast<const float4*>(f + (n + t) * kStride);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[i][u] = fmaf(part(ev[i], t), part(fv[t], u), acc[i][u]);
  }
}

template <int kMI, int kNJ>
__device__ __forceinline__ void zero(float (&a)[kMI][kNJ]) {
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) a[i][j] = 0.f;
}

// rows r0 + kRowStep * i (< s) of a (s, kD) matrix at the thread's 4
// columns c0 .. c0 + 3
template <int kMI, int kRowStep, int kD>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[kMI][4], int r0,
                                           int c0, int s, bool vec) {
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int row = r0 + kRowStep * i;
    if (row >= s) continue;
    float* p = dst + (long long)row * kD + c0;
    if (vec) {
      *reinterpret_cast<float4*>(p) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] = acc[i][u];
    }
  }
}

}  // namespace apex_port
