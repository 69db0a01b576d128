// Fused Adam / AdamW over flat fp32 buffers for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/fused_adam_kernel.py `fused_adam_flat` (the
// Pallas kernel `_adam_kernel`), operation for operation:
//   g = g * inv_scale;             (L2 mode: g = g + wd * p)
//   m = beta1 * m + (1 - beta1) * g
//   v = beta2 * v + (1 - beta2) * g * g
//   u = (m / bc1) / (sqrt(v / bc2) + eps)   (AdamW mode: u = u + wd * p)
//   p = p - lr * u
// p, m and v are updated in place (the TPU kernel's donated buffers). The
// nine scalars [lr, beta1, beta2, eps, wd, bc1, bc2, inv_scale, noop] come
// in as a float32 buffer on the device, packed as `_pack_scalars` packs
// them, so the step count, the loss scale and the overflow flag never reach
// the host (the TPU kernel's capturable contract). noop != 0 leaves p, m
// and v untouched, bit for bit.
//
// What bounds it on this card: memory bytes. Per element it reads p, g, m,
// v and writes p, m, v (28 bytes) for ~15 flops.
//
// What the design does about that: one grid-stride pass, four elements per
// thread through 16-byte loads and stores when every buffer is 16-byte
// aligned (the flat buffers are), one element at a time otherwise. Each
// step is a separate IEEE operation (__fmul_rn / __fadd_rn keep the
// compiler from contracting them into FMAs), so the kernel computes the
// plain PyTorch version's operations in the same order.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks on each of the 132 SMs

struct AdamScalars {
  float lr, beta1, beta2, eps, wd, bc1, bc2, inv_scale;
  float one_m_beta1, one_m_beta2;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const AdamScalars& s,
                                         int mode) {
  g = __fmul_rn(g, s.inv_scale);
  if (mode == 0) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_m_beta1, g));
  v = __fadd_rn(__fmul_rn(s.beta2, v),
                __fmul_rn(__fmul_rn(s.one_m_beta2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (mode == 1) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, u));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ m, float* __restrict__ v,
                  const float* __restrict__ scal, long long n, int mode) {
  if (scal[8] != 0.f) return;  // overflow step: nothing changes
  AdamScalars s;
  s.lr = scal[0];
  s.beta1 = scal[1];
  s.beta2 = scal[2];
  s.eps = scal[3];
  s.wd = scal[4];
  s.bc1 = scal[5];
  s.bc2 = scal[6];
  s.inv_scale = scal[7];
  s.one_m_beta1 = __fsub_rn(1.f, s.beta1);
  s.one_m_beta2 = __fsub_rn(1.f, s.beta2);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (long long j = i; j < n4; j += stride) {
      float4 pp = p4[j], mm = m4[j], vv = v4[j];
      const float4 gg = g4[j];
      adam_one(pp.x, gg.x, mm.x, vv.x, s, mode);
      adam_one(pp.y, gg.y, mm.y, vv.y, s, mode);
      adam_one(pp.z, gg.z, mm.z, vv.z, s, mode);
      adam_one(pp.w, gg.w, mm.w, vv.w, s, mode);
      p4[j] = pp;
      m4[j] = mm;
      v4[j] = vv;
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) {
    float pp = p[j], mm = m[j], vv = v[j];
    adam_one(pp, g[j], mm, vv, s, mode);
    p[j] = pp;
    m[j] = mm;
    v[j] = vv;
  }
}

}  // namespace

// p, g, m, v: float32 [n]; scal: float32 [9] on the device; mode 0 = Adam
// with L2 regularisation, 1 = AdamW (decoupled weight decay).
extern "C" int apex_fused_adam(void* p, const void* g, void* m, void* v,
                               const void* scal, long long n, int mode,
                               void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<std::uintptr_t>(p) |
                     reinterpret_cast<std::uintptr_t>(g) |
                     reinterpret_cast<std::uintptr_t>(m) |
                     reinterpret_cast<std::uintptr_t>(v)) % 16) == 0;
  const long long work = vec ? (n + 3) / 4 : n;
  const int blocks =
      (int)std::min<long long>((work + kThreads - 1) / kThreads, kMaxBlocks);
  float* pf = static_cast<float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* sf = static_cast<const float*>(scal);
  if (vec)
    fused_adam_kernel<true><<<blocks, kThreads, 0, s>>>(pf, gf, mf, vf, sf, n,
                                                        mode);
  else
    fused_adam_kernel<false><<<blocks, kThreads, 0, s>>>(pf, gf, mf, vf, sf,
                                                         n, mode);
  return (int)cudaGetLastError();
}
