// Fused SGD (momentum, dampening, Nesterov, weight decay before or after
// the momentum) over flat buffers for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/fused_sgd_kernel.py `fused_sgd_flat` (the
// Pallas kernel `_sgd_kernel`), operation for operation, in fp32 whatever
// the storage type:
//   g = g * inv_scale;              (wd before momentum: g = g + wd * p)
//   b' = first_step ? g : momentum * b + (1 - dampening) * g
//   d = momentum != 0 ? (nesterov ? g + momentum * b' : b') : g
//                                   (wd after momentum: d = d + wd * p)
//   p = p - lr * d;   b = momentum != 0 ? b' : b
// p (float32 or bfloat16, with g of the same type) and the float32
// momentum buffer b are updated in place (the TPU kernel's donated
// buffers); with momentum 0 the buffer keeps its bits. The seven scalars
// [lr, momentum, dampening, wd, inv_scale, noop, first_step] come in as a
// float32 buffer on the device, so the loss scale, the overflow flag and
// the first-step flag never reach the host. noop != 0 leaves p and b
// untouched, bit for bit.
//
// What bounds it on this card: memory bytes. Per element it reads p, g, b
// and writes p, b (20 bytes in fp32) for ~8 flops.
//
// What the design does about that: one grid-stride pass, four elements per
// thread through 16-byte accesses (8-byte pairs of bf16) when every buffer
// is aligned to them, one element at a time otherwise. Nesterov and the
// place of the weight decay are template parameters chosen at launch, not
// branches in the loop. Each step is a separate IEEE operation
// (__fmul_rn / __fadd_rn keep the compiler from contracting them into
// FMAs), so the kernel computes the plain PyTorch version's operations in
// the same order.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace apex_port;

struct SgdScalars {
  float lr, momentum, one_m_dampening, wd, inv_scale;
  bool first, use_momentum;
};

template <bool kNesterov, bool kWdAfter>
__device__ __forceinline__ void sgd_one(float& p, float g, float& b,
                                        const SgdScalars& s) {
  g = __fmul_rn(g, s.inv_scale);
  if (!kWdAfter) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  const float bn = s.first ? g
                           : __fadd_rn(__fmul_rn(s.momentum, b),
                                       __fmul_rn(s.one_m_dampening, g));
  float d;
  if (kNesterov)
    d = s.use_momentum ? __fadd_rn(g, __fmul_rn(s.momentum, bn)) : g;
  else
    d = s.use_momentum ? bn : g;
  if (kWdAfter) d = __fadd_rn(d, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, d));
  if (s.use_momentum) b = bn;
}

template <typename T, bool kVec, bool kNesterov, bool kWdAfter>
__global__ void __launch_bounds__(kFlatThreads)
fused_sgd_kernel(T* __restrict__ p, const T* __restrict__ g,
                 float* __restrict__ buf, const float* __restrict__ scal,
                 long long n) {
  if (scal[5] != 0.f) return;  // overflow step: nothing changes
  SgdScalars s;
  s.lr = scal[0];
  s.momentum = scal[1];
  s.one_m_dampening = __fsub_rn(1.f, scal[2]);
  s.wd = scal[3];
  s.inv_scale = scal[4];
  s.first = scal[6] != 0.f;
  s.use_momentum = s.momentum != 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long j = i; j < n4; j += stride) {
      float4 pp = load4(p, j), bb = load4(buf, j);
      const float4 gg = load4(g, j);
      sgd_one<kNesterov, kWdAfter>(pp.x, gg.x, bb.x, s);
      sgd_one<kNesterov, kWdAfter>(pp.y, gg.y, bb.y, s);
      sgd_one<kNesterov, kWdAfter>(pp.z, gg.z, bb.z, s);
      sgd_one<kNesterov, kWdAfter>(pp.w, gg.w, bb.w, s);
      store4(p, j, pp);
      if (s.use_momentum) store4(buf, j, bb);
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) {
    float pp = to_f32(p[j]), bb = buf[j];
    sgd_one<kNesterov, kWdAfter>(pp, to_f32(g[j]), bb, s);
    p[j] = from_f32<T>(pp);
    buf[j] = bb;
  }
}

template <typename T, bool kVec>
void launch(T* p, const T* g, float* buf, const float* scal, long long n,
            int nesterov, int wd_after, cudaStream_t st) {
  const int blocks = flat_blocks(kVec ? (n + 3) / 4 : n);
  if (nesterov && wd_after)
    fused_sgd_kernel<T, kVec, true, true><<<blocks, kFlatThreads, 0, st>>>(
        p, g, buf, scal, n);
  else if (nesterov)
    fused_sgd_kernel<T, kVec, true, false><<<blocks, kFlatThreads, 0, st>>>(
        p, g, buf, scal, n);
  else if (wd_after)
    fused_sgd_kernel<T, kVec, false, true><<<blocks, kFlatThreads, 0, st>>>(
        p, g, buf, scal, n);
  else
    fused_sgd_kernel<T, kVec, false, false><<<blocks, kFlatThreads, 0, st>>>(
        p, g, buf, scal, n);
}

template <typename T>
int fused_sgd(void* p, const void* g, void* buf, const void* scal,
              long long n, int nesterov, int wd_after, cudaStream_t st) {
  T* pt = static_cast<T*>(p);
  const T* gt = static_cast<const T*>(g);
  float* bf = static_cast<float*>(buf);
  const float* sf = static_cast<const float*>(scal);
  const unsigned a = 4 * sizeof(T);  // one access of four elements
  if (is_aligned(p, a) && is_aligned(g, a) && is_aligned(buf, 16))
    launch<T, true>(pt, gt, bf, sf, n, nesterov, wd_after, st);
  else
    launch<T, false>(pt, gt, bf, sf, n, nesterov, wd_after, st);
  return (int)cudaGetLastError();
}

}  // namespace

// p, g: [n] of `dtype` (0 = float32, 1 = bfloat16); buf: float32 [n]; scal:
// float32 [7] on the device; nesterov and wd_after_momentum 0 or 1.
extern "C" int apex_fused_sgd(void* p, const void* g, void* buf,
                              const void* scal, long long n, int nesterov,
                              int wd_after_momentum, int dtype,
                              void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fused_sgd<float>(p, g, buf, scal, n, nesterov, wd_after_momentum,
                            st);
  if (dtype == 1)
    return fused_sgd<__nv_bfloat16>(p, g, buf, scal, n, nesterov,
                                    wd_after_momentum, st);
  return (int)cudaErrorInvalidValue;
}
