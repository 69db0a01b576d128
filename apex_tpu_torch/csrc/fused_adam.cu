// Fused Adam / AdamW over flat buffers for Hopper (sm_90a): the plain form
// and the master-weight form.
//
// Replaces: apex_tpu/ops/pallas/fused_adam_kernel.py
// - `fused_adam_flat` (the Pallas kernel `_adam_kernel`): p and g float32
//   or bfloat16 (the JAX class keeps a low-precision flat buffer when its
//   parameters are low-precision), m and v float32;
// - `fused_adam_flat_master` (`_master_adam_kernel`): a float32 master p,
//   float32 g, m, v, and the low-precision (bfloat16) copy of the updated
//   master written out in the same pass;
// operation for operation, in fp32 whatever the storage type:
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
// and v untouched, bit for bit; the master form then still writes the copy
// as the cast of the kept master (the TPU kernel writes the cast of the
// selected value), which rewrites the bits the copy already holds.
//
// What bounds it on this card: memory bytes. Per element the plain form
// reads p, g, m, v and writes p, m, v (28 bytes in fp32, 24 with bf16 p
// and g); the master form also writes the 2-byte copy (30 bytes), for ~15
// flops.
//
// What the design does about that: one grid-stride pass, four elements per
// thread through 16-byte accesses (8-byte pairs of bf16) when every buffer
// is aligned to them (the flat buffers are), one element at a time
// otherwise. The mode and the storage type are template parameters chosen
// at launch. Each step is a separate IEEE operation (__fmul_rn / __fadd_rn
// keep the compiler from contracting them into FMAs), so the kernel
// computes the plain PyTorch version's operations in the same order, and
// the bf16 stores round to nearest even as PyTorch's casts do.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace apex_port;

struct AdamScalars {
  float lr, beta1, beta2, eps, wd, bc1, bc2, inv_scale;
  float one_m_beta1, one_m_beta2;
};

__device__ __forceinline__ AdamScalars adam_scalars(const float* scal) {
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
  return s;
}

template <int kMode>
__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, const AdamScalars& s) {
  g = __fmul_rn(g, s.inv_scale);
  if (kMode == 0) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_m_beta1, g));
  v = __fadd_rn(__fmul_rn(s.beta2, v),
                __fmul_rn(__fmul_rn(s.one_m_beta2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (kMode == 1) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, u));
}

template <int kMode>
__device__ __forceinline__ void adam_four(float4& p, const float4& g,
                                          float4& m, float4& v,
                                          const AdamScalars& s) {
  adam_one<kMode>(p.x, g.x, m.x, v.x, s);
  adam_one<kMode>(p.y, g.y, m.y, v.y, s);
  adam_one<kMode>(p.z, g.z, m.z, v.z, s);
  adam_one<kMode>(p.w, g.w, m.w, v.w, s);
}

// T: the storage type of p and g (float or __nv_bfloat16)
template <typename T, bool kVec, int kMode>
__global__ void __launch_bounds__(kFlatThreads)
fused_adam_kernel(T* __restrict__ p, const T* __restrict__ g,
                  float* __restrict__ m, float* __restrict__ v,
                  const float* __restrict__ scal, long long n) {
  if (scal[8] != 0.f) return;  // overflow step: nothing changes
  const AdamScalars s = adam_scalars(scal);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long j = i; j < n4; j += stride) {
      float4 pp = load4(p, j), mm = load4(m, j), vv = load4(v, j);
      adam_four<kMode>(pp, load4(g, j), mm, vv, s);
      store4(p, j, pp);
      store4(m, j, mm);
      store4(v, j, vv);
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) {
    float pp = to_f32(p[j]), mm = m[j], vv = v[j];
    adam_one<kMode>(pp, to_f32(g[j]), mm, vv, s);
    p[j] = from_f32<T>(pp);
    m[j] = mm;
    v[j] = vv;
  }
}

template <bool kVec, int kMode>
__global__ void __launch_bounds__(kFlatThreads)
fused_adam_master_kernel(float* __restrict__ pm, const float* __restrict__ g,
                         float* __restrict__ m, float* __restrict__ v,
                         __nv_bfloat16* __restrict__ p_lp,
                         const float* __restrict__ scal, long long n) {
  const bool noop = scal[8] != 0.f;
  const AdamScalars s = adam_scalars(scal);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long j = i; j < n4; j += stride) {
      float4 pp = load4(pm, j);
      if (!noop) {
        float4 mm = load4(m, j), vv = load4(v, j);
        adam_four<kMode>(pp, load4(g, j), mm, vv, s);
        store4(pm, j, pp);
        store4(m, j, mm);
        store4(v, j, vv);
      }
      store4(p_lp, j, pp);
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) {
    float pp = pm[j];
    if (!noop) {
      float mm = m[j], vv = v[j];
      adam_one<kMode>(pp, g[j], mm, vv, s);
      pm[j] = pp;
      m[j] = mm;
      v[j] = vv;
    }
    p_lp[j] = from_f32<__nv_bfloat16>(pp);
  }
}

template <typename T, bool kVec>
void launch_plain(T* p, const T* g, float* m, float* v, const float* scal,
                  long long n, int mode, cudaStream_t st) {
  const int blocks = flat_blocks(kVec ? (n + 3) / 4 : n);
  if (mode == 0)
    fused_adam_kernel<T, kVec, 0><<<blocks, kFlatThreads, 0, st>>>(
        p, g, m, v, scal, n);
  else
    fused_adam_kernel<T, kVec, 1><<<blocks, kFlatThreads, 0, st>>>(
        p, g, m, v, scal, n);
}

template <typename T>
int fused_adam(void* p, const void* g, void* m, void* v, const void* scal,
               long long n, int mode, cudaStream_t st) {
  T* pt = static_cast<T*>(p);
  const T* gt = static_cast<const T*>(g);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* sf = static_cast<const float*>(scal);
  const unsigned a = 4 * sizeof(T);  // one access of four elements
  if (is_aligned(p, a) && is_aligned(g, a) && is_aligned(m, 16) &&
      is_aligned(v, 16))
    launch_plain<T, true>(pt, gt, mf, vf, sf, n, mode, st);
  else
    launch_plain<T, false>(pt, gt, mf, vf, sf, n, mode, st);
  return (int)cudaGetLastError();
}

template <bool kVec>
void launch_master(float* pm, const float* g, float* m, float* v,
                   __nv_bfloat16* p_lp, const float* scal, long long n,
                   int mode, cudaStream_t st) {
  const int blocks = flat_blocks(kVec ? (n + 3) / 4 : n);
  if (mode == 0)
    fused_adam_master_kernel<kVec, 0><<<blocks, kFlatThreads, 0, st>>>(
        pm, g, m, v, p_lp, scal, n);
  else
    fused_adam_master_kernel<kVec, 1><<<blocks, kFlatThreads, 0, st>>>(
        pm, g, m, v, p_lp, scal, n);
}

}  // namespace

// p, g: [n] of `dtype` (0 = float32, 1 = bfloat16); m, v: float32 [n];
// scal: float32 [9] on the device; mode 0 = Adam with L2 regularisation,
// 1 = AdamW (decoupled weight decay).
extern "C" int apex_fused_adam(void* p, const void* g, void* m, void* v,
                               const void* scal, long long n, int mode,
                               int dtype, void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fused_adam<float>(p, g, m, v, scal, n, mode, st);
  if (dtype == 1)
    return fused_adam<__nv_bfloat16>(p, g, m, v, scal, n, mode, st);
  return (int)cudaErrorInvalidValue;
}

// p_master, g, m, v: float32 [n]; p_lp: bfloat16 [n], written; scal and
// mode as above.
extern "C" int apex_fused_adam_master(void* p_master, const void* g, void* m,
                                      void* v, void* p_lp, const void* scal,
                                      long long n, int mode, void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(p_master);
  const float* gf = static_cast<const float*>(g);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  __nv_bfloat16* lp = static_cast<__nv_bfloat16*>(p_lp);
  const float* sf = static_cast<const float*>(scal);
  if (is_aligned(pm, 16) && is_aligned(gf, 16) && is_aligned(mf, 16) &&
      is_aligned(vf, 16) && is_aligned(lp, 8))
    launch_master<true>(pm, gf, mf, vf, lp, sf, n, mode, st);
  else
    launch_master<false>(pm, gf, mf, vf, lp, sf, n, mode, st);
  return (int)cudaGetLastError();
}
