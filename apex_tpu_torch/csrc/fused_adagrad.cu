// Fused Adagrad / AdagradW over flat fp32 buffers for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/fused_opt_kernels.py `fused_adagrad_flat`
// (the Pallas kernel `_adagrad_kernel`), operation for operation:
//   g = g * inv_scale;              (L2 mode: g = g + wd * p)
//   h = h + g * g
//   u = g / (sqrt(h) + eps)         (AdagradW mode: u = u + wd * p)
//   p = p - lr * u
// p and the sum of squares h are updated in place (the TPU kernel's
// donated buffers). The five scalars [lr, eps, wd, inv_scale, noop] come in
// as a float32 buffer on the device, so the loss scale and the overflow
// flag never reach the host. noop != 0 leaves p and h untouched, bit for
// bit.
//
// What bounds it on this card: memory bytes. Per element it reads p, g, h
// and writes p, h (20 bytes) for ~8 flops.
//
// What the design does about that: one grid-stride pass, four elements per
// thread through 16-byte loads and stores when every buffer is 16-byte
// aligned (the flat buffers are), one element at a time otherwise. The
// weight-decay mode is a template parameter chosen at launch. Each step is
// a separate IEEE operation (__fmul_rn / __fadd_rn keep the compiler from
// contracting them into FMAs), so the kernel computes the plain PyTorch
// version's operations in the same order.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace apex_port;

struct AdagradScalars {
  float lr, eps, wd, inv_scale;
};

template <bool kW>
__device__ __forceinline__ void adagrad_one(float& p, float g, float& h,
                                            const AdagradScalars& s) {
  g = __fmul_rn(g, s.inv_scale);
  if (!kW) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  h = __fadd_rn(h, __fmul_rn(g, g));
  float u = __fdiv_rn(g, __fadd_rn(__fsqrt_rn(h), s.eps));
  if (kW) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, u));
}

template <bool kVec, bool kW>
__global__ void __launch_bounds__(kFlatThreads)
fused_adagrad_kernel(float* __restrict__ p, const float* __restrict__ g,
                     float* __restrict__ h, const float* __restrict__ scal,
                     long long n) {
  if (scal[4] != 0.f) return;  // overflow step: nothing changes
  AdagradScalars s;
  s.lr = scal[0];
  s.eps = scal[1];
  s.wd = scal[2];
  s.inv_scale = scal[3];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long j = i; j < n4; j += stride) {
      float4 pp = load4(p, j), hh = load4(h, j);
      const float4 gg = load4(g, j);
      adagrad_one<kW>(pp.x, gg.x, hh.x, s);
      adagrad_one<kW>(pp.y, gg.y, hh.y, s);
      adagrad_one<kW>(pp.z, gg.z, hh.z, s);
      adagrad_one<kW>(pp.w, gg.w, hh.w, s);
      store4(p, j, pp);
      store4(h, j, hh);
    }
    done = n4 * 4;
  }
  for (long long j = done + i; j < n; j += stride) {
    float pp = p[j], hh = h[j];
    adagrad_one<kW>(pp, g[j], hh, s);
    p[j] = pp;
    h[j] = hh;
  }
}

template <bool kVec>
void launch(float* p, const float* g, float* h, const float* scal,
            long long n, int w_mode, cudaStream_t st) {
  const int blocks = flat_blocks(kVec ? (n + 3) / 4 : n);
  if (w_mode)
    fused_adagrad_kernel<kVec, true><<<blocks, kFlatThreads, 0, st>>>(
        p, g, h, scal, n);
  else
    fused_adagrad_kernel<kVec, false><<<blocks, kFlatThreads, 0, st>>>(
        p, g, h, scal, n);
}

}  // namespace

// p, g, h: float32 [n]; scal: float32 [5] on the device; w_mode 1 =
// decoupled weight decay (AdagradW), 0 = L2.
extern "C" int apex_fused_adagrad(void* p, const void* g, void* h,
                                  const void* scal, long long n, int w_mode,
                                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  const float* gf = static_cast<const float*>(g);
  float* hf = static_cast<float*>(h);
  const float* sf = static_cast<const float*>(scal);
  if (is_aligned(pf, 16) && is_aligned(gf, 16) && is_aligned(hf, 16))
    launch<true>(pf, gf, hf, sf, n, w_mode, st);
  else
    launch<false>(pf, gf, hf, sf, n, w_mode, st);
  return (int)cudaGetLastError();
}
