// Fused NovoGrad over flat fp32 buffers for Hopper (sm_90a): the
// elementwise update with per-tensor denominators.
//
// Replaces: apex_tpu/ops/pallas/fused_opt_kernels.py `fused_novograd_flat`
// (the Pallas kernel `_novograd_kernel`), operation for operation:
//   g = g * inv_scale
//   g = g / denom[tensor of the row]
//   g = g + wd * p
//   m = beta1 * m + beta3 * g
//   p = p - lr * (m / bc1)
// The buffers are viewed as (rows, 128); each row belongs to one tensor of
// the flat layout, and `row_ids` names it (the tail padding rows name the
// extra last entry of `denom`, which is 1). The per-tensor second moments
// and their denominators sqrt(v / bc2) + eps are computed before the launch
// from the scaled gradients' per-row sums of squares, in plain PyTorch, as
// plain XLA computes them in the JAX package; the kernel reads each row's
// denominator through `row_ids` instead of a gathered (rows, 1) column.
// p and m are updated in place (the TPU kernel's donated buffers). The
// seven scalars [lr, beta1, beta3, wd, bc1, inv_scale, noop] come in as a
// float32 buffer on the device. noop != 0 leaves p and m untouched, bit
// for bit.
//
// What bounds it on this card: memory bytes. Per element it reads p, g, m
// and writes p, m (20 bytes) plus 4 bytes of row id per 128 elements, for
// ~8 flops.
//
// What the design does about that: one grid-stride pass of 16-byte loads
// and stores (the buffers are whole rows and 16-byte aligned); a thread's
// four elements lie in one row, so it reads one row id and one
// denominator. Each step is a separate IEEE operation (__fmul_rn /
// __fdiv_rn keep the compiler from contracting or approximating them), so
// the kernel computes the plain PyTorch version's operations in the same
// order.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace apex_port;

constexpr int kLane = 128;  // floats per row

struct NovoScalars {
  float lr, beta1, beta3, wd, bc1, inv_scale;
};

__device__ __forceinline__ void novograd_one(float& p, float g, float& m,
                                             float denom,
                                             const NovoScalars& s) {
  g = __fmul_rn(g, s.inv_scale);
  g = __fdiv_rn(g, denom);
  g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.beta3, g));
  p = __fsub_rn(p, __fmul_rn(s.lr, __fdiv_rn(m, s.bc1)));
}

__global__ void __launch_bounds__(kFlatThreads)
fused_novograd_kernel(float* __restrict__ p, const float* __restrict__ g,
                      float* __restrict__ m, const float* __restrict__ denom,
                      const int* __restrict__ row_ids,
                      const float* __restrict__ scal, long long n4) {
  if (scal[6] != 0.f) return;  // overflow step: nothing changes
  NovoScalars s;
  s.lr = scal[0];
  s.beta1 = scal[1];
  s.beta3 = scal[2];
  s.wd = scal[3];
  s.bc1 = scal[4];
  s.inv_scale = scal[5];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n4; j += stride) {
    const float d = denom[row_ids[j / (kLane / 4)]];
    float4 pp = load4(p, j), mm = load4(m, j);
    const float4 gg = load4(g, j);
    novograd_one(pp.x, gg.x, mm.x, d, s);
    novograd_one(pp.y, gg.y, mm.y, d, s);
    novograd_one(pp.z, gg.z, mm.z, d, s);
    novograd_one(pp.w, gg.w, mm.w, d, s);
    store4(p, j, pp);
    store4(m, j, mm);
  }
}

}  // namespace

// p, g, m: float32 [rows * 128], 16-byte aligned; denom: float32 [T + 1]
// (the last entry, 1, for the padding rows); row_ids: int32 [rows]; scal:
// float32 [7] on the device.
extern "C" int apex_fused_novograd(void* p, const void* g, void* m,
                                   const void* denom, const void* row_ids,
                                   const void* scal, long long rows,
                                   void* stream) {
  if (rows <= 0) return 0;
  if (!(is_aligned(p, 16) && is_aligned(g, 16) && is_aligned(m, 16)))
    return (int)cudaErrorInvalidValue;
  const long long n4 = rows * (kLane / 4);
  fused_novograd_kernel<<<flat_blocks(n4), kFlatThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<const float*>(denom),
      static_cast<const int*>(row_ids), static_cast<const float*>(scal), n4);
  return (int)cudaGetLastError();
}
