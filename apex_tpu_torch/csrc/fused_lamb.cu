// Fused LAMB over flat fp32 buffers for Hopper (sm_90a): the two stages.
//
// Replaces: apex_tpu/ops/pallas/fused_opt_kernels.py `fused_lamb_flat`, its
// two Pallas kernels, operation for operation:
//   stage 1 (`_lamb_stage1_kernel`), per element:
//     g = g * inv_scale / clip;        (L2 mode: g = g + wd * p)
//     m = beta1 * m + beta3 * g
//     v = beta2 * v + (1 - beta2) * g * g
//     u = (m / bc1) / (sqrt(v / bc2) + eps)   (AdamW mode: u = u + wd * p)
//     noop != 0: u = 0 and m, v keep their bits;
//   stage 2 (`_lamb_stage2_kernel`): p = p - lr * ratio[tensor of row] * u,
//     nothing written when noop != 0.
// The buffers are viewed as (rows, 128); each row belongs to one tensor of
// the flat layout (every tensor starts on a 128-element boundary), so the
// per-tensor norms ||p|| and ||u|| of the trust ratio are sums of per-row
// sums. The ten stage-1 scalars [beta1, beta2, beta3, eps, wd, bc1, bc2,
// clip, inv_scale, noop] and the two stage-2 scalars [lr, noop] come in as
// float32 buffers on the device, so the step count, the global gradient
// norm and the overflow flag never reach the host. The (T,)-sized trust
// ratios between the stages are plain PyTorch, as they are plain XLA in
// the JAX package.
//
// What bounds both on this card: memory bytes. Stage 1 reads p, g, m, v and
// writes u, m, v (28 bytes per element) for ~20 flops; stage 2 reads p, u
// and writes p (12 bytes).
//
// What the design does about that:
// - one warp per 128-float row, each lane one 16-byte load per buffer, rows
//   dealt out warp by warp over a grid-stride loop; stage 2 is a plain
//   grid-stride pass of 16-byte loads and stores;
// - stage 1 also writes each row's sum of squares of p (before the update)
//   and of u, so the norms need no second pass over the 1.34 GB buffers at
//   BERT-large. The row sum is a fixed order: ((a^2 + b^2) + c^2) + d^2 per
//   lane, then a butterfly across the warp. No atomics anywhere: two runs
//   give the same bits, and the plain version repeats the same order;
// - every operation is a separate IEEE operation (__fmul_rn / __fadd_rn
//   keep the compiler from contracting them into FMAs), so the kernels
//   compute the plain PyTorch version's operations in the same order.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each function returns cudaGetLastError() after its launch.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using namespace apex_port;

constexpr int kLane = 128;     // floats per row
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxBlocks = 132 * 16;

struct Stage1 {
  float beta1, beta2, beta3, eps, wd, bc1, bc2, clip, inv_scale;
  float one_m_beta2;
};

__device__ __forceinline__ void lamb_one(float p, float g, float& m,
                                         float& v, float& u,
                                         const Stage1& s, int adam_w) {
  g = __fdiv_rn(__fmul_rn(g, s.inv_scale), s.clip);
  if (!adam_w) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.beta3, g));
  v = __fadd_rn(__fmul_rn(s.beta2, v),
                __fmul_rn(__fmul_rn(s.one_m_beta2, g), g));
  u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (adam_w) u = __fadd_rn(u, __fmul_rn(s.wd, p));
}

// ((a^2 + b^2) + c^2) + d^2, no contraction
__device__ __forceinline__ float sumsq4(const float4& a) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.x, a.x),
                                       __fmul_rn(a.y, a.y)),
                             __fmul_rn(a.z, a.z)),
                   __fmul_rn(a.w, a.w));
}

__global__ void __launch_bounds__(kThreads)
lamb_stage1_kernel(const float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   float* __restrict__ u, float* __restrict__ row_p,
                   float* __restrict__ row_u,
                   const float* __restrict__ scal, long long rows,
                   int adam_w) {
  Stage1 s;
  s.beta1 = scal[0];
  s.beta2 = scal[1];
  s.beta3 = scal[2];
  s.eps = scal[3];
  s.wd = scal[4];
  s.bc1 = scal[5];
  s.bc2 = scal[6];
  s.clip = scal[7];
  s.inv_scale = scal[8];
  s.one_m_beta2 = __fsub_rn(1.f, s.beta2);
  const bool noop = scal[9] != 0.f;
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (kThreads / 32);
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  float4* u4 = reinterpret_cast<float4*>(u);
  for (long long row = (long long)blockIdx.x * (kThreads / 32) +
                       (threadIdx.x >> 5);
       row < rows; row += nwarps) {
    const long long j = row * (kLane / 4) + lane;
    const float4 pp = p4[j];
    float4 uu = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!noop) {
      const float4 gg = g4[j];
      float4 mm = m4[j], vv = v4[j];
      lamb_one(pp.x, gg.x, mm.x, vv.x, uu.x, s, adam_w);
      lamb_one(pp.y, gg.y, mm.y, vv.y, uu.y, s, adam_w);
      lamb_one(pp.z, gg.z, mm.z, vv.z, uu.z, s, adam_w);
      lamb_one(pp.w, gg.w, mm.w, vv.w, uu.w, s, adam_w);
      m4[j] = mm;
      v4[j] = vv;
    }
    u4[j] = uu;
    const float sp = warp_sum(sumsq4(pp));
    const float su = warp_sum(sumsq4(uu));
    if (lane == 0) {
      row_p[row] = sp;
      row_u[row] = su;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lamb_stage2_kernel(float* __restrict__ p, const float* __restrict__ u,
                   const float* __restrict__ ratio,
                   const int* __restrict__ row_ids,
                   const float* __restrict__ scal, long long n4) {
  if (scal[1] != 0.f) return;  // overflow step: p keeps its bits
  const float lr = scal[0];
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* u4 = reinterpret_cast<const float4*>(u);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < n4; j += stride) {
    const float t = __fmul_rn(lr, ratio[row_ids[j / (kLane / 4)]]);
    float4 pp = p4[j];
    const float4 uu = u4[j];
    pp.x = __fsub_rn(pp.x, __fmul_rn(t, uu.x));
    pp.y = __fsub_rn(pp.y, __fmul_rn(t, uu.y));
    pp.z = __fsub_rn(pp.z, __fmul_rn(t, uu.z));
    pp.w = __fsub_rn(pp.w, __fmul_rn(t, uu.w));
    p4[j] = pp;
  }
}

bool aligned16(const void* a) {
  return reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
}

int grid(long long work) {
  return (int)std::max<long long>(
      1, std::min<long long>((work + kThreads - 1) / kThreads, kMaxBlocks));
}

}  // namespace

// p, g, m, v, u: float32 [rows * 128], 16-byte aligned; row_p, row_u:
// float32 [rows]; scal: float32 [10] on the device; adam_w 1 = decoupled
// weight decay, 0 = L2.
extern "C" int apex_lamb_stage1(const void* p, const void* g, void* m,
                                void* v, void* u, void* row_p, void* row_u,
                                const void* scal, long long rows, int adam_w,
                                void* stream) {
  if (rows <= 0) return 0;
  if (!(aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v) &&
        aligned16(u)))
    return (int)cudaErrorInvalidValue;
  lamb_stage1_kernel<<<grid(rows * 32), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), static_cast<float*>(u),
      static_cast<float*>(row_p), static_cast<float*>(row_u),
      static_cast<const float*>(scal), rows, adam_w);
  return (int)cudaGetLastError();
}

// p, u: float32 [rows * 128], 16-byte aligned; ratio: float32 [T + 1] (the
// last entry for padding rows); row_ids: int32 [rows]; scal: float32 [2]
// on the device.
extern "C" int apex_lamb_stage2(void* p, const void* u, const void* ratio,
                                const void* row_ids, const void* scal,
                                long long rows, void* stream) {
  if (rows <= 0) return 0;
  if (!(aligned16(p) && aligned16(u))) return (int)cudaErrorInvalidValue;
  const long long n4 = rows * (kLane / 4);
  lamb_stage2_kernel<<<grid(n4), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(u),
      static_cast<const float*>(ratio), static_cast<const int*>(row_ids),
      static_cast<const float*>(scal), n4);
  return (int)cudaGetLastError();
}
