// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/layer_norm_kernel.py `ln_fwd_pallas`
// (the Pallas kernel `_ln_fwd_kernel`, its LayerNorm form with gamma and
// beta): y = (x - mean) * rsqrt(var + eps) * gamma + beta per row, with the statistics kept in fp32 whatever the IO
// dtype, and mean / invvar returned as fp32 (rows, 1) columns.
//
// What bounds it on this card: memory bytes. Each element is read once and
// written once and costs about ten flops, far below the ~295 flops per byte
// at which an H100 stops being limited by its 3.35 TB/s of device memory.
//
// What the design does about that: one warp per row, four rows per block.
// The warp reads its row from device memory exactly once, keeps it in
// shared memory as fp32, and takes the mean, the centred variance
// (the same two-pass mean((x - mu)^2) the TPU kernel computes) and the
// output from there, so device memory sees one read of x, one write of y
// and 8 bytes of statistics per row. Loads and stores are coalesced: lane
// i touches elements i, i + 32, ... of the row. No padding of the row
// count is needed (the TPU kernel padded rows to a multiple of 8); a
// ragged last block simply has idle warps.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ y, float* __restrict__ mean,
                              float* __restrict__ invvar, int rows,
                              int hidden, float eps) {
  extern __shared__ float row_buf[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // no block-wide barrier below
  float* xs = row_buf + (size_t)warp * hidden;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;

  float s = 0.f;
  for (int i = lane; i < hidden; i += 32) {
    const float v = to_f32(xr[i]);
    xs[i] = v;  // each lane reads back only what it wrote: no barrier
    s += v;
  }
  const float inv_h = 1.f / (float)hidden;
  const float mu = warp_sum(s) * inv_h;
  float ss = 0.f;
  for (int i = lane; i < hidden; i += 32) {
    const float c = xs[i] - mu;
    ss += c * c;
  }
  const float rstd = rsqrtf(warp_sum(ss) * inv_h + eps);
  for (int i = lane; i < hidden; i += 32) {
    yr[i] = from_f32<T>((xs[i] - mu) * rstd * gamma[i] + beta[i]);
  }
  if (lane == 0) {
    mean[row] = mu;
    invvar[row] = rstd;
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           void* mean, void* invvar, int rows, int hidden, float eps,
           cudaStream_t stream) {
  const size_t smem = (size_t)kWarpsPerBlock * hidden * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(ln_fwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ln_fwd_kernel<T><<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(invvar), rows, hidden,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y); gamma / beta are float32
// [hidden]. mean / invvar are float32 [rows].
extern "C" int apex_ln_fwd(const void* x, const void* gamma, const void* beta,
                           void* y, void* mean, void* invvar, int rows,
                           int hidden, float eps, int dtype,
                           void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, beta, y, mean, invvar, rows, hidden, eps,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, y, mean, invvar, rows,
                                 hidden, eps, s);
  return (int)cudaErrorInvalidValue;
}
