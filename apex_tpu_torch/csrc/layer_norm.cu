// Row LayerNorm / RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/layer_norm_kernel.py `ln_fwd_pallas` (the
// Pallas kernel `_ln_fwd_kernel`) and `ln_bwd_pallas` (`_ln_bwd_kernel`),
// their LayerNorm and RMSNorm forms (x saved), with or without gamma:
//   forward  LayerNorm: y = (x - mean) * rsqrt(var + eps) * gamma (+ beta),
//            RMSNorm: y = x * rsqrt(mean(x^2) + eps) * gamma, mean written
//            as 0; statistics in fp32 whatever the IO dtype, mean / invvar
//            returned as fp32 (rows, 1) columns;
//   backward xhat = (x - mean) * rstd (RMSNorm: x * rstd), wdy = dy * gamma,
//            dx = (wdy - xhat * mean(xhat * wdy) - mean(wdy)) * rstd, the
//            mean(wdy) term only for LayerNorm, dgamma = sum over rows of
//            dy * xhat, dbeta = sum of dy.
// A null beta means zero (the forward adds nothing, the backward writes no
// dbeta). A null gamma means no affine step: y = xhat, wdy = dy, and the
// backward writes neither dgamma nor dbeta and skips its reduce launch.
//
// What bounds both on this card: memory bytes. Each element is read once
// (twice, x and dy, in the backward) and written once and costs about ten
// flops, far below the ~295 flops per byte at which an H100 stops being
// limited by its 3.35 TB/s of device memory.
//
// What the design does about that:
// - forward: one warp per row, four rows per block. The warp reads its row
//   from device memory exactly once, keeps it in shared memory as fp32, and
//   takes the mean, the centred variance (the same two-pass mean((x - mu)^2)
//   the TPU kernel computes) and the output from there. Loads and stores are
//   coalesced: lane i touches elements i, i + 32, ... of the row.
// - backward: one warp per row as well; the warp stages xhat and dy of its
//   row in shared memory, so x and dy are read from device memory once and
//   dx written once. dgamma / dbeta are the TPU grid's sequential
//   accumulator; blocks on Hopper run in parallel, so each warp keeps
//   running fp32 sums for its columns in shared memory, the block adds its
//   warps' sums in warp order into one row of a (blocks, hidden) partial
//   buffer, and a second small launch adds the partial rows in a fixed
//   order. No float atomics: the result has the same bits on every run.
// - rows wider than kSmemMaxHidden (8192) do not fit four to a block in
//   shared memory. Their forms stage nothing and take any width up to
//   kMaxHidden (the int column index): one block of kWideWarps warps per
//   row (forward) or per strided set of rows (backward). The forward reads
//   the row three times, for the mean, the centred variance and the
//   output, the backward x and dy twice; every read after the first is
//   served by L2 while the rows in flight fit there. The backward keeps its
//   running dgamma / dbeta sums in its own row of the partial buffer in
//   device memory, each column owned by one thread, so the reduce launch
//   and the bits stay as in the shared-memory form.
// No padding of the row count is needed (the TPU kernel padded rows to a
// multiple of 8); a ragged last block simply has idle warps.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each function returns cudaGetLastError() after its launches.

#include "common.cuh"

namespace {

using namespace apex_port;

constexpr int kFwdWarps = 4;
constexpr int kSmemMaxHidden = 8192;  // LN_SMEM_MAX_HIDDEN in ops/tiling.py
constexpr int kMaxHidden = 1 << 30;   // LN_MAX_HIDDEN
constexpr int kWideWarps = 16;        // LN_WIDE_WARPS
constexpr int kReduceCols = 32;  // columns per block of the partial sum
constexpr int kReduceRows = 8;   // partial rows summed side by side

// kRms: RMSNorm (no centring); kAffine: gamma (and an optional beta). Each
// form is its own instantiation, so the LayerNorm form carries no branch
// of the others.
template <typename T, bool kRms, bool kAffine>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ y, float* __restrict__ mean,
                              float* __restrict__ invvar, int rows,
                              int hidden, float eps) {
  extern __shared__ float row_buf[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kFwdWarps + warp;
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
  // RMSNorm centres on 0: the second pass then sums x^2
  const float mu = kRms ? 0.f : warp_sum(s) * inv_h;
  float ss = 0.f;
  for (int i = lane; i < hidden; i += 32) {
    const float c = xs[i] - mu;
    ss += c * c;
  }
  const float rstd = rsqrtf(warp_sum(ss) * inv_h + eps);
  for (int i = lane; i < hidden; i += 32) {
    const float xhat = (xs[i] - mu) * rstd;
    if (!kAffine) {
      yr[i] = from_f32<T>(xhat);
    } else {
      const float b = beta != nullptr ? beta[i] : 0.f;
      yr[i] = from_f32<T>(xhat * gamma[i] + b);
    }
  }
  if (lane == 0) {
    mean[row] = mu;
    invvar[row] = rstd;
  }
}

// The forward for a row wider than kSmemMaxHidden: one block per row, the
// same mean, centred variance and output as ln_fwd_kernel, each a pass over
// the row in device memory (the later passes mostly from L2).
template <typename T, bool kRms, bool kAffine>
__global__ void __launch_bounds__(kWideWarps * 32)
ln_fwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y,
                   float* __restrict__ mean, float* __restrict__ invvar,
                   int hidden, float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;
  const float inv_h = 1.f / (float)hidden;
  float mu = 0.f;
  if (!kRms) {
    float s = 0.f;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) s += to_f32(xr[i]);
    mu = block_sum(s, red) * inv_h;
  }
  float ss = 0.f;
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float c = to_f32(xr[i]) - mu;
    ss += c * c;
  }
  const float rstd = rsqrtf(block_sum(ss, red) * inv_h + eps);
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    const float xhat = (to_f32(xr[i]) - mu) * rstd;
    if (!kAffine) {
      yr[i] = from_f32<T>(xhat);
    } else {
      const float b = beta != nullptr ? beta[i] : 0.f;
      yr[i] = from_f32<T>(xhat * gamma[i] + b);
    }
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    invvar[row] = rstd;
  }
}

// Shared memory per warp: xhat, dy, and the running dgamma / dbeta sums of
// the rows the warp has done, each `hidden` floats. kRms drops the mean
// (read as 0) and the mean(wdy) term; without kAffine (no gamma, null
// part_g) wdy = dy and no sums are kept.
template <typename T, bool kRms, bool kAffine>
__global__ void ln_bwd_kernel(const T* __restrict__ dy,
                              const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ mean,
                              const float* __restrict__ invvar,
                              T* __restrict__ dx, float* __restrict__ part_g,
                              float* __restrict__ part_b, int rows,
                              int hidden) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* xh = smem + (size_t)warp * 4 * hidden;
  float* dys = xh + hidden;
  float* acc_g = dys + hidden;
  float* acc_b = acc_g + hidden;
  for (int i = lane; i < hidden; i += 32) {
    acc_g[i] = 0.f;
    acc_b[i] = 0.f;
  }
  const float fh = (float)hidden;
  const long long stride = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + warp; row < rows;
       row += stride) {
    const T* dyr = dy + row * hidden;
    const T* xr = x + row * hidden;
    const float mu = kRms ? 0.f : mean[row];
    const float rstd = invvar[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int i = lane; i < hidden; i += 32) {
      const float d = to_f32(dyr[i]);
      const float xhat = (to_f32(xr[i]) - mu) * rstd;
      const float wdy = kAffine ? d * gamma[i] : d;
      xh[i] = xhat;  // each lane reads back only what it wrote
      dys[i] = d;
      s1 += xhat * wdy;
      s2 += wdy;
      if (kAffine) {
        acc_g[i] += d * xhat;
        acc_b[i] += d;
      }
    }
    const float c1 = warp_sum(s1) / fh;
    const float c2 = kRms ? 0.f : warp_sum(s2) / fh;
    T* dxr = dx + row * hidden;
#pragma unroll 4
    for (int i = lane; i < hidden; i += 32) {
      const float wdy = kAffine ? dys[i] * gamma[i] : dys[i];
      dxr[i] = from_f32<T>((wdy - xh[i] * c1 - c2) * rstd);
    }
  }
  if (!kAffine) return;  // no affine step: no dgamma / dbeta
  __syncthreads();
  // this block's partial row: its warps' sums added in warp order
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    float g = 0.f, b = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float* base = smem + (size_t)w * 4 * hidden;
      g += base[2 * hidden + i];
      b += base[3 * hidden + i];
    }
    part_g[(size_t)blockIdx.x * hidden + i] = g;
    if (part_b != nullptr) part_b[(size_t)blockIdx.x * hidden + i] = b;
  }
}

// The backward for a row wider than kSmemMaxHidden: block b takes rows b,
// b + gridDim.x, ...; per row one pass for the two row sums and the dgamma
// / dbeta terms, one for dx. Column i is always thread i % blockDim.x's, so
// the block's running sums live in its partial row (part_g[b], part_b[b])
// without a race.
template <typename T, bool kRms, bool kAffine>
__global__ void __launch_bounds__(kWideWarps * 32)
ln_bwd_wide_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ mean,
                   const float* __restrict__ invvar, T* __restrict__ dx,
                   float* __restrict__ part_g, float* __restrict__ part_b,
                   int rows, int hidden) {
  __shared__ float red[32];
  float* pg = kAffine ? part_g + (size_t)blockIdx.x * hidden : nullptr;
  float* pb = (kAffine && part_b != nullptr)
                  ? part_b + (size_t)blockIdx.x * hidden : nullptr;
  if (kAffine) {
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      pg[i] = 0.f;
      if (pb != nullptr) pb[i] = 0.f;
    }
  }
  const float fh = (float)hidden;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* dyr = dy + row * hidden;
    const T* xr = x + row * hidden;
    const float mu = kRms ? 0.f : mean[row];
    const float rstd = invvar[row];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float d = to_f32(dyr[i]);
      const float xhat = (to_f32(xr[i]) - mu) * rstd;
      const float wdy = kAffine ? d * gamma[i] : d;
      s1 += xhat * wdy;
      s2 += wdy;
      if (kAffine) {
        pg[i] += d * xhat;
        if (pb != nullptr) pb[i] += d;
      }
    }
    const float c1 = block_sum(s1, red) / fh;
    const float c2 = kRms ? 0.f : block_sum(s2, red) / fh;
    T* dxr = dx + row * hidden;
    for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
      const float d = to_f32(dyr[i]);
      const float xhat = (to_f32(xr[i]) - mu) * rstd;
      const float wdy = kAffine ? d * gamma[i] : d;
      dxr[i] = from_f32<T>((wdy - xhat * c1 - c2) * rstd);
    }
  }
}

// dgamma[c] = sum over partial rows k of part_g[k][c]: thread (c, y) adds
// rows y, y + 8, ... in order, then the 8 sums are added in y order.
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ part_g,
                                     const float* __restrict__ part_b,
                                     float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int nblk,
                                     int hidden) {
  __shared__ float sg[kReduceRows][kReduceCols + 1];
  __shared__ float sb[kReduceRows][kReduceCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kReduceCols + tx;
  float g = 0.f, b = 0.f;
  if (col < hidden) {
    for (int k = ty; k < nblk; k += kReduceRows) {
      g += part_g[(size_t)k * hidden + col];
      if (part_b != nullptr) b += part_b[(size_t)k * hidden + col];
    }
  }
  sg[ty][tx] = g;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && col < hidden) {
    float tg = 0.f, tb = 0.f;
    for (int k = 0; k < kReduceRows; ++k) {
      tg += sg[k][tx];
      tb += sb[k][tx];
    }
    dgamma[col] = tg;
    if (dbeta != nullptr) dbeta[col] = tb;
  }
}

template <typename T>
int launch_fwd(const void* x, const void* gamma, const void* beta, void* y,
               void* mean, void* invvar, int rows, int hidden, float eps,
               int rms, cudaStream_t stream) {
  const bool affine = gamma != nullptr;
  if (hidden > kSmemMaxHidden) {
    const auto wide =
        rms ? (affine ? ln_fwd_wide_kernel<T, true, true>
                      : ln_fwd_wide_kernel<T, true, false>)
            : (affine ? ln_fwd_wide_kernel<T, false, true>
                      : ln_fwd_wide_kernel<T, false, false>);
    wide<<<rows, kWideWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(invvar), hidden, eps);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)kFwdWarps * hidden * sizeof(float);
  const auto kernel =
      rms ? (affine ? ln_fwd_kernel<T, true, true>
                    : ln_fwd_kernel<T, true, false>)
          : (affine ? ln_fwd_kernel<T, false, true>
                    : ln_fwd_kernel<T, false, false>);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const int blocks = (rows + kFwdWarps - 1) / kFwdWarps;
  kernel<<<blocks, kFwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(invvar), rows, hidden,
      eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* dy, const void* x, const void* gamma,
               const void* mean, const void* invvar, void* dx, void* part_g,
               void* part_b, void* dgamma, void* dbeta, int rows, int hidden,
               int warps, int nblk, int rms, cudaStream_t stream) {
  const bool affine = gamma != nullptr;
  const bool wide = hidden > kSmemMaxHidden;
  const size_t smem = wide ? 0 : (size_t)warps * 4 * hidden * sizeof(float);
  const auto kernel =
      wide ? (rms ? (affine ? ln_bwd_wide_kernel<T, true, true>
                            : ln_bwd_wide_kernel<T, true, false>)
                  : (affine ? ln_bwd_wide_kernel<T, false, true>
                            : ln_bwd_wide_kernel<T, false, false>))
           : (rms ? (affine ? ln_bwd_kernel<T, true, true>
                            : ln_bwd_kernel<T, true, false>)
                  : (affine ? ln_bwd_kernel<T, false, true>
                            : ln_bwd_kernel<T, false, false>));
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  kernel<<<nblk, warps * 32, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(mean),
      static_cast<const float*>(invvar), static_cast<T*>(dx),
      static_cast<float*>(part_g), static_cast<float*>(part_b), rows,
      hidden);
  int err = (int)cudaGetLastError();
  if (err != 0 || part_g == nullptr) return err;
  const dim3 grid((hidden + kReduceCols - 1) / kReduceCols);
  ln_bwd_reduce_kernel<<<grid, dim3(kReduceCols, kReduceRows), 0, stream>>>(
      static_cast<const float*>(part_g), static_cast<const float*>(part_b),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta), nblk, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y); gamma / beta are float32
// [hidden], both may be null (beta is only read with gamma). mean / invvar
// are float32 [rows]. rms: 1 = RMSNorm (mean written as 0), 0 = LayerNorm.
// hidden: 1 .. kMaxHidden.
extern "C" int apex_ln_fwd(const void* x, const void* gamma, const void* beta,
                           void* y, void* mean, void* invvar, int rows,
                           int hidden, float eps, int rms, int dtype,
                           void* stream) {
  if (hidden < 1 || hidden > kMaxHidden) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, gamma, beta, y, mean, invvar, rows, hidden,
                             eps, rms, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, gamma, beta, y, mean, invvar, rows,
                                     hidden, eps, rms, s);
  return (int)cudaErrorInvalidValue;
}

// dtype as above for dy, x and dx. part_g / part_b: float32 scratch of
// [nblk, hidden]; dgamma / dbeta: float32 [hidden]. part_b and dbeta are
// null together when the forward had no beta; gamma, part_g and dgamma are
// null together (and then part_b and dbeta too) when it had no gamma. mean
// is not read (and may be null) when rms = 1. `warps` warps per block,
// `nblk` blocks (rows are dealt out warp by warp over the whole grid; above
// kSmemMaxHidden block by block, with kWideWarps warps, ln_bwd_geometry in
// ops/tiling.py).
extern "C" int apex_ln_bwd(const void* dy, const void* x, const void* gamma,
                           const void* mean, const void* invvar, void* dx,
                           void* part_g, void* part_b, void* dgamma,
                           void* dbeta, int rows, int hidden, int warps,
                           int nblk, int rms, int dtype, void* stream) {
  if (warps < 1 || warps > 32 || nblk < 1 || hidden < 1 ||
      hidden > kMaxHidden || (hidden > kSmemMaxHidden && warps != kWideWarps))
    return (int)cudaErrorInvalidValue;
  if ((gamma == nullptr) != (part_g == nullptr) ||
      (part_g == nullptr && part_b != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(dy, x, gamma, mean, invvar, dx, part_g, part_b,
                             dgamma, dbeta, rows, hidden, warps, nblk, rms,
                             s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(dy, x, gamma, mean, invvar, dx, part_g,
                                     part_b, dgamma, dbeta, rows, hidden,
                                     warps, nblk, rms, s);
  return (int)cudaErrorInvalidValue;
}
