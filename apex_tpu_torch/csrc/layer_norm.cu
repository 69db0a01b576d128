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
// - backward, rows up to 1024 columns that are whole 16-byte vectors (the
//   "reg" form; GPT-2's 768, BERT's 1024): one warp per row, each lane
//   holding its kV vectors of x and dy in registers, loaded 16 bytes at a
//   time (8 bf16 or 4 fp32 a load, kV * 32 bytes a lane in flight a row).
//   Both row sums are warp shuffles, dx is written as vectors, and the
//   lane's running dgamma / dbeta sums for its fixed columns stay in
//   registers across every row its warp takes: nothing of a row goes
//   through shared memory. The grid is persistent (LN_REG_BLOCKS_PER_SM
//   blocks of 8 warps on each SM at most), so a warp takes many rows and
//   the block's fixed costs (its warp-ordered combine into one partial
//   row) are paid once; with no row in shared memory, 16 warps an SM fit
//   (bf16; the registers bound it), each with 48-64 bytes a lane in
//   flight a row.
// - backward, other rows up to kSmemMaxHidden: one warp per row; the warp
//   stages xhat and dy of its row in shared memory, so x and dy are read
//   from device memory once and dx written once, with running dgamma /
//   dbeta sums a warp in shared memory.
// - dgamma / dbeta are the TPU grid's sequential accumulator; blocks on
//   Hopper run in parallel, so each block adds its warps' sums in warp
//   order into one row of a (blocks, hidden) partial buffer, and a second
//   launch adds the partial rows in a fixed order (a block per 8 columns,
//   one 32-byte sector of each partial row, where the partial rows are
//   many and the row short, as GPT-2's 264 x 768, so the sum spreads over
//   all SMs; a block per 32 columns otherwise; the rows split over slices
//   of threads, combined by shuffles and then in warp order). No float
//   atomics: the result has the same bits on every run.
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
constexpr int kRegWarps = 8;          // LN_REG_WARPS
constexpr int kRegLaneValues = 32;    // LN_REG_LANE_VALUES
// the reduce launch's block: 256 threads, 8 or 32 columns (LN_REDUCE_COLS)
// by ln_reduce_cols in ops/tiling.py, the rest of its threads slices of
// the partial rows
constexpr int kReduceThreads = 256;     // LN_REDUCE_THREADS
constexpr int kReduceNarrow = 8;
constexpr int kReduceWide = 32;
constexpr int kReduceWideCols = 4224;   // LN_REDUCE_WIDE_COLS
constexpr int kReduceFewRows = 32;      // LN_REDUCE_FEW_ROWS
constexpr int kFormReg = 0, kFormSmem = 1, kFormWide = 2;  // LN_BWD_FORMS

// The "reg" form by IO dtype: values of a 16-byte vector, the most
// vectors a lane holds, and blocks an SM (LN_REG_BLOCKS_PER_SM: the bf16
// form fits two 8-warp blocks in 128 registers a thread, the fp32 form,
// with twice the registers a value, one)
template <typename T> struct RegForm {
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kMaxVectors = kRegLaneValues / kVec;
  static constexpr int kBlocksPerSM = sizeof(T) == 2 ? 2 : 1;
};

// kN fp32 values of an aligned row (gamma) from L1
template <int kN>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
    f[i] = v.x;
    f[i + 1] = v.y;
    f[i + 2] = v.z;
    f[i + 3] = v.w;
  }
}

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

// The block's row of `part` (its partial sums): each warp's register sums
// a (columns as in ln_bwd_kernel_reg) into its row of `comb`, then column
// i the sum over warps in warp order.
template <int kV, int kVec>
__device__ __forceinline__ void combine_warps(const float (&a)[kV][kVec],
                                              float* comb, float* part,
                                              int hidden) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int col = (v * 32 + lane) * kVec;
    if (col < hidden) {
#pragma unroll
      for (int i = 0; i < kVec; i += 4)
        *reinterpret_cast<float4*>(comb + (size_t)warp * hidden + col + i) =
            make_float4(a[v][i], a[v][i + 1], a[v][i + 2], a[v][i + 3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kRegWarps; ++w) t += comb[(size_t)w * hidden + i];
    part[(size_t)blockIdx.x * hidden + i] = t;
  }
}

// The "reg" form: warp w of block b takes rows b * kRegWarps + w, then
// every gridDim.x * kRegWarps further. Lane l holds vectors v = 0 .. kV-1
// of each row, columns (v * 32 + l) * kVec onwards (those below hidden),
// and keeps dgamma / dbeta for them in registers; at the end the block's
// warps add their sums in warp order through `comb` (kRegWarps * hidden
// floats, dgamma first, then dbeta) into its partial rows.
template <typename T, int kV, bool kRms, bool kAffine>
__global__ void __launch_bounds__(kRegWarps * 32, RegForm<T>::kBlocksPerSM)
ln_bwd_kernel_reg(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ invvar, T* __restrict__ dx,
                  float* __restrict__ part_g, float* __restrict__ part_b,
                  int rows, int hidden) {
  constexpr int kVec = RegForm<T>::kVec;
  extern __shared__ float comb[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc_g[kV][kVec], acc_b[kV][kVec];
#pragma unroll
  for (int v = 0; v < kV; ++v)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc_g[v][i] = acc_b[v][i] = 0.f;
  const float fh = (float)hidden;
  const long long stride = (long long)gridDim.x * kRegWarps;
  for (long long row = (long long)blockIdx.x * kRegWarps + warp; row < rows;
       row += stride) {
    const float mu = kRms ? 0.f : mean[row];
    const float rstd = invvar[row];
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * hidden);
    const uint4* dyr = reinterpret_cast<const uint4*>(dy + row * hidden);
    uint4 xv[kV], dv[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      if ((v * 32 + lane) * kVec < hidden) {
        xv[v] = __ldg(xr + v * 32 + lane);
        dv[v] = __ldg(dyr + v * 32 + lane);
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int col = (v * 32 + lane) * kVec;
      if (col < hidden) {
        float xf[kVec], df[kVec], g[kVec];
        unpack16(xv[v], xf);
        unpack16(dv[v], df);
        if (kAffine) load_f32(gamma + col, g);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float xhat = (xf[i] - mu) * rstd;
          const float wdy = kAffine ? df[i] * g[i] : df[i];
          s1 += xhat * wdy;
          s2 += wdy;
          if (kAffine) {
            acc_g[v][i] += df[i] * xhat;
            acc_b[v][i] += df[i];
          }
        }
      }
    }
    const float c1 = warp_sum(s1) / fh;
    const float c2 = kRms ? 0.f : warp_sum(s2) / fh;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * hidden);
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int col = (v * 32 + lane) * kVec;
      if (col < hidden) {
        float xf[kVec], df[kVec], g[kVec], o[kVec];
        unpack16(xv[v], xf);
        unpack16(dv[v], df);
        if (kAffine) load_f32(gamma + col, g);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float xhat = (xf[i] - mu) * rstd;
          const float wdy = kAffine ? df[i] * g[i] : df[i];
          o[i] = (wdy - xhat * c1 - c2) * rstd;
        }
        dxr[v * 32 + lane] = pack16(o);
      }
    }
  }
  if (!kAffine) return;  // no affine step: no dgamma / dbeta
  combine_warps(acc_g, comb, part_g, hidden);
  if (part_b == nullptr) return;  // no beta: no dbeta
  __syncthreads();  // the dgamma combine's readers are done with comb
  combine_warps(acc_b, comb, part_b, hidden);
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

// dgamma[c] (grid.y 0, from part_g) or dbeta[c] (grid.y 1, from part_b) =
// the sum over partial rows k of part[k][c]. A block takes kCols columns
// (8: one 32-byte sector of each partial row, so a short row spreads over
// many blocks; 32: a warp's), thread t's column t % kCols, its slice t /
// kCols of the kReduceThreads / kCols slices; it adds rows slice, slice +
// slices, ... in order; a warp's slices are then added by shuffles, and
// the block's warps in warp order.
template <int kCols>
__global__ void __launch_bounds__(kReduceThreads)
ln_bwd_reduce_kernel(const float* __restrict__ part_g,
                     const float* __restrict__ part_b,
                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                     int nblk, int hidden) {
  constexpr int kSlices = kReduceThreads / kCols;
  constexpr int kWarps = kReduceThreads / 32;
  __shared__ float red[kWarps][kCols];
  const float* part = blockIdx.y == 0 ? part_g : part_b;
  float* out = blockIdx.y == 0 ? dgamma : dbeta;
  const int tx = threadIdx.x % kCols;
  const int slice = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + tx;
  float a = 0.f;
  if (col < hidden) {
    for (int k = slice; k < nblk; k += kSlices)
      a += part[(size_t)k * hidden + col];
  }
#pragma unroll
  for (int off = kCols; off < 32; off <<= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  if ((threadIdx.x & 31) < kCols) red[threadIdx.x >> 5][tx] = a;
  __syncthreads();
  if ((int)threadIdx.x < kCols && col < hidden) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][tx];
    out[col] = t;
  }
}

// The reduce launch's columns a block (ln_reduce_cols in ops/tiling.py):
// 8 where the partial rows are many and the row short, else 32
inline int reduce_cols(int hidden, int nblk) {
  return nblk > kReduceFewRows && hidden < kReduceWideCols ? kReduceNarrow
                                                           : kReduceWide;
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

// The "reg" form's instantiations for kV = 1 .. RegForm<T>::kMaxVectors,
// each indexed by rms * 2 + affine.
#define LN_REG_FORMS(T, V)                                            \
  {ln_bwd_kernel_reg<T, V, false, false>,                             \
   ln_bwd_kernel_reg<T, V, false, true>,                              \
   ln_bwd_kernel_reg<T, V, true, false>, ln_bwd_kernel_reg<T, V, true, true>}
template <typename T>
using BwdFn = void (*)(const T*, const T*, const float*, const float*,
                       const float*, T*, float*, float*, int, int);
template <typename T>
BwdFn<T> reg_kernel(int vectors, int rms, bool affine) {
  const int which = (rms ? 2 : 0) + (affine ? 1 : 0);
  if constexpr (RegForm<T>::kMaxVectors == 8) {
    static const BwdFn<T> forms[8][4] = {
        LN_REG_FORMS(T, 1), LN_REG_FORMS(T, 2), LN_REG_FORMS(T, 3),
        LN_REG_FORMS(T, 4), LN_REG_FORMS(T, 5), LN_REG_FORMS(T, 6),
        LN_REG_FORMS(T, 7), LN_REG_FORMS(T, 8)};
    return forms[vectors - 1][which];
  } else {
    static_assert(RegForm<T>::kMaxVectors == 4, "kV = 1 .. kMaxVectors");
    static const BwdFn<T> forms[4][4] = {
        LN_REG_FORMS(T, 1), LN_REG_FORMS(T, 2), LN_REG_FORMS(T, 3),
        LN_REG_FORMS(T, 4)};
    return forms[vectors - 1][which];
  }
}

// The form's shape requirements (ln_bwd_geometry in ops/tiling.py)
template <typename T>
bool bwd_form_ok(int form, int hidden, int vectors, int warps,
                 const void* dy, const void* x, const void* dx,
                 const void* gamma) {
  constexpr int kVec = RegForm<T>::kVec;
  if (form == kFormReg)
    return warps == kRegWarps && vectors >= 1 &&
           vectors <= RegForm<T>::kMaxVectors && hidden % kVec == 0 &&
           hidden <= vectors * 32 * kVec &&
           hidden > (vectors - 1) * 32 * kVec && is_aligned(dy, 16) &&
           is_aligned(x, 16) && is_aligned(dx, 16) &&
           (gamma == nullptr || is_aligned(gamma, 16));
  if (form == kFormSmem)
    return hidden <= kSmemMaxHidden && warps >= 1 && warps <= 32;
  return form == kFormWide && hidden > kSmemMaxHidden &&
         warps == kWideWarps;
}

template <typename T>
int launch_bwd(const void* dy, const void* x, const void* gamma,
               const void* mean, const void* invvar, void* dx, void* part_g,
               void* part_b, void* dgamma, void* dbeta, int rows, int hidden,
               int form, int vectors, int warps, int nblk, int rms,
               cudaStream_t stream) {
  if (!bwd_form_ok<T>(form, hidden, vectors, warps, dy, x, dx, gamma))
    return (int)cudaErrorInvalidValue;
  const bool affine = gamma != nullptr;
  BwdFn<T> kernel;
  size_t smem;
  if (form == kFormReg) {
    kernel = reg_kernel<T>(vectors, rms, affine);
    smem = affine ? (size_t)kRegWarps * hidden * sizeof(float) : 0;
  } else if (form == kFormWide) {
    kernel = rms ? (affine ? ln_bwd_wide_kernel<T, true, true>
                           : ln_bwd_wide_kernel<T, true, false>)
                 : (affine ? ln_bwd_wide_kernel<T, false, true>
                           : ln_bwd_wide_kernel<T, false, false>);
    smem = 0;
  } else {
    kernel = rms ? (affine ? ln_bwd_kernel<T, true, true>
                           : ln_bwd_kernel<T, true, false>)
                 : (affine ? ln_bwd_kernel<T, false, true>
                           : ln_bwd_kernel<T, false, false>);
    smem = (size_t)warps * 4 * hidden * sizeof(float);
  }
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
  const int cols = reduce_cols(hidden, nblk);
  const dim3 grid((hidden + cols - 1) / cols, part_b != nullptr ? 2 : 1);
  const auto reduce = cols == kReduceNarrow
                          ? ln_bwd_reduce_kernel<kReduceNarrow>
                          : ln_bwd_reduce_kernel<kReduceWide>;
  reduce<<<grid, kReduceThreads, 0, stream>>>(
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
// is not read (and may be null) when rms = 1. form: 0 "reg" (`vectors`
// 16-byte vectors a lane, 8 warps, 16-byte aligned dy, x, dx and gamma,
// which it reads as vectors), 1 "smem"
// (`warps` warps, rows dealt out warp by warp over the grid), 2 "wide"
// (above kSmemMaxHidden, kWideWarps warps, rows dealt out block by block);
// `nblk` blocks (ln_bwd_geometry in ops/tiling.py).
extern "C" int apex_ln_bwd(const void* dy, const void* x, const void* gamma,
                           const void* mean, const void* invvar, void* dx,
                           void* part_g, void* part_b, void* dgamma,
                           void* dbeta, int rows, int hidden, int form,
                           int vectors, int warps, int nblk, int rms,
                           int dtype, void* stream) {
  if (nblk < 1 || hidden < 1 || hidden > kMaxHidden)
    return (int)cudaErrorInvalidValue;
  if ((gamma == nullptr) != (part_g == nullptr) ||
      (part_g == nullptr && part_b != nullptr) ||
      (part_g != nullptr) != (dgamma != nullptr) ||
      (part_b != nullptr) != (dbeta != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(dy, x, gamma, mean, invvar, dx, part_g, part_b,
                             dgamma, dbeta, rows, hidden, form, vectors,
                             warps, nblk, rms, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(dy, x, gamma, mean, invvar, dx, part_g,
                                     part_b, dgamma, dbeta, rows, hidden,
                                     form, vectors, warps, nblk, rms, s);
  return (int)cudaErrorInvalidValue;
}
