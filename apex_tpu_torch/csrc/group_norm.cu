// NHWC GroupNorm (+ SiLU) for Hopper (sm_90a): the one-pass kernel and the
// two-pass pair (statistics, then apply).
//
// Replaces: apex_tpu/ops/pallas/group_norm_kernel.py `_group_norm_one_pass`
// (the Pallas kernel `_one_pass_kernel`) and the two `pallas_call`s of
// `group_norm_nhwc_pallas` (`_stats_kernel`, `_apply_kernel`). x is NHWC
// and contiguous, seen as (n, hw, c); group g is channels [g*cpg, (g+1)*cpg)
// of every pixel (cpg = c / groups). Per (n, g):
//   mean, var over the group's hw * cpg values, rstd = rsqrt(var + eps),
//   y = (x - mean) * rstd (* gamma[c]) (+ beta[c]), then optionally
//   y * sigmoid(y) (SiLU), stored in x's dtype; statistics in fp32, returned
//   as (n, groups) fp32 about the shift K below: mean_d = mean - K, rstd.
// Any hw: nothing is tiled by 8 as on the TPU.
// The TPU kernels sum each channel over the pixels and then the channels of
// a group through a one-hot (C, G) matmul; here a group's sums are plain
// fp32 sums over its cpg contiguous channels.
//
// Statistics. The TPU kernels take var = E[x^2] - mean^2, which cancels to
// NaN on a group whose mean dwarfs its spread (mean 1000, std 0.01). These
// kernels shift every value by K, the group's first element x[n, 0, g*cpg]:
// - one-pass: mean_d = sum(x - K) / cnt, then the variance centred over the
//   group, sum((x - K - mean_d)^2) / cnt, and y from (x - K) - mean_d;
// - two-pass: the stats kernel writes per-(n, tile, g) partial sums of
//   d = x - K and d^2 (SyncBatchNorm's shifted statistics), torch ops add
//   them in tile order and take var = max(E[d^2] - E[d]^2, 0), and the
//   apply kernel normalises (x - K) - mean_d.
// The kernels return mean_d, not mean = K + mean_d: the backward rebuilds
// (x - K) - mean_d exactly where fp32 K + mean_d would round away the
// spread of an ill-conditioned group.
//
// What bounds them on this card: memory bytes (about ten flops an element).
// One-pass reads x once and writes y once; the two-pass pair reads x twice.
// What the design does about that:
// - one-pass: one block per (g, n) stages the group's hw x cpg values as
//   fp32 in dynamic shared memory (160 KB for 320 channels at 64 x 64 in 32
//   groups), so its three passes (mean, centred variance, output) read
//   device memory once. A group whose slab does not fit (gn_one_pass_ok in
//   ops/tiling.py) runs the same arithmetic in a second compile-time form
//   that reads x from device memory in each pass.
// - stats / apply: one block per (n, hw tile) of all c channels, the tile
//   any divisor of hw (gn_hw_block in ops/tiling.py); each thread walks its
//   channels down the tile's pixels, so at every pixel a warp touches 32
//   neighbouring channels. The stats block keeps its per-channel sums in
//   shared memory and adds each group's cpg of them in channel order into a
//   fixed slot of the partial buffer: no atomics, the same bits on every
//   run.
// - a group's values are runs of cpg channels (20 - 80 bytes in bf16 at
//   Stable Diffusion's widths), strided by c: the one-pass block's reads are
//   poorly coalesced. Left for a later change.
// Forms (SiLU or not, gamma, beta, the staged slab) are template parameters
// chosen at launch, so no inner loop tests a form at run time.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each function returns cudaGetLastError() after its launch.

#include "common.cuh"

namespace {

using namespace apex_port;

constexpr int kOnePassThreads = 512;
constexpr int kTileThreads = 256;

template <bool kSilu, bool kW, bool kB>
__device__ __forceinline__ float epilogue(float v, const float* w,
                                          const float* b, int ch) {
  if (kW) v = v * w[ch];
  if (kB) v = v + b[ch];
  if (kSilu) v = v * (1.f / (1.f + expf(-v)));
  return v;
}

// One block per (group, sample): grid (groups, n). With kStaged the group's
// values minus K live in `slab` (hw * cpg floats of dynamic shared memory).
template <typename T, bool kStaged, bool kSilu, bool kW, bool kB>
__global__ void __launch_bounds__(kOnePassThreads)
gn_one_pass_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ y,
                   float* __restrict__ dmean, float* __restrict__ rstd,
                   int hw, int c, int groups, float eps) {
  extern __shared__ float slab[];
  __shared__ float red[32];
  const int g = blockIdx.x;
  const long long n = blockIdx.y;
  const int cpg = c / groups;
  const int cnt = hw * cpg;
  const long long base = n * hw * c + (long long)g * cpg;
  const T* xb = x + base;
  T* yb = y + base;
  const float k = to_f32(xb[0]);
  // value e of the group: pixel e / cpg, channel e % cpg
  float s = 0.f;
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int p = e / cpg;
    const float d = to_f32(xb[(long long)p * c + (e - p * cpg)]) - k;
    if (kStaged) slab[e] = d;  // each thread reads back only what it wrote
    s += d;
  }
  const float fcnt = (float)cnt;
  const float md = block_sum(s, red) / fcnt;
  float ss = 0.f;
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    float d;
    if (kStaged) {
      d = slab[e];
    } else {
      const int p = e / cpg;
      d = to_f32(xb[(long long)p * c + (e - p * cpg)]) - k;
    }
    const float dc = d - md;
    ss += dc * dc;
  }
  const float r = rsqrtf(block_sum(ss, red) / fcnt + eps);
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int p = e / cpg;
    const int j = e - p * cpg;
    const long long off = (long long)p * c + j;
    const float d = kStaged ? slab[e] : to_f32(xb[off]) - k;
    yb[off] = from_f32<T>(epilogue<kSilu, kW, kB>((d - md) * r, w, b,
                                                   g * cpg + j));
  }
  if (threadIdx.x == 0) {
    dmean[n * groups + g] = md;
    rstd[n * groups + g] = r;
  }
}

// One block per (hw tile, sample): grid (hw / hwb, n). Thread t sums
// channels t, t + blockDim.x, ... over the tile's hwb pixels in pixel order
// (d = x - K of the channel's group); then each group's cpg channel sums
// are added in channel order into psum / psq[n][tile][g].
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
gn_stats_kernel(const T* __restrict__ x, const float* __restrict__ shift,
                float* __restrict__ psum, float* __restrict__ psq, int hw,
                int c, int groups, int hwb) {
  extern __shared__ float cs[];  // [2][c]: per-channel sums of d, d^2
  const int tile = blockIdx.x;
  const long long n = blockIdx.y;
  const int cpg = c / groups;
  const T* xt = x + (n * hw + (long long)tile * hwb) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float k = shift[n * groups + ch / cpg];
    float s = 0.f, ss = 0.f;
    for (int p = 0; p < hwb; ++p) {
      const float d = to_f32(xt[(long long)p * c + ch]) - k;
      s += d;
      ss += d * d;
    }
    cs[ch] = s;
    cs[c + ch] = ss;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s = 0.f, ss = 0.f;
    for (int j = 0; j < cpg; ++j) {
      s += cs[g * cpg + j];
      ss += cs[c + g * cpg + j];
    }
    const long long o = (n * gridDim.x + tile) * groups + g;
    psum[o] = s;
    psq[o] = ss;
  }
}

// One block per (hw tile, sample), as the stats kernel: thread t normalises
// channels t, t + blockDim.x, ... down the tile's pixels with its group's
// K, mean_d (= mean - K) and rstd.
template <typename T, bool kSilu, bool kW, bool kB>
__global__ void __launch_bounds__(kTileThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ shift,
                const float* __restrict__ dmean,
                const float* __restrict__ rstd, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ y, int hw, int c,
                int groups, int hwb) {
  const int tile = blockIdx.x;
  const long long n = blockIdx.y;
  const int cpg = c / groups;
  const long long base = (n * hw + (long long)tile * hwb) * c;
  const T* xt = x + base;
  T* yt = y + base;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const long long ng = n * groups + ch / cpg;
    const float k = shift[ng], md = dmean[ng], r = rstd[ng];
    for (int p = 0; p < hwb; ++p) {
      const long long off = (long long)p * c + ch;
      yt[off] = from_f32<T>(epilogue<kSilu, kW, kB>(
          ((to_f32(xt[off]) - k) - md) * r, w, b, ch));
    }
  }
}

// The forms of a kernel, indexed by silu * 4 + (gamma != null) * 2 +
// (beta != null).
#define GN_FORMS(K, ...)                                                    \
  {K<__VA_ARGS__, false, false, false>, K<__VA_ARGS__, false, false, true>, \
   K<__VA_ARGS__, false, true, false>,  K<__VA_ARGS__, false, true, true>,  \
   K<__VA_ARGS__, true, false, false>,  K<__VA_ARGS__, true, false, true>,  \
   K<__VA_ARGS__, true, true, false>,   K<__VA_ARGS__, true, true, true>}

inline int form(int silu, const void* w, const void* b) {
  return (silu ? 4 : 0) + (w != nullptr ? 2 : 0) + (b != nullptr ? 1 : 0);
}

template <typename T>
int launch_one_pass(const void* x, const void* w, const void* b, void* y,
                    void* dmean, void* rstd, int n, int hw, int c, int groups,
                    float eps, int silu, int staged, cudaStream_t stream) {
  using Fn = void (*)(const T*, const float*, const float*, T*, float*,
                      float*, int, int, int, float);
  static const Fn staged_forms[8] = GN_FORMS(gn_one_pass_kernel, T, true);
  static const Fn global_forms[8] = GN_FORMS(gn_one_pass_kernel, T, false);
  const Fn kernel = (staged ? staged_forms : global_forms)[form(silu, w, b)];
  const size_t smem =
      staged ? (size_t)hw * (c / groups) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  kernel<<<dim3(groups, n), kOnePassThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y),
      static_cast<float*>(dmean), static_cast<float*>(rstd), hw, c, groups,
      eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stats(const void* x, const void* shift, void* psum, void* psq,
                 int n, int hw, int c, int groups, int hwb,
                 cudaStream_t stream) {
  const size_t smem = 2 * (size_t)c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(gn_stats_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  gn_stats_kernel<T><<<dim3(hw / hwb, n), kTileThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(shift),
      static_cast<float*>(psum), static_cast<float*>(psq), hw, c, groups,
      hwb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const void* shift, const void* dmean,
                 const void* rstd, const void* w, const void* b, void* y,
                 int n, int hw, int c, int groups, int hwb, int silu,
                 cudaStream_t stream) {
  using Fn = void (*)(const T*, const float*, const float*, const float*,
                      const float*, const float*, T*, int, int, int, int);
  static const Fn forms[8] = GN_FORMS(gn_apply_kernel, T);
  forms[form(silu, w, b)]<<<dim3(hw / hwb, n), kTileThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(shift),
      static_cast<const float*>(dmean), static_cast<const float*>(rstd),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), hw, c, groups, hwb);
  return (int)cudaGetLastError();
}

// c a multiple of groups; the caller (ops/group_norm_kernel.py) keeps
// hw * c / groups below 2^31 and, for the two-pass pair, hwb a divisor of hw
bool shape_ok(int n, int hw, int c, int groups) {
  return n >= 0 && hw > 0 && groups > 0 && c > 0 && c % groups == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). w / b: float32 [c] or null.
// dmean / rstd: float32 [n, groups], dmean the mean less the group's first
// element x[n, 0, g * c / groups]. silu: 1 = SiLU epilogue. staged: 1 =
// the group's slab in shared memory (hw * c / groups * 4 bytes; gate
// gn_one_pass_ok in ops/tiling.py), 0 = read x from device memory in each
// pass.
extern "C" int apex_gn_one_pass(const void* x, const void* w, const void* b,
                                void* y, void* dmean, void* rstd, int n,
                                int hw, int c, int groups, float eps,
                                int silu, int staged, int dtype,
                                void* stream) {
  if (!shape_ok(n, hw, c, groups)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_one_pass<float>(x, w, b, y, dmean, rstd, n, hw, c, groups,
                                  eps, silu, staged, s);
  if (dtype == 1)
    return launch_one_pass<__nv_bfloat16>(x, w, b, y, dmean, rstd, n, hw, c,
                                          groups, eps, silu, staged, s);
  return (int)cudaErrorInvalidValue;
}

// shift: float32 [n, groups], the group's first element. psum / psq:
// float32 [n, hw / hwb, groups], written whole. hwb divides hw.
extern "C" int apex_gn_stats(const void* x, const void* shift, void* psum,
                             void* psq, int n, int hw, int c, int groups,
                             int hwb, int dtype, void* stream) {
  if (!shape_ok(n, hw, c, groups) || hwb < 1 || hw % hwb != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_stats<float>(x, shift, psum, psq, n, hw, c, groups, hwb, s);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16>(x, shift, psum, psq, n, hw, c, groups,
                                       hwb, s);
  return (int)cudaErrorInvalidValue;
}

// shift, dmean (mean - shift) and rstd: float32 [n, groups]; w / b as for
// apex_gn_one_pass; hwb divides hw.
extern "C" int apex_gn_apply(const void* x, const void* shift,
                             const void* dmean, const void* rstd,
                             const void* w, const void* b, void* y, int n,
                             int hw, int c, int groups, int hwb, int silu,
                             int dtype, void* stream) {
  if (!shape_ok(n, hw, c, groups) || hwb < 1 || hw % hwb != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_apply<float>(x, shift, dmean, rstd, w, b, y, n, hw, c,
                               groups, hwb, silu, s);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(x, shift, dmean, rstd, w, b, y, n, hw,
                                       c, groups, hwb, silu, s);
  return (int)cudaErrorInvalidValue;
}
