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
// - one-pass ("cluster" route, gn_one_pass_geometry in ops/tiling.py): a
//   thread block cluster takes a (sample, channel slice), the slice the
//   fewest whole groups that are a whole number of 16-byte vectors (40
//   channels of 320 in bf16: 4 groups, 80 bytes a pixel), so a sample's
//   pixels split over the fewest blocks (the cluster barriers are the
//   route's fixed cost). Each block copies its (pixels x slice) tile into
//   shared memory in x's dtype with 16-byte cp.async, every copy issued
//   before the first is waited on (about 160 KB in flight an SM at the
//   UNet's 64 x 64 x 320), so x is read from device memory once, and the
//   mean pass starts on a thread's first batch of copies while the rest
//   land. Thread t keeps one vector column of the tile (its channels
//   fixed) down every R-th pixel, so its per-channel sums, K, mean and
//   rstd, gamma and beta sit in registers and the passes over the tile
//   read 16 bytes at a time. The per-group sums of the mean pass, then of
//   the centred squares, are added over the block's threads in a fixed
//   order (each channel over parts of the rows, then a warp a group) and
//   then over the cluster's blocks in rank order through distributed
//   shared memory, so every block holds the same mean and rstd and two
//   runs give the same bits. y is written as 16-byte vectors.
// - one-pass, "staged" and "unstaged" routes (slices that cannot be
//   16-byte aligned, misaligned x, slabs of at most 2048 values; a slab
//   over the gate): one block per (g, n) stages the group's hw x cpg
//   values as fp32 in dynamic shared memory, so its three passes (mean,
//   centred variance, output) read device memory once; a group whose slab
//   does not fit (gn_one_pass_ok in ops/tiling.py) runs the same
//   arithmetic in a second compile-time form that reads x from device
//   memory in each pass.
// - stats / apply, "vector" route (gn_two_pass_geometry in ops/tiling.py;
//   x and y 16-byte aligned, c a whole number of 16-byte vectors): the
//   tile, hwb pixels of all c channels (any divisor of hw, gn_hw_block), is
//   contiguous ("slot", (sample, tile) in psum's order), and so are the
//   one or two consecutive slots a stats block takes (an apply block
//   takes one). Thread t < rows * nj (nj = c / vec) keeps vector column
//   j = t % nj, 8 bf16 or 4 fp32 channels, down pixels t / nj, + rows,
//   ... of each tile, so its channels' K (and for apply
//   mean_d, rstd, gamma and beta) sit in registers, every access is 16
//   bytes and a warp's accesses are contiguous. Each thread issues its
//   loads in batches, all of a batch before it uses the first: 16 in the
//   stats kernel (a thread's whole column of a 32-pixel tile at the
//   UNet's shape), 8 in apply, whose per-channel statistics and affine
//   take 40 registers (batches of 16 spilled); a column's last vectors go
//   in batches of 8, 4, 2, 1. The stats block writes its threads'
//   per-channel sums of d and d^2 to shared memory; warp w then
//   adds group g = w, w + warps, ...: lane l its channels l, l + 32, ...,
//   each over the block's pixel rows in order, then a shuffle tree, into
//   the tile's slot of psum / psq: each slot written once, no atomics, the
//   same bits on every run; a stats block takes two slots where the grid
//   stays a wave, which halves the block reductions' share. apply keeps
//   ((x - K) - mean_d) * rstd, then gamma, then beta, in that order
//   (folding them into x * a + b would lose an ill-conditioned group's
//   spread); SiLU takes __expf and __fdividef, fewer instructions than
//   the IEEE forms in the loop that bounds the pass, and y is stored 16
//   bytes at a time.
// - stats / apply, "scalar" route (misaligned x, widths that are not whole
//   16-byte vectors or over 512 of them): one block per (n, hw tile) of all
//   c channels; each thread walks its channels down the tile's pixels, so
//   at every pixel a warp touches 32 neighbouring channels with 2- or
//   4-byte loads. The stats block keeps its per-channel sums in shared
//   memory and adds each group's cpg of them in channel order into a fixed
//   slot of the partial buffer: no atomics, the same bits on every run.
// Forms (SiLU or not, gamma, beta, the staged slab) are template parameters
// chosen at launch, so no inner loop tests a form at run time.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each function returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using namespace apex_port;
namespace cg = cooperative_groups;

constexpr int kOnePassThreads = 512;  // GN_STAGED_THREADS
constexpr int kTileThreads = 256;  // GN_SCALAR_THREADS
constexpr int kClusterMax = 8;           // GN_CLUSTER_MAX
constexpr int kClusterThreads = 512;     // GN_CLUSTER_THREADS
constexpr int kVectorBytes = 16;         // GN_VECTOR_BYTES
constexpr int kCopyBatches = 4;  // commit groups of a thread's copies
constexpr int kSmemBytes = 227 * 1024 - 1024;  // GN_ONE_PASS_SMEM_BYTES
constexpr int kTwoPassMaxThreads = 512;  // GN_TWO_PASS_MAX_THREADS
constexpr int kStatsUnroll = 16;         // GN_STATS_UNROLL
constexpr int kApplyUnroll = 8;          // GN_APPLY_UNROLL

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

// wait for batch `bt` of kBatches commit groups of cp_async16 copies (bt a
// compile-time value once the caller's loop is unrolled)
template <int kBatches>
__device__ __forceinline__ void cp_async_wait_batch(int bt) {
  if (bt == 0) cp_async_wait<kBatches - 1>();
  else if (bt == 1) cp_async_wait<(kBatches > 2 ? kBatches - 2 : 0)>();
  else if (bt == 2) cp_async_wait<(kBatches > 3 ? kBatches - 3 : 0)>();
  else cp_async_wait<0>();
}
// the cluster barrier in halves: arrive (releasing this block's shared
// memory writes to the cluster), and wait (acquiring the others')
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// every block of the cluster has reached this point (one block: the block
// barrier, which is all a cluster of one needs)
__device__ __forceinline__ void cluster_sync(int ranks) {
  if (ranks > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// The "cluster" route's block sums of a pass: thread (j, r0) holds kVec
// per-channel sums for channels j * kVec .. of the slice. They go to
// red[r0][slice_c]; then thread (ch, k) of `parts` = blockDim.x / slice_c
// parts a channel adds rows k, k + parts, ... of its channel in order into
// red[k][ch] (no other thread reads those rows); then warp w adds group
// w's parts x cpg values (lane i its channels i, i + 32, ..., each over
// the parts in order, then a shuffle tree) into out[w]. No value is
// summed twice and no division runs an element. The caller's cluster
// barrier follows.
template <int kVec>
__device__ __forceinline__ void group_block_sums(const float (&acc)[kVec],
                                                 float* red, float* out,
                                                 int j, int r0, int rsteps,
                                                 int slice_c, int cpg) {
#pragma unroll
  for (int i = 0; i < kVec; i += 4)
    *reinterpret_cast<float4*>(red + r0 * slice_c + j * kVec + i) =
        make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  __syncthreads();
  const int parts = max(1, min(rsteps, (int)blockDim.x / slice_c));
  for (int e = threadIdx.x; e < parts * slice_c; e += blockDim.x) {
    const int k = e / slice_c;
    const int ch = e - k * slice_c;
    float v = 0.f;
#pragma unroll 8
    for (int r = k; r < rsteps; r += parts) v += red[r * slice_c + ch];
    red[k * slice_c + ch] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int gs = slice_c / cpg;
  for (int g = threadIdx.x >> 5; g < gs; g += blockDim.x >> 5) {
    float v = 0.f;
    for (int i = lane; i < cpg; i += 32) {
      const float* col = red + g * cpg + i;
#pragma unroll 8
      for (int k = 0; k < parts; ++k) v += col[k * slice_c];
    }
    v = warp_sum(v);
    if (lane == 0) out[g] = v;
  }
}

// The "cluster" route. Grid (cluster, c / slice_c, n), a cluster of
// gridDim.x blocks; block `rank` stages pixels [rank * pixels, + pixels)
// of sample blockIdx.z, channels [blockIdx.y * slice_c, + slice_c).
// Thread t takes vector column j = t % J (J = slice_c / kVec) of pixels
// r0 = t / J, r0 + R, ... (R = blockDim.x / J); it copies those vectors
// into the tile itself and reads back only those, so no block barrier
// stands between the copies and the first pass. Shared memory: the tile
// (x's dtype), red (R x slice_c fp32), then per group of the slice the
// block's sums of d and of (d - mean_d)^2, K, mean_d and rstd.
template <typename T, bool kSilu, bool kW, bool kB>
__global__ void __launch_bounds__(kClusterThreads)
gn_one_pass_kernel_cluster(const T* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ b, T* __restrict__ y,
                           float* __restrict__ dmean,
                           float* __restrict__ rstd, int hw, int c,
                           int groups, int slice_c, int pixels, float eps) {
  constexpr int kVec = kVectorBytes / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int cpg = c / groups;
  const int gs = slice_c / cpg;
  const int nj = slice_c / kVec;
  const int rsteps = blockDim.x / nj;
  const int j = threadIdx.x % nj;
  const int r0 = threadIdx.x / nj;
  const int p0 = rank * pixels;
  const int np = max(0, min(pixels, hw - p0));
  T* tile = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(
      smem + (size_t)pixels * slice_c * sizeof(T));
  float* bsum = red + rsteps * slice_c;
  float* bsq = bsum + gs;
  float* kst = bsq + gs;
  float* mst = kst + gs;
  float* rst = mst + gs;
  const long long n = blockIdx.z;
  const int ch0 = blockIdx.y * slice_c;  // the slice's first channel
  const T* xs = x + (n * hw + p0) * c + ch0 + j * kVec;
  T* ys = y + (n * hw + p0) * c + ch0 + j * kVec;
  uint4* tv = reinterpret_cast<uint4*>(tile) + j;  // + p * nj
  // K, gamma and beta first (loads issued behind the tile's copies wait
  // for them), used only after the copies are issued
  const float kload = (int)threadIdx.x < gs
                          ? to_f32(x[n * hw * c + ch0 + threadIdx.x * cpg])
                          : 0.f;
  float wv[kVec], bv[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    wv[i] = kW ? w[ch0 + j * kVec + i] : 1.f;
    bv[i] = kB ? b[ch0 + j * kVec + i] : 0.f;
  }
  // this thread's vectors: pixels r0 + k * rsteps, k < m, copied in
  // kCopyBatches commit groups so the mean pass starts on the first while
  // the others are in flight
  const int m = r0 < np ? (np - 1 - r0) / rsteps + 1 : 0;
  {
    int k = 0;
#pragma unroll
    for (int bt = 0; bt < kCopyBatches; ++bt) {
      for (const int end = m * (bt + 1) / kCopyBatches; k < end; ++k) {
        const int p = r0 + k * rsteps;
        cp_async16(tv + p * nj, xs + (long long)p * c);
      }
      cp_async_commit();
    }
  }
  if ((int)threadIdx.x < gs) kst[threadIdx.x] = kload;
  __syncthreads();  // K of the slice's groups
  float kk[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) kk[i] = kst[(j * kVec + i) / cpg];

  // mean_d of each group: the sum of d = x - K over the cluster, each
  // batch of this thread's vectors as it lands in the tile (it reads back
  // only what it copied: no block barrier before)
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  {
    int k = 0;
#pragma unroll
    for (int bt = 0; bt < kCopyBatches; ++bt) {
      cp_async_wait_batch<kCopyBatches>(bt);
#pragma unroll 4
      for (const int end = m * (bt + 1) / kCopyBatches; k < end; ++k) {
        float f[kVec];
        unpack16(tv[(r0 + k * rsteps) * nj], f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] += f[i] - kk[i];
      }
    }
  }
  group_block_sums(acc, red, bsum, j, r0, rsteps, slice_c, cpg);
  const float fcnt = (float)((long long)hw * cpg);
  cluster_sync(ranks);
  for (int g = threadIdx.x; g < gs; g += blockDim.x) {
    float t = 0.f;
    for (int r = 0; r < ranks; ++r) t += cluster.map_shared_rank(bsum, r)[g];
    mst[g] = t / fcnt;
  }
  __syncthreads();
  float md[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) md[i] = mst[(j * kVec + i) / cpg];

  // rstd: the centred sum of squares over the cluster
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int p = r0; p < np; p += rsteps) {
    float f[kVec];
    unpack16(tv[p * nj], f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float dc = (f[i] - kk[i]) - md[i];
      acc[i] += dc * dc;
    }
  }
  group_block_sums(acc, red, bsq, j, r0, rsteps, slice_c, cpg);
  cluster_sync(ranks);
  for (int g = threadIdx.x; g < gs; g += blockDim.x) {
    float t = 0.f;
    for (int r = 0; r < ranks; ++r) t += cluster.map_shared_rank(bsq, r)[g];
    const float rv = rsqrtf(t / fcnt + eps);
    rst[g] = rv;
    if (rank == 0) {
      const long long o = n * groups + (long long)blockIdx.y * gs + g;
      dmean[o] = mst[g];
      rstd[o] = rv;
    }
  }
  // done with the other blocks' shared memory: arrive now, and wait for
  // theirs only before leaving, so no block's shared memory goes while
  // another reads it
  if (ranks > 1) cluster_arrive();
  __syncthreads();

  // y = epilogue((d - mean_d) * rstd), 16 bytes a store; SiLU's
  // reciprocal by __fdividef (2 ulp), without the IEEE division's
  // slow-path branch in the loop that bounds the pass
  float rs[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) rs[i] = rst[(j * kVec + i) / cpg];
#pragma unroll 2
  for (int p = r0; p < np; p += rsteps) {
    float f[kVec];
    unpack16(tv[p * nj], f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float v = ((f[i] - kk[i]) - md[i]) * rs[i];
      if (kW) v = v * wv[i];
      if (kB) v = v + bv[i];
      if (kSilu) v = __fdividef(v, 1.f + expf(-v));
      f[i] = v;
    }
    *reinterpret_cast<uint4*>(ys + (long long)p * c) = pack16(f);
  }
  if (ranks > 1) cluster_wait();
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

// The "vector" route's part of a block a thread takes: vector column j of
// pixel rows r0, r0 + rows, ... of each tile, m of them in a tile of hwb
// pixels (rows <= hwb: every row has a pixel). The padding threads past
// rows * nj (`on` false) load nothing and only join the group sums.
struct VecLane {
  bool on;
  int j, r0, m;
  __device__ __forceinline__ VecLane(int nj, int rows, int hwb) {
    const int t = threadIdx.x;
    on = t < rows * nj;
    j = on ? t % nj : 0;
    r0 = t / nj;
    m = on ? (hwb - 1 - r0) / rows + 1 : 0;
  }
};

// f(p, v) for kN vectors v of a thread's column of the tile at xt (its
// column's first element), at pixels p0, p0 + rows, ...: all kN 16-byte
// loads (evict-first: the pair reads x once a pass) issued before the
// first is used
template <int kN, typename T, typename F>
__device__ __forceinline__ void column_batch(const T* xt, int p0, int rows,
                                             int c, F& f) {
  uint4 u[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q)
    u[q] = __ldcs(reinterpret_cast<const uint4*>(
        xt + (long long)(p0 + q * rows) * c));
#pragma unroll
  for (int q = 0; q < kN; ++q) f(p0 + q * rows, u[q]);
}

// the last `left` (< 2 kN) vectors from pixel p on: a batch of kN if
// that many are left, then of kN / 2, ..., 1
template <int kN, typename T, typename F>
__device__ __forceinline__ void column_rest(const T* xt, int p, int left,
                                            int rows, int c, F& f) {
  if constexpr (kN >= 1) {
    if (left >= kN) {
      column_batch<kN>(xt, p, rows, c, f);
      p += kN * rows;
      left -= kN;
    }
    column_rest<kN / 2>(xt, p, left, rows, c, f);
  }
}

// f(p, v) for the thread's m vectors v of the tile at xt, pixels p = r0 +
// k * rows in order: batches of kU loads, each batch all issued before
// its first is used (up to kU * 16 bytes a thread in flight), then the
// rest in batches of kU / 2, ..., 1
template <int kU, typename T, typename F>
__device__ __forceinline__ void walk_column(const T* xt, const VecLane& l,
                                            int rows, int c, F&& f) {
  int k = 0;
  for (; k + kU <= l.m; k += kU)
    column_batch<kU>(xt, l.r0 + k * rows, rows, c, f);
  column_rest<kU / 2>(xt, l.r0 + k * rows, l.m - k, rows, c, f);
}

// The stats kernel's work on one vector of its column: d = x - K and d^2
// added to the thread's per-channel sums (a functor with a forced-inline
// call, so the sums stay in registers at every call site)
template <typename T>
struct ColumnSums {
  static constexpr int kVec = kVectorBytes / (int)sizeof(T);
  float kk[kVec], as[kVec], aq[kVec];
  __device__ __forceinline__ void operator()(int, const uint4& u) {
    float f[kVec];
    unpack16(u, f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float d = f[i] - kk[i];
      as[i] += d;
      aq[i] += d * d;
    }
  }
};

// The apply kernel's work on one vector: y = epilogue(((x - K) - mean_d)
// * rstd) of its kVec channels, stored 16 bytes at a time at pixel p of
// the tile at yt. SiLU as __fdividef(v, 1 + __expf(-v)): __expf's error,
// (2 + 1.16 |v|) ulp, is under GN_TOL's 1e-5 relative for |v| < 70, and
// beyond that y is 0 or v in fp32 either way.
template <typename T, bool kSilu, bool kW, bool kB>
struct ColumnOut {
  static constexpr int kVec = kVectorBytes / (int)sizeof(T);
  float kk[kVec], md[kVec], rs[kVec], wv[kVec], bv[kVec];
  T* yt;
  int c;
  __device__ __forceinline__ void operator()(int p, const uint4& u) {
    float f[kVec];
    unpack16(u, f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float v = ((f[i] - kk[i]) - md[i]) * rs[i];
      if (kW) v = v * wv[i];
      if (kB) v = v + bv[i];
      if (kSilu) v = __fdividef(v, 1.f + __expf(-v));
      f[i] = v;
    }
    *reinterpret_cast<uint4*>(yt + (long long)p * c) = pack16(f);
  }
};

// The "vector" stats route. Grid: ceil(slots / tpb) blocks, block b takes
// slots [b * tpb, + tpb) (slot s = sample s / tiles, tile s % tiles, at x
// + s * hwb * c). Per slot, thread (j, r0) sums d = x - K and d^2 of its
// kVec channels over its pixels in order; the sums go to red ([2][rows][c]
// fp32, dynamic shared memory) and warp w adds groups w, w + warps, ...
// into psum / psq[s][g].
template <typename T>
__global__ void __launch_bounds__(kTwoPassMaxThreads)
gn_stats_kernel_vec(const T* __restrict__ x, const float* __restrict__ shift,
                    float* __restrict__ psum, float* __restrict__ psq,
                    int c, int groups, int hwb, int tiles, long long slots,
                    int rows, int tpb) {
  constexpr int kVec = kVectorBytes / (int)sizeof(T);
  extern __shared__ __align__(16) float red[];
  const int nj = c / kVec;
  const int cpg = c / groups;
  const VecLane l(nj, rows, hwb);
  float* rs = red;
  float* rq = red + rows * c;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long s0 = (long long)blockIdx.x * tpb;
  const long long s1 = s0 + tpb < slots ? s0 + tpb : slots;
  long long cur = -1;  // the sample whose K the thread holds
  ColumnSums<T> acc;
  for (long long s = s0; s < s1; ++s) {
    const long long n = s / tiles;
    if (n != cur) {
      cur = n;
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        acc.kk[i] = l.on ? shift[n * groups + (l.j * kVec + i) / cpg] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc.as[i] = acc.aq[i] = 0.f;
    walk_column<kStatsUnroll>(x + s * hwb * c + (long long)l.j * kVec, l,
                              rows, c, acc);
    if (l.on) {
      float* ps = rs + l.r0 * c + l.j * kVec;
      float* pq = rq + l.r0 * c + l.j * kVec;
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        *reinterpret_cast<float4*>(ps + i) = make_float4(
            acc.as[i], acc.as[i + 1], acc.as[i + 2], acc.as[i + 3]);
        *reinterpret_cast<float4*>(pq + i) = make_float4(
            acc.aq[i], acc.aq[i + 1], acc.aq[i + 2], acc.aq[i + 3]);
      }
    }
    __syncthreads();
    for (int g = threadIdx.x >> 5; g < groups; g += warps) {
      float vs = 0.f, vq = 0.f;
      for (int i = lane; i < cpg; i += 32) {
        const int ch = g * cpg + i;
        for (int r = 0; r < rows; ++r) {
          vs += rs[r * c + ch];
          vq += rq[r * c + ch];
        }
      }
      vs = warp_sum(vs);
      vq = warp_sum(vq);
      if (lane == 0) {
        psum[s * groups + g] = vs;
        psq[s * groups + g] = vq;
      }
    }
    if (s + 1 < s1) __syncthreads();  // red is read before it is rewritten
  }
}

// The "vector" apply route. Grid: one block a slot (slot s = sample s /
// tiles, tile s % tiles, at x + s * hwb * c). Thread (j, r0) holds its
// kVec channels' K, mean_d, rstd, gamma and beta and writes its column
// of y (ColumnOut).
template <typename T, bool kSilu, bool kW, bool kB>
__global__ void __launch_bounds__(kTwoPassMaxThreads)
gn_apply_kernel_vec(const T* __restrict__ x, const float* __restrict__ shift,
                    const float* __restrict__ dmean,
                    const float* __restrict__ rstd,
                    const float* __restrict__ w, const float* __restrict__ b,
                    T* __restrict__ y, int c, int groups, int hwb, int tiles,
                    int rows) {
  constexpr int kVec = kVectorBytes / (int)sizeof(T);
  const int nj = c / kVec;
  const int cpg = c / groups;
  const VecLane l(nj, rows, hwb);
  if (!l.on) return;  // no block barrier below
  const int ch0 = l.j * kVec;
  const long long s = blockIdx.x;
  const long long n = s / tiles;
  ColumnOut<T, kSilu, kW, kB> out;
  out.c = c;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const long long ng = n * groups + (ch0 + i) / cpg;
    out.kk[i] = shift[ng];
    out.md[i] = dmean[ng];
    out.rs[i] = rstd[ng];
    out.wv[i] = kW ? w[ch0 + i] : 1.f;
    out.bv[i] = kB ? b[ch0 + i] : 0.f;
  }
  const long long base = s * hwb * c + ch0;
  out.yt = y + base;
  walk_column<kApplyUnroll>(x + base, l, rows, c, out);
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

// The "cluster" route's shared memory: as _gn_cluster_smem in
// ops/tiling.py
inline size_t cluster_smem(int pixels, int slice_c, int cpg, int threads,
                           size_t itemsize) {
  const size_t vec = kVectorBytes / itemsize;
  return (size_t)pixels * slice_c * itemsize +
         4 * ((size_t)threads * vec + 5 * (size_t)(slice_c / cpg));
}

template <typename T>
int launch_cluster(const void* x, const void* w, const void* b, void* y,
                   void* dmean, void* rstd, int n, int hw, int c, int groups,
                   float eps, int silu, int slice_c, int cluster, int pixels,
                   int threads, cudaStream_t stream) {
  constexpr int kVec = kVectorBytes / (int)sizeof(T);
  const int cpg = c / groups;
  const int nj = slice_c / kVec;
  const size_t smem = cluster_smem(pixels, slice_c, cpg, threads, sizeof(T));
  // the geometry of gn_one_pass_geometry: whole groups and vectors a slice,
  // a vector column a thread, every pixel in one block, at least one each
  if (slice_c < 1 || slice_c % cpg != 0 || slice_c % kVec != 0 ||
      c % slice_c != 0 || cluster < 1 || cluster > kClusterMax ||
      pixels < 1 || (long long)pixels * cluster < hw ||
      (long long)pixels * (cluster - 1) >= hw || threads < 32 ||
      threads > kClusterThreads || threads % 32 != 0 || threads % nj != 0 ||
      slice_c / cpg > threads ||
      smem > (size_t)kSmemBytes || n > 65535 || c / slice_c > 65535 ||
      !is_aligned(x, kVectorBytes) || !is_aligned(y, kVectorBytes))
    return (int)cudaErrorInvalidValue;
  using Fn = void (*)(const T*, const float*, const float*, T*, float*,
                      float*, int, int, int, int, int, float);
  static const Fn forms[8] = GN_FORMS(gn_one_pass_kernel_cluster, T);
  const Fn kernel = forms[form(silu, w, b)];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, c / slice_c, n);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y),
      static_cast<float*>(dmean), static_cast<float*>(rstd), hw, c, groups,
      slice_c, pixels, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The two-pass pair's launch, as gn_two_pass_geometry (ops/tiling.py)
// gives it: the route (kRouteVector, else the scalar kernels), and on the
// vector route the pixel rows and threads of a block and the slots (tpb)
// of a stats block (an apply block takes one).
struct TwoPass {
  int route, rows, threads, tpb;
};
constexpr int kRouteVector = 0;

// The "vector" stats block's dynamic shared memory: red, two fp32 sums a
// pixel row and channel
inline size_t two_pass_smem(const TwoPass& g, int c) {
  return 2 * (size_t)g.rows * c * sizeof(float);
}

// the "vector" route's geometry: rows pixel rows of nj = c / vec vector
// columns (rows <= hwb), padded to whole warps (fewer than 32 idle
// threads), at most kTwoPassMaxThreads, tpb >= 1 slots a block, the
// stats block's shared memory within the 48 KB a launch takes unasked
inline bool two_pass_vec_ok(const TwoPass& g, const void* x, const void* y,
                            int c, int hwb, long long slots,
                            size_t itemsize) {
  const int vec = kVectorBytes / (int)itemsize;
  if (c % vec != 0) return false;
  const int nj = c / vec;
  const long long active = (long long)g.rows * nj;
  return g.rows >= 1 && g.rows <= hwb && g.threads % 32 == 0 &&
         g.threads <= kTwoPassMaxThreads && active <= g.threads &&
         g.threads - active < 32 && g.tpb >= 1 &&
         (slots + g.tpb - 1) / g.tpb <= 2147483647LL &&
         two_pass_smem(g, c) <= 48 * 1024 &&
         is_aligned(x, kVectorBytes) &&
         (y == nullptr || is_aligned(y, kVectorBytes));
}

template <typename T>
int launch_stats(const void* x, const void* shift, void* psum, void* psq,
                 int n, int hw, int c, int groups, int hwb, TwoPass g,
                 cudaStream_t stream) {
  if (g.route == kRouteVector) {
    const int tiles = hw / hwb;
    const long long slots = (long long)n * tiles;
    if (!two_pass_vec_ok(g, x, nullptr, c, hwb, slots, sizeof(T)))
      return (int)cudaErrorInvalidValue;
    gn_stats_kernel_vec<T>
        <<<(unsigned)((slots + g.tpb - 1) / g.tpb), g.threads,
           two_pass_smem(g, c), stream>>>(static_cast<const T*>(x),
                     static_cast<const float*>(shift),
                     static_cast<float*>(psum), static_cast<float*>(psq), c,
                     groups, hwb, tiles, slots, g.rows, g.tpb);
    return (int)cudaGetLastError();
  }
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
                 int n, int hw, int c, int groups, int hwb, TwoPass g,
                 int silu, cudaStream_t stream) {
  if (g.route == kRouteVector) {
    const int tiles = hw / hwb;
    const long long slots = (long long)n * tiles;
    if (!two_pass_vec_ok(g, x, y, c, hwb, slots, sizeof(T)))
      return (int)cudaErrorInvalidValue;
    using Fn = void (*)(const T*, const float*, const float*, const float*,
                        const float*, const float*, T*, int, int, int, int,
                        int);
    static const Fn forms[8] = GN_FORMS(gn_apply_kernel_vec, T);
    forms[form(silu, w, b)]<<<(unsigned)slots, g.threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(shift),
        static_cast<const float*>(dmean), static_cast<const float*>(rstd),
        static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<T*>(y), c, groups, hwb, tiles, g.rows);
    return (int)cudaGetLastError();
  }
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
// element x[n, 0, g * c / groups]. silu: 1 = SiLU epilogue. route
// (gn_one_pass_geometry in ops/tiling.py): 0 = "cluster" (slice_c
// channels a cluster of `cluster` blocks, `pixels` pixels and `threads`
// threads a block; x and y 16-byte aligned), 1 = "staged" (the group's
// slab in shared memory, hw * c / groups * 4 bytes; gate gn_one_pass_ok),
// 2 = "unstaged" (x read from device memory in each pass); the last four
// are not read for routes 1 and 2.
extern "C" int apex_gn_one_pass(const void* x, const void* w, const void* b,
                                void* y, void* dmean, void* rstd, int n,
                                int hw, int c, int groups, float eps,
                                int silu, int route, int slice_c,
                                int cluster, int pixels, int threads,
                                int dtype, void* stream) {
  if (!shape_ok(n, hw, c, groups) || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (dtype == 0)
      return launch_cluster<float>(x, w, b, y, dmean, rstd, n, hw, c, groups,
                                   eps, silu, slice_c, cluster, pixels,
                                   threads, s);
    if (dtype == 1)
      return launch_cluster<__nv_bfloat16>(x, w, b, y, dmean, rstd, n, hw, c,
                                           groups, eps, silu, slice_c,
                                           cluster, pixels, threads, s);
    return (int)cudaErrorInvalidValue;
  }
  const int staged = route == 1;
  if (dtype == 0)
    return launch_one_pass<float>(x, w, b, y, dmean, rstd, n, hw, c, groups,
                                  eps, silu, staged, s);
  if (dtype == 1)
    return launch_one_pass<__nv_bfloat16>(x, w, b, y, dmean, rstd, n, hw, c,
                                          groups, eps, silu, staged, s);
  return (int)cudaErrorInvalidValue;
}

// The two-pass pair's geometry (gn_two_pass_geometry in ops/tiling.py):
// route 0 = "vector" (rows pixel rows of 16-byte vector columns, threads a
// block, tpb slots a stats block; x and y 16-byte aligned, c whole
// vectors), 1 = "scalar" (a block of kTileThreads per (tile, sample);
// rows, threads and tpb not read).
// shift: float32 [n, groups], the group's first element. psum / psq:
// float32 [n, hw / hwb, groups], written whole. hwb divides hw.
extern "C" int apex_gn_stats(const void* x, const void* shift, void* psum,
                             void* psq, int n, int hw, int c, int groups,
                             int hwb, int route, int rows, int threads,
                             int tpb, int dtype, void* stream) {
  if (!shape_ok(n, hw, c, groups) || hwb < 1 || hw % hwb != 0 ||
      route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TwoPass g{route, rows, threads, tpb};
  if (dtype == 0)
    return launch_stats<float>(x, shift, psum, psq, n, hw, c, groups, hwb, g,
                               s);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16>(x, shift, psum, psq, n, hw, c, groups,
                                       hwb, g, s);
  return (int)cudaErrorInvalidValue;
}

// shift, dmean (mean - shift) and rstd: float32 [n, groups]; w / b as for
// apex_gn_one_pass; hwb divides hw; route, rows, threads as for
// apex_gn_stats (one slot a block).
extern "C" int apex_gn_apply(const void* x, const void* shift,
                             const void* dmean, const void* rstd,
                             const void* w, const void* b, void* y, int n,
                             int hw, int c, int groups, int hwb, int route,
                             int rows, int threads, int silu, int dtype,
                             void* stream) {
  if (!shape_ok(n, hw, c, groups) || hwb < 1 || hw % hwb != 0 ||
      route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TwoPass g{route, rows, threads, 1};
  if (dtype == 0)
    return launch_apply<float>(x, shift, dmean, rstd, w, b, y, n, hw, c,
                               groups, hwb, g, silu, s);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(x, shift, dmean, rstd, w, b, y, n, hw,
                                       c, groups, hwb, g, silu, s);
  return (int)cudaErrorInvalidValue;
}
