// Flash-attention forward for Hopper (sm_90a), fp32 at head width 64: o =
// softmax(q k^T * scale) v with an online softmax, plus the fp32 row
// log-sum-exp, on the FMA pipes (full fp32 products). bf16 runs on the
// tensor cores instead (flash_fwd_wgmma.cu), and so does fp32 at the head
// widths 128 and 256, as split-TF32 products within the same fp32
// tolerances (flash_fwd_tf32.cu), as fp32 SDPA runs its own.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py `flash_attention_fwd`
// (the Pallas kernel `_fa_fwd_kernel`), causal or not, with or without an
// additive fp32 score bias, with or without attention dropout (the keep
// factor of `Dropout`, common.cuh, times p before the p.v product; l and
// lse from the undropped p, as `_fa_fwd_kernel` sums them), JAX layout q
// (b, h, sq, d), k / v (b, h, sk, d), d = 64 (the template parameter kD;
// the wrapper pads any d below 64 up to it with zero columns). The bias (a boolean mask arrives as
// -1e30 where masked, `flash_attention`'s rule) is broadcastable to
// (b, h, sq, sk) and read through per-dimension strides, 0 on a broadcast
// dimension, so a (b, 1, 1, sk) padding mask is never expanded (the TPU's
// `_BiasPlan` rule): s = (q . k) * scale + bias.
// Conventions kept from the TPU kernel: scores in fp32, masked scores set to
// -1e30 (a score <= -0.5e30, from the bias too, is out of the softmax
// support), the rescale of a row whose running max is still "masked"
// shifted by 0 so exp() underflows to 0, p cast to v's dtype (fp32 here:
// no rounding) before the p.v product, fully masked rows give o = 0 and
// lse = -1e30, lse = m + log(l) in fp32, the accurate expf and logf.
//
// What bounds it on this card: operations, on the FMA pipes. At GPT-2's
// shapes (b = 4, h = 12, s = 1024, d = 64, causal) it does two s x s x d
// products per head (S = q k^T and o = p v, half of each when causal) over
// 16 bytes per (row, d) element of traffic: hundreds of flops a byte. A
// sub-partition issues one warp instruction a clock and retires one warp
// FFMA a clock, so every other instruction in a product loop takes an
// FFMA's slot; the online softmax (a row max, 40 expf a lane a tile) sits
// between the two products of every tile.
//
// What the design does about that (the backward's design,
// flash_attention_bwd.cu, with the softmax between the products):
// - Register-blocked products. A block of kThreads = 128 threads (4 warps,
//   two blocks an SM) owns kBM = 64 query rows and streams kBN = 64-row
//   K / V tiles. (Against 8-warp blocks of 128 rows, one an SM, the
//   backward's height: two blocks overlap one's copies and barrier with
//   the other's products, and short sequences leave fewer warps idle;
//   PERF.md has the times of both on an H100.)
//   Warp w owns rows 16 w .. + 15 and ALL 64 keys of a tile:
//   lane (ly, lx) = (lane / 16, lane % 16) holds an 8 x 4 micro-tile of S
//   (rows ly + 2i, keys lx + 16j) and an 8 x 4 block of o (the same rows, d
//   columns 4 lx .. + 3). Every operand is a 16-byte float4 from a
//   row-major tile whose row stride is padded to kStride = 68 floats, so
//   the 8 keys or V chunks a quarter-warp reads fall in 32 distinct banks
//   and its Q or p rows are one address: 12 shared-memory loads feed 128
//   FFMAs in both product loops (fma_tiles.cuh). A lane writes p to its
//   warp's strip of 16 padded rows, and reads the strip's rows back as the
//   left operand of p v after a __syncwarp.
// - The online softmax stays inside the warp. The layout that splits a
//   tile's keys over a warp pair (the backward's) would need a pair
//   exchange of every row's max through shared memory and a named barrier
//   each tile; with a warp's 16 rows over all 64 keys the max is 4
//   shuffles within the 16 lanes of a row, and p v needs no pair barrier
//   either. The row sum l stays a per-lane partial (the lane's 4 keys of
//   each tile, rescaled with o) and is summed over the 16 lanes once, at
//   the end (a butterfly: every lane gets the same bits). So l is summed
//   in another order than the plain version's whole-row sum (and than the
//   first version's per-tile warp sum): o and lse move by an ulp or so,
//   inside FA_TOL / LSE_TOL. Each score is summed over d = 0..63 in order
//   and each o element over keys in order, as before.
// - Asynchronous copies. K and V go through kStages = 2 shared-memory
//   stages by 16-byte `cp.async` copies into the padded rows (4-byte
//   copies when an operand's base is not 16-byte aligned), rows past sk
//   zero filled. One block barrier a tile: after it, tile t has landed and
//   every warp is done with tile t - 1, so the copies of tile t + 1 start
//   into the freed stage and run under tile t's products. Q is copied
//   once, in the first commit group with the first K; the first V comes in
//   a second group, so S waits only for Q and K.
// - Causal work. A block visits key tiles up to its last row's diagonal.
//   The grid's x runs over batch * heads and y over the query blocks,
//   heaviest first, so the hardware dispatches every head's heaviest block
//   before any lighter one. Inside a visited tile a warp whose 16 rows see
//   none of its keys (or lie past sq) skips the products (its rows' m, l
//   and o would not change).
// - Exactness. The score is __fmul_rn / __fadd_rn (no FMA contraction);
//   each block owns its output rows, with no atomics: two runs give the
//   same bits.
// The geometry is mirrored by fa_fma_fwd_geometry() in ops/tiling.py.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include "fma_tiles.cuh"

namespace {

using namespace apex_port;

constexpr int kBM = 64;         // query rows a block owns
constexpr int kMI = 8;          // rows of a lane's micro-tiles
constexpr int kWarpRows = 16;   // rows of a warp: all of a tile's keys
constexpr int kThreads = 32 * kBM / kWarpRows;  // 4 warps
constexpr int kStages = 2;      // shared-memory stages of K / V tiles
static_assert(kStages == 2, "the pipeline below prefetches one tile");
constexpr int kUnroll = 4;      // float4 steps of a product loop unrolled
constexpr int kRowStep = kWarpRows / kMI;  // a lane's rows: ly + 2 i
constexpr int kColStep = 16;    // a lane's keys: lx + 16 j
constexpr float kNegInf = -1e30f;
constexpr float kMaskEdge = 0.5f * kNegInf;

// What depends on the head dim kD (64 only: fp32 at 128 and 256 is
// flash_fwd_tf32.cu's): the padded row stride of Q, K and V (floats), the
// key rows of a streamed tile and the blocks an SM that their shared
// memory allows.
template <int kD>
struct FwdGeometry;
template <>
struct FwdGeometry<64> {
  static constexpr int kStride = 68;
  static constexpr int kBN = 64;
  static constexpr int kBlocksPerSM = 2;
};

template <int kD>
struct Fwd : FwdGeometry<kD> {
  using FwdGeometry<kD>::kStride;
  using FwdGeometry<kD>::kBN;
  using FwdGeometry<kD>::kBlocksPerSM;
  static constexpr int kNJ = kBN / kColStep;  // a lane's keys of a tile
  static constexpr int kSStride = kBN + 4;    // padded row stride of p
  static constexpr int kGroups = kD / 64;  // 64-column groups of o
  static constexpr int kTile = kBN * kStride;  // floats of a streamed tile
  // Q, the p strip (block rows), then K / V per stage
  static constexpr int kSmemFloats =
      kBM * kStride + kBM * kSStride + kStages * 2 * kTile;
  static_assert(kStride == kD + 4, "the head dim padded by one chunk");
  static_assert(kStride % 4 == 0 && (kStride / 4) % 2 == 1 &&
                    kSStride % 4 == 0 && (kSStride / 4) % 2 == 1,
                "16-byte rows whose chunks fall in distinct banks");
  static_assert(kNJ * kColStep == kBN, "16 lanes cover a tile's keys");
  // kBlocksPerSM blocks, each with the 1 KB the hardware reserves, in
  // the SM's 228 KB of shared memory
  static_assert(kBlocksPerSM * (kSmemFloats * 4 + 1024) <= 233472,
                "kBlocksPerSM blocks an SM");
};

static_assert(kRowStep == 32 / kColStep && 64 == 4 * kColStep,
              "16 lanes cover a row's keys and each 64 d columns");

// max over the 16 lanes of a row (lanes lx = 0..15 of one ly)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The flat batch * head index of a block. The grid is (grid_y, query
// blocks, grid_z) of fa_batch_heads_grid's split: x, which the hardware
// dispatches first, runs over batch * heads, so that each query block is
// launched for every head before the next, lighter one.
__device__ __forceinline__ long long block_head() {
  return (long long)blockIdx.z * gridDim.x + blockIdx.x;
}

template <int kD, bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, Fwd<kD>::kBlocksPerSM)
fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int nbh, int sq, int sk, float scale,
              int causal, int vec, ScoreBias bias, Dropout drop) {
  using G = Fwd<kD>;
  constexpr int kStride = G::kStride, kTile = G::kTile, kBN = G::kBN,
                kNJ = G::kNJ, kSStride = G::kSStride;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [kBM][kStride]
  float* strip = qs + kBM * kStride;    // [kBM][kSStride]: p
  float* stage = strip + kBM * kSStride;  // [kStages][K, V][kBN][kStride]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ly = lane >> 4, lx = lane & 15;
  const long long bh = block_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest first
  const float* kb = k + bh * sk * kD;
  const float* vb = v + bh * sk * kD;
  const float* bs = kBias ? bias.slice(bh) : nullptr;
  const uint32_t dhead = kDropout ? drop.head(bh) : 0u;
  int nk = (sk + kBN - 1) / kBN;
  if (causal) nk = min(nk, (min(q0 + kBM, sq) - 1) / kBN + 1);

  // K (part 0) or V (part 1) of tile kt into its stage
  auto load = [&](int kt, int part) {
    float* st = stage + (kt % kStages) * 2 * kTile + part * kTile;
    copy_tile<kBN, kThreads, kD, kStride>(st, part == 0 ? kb : vb, kt * kBN,
                                          sk, vec);
  };
  // two commit groups: Q with tile 0's K (the S product), then its V
  copy_tile<kBM, kThreads, kD, kStride>(qs, q + bh * sq * kD, q0, sq, vec);
  if (nk > 0) load(0, 0);
  cp_async_commit();
  if (nk > 0) load(0, 1);
  cp_async_commit();

  const int r0 = warp * kWarpRows + ly;  // the lane's first row in the block
  const int warp_row0 = q0 + warp * kWarpRows;
  float m[kMI], l[kMI], acc[G::kGroups][kMI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g) zero(acc[g]);

  for (int kt = 0; kt < nk; ++kt) {
    // tile kt has landed (of tile 0 the first group) for every thread,
    // and every warp is done with tile kt - 1: its stage is free for
    // tile kt + 1
    if (kt == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < nk) {
      load(kt + 1, 0);
      load(kt + 1, 1);
    }
    cp_async_commit();
    const float* ks = stage + (kt % kStages) * 2 * kTile;
    const float* vs = ks + kTile;
    const int k0 = kt * kBN;
    // the warp's 16 rows lie past sq or (causal) see none of these keys
    const bool idle =
        warp_row0 >= sq || (causal && k0 > warp_row0 + kWarpRows - 1);
    if (!idle) {
      float s[kMI][kNJ];
      zero(s);
      score_product<kMI, kRowStep, kColStep, kD, kStride, kUnroll>(
          s, qs + r0 * kStride, ks + lx * kStride);
      float* prow = strip + r0 * kSStride + lx;  // the lane's strip entries
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int row = q0 + r0 + kRowStep * i;
        float mt = kNegInf;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int key = k0 + lx + kColStep * j;
          // __fmul_rn / __fadd_rn: no FMA contraction, so the score is
          // the plain version's round(round(q.k * scale) + bias)
          float a = __fmul_rn(s[i][j], scale);
          if (kBias && row < sq && key < sk)
            a = __fadd_rn(a, bias.at(bs, row, key));
          if (key >= sk || (causal && key > row)) a = kNegInf;
          s[i][j] = a;
          mt = fmaxf(mt, a);
        }
        const float m_prev = m[i];
        const float m_new = fmaxf(m_prev, row_max16(mt));
        const float m_safe = m_new <= kMaskEdge ? 0.f : m_new;
        const float alpha =
            expf((m_prev <= kMaskEdge ? kNegInf : m_prev) - m_safe);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const float p = expf(s[i][j] - m_safe);
          ps += p;
          // dropout: p times its keep factor into the p.v product only
          prow[kRowStep * i * kSStride + kColStep * j] =
              kDropout ? p * drop.keep(dhead, row, k0 + lx + kColStep * j)
                       : p;
        }
        l[i] = l[i] * alpha + ps;
#pragma unroll
        for (int g = 0; g < G::kGroups; ++g)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[g][i][u] *= alpha;
        m[i] = m_new;
      }
    }
    if (kt == 0) {  // the first V
      cp_async_wait<1>();
      __syncthreads();
    }
    if (!idle) {
      __syncwarp();  // the warp's strip rows are whole
      // o's 64-column groups, one product over V's columns each
#pragma unroll
      for (int g = 0; g < G::kGroups; ++g)
        out_product<kMI, kRowStep, kBN, kStride, kUnroll, kSStride>(
            acc[g], strip + r0 * kSStride, vs + 64 * g + lx * 4);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const float sum = row_sum16(l[i]);
    const float safe_l = sum > 0.f ? sum : 1.f;
#pragma unroll
    for (int g = 0; g < G::kGroups; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[g][i][u] = acc[g][i][u] / safe_l;
    const int row = q0 + r0 + kRowStep * i;
    if (lx == 0 && row < sq)
      lse[bh * sq + row] = m[i] <= kMaskEdge ? kNegInf : m[i] + logf(safe_l);
  }
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g)
    store_rows<kMI, kRowStep, kD>(o + bh * sq * kD, acc[g], q0 + r0,
                                  64 * g + lx * 4, sq, vec);
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int grid_y, int grid_z, int sq, int sk, float scale,
           int causal, const ScoreBias& bias, const Dropout& drop,
           cudaStream_t stream) {
  const int smem = (int)(Fwd<kD>::kSmemFloats * sizeof(float));
  // a separate instantiation for each form, so the kernel without a bias
  // or dropout keeps no registers or branches of theirs
  const bool b = bias.p != nullptr, d = drop.seed != nullptr;
  const auto kernel = b ? (d ? fa_fwd_kernel<kD, true, true>
                             : fa_fwd_kernel<kD, true, false>)
                        : (d ? fa_fwd_kernel<kD, false, true>
                             : fa_fwd_kernel<kD, false, false>);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  // all of the SM's unified memory as shared memory: kBlocksPerSM fit
  cudaFuncSetAttribute(kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const dim3 grid(grid_y, (sq + kBM - 1) / kBM, grid_z);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), bh, sq, sk, scale, causal,
      (int)(is_aligned(q, 16) && is_aligned(k, 16) && is_aligned(v, 16) &&
            is_aligned(o, 16)),
      bias, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (q, k, v and o; bfloat16 is apex_fa_fwd_wgmma's);
// lse is float32 [bh, sq]. d: 64 (fp32 at 128 and 256 is
// apex_fa_fwd_tf32's; the wrapper pads any d below 64). grid_y x grid_z
// carry the bh = b * h slices (fa_batch_heads_grid in ops/tiling.py) on
// grid.x and grid.z; grid.y runs over the query blocks. bias: float32 or
// null; heads = h of bh = b * h; bsb, bsh, bsq, bsk its strides in
// elements (0 on a broadcast dimension). seed: the dropout seed, int32 on
// the device, or null without dropout; threshold and keep as in Dropout
// (common.cuh).
extern "C" int apex_fa_fwd(const void* q, const void* k, const void* v,
                           const void* bias, void* o, void* lse, int bh,
                           int grid_y, int grid_z, int heads, int sq, int sk,
                           int d, float scale, int causal, long long bsb,
                           long long bsh, long long bsq, long long bsk,
                           const void* seed, unsigned threshold, float keep,
                           int dtype, void* stream) {
  if (d != 64 || heads < 1 || !bh_grid_ok(bh, grid_y, grid_z))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0) return 0;
  if ((sq + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const apex_port::ScoreBias sb{static_cast<const float*>(bias), heads,
                                bsb, bsh, bsq, bsk};
  const apex_port::Dropout dr{static_cast<const int*>(seed), threshold,
                              keep};
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<64>(q, k, v, o, lse, bh, grid_y, grid_z, sq, sk, scale,
                    causal, sb, dr, s);
}
