// Flash-attention forward for Hopper (sm_90a), fp32 at head widths 128 and
// 256, on the tensor cores: o = softmax(q k^T * scale) v with an online
// softmax, plus the fp32 row log-sum-exp, both products run as split-TF32
// ("3xTF32") mma.sync products, the way fp32 SDPA's memory-efficient
// backend runs its own (CUTLASS's OpMultiplyAddFastF32). The fp32 forward
// at d = 64 (flash_attention.cu) and the fp32 backward pair
// (flash_attention_bwd.cu) stay on the FMA pipes; bf16 runs the wgmma
// kernels.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py `flash_attention_fwd`
// (the Pallas kernel `_fa_fwd_kernel`) in fp32 at the head widths 128 and
// 256 that its BlockSpecs carry, causal or not, with or without an additive
// fp32 score bias (read through per-dimension strides, 0 on a broadcast
// dimension: never expanded), with or without attention dropout (the keep
// factor of `Dropout`, common.cuh, JAX's mask bit for bit, times p before
// the p.v product; l and lse from the undropped p). JAX layout q (b, h, sq,
// d), k / v (b, h, sk, d); the wrapper pads any d from 65 to 255 up to 128
// or 256 with zero columns. On the TPU an fp32 dot runs on the matrix unit
// as a multi-pass product (`_scores`); the split TF32 product is Hopper's
// counterpart.
//
// The split. Every fp32 operand x is cut into big = cvt.rna.tf32(x) (the
// nearest TF32 value, ties away from zero) and small = x - big (exact in
// fp32; the tensor core reads its top 19 bits), and a product a.b is three
// TF32 products, the small ones first, as CUTLASS's OpMultiplyAddFastF32
// orders them: small(a).big(b), big(a).small(b), then big(a).big(b). The
// one left out, small.small, is below 2^-22 of |a||b|. One TF32 product
// alone (about three decimal digits) would miss the fp32 tolerances by an
// order of magnitude.
//
// The accumulators. A tensor core's sum drops the bits of its addends
// below the largest one's last place, toward zero, so a chain of products
// into one accumulator is biased in proportion to its length and to the
// sum's size: chained over all of d and all keys, o and lse on scores
// drawn at twice unit scale landed past 2e-5 at d = 256 on an H100. So the
// small products of a score go to their own
// accumulator (2^-11 of the big ones' size), the big ones of each kChunk =
// 64 columns to a fresh one added to the score in fp32, and each key
// tile's p.V to a fresh one merged into o as fma(o, alpha, acc): o and lse
// then stay within the fp32 tolerances (2e-5) of the plain version, as
// fp32 SDPA's o does (PERF.md gives both errors).
//
// Conventions kept from the TPU kernel and the FMA kernel: scores in fp32,
// the scale applied after the product (__fmul_rn) and the bias added with
// __fadd_rn, masked scores at -1e30 (a score <= -0.5e30, from the bias
// too, is out of the softmax support), the rescale of a row whose running
// max is still "masked" shifted by 0, fully masked rows give o = 0 and lse
// = -1e30, lse = m + log(l) in fp32, the accurate expf and logf, one pass
// over the keys with an online softmax.
//
// What bounds it on this card: operations, on the tensor cores. Two s x s
// x d products per head (half of each when causal), each three TF32
// products: at 495 TFLOP/s of dense TF32 that is 0.208 ms at Cerebras-GPT
// 1.3B's causal 2 x 16 x 2048 x 128 and 0.417 ms at GPT-J's 2 x 16 x 2048 x
// 256 (chip_smoke.py's `tf32x3` peak); on the FMA pipes (67 TFLOP/s) the
// same work is 0.513 / 1.026 ms, which no fp32 FMA kernel of the port came
// within half of. The split costs a cvt and a sub an operand value, and
// the online softmax (a row max, an expf a score) sits between the two
// products of every tile.
//
// What the design does about that:
// - mma.sync.m16n8k8 TF32 products with operands split in registers.
//   A warp owns 16 query rows (one m16 fragment) and its part of a tile's
//   keys (all of them at d = 128); lane (g, t) = (lane / 4, lane % 4). Q,
//   K and V stay raw fp32 in shared memory; a fragment is split as it is
//   loaded. A Q fragment serves the warp's kWarpKeys / 8 key fragments of
//   a tile.
// - Vector loads without bank conflicts. A product's 8-deep step may take
//   the d columns in any order, the same for both operands: lane t holds
//   columns 4t .. 4t + 3 of each 16 (one float4), the first two as k
//   positions t and t + 4 of one step, the last two of the next. Q and K
//   rows are kD + 16 floats, so a quarter-warp's float4s (two rows of four
//   chunks) fall in 32 distinct banks.
// - p stays in registers. S's accumulator gives lane (g, t) keys 2t and 2t
//   + 1 of each 8 (rows g and g + 8); p.V takes key 2t as k position t and
//   key 2t + 1 as k position t + 4, so the accumulator is the A fragment
//   as it stands (its registers reordered), and V's B fragment is rows 2t
//   and 2t + 1. o's n position n of n-tile (c, e) is d column 32c + 4n + e:
//   lane g reads V's columns 32c + 4g .. + 3 as one float4 for four
//   n-tiles, and holds o's columns 32c + 8t .. + 7 of its rows (two float4
//   stores). V rows are kD + 4 floats, so those float4s fall in 32 distinct
//   banks. No p strip, no __syncwarp.
// - Asynchronous copies as in the FMA kernel: kStages = 2 stages of K / V
//   tiles by 16-byte cp.async (4-byte copies when an operand's base is not
//   16-byte aligned: a misaligned view gives the aligned view's bits), rows
//   past sk zero filled; one block barrier a tile, after which tile t + 1's
//   copies run under tile t's products; Q and the first K in one commit
//   group, the first V in the next.
// - Causal work: a block visits key tiles up to its last row's diagonal;
//   the grid's x runs over batch * heads and y over the query blocks,
//   heaviest first; a warp whose 16 rows see none of a tile's keys (or lie
//   past sq) skips the tile. With a bias, a lane's bias entries of the tile
//   are read before the score product, which hides their latency.
// - Blocks an SM: at d = 128, blocks of 64 rows (4 warps) over 32-key
//   tiles: Q (144-float rows) and two stages of K (144) and V (132) take
//   105 KB, so two blocks (8 warps) share an SM. At d = 256 a lane's o is
//   128 fp32 and a block's Q and stages take 201 KB (272 / 260-float
//   rows), so one block an SM; to give it 8 warps, two warps share each
//   16-row group (kKeySplit = 2), each taking half of every 32-key tile
//   with its own online softmax, and meet at the end through the stages
//   (the second hands its m, l and o to the first, which merges them as a
//   tile). 64-row blocks of 4 warps were slower on an H100, and 128-row
//   blocks of 8 warps left the causal grid's heaviest block twice this
//   one's work: with few heads (Nemotron-4's 8 at 2048) that block sets
//   the time (PERF.md). The addresses that only the copies
//   and the epilogue use are taken again from the block index there, which
//   kept the forms without a bias free of spills.
// - Exactness: each block owns its output rows, no atomics: two runs give
//   the same bits. l is a lane's partial over its keys, summed over the
//   four lanes of a row at the end (every lane the same bits).
// The geometry is mirrored by fa_tf32_fwd_geometry(d) in ops/tiling.py.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include "fma_tiles.cuh"

namespace {

using namespace apex_port;

constexpr int kWarpRows = 16;  // rows of a warp: one m16 fragment
constexpr int kStages = 2;     // shared-memory stages of K / V tiles
static_assert(kStages == 2, "the pipeline below prefetches one tile");
constexpr float kNegInf = -1e30f;
constexpr float kMaskEdge = 0.5f * kNegInf;

// What depends on the head width kD (128 or 256): the query rows of a
// block, the keys of a streamed tile and the blocks an SM that their
// shared memory allows.
template <int kD>
struct TfGeometry;
template <>
struct TfGeometry<128> {
  static constexpr int kBM = 64;
  static constexpr int kBN = 32;
  static constexpr int kKeySplit = 1;
  static constexpr int kBlocksPerSM = 2;
};
template <>
struct TfGeometry<256> {
  static constexpr int kBM = 64;
  static constexpr int kBN = 32;
  static constexpr int kKeySplit = 2;
  static constexpr int kBlocksPerSM = 1;
};

template <int kD>
struct Tf : TfGeometry<kD> {
  using TfGeometry<kD>::kBM;
  using TfGeometry<kD>::kBN;
  using TfGeometry<kD>::kKeySplit;
  using TfGeometry<kD>::kBlocksPerSM;
  static constexpr int kRowWarps = kBM / kWarpRows;  // warps of a key part
  static constexpr int kThreads = 32 * kRowWarps * kKeySplit;
  static constexpr int kWarpKeys = kBN / kKeySplit;  // a warp's keys a tile
  static constexpr int kQKStride = kD + 16;  // Q and K rows (floats)
  static constexpr int kVStride = kD + 4;    // V rows
  static constexpr int kKTile = kBN * kQKStride;
  static constexpr int kVTile = kBN * kVStride;
  static constexpr int kNT = kWarpKeys / 8;  // S's n-tiles: p.V's k steps
  static constexpr int kOC = kD / 32;   // o's groups of 4 n-tiles
  static constexpr int kChunk = 64;     // columns of a fresh big sum
  // Q (block rows), then K and V per stage
  static constexpr int kSmemFloats =
      kBM * kQKStride + kStages * (kKTile + kVTile);
  // with the keys split, a part's m, l and o for each lane, laid out
  // element-major over the stages once the loop is done
  static constexpr int kPartFloats = 32 * (kD / 2 + 4);
  static_assert((kKeySplit - 1) * kRowWarps * kPartFloats <=
                    kStages * (kKTile + kVTile),
                "the key parts meet in the stages");
  static_assert(kQKStride % 32 == 16 && kVStride % 32 == 4,
                "float4 fragments in 32 distinct banks");
  static_assert(kD % 32 == 0 && kBN % 8 == 0, "whole fragments");
  // kBlocksPerSM blocks, each with the 1 KB the hardware reserves, in the
  // SM's 228 KB of shared memory
  static_assert(kBlocksPerSM * (kSmemFloats * 4 + 1024) <= 233472,
                "kBlocksPerSM blocks an SM");
};

// x as a split pair: big = x rounded to TF32 (ties away from zero), small =
// x - big, exact in fp32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a . b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b as three TF32 products of the split operands, the small ones
// first: small(a) big(b), big(a) small(b), big(a) big(b)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

// s[j] + sl[j] = Q's rows g and g + 8 of the warp . K's keys 8j + g over
// all kD columns: the small products into sl, the big ones of each
// kChunk columns into a fresh accumulator, added to s with one rounding
// (a tensor core's sum drops the bits of its addends below its largest
// one's last place, always toward zero: chained over all of d, that bias
// would grow with the depth). qa / qb: Q rows g and g + 8 at column 4t;
// kr: K row g at column 4t. Of each 16 columns, lane t's 4t, 4t + 1 are k
// positions t, t + 4 of the first step and 4t + 2, 4t + 3 those of the
// second.
template <int kD, int kStride, int kChunk, int kNT>
__device__ __forceinline__ void score_product(float (&s)[kNT][4],
                                              float (&sl)[kNT][4],
                                              const float* qa,
                                              const float* qb,
                                              const float* kr) {
#pragma unroll 1
  for (int c0 = 0; c0 < kD; c0 += kChunk) {
    float part[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int c = c0; c < c0 + kChunk; c += 16) {
      const float4 xa = *reinterpret_cast<const float4*>(qa + c);
      const float4 xb = *reinterpret_cast<const float4*>(qb + c);
      uint32_t ab[2][4], as[2][4];
      split(xa.x, ab[0][0], as[0][0]);
      split(xb.x, ab[0][1], as[0][1]);
      split(xa.y, ab[0][2], as[0][2]);
      split(xb.y, ab[0][3], as[0][3]);
      split(xa.z, ab[1][0], as[1][0]);
      split(xb.z, ab[1][1], as[1][1]);
      split(xa.w, ab[1][2], as[1][2]);
      split(xb.w, ab[1][3], as[1][3]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float4 y =
            *reinterpret_cast<const float4*>(kr + 8 * j * kStride + c);
        uint32_t bb[4], bs[4];
        split(y.x, bb[0], bs[0]);
        split(y.y, bb[1], bs[1]);
        split(y.z, bb[2], bs[2]);
        split(y.w, bb[3], bs[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(sl[j], as[h], bb[2 * h], bb[2 * h + 1]);
          mma(sl[j], ab[h], bs[2 * h], bs[2 * h + 1]);
          mma(part[j], ab[h], bb[2 * h], bb[2 * h + 1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
  }
}

// o[c][e] = o[c][e] * alpha + p . V of this tile, the tile's product in a
// fresh accumulator (one rounding where it meets o; chained over all keys,
// the tensor cores' truncation would bias o): p's k step j is the tile's
// keys 8j .. + 7, key 2t as k position t and key 2t + 1 as t + 4 (p[j] is
// S's accumulator: rows g, g + 8 at keys 2t, 2t + 1); o's n-tile (c, e)
// holds d columns 32c + 4n + e. vr: V row 2t at column 4g.
template <int kOC, int kStride, int kNT>
__device__ __forceinline__ void out_product(float (&o)[kOC][4][4],
                                            const float (&p)[kNT][4],
                                            const float (&alpha)[2],
                                            const float* vr) {
  uint32_t ab[kNT][4], as[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    split(p[j][0], ab[j][0], as[j][0]);  // row g, k position t
    split(p[j][2], ab[j][1], as[j][1]);  // row g + 8, k position t
    split(p[j][1], ab[j][2], as[j][2]);  // row g, k position t + 4
    split(p[j][3], ab[j][3], as[j][3]);  // row g + 8, k position t + 4
  }
#pragma unroll
  for (int c = 0; c < kOC; ++c) {
    float acc[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[e][u] = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* v0 = vr + 8 * j * kStride + 32 * c;
      const float4 y0 = *reinterpret_cast<const float4*>(v0);
      const float4 y1 = *reinterpret_cast<const float4*>(v0 + kStride);
      uint32_t bb0[4], bs0[4], bb1[4], bs1[4];
      split(y0.x, bb0[0], bs0[0]);
      split(y0.y, bb0[1], bs0[1]);
      split(y0.z, bb0[2], bs0[2]);
      split(y0.w, bb0[3], bs0[3]);
      split(y1.x, bb1[0], bs1[0]);
      split(y1.y, bb1[1], bs1[1]);
      split(y1.z, bb1[2], bs1[2]);
      split(y1.w, bb1[3], bs1[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mma3(acc[e], ab[j], as[j], bb0[e], bb1[e], bs0[e], bs1[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        o[c][e][u] = fmaf(o[c][e][u], alpha[u >> 1], acc[e][u]);
  }
}

// the flat batch * head index of a block: the grid is (grid_y, query
// blocks, grid_z) of fa_batch_heads_grid's split, x (dispatched first)
// over batch * heads, so each query block is launched for every head
// before the next, lighter one
__device__ __forceinline__ long long block_head() {
  return (long long)blockIdx.z * gridDim.x + blockIdx.x;
}
// the same, read again from the special registers, so that an address
// taken from it keeps no register live across the main loop
__device__ __forceinline__ long long block_head_again() {
  unsigned x, z;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
  return (long long)z * gridDim.x + x;
}

template <int kD, bool kBias, bool kDropout>
__global__ void __launch_bounds__(Tf<kD>::kThreads, Tf<kD>::kBlocksPerSM)
fa_fwd_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int nbh, int sq, int sk,
                   float scale, int causal, int vec, ScoreBias bias,
                   Dropout drop) {
  using G = Tf<kD>;
  constexpr int kBM = G::kBM, kBN = G::kBN, kNT = G::kNT, kOC = G::kOC,
                kQK = G::kQKStride, kV = G::kVStride,
                kThreads = G::kThreads, kRowWarps = G::kRowWarps;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kBM][kQK]
  float* stage = qs + kBM * kQK;      // [kStages][K [kBN][kQK], V [kBN][kV]]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = block_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest first
  const float* bs = kBias ? bias.slice(bh) : nullptr;
  const uint32_t dhead = kDropout ? drop.head(bh) : 0u;
  int nk = (sk + kBN - 1) / kBN;
  if (causal) nk = min(nk, (min(q0 + kBM, sq) - 1) / kBN + 1);

  // K (which 0) or V (which 1) of tile kt into its stage; the head's base
  // is taken again for each copy (kept live over the loop, it went to
  // local memory at d = 256)
  auto load = [&](int kt, int which) {
    const long long base = block_head_again() * sk * kD;
    float* st = stage + (kt % kStages) * (G::kKTile + G::kVTile);
    if (which == 0)
      copy_tile<kBN, kThreads, kD, kQK>(st, k + base, kt * kBN, sk, vec);
    else
      copy_tile<kBN, kThreads, kD, kV>(st + G::kKTile, v + base, kt * kBN,
                                       sk, vec);
  };
  // two commit groups: Q with tile 0's K (the S product), then its V
  copy_tile<kBM, kThreads, kD, kQK>(qs, q + bh * sq * kD, q0, sq, vec);
  if (nk > 0) load(0, 0);
  cp_async_commit();
  if (nk > 0) load(0, 1);
  cp_async_commit();

  // warp (part, row group): rows r0 .. + 15 and the part's kWarpKeys keys
  // of each tile
  const int part = warp / kRowWarps;
  const int r0 = (warp % kRowWarps) * kWarpRows;
  const int row_a = q0 + r0 + g;          // the lane's rows: row_a, row_a + 8
  const int warp_row0 = q0 + r0;
  const float* qa = qs + (r0 + g) * kQK + 4 * t;
  const float* qb = qa + 8 * kQK;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kOC][4][4];
#pragma unroll
  for (int c = 0; c < kOC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[c][e][u] = 0.f;

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
    const float* ks = stage + (kt % kStages) * (G::kKTile + G::kVTile) +
                      part * G::kWarpKeys * kQK;
    const float* vs = stage + (kt % kStages) * (G::kKTile + G::kVTile) +
                      G::kKTile + part * G::kWarpKeys * kV;
    const int k0 = kt * kBN + part * G::kWarpKeys;  // the warp's first key
    // the warp's 16 rows lie past sq, or its keys past sk, or (causal) its
    // rows see none of its keys
    const bool idle = warp_row0 >= sq || k0 >= sk ||
                      (causal && k0 > warp_row0 + kWarpRows - 1);
    float s[kNT][4], alpha[2];
    if (!idle) {
      // the lane's bias entries, read before the product: (row_a, row_a +
      // 8) x (keys 8j + 2t, + 1); 0 past sq or sk (those scores are not
      // kept)
      float bv[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_a + 8 * (e >> 1);
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          bv[j][e] = kBias && row < sq && key < sk ? bias.at(bs, row, key)
                                                   : 0.f;
        }
      float sl[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
      score_product<kD, kQK, G::kChunk>(s, sl, qa, qb, ks + g * kQK + 4 * t);
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_a + 8 * (e >> 1);
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          // __fmul_rn / __fadd_rn: no FMA contraction, so the score is
          // round(round(q.k * scale) + bias) of the split product's q.k
          float a = __fmul_rn(__fadd_rn(s[j][e], sl[j][e]), scale);
          if (kBias) a = __fadd_rn(a, bv[j][e]);
          if (key >= sk || (causal && key > row)) a = kNegInf;
          s[j][e] = a;
          mt[e >> 1] = fmaxf(mt[e >> 1], a);
        }
      float m_safe[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the row's max over its four lanes (t = 0..3 of one g)
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        m_safe[r] = m_new <= kMaskEdge ? 0.f : m_new;
        alpha[r] = expf((m[r] <= kMaskEdge ? kNegInf : m[r]) - m_safe[r]);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m_safe[e >> 1]);
          ps[e >> 1] += p;
          // dropout: p times its keep factor into the p.v product only
          s[j][e] = kDropout ? p * drop.keep(dhead, row_a + 8 * (e >> 1),
                                             k0 + 8 * j + 2 * t + (e & 1))
                             : p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
    }
    if (kt == 0) {  // the first V
      cp_async_wait<1>();
      __syncthreads();
    }
    if (!idle)
      out_product<kOC, kV>(acc, s, alpha, vs + 2 * t * kV + 4 * g);
  }
  cp_async_wait<0>();

  if (G::kKeySplit > 1) {
    // the key parts meet: part 1 hands its m, l and o to part 0 of its row
    // group through the stages, which merges them as the online softmax
    // merges a tile
    __syncthreads();  // every warp is done with the stages
    float* xs = stage + (warp % kRowWarps) * G::kPartFloats + lane;
    if (part == 1) {
#pragma unroll
      for (int c = 0; c < kOC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < 4; ++u) xs[32 * (16 * c + 4 * e + u)] =
              acc[c][e][u];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xs[32 * (kD / 2 + r)] = m[r];
        xs[32 * (kD / 2 + 2 + r)] = l[r];
      }
    }
    __syncthreads();
    if (part == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xs[32 * (kD / 2 + r)];
      const float m_new = fmaxf(m[r], m1);
      const float m_safe = m_new <= kMaskEdge ? 0.f : m_new;
      a0[r] = expf((m[r] <= kMaskEdge ? kNegInf : m[r]) - m_safe);
      a1[r] = expf((m1 <= kMaskEdge ? kNegInf : m1) - m_safe);
      l[r] = l[r] * a0[r] + xs[32 * (kD / 2 + 2 + r)] * a1[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[c][e][u] = fmaf(acc[c][e][u], a0[u >> 1],
                              xs[32 * (16 * c + 4 * e + u)] * a1[u >> 1]);
  }

  const long long bh_rows = block_head_again() * sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float safe_l = sum > 0.f ? sum : 1.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[c][e][2 * r] = acc[c][e][2 * r] / safe_l;
        acc[c][e][2 * r + 1] = acc[c][e][2 * r + 1] / safe_l;
      }
    const int row = row_a + 8 * r;
    if (t == 0 && row < sq)
      lse[bh_rows + row] = m[r] <= kMaskEdge ? kNegInf : m[r] + logf(safe_l);
    if (row >= sq) continue;
    // columns 32c + 8t + 4h + e of the row: acc[c][e][2r + h]
    float* dst = o + (bh_rows + row) * kD + 8 * t;
#pragma unroll
    for (int c = 0; c < kOC; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = dst + 32 * c + 4 * h;
        if (vec) {
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[c][0][2 * r + h], acc[c][1][2 * r + h],
                          acc[c][2][2 * r + h], acc[c][3][2 * r + h]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = acc[c][e][2 * r + h];
        }
      }
  }
}

template <int kD>
auto form(bool b, bool d) {
  // a separate instantiation for each form, so the kernel without a bias
  // or dropout keeps no registers or branches of theirs
  return b ? (d ? fa_fwd_kernel_tf32<kD, true, true>
                : fa_fwd_kernel_tf32<kD, true, false>)
           : (d ? fa_fwd_kernel_tf32<kD, false, true>
                : fa_fwd_kernel_tf32<kD, false, false>);
}

// the kernel's shared memory, and all of the SM's unified memory as shared
// memory, so that kBlocksPerSM blocks fit
template <int kD, typename F>
int prepare(F kernel) {
  const int smem = (int)(Tf<kD>::kSmemFloats * sizeof(float));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  return smem;
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int grid_y, int grid_z, int sq, int sk, float scale,
           int causal, const ScoreBias& bias, const Dropout& drop,
           cudaStream_t stream) {
  using G = Tf<kD>;
  if ((sq + G::kBM - 1) / G::kBM > 65535) return (int)cudaErrorInvalidValue;
  const auto kernel = form<kD>(bias.p != nullptr, drop.seed != nullptr);
  const int smem = prepare<kD>(kernel);
  const dim3 grid(grid_y, (sq + G::kBM - 1) / G::kBM, grid_z);
  kernel<<<grid, G::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), bh, sq, sk, scale, causal,
      (int)(is_aligned(q, 16) && is_aligned(k, 16) && is_aligned(v, 16) &&
            is_aligned(o, 16)),
      bias, drop);
  return (int)cudaGetLastError();
}

template <int kD>
int occupancy(int bias, int drop, int* blocks) {
  const auto kernel = form<kD>(bias != 0, drop != 0);
  const int smem = prepare<kD>(kernel);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, Tf<kD>::kThreads, smem);
}

}  // namespace

// fp32 q, k, v and o; lse is float32 [bh, sq]. d: 128 or 256 (d = 64 is
// apex_fa_fwd's; the wrapper pads any other d from 65 up). grid_y x grid_z
// carry the bh = b * h slices (fa_batch_heads_grid in ops/tiling.py) on
// grid.x and grid.z; grid.y runs over the query blocks. bias: float32 or
// null; heads = h of bh = b * h; bsb, bsh, bsq, bsk its strides in
// elements (0 on a broadcast dimension). seed: the dropout seed, int32 on
// the device, or null without dropout; threshold and keep as in Dropout
// (common.cuh).
extern "C" int apex_fa_fwd_tf32(const void* q, const void* k, const void* v,
                                const void* bias, void* o, void* lse, int bh,
                                int grid_y, int grid_z, int heads, int sq,
                                int sk, int d, float scale, int causal,
                                long long bsb, long long bsh, long long bsq,
                                long long bsk, const void* seed,
                                unsigned threshold, float keep,
                                void* stream) {
  if ((d != 128 && d != 256) || heads < 1 || !bh_grid_ok(bh, grid_y, grid_z))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0) return 0;
  const apex_port::ScoreBias sb{static_cast<const float*>(bias), heads,
                                bsb, bsh, bsq, bsk};
  const apex_port::Dropout dr{static_cast<const int*>(seed), threshold,
                              keep};
  const auto run = d == 128 ? launch<128> : launch<256>;
  return run(q, k, v, o, lse, bh, grid_y, grid_z, sq, sk, scale, causal, sb,
             dr, static_cast<cudaStream_t>(stream));
}

// The resident blocks an SM of the current device holds of the kernel at
// head width d (128 or 256) in the form (bias, dropout), as launched, into
// *blocks.
extern "C" int apex_fa_fwd_tf32_occupancy(int d, int bias, int drop,
                                          int* blocks) {
  if ((d != 128 && d != 256) || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return d == 128 ? occupancy<128>(bias, drop, blocks)
                  : occupancy<256>(bias, drop, blocks);
}
