// Flash-attention backward for Hopper (sm_90a): dq, dk and dv from the
// forward's fp32 row log-sum-exp, without the (sq, sk) probability matrix.
// Here: the fp32 route, dq and dk / dv. bf16 runs on the tensor cores
// (flash_bwd_dq_wgmma.cu, flash_bwd_dkv_wgmma.cu); fp32 stays on the FMA
// pipes, whose full fp32 products the fp32 tolerances hold.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py `flash_attention_bwd`,
// its two Pallas kernels `_fa_dq_kernel` and `_fa_dkv_kernel`, causal or
// not, with or without an additive fp32 score bias (read through
// per-dimension strides, 0 on a broadcast dimension, never expanded: see
// flash_attention.cu), with or without attention dropout and, in dq, the
// dlogits of a differentiated bias (`want_dbias`), JAX layout q / do
// (b, h, sq, d), k / v (b, h, sk, d), lse and D = rowsum(do * o) as fp32
// (b, h, sq) (D is computed outside the kernels, as the JAX wrapper
// computes it). Per (query i, key j):
//   s  = (q_i . k_j) * scale + bias_ij in fp32, masked where j >= sk or
//        (causal) j > i
//   p  = exp(s - lse_i), exactly 0 where s is masked or lse_i <= -0.5e30
//        (fully masked rows give zero gradients: `_bwd_p`)
//   dp = (do_i . v_j) * keep_ij,  ds = p * (dp - D_i)
//   dq_i += (ds * scale) . k_j
//   dv_j += (p * keep_ij) . do_i
//   dk_j += (ds * scale) . q_i
// where keep_ij is dropout's keep factor (`Dropout`, common.cuh; 1 without
// dropout), and with dlogits the dq kernel also writes ds (fp32) at (i, j)
// for every i < sq, j < sk: 0 where masked or in a key tile it skips.
// The TPU wrapper folds a power-of-two scale into q (`_fold_scale`);
// scaling by a power of two commutes with rounding, so multiplying ds by
// the scale, as here, gives the same dk bits, and the scores the same
// values. Every gradient sums over keys or queries in order; a score sums
// over d in the plain version's sequential order at d = 64, and at d = 128
// and 256 as two or four sequential sums over 64 columns each (d = 0..63,
// 64..127, ...), added in that order: s0 + s1, ((s0 + s1) + s2) + s3.
//
// What bounds it on this card: operations, on the FMA pipes. At GPT-2's
// shapes (b = 4, h = 12, s = 1024, d = 64, causal) the two kernels do
// seven s x s x d products per head (S, dP, dQ in dq; S, dP, dV, dK in
// dK·dV; S and dP computed in both so that no output is summed across
// blocks) over 20 bytes per (row, d) element of traffic: hundreds of
// flops a byte. A sub-partition issues one warp instruction a clock and
// retires one warp FFMA a clock, so every other instruction in a product
// loop takes an FFMA's slot; a 16-byte shared-memory load costs the SM's
// shared memory more clocks when a quarter-warp reads eight addresses than
// when it reads one; and with one block an SM, the order in which blocks
// are dispatched decides how evenly the causal work spreads over the SMs.
//
// What the design does about that:
// - Register-blocked products. A block of kThreads = 256 threads (8 warps,
//   one block an SM) owns kBM = 128 rows (queries in dq, keys in dK·dV)
//   and streams kBN = 64-row tiles (keys in dq, queries in dK·dV). Warp w
//   takes rows 32 (w / 2) .. + 31 and half (w % 2) of the tile (a warp
//   pair, kSplit = 2 warps, shares 32 rows); lane (ly,
//   lx) = (lane / 8, lane % 8) holds an 8 x 4 micro-tile of S or dP (rows
//   ly + 4i, streamed rows lx + 8j) and an 8 x 4 block of each output (the
//   same rows, d columns 4 lx .. + 3 of its half). Every operand is a
//   16-byte float4 from a row-major tile whose row stride is padded to
//   kStride = 68 floats, so the 8 rows a quarter-warp reads fall in 32
//   distinct banks: 12 shared-memory loads feed 128 FFMAs (8 of them one
//   address per quarter), and each product loop is ~90 % FFMA. A lane
//   writes its p and ds * scale to a strip of the block's rows, where it
//   reads them back for the next step and the warp pair reads whole rows
//   as the left operand of the gradient products (after a named barrier
//   of the pair); S is not kept in registers beside dP, which leaves ptxas
//   room to interleave each loop's loads with its FFMAs, and dK·dV runs
//   its two gradient products in one loop.
// - Asynchronous copies. The streamed tiles (K / V in dq; Q / dO and the
//   lse / D slices in dK·dV) go through kStages = 2 shared-memory stages
//   by 16-byte `cp.async` copies into the padded rows (4-byte copies when
//   an operand's base is not 16-byte aligned), rows past sq / sk zero
//   filled. One block barrier a tile: after it, tile t has landed and
//   every warp is done with tile t - 1, so the copies of tile t + 1 start
//   into the freed stage and run under tile t's products. The block's own
//   rows (Q, dO in dq; K, V in dK·dV) are copied the same way once, with
//   the first tile in two commit groups: the S product waits only for Q
//   and K (K and Q in dK·dV), dP for the rest.
// - Causal work. dq visits key tiles up to its last row's diagonal,
//   dK·dV query tiles from its first key's diagonal. The grid's x runs
//   over batch * heads and y over the row blocks, so the hardware
//   dispatches every head's heaviest row block before any lighter one:
//   dispatched head by head, the light blocks of the first heads took SMs
//   that the heavy blocks of the last heads then waited for. Inside a
//   visited tile a warp pair whose 32 rows see none of its keys (or lie
//   past sq / sk) skips the products.
// - Exactness. The score is __fmul_rn / __fadd_rn (no FMA contraction),
//   p exp(s - lse) with exact zeros where masked; each block owns its
//   output rows, with no atomics: two runs give the same bits, and each
//   sum runs in the order stated above (the plain version's, apart from a
//   d = 128 or 256 score's parts).
// - Head dims 128 and 256 (the template parameter kD; the wrapper pads any
//   other d up to the next compiled width with zero columns). 64-row
//   blocks of 132-float rows over 32-row tiles take 144 KB (dq) and 154 KB
//   (dK·dV), one block an SM, and at d = 256 (260-float rows) 269 and 279
//   KB, more than a block may have. So a block owns kBM = 32 rows over kBN
//   = 32-row tiles. Split by streamed rows among its warps, a lane's share
//   of a 32 x 32 score would be an 8 x 2 (d = 128, 10 loads for 64 FFMAs)
//   or 8 x 1 micro-tile, and each scheduler would hold one warp. So the
//   scores are split by depth into kScoreParts = kD / 64 parts and the
//   block's kSplit = 2 kScoreParts warps run S and dP side by side: warp
//   (product, part) sums its product's whole 32 x 32 tile over its 64
//   columns of d, an 8 x 4 micro-tile a lane as at d = 64, and the partial
//   scores of an entry meet in shared memory. The product's warp that owns
//   an entry's column (kOwnCols of a lane's four) finishes it: the others
//   store their partials in kScoreParts - 1 planes (strips of kSStride =
//   40-float rows, so that a warp's 4-byte stores fall in 32 banks, one set
//   for S, one for dP), and the owning lane adds its own partial from
//   registers in part order. S's owner writes p over its first plane's
//   entry, dP's owner then reads it back and writes ds * scale over its
//   own (dK·dV: and p * keep over p), entries only those two lanes touch.
//   Four block barriers a tile: the tile landed, the partials stored, p
//   written, the strips written. Each warp then takes kOutCols = 32
//   columns of every output, rows ly + 4i by 4 columns (dK·dV: both
//   products in one loop). A 16-byte load costs the shared memory two
//   passes where a quarter-warp reads one or two addresses and four where
//   it reads four or more (tools/smem_wavefronts.py measures it), so every
//   product's loads are one row a quarter and eight streamed rows, as at d
//   = 64. At d = 128 (four warps) dq takes 109 KB and dK·dV 109.5 KB, so
//   an SM holds kBlocksPerSM = 2 blocks, two warps a scheduler, and one
//   block's barriers are covered by the other's products; at d = 256
//   (eight warps) dq takes 225 KB, dK·dV 225.5 KB, one block an SM. With
//   a bias, the lanes that finish S's entries load their bias from global
//   memory at the tile's start, so that the loads run under the score
//   product (read where p is taken, each waited for in turn, they cost
//   the biased dq about 30 % of its time, dK·dV about 10 %).
// The geometry is mirrored by fa_fma_bwd_geometry(d) in ops/tiling.py.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each function returns cudaGetLastError() after its launch.

#include "fma_tiles.cuh"

namespace {

using namespace apex_port;

constexpr int kMI = 8;          // rows of a lane's micro-tiles
constexpr int kGroupRows = 4 * kMI;  // rows of a group of kSplit warps
constexpr int kStages = 2;      // shared-memory stages of streamed tiles
static_assert(kStages == 2, "the pipeline below prefetches one tile");
constexpr int kUnroll = 4;      // float4 steps of a product loop unrolled
constexpr int kRowStep = 4;     // a lane's rows: ly + kRowStep * i
constexpr int kColStep = 8;     // a lane's streamed rows: lx + kColStep * j
constexpr float kNegInf = -1e30f;
constexpr float kMaskEdge = 0.5f * kNegInf;

// What depends on the head dim kD (64, 128 or 256): the rows a block owns
// (kBM), the rows of a streamed tile (kBN), the padded row stride of Q, K,
// V and dO (floats), within a block's shared memory, the padded row stride
// of a p / ds strip (kSStride), the warps that share a group's rows
// (kSplit), each a 1 / kSplit part of the tile's streamed rows and of d,
// the parts of d that a score is split into (kScoreParts): 1, each warp's
// scores over all of d for its part of the streamed rows, or kSplit / 2,
// each warp's over its part of d for all of them, and the blocks an SM
// holds (kBlocksPerSM, the kernels' launch bound).
template <int kD>
struct BwdGeometry;
template <>
struct BwdGeometry<64> {
  static constexpr int kBM = 128;
  static constexpr int kBN = 64;
  static constexpr int kStride = 68;
  static constexpr int kSStride = 68;
  static constexpr int kSplit = 2;
  static constexpr int kScoreParts = 1;
  static constexpr int kBlocksPerSM = 1;
};
template <>
struct BwdGeometry<128> {
  static constexpr int kBM = 32;
  static constexpr int kBN = 32;
  static constexpr int kStride = 132;
  static constexpr int kSStride = 40;
  static constexpr int kSplit = 4;
  static constexpr int kScoreParts = 2;
  static constexpr int kBlocksPerSM = 2;
};
template <>
struct BwdGeometry<256> {
  static constexpr int kBM = 32;
  static constexpr int kBN = 32;
  static constexpr int kStride = 260;
  static constexpr int kSStride = 40;
  static constexpr int kSplit = 8;
  static constexpr int kScoreParts = 4;
  static constexpr int kBlocksPerSM = 1;
};

template <int kD>
struct Bwd : BwdGeometry<kD> {
  using BwdGeometry<kD>::kBM;
  using BwdGeometry<kD>::kBN;
  using BwdGeometry<kD>::kStride;
  using BwdGeometry<kD>::kSStride;
  using BwdGeometry<kD>::kSplit;
  using BwdGeometry<kD>::kScoreParts;
  using BwdGeometry<kD>::kBlocksPerSM;
  // groups of kGroupRows rows, kSplit warps each
  static constexpr int kThreads = 32 * kSplit * kBM / kGroupRows;
  // kScoreParts = 1: a lane's streamed rows lx + kColStep * j, j < kNJ, in
  // its warp's part
  static constexpr int kNJ = kBN / (kSplit * kColStep);
  // 32-column groups of d in a warp's part of an output
  static constexpr int kGroups = kD / (32 * kSplit);
  // kScoreParts > 1: the score products that run side by side (S and dP,
  // kScoreParts warps each), a lane's rows (kRowStep apart) and streamed
  // rows (kColStep apart) of a score, the streamed rows whose entries its
  // warp finishes, a lane's rows of the outputs (kRowStep apart) and a
  // warp's output columns
  static constexpr int kProducts = kSplit / kScoreParts;
  static constexpr int kDMI = kBM / kRowStep;
  static constexpr int kDNJ = kBN / kColStep;
  static constexpr int kOwnCols = kDNJ / kScoreParts;
  static constexpr int kOMI = kBM / kRowStep;
  static constexpr int kOutCols = kD / kSplit;
  // strips of kBM rows: dq's ds, dK·dV's p and ds; split by depth, the
  // partial scores' planes of S and of dP, whose first planes hold them
  static constexpr int kDqStrips = kScoreParts > 1 ? 2 * (kScoreParts - 1) : 1;
  static constexpr int kDkvStrips = kScoreParts > 1 ? 2 * (kScoreParts - 1) : 2;
  static constexpr int kStrip = kBM * kSStride;     // a strip
  static constexpr int kBlockTile = kBM * kStride;  // the block's rows
  static constexpr int kTile = kBN * kStride;       // a streamed tile
  // dq: Q, dO, the strips, then K / V per stage
  static constexpr int kDqSmemFloats =
      2 * kBlockTile + kDqStrips * kStrip + kStages * 2 * kTile;
  // dK·dV: K, V, the strips, Q / dO per stage, lse / D per stage
  static constexpr int kDkvSmemFloats = 2 * kBlockTile + kDkvStrips * kStrip
                                        + kStages * 2 * kTile
                                        + kStages * 2 * kBN;
  static_assert(kStride == kD + 4, "the head dim padded by one chunk");
  static_assert(kStride % 4 == 0 && (kStride / 4) % 2 == 1 &&
                    kSStride % 4 == 0,
                "16-byte rows whose chunks fall in distinct banks");
  static_assert(kScoreParts == 1
                    ? kSStride == kBN + 4 &&
                          kNJ * kSplit * kColStep == kBN &&
                          kGroups * 32 * kSplit == kD
                    : kSStride % 32 == 8 && kBM == kGroupRows &&
                          kProducts * kScoreParts == kSplit &&
                          kProducts == 2 && kBN % kColStep == 0 &&
                          kDNJ % kScoreParts == 0 && kOutCols % 32 == 0 &&
                          kThreads >= kBN,
                "the lanes' parts of the scores and outputs");
  static_assert(kDkvSmemFloats * 4 <= 232448 && kDqSmemFloats * 4 <= 232448,
                "a block's shared memory");
  // kBlocksPerSM blocks, each with the 1 KB the hardware reserves, in the
  // SM's 228 KB
  static_assert(kBlocksPerSM * (kDkvSmemFloats * 4 + 1024) <= 233472 &&
                    kBlocksPerSM * (kDqSmemFloats * 4 + 1024) <= 233472,
                "kBlocksPerSM blocks an SM");
};

// A stamp of a tile's phase: nothing in the port's build;
// tools/flash_bwd_split.py defines it in a copy of this source to read the
// SM's clock there (slot `slot` of tile `tile`, a phase named `phase`)
#ifndef APEX_SPLIT
#define APEX_SPLIT(slot, tile, phase)
#endif

// `_bwd_p`: P = exp(s - lse), 0 where s or the row's lse is masked
__device__ __forceinline__ float bwd_p(float s, float lse) {
  return (s <= kMaskEdge || lse <= kMaskEdge) ? 0.f : expf(s - lse);
}

// the kSplit warps of row group `grp` meet
template <int kSplit>
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "n"(32 * kSplit)
               : "memory");
}

// out_product for two products at once (acc += e . f, acc2 += e2 . f2):
// one loop, twice the independent FFMAs between a load and its use; e, e2
// strips (rows kSStride apart), f, f2 streamed tiles (rows kStride apart)
template <int kD>
__device__ __forceinline__ void out_product2(float (&acc)[kMI][4],
                                             const float* e, const float* f,
                                             float (&acc2)[kMI][4],
                                             const float* e2,
                                             const float* f2) {
  constexpr int kBN = Bwd<kD>::kBN, kStride = Bwd<kD>::kStride,
                kSStride = Bwd<kD>::kSStride;
#pragma unroll (kUnroll)
  for (int n = 0; n < kBN; n += 4) {
    float4 ev[kMI], fv[4], ev2[kMI], fv2[4];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      ev[i] =
          *reinterpret_cast<const float4*>(e + kRowStep * i * kSStride + n);
      ev2[i] =
          *reinterpret_cast<const float4*>(e2 + kRowStep * i * kSStride + n);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      fv[t] = *reinterpret_cast<const float4*>(f + (n + t) * kStride);
      fv2[t] = *reinterpret_cast<const float4*>(f2 + (n + t) * kStride);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[i][u] = fmaf(part(ev[i], t), part(fv[t], u), acc[i][u]);
          acc2[i][u] = fmaf(part(ev2[i], t), part(fv2[t], u), acc2[i][u]);
        }
  }
}

// p of a lane's micro-tile (scores s, rows row0 + kRowStep i, keys key0 +
// kColStep j, the rows' lse in l) into its strip entries `e` (row stride
// kSStride)
template <int kD, bool kBias>
__device__ __forceinline__ void dq_p(float* e,
                                     const float (&s)[kMI][Bwd<kD>::kNJ],
                                     const float (&l)[kMI], int row0,
                                     int key0, int sq, int sk, int causal,
                                     float scale, const ScoreBias& bias,
                                     const float* bs) {
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int row = row0 + kRowStep * i;
#pragma unroll
    for (int j = 0; j < Bwd<kD>::kNJ; ++j) {
      const int key = key0 + kColStep * j;
      const bool m = key >= sk || (causal && key > row);
      // __fmul_rn / __fadd_rn: no FMA contraction, so the score is the
      // plain version's round(round(q.k * scale) + bias)
      float a = __fmul_rn(s[i][j], scale);
      if (kBias && !m && row < sq) a = __fadd_rn(a, bias.at(bs, row, key));
      e[kRowStep * i * Bwd<kD>::kSStride + kColStep * j] =
          m ? 0.f : bwd_p(a, l[i]);
    }
  }
}

// The same for dK·dV's micro-tile: rows are keys key0 + kRowStep i,
// streamed rows the queries q0 + c0 + kColStep j, whose lse is ls[c0 +
// kColStep j].
template <int kD, bool kBias>
__device__ __forceinline__ void dkv_p(float* e,
                                      const float (&s)[kMI][Bwd<kD>::kNJ],
                                      const float* ls, int key0, int q0,
                                      int c0, int sq, int sk, int causal,
                                      float scale, const ScoreBias& bias,
                                      const float* bs) {
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int key = key0 + kRowStep * i;
#pragma unroll
    for (int j = 0; j < Bwd<kD>::kNJ; ++j) {
      const int col = c0 + kColStep * j;
      const int qry = q0 + col;
      const bool m = key >= sk || qry >= sq || (causal && key > qry);
      // __fmul_rn / __fadd_rn: no FMA contraction, so the score is the
      // plain version's round(round(q.k * scale) + bias)
      float a = __fmul_rn(s[i][j], scale);
      if (kBias && !m) a = __fadd_rn(a, bias.at(bs, qry, key));
      e[kRowStep * i * Bwd<kD>::kSStride + kColStep * j] =
          m ? 0.f : bwd_p(a, ls[col]);
    }
  }
}

// The flat batch * head index of a block. The grid is (grid_y, blocks of
// rows, grid_z) of fa_batch_heads_grid's split: x, which the hardware
// dispatches first, runs over batch * heads, so that each row block is
// launched for every head before the next, lighter one (heaviest first
// over the whole grid, not within one head).
__device__ __forceinline__ long long block_head() {
  return (long long)blockIdx.z * gridDim.x + blockIdx.x;
}

// the key tiles a dq block of rows [q0, q0 + kBM) visits: all of sk, or
// (causal) up to the diagonal of its last row below sq
template <int kD>
__device__ __forceinline__ int dq_key_tiles(int q0, int sq, int sk,
                                            int causal) {
  constexpr int kBM = Bwd<kD>::kBM, kBN = Bwd<kD>::kBN;
  const int n = (sk + kBN - 1) / kBN;
  return causal ? min(n, (min(q0 + kBM, sq) - 1) / kBN + 1) : n;
}

// dq at d = 64 (kScoreParts = 1): each warp its rows' scores
// over all of d for its part of the tile's keys
template <int kD, bool kBias, bool kDropout, bool kDbias>
__device__ __forceinline__ void dq_rows(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    float* __restrict__ dq, int nbh, int sq, int sk, float scale,
    int causal, int vec, const ScoreBias& bias, const Dropout& drop,
    float* __restrict__ dlogits) {
  using G = Bwd<kD>;
  constexpr int kBM = G::kBM, kBN = G::kBN, kThreads = G::kThreads,
                kStride = G::kStride, kSStride = G::kSStride,
                kTile = G::kTile, kBlockTile = G::kBlockTile;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kBM][kStride]
  float* dos = qs + kBlockTile;       // [kBM][kStride]
  float* strip = dos + kBlockTile;    // [kBM][kSStride]: ds * scale
  float* stage = strip + kBM * kSStride;  // [kStages][K, V][kBN][kStride]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / G::kSplit, part = warp % G::kSplit;
  const int ly = lane >> 3, lx = lane & 7;
  const long long bh = block_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest first
  const float* kb = k + bh * sk * kD;
  const float* vb = v + bh * sk * kD;
  const float* bs = kBias ? bias.slice(bh) : nullptr;
  const uint32_t dhead = kDropout ? drop.head(bh) : 0u;
  float* dlb = kDbias ? dlogits + bh * sq * sk : nullptr;
  const int nk = dq_key_tiles<kD>(q0, sq, sk, causal);

  // K (part 0) and V (part 1) of tile kt into its stage
  auto load = [&](int kt, int part) {
    float* st = stage + (kt % kStages) * 2 * kTile + part * kTile;
    copy_tile<kBN, kThreads, kD, kStride>(st, part == 0 ? kb : vb, kt * kBN,
                                          sk, vec);
  };
  // two commit groups: Q with tile 0's K (the S product), then dO with
  // its V (the dP product), so that S starts on half the bytes
  copy_tile<kBM, kThreads, kD, kStride>(qs, q + bh * sq * kD, q0, sq, vec);
  if (nk > 0) load(0, 0);
  cp_async_commit();
  copy_tile<kBM, kThreads, kD, kStride>(dos, dout + bh * sq * kD, q0, sq, vec);
  if (nk > 0) load(0, 1);
  cp_async_commit();

  const int r0 = grp * kGroupRows + ly;  // the lane's first row in the block
  const int c0 = part * (kBN / G::kSplit) + lx;  // its first key in a tile
  float l[kMI], dd[kMI];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int row = q0 + r0 + kRowStep * i;
    l[i] = row < sq ? lse[bh * sq + row] : kNegInf;
    dd[i] = row < sq ? dvec[bh * sq + row] : 0.f;
  }
  float acc[G::kGroups][kMI][4];
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g) zero(acc[g]);
  const int grp_row0 = q0 + grp * kGroupRows;

  for (int kt = 0; kt < nk; ++kt) {
    APEX_SPLIT(0, kt, "start");
    // tile kt has landed (of tile 0 the first group) for every thread,
    // and every warp is done with tile kt - 1: its stage and the strip
    // are free for tile kt + 1
    if (kt == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    APEX_SPLIT(1, kt, "wait tile");
    if (kt + 1 < nk) {
      load(kt + 1, 0);
      load(kt + 1, 1);
    }
    cp_async_commit();
    const float* ks = stage + (kt % kStages) * 2 * kTile;
    const float* vs = ks + kTile;
    const int k0 = kt * kBN;
    // the group's 32 rows lie past sq or (causal) see none of these keys
    const bool idle =
        grp_row0 >= sq || (causal && k0 > grp_row0 + kGroupRows - 1);
    float* srow = strip + r0 * kSStride + c0;  // the lane's strip entries
    if (!idle) {
      float s[kMI][G::kNJ];
      zero(s);
      score_product<kMI, kRowStep, kColStep, kD, kStride, kUnroll>(
          s, qs + r0 * kStride, ks + c0 * kStride);
      // p into the strip (the thread's own entries)
      dq_p<kD, kBias>(srow, s, l, q0 + r0, k0 + c0, sq, sk, causal, scale,
                      bias, bs);
    }
    APEX_SPLIT(2, kt, "S, p");
    if (kt == 0) {  // dO and the first V
      cp_async_wait<1>();
      __syncthreads();
    }
    if (!idle) {
      float s[kMI][G::kNJ];
      zero(s);
      score_product<kMI, kRowStep, kColStep, kD, kStride, kUnroll>(
          s, dos + r0 * kStride, vs + c0 * kStride);
      // ds * scale = p (dp * keep - D) * scale in place
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < G::kNJ; ++j) {
          float* e = srow + kRowStep * i * kSStride + kColStep * j;
          const int row = q0 + r0 + kRowStep * i, key = k0 + c0 + kColStep * j;
          const float dp =
              kDropout ? s[i][j] * drop.keep(dhead, row, key) : s[i][j];
          const float dl = *e * (dp - dd[i]);
          if (kDbias && row < sq && key < sk)
            dlb[(long long)row * sk + key] = dl;
          *e = dl * scale;
        }
      APEX_SPLIT(3, kt, "dP, ds");
      group_sync<G::kSplit>(grp);  // the group's strip rows are whole
      APEX_SPLIT(4, kt, "group barrier");
      // the 32-column groups of the warp's part of d, a product each
#pragma unroll
      for (int g = 0; g < G::kGroups; ++g)
        out_product<kMI, kRowStep, kBN, kStride, kUnroll, kSStride>(
            acc[g], strip + r0 * kSStride,
            ks + part * (kD / G::kSplit) + 32 * g + lx * 4);
      APEX_SPLIT(5, kt, "dQ");
    } else if (kDbias) {  // rows past sq, or (causal) keys none of them sees
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < G::kNJ; ++j) {
          const int row = q0 + r0 + kRowStep * i, key = k0 + c0 + kColStep * j;
          if (row < sq && key < sk) dlb[(long long)row * sk + key] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  if (kDbias) {  // the key tiles past the block's diagonal: zeros
    const int kz = nk * kBN, w = sk - kz, rows = min(kBM, sq - q0);
    for (long long t = threadIdx.x; w > 0 && t < (long long)rows * w;
         t += kThreads)
      dlb[(long long)(q0 + t / w) * sk + kz + t % w] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g)
    store_rows<kMI, kRowStep, kD>(dq + bh * sq * kD, acc[g], q0 + r0,
                                  part * (kD / G::kSplit) + 32 * g + lx * 4,
                                  sq, vec);
}

// dK·dV at d = 64 (kScoreParts = 1): each warp its keys' scores
// over all of d for its part of the tile's queries
template <int kD, bool kBias, bool kDropout>
__device__ __forceinline__ void dkv_rows(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    float* __restrict__ dk, float* __restrict__ dv, int nbh, int sq, int sk,
    float scale, int causal, int vec, const ScoreBias& bias,
    const Dropout& drop) {
  using G = Bwd<kD>;
  constexpr int kBM = G::kBM, kBN = G::kBN, kThreads = G::kThreads,
                kStride = G::kStride, kSStride = G::kSStride,
                kTile = G::kTile, kBlockTile = G::kBlockTile;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [kBM][kStride]
  float* vs = ks + kBlockTile;       // [kBM][kStride]
  float* pst = vs + kBlockTile;      // [kBM][kSStride]: p (keys x queries)
  float* dst = pst + kBM * kSStride;   // [kBM][kSStride]: ds * scale
  float* stage = dst + kBM * kSStride;  // [kStages][Q, dO][kBN][kStride]
  float* vecs = stage + kStages * 2 * kTile;  // [kStages][lse, D][kBN]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / G::kSplit, part = warp % G::kSplit;
  const int ly = lane >> 3, lx = lane & 7;
  const long long bh = block_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int k0 = blockIdx.y * kBM;  // the first key blocks see the most
  const float* qb = q + bh * sq * kD;
  const float* dob = dout + bh * sq * kD;
  const float* lb = lse + bh * sq;
  const float* db = dvec + bh * sq;
  const float* bs = kBias ? bias.slice(bh) : nullptr;
  const uint32_t dhead = kDropout ? drop.head(bh) : 0u;
  // causal: query tiles below k0 see none of this block's keys
  const int qt0 = causal ? k0 / kBN : 0;
  const int nq = max(0, (sq + kBN - 1) / kBN - qt0);

  // Q and the lse slice (part 0), dO and the D slice (part 1) of query
  // tile it into its stage
  auto load = [&](int it, int part) {
    float* st = stage + (it % kStages) * 2 * kTile + part * kTile;
    float* sv = vecs + (it % kStages) * 2 * kBN + part * kBN;
    const int row0 = (qt0 + it) * kBN;
    copy_tile<kBN, kThreads, kD, kStride>(st, part == 0 ? qb : dob, row0,
                                          sq, vec);
    const int r = threadIdx.x;
    if (r < kBN) {
      const bool ok = row0 + r < sq;
      const float* src = part == 0 ? lb : db;
      cp_async4(sv + r, ok ? src + row0 + r : src, ok);
    }
  };
  // two commit groups: K with tile 0's Q and lse (the S product and p),
  // then V with its dO and D (the dP product and ds)
  copy_tile<kBM, kThreads, kD, kStride>(ks, k + bh * sk * kD, k0, sk, vec);
  if (nq > 0) load(0, 0);
  cp_async_commit();
  copy_tile<kBM, kThreads, kD, kStride>(vs, v + bh * sk * kD, k0, sk, vec);
  if (nq > 0) load(0, 1);
  cp_async_commit();

  const int r0 = grp * kGroupRows + ly;  // the lane's first key in the block
  const int c0 = part * (kBN / G::kSplit) + lx;  // its first query in a tile
  float ak[G::kGroups][kMI][4], av[G::kGroups][kMI][4];
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g) {
    zero(ak[g]);
    zero(av[g]);
  }
  const int grp_key0 = k0 + grp * kGroupRows;

  for (int it = 0; it < nq; ++it) {
    APEX_SPLIT(0, it, "start");
    // tile it has landed (of tile 0 the first group) for every thread,
    // and every warp is done with tile it - 1: its stage and the strips
    // are free for tile it + 1
    if (it == 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    APEX_SPLIT(1, it, "wait tile");
    if (it + 1 < nq) {
      load(it + 1, 0);
      load(it + 1, 1);
    }
    cp_async_commit();
    const float* qs = stage + (it % kStages) * 2 * kTile;
    const float* dos = qs + kTile;
    const float* ls = vecs + (it % kStages) * 2 * kBN;
    const float* ds = ls + kBN;
    const int q0 = (qt0 + it) * kBN;
    // the group's 32 keys lie past sk or (causal) above every query here
    const bool idle =
        grp_key0 >= sk || (causal && grp_key0 > q0 + kBN - 1);
    float* prow = pst + r0 * kSStride + c0;  // the lane's strip entries
    float* drow = dst + r0 * kSStride + c0;
    if (!idle) {
      float s[kMI][G::kNJ];
      zero(s);
      score_product<kMI, kRowStep, kColStep, kD, kStride, kUnroll>(
          s, ks + r0 * kStride, qs + c0 * kStride);
      // p into its strip (the thread's own entries)
      dkv_p<kD, kBias>(prow, s, ls, k0 + r0, q0, c0, sq, sk, causal, scale,
                       bias, bs);
    }
    APEX_SPLIT(2, it, "S^T, p");
    if (it == 0) {  // V, the first dO and D
      cp_async_wait<1>();
      __syncthreads();
    }
    if (!idle) {
      float s[kMI][G::kNJ];
      zero(s);
      score_product<kMI, kRowStep, kColStep, kD, kStride, kUnroll>(
          s, vs + r0 * kStride, dos + c0 * kStride);
      // ds * scale = p (dp * keep - D) * scale into the other strip;
      // with dropout p times its keep factor in place, for dv
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < G::kNJ; ++j) {
          const int e = kRowStep * i * kSStride + kColStep * j;
          if (kDropout) {
            const float keep = drop.keep(dhead, q0 + c0 + kColStep * j,
                                         k0 + r0 + kRowStep * i);
            drow[e] = prow[e] * (s[i][j] * keep - ds[c0 + kColStep * j]) *
                      scale;
            prow[e] *= keep;
          } else {
            drow[e] = prow[e] * (s[i][j] - ds[c0 + kColStep * j]) * scale;
          }
        }
      APEX_SPLIT(3, it, "dP^T, ds");
      group_sync<G::kSplit>(grp);  // the group's strip rows are whole
      APEX_SPLIT(4, it, "group barrier");
      // the 32-column groups of the warp's part of d, a loop each
#pragma unroll
      for (int g = 0; g < G::kGroups; ++g) {
        const int col = part * (kD / G::kSplit) + 32 * g + lx * 4;
        out_product2<kD>(av[g], pst + r0 * kSStride, dos + col, ak[g],
                         dst + r0 * kSStride, qs + col);
      }
      APEX_SPLIT(5, it, "dV, dK");
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int g = 0; g < G::kGroups; ++g) {
    const int col = part * (kD / G::kSplit) + 32 * g + lx * 4;
    store_rows<kMI, kRowStep, kD>(dk + bh * sk * kD, ak[g], k0 + r0, col,
                                  sk, vec);
    store_rows<kMI, kRowStep, kD>(dv + bh * sk * kD, av[g], k0 + r0, col,
                                  sk, vec);
  }
}

// Split by depth (d = 128 and 256, kScoreParts > 1). The block's warps run
// S and dP side by side: warp w = (product, part) = (w / kScoreParts, w %
// kScoreParts) sums its product's whole tile (all kBM rows, all kBN
// streamed rows) over d columns kPartD part .. + kPartD - 1; lane (ly, lx)
// = (lane / 8, lane % 8) holds rows ly + kRowStep i (i < kDMI) by
// streamed rows lx + kColStep j (j < kDNJ): a quarter-warp reads one row
// of its own operand and eight of the streamed one. Of those entries the
// product's warp o finishes columns j = kOwnCols o .. + kOwnCols - 1, so
// each other warp of the product stores its partials of them into the
// plane numbered by its rank among the non-owners (`planes`: kScoreParts
// - 1 strips of kSStride-float rows, entry (row, col) at row * kSStride +
// col; a warp's 32 stores of one (i, j) fall in 32 banks).
template <int kD>
__device__ __forceinline__ void put_partials(
    float* planes, const float (&s)[Bwd<kD>::kDMI][Bwd<kD>::kDNJ], int part,
    int row0, int lx) {
  using G = Bwd<kD>;
#pragma unroll
  for (int j = 0; j < G::kDNJ; ++j) {
    const int owner = j / G::kOwnCols;
    if (owner == part) continue;
    float* e = planes + (part - (part > owner)) * G::kStrip +
               row0 * G::kSStride + lx + kColStep * j;
#pragma unroll
    for (int i = 0; i < G::kDMI; ++i) e[kRowStep * i * G::kSStride] = s[i][j];
  }
}

// The warp's own partials of the entries it finishes: columns j =
// kOwnCols * part + jj of `s` (a selection by the warp's part, kept in
// registers)
template <int kD>
__device__ __forceinline__ void own_partials(
    float (&own)[Bwd<kD>::kDMI][Bwd<kD>::kOwnCols],
    const float (&s)[Bwd<kD>::kDMI][Bwd<kD>::kDNJ], int part) {
  using G = Bwd<kD>;
#pragma unroll
  for (int o = 0; o < G::kScoreParts; ++o)
    if (o == part)
#pragma unroll
      for (int i = 0; i < G::kDMI; ++i)
#pragma unroll
        for (int jj = 0; jj < G::kOwnCols; ++jj)
          own[i][jj] = s[i][G::kOwnCols * o + jj];
}

// The whole score of entry `e` (an offset within a plane) that the lane
// finishes: the kScoreParts partials added in part order, its own `mine`
// from registers, the others' from their planes
template <int kD>
__device__ __forceinline__ float whole_score(const float* planes, int e,
                                             int part, float mine) {
  using G = Bwd<kD>;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < G::kScoreParts; ++w) {
    const float x =
        w == part ? mine : planes[(w - (w > part)) * G::kStrip + e];
    s = w == 0 ? x : __fadd_rn(s, x);
  }
  return s;
}

// acc[c][i][u] += sum over the kN tile rows n, in order, of e_i[n] *
// f[n][32 c + u]: e_i is row kRowStep i of the strip `e` (rows kEStride
// floats apart), f the streamed tile (rows kStride apart) at the lane's
// column; with kTwo also acc2 from e2 and f2 in the same loop. A lane's
// output block is kOMI rows (ly + kRowStep i) by kChunks 4-column chunks
// 32 apart.
template <int kOMI, int kChunks, int kN, int kStride, int kEStride,
          bool kTwo>
__device__ __forceinline__ void out_chunks(float (&acc)[kChunks][kOMI][4],
                                           const float* e, const float* f,
                                           float (&acc2)[kChunks][kOMI][4],
                                           const float* e2,
                                           const float* f2) {
#pragma unroll (kUnroll)
  for (int n = 0; n < kN; n += 4) {
    float4 ev[kOMI], fv[4][kChunks], ev2[kTwo ? kOMI : 1],
        fv2[4][kTwo ? kChunks : 1];
#pragma unroll
    for (int i = 0; i < kOMI; ++i) {
      const int at = kRowStep * i * kEStride + n;
      ev[i] = *reinterpret_cast<const float4*>(e + at);
      if constexpr (kTwo) ev2[i] = *reinterpret_cast<const float4*>(e2 + at);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        fv[t][c] =
            *reinterpret_cast<const float4*>(f + (n + t) * kStride + 32 * c);
        if constexpr (kTwo)
          fv2[t][c] = *reinterpret_cast<const float4*>(f2 + (n + t) * kStride
                                                       + 32 * c);
      }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < kOMI; ++i)
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[c][i][u] =
                fmaf(part(ev[i], t), part(fv[t][c], u), acc[c][i][u]);
            if constexpr (kTwo)
              acc2[c][i][u] = fmaf(part(ev2[i], t), part(fv2[t][c], u),
                                   acc2[c][i][u]);
          }
  }
}

// dq at d = 128 and 256: the scores split by depth (see put_partials), S
// by warps 0 .. kScoreParts - 1 and dP by the others; the lane finishes
// the entries of columns j = kOwnCols * part + jj of its product's
// micro-tile, then holds rows ly + kRowStep i of dQ at the warp's
// kOutCols columns (chunks 4 lx + 32 c)
template <int kD, bool kBias, bool kDropout, bool kDbias>
__device__ __forceinline__ void dq_depth(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    float* __restrict__ dq, int nbh, int sq, int sk, float scale,
    int causal, int vec, const ScoreBias& bias, const Dropout& drop,
    float* __restrict__ dlogits) {
  using G = Bwd<kD>;
  constexpr int kBM = G::kBM, kBN = G::kBN, kThreads = G::kThreads,
                kStride = G::kStride, kSStride = G::kSStride,
                kTile = G::kTile, kBlockTile = G::kBlockTile,
                kMI = G::kDMI, kNJ = G::kDNJ, kOwn = G::kOwnCols,
                kPartD = kD / G::kScoreParts, kChunks = G::kOutCols / 32;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kBM][kStride]
  float* dos = qs + kBlockTile;       // [kBM][kStride]
  // [S, dP][kScoreParts - 1][kBM][kSStride]: the partial scores; S's first
  // plane takes p, dP's the ds * scale strip
  float* sparts = dos + kBlockTile;
  float* dparts = sparts + (G::kScoreParts - 1) * G::kStrip;
  // [kStages][K, V][kBN][kStride]
  float* stage = sparts + G::kDqStrips * G::kStrip;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's product (S or dP) and its part of d in the scores
  const bool dpw = warp >= G::kScoreParts;
  const int part = warp % G::kScoreParts;
  const int ly = lane >> 3, lx = lane & 7;
  const long long bh = block_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest first
  const float* kb = k + bh * sk * kD;
  const float* vb = v + bh * sk * kD;
  const float* bs = kBias ? bias.slice(bh) : nullptr;
  const uint32_t dhead = kDropout ? drop.head(bh) : 0u;
  float* dlb = kDbias ? dlogits + bh * sq * sk : nullptr;
  const int nk = dq_key_tiles<kD>(q0, sq, sk, causal);

  // K (which 0) and V (which 1) of tile kt into its stage
  auto load = [&](int kt, int which) {
    float* st = stage + (kt % kStages) * 2 * kTile + which * kTile;
    copy_tile<kBN, kThreads, kD, kStride>(st, which == 0 ? kb : vb,
                                          kt * kBN, sk, vec);
  };
  copy_tile<kBM, kThreads, kD, kStride>(qs, q + bh * sq * kD, q0, sq, vec);
  copy_tile<kBM, kThreads, kD, kStride>(dos, dout + bh * sq * kD, q0, sq, vec);
  if (nk > 0) {
    load(0, 0);
    load(0, 1);
  }
  cp_async_commit();

  const int dcol = part * kPartD;  // the warp's part of d in the scores
  const int ocol = warp * G::kOutCols + 4 * lx;  // its first dQ column
  float l[kMI], dd[kMI];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const int row = q0 + ly + kRowStep * i;
    l[i] = row < sq ? lse[bh * sq + row] : kNegInf;
    dd[i] = row < sq ? dvec[bh * sq + row] : 0.f;
  }
  float acc[kChunks][G::kOMI][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) zero(acc[c]);

  for (int kt = 0; kt < nk; ++kt) {
    APEX_SPLIT(0, kt, "start");
    // tile kt has landed for every thread, and every warp is done with
    // tile kt - 1: its stage, the planes and the strip are free for tile
    // kt + 1
    cp_async_wait<0>();
    __syncthreads();
    APEX_SPLIT(1, kt, "wait tile");
    if (kt + 1 < nk) {
      load(kt + 1, 0);
      load(kt + 1, 1);
    }
    cp_async_commit();
    const float* ks = stage + (kt % kStages) * 2 * kTile;
    const float* vs = ks + kTile;
    const int k0 = kt * kBN;
    // S's warps: the bias of the entries the lane finishes, loaded here
    // so that the loads run under the score product
    float bv[kMI][kOwn];
    if constexpr (kBias) {
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int row = q0 + ly + kRowStep * i;
#pragma unroll
        for (int jj = 0; jj < kOwn; ++jj) {
          const int key = k0 + lx + kColStep * (kOwn * part + jj);
          const bool m = key >= sk || (causal && key > row) || row >= sq;
          bv[i][jj] = !dpw && !m ? bias.at(bs, row, key) : 0.f;
        }
      }
    }
    float own[kMI][kOwn];
    {
      float s[kMI][kNJ];
      zero(s);
      score_product<kMI, kRowStep, kColStep, kPartD, kStride, kUnroll>(
          s, (dpw ? dos : qs) + ly * kStride + dcol,
          (dpw ? vs : ks) + lx * kStride + dcol);
      put_partials<kD>(dpw ? dparts : sparts, s, part, ly, lx);
      own_partials<kD>(own, s, part);
    }
    APEX_SPLIT(2, kt, "S | dP part");
    __syncthreads();  // every partial stored
    APEX_SPLIT(3, kt, "partials barrier");
    // the lane's entries: S's warps p over S's first plane; dP's warps dp
    // times the keep factor, in registers
    float dps[kMI][kOwn];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int r = ly + kRowStep * i, row = q0 + r;
#pragma unroll
      for (int jj = 0; jj < kOwn; ++jj) {
        const int c = lx + kColStep * (kOwn * part + jj), key = k0 + c;
        const int e = r * kSStride + c;
        if (dpw) {
          const float x = whole_score<kD>(dparts, e, part, own[i][jj]);
          dps[i][jj] = kDropout ? x * drop.keep(dhead, row, key) : x;
        } else {
          const bool m = key >= sk || (causal && key > row);
          // __fmul_rn / __fadd_rn: no FMA contraction, so the score is
          // the plain version's round(round(q.k * scale) + bias)
          float a = __fmul_rn(whole_score<kD>(sparts, e, part, own[i][jj]),
                              scale);
          if constexpr (kBias)
            if (!m && row < sq) a = __fadd_rn(a, bv[i][jj]);
          sparts[e] = m ? 0.f : bwd_p(a, l[i]);
        }
      }
    }
    APEX_SPLIT(4, kt, "p | dp");
    __syncthreads();  // p is written
    APEX_SPLIT(5, kt, "p barrier");
    if (dpw) {  // ds * scale = p (dp * keep - D) * scale over dP's plane
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int r = ly + kRowStep * i, row = q0 + r;
#pragma unroll
        for (int jj = 0; jj < kOwn; ++jj) {
          const int c = lx + kColStep * (kOwn * part + jj), key = k0 + c;
          const int e = r * kSStride + c;
          const float dl = sparts[e] * (dps[i][jj] - dd[i]);
          if (kDbias && row < sq && key < sk)
            dlb[(long long)row * sk + key] = dl;
          dparts[e] = dl * scale;
        }
      }
    }
    __syncthreads();  // the strip is whole
    APEX_SPLIT(6, kt, "ds, strip barrier");
    out_chunks<G::kOMI, kChunks, kBN, kStride, kSStride, false>(
        acc, dparts + ly * kSStride, ks + ocol, acc, nullptr, nullptr);
    APEX_SPLIT(7, kt, "dQ");
  }
  cp_async_wait<0>();
  if (kDbias) {  // the key tiles past the block's diagonal: zeros, a warp
                 // a row
    const int kz = nk * kBN, rows = min(kBM, sq - q0);
    for (int r = warp; r < rows; r += kThreads / 32)
      for (int key = kz + lane; key < sk; key += 32)
        dlb[(long long)(q0 + r) * sk + key] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    store_rows<G::kOMI, kRowStep, kD>(dq + bh * sq * kD, acc[c], q0 + ly,
                                      ocol + 32 * c, sq, vec);
}

// dK·dV at d = 128 and 256: the scores S^T (keys x queries) and dP^T split by
// depth as in dq_depth; the lane finishes the entries of columns
// (queries) j = kOwnCols * part + jj of its product's micro-tile: p * keep
// over S^T's first plane and ds * scale over dP^T's, the strips of dV and
// dK, which every warp then sums in one loop (rows ly + kRowStep i, the
// warp's kOutCols columns)
template <int kD, bool kBias, bool kDropout>
__device__ __forceinline__ void dkv_depth(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    float* __restrict__ dk, float* __restrict__ dv, int nbh, int sq, int sk,
    float scale, int causal, int vec, const ScoreBias& bias,
    const Dropout& drop) {
  using G = Bwd<kD>;
  constexpr int kBM = G::kBM, kBN = G::kBN, kThreads = G::kThreads,
                kStride = G::kStride, kSStride = G::kSStride,
                kTile = G::kTile, kBlockTile = G::kBlockTile,
                kMI = G::kDMI, kNJ = G::kDNJ, kOwn = G::kOwnCols,
                kPartD = kD / G::kScoreParts, kChunks = G::kOutCols / 32;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [kBM][kStride]
  float* vs = ks + kBlockTile;       // [kBM][kStride]
  // [S^T, dP^T][kScoreParts - 1][kBM][kSStride]: the partial scores; the
  // first plane of each is the p * keep (ds * scale) strip
  float* sparts = vs + kBlockTile;
  float* dparts = sparts + (G::kScoreParts - 1) * G::kStrip;
  // [kStages][Q, dO][kBN][kStride], then [kStages][lse, D][kBN]
  float* stage = sparts + G::kDkvStrips * G::kStrip;
  float* vecs = stage + kStages * 2 * kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's product (S^T or dP^T) and its part of d in the scores
  const bool dpw = warp >= G::kScoreParts;
  const int part = warp % G::kScoreParts;
  const int ly = lane >> 3, lx = lane & 7;
  const long long bh = block_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int k0 = blockIdx.y * kBM;  // the first key blocks see the most
  const float* qb = q + bh * sq * kD;
  const float* dob = dout + bh * sq * kD;
  const float* lb = lse + bh * sq;
  const float* db = dvec + bh * sq;
  const float* bs = kBias ? bias.slice(bh) : nullptr;
  const uint32_t dhead = kDropout ? drop.head(bh) : 0u;
  // causal: query tiles below k0 see none of this block's keys
  const int qt0 = causal ? k0 / kBN : 0;
  const int nq = max(0, (sq + kBN - 1) / kBN - qt0);

  // Q and the lse slice (which 0), dO and the D slice (which 1) of query
  // tile it into its stage
  auto load = [&](int it, int which) {
    float* st = stage + (it % kStages) * 2 * kTile + which * kTile;
    float* sv = vecs + (it % kStages) * 2 * kBN + which * kBN;
    const int row0 = (qt0 + it) * kBN;
    copy_tile<kBN, kThreads, kD, kStride>(st, which == 0 ? qb : dob, row0,
                                          sq, vec);
    const int r = threadIdx.x;
    if (r < kBN) {
      const bool ok = row0 + r < sq;
      const float* src = which == 0 ? lb : db;
      cp_async4(sv + r, ok ? src + row0 + r : src, ok);
    }
  };
  copy_tile<kBM, kThreads, kD, kStride>(ks, k + bh * sk * kD, k0, sk, vec);
  copy_tile<kBM, kThreads, kD, kStride>(vs, v + bh * sk * kD, k0, sk, vec);
  if (nq > 0) {
    load(0, 0);
    load(0, 1);
  }
  cp_async_commit();

  const int dcol = part * kPartD;  // the warp's part of d in the scores
  const int ocol = warp * G::kOutCols + 4 * lx;  // its first dK / dV column
  float ak[kChunks][G::kOMI][4], av[kChunks][G::kOMI][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    zero(ak[c]);
    zero(av[c]);
  }

  for (int it = 0; it < nq; ++it) {
    APEX_SPLIT(0, it, "start");
    // tile it has landed for every thread, and every warp is done with
    // tile it - 1: its stage, the planes and the strips are free for tile
    // it + 1
    cp_async_wait<0>();
    __syncthreads();
    APEX_SPLIT(1, it, "wait tile");
    if (it + 1 < nq) {
      load(it + 1, 0);
      load(it + 1, 1);
    }
    cp_async_commit();
    const float* qs = stage + (it % kStages) * 2 * kTile;
    const float* dos = qs + kTile;
    const float* ls = vecs + (it % kStages) * 2 * kBN;
    const float* ds = ls + kBN;
    const int q0 = (qt0 + it) * kBN;
    // S^T's warps: the bias of the entries the lane finishes, loaded here
    // so that the loads run under the score product
    float bv[kMI][kOwn];
    if constexpr (kBias) {
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int key = k0 + ly + kRowStep * i;
#pragma unroll
        for (int jj = 0; jj < kOwn; ++jj) {
          const int qry = q0 + lx + kColStep * (kOwn * part + jj);
          const bool m = key >= sk || qry >= sq || (causal && key > qry);
          bv[i][jj] = !dpw && !m ? bias.at(bs, qry, key) : 0.f;
        }
      }
    }
    float own[kMI][kOwn];
    {
      float s[kMI][kNJ];
      zero(s);
      score_product<kMI, kRowStep, kColStep, kPartD, kStride, kUnroll>(
          s, (dpw ? vs : ks) + ly * kStride + dcol,
          (dpw ? dos : qs) + lx * kStride + dcol);
      put_partials<kD>(dpw ? dparts : sparts, s, part, ly, lx);
      own_partials<kD>(own, s, part);
    }
    APEX_SPLIT(2, it, "S^T | dP^T part");
    __syncthreads();  // every partial stored
    APEX_SPLIT(3, it, "partials barrier");
    // the lane's entries: S^T's warps p over S^T's first plane; dP^T's
    // warps dp, in registers
    float dps[kMI][kOwn];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int r = ly + kRowStep * i, key = k0 + r;
#pragma unroll
      for (int jj = 0; jj < kOwn; ++jj) {
        const int c = lx + kColStep * (kOwn * part + jj), qry = q0 + c;
        const int e = r * kSStride + c;
        if (dpw) {
          dps[i][jj] = whole_score<kD>(dparts, e, part, own[i][jj]);
        } else {
          const bool m = key >= sk || qry >= sq || (causal && key > qry);
          // __fmul_rn / __fadd_rn: no FMA contraction, so the score is
          // the plain version's round(round(q.k * scale) + bias)
          float a = __fmul_rn(whole_score<kD>(sparts, e, part, own[i][jj]),
                              scale);
          if constexpr (kBias)
            if (!m) a = __fadd_rn(a, bv[i][jj]);
          sparts[e] = m ? 0.f : bwd_p(a, ls[c]);
        }
      }
    }
    APEX_SPLIT(4, it, "p | dp");
    __syncthreads();  // p is written
    APEX_SPLIT(5, it, "p barrier");
    if (dpw) {  // ds * scale = p (dp * keep - D) * scale over dP^T's plane,
                // p times its keep factor over S^T's
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        const int r = ly + kRowStep * i, key = k0 + r;
#pragma unroll
        for (int jj = 0; jj < kOwn; ++jj) {
          const int c = lx + kColStep * (kOwn * part + jj), qry = q0 + c;
          const int e = r * kSStride + c;
          const float p = sparts[e];
          if (kDropout) {
            const float keep = drop.keep(dhead, qry, key);
            dparts[e] = p * (dps[i][jj] * keep - ds[c]) * scale;
            sparts[e] = p * keep;
          } else {
            dparts[e] = p * (dps[i][jj] - ds[c]) * scale;
          }
        }
      }
    }
    __syncthreads();  // the strips are whole
    APEX_SPLIT(6, it, "ds, strip barrier");
    out_chunks<G::kOMI, kChunks, kBN, kStride, kSStride, true>(
        av, sparts + ly * kSStride, dos + ocol, ak, dparts + ly * kSStride,
        qs + ocol);
    APEX_SPLIT(7, it, "dV, dK");
  }
  cp_async_wait<0>();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    store_rows<G::kOMI, kRowStep, kD>(dk + bh * sk * kD, ak[c], k0 + ly,
                                      ocol + 32 * c, sk, vec);
    store_rows<G::kOMI, kRowStep, kD>(dv + bh * sk * kD, av[c], k0 + ly,
                                      ocol + 32 * c, sk, vec);
  }
}

template <int kD, bool kBias, bool kDropout, bool kDbias>
__global__ void __launch_bounds__(Bwd<kD>::kThreads, Bwd<kD>::kBlocksPerSM)
fa_bwd_dq_kernel_fma(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, float* __restrict__ dq,
                     int nbh, int sq, int sk, float scale, int causal,
                     int vec, ScoreBias bias, Dropout drop,
                     float* __restrict__ dlogits) {
  if constexpr (Bwd<kD>::kScoreParts == 1)
    dq_rows<kD, kBias, kDropout, kDbias>(q, k, v, dout, lse, dvec, dq, nbh,
                                         sq, sk, scale, causal, vec, bias,
                                         drop, dlogits);
  else
    dq_depth<kD, kBias, kDropout, kDbias>(q, k, v, dout, lse, dvec, dq, nbh,
                                          sq, sk, scale, causal, vec, bias,
                                          drop, dlogits);
}

template <int kD, bool kBias, bool kDropout>
__global__ void __launch_bounds__(Bwd<kD>::kThreads, Bwd<kD>::kBlocksPerSM)
fa_bwd_dkv_kernel_fma(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dvec, float* __restrict__ dk,
                      float* __restrict__ dv, int nbh, int sq, int sk,
                      float scale, int causal, int vec, ScoreBias bias,
                      Dropout drop) {
  if constexpr (Bwd<kD>::kScoreParts == 1)
    dkv_rows<kD, kBias, kDropout>(q, k, v, dout, lse, dvec, dk, dv, nbh, sq,
                                  sk, scale, causal, vec, bias, drop);
  else
    dkv_depth<kD, kBias, kDropout>(q, k, v, dout, lse, dvec, dk, dv, nbh,
                                   sq, sk, scale, causal, vec, bias, drop);
}

// a kernel's shared memory, and with kBlocksPerSM > 1 all of the SM's
// unified memory as shared memory, so that kBlocksPerSM blocks fit
template <int kD, typename Kernel>
void prepare(Kernel kernel, int smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  if constexpr (Bwd<kD>::kBlocksPerSM > 1)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
}

// a separate instantiation for each form, so the kernel without a bias,
// dropout or dlogits keeps no registers or branches of theirs; dlogits
// come with a bias only
template <int kD>
auto dq_kernel(bool bias, bool drop, bool dlogits) {
  return dlogits ? (drop ? fa_bwd_dq_kernel_fma<kD, true, true, true>
                         : fa_bwd_dq_kernel_fma<kD, true, false, true>)
         : bias  ? (drop ? fa_bwd_dq_kernel_fma<kD, true, true, false>
                         : fa_bwd_dq_kernel_fma<kD, true, false, false>)
                 : (drop ? fa_bwd_dq_kernel_fma<kD, false, true, false>
                         : fa_bwd_dq_kernel_fma<kD, false, false, false>);
}

template <int kD>
auto dkv_kernel(bool bias, bool drop) {
  return bias ? (drop ? fa_bwd_dkv_kernel_fma<kD, true, true>
                      : fa_bwd_dkv_kernel_fma<kD, true, false>)
              : (drop ? fa_bwd_dkv_kernel_fma<kD, false, true>
                      : fa_bwd_dkv_kernel_fma<kD, false, false>);
}

template <int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dvec, void* dq, int bh,
              int grid_y, int grid_z, int sq, int sk, float scale,
              int causal, const ScoreBias& bias, const Dropout& drop,
              float* dlogits, cudaStream_t stream) {
  using G = Bwd<kD>;
  if ((sq + G::kBM - 1) / G::kBM > 65535) return (int)cudaErrorInvalidValue;
  const int smem = (int)(G::kDqSmemFloats * sizeof(float));
  const auto kernel = dq_kernel<kD>(bias.p != nullptr, drop.seed != nullptr,
                                    dlogits != nullptr);
  prepare<kD>(kernel, smem);
  const dim3 grid(grid_y, (sq + G::kBM - 1) / G::kBM, grid_z);
  kernel<<<grid, G::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<float*>(dq), bh, sq, sk, scale, causal,
      (int)(is_aligned(q, 16) && is_aligned(k, 16) && is_aligned(v, 16) &&
            is_aligned(dout, 16) && is_aligned(dq, 16)),
      bias, drop, dlogits);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dvec, void* dk, void* dv, int bh,
               int grid_y, int grid_z, int sq, int sk, float scale,
               int causal, const ScoreBias& bias, const Dropout& drop,
               cudaStream_t stream) {
  using G = Bwd<kD>;
  if ((sk + G::kBM - 1) / G::kBM > 65535) return (int)cudaErrorInvalidValue;
  const int smem = (int)(G::kDkvSmemFloats * sizeof(float));
  const auto kernel = dkv_kernel<kD>(bias.p != nullptr, drop.seed != nullptr);
  prepare<kD>(kernel, smem);
  const dim3 grid(grid_y, (sk + G::kBM - 1) / G::kBM, grid_z);
  kernel<<<grid, G::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<float*>(dk), static_cast<float*>(dv), bh, sq, sk, scale,
      causal,
      (int)(is_aligned(q, 16) && is_aligned(k, 16) && is_aligned(v, 16) &&
            is_aligned(dout, 16) && is_aligned(dk, 16) &&
            is_aligned(dv, 16)),
      bias, drop);
  return (int)cudaGetLastError();
}

// the blocks of one form of the dq (kernel 0) or dK·dV (1) kernel that an
// SM holds at once, as launched
template <int kD>
int occupancy(int kernel, int bias, int drop, int dlogits, int* blocks) {
  using G = Bwd<kD>;
  if (kernel == 0) {
    const auto f = dq_kernel<kD>(bias, drop, dlogits);
    prepare<kD>(f, (int)(G::kDqSmemFloats * sizeof(float)));
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, f, G::kThreads, G::kDqSmemFloats * sizeof(float));
  }
  const auto f = dkv_kernel<kD>(bias, drop);
  prepare<kD>(f, (int)(G::kDkvSmemFloats * sizeof(float)));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, f, G::kThreads, G::kDkvSmemFloats * sizeof(float));
}

}  // namespace

// dtype: 0 = float32 (q, k, v, do and the gradients; bfloat16 is
// apex_fa_bwd_dq_wgmma's and apex_fa_bwd_dkv_wgmma's); lse and dvec are
// float32 [bh, sq]. d: 64, 128 or 256 (the compiled widths; the wrapper
// pads any other d). grid_y, grid_z,
// bias, heads, the bias strides and the dropout seed, threshold and keep
// as for apex_fa_fwd. dlogits: float32 [bh, sq, sk], every entry written,
// or null; only with a bias.
extern "C" int apex_fa_bwd_dq(const void* q, const void* k, const void* v,
                              const void* bias, const void* dout,
                              const void* lse, const void* dvec, void* dq,
                              int bh, int grid_y, int grid_z, int heads,
                              int sq, int sk, int d, float scale, int causal,
                              long long bsb, long long bsh, long long bsq,
                              long long bsk, const void* seed,
                              unsigned threshold, float keep, void* dlogits,
                              int dtype, void* stream) {
  if ((d != 64 && d != 128 && d != 256) || heads < 1 ||
      !bh_grid_ok(bh, grid_y, grid_z) ||
      (dlogits != nullptr && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const apex_port::ScoreBias sb{static_cast<const float*>(bias), heads,
                                bsb, bsh, bsq, bsk};
  const apex_port::Dropout dr{static_cast<const int*>(seed), threshold,
                              keep};
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const auto run = d == 64    ? launch_dq<64>
                   : d == 128 ? launch_dq<128>
                              : launch_dq<256>;
  return run(q, k, v, dout, lse, dvec, dq, bh, grid_y, grid_z, sq, sk, scale,
             causal, sb, dr, static_cast<float*>(dlogits), s);
}

extern "C" int apex_fa_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* dvec, void* dk,
                               void* dv, int bh, int grid_y, int grid_z,
                               int heads, int sq, int sk, int d, float scale,
                               int causal, long long bsb, long long bsh,
                               long long bsq, long long bsk, const void* seed,
                               unsigned threshold, float keep, int dtype,
                               void* stream) {
  if ((d != 64 && d != 128 && d != 256) || heads < 1 ||
      !bh_grid_ok(bh, grid_y, grid_z))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const apex_port::ScoreBias sb{static_cast<const float*>(bias), heads,
                                bsb, bsh, bsq, bsk};
  const apex_port::Dropout dr{static_cast<const int*>(seed), threshold,
                              keep};
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const auto run = d == 64    ? launch_dkv<64>
                   : d == 128 ? launch_dkv<128>
                              : launch_dkv<256>;
  return run(q, k, v, dout, lse, dvec, dk, dv, bh, grid_y, grid_z, sq, sk,
             scale, causal, sb, dr, s);
}

// The resident blocks an SM of the current device holds of the fp32 dq
// (kernel 0) or dK·dV (kernel 1) kernel at head width d in the form
// (bias, dropout, dlogits; dlogits only in dq, with a bias), into
// *blocks.
extern "C" int apex_fa_bwd_fma_occupancy(int d, int kernel, int bias,
                                         int drop, int dlogits,
                                         int* blocks) {
  if ((d != 64 && d != 128 && d != 256) || (kernel != 0 && kernel != 1) ||
      (dlogits && (kernel != 0 || !bias)) || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto run = d == 64    ? occupancy<64>
                   : d == 128 ? occupancy<128>
                              : occupancy<256>;
  return run(kernel, bias, drop, dlogits, blocks);
}
