// Flash-attention backward, the dk / dv half, for Hopper's tensor cores
// (sm_90a), bf16. dq is flash_bwd_dq_wgmma.cu's; the fp32 route keeps the
// FMA kernels of flash_attention_bwd.cu (full fp32 products).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py `_fa_dkv_kernel`,
// causal or not, with or without the additive fp32 score bias (ScoreBias
// in common.cuh) and attention dropout (Dropout in common.cuh), JAX
// layout q / do (b, h, sq, d), k / v (b, h, sk, d), d a compiled head
// width (64, 128 or 256: the template parameter kD; the wrapper pads any
// other d up to the next of them with zero columns), lse and D = rowsum(do
// * o) fp32 (b, h, sq) (D computed outside, `attention_dvec`). Per (key j,
// query i):
//   s  = round(round(q_i . k_j * scale) + bias_ij), masked where j >= sk
//        or (causal) j > i
//   p  = exp(s - lse_i), exactly 0 where masked, s <= -0.5e30 or
//        lse_i <= -0.5e30 (`_bwd_p`; padded and fully masked rows)
//   dv_j += bf16(p * keep_ij) . do_i;  dp = (do_i . v_j) * keep_ij
//   ds = bf16(p * (dp - D_i) * scale);  dk_j += ds . q_i
// keep_ij dropout's keep factor (1 without dropout)
// as in flash_attention_bwd.cu (the scale before the cast gives the TPU's
// folded-scale bits).
//
// What bounds it on this card: operations. Four s x s x d products a head
// (S, dP, dV, dK; half when causal) over ~12 bytes per (row, d) element of
// traffic: hundreds of flops a byte.
//
// What the design does about that: the four products run on the tensor
// cores (wgmma) from tiles that TMA brings into shared memory, each once
// per block. Up to d = 128 a block owns 128 keys of one (b * h) slice:
// two consumer warpgroups of 64 keys
// (wgmma's M) whose K and V rows stay resident in shared memory, and a
// producer warp that streams 64-row Q and dO tiles, with that tile's 64
// lse (as l2, `bwd_lse2`) and D values beside them, through a ring of
// kStages stages ("full": the TMA's bytes and the producer lanes' arrivals
// after their l2 / D stores; "empty": every consumer thread once the
// tile's products are done). From the diagonal on when causal. Per tile
// and warpgroup:
//   S^T = K Q^T, dP^T = V dO^T (both operands from shared memory,
//   K-major), two groups; wait for S^T only;
//   p per accumulator element (l2 indexed by the fragment's column, a
//   query), two instructions (the MUFU's ex2), under dP^T;
//   wait for dP^T; ds per element; both A operands packed to bf16 (p
//   times its keep factor, ds);
//   dV += P^T dO and dK += dS^T Q (A from registers, B the dO / Q tile
//   read MN-major); wait; release the stage.
// With a bias, a quarter of the tile's 32 bias values a thread is read
// while S^T runs, each other quarter after the previous quarter's p, and
// dP^T is issued after p: all of them at once, beside dP^T's (or S^T's)
// registers, spilled. A tile's dropout keep bits (from the indices alone)
// are drawn while the tile before runs its dV and dK products.
// Every product is issued on every path (ptxas serialises the whole wgmma
// pipeline around a product issued on one branch) and a tile's mask is
// decided per loop, not per tile: the tiles across the warpgroup's
// diagonal or the ragged sk edge, which run the masked arithmetic
// (`_mask_split`), come first, in a loop of their own, then the rest. dV
// and dK at N = 128 (d = 128) are one m64n128k16 product a step of depth
// over both 64-column chunks of dO / Q, the A operand fed once (at d =
// 256 one m64n256k16 over all four). The waits are mbar_wait_nt's: without a
// trap instruction the consumers get setmaxnreg's registers, 240 (the
// producer keeps 24); the resident tiles' descriptors are formed at each
// product (product_ss's kFresh), not held across the loop. Each block owns
// its dK and dV rows: no atomics, and two runs give the same bits. Rows
// past sq load as zeros with l2 = +inf and so add nothing.
//
// Head dim 128: each tile arrives as two 64-column boxes (hopper.cuh), S^T
// and dP^T take eight steps of depth; a consumer thread holds 128 fp32 of
// dK and dV beside the 64 of S^T and dP^T (p and ds in place) and the 32
// packed A registers of the dV and dK products. Shared memory holds K and
// V (64 KB), four stages of Q and dO (128 KB) and their l2 / D slices.
//
// Head dim 256: dK and dV over all 256 columns of a consumer's 64 keys
// would be 256 fp32 a thread, past the 255 registers a thread may have,
// and 128 keys of K and V (128 KB) beside two stages of Q and dO (128 KB)
// would not fit a block's 227 KB. So a block owns one 64-key slab
// (Layout::kSlabs = 1) that both consumer warpgroups take, and the work is
// split by output, each product run once: the dV warpgroup (0) runs S^T,
// p and dV += bf16(p * keep) dO over all 256 columns, the dK warpgroup (1)
// dP^T, ds and dK += bf16(ds * scale) Q; p crosses from the one to the
// other in fp32 through shared memory. The tensor-core work of a block is
// one S^T, dP^T, dV and dK of its keys (4/4; the layout this replaces ran
// S^T and dP^T in both warpgroups, each half of dK's and dV's columns:
// 6/4). Per tile (64 queries):
//   dV warpgroup: S^T = K Q^T (m64n64k16, sixteen steps of depth; a bias
//   read in quarters as at d = 128); p; p into the exchange buffer of the
//   tile's parity (16 KB of fp32, each thread's 32 values as eight
//   16-byte chunks, a warp's stores in distinct banks), then it arrives
//   on that buffer's named barrier; dV += P^T dO (A from registers, four
//   m64n256k16 products, dO MN-major); wait; release the stage;
//   dK warpgroup: dP^T = V dO^T; waits on the named barrier; ds from the
//   exchanged p, its dP^T and D; dK += dS^T Q (four m64n256k16); wait;
//   release the stage.
// Each warpgroup holds one accumulator of 128 fp32 a thread beside 32 of
// S^T or dP^T and 16 packed A registers. The dV warpgroup draws the
// dropout keep bits (under its dV) and hands them over in p's sign bit (p
// >= 0; a dropped entry's p is stored negated, -0 for 0), so the dK
// warpgroup hashes nothing. A warpgroup's products overlap the other's p
// or ds: nothing holds the two in step but the exchange. The dV warpgroup
// writes a buffer again two tiles on, into a stage that the dK warpgroup
// released only after it read the buffer, so two buffers need no second
// barrier. Shared memory: K and V 64 KB, two stages of Q and dO 128 KB,
// the exchange 32 KB, the l2 / D slices 1 KB (231,464 bytes with the
// barriers and the alignment). Tried on the card and not kept (PERF.md
// §6): S^T and dP^T split by query halves, bf16 p and ds exchanged
// (m64n32k16 products, which read their A, K or V, from shared memory for
// half the work of a m64n64k16 one: slower); the next tile's S^T or dP^T
// issued under this tile's dV or dK (ptxas serialises the pipeline); dP^T
// held back until S^T is done (no gain).
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace apex_port;
using namespace apex_port::hopper;

constexpr int kKeysWG = 64;     // keys per consumer warpgroup
constexpr int kBQ = 64;         // query rows per streamed tile
constexpr int kThreads = 384;   // two consumer warpgroups + the producer
constexpr float kNegInf = -1e30f;
constexpr float kMaskEdge = 0.5f * kNegInf;

// The block at head dim kD (64, 128 or 256): kSlabs 64-key slabs, one a
// consumer warpgroup holding dK and dV over all kD columns (d <= 128), or
// one slab that both warpgroups take (d = 256), the one holding dV, the
// other dK, over all kD columns, S^T's p crossing between them through two
// exchange buffers of kXBytes (fp32); kStages stages of Q and dO. A
// tile's rows are 64-column chunks of 128 bytes, chunk c c * kHalf bytes
// after the first: kBQ * 128 for a Q / dO tile, kBK * 128 for K and V.
template <int kD>
struct Layout {
  static constexpr int kSlabs = kD == 256 ? 1 : 2;
  static constexpr int kBK = kKeysWG * kSlabs;     // keys per block
  static constexpr int kCols = kD;                 // columns of an output
  static constexpr int kStages = kD == 256 ? 2 : 4;
  static constexpr int kTileBytes = kBQ * kD * 2;  // one 64-row bf16 tile
  static constexpr int kKVBytes = kBK * kD * 2;    // the resident K (or V)
  static constexpr int kXBytes = kSlabs == 1 ? kKeysWG * kBQ * 4 : 0;
  static constexpr int kTileHalf = kBQ * 128;
  static constexpr int kKVHalf = kBK * 128;
  static constexpr int kOffStages = 2 * kKVBytes;  // Q, dO of each stage
  static constexpr int kOffX = kOffStages + kStages * 2 * kTileBytes;
  static constexpr int kOffStats = kOffX + 2 * kXBytes;
  static constexpr int kOffBars = kOffStats + kStages * 2 * kBQ * 4;
  static constexpr int kSmemBytes = kOffBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kD == 64 || kD == 128 || kD == 256, "compiled head widths");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

// The dropout keep bits of one tile for the thread's two keys (their hash
// terms kt, Dropout::key_term) and 16 queries from q0 (bit 4j + e of
// accumulator element 4j + e): from the indices alone, so each tile's are
// drawn while the tile before runs its dV and dK products
__device__ __forceinline__ uint32_t dkv_kept(const uint32_t (&kt)[2], int q0,
                                             int cq, const Dropout& drop) {
  uint32_t kept = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (drop.kept_at(kt[e >> 1], q0 + 8 * j + cq + (e & 1)))
        kept |= 1u << (4 * j + e);
  return kept;
}

// The bias of a quarter of a tile's (query, key) pairs for the thread's
// two keys and 4 of its queries (j in [kJ0, kJ0 + 2); element 4 (j - kJ0)
// + e), 0 where the key is past sk (kMasked) or the query past sq (never
// read there; a pair above the diagonal is read, and its p set to 0
// after).
template <bool kMasked, int kJ0>
__device__ __forceinline__ void dkv_bias(float (&bv)[8], int key0, int q0,
                                         int cq, int sq, int sk,
                                         const ScoreBias& bias,
                                         const float* bs) {
  // the keys' offsets into the bias formed here each time (an empty asm
  // hides key0 from the loop), not held across the tiles
  asm volatile("" : "+r"(key0));
#pragma unroll
  for (int j = kJ0; j < kJ0 + 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + (e >> 1) * 8;
      const int qry = q0 + 8 * j + cq + (e & 1);
      bv[4 * (j - kJ0) + e] = (!kMasked || key < sk) && qry < sq
                                  ? bias.at(bs, qry, key)
                                  : 0.f;
    }
}

// p (into s, from the scores S^T) of the thread's two keys and the queries
// j in [kJ0, kJ0 + kJN) of one tile, with their bias bv (kBias, kJN = 2;
// as dkv_bias). ls: the tile's queries' l2 (`bwd_lse2`); scale2 = scale
// log2(e), which takes the score's scale into the power without a bias.
// kMasked: the tile crosses the diagonal or the sk edge.
template <bool kBias, bool kMasked, int kJ0, int kJN>
__device__ __forceinline__ void dkv_p(float (&s)[32], const float (&bv)[8],
                                      const float* ls, int key0, int q0,
                                      int cq, int sk, float scale,
                                      float scale2, int causal) {
#pragma unroll
  for (int j = kJ0; j < kJ0 + kJN; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + (e >> 1) * 8;
      const int qry = q0 + 8 * j + cq + (e & 1);
      const float l = (e & 1) ? l2.y : l2.x;
      const bool dead =
          kMasked && (key >= sk || (causal && key > qry));
      float p;
      if (kBias) {
        // __fmul_rn / __fadd_rn: no FMA contraction, so the score is the
        // plain version's round(round(q.k * scale) + bias)
        const float x = __fadd_rn(__fmul_rn(s[4 * j + e], scale),
                                  bv[4 * (j - kJ0) + e]);
        p = x <= kMaskEdge ? 0.f : bwd_p2(x, l);
      } else {
        p = ex2_approx(fmaf(s[4 * j + e], scale2, -l));
      }
      s[4 * j + e] = dead ? 0.f : p;
    }
  }
}

// ds * scale of one tile (into t) from p (s) and dP^T (t): p * (dp * keep -
// D) * scale, D indexed by the fragment's column, and p * keep (into s);
// then both A operands: the dv product's bf16(p * keep) (do's dtype) and
// the dk product's bf16(ds * scale) (q's dtype). kept: the keep bits
// (dkv_kept), keep_scale a kept entry's factor.
template <bool kDropout>
__device__ __forceinline__ void dkv_ds(float (&s)[32], float (&t)[32],
                                       uint32_t (&ap)[4][4],
                                       uint32_t (&ads)[4][4], const float* dd,
                                       int cq, float scale, uint32_t kept,
                                       float keep_scale) {
  // a step of depth (16 queries: two j) at a time, so that each step's p
  // and ds die as its A operands are packed
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const float dsum = (e & 1) ? d2.y : d2.x;
        if (kDropout) {
          const float keep = (kept >> x & 1) ? keep_scale : 0.f;
          t[x] = s[x] * (t[x] * keep - dsum) * scale;
          s[x] *= keep;
        } else {
          t[x] = s[x] * (t[x] - dsum) * scale;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 8 * kk + 2 * i;
      ap[kk][i] = pack_bf16(s[e], s[e + 1]);
      ads[kk][i] = pack_bf16(t[e], t[e + 1]);
    }
  }
}

// What a consumer warpgroup's tiles share: its place in shared memory
// (the stage ring, its rows of K and V), its keys, the score's bias and
// dropout
struct DkvTiles {
  uint8_t* smem;        // the block's (Layout's offsets)
  uint32_t k_addr;      // the warpgroup's rows of K (V's kKVBytes after)
  int qt0, key0, cq, sq, sk, causal;
  float scale;
  ScoreBias bias;
  const float* bs;      // the slice's bias
  Dropout drop;
  uint32_t kt[2];       // the dropout hash's terms of the thread's two keys
};

// A quarter of a tile's p with a bias, j in [kJ0, kJ0 + 2): its bias read
// (dkv_bias) after a fence, which keeps those loads from being issued
// before the previous quarter's p is taken, then its p (dkv_p)
template <bool kMasked, int kJ0>
__device__ __forceinline__ void dkv_bias_p(float (&s)[32], float (&bv)[8],
                                           const float* ls,
                                           const DkvTiles& c, int q0) {
  __threadfence_block();
  dkv_bias<kMasked, kJ0>(bv, c.key0, q0, c.cq, c.sq, c.sk, c.bias, c.bs);
  dkv_p<true, kMasked, kJ0, 2>(s, bv, ls, c.key0, q0, c.cq, c.sk, c.scale,
                               c.scale * kLog2e, c.causal);
}

// Query tile qt of a consumer warpgroup (kMasked: across its diagonal or
// the sk edge), kept its keep bits (dkv_kept; all set without dropout):
// its dP^T product runs under p (without a bias), its products are done
// and its stage released on return, and kept holds the next tile's bits.
template <int kD, bool kBias, bool kMasked, bool kDropout>
__device__ __forceinline__ void dkv_tile(const DkvTiles& c, int qt,
                                         uint32_t& kept,
                                         float (&adk)[Layout<kD>::kCols / 2],
                                         float (&adv)[Layout<kD>::kCols / 2],
                                         float (&s)[32], float (&tp)[32],
                                         uint32_t (&ap)[4][4],
                                         uint32_t (&ads)[4][4]) {
  using L = Layout<kD>;
  const int i = qt - c.qt0, st = i % L::kStages;
  const int q0 = qt * kBQ;
  APEX_SPLIT(0, i, "start");
  uint64_t* full = reinterpret_cast<uint64_t*>(c.smem + L::kOffBars);
  uint64_t* empty = full + L::kStages;
  mbar_wait_nt(&full[st], (i / L::kStages) & 1);
  APEX_SPLIT(1, i, "wait full");
  const uint32_t q_addr =
      smem_addr(c.smem + L::kOffStages + st * 2 * L::kTileBytes);
  const uint32_t v_addr = c.k_addr + L::kKVBytes;
  const uint32_t do_addr = q_addr + L::kTileBytes;
  // the stage's l2 (bwd_lse2 of its rows' lse), then D
  const float* ls =
      reinterpret_cast<const float*>(c.smem + L::kOffStats) + st * 2 * kBQ;
  wgmma_fence();
  // S^T = K Q^T, dP^T = V dO^T, two groups (K and V resident: descriptors
  // formed at each product, not held across the loop). With a bias, dP^T
  // waits until p is taken: the bias's values, read while S^T runs, do not
  // fit beside dP^T's registers.
  product_ss<kD, true>(s, c.k_addr, L::kKVHalf, q_addr, L::kTileHalf);
  wgmma_commit();
  if constexpr (!kBias) {
    product_ss<kD, true>(tp, v_addr, L::kKVHalf, do_addr, L::kTileHalf);
    wgmma_commit();
  }
  // with a bias, its first quarter read under S^T
  float bv[8];
  if constexpr (kBias)
    dkv_bias<kMasked, 0>(bv, c.key0, q0, c.cq, c.sq, c.sk, c.bias, c.bs);
  wgmma_wait<kBias ? 0 : 1>();  // S^T done
  fence_regs(s);
  APEX_SPLIT(2, i, "S^T (and a quarter of the bias)");
  // p, under dP^T without a bias
  const float scale2 = c.scale * kLog2e;
  if constexpr (kBias) {
    // a quarter's p, then the next quarter's bias and p (dkv_bias_p): the
    // tile's 32 values a thread at once spilled
    dkv_p<true, kMasked, 0, 2>(s, bv, ls, c.key0, q0, c.cq, c.sk, c.scale,
                               scale2, c.causal);
    dkv_bias_p<kMasked, 2>(s, bv, ls, c, q0);
    dkv_bias_p<kMasked, 4>(s, bv, ls, c, q0);
    dkv_bias_p<kMasked, 6>(s, bv, ls, c, q0);
  } else {
    dkv_p<false, kMasked, 0, 8>(s, bv, ls, c.key0, q0, c.cq, c.sk, c.scale,
                                scale2, c.causal);
  }
  if constexpr (kBias) {
    wgmma_fence();
    product_ss<kD, true>(tp, v_addr, L::kKVHalf, do_addr, L::kTileHalf);
    wgmma_commit();
  }
  APEX_SPLIT(3, i, "p");
  wgmma_wait<0>();  // dP^T done
  fence_regs(tp);
  APEX_SPLIT(4, i, "dP^T");
  dkv_ds<kDropout>(s, tp, ap, ads, ls + kBQ, c.cq, c.scale, kept,
                   c.drop.scale);
  APEX_SPLIT(5, i, "ds, both A operands");
  wgmma_fence();
  // dV += P^T dO, dK += dS^T Q (dO, Q MN-major)
  product_rs(adv, ap, do_addr, L::kTileHalf);
  product_rs(adk, ads, q_addr, L::kTileHalf);
  wgmma_commit();
  // the next tile's keep bits under dV and dK
  if (kDropout) kept = dkv_kept(c.kt, q0 + kBQ, c.cq, c.drop);
  wgmma_wait<0>();
  fence_regs(adv);
  fence_regs(adk);
  fence_regs(ap);
  fence_regs(ads);
  mbar_arrive(&empty[st]);  // the stage is read
  APEX_SPLIT(6, i, "dV, dK");
}

// The exchange buffer of query tile i (its parity) at d = 256, from a
// consumer thread t's 32 values of p in it: eight 16-byte chunks, chunk h
// (accumulator elements 4h .. 4h + 3) at (h * 128 + t) * 16 bytes, so
// that a warp's stores and loads of one chunk cover 512 contiguous bytes
__device__ __forceinline__ float4* dkv_pbuf(const DkvTiles& c, int i,
                                            int t) {
  using L = Layout<256>;
  return reinterpret_cast<float4*>(c.smem + L::kOffX +
                                   (i & 1) * L::kXBytes) + t;
}

// Query tile qt of the dV warpgroup at d = 256 (kMasked: across the slab's
// diagonal or the sk edge), kept its keep bits (dkv_kept; all set without
// dropout): S^T, p (with a bias read in quarters, dkv_bias_p), p to the dK
// warpgroup (the exchange, a dropped entry's p negated, then named barrier
// 1 + the tile's parity), dV += bf16(p * keep) dO over all 256 columns;
// its products done and its stage released on return, kept holds the next
// tile's bits.
template <bool kBias, bool kMasked, bool kDropout>
__device__ __forceinline__ void dkv_tile_dv(const DkvTiles& c, int qt, int t,
                                            uint32_t& kept,
                                            float (&adv)[128],
                                            float (&s)[32],
                                            uint32_t (&ap)[4][4]) {
  using L = Layout<256>;
  const int i = qt - c.qt0, st = i % L::kStages;
  const int q0 = qt * kBQ;
  APEX_SPLIT(0, i, "start");
  uint64_t* full = reinterpret_cast<uint64_t*>(c.smem + L::kOffBars);
  uint64_t* empty = full + L::kStages;
  mbar_wait_nt(&full[st], (i / L::kStages) & 1);
  APEX_SPLIT(1, i, "wait full");
  const uint32_t q_addr =
      smem_addr(c.smem + L::kOffStages + st * 2 * L::kTileBytes);
  const uint32_t do_addr = q_addr + L::kTileBytes;
  const float* ls =
      reinterpret_cast<const float*>(c.smem + L::kOffStats) + st * 2 * kBQ;
  wgmma_fence();
  // S^T = K Q^T (K resident: descriptors formed at each product)
  product_ss<256, true>(s, c.k_addr, L::kKVHalf, q_addr, L::kTileHalf);
  wgmma_commit();
  float bv[8];
  if constexpr (kBias)  // its first quarter under S^T
    dkv_bias<kMasked, 0>(bv, c.key0, q0, c.cq, c.sq, c.sk, c.bias, c.bs);
  wgmma_wait<0>();
  fence_regs(s);
  APEX_SPLIT(2, i, "S^T");
  if constexpr (kBias) {
    dkv_p<true, kMasked, 0, 2>(s, bv, ls, c.key0, q0, c.cq, c.sk, c.scale,
                               c.scale * kLog2e, c.causal);
    dkv_bias_p<kMasked, 2>(s, bv, ls, c, q0);
    dkv_bias_p<kMasked, 4>(s, bv, ls, c, q0);
    dkv_bias_p<kMasked, 6>(s, bv, ls, c, q0);
  } else {
    dkv_p<false, kMasked, 0, 8>(s, bv, ls, c.key0, q0, c.cq, c.sk, c.scale,
                                c.scale * kLog2e, c.causal);
  }
  APEX_SPLIT(3, i, "p");
  // p to the dK warpgroup, a dropped entry's negated (the keep bit in the
  // sign)
  float4* pb = dkv_pbuf(c, i, t);
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = kDropout && !(kept >> (4 * h + e) & 1) ? -s[4 * h + e]
                                                    : s[4 * h + e];
    pb[h * 128] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __threadfence_block();
  bar_arrive(1 + (i & 1), 256);
  // the dv product's A: bf16(p * keep) (do's dtype)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2) {
      const int x = 8 * kk + 2 * e2;
      float a = s[x], b = s[x + 1];
      if (kDropout) {
        a = (kept >> x & 1) ? a * c.drop.scale : 0.f;
        b = (kept >> (x + 1) & 1) ? b * c.drop.scale : 0.f;
      }
      ap[kk][e2] = pack_bf16(a, b);
    }
  APEX_SPLIT(4, i, "p exchange, A");
  wgmma_fence();
  // dV += P^T dO over all 256 columns (dO MN-major)
  product_rs(adv, ap, do_addr, L::kTileHalf);
  wgmma_commit();
  // the next tile's keep bits under dV
  if (kDropout) kept = dkv_kept(c.kt, q0 + kBQ, c.cq, c.drop);
  wgmma_wait<0>();
  fence_regs(adv);
  fence_regs(ap);
  mbar_arrive(&empty[st]);  // the stage is read
  APEX_SPLIT(5, i, "dV");
}

// Query tile qt of the dK warpgroup at d = 256: dP^T, then (named barrier
// 1 + the tile's parity) ds from the exchanged p (its sign the keep bit),
// dK += bf16(ds * scale) Q over all 256 columns; its products done and its
// stage released on return.
template <bool kDropout>
__device__ __forceinline__ void dkv_tile_dk(const DkvTiles& c, int qt, int t,
                                            float (&adk)[128],
                                            float (&tp)[32],
                                            uint32_t (&ads)[4][4]) {
  using L = Layout<256>;
  const int i = qt - c.qt0, st = i % L::kStages;
  APEX_SPLIT(0, i, "start");
  uint64_t* full = reinterpret_cast<uint64_t*>(c.smem + L::kOffBars);
  uint64_t* empty = full + L::kStages;
  mbar_wait_nt(&full[st], (i / L::kStages) & 1);
  APEX_SPLIT(1, i, "wait full");
  const uint32_t q_addr =
      smem_addr(c.smem + L::kOffStages + st * 2 * L::kTileBytes);
  const uint32_t do_addr = q_addr + L::kTileBytes;
  // the stage's D
  const float* dd = reinterpret_cast<const float*>(c.smem + L::kOffStats) +
                    st * 2 * kBQ + kBQ;
  wgmma_fence();
  // dP^T = V dO^T (V resident)
  product_ss<256, true>(tp, c.k_addr + L::kKVBytes, L::kKVHalf, do_addr,
                        L::kTileHalf);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(tp);
  APEX_SPLIT(2, i, "dP^T");
  bar_sync(1 + (i & 1), 256);  // the tile's p exchanged
  APEX_SPLIT(3, i, "wait p");
  // ds * scale = p * (dp * keep - D) * scale (keep from p's sign), D
  // indexed by the fragment's column, packed a step of depth (16 queries:
  // two 16-byte chunks of p) at a time: the dk product's A (q's dtype)
  const float4* pb = dkv_pbuf(c, i, t);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float4 p0 = pb[(2 * kk) * 128], p1 = pb[(2 * kk + 1) * 128];
    const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int x = 8 * kk + e;
      const float dsum = dd[8 * (x / 4) + c.cq + (e & 1)];
      float dp = tp[x];
      if (kDropout) dp = __float_as_int(p[e]) < 0 ? 0.f : dp * c.drop.scale;
      tp[x] = fabsf(p[e]) * (dp - dsum) * c.scale;
    }
#pragma unroll
    for (int e2 = 0; e2 < 4; ++e2)
      ads[kk][e2] = pack_bf16(tp[8 * kk + 2 * e2], tp[8 * kk + 2 * e2 + 1]);
  }
  APEX_SPLIT(4, i, "ds");
  wgmma_fence();
  // dK += dS^T Q over all 256 columns (Q MN-major)
  product_rs(adk, ads, q_addr, L::kTileHalf);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(adk);
  fence_regs(ads);
  mbar_arrive(&empty[st]);  // the stage is read
  APEX_SPLIT(5, i, "dK");
}

// dk / dv on the tensor cores
template <int kD, bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int nbh, int sq,
                        int sk, float scale, int causal, ScoreBias bias,
                        Dropout drop) {
  using L = Layout<kD>;
  constexpr int kBK = L::kBK, kStages = L::kStages, kCols = L::kCols;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;
  uint8_t* vs = smem + L::kKVBytes;
  // each stage's l2 (bwd_lse2 of its rows' lse), then D
  float* stats = reinterpret_cast<float*>(smem + L::kOffStats);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kOffBars);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const long long bh = batch_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int k0 = blockIdx.x * kBK;  // the first key blocks see the most q
  const int nq = (sq + kBQ - 1) / kBQ;
  // causal: query tiles wholly above the block's first key see none of it
  const int qt0 = causal ? min(k0 / kBQ, nq) : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 32);  // the producer warp's lanes
      mbar_init(&empty[st], 2 * 128);
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup and, below, the warp, from lane 0: to ptxas then uniform
  // across the warp, so what follows from them (the warpgroup's rows, its
  // tiles, the loops) can live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ------------------------------------------------ producer
    regs_dec<24>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 == 8) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * L::kKVBytes);
        tma_load_rows<kD>(ks, &map_k, kvbar, kBK, k0, (int)bh);
        tma_load_rows<kD>(vs, &map_v, kvbar, kBK, k0, (int)bh);
      }
      const float* lb = lse + bh * sq;
      const float* db = dvec + bh * sq;
      for (int qt = qt0; qt < nq; ++qt) {
        const int i = qt - qt0, st = i % kStages;
        mbar_wait_nt(&empty[st], ((i / kStages) & 1) ^ 1);
        float* ls = stats + st * 2 * kBQ;
        for (int r = lane; r < kBQ; r += 32) {
          const int row = qt * kBQ + r;
          ls[r] = bwd_lse2(row < sq ? lb[row] : kNegInf);
          ls[kBQ + r] = row < sq ? db[row] : 0.f;
        }
        if (lane == 0) {
          uint8_t* qs = smem + L::kOffStages + st * 2 * L::kTileBytes;
          mbar_expect_tx(&full[st], 2 * L::kTileBytes);
          tma_load_rows<kD>(qs, &map_q, &full[st], kBQ, qt * kBQ, (int)bh);
          tma_load_rows<kD>(qs + L::kTileBytes, &map_do, &full[st], kBQ,
                            qt * kBQ, (int)bh);
        } else {
          mbar_arrive(&full[st]);  // after this lane's lse / D stores
        }
      }
    }
  } else {
    // ----------------------------------------------- consumers
    regs_inc<240>();
    const int t = threadIdx.x % 128;
    const int warp = __shfl_sync(0xffffffffu, t / 32, 0), lane = t % 32;
    // the warpgroup's slab of keys (at d = 256 both take slab 0)
    const int slab = L::kSlabs == 2 ? wg : 0;
    const int kw0 = k0 + slab * kKeysWG;        // the warpgroup's keys
    const int key0 = kw0 + 16 * warp + lane / 4;  // and key0 + 8
    const int cq = (lane % 4) * 2;
    // the warpgroup's rows of each 64-column chunk of K and V
    const DkvTiles c{smem, smem_addr(ks) + slab * kKeysWG * 128, qt0, key0,
                     cq, sq, sk, causal, scale, bias,
                     kBias ? bias.slice(bh) : nullptr, drop,
                     {kDropout ? drop.key_term(drop.head(bh), key0) : 0u,
                      kDropout ? drop.key_term(drop.head(bh), key0 + 8)
                               : 0u}};

    // The warpgroup's query tiles: from its diagonal when causal (the
    // tiles before it, wholly above its keys, are released unread; all of
    // them when its keys start past sk); the masked ones, [q_start,
    // q_mask), first
    const int q_start = kw0 >= sk ? nq : causal ? min(kw0 / kBQ, nq) : 0;
    const int q_mask = kw0 + kKeysWG > sk ? nq
                       : causal           ? min(q_start + 1, nq)
                                          : q_start;
    mbar_wait_nt(kvbar, 0);
    int qt = qt0;
    for (; qt < q_start; ++qt) {
      const int i = qt - qt0, st = i % kStages;
      mbar_wait_nt(&full[st], (i / kStages) & 1);
      mbar_arrive(&empty[st]);
    }
    uint32_t kept = kDropout ? dkv_kept(c.kt, qt * kBQ, cq, drop) : ~0u;
    // a warpgroup's outputs, each over all kCols columns (one accumulator
    // of N = kCols each): dk and dv (d <= 128), or at d = 256 the dV
    // warpgroup's dv and the dK one's dk; s and ap S^T's p and dV's A, tp
    // and ads dP^T's ds and dK's A
    float acc[L::kSlabs][kCols / 2], s[32], tp[32];
    uint32_t ap[4][4], ads[4][4];
#pragma unroll
    for (int o = 0; o < L::kSlabs; ++o)
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) acc[o][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      tp[i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ap[kk][i] = 0u;
        ads[kk][i] = 0u;
      }
    if constexpr (L::kSlabs == 1) {
      if (wg == 0) {
        for (; qt < q_mask; ++qt)
          dkv_tile_dv<kBias, true, kDropout>(c, qt, t, kept, acc[0], s, ap);
        for (; qt < nq; ++qt)
          dkv_tile_dv<kBias, false, kDropout>(c, qt, t, kept, acc[0], s,
                                              ap);
      } else {
        for (; qt < nq; ++qt)
          dkv_tile_dk<kDropout>(c, qt, t, acc[0], tp, ads);
      }
    } else {
      for (; qt < q_mask; ++qt)
        dkv_tile<kD, kBias, true, kDropout>(c, qt, kept, acc[0], acc[1], s,
                                            tp, ap, ads);
      for (; qt < nq; ++qt)
        dkv_tile<kD, kBias, false, kDropout>(c, qt, kept, acc[0], acc[1], s,
                                             tp, ap, ads);
    }

    if (kw0 < sk) {
      // dk from acc[0] and dv from acc[1]; at d = 256 the warpgroup's one
      __nv_bfloat16* dkb = dk + bh * sk * kD;
      __nv_bfloat16* dvb = dv + bh * sk * kD;
#pragma unroll
      for (int o = 0; o < L::kSlabs; ++o) {
        __nv_bfloat16* ob = L::kSlabs == 1 ? (wg == 0 ? dvb : dkb)
                            : o == 0      ? dkb
                                          : dvb;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = key0 + 8 * h;
          if (key >= sk) continue;
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long long)key * kD +
                                               8 * j + cq) =
                __floats2bfloat162_rn(acc[o][4 * j + 2 * h],
                                      acc[o][4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dvec;
  void *dk, *dv;
  int bh, grid_y, grid_z, sq, sk;
  float scale;
  int causal;
  ScoreBias sb;
  Dropout dr;
  void* stream;
};

template <int kD>
int launch(const Args& a) {
  using L = Layout<kD>;
  // with no queries the Q / dO maps are never read: build them over k
  const bool noq = a.sq <= 0;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map_bf16(&mq, noq ? a.k : a.q, noq ? a.sk : a.sq, a.bh, kBQ,
                     kD) ||
      !make_map_bf16(&mk, a.k, a.sk, a.bh, L::kBK, kD) ||
      !make_map_bf16(&mv, a.v, a.sk, a.bh, L::kBK, kD) ||
      !make_map_bf16(&mdo, noq ? a.k : a.dout, noq ? a.sk : a.sq, a.bh, kBQ,
                     kD))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.sk + L::kBK - 1) / L::kBK, a.grid_y, a.grid_z);
  // a separate instantiation for each form
  const bool b = a.sb.p != nullptr, dd = a.dr.seed != nullptr;
  const auto kernel = b ? (dd ? fa_bwd_dkv_kernel_wgmma<kD, true, true>
                              : fa_bwd_dkv_kernel_wgmma<kD, true, false>)
                        : (dd ? fa_bwd_dkv_kernel_wgmma<kD, false, true>
                              : fa_bwd_dkv_kernel_wgmma<kD, false, false>);
  constexpr int smem = L::kSmemBytes;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dvec), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.bh, noq ? 0 : a.sq, a.sk,
      a.scale, a.causal, a.sb, a.dr);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, do, dk and dv, contiguous and 16-byte aligned; lse and dvec
// float32 [bh, sq]. d: 64, 128 or 256 (the compiled widths; the wrapper
// pads any other d). grid_y, grid_z, bias, heads, the bias strides and the
// dropout seed, threshold and keep as for apex_fa_fwd_wgmma.
extern "C" int apex_fa_bwd_dkv_wgmma(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* dvec, void* dk, void* dv,
    int bh, int grid_y, int grid_z, int heads, int sq, int sk, int d,
    float scale, int causal, long long bsb, long long bsh, long long bsq,
    long long bsk, const void* seed, unsigned threshold, float keep,
    void* stream) {
  if ((d != 64 && d != 128 && d != 256) || heads < 1 ||
      !bh_grid_ok(bh, grid_y, grid_z))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sk <= 0) return 0;
  if (!is_aligned(q, 16) || !is_aligned(k, 16) || !is_aligned(v, 16) ||
      !is_aligned(dout, 16))
    return (int)cudaErrorMisalignedAddress;
  const ScoreBias sb{static_cast<const float*>(bias), heads, bsb, bsh, bsq,
                     bsk};
  const Dropout dr{static_cast<const int*>(seed), threshold, keep};
  const Args a{q, k, v, dout, lse, dvec, dk, dv, bh, grid_y, grid_z, sq, sk,
               scale, causal, sb, dr, stream};
  return d == 64 ? launch<64>(a) : d == 128 ? launch<128>(a) : launch<256>(a);
}
