// Flash-attention forward for Hopper's tensor cores (sm_90a), bf16:
// o = softmax(q k^T * scale + bias) v with an online softmax, plus the fp32
// row log-sum-exp. The fp32 route keeps the FMA kernel of
// flash_attention.cu (full fp32 products; a TF32 product would change the
// numbers users get).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py `flash_attention_fwd`
// (the Pallas kernel `_fa_fwd_kernel`), causal or not, with or without
// the additive fp32 score bias read through per-dimension strides
// (ScoreBias in common.cuh, never expanded), with or without attention
// dropout (Dropout in common.cuh: p times its keep factor before the cast
// to bf16 for the p.v product; l and lse from the undropped p), JAX layout
// q (b, h, sq, d), k / v (b, h, sk, d), d a compiled head width (64, 128
// or 256: the template parameter kD; the wrapper pads any other d up to
// the next of them with zero columns). The arithmetic is the TPU
// kernel's: s = round(round(q.k * scale) + bias) in fp32; masked scores
// (key > row when causal, key >= sk) are -1e30 and a score <= -0.5e30 is
// out of the softmax support; the running max is shifted by 0 while it is
// still "masked"; p is cast to bf16 before the p.v product; o = acc / l, a
// fully masked row giving o = 0 and lse = -1e30; lse = m + log(l) in fp32.
//
// What bounds it on this card: operations. At GPT-2's shapes (4 x 12 x
// 1024 x 64, causal) the products are ~2 x 2 x s^2 / 2 x d flops a head
// over 4 x s x d x 2 bytes of q, k, v and o: ~500 flops a byte, above the
// H100's ridge (~295 for bf16); at d = 128 (Cerebras-GPT 1.3B's 2 x 16 x
// 2048 x 128) and d = 256 (GPT-J 6B's 2 x 16 x 2048 x 256) the flops and
// the bytes grow together. What bounds this kernel in practice is the
// CUDA-core work of exact p between the products (below).
//
// What the design does about that: the products run on the tensor cores
// (wgmma, bf16 in, fp32 sums) from tiles that TMA brings into shared
// memory. A block owns 128 query rows of one (b * h) slice: two consumer
// warpgroups, each 64 rows (wgmma's M) and all d columns of O (Layout::
// kCols = d: 32 fp32 of O a thread for each 64 columns), and a
// producer warpgroup whose one thread issues the loads. Q arrives once;
// K / V tiles of kBK keys (64, or 32 at d = 256, where O holds 128 fp32 a
// thread) stream through a ring of kStages stages, each with a "full"
// barrier (the TMA's bytes) and an "empty" barrier (every consumer thread
// arrives when its products have read the stage). Per tile and warpgroup,
// each product waited for where it is issued (the other warpgroup's work
// fills the time):
// S = Q K^T from shared memory (K stored [key][d] is K-major for B; N =
// kBK), the scale, bias and masks applied per accumulator element from its
// (row, key), row max and sum over the 4 threads of a quad, p packed to
// bf16 in registers as the A operand of O += P V (V, [key][d], is the
// MN-major B operand; a product of N = 64 on each 64-column chunk of V,
// into as many accumulators); O is rescaled only where a row's max moved.
// The consumers keep setmaxnreg's 232 registers (the waits end a stalled
// pipeline with a faulting store, not a trap: hopper.cuh mbar_wait_nt).
// Causal blocks stop at the diagonal; only a
// tile that crosses a warpgroup's diagonal or the ragged sk edge runs the
// masked arithmetic (`_mask_split`), the heaviest query blocks are
// launched first, and rows past sq load as zeros (the 3-D tensor map) and
// are never written. The bias is a compile-time variant.
//
// Every tile's row is 64-column chunks (TMA boxes) of 128 bytes. Shared
// memory (Layout::kSmemBytes): d = 64, Q 16 KB, four stages of 64-key K
// and V 64 KB, the re-sum scratch 80 KB; d = 128, Q 32 KB, three stages
// 96 KB, the scratch 80 KB; d = 256, Q 64 KB, four stages of 32-key K and
// V 128 KB, the scratch 24 KB.
//
// At d = 256 a block makes two passes over the keys (Layout::kTwoPass):
// the first streams K alone and takes each row's exact max (its
// candidates summed again as below, at the end of the pass: most are
// overtaken by a later tile's, so each thread keeps one pending a row,
// max_tile, and resolve_pending reads their rows of K from global memory),
// the second starts from it, so that
// the max never moves and every bf16(p) is exp(s - the row's max) rounded,
// the plain version's bit for bit, with no rescale of O. With one pass, p
// is rounded against the running max and rescaled when a later tile
// raises it, as the TPU kernel's online softmax does: in a row whose max
// moves, a large p can then land a bf16 ulp from the plain version's (2 of
// 148,608 elements of o past FA_TOL in the card test at d = 192 with a
// learned bias and dropout; a 64-key-tile online reference computed in
// PyTorch gives the same 2). d = 64 and 128 keep one pass.
//
// The tensor cores sum a score's d terms in another order than the plain
// version's sequential fp32 product, and bf16(p) can then land on the
// neighbouring bf16 value: in rows of a few keys that moved o past FA_TOL
// (13 of 268,697,600 elements at b * h = 65,600, s = 64). So each tile
// bounds every score's order error from |q| and the tile's largest |k|
// (the producer's idle warps take the key norms), and sums again, in the
// sequential order, the scores whose bf16(p) the bound leaves open and
// those that can be the row's maximum: the warp shares them out, one a
// lane, each lane streaming its rows of Q and K from shared memory a few
// 16-byte chunks ahead of its FMA chain, and the lane that sums a
// score again also takes its p. p is then the plain version's bit for
// bit. Under dropout the value rounded to bf16 is fp32(p * c), c = 1 / (1
// - p_drop), for a kept entry (a dropped one is 0 in both): the midpoint
// test is made on its bits, with a band 4 ulps wider (the product's
// rounding in either order, and p's relative error carried over
// unchanged).
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace apex_port;
using namespace apex_port::hopper;

constexpr int kRowsWG = 64;     // query rows per consumer warpgroup
constexpr int kThreads = 384;   // two consumer warpgroups + the producer
constexpr float kNegInf = -1e30f;
constexpr float kMaskEdge = 0.5f * kNegInf;
constexpr int kNormThread0 = 288;  // the producer's warps 9 and 10: |k|

// How a key tile's softmax treats the row max: the online softmax of one
// pass (the running max), the first of two passes (the exact max only),
// the second (from the exact max, which no tile moves)
enum Pass : int { kOnePass, kMaxPass, kFinalPass };

// The block at head dim kD (64, 128 or 256): 128 query rows, 64 a
// consumer warpgroup, each holding all kD columns of O; kStages stages of
// kBK-key K and V tiles; a first pass over the keys for each row's exact
// max at d = 256 (see the header). A tile's rows are 64-column chunks of
// 128 bytes, chunk c c * kHalf bytes after the first: kBK * 128 for a K /
// V tile, kBQ * 128 for Q. A consumer warp's scratch for the scores summed
// again (softmax_tile): a value slot per (accumulator element, lane), with
// one pass a second for p, and the list of the slots to fill.
template <int kD>
struct Layout {
  static constexpr int kBK = kD == 256 ? 32 : 64;
  static constexpr int kStages = kD == 128 ? 3 : 4;
  static constexpr bool kTwoPass = kD == 256;
  static constexpr int kBQ = 2 * kRowsWG;          // query rows per block
  static constexpr int kCols = kD;                 // O columns a warpgroup
  static constexpr int kE = kBK / 2;               // S values a thread
  static constexpr int kTileBytes = kBK * kD * 2;  // one K or V tile
  static constexpr int kQBytes = kBQ * kD * 2;
  static constexpr int kTileHalf = kBK * 128;
  static constexpr int kQHalf = kBQ * 128;
  static constexpr int kFixSlots = 32 * kE;
  static constexpr int kFixValues = kTwoPass ? 1 : 2;  // fp32 a slot
  static constexpr int kFixBytes = kFixSlots * (4 * kFixValues + 2);
  static constexpr int kOffStages = kQBytes;       // K, V of each stage
  // max |k| of each stage's K tile, one value from each of two warps
  static constexpr int kOffNorms = kOffStages + kStages * 2 * kTileBytes;
  static constexpr int kOffFix = kOffNorms + kStages * 2 * 4;  // 8 warps
  static constexpr int kOffBars = kOffFix + 8 * kFixBytes;
  static constexpr int kSmemBytes = kOffBars + (3 * kStages + 1) * 8 + 1024;
  static_assert(kD == 64 || kD == 128 || kD == 256, "compiled head widths");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The 16-byte chunk c (8 bf16) of row r of a 128-byte-swizzled tile whose
// 64-column chunks lie kHalf bytes apart (c below 8 at d = 64)
template <int kHalf>
__device__ __forceinline__ uint4 tile_chunk(const uint8_t* tile, int r,
                                            int c) {
  return *reinterpret_cast<const uint4*>(
      tile + (c >> 3) * kHalf + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}
// a pair of bf16 (the lower one first in memory) as fp32
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
// |row r|^2 of a 128-byte-swizzled tile (64-column chunks kHalf bytes
// apart), chunks c0 .. c0 + nc - 1 (a bound: the order does not matter)
template <int kHalf>
__device__ __forceinline__ float tile_row_sq(const uint8_t* tile, int r,
                                             int c0, int nc) {
  float acc = 0.f;
#pragma unroll 2
  for (int c = c0; c < c0 + nc; ++c) {
    const uint4 v = tile_chunk<kHalf>(tile, r, c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc = fmaf(bf_lo(w[i]), bf_lo(w[i]),
                 fmaf(bf_hi(w[i]), bf_hi(w[i]), acc));
  }
  return acc;
}
// q . k in the plain version's order: one fp32 FMA a term, d = 0 .. kD -
// 1, from 0 (the sequential sum of cuBLAS's fp32 product, which the FMA
// kernel repeats): row rq of Q against row rk of K, 128-byte-swizzled
// tiles whose 64-column chunks lie kQHalf and kKHalf bytes apart. The
// loads run four 16-byte chunks ahead of the FMA chain, so that the
// gathers' latency hides under it.
template <int kD, int kQHalf, int kKHalf>
__device__ __forceinline__ float seq_dot(const uint8_t* q, int rq,
                                         const uint8_t* k, int rk) {
  constexpr int kC = kD / 8, kAhead = 4;
  uint4 qb[kAhead], kb[kAhead];
#pragma unroll
  for (int c = 0; c < kAhead; ++c) {
    qb[c] = tile_chunk<kQHalf>(q, rq, c);
    kb[c] = tile_chunk<kKHalf>(k, rk, c);
  }
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const uint4 qv = qb[c % kAhead], kv = kb[c % kAhead];
    if (c + kAhead < kC) {
      qb[c % kAhead] = tile_chunk<kQHalf>(q, rq, c + kAhead);
      kb[c % kAhead] = tile_chunk<kKHalf>(k, rk, c + kAhead);
    }
    const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
    const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a = fmaf(bf_lo(qw[i]), bf_lo(kw[i]), a);
      a = fmaf(bf_hi(qw[i]), bf_hi(kw[i]), a);
    }
  }
  return a;
}

// Where the tensor cores' summation order can change bf16(p). A score's
// fp32 sum differs between two orders of its d terms by a few units of
// 2^-24 |q| |k| (the terms' roundings, Cauchy-Schwarz); the tensor cores'
// order against the plain version's measured at most 2.22 units at d = 64
// on the card test's data (chip_smoke.py's "bf16 summation order" lines,
// which require at most half of kOrderUnits at each width), and
// kOrderUnits bounds it with room. The worst case of the order error
// grows with the number of terms (each partial sum rounds once more), so
// the bound grows with d: 16 units at d = 64, 32 at d = 128, 64 at d =
// 256. Scaling and
// the bias add round once more each (2^-23 of |q.k * scale| <= scale |q|
// |k| and of |x|).
template <int kD>
constexpr float kOrderUnits = 16.f * (kD / 64);
template <int kD>
constexpr float kErrPerNorm = (kOrderUnits<kD> + 4.f) * 0x1p-24f;

// The tile's scores from S = Q K^T in s, into x (which may be s itself)
// for the thread's rows r0 and r0 + 8: round(round(q.k * scale) + bias)
// (__fmul_rn / __fadd_rn: no FMA contraction, the plain version's
// roundings), -1e30 where masked (kMasked: key >= sk, or key > row when
// causal); mx each row's max and, with a bias, ax its largest |score|.
template <int kE, bool kBias, bool kMasked>
__device__ __forceinline__ void tile_scores(
    const float (&s)[kE], float (&x)[kE], float (&mx)[2], float (&ax)[2],
    int r0, int k0, int cq, int sq, int sk, float scale, int causal,
    const ScoreBias& bias, const float* bs) {
  mx[0] = mx[1] = kNegInf;
  ax[0] = ax[1] = 0.f;
#pragma unroll
  for (int j = 0; j < kE / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >> 1) * 8;
      const int key = k0 + 8 * j + cq + (e & 1);
      float v = __fmul_rn(s[4 * j + e], scale);
      if (kBias && row < sq && (!kMasked || key < sk))
        v = __fadd_rn(v, bias.at(bs, row, key));
      if (kMasked && (key >= sk || (causal && key > row))) v = kNegInf;
      x[4 * j + e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
      if (kBias && v > kMaskEdge) ax[e >> 1] = fmaxf(ax[e >> 1], fabsf(v));
    }
}

// One key tile of the online softmax for the thread's two rows: scores in
// s become p (fp32, times the keep factor under dropout), l is updated
// and the factor O is to be rescaled by is returned in alpha (1 where the
// row's max did not move, and always in kFinalPass). kMasked: the tile
// crosses the diagonal or the sk edge. kPass (Pass): kMaxPass takes only
// the row max m, made exact, and nothing else; kFinalPass starts from the
// exact max, which it keeps.
//
// p is rounded to bf16 before the p.v product, so a score's last bits can
// move p to the neighbouring bf16 value. Where they can (p within the
// score's error bound of a bf16 rounding midpoint), and for the scores
// that can be the row's maximum while the bound moves it, the score is
// summed again in the plain version's order: the row max is the plain
// version's and so is every bf16(p). The warp shares those sums out, one
// a lane (a few a tile), through its scratch: fv the values (p in
// kFinalPass), fp their p (kOnePass), fl the list.
template <int kD, bool kBias, bool kMasked, bool kDropout, int kPass>
__device__ __forceinline__ void softmax_tile(
    float (&s)[Layout<kD>::kE], float (&m)[2], float (&l)[2],
    float (&alpha)[2], const float (&qn)[2], float kmax,
    const uint8_t* qt, const uint8_t* kt, uint8_t* scratch, int row0,
    int rw, int lane, int k0, int sq, int sk, float scale, int causal,
    const ScoreBias& bias, const float* bs, const Dropout& drop,
    uint32_t dhead) {
  using L = Layout<kD>;
  constexpr int kE = L::kE;
  constexpr bool kMaxOnly = kPass == kMaxPass, kFinal = kPass == kFinalPass;
  float* fv = reinterpret_cast<float*>(scratch);
  float* fp = fv + L::kFixSlots;  // kOnePass only
  uint16_t* fl =
      reinterpret_cast<uint16_t*>(scratch + L::kFixSlots * 4 * L::kFixValues);
  const int r0 = row0 + rw + lane / 4;  // the thread's rows: r0, r0 + 8
  const int cq = (lane % 4) * 2;
  float mx[2], ax[2];
  tile_scores<kE, kBias, kMasked>(s, s, mx, ax, r0, k0, cq, sq, sk, scale,
                                  causal, bias, bs);
  // per row: the scores' error bound, the estimated max and the bound of
  // the exact one, and p's distance to a bf16 rounding midpoint that the
  // bounds allow, in p's ulps (which are at least 2^-24 p)
  float m_est[2], m_safe[2], floor_[2];
  uint32_t width[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float qk = scale * qn[h] * kmax;  // >= |q.k * scale|
    ax[h] = kBias ? quad_max(ax[h]) : qk;
    const float err = fmaf(qk, kErrPerNorm<kD>, 0x1p-22f * ax[h]);
    float em = 0.f;
    if (kFinal) {  // the exact max: nothing of this tile can move it
      m_est[h] = m[h];
      floor_[h] = 3e38f;
    } else {
      mx[h] = quad_max(mx[h]);
      m_est[h] = fmaxf(m[h], mx[h]);
      // the exact max lies in [max(mx - err, m), max(mx + err, m)]
      const float lo = fmaxf(mx[h] - err, m[h]);
      em = mx[h] > kMaskEdge && mx[h] + err > m[h] ? mx[h] + err - lo : 0.f;
      floor_[h] = em > 0.f ? lo - err : 3e38f;  // the max's candidates
    }
    m_safe[h] = m_est[h] <= kMaskEdge ? 0.f : m_est[h];
    const float w = fmaf(err + em + 0x1p-23f * (ax[h] + fabsf(m_safe[h])),
                         0x1.1p24f, 16.f);
    width[h] = w < 32768.f ? (uint32_t)w : 32768u;  // 32768: every p
  }
  // dropout: the kept entries (a bit each)
  uint32_t kept = 0u;
  if (kDropout && !kMaxOnly) {
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if (drop.keep(dhead, r0 + ((e >> 1) & 1) * 8,
                    k0 + 8 * (e >> 2) + cq + (e & 1)) != 0.f)
        kept |= 1u << e;
  }
  float pp[kE];
  uint32_t fix = 0;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int h = (e >> 1) & 1;
    const float x = s[e];
    if (kMaxOnly) {  // the scores that can be the row's max
      if (x > kMaskEdge && x >= floor_[h]) fix |= 1u << e;
      continue;
    }
    pp[e] = expf(x - m_safe[h]);
    bool open;  // bf16 of the value the p.v product takes is in doubt
    if (kDropout) {
      const uint32_t bits = __float_as_uint(pp[e] * drop.scale);
      const uint32_t wd = width[h] + 4u;
      open = ((kept >> e) & 1u) && ((bits - 0x8000u + wd) & 0xFFFFu) <= 2 * wd;
    } else {
      const uint32_t bits = __float_as_uint(pp[e]);
      open = ((bits - 0x8000u + width[h]) & 0xFFFFu) <= 2 * width[h];
    }
    if (x > kMaskEdge && (open || x >= floor_[h])) fix |= 1u << e;
  }
  // the warp's list of slots to sum again (an exclusive prefix of counts)
  const int mine = __popc(fix);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (total > 0) {
    int at = incl - mine;
    for (uint32_t f = fix; f; f &= f - 1)
      fl[at++] = (uint16_t)((__ffs(f) - 1) * 32 + lane);
    __syncwarp();
    // rounds of 32, one a lane; a lane past the list repeats its last
    // entry, unwritten
    for (int base = 0; base < total; base += 32) {
      const int i = base + lane;
      const int slot = fl[min(i, total - 1)];
      const int e = slot >> 5, owner = slot & 31;
      const int rr = rw + owner / 4 + ((e >> 1) & 1) * 8;  // row in qt
      const int kk = 8 * (e >> 2) + (owner % 4) * 2 + (e & 1);
      // the owner's shift of the row: p is taken here
      const float s0 = __shfl_sync(0xffffffffu, m_safe[0], owner);
      const float s1 = __shfl_sync(0xffffffffu, m_safe[1], owner);
      if (i < total) {
        float x = __fmul_rn(
            seq_dot<kD, L::kQHalf, L::kTileHalf>(qt, rr, kt, kk), scale);
        if (kBias && row0 + rr < sq)
          x = __fadd_rn(x, bias.at(bs, row0 + rr, k0 + kk));
        const float ms = (e >> 1) & 1 ? s1 : s0;
        if (kFinal) {
          fv[slot] = expf(x - ms);
        } else {
          fv[slot] = x;
          if (!kMaxOnly) fp[slot] = expf(x - ms);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < kE; ++e)
      if ((fix >> e) & 1u) {
        if (kFinal) {
          pp[e] = fv[e * 32 + lane];
        } else {
          s[e] = fv[e * 32 + lane];
          if (!kMaxOnly) pp[e] = fp[e * 32 + lane];
        }
      }
    if (!kFinal) {
      // the row max from the summed-again candidates, then p again in a
      // row where the max moved (the summing lane took p from the old one)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = kNegInf;
#pragma unroll
        for (int j = 0; j < kE / 4; ++j)
          v = fmaxf(v, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        const float m_new = fmaxf(m[h], quad_max(v));
        const bool moved = m_new != m_est[h];
        m_est[h] = m_new;
        m_safe[h] = m_new <= kMaskEdge ? 0.f : m_new;
        if (moved && !kMaxOnly) {
#pragma unroll
          for (int j = 0; j < kE / 4; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              pp[4 * j + 2 * h + c] = expf(s[4 * j + 2 * h + c] - m_safe[h]);
        }
      }
    }
    __syncwarp();  // the scratch is free for the next tile
  }
  if (kMaxOnly) {
    m[0] = m_est[0];
    m[1] = m_est[1];
    return;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    alpha[h] = kFinal ? 1.f
                      : expf((m[h] <= kMaskEdge ? kNegInf : m[h]) - m_safe[h]);
    m[h] = m_est[h];
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    // dropout: the p.v product takes p times its keep factor
    const bool kept_e = (kept >> e) & 1u;
    s[e] = !kDropout ? pp[e] : kept_e ? pp[e] * drop.scale : 0.f;
    sum[(e >> 1) & 1] += pp[e];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
}

// q . k in the plain version's order (as seq_dot) for row rq of Q in
// shared memory against a row of K in global memory (kr: its kD bf16,
// 16-byte aligned), eight 16-byte loads at a time
template <int kD, int kQHalf>
__device__ __forceinline__ float seq_dot_global(const uint8_t* q, int rq,
                                                const __nv_bfloat16* kr) {
  const uint4* kv = reinterpret_cast<const uint4*>(kr);
  float a = 0.f;
#pragma unroll 1
  for (int g = 0; g < kD / 8; g += 8) {
    uint4 kb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) kb[i] = __ldg(kv + g + i);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 qv = tile_chunk<kQHalf>(q, rq, g + i);
      const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
      const uint32_t kw[4] = {kb[i].x, kb[i].y, kb[i].z, kb[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a = fmaf(bf_lo(qw[j]), bf_lo(kw[j]), a);
        a = fmaf(bf_hi(qw[j]), bf_hi(kw[j]), a);
      }
    }
  }
  return a;
}

// A key tile of the first of two passes, its re-sum deferred to the end
// of the pass: most candidates for a row's exact max are overtaken by a
// later tile's. The row's running max of the tensor cores' scores M and
// error bound E (the largest of its tiles'); per thread and row at most
// one pending candidate, pk its key and px its score: a key whose score
// lies within 2E of M, dropped when M rises past that. True (for the
// whole warp) where a thread would hold two: the tile is then summed
// again at once (softmax_tile's kMaxPass, which keeps m the exact max of
// the keys it summed). The scores in s are left as they are.
template <int kD, bool kBias, bool kMasked>
__device__ __forceinline__ bool max_tile(
    const float (&s)[Layout<kD>::kE], float (&M)[2], float (&E)[2],
    int (&pk)[2], float (&px)[2], const float (&qn)[2], float kmax,
    int row0, int rw, int lane, int k0, int sq, int sk, float scale,
    int causal, const ScoreBias& bias, const float* bs) {
  constexpr int kE = Layout<kD>::kE;
  const int r0 = row0 + rw + lane / 4;  // the thread's rows: r0, r0 + 8
  const int cq = (lane % 4) * 2;
  float x[kE], mx[2], ax[2];
  tile_scores<kE, kBias, kMasked>(s, x, mx, ax, r0, k0, cq, sq, sk, scale,
                                  causal, bias, bs);
  float thr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float qk = scale * qn[h] * kmax;  // >= |q.k * scale|
    ax[h] = kBias ? quad_max(ax[h]) : qk;
    E[h] = fmaxf(E[h], fmaf(qk, kErrPerNorm<kD>, 0x1p-22f * ax[h]));
    M[h] = fmaxf(M[h], quad_max(mx[h]));
    thr[h] = fmaf(-2.f, E[h], M[h]);
    if (pk[h] >= 0 && px[h] < thr[h]) pk[h] = -1;
  }
  bool over = false;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int h = (e >> 1) & 1;
    if (x[e] > kMaskEdge && x[e] >= thr[h]) {
      if (pk[h] < 0) {
        pk[h] = k0 + 8 * (e >> 2) + cq + (e & 1);
        px[h] = x[e];
      } else {
        over = true;
      }
    }
  }
  return __any_sync(0xffffffffu, over);
}

// The end of the first pass: each pending candidate summed again in the
// plain version's order, its row of K read from global memory (kg: the
// slice's keys), the warp sharing them out one a lane; m becomes each
// row's exact max.
template <int kD, bool kBias>
__device__ __forceinline__ void resolve_pending(
    const int (&pk)[2], float (&m)[2], const uint8_t* qt,
    const __nv_bfloat16* kg, uint8_t* scratch, int row0, int rw, int lane,
    int sq, float scale, const ScoreBias& bias, const float* bs) {
  float* fv = reinterpret_cast<float*>(scratch);     // by slot h * 32 + lane
  int* fk = reinterpret_cast<int*>(scratch + 256);   // the slot's key
  uint16_t* fl = reinterpret_cast<uint16_t*>(scratch + 512);  // the list
  const uint32_t fix = (pk[0] >= 0 ? 1u : 0u) | (pk[1] >= 0 ? 2u : 0u);
  const int mine = __popc(fix);
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (total > 0) {
    int at = incl - mine;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (pk[h] >= 0) {
        fl[at++] = (uint16_t)(h * 32 + lane);
        fk[h * 32 + lane] = pk[h];
      }
    __syncwarp();
    for (int base = 0; base < total; base += 32) {
      if (base + lane < total) {
        const int slot = fl[base + lane];
        const int owner = slot & 31, key = fk[slot];
        const int rr = rw + owner / 4 + (slot >> 5) * 8;  // row in qt
        float x = __fmul_rn(seq_dot_global<kD, Layout<kD>::kQHalf>(
                                qt, rr, kg + (long long)key * kD),
                            scale);
        if (kBias && row0 + rr < sq)
          x = __fadd_rn(x, bias.at(bs, row0 + rr, key));
        fv[slot] = x;
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (pk[h] >= 0) m[h] = fmaxf(m[h], fv[h * 32 + lane]);
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = quad_max(m[h]);
}

// A consumer warpgroup's view of the block's pipeline: shared memory, the
// stages' barriers and key norms, the block's key tiles (nk) and the
// warpgroup's (nk_me; none unless active)
struct Pipe {
  uint8_t* smem;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* normed;
  const float* kmaxs;
  int nk, nk_me;
  bool active;
};
// What softmax_tile reads besides S: the warpgroup's Q, the warp's
// scratch, its rows and the call's arguments
struct Tile {
  const uint8_t* qw;
  uint8_t* scratch;
  int row0, rw, lane, sq, sk;
  float scale;
  int causal;
  ScoreBias bias;
  const float* bs;
  Dropout drop;
  uint32_t dhead;
  const __nv_bfloat16* kg;  // the slice's rows of K (the deferred re-sum)
};

// One pass of a consumer warpgroup over the block's nk key tiles, stream
// iterations it0 .. it0 + nk - 1: the first of two passes (the row max
// only) or the output pass. Each product is waited for where it is issued
// (ptxas serialises the wgmma pipeline of this kernel wherever a product
// stays in flight across the softmax, so the two warpgroups' products and
// softmaxes overlap each other instead), and every product is issued on
// every iteration, whatever the warpgroup's rows need (a tile past them
// takes S and a P V of p = 0), so that none sits on a branch.
template <int kD, bool kBias, bool kDropout, bool kOutput>
__device__ __forceinline__ void key_pass(
    const Pipe& pp, const Tile& tl, int it0, float (&acc)[kD / 64][32],
    float (&s)[Layout<kD>::kE], uint32_t (&p)[Layout<kD>::kE / 8][4],
    float (&m)[2], float (&l)[2], const float (&qn)[2]) {
  using L = Layout<kD>;
  constexpr int kStages = L::kStages, kBK = L::kBK, kNC = L::kCols / 64;
  constexpr int kE = L::kE;
  constexpr int kPass = !kOutput      ? kMaxPass
                        : L::kTwoPass ? kFinalPass
                                      : kOnePass;
  const uint32_t q_addr = smem_addr(tl.qw);
  // the first pass: the running max of the tensor cores' scores, its error
  // bound and the pending candidates (max_tile)
  float M[2] = {kNegInf, kNegInf}, E[2] = {0.f, 0.f}, px[2] = {0.f, 0.f};
  int pk[2] = {-1, -1};
  for (int t = 0; t < pp.nk; ++t) {
    const int it = it0 + t, st = it % kStages;
    const uint8_t* kt_s = pp.smem + L::kOffStages + st * 2 * L::kTileBytes;
    mbar_wait_nt(&pp.full[st], (it / kStages) & 1);
    wgmma_fence();
    product_ss<kD>(s, q_addr, L::kQHalf, smem_addr(kt_s), L::kTileHalf);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const bool works = pp.active && t < pp.nk_me;
    float alpha[2] = {1.f, 1.f};
    if (works) {
      const int k0 = t * kBK;
      // `_mask_split`: only a tile across the diagonal or the sk edge
      const bool masked =
          (tl.causal && k0 + kBK - 1 > tl.row0) || k0 + kBK > tl.sk;
      mbar_wait_nt(&pp.normed[st], (it / kStages) & 1);
      const float kmax = fmaxf(pp.kmaxs[2 * st], pp.kmaxs[2 * st + 1]);
      bool now = true;  // the re-sum at once (not deferred)
      if constexpr (!kOutput)
        now = masked ? max_tile<kD, kBias, true>(
                           s, M, E, pk, px, qn, kmax, tl.row0, tl.rw,
                           tl.lane, k0, tl.sq, tl.sk, tl.scale, tl.causal,
                           tl.bias, tl.bs)
                     : max_tile<kD, kBias, false>(
                           s, M, E, pk, px, qn, kmax, tl.row0, tl.rw,
                           tl.lane, k0, tl.sq, tl.sk, tl.scale, tl.causal,
                           tl.bias, tl.bs);
      if (now) {
        if (masked)
          softmax_tile<kD, kBias, true, kDropout, kPass>(
              s, m, l, alpha, qn, kmax, tl.qw, kt_s, tl.scratch, tl.row0,
              tl.rw, tl.lane, k0, tl.sq, tl.sk, tl.scale, tl.causal,
              tl.bias, tl.bs, tl.drop, tl.dhead);
        else
          softmax_tile<kD, kBias, false, kDropout, kPass>(
              s, m, l, alpha, qn, kmax, tl.qw, kt_s, tl.scratch, tl.row0,
              tl.rw, tl.lane, k0, tl.sq, tl.sk, tl.scale, tl.causal,
              tl.bias, tl.bs, tl.drop, tl.dhead);
      }
    }
    if constexpr (kOutput) {
      // O rescaled where a row's max moved; p in bf16 (v's dtype before
      // the p.v product), 0 on a tile past the warpgroup's rows
      if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
        for (int c = 0; c < kNC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
      }
      if (!works) {
#pragma unroll
        for (int e = 0; e < kE; ++e) s[e] = 0.f;
      }
      to_a_operand(s, p);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kNC; ++c) fence_regs(acc[c]);
      // O += P V: a product of N = 64 on each 64-column chunk of V
#pragma unroll
      for (int c = 0; c < kNC; ++c)
        product_rs(acc[c], p,
                   smem_addr(kt_s) + L::kTileBytes + c * L::kTileHalf);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < kNC; ++c) fence_regs(acc[c]);
      fence_regs(p);
    }
    mbar_arrive(&pp.empty[st]);  // the stage is read: K by S, V by P V
  }
  if constexpr (!kOutput) {
#pragma unroll
    for (int h = 0; h < 2; ++h)  // the pending keys still in the window
      if (pk[h] >= 0 && px[h] < fmaf(-2.f, E[h], M[h])) pk[h] = -1;
    resolve_pending<kD, kBias>(pk, m, tl.qw, tl.kg, tl.scratch, tl.row0,
                               tl.rw, tl.lane, tl.sq, tl.scale, tl.bias,
                               tl.bs);
  }
}

template <int kD, bool kBias, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
fa_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __nv_bfloat16* __restrict__ kraw,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int nbh, int sq, int sk, float scale, int causal,
                    ScoreBias bias, Dropout drop) {
  using L = Layout<kD>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kStages = L::kStages;
  constexpr int kNC = L::kCols / 64, kE = L::kE;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  float* kmaxs = reinterpret_cast<float*>(smem + L::kOffNorms);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kOffBars);
  uint64_t* empty = full + kStages;
  uint64_t* normed = empty + kStages;
  uint64_t* qbar = normed + kStages;

  const long long bh = batch_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int nk_all = (sk + kBK - 1) / kBK;
  // the block's key tiles: up to its last real row's diagonal when causal
  const int nk =
      causal ? min(nk_all, (min(q0 + kBQ, sq) - 1) / kBK + 1) : nk_all;
  // the key tiles streamed: twice (K alone, then K and V) where a first
  // pass takes each row's max
  const int passes = L::kTwoPass ? 2 : 1;
  const int n_it = passes * nk;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2 * 128);
      mbar_init(&normed[st], 64);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, warp-uniform as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ------------------------------------------------ producer
    regs_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, L::kQBytes);
      tma_load_rows<kD>(qs, &map_q, qbar, kBQ, q0, (int)bh);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages, kt = L::kTwoPass ? it % nk : it;
        const bool with_v = !L::kTwoPass || it >= (passes - 1) * nk;
        mbar_wait_nt(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* ks = smem + L::kOffStages + st * 2 * L::kTileBytes;
        mbar_expect_tx(&full[st], (with_v ? 2 : 1) * L::kTileBytes);
        tma_load_rows<kD>(ks, &map_k, &full[st], kBK, kt * kBK, (int)bh);
        if (with_v)
          tma_load_rows<kD>(ks + L::kTileBytes, &map_v, &full[st], kBK,
                            kt * kBK, (int)bh);
      }
    } else if (threadIdx.x >= kNormThread0 &&
               threadIdx.x < kNormThread0 + 64) {
      // max |k| of each K tile, for the consumers' error bounds: a key a
      // thread (two threads at 32-key tiles, each half its columns), a max
      // a warp
      constexpr int kPer = 64 / kBK, kNC8 = kD / 8 / kPer;
      const int t = threadIdx.x - kNormThread0, key = t / kPer;
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        mbar_wait_nt(&full[st], (it / kStages) & 1);
        float n2 = tile_row_sq<L::kTileHalf>(
            smem + L::kOffStages + st * 2 * L::kTileBytes, key,
            (t % kPer) * kNC8, kNC8);
        if (kPer == 2) n2 += __shfl_xor_sync(0xffffffffu, n2, 1);
        float n = sqrtf(n2);
#pragma unroll
        for (int d = 16; d; d >>= 1)
          n = fmaxf(n, __shfl_xor_sync(0xffffffffu, n, d));
        if (t % 32 == 0) kmaxs[st * 2 + t / 32] = n;
        mbar_arrive(&normed[st]);
      }
    }
  } else {
    // ----------------------------------------------- consumers
    regs_inc<232>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int row0 = q0 + wg * kRowsWG;          // the warpgroup's first row
    const int r0 = row0 + 16 * warp + lane / 4;  // and r0 + 8
    const int cq = (lane % 4) * 2;
    const bool active = row0 < sq;
    const int nk_me =
        causal ? min(nk_all, (row0 + kRowsWG - 1) / kBK + 1) : nk_all;
    // the warpgroup's Q (its rows of each 64-column chunk)
    const uint8_t* qw = qs + wg * kRowsWG * 128;
    const int rq = 16 * warp + lane / 4;  // r0's row in qw
    Pipe pipe{smem, full, empty, normed, kmaxs, nk, nk_me, active};
    Tile tile{qw, smem + L::kOffFix + (wg * 4 + warp) * L::kFixBytes,
              row0, 16 * warp, lane, sq, sk, scale, causal, bias,
              kBias ? bias.slice(bh) : nullptr, drop,
              kDropout ? drop.head(bh) : 0u, kraw + bh * sk * kD};

    // the warpgroup's o in kNC accumulators of 64 d columns each, and S
    float acc[kNC][32], s[kE], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    uint32_t p[kE / 8][4];
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[c][i] = 0.f;

    mbar_wait_nt(qbar, 0);
    float qn[2];  // |q| of the thread's rows
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qn[h] = sqrtf(quad_sum(tile_row_sq<L::kQHalf>(
          qw, rq + 8 * h, (kD / 32) * (lane % 4), kD / 32)));
    if constexpr (L::kTwoPass)
      key_pass<kD, kBias, kDropout, false>(pipe, tile, 0, acc, s, p, m, l,
                                           qn);
    key_pass<kD, kBias, kDropout, true>(pipe, tile, (passes - 1) * nk, acc,
                                        s, p, m, l, qn);
    if (active) {
      __nv_bfloat16* ob = o + bh * sq * kD;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= sq) continue;
        const float safe_l = l[h] > 0.f ? l[h] : 1.f;
#pragma unroll
        for (int c = 0; c < kNC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(
                ob + (long long)row * kD + 64 * c + 8 * j + cq) =
                __floats2bfloat162_rn(acc[c][4 * j + 2 * h] / safe_l,
                                      acc[c][4 * j + 2 * h + 1] / safe_l);
        if (cq == 0)
          lse[bh * sq + row] =
              m[h] <= kMaskEdge ? kNegInf : m[h] + logf(safe_l);
      }
    }
  }
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int grid_y, int grid_z, int sq, int sk, float scale,
           int causal, const ScoreBias& sb, const Dropout& dr, void* stream) {
  using L = Layout<kD>;
  // with no keys the K / V maps are never read: build them over q
  const bool nokeys = sk <= 0;
  CUtensorMap mq, mk, mv;
  if (!make_map_bf16(&mq, q, sq, bh, L::kBQ, kD) ||
      !make_map_bf16(&mk, nokeys ? q : k, nokeys ? sq : sk, bh, L::kBK,
                     kD) ||
      !make_map_bf16(&mv, nokeys ? q : v, nokeys ? sq : sk, bh, L::kBK, kD))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + L::kBQ - 1) / L::kBQ, grid_y, grid_z);
  // a separate instantiation for each form
  const bool b = sb.p != nullptr, dd = dr.seed != nullptr;
  const auto kernel = b ? (dd ? fa_fwd_kernel_wgmma<kD, true, true>
                              : fa_fwd_kernel_wgmma<kD, true, false>)
                        : (dd ? fa_fwd_kernel_wgmma<kD, false, true>
                              : fa_fwd_kernel_wgmma<kD, false, false>);
  constexpr int smem = L::kSmemBytes;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<const __nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      bh, sq, sk < 0 ? 0 : sk, scale, causal, sb, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v and o, contiguous and 16-byte aligned; lse float32 [bh,
// sq]. d: 64, 128 or 256 (the compiled widths; the wrapper pads any other
// d).
// grid_y x grid_z blocks carry the bh = b * h slices
// (fa_batch_heads_grid in ops/tiling.py). bias: float32 or null; heads = h
// of bh = b * h; bsb, bsh, bsq, bsk its strides in elements (0 on a
// broadcast dimension). seed: the dropout seed, int32 on the device, or
// null without dropout; threshold and keep as in Dropout (common.cuh).
extern "C" int apex_fa_fwd_wgmma(const void* q, const void* k, const void* v,
                                 const void* bias, void* o, void* lse,
                                 int bh, int grid_y, int grid_z, int heads,
                                 int sq, int sk, int d, float scale,
                                 int causal, long long bsb, long long bsh,
                                 long long bsq, long long bsk,
                                 const void* seed, unsigned threshold,
                                 float keep, void* stream) {
  if ((d != 64 && d != 128 && d != 256) || heads < 1 ||
      !bh_grid_ok(bh, grid_y, grid_z))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0) return 0;
  if (!is_aligned(q, 16) || !is_aligned(k, 16) || !is_aligned(v, 16))
    return (int)cudaErrorMisalignedAddress;
  const ScoreBias sb{static_cast<const float*>(bias), heads, bsb, bsh, bsq,
                     bsk};
  const Dropout dr{static_cast<const int*>(seed), threshold, keep};
  const auto run = d == 64 ? launch<64> : d == 128 ? launch<128> : launch<256>;
  return run(q, k, v, o, lse, bh, grid_y, grid_z, sq, sk, scale, causal, sb,
             dr, stream);
}
