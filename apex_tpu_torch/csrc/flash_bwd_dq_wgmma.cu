// Flash-attention backward, the dq half, for Hopper's tensor cores
// (sm_90a), bf16. The fp32 route keeps the FMA kernel of
// flash_attention_bwd.cu (full fp32 products).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py `_fa_dq_kernel`, causal
// or not, with or without the additive fp32 score bias (ScoreBias in
// common.cuh), attention dropout (Dropout in common.cuh) and the dlogits
// of a differentiated bias (`want_dbias`), JAX layout q / do (b, h, sq, d),
// k / v (b, h, sk, d), d a compiled head width (64, 128 or 256: the
// template parameter kD; the wrapper pads any other d up to the next of
// them with zero columns),
// lse and D = rowsum(do * o) fp32 (b, h, sq) (D computed outside,
// `attention_dvec`). Per (query i, key j):
//   s  = round(round(q_i . k_j * scale) + bias_ij), masked where j >= sk
//        or (causal) j > i
//   p  = exp(s - lse_i), exactly 0 where masked, s <= -0.5e30 or
//        lse_i <= -0.5e30 (`_bwd_p`; padded and fully masked rows)
//   dp = (do_i . v_j) * keep_ij,  dl = p * (dp - D_i)
//   ds = bf16(dl * scale),  dq_i += ds . k_j   (fp32 sums, dq in bf16)
// keep_ij dropout's keep factor (1 without dropout); with dlogits, dl in
// fp32 at (i, j) for every i < sq, j < sk, taken from the accumulator
// fragments before they are packed to bf16: 0 where masked or in a key
// tile past the warpgroup's diagonal. That form writes b*h*sq*sk*4 bytes
// and is bound by them.
// as in flash_attention_bwd.cu (the scale before the cast gives the TPU's
// folded-scale bits).
//
// What bounds it on this card: operations. Three s x s x d products a head
// (S, dP, dQ; half when causal) over ~10 bytes per (row, d) element of
// traffic: hundreds of flops a byte.
//
// What the design does about that: the three products run on the tensor
// cores (wgmma) from tiles that TMA brings into shared memory, each once
// per block. A block owns 128 query rows of one (b * h) slice: two
// consumer warpgroups of 64 rows (wgmma's M), each holding all d columns
// of its rows' dQ, whose Q and dO rows stay resident in shared memory, each
// thread holding the lse and D of its two rows in registers, and a
// producer warp that streams kBK-key K and V tiles through a ring of
// kStages stages ("full": the TMA's bytes; "empty": every consumer thread
// once the products that read the stage are done), up to the block's
// diagonal when causal, the heaviest query blocks first. Per tile and
// warpgroup, so that each product runs on the tensor cores under work that
// does not need it:
//   S = Q K^T, dP = dO V^T (both operands from shared memory, K-major; K
//   and V are stored [key][d]), issued together; wait for S only (and the
//   previous tile's dQ, whose stage is then freed);
//   p per accumulator element; wait for dP; ds per element (and the
//   dlogits), packed to bf16;
//   dQ += dS K issued (A from registers, B the same K tile read MN-major),
//   and left in flight into the next tile.
// Every product is issued on every path and a tile's mask is decided per
// loop, not per tile (ptxas serialises the whole pipeline around a product
// issued on one branch): the tiles that need no mask come first, in a loop
// of their own, then those across the warpgroup's diagonal or the ragged
// sk edge (`_mask_split`). dQ at N = 128 or 256 is one m64n128k16 or
// m64n256k16 product a step of depth over all of K's 64-column chunks. The
// waits are mbar_wait_nt's, without a trap instruction, so the consumers
// keep setmaxnreg's 232 registers. Each block owns its dQ rows: no
// atomics, and two runs give the same bits. Rows past sq load as zeros
// with lse = -1e30 and are never written. Head dim 128: each tile arrives
// as two 64-column boxes (hopper.cuh), S and dP take eight steps of depth
// and dQ is 64 fp32 a thread; shared memory holds Q and dO (64 KB) and
// four stages of 64-key K and V (128 KB).
//
// Head dim 256: dQ over all 256 columns is 128 fp32 a consumer thread, so
// the key tiles are 32 keys (Layout::kBK), S and dP 16 fp32 a thread each
// (m64n32k16, sixteen steps of depth), and dQ two m64n256k16 products a
// tile; about 172 registers live, under setmaxnreg's 232. Each
// warpgroup runs its own rows' S, dP and dQ, so no product runs twice:
// the tensor-core work of a block is one S, one dP and one dQ of its rows
// (3/3; the 64-row slab that both warpgroups took before ran S and dP in
// each, 5/3), and each K / V tile is read once for 128 rows. Shared
// memory: Q and dO 128 KB, three stages of K and V 96 KB (230,464 bytes
// with the barriers and the alignment).
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

// The block at head dim kD (64, 128 or 256): 128 query rows, a 64-row
// slab a consumer warpgroup, each holding all kD columns of dQ (kCols:
// kD / 2 fp32 a thread); kStages stages of kBK-key K and V tiles (32 keys
// at d = 256, where dQ holds 128 fp32 a thread: S and dP then take kE = 16
// each). A tile's rows are 64-column chunks of 128 bytes, chunk c c *
// kHalf bytes after the first: kBK * 128 for a K / V tile, kBQ * 128 for
// Q and dO. Barriers: full and empty a stage, Q / dO's, and a sink that
// takes the release of the stage before a warpgroup's first tile (there
// is none).
template <int kD>
struct Layout {
  static constexpr int kBK = kD == 256 ? 32 : 64;  // keys per streamed tile
  static constexpr int kStages = kD == 256 ? 3 : 4;
  static constexpr int kBQ = 2 * kRowsWG;          // query rows per block
  static constexpr int kCols = kD;                 // dQ columns a warpgroup
  static constexpr int kE = kBK / 2;               // S, dP fp32 a thread
  static constexpr int kTileBytes = kBK * kD * 2;  // one K or V tile
  static constexpr int kQBytes = kBQ * kD * 2;     // the resident Q (or dO)
  static constexpr int kTileHalf = kBK * 128;
  static constexpr int kQHalf = kBQ * 128;
  static constexpr int kOffStages = 2 * kQBytes;   // K, V of each stage
  static constexpr int kOffBars = kOffStages + kStages * 2 * kTileBytes;
  static constexpr int kSmemBytes = kOffBars + (2 * kStages + 2) * 8 + 1024;
  static_assert(kD == 64 || kD == 128 || kD == 256, "compiled head widths");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

// p of one tile (into s, from the scores) for the thread's two rows and
// kE / 2 keys; l: the rows' l2 (`bwd_lse2`); scale2 = scale log2(e), which
// takes the score's scale into the power without a bias. kMasked: the tile
// crosses the diagonal or the sk edge.
template <bool kBias, bool kMasked, int kE>
__device__ __forceinline__ void dq_p(float (&s)[kE], const float (&l)[2],
                                     int r0, int k0, int cq, int sq, int sk,
                                     float scale, float scale2, int causal,
                                     const ScoreBias& bias, const float* bs) {
#pragma unroll
  for (int j = 0; j < kE / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int row = r0 + 8 * h;
      const int key = k0 + 8 * j + cq + (e & 1);
      const bool dead = kMasked && (key >= sk || (causal && key > row));
      float p;
      if (kBias) {
        // __fmul_rn / __fadd_rn: no FMA contraction, so the score is the
        // plain version's round(round(q.k * scale) + bias)
        float x = __fmul_rn(s[4 * j + e], scale);
        if (!dead && row < sq) x = __fadd_rn(x, bias.at(bs, row, key));
        p = x <= kMaskEdge ? 0.f : bwd_p2(x, l[h]);
      } else {
        p = ex2_approx(fmaf(s[4 * j + e], scale2, -l[h]));
      }
      s[4 * j + e] = dead ? 0.f : p;
    }
}

// ds * scale (into s) of one tile from p (s) and dP (t), dl = p * (dp *
// keep - D); kDbias: the dlogits dl into dlb
template <bool kMasked, bool kDropout, bool kDbias, int kE>
__device__ __forceinline__ void dq_ds(float (&s)[kE], const float (&t)[kE],
                                      const float (&dsum)[2], int r0, int k0,
                                      int cq, int sq, int sk, float scale,
                                      const Dropout& drop, uint32_t dhead,
                                      float* dlb) {
#pragma unroll
  for (int j = 0; j < kE / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int row = r0 + 8 * h;
      const int key = k0 + 8 * j + cq + (e & 1);
      const float dp =
          kDropout ? t[4 * j + e] * drop.keep(dhead, row, key) : t[4 * j + e];
      const float dl = s[4 * j + e] * (dp - dsum[h]);
      if (kDbias && row < sq && (!kMasked || key < sk))
        dlb[(long long)row * sk + key] = dl;
      // the dq product takes ds * scale in k's dtype
      s[4 * j + e] = dl * scale;
    }
}

// What a consumer warpgroup's tiles share: the stage ring, its rows of Q
// and dO, its rows, the score's bias, dropout and the dlogits
struct DqTiles {
  uint8_t* stages;      // the K / V stages
  uint64_t* full;
  uint64_t* empty;
  uint32_t q_addr, do_addr;
  int r0, cq, sq, sk, causal;
  float scale;
  ScoreBias bias;
  const float* bs;
  Dropout drop;
  uint32_t dhead;
  float* dlb;
};

// Key tile kt of a consumer warpgroup (kMasked: across its diagonal or the
// sk edge). On entry the previous tile's dQ product may be in flight; it
// is waited for here, and `release` (the stage that tile read) freed. On
// return this tile's dQ product is in flight and `release` is its stage.
template <int kD, bool kBias, bool kMasked, bool kDropout, bool kDbias>
__device__ __forceinline__ void dq_tile(
    const DqTiles& c, int kt, uint64_t*& release,
    float (&adq)[Layout<kD>::kCols / 2], float (&s)[Layout<kD>::kE],
    float (&tp)[Layout<kD>::kE], uint32_t (&ads)[Layout<kD>::kE / 8][4],
    const float (&l)[2], const float (&dsum)[2]) {
  using L = Layout<kD>;
  const int st = kt % L::kStages;
  const int k0 = kt * L::kBK;
  APEX_SPLIT(0, kt, "start");
  mbar_wait_nt(&c.full[st], (kt / L::kStages) & 1);
  APEX_SPLIT(1, kt, "wait full");
  const uint32_t k_addr = smem_addr(c.stages + st * 2 * L::kTileBytes);
  wgmma_fence();
  // S = Q K^T, dP = dO V^T, two groups (Q and dO resident: descriptors
  // formed at each product, not held across the loop)
  product_ss<kD, true>(s, c.q_addr, L::kQHalf, k_addr, L::kTileHalf);
  wgmma_commit();
  product_ss<kD, true>(tp, c.do_addr, L::kQHalf, k_addr + L::kTileBytes,
                       L::kTileHalf);
  wgmma_commit();
  // S done, and the previous tile's dQ: its stage is free
  wgmma_wait<1>();
  fence_regs(s);
  fence_regs(adq);
  fence_regs(ads);
  mbar_arrive(release);
  release = &c.empty[st];
  APEX_SPLIT(2, kt, "S (+ the previous dQ)");
  dq_p<kBias, kMasked>(s, l, c.r0, k0, c.cq, c.sq, c.sk, c.scale,
                       c.scale * kLog2e, c.causal, c.bias, c.bs);
  APEX_SPLIT(3, kt, "p");
  wgmma_wait<0>();  // dP done
  fence_regs(tp);
  APEX_SPLIT(4, kt, "dP");
  dq_ds<kMasked, kDropout, kDbias>(s, tp, dsum, c.r0, k0, c.cq, c.sq, c.sk,
                                   c.scale, c.drop, c.dhead, c.dlb);
  to_a_operand(s, ads);  // ds * scale in k's dtype
  APEX_SPLIT(5, kt, "ds");
  wgmma_fence();
  // dQ += dS K (K MN-major), in flight into the next tile
  product_rs(adq, ads, k_addr, L::kTileHalf);
  wgmma_commit();
  APEX_SPLIT(6, kt, "dQ issue");
}

// dq on the tensor cores
template <int kD, bool kBias, bool kDropout, bool kDbias>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec,
                       __nv_bfloat16* __restrict__ dq, int nbh, int sq,
                       int sk, float scale, int causal, ScoreBias bias,
                       Dropout drop, float* __restrict__ dlogits) {
  using L = Layout<kD>;
  constexpr int kBQ = L::kBQ, kBK = L::kBK, kStages = L::kStages;
  constexpr int kCols = L::kCols, kE = L::kE;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* dos = smem + L::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kOffBars);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  uint64_t* sink = qbar + 1;

  const long long bh = batch_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int nk_all = (sk + kBK - 1) / kBK;
  // the block's key tiles: up to its last real row's diagonal when causal
  const int nk =
      causal ? min(nk_all, (min(q0 + kBQ, sq) - 1) / kBK + 1) : nk_all;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 2 * 128);
    }
    mbar_init(qbar, 1);
    mbar_init(sink, 2 * 128);
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup and, below, the warp, from lane 0: to ptxas then uniform
  // across the warp, so what follows from them (the warpgroup's rows, its
  // tiles, the loops) can live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // ------------------------------------------------ producer
    regs_dec<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, 2 * L::kQBytes);
      tma_load_rows<kD>(qs, &map_q, qbar, kBQ, q0, (int)bh);
      tma_load_rows<kD>(dos, &map_do, qbar, kBQ, q0, (int)bh);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        mbar_wait_nt(&empty[st], ((kt / kStages) & 1) ^ 1);
        uint8_t* ks = smem + L::kOffStages + st * 2 * L::kTileBytes;
        mbar_expect_tx(&full[st], 2 * L::kTileBytes);
        tma_load_rows<kD>(ks, &map_k, &full[st], kBK, kt * kBK, (int)bh);
        tma_load_rows<kD>(ks + L::kTileBytes, &map_v, &full[st], kBK,
                          kt * kBK, (int)bh);
      }
    }
  } else {
    // ----------------------------------------------- consumers
    regs_inc<232>();
    const int t = threadIdx.x % 128;
    const int warp = __shfl_sync(0xffffffffu, t / 32, 0), lane = t % 32;
    const int row0 = q0 + wg * kRowsWG;          // the warpgroup's first row
    const int r0 = row0 + 16 * warp + lane / 4;  // and r0 + 8
    const bool active = row0 < sq;
    // its key tiles: up to its last real row's diagonal when causal
    // (within the block's: at 32-key tiles a row past sq would reach past
    // them)
    const int nk_me =
        active ? (causal ? min(nk_all,
                               (min(row0 + kRowsWG, sq) - 1) / kBK + 1)
                         : nk_all)
               : 0;
    // the key tiles that need no mask (below the warpgroup's diagonal and
    // inside sk) come first: [0, nk_plain), then the rest of [0, nk_me)
    const int nk_plain =
        min(nk_me, causal ? min(sk / kBK, row0 / kBK) : sk / kBK);
    float* dlb = kDbias ? dlogits + bh * sq * sk : nullptr;
    // the warpgroup's rows of each 64-column chunk of Q and dO
    const DqTiles c{smem + L::kOffStages,
                    full,
                    empty,
                    smem_addr(qs) + wg * kRowsWG * 128,
                    smem_addr(dos) + wg * kRowsWG * 128,
                    r0,
                    (lane % 4) * 2,
                    sq,
                    sk,
                    causal,
                    scale,
                    bias,
                    kBias ? bias.slice(bh) : nullptr,
                    drop,
                    kDropout ? drop.head(bh) : 0u,
                    dlb};

    // the l2 (bwd_lse2 of the lse) and D of the thread's rows; rows past
    // sq add nothing
    float l[2], dsum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      l[h] = bwd_lse2(row < sq ? lse[bh * sq + row] : kNegInf);
      dsum[h] = row < sq ? dvec[bh * sq + row] : 0.f;
    }

    // the warpgroup's dq over all kCols columns (one accumulator of N =
    // kCols: 64, 128 or 256)
    float adq[kCols / 2], s[kE], tp[kE];
    uint32_t ads[kE / 8][4];
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) adq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      s[i] = 0.f;
      tp[i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kE / 8; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) ads[kk][i] = 0u;

    uint64_t* release = sink;  // the stage the previous tile read
    mbar_wait_nt(qbar, 0);
    int kt = 0;
    for (; kt < nk_plain; ++kt)
      dq_tile<kD, kBias, false, kDropout, kDbias>(c, kt, release, adq, s, tp,
                                                  ads, l, dsum);
    for (; kt < nk_me; ++kt)
      dq_tile<kD, kBias, true, kDropout, kDbias>(c, kt, release, adq, s, tp,
                                                 ads, l, dsum);
    wgmma_wait<0>();
    fence_regs(adq);
    fence_regs(ads);
    mbar_arrive(release);
    // the block's tiles past this warpgroup's diagonal: released unread
    for (; kt < nk; ++kt) {
      const int st = kt % kStages;
      mbar_wait_nt(&full[st], (kt / kStages) & 1);
      mbar_arrive(&empty[st]);
    }
    if (kDbias && active) {  // keys past the diagonal: zeros,
      const int kz = nk_me * kBK;  // a warp its 16 rows, a lane a key
      for (int r = 16 * warp; r < 16 * warp + 16 && row0 + r < sq; ++r)
        for (int key = kz + lane; key < sk; key += 32)
          dlb[(long long)(row0 + r) * sk + key] = 0.f;
    }

    if (active) {
      __nv_bfloat16* dqb = dq + bh * sq * kD;
      const int cq = (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= sq) continue;
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(
              dqb + (long long)row * kD + 8 * j + cq) =
              __floats2bfloat162_rn(adq[4 * j + 2 * h], adq[4 * j + 2 * h + 1]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dvec;
  void* dq;
  int bh, grid_y, grid_z, sq, sk;
  float scale;
  int causal;
  ScoreBias sb;
  Dropout dr;
  void *dlogits, *stream;
};

template <int kD>
int launch(const Args& a) {
  using L = Layout<kD>;
  // with no keys the K / V maps are never read: build them over q
  const bool nokeys = a.sk <= 0;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map_bf16(&mq, a.q, a.sq, a.bh, L::kBQ, kD) ||
      !make_map_bf16(&mk, nokeys ? a.q : a.k, nokeys ? a.sq : a.sk, a.bh,
                     L::kBK, kD) ||
      !make_map_bf16(&mv, nokeys ? a.q : a.v, nokeys ? a.sq : a.sk, a.bh,
                     L::kBK, kD) ||
      !make_map_bf16(&mdo, a.dout, a.sq, a.bh, L::kBQ, kD))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.sq + L::kBQ - 1) / L::kBQ, a.grid_y, a.grid_z);
  // a separate instantiation for each form; dlogits come with a bias only
  const bool dd = a.dr.seed != nullptr;
  const auto kernel =
      a.dlogits != nullptr
          ? (dd ? fa_bwd_dq_kernel_wgmma<kD, true, true, true>
                : fa_bwd_dq_kernel_wgmma<kD, true, false, true>)
      : a.sb.p != nullptr
          ? (dd ? fa_bwd_dq_kernel_wgmma<kD, true, true, false>
                : fa_bwd_dq_kernel_wgmma<kD, true, false, false>)
          : (dd ? fa_bwd_dq_kernel_wgmma<kD, false, true, false>
                : fa_bwd_dq_kernel_wgmma<kD, false, false, false>);
  constexpr int smem = L::kSmemBytes;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(a.stream)>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dvec), static_cast<__nv_bfloat16*>(a.dq),
      a.bh, a.sq, a.sk < 0 ? 0 : a.sk, a.scale, a.causal, a.sb, a.dr,
      static_cast<float*>(a.dlogits));
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, do and dq, contiguous and 16-byte aligned; lse and dvec
// float32 [bh, sq]. d: 64, 128 or 256 (the compiled widths; the wrapper
// pads any other d). grid_y, grid_z, bias, heads, the bias
// strides and the dropout seed, threshold and keep as for
// apex_fa_fwd_wgmma. dlogits: float32 [bh, sq, sk], every entry written,
// or null; only with a bias.
extern "C" int apex_fa_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* dvec, void* dq, int bh,
    int grid_y, int grid_z, int heads, int sq, int sk, int d, float scale,
    int causal, long long bsb, long long bsh, long long bsq, long long bsk,
    const void* seed, unsigned threshold, float keep, void* dlogits,
    void* stream) {
  if ((d != 64 && d != 128 && d != 256) || heads < 1 ||
      !bh_grid_ok(bh, grid_y, grid_z) ||
      (dlogits != nullptr && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0) return 0;
  if (!is_aligned(q, 16) || !is_aligned(k, 16) || !is_aligned(v, 16) ||
      !is_aligned(dout, 16))
    return (int)cudaErrorMisalignedAddress;
  const ScoreBias sb{static_cast<const float*>(bias), heads, bsb, bsh, bsq,
                     bsk};
  const Dropout dr{static_cast<const int*>(seed), threshold, keep};
  const Args a{q, k, v, dout, lse, dvec, dq, bh, grid_y, grid_z, sq, sk,
               scale, causal, sb, dr, dlogits, stream};
  return d == 64 ? launch<64>(a) : d == 128 ? launch<128>(a) : launch<256>(a);
}
