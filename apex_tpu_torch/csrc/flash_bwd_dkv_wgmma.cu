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
// cores (wgmma m64n64k16) from tiles that TMA brings into shared memory. A
// block owns 128 keys of one (b * h) slice: two consumer warpgroups of 64
// keys (wgmma's M) whose K and V rows stay resident in shared memory, and
// a producer warp that streams 64-row Q and dO tiles, with that tile's 64
// lse and D values beside them, through a ring of kStages stages ("full":
// the TMA's bytes and the producer lanes' arrivals after their lse / D
// stores; "empty": every consumer thread after its products). From the
// diagonal on when causal. Per tile and warpgroup: S^T = K Q^T and
// dP^T = V dO^T with both operands from shared memory, K-major; p and ds
// per accumulator element, lse and D indexed by the fragment's column (a
// query); then dV += P^T dO and dK += dS^T Q with A from registers (the
// accumulators packed to bf16) and B the same dO / Q tile read MN-major
// through a second descriptor. Each block owns its dK and dV rows: no
// atomics, and two runs give the same bits. Only a tile across a
// warpgroup's diagonal or the ragged sk edge runs the masked arithmetic
// (`_mask_split`); rows past sq load as zeros with lse = -1e30 and so add
// nothing. In this first version the products of a tile and its
// elementwise work do not overlap (later work).
//
// Head dim 128: each tile arrives as two 64-column boxes (hopper.cuh), S^T
// and dP^T take eight steps of depth, and dV and dK are two products of N =
// 64 each, one on each 64-column chunk of dO / Q, into two accumulators
// apiece: a
// consumer thread holds 128 fp32 of dK and dV beside the 64 of S and dP
// while they are live (192 of its 232 registers; p and ds are packed to
// bf16 as S and dP die), so the register split stays the d = 64 one
// (producer 40, consumers 232). Shared memory holds K and V (64 KB), four
// stages of Q and dO (128 KB) and their lse / D slices.
//
// Head dim 256: dK and dV over all 256 columns of a consumer's 64 keys
// would be 256 fp32 a thread, past the 255 registers a thread may have,
// and 128 keys of K and V (128 KB) beside two stages of Q and dO (128 KB)
// would not fit a block's 227 KB. So a block owns one 64-key slab
// (Layout::kSlabs = 1) that both consumer warpgroups take, and the
// accumulators are split by columns: each warpgroup runs the slab's S^T
// and dP^T products and its p and ds (the same operations on the same
// operands, the same bits) and keeps half of dK's and half of dV's
// columns, 128 fp32 a thread as at d = 128. Splitting by output instead
// (dV in one warpgroup, dK in the other) would run S^T twice but dP^T
// once, for 128 + 32 registers in one warpgroup and 128 + 64 in the
// other, and would leave the warpgroups unequal (two products against
// three); the split by columns keeps the d = 128 code and its register
// budget unchanged, at 6/4 of the tensor-core work of one S^T, dP^T, dV
// and dK. Shared memory: K and V 64 KB, two stages of Q and dO 128 KB.
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
// consumer warpgroup (d <= 128), or one slab that both warpgroups take,
// each holding kCols of dK's and dV's columns (d = 256); kStages stages of
// Q and dO. A tile's rows are 64-column chunks of 128 bytes, chunk c c *
// kHalf bytes after the first: kBQ * 128 for a Q / dO tile, kBK * 128 for
// K and V.
template <int kD>
struct Layout {
  static constexpr int kSlabs = kD == 256 ? 1 : 2;
  static constexpr int kBK = kKeysWG * kSlabs;     // keys per block
  static constexpr int kCols = kD * kSlabs / 2;    // dK, dV columns a group
  static constexpr int kStages = kD == 256 ? 2 : 4;
  static constexpr int kTileBytes = kBQ * kD * 2;  // one 64-row bf16 tile
  static constexpr int kKVBytes = kBK * kD * 2;    // the resident K (or V)
  static constexpr int kTileHalf = kBQ * 128;
  static constexpr int kKVHalf = kBK * 128;
  static constexpr int kOffStages = 2 * kKVBytes;  // Q, dO of each stage
  static constexpr int kOffStats = kOffStages + kStages * 2 * kTileBytes;
  static constexpr int kOffBars = kOffStats + kStages * 2 * kBQ * 4;
  static constexpr int kSmemBytes = kOffBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kD == 64 || kD == 128 || kD == 256, "compiled head widths");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

// `_bwd_p`: P = exp(s - lse), 0 where s or the row's lse is masked
__device__ __forceinline__ float bwd_p(float s, float lse) {
  return (s <= kMaskEdge || lse <= kMaskEdge) ? 0.f : expf(s - lse);
}

// p (into s) and ds * scale (into t) of one tile for the thread's two
// keys and 16 queries. kMasked: the tile crosses the diagonal or the sk
// edge.
template <bool kBias, bool kMasked, bool kDropout>
__device__ __forceinline__ void dkv_tile(float (&s)[32], float (&t)[32],
                                         const float* ls, const float* dd,
                                         int key0, int q0, int cq, int sq,
                                         int sk, float scale, int causal,
                                         const ScoreBias& bias,
                                         const float* bs, const Dropout& drop,
                                         uint32_t dhead) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
    const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * j + cq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + (e >> 1) * 8;
      const int qry = q0 + 8 * j + cq + (e & 1);
      const float l = (e & 1) ? l2.y : l2.x;
      const float dsum = (e & 1) ? d2.y : d2.x;
      const bool dead =
          kMasked && (key >= sk || (causal && key > qry));
      // __fmul_rn / __fadd_rn: no FMA contraction, so the score is the
      // plain version's round(round(q.k * scale) + bias)
      float x = __fmul_rn(s[4 * j + e], scale);
      if (kBias && !dead && qry < sq) x = __fadd_rn(x, bias.at(bs, qry, key));
      const float p = dead ? 0.f : bwd_p(x, l);
      // the dk product takes ds * scale in q's dtype, the dv product p
      // (times its keep factor) in do's
      if (kDropout) {
        const float keep = drop.keep(dhead, qry, key);
        s[4 * j + e] = p * keep;
        t[4 * j + e] = p * (t[4 * j + e] * keep - dsum) * scale;
      } else {
        s[4 * j + e] = p;
        t[4 * j + e] = p * (t[4 * j + e] - dsum) * scale;
      }
    }
  }
}

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
  constexpr int kBK = L::kBK, kStages = L::kStages, kNC = L::kCols / 64;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;
  uint8_t* vs = smem + L::kKVBytes;
  float* stats = reinterpret_cast<float*>(smem + L::kOffStats);  // lse, D
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

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------ producer
    regs_dec<40>();
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
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        float* ls = stats + st * 2 * kBQ;
        for (int r = lane; r < kBQ; r += 32) {
          const int row = qt * kBQ + r;
          ls[r] = row < sq ? lb[row] : kNegInf;
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
    regs_inc<232>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // the warpgroup's slab of keys and its group of dK's and dV's columns
    // (at d = 256 both warpgroups take slab 0, each kCols of the columns)
    const int slab = L::kSlabs == 2 ? wg : 0, cg = L::kSlabs == 2 ? 0 : wg;
    const int kw0 = k0 + slab * kKeysWG;        // the warpgroup's keys
    const int key0 = kw0 + 16 * warp + lane / 4;  // and key0 + 8
    const int cq = (lane % 4) * 2;
    const bool active = kw0 < sk;
    const float* bs = kBias ? bias.slice(bh) : nullptr;
    const uint32_t dhead = kDropout ? drop.head(bh) : 0u;
    // the warpgroup's rows of each 64-column chunk of K and V
    const uint32_t k_addr = smem_addr(ks) + slab * kKeysWG * 128;
    const uint32_t v_addr = smem_addr(vs) + slab * kKeysWG * 128;

    // the warpgroup's dk and dv in kNC accumulators of 64 d columns each
    float adk[kNC][32], adv[kNC][32], s[32], tp[32];
    uint32_t ap[4][4], ads[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        adk[c][i] = 0.f;
        adv[c][i] = 0.f;
      }
      s[i] = 0.f;
      tp[i] = 0.f;
    }

    mbar_wait(kvbar, 0);
    for (int qt = qt0; qt < nq; ++qt) {
      const int i = qt - qt0, st = i % kStages;
      const int q0 = qt * kBQ;
      mbar_wait(&full[st], (i / kStages) & 1);
      // `_causal_run`: a tile wholly above the warpgroup's first key is
      // skipped (only the second warpgroup's first tile can be)
      if (active && (!causal || kw0 <= q0 + kBQ - 1)) {
        const uint32_t q_addr =
            smem_addr(smem + L::kOffStages + st * 2 * L::kTileBytes);
        const uint32_t do_addr = q_addr + L::kTileBytes;
        wgmma_fence();
        // S^T = K Q^T, dP^T = V dO^T
        product_ss<kD>(s, k_addr, L::kKVHalf, q_addr, L::kTileHalf);
        product_ss<kD>(tp, v_addr, L::kKVHalf, do_addr, L::kTileHalf);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(tp);
        const float* ls = stats + st * 2 * kBQ;
        // `_mask_split`: only a tile across the diagonal or the sk edge
        const bool masked =
            (causal && kw0 + kKeysWG - 1 > q0) || kw0 + kKeysWG > sk;
        if (masked)
          dkv_tile<kBias, true, kDropout>(s, tp, ls, ls + kBQ, key0, q0, cq,
                                          sq, sk, scale, causal, bias, bs,
                                          drop, dhead);
        else
          dkv_tile<kBias, false, kDropout>(s, tp, ls, ls + kBQ, key0, q0, cq,
                                           sq, sk, scale, causal, bias, bs,
                                           drop, dhead);
        to_a_operand(s, ap);    // p in do's dtype for the dv product
        to_a_operand(tp, ads);  // ds * scale in q's dtype for dk
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          fence_regs(adv[c]);
          fence_regs(adk[c]);
        }
        // dV += P^T dO, dK += dS^T Q (dO, Q MN-major): a product on each
        // of the warpgroup's 64-column chunks
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          product_rs(adv[c], ap, do_addr + (cg * kNC + c) * L::kTileHalf);
          product_rs(adk[c], ads, q_addr + (cg * kNC + c) * L::kTileHalf);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          fence_regs(adv[c]);
          fence_regs(adk[c]);
        }
        fence_regs(ap);
        fence_regs(ads);
      }
      mbar_arrive(&empty[st]);
    }

    if (active) {
      __nv_bfloat16* dkb = dk + bh * sk * kD;
      __nv_bfloat16* dvb = dv + bh * sk * kD;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key0 + 8 * h;
        if (key >= sk) continue;
#pragma unroll
        for (int c = 0; c < kNC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const long long at =
                (long long)key * kD + 64 * (cg * kNC + c) + 8 * j + cq;
            *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
                __floats2bfloat162_rn(adk[c][4 * j + 2 * h],
                                      adk[c][4 * j + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
                __floats2bfloat162_rn(adv[c][4 * j + 2 * h],
                                      adv[c][4 * j + 2 * h + 1]);
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
