// Flash-attention forward for Hopper (sm_90a), fp32: o = softmax(q k^T *
// scale) v with an online softmax, plus the fp32 row log-sum-exp. bf16
// runs on the tensor cores instead (flash_fwd_wgmma.cu); fp32 stays here on
// the FMA pipes, whose full fp32 products the fp32 tolerances hold (a TF32
// tensor-core product would change the numbers users get).
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py `flash_attention_fwd`
// (the Pallas kernel `_fa_fwd_kernel`) without dropout, causal or not, with
// or without an additive fp32 score bias, with the JAX layout q
// (b, h, sq, d), k / v (b, h, sk, d). The bias (a boolean mask arrives as
// -1e30 where masked, `flash_attention`'s rule) is broadcastable to
// (b, h, sq, sk) and read through per-dimension strides, 0 on a broadcast
// dimension, so a (b, 1, 1, sk) padding mask is never expanded (the TPU's
// `_BiasPlan` rule): s = (q . k) * scale + bias.
// Conventions kept from the TPU kernel: scores in fp32, masked scores set to
// -1e30 (a score <= -0.5e30, from the bias too, is out of the softmax
// support), the rescale of a row whose running max is still "masked"
// shifted by 0 so exp() underflows to 0, p cast to v's dtype before the p.v
// product, fully masked rows give o = 0 and lse = -1e30, lse = m + log(l)
// in fp32.
//
// What bounds it on this card: operations. At the main path's shapes
// (b = 4, h = 12, s = 1024, d = 64) the kernel does ~2 * 2 * s^2 * d flops
// per head (half of that when causal) over 12 * s * d * 2 bytes of q, k, v
// and o: hundreds of flops per byte, at or above the H100's ridge point.
//
// What the design does about that, in this first version: the TPU grid's
// sequential k axis becomes a loop inside one block; one block owns 64 query
// rows of one (batch, head) and streams 64-row K / V tiles through shared
// memory, so q is read once and each K / V tile once per query tile. Causal
// blocks stop at the diagonal tile, and the heaviest (last) query tiles are
// scheduled first. Each of the 4 warps owns 16 query rows; a lane holds the
// scores of keys lane and lane + 32 and the output columns lane and
// lane + 32 for those rows in registers, so the two products read one
// broadcast shared-memory value per two FMAs and the K tile is padded to a
// 65-float row stride to keep the lanes on distinct banks. The products run
// on the fp32 FMA pipes, not the tensor cores, so fp32 keeps full fp32
// products.
// Ragged sq / sk are masked inside the kernel (no padding copies). The bias
// is a compile-time variant: the kernel without one keeps no bias registers
// or branches.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; the function returns cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

using namespace apex_port;

constexpr int kD = 64;        // head dim this kernel is written for
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // key rows per streamed tile
constexpr int kWarps = 4;
constexpr int kRW = kBQ / kWarps;  // query rows per warp
constexpr int kKStride = kD + 1;   // padded K row: conflict-free lanes
constexpr float kNegInf = -1e30f;
constexpr float kMaskEdge = 0.5f * kNegInf;

constexpr size_t kSmemFloats =
    kBQ * kD + kBK * kKStride + kBK * kD + kWarps * kRW * kBK;

template <typename T, bool kBias>
__global__ void __launch_bounds__(kWarps * 32)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int nbh, int sq, int sk,
              float scale, int causal, ScoreBias bias) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][kD]
  float* ks = qs + kBQ * kD;         // [kBK][kKStride]
  float* vs = ks + kBK * kKStride;   // [kBK][kD]
  float* ps = vs + kBK * kD;         // [kWarps][kRW][kBK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const long long bh = batch_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int q0 = qt * kBQ;
  const T* qb = q + bh * sq * kD;
  const T* kb = k + bh * sk * kD;
  const T* vb = v + bh * sk * kD;
  const float* bs = kBias ? bias.slice(bh) : nullptr;

  for (int i = tid; i < kBQ * kD; i += kWarps * 32) {
    const int row = q0 + i / kD;
    qs[i] = row < sq ? to_f32(qb[(long long)row * kD + i % kD]) : 0.f;
  }

  float m[kRW], l[kRW], acc0[kRW], acc1[kRW];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc0[r] = 0.f;
    acc1[r] = 0.f;
  }

  int nk = (sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);
  const float* qw = qs + warp * kRW * kD;
  float* pw = ps + warp * kRW * kBK;
  const int row0 = q0 + warp * kRW;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBK * kD; i += kWarps * 32) {
      const int r = i / kD, c = i % kD;
      const int key = k0 + r;
      const bool ok = key < sk;
      ks[r * kKStride + c] = ok ? to_f32(kb[(long long)key * kD + c]) : 0.f;
      vs[i] = ok ? to_f32(vb[(long long)key * kD + c]) : 0.f;
    }
    __syncthreads();

    float s0[kRW], s1[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      s0[r] = 0.f;
      s1[r] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < kD; ++c) {
      const float ka = ks[lane * kKStride + c];
      const float kc = ks[(lane + 32) * kKStride + c];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float qv = qw[r * kD + c];
        s0[r] = fmaf(qv, ka, s0[r]);
        s1[r] = fmaf(qv, kc, s1[r]);
      }
    }

    const int key0 = k0 + lane, key1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int row = row0 + r;
      // __fmul_rn / __fadd_rn: no FMA contraction, so the score is the
      // plain version's round(round(q.k * scale) + bias)
      float a = __fmul_rn(s0[r], scale), b = __fmul_rn(s1[r], scale);
      if (kBias && row < sq) {
        if (key0 < sk) a = __fadd_rn(a, bias.at(bs, row, key0));
        if (key1 < sk) b = __fadd_rn(b, bias.at(bs, row, key1));
      }
      if (key0 >= sk || (causal && key0 > row)) a = kNegInf;
      if (key1 >= sk || (causal && key1 > row)) b = kNegInf;
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, b)));
      const float m_safe = m_new <= kMaskEdge ? 0.f : m_new;
      const float pa = expf(a - m_safe), pb = expf(b - m_safe);
      const float alpha =
          expf((m_prev <= kMaskEdge ? kNegInf : m_prev) - m_safe);
      l[r] = l[r] * alpha + warp_sum(pa + pb);
      acc0[r] *= alpha;
      acc1[r] *= alpha;
      m[r] = m_new;
      pw[r * kBK + lane] = round_to<T>(pa);
      pw[r * kBK + lane + 32] = round_to<T>(pb);
    }
    __syncwarp();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float va = vs[kk * kD + lane], vc = vs[kk * kD + lane + 32];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float p = pw[r * kBK + kk];
        acc0[r] = fmaf(p, va, acc0[r]);
        acc1[r] = fmaf(p, vc, acc1[r]);
      }
    }
    __syncwarp();  // p of this tile is consumed before the next overwrite
  }

  T* ob = o + bh * sq * kD;
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int row = row0 + r;
    if (row >= sq) continue;
    const float safe_l = l[r] > 0.f ? l[r] : 1.f;
    ob[(long long)row * kD + lane] = from_f32<T>(acc0[r] / safe_l);
    ob[(long long)row * kD + lane + 32] = from_f32<T>(acc1[r] / safe_l);
    if (lane == 0)
      lse[bh * sq + row] =
          m[r] <= kMaskEdge ? kNegInf : m[r] + logf(safe_l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int grid_y, int grid_z, int sq, int sk, float scale,
           int causal, const ScoreBias& bias, cudaStream_t stream) {
  const int smem = (int)(kSmemFloats * sizeof(float));
  // a separate instantiation with the bias, so the unbiased kernel keeps
  // no bias registers or branches
  const auto kernel = bias.p != nullptr ? fa_fwd_kernel<T, true>
                                        : fa_fwd_kernel<T, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((sq + kBQ - 1) / kBQ, grid_y, grid_z);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      bh, sq, sk, scale, causal, bias);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (q, k, v and o; bfloat16 is apex_fa_fwd_wgmma's);
// lse is float32 [bh, sq]. Only head_dim 64 is compiled. grid_y x grid_z
// blocks carry the bh = b * h slices (fa_batch_heads_grid in
// ops/tiling.py). bias: float32 or null; heads = h of bh = b * h; bsb, bsh,
// bsq, bsk its strides in elements (0 on a broadcast dimension).
extern "C" int apex_fa_fwd(const void* q, const void* k, const void* v,
                           const void* bias, void* o, void* lse, int bh,
                           int grid_y, int grid_z, int heads, int sq, int sk,
                           int d, float scale, int causal, long long bsb,
                           long long bsh, long long bsq, long long bsk,
                           int dtype, void* stream) {
  if (d != kD || heads < 1 || !bh_grid_ok(bh, grid_y, grid_z))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const apex_port::ScoreBias sb{static_cast<const float*>(bias), heads,
                                bsb, bsh, bsq, bsk};
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, bh, grid_y, grid_z, sq, sk, scale,
                         causal, sb, s);
  return (int)cudaErrorInvalidValue;
}
