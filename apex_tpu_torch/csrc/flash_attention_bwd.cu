// Flash-attention backward for Hopper (sm_90a): dq, dk and dv from the
// forward's fp32 row log-sum-exp, without the (sq, sk) probability matrix.
// Here: the fp32 route, dq and dk / dv. bf16 runs on the tensor cores
// (flash_bwd_dq_wgmma.cu, flash_bwd_dkv_wgmma.cu); fp32 stays on the FMA
// pipes, whose full fp32 products the fp32 tolerances hold.
//
// Replaces: apex_tpu/ops/pallas/flash_attention.py `flash_attention_bwd`,
// its two Pallas kernels `_fa_dq_kernel` and `_fa_dkv_kernel`, without
// dropout and without dbias, causal or not, with or without an additive
// fp32 score bias (read through per-dimension strides, 0 on a broadcast
// dimension, never expanded: see flash_attention.cu), JAX layout q / do
// (b, h, sq, d), k / v (b, h, sk, d), lse and D = rowsum(do * o) as fp32
// (b, h, sq) (D is computed outside the kernels, as the JAX wrapper
// computes it). Per (query i, key j):
//   s  = (q_i . k_j) * scale + bias_ij in fp32, masked where j >= sk or
//        (causal) j > i
//   p  = exp(s - lse_i), exactly 0 where s is masked or lse_i <= -0.5e30
//        (fully masked rows give zero gradients: `_bwd_p`)
//   dp = do_i . v_j,  ds = p * (dp - D_i)
//   dq_i += (ds * scale in k's dtype) . k_j
//   dv_j += (p in do's dtype) . do_i
//   dk_j += (ds * scale in q's dtype) . q_i
// The casts to the IO dtype before each product are the TPU kernels'. The
// TPU wrapper folds a power-of-two scale into q (`_fold_scale`); scaling
// by a power of two commutes with rounding, so multiplying ds by the scale
// before its cast, as here, gives the same dk bits, and the scores the
// same values.
//
// What bounds it on this card: operations. At the main path's shapes
// (b = 4, h = 12, s = 1024, d = 64, causal) the two kernels do five
// s x s x d products per head (three in dq, four in dk / dv, S and dP
// computed in both), ~2.5x the forward's work, over 20 bytes per (row, d)
// element of traffic: hundreds of flops per byte.
//
// What the design does about that, in this first version: two kernels, as
// the TPU has, so that no output is summed across blocks and no atomics are
// needed (the results have the same bits on every run). The TPU grid's
// sequential third axis becomes a loop inside one block:
// - dq: one block per (batch * head, 64-row q tile) streams 64-row K / V
//   tiles up to the diagonal, the heaviest tiles launched first;
// - dk / dv: one block per (batch * head, 64-row k tile) keeps its K / V
//   tile in shared memory and streams the Q / dO tiles from the diagonal on.
// Each of the 4 warps owns 16 rows of the block's tile; a lane holds the
// 16 x 2 scores of columns lane and lane + 32 in registers, writes its
// share of p or ds to a per-warp shared-memory strip, and accumulates two
// output columns (lane, lane + 32) of its 16 rows. Streamed tiles that
// lanes read down a column are padded to a 65-float row stride so the 32
// lanes hit 32 distinct banks. The products run on the fp32 FMA pipes, not
// the tensor cores (a TF32 product would change fp32 results). Ragged sq /
// sk are masked inside the kernels (no padding copies): padded query rows read
// lse = -1e30 and so contribute nothing. The bias is a compile-time
// variant, as in the forward.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each function returns cudaGetLastError() after its launch.

#include "common.cuh"

namespace {

using namespace apex_port;

constexpr int kD = 64;        // head dim these kernels are written for
constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // key rows per tile
constexpr int kWarps = 4;
constexpr int kRW = 16;       // tile rows per warp (kBQ / kWarps)
constexpr int kPad = kD + 1;  // padded row stride of column-read tiles
constexpr float kNegInf = -1e30f;
constexpr float kMaskEdge = 0.5f * kNegInf;

static_assert(kBQ == kBK && kBQ == kWarps * kRW, "square 64-row tiles");

// both kernels: two plain tiles, two padded tiles, the per-warp p / ds
// strips and two per-row vectors
constexpr size_t kSmemFloats =
    2 * kBQ * kD + 2 * kBK * kPad + kWarps * kRW * kBK + 2 * kBQ;

// `_bwd_p`: P = exp(s - lse), 0 where s or the row's lse is masked
__device__ __forceinline__ float bwd_p(float s, float lse) {
  return (s <= kMaskEdge || lse <= kMaskEdge) ? 0.f : expf(s - lse);
}

// rows [row0, row0 + kBQ) of a (s, kD) matrix into a kBQ x stride fp32
// tile, zero past `s`
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int row0, int s) {
  for (int i = threadIdx.x; i < kBQ * kD; i += kWarps * 32) {
    const int r = i / kD, c = i % kD;
    const int row = row0 + r;
    dst[r * stride + c] =
        row < s ? to_f32(src[(long long)row * kD + c]) : 0.f;
  }
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kWarps * 32)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dvec, T* __restrict__ dq, int nbh,
                 int sq, int sk, float scale, int causal, ScoreBias bias) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][kD]
  float* dos = qs + kBQ * kD;         // [kBQ][kD]
  float* ks = dos + kBQ * kD;         // [kBK][kPad]
  float* vs = ks + kBK * kPad;        // [kBK][kPad]
  float* strip = vs + kBK * kPad;     // [kWarps][kRW][kBK]
  float* ls = strip + kWarps * kRW * kBK;  // [kBQ]
  float* dd = ls + kBQ;                    // [kBQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const long long bh = batch_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int q0 = qt * kBQ;
  const T* kb = k + bh * sk * kD;
  const T* vb = v + bh * sk * kD;
  const float* bs = kBias ? bias.slice(bh) : nullptr;

  load_tile(qs, kD, q + bh * sq * kD, q0, sq);
  load_tile(dos, kD, dout + bh * sq * kD, q0, sq);
  for (int i = tid; i < kBQ; i += kWarps * 32) {
    const int row = q0 + i;
    ls[i] = row < sq ? lse[bh * sq + row] : kNegInf;
    dd[i] = row < sq ? dvec[bh * sq + row] : 0.f;
  }

  float acc0[kRW], acc1[kRW];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    acc0[r] = 0.f;
    acc1[r] = 0.f;
  }

  int nk = (sk + kBK - 1) / kBK;
  if (causal) nk = min(nk, (q0 + kBQ - 1) / kBK + 1);
  const float* qw = qs + warp * kRW * kD;
  const float* dow = dos + warp * kRW * kD;
  float* sw = strip + warp * kRW * kBK;
  const int row0 = q0 + warp * kRW;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile(ks, kPad, kb, k0, sk);
    load_tile(vs, kPad, vb, k0, sk);
    __syncthreads();

    // s = q . k and dp = do . v for keys lane and lane + 32
    float s0[kRW], s1[kRW], t0[kRW], t1[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      s0[r] = 0.f;
      s1[r] = 0.f;
      t0[r] = 0.f;
      t1[r] = 0.f;
    }
#pragma unroll 2
    for (int c = 0; c < kD; ++c) {
      const float ka = ks[lane * kPad + c];
      const float kc = ks[(lane + 32) * kPad + c];
      const float va = vs[lane * kPad + c];
      const float vc = vs[(lane + 32) * kPad + c];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float qv = qw[r * kD + c];
        const float dv = dow[r * kD + c];
        s0[r] = fmaf(qv, ka, s0[r]);
        s1[r] = fmaf(qv, kc, s1[r]);
        t0[r] = fmaf(dv, va, t0[r]);
        t1[r] = fmaf(dv, vc, t1[r]);
      }
    }

    const int key0 = k0 + lane, key1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int row = row0 + r;
      const float l = ls[warp * kRW + r];
      const float dsum = dd[warp * kRW + r];
      const bool m0 = key0 >= sk || (causal && key0 > row);
      const bool m1 = key1 >= sk || (causal && key1 > row);
      // __fmul_rn / __fadd_rn: no FMA contraction, so the score is the
      // plain version's round(round(q.k * scale) + bias)
      float a = __fmul_rn(s0[r], scale), b = __fmul_rn(s1[r], scale);
      if (kBias && row < sq) {
        if (!m0) a = __fadd_rn(a, bias.at(bs, row, key0));
        if (!m1) b = __fadd_rn(b, bias.at(bs, row, key1));
      }
      const float p0 = m0 ? 0.f : bwd_p(a, l);
      const float p1 = m1 ? 0.f : bwd_p(b, l);
      // dl = p (dp - D); the dq product takes dl * scale in k's dtype
      sw[r * kBK + lane] = round_to<T>(p0 * (t0[r] - dsum) * scale);
      sw[r * kBK + lane + 32] = round_to<T>(p1 * (t1[r] - dsum) * scale);
    }
    __syncwarp();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float ka = ks[kk * kPad + lane];
      const float kc = ks[kk * kPad + lane + 32];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float d = sw[r * kBK + kk];
        acc0[r] = fmaf(d, ka, acc0[r]);
        acc1[r] = fmaf(d, kc, acc1[r]);
      }
    }
    __syncwarp();  // the strip is consumed before the next overwrite
  }

  T* dqb = dq + bh * sq * kD;
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int row = row0 + r;
    if (row >= sq) continue;
    dqb[(long long)row * kD + lane] = from_f32<T>(acc0[r]);
    dqb[(long long)row * kD + lane + 32] = from_f32<T>(acc1[r]);
  }
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kWarps * 32)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dvec, T* __restrict__ dk,
                  T* __restrict__ dv, int nbh, int sq, int sk, float scale,
                  int causal, ScoreBias bias) {
  extern __shared__ float smem[];
  float* ks = smem;                   // [kBK][kD]
  float* vs = ks + kBK * kD;          // [kBK][kD]
  float* qs = vs + kBK * kD;          // [kBQ][kPad]
  float* dos = qs + kBQ * kPad;       // [kBQ][kPad]
  float* strip = dos + kBQ * kPad;    // [kWarps][kRW][kBQ]
  float* ls = strip + kWarps * kRW * kBQ;  // [kBQ]
  float* dd = ls + kBQ;                    // [kBQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kt = blockIdx.x;  // the first k tiles see the most q tiles
  const long long bh = batch_head();
  if (bh >= nbh) return;  // the last z-slice's spare blocks
  const int k0 = kt * kBK;
  const T* qb = q + bh * sq * kD;
  const T* dob = dout + bh * sq * kD;
  const float* bs = kBias ? bias.slice(bh) : nullptr;

  load_tile(ks, kD, k + bh * sk * kD, k0, sk);
  load_tile(vs, kD, v + bh * sk * kD, k0, sk);

  float ak0[kRW], ak1[kRW], av0[kRW], av1[kRW];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    ak0[r] = 0.f;
    ak1[r] = 0.f;
    av0[r] = 0.f;
    av1[r] = 0.f;
  }

  const int nq = (sq + kBQ - 1) / kBQ;
  // causal: query rows below k0 see none of this tile's keys
  const int qt_begin = causal ? k0 / kBQ : 0;
  const float* kw = ks + warp * kRW * kD;
  const float* vw = vs + warp * kRW * kD;
  float* sw = strip + warp * kRW * kBQ;
  const int key_row0 = k0 + warp * kRW;

  for (int qt = qt_begin; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // every warp is done with the previous q tile
    load_tile(qs, kPad, qb, q0, sq);
    load_tile(dos, kPad, dob, q0, sq);
    for (int i = tid; i < kBQ; i += kWarps * 32) {
      const int row = q0 + i;
      ls[i] = row < sq ? lse[bh * sq + row] : kNegInf;
      dd[i] = row < sq ? dvec[bh * sq + row] : 0.f;
    }
    __syncthreads();

    // s = k . q for queries lane and lane + 32, then p in place
    float s0[kRW], s1[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      s0[r] = 0.f;
      s1[r] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < kD; ++c) {
      const float qa = qs[lane * kPad + c];
      const float qc = qs[(lane + 32) * kPad + c];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float kv = kw[r * kD + c];
        s0[r] = fmaf(kv, qa, s0[r]);
        s1[r] = fmaf(kv, qc, s1[r]);
      }
    }
    const int qry0 = q0 + lane, qry1 = q0 + lane + 32;
    const float l0 = ls[lane], l1 = ls[lane + 32];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const int key = key_row0 + r;
      const bool m0 = key >= sk || (causal && key > qry0);
      const bool m1 = key >= sk || (causal && key > qry1);
      // __fmul_rn / __fadd_rn: no FMA contraction, so the score is the
      // plain version's round(round(q.k * scale) + bias)
      float a = __fmul_rn(s0[r], scale), b = __fmul_rn(s1[r], scale);
      if (kBias) {
        if (!m0 && qry0 < sq) a = __fadd_rn(a, bias.at(bs, qry0, key));
        if (!m1 && qry1 < sq) b = __fadd_rn(b, bias.at(bs, qry1, key));
      }
      s0[r] = m0 ? 0.f : bwd_p(a, l0);
      s1[r] = m1 ? 0.f : bwd_p(b, l1);
      // the dv product takes p in do's dtype
      sw[r * kBQ + lane] = round_to<T>(s0[r]);
      sw[r * kBQ + lane + 32] = round_to<T>(s1[r]);
    }
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < kBQ; ++i) {
      const float da = dos[i * kPad + lane];
      const float dc = dos[i * kPad + lane + 32];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float pv = sw[r * kBQ + i];
        av0[r] = fmaf(pv, da, av0[r]);
        av1[r] = fmaf(pv, dc, av1[r]);
      }
    }
    __syncwarp();

    // dp = v . do for the same (key, query) pairs, then ds
    float t0[kRW], t1[kRW];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      t0[r] = 0.f;
      t1[r] = 0.f;
    }
#pragma unroll 4
    for (int c = 0; c < kD; ++c) {
      const float da = dos[lane * kPad + c];
      const float dc = dos[(lane + 32) * kPad + c];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float vv = vw[r * kD + c];
        t0[r] = fmaf(vv, da, t0[r]);
        t1[r] = fmaf(vv, dc, t1[r]);
      }
    }
    const float d0 = dd[lane], d1 = dd[lane + 32];
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      // the dk product takes ds * scale in q's dtype
      sw[r * kBQ + lane] = round_to<T>(s0[r] * (t0[r] - d0) * scale);
      sw[r * kBQ + lane + 32] = round_to<T>(s1[r] * (t1[r] - d1) * scale);
    }
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < kBQ; ++i) {
      const float qa = qs[i * kPad + lane];
      const float qc = qs[i * kPad + lane + 32];
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
        const float d = sw[r * kBQ + i];
        ak0[r] = fmaf(d, qa, ak0[r]);
        ak1[r] = fmaf(d, qc, ak1[r]);
      }
    }
    __syncwarp();  // the strip is consumed before the next overwrite
  }

  T* dkb = dk + bh * sk * kD;
  T* dvb = dv + bh * sk * kD;
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    const int key = key_row0 + r;
    if (key >= sk) continue;
    dkb[(long long)key * kD + lane] = from_f32<T>(ak0[r]);
    dkb[(long long)key * kD + lane + 32] = from_f32<T>(ak1[r]);
    dvb[(long long)key * kD + lane] = from_f32<T>(av0[r]);
    dvb[(long long)key * kD + lane + 32] = from_f32<T>(av1[r]);
  }
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dvec, void* dq, int bh,
              int grid_y, int grid_z, int sq, int sk, float scale,
              int causal, const ScoreBias& bias, cudaStream_t stream) {
  const int smem = (int)(kSmemFloats * sizeof(float));
  // a separate instantiation with the bias, so the unbiased kernel keeps
  // no bias registers or branches
  const auto kernel = bias.p != nullptr ? fa_bwd_dq_kernel<T, true>
                                        : fa_bwd_dq_kernel<T, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((sq + kBQ - 1) / kBQ, grid_y, grid_z);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dq), bh, sq, sk, scale, causal, bias);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dvec, void* dk, void* dv, int bh,
               int grid_y, int grid_z, int sq, int sk, float scale,
               int causal, const ScoreBias& bias, cudaStream_t stream) {
  const int smem = (int)(kSmemFloats * sizeof(float));
  // a separate instantiation with the bias, so the unbiased kernel keeps
  // no bias registers or branches
  const auto kernel = bias.p != nullptr ? fa_bwd_dkv_kernel<T, true>
                                        : fa_bwd_dkv_kernel<T, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const dim3 grid((sk + kBK - 1) / kBK, grid_y, grid_z);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dk), static_cast<T*>(dv), bh, sq, sk, scale, causal,
      bias);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (q, k, v, do and the gradients; bfloat16 is
// apex_fa_bwd_dq_wgmma's and apex_fa_bwd_dkv_wgmma's); lse and dvec are
// float32 [bh, sq]. Only head_dim 64 is compiled. grid_y, grid_z,
// bias, heads and the bias strides as for apex_fa_fwd.
extern "C" int apex_fa_bwd_dq(const void* q, const void* k, const void* v,
                              const void* bias, const void* dout,
                              const void* lse, const void* dvec, void* dq,
                              int bh, int grid_y, int grid_z, int heads,
                              int sq, int sk, int d, float scale, int causal,
                              long long bsb, long long bsh, long long bsq,
                              long long bsk, int dtype, void* stream) {
  if (d != kD || heads < 1 || !bh_grid_ok(bh, grid_y, grid_z))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const apex_port::ScoreBias sb{static_cast<const float*>(bias), heads,
                                bsb, bsh, bsq, bsk};
  if (dtype == 0)
    return launch_dq<float>(q, k, v, dout, lse, dvec, dq, bh, grid_y, grid_z,
                            sq, sk, scale, causal, sb, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int apex_fa_bwd_dkv(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* dvec, void* dk,
                               void* dv, int bh, int grid_y, int grid_z,
                               int heads, int sq, int sk, int d, float scale,
                               int causal, long long bsb, long long bsh,
                               long long bsq, long long bsk, int dtype,
                               void* stream) {
  if (d != kD || heads < 1 || !bh_grid_ok(bh, grid_y, grid_z))
    return (int)cudaErrorInvalidValue;
  if (bh <= 0 || sk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const apex_port::ScoreBias sb{static_cast<const float*>(bias), heads,
                                bsb, bsh, bsq, bsk};
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, dout, lse, dvec, dk, dv, bh, grid_y,
                             grid_z, sq, sk, scale, causal, sb, s);
  return (int)cudaErrorInvalidValue;
}
