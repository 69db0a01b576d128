// Megatron attention-score softmax for Hopper (sm_90a): the forward
// (scaled, masked, causal) and the backward.
//
// Replaces: apex_tpu/ops/pallas/softmax_kernel.py `softmax_fwd_pallas`
// (body `_sm_fwd_kernel`), `_softmax_fwd_causal_chunked` (body
// `_sm_causal_chunked_kernel`; its chunked fetch is this file's causal
// form) and `softmax_bwd_pallas` (body `_sm_bwd_kernel`). x is seen as rows
// of sk, row r being query q = r % sq of flat batch b = r / sq. Per row, in
// fp32 whatever the IO dtype (float32, bfloat16, float16):
//   v = x * scale; masked positions (mask != 0) and, in the causal form,
//   columns j > q are REPLACED by -10000; m = max(v); e = exp(v - m);
//   s = sum(e); y = e * (1 / s), and y = 0 on a row whose m <= -10000
//   (fully masked); backward dx = (dy - sum(dy * y)) * y * scale, with no
//   mask operand (masked y is 0).
// Unlike the TPU kernels nothing is padded: any sk, any number of rows.
//
// What bounds them on this card: memory bytes (a dozen flops an element).
// The forward reads x (and the mask) once and writes y once; the backward
// reads y and dy once and writes dx once. What the design does about it:
// - row-resident forms hold a whole row in registers: "warp", one warp
//   per row and 4 rows a block, for rows up to 1024 (the forward's lanes
//   hold 16 values up to 512 columns, 32 above, so the registers of a
//   short row hold no padding and an SM keeps more rows in flight; the
//   backward's 32); "block", one 512-thread block per row, 32 values a
//   thread, up to 16384 (the megatron warp kernels' limit). Rows whose
//   length is a multiple of the 16-byte access (4 fp32, 8 bf16 / fp16)
//   are read and written 16 bytes a thread, others one element at a time.
//   Chunk c of lane t covers the same columns whatever the lane holds, so
//   the short form gives the long form's bits.
// - "stream", one 512-thread block per row at any length: the forward
//   reads the row once for an online max and sum, and once more to write;
//   the backward once for sum(dy * y) and once to write. This is what
//   makes generic_scaled_masked_softmax generic on the card.
// - the causal form never reads x above the diagonal (the TPU kernel's
//   chunked fetch skips those DMAs): row q reads columns 0 .. min(q,
//   sk - 1) only. The replaced positions above it still take part in the
//   max and the sum as the reference's -10000 do, as a count times
//   exp(-10000 - m), and are written as exp(-10000 - m) / s (0 unless the
//   row's scores are themselves near -10000).
// - the mask is read through one stride per dimension of x (0 where the
//   mask broadcasts), for any leading rank, as a 1, 2, 4 or 8-byte integer
//   or bool (the width a template parameter): a (b, 1, sq, sk) or
//   (b, 1, 1, sk) mask against (b, h, sq, sk) scores is never expanded or
//   copied. Its vector route: where the mask's sk stride is 1, its base
//   and every row's start are aligned to the access, and x takes 16-byte
//   accesses (mask_vector_ok, mirrored by ops/softmax_kernel.py's
//   mask_route), a row's mask pointer is computed once and each chunk of
//   V values of x takes one access of its V mask entries (4 bytes for a
//   float4 of x and a bool mask); every other mask (strided, misaligned,
//   a ragged sk) reads one entry at a time. A thread issues every load of
//   its row (x and mask) before it uses any, and a row's indices are
//   split with 32-bit divisions where they fit.
// - rows run over grid.x (B * sq is 131072 at the JAX AOT shape, past
//   grid.y's 65535) and element offsets are 64-bit (4 x 25 x 1024 x 32768
//   elements is past 2^31).
// - no atomics: every sum is a fixed butterfly in the warp, then the warps
//   in order, so two runs give the same bits.
// Forms (warp / block / stream, causal, mask) are template parameters
// chosen at launch. Speed beyond this simple design is later work.
//
// C interface (bound with ctypes): every pointer and the stream are
// `void*`; each function returns cudaGetLastError() after its launch.

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

using namespace apex_port;

constexpr float kMaskFill = -10000.0f;
constexpr int kPer = 32;            // values of a row a thread holds
constexpr int kPerShort = 16;       // the forward's "warp" form, short rows
constexpr int kWarpRows = 4;        // rows (warps) a block, "warp" form
constexpr int kBlockThreads = 512;  // threads a row, "block" / "stream"
constexpr int kWarpCols = 32 * kPer;
constexpr int kWarpShortCols = 32 * kPerShort;
constexpr int kResidentMax = kBlockThreads * kPer;
constexpr int kMaxLead = 8;         // leading dimensions of the mask plan

// a / b and a % b of non-negative a, b: 32-bit where both fit (the
// hardware has no 64-bit divide; its routine costs several times more)
__device__ __forceinline__ long long div_ll(long long a, long long b) {
  return (a <= 0x7fffffffLL && b <= 0x7fffffffLL)
             ? (long long)((unsigned)a / (unsigned)b)
             : a / b;
}

// the unsigned integer of kB bytes
template <int kB> struct MaskWord;
template <> struct MaskWord<1> { using T = unsigned char; };
template <> struct MaskWord<2> { using T = unsigned short; };
template <> struct MaskWord<4> { using T = unsigned int; };
template <> struct MaskWord<8> { using T = unsigned long long; };

// The mask broadcast to x's (lead..., sq, sk): element (b, q, j) sits at
// p + bytes * (sum_d i_d * stride[d] + q * sq + j * sk), b split into the
// lead dimensions' indices i_d (last dimension fastest). Strides are in
// elements, 0 where the mask broadcasts.
struct MaskView {
  const unsigned char* p;
  long long bytes;
  long long nlead;
  long long size[kMaxLead];
  long long stride[kMaxLead];
  long long sq, sk;
  __device__ __forceinline__ long long row_offset(long long b, int q) const {
    long long off = (long long)q * sq;
    for (int d = (int)nlead - 1; d >= 0; --d) {
      const long long n = div_ll(b, size[d]);
      off += (b - n * size[d]) * stride[d];
      b = n;
    }
    return off;
  }
  // entry `col` of the row at `off`, a kB-byte integer (kB == bytes)
  template <int kB>
  __device__ __forceinline__ typename MaskWord<kB>::T at(long long off,
                                                         int col) const {
    return *reinterpret_cast<const typename MaskWord<kB>::T*>(
        p + (off + (long long)col * sk) * kB);
  }
};

// The vector route's access: kV consecutive kB-byte entries from `e`,
// aligned to the access (at most 16 bytes: wider ones are several 16-byte
// loads), as kB * kV / 4 32-bit words; word_masked reads entry i of them.
template <int kB, int kV>
__device__ __forceinline__ void mask_words(const unsigned char* e,
                                           unsigned* w) {
  constexpr int kBytes = kB * kV;
  static_assert(kBytes % 4 == 0, "whole 32-bit words");
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 a = reinterpret_cast<const uint4*>(e)[i];
      w[4 * i] = a.x;
      w[4 * i + 1] = a.y;
      w[4 * i + 2] = a.z;
      w[4 * i + 3] = a.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 a = *reinterpret_cast<const uint2*>(e);
    w[0] = a.x;
    w[1] = a.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(e);
  }
}
template <int kB>
__device__ __forceinline__ bool word_masked(const unsigned* w, int i) {
  if constexpr (kB >= 4) {
    unsigned any = 0;
#pragma unroll
    for (int t = 0; t < kB / 4; ++t) any |= w[i * kB / 4 + t];
    return any != 0;
  } else {
    return (w[i * kB / 4] >> (8 * (i * kB % 4)) & ((1u << (8 * kB)) - 1)) !=
           0;
  }
}

// 16-bit values from and to their bits
template <typename T> __device__ __forceinline__ float bits_f32(unsigned b);
template <> __device__ __forceinline__ float bits_f32<__nv_bfloat16>(
    unsigned b) {
  return __uint_as_float(b << 16);
}
template <> __device__ __forceinline__ float bits_f32<__half>(unsigned b) {
  return __half2float(__ushort_as_half((unsigned short)b));
}
template <typename T> __device__ __forceinline__ unsigned f32_bits(float v);
template <> __device__ __forceinline__ unsigned f32_bits<__nv_bfloat16>(
    float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <> __device__ __forceinline__ unsigned f32_bits<__half>(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

// One 16-byte access: 4 fp32 or 8 16-bit values (p aligned to 16 bytes).
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

__device__ __forceinline__ void load_vec(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* o) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = bits_f32<T>(w[i] & 0xffffu);
    o[2 * i + 1] = bits_f32<T>(w[i] >> 16);
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = f32_bits<T>(v[2 * i]) | (f32_bits<T>(v[2 * i + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) t = fmaxf(t, red[w]);
  return t;
}
// the max / sum over a row: its warp ("warp" form) or its block
template <int kThreads>
__device__ __forceinline__ float row_max(float v, float* red) {
  return kThreads == 32 ? warp_max(v) : block_max(v, red);
}
template <int kThreads>
__device__ __forceinline__ float row_sum(float v, float* red) {
  return kThreads == 32 ? warp_sum(v) : block_sum(v, red);
}

// (m, s) <- the online-softmax merge of (m, s) and (mo, so): the max and
// the sum of exp(v - max); an empty side has m = -inf. Commutative, so the
// butterfly leaves every lane the same bits.
__device__ __forceinline__ void merge(float& m, float& s, float mo,
                                      float so) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * expf(m - mn)) +
      (mo == -INFINITY ? 0.f : so * expf(mo - mn));
  m = mn;
}

// A row's place in the mask: its element offset and, on the vector
// route, its first entry's address.
struct MaskRow {
  long long off;
  const unsigned char* p;
};
template <int kMB>
__device__ __forceinline__ MaskRow mask_row(const MaskView& mv,
                                            long long row, int sq, int q) {
  if (kMB == 0) return {0, nullptr};
  const long long off = mv.row_offset(div_ll(row, sq), q);
  return {off, mv.p + off * kMB};
}

// kN chunks of V values of x, chunk c from column col0 + c * step, scaled
// and masked (kMB: the mask's bytes an entry, 0 without one; kMV: its
// vector route); columns past lim (above the diagonal, or past the row)
// -inf and never read. Every load of x and of the mask is issued before
// any is used, so a thread's bytes of a row are in flight together. The
// vector route reads a chunk's mask entries wherever they lie inside the
// row (sk is a multiple of V there), the diagonal's chunk included.
template <typename T, int kN, int kMB, bool kMV>
__device__ __forceinline__ void load_chunks(const T* xr, const MaskView& mv,
                                            const MaskRow& mr, int col0,
                                            int step, int lim, int sk,
                                            float scale, int vec, float* v) {
  constexpr int V = Vec<T>::n;
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    const int col = col0 + c * step;
    if (vec && col + V - 1 <= lim) {
      load_vec(xr + col, v + c * V);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[c * V + e] = col + e <= lim ? to_f32(xr[col + e]) : 0.f;
    }
  }
  constexpr int kB = kMB > 0 ? kMB : 1;
  constexpr int kWords = kMV ? kB * V / 4 : 1;
  unsigned words[kN][kWords];
  typename MaskWord<kB>::T raw[kN][kMV ? 1 : V];
  if constexpr (kMB > 0) {
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      const int col = col0 + c * step;
      if constexpr (kMV) {
        if (col < sk) {
          mask_words<kB, V>(mr.p + (long long)col * kB, words[c]);
        } else {
#pragma unroll
          for (int w = 0; w < kWords; ++w) words[c][w] = 0;
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          raw[c][e] = col + e <= lim ? mv.at<kB>(mr.off, col + e) : 0;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kN; ++c) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int col = col0 + c * step + e;
      float s = v[c * V + e] * scale;
      if constexpr (kMB > 0) {
        const bool m =
            kMV ? word_masked<kB>(words[c], e) : raw[c][kMV ? 0 : e] != 0;
        if (m) s = kMaskFill;
      }
      v[c * V + e] = col <= lim ? s : -INFINITY;
    }
  }
}

// load_chunks on the mask's route: mvec is the same for the whole launch
template <typename T, int kN, int kMB>
__device__ __forceinline__ void load_row(const T* xr, const MaskView& mv,
                                         const MaskRow& mr, int col0,
                                         int step, int lim, int sk,
                                         float scale, int vec, int mvec,
                                         float* v) {
  if (kMB > 0 && mvec)
    load_chunks<T, kN, kMB, true>(xr, mv, mr, col0, step, lim, sk, scale,
                                  vec, v);
  else
    load_chunks<T, kN, kMB, false>(xr, mv, mr, col0, step, lim, sk, scale,
                                   vec, v);
}

// Store a chunk of results: columns <= lim take e * inv, the causal
// replaced columns above lim take `fill`; nothing at or past sk.
template <typename T>
__device__ __forceinline__ void store_chunk(T* yr, int col0, int sk, int lim,
                                            const float* e, float inv,
                                            float fill, int vec) {
  constexpr int V = Vec<T>::n;
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = col0 + i <= lim ? e[i] * inv : fill;
  if (vec && col0 + V <= sk) {
    store_vec(yr + col0, o);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (col0 + i < sk) yr[col0 + i] = from_f32<T>(o[i]);
  }
}

template <int kThreads>
__device__ __forceinline__ long long resident_row(int& t) {
  if (kThreads == 32) {
    t = threadIdx.x & 31;
    return (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  }
  t = threadIdx.x;
  return blockIdx.x;
}

// Row-resident forward: kThreads = 32 ("warp") or kBlockThreads ("block"),
// kP values a thread; kMB the mask's bytes an entry (0: no mask).
template <typename T, int kThreads, int kP, bool kCausal, int kMB>
__global__ void __launch_bounds__(kThreads == 32 ? 32 * kWarpRows : kThreads)
    sm_fwd_resident(const T* __restrict__ x, MaskView mv, T* __restrict__ y,
                    long long rows, int sq, int sk, float scale, int vec,
                    int mvec) {
  constexpr int V = Vec<T>::n;
  __shared__ float red[32];
  int t;
  const long long row = resident_row<kThreads>(t);
  if (row >= rows) return;  // a whole warp ("warp" form only)
  const int q = (int)(row - div_ll(row, sq) * sq);
  const int lim = kCausal ? min(q, sk - 1) : sk - 1;
  const long long base = row * (long long)sk;
  const MaskRow mr = mask_row<kMB>(mv, row, sq, q);
  float v[kP];
  load_row<T, kP / V, kMB>(x + base, mv, mr, t * V, kThreads * V, lim, sk,
                           scale, vec, mvec, v);
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kP; ++i) m = fmaxf(m, v[i]);
  m = row_max<kThreads>(m, red);
  const int above = sk - 1 - lim;  // replaced columns never read
  if (kCausal && above > 0) m = fmaxf(m, kMaskFill);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kP; ++i) {
    v[i] = expf(v[i] - m);
    s += v[i];
  }
  s = row_sum<kThreads>(s, red);
  const float efill = kCausal && above > 0 ? expf(kMaskFill - m) : 0.f;
  s += (float)above * efill;
  const float inv = m <= kMaskFill ? 0.f : 1.f / s;
#pragma unroll
  for (int c = 0; c < kP / V; ++c)
    store_chunk(y + base, (t + c * kThreads) * V, sk, lim, v + c * V, inv,
                efill * inv, vec);
}

// Streaming forward, one block of kBlockThreads per row, any sk.
template <typename T, bool kCausal, int kMB>
__global__ void __launch_bounds__(kBlockThreads)
    sm_fwd_stream(const T* __restrict__ x, MaskView mv, T* __restrict__ y,
                  long long rows, int sq, int sk, float scale, int vec,
                  int mvec) {
  constexpr int V = Vec<T>::n;
  constexpr int kStep = kBlockThreads * V;
  __shared__ float red_m[32], red_s[32];
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const int q = (int)(row - div_ll(row, sq) * sq);
  const int lim = kCausal ? min(q, sk - 1) : sk - 1;
  const long long base = row * (long long)sk;
  const MaskRow mr = mask_row<kMB>(mv, row, sq, q);
  const T* xr = x + base;
  float m = -INFINITY, s = 0.f;
  float v[V];
  for (int col0 = t * V; col0 <= lim; col0 += kStep) {
    load_row<T, 1, kMB>(xr, mv, mr, col0, 0, lim, sk, scale, vec, mvec, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (v[e] > m) {
        s = s * expf(m - v[e]) + 1.f;
        m = v[e];
      } else if (m != -INFINITY) {
        s += expf(v[e] - m);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, s, off));
  if ((t & 31) == 0) {
    red_m[t >> 5] = m;
    red_s[t >> 5] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
  for (int w = 1; w < kBlockThreads / 32; ++w) merge(m, s, red_m[w], red_s[w]);
  const int above = sk - 1 - lim;
  if (kCausal && above > 0) merge(m, s, kMaskFill, (float)above);
  const float inv = m <= kMaskFill ? 0.f : 1.f / s;
  const float fill = kCausal && above > 0 ? expf(kMaskFill - m) * inv : 0.f;
  for (int col0 = t * V; col0 < sk; col0 += kStep) {
    if (col0 <= lim) {
      load_row<T, 1, kMB>(xr, mv, mr, col0, 0, lim, sk, scale, vec, mvec,
                          v);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = expf(v[e] - m);
    }
    store_chunk(y + base, col0, sk, lim, v, inv, fill, vec);
  }
}

// Row-resident backward.
template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads == 32 ? 32 * kWarpRows : kThreads)
    sm_bwd_resident(const T* __restrict__ y, const T* __restrict__ dy,
                    T* __restrict__ dx, long long rows, int sk, float scale,
                    int vec) {
  constexpr int V = Vec<T>::n;
  __shared__ float red[32];
  int t;
  const long long row = resident_row<kThreads>(t);
  if (row >= rows) return;
  const long long base = row * (long long)sk;
  float yv[kPer], gv[kPer];
  float dot = 0.f;
#pragma unroll
  for (int c = 0; c < kPer / V; ++c) {
    const int col0 = (t + c * kThreads) * V;
    if (vec && col0 + V <= sk) {
      load_vec(y + base + col0, yv + c * V);
      load_vec(dy + base + col0, gv + c * V);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const bool in = col0 + e < sk;
        yv[c * V + e] = in ? to_f32(y[base + col0 + e]) : 0.f;
        gv[c * V + e] = in ? to_f32(dy[base + col0 + e]) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dot += gv[c * V + e] * yv[c * V + e];
  }
  dot = row_sum<kThreads>(dot, red);
#pragma unroll
  for (int c = 0; c < kPer / V; ++c) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      gv[c * V + e] = (gv[c * V + e] - dot) * yv[c * V + e] * scale;
    store_chunk(dx + base, (t + c * kThreads) * V, sk, sk - 1, gv + c * V,
                1.f, 0.f, vec);
  }
}

// Streaming backward, one block of kBlockThreads per row, any sk.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    sm_bwd_stream(const T* __restrict__ y, const T* __restrict__ dy,
                  T* __restrict__ dx, long long rows, int sk, float scale,
                  int vec) {
  constexpr int V = Vec<T>::n;
  constexpr int kStep = kBlockThreads * V;
  __shared__ float red[32];
  const long long base = (long long)blockIdx.x * sk;
  const int t = threadIdx.x;
  float yv[V], gv[V];
  auto load = [&](int col0) {
    if (vec && col0 + V <= sk) {
      load_vec(y + base + col0, yv);
      load_vec(dy + base + col0, gv);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const bool in = col0 + e < sk;
        yv[e] = in ? to_f32(y[base + col0 + e]) : 0.f;
        gv[e] = in ? to_f32(dy[base + col0 + e]) : 0.f;
      }
    }
  };
  float dot = 0.f;
  for (int col0 = t * V; col0 < sk; col0 += kStep) {
    load(col0);
#pragma unroll
    for (int e = 0; e < V; ++e) dot += gv[e] * yv[e];
  }
  dot = block_sum(dot, red);
  for (int col0 = t * V; col0 < sk; col0 += kStep) {
    load(col0);
#pragma unroll
    for (int e = 0; e < V; ++e) gv[e] = (gv[e] - dot) * yv[e] * scale;
    store_chunk(dx + base, col0, sk, sk - 1, gv, 1.f, 0.f, vec);
  }
}

template <typename T, bool kCausal, int kMB>
int launch_fwd(const void* x, const MaskView& mv, void* y, long long rows,
               int sq, int sk, float scale, int vec, int mvec,
               cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const long long warp_blocks = (rows + kWarpRows - 1) / kWarpRows;
  if (sk <= kWarpShortCols) {
    sm_fwd_resident<T, 32, kPerShort, kCausal, kMB>
        <<<(unsigned)warp_blocks, 32 * kWarpRows, 0, s>>>(
            xp, mv, yp, rows, sq, sk, scale, vec, mvec);
  } else if (sk <= kWarpCols) {
    sm_fwd_resident<T, 32, kPer, kCausal, kMB>
        <<<(unsigned)warp_blocks, 32 * kWarpRows, 0, s>>>(
            xp, mv, yp, rows, sq, sk, scale, vec, mvec);
  } else if (sk <= kResidentMax) {
    sm_fwd_resident<T, kBlockThreads, kPer, kCausal, kMB>
        <<<(unsigned)rows, kBlockThreads, 0, s>>>(xp, mv, yp, rows, sq, sk,
                                                  scale, vec, mvec);
  } else {
    sm_fwd_stream<T, kCausal, kMB><<<(unsigned)rows, kBlockThreads, 0, s>>>(
        xp, mv, yp, rows, sq, sk, scale, vec, mvec);
  }
  return (int)cudaGetLastError();
}

// The mask's vector route (mask_route in ops/softmax_kernel.py): x takes
// 16-byte accesses (`vec`), the mask's sk stride is 1, and its base and
// every row's start (each lead stride and the sq stride) are aligned to
// the access of V entries, at most 16 bytes.
template <typename T>
bool mask_vector_ok(const MaskView& mv, int vec) {
  const long long access = std::min(16LL, Vec<T>::n * mv.bytes);
  const long long unit = access / mv.bytes;  // entries
  if (!vec || mv.sk != 1 || !is_aligned(mv.p, (unsigned)access) ||
      mv.sq % unit != 0)
    return false;
  for (int d = 0; d < mv.nlead; ++d)
    if (mv.stride[d] % unit != 0) return false;
  return true;
}

template <typename T, bool kCausal>
int launch_fwd_mask(const void* x, const MaskView& mv, bool mask, void* y,
                    long long rows, int sq, int sk, float scale, int vec,
                    cudaStream_t s) {
  const int mvec = mask && mask_vector_ok<T>(mv, vec);
  switch (mask ? mv.bytes : 0) {
    case 0:
      return launch_fwd<T, kCausal, 0>(x, mv, y, rows, sq, sk, scale, vec,
                                       mvec, s);
    case 1:
      return launch_fwd<T, kCausal, 1>(x, mv, y, rows, sq, sk, scale, vec,
                                       mvec, s);
    case 2:
      return launch_fwd<T, kCausal, 2>(x, mv, y, rows, sq, sk, scale, vec,
                                       mvec, s);
    case 4:
      return launch_fwd<T, kCausal, 4>(x, mv, y, rows, sq, sk, scale, vec,
                                       mvec, s);
    default:
      return launch_fwd<T, kCausal, 8>(x, mv, y, rows, sq, sk, scale, vec,
                                       mvec, s);
  }
}

template <typename T>
int launch_fwd_forms(const void* x, const MaskView& mv, bool mask, int causal,
                     void* y, long long rows, int sq, int sk, float scale,
                     cudaStream_t s) {
  const int vec =
      sk % Vec<T>::n == 0 && is_aligned(x, 16) && is_aligned(y, 16);
  if (causal)
    return launch_fwd_mask<T, true>(x, mv, mask, y, rows, sq, sk, scale, vec,
                                    s);
  return launch_fwd_mask<T, false>(x, mv, mask, y, rows, sq, sk, scale, vec,
                                   s);
}

template <typename T>
int launch_bwd(const void* y, const void* dy, void* dx, long long rows,
               int sk, float scale, cudaStream_t s) {
  const T* yp = static_cast<const T*>(y);
  const T* gp = static_cast<const T*>(dy);
  T* dp = static_cast<T*>(dx);
  const int vec = sk % Vec<T>::n == 0 && is_aligned(y, 16) &&
                  is_aligned(dy, 16) && is_aligned(dx, 16);
  if (sk <= kWarpCols) {
    const long long blocks = (rows + kWarpRows - 1) / kWarpRows;
    sm_bwd_resident<T, 32><<<(unsigned)blocks, 32 * kWarpRows, 0, s>>>(
        yp, gp, dp, rows, sk, scale, vec);
  } else if (sk <= kResidentMax) {
    sm_bwd_resident<T, kBlockThreads><<<(unsigned)rows, kBlockThreads, 0, s>>>(
        yp, gp, dp, rows, sk, scale, vec);
  } else {
    sm_bwd_stream<T><<<(unsigned)rows, kBlockThreads, 0, s>>>(yp, gp, dp, rows,
                                                              sk, scale, vec);
  }
  return (int)cudaGetLastError();
}

// rows and sk give a grid within grid.x's 2^31 - 1 blocks
bool geometry_ok(long long rows, int sk) {
  if (rows < 0 || sk < 1) return false;
  const long long blocks =
      sk <= kWarpCols ? (rows + kWarpRows - 1) / kWarpRows : rows;
  return blocks <= INT_MAX;
}

}  // namespace

// x, y: [rows, sk] contiguous, row r = (flat batch r / sq, query r % sq).
// mask: null, or the mask's first element; plan: null without a mask, else
// 4 + 2 * 8 long longs: bytes (1, 2, 4, 8), nlead (<= 8), the lead sizes
// (8), the lead strides (8), the sq stride and the sk stride, in elements
// (see MaskView). causal: columns j > q replaced. dtype: 0 float32,
// 1 bfloat16, 2 float16.
extern "C" int apex_softmax_fwd(const void* x, const void* mask,
                                const void* plan, void* y, long long rows,
                                int sq, int sk, float scale, int causal,
                                int dtype, void* stream) {
  if (!geometry_ok(rows, sk) || sq < 1) return (int)cudaErrorInvalidValue;
  MaskView mv{};
  if (mask != nullptr) {
    const long long* pl = static_cast<const long long*>(plan);
    if (pl == nullptr) return (int)cudaErrorInvalidValue;
    mv.p = static_cast<const unsigned char*>(mask);
    mv.bytes = pl[0];
    mv.nlead = pl[1];
    if (!(mv.bytes == 1 || mv.bytes == 2 || mv.bytes == 4 || mv.bytes == 8) ||
        mv.nlead < 0 || mv.nlead > kMaxLead)
      return (int)cudaErrorInvalidValue;
    for (int d = 0; d < kMaxLead; ++d) {
      mv.size[d] = pl[2 + d];
      mv.stride[d] = pl[2 + kMaxLead + d];
      if (d < mv.nlead && mv.size[d] < 1) return (int)cudaErrorInvalidValue;
    }
    mv.sq = pl[2 + 2 * kMaxLead];
    mv.sk = pl[3 + 2 * kMaxLead];
  }
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool m = mask != nullptr;
  if (dtype == 0)
    return launch_fwd_forms<float>(x, mv, m, causal, y, rows, sq, sk, scale, s);
  if (dtype == 1)
    return launch_fwd_forms<__nv_bfloat16>(x, mv, m, causal, y, rows, sq, sk,
                                           scale, s);
  if (dtype == 2)
    return launch_fwd_forms<__half>(x, mv, m, causal, y, rows, sq, sk, scale,
                                    s);
  return (int)cudaErrorInvalidValue;
}

// y, dy, dx: [rows, sk] contiguous, one dtype (0 float32, 1 bfloat16,
// 2 float16).
extern "C" int apex_softmax_bwd(const void* y, const void* dy, void* dx,
                                long long rows, int sk, float scale,
                                int dtype, void* stream) {
  if (!geometry_ok(rows, sk)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(y, dy, dx, rows, sk, scale, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(y, dy, dx, rows, sk, scale, s);
  if (dtype == 2) return launch_bwd<__half>(y, dy, dx, rows, sk, scale, s);
  return (int)cudaErrorInvalidValue;
}
