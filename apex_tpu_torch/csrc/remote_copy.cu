// Peer puts between rank processes through CUDA IPC, for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/pallas/remote_copy.py `peer_shift` (the Pallas
// kernel `_shift_kernel`: a one-sided remote DMA of the whole shard to
// rank (my + shift) mod n) and `halo_exchange_rdma` (`_halo_kernel`: the
// low edge to the left rank's `hi` landing buffer, the high edge to the
// right rank's `lo`). On the TPU a DMA engine moves the bytes and a pair
// of DMA semaphores says when they landed. Here every rank is a process
// with its own CUDA context; each exports one device allocation (an
// arena, cudaMalloc'd by `apex_ipc_alloc`) through cudaIpcGetMemHandle and
// maps its peers' arenas with cudaIpcOpenMemHandle, which works between
// processes on one card as between cards. A put is then a kernel of the
// sending rank that stores through the peer-mapped pointer, and the
// semaphores become 64-bit epoch flags in the arenas:
//
//   sender  (peer_put / halo_put):
//     wait until ack >= need          the slot's previous message was
//                                     consumed (ld.acquire.sys spin)
//     copy src -> peer landing        the copy plan (below)
//   the next kernel on the stream (peer_wait; peer_shift and
//   halo_exchange_rdma launch it right after the put), one release at
//   system scope (fence.acq_rel.sys, then the stores):
//     ready = epoch                   in the receiver's arena
//     ack = previous                  in the sender's arena: the previous
//                                     message's copy-out is done
//   receiver (peer_wait):
//     wait until ready >= epoch       (ld.acquire.sys spin)
//     copy landing -> out             (optional: peer_shift copies out)
//
// This is the handshake of the reference's `push_pull_halos_1d`
// (apex/contrib/csrc/peer_memory/peer_memory_cuda.cu): without the ack a
// fast rank would overwrite a landing buffer its slower neighbour has not
// read yet. A flag is released by one thread of the kernel that follows
// the one whose accesses it announces: every access of a kernel before it
// on the stream is complete when it starts (as halo_put's acks of what
// landed in the previous exchange always were), so no kernel has to count
// its blocks to find the last one and fence for all of them. The release
// at system scope pairs with the peer's acquire. With two landing slots a
// sender, the ack of a message (released when the receiver's next
// peer_shift starts) still arrives before the sender's put two messages
// later needs it. Every spin is bounded by %globaltimer and ends in
// __trap(), so a signal that never comes is a CUDA error on the stream,
// never a hang.
//
// Contexts of separate processes on one card are time-sliced (no MPS is
// assumed): a spinning wait holds its time slice until it is preempted,
// so the waits live in these short kernels and never inside a compute
// kernel.
//
// What bounds it on this card: memory bytes. A put reads the source once
// and writes the landing buffer once, both in the one HBM (3.35 TB/s),
// so its least time is 2 * bytes / 3.35 TB/s; the copy-out of peer_wait
// costs the same again. Below the 50 MB L2 both ends can stay in the
// cache, and then a launch's fixed cost (the spins, the fences, finding
// the last block) is what is left to save.
//
// What the design does about that. The copy plan (`copy_plan` in
// ops/remote_copy.py, which the wrapper passes in) splits the message into
// a head (bytes until both pointers are aligned), an aligned body and a
// tail, cuts the body into runs of at most a stage and deals them to a
// persistent grid (at most one block an SM) in turn, the same number to
// every block, so the blocks move through the message side by side:
// - the bulk route: both pointers 16-byte aligned after the head and a
//   body of at least one stage (32 KB). One thread of each block moves
//   its runs through a ring of 6 stages of 32 KB in shared memory: a bulk
//   load (cp.async.bulk, the TMA's untiled form) lands a run in a stage
//   and completes on its mbarrier, a bulk store takes it to the
//   destination, and the stage is loaded again once that store has read
//   it, so loads and stores of several runs are in flight at once and no
//   thread spends registers or instructions on the bytes. The loads that
//   fill the ring read only the source, so the put issues them before it
//   waits for the receiver's ack;
// - the register route: a body smaller than one stage (a bulk launch's
//   set-up would not pay), or pointers that no head can align both of to
//   16 bytes. Words of the widest size both take (16, 8, 4, 2 or 1 bytes);
//   each thread has 64 bytes of independent loads in flight before it
//   stores them;
// - the head and tail (under 16 bytes each) by the threads of a job's
//   first block.
// The route is chosen by size and alignment, never as a fallback: a plan
// the pointers do not meet is refused (cudaErrorInvalidValue) and the
// wrapper raises. With at most 132 blocks a launch there are at most 132
// acquire spins and no count, where the grid-stride copy this replaces
// had up to 528 blocks, each with a spin, a system fence and a count.
//
// C interface (bound with ctypes): pointers and the stream are `void*`;
// every function returns a cudaError_t (cudaGetLastError() after a launch).

#include <cstdio>

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

namespace hp = apex_port::hopper;
using u64 = unsigned long long;

constexpr int kThreads = 256;
// register route: bytes a thread moves a pass, all loads in flight before
// the stores (4 words of 16 bytes, or more of narrower ones)
constexpr int kPassBytes = 64;
constexpr int kMaxStages = 16;
constexpr int kMaxRingBytes = 224 * 1024;  // dynamic shared memory a block

// The copy plan of ops/remote_copy.py `CopyPlan`, field for field.
struct Plan {
  long long head, body, tail;  // bytes: src[0:head), the aligned body, tail
  long long chunk;             // bytes of a run (runs dealt in turn)
  long long stage;             // bytes of a ring stage, or of a pass
  long long stages;            // the bulk ring's stages
  long long blocks;            // blocks of the job
  long long word;              // register route: bytes a word
  long long bulk;              // 1: the bulk route
};

__device__ __forceinline__ u64 ld_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// *f0 = v0 and *f1 = v1 (either flag may be null), each a release at
// system scope: one fence, then the strong stores (a release pattern
// each), so that two flags cost one fence, not two.
__device__ void release_sys(u64* f0, u64 v0, u64* f1, u64 v1) {
  if (f0 == nullptr && f1 == nullptr) return;
  asm volatile("fence.acq_rel.sys;" ::: "memory");
  if (f0 != nullptr)
    asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(f0), "l"(v0)
                 : "memory");
  if (f1 != nullptr)
    asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(f1), "l"(v1)
                 : "memory");
}

// Thread 0 of the block spins until *flag >= want (acquire, system
// scope); its proxy fence orders its bulk copies after that acquire, and
// the barrier every other thread's accesses (the causality chain release
// -> acquire -> bar.sync). want == 0 never waits. Past timeout_ns:
// __trap().
__device__ void wait_at_least(const u64* flag, u64 want, u64 timeout_ns,
                              const char* what) {
  if (want == 0) return;
  if (threadIdx.x == 0) {
    const u64 t0 = hp::globaltimer();
    while (ld_acquire_sys(flag) < want) {
      if (hp::globaltimer() - t0 > timeout_ns) {
        printf("apex_tpu_torch remote_copy: %s flag %p stayed at %llu < "
               "%llu for %llu ns; trapping\n",
               what, (const void*)flag, ld_acquire_sys(flag), want,
               timeout_ns);
        __trap();
      }
      __nanosleep(200);
    }
    hp::fence_proxy_async_global();
  }
  __syncthreads();
}

// The head and the tail: the first threads of the job's first block.
__device__ void copy_ragged(const char* s, char* d, const Plan& p) {
  const int t = threadIdx.x;
  if (t < p.head) d[t] = s[t];
  const long long off = p.head + p.body;
  if (t < p.tail) d[off + t] = s[off + t];
}

// Block jb's runs: the body is cut into runs of p.chunk bytes (at most
// a stage) dealt to the blocks in turn, so run k of block jb starts at
// (jb + k * blocks) * chunk and the blocks move through the message side
// by side. A cursor over them, without a division.
struct Runs {
  long long off, step, body, chunk;
  __device__ __forceinline__ uint32_t bytes() const {
    return off < body ? (uint32_t)min(chunk, body - off) : 0u;
  }
  __device__ __forceinline__ void next() { off += step; }
};

__device__ __forceinline__ Runs runs(const Plan& p, long long jb) {
  return {jb * p.chunk, p.blocks * p.chunk, p.body, p.chunk};
}

// The register route: each run is one pass in which every thread loads
// its kPassBytes (words of V, kThreads apart), then stores them.
template <typename V>
__device__ void copy_regs(const char* __restrict__ s, char* __restrict__ d,
                          const Plan& p, long long jb) {
  constexpr int kWords = kPassBytes / (int)sizeof(V);
  for (Runs r = runs(p, jb); r.bytes() > 0; r.next()) {
    const int n = (int)(r.bytes() / sizeof(V));
    const V* sv = reinterpret_cast<const V*>(s + r.off);
    V* dv = reinterpret_cast<V*>(d + r.off);
    V v[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int w = u * kThreads + (int)threadIdx.x;
      if (w < n) v[u] = sv[w];
    }
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int w = u * kThreads + (int)threadIdx.x;
      if (w < n) dv[w] = v[u];
    }
  }
}

// The bulk route, by thread 0 of the block: run i lands in stage i %
// stages and completes that stage's barrier phase i / stages. bulk_begin
// sets the barriers up and issues the loads that fill the ring; they read
// only the source, so a kernel issues them before it waits for the flag
// that lets it write. bulk_finish stores each run as it lands (one bulk
// group each) and, after issuing the store of run i, refills the stage of
// run i - 1 with the next run to load once that store has read it (all
// but the newest group read). It returns when every store's writes are
// done, ordered before this thread's later generic accesses.
__device__ void bulk_begin(const char* s, const Plan& p, long long jb,
                           char* ring, uint64_t* full) {
  const int stages = (int)p.stages;
  for (int k = 0; k < stages; ++k) hp::mbar_init(&full[k], 1);
  hp::mbar_init_fence();
  Runs r = runs(p, jb);
  for (int k = 0; k < stages && r.bytes() > 0; ++k, r.next()) {
    hp::mbar_expect_tx(&full[k], r.bytes());
    hp::bulk_load(ring + k * p.stage, s + r.off, r.bytes(), &full[k]);
  }
}

__device__ void bulk_finish(const char* s, char* d, const Plan& p,
                            long long jb, char* ring, uint64_t* full,
                            u64 timeout_ns) {
  const int stages = (int)p.stages;
  Runs ld = runs(p, jb);
  for (int k = 0; k < stages; ++k) ld.next();
  int st = 0, prev = -1;
  uint32_t phase = 0;
  for (Runs r = runs(p, jb); r.bytes() > 0; r.next()) {
    hp::mbar_wait(&full[st], phase, timeout_ns);
    hp::fence_proxy_async_shared();
    hp::bulk_store(d + r.off, ring + st * p.stage, r.bytes());
    hp::bulk_commit();
    if (prev >= 0 && ld.bytes() > 0) {
      hp::bulk_wait_read<1>();
      hp::mbar_expect_tx(&full[prev], ld.bytes());
      hp::bulk_load(ring + prev * p.stage, s + ld.off, ld.bytes(),
                    &full[prev]);
      ld.next();
    }
    prev = st;
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }
  hp::bulk_wait<0>();
  hp::fence_proxy_async_global();
}

// A copy job (src -> dst by plan p) as block jb runs it, in two steps
// around the wait for the flag that lets it write: copy_begin issues the
// bulk route's first loads; copy_finish moves the ragged bytes (block 0),
// then the block's runs by the plan's route.
__device__ void copy_begin(const void* src, const Plan& p, long long jb,
                           char* ring, uint64_t* full) {
  if (p.bulk && threadIdx.x == 0)
    bulk_begin(static_cast<const char*>(src) + p.head, p, jb, ring, full);
}

__device__ void copy_finish(const void* src, void* dst, const Plan& p,
                            long long jb, char* ring, uint64_t* full,
                            u64 timeout_ns) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if (jb == 0) copy_ragged(s, d, p);
  s += p.head;
  d += p.head;
  if (p.bulk) {
    if (threadIdx.x == 0) bulk_finish(s, d, p, jb, ring, full, timeout_ns);
    return;
  }
  switch (p.word) {
    case 16: copy_regs<uint4>(s, d, p, jb); break;
    case 8: copy_regs<uint2>(s, d, p, jb); break;
    case 4: copy_regs<unsigned>(s, d, p, jb); break;
    case 2: copy_regs<unsigned short>(s, d, p, jb); break;
    default: copy_regs<unsigned char>(s, d, p, jb); break;
  }
}

__global__ void __launch_bounds__(kThreads)
peer_put_kernel(const void* src, void* dst, const Plan p, const u64* ack,
                u64 ack_need, u64 timeout_ns) {
  extern __shared__ __align__(128) char ring[];
  __shared__ uint64_t full[kMaxStages];
  copy_begin(src, p, blockIdx.x, ring, full);
  wait_at_least(ack, ack_need, timeout_ns, "peer_put ack");
  copy_finish(src, dst, p, blockIdx.x, ring, full, timeout_ns);
}

// One launch sends both edges: src_lo -> dst_lo (the left rank's `hi`
// landing buffer) by the first lo.blocks blocks, src_hi -> dst_hi (the
// right rank's `lo`) by the rest. Block 0 first releases this rank's acks
// of the previous exchange (it has used what landed then: every kernel
// before this one on the stream is done); every block then waits for the
// neighbours' acks of this rank's previous puts.
__global__ void __launch_bounds__(kThreads)
halo_put_kernel(const void* src_lo, void* dst_lo, const Plan lo,
                const void* src_hi, void* dst_hi, const Plan hi,
                u64* ack_out_left, u64* ack_out_right,
                const u64* ack_in_left, const u64* ack_in_right, u64 prev,
                u64 timeout_ns) {
  extern __shared__ __align__(128) char ring[];
  __shared__ uint64_t full[kMaxStages];
  const bool is_lo = blockIdx.x < lo.blocks;
  const Plan& p = is_lo ? lo : hi;
  const void* src = is_lo ? src_lo : src_hi;
  const long long jb = is_lo ? blockIdx.x : blockIdx.x - lo.blocks;
  if (blockIdx.x == 0 && threadIdx.x == 0 && prev > 0)
    release_sys(ack_out_left, prev, ack_out_right, prev);
  copy_begin(src, p, jb, ring, full);
  wait_at_least(ack_in_left, prev, timeout_ns, "halo_put left ack");
  wait_at_least(ack_in_right, prev, timeout_ns, "halo_put right ack");
  copy_finish(src, is_lo ? dst_lo : dst_hi, p, jb, ring, full, timeout_ns);
}

// First releases the flags of the kernels before it on the stream (each
// non-null flag f_i = v_i, by one thread of block 0: the last warp's first
// thread, so that thread 0's spin and copy do not wait for the fence),
// then waits until *ready >= epoch and copies the landing buffer to out
// by the plan.
__global__ void __launch_bounds__(kThreads)
peer_wait_kernel(u64* f0, u64 v0, u64* f1, u64 v1, const u64* ready,
                 u64 epoch, const void* landing, void* out, const Plan p,
                 u64 timeout_ns) {
  extern __shared__ __align__(128) char ring[];
  __shared__ uint64_t full[kMaxStages];
  if (blockIdx.x == 0 && threadIdx.x == (blockDim.x - 1) / 32 * 32)
    release_sys(f0, v0, f1, v1);
  wait_at_least(ready, epoch, timeout_ns, "peer_wait ready");
  copy_begin(landing, p, blockIdx.x, ring, full);
  copy_finish(landing, out, p, blockIdx.x, ring, full, timeout_ns);
}

// The plan from the wrapper's array, or nothing to copy where it is null.
Plan read_plan(const long long* a) {
  Plan p = {0, 0, 0, 16, 16, 1, 1, 16, 0};
  if (a != nullptr)
    p = {a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8]};
  return p;
}

// A plan the kernel can run on these pointers: consistent sizes, a ring
// that fits, and a body both pointers reach aligned to the route's word.
bool plan_ok(const Plan& p, const void* src, const void* dst) {
  const u64 s = reinterpret_cast<u64>(src) + p.head;
  const u64 d = reinterpret_cast<u64>(dst) + p.head;
  const long long w = p.bulk ? 16 : p.word;
  const bool words = w == 1 || w == 2 || w == 4 || w == 8 || w == 16;
  return words && p.head >= 0 && p.tail >= 0 && p.body >= 0 &&
         p.head < 16 && p.tail < 16 && p.body % w == 0 &&
         (p.body == 0 || (s % w == 0 && d % w == 0)) && p.blocks >= 1 &&
         p.chunk > 0 && p.chunk % w == 0 && p.stage > 0 &&
         p.stage % w == 0 &&
         p.chunk <= p.stage &&
         (p.body == 0 || p.chunk * (p.blocks - 1) < p.body) &&
         (p.bulk || p.stage <= (long long)kThreads * kPassBytes) &&
         (!p.bulk || (p.stage % 16 == 0 && p.stage > 0 && p.stages >= 1 &&
                      p.stages <= kMaxStages &&
                      p.stage * p.stages <= kMaxRingBytes));
}

int ring_bytes(const Plan& p) {
  return p.bulk ? (int)(p.stage * p.stages) : 0;
}

// The launch of `kernel` with `blocks` blocks and `smem` bytes of ring
// (above the default 48 KB only with the attribute raised to it).
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int blocks, int threads,
                   int smem, cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- arenas

// A zeroed device allocation of nbytes on `device` that IPC can export.
extern "C" int apex_ipc_alloc(long long nbytes, int device, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(out, (size_t)nbytes);
  if (e == cudaSuccess) e = cudaMemset(*out, 0, (size_t)nbytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// The 64-byte cudaIpcMemHandle_t of an apex_ipc_alloc allocation.
extern "C" int apex_ipc_handle(void* ptr, void* handle) {
  return (int)cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle),
                                  ptr);
}

// Maps another process's allocation into this one.
extern "C" int apex_ipc_open(const void* handle, int device, void** out) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h = *static_cast<const cudaIpcMemHandle_t*>(handle);
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int apex_ipc_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int apex_ipc_free(void* ptr) { return (int)cudaFree(ptr); }

// --------------------------------------------------------------- kernels

// src (local) -> dst (a peer's landing buffer) by `plan` (nine long
// longs, host memory), after *ack >= ack_need. The receiver's ready flag
// is released by the peer_wait launched next on the stream.
extern "C" int apex_peer_put(const void* src, void* dst,
                             const long long* plan, const void* ack,
                             u64 ack_need, u64 timeout_ns, void* stream) {
  const Plan p = read_plan(plan);
  if (plan == nullptr || !plan_ok(p, src, dst))
    return (int)cudaErrorInvalidValue;
  return (int)launch(peer_put_kernel, (int)p.blocks, kThreads, ring_bytes(p),
                     static_cast<cudaStream_t>(stream), src, dst, p,
                     static_cast<const u64*>(ack), ack_need, timeout_ns);
}

// Both halo edges in one launch (see halo_put_kernel), each by its plan;
// the neighbours' ready flags are released by the peer_wait launched next.
extern "C" int apex_halo_put(const void* src_lo, void* dst_lo,
                             const long long* plan_lo, const void* src_hi,
                             void* dst_hi, const long long* plan_hi,
                             void* ack_out_left, void* ack_out_right,
                             const void* ack_in_left,
                             const void* ack_in_right, u64 prev,
                             u64 timeout_ns, void* stream) {
  const Plan lo = read_plan(plan_lo), hi = read_plan(plan_hi);
  if (plan_lo == nullptr || plan_hi == nullptr ||
      !plan_ok(lo, src_lo, dst_lo) || !plan_ok(hi, src_hi, dst_hi))
    return (int)cudaErrorInvalidValue;
  const int smem = ring_bytes(lo) > ring_bytes(hi) ? ring_bytes(lo)
                                                   : ring_bytes(hi);
  return (int)launch(
      halo_put_kernel, (int)(lo.blocks + hi.blocks), kThreads, smem,
      static_cast<cudaStream_t>(stream), src_lo, dst_lo, lo, src_hi, dst_hi,
      hi, static_cast<u64*>(ack_out_left), static_cast<u64*>(ack_out_right),
      static_cast<const u64*>(ack_in_left),
      static_cast<const u64*>(ack_in_right), prev, timeout_ns);
}

// Releases *f0 = v0 and *f1 = v1 (either may be null: the flags of the
// kernels before this one on the stream), waits until *ready >= epoch,
// then, with a plan, copies the landing buffer to out by it. Without a
// plan it is one thread.
extern "C" int apex_peer_wait(void* f0, u64 v0, void* f1, u64 v1,
                              const void* ready, u64 epoch,
                              const void* landing, void* out,
                              const long long* plan, u64 timeout_ns,
                              void* stream) {
  const Plan p = read_plan(plan);
  if (plan != nullptr && !plan_ok(p, landing, out))
    return (int)cudaErrorInvalidValue;
  return (int)launch(peer_wait_kernel, (int)p.blocks,
                     plan == nullptr ? 1 : kThreads, ring_bytes(p),
                     static_cast<cudaStream_t>(stream),
                     static_cast<u64*>(f0), v0, static_cast<u64*>(f1), v1,
                     static_cast<const u64*>(ready), epoch, landing, out, p,
                     timeout_ns);
}
