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
//     copy src -> peer landing        grid-stride, 16-byte vectors where
//                                     both pointers allow, bytes at the tail
//     __threadfence_system; the last block to finish (a done counter)
//     st.release.sys ready = epoch    in the receiver's arena
//   receiver (peer_wait):
//     wait until ready >= epoch       (ld.acquire.sys spin)
//     copy landing -> out             (optional: peer_shift copies out)
//     st.release.sys ack = epoch      in the sender's arena (optional)
//
// This is the handshake of the reference's `push_pull_halos_1d`
// (apex/contrib/csrc/peer_memory/peer_memory_cuda.cu): without the ack a
// fast rank would overwrite a landing buffer its slower neighbour has not
// read yet. Every spin is bounded by %globaltimer and ends in __trap(), so
// a signal that never comes is a CUDA error on the stream, never a hang.
//
// Contexts of separate processes on one card are time-sliced (no MPS is
// assumed): a spinning wait holds its time slice until it is preempted,
// so the waits live in these short kernels and never inside a compute
// kernel.
//
// What bounds it on this card: memory bytes. A put reads the source once
// and writes the landing buffer once, both in the one HBM (3.35 TB/s),
// so its least time is 2 * bytes / 3.35 TB/s; the copy-out of peer_wait
// costs the same again. The flag handshakes add a context switch each
// when the peer is another process.
//
// What the design does about that: one pass of 16-byte accesses over all
// SMs (at most 4 blocks of 256 threads on each), no staging; the signal
// rides the last block of the copy, so a put is one launch.
//
// C interface (bound with ctypes): pointers and the stream are `void*`;
// every function returns a cudaError_t (cudaGetLastError() after a launch).

#include <cstdio>

#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 4;

__device__ __forceinline__ u64 ld_acquire_sys(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 of the block spins until *flag >= want (acquire, system
// scope); the barrier then orders every thread's later reads after that
// acquire (the causality chain release -> acquire -> bar.sync). want == 0
// never waits. Past timeout_ns: __trap().
__device__ void wait_at_least(const u64* flag, u64 want, u64 timeout_ns,
                              const char* what) {
  if (want == 0) return;
  if (threadIdx.x == 0) {
    const u64 t0 = global_ns();
    while (ld_acquire_sys(flag) < want) {
      if (global_ns() - t0 > timeout_ns) {
        printf("apex_tpu_torch remote_copy: %s flag %p stayed at %llu < "
               "%llu for %llu ns; trapping\n",
               what, (const void*)flag, ld_acquire_sys(flag), want,
               timeout_ns);
        __trap();
      }
      __nanosleep(200);
    }
  }
  __syncthreads();
}

// dst[0:nbytes) = src[0:nbytes) over the whole grid: words of V where both
// pointers are aligned to V, then the tail bytes.
template <typename V>
__device__ void copy_as(const char* __restrict__ src, char* __restrict__ dst,
                        long long nbytes) {
  const long long nw = nbytes / (long long)sizeof(V);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  for (long long i = t; i < nw; i += stride) d[i] = s[i];
  for (long long i = nw * (long long)sizeof(V) + t; i < nbytes; i += stride)
    dst[i] = src[i];
}

__device__ void copy_bytes(const void* src, void* dst, long long nbytes) {
  if (nbytes <= 0) return;
  const u64 a = reinterpret_cast<u64>(src) | reinterpret_cast<u64>(dst);
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if (a % 16 == 0)
    copy_as<uint4>(s, d, nbytes);
  else if (a % 8 == 0)
    copy_as<uint2>(s, d, nbytes);
  else if (a % 4 == 0)
    copy_as<unsigned>(s, d, nbytes);
  else
    copy_as<char>(s, d, nbytes);
}

// Called by every thread after its stores (or reads) are done: the
// barrier gathers the block's accesses under thread 0, whose system fence
// orders them before its count (the pattern of a cooperative grid sync);
// the last block to count releases `value` into each non-null flag, then
// resets the done counter for the next launch on the stream. One fence a
// block, not one a thread.
__device__ void publish(unsigned* counter, u64* f0, u64* f1, u64 value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    const unsigned done = atomicAdd(counter, 1u);
    if (done == gridDim.x - 1) {
      __threadfence_system();
      if (f0 != nullptr) st_release_sys(f0, value);
      if (f1 != nullptr) st_release_sys(f1, value);
      atomicExch(counter, 0u);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
peer_put_kernel(const void* src, void* dst, long long nbytes,
                const u64* ack, u64 ack_need, u64* ready, u64 epoch,
                unsigned* counter, u64 timeout_ns) {
  wait_at_least(ack, ack_need, timeout_ns, "peer_put ack");
  copy_bytes(src, dst, nbytes);
  publish(counter, ready, nullptr, epoch);
}

// One launch sends both edges: src_lo -> dst_lo (the left rank's `hi`
// landing buffer) and src_hi -> dst_hi (the right rank's `lo`). Each block
// first releases this rank's acks of the previous exchange (it has used
// what landed then: every kernel before this one on the stream is done),
// then waits for the neighbours' acks of this rank's previous puts.
__global__ void __launch_bounds__(kThreads)
halo_put_kernel(const void* src_lo, void* dst_lo, const void* src_hi,
                void* dst_hi, long long nbytes, u64* ack_out_left,
                u64* ack_out_right, const u64* ack_in_left,
                const u64* ack_in_right, u64 prev, u64* ready_left,
                u64* ready_right, u64 epoch, unsigned* counter,
                u64 timeout_ns) {
  if (threadIdx.x == 0 && prev > 0) {
    st_release_sys(ack_out_left, prev);
    st_release_sys(ack_out_right, prev);
  }
  wait_at_least(ack_in_left, prev, timeout_ns, "halo_put left ack");
  wait_at_least(ack_in_right, prev, timeout_ns, "halo_put right ack");
  copy_bytes(src_lo, dst_lo, nbytes);
  copy_bytes(src_hi, dst_hi, nbytes);
  publish(counter, ready_left, ready_right, epoch);
}

__global__ void __launch_bounds__(kThreads)
peer_wait_kernel(const u64* ready, u64 epoch, const void* landing,
                 void* out, long long nbytes, u64* ack, unsigned* counter,
                 u64 timeout_ns) {
  wait_at_least(ready, epoch, timeout_ns, "peer_wait ready");
  copy_bytes(landing, out, nbytes);
  if (ack != nullptr) publish(counter, ack, nullptr, epoch);
}

int copy_blocks(long long nbytes) {
  const long long words = (nbytes + 15) / 16;
  const long long b = (words + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
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

// src (local) -> dst (a peer's landing buffer), nbytes of any alignment,
// after *ack >= ack_need; then *ready = epoch (ready in the peer's arena).
// counter: a local unsigned, 0 between launches.
extern "C" int apex_peer_put(const void* src, void* dst, long long nbytes,
                             const void* ack, u64 ack_need, void* ready,
                             u64 epoch, void* counter, u64 timeout_ns,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  peer_put_kernel<<<copy_blocks(nbytes), kThreads, 0, st>>>(
      src, dst, nbytes, static_cast<const u64*>(ack), ack_need,
      static_cast<u64*>(ready), epoch, static_cast<unsigned*>(counter),
      timeout_ns);
  return (int)cudaGetLastError();
}

// Both halo edges in one launch (see halo_put_kernel); nbytes each.
extern "C" int apex_halo_put(const void* src_lo, void* dst_lo,
                             const void* src_hi, void* dst_hi,
                             long long nbytes, void* ack_out_left,
                             void* ack_out_right, const void* ack_in_left,
                             const void* ack_in_right, u64 prev,
                             void* ready_left, void* ready_right, u64 epoch,
                             void* counter, u64 timeout_ns, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  halo_put_kernel<<<copy_blocks(nbytes), kThreads, 0, st>>>(
      src_lo, dst_lo, src_hi, dst_hi, nbytes,
      static_cast<u64*>(ack_out_left), static_cast<u64*>(ack_out_right),
      static_cast<const u64*>(ack_in_left),
      static_cast<const u64*>(ack_in_right), prev,
      static_cast<u64*>(ready_left), static_cast<u64*>(ready_right), epoch,
      static_cast<unsigned*>(counter), timeout_ns);
  return (int)cudaGetLastError();
}

// Waits until *ready >= epoch; then, with nbytes > 0, copies the landing
// buffer to out; then, with a non-null ack (in the sender's arena),
// *ack = epoch. Without a copy or an ack it is one thread.
extern "C" int apex_peer_wait(const void* ready, u64 epoch,
                              const void* landing, void* out,
                              long long nbytes, void* ack, void* counter,
                              u64 timeout_ns, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool alone = nbytes <= 0 && ack == nullptr;
  peer_wait_kernel<<<alone ? 1 : copy_blocks(nbytes), alone ? 1 : kThreads,
                     0, st>>>(static_cast<const u64*>(ready), epoch, landing,
                              out, nbytes, static_cast<u64*>(ack),
                              static_cast<unsigned*>(counter), timeout_ns);
  return (int)cudaGetLastError();
}
