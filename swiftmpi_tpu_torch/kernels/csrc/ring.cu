// Ring exchange between n ranks: all_to_all(x, axis, 0, 0, tiled=True).
// Block j of rank r's result is block r of rank j's operand.
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_ring.py ring_exchange
// (_ring_kernel): a local copy plus n-1 remote DMA copies, all started
// before any is waited on, each with its own send/recv semaphore.  Here a
// rank is given raw pointers to every rank's output buffer and flag array
// (its peers may share its card or sit behind a peer mapping), and the
// exchange is two kernels per rank, the start()/wait() split of the Pallas
// kernel:
//
//   ring_send  never waits.  Thread blocks (s, b) copy block (me+s)%n of the
//              operand into slot `me` of rank (me+s)%n's output; s = 0 is the
//              local block.  The last thread block of a step to finish
//              publishes the step's flag at the receiver: a system-scope
//              fence, then a release store of the exchange's epoch into
//              flags[receiver][me].  Epochs only grow, so no flag is ever
//              reset.
//   ring_wait  one thread per peer spins (acquire loads, system scope) until
//              flags[me][j] >= epoch.  It is enqueued only after all n sends
//              are enqueued, so a waiter can never hold the card against a
//              sender that is not scheduled yet: on one stream the flags are
//              already set, on n streams or n cards the waiter really waits.
//              The waits of the ranks that share a card go in one launch,
//              one thread block per rank.  A waiter that polls too long
//              counts a timeout in flags[me][n] and returns instead of
//              hanging the card.
//
// Bound: bytes — every operand byte read once and written once, over
// 3.35 TB/s.  Design: plain coalesced copies, 16 bytes a thread when source,
// destination and block size are 16-byte aligned (four loads in flight per
// thread), 4 bytes a thread otherwise (odd row widths and odd C).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

template <typename T>
__device__ __forceinline__ void copy_block(const T* __restrict__ src,
                                           T* __restrict__ dst, long long n,
                                           long long tid, long long nthr) {
  long long i = tid;
  // four independent loads in flight per thread
  for (; i + 3 * nthr < n; i += 4 * nthr) {
    T a = src[i], b = src[i + nthr], c = src[i + 2 * nthr],
      d = src[i + 3 * nthr];
    dst[i] = a;
    dst[i + nthr] = b;
    dst[i + 2 * nthr] = c;
    dst[i + 3 * nthr] = d;
  }
  for (; i < n; i += nthr) dst[i] = src[i];
}

__global__ void ring_send(int me, int n, long long block_bytes,
                          const char* __restrict__ x, char* const* outs,
                          unsigned long long* const* flags,
                          unsigned int* done, unsigned long long epoch) {
  const int s = blockIdx.y;
  const int dst_rank = (me + s) % n;
  const char* src = x + (long long)dst_rank * block_bytes;
  char* dst = outs[dst_rank] + (long long)me * block_bytes;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthr = (long long)gridDim.x * blockDim.x;
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(block_bytes);
  if ((align & 15) == 0) {
    copy_block(reinterpret_cast<const int4*>(src),
               reinterpret_cast<int4*>(dst), block_bytes >> 4, tid, nthr);
  } else {
    copy_block(reinterpret_cast<const int*>(src),
               reinterpret_cast<int*>(dst), block_bytes >> 2, tid, nthr);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // this block's stores before its arrival.  Card scope is enough here:
    // the last arriver's system-scope fence below is cumulative over what
    // it observed through the arrival counter.
    __threadfence();
    const unsigned int arrived = atomicAdd(&done[s], 1u);
    if (arrived == gridDim.x - 1) {
      done[s] = 0;           // the next send of this rank starts from zero
      __threadfence_system();  // every block's stores before the flag
      st_release_sys(flags[dst_rank] + me, epoch);
    }
  }
}

__global__ void ring_wait(int n, unsigned long long* const* rank_flags,
                          unsigned long long epoch, long long max_polls) {
  unsigned long long* flags = rank_flags[blockIdx.x];
  const int j = threadIdx.x;
  if (j >= n) return;
  long long polls = 0;
  while (ld_acquire_sys(flags + j) < epoch) {
    __nanosleep(100);
    if (++polls > max_polls) {
      atomicAdd(flags + n, 1ULL);
      return;
    }
  }
}

}  // namespace

// One rank's sends.  `outs` and `flags` are device arrays of n pointers (the
// n ranks' output buffers and flag arrays); `done` is this rank's n arrival
// counters, zero before the first send.  The block size must be a multiple
// of 4 bytes and the buffers 4-byte aligned.
extern "C" int smtpu_ring_send(int me, int n, long long block_bytes,
                               const void* x, const void* outs,
                               const void* flags, void* done,
                               unsigned long long epoch, int blocks_per_step,
                               void* stream) {
  if (n <= 0 || block_bytes <= 0) return 0;
  dim3 grid((unsigned)blocks_per_step, (unsigned)n);
  ring_send<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      me, n, block_bytes, static_cast<const char*>(x),
      static_cast<char* const*>(outs),
      static_cast<unsigned long long* const*>(flags),
      static_cast<unsigned int*>(done), epoch);
  return static_cast<int>(cudaGetLastError());
}

// The waits of `ranks` ranks of one card: returns once all n flags of each
// reached `epoch`.  `rank_flags` is a device array of those ranks' flag
// arrays (n + 1 counters each, the last counts timeouts).
extern "C" int smtpu_ring_wait(int n, int ranks, const void* rank_flags,
                               unsigned long long epoch, long long max_polls,
                               void* stream) {
  if (n <= 0 || ranks <= 0) return 0;
  if (n > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((n + 31) / 32) * 32;
  ring_wait<<<ranks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<unsigned long long* const*>(rank_flags), epoch,
      max_polls);
  return static_cast<int>(cudaGetLastError());
}
