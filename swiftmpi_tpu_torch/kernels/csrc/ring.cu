// Ring exchange between n ranks: all_to_all(x, axis, 0, 0, tiled=True).
// Block j of rank r's result is block r of rank j's operand.
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_ring.py ring_exchange
// (_ring_kernel): a local copy plus n-1 remote DMA copies, all started
// before any is waited on, each with its own send/recv semaphore.  Here the
// exchange is two kernels per card, the start()/wait() split of the Pallas
// kernel:
//
//   ring_send  one launch sends for every rank of the card.  Its work items
//              are (sender, step s, chunk): sender `me` copies block
//              (me+s)%n of its operand into slot `me` of rank (me+s)%n's
//              output; s = 0 is the local block.  A grid of a few thread
//              blocks per SM walks the items.  Each (sender, step) has an
//              arrival counter; the thread block that finishes its last
//              chunk publishes the step's flag at the receiver: a
//              system-scope fence, then a release store of the exchange's
//              epoch into flags[receiver][me].  Epochs only grow, so no flag
//              is ever reset.  The kernel never waits.
//   ring_wait  one thread per peer spins (acquire loads, system scope) until
//              flags[me][j] >= epoch.  It is enqueued after the card's send
//              launch, so a waiter never holds the card against a sender of
//              its own that is not scheduled yet: on one card the flags are
//              already set, across peer-mapped cards the waiter really
//              waits.  One launch for the ranks of a card, one thread block
//              per rank.  One C call enqueues both launches.  A waiter
//              that polls too long counts a timeout in flags[me][n] and
//              returns instead of hanging the card.
//
// Operands are given as base + stride (sender i's operand at x + i*x_stride,
// each operand contiguous), so the transfer hands the kernel one (R, n, ...)
// tensor and nothing is uploaded per call.  Outputs likewise (rank r's at
// out + r*out_stride) on one card, or through a device array of the ranks'
// output pointers, peer pointers included, across cards.
//
// Bound: bytes, every operand byte read once and written once, over
// 3.35 TB/s.  Copies are shaped for Hopper.  Every (sender, step) block is
// split into a head of up to three 4-byte words that brings the destination
// to a 16-byte boundary, a body of 16-byte chunks and a tail of up to three
// words.  Where source and destination share their alignment mod 16, the
// Tensor Memory Accelerator copies the body: one thread streams it through
// a ring of kStages shared-memory stages with cp.async.bulk (global ->
// shared, completed on an mbarrier; then shared -> global, a bulk group)
// while the other threads copy head and tail.  Where they do not (the
// int32 request buckets: C*4 = 4 mod 16), every thread keeps 16-byte loads
// in flight, aligned to the source, and cuts each 16-byte store to the
// destination from two of them in registers (the second is the neighbour's
// first, an L1 hit).  TMA bodies read 4% faster than 16-byte vector copies
// of the same bodies on the H100 (PERF.md, apps/ring_sweep.py); the card's
// copy ceiling, not the kernel, bounds both.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;        // 16-byte loads in flight a thread
constexpr long long kMaxItemBytes = 64 << 10;
constexpr long long kMinItemBytes = 16 << 10;
constexpr int kStages = 4;
constexpr int kStageBytes = 16 << 10;
constexpr int kSmem = kStages * kStageBytes;
constexpr int kBlocksPerSM = 3;   // what the shared-memory ring allows

struct Send {
  int n;                          // ranks in the exchange
  int first, step;                // sender i of this launch: rank first+i*step
  long long words;                // 4-byte words of one (C, ...) block
  const char* x;                  // sender i's operand at x + i*x_stride
  long long x_stride;
  char* out;                      // rank r's result at out + r*out_stride,
  long long out_stride;           // unless `outs` is given:
  char* const* outs;              // device array of the n ranks' results
  unsigned long long* const* flags;  // device array of the n flag arrays
  unsigned int* done;             // one arrival counter per (sender, step)
  unsigned long long epoch;
  int items;                      // work items per (sender, step)
  long long pairs;                // senders * n
};

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

// One (sender, step) block: where it comes from and goes to, cut into head
// words, 16-byte body chunks and tail words.
struct Pair {
  const char* src;
  char* dst;
  int me, to;
  int head;         // words copied one by one before the body
  long long body;   // 16-byte chunks, destination aligned
  int tail;         // words after the body
  int shift;        // (source of the body mod 16) / 4: 0 = aligned alike
};

__device__ __forceinline__ Pair pair_of(const Send& a, long long p) {
  Pair q;
  const int i = (int)(p / a.n), s = (int)(p % a.n);
  q.me = a.first + i * a.step;
  q.to = (q.me + s) % a.n;
  const long long bytes = a.words * 4;
  q.src = a.x + i * a.x_stride + q.to * bytes;
  q.dst = (a.outs ? a.outs[q.to] : a.out + q.to * a.out_stride) +
          (long long)q.me * bytes;
  const int head =
      (int)(((16 - (reinterpret_cast<uintptr_t>(q.dst) & 15)) & 15) >> 2);
  q.head = (int)(head < a.words ? head : a.words);
  q.body = (a.words - q.head) >> 2;
  q.tail = (int)((a.words - q.head) & 3);
  q.shift = (int)((reinterpret_cast<uintptr_t>(q.src + 4 * q.head) & 15) >> 2);
  return q;
}

__device__ __forceinline__ int4 ld_nc(const int4* p) { return __ldg(p); }

// words shift .. shift+3 of the eight words a, b
__device__ __forceinline__ int4 cut(int4 a, int4 b, int shift) {
  if (shift == 1) return make_int4(a.y, a.z, a.w, b.x);
  if (shift == 2) return make_int4(a.z, a.w, b.x, b.y);
  return make_int4(a.w, b.x, b.y, b.z);
}

// body chunks [lo, hi) of a q whose source and destination differ mod 16:
// aligned source loads, 16-byte stores cut from two of them
__device__ __forceinline__ void copy_shifted(const Pair& q, long long lo,
                                             long long hi) {
  int4* d4 = reinterpret_cast<int4*>(q.dst + 4 * q.head);
  // chunk j of the body starts inside sa[j]
  const int4* sa = reinterpret_cast<const int4*>(q.src + 4 * q.head -
                                                 4 * q.shift);
  constexpr int kU = kUnroll / 2;
  for (long long b = lo + threadIdx.x; b < hi; b += kU * kThreads) {
    int4 v0[kU], v1[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (b + u * kThreads < hi) {
        v0[u] = ld_nc(sa + b + u * kThreads);
        v1[u] = ld_nc(sa + b + u * kThreads + 1);
      }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (b + u * kThreads < hi)
        d4[b + u * kThreads] = cut(v0[u], v1[u], q.shift);
  }
}

// the head (item 0) and tail (last item) words of q
__device__ __forceinline__ void copy_edges(const Send& a, const Pair& q,
                                           int chunk) {
  const int* s = reinterpret_cast<const int*>(q.src);
  int* d = reinterpret_cast<int*>(q.dst);
  if (chunk == 0 && (int)threadIdx.x < q.head) d[threadIdx.x] = s[threadIdx.x];
  if (chunk == a.items - 1 && (int)threadIdx.x < q.tail) {
    const long long w = q.head + 4 * q.body + threadIdx.x;
    d[w] = s[w];
  }
}

// body chunks [lo, hi) of item `chunk` out of `body` chunks
__device__ __forceinline__ void item_range(long long body, int items,
                                           int chunk, long long* lo,
                                           long long* hi) {
  const long long per = (body + items - 1) / items;
  const long long l = per * chunk;
  *lo = l < body ? l : body;
  *hi = l + per < body ? l + per : body;
}

// after the thread block's stores of an item of pair p: count the item and,
// for the last one of the pair, publish its flag at the receiver
__device__ __forceinline__ void arrive(const Send& a, const Pair& q,
                                       long long p) {
  __syncthreads();
  if (threadIdx.x == 0) {
    // this block's stores before its arrival.  Card scope is enough here:
    // the last arriver's system-scope fence below is cumulative over what
    // it observed through the arrival counter.
    __threadfence();
    const unsigned int arrived = atomicAdd(a.done + p, 1u);
    if (arrived == (unsigned)a.items - 1) {
      a.done[p] = 0;            // the next exchange starts from zero
      __threadfence_system();   // every block's stores before the flag
      st_release_sys(a.flags[q.to] + q.me, a.epoch);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(ready) : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) ring_send(const Send a) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) unsigned long long bars[kStages];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(bars + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  uint32_t loaded = 0;   // chunks thread 0 has loaded: stage and parity
  const long long total = a.pairs * a.items;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    const long long p = it / a.items;
    const int chunk = (int)(it % a.items);
    const Pair q = pair_of(a, p);
    long long lo, hi;
    item_range(q.body, a.items, chunk, &lo, &hi);
    copy_edges(a, q, chunk);
    if (q.shift != 0) {
      copy_shifted(q, lo, hi);
    } else if (threadIdx.x == 0 && hi > lo) {
      const char* src = q.src + 4 * q.head + 16 * lo;
      char* dst = q.dst + 4 * q.head + 16 * lo;
      const long long bytes = 16 * (hi - lo);
      const long long n = (bytes + kStageBytes - 1) / kStageBytes;
      auto len = [&](long long c) {
        const long long rest = bytes - c * kStageBytes;
        return (uint32_t)(rest < kStageBytes ? rest : kStageBytes);
      };
      auto load = [&](long long c) {
        const uint32_t s = (loaded + (uint32_t)c) % kStages;
        bulk_load(smem_addr(stage + s * kStageBytes), src + c * kStageBytes,
                  len(c), smem_addr(bars + s));
      };
      for (long long c = 0; c < n && c < kStages; ++c) load(c);
      for (long long c = 0; c < n; ++c) {
        const uint32_t g = loaded + (uint32_t)c;
        const uint32_t s = g % kStages;
        bar_wait(smem_addr(bars + s), (g / kStages) & 1);
        bulk_store(dst + c * kStageBytes, smem_addr(stage + s * kStageBytes),
                   len(c));
        if (c + kStages < n) {
          // the stage is loaded again once its store has read it
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          load(c + kStages);
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
      asm volatile("fence.proxy.async.global;" ::: "memory");
      loaded += (uint32_t)n;
    }
    arrive(a, q, p);
  }
}

__global__ void ring_wait(int n, int first, int step,
                          unsigned long long* const* rank_flags,
                          unsigned long long epoch, long long max_polls) {
  unsigned long long* flags = rank_flags[first + blockIdx.x * step];
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

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

}  // namespace

// One exchange's launches on one card: the sends of its `senders` ranks in
// one launch, then their waits in another.  Sender i is rank first + i*step;
// its (n, C, ...) operand is contiguous at x + i*x_stride.  Rank r's
// (n, C, ...) result is at out + r*out_stride, or at outs[r] when `outs` (a
// device array of n pointers) is not null.  `flags` is a device array of the
// n ranks' flag arrays (n + 1 counters each, the last counts timeouts);
// `done` holds senders*n arrival counters, zero before the first send.
// Block sizes and buffers are multiples of 4 bytes.  The wait follows this
// card's sends on this card's stream, so it never holds a sender of its own
// card; across cards each card's stream runs its own sends whatever the
// other cards' waits do.
extern "C" int smtpu_ring_exchange(int n, int senders, int first, int step,
                                   long long block_bytes, const void* x,
                                   long long x_stride, void* out,
                                   long long out_stride, const void* outs,
                                   const void* flags, void* done,
                                   unsigned long long epoch,
                                   long long max_polls, void* stream) {
  if (n <= 0 || senders <= 0 || block_bytes <= 0) return 0;
  if (block_bytes % 4 || n > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  Send a;
  a.n = n;
  a.first = first;
  a.step = step;
  a.words = block_bytes / 4;
  a.x = static_cast<const char*>(x);
  a.x_stride = x_stride;
  a.out = static_cast<char*>(out);
  a.out_stride = out_stride;
  a.outs = static_cast<char* const*>(outs);
  a.flags = static_cast<unsigned long long* const*>(flags);
  a.done = static_cast<unsigned int*>(done);
  a.epoch = epoch;
  a.pairs = (long long)senders * n;
  const long long wave = (long long)sm_count() * kBlocksPerSM;
  // items of at most kMaxItemBytes, and enough of them to fill one wave of
  // thread blocks where the blocks are small (down to kMinItemBytes)
  long long items = (block_bytes + kMaxItemBytes - 1) / kMaxItemBytes;
  long long fill = (wave + a.pairs - 1) / a.pairs;
  const long long finest = block_bytes / kMinItemBytes;
  if (fill > finest) fill = finest;
  if (items < fill) items = fill;
  if (items < 1) items = 1;
  a.items = (int)items;
  long long grid = a.pairs * items;
  if (grid > wave) grid = wave;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        ring_send, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ring_send<<<(unsigned)grid, kThreads, kSmem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ring_wait<<<senders, ((n + 31) / 32) * 32, 0, s>>>(
      n, first, step, a.flags, epoch, max_polls);
  return static_cast<int>(cudaGetLastError());
}
