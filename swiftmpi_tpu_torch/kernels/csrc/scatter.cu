// Masked scatter-add of R ranks at once, with the per-slot counts in the
// same launch:
//   acc[r][s] += grads[r][i]   and   counts[r][s] += 1
// for every row i of rank r with valid[r][i] and 0 <= s = slots[r][i] < cap;
// other rows are skipped.  acc is a (R, cap, w) tensor, counts a (R, cap)
// tensor or null; the caller allocates both, zeroed for a plain sum, or
// holding earlier launches' sums to add to.
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_scatter.py
// (vmem_scatter_add / masked_vmem_scatter_add), the drop-in body of the
// dense push's transfer/xla.py _push_dense._scatter, which sums into a
// (cap + 1, w) accumulator whose dump row cap takes invalid and
// out-of-range rows and is sliced away.  Here those rows are skipped (a
// stencil push is mostly padding, and their atomics would all contend for
// the dump row).  The TPU kernel runs its grid in order, so duplicates are
// summed by sequential read-modify-write of a VMEM-resident accumulator.
// Hopper blocks run in no order, so duplicates meet in float reductions at
// L2 instead: the summation order is not fixed and results are held to a
// tolerance, not to bits.  Counts are sums of 1.0 below 2^24: exact.
//
// Bound: bytes — slots, valid and the landing grads read once, the
// accumulator and counts written once, over 3.35 TB/s.
//
// Design.  What bounds this kernel is not bytes but hot slots: the word2vec
// h push's targets follow the unigram^0.75 law, so a hot word's row takes
// thousands of reductions, serialized at its L2 slice whatever their width.
// So rows are merged before they reach L2:
//   w <= 4   (the count families) one thread a row, scalar reductions.
//   w > 4    a thread block takes 128 rows of one rank at a time, files each
//            landing row under its slot in a shared-memory hash table (a
//            list per distinct slot), then its warps walk the lists, two
//            rows in flight: each distinct slot of the tile gets one
//            reduction per element and one count.  Where w % 4 == 0 and the
//            grads and the accumulator are 16-byte aligned (w = 100:
//            400-byte rows) a lane adds a float4 with one vector reduction
//            (red.global.add.v4.f32, sm_90); other widths (w = 101) add one
//            float per lane.
// The rank is blockIdx.y, so no row index is divided.  apps/scatter_sweep.py
// times the kernel at the word2vec shapes; PERF.md has the forms that were
// tried (a warp a row, a warp merge with __match_any_sync, a 512-row tile)
// and why this one was kept.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One rank of the launch: blockIdx.y picks it, so no row index is divided.
struct Scatter {
  const int* slots;       // (R, n)
  const uint8_t* valid;   // (R, n)
  const float* grads;     // (R, n, w)
  float* acc;             // (R, cap, w)
  float* counts;          // (R, cap) or null
  long long rows;         // n: the rows of one rank
  int w;
  long long cap;

  // the launch's view of rank blockIdx.y: its rows, sums and counts
  __device__ __forceinline__ Scatter rank() const {
    Scatter r = *this;
    const long long k = blockIdx.y;
    r.slots += k * rows;
    r.valid += k * rows;
    r.grads += k * rows * w;
    r.acc += k * cap * w;
    if (counts) r.counts += k * cap;
    return r;
  }
};

// the accumulator row a grad row lands in, or -1 where it is skipped
__device__ __forceinline__ long long target(const Scatter& a, long long row) {
  const long long s = a.slots[row];
  if (!a.valid[row] || s < 0 || s >= a.cap) return -1;
  return s;
}

__device__ __forceinline__ void red_v4(float* dst, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(dst), v);
}

__device__ __forceinline__ void add4(float4& s, float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

__global__ void __launch_bounds__(kThreads) scatter_narrow(const Scatter all) {
  const Scatter a = all.rank();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
       row < a.rows; row += stride) {
    const long long t = target(a, row);
    if (t < 0) continue;
    for (int c = 0; c < a.w; ++c)
      atomicAdd(a.acc + t * a.w + c, a.grads[row * a.w + c]);
    if (a.counts) atomicAdd(a.counts + t, 1.0f);
  }
}

// The tile merge (see the top of the file).  Slots are 32-bit keys here
// (cap < 2^31).
constexpr int kTile = 128;
constexpr int kHash = 2 * kTile;
constexpr unsigned kEmpty = 0xffffffffu;
static_assert(kHash == 1 << 8, "the hash takes the top 8 bits");

template <bool kVec>
__global__ void __launch_bounds__(kThreads) scatter_tile(const Scatter all) {
  const Scatter a = all.rank();
  __shared__ unsigned keys[kHash];
  __shared__ int head[kHash];
  __shared__ int next[kTile];
  __shared__ int uniq[kTile];
  __shared__ int n_uniq;
  for (int h = threadIdx.x; h < kHash; h += kThreads) {
    keys[h] = kEmpty;
    head[h] = -1;
  }
  if (threadIdx.x == 0) n_uniq = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long base = (long long)blockIdx.x * kTile; base < a.rows;
       base += (long long)gridDim.x * kTile) {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const long long row = base + i;
      const long long t = row < a.rows ? target(a, row) : -1;
      if (t < 0) continue;
      const unsigned key = (unsigned)t;
      unsigned h = (key * 2654435761u) >> 24;   // top 8 bits: kHash
      while (true) {
        const unsigned prev = atomicCAS(keys + h, kEmpty, key);
        if (prev == kEmpty) {        // a new target of this tile
          uniq[atomicAdd(&n_uniq, 1)] = (int)h;
          break;
        }
        if (prev == key) break;
        h = (h + 1) & (kHash - 1);
      }
      next[i] = atomicExch(head + h, i);   // push the row on h's list
    }
    __syncthreads();
    const float* g = a.grads + base * a.w;
    for (int u = warp; u < n_uniq; u += kWarps) {
      const int h = uniq[u];
      float* dst = a.acc + (long long)keys[h] * a.w;
      const int first = head[h];
      if (kVec) {
        const float4* g4 = reinterpret_cast<const float4*>(g);
        const int w4 = a.w / 4;
        for (int c = lane; c < w4; c += 32) {
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int i = first; i >= 0;) {
            const int j = next[i];
            const float4 v0 = g4[i * w4 + c];
            if (j < 0) {
              add4(s, v0);
              break;
            }
            const float4 v1 = g4[j * w4 + c];
            add4(s, v0);
            add4(s, v1);
            i = next[j];
          }
          red_v4(dst + 4 * c, s);
        }
      } else {
        for (int c = lane; c < a.w; c += 32) {
          float s = 0.f;
          for (int i = first; i >= 0;) {
            const int j = next[i];
            const float v0 = g[(long long)i * a.w + c];
            if (j < 0) {
              s += v0;
              break;
            }
            const float v1 = g[(long long)j * a.w + c];
            s += v0;
            s += v1;
            i = next[j];
          }
          atomicAdd(dst + c, s);
        }
      }
      if (a.counts && lane == 0) {
        int count = 0;
        for (int i = first; i >= 0; i = next[i]) ++count;
        atomicAdd(a.counts + keys[h], (float)count);
      }
    }
    __syncthreads();
    for (int u = threadIdx.x; u < n_uniq; u += kThreads) {
      keys[uniq[u]] = kEmpty;
      head[uniq[u]] = -1;
    }
    __syncthreads();
    if (threadIdx.x == 0) n_uniq = 0;
    __syncthreads();
  }
}

}  // namespace

// `ranks` ranks of n rows each: slots int32 (ranks, n), valid uint8
// (ranks, n), grads float32 (ranks, n, w) contiguous; acc float32
// (ranks, cap, w) and counts float32 (ranks, cap) (or null), added to.
extern "C" int smtpu_masked_scatter_add_f32(
    const void* slots, const void* valid, const void* grads, void* acc,
    void* counts, long long ranks, long long n, int w, long long cap,
    void* stream) {
  if (ranks <= 0 || n <= 0) return 0;
  if (ranks > 65535 || cap >= (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Scatter a;
  a.slots = static_cast<const int*>(slots);
  a.valid = static_cast<const uint8_t*>(valid);
  a.grads = static_cast<const float*>(grads);
  a.acc = static_cast<float*>(acc);
  a.counts = static_cast<float*>(counts);
  a.rows = n;
  a.w = w;
  a.cap = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_block = w <= 4 ? kThreads : kTile;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  const dim3 g((unsigned)blocks, (unsigned)ranks);
  if (w <= 4) {
    scatter_narrow<<<g, kThreads, 0, s>>>(a);
  } else if (w % 4 == 0 && ((reinterpret_cast<uintptr_t>(grads) |
                             reinterpret_cast<uintptr_t>(acc)) & 15) == 0) {
    scatter_tile<true><<<g, kThreads, 0, s>>>(a);
  } else {
    scatter_tile<false><<<g, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
