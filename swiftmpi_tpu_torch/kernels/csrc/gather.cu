// Masked row gather, rank by rank:
//   out[r, i] = valid[r, i] ? table[r, clip(slots[r, i], 0, cap-1)] : 0,
// for float32 or bfloat16 rows: the bits are moved, never converted.
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_gather.py
// (vmem_gather / masked_vmem_gather), the drop-in body of the pull path's
// transfer/xla.py _masked_gather and of the owners' gather of
// transfer/tpu.py.  The TPU kernel stages the whole table in VMEM; on
// Hopper the 50 MB L2 already holds the hot rows, so the kernel is a row
// copy.  Bound: bytes — each distinct valid row read once plus every
// output row written once, over 3.35 TB/s (half the bytes for bfloat16).
//
// The rank is blockIdx.y: the ranks that share a card (their table shards
// one (R, cap, d) block, passed as base + rank stride) gather in one
// launch, with no division of a row index by the rank count.
//
// Design of the vector form (d % 4 == 0, rows aligned to a group of four
// elements: 16 bytes of float32, 8 of bfloat16, because a 200-byte
// bfloat16 row is not 16-byte aligned): a warp takes a group of G rows
// (G * d/4 <= 128 four-element chunks, so G = 5 at d = 100).  Lanes
// 0..G-1 load the group's slots and valid flags in one coalesced load and
// hand them out with shuffles; then every lane issues the loads of all its
// chunks (up to 4) before any store, so the warp waits on the index->row
// dependency once per group, not once per row, and all 32 lanes move
// data.  Table rows are read with an L2 evict-last policy and output rows
// written with streaming stores, so the output, which nothing reads again
// in this kernel, does not push the table out of L2.  Invalid rows store
// zeros without reading.  Widths that are no multiple of 4, and unaligned
// rows, take the scalar form: a warp a row, lanes along d, one element a
// lane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// float4 chunks a lane has in flight in the group form
constexpr int kPerLane = 4;

__device__ __forceinline__ long long clip_slot(int s, long long cap) {
  long long v = s;
  return v < 0 ? 0 : (v >= cap ? cap - 1 : v);
}

// V: four elements, float4 (float32) or uint2 (bfloat16)
__device__ __forceinline__ float4 ld_evict_last(const float4* p,
                                                uint64_t policy) {
  float4 v;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ uint2 ld_evict_last(const uint2* p,
                                               uint64_t policy) {
  uint2 v;
  asm volatile("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p), "l"(policy));
  return v;
}

template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ uint2 vzero<uint2>() {
  return make_uint2(0u, 0u);
}

// A warp a row, lanes along d: the scalar form, for widths that are no
// multiple of 4 and for unaligned rows.  T: float, or unsigned short for
// bfloat16's bits.
template <typename T>
__global__ void masked_gather_scalar(const T* __restrict__ table,
                                     long long rank_stride,
                                     const int* __restrict__ slots,
                                     const uint8_t* __restrict__ valid,
                                     T* __restrict__ out, long long n,
                                     int d, long long cap) {
  const int rank = blockIdx.y;
  table += rank * rank_stride;
  slots += rank * n;
  valid += rank * n;
  out += rank * n * d;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < n; row += stride) {
    T* dst = out + row * d;
    if (!valid[row]) {
      for (int c = lane; c < d; c += 32) dst[c] = T(0);
      continue;
    }
    const T* src = table + clip_slot(slots[row], cap) * d;
    for (int c = lane; c < d; c += 32) dst[c] = __ldg(src + c);
  }
}

// G rows a warp, every load of a pass issued before its stores, loads
// with an L2 evict-last policy, streaming stores.  V: four elements.
template <typename V>
__global__ void masked_gather_group(const V* __restrict__ table,
                                    long long rank_stride,
                                    const int* __restrict__ slots,
                                    const uint8_t* __restrict__ valid,
                                    V* __restrict__ out, long long n,
                                    int d4, long long cap, int G) {
  const int rank = blockIdx.y;
  table += rank * rank_stride;
  slots += rank * n;
  valid += rank * n;
  out += rank * n * d4;
  const int lane = threadIdx.x & 31;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  const long long groups = (n + G - 1) / G;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long grp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       grp < groups; grp += stride) {
    const long long r0 = grp * G;
    const int rows = (int)(n - r0 < G ? n - r0 : G);
    // the group's slots and flags: one coalesced load, then shuffles
    int my_row = 0;
    int my_ok = 0;
    if (lane < rows) {
      my_ok = valid[r0 + lane];
      my_row = (int)clip_slot(slots[r0 + lane], cap);
    }
    const int total = rows * d4;
    V* dst = out + r0 * d4;
    for (int base = 0; base < total; base += 32 * kPerLane) {
      V v[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = base + lane + 32 * k;
        int j = c / d4;
        j = j < rows ? j : rows - 1;
        const int row = __shfl_sync(0xffffffffu, my_row, j);
        const int ok = __shfl_sync(0xffffffffu, my_ok, j);
        v[k] = vzero<V>();
        if (c < total && ok) {
          const V* src = table + (long long)row * d4 + (c - j * d4);
          v[k] = ld_evict_last(src, policy);
        }
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = base + lane + 32 * k;
        if (c < total) __stcs(dst + c, v[k]);
      }
    }
  }
}

template <typename V, typename T>
int launch(const void* table, long long rank_stride, const int* sl,
           const uint8_t* ok, void* out, int ranks, long long n, int d,
           long long cap, int vec4, cudaStream_t s) {
  if (vec4) {
    const int d4 = d / 4;
    int G = 32 * kPerLane / d4;
    G = G < 1 ? 1 : (G > 32 ? 32 : G);
    long long blocks = ((n + G - 1) / G + kWarps - 1) / kWarps;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    masked_gather_group<V><<<dim3((unsigned)blocks, (unsigned)ranks),
                             kThreads, 0, s>>>(
        static_cast<const V*>(table), rank_stride / 4, sl, ok,
        static_cast<V*>(out), n, d4, cap, G);
  } else {
    long long blocks = (n + kWarps - 1) / kWarps;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    masked_gather_scalar<T><<<dim3((unsigned)blocks, (unsigned)ranks),
                              kThreads, 0, s>>>(
        static_cast<const T*>(table), rank_stride, sl, ok,
        static_cast<T*>(out), n, d, cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// esize: 4 for float32 rows, 2 for bfloat16.  vec4: d % 4 == 0 and every
// row aligned to a group of four elements (16 bytes float32, 8 bytes
// bfloat16; the group form), else the scalar form.  rank_stride in
// elements.
extern "C" int smtpu_masked_gather(const void* table, int esize,
                                   long long rank_stride, const void* slots,
                                   const void* valid, void* out, int ranks,
                                   long long n, int d, long long cap,
                                   int vec4, void* stream) {
  if (n <= 0 || ranks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  if (esize == 2)
    return launch<uint2, unsigned short>(table, rank_stride, sl, ok, out,
                                         ranks, n, d, cap, vec4, s);
  if (esize != 4) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float4, float>(table, rank_stride, sl, ok, out, ranks, n, d,
                               cap, vec4, s);
}
