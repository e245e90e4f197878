// Fused stencil gather: the CBOW context sum of the stencil rendering,
//   out[b] = sum_{k < K} wmask[b, k] * table[clip(slots[lo'[b] + k])]
// with lo'[b] = clip(lo[b], 0, S - K), K = 2W + 1, summed in k order.
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_stencil.py
// fused_stencil_gather (_stencil_kernel).  The TPU kernel stages the whole
// span (S <= B + 2W rows) in VMEM once and then walks the centers in order.
// Bound here: bytes — the distinct table rows the windows reach, read once,
// plus neu1 written once (about 2.5 MB for a stencil batch of the word2vec
// reference configuration, under a microsecond at 3.35 TB/s); the 2·K·d
// flops a center are far below the float32 rate.  At that size the kernel
// is bound by latency, not by bytes: the chain lo -> slots -> table row.
//
// Design: one warp per center, lanes along d (float4 when d % 4 == 0).
// Lanes 0..15 read a chunk of the window's slots and weights with one
// coalesced load each; shuffles hand every lane the chunk's row indices, and
// each lane issues the chunk's row loads back to back, so a center's K rows
// are in flight together and the L1/L2 serve rows that neighbouring
// centers share.  Then the lane sums the rows in k order with each product
// and sum rounded on its own (__fmul_rn / __fadd_rn: nvcc would contract
// them into FMAs), the order of the plain PyTorch version, so the two agree
// bit for bit on the card.  A center whose wmask row is all zero (a padded
// center) writes a zero row without reading the table.  Any lo, any span
// order of the centers: nothing assumes neighbouring centers share rows.
// Nothing is staged in shared memory: at these sizes a staging loop only
// adds a serial chain of dependent loads before the first sum (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                 // window rows in flight per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clip_slot(int s, long long cap) {
  long long v = s;
  return v < 0 ? 0 : (v >= cap ? cap - 1 : v);
}

__device__ __forceinline__ float madd(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

__device__ __forceinline__ float4 madd(float4 acc, float w, float4 v) {
  acc.x = madd(acc.x, w, v.x);
  acc.y = madd(acc.y, w, v.y);
  acc.z = madd(acc.z, w, v.z);
  acc.w = madd(acc.w, w, v.w);
  return acc;
}

template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// V is float (any d) or float4 (d % 4 == 0, 16-byte aligned rows); dv is d
// in units of V.
template <typename V>
__global__ void stencil_gather(const V* __restrict__ table,
                               const int* __restrict__ slots,
                               const int* __restrict__ lo,
                               const float* __restrict__ wmask,
                               V* __restrict__ out, int B, int S, int K,
                               int dv, long long cap) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                                   // warp-uniform
  const float* w = wmask + b * K;
  V* dst = out + b * dv;
  bool any = false;
  for (int k = lane; k < K; k += 32) any |= (w[k] != 0.f);
  if (!__any_sync(kFull, any)) {                        // padded center
    for (int c = lane; c < dv; c += 32) dst[c] = vzero<V>();
    return;
  }
  int l = lo[b];
  l = l < 0 ? 0 : (l > S - K ? S - K : l);
  for (int c0 = 0; c0 < dv; c0 += 32) {
    const int c = c0 + lane;
    const bool col = c < dv;
    V acc = vzero<V>();
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      long long my_slot = 0;
      float my_w = 0.f;
      if (lane < kChunk && k0 + lane < K) {
        my_w = w[k0 + lane];
        my_slot = clip_slot(slots[l + k0 + lane], cap);
      }
      V rows[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const long long s = __shfl_sync(kFull, my_slot, k);
        rows[k] = (col && k0 + k < K) ? __ldg(table + s * dv + c)
                                      : vzero<V>();
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float wk = __shfl_sync(kFull, my_w, k);
        if (k0 + k < K) acc = madd(acc, wk, rows[k]);
      }
    }
    if (col) dst[c] = acc;
  }
}

}  // namespace

extern "C" int smtpu_stencil_gather_f32(const void* table, const void* slots,
                                        const void* lo, const void* wmask,
                                        void* out, int B, int S, int K, int d,
                                        long long cap, int vec4,
                                        void* stream) {
  if (B <= 0 || d <= 0) return 0;
  const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    stencil_gather<float4><<<blocks, kThreads, 0, s>>>(
        static_cast<const float4*>(table), static_cast<const int*>(slots),
        static_cast<const int*>(lo), static_cast<const float*>(wmask),
        static_cast<float4*>(out), B, S, K, d / 4, cap);
  } else {
    stencil_gather<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(table), static_cast<const int*>(slots),
        static_cast<const int*>(lo), static_cast<const float*>(wmask),
        static_cast<float*>(out), B, S, K, d, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
