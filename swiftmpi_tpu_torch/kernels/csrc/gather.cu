// Masked row gather: out[r] = valid[r] ? table[clip(slots[r], 0, cap-1)] : 0.
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_gather.py
// (vmem_gather / masked_vmem_gather), the drop-in body of the pull path's
// transfer/xla.py _masked_gather.  The TPU kernel stages the whole table in
// VMEM; on Hopper the 50 MB L2 already holds the hot rows, so the kernel is
// a plain row copy.  Bound: bytes — each unique row read once plus every
// output row written once, over 3.35 TB/s.
//
// Design: one warp per output row, lanes striding along d, so a row is one
// run of coalesced accesses.  With d % 4 == 0 and 16-byte aligned rows the
// copy moves float4s (d = 100 is 25 float4 per row).  Any row count; no
// padding.  Blocks walk rows grid-stride.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long clip_slot(int s, long long cap) {
  long long v = s;
  return v < 0 ? 0 : (v >= cap ? cap - 1 : v);
}

__global__ void masked_gather_vec4(const float4* __restrict__ table,
                                   const int* __restrict__ slots,
                                   const uint8_t* __restrict__ valid,
                                   float4* __restrict__ out, long long n,
                                   int d4, long long cap) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < n; row += stride) {
    float4* dst = out + row * d4;
    if (!valid[row]) {
      for (int c = lane; c < d4; c += 32) dst[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float4* src = table + clip_slot(slots[row], cap) * d4;
    for (int c = lane; c < d4; c += 32) dst[c] = __ldg(src + c);
  }
}

__global__ void masked_gather_scalar(const float* __restrict__ table,
                                     const int* __restrict__ slots,
                                     const uint8_t* __restrict__ valid,
                                     float* __restrict__ out, long long n,
                                     int d, long long cap) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < n; row += stride) {
    float* dst = out + row * d;
    if (!valid[row]) {
      for (int c = lane; c < d; c += 32) dst[c] = 0.f;
      continue;
    }
    const float* src = table + clip_slot(slots[row], cap) * d;
    for (int c = lane; c < d; c += 32) dst[c] = __ldg(src + c);
  }
}

}  // namespace

extern "C" int smtpu_masked_gather_f32(const void* table, const void* slots,
                                       const void* valid, void* out,
                                       long long n, int d, long long cap,
                                       int vec4, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    masked_gather_vec4<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float4*>(table), static_cast<const int*>(slots),
        static_cast<const uint8_t*>(valid), static_cast<float4*>(out), n,
        d / 4, cap);
  } else {
    masked_gather_scalar<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(table), static_cast<const int*>(slots),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out), n, d,
        cap);
  }
  return static_cast<int>(cudaGetLastError());
}
