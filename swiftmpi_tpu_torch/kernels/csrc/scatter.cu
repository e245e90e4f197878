// Masked scatter-add into a dump-row accumulator:
//   acc[(valid[r] && 0 <= slots[r] < cap) ? slots[r] : cap] += grads[r]
// over a zeroed (cap + 1, w) accumulator that the caller allocates; row
// cap is the dump row for invalid and out-of-range entries.  The caller
// reads only rows [0, cap), so the kernel skips those entries instead of
// adding them there: a stencil-rendering push is mostly padding rows, and
// their atomics would all contend for the dump row's w addresses.
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_scatter.py
// (vmem_scatter_add / masked_vmem_scatter_add), the drop-in body of the
// dense push's transfer/xla.py _push_dense._scatter.  The TPU kernel runs
// its grid in order, so duplicates are summed by sequential
// read-modify-write of a VMEM-resident accumulator.  Hopper blocks run in
// no order, so duplicates meet in float atomics at L2 instead: the
// summation order is not fixed and results are held to a tolerance, not to
// bits.  Bound: bytes — grads and indices read once, the accumulator
// written once, over 3.35 TB/s.
//
// Design: one warp per gradient row, lanes striding along w, one scalar
// atomicAdd (compiled to a fire-and-forget RED) per element.  The word2vec
// push has w = d + 1 = 101 (the fused count column), 404-byte rows that
// are not 16-byte aligned, so scalar atomics are the simple correct form.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void masked_scatter_add(const int* __restrict__ slots,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ grads,
                                   float* __restrict__ acc, long long n, int w,
                                   long long cap) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < n; row += stride) {
    const long long s = slots[row];
    // invalid and out-of-range rows belong to the dump row, which the
    // wrapper slices away: skip them (warp-uniform) rather than pile every
    // one's atomics onto the same w addresses
    if (!valid[row] || s < 0 || s >= cap) continue;
    float* dst = acc + s * w;
    const float* src = grads + row * w;
    for (int c = lane; c < w; c += 32) atomicAdd(dst + c, src[c]);
  }
}

}  // namespace

extern "C" int smtpu_masked_scatter_add_f32(const void* slots,
                                            const void* valid,
                                            const void* grads, void* acc,
                                            long long n, int w, long long cap,
                                            void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  masked_scatter_add<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slots), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(grads), static_cast<float*>(acc), n, w, cap);
  return static_cast<int>(cudaGetLastError());
}
