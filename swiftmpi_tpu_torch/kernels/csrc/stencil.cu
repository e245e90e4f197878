// Stencil context sum: the CBOW context sum of the stencil rendering, from
// the stencil batch itself,
//   out[b] = sum_{k < K, k on for b} float(table[clip(slots[lo[b] + k])])
// with K = 2W + 1, cp = clip(center_pos[b], 0, S - 1),
// lo[b] = clip(cp - W, 0, S - K), and window row k on for b iff
// center_pos[b] >= 0, j = lo[b] + k != cp, |j - cp| <= half[b], j < S and
// sent_id[j] == sent_id[cp]: the rule of kernels/stencil.py
// stencil_window_inputs, whose (lo, wmask) the kernel never writes out.
// Rows are float32 or bfloat16 (upcast exactly); the sum is float32 in k
// order.
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_stencil.py
// fused_stencil_gather (_stencil_kernel) together with the XLA ops of
// stencil_window_inputs that feed it.  The TPU kernel stages the whole
// span (S <= B + 2W rows) in VMEM once and then walks the centers in
// order.  Bound here: bytes — the four index arrays, the distinct table
// rows the windows reach (x itemsize) and out written once (about 2.1 MB
// for a stencil batch of the word2vec reference configuration, under a
// microsecond at 3.35 TB/s); the adds are far below the float32 rate.  At
// that size the kernel is bound by latency, not bytes: the chain
// center_pos -> sent_id, slots -> table row, and the launch.  So the
// redesign folds the ~20 torch launches of the window inputs, and the
// (B, K) float mask they wrote and the kernel read back, into the kernel.
//
// Design: a warp a center, lanes along d (16-byte float4 for float32
// rows, 8-byte groups of four bfloat16 when d % 4 == 0, because a 200-byte
// bfloat16 row is not 16-byte aligned; else one element a lane).  Lanes
// 0..15 each take a window row, test it against the rule (one load of
// sent_id and one of the slot, side by side) and shuffle the slots of the
// rows that are on to every lane; every lane then issues all of a chunk's
// row loads before it sums them, so the chain is center_pos -> sent_id and
// slots -> rows, and the L1/L2 serve the rows that neighbouring centers
// share.  A padded center writes a zero row without reading the table.
// Each on row is added in k order with each sum rounded on its own
// (__fadd_rn), the order of the plain PyTorch version, which adds 0 * row
// for the rows that are off: for a finite table that is +-0 and leaves the
// sum as it is, so the two agree bit for bit on the card.  A form that
// stages a tile of centers' window rows in shared memory with cp.async
// first was slower at every batch timed (PERF.md, apps/stencil_sweep.py):
// at the word2vec batches a row is read by one or two centers, so staging
// only adds a barrier and a pass.
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

// table elements -> float32, exactly: E is what a lane loads, float4 or
// float for float32 rows, uint2 (four bfloat16) or unsigned short for
// bfloat16 rows (a bfloat16 is the top half of a float32)
__device__ __forceinline__ float up(float v) { return v; }
__device__ __forceinline__ float4 up(float4 v) { return v; }
__device__ __forceinline__ float up(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ float4 up(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <typename F> __device__ __forceinline__ F vzero();
template <> __device__ __forceinline__ float vzero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// One center of the batch: its clipped position, window start, radius and
// sentence.
struct Center {
  int cp, lo, half, sid;
  bool real;
};

__device__ __forceinline__ Center center_of(const long long* center_pos,
                                            const int* half,
                                            const int* sent_id, long long b,
                                            int S, int W) {
  Center c;
  const long long p = center_pos[b];
  c.real = p >= 0;
  c.cp = (int)(p < 0 ? 0 : (p >= S ? S - 1 : p));
  const int top = S - (2 * W + 1) > 0 ? S - (2 * W + 1) : 0;
  const int lo = c.cp - W;
  c.lo = lo < 0 ? 0 : (lo > top ? top : lo);
  c.half = half[b];
  c.sid = sent_id[c.cp];
  return c;
}

// The slot of window row k of center c, or -1 when the row is off.  The
// slot and the row's sentence are loaded side by side.
__device__ __forceinline__ int window_slot(const Center& c,
                                           const int* __restrict__ slots,
                                           const int* __restrict__ sent_id,
                                           int k, int S, long long cap) {
  const int j = c.lo + k;
  if (!c.real || j >= S) return -1;
  const int slot = slots[j];
  const int sid = sent_id[j];
  const int off = j - c.cp;
  const int aoff = off < 0 ? -off : off;
  const bool on = off != 0 && aoff <= c.half && sid == c.sid;
  return on ? (int)clip_slot(slot, cap) : -1;
}

// Center c's sum: chunks of kChunk window rows, every row load of a chunk
// issued before its adds.
template <typename E, typename F>
__device__ __forceinline__ void sum_window(const E* __restrict__ table,
                                           const int* __restrict__ slots,
                                           const int* __restrict__ sent_id,
                                           const Center& c, F* dst, int lane,
                                           int S, int W, int dv,
                                           long long cap) {
  const int K = 2 * W + 1;
  for (int c0 = 0; c0 < dv; c0 += 32) {
    const int col = c0 + lane;
    const bool has = col < dv;
    F acc = vzero<F>();
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      int my_slot = -1;
      if (lane < kChunk && k0 + lane < K)
        my_slot = window_slot(c, slots, sent_id, k0 + lane, S, cap);
      F rows[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int s = __shfl_sync(kFull, my_slot, k);
        rows[k] = (has && s >= 0)
                      ? up(__ldg(table + (long long)s * dv + col))
                      : vzero<F>();
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) acc = add(acc, rows[k]);
    }
    if (has) dst[col] = acc;
  }
}

template <typename F>
__device__ __forceinline__ void write_zero(F* dst, int lane, int dv) {
  for (int col = lane; col < dv; col += 32) dst[col] = vzero<F>();
}

// A warp a center.
template <typename E, typename F>
__global__ void context_sum_warp(const E* __restrict__ table,
                                 const int* __restrict__ slots,
                                 const int* __restrict__ sent_id,
                                 const long long* __restrict__ center_pos,
                                 const int* __restrict__ half,
                                 F* __restrict__ out, int B, int S, int W,
                                 int dv, long long cap) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                                   // warp-uniform
  F* dst = out + b * dv;
  const Center c = center_of(center_pos, half, sent_id, b, S, W);
  if (!c.real) {                                        // padded center
    write_zero(dst, lane, dv);
    return;
  }
  sum_window<E, F>(table, slots, sent_id, c, dst, lane, S, W, dv, cap);
}

template <typename E, typename F>
int launch_warp(const void* table, const int* slots, const int* sent_id,
                const long long* center_pos, const int* half, void* out,
                int B, int S, int W, int dv, long long cap, cudaStream_t s) {
  const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  context_sum_warp<E, F><<<blocks, kThreads, 0, s>>>(
      static_cast<const E*>(table), slots, sent_id, center_pos, half,
      static_cast<F*>(out), B, S, W, dv, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (B, d) float32 <- the context sums of the stencil batch.  table
// (cap, d): float32 (bf16 = 0) or bfloat16 (bf16 = 1).  slots, sent_id:
// (S,) int32; center_pos (B,) int64; half (B,) int32.  vec4: d % 4 == 0
// and every row aligned to its 4-element group (16 bytes float32, 8
// bytes bfloat16), out 16-byte aligned.
extern "C" int smtpu_stencil_context_sum(const void* table, int bf16,
                                         const void* slots,
                                         const void* sent_id,
                                         const void* center_pos,
                                         const void* half, void* out, int B,
                                         int S, int W, int d, long long cap,
                                         int vec4, void* stream) {
  if (B <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  const int* sid = static_cast<const int*>(sent_id);
  const long long* cp = static_cast<const long long*>(center_pos);
  const int* hf = static_cast<const int*>(half);
  if (vec4)
    return bf16 ? launch_warp<uint2, float4>(table, sl, sid, cp, hf, out, B,
                                             S, W, d / 4, cap, s)
                : launch_warp<float4, float4>(table, sl, sid, cp, hf, out, B,
                                              S, W, d / 4, cap, s);
  return bf16 ? launch_warp<unsigned short, float>(table, sl, sid, cp, hf,
                                                   out, B, S, W, d, cap, s)
              : launch_warp<float, float>(table, sl, sid, cp, hf, out, B, S,
                                          W, d, cap, s);
}
