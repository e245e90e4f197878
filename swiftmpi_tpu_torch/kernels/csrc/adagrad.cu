// In-place AdaGrad over float32 accumulators and grads, with float32 or
// bfloat16 params:
//   g = grad (optionally * or / a per-row operand)
//   accum += g * g;  param += lr * g * rsqrt(accum + fudge)
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_kernels.py
// adagrad_update (_adagrad_kernel), the body of
// PallasAdaGradAccess.apply_push.  The TPU kernel walks a lane-padded
// (rows, 128) view block by block with input/output aliasing; here the
// update is written straight into param and accum, which is what the
// aliasing achieved.  Bound: bytes — param, accum and grad read once,
// param and accum written once (20 bytes an element, 16 with bfloat16
// params, plus the slot, mask and per-row operand of each row), over
// 3.35 TB/s; the seven flops an element are far below the float32 rate.
//
// Two forms, one kernel:
// - dense: rows * d elements of R blocks at once (param and accum as
//   base + rank stride, the rank on blockIdx.y: the shards of the ranks
//   that share a card in one launch), grad (R, rows, d);
// - row-indexed: row i of grad updates table row slots[i], for the rows
//   the mask keeps and whose slot lies in [0, cap): no gather copy of the
//   touched rows and no write-back.  The kept slots must be distinct (two
//   threads would race on one row); callers pass segment representatives
//   or span owners, distinct by construction.
// Either form may scale each grad row by a per-row operand first, a
// product (the mean's reciprocal) or a quotient (its divisor), fused
// instead of a separate pass over the grads.
//
// The mixed form ([server] dtype: bfloat16; the JAX rule of
// swiftmpi_tpu/parameter/access.py AdaGradAccess.apply_push) reads a
// bfloat16 param, upcasts it exactly, runs the same float32 math and
// rounds the new param once on store, to nearest even
// (__float2bfloat16_rn); the accumulator stays float32.
//
// Grid-stride over four-element chunks where d % 4 == 0 and the rows are
// aligned (16 bytes of float32, 8 of bfloat16), else over elements.  Each
// product, quotient and sum is rounded on its own (__fmul_rn, __fdiv_rn and
// __fadd_rn keep nvcc from contracting them into FMAs), in the order the
// plain PyTorch version evaluates them, and rsqrtf is the function
// torch.rsqrt runs on the card, so every form agrees with the plain version
// bit for bit on the same card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int kScale>
__device__ __forceinline__ void update(float& p, float& a, float g, float s,
                                       float lr, float fudge) {
  if constexpr (kScale == 1) g = __fmul_rn(g, s);
  if constexpr (kScale == 2) g = __fdiv_rn(g, s);
  a = __fadd_rn(a, __fmul_rn(g, g));
  p = __fadd_rn(p, __fmul_rn(__fmul_rn(lr, g), rsqrtf(__fadd_rn(a, fudge))));
}

template <int kScale>
__device__ __forceinline__ void update(float4& p, float4& a, float4 g,
                                       float s, float lr, float fudge) {
  update<kScale>(p.x, a.x, g.x, s, lr, fudge);
  update<kScale>(p.y, a.y, g.y, s, lr, fudge);
  update<kScale>(p.z, a.z, g.z, s, lr, fudge);
  update<kScale>(p.w, a.w, g.w, s, lr, fudge);
}

// params: P is what holds T's elements of a param row — T itself for
// float32, unsigned short (one bfloat16's bits) for float, uint2 (four)
// for float4.  to_f upcasts exactly; round_to stores to nearest even.
__device__ __forceinline__ float to_f(float p) { return p; }
__device__ __forceinline__ float4 to_f(float4 p) { return p; }
__device__ __forceinline__ float to_f(unsigned short p) {
  return __uint_as_float(static_cast<unsigned>(p) << 16);
}
__device__ __forceinline__ float4 to_f(uint2 p) {
  return make_float4(__uint_as_float(p.x << 16),
                     __uint_as_float(p.x & 0xffff0000u),
                     __uint_as_float(p.y << 16),
                     __uint_as_float(p.y & 0xffff0000u));
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename P> __device__ __forceinline__ P round_to(float v);
template <typename P> __device__ __forceinline__ P round_to(float4 v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float4 round_to<float4>(float4 v) {
  return v;
}
template <>
__device__ __forceinline__ unsigned short round_to<unsigned short>(float v) {
  return static_cast<unsigned short>(bf16_bits(v));
}
template <> __device__ __forceinline__ uint2 round_to<uint2>(float4 v) {
  return make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                    bf16_bits(v.z) | (bf16_bits(v.w) << 16));
}

// T: float or float4 (accum and grad); P: the param's holder of T's
// elements; dv: T's per row.  kScale: 0 none, 1 multiply, 2 divide.
// slots == nullptr in the dense form.
template <typename T, typename P, bool kIndexed, int kScale>
__global__ void adagrad_update(P* __restrict__ param, T* __restrict__ accum,
                               long long rank_stride,
                               const T* __restrict__ grad,
                               const int* __restrict__ slots,
                               const uint8_t* __restrict__ mask,
                               const float* __restrict__ scale,
                               unsigned rows, unsigned dv, long long cap,
                               float lr, float fudge) {
  const int rank = blockIdx.y;
  param += rank * rank_stride;
  accum += rank * rank_stride;
  grad += (long long)rank * rows * dv;
  if (kScale) scale += (long long)rank * rows;
  const unsigned n = rows * dv;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned row = 0;
    if (kIndexed || kScale) row = i / dv;
    long long at = i;
    if constexpr (kIndexed) {
      if (mask != nullptr && !mask[row]) continue;
      const long long s = slots[row];
      if (s < 0 || s >= cap) continue;
      at = s * dv + (i - row * dv);
    }
    T p = to_f(param[at]);
    T a = accum[at];
    update<kScale>(p, a, grad[i], kScale ? scale[row] : 1.f, lr, fudge);
    accum[at] = a;
    param[at] = round_to<P>(p);
  }
}

template <typename T, typename P, bool kIndexed>
int launch(void* param, void* accum, long long rank_stride, const void* grad,
           const void* slots, const void* mask, const void* scale,
           int scale_mode, int ranks, unsigned rows, unsigned dv,
           long long cap, float lr, float fudge, cudaStream_t s) {
  long long blocks = ((long long)rows * dv + kThreads - 1) / kThreads;
  // enough blocks to fill 132 SMs several times over; the rest
  // grid-strides
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  dim3 grid((unsigned)blocks, (unsigned)ranks);
  P* p = static_cast<P*>(param);
  T* a = static_cast<T*>(accum);
  const T* g = static_cast<const T*>(grad);
  const int* sl = static_cast<const int*>(slots);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* sc = static_cast<const float*>(scale);
  if (scale_mode == 1)
    adagrad_update<T, P, kIndexed, 1><<<grid, kThreads, 0, s>>>(
        p, a, rank_stride, g, sl, m, sc, rows, dv, cap, lr, fudge);
  else if (scale_mode == 2)
    adagrad_update<T, P, kIndexed, 2><<<grid, kThreads, 0, s>>>(
        p, a, rank_stride, g, sl, m, sc, rows, dv, cap, lr, fudge);
  else
    adagrad_update<T, P, kIndexed, 0><<<grid, kThreads, 0, s>>>(
        p, a, rank_stride, g, sl, m, sc, rows, dv, cap, lr, fudge);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int dispatch(void* param, void* accum, long long rank_stride,
             const void* grad, const void* slots, const void* mask,
             const void* scale, int scale_mode, int ranks, unsigned rows,
             unsigned dv, long long cap, float lr, float fudge,
             cudaStream_t s) {
  return slots != nullptr
      ? launch<T, P, true>(param, accum, rank_stride, grad, slots, mask,
                           scale, scale_mode, ranks, rows, dv, cap, lr,
                           fudge, s)
      : launch<T, P, false>(param, accum, rank_stride, grad, slots, mask,
                            scale, scale_mode, ranks, rows, dv, cap, lr,
                            fudge, s);
}

}  // namespace

// Dense form when slots is null: ranks blocks of rows x d at param/accum
// + r * rank_stride (elements), grad (ranks, rows, d) contiguous, scale
// (ranks, rows).  Row-indexed form otherwise (ranks must be 1): grad
// (rows, d), slots (rows,), mask (rows,) or null, scale (rows,) or null;
// param/accum (cap, d).  scale_mode: 0 none, 1 multiply, 2 divide.
// param_bf16: 1 for bfloat16 params (the mixed form), 0 for float32.
// vec4: d % 4 == 0 and every row aligned to a group of four elements.
// rows * d must be below 2**31.
extern "C" int smtpu_adagrad_update(
    void* param, int param_bf16, void* accum, long long rank_stride,
    const void* grad, const void* slots, const void* mask, const void* scale,
    int scale_mode, int ranks, long long rows, int d, long long cap,
    float lr, float fudge, int vec4, void* stream) {
  if (rows <= 0 || d <= 0 || ranks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const unsigned dv = (unsigned)(d / 4);
    return param_bf16
        ? dispatch<float4, uint2>(param, accum, rank_stride / 4, grad, slots,
                                  mask, scale, scale_mode, ranks,
                                  (unsigned)rows, dv, cap, lr, fudge, s)
        : dispatch<float4, float4>(param, accum, rank_stride / 4, grad,
                                   slots, mask, scale, scale_mode, ranks,
                                   (unsigned)rows, dv, cap, lr, fudge, s);
  }
  return param_bf16
      ? dispatch<float, unsigned short>(param, accum, rank_stride, grad,
                                        slots, mask, scale, scale_mode, ranks,
                                        (unsigned)rows, (unsigned)d, cap, lr,
                                        fudge, s)
      : dispatch<float, float>(param, accum, rank_stride, grad, slots, mask,
                               scale, scale_mode, ranks, (unsigned)rows,
                               (unsigned)d, cap, lr, fudge, s);
}
