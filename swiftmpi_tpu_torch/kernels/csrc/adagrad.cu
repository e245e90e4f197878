// In-place AdaGrad over same-shape float32 arrays:
//   accum += g * g;  param += lr * g * rsqrt(accum + fudge)
//
// Replaces the Pallas kernel swiftmpi_tpu/ops/pallas_kernels.py
// adagrad_update (_adagrad_kernel), the body of
// PallasAdaGradAccess.apply_push.  The TPU kernel walks a lane-padded
// (rows, 128) view block by block with input/output aliasing; here the
// update is written straight into param and accum, which is what the
// aliasing achieved.  Bound: bytes — param, accum and grad read once,
// param and accum written once (20 bytes an element), over 3.35 TB/s; the
// seven flops an element are far below the float32 rate.
//
// Design: grid-stride elementwise over numel with coalesced float loads,
// f32 math.  Each product and sum is rounded on its own (__fmul_rn /
// __fadd_rn keep nvcc from contracting them into FMAs), in the order the
// plain PyTorch version evaluates them, and rsqrtf is the function
// torch.rsqrt runs on the card, so the kernel agrees with the plain
// version bit for bit on the same card.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void adagrad_update(float* __restrict__ param,
                               float* __restrict__ accum,
                               const float* __restrict__ grad, long long n,
                               float lr, float fudge) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float g = grad[i];
    const float a = __fadd_rn(accum[i], __fmul_rn(g, g));
    accum[i] = a;
    const float step = __fmul_rn(__fmul_rn(lr, g), rsqrtf(__fadd_rn(a, fudge)));
    param[i] = __fadd_rn(param[i], step);
  }
}

}  // namespace

extern "C" int smtpu_adagrad_update_f32(void* param, void* accum,
                                        const void* grad, long long n,
                                        float lr, float fudge, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  // enough blocks to fill 132 SMs several times over; the rest grid-strides
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  adagrad_update<<<(unsigned)blocks, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(param), static_cast<float*>(accum),
      static_cast<const float*>(grad), n, lr, fudge);
  return static_cast<int>(cudaGetLastError());
}
