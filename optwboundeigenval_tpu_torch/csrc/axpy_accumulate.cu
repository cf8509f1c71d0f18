// In-place fp32 accumulate  acc[i] = acc[i] + alpha * delta[i]  for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel optwboundeigenval_tpu/ops/pallas_kernels.py
// ::axpy_accumulate (the running sum of the micro-batched HVP).
//
// Bound: memory.  Per element it reads acc and delta and writes acc: 12 bytes,
// no reuse, 2 flops.  The design therefore only has to stream: 16-byte loads and
// stores (float4) when both pointers are 16-byte aligned, a grid-stride loop over
// the vector body, and a masked scalar tail instead of the TPU version's
// zero-padding to (512, 128) tiles.  It works in place on acc (the TPU kernel
// wrote a fresh output), reads alpha from device memory so the caller never
// syncs to the host, allocates nothing and does not synchronise.
//
// The sum is rounded as  fl(acc + fl(alpha * delta)): __fmul_rn / __fadd_rn keep
// nvcc from contracting it into one fma, so the kernel agrees bit for bit with
// the plain PyTorch version  acc.add_(delta * alpha)  and with the JAX
// accumulate  a + scale * d.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM on 132 SMs

__global__ void axpy_vec4_kernel(float* __restrict__ acc,
                                 const float* __restrict__ delta,
                                 const float* __restrict__ alpha,
                                 long long n) {
  const float a = *alpha;
  const long long n4 = n >> 2;
  const long long stride = (long long)blockDim.x * gridDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float4* acc4 = reinterpret_cast<float4*>(acc);
  const float4* delta4 = reinterpret_cast<const float4*>(delta);
  for (long long k = tid; k < n4; k += stride) {
    float4 x = acc4[k];
    const float4 d = delta4[k];
    x.x = __fadd_rn(x.x, __fmul_rn(a, d.x));
    x.y = __fadd_rn(x.y, __fmul_rn(a, d.y));
    x.z = __fadd_rn(x.z, __fmul_rn(a, d.z));
    x.w = __fadd_rn(x.w, __fmul_rn(a, d.w));
    acc4[k] = x;
  }
  // masked tail: at most 3 elements
  const long long k = (n4 << 2) + tid;
  if (k < n) acc[k] = __fadd_rn(acc[k], __fmul_rn(a, delta[k]));
}

__global__ void axpy_scalar_kernel(float* __restrict__ acc,
                                   const float* __restrict__ delta,
                                   const float* __restrict__ alpha,
                                   long long n) {
  const float a = *alpha;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    acc[k] = __fadd_rn(acc[k], __fmul_rn(a, delta[k]));
  }
}

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)b;
}

}  // namespace

// acc, delta: n contiguous fp32 values on the device; alpha: one fp32 value on
// the device.  Launches on `stream` and returns cudaGetLastError() (cudaSuccess
// when n == 0 and nothing was launched).
extern "C" int axpy_accumulate_f32(void* acc, const void* delta,
                                   const void* alpha, long long n,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  float* a = static_cast<float*>(acc);
  const float* d = static_cast<const float*>(delta);
  const float* s = static_cast<const float*>(alpha);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(a) |
                         reinterpret_cast<std::uintptr_t>(d)) & 15u) == 0;
  if (aligned) {
    axpy_vec4_kernel<<<blocks_for(n >> 2), kThreads, 0, st>>>(a, d, s, n);
  } else {
    axpy_scalar_kernel<<<blocks_for(n), kThreads, 0, st>>>(a, d, s, n);
  }
  return (int)cudaGetLastError();
}
