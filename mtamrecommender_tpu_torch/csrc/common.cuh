// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace port {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The value an f32 takes when cast to T and back (round to nearest even):
// what JAX's `.astype(in_dtype)` does to an operand before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Accurate transcendental functions only: no __expf, no fast math.
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Block-wide reductions over NT threads; every thread gets the result.
// `scratch` holds NT/32 floats; the trailing barrier lets it be reused.
template <int NT>
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < NT / 32 ? scratch[lane] : 0.0f;
  x = warp_sum(x);
  __syncthreads();
  return x;
}

template <int NT>
__device__ __forceinline__ float block_max(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_max(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = lane < NT / 32 ? scratch[lane] : -INFINITY;
  x = warp_max(x);
  __syncthreads();
  return x;
}

}  // namespace port

extern "C" const char* port_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
