// Shared pieces of the Hopper FWHT kernels (fwht.cu, srht_fused.cu).
//
// Every kernel here holds one row of d floats in shared memory and runs the
// unnormalised Sylvester-order butterfly of kernels/ref.py::fwht_ref: for
// h = 1, 2, 4, ..., d/2 the pair (j, j + h) inside each block of 2h becomes
// (a + b, a - b). Doing exactly the reference's adds in the reference's order
// makes every output bitwise equal to the plain version, on any float input.
// The sources are built with -fmad=false so that no multiply followed by an
// add is contracted into an FMA, which would round differently.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Largest shared-memory footprint a block may ask for on sm_90.
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ void fwht_smem(float* s, int d) {
  const int half = d >> 1;
  for (int h = 1; h < d; h <<= 1) {
    __syncthreads();
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int j = ((p & ~(h - 1)) << 1) | (p & (h - 1));
      const float a = s[j];
      const float b = s[j + h];
      s[j] = a + b;
      s[j + h] = a - b;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Threads per block: one per butterfly pair, between one warp and 256.
inline int block_threads(int d) {
  int t = d / 2;
  if (t < 32) t = 32;
  if (t > 256) t = 256;
  return t;
}

// Opt in to more than 48 KB of dynamic shared memory where a kernel needs it.
template <typename K>
inline cudaError_t prepare_smem(K kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
  }
  return cudaSuccess;
}

}  // namespace repro_torch
