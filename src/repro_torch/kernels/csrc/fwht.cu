// Hopper port of src/repro/kernels/fwht.py::fwht_pallas (its body `_kernel`):
// batched FWHT over the last axis with one shared (d,) sign diagonal,
//
//     out = (scale * H_d (signs * x))[rows]      (the gather only when rows given)
//
// f32 or bf16 input, f32 compute, output in the input dtype. The scale is
// applied AFTER the transform, as kernels/ref.py does, so the result equals
// the plain version bit for bit (the TPU kernel folds it into H_b instead).
//
// Bound on an H100: bytes. The transform does d log2(d) adds per row, about
// three adds per byte read, far below the card's operations-per-byte balance.
// Design: one block per row, the row in shared memory, log2(d) butterfly
// stages between __syncthreads, so every element is read from and written to
// device memory once. With `rows` the SRHT encode's row gather is fused: the
// block writes only its k selected outputs, never the (rows, d) transform.
#include "fwht_common.cuh"

namespace repro_torch {

template <typename T>
__global__ void fwht_kernel(const T* __restrict__ x, const float* __restrict__ signs,
                            const int64_t* __restrict__ rows, T* __restrict__ out, int d, int k,
                            float scale) {
  extern __shared__ float s[];
  const size_t r = blockIdx.x;
  const T* xr = x + r * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = to_f32(xr[j]);
    s[j] = signs != nullptr ? v * signs[j] : v;
  }
  fwht_smem(s, d);
  if (rows != nullptr) {
    T* o = out + r * k;
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
      const int64_t j = rows[t];
      // out-of-range rows read NaN, as jnp.take's default fill mode does
      const float v = (j >= 0 && j < d) ? s[j] * scale : __int_as_float(0x7fc00000);
      o[t] = from_f32<T>(v);
    }
  } else {
    T* o = out + r * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) o[j] = from_f32<T>(s[j] * scale);
  }
}

template <typename T>
int launch_fwht(const void* x, const void* signs, const void* rows, void* out, long long n_rows,
                int d, int k, float scale, void* stream) {
  if (n_rows == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * d;
  cudaError_t err = prepare_smem(fwht_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  fwht_kernel<T><<<static_cast<unsigned>(n_rows), block_threads(d), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(signs),
      static_cast<const int64_t*>(rows), static_cast<T*>(out), d, k, scale);
  return cudaGetLastError();
}

}  // namespace repro_torch

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int fwht_f32(const void* x, const void* signs, const void* rows, void* out, long long n_rows,
             int d, int k, float scale, void* stream) {
  return repro_torch::launch_fwht<float>(x, signs, rows, out, n_rows, d, k, scale, stream);
}

int fwht_bf16(const void* x, const void* signs, const void* rows, void* out, long long n_rows,
              int d, int k, float scale, void* stream) {
  return repro_torch::launch_fwht<__nv_bfloat16>(x, signs, rows, out, n_rows, d, k, scale,
                                                 stream);
}

}  // extern "C"
