// Hopper ports of the three kernels of src/repro/kernels/srht_fused.py:
//
//   fwht_rowsigns   <- fwht_rowsigns_pallas (_rowsigns_kernel):
//       out = (scale * [s *] H ([s *] x))[rows]   one diagonal s per row
//   srht_decode_sum <- srht_decode_sum_pallas (_decode_sum_kernel):
//       out_c = sum_i scale * s_i * H scatter(z_ic, rows_i)
//   srht_gram_apply <- srht_gram_apply_pallas (_gram_apply_kernel):
//       out_c = sum_i scale * s_i * H (m_i * H (s_i * v_c))
//
// Bound on an H100: bytes. A transform is d log2(d) adds per row, a few adds
// per byte moved. Design: one block per chunk row with the row in shared
// memory and the butterfly of fwht_common.cuh, so each kernel reads its
// inputs once and writes its output once:
//   * decode_sum takes the (n, C, k) payloads and their rows and scatters
//     them in shared memory, so the (n, C, d) scattered tensor of the TPU
//     path never exists in device memory;
//   * the client sum is a loop inside the block, in client order, into a
//     shared-memory accumulator written once at the end: no atomics, and the
//     same order as the plain version, so the result is deterministic;
//   * signs and masks of shape (n, 1, d) (shared randomness) are read by
//     broadcast through a zero chunk stride, never expanded to (n, C, d).
// The TPU kernels' Kronecker two-matmul tiling is an MXU adaptation and is
// not carried over.
#include "fwht_common.cuh"

namespace repro_torch {

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

__global__ void rowsigns_kernel(const float* __restrict__ x, const float* __restrict__ signs,
                                const int64_t* __restrict__ rows, float* __restrict__ out, int d,
                                int k, int sign_pre, int sign_post, float scale) {
  extern __shared__ float s[];
  const size_t r = blockIdx.x;
  const float* xr = x + r * d;
  const float* sr = signs + r * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) s[j] = sign_pre ? xr[j] * sr[j] : xr[j];
  fwht_smem(s, d);
  if (rows != nullptr) {
    const int64_t* rr = rows + r * k;
    float* o = out + r * k;
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
      const int64_t j = rr[t];
      if (j >= 0 && j < d) {
        const float v = sign_post ? s[j] * sr[j] : s[j];
        o[t] = v * scale;
      } else {
        o[t] = nan_f32();  // jnp.take_along_axis fills out-of-range reads with NaN
      }
    }
  } else {
    float* o = out + r * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float v = sign_post ? s[j] * sr[j] : s[j];
      o[j] = v * scale;
    }
  }
}

// rows_cs / signs_cs: chunk stride of rows and signs, k or d per chunk, or 0
// when one draw per client serves every chunk.
__global__ void decode_sum_kernel(const float* __restrict__ z, const int64_t* __restrict__ rows,
                                  const float* __restrict__ signs, float* __restrict__ out, int n,
                                  int C, int d, int k, long long rows_cs, long long signs_cs,
                                  float scale) {
  extern __shared__ float sm[];
  float* buf = sm;
  float* acc = sm + d;
  const size_t c = blockIdx.x;
  for (int j = threadIdx.x; j < d; j += blockDim.x) acc[j] = 0.f;
  for (int i = 0; i < n; ++i) {
    for (int j = threadIdx.x; j < d; j += blockDim.x) buf[j] = 0.f;
    __syncthreads();
    const float* zi = z + (static_cast<size_t>(i) * C + c) * k;
    const int64_t* ri = rows + static_cast<size_t>(i) * (rows_cs ? C : 1) * k + c * rows_cs;
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
      const int64_t j = ri[t];
      if (j >= 0 && j < d) buf[j] = zi[t];  // out-of-range updates drop, as in .at[].set
    }
    fwht_smem(buf, d);
    const float* si = signs + static_cast<size_t>(i) * (signs_cs ? C : 1) * d + c * signs_cs;
    // each thread reads back only the j it owns in every loop, so the next
    // client's zeroing of buf needs no barrier before it
    for (int j = threadIdx.x; j < d; j += blockDim.x) acc[j] = acc[j] + buf[j] * si[j] * scale;
  }
  float* o = out + c * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) o[j] = acc[j];
}

__global__ void gram_apply_kernel(const float* __restrict__ v, const float* __restrict__ signs,
                                  const float* __restrict__ mask, float* __restrict__ out, int n,
                                  int C, int d, long long signs_cs, long long mask_cs,
                                  float scale) {
  extern __shared__ float sm[];
  float* buf = sm;
  float* acc = sm + d;
  const size_t c = blockIdx.x;
  const float* vc = v + c * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) acc[j] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float* si = signs + static_cast<size_t>(i) * (signs_cs ? C : 1) * d + c * signs_cs;
    const float* mi = mask + static_cast<size_t>(i) * (mask_cs ? C : 1) * d + c * mask_cs;
    for (int j = threadIdx.x; j < d; j += blockDim.x) buf[j] = vc[j] * si[j];
    fwht_smem(buf, d);
    for (int j = threadIdx.x; j < d; j += blockDim.x) buf[j] = mi[j] * buf[j];
    fwht_smem(buf, d);
    for (int j = threadIdx.x; j < d; j += blockDim.x) acc[j] = acc[j] + buf[j] * si[j] * scale;
  }
  float* o = out + c * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) o[j] = acc[j];
}

}  // namespace repro_torch

using namespace repro_torch;

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int fwht_rowsigns_f32(const void* x, const void* signs, const void* rows, void* out,
                      long long n_rows, int d, int k, int sign_pre, int sign_post, float scale,
                      void* stream) {
  if (n_rows == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * d;
  cudaError_t err = prepare_smem(rowsigns_kernel, smem);
  if (err != cudaSuccess) return err;
  rowsigns_kernel<<<static_cast<unsigned>(n_rows), block_threads(d), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(signs),
      static_cast<const int64_t*>(rows), static_cast<float*>(out), d, k, sign_pre, sign_post,
      scale);
  return cudaGetLastError();
}

int srht_decode_sum_f32(const void* z, const void* rows, const void* signs, void* out, int n,
                        int C, int d, int k, int rows_per_chunk, int signs_per_chunk, float scale,
                        void* stream) {
  if (C == 0) return cudaSuccess;
  const size_t smem = 2 * sizeof(float) * d;
  cudaError_t err = prepare_smem(decode_sum_kernel, smem);
  if (err != cudaSuccess) return err;
  decode_sum_kernel<<<static_cast<unsigned>(C), block_threads(d), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const int64_t*>(rows),
      static_cast<const float*>(signs), static_cast<float*>(out), n, C, d, k,
      rows_per_chunk ? k : 0, signs_per_chunk ? d : 0, scale);
  return cudaGetLastError();
}

int srht_gram_apply_f32(const void* v, const void* signs, const void* mask, void* out, int n,
                        int C, int d, int signs_per_chunk, int mask_per_chunk, float scale,
                        void* stream) {
  if (C == 0) return cudaSuccess;
  const size_t smem = 2 * sizeof(float) * d;
  cudaError_t err = prepare_smem(gram_apply_kernel, smem);
  if (err != cudaSuccess) return err;
  gram_apply_kernel<<<static_cast<unsigned>(C), block_threads(d), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(signs),
      static_cast<const float*>(mask), static_cast<float*>(out), n, C, d,
      signs_per_chunk ? d : 0, mask_per_chunk ? d : 0, scale);
  return cudaGetLastError();
}

}  // extern "C"
