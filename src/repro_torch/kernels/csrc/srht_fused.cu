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
// per byte moved. Each kernel reads its inputs once and writes its output
// once:
//   * decode_sum takes the (n, C, k) payloads and their rows and scatters
//     them in shared memory, so the (n, C, d) scattered tensor of the TPU
//     path never exists in device memory;
//   * the client sum is a loop in client order over an accumulator that is
//     written once at the end: no atomics, and the same order as the plain
//     version, so the result is deterministic;
//   * signs and masks of shape (n, 1, d) (shared randomness) are read by
//     broadcast through a zero chunk stride, never expanded to (n, C, d).
// The TPU kernels' Kronecker two-matmul tiling is an MXU adaptation and is
// not carried over.
//
// fwht_rowsigns and gram_apply run one block per chunk row, the row in shared
// memory, fwht_smem's __syncthreads a stage. decode_sum runs the butterfly
// once a client: in shared memory that is about 80k shared accesses and 48
// block barriers a chunk of four clients, far more time than its bytes take.
// So it runs the register-resident butterfly of fwht_common.cuh: a warp
// owns 1024 / d chunks (a block of d / 32 threads owns one above 1024) in a
// persistent grid, with the accumulator in registers and the
// client loop inside the warp. Per client it scatters the k payload values
// into a zero shared tile, reads the tile in layout A, puts the k zeros back
// (cheaper than clearing the tile), transforms in registers with two passes
// through a second tile, and adds (v * s_i) * scale to the accumulator, as
// the plain version does. Shared signs and rows are staged in shared memory
// once a block; a draw per chunk is read per chunk. Each register of the
// result is stored as one coalesced 128-byte line a warp (16-byte stores
// would need one more pass through shared memory for no fewer lines).
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

constexpr int kDecodeGroups = 8;              // warps (groups) a block for d <= 1024
constexpr int kPrefetch = 2;                   // scatter entries a thread fetches ahead
constexpr size_t kStageSignBytes = 32 * 1024;  // shared signs staged up to this size
constexpr size_t kStageRowBytes = 16 * 1024;   // shared rows staged up to this size

// One client's payload for chunks [c0, c0 + nc): entry t is z[i, c0 + t / k,
// t % k], scattered to tile position rho d + rows[.., t % k] (rho = t / k).
struct Payload {
  const float* z;       // z[i, c0, 0]
  const int64_t* rows;  // rows[i, c0, 0] for a draw per chunk, else rows[i, 0, 0]
  int n_in;             // entries: nc k
};

// Tile position of entry t (-1 when its row is out of range: the update
// drops, as in .at[].set).
template <int LOG_D>
__device__ __forceinline__ int scatter_pos(const Payload& pl, int t, int k, int rows_pc) {
  const int rho = Butterfly<LOG_D>::kRows == 1 ? 0 : t / k;
  const int64_t j = pl.rows[rows_pc ? t : t - rho * k];
  return (j >= 0 && j < (1 << LOG_D)) ? swz(rho * (1 << LOG_D) + static_cast<int>(j)) : -1;
}

// Shared memory: the groups' scatter tiles (kept zero between clients), their
// transform tiles, then the staged signs (n, d) and rows (n, k) when shared.
// rows_pc / signs_pc: a draw per chunk (else one per client for every chunk).
// Each thread fetches the first kPrefetch entries of the next client's
// payload into registers while this client's transform runs, so the payload's
// device-memory latency is off the client loop's path; a payload of more
// than kPrefetch entries a thread (d < 1024 here) reads the rest in place.
template <int LOG_D>
__global__ void __launch_bounds__(Butterfly<LOG_D>::kWarps == 1 ? 32 * kDecodeGroups
                                                               : Butterfly<LOG_D>::kThreads)
    decode_sum_butterfly_kernel(const float* __restrict__ z, const int64_t* __restrict__ rows,
                                const float* __restrict__ signs, float* __restrict__ out, int n,
                                int C, int k, int rows_pc, int signs_pc, int stage_rows,
                                int stage_signs, float scale) {
  using BF = Butterfly<LOG_D>;
  constexpr int kD = BF::kD;
  constexpr int kGroups = BF::kWarps == 1 ? kDecodeGroups : 1;
  extern __shared__ __align__(16) float smem[];
  const int grp = threadIdx.x / BF::kThreads;
  const int g = threadIdx.x % BF::kThreads;
  float* ztile = smem + grp * BF::kTile;
  float* xtile = smem + (kGroups + grp) * BF::kTile;
  float* staged = smem + 2 * kGroups * BF::kTile;

  for (int i = threadIdx.x; i < kGroups * BF::kTile; i += blockDim.x) smem[i] = 0.f;
  // generic pointers: shared memory when staged, device memory otherwise
  const float* sg = signs;
  if (stage_signs) {
    for (int i = threadIdx.x; i < n * kD; i += blockDim.x) staged[i] = signs[i];
    sg = staged;
    staged += n * kD;
  }
  const int64_t* rw = rows;
  if (stage_rows) {
    int64_t* st = reinterpret_cast<int64_t*>(staged);
    for (int i = threadIdx.x; i < n * k; i += blockDim.x) st[i] = rows[i];
    rw = st;
  }
  __syncthreads();

  const long long n_tasks = (static_cast<long long>(C) + BF::kRows - 1) / BF::kRows;
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  // client i's payload for the task (group of chunks) starting at chunk c0
  auto payload = [&](long long c0, int i) {
    const long long left = C - c0;
    const int nc = static_cast<int>(left < BF::kRows ? left : BF::kRows);
    const size_t at = (static_cast<size_t>(i) * C + c0) * k;
    return Payload{z + at, rw + (rows_pc ? at : static_cast<size_t>(i) * k), nc * k};
  };
  float zv[kPrefetch];
  int pos[kPrefetch];
  auto fetch = [&](const Payload& pl) {
#pragma unroll
    for (int m = 0; m < kPrefetch; ++m) {
      const int t = g + m * BF::kThreads;
      pos[m] = t < pl.n_in ? scatter_pos<LOG_D>(pl, t, k, rows_pc) : -1;
      zv[m] = t < pl.n_in ? pl.z[t] : 0.f;
    }
  };
  long long task = static_cast<long long>(blockIdx.x) * kGroups + grp;
  if (task < n_tasks) fetch(payload(task * BF::kRows, 0));
  for (; task < n_tasks; task += stride) {
    const long long c0 = task * BF::kRows;
    const long long left = C - c0;
    const int nc = static_cast<int>(left < BF::kRows ? left : BF::kRows);  // chunks here
    float acc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] = -0.f;  // -0 + t == t for every t: the first term
    for (int i = 0; i < n; ++i) {
      const Payload pl = payload(c0, i);
      BF::sync();  // the last client's zeros are back
      int here[kPrefetch];
#pragma unroll
      for (int m = 0; m < kPrefetch; ++m) {
        here[m] = pos[m];
        if (here[m] >= 0) ztile[here[m]] = zv[m];
      }
      for (int t = g + kPrefetch * BF::kThreads; t < pl.n_in; t += BF::kThreads) {
        const int p = scatter_pos<LOG_D>(pl, t, k, rows_pc);
        if (p >= 0) ztile[p] = pl.z[t];
      }
      // the next client's payload (or the next task's first) loads meanwhile
      if (i + 1 < n) {
        fetch(payload(c0, i + 1));
      } else if (task + stride < n_tasks) {
        fetch(payload((task + stride) * BF::kRows, 0));
      }
      BF::sync();
      float v[32];
      BF::load_a(v, ztile, g);
      BF::sync();
#pragma unroll
      for (int m = 0; m < kPrefetch; ++m) {
        if (here[m] >= 0) ztile[here[m]] = 0.f;
      }
      for (int t = g + kPrefetch * BF::kThreads; t < pl.n_in; t += BF::kThreads) {
        const int p = scatter_pos<LOG_D>(pl, t, k, rows_pc);
        if (p >= 0) ztile[p] = 0.f;
      }
      BF::transform(v, xtile, g);
      const float* si = sg + (signs_pc ? (static_cast<size_t>(i) * C + c0) * kD
                                       : static_cast<size_t>(i) * kD);
      // eight signs at a time: the barrier keeps the compiler from holding
      // all 32 in registers at once. With one row a tile (d >= 1024) every
      // p is in range and is the row position: si + p is si + g + a constant.
#pragma unroll
      for (int r0 = 0; r0 < 32; r0 += 8) {
        float s[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int p = BF::final_index(g, r0 + r);
          if constexpr (BF::kRows == 1) {
            s[r] = si[p];
          } else {
            s[r] = p < nc * kD ? si[signs_pc ? p : (p & (kD - 1))] : 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r0 + r] = acc[r0 + r] + v[r0 + r] * s[r] * scale;
        asm volatile("" ::: "memory");
      }
    }
    float* o = out + c0 * kD;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int p = BF::final_index(g, r);
      if (BF::kRows == 1 || p < nc * kD) o[p] = acc[r];
    }
  }
}

template <int LOG_D>
int launch_decode_sum(const void* z, const void* rows, const void* signs, void* out, int n, int C,
                      int k, int rows_pc, int signs_pc, float scale, cudaStream_t stream) {
  using BF = Butterfly<LOG_D>;
  constexpr int kGroups = BF::kWarps == 1 ? kDecodeGroups : 1;
  constexpr int kThreads = kGroups * BF::kThreads;
  const size_t sign_bytes = sizeof(float) * n * BF::kD;
  const size_t row_bytes = sizeof(int64_t) * n * k;
  const int stage_signs = !signs_pc && sign_bytes <= kStageSignBytes;
  const int stage_rows = !rows_pc && row_bytes <= kStageRowBytes;
  const size_t smem = sizeof(float) * 2 * kGroups * BF::kTile + (stage_signs ? sign_bytes : 0) +
                      (stage_rows ? row_bytes : 0);
  auto kernel = decode_sum_butterfly_kernel<LOG_D>;
  cudaError_t err = prepare_smem(kernel, smem);
  const long long tasks = (static_cast<long long>(C) + BF::kRows - 1) / BF::kRows;
  int blocks = 0;
  if (err == cudaSuccess) {
    err = persistent_grid(kernel, kThreads, smem, (tasks + kGroups - 1) / kGroups, &blocks);
  }
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(z), static_cast<const int64_t*>(rows),
      static_cast<const float*>(signs), static_cast<float*>(out), n, C, k, rows_pc, signs_pc,
      stage_rows, stage_signs, scale);
  return cudaGetLastError();
}

// signs_cs / mask_cs: chunk stride, d for a draw per chunk or 0 when one draw
// per client serves every chunk.
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
  return with_log_d<14>(log2_exact(d), [&](auto log_d) {
    return launch_decode_sum<decltype(log_d)::value>(z, rows, signs, out, n, C, k,
                                                     rows_per_chunk, signs_per_chunk, scale,
                                                     static_cast<cudaStream_t>(stream));
  });
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
