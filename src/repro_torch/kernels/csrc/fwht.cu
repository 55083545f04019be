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
// Between a butterfly in shared memory and that bound stand four shared
// accesses an element a stage and a block barrier a stage. Design: the
// register-resident butterfly of fwht_common.cuh. One warp holds 1024
// elements (1024 / d rows; a block of d / 32 threads holds a row above 1024)
// and walks the rows in a persistent grid. It reads them with coalesced
// 16-byte loads into its swizzled shared tile, multiplying by the signs,
// which it keeps in registers across its rows (read per row, from cache,
// above 1024), then runs the stages in registers with two passes through the
// tile. Without `rows` each register is stored as one coalesced 128-byte
// line a warp; with `rows` the final values go back to the tile and the k
// gathered outputs a row are written coalesced: the (rows, d) transform
// never reaches device memory.
#include "fwht_common.cuh"

namespace repro_torch {

constexpr int kGroupsSmall = 8;  // warps (groups) a block for d <= 1024

// 16 bytes of x from 16-byte-aligned src, as floats
__device__ __forceinline__ void load16(const float* src, float (&f)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(src));
  f[0] = t.x;
  f[1] = t.y;
  f[2] = t.z;
  f[3] = t.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float (&f)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(src));
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its float's bits
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int LOG_D>
__global__ void __launch_bounds__(Butterfly<LOG_D>::kWarps == 1 ? 32 * kGroupsSmall
                                                               : Butterfly<LOG_D>::kThreads)
    fwht_butterfly_kernel(const T* __restrict__ x, const float* __restrict__ signs,
                          const int64_t* __restrict__ rows, T* __restrict__ out, long long n_rows,
                          int k, float scale) {
  using BF = Butterfly<LOG_D>;
  constexpr int kD = BF::kD;
  constexpr int kV = 16 / sizeof(T);  // elements a 16-byte vector
  constexpr int kVecs = 32 / kV;      // vectors a thread loads a tile
  constexpr int kGroups = BF::kWarps == 1 ? kGroupsSmall : 1;
  constexpr bool kSignRegs = BF::kWarps == 1;  // above 1024 the signs are read per row
  extern __shared__ __align__(16) float smem[];
  const int grp = threadIdx.x / BF::kThreads;
  const int g = threadIdx.x % BF::kThreads;
  float* tile = smem + grp * BF::kTile;
  const bool has_signs = signs != nullptr;

  // Element p of a tile is loaded by thread g as element e of vector q, with
  // p = kV (q kThreads + g) + e: the same row position j = p % d for every
  // tile, so the signs it multiplies are the same registers every row.
  float sg[kSignRegs ? 32 : 1];
  if constexpr (kSignRegs) {
#pragma unroll
    for (int q = 0; q < kVecs; ++q) {
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        sg[q * kV + e] = has_signs ? signs[(kV * (q * BF::kThreads + g) + e) & (kD - 1)] : 1.f;
      }
    }
  }

  const long long n_tasks = (n_rows + BF::kRows - 1) / BF::kRows;
  for (long long task = static_cast<long long>(blockIdx.x) * kGroups + grp; task < n_tasks;
       task += static_cast<long long>(gridDim.x) * kGroups) {
    const long long row0 = task * BF::kRows;
    const long long left = n_rows - row0;
    const int valid = static_cast<int>(left < BF::kRows ? left : BF::kRows) * kD;
    const T* xs = x + row0 * kD;
    BF::sync();  // the tile's readers of the last task are done
    // fully unrolled with the signs in registers; above 1024 two vectors at
    // a time, which keeps the loads and their signs within 64 registers
#pragma unroll (kSignRegs ? kVecs : 2)
    for (int q = 0; q < kVecs; ++q) {
      const int p = kV * (q * BF::kThreads + g);
      float f[kV];
      if (p + kV <= valid) {
        load16(xs + p, f);
      } else {
#pragma unroll
        for (int e = 0; e < kV; ++e) f[e] = p + e < valid ? to_f32(xs[p + e]) : 0.f;
      }
      if (has_signs) {
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          if constexpr (kSignRegs) {
            f[e] = f[e] * sg[q * kV + e];
          } else {
            f[e] = f[e] * __ldg(signs + p + e);  // p is the row position above 1024
          }
        }
      }
#pragma unroll
      for (int h = 0; h < kV; h += 4) {
        *reinterpret_cast<float4*>(tile + swz(p + h)) = make_float4(f[h], f[h + 1], f[h + 2],
                                                                    f[h + 3]);
      }
    }
    BF::sync();
    float v[32];
    BF::load_a(v, tile, g);
    BF::transform(v, tile, g);
    if (rows == nullptr) {
      T* o = out + row0 * kD;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int p = BF::final_index(g, r);
        if (BF::kRows == 1 || p < valid) o[p] = from_f32<T>(v[r] * scale);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) tile[BF::final_addr(g, r)] = v[r];
      BF::sync();
      T* o = out + row0 * k;
      const int n_out = (valid / kD) * k;
      for (int t = g; t < n_out; t += BF::kThreads) {
        const int rho = t / k;
        const int64_t j = rows[t - rho * k];
        // out-of-range rows read NaN, as jnp.take's default fill mode does
        const float val = (j >= 0 && j < kD) ? tile[swz(rho * kD + static_cast<int>(j))] * scale
                                             : __int_as_float(0x7fc00000);
        o[t] = from_f32<T>(val);
      }
    }
  }
}

template <typename T, int LOG_D>
int launch_fwht(const void* x, const void* signs, const void* rows, void* out, long long n_rows,
                int k, float scale, cudaStream_t stream) {
  using BF = Butterfly<LOG_D>;
  constexpr int kGroups = BF::kWarps == 1 ? kGroupsSmall : 1;
  constexpr int kThreads = kGroups * BF::kThreads;
  const size_t smem = sizeof(float) * kGroups * BF::kTile;
  auto kernel = fwht_butterfly_kernel<T, LOG_D>;
  cudaError_t err = prepare_smem(kernel, smem);
  const long long tasks = (n_rows + BF::kRows - 1) / BF::kRows;
  int blocks = 0;
  if (err == cudaSuccess) {
    err = persistent_grid(kernel, kThreads, smem, (tasks + kGroups - 1) / kGroups, &blocks);
  }
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(signs),
      static_cast<const int64_t*>(rows), static_cast<T*>(out), n_rows, k, scale);
  return cudaGetLastError();
}

template <typename T>
int fwht(const void* x, const void* signs, const void* rows, void* out, long long n_rows, int d,
         int k, float scale, void* stream) {
  if (n_rows == 0) return cudaSuccess;
  return with_log_d<15>(log2_exact(d), [&](auto log_d) {
    return launch_fwht<T, decltype(log_d)::value>(x, signs, rows, out, n_rows, k, scale,
                                                  static_cast<cudaStream_t>(stream));
  });
}

}  // namespace repro_torch

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int fwht_f32(const void* x, const void* signs, const void* rows, void* out, long long n_rows,
             int d, int k, float scale, void* stream) {
  return repro_torch::fwht<float>(x, signs, rows, out, n_rows, d, k, scale, stream);
}

int fwht_bf16(const void* x, const void* signs, const void* rows, void* out, long long n_rows,
              int d, int k, float scale, void* stream) {
  return repro_torch::fwht<__nv_bfloat16>(x, signs, rows, out, n_rows, d, k, scale, stream);
}

}  // extern "C"
