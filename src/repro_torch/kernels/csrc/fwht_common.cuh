// Shared pieces of the Hopper FWHT kernels (fwht.cu, srht_fused.cu).
//
// Every kernel here runs the unnormalised Sylvester-order butterfly of
// kernels/ref.py::fwht_ref: for h = 1, 2, 4, ..., d/2 the pair (j, j + h)
// inside each block of 2h becomes (a + b, a - b). Doing exactly the
// reference's adds in the reference's order makes every output bitwise equal
// to the plain version, on any float input. The sources are built with
// -fmad=false so that no multiply followed by an add is contracted into an
// FMA, which would round differently.
//
// Two forms of it:
//   * fwht_smem: one row in shared memory, one __syncthreads a stage (K2);
//   * Butterfly<LOG_D>: the row in registers (K1, K3, K4), described below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The register-resident butterfly (K1 fwht.cu, K3 and K4 srht_fused.cu).
//
// Every thread holds 32 floats of a tile in registers. A group of threads
// owns one tile: one warp and 1024 elements (1024 / d rows) for d <= 1024,
// or d / 32 threads (a whole block) and one row for d > 1024. Element p of
// the tile sits in one of three layouts (g: thread of the group, w = g / 32,
// l = g % 32, r: register):
//
//   A   p = 32 g + r                              r holds bits 0-4 of p
//   B   p = 1024 w + 32 r + l                     r holds bits 5-9
//   C   p = 1024 (r % W) + 32 W (r / W) + g       r % W holds bits 10.. (W = d / 1024)
//
// A stage whose pair distance lies in the register bits is 16 register adds
// and 16 register subtracts, with no barrier. The transform runs layout A's
// stages (h = 1 .. 16), moves the tile to layout B through the group's
// shared-memory tile (one store, __syncwarp, one load), runs B's stages
// (h = 32 .. 512) and, for d > 1024, moves to C across the row's warps
// (__syncthreads) for the rest. So the stages keep the reference's order
// and every element crosses shared memory twice (three times above 1024),
// not twice a stage. After the transform a thread holds final_index(g, r):
// for each r the 32 lanes of a warp hold 32 consecutive elements, so a
// store of one register is a coalesced 128-byte line.
//
// The shared tile is swizzled, element p at swz(p): bits 5-7 of p flip bits
// 2-4. A 16-byte access of layout A (lane l, 4 consecutive elements of its
// own 32), a 4-byte access of layout B or C and a 16-byte access of a
// coalesced global row (lane l, vector q * threads + g) then each hit every
// bank once per quarter warp (16 bytes) or warp (4 bytes): no conflicts.
__device__ __forceinline__ int swz(int p) { return p ^ (((p >> 5) & 7) << 2); }

template <int LOG_D>
struct Butterfly {
  static constexpr int kD = 1 << LOG_D;
  static constexpr int kTile = kD < 1024 ? 1024 : kD;  // elements a group holds
  static constexpr int kWarps = kTile / 1024;          // warps a group (W)
  static constexpr int kThreads = kTile / 32;          // threads a group
  static constexpr int kRows = kTile / kD;             // rows a group holds
  static constexpr int kStagesA = LOG_D < 5 ? LOG_D : 5;
  static constexpr int kStagesB = LOG_D < 5 ? 0 : (LOG_D < 10 ? LOG_D - 5 : 5);
  static constexpr int kStagesC = LOG_D > 10 ? LOG_D - 10 : 0;

  // orders the group's shared-memory accesses
  __device__ static __forceinline__ void sync() {
    if constexpr (kWarps == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }

  // tile element held in register r by thread g after the transform
  __device__ static __forceinline__ int final_index(int g, int r) {
    if constexpr (kWarps == 1) {
      return 32 * r + g;
    } else {
      return 1024 * (r % kWarps) + 32 * kWarps * (r / kWarps) + g;
    }
  }

  // Shared-tile addresses, each written as a few registers plus a constant
  // of the unrolled r or q, which spares ptxas a live address a register.
  // a_addr(g, q) = swz(32 g + 4 q): float4 q of layout A
  __device__ static __forceinline__ int a_addr(int g, int q) { return 32 * g + 4 * (q ^ (g & 7)); }

  // b_addr(g, r) = swz(1024 w + 32 r + l): bits 5-7 of the element are r's
  __device__ static __forceinline__ int b_addr(int g, int r) {
    return 1024 * (g >> 5) + 32 * r + ((g & 31) ^ ((r & 7) << 2));
  }

  // final_addr(g, r) = swz(final_index(g, r)): above 1024 the bits of
  // 32 W (r / W) and of g are disjoint, so bits 5-7 are theirs xored
  __device__ static __forceinline__ int final_addr(int g, int r) {
    if constexpr (kWarps == 1) {
      return b_addr(g, r);
    } else {
      const int hi = kWarps * (r / kWarps);
      return 1024 * (r % kWarps) + 32 * hi + (swz(g) ^ ((hi & 7) << 2));
    }
  }

  // the stages of register bits 0 .. COUNT-1, lowest first
  template <int COUNT>
  __device__ static __forceinline__ void stages(float (&v)[32]) {
#pragma unroll
    for (int s = 0; s < COUNT; ++s) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        if ((r & (1 << s)) == 0) {
          const float a = v[r];
          const float b = v[r + (1 << s)];
          v[r] = a + b;
          v[r + (1 << s)] = a - b;
        }
      }
    }
  }

  // layout A: thread g's 32 consecutive elements, 16 bytes at a time
  __device__ static __forceinline__ void load_a(float (&v)[32], const float* tile, int g) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(tile + a_addr(g, q));
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }

  __device__ static __forceinline__ void store_a(const float (&v)[32], float* tile, int g) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      *reinterpret_cast<float4*>(tile + a_addr(g, q)) =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }

  // H_d on every row of the group's tile. On entry v holds layout A (the
  // thread's own positions of `tile`, which no other thread may still be
  // reading); on exit final_index(g, r), each thread having last read from
  // `tile` only the positions it now holds.
  __device__ static __forceinline__ void transform(float (&v)[32], float* tile, int g) {
    stages<kStagesA>(v);
    store_a(v, tile, g);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 32; ++r) v[r] = tile[b_addr(g, r)];
    stages<kStagesB>(v);
    if constexpr (kWarps > 1) {
#pragma unroll
      for (int r = 0; r < 32; ++r) tile[b_addr(g, r)] = v[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 32; ++r) v[r] = tile[final_addr(g, r)];
      stages<kStagesC>(v);
    }
  }
};

// Calls fn(std::integral_constant<int, L>) for L = log_d in [1, MAX_LOG_D].
template <int MAX_LOG_D, int L = 1, typename Fn>
inline int with_log_d(int log_d, Fn&& fn) {
  if constexpr (L > MAX_LOG_D) {
    return cudaErrorInvalidValue;
  } else {
    if (log_d == L) return fn(std::integral_constant<int, L>{});
    return with_log_d<MAX_LOG_D, L + 1>(log_d, fn);
  }
}

inline int log2_exact(int d) {
  int l = 0;
  while ((1 << l) < d) ++l;
  return (1 << l) == d ? l : -1;
}

// Blocks of a persistent grid: as many as fit on the card at once, at most `want`.
template <typename K>
inline cudaError_t persistent_grid(K kernel, int threads, size_t smem, long long want,
                                   int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return err;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *blocks = static_cast<int>(want < cap ? want : cap);
  return cudaSuccess;
}

// Threads per block of fwht_smem's kernels: one per butterfly pair, between one warp and 256.
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
