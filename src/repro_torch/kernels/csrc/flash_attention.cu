// Hopper port of src/repro/kernels/flash_attention.py::flash_attention_pallas
// (its body `_kernel`) for float32: causal GQA attention with an online
// softmax,
//
//     o[n, i] = softmax_j(mask(i, j) ? (scale * q[n, i]) . k[n / rep, j] : -1e9) @ v[n / rep]
//
// with query i at absolute position q_offset + i, key j allowed when
// j <= q_offset + i (and q_offset + i - j < window when window > 0). float32
// in and out, float32 arithmetic throughout. As in the Pallas body, q is
// scaled by 1/sqrt(dh) BEFORE the product, masked scores are -1e9,
// p = mask ? exp(s - m) : 0, and the output is acc / max(l, 1e-30). bf16
// inputs take the tensor-core kernel of flash_attention_tc.cu instead: on
// the tensor cores float32 would run as TF32, which the float32 tolerances
// (2e-5) do not allow.
//
// Bound on an H100 at the serve shape in float32 (q (32, 2048, 256), k/v
// (16, 2048, 256)): operations. One launch moves about 201 MB (60 us at
// 3.35 TB/s) and does 51.6 GFLOP with a 1024 window or 68.8 GFLOP causal:
// 0.77 / 1.03 ms at the 67 TFLOP/s of float32 outside the tensor cores.
//
// Design. The TPU grid walks (head, q tile, kv tile) in order and carries m,
// l and the accumulator in VMEM from one kv step to the next. Blocks on
// Hopper run in parallel and in no order, so one block owns one (head, q
// tile) and loops over the kv tiles itself, visiting only those the causal
// frontier and the window can reach (the others are fully masked and change
// nothing). The q tile, the current K or V tile and the P tile sit in
// dynamic shared memory as float32 with padded rows (no bank conflicts); m,
// l and the (64 x dh) accumulator live in registers, each thread owning 4
// rows: the row max and sum are reduced with warp shuffles over the 16
// threads that share those rows, so the softmax never leaves registers.
// K and V share one buffer (K for QK^T, then V for PV), which keeps the
// footprint at 147 KB for dh = 256. Products are float32 FMAs on the CUDA
// cores, written as explicit fmaf calls (the sources build with -fmad=false,
// which only stops the compiler contracting a separate multiply and add).
// Blocks take the q tiles longest first, so the causal tail fills the card.
#include "fwht_common.cuh"

namespace repro_torch {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 64;       // keys per kv tile
constexpr int kFaThreads = 256;
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Rows [row0, row0 + tile_rows) of a (rows, dh) matrix into shared memory
// (row stride ld floats), times `scale`; rows past `rows` and columns past
// dh (up to the padded width dhp) are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int rows, int dh,
                                          int dhp, int ld, float scale, int tile_rows) {
  const int chunks = dhp / 4;
  for (int idx = threadIdx.x; idx < tile_rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows && c < dh) {
      v = load4(src + static_cast<size_t>(row0 + r) * dh + c);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    store4(dst + r * ld + c, v);
  }
}

// One block per (q row group n, q tile). Thread t owns rows 4 * (t / 16) + i,
// i < 4, of the tile: score columns t % 16 + 16 j (j < 4) and output columns
// 4 * (t % 16) + 64 c + {0..3} (c < DHP / 64).
template <int DHP>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int sq, int sk, int dh,
                       int rep, int window, int q_offset, float scale) {
  constexpr int LD = DHP + 4;    // row stride of the q and k/v tiles
  constexpr int LDP = kBKV + 4;  // row stride of the p tile
  constexpr int NC = DHP / 64;   // float4 output chunks per thread and row
  extern __shared__ __align__(16) float fa_smem[];
  float* s_q = fa_smem;             // kBQ x LD
  float* s_kv = s_q + kBQ * LD;     // kBKV x LD: K, then V
  float* s_p = s_kv + kBKV * LD;    // kBQ x LDP

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int n = blockIdx.y;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* qn = q + static_cast<size_t>(n) * sq * dh;
  const float* kn = k + static_cast<size_t>(n / rep) * sk * dh;
  const float* vn = v + static_cast<size_t>(n / rep) * sk * dh;

  load_tile(s_q, qn, q0, sq, dh, DHP, LD, scale, kBQ);

  // the keys this tile's rows can reach: [k_lo, k_hi)
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_hi = min(sk, q_last + 1);
  const int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;

  float m[4], l[4];
  float acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }
  }

  for (int k0 = (k_lo / kBKV) * kBKV; k0 < k_hi; k0 += kBKV) {
    __syncthreads();  // the previous tile's P and V are read
    load_tile(s_kv, kn, k0, sk, dh, DHP, LD, 1.f, kBKV);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < dh; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(s_q + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = load4(s_kv + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb[j].x, t);
          t = fmaf(qa[i].y, kb[j].y, t);
          t = fmaf(qa[i].z, kb[j].z, t);
          t = fmaf(qa[i].w, kb[j].w, t);
          s[i][j] = t;
        }
      }
    }

    // mask, online softmax in registers, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < sk && kpos <= qpos && (window <= 0 || qpos - kpos < window);
        s[i][j] = ok[j] ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        s_p[(ty * 4 + i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
      }
    }

    __syncthreads();  // K is read and P is complete
    load_tile(s_kv, vn, k0, sk, dh, DHP, LD, 1.f, kBKV);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_p[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = load4(s_kv + kk * LD + tx * 4 + 64 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c][0] = fmaf(p[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p[i], vv.w, acc[i][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + (static_cast<size_t>(n) * sq + row) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col < dh) {
        store4(orow + col, make_float4(acc[i][c][0] / den, acc[i][c][1] / den,
                                       acc[i][c][2] / den, acc[i][c][3] / den));
      }
    }
  }
}

template <int DHP>
int launch_flash_dhp(const void* q, const void* k, const void* v, void* o, int n_q, int sq,
                     int sk, int dh, int rep, int window, int q_offset, float scale,
                     void* stream) {
  const size_t smem = sizeof(float) * ((kBQ + kBKV) * (DHP + 4) + kBQ * (kBKV + 4));
  cudaError_t err = prepare_smem(flash_attention_kernel<DHP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, n_q);
  flash_attention_kernel<DHP><<<grid, kFaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, sk, dh, rep, window, q_offset, scale);
  return cudaGetLastError();
}

int launch_flash(const void* q, const void* k, const void* v, void* o, int n_q, int sq, int sk,
                 int dh, int rep, int window, int q_offset, float scale, void* stream) {
  if (dh < 8 || dh > 256 || dh % 8 != 0 || rep < 1 || n_q % rep != 0 || n_q > 65535 || sk < 1 ||
      q_offset < 0) {
    return cudaErrorInvalidValue;
  }
  if (n_q == 0 || sq == 0) return cudaSuccess;
  if (dh <= 64) {
    return launch_flash_dhp<64>(q, k, v, o, n_q, sq, sk, dh, rep, window, q_offset, scale,
                                   stream);
  }
  if (dh <= 128) {
    return launch_flash_dhp<128>(q, k, v, o, n_q, sq, sk, dh, rep, window, q_offset, scale,
                                    stream);
  }
  return launch_flash_dhp<256>(q, k, v, o, n_q, sq, sk, dh, rep, window, q_offset, scale,
                                  stream);
}

}  // namespace repro_torch

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int n_q, int sq,
                        int sk, int dh, int rep, int window, int q_offset, float scale,
                        void* stream) {
  return repro_torch::launch_flash(q, k, v, o, n_q, sq, sk, dh, rep, window, q_offset, scale,
                                    stream);
}

}  // extern "C"
