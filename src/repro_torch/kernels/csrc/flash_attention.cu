// Hopper port of src/repro/kernels/flash_attention.py::flash_attention_pallas
// (its body `_kernel`) for float32, on the tensor cores in split TF32:
// causal GQA attention with an online softmax,
//
//     o[n, i] = softmax_j(mask(i, j) ? scale * (q[n, i] . k[n / rep, j]) : -1e9) @ v[n / rep]
//
// with query i at absolute position q_offset + i, key j allowed when
// j <= q_offset + i (and q_offset + i - j < window when window > 0). float32
// in and out. bf16 inputs take the wgmma kernel of flash_attention_tc.cu.
//
// Numerics against the Pallas body, which multiplies in float32:
// - Both products, S = Q K^T and O += P V, run as mma.sync m16n8k8 TF32 ->
//   f32 in split TF32: every operand fragment x is split in registers as
//   hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (|x - hi - lo| <=
//   2^-22 |x|; the rounding done as bit arithmetic, tf32() below), and each
//   pair of fragments takes three products into the same float32
//   accumulator, the small terms first: lo hi, hi lo, hi hi (the lo lo
//   term, below 2^-22 of the product, is dropped). Plain TF32 would keep 11
//   bits of each operand, which the float32 tolerances (2e-5) do not allow.
// - The scale 1/sqrt(dh) multiplies S after the product (Pallas scales q
//   before it): exact for dh 64 and 256, one f32 rounding apart otherwise.
//   log2(e) is folded into that scale, so the exponentials are exp2
//   (ex2.approx).
// - m and l are f32 and m starts at -1e9. A masked score enters the row max
//   and the exponential as -inf: with m never below -1e9 this gives exactly
//   the Pallas body's -1e9 fill and p = 0 where masked. l sums P in f32.
// - The output is acc / max(l, 1e-30).
//
// Bound on an H100 at the serve shape (q (32, 2048, 256), k/v (16, 2048,
// 256)): operations. One launch moves about 201 MB (60 us at 3.35 TB/s) and
// does 51.6 GFLOP with a 1024 window or 68.8 GFLOP causal. The faster of the
// card's two float32-accurate ways to do that is split TF32 on the tensor
// cores, 495 / 3 = 165 TFLOP/s against 67 on the CUDA cores: 0.31 / 0.42 ms.
//
// Why mma.sync and not wgmma: TF32 wgmma takes K-major operands only, V is
// (keys, d_head) and so MN-major for P V, and an operand in shared memory
// cannot be split without a pass over the tile. mma.sync fragments load
// from any layout and split in registers.
//
// Design. One block owns one (q row group n, BQ-row q tile) and loops over
// the kv tiles that the causal frontier and the window reach; blocks are
// numbered longest causal rows first across all heads.
// - A producer warpgroup (one thread issues) keeps TMA loads in flight: the
//   Q tile once, then K and V tiles into a ring of two stages, each with a
//   "full" mbarrier for K and one for V, and an "empty" one for each that
//   the consumers release as soon as they are done with it (K after S, V
//   after P V), so tile i + 2 arrives while tile i + 1 is computed.
// - Each consumer warp owns 16 q rows. Per kv tile: S = Q K^T (16 x BKV),
//   the mask on tiles that the diagonal, the window edge or Sk cross, the
//   online softmax in registers on the accumulator's layout (row g and
//   g + 8 of the warp, columns 2t, 2t + 1 of every 8, g = lane / 4,
//   t = lane % 4; the row max and sum are quad shuffles), then O += P V with
//   P straight from S's registers (below). A tile none of a warp's rows
//   reaches is waited for and released, not computed.
// - setmaxnreg moves registers from the producer (24) to the 8 consumer
//   warps (240).
//
// Fragments and the swizzle. Tiles arrive as TMA boxes of 32 float32
// columns (128 bytes) x rows with the 128-byte swizzle: 16-byte chunk c of
// box row r sits at chunk c ^ (r % 8). A product's reduction index may be
// permuted as long as both operands follow it, and every fragment load is
// one 16-byte load:
// - S = Q K^T, per box of 32 columns of d: thread (g, t) loads chunks 2t and
//   2t + 1 of its rows (Q rows g and g + 8 of the warp, K row g of each
//   8-key n-tile); k-step s (0..3) takes element s of each, i.e. m16n8k8's
//   k index t is column 8t + s and t + 4 is 8t + 4 + s. A quarter warp
//   (lanes g = 2h, 2h + 1) then reads chunks {2t ^ g} and {(2t + 1) ^ g}:
//   eight distinct chunks, all 32 banks, no conflict.
// - O += P V, per 8-key step: key 2t is k index t and key 2t + 1 is t + 4,
//   so S's accumulator registers (keys 2t, 2t + 1 of rows g, g + 8) are
//   P's A fragment as they stand: no shuffle, no trip through shared
//   memory. V's B fragment then needs keys 2t and 2t + 1 at output column
//   n = g: thread (g, t) loads chunk g of V rows 2t and 2t + 1, four n-tiles
//   at once (n-tile q of a box: column 4g + q). A quarter warp (g = 2h,
//   2h + 1; t = 0..3) reads chunks g ^ 2t (or g ^ (2t + 1)): eight distinct
//   chunks. The accumulator of n-tile q holds columns 8t + q and 8t + 4 + q
//   of the box, so each thread ends with 8 contiguous columns a row and
//   box, stored as two float4.
//
// Tiles and shared memory (Q BQ x DHP f32, a K or V stage BKV x DHP, two
// stages of each, 128 bytes of mbarriers, 1024 bytes of slack to align the
// base for the swizzle); one block a SM, 8 consumer warps and a producer
// warpgroup (384 threads):
//   DHP 256: BQ 128, BKV 24: Q 128 KB + 4 x 24 KB = 224 KB (230,528 bytes)
//   DHP 128: BQ 128, BKV 64: Q  64 KB + 4 x 32 KB = 192 KB
//   DHP  64: BQ 128, BKV 64: Q  32 KB + 4 x 16 KB =  96 KB
// At DHP 256, BQ 128 with BKV 24 was the fastest of the layouts timed at
// the serve shape (BKV 16, and BQ 64 with BKV 32; PERF.md).
// Registers a consumer thread at DHP 256: O 16 x 256 f32 over 32 lanes is
// 128, S BKV / 2, a box of Q fragments split 32; chip_smoke.py fails the
// build if ptxas (-Xptxas -v) reports a spill.
//
// What bounds it (inferred from the SASS; PERF.md): the splits. Each is two
// integer instructions for hi, a subtraction and two more for lo, and every
// warp splits its own fragments, Q's again for every kv tile: about 520
// splits a warp and 24-key tile against 576 mma.sync, about six issued
// instructions a product in all.
//
// Built with the other sources' flags, -fmad=false included: the products
// are mma instructions and the softmax's few scalar multiply-adds do not
// need contracting. Its times on an H100 are in PERF.md (chip_smoke.py).
#include "fwht_common.cuh"
#include "tma_pipeline.cuh"

namespace repro_torch {
namespace fa_f32 {

constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNeg = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DHP, int BQ, int BKV>
struct Layout {
  static constexpr int kBQ = BQ, kBKV = BKV;
  static constexpr int kConsumers = 32 * BQ / 16;     // consumer warps, 16 q rows each
  static constexpr int kThreads = kConsumers + 128;   // and one producer warpgroup
  static constexpr int kBoxes = DHP / 32;             // 32-column TMA boxes across a row
  static constexpr int kQBytes = BQ * DHP * 4;
  static constexpr int kKVBytes = BKV * DHP * 4;      // one K or one V stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOffset + 128 + 1024;
  // 8 consumer warps: setmaxnreg's 24 / 240 split of 384 threads assumes it
  static_assert(BQ == 128 && BKV % 8 == 0 && kSmem <= kMaxSmemBytes, "layout");
};

// the layout each padded d_head runs
template <int DHP>
struct Pick;
template <>
struct Pick<64> {
  using L = Layout<64, 128, 64>;
};
template <>
struct Pick<128> {
  using L = Layout<128, 128, 64>;
};
template <>
struct Pick<256> {
  using L = Layout<256, 128, 24>;
};

__device__ __forceinline__ float4 lds4(const uint8_t* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to 10 mantissa
// bits) for every x but a NaN: add half of the lowest kept bit to the
// magnitude's bits, then clear the 13 bits below it. Two integer
// instructions; the cvt itself compiles to four (with a NaN test).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, two TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32: lo hi, hi lo, hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], uint32_t b0_hi, uint32_t b1_hi,
                                     uint32_t b0_lo, uint32_t b1_lo) {
  mma(d, a_lo, b0_hi, b1_hi);
  mma(d, a_hi, b0_lo, b1_lo);
  mma(d, a_hi, b0_hi, b1_hi);
}

__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int DHP, int BQ, int BKV>
__global__ void __launch_bounds__(Layout<DHP, BQ, BKV>::kThreads, 1)
flash_attention_kernel_f32_tf32(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                                int n_q, int sq, int sk, int dh, int rep, int window,
                                int q_offset, float scale_log2) {
  using L = Layout<DHP, BQ, BKV>;
  extern __shared__ uint8_t fa_smem_raw[];
  const uint32_t raw = smem_u32(fa_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint8_t* smem = fa_smem_raw + (base - raw);
  // Q: kBoxes boxes of BQ rows x 128 bytes from base; K stage s at kQBytes +
  // s kKVBytes, V stage s kStages kKVBytes further, each kBoxes boxes of BKV rows
  const uint32_t bar_q = base + L::kBarOffset;  // then k_full[2], v_full[2], k_empty[2], v_empty[2]
  const uint32_t k_full = bar_q + 8, v_full = bar_q + 24, k_empty = bar_q + 40,
                 v_empty = bar_q + 56;

  const int n_qt = (sq + BQ - 1) / BQ;
  const int n = blockIdx.x % n_q;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_q) * BQ;  // longest rows first
  // the keys this tile's rows can reach, [k_lo, k_hi), in whole kv tiles from kt0
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + BQ, sq) - 1;
  const int k_hi = min(sk, q_last + 1);
  const int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kt0 = (k_lo / BKV) * BKV;
  const int n_tiles = k_hi > kt0 ? (k_hi - kt0 + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, L::kConsumers);
      mbar_init(v_empty + 8 * s, L::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= L::kConsumers) {
    // ---- producer warpgroup: TMA loads, one thread issues them ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == L::kConsumers) {
      const int n_kv = n / rep;
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int b = 0; b < L::kBoxes; ++b) tma_load(base + b * BQ * 128, &tm_q, bar_q, 32 * b, q0, n);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = kt0 + i * BKV;
        const uint32_t k_st = base + L::kQBytes + s * L::kKVBytes;
        const uint32_t v_st = k_st + kStages * L::kKVBytes;
        // stage s was last used by tile i - kStages: wait until every consumer released it
        const uint32_t parity = (i / kStages - 1) & 1;
        if (i >= kStages) mbar_wait(k_empty + 8 * s, parity);
        mbar_expect_tx(k_full + 8 * s, L::kKVBytes);
        for (int b = 0; b < L::kBoxes; ++b) {
          tma_load(k_st + b * BKV * 128, &tm_k, k_full + 8 * s, 32 * b, k0, n_kv);
        }
        if (i >= kStages) mbar_wait(v_empty + 8 * s, parity);
        mbar_expect_tx(v_full + 8 * s, L::kKVBytes);
        for (int b = 0; b < L::kBoxes; ++b) {
          tma_load(v_st + b * BKV * 128, &tm_v, v_full + 8 * s, 32 * b, k0, n_kv);
        }
      }
    }
    return;
  }

  // ---- consumer warps ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = threadIdx.x >> 5;  // rows 16 warp .. 16 warp + 15 of the q tile
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp;  // the warp's first q row
  const bool has_rows = row0 < sq;
  const int w_first = q_offset + row0;  // positions of its first and last rows
  const int w_last = q_offset + min(row0 + 16, sq) - 1;
  const int wk_hi = min(sk, w_last + 1);  // the keys its rows reach: [wk_lo, wk_hi)
  const int wk_lo = window > 0 ? max(0, w_first - window + 1) : 0;
  const int pos0 = w_first + g, pos1 = pos0 + 8;  // this thread's rows' positions
  const float kNegInf = -__int_as_float(0x7f800000);

  // Fragment offsets in bytes into a box (see the header). S = Q K^T: chunks
  // 2t and 2t + 1 of a row r with r % 8 = g (Q rows g and g + 8 of the warp,
  // 1024 bytes apart; K row g of n-tile j, at 1024 j). O += P V: chunk g of
  // V rows 2t and 2t + 1 of each 8-key step (at 1024 j).
  const uint32_t ch_even = static_cast<uint32_t>((2 * t) ^ g) << 4;
  const uint32_t ch_odd = static_cast<uint32_t>((2 * t + 1) ^ g) << 4;
  const uint8_t* q_rows = smem + (16 * warp + g) * 128;
  const uint32_t k_row = g * 128;
  const uint32_t v_off0 = 2 * t * 128 + (static_cast<uint32_t>(g ^ (2 * t)) << 4);
  const uint32_t v_off1 = (2 * t + 1) * 128 + (static_cast<uint32_t>(g ^ (2 * t + 1)) << 4);

  float acc[L::kBoxes][4][4];
#pragma unroll
  for (int b = 0; b < L::kBoxes; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][q][e] = 0.f;
    }
  }
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = kt0 + i * BKV;
    const uint8_t* k_st = smem + L::kQBytes + s * L::kKVBytes;
    const uint8_t* v_st = k_st + kStages * L::kKVBytes;
    mbar_wait(k_full + 8 * s, parity);
    if (!(has_rows && k0 < wk_hi && k0 + BKV > wk_lo)) {
      // none of the warp's rows reaches this tile
      mbar_arrive(k_empty + 8 * s);
      mbar_wait(v_full + 8 * s, parity);
      mbar_arrive(v_empty + 8 * s);
      continue;
    }

    // S = Q K^T: per box of 32 columns, 4 k-steps of 8
    float sc[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    }
#pragma unroll
    for (int b = 0; b < L::kBoxes; ++b) {
      const uint8_t* qb = q_rows + b * BQ * 128;
      const float4 q0e = lds4(qb + ch_even), q0o = lds4(qb + ch_odd);
      const float4 q1e = lds4(qb + 1024 + ch_even), q1o = lds4(qb + 1024 + ch_odd);
      uint32_t a_hi[4][4], a_lo[4][4];  // k-step s: rows g, g + 8 at k t; rows g, g + 8 at t + 4
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        split(elem(q0e, ks), a_hi[ks][0], a_lo[ks][0]);
        split(elem(q1e, ks), a_hi[ks][1], a_lo[ks][1]);
        split(elem(q0o, ks), a_hi[ks][2], a_lo[ks][2]);
        split(elem(q1o, ks), a_hi[ks][3], a_lo[ks][3]);
      }
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const uint8_t* kb = k_st + b * BKV * 128 + j * 1024 + k_row;
        const float4 ke = lds4(kb + ch_even), ko = lds4(kb + ch_odd);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
          split(elem(ke, ks), b0_hi, b0_lo);
          split(elem(ko, ks), b1_hi, b1_lo);
          mma3(sc[j], a_hi[ks], a_lo[ks], b0_hi, b1_hi, b0_lo, b1_lo);
        }
      }
    }
    mbar_arrive(k_empty + 8 * s);  // this thread's reads of the K stage are done

    // scale (log2 e folded in), mask where the diagonal, the window edge or
    // Sk crosses the tile (-inf: see the header), row max
    const bool edge = k0 + BKV - 1 > w_first || k0 + BKV > sk ||
                      (window > 0 && w_last - k0 >= window);
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = sc[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int pos = (e & 2) ? pos1 : pos0;
          if (key >= sk || key > pos || (window > 0 && pos - key >= window)) v = kNegInf;
        }
        sc[j][e] = v;
        if (e & 2) {
          mx1 = fmaxf(mx1, v);
        } else {
          mx0 = fmaxf(mx0, v);
        }
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P = exp2(t - m) in place (0 where masked)
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      sc[j][0] = ex2(sc[j][0] - mn0);
      sc[j][1] = ex2(sc[j][1] - mn0);
      sc[j][2] = ex2(sc[j][2] - mn1);
      sc[j][3] = ex2(sc[j][3] - mn1);
      rs0 += sc[j][0] + sc[j][1];
      rs1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * corr0 + quad_sum(rs0);
    l1 = l1 * corr1 + quad_sum(rs1);
    if (__any_sync(0xffffffffu, corr0 != 1.f || corr1 != 1.f)) {
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[b][q][0] *= corr0;
          acc[b][q][1] *= corr0;
          acc[b][q][2] *= corr1;
          acc[b][q][3] *= corr1;
        }
      }
    }

    // O += P V: per 8-key step j, P's A fragment is S's registers of n-tile
    // j (key 2t = k index t, key 2t + 1 = t + 4); per box, V rows 2t and
    // 2t + 1 give the B fragments of its four n-tiles
    mbar_wait(v_full + 8 * s, parity);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      uint32_t p_hi[4], p_lo[4];
      split(sc[j][0], p_hi[0], p_lo[0]);
      split(sc[j][2], p_hi[1], p_lo[1]);
      split(sc[j][1], p_hi[2], p_lo[2]);
      split(sc[j][3], p_hi[3], p_lo[3]);
      const uint8_t* vj = v_st + j * 1024;
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) {
        const float4 va = lds4(vj + b * BKV * 128 + v_off0);
        const float4 vb = lds4(vj + b * BKV * 128 + v_off1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
          split(elem(va, q), b0_hi, b0_lo);
          split(elem(vb, q), b1_hi, b1_lo);
          mma3(acc[b][q], p_hi, p_lo, b0_hi, b1_hi, b0_lo, b1_lo);
        }
      }
    }
    mbar_arrive(v_empty + 8 * s);  // this thread's reads of the V stage are done
  }

  if (has_rows) {
    // each thread: columns 32 b + 8 t .. + 7 of rows g and g + 8 of the warp
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
    for (int b = 0; b < L::kBoxes; ++b) {
      const int col = 32 * b + 8 * t;
      if (col >= dh) continue;
      if (r0 < sq) {
        float* out = o + (static_cast<size_t>(n) * sq + r0) * dh + col;
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[b][0][0] / den0, acc[b][1][0] / den0, acc[b][2][0] / den0,
                        acc[b][3][0] / den0);
        *reinterpret_cast<float4*>(out + 4) =
            make_float4(acc[b][0][1] / den0, acc[b][1][1] / den0, acc[b][2][1] / den0,
                        acc[b][3][1] / den0);
      }
      if (r1 < sq) {
        float* out = o + (static_cast<size_t>(n) * sq + r1) * dh + col;
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[b][0][2] / den1, acc[b][1][2] / den1, acc[b][2][2] / den1,
                        acc[b][3][2] / den1);
        *reinterpret_cast<float4*>(out + 4) =
            make_float4(acc[b][0][3] / den1, acc[b][1][3] / den1, acc[b][2][3] / den1,
                        acc[b][3][3] / den1);
      }
    }
  }
}

template <int DHP>
int launch_dhp(const void* q, const void* k, const void* v, void* o, int n_q, int sq, int sk,
               int dh, int rep, int window, int q_offset, float scale, void* stream) {
  using L = typename Pick<DHP>::L;
  constexpr int BQ = L::kBQ, BKV = L::kBKV;
  const long long blocks = static_cast<long long>(n_q) * ((sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap map_q, map_k, map_v;
  cudaError_t err = make_map(&map_q, kF32, 4, q, dh, sq, n_q, BQ);
  if (err == cudaSuccess) err = make_map(&map_k, kF32, 4, k, dh, sk, n_q / rep, BKV);
  if (err == cudaSuccess) err = make_map(&map_v, kF32, 4, v, dh, sk, n_q / rep, BKV);
  auto kernel = flash_attention_kernel_f32_tf32<DHP, BQ, BKV>;
  if (err == cudaSuccess) err = prepare_smem(kernel, L::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, L::kSmem,
           static_cast<cudaStream_t>(stream)>>>(map_q, map_k, map_v, static_cast<float*>(o), n_q,
                                                sq, sk, dh, rep, window, q_offset,
                                                scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace fa_f32
}  // namespace repro_torch

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int n_q, int sq,
                        int sk, int dh, int rep, int window, int q_offset, float scale,
                        void* stream) {
  using namespace repro_torch::fa_f32;
  if (dh < 8 || dh > 256 || dh % 8 != 0 || rep < 1 || n_q % rep != 0 || n_q > 65535 || sk < 1 ||
      q_offset < 0 || window < 0) {
    return cudaErrorInvalidValue;
  }
  if (n_q == 0 || sq == 0) return cudaSuccess;
  if (dh <= 64) {
    return launch_dhp<64>(q, k, v, o, n_q, sq, sk, dh, rep, window, q_offset, scale, stream);
  }
  if (dh <= 128) {
    return launch_dhp<128>(q, k, v, o, n_q, sq, sk, dh, rep, window, q_offset, scale, stream);
  }
  return launch_dhp<256>(q, k, v, o, n_q, sq, sk, dh, rep, window, q_offset, scale, stream);
}

}  // extern "C"
