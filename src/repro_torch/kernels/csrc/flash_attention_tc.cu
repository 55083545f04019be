// Hopper tensor-core form of src/repro/kernels/flash_attention.py::flash_attention_pallas
// (its body `_kernel`) for bfloat16: causal GQA attention with an online softmax,
//
//     o[n, i] = softmax_j(mask(i, j) ? scale * (q[n, i] . k[n / rep, j]) : -1e9) @ v[n / rep]
//
// with query i at absolute position q_offset + i, key j allowed when
// j <= q_offset + i (and q_offset + i - j < window when window > 0). bf16 in,
// bf16 out. float32 inputs take the split-TF32 kernel of flash_attention.cu;
// this kernel takes bf16 only.
//
// Numerics against the Pallas body, which casts q, k, v to f32 and multiplies
// in f32:
// - S = Q K^T on the tensor cores, bf16 x bf16 -> f32. A product of two bf16
//   values is exact in f32, so S differs from the Pallas body only in the
//   order of its sums.
// - The scale 1/sqrt(dh) multiplies S after the product (Pallas scales q
//   before it): exact for dh 64 and 256, one f32 rounding apart otherwise.
//   log2(e) is folded into that scale, so the exponentials are exp2 (ex2.approx).
// - Masked scores are -1e9 and p is 0 where masked; m and l are f32.
// - P (f32) enters the P V product as two bf16 values, P_hi = bf16(P) and
//   P_lo = bf16(P - P_hi), which carry about 16 significant bits of it
//   (|P - P_hi - P_lo| <= 2^-16 P): two bf16 x bf16 -> f32 products into
//   the same accumulator, P_lo V first, then P_hi V. The Pallas body
//   multiplies an f32 P by V; V is bf16 on both sides. l sums P_hi + P_lo,
//   the values that enter the product, so each output row is a convex
//   combination of V's rows.
// - The output is acc / max(l, 1e-30), rounded to bf16.
//
// Bound on an H100 at the serve shape (gemma3-4b prefill, q (32, 2048, 256),
// k/v (16, 2048, 256)): operations. One launch moves 100.7 MB (30 us at
// 3.35 TB/s) and does 51.6 GFLOP with a 1024 window or 68.8 GFLOP causal
// (52 / 70 us at the tensor cores' 989 TFLOP/s).
//
// Design. One block owns one (q row group n, 128-row q tile) and loops over
// the kv tiles that the causal frontier and the window reach, longest causal
// rows first (blockIdx.y counts the q tiles down; blockIdx.x is n, so all
// heads' last tiles launch first). 384 threads:
// - warpgroup 2 (the producer; one thread issues) keeps TMA loads in flight:
//   the Q tile once, then K and V tiles into a ring of two stages, each
//   stage with a "full" mbarrier for K, one for V, and an "empty" one that
//   the consumers release.
// - warpgroups 0 and 1 (the consumers) own q rows 64 w .. 64 w + 63. Per kv
//   tile: S = Q K^T by wgmma (m64nBKVk16, both operands from shared memory,
//   K-major), the mask on tiles that the diagonal, the window edge or Sk
//   cross, the online softmax in registers on the accumulator's layout (each
//   thread holds two rows; the row max and sum are quad shuffles), then
//   O += P V by two wgmmas a 16-key step (P_lo, then P_hi) with P from
//   registers (the RS form) and V from shared memory with the transpose bit
//   (V is stored MN-major). A tile none of a warpgroup's rows reaches is
//   waited for and released, not computed.
// - setmaxnreg moves registers from the producer (24) to the consumers (240).
// Loads are TMA copies of 3-D tensor maps over (dh, S, N) in boxes of 64
// columns (128 bytes) with the 128-byte swizzle that the wgmma descriptors
// name: a ragged tile never reads into the next head, and rows past Sq or Sk
// and columns past dh (up to the padded width DHP) arrive as zeros. The
// epilogue writes each warpgroup's rows, as bf16, into its own rows of the Q
// tile (no wgmma reads them any more) in the same swizzled layout, then
// copies them out 16 bytes a thread, rows past Sq and columns past dh left
// out.
//
// Tiles and shared memory for each padded width DHP (Q is 128 x DHP bf16,
// a K or V stage BKV x DHP bf16, two stages of each, 64 bytes of
// mbarriers, and 1024 bytes of slack to align the base for the swizzle):
//   DHP 256, BKV  64: Q 64 KB + 4 x 32 KB = 192 KB (197,696 bytes)
//   DHP 128, BKV 128: Q 32 KB + 4 x 32 KB = 160 KB (164,928 bytes)
//   DHP  64, BKV 128: Q 16 KB + 4 x 16 KB =  80 KB ( 83,008 bytes)
// so one block a SM. Registers a consumer thread at DHP 256: O 64 x 256 f32
// over 128 threads is 128, S 32, P_hi and P_lo 16 each (bf16 pairs); at
// DHP 128, O 64, S 64, P_hi and P_lo 32 each. chip_smoke.py fails the build
// if ptxas (-Xptxas -v) reports a spill at any DHP.
//
// Built with the other sources' flags, -fmad=false included: it touches no
// wgmma, and the softmax's few scalar multiply-adds do not need contracting.
// Its times on an H100 are in PERF.md (chip_smoke.py).
#include "fwht_common.cuh"
#include "tma_pipeline.cuh"

namespace repro_torch {
namespace fa_tc {

constexpr int kBQ = 128;                  // q rows per block
constexpr int kConsumers = 256;           // two consumer warpgroups of 64 rows each
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kStages = 2;
// setmaxnreg shares the block's registers, 168 a thread at launch (65,536 /
// 384, rounded down to a multiple of 8): 128 x 24 + 256 x 240 = 384 x 168
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNeg = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DHP>
struct Tiles {
  static constexpr int kBKV = DHP == 256 ? 64 : 128;  // keys per kv tile
  static constexpr int kBoxes = DHP / 64;              // 64-column TMA boxes across a row
  static constexpr int kQBytes = kBQ * DHP * 2;
  static constexpr int kKVBytes = kBKV * DHP * 2;      // one K or one V stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmem = kBarOffset + 64 + 1024;
};

// wgmma descriptor of a shared-memory operand in the 128-byte swizzle:
// start address, leading and stride byte offsets in 16-byte units, layout
// type 1 (B128) in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of a wgmma accumulator
// across the asynchronous product: tie the registers to this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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

// (lo, hi) rounded to a bf16 pair, lo (the lower column) in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (lo, hi) as P_hi + P_lo, two bf16 pairs (P_hi = bf16(P), P_lo =
// bf16(P - P_hi)); the values that enter the product, P_hi + P_lo, are
// added to `sum`.
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& p_hi, uint32_t& p_lo,
                                           float& sum) {
  p_hi = pack_bf16(lo, hi);
  const float2 big = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p_hi));
  p_lo = pack_bf16(lo - big.x, hi - big.y);
  const float2 small = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p_lo));
  sum += (big.x + small.x) + (big.y + small.y);
}

// m64nNk16 bf16 -> f32 wgmma. Accumulator layout (thread t of the warpgroup,
// warp w = t / 32, lane l): register i holds row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d (+)= A (64 x 16) B (16 x 64), both from shared memory, both K-major
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  // d (+)= A (64 x 16, bf16 pairs in registers) B (16 x 64, MN-major in shared
  // memory: the transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A (64 x 16) B (16 x 128), both from shared memory, both K-major
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  // d (+)= A (64 x 16, bf16 pairs in registers) B (16 x 128, MN-major in shared
  // memory: the transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  // d (+)= A (64 x 16, bf16 pairs in registers) B (16 x 256, MN-major in shared
  // memory: the transpose bit)
  __device__ __forceinline__ static void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_bf16_wgmma(const __grid_constant__ CUtensorMap tm_q,
                                  const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  __nv_bfloat16* __restrict__ o, int sq, int sk, int dh, int rep,
                                  int window, int q_offset, float scale_log2) {
  using T = Tiles<DHP>;
  constexpr int BKV = T::kBKV;
  extern __shared__ uint8_t fa_smem_raw[];
  const uint32_t raw = smem_u32(fa_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes
  uint8_t* smem = fa_smem_raw + (base - raw);
  const uint32_t s_q = base;                      // kBoxes boxes of kBQ rows x 128 bytes
  const uint32_t s_k = base + T::kQBytes;         // stage s at s_k + s * kKVBytes
  const uint32_t s_v = s_k + kStages * T::kKVBytes;
  const uint32_t bar_q = base + T::kBarOffset;    // then k_full[2], v_full[2], kv_empty[2]
  const uint32_t bar_k = bar_q + 8, bar_v = bar_q + 24, bar_empty = bar_q + 40;

  const int n = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal rows first
  // the keys this tile's rows can reach, [k_lo, k_hi), in whole kv tiles from kt0
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, sq) - 1;
  const int k_hi = min(sk, q_last + 1);
  const int k_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kt0 = (k_lo / BKV) * BKV;
  const int n_tiles = k_hi > kt0 ? (k_hi - kt0 + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: TMA loads, one thread issues them ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      const int n_kv = n / rep;
      mbar_expect_tx(bar_q, T::kQBytes);
      for (int b = 0; b < T::kBoxes; ++b) {
        tma_load(s_q + b * kBQ * 128, &tm_q, bar_q, 64 * b, q0, n);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = kt0 + i * BKV;
        // stage s was last used by tile i - kStages: wait until both consumers released it
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, (i / kStages - 1) & 1);
        mbar_expect_tx(bar_k + 8 * s, T::kKVBytes);
        for (int b = 0; b < T::kBoxes; ++b) {
          tma_load(s_k + s * T::kKVBytes + b * BKV * 128, &tm_k, bar_k + 8 * s, 64 * b, k0, n_kv);
        }
        mbar_expect_tx(bar_v + 8 * s, T::kKVBytes);
        for (int b = 0; b < T::kBoxes; ++b) {
          tma_load(s_v + s * T::kKVBytes + b * BKV * 128, &tm_v, bar_v + 8 * s, 64 * b, k0, n_kv);
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7;  // rows 64 wg .. 64 wg + 63 of the q tile
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r0 = 16 * (tid >> 5) + (lane >> 2);  // this thread's rows: r0 and r0 + 8
    const int c0 = 2 * (lane & 3);                 // and columns c0, c0 + 1 of every 8
    const int row0 = q0 + 64 * wg;                 // the warpgroup's first q row
    const bool has_rows = row0 < sq;
    const int w_first = q_offset + row0;  // positions of its first and last rows
    const int w_last = q_offset + min(row0 + 64, sq) - 1;
    const int wk_hi = min(sk, w_last + 1);  // the keys its rows reach: [wk_lo, wk_hi)
    const int wk_lo = window > 0 ? max(0, w_first - window + 1) : 0;
    const int pos0 = w_first + r0, pos1 = pos0 + 8;
    const uint32_t q_wg = s_q + 64 * wg * 128;  // the warpgroup's rows in Q box 0

    float acc[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = kt0 + i * BKV;
      const uint32_t k_st = s_k + s * T::kKVBytes, v_st = s_v + s * T::kKVBytes;
      mbar_wait(bar_k + 8 * s, parity);
      if (has_rows && k0 < wk_hi && k0 + BKV > wk_lo) {
        // S = Q K^T: DHP / 16 steps of 16 columns; 4 steps per 64-column box
        float sc[BKV / 2];
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) sc[j] = 0.f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk) {
          const uint32_t col = (kk & 3) * 32;  // bytes into the box's 128-byte rows
          Wgmma<BKV>::ss(sc, sw128_desc(q_wg + (kk >> 2) * kBQ * 128 + col, 16, 1024),
                         sw128_desc(k_st + (kk >> 2) * BKV * 128 + col, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale (log2 e folded in), mask where the diagonal, the window edge
        // or Sk crosses the tile, row max
        const bool edge = k0 + BKV - 1 > w_first || k0 + BKV > sk ||
                          (window > 0 && w_last - k0 >= window);
        uint32_t ok[BKV / 64];
#pragma unroll
        for (int w = 0; w < BKV / 64; ++w) ok[w] = 0xffffffffu;
        float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) {
          float t = sc[j] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * (j >> 2) + c0 + (j & 1);
            const int pos = (j & 2) ? pos1 : pos0;
            if (key >= sk || key > pos || (window > 0 && pos - key >= window)) {
              t = kNeg;
              ok[j >> 5] &= ~(1u << (j & 31));
            }
          }
          sc[j] = t;
          if (j & 2) {
            mx1 = fmaxf(mx1, t);
          } else {
            mx0 = fmaxf(mx0, t);
          }
        }
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        const float corr0 = ex2(m0 - mn0), corr1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;

        // P = exp2(t - m) (0 where masked) as P_hi + P_lo, bf16 pairs in the
        // A-operand layout of m64k16: for step kk, columns 16 kk .. 16 kk + 15
        // are accumulator registers 8 kk .. 8 kk + 7
        uint32_t pa_hi[BKV / 16][4], pa_lo[BKV / 16][4];
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          float p[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int j = 8 * kk + e;
            const float mrow = (j & 2) ? mn1 : mn0;
            p[e] = ((ok[j >> 5] >> (j & 31)) & 1u) ? ex2(sc[j] - mrow) : 0.f;
          }
          split_bf16(p[0], p[1], pa_hi[kk][0], pa_lo[kk][0], rs0);
          split_bf16(p[2], p[3], pa_hi[kk][1], pa_lo[kk][1], rs1);
          split_bf16(p[4], p[5], pa_hi[kk][2], pa_lo[kk][2], rs0);
          split_bf16(p[6], p[7], pa_hi[kk][3], pa_lo[kk][3], rs1);
        }
        l0 = l0 * corr0 + quad_sum(rs0);
        l1 = l1 * corr1 + quad_sum(rs1);
#pragma unroll
        for (int j = 0; j < DHP / 2; ++j) acc[j] *= (j & 2) ? corr1 : corr0;

        // O += P V: BKV / 16 steps of 16 keys (2048 bytes of V each), each
        // P_lo V, then P_hi V
        mbar_wait(bar_v + 8 * s, parity);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          const uint64_t desc = sw128_desc(v_st + kk * 16 * 128, BKV * 128, 1024);
          Wgmma<DHP>::rs(acc, pa_lo[kk], desc, 1);
          Wgmma<DHP>::rs(acc, pa_hi[kk], desc, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      } else {
        mbar_wait(bar_v + 8 * s, parity);  // none of its rows reaches this tile
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    if (has_rows) {
      // The warpgroup's rows of the Q tile are read by no wgmma any more:
      // stage its output there in the same swizzled layout (conflict-free
      // 4-byte writes), then copy it out 16 bytes a thread.
      const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        const uint32_t box = q_wg + (j >> 3) * kBQ * 128;
        const uint32_t chunk0 = static_cast<uint32_t>(((j & 7) ^ (r0 & 7)) << 4) + 2 * c0;
        // rows r0 and r0 + 8 share (row & 7), so the same chunk position
        *reinterpret_cast<uint32_t*>(smem + (box - base) + r0 * 128 + chunk0) =
            pack_bf16(acc[4 * j] / den0, acc[4 * j + 1] / den0);
        *reinterpret_cast<uint32_t*>(smem + (box - base) + (r0 + 8) * 128 + chunk0) =
            pack_bf16(acc[4 * j + 2] / den1, acc[4 * j + 3] / den1);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      constexpr int kChunks = DHP / 8;  // 16-byte chunks a row
      for (int idx = tid; idx < 64 * kChunks; idx += 128) {
        const int r = idx / kChunks, c = idx % kChunks;
        if (row0 + r < sq && c * 8 < dh) {
          const uint4 val = *reinterpret_cast<const uint4*>(
              smem + (q_wg - base) + (c >> 3) * kBQ * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
          *reinterpret_cast<uint4*>(o + (static_cast<size_t>(n) * sq + row0 + r) * dh + c * 8) =
              val;
        }
      }
    }
  }
}

template <int DHP>
int launch_dhp(const void* q, const void* k, const void* v, void* o, int n_q, int sq, int sk,
               int dh, int rep, int window, int q_offset, float scale, void* stream) {
  using T = Tiles<DHP>;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t err = make_map(&map_q, kBf16, 2, q, dh, sq, n_q, kBQ);
  if (err == cudaSuccess) err = make_map(&map_k, kBf16, 2, k, dh, sk, n_q / rep, T::kBKV);
  if (err == cudaSuccess) err = make_map(&map_v, kBf16, 2, v, dh, sk, n_q / rep, T::kBKV);
  if (err == cudaSuccess) err = prepare_smem(flash_attention_kernel_bf16_wgmma<DHP>, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_q, n_qt);
  flash_attention_kernel_bf16_wgmma<DHP><<<grid, kThreads, T::kSmem,
                                           static_cast<cudaStream_t>(stream)>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), sq, sk, dh, rep, window, q_offset,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace fa_tc
}  // namespace repro_torch

extern "C" {

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int flash_attention_bf16_wgmma(const void* q, const void* k, const void* v, void* o, int n_q,
                               int sq, int sk, int dh, int rep, int window, int q_offset,
                               float scale, void* stream) {
  using namespace repro_torch::fa_tc;
  if (dh < 8 || dh > 256 || dh % 8 != 0 || rep < 1 || n_q % rep != 0 || sk < 1 || q_offset < 0 ||
      window < 0) {
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

// Dynamic shared memory a block of the kernel asks for at this d_head.
int flash_attention_bf16_wgmma_smem(int dh) {
  using namespace repro_torch::fa_tc;
  return dh <= 64 ? Tiles<64>::kSmem : dh <= 128 ? Tiles<128>::kSmem : Tiles<256>::kSmem;
}

}  // extern "C"
