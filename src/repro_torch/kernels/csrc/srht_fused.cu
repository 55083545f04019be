// Hopper ports of the three kernels of src/repro/kernels/srht_fused.py:
//
//   fwht_rowsigns   <- fwht_rowsigns_pallas (_rowsigns_kernel):
//       out = (scale * [s *] H ([s *] x))[rows]   one diagonal s per row
//   srht_decode_sum <- srht_decode_sum_pallas (_decode_sum_kernel):
//       out_c = sum_i scale * s_i * H scatter(z_ic, rows_i)
//   srht_gram_apply <- srht_gram_apply_pallas (_gram_apply_kernel):
//       out_c = sum_i scale * s_i * H (m_i * H (s_i * v_c))
//     and srht_cg_step, the same kernel with one CG iteration in its epilogue
//
// Bound on an H100: bytes. A transform is d log2(d) adds per row, a few adds
// per byte moved. Each kernel reads its inputs once and writes its output
// once:
//   * decode_sum takes the (n, C, k) payloads and their rows and scatters
//     them in shared memory, so the (n, C, d) scattered tensor of the TPU
//     path never exists in device memory; the Gram apply takes the rows,
//     not the (n, C, d) mask;
//   * the client sum is a loop in client order over an accumulator that is
//     written once at the end: no atomics, and the same order as the plain
//     version, so the result is deterministic;
//   * signs and rows of shape (n, 1, .) (shared randomness) are staged in
//     shared memory once a block, never expanded to (n, C, .).
// The TPU kernels' Kronecker two-matmul tiling is an MXU adaptation and is
// not carried over.
//
// fwht_rowsigns runs one block per chunk row, the row in shared memory,
// fwht_smem's __syncthreads a stage. decode_sum and the Gram apply run the
// butterfly once or twice a client: in shared memory that is about 80k
// shared accesses and 48 block barriers a chunk of four clients for
// decode_sum, far more time than its bytes take. So they run the
// register-resident butterfly of fwht_common.cuh: a warp owns 1024 / d
// chunks (a block of d / 32 threads owns one above 1024) in a persistent
// grid, with the accumulator in registers and the client loop inside the
// warp. Per client decode_sum scatters the k payload values into a zero
// shared tile, reads the tile in layout A, puts the k zeros back (cheaper
// than clearing the tile), transforms in registers with two passes through
// a second tile, and adds (v * s_i) * scale to the accumulator, as the plain
// version does. Shared signs and rows are staged in shared memory once a
// block; a draw per chunk is read per chunk. Each register of the result is
// stored as one coalesced 128-byte line a warp (16-byte stores would need
// one more pass through shared memory for no fewer lines). The Gram apply
// is described at its kernel (K4, below).
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

// ---------------------------------------------------------------------------
// K4: the Gram apply and the CG step, one template on Butterfly<LOG_D>.
//
//   gram_apply_butterfly_kernel  <- srht_gram_apply_pallas (_gram_apply_kernel):
//       out_c = sum_i scale * s_i * H (m_i * H (s_i * v_c)), m_i the 0/1
//       indicator of draw i's k rows
//   cg_step_butterfly_kernel: one iteration of
//       rand_proj_spatial._cg_resolvent_solve (kernels/ref.py::srht_cg_step_ref),
//       the same Gram apply of p with every update of the step in its epilogue
//
// Bound on an H100: bytes. The Gram apply reads v and writes its result; the
// CG step reads x, r and p and writes them back (six (C, d) float32 passes).
// Every CG reduction is per chunk, and a group (a warp, or the block above
// d = 1024) owns whole chunks, so the step needs no reduction across blocks
// and no second launch.
//
// Per task (a group's chunks), p is read once with coalesced 16-byte loads
// into the group's p tile, where it stays for the whole step. Per client, in
// client order: layout A of p times s_i, the transform, its result stored in
// the tile, the k row positions of each chunk gathered into a zero tile and
// layout A read back from it (the mask multiply and the trip back to layout
// A in one pass; then the zeros go back), the second transform, and
// acc += v * s_i * scale in the final layout, as the plain version's terms
// and client sum. A position the mask drops is +0 here where the plain
// version has 0 * t, which is +0 or -0 (NaN for an infinite t): equal under
// torch.equal, and no later operation of the step turns the sign of a zero
// into a different value (the divisions are guarded to positive divisors).
//
// The CG epilogue computes ap = c0 p + c1 acc in the final layout, p read
// from the tile, and the row dot products pap = <p, ap> and rs2 = <r2, r2> in
// row_dot_ref's halving order (row_sum; cross_warp_sum above d = 1024, where
// cg_epilogue_wide works group by group). Each elementwise operation is one
// correctly rounded float32 operation in the plain step's order (-fmad=false;
// '/' is IEEE division), so the step is bit for bit the plain one. x and r
// are read and written in the final layout, a coalesced 128-byte line a warp
// per register. A task whose chunks are all done is skipped, and a done chunk
// is never written: it keeps every bit, as where(done, old, new) keeps it.
//
// Registers: the accumulator and the working row are 64 floats a thread;
// p stays in shared memory, not in a third set, and is read from it again in
// each pass of the epilogue, which also keeps S p (then ap, then r2) in the
// transform tile rather than in registers. Shared memory a block: three
// tiles a group (p, transform, zero), shared signs staged once a block as a
// swizzled tile per client (so layout A reads them 16 bytes at a time and
// the final layout 4 bytes, without conflicts) and shared rows. At d = 1024
// that is 12 warps and about 162 KB, one block an SM in a persistent grid,
// at most 168 registers a thread (16 warps would cap them at 128, and both
// entries spill there); below 1024 (several chunks a warp, more per-chunk
// scalars in registers) 8 warps; above, the d / 32 threads of one row.
//
// Latency: each pass of the epilogue issues all its loads of x (or r) before
// its stores, since the compiler must assume a store to one may alias the
// next load of the other. At the start of a task the group prefetches into
// L2 this task's x and r and the next task's p; during client i, client
// i + 1's rows and signs when drawn per chunk.
template <int LOG_D>
constexpr int kGramGroups = Butterfly<LOG_D>::kWarps > 1 ? 1 : (LOG_D == 10 ? 12 : 8);

template <int LOG_D>
constexpr int kGramThreads = kGramGroups<LOG_D> * Butterfly<LOG_D>::kThreads;

// prefetch.L2 of the first 128-byte lines of [p + at, p + at + bytes) (device
// memory), one line a thread of the group: a tile's worth (32 floats a
// thread), all of it for a tile of x, r, p or signs. The address is summed
// inside the asm, so the compiler does not keep it (shared with the later
// loads of the same data) live in registers in between.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t at, size_t bytes, int g) {
  const size_t off = static_cast<size_t>(g) * 128;
  if (off < bytes) {
    asm volatile("{\n\t.reg .u64 a;\n\tadd.u64 a, %0, %1;\n\tprefetch.L2 [a];\n\t}" ::"l"(p),
                 "l"(at + off));
  }
}

// floats of the cross-warp reduction buffer (a block owns one row above 1024)
template <int LOG_D>
constexpr int kGramRed = Butterfly<LOG_D>::kWarps == 1 ? 0 : 32 * Butterfly<LOG_D>::kWarps + 4;

struct GramArgs {
  const float* signs;   // (n, C|1, d)
  const int64_t* rows;  // (n, C|1, k)
  float* p;             // (C, d): v of the Gram apply; the CG step's p, updated in place
  float* out;           // the Gram apply's (C, d) result
  float* x;             // the CG step's state, updated in place: x, r (C, d), rs, done (C)
  float* r;
  float* rs;
  uint8_t* done;
  const float* c0;    // ap = c0 p + c1 S p: (C) or one value
  const float* c1;
  const float* tol2;  // (C)
  int n, C, k;
  int signs_pc, rows_pc, c0_pc, c1_pc;  // a value per chunk, else one for every chunk
  int stage_signs, stage_rows;
  float scale;
};

// chunk of the task held in register r (final layout)
template <int LOG_D>
__device__ __forceinline__ int row_of(int g, int r) {
  if constexpr (Butterfly<LOG_D>::kRows == 1) {
    return 0;
  } else if constexpr (LOG_D >= 5) {
    return r >> (LOG_D - 5);
  } else {
    return (32 * r + g) >> LOG_D;
  }
}

// Registers an epilogue pass covers (whole chunks): all 32 at d = 1024, else
// 8 (16 at d = 512), so that fewer per-chunk values are live at once.
template <int LOG_D>
constexpr int kPassRegs = Butterfly<LOG_D>::kRows == 1 ? 32 : (LOG_D == 9 ? 16 : 8);

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// a[j] += a[j + h] for j < h, h = N/2, ..., 1: row_dot_ref's order over N
// consecutive elements. -> their sum, in a[0]
template <int N>
__device__ __forceinline__ float halving_sum(float (&a)[N]) {
#pragma unroll
  for (int e = ilog2(N) - 1; e >= 0; --e) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j < (1 << e)) a[j] = a[j] + a[j + (1 << e)];
    }
  }
  return a[0];
}

// Every register of t (final layout registers r0 .. r0 + P - 1, whole rows
// of a warp's tile, d <= 1024) becomes the total of its row, summed in
// row_dot_ref's order: t[j] + t[j + h] for h = d/2, d/4, ..., 1. (The folds
// count exponents down, so that every loop unrolls and t stays in registers.)
template <int LOG_D, int P>
__device__ __forceinline__ void row_sum(float (&t)[P], int g) {
  static_assert(Butterfly<LOG_D>::kWarps == 1, "rows of one warp");
  // element 32 r + l
  constexpr int kLogR = LOG_D >= 5 ? LOG_D - 5 : 0;
  constexpr int kLogL = LOG_D >= 5 ? 5 : LOG_D;
  constexpr int R = 1 << kLogR;  // registers a row
  constexpr int L = 1 << kLogL;  // lanes a row
  static_assert(P % R == 0, "a pass holds whole rows");
  // h = d/2 .. 32: registers r and r + h/32 of one row
#pragma unroll
  for (int e = kLogR - 1; e >= 0; --e) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      if (r % R < (1 << e)) t[r] = t[r] + t[r + (1 << e)];
    }
  }
  // h = L/2 .. 1: lanes l and l + h, into the row's first lane
#pragma unroll
  for (int e = kLogL - 1; e >= 0; --e) {
#pragma unroll
    for (int r = 0; r < P; r += R) t[r] = t[r] + __shfl_down_sync(0xffffffffu, t[r], 1 << e);
  }
#pragma unroll
  for (int r = 0; r < P; r += R) {
    const float s = __shfl_sync(0xffffffffu, t[r], g & ~(L - 1));
#pragma unroll
    for (int q = 0; q < R; ++q) t[r + q] = s;
  }
}

// Above d = 1024 (a row across the W warps of a block): thread g's partial
// sum for row position g (its registers already folded) -> the row's total,
// every thread. The folds h = 16 W .. 32 run across the warps through red,
// then h = 16 .. 1 across the lanes of warp 0.
template <int LOG_D>
__device__ __forceinline__ float cross_warp_sum(float part, float* red, int g) {
  constexpr int W = Butterfly<LOG_D>::kWarps;
  red[g] = part;
  __syncthreads();
  if (g < 32) {
    float u[W];
#pragma unroll
    for (int m = 0; m < W; ++m) u[m] = red[32 * m + g];
    float s = halving_sum(u);
#pragma unroll
    for (int e = 4; e >= 0; --e) s = s + __shfl_down_sync(0xffffffffu, s, 1 << e);
    if (g == 0) red[32 * W] = s;
  }
  __syncthreads();
  return red[32 * W];
}

// v *= s_i in layout A (tile element 32 g + r): from st, client i's staged
// tile in shared memory, when staged; else from si, its signs in device
// memory from the task's first chunk (a draw per chunk) or from position 0
// (shared). Elements past the task's chunks are 0 in v and keep it.
template <int LOG_D>
__device__ __forceinline__ void signs_a(float (&v)[32], const float* st, const float* si,
                                        int staged, int signs_pc, int valid, int g) {
  using BF = Butterfly<LOG_D>;
  constexpr int kD = BF::kD;
  if (staged) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 s = *reinterpret_cast<const float4*>(st + BF::a_addr(g, q));
      v[4 * q] = v[4 * q] * s.x;
      v[4 * q + 1] = v[4 * q + 1] * s.y;
      v[4 * q + 2] = v[4 * q + 2] * s.z;
      v[4 * q + 3] = v[4 * q + 3] * s.w;
    }
  } else if constexpr (kD >= 32) {  // the thread's 32 elements lie in one row
    const int e0 = 32 * g;
    if (BF::kRows == 1 || e0 < valid) {
      const float* sr = si + (signs_pc ? e0 : (e0 & (kD - 1)));
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 s = *reinterpret_cast<const float4*>(sr + 4 * q);
        v[4 * q] = v[4 * q] * s.x;
        v[4 * q + 1] = v[4 * q + 1] * s.y;
        v[4 * q + 2] = v[4 * q + 2] * s.z;
        v[4 * q + 3] = v[4 * q + 3] * s.w;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int e = 32 * g + r;
      if (e < valid) v[r] = v[r] * si[signs_pc ? e : (e & (kD - 1))];
    }
  }
}

// The CG step's inputs of one chunk (live: a chunk of the task not yet done).
struct RowIn {
  bool live;
  float rs, tol2, c0, c1;
};

// The update of rand_proj_spatial._cg_resolvent_solve for the task's chunks
// (d <= 1024: a warp's), in passes of whole chunks. work holds S p at the
// final positions (each thread reads and writes only its own), where ap and
// then r2 replace it: no 32 registers stay live through the epilogue.
template <int LOG_D>
__device__ __forceinline__ void cg_epilogue(const GramArgs& a, const float* ptile, float* work,
                                            int g, long long c0, int nc) {
  using BF = Butterfly<LOG_D>;
  constexpr int kD = BF::kD;
  constexpr int P = kPassRegs<LOG_D>;
  constexpr int B = P;  // loads of x (r) in flight at once
  asm volatile("" ::: "memory");  // the chunks' scalars load here, not before the client loop
  const size_t base = static_cast<size_t>(c0) * kD;
  auto row_in = [&](int row) {
    const bool in = BF::kRows == 1 || row < nc;
    const long long ch = c0 + (in ? row : 0);
    RowIn o;
    o.live = in && !a.done[ch];
    o.rs = a.rs[ch];
    o.tol2 = a.tol2[ch];
    o.c0 = a.c0[a.c0_pc ? ch : 0];
    o.c1 = a.c1[a.c1_pc ? ch : 0];
    return o;
  };
  const RowIn one = row_in(0);
  auto row_at = [&](int r) { return BF::kRows == 1 ? one : row_in(row_of<LOG_D>(g, r)); };
  auto alpha = [&](const RowIn& ri, float pap) { return ri.rs / (pap > 0.f ? pap : 1.f); };

#pragma unroll
  for (int r0 = 0; r0 < 32; r0 += P) {
    // ap = c0 p + c1 S p, and p * ap for pap
    float t[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const RowIn ri = row_at(r0 + q);
      const int f = BF::final_addr(g, r0 + q);
      const float pv = ptile[f];
      const float ap = ri.c0 * pv + ri.c1 * work[f];
      work[f] = ap;
      t[q] = pv * ap;
    }
    row_sum<LOG_D, P>(t, g);
    // alpha = rs / pap; x += alpha p (B loads of x, then their stores)
#pragma unroll
    for (int b0 = 0; b0 < P; b0 += B) {
      float w[B];
#pragma unroll
      for (int q = 0; q < B; ++q) {
        const int r = r0 + b0 + q;
        w[q] = row_at(r).live ? a.x[base + BF::final_index(g, r)] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < B; ++q) {
        const int r = r0 + b0 + q;
        const RowIn ri = row_at(r);
        if (ri.live) {
          a.x[base + BF::final_index(g, r)] =
              w[q] + alpha(ri, t[b0 + q]) * ptile[BF::final_addr(g, r)];
        }
      }
      asm volatile("" ::: "memory");
    }
    // r2 = r - alpha ap, and r2 * r2 for rs2 (each register's pap is used
    // before its r2 * r2 replaces it)
#pragma unroll
    for (int b0 = 0; b0 < P; b0 += B) {
      float w[B];
#pragma unroll
      for (int q = 0; q < B; ++q) {
        const int r = r0 + b0 + q;
        w[q] = row_at(r).live ? a.r[base + BF::final_index(g, r)] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < B; ++q) {
        const int r = r0 + b0 + q;
        const int f = BF::final_addr(g, r);
        const RowIn ri = row_at(r);
        float r2 = 0.f;
        if (ri.live) {
          r2 = w[q] - alpha(ri, t[b0 + q]) * work[f];
          a.r[base + BF::final_index(g, r)] = r2;
        }
        work[f] = r2;
        t[b0 + q] = r2 * r2;
      }
      asm volatile("" ::: "memory");
    }
    row_sum<LOG_D, P>(t, g);
    // done2 = rs2 <= tol2; beta = rs2 / rs; p = r2 + beta p where not done2
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int r = r0 + q;
      const RowIn ri = row_at(r);
      const float rs2 = t[q];
      if (ri.live && !(rs2 <= ri.tol2)) {
        const float bet = rs2 / (ri.rs > 0.f ? ri.rs : 1.f);
        const int f = BF::final_addr(g, r);
        a.p[base + BF::final_index(g, r)] = work[f] + bet * ptile[f];
      }
    }
    BF::sync();  // every thread of the group has read these chunks' rs and done
    // the thread holding a chunk's element 0 writes its rs and done
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int r = r0 + q;
      if ((BF::final_index(g, r) & (kD - 1)) == 0) {
        const RowIn ri = row_at(r);
        if (ri.live) {
          const long long ch = c0 + row_of<LOG_D>(g, r);
          a.rs[ch] = t[q];
          a.done[ch] = t[q] <= ri.tol2;
        }
      }
    }
  }
}

// The same update above d = 1024, where a block owns the task's one chunk
// (live: a task of a done chunk is skipped). Register r of thread g holds
// element 1024 (r % W) + 32 W (r / W) + g, so row_dot_ref's order folds each
// group of W registers (r / W fixed) first, then the groups, then the warps
// and lanes (cross_warp_sum). It works whole groups at a time, G registers a
// batch of loads, so few values are live: at d = 16384 a thread has 128
// registers.
template <int LOG_D>
__device__ __forceinline__ void cg_epilogue_wide(const GramArgs& a, const float* ptile,
                                                 float* work, float* red, int g, long long c0) {
  using BF = Butterfly<LOG_D>;
  constexpr int W = BF::kWarps;
  constexpr int Q = 32 / W;           // groups
  constexpr int G = W >= 8 ? W : 8;   // registers a batch of loads: whole groups
  asm volatile("" ::: "memory");  // the chunk's scalars load here, not before the client loop
  const size_t base = static_cast<size_t>(c0) * BF::kD;
  const float rs = a.rs[c0];
  const float tol2 = a.tol2[c0];
  const float k0 = a.c0[a.c0_pc ? c0 : 0];
  const float k1 = a.c1[a.c1_pc ? c0 : 0];
  float gs[Q];  // each group's sum
  // ap = c0 p + c1 S p, and pap = <p, ap>
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float u[W];
#pragma unroll
    for (int m = 0; m < W; ++m) {
      const int f = BF::final_addr(g, W * q + m);
      const float pv = ptile[f];
      const float ap = k0 * pv + k1 * work[f];
      work[f] = ap;
      u[m] = pv * ap;
    }
    gs[q] = halving_sum(u);
  }
  const float pap = cross_warp_sum<LOG_D>(halving_sum(gs), red, g);
  const float alpha = rs / (pap > 0.f ? pap : 1.f);
  // x += alpha p
#pragma unroll
  for (int b0 = 0; b0 < 32; b0 += G) {
    float w[G];
#pragma unroll
    for (int m = 0; m < G; ++m) w[m] = a.x[base + BF::final_index(g, b0 + m)];
#pragma unroll
    for (int m = 0; m < G; ++m) {
      a.x[base + BF::final_index(g, b0 + m)] = w[m] + alpha * ptile[BF::final_addr(g, b0 + m)];
    }
    asm volatile("" ::: "memory");
  }
  // r2 = r - alpha ap, and rs2 = <r2, r2>
#pragma unroll
  for (int b0 = 0; b0 < 32; b0 += G) {
    float w[G];
#pragma unroll
    for (int m = 0; m < G; ++m) w[m] = a.r[base + BF::final_index(g, b0 + m)];
#pragma unroll
    for (int q = 0; q < G / W; ++q) {
      float u[W];
#pragma unroll
      for (int m = 0; m < W; ++m) {
        const int r = b0 + W * q + m;
        const int f = BF::final_addr(g, r);
        const float r2 = w[W * q + m] - alpha * work[f];
        a.r[base + BF::final_index(g, r)] = r2;
        work[f] = r2;
        u[m] = r2 * r2;
      }
      gs[b0 / W + q] = halving_sum(u);
    }
    asm volatile("" ::: "memory");
  }
  const float rs2 = cross_warp_sum<LOG_D>(halving_sum(gs), red, g);
  // done2 = rs2 <= tol2; p = r2 + beta p unless done2. Every thread read rs
  // before cross_warp_sum's barriers, so thread 0 writes it after them.
  const bool done2 = rs2 <= tol2;
  if (!done2) {
    const float bet = rs2 / (rs > 0.f ? rs : 1.f);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int f = BF::final_addr(g, r);
      a.p[base + BF::final_index(g, r)] = work[f] + bet * ptile[f];
    }
  }
  if (g == 0) {
    a.rs[c0] = rs2;
    a.done[c0] = done2;
  }
}

template <int LOG_D, bool kCgStep>
__device__ __forceinline__ void gram_body(const GramArgs& a) {
  using BF = Butterfly<LOG_D>;
  constexpr int kD = BF::kD;
  constexpr int kGroups = kGramGroups<LOG_D>;
  extern __shared__ __align__(16) float smem[];
  const int grp = threadIdx.x / BF::kThreads;
  const int g = threadIdx.x % BF::kThreads;
  float* ptile = smem + grp * BF::kTile;
  float* xtile = smem + (kGroups + grp) * BF::kTile;
  float* ztile = smem + (2 * kGroups + grp) * BF::kTile;
  float* red = smem + 3 * kGroups * BF::kTile;
  float* staged = red + kGramRed<LOG_D>;

  for (int i = threadIdx.x; i < kGroups * BF::kTile; i += blockDim.x) {
    smem[2 * kGroups * BF::kTile + i] = 0.f;  // the zero tiles
  }
  // when staged, client i's tile: element q at swz(q) holds s_i[q % d]
  const float* s_tiles = staged;
  if (a.stage_signs) {
    for (int i = threadIdx.x; i < a.n * BF::kTile; i += blockDim.x) {
      const int q = i & (BF::kTile - 1);
      staged[i - q + swz(q)] = a.signs[(i / BF::kTile) * kD + (q & (kD - 1))];
    }
    staged += a.n * BF::kTile;
  }
  // a generic pointer: shared memory when staged, device memory otherwise
  const int64_t* rw = a.rows;
  if (a.stage_rows) {
    int64_t* st = reinterpret_cast<int64_t*>(staged);
    for (int i = threadIdx.x; i < a.n * a.k; i += blockDim.x) st[i] = a.rows[i];
    rw = st;
  }
  __syncthreads();

  const int C = a.C, k = a.k;
  const long long n_tasks = (static_cast<long long>(C) + BF::kRows - 1) / BF::kRows;
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  for (long long task = static_cast<long long>(blockIdx.x) * kGroups + grp; task < n_tasks;
       task += stride) {
    const long long c0 = task * BF::kRows;
    const long long left = C - c0;
    const int nc = static_cast<int>(left < BF::kRows ? left : BF::kRows);  // chunks here
    const int valid = nc * kD;                                              // their elements
    if constexpr (kCgStep) {  // done chunks keep every bit: skip a task of only those
      if constexpr (BF::kRows == 1) {
        if (a.done[c0]) continue;  // the same for every thread of the group
      } else {  // a warp holds several chunks
        int live = 0;
        for (int q = g; q < nc; q += 32) live |= !a.done[c0 + q];
        if (!__any_sync(0xffffffffu, live)) continue;
      }
    }
    if constexpr (kCgStep) {
      prefetch_l2(a.x, sizeof(float) * kD * c0, sizeof(float) * valid, g);
      prefetch_l2(a.r, sizeof(float) * kD * c0, sizeof(float) * valid, g);
    }
    if (task + stride < n_tasks) {
      const long long c1 = (task + stride) * BF::kRows;
      const long long left1 = C - c1;
      prefetch_l2(a.p, sizeof(float) * kD * c1,
                                sizeof(float) * kD * (left1 < BF::kRows ? left1 : BF::kRows), g);
    }
    BF::sync();  // the last task's reads of the p tile are done
    const float* pg = a.p + static_cast<size_t>(c0) * kD;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = 4 * (q * BF::kThreads + g);
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (BF::kRows == 1 || e + 4 <= valid) {
        t = *reinterpret_cast<const float4*>(pg + e);
      } else if (e < valid) {  // d = 2: a ragged last task may end mid-vector
        t.x = pg[e];
        if (e + 1 < valid) t.y = pg[e + 1];
        if (e + 2 < valid) t.z = pg[e + 2];
      }
      *reinterpret_cast<float4*>(ptile + swz(e)) = t;
    }

    float acc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] = -0.f;  // -0 + t == t for every t: the first term
    for (int i = 0; i < a.n; ++i) {
      // draw i's rows for these chunks (entry t: chunk t / k, column t % k)
      const Payload pl{nullptr,
                       rw + (a.rows_pc ? (static_cast<size_t>(i) * C + c0) * k
                                       : static_cast<size_t>(i) * k),
                       nc * k};
      const float* st = s_tiles + static_cast<size_t>(i) * BF::kTile;
      const float* si = a.signs + (a.signs_pc ? (static_cast<size_t>(i) * C + c0) * kD
                                              : static_cast<size_t>(i) * kD);
      int pos[kPrefetch];
#pragma unroll
      for (int m = 0; m < kPrefetch; ++m) {
        const int t = g + m * BF::kThreads;
        pos[m] = t < pl.n_in ? scatter_pos<LOG_D>(pl, t, k, a.rows_pc) : -1;
      }
      if (i + 1 < a.n) {  // the next client's draws, where they are drawn per chunk
        const size_t next = (static_cast<size_t>(i) + 1) * C + c0;
        if (a.rows_pc) {
          prefetch_l2(a.rows, sizeof(int64_t) * k * next, sizeof(int64_t) * pl.n_in, g);
        }
        if (a.signs_pc) {
          prefetch_l2(a.signs, sizeof(float) * kD * next, sizeof(float) * valid, g);
        }
      }
      BF::sync();  // the p tile is loaded; the last client's reads of both tiles are done
      float v[32];
      BF::load_a(v, ptile, g);
      signs_a<LOG_D>(v, st, si, a.stage_signs, a.signs_pc, valid, g);
      BF::transform(v, xtile, g);
      // the mask: store the transform, gather the rows into the zero tile,
      // read layout A from it, put the zeros back
#pragma unroll
      for (int r = 0; r < 32; ++r) xtile[BF::final_addr(g, r)] = v[r];
      BF::sync();
#pragma unroll
      for (int m = 0; m < kPrefetch; ++m) {
        if (pos[m] >= 0) ztile[pos[m]] = xtile[pos[m]];
      }
      for (int t = g + kPrefetch * BF::kThreads; t < pl.n_in; t += BF::kThreads) {
        const int q = scatter_pos<LOG_D>(pl, t, k, a.rows_pc);
        if (q >= 0) ztile[q] = xtile[q];
      }
      BF::sync();
      BF::load_a(v, ztile, g);
      BF::sync();
#pragma unroll
      for (int m = 0; m < kPrefetch; ++m) {
        if (pos[m] >= 0) ztile[pos[m]] = 0.f;
      }
      for (int t = g + kPrefetch * BF::kThreads; t < pl.n_in; t += BF::kThreads) {
        const int q = scatter_pos<LOG_D>(pl, t, k, a.rows_pc);
        if (q >= 0) ztile[q] = 0.f;
      }
      BF::transform(v, xtile, g);
      // acc += v * s_i * scale, eight signs at a time as K3 (four above
      // 1024, where a thread has fewer registers)
      constexpr int SC = BF::kWarps > 1 ? 4 : 8;
#pragma unroll
      for (int r0 = 0; r0 < 32; r0 += SC) {
        float s[SC];
#pragma unroll
        for (int r = 0; r < SC; ++r) {
          const int q = BF::final_index(g, r0 + r);
          if (a.stage_signs) {
            s[r] = st[BF::final_addr(g, r0 + r)];
          } else if constexpr (BF::kRows == 1) {
            s[r] = si[q];
          } else {
            s[r] = q < valid ? si[a.signs_pc ? q : (q & (kD - 1))] : 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < SC; ++r) acc[r0 + r] = acc[r0 + r] + v[r0 + r] * s[r] * a.scale;
        asm volatile("" ::: "memory");
      }
    }
    if constexpr (kCgStep) {
      // S p to the transform tile, each thread at its own final positions
      // (which the transform last read), for the epilogue
#pragma unroll
      for (int r = 0; r < 32; ++r) xtile[BF::final_addr(g, r)] = acc[r];
      if constexpr (BF::kWarps == 1) {
        cg_epilogue<LOG_D>(a, ptile, xtile, g, c0, nc);
      } else {
        cg_epilogue_wide<LOG_D>(a, ptile, xtile, red, g, c0);
      }
    } else {
      float* o = a.out + static_cast<size_t>(c0) * kD;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int q = BF::final_index(g, r);
        if (BF::kRows == 1 || q < valid) o[q] = acc[r];
      }
    }
  }
}

template <int LOG_D>
__global__ void __launch_bounds__(kGramThreads<LOG_D>, 1)
    gram_apply_butterfly_kernel(const GramArgs a) {
  gram_body<LOG_D, false>(a);
}

template <int LOG_D>
__global__ void __launch_bounds__(kGramThreads<LOG_D>, 1)
    cg_step_butterfly_kernel(const GramArgs a) {
  gram_body<LOG_D, true>(a);
}

template <int LOG_D, bool kCgStep>
int launch_gram(GramArgs args, cudaStream_t stream) {
  using BF = Butterfly<LOG_D>;
  constexpr int kGroups = kGramGroups<LOG_D>;
  const size_t tiles = sizeof(float) * (3 * kGroups * BF::kTile + kGramRed<LOG_D>);
  const size_t sign_bytes = sizeof(float) * args.n * BF::kTile;
  const size_t row_bytes = sizeof(int64_t) * args.n * args.k;
  args.stage_signs = !args.signs_pc && sign_bytes <= kStageSignBytes &&
                     tiles + sign_bytes <= static_cast<size_t>(kMaxSmemBytes);
  size_t smem = tiles + (args.stage_signs ? sign_bytes : 0);
  args.stage_rows = !args.rows_pc && row_bytes <= kStageRowBytes &&
                    smem + row_bytes <= static_cast<size_t>(kMaxSmemBytes);
  smem += args.stage_rows ? row_bytes : 0;
  auto kernel = kCgStep ? cg_step_butterfly_kernel<LOG_D> : gram_apply_butterfly_kernel<LOG_D>;
  cudaError_t err = prepare_smem(kernel, smem);
  const long long tasks = (static_cast<long long>(args.C) + BF::kRows - 1) / BF::kRows;
  int blocks = 0;
  if (err == cudaSuccess) {
    err = persistent_grid(kernel, kGramThreads<LOG_D>, smem, (tasks + kGroups - 1) / kGroups,
                          &blocks);
  }
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kGramThreads<LOG_D>, smem, stream>>>(args);
  return cudaGetLastError();
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

int srht_gram_apply_f32(const void* v, const void* signs, const void* rows, void* out, int n,
                        int C, int d, int k, int signs_per_chunk, int rows_per_chunk, float scale,
                        void* stream) {
  if (C == 0) return cudaSuccess;
  GramArgs args{};
  args.signs = static_cast<const float*>(signs);
  args.rows = static_cast<const int64_t*>(rows);
  args.p = const_cast<float*>(static_cast<const float*>(v));  // read only
  args.out = static_cast<float*>(out);
  args.n = n;
  args.C = C;
  args.k = k;
  args.signs_pc = signs_per_chunk;
  args.rows_pc = rows_per_chunk;
  args.scale = scale;
  return with_log_d<14>(log2_exact(d), [&](auto log_d) {
    return launch_gram<decltype(log_d)::value, false>(args, static_cast<cudaStream_t>(stream));
  });
}

int srht_cg_step_f32(void* x, void* r, void* p, void* rs, void* done, const void* c0,
                     const void* c1, const void* tol2, const void* signs, const void* rows, int n,
                     int C, int d, int k, int c0_per_chunk, int c1_per_chunk,
                     int signs_per_chunk, int rows_per_chunk, float scale, void* stream) {
  if (C == 0) return cudaSuccess;
  GramArgs args{};
  args.signs = static_cast<const float*>(signs);
  args.rows = static_cast<const int64_t*>(rows);
  args.p = static_cast<float*>(p);
  args.x = static_cast<float*>(x);
  args.r = static_cast<float*>(r);
  args.rs = static_cast<float*>(rs);
  args.done = static_cast<uint8_t*>(done);
  args.c0 = static_cast<const float*>(c0);
  args.c1 = static_cast<const float*>(c1);
  args.tol2 = static_cast<const float*>(tol2);
  args.n = n;
  args.C = C;
  args.k = k;
  args.signs_pc = signs_per_chunk;
  args.rows_pc = rows_per_chunk;
  args.c0_pc = c0_per_chunk;
  args.c1_pc = c1_per_chunk;
  args.scale = scale;
  return with_log_d<14>(log2_exact(d), [&](auto log_d) {
    return launch_gram<decltype(log_d)::value, true>(args, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
