// Coded-diagonal (coded-DIA) SpMM for Hopper (sm_90a): the coded SpMV of
// csrc/dia_coded.cu over K right-hand sides at once, with the block CG
// direction fold (per-column beta, an optional shared minv).
//
// Replaces no Pallas kernel of its own: on a block operand the JAX
// package's `_spmv_body` takes the XLA form `_dia_coded_xla`
// (partitionedarrays_jl_tpu/parallel/tpu.py:3006-3020, chosen at
// :3089-3091, since the Pallas kernel `_padded_kernel` of ops/pallas_dia.py
// is K = 1 only) and, in the fused body, the jnp fold
// `pnew = z + beta * pv` (:3284-3290) before it. This kernel stands for
// that pair in the port's block CG and PCG (parallel/gpu.py:
// make_block_cg_fn), the s-step pair [p | r] (K = 2) and the LOBPCG block.
//
// Layout: (P, W, K) slabs, the K columns of a row contiguous; the owned band
// of part p at rows [o0, o0 + no[p]).
//
// What it computes, per part p (blockIdx.y), owned row i < no[p] and
// column k < K:
//   y[p, o0 + i, k] = sum_d v_d(i) * u[p, i + off_d, k]   (ascending d)
// with v_d(i) decoded from the codebook and the nibble codes as K1 decodes
// it (ops/dia.py:_band_sum: a constant diagonal's cb[p, d, 0], else
// cb[p, d, c], c the 4-bit code, a code >= kk[d] reading slot 0; the
// row-class decode is the same with every coded diagonal on stream 0's low
// nibble), every diagonal summed, zero coefficients included, and a read
// at i + off_d outside [0, no[p]) taken as 0. The operand u is x (plain
// mode), or in pfold mode the fold
//   u = r + beta[k] * pprev            (minv null)
//   u = minv * r + beta[k] * pprev     (minv shared by the columns)
// each product rounded before the add, which the kernel also writes out as
// p on the owned rows (0 on every other slot of its frame). Every other
// slot of y (width wy) is exactly 0.
//
// Rounding: __fmul_rn / __fadd_rn in ascending-offset order from -0, the
// order of the plain PyTorch version (ops/dia.py:dia_coded_spmm_plain), so
// the two agree value for value, and column k equals K1's plain version on
// column k.
//
// Bound: memory, K values of x read and of y written a row and the code
// bytes once: at 192^3 f32, one part, on the row-class Poisson operator (1
// code byte) K = 2 moves 17 B a row, 120.3 MB, 35.9 us at 3.35 TB/s, K = 8
// 65 B, 460 MB, 137.3 us; on the select-chain GMG A0 (4 code bytes) K = 4
// moves 36 B, 254.8 MB, 76.1 us. The pfold form reads r and pprev and
// writes y and p: 4K + 1 values' bytes a row (K = 8 f32: 129 B, 913 MB,
// 272.6 us; with minv 4 B more).
//
// Two forms, chosen by the host planner on shapes (ops/dia.py:spmm_form;
// a launch counts as one dia_coded_spmm either way):
//
// * The staged form (form 1), K1's design over K columns. A CTA sums
//   tiles of T rows; the read windows, the march along the plane stride and
//   the ring of buffers are K1's plan (ops/dia.py:plan_coded_block_windows,
//   the rows of a window K values wide). A window's rows are one run of
//   K x rows values in the slab, staged with cp.async 16-byte copies from
//   any phase, values outside [0, no*K) as exact 0, so the band sum reads
//   shared memory only, with no branch on bounds; a CTA marching along the
//   planes stages each plane's union window once, one step ahead. pfold
//   folds each staged value once, a row and column group at a time (minv
//   staged a value a row beside it), and the offset-0 slots of the tile go
//   out as p. The codebook sits in shared memory as a table of 16
//   coefficients a diagonal, one per 4-bit code (a code past kk[d] holding
//   slot 0's value), so a decode is a code byte, a shift and one shared
//   load, once a row for all its columns (the row-class decode loads its
//   row's code once for every diagonal). On the 7-diagonal operators whose
//   codebooks hold at most 2 slots (the s-step pair and the LOBPCG block,
//   ops/dia.py:spmm_nd) the sum is unrolled and a coefficient is a select
//   between the diagonal's two values. A thread sums 4 items (2 where a
//   group is 32 bytes or more), an item a row and a group of KB columns
//   (KB = 1, 2, 4, 8: the smallest power of two at least min(K, 8); G groups
//   a row, a power of two), 256 items apart: a warp's lanes read
//   consecutive rows of the buffer, KB values each (8- or 16-byte shared
//   loads where the slabs allow: `vec`), and store them to y the same way.
// * The row form (form 0, the kernel's first design, unchanged): one thread a row and a
//   group of KB columns (blockIdx.z the group), KB accumulators in
//   registers, the operand rows read from global memory (16-byte vector
//   loads where K and KB are multiples of the vector and the slabs
//   aligned), the pfold form folding each operand row it reads.
//
// The staged form is taken where its plan reaches a tile of 1024 rows
// within 113 KB (two CTAs an SM): at 192^3 the K = 2 slabs in every mode
// on the row-class operator, plain and pfold on the select-chain A0, and K
// = 4 plain in f32; everything wider takes the row form. Times
// (tools/time_coded_kernels.py --block 2 4 8, 192^3 f32, flushed; NVIDIA
// H100 80GB HBM3, 700.00 W), staged against row form: K = 2 row class
// 74.7 against 156.2 us (bound 35.9), A0 91.4 against 162.2; K = 4 row
// class 118.4 against 181.4 (bound 69.7), A0 130.6 against 204.1 (bound
// 76.1); K = 2 pfold 155.2 against 184.4. Forms tried and dropped:
// * the staged form at smaller tiles: 512 rows ties or loses (A0 K = 2 pfold
//   199 against the row form's 189), 256 rows runs 2.5-3x the row form
//   (K = 8 plain 610 against 242, K = 4 pfold 746 against 261): each tile
//   stages the plane's 2n-row halo beside it, and one column of CTAs a
//   plane leaves the card half empty;
// * copies two steps ahead (a ring of one more buffer): 118.5 against
//   118.2 us at K = 2, no gain, and the extra buffer halves the tile at
//   K = 2 pfold (251 against 156);
// * the table lookup in a run-time loop for the 7-diagonal operators (the
//   generic sum): 98.7 us at K = 2 row class, 151.2 at K = 4 on A0;
// * 128 registers a thread (two CTAs an SM by registers): 118 against 95
//   us at K = 2; ptxas now caps a thread at 64 registers where a group is 8
//   bytes, 80 where 16, 128 above, with no spill;
// * a row form issuing a batch of diagonals' loads at once with the table
//   in shared memory: 184 against 156 us at K = 2, 277 against 242 at K = 8.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_MAX_DIAGS 64
#define PA_MAX_WINDOWS (PA_MAX_DIAGS + 1)
#define PA_MAX_BUFS (2 * PA_MAX_WINDOWS)
#define PA_SPMM_THREADS 256
// (row, column group) items a thread of the staged form sums: 4, or 2 where
// a group is 32 bytes or more (ops/dia.py:spmm_items)
template <typename T, int KB>
__host__ __device__ constexpr int spmm_items() { return KB * sizeof(T) >= 32 ? 2 : 4; }
// CTAs an SM the staged form is built for, by the bytes of a column group:
// 4 (64 registers a thread) up to 8 bytes, 3 (80) up to 16, else 2 (128)
template <typename T, int KB>
__host__ __device__ constexpr int staged_min_ctas() {
  return KB * sizeof(T) <= 8 ? 4 : KB * sizeof(T) <= 16 ? 3 : 2;
}
// coefficient table entries a diagonal: one per 4-bit code
#define PA_CODES 16

struct PaSpmmParams {
  int P;               // stacked parts
  int D;               // diagonals
  int kmax;            // codebook slots per diagonal
  int n_streams;       // packed code byte streams
  long long code_len;  // bytes per stream per part (the band length n)
  long long wx;        // operand frame width (rows)
  long long wy;        // result frame width (rows)
  long long o0;        // owned offset in both frames
  int K;               // columns
  int mode;            // 0: y = A x; 1: pfold; 2: pfold with minv
  int off[PA_MAX_DIAGS];
  int kk[PA_MAX_DIAGS];
  int code_row[PA_MAX_DIAGS];
  int KB;              // columns a thread (1, 2, 4 or 8)
  int vec;             // rows moved as vectors
  // the staged form (form 1); its plan (ops/dia.py:plan_coded_block_windows),
  // byte offsets in shared memory. Step k of a CTA sums the tile at row
  // ts(k) = ts0 + k * tstep.
  int form;            // 0: the row form, 1: the staged form
  int T;               // rows per tile
  int G;               // column groups a row, a power of two (T * G <= items * PA_SPMM_THREADS)
  int ncol;            // marching: tiles per plane, ceil(stride / T)
  int planes;          // marching: planes per CTA (set at the plan's first launch)
  int lead;            // steps staged before the first (planes read - 1 marching, else 0)
  int n_buf;           // operand buffers
  int step_bufs;       // buffer index advance per step
  int grid_x;          // CTAs per part, 0 until the plan's first launch sets it
  int n_new;           // windows staged per step
  int zero_win;        // the read window that holds offset 0
  int one_code;        // every coded diagonal on one nibble (the row-class decode)
  int code0;           // the coded index whose nibble a constant diagonal reads (its table is flat)
  int nd_spec;         // 7: the unrolled two-slot sum (plain mode, 7 diagonals, kk <= 2); else 0
  int ccf_at;          // head: the coefficient table, PA_CODES a diagonal
  int beta_at;         // head: beta, K values
  int sidx_at;         // head: per-step operand slot of each diagonal (and of offset 0)
  int cidx_at;         // head: per-step code byte slot of each diagonal in the stage
  int csh_at;          // head: the nibble shift of each diagonal
  int pp_shift;        // pfold: a buffer's pprev lies pp_shift bytes after it
  int mv_at;           // pfold with minv: minv buffer b at mv_at + b * mv_bytes
  int mv_bytes;
  int stage_at;        // two stages of the tile's code bytes from here
  int stage_bytes;
  int code_stride;     // bytes per code stream in a stage
  int smem_bytes;
  long long stride;    // marching plane stride (rows; 0: tiles walk the part)
  // read window c of step k starts at row ts(k) + win_src[c] of buffer
  // (k * step_bufs + win_buf[c]) mod n_buf; new window s of step k, staged
  // one step ahead, holds new_len[s] rows from ts(k) + new_src[s] in buffer
  // (k * step_bufs + new_buf[s]) mod n_buf
  int win_src[PA_MAX_WINDOWS];
  int win_buf[PA_MAX_WINDOWS];
  int new_src[PA_MAX_WINDOWS];
  int new_buf[PA_MAX_WINDOWS];
  int new_len[PA_MAX_WINDOWS];
  int buf_at[PA_MAX_BUFS];
  int diag_win[PA_MAX_DIAGS];  // read window of diagonal d
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ void unpack(float* b, float4 c) { b[0] = c.x; b[1] = c.y; b[2] = c.z; b[3] = c.w; }
__device__ __forceinline__ void unpack(double* b, double2 c) { b[0] = c.x; b[1] = c.y; }
__device__ __forceinline__ void unpack(float* b, float2 c) { b[0] = c.x; b[1] = c.y; }
__device__ __forceinline__ float4 pack(const float* b) { return make_float4(b[0], b[1], b[2], b[3]); }
__device__ __forceinline__ double2 pack(const double* b) { return make_double2(b[0], b[1]); }
__device__ __forceinline__ float2 pack2(const float* b) { return make_float2(b[0], b[1]); }

// The first n (<= KB) of the KB values at src: as 16-byte vectors with VEC
// (src 16-byte aligned, n a multiple of the vector), else one by one.
template <typename T, int KB, bool VEC>
__device__ __forceinline__ void load_row(const T* src, int n, T (&v)[KB]) {
  if constexpr (VEC) {
    constexpr int NV = 16 / (int)sizeof(T);
#pragma unroll
    for (int q = 0; q < KB / NV; ++q)
      if (q * NV < n) unpack(v + q * NV, reinterpret_cast<const typename Vec16<T>::type*>(src)[q]);
  } else {
#pragma unroll
    for (int c = 0; c < KB; ++c)
      if (c < n) v[c] = src[c];
  }
}

template <typename T, int KB, bool VEC>
__device__ __forceinline__ void store_row(T* dst, int n, const T (&v)[KB]) {
  if constexpr (VEC) {
    constexpr int NV = 16 / (int)sizeof(T);
#pragma unroll
    for (int q = 0; q < KB / NV; ++q)
      if (q * NV < n) reinterpret_cast<typename Vec16<T>::type*>(dst)[q] = pack(v + q * NV);
  } else {
#pragma unroll
    for (int c = 0; c < KB; ++c)
      if (c < n) dst[c] = v[c];
  }
}

// ---------------------------------------------------------------------------
// the row form
// ---------------------------------------------------------------------------

// the operand row j (owned, 0 <= j < no) of the thread's columns: x, or
// the fold r + b * pprev (MODE 1), minv * r + b * pprev (MODE 2)
template <typename T, int MODE, int KB, bool VEC>
__device__ __forceinline__ void operand_row(const T* xp, const T* pp, const T* mp, long long j, int K, int n,
                                            const T (&b)[KB], T (&u)[KB]) {
  load_row<T, KB, VEC>(xp + j * K, n, u);
  if constexpr (MODE != 0) {
    T q[KB];
    load_row<T, KB, VEC>(pp + j * K, n, q);
    const T m = MODE == 2 ? mp[j] : T(0);
#pragma unroll
    for (int c = 0; c < KB; ++c) u[c] = add_rn(MODE == 2 ? mul_rn(m, u[c]) : u[c], mul_rn(b[c], q[c]));
  }
}

template <typename T, int MODE, int KB, bool VEC>
__global__ void __launch_bounds__(PA_SPMM_THREADS)
dia_coded_spmm_kernel(const PaSpmmParams prm, const T* __restrict__ cb, const int32_t* __restrict__ no_arr,
                      const uint8_t* __restrict__ codes, const T* __restrict__ x, const T* __restrict__ pprev,
                      const T* __restrict__ beta, const T* __restrict__ minv, T* __restrict__ y,
                      T* __restrict__ pout) {
  const int p = blockIdx.y;
  const int K = prm.K, c0 = blockIdx.z * KB;
  const int nv = K - c0 < KB ? K - c0 : KB;
  const long long no = no_arr[p];
  const long long n = prm.code_len;
  const T* xp = x + ((long long)p * prm.wx + prm.o0) * K + c0;
  const T* pp = MODE != 0 ? pprev + ((long long)p * prm.wx + prm.o0) * K + c0 : nullptr;
  const T* mp = MODE == 2 ? minv + (long long)p * prm.wx + prm.o0 : nullptr;
  const T* cbp = cb + (long long)p * prm.D * prm.kmax;
  const uint8_t* cpart = codes + (long long)p * prm.n_streams * n;
  T* yp = y + ((long long)p * prm.wy + prm.o0) * K + c0;
  T* vp = MODE != 0 ? pout + ((long long)p * prm.wx + prm.o0) * K + c0 : nullptr;
  T b[KB];
#pragma unroll
  for (int c = 0; c < KB; ++c) b[c] = MODE != 0 && c < nv ? beta[c0 + c] : T(0);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    T acc[KB];
    if (i >= no) {
#pragma unroll
      for (int c = 0; c < KB; ++c) acc[c] = T(0);
      store_row<T, KB, VEC>(yp + i * K, nv, acc);
      if (MODE != 0) store_row<T, KB, VEC>(vp + i * K, nv, acc);
      continue;
    }
#pragma unroll
    for (int c = 0; c < KB; ++c) acc[c] = T(-0.0);
    for (int d = 0; d < prm.D; ++d) {
      T v;
      if (prm.kk[d] == 1) {
        v = cbp[d * prm.kmax];
      } else {
        const int ci = prm.code_row[d];
        const int cc = (cpart[(long long)(ci >> 1) * n + i] >> (4 * (ci & 1))) & 15;
        v = cbp[d * prm.kmax + (cc < prm.kk[d] ? cc : 0)];
      }
      const long long j = i + prm.off[d];
      T u[KB];
      if (j >= 0 && j < no) {
        operand_row<T, MODE, KB, VEC>(xp, pp, mp, j, K, nv, b, u);
      } else {
#pragma unroll
        for (int c = 0; c < KB; ++c) u[c] = T(0);
      }
#pragma unroll
      for (int c = 0; c < KB; ++c) acc[c] = add_rn(acc[c], mul_rn(v, u[c]));
    }
    store_row<T, KB, VEC>(yp + i * K, nv, acc);
    if (MODE != 0) {
      T u[KB];
      operand_row<T, MODE, KB, VEC>(xp, pp, mp, i, K, nv, b, u);
      store_row<T, KB, VEC>(vp + i * K, nv, u);
    }
  }
  // the rows outside the band: [0, o0) and [o0 + n, width) of y (and p)
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long row = t0; row < prm.wy - n; row += stride)
    for (int c = 0; c < nv; ++c) y[((long long)p * prm.wy + (row < prm.o0 ? row : row + n)) * K + c0 + c] = T(0);
  if (MODE != 0)
    for (long long row = t0; row < prm.wx - n; row += stride)
      for (int c = 0; c < nv; ++c) pout[((long long)p * prm.wx + (row < prm.o0 ? row : row + n)) * K + c0 + c] = T(0);
}

// ---------------------------------------------------------------------------
// the staged form: cp.async staging (as csrc/dia_coded.cu stages)
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, int src_bytes) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(N), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The slot phase of element g of src in its 16-byte chunk.
template <typename E>
__device__ __forceinline__ int phase(const E* src, long long g) {
  return (int)(((long long)((uintptr_t)src / sizeof(E)) + g) & (16 / (long long)sizeof(E) - 1));
}

// Copy elements [g_lo, g_lo + len) of src (valid on [0, lim)) into the
// window at dst: element g lands at slot phase(src, g_lo) + g - g_lo, so the
// source's 16-byte chunks land on the window's. Slots of g >= lim are
// zero-filled by the copy's source size, and slots of g < 0 are 0 too.
template <typename E>
__device__ __forceinline__ void stage_window(unsigned char* dst, const E* src, long long g_lo,
                                             long long len, long long lim) {
  constexpr int S = (int)sizeof(E);
  constexpr int V = 16 / S;
  const long long base = (long long)(uintptr_t)src;
  const long long c_lo = (base + g_lo * S) & ~15LL;
  const int nq = (int)((base + (g_lo + len) * S - c_lo + 15) >> 4);
  const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
  for (int k = threadIdx.x; k < nq; k += blockDim.x) {
    const long long gq = (c_lo + 16LL * k - base) / S;
    const unsigned d = sdst + 16u * (unsigned)k;
    long long nv = lim - gq;
    nv = nv < 0 ? 0 : nv > V ? V : nv;
    // a copy of fewer bytes than its size zero-fills the rest and reads
    // nothing past them: the address of a chunk past either end of src
    // stays aligned and is never read
    if (gq >= 0) {
      cp_async<16>(d, src + gq, (int)nv * S);
    } else if (gq + V <= 0) {
      cp_async<16>(d, src + gq, 0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const long long g = gq + e;
        cp_async<S>(d + e * S, src + g, g >= 0 && g < lim ? S : 0);
      }
    }
  }
}

// The tile's code bytes [ts, ts + T) of every stream into the code stage:
// stream s at code_stride * s, landing with its source's 16-byte phase,
// zero-filled past no (K1's stage_codes).
__device__ __forceinline__ void stage_codes(const PaSpmmParams& prm, unsigned char* dst, const uint8_t* cpart,
                                            long long ts, long long no) {
  const int NQ = (prm.T + 30) >> 4;  // chunks a stream's T bytes span at most
  int s = threadIdx.x / NQ, j = threadIdx.x - s * NQ;
  const int ds = blockDim.x / NQ, dj = blockDim.x - ds * NQ;
  const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
  while (s < prm.n_streams) {
    const uint8_t* src = cpart + s * prm.code_len;
    const long long base = (long long)(uintptr_t)src;
    const long long c_lo = (base + ts) & ~15LL;
    if (j < (int)((base + ts + prm.T - c_lo + 15) >> 4)) {
      const long long gq = c_lo + 16LL * j - base;
      long long nv = no - gq;
      nv = nv < 0 ? 0 : nv > 16 ? 16 : nv;
      cp_async<16>(sdst + (unsigned)(s * prm.code_stride + 16 * j), src + gq, (int)nv);
    }
    s += ds;
    j += dj;
    if (j >= NQ) {
      j -= NQ;
      ++s;
    }
  }
}

__device__ __forceinline__ int buffer_index(const PaSpmmParams& prm, int k, int rel) {
  const int b = (k * prm.step_bufs + rel) % prm.n_buf;
  return b < 0 ? b + prm.n_buf : b;
}

// Issue the copies of step k (tile at row ts): its new operand windows (K
// values a row; minv a value a row) and, with `rows`, the tile's code bytes
// into stage k & 1.
template <typename T, int MODE>
__device__ __forceinline__ void stage_step(const PaSpmmParams& prm, unsigned char* smem, int k, long long ts,
                                           bool rows, long long no, const T* xp, const T* pp, const T* mp,
                                           const uint8_t* cpart) {
  const int K = prm.K;
  for (int s = 0; s < prm.n_new; ++s) {
    const int bi = buffer_index(prm, k, prm.new_buf[s]);
    unsigned char* b = smem + prm.buf_at[bi];
    const long long g = ts + prm.new_src[s];
    stage_window<T>(b, xp, g * K, (long long)prm.new_len[s] * K, no * K);
    if (MODE != 0) stage_window<T>(b + prm.pp_shift, pp, g * K, (long long)prm.new_len[s] * K, no * K);
    if (MODE == 2) stage_window<T>(smem + prm.mv_at + bi * prm.mv_bytes, mp, g, prm.new_len[s], no);
  }
  if (rows) stage_codes(prm, smem + prm.stage_at + (k & 1) * prm.stage_bytes, cpart, ts, no);
}

// A group of KB values of shared memory at src (the first n of them): with
// VEC as vectors of min(16, KB * sizeof(T)) bytes (src aligned to them),
// else one by one.
template <typename T, int KB, bool VEC>
__device__ __forceinline__ void load_group(const T* src, int n, T (&v)[KB]) {
  if constexpr (VEC && KB * sizeof(T) == 8) {
    unpack(v, *reinterpret_cast<const float2*>(src));
  } else {
    load_row<T, KB, VEC>(src, n, v);
  }
}

template <typename T, int KB, bool VEC>
__device__ __forceinline__ void store_group(T* dst, int n, const T (&v)[KB]) {
  if constexpr (VEC && KB * sizeof(T) == 8) {
    *reinterpret_cast<float2*>(dst) = pack2(reinterpret_cast<const float*>(v));
  } else {
    store_row<T, KB, VEC>(dst, n, v);
  }
}

// The fold over a staged window of `len` rows, in place at sr (r from phase
// ph_r, pprev at sq from ph_q, each K values a row; minv at sm from ph_m, a
// value a row): an item is a row and a column group, as in the band sum
// (G a power of two), its KB values loaded and stored as the band sum's.
template <typename T, int MODE, int KB, bool VEC>
__device__ __forceinline__ void fold_window(T* sr, const T* sq, const T* sm, int ph_r, int ph_q, int ph_m,
                                            int len, int K, int G, const T* sbeta) {
  const int grp = threadIdx.x & (G - 1), c0 = grp * KB, nv = K - c0 < KB ? K - c0 : KB;
  const int rstep = PA_SPMM_THREADS / G;
  T b[KB];
#pragma unroll
  for (int e = 0; e < KB; ++e) b[e] = e < nv ? sbeta[c0 + e] : T(0);
  for (int row = threadIdx.x / G; row < len; row += rstep) {
    T u[KB], q[KB];
#pragma unroll
    for (int e = 0; e < KB; ++e) u[e] = q[e] = T(0);
    T* at = sr + ph_r + row * K + c0;
    load_group<T, KB, VEC>(at, nv, u);
    load_group<T, KB, VEC>(sq + ph_q + row * K + c0, nv, q);
    const T m = MODE == 2 ? sm[ph_m + row] : T(0);
#pragma unroll
    for (int e = 0; e < KB; ++e) u[e] = add_rn(MODE == 2 ? mul_rn(m, u[e]) : u[e], mul_rn(b[e], q[e]));
    store_group<T, KB, VEC>(at, nv, u);
  }
}

// ND > 0: the sum unrolled over ND diagonals whose codebooks hold at most
// two slots (kk <= 2: a code of 1 reads slot 1, any other slot 0), the
// coefficient a select between the diagonal's two values; ONE: every coded
// diagonal on one nibble, read once a row (the row-class decode). ND = 0:
// any operator, the table lookup in a run-time loop.
template <typename T, int MODE, int KB, bool VEC, int ND, bool ONE>
__global__ void __launch_bounds__(PA_SPMM_THREADS, (staged_min_ctas<T, KB>()))
dia_coded_spmm_staged(const PaSpmmParams prm, const T* __restrict__ cb, const int32_t* __restrict__ no_arr,
                      const uint8_t* __restrict__ codes, const T* __restrict__ x, const T* __restrict__ pprev,
                      const T* __restrict__ beta, const T* __restrict__ minv, T* __restrict__ y,
                      T* __restrict__ pout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* sop = reinterpret_cast<const T*>(smem);
  T* sccf = reinterpret_cast<T*>(smem + prm.ccf_at);
  T* sbeta = reinterpret_cast<T*>(smem + prm.beta_at);
  int* sidx = reinterpret_cast<int*>(smem + prm.sidx_at);
  int* cidx = reinterpret_cast<int*>(smem + prm.cidx_at);
  int* csh = reinterpret_cast<int*>(smem + prm.csh_at);

  const int p = blockIdx.y;
  const int K = prm.K, D = prm.D;
  const long long no = no_arr[p];
  const T* xp = x + ((long long)p * prm.wx + prm.o0) * K;
  const T* pp = MODE != 0 ? pprev + ((long long)p * prm.wx + prm.o0) * K : nullptr;
  const T* mp = MODE == 2 ? minv + (long long)p * prm.wx + prm.o0 : nullptr;
  T* yp = y + ((long long)p * prm.wy + prm.o0) * K;
  T* vp = MODE != 0 ? pout + ((long long)p * prm.wx + prm.o0) * K : nullptr;
  const uint8_t* cpart = codes + (long long)p * prm.n_streams * prm.code_len;
  const int TR = prm.T;

  // this CTA's tiles: ts(k) = ts0 + k * tstep for k < steps, each of at most
  // rowcap rows
  long long ts0, tstep;
  int steps, rowcap;
  if (prm.stride > 0) {
    const long long M = prm.stride;
    const int col = blockIdx.x % prm.ncol;
    const long long z0 = (long long)(blockIdx.x / prm.ncol) * prm.planes;
    const long long nz = (no + M - 1) / M;
    const long long left = nz - z0;
    steps = left <= 0 ? 0 : (int)(left < prm.planes ? left : prm.planes);
    ts0 = z0 * M + (long long)col * TR;
    tstep = M;
    const long long cap = M - (long long)col * TR;
    rowcap = cap < TR ? (int)cap : TR;
  } else {
    const long long ntiles = (no + TR - 1) / TR;
    steps = blockIdx.x < ntiles ? (int)((ntiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
    ts0 = (long long)blockIdx.x * TR;
    tstep = (long long)gridDim.x * TR;
    rowcap = TR;
  }

  if (steps > 0)
    for (int k = -prm.lead; k <= 0; ++k) stage_step<T, MODE>(prm, smem, k, ts0 + k * tstep, k == 0, no, xp, pp, mp, cpart);
  cp_async_commit();

  // the head: coefficient table (the value code c of diagonal d selects),
  // beta, each diagonal's nibble shift
  const T* cbp = cb + (long long)p * D * prm.kmax;
  for (int e = threadIdx.x; e < D * PA_CODES; e += blockDim.x) {
    const int d = e / PA_CODES, c = e - d * PA_CODES;
    sccf[e] = cbp[d * prm.kmax + (prm.kk[d] > 1 && c < prm.kk[d] ? c : 0)];
  }
  if (MODE != 0)
    for (int c = threadIdx.x; c < K; c += blockDim.x) sbeta[c] = beta[c];
  for (int d = threadIdx.x; d < D; d += blockDim.x) csh[d] = 4 * ((prm.kk[d] > 1 ? prm.code_row[d] : prm.code0) & 1);
  // every slot outside the owned band: y (and p) 0
  {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long lo = prm.o0 * K, band = no * K;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < (prm.wy - no) * K; e += stride)
      y[(long long)p * prm.wy * K + (e < lo ? e : e + band)] = T(0);
    if (MODE != 0)
      for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < (prm.wx - no) * K; e += stride)
        pout[(long long)p * prm.wx * K + (e < lo ? e : e + band)] = T(0);
  }

  // this thread's items (step-invariant): item q = threadIdx.x + r * 256 of
  // the tile is row q / G and column group q % G (G a power of two): rows
  // row0 + r * rstep, columns [c0, c0 + nv) of each, row < T
  constexpr int ITEMS = spmm_items<T, KB>();
  const int G = prm.G;
  const int grp = threadIdx.x & (G - 1), row0 = threadIdx.x / G, rstep = PA_SPMM_THREADS / G;
  const int c0 = grp * KB, nv = K - c0 < KB ? K - c0 : KB;

  for (int k = 0; k < steps; ++k) {
    const long long ts = ts0 + k * tstep;
    const int st = prm.stage_at + (k & 1) * prm.stage_bytes;
    // the slot of row 0 of the tile for each diagonal, and for offset 0 at
    // D; the stage slot of each diagonal's code byte for row 0
    for (int d = threadIdx.x; d <= D; d += blockDim.x) {
      const int c = d < D ? prm.diag_win[d] : prm.zero_win;
      const int o = d < D ? prm.off[d] : 0;
      sidx[d] = prm.buf_at[buffer_index(prm, k, prm.win_buf[c])] / (int)sizeof(T) +
                phase(xp, (ts + prm.win_src[c]) * K) + (o - prm.win_src[c]) * K;
      if (d < D) {
        const int s = (prm.kk[d] > 1 ? prm.code_row[d] : prm.code0) >> 1;
        cidx[d] = st + s * prm.code_stride + phase(cpart + s * prm.code_len, ts);
      }
    }
    if (k + 1 < steps) stage_step<T, MODE>(prm, smem, k + 1, ts + tstep, true, no, xp, pp, mp, cpart);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    if (MODE != 0) {
      // the fold once per staged value: the windows that arrived for this
      // step (at the first, those staged ahead of it too)
      for (int j = k == 0 ? -prm.lead : k; j <= k; ++j) {
        const long long tj = ts0 + j * tstep;
        for (int s = 0; s < prm.n_new; ++s) {
          const int bi = buffer_index(prm, j, prm.new_buf[s]);
          unsigned char* b = smem + prm.buf_at[bi];
          const long long g = tj + prm.new_src[s];
          fold_window<T, MODE, KB, VEC>(reinterpret_cast<T*>(b), reinterpret_cast<const T*>(b + prm.pp_shift),
                                        reinterpret_cast<const T*>(smem + prm.mv_at + bi * prm.mv_bytes),
                                        phase(xp, g * K), phase(pp, g * K), MODE == 2 ? phase(mp, g) : 0,
                                        prm.new_len[s], K, prm.G, sbeta);
        }
      }
      __syncthreads();
    }

    const long long left = no - ts;
    const int nrow = left < rowcap ? (int)left : rowcap;
    if (nrow > 0) {
      T acc[ITEMS][KB];
#pragma unroll
      for (int r = 0; r < ITEMS; ++r)
#pragma unroll
        for (int c = 0; c < KB; ++c) acc[r][c] = T(-0.0);
      int code[ITEMS] = {};
      if (ND > 0 ? ONE : prm.one_code) {
        const unsigned char* sc = smem + cidx[0] + row0;
        const int sh = csh[0];
#pragma unroll
        for (int r = 0; r < ITEMS; ++r)
          if (row0 + r * rstep < TR) code[r] = (sc[r * rstep] >> sh) & 15;
      }
      if constexpr (ND > 0) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const T* xs = sop + sidx[d] + row0 * K + c0;
          const T a0 = sccf[d * PA_CODES], a1 = sccf[d * PA_CODES + 1];
          const unsigned char* sc = smem + cidx[d] + row0;
          const int sh = csh[d];
#pragma unroll
          for (int r = 0; r < ITEMS; ++r) {
            if (row0 + r * rstep < TR) {
              const int c = ONE ? code[r] : (sc[r * rstep] >> sh) & 15;
              const T v = c == 1 ? a1 : a0;
              T u[KB];
#pragma unroll
              for (int e = 0; e < KB; ++e) u[e] = T(0);
              load_group<T, KB, VEC>(xs + r * rstep * K, nv, u);
#pragma unroll
              for (int e = 0; e < KB; ++e) acc[r][e] = add_rn(acc[r][e], mul_rn(v, u[e]));
            }
          }
        }
      } else {
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const T* xs = sop + sidx[d] + row0 * K + c0;
          const T* cf = sccf + d * PA_CODES;
          const unsigned char* sc = smem + cidx[d] + row0;
          const int sh = csh[d];
#pragma unroll
          for (int r = 0; r < ITEMS; ++r) {
            if (row0 + r * rstep < TR) {
              const int c = prm.one_code ? code[r] : (sc[r * rstep] >> sh) & 15;
              const T v = cf[c];
              T u[KB];
#pragma unroll
              for (int e = 0; e < KB; ++e) u[e] = T(0);
              load_group<T, KB, VEC>(xs + r * rstep * K, nv, u);
#pragma unroll
              for (int e = 0; e < KB; ++e) acc[r][e] = add_rn(acc[r][e], mul_rn(v, u[e]));
            }
          }
        }
      }
      const T* zs = sop + sidx[D] + row0 * K + c0;
#pragma unroll
      for (int r = 0; r < ITEMS; ++r) {
        const int row = row0 + r * rstep;
        if (row < nrow) {
          const long long at = (ts + row) * K + c0;
          store_group<T, KB, VEC>(yp + at, nv, acc[r]);
          if (MODE != 0) {
            T u[KB];
            load_group<T, KB, VEC>(zs + r * rstep * K, nv, u);
            store_group<T, KB, VEC>(vp + at, nv, u);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int MODE, int KB>
static int launch_kb(const PaSpmmParams* prm, const void* cb, const void* no, const void* codes, const void* x,
                     const void* pprev, const void* beta, const void* minv, void* y, void* pout, void* stream) {
  long long gx = (prm->code_len + PA_SPMM_THREADS - 1) / PA_SPMM_THREADS;
  gx = gx < 1 ? 1 : gx > 65535 * 16 ? 65535 * 16 : gx;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P, (unsigned int)((prm->K + KB - 1) / KB));
  constexpr int NV = 16 / (int)sizeof(T);
  if (prm->vec) {
    if constexpr (KB % NV == 0) {
      if (prm->K % NV != 0) return (int)cudaErrorInvalidValue;
      dia_coded_spmm_kernel<T, MODE, KB, true><<<grid, PA_SPMM_THREADS, 0, (cudaStream_t)stream>>>(
          *prm, (const T*)cb, (const int32_t*)no, (const uint8_t*)codes, (const T*)x, (const T*)pprev,
          (const T*)beta, (const T*)minv, (T*)y, (T*)pout);
      return (int)cudaGetLastError();
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  dia_coded_spmm_kernel<T, MODE, KB, false><<<grid, PA_SPMM_THREADS, 0, (cudaStream_t)stream>>>(
      *prm, (const T*)cb, (const int32_t*)no, (const uint8_t*)codes, (const T*)x, (const T*)pprev,
      (const T*)beta, (const T*)minv, (T*)y, (T*)pout);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, int KB, bool VEC, int ND, bool ONE>
static int launch_staged_kernel(PaSpmmParams* prm, const void* cb, const void* no, const void* codes, const void* x,
                                const void* pprev, const void* beta, const void* minv, void* y, void* pout,
                                void* stream) {
  auto kern = dia_coded_spmm_staged<T, MODE, KB, VEC, ND, ONE>;
  static int n_sm = 0;
  cudaError_t e;
  if (n_sm == 0) {
    int dev, optin, sms;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess) return (int)e;
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) != cudaSuccess)
      return (int)e;
    n_sm = sms;
  }
  if (prm->grid_x == 0) {
    // once per plan (ops/dia.py keeps a plan's parameters per frame widths,
    // mode, K, dtype and vec): one wave of CTAs that fills every SM
    int occ;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, PA_SPMM_THREADS, prm->smem_bytes)) !=
        cudaSuccess)
      return (int)e;
    occ = occ < 1 ? 1 : occ;
    const long long per_part = ((long long)occ * n_sm + prm->P - 1) / prm->P;
    long long gx;
    if (prm->stride > 0) {
      const long long nz = (prm->code_len + prm->stride - 1) / prm->stride;
      long long chunks = per_part / prm->ncol;
      chunks = chunks < 1 ? 1 : chunks > nz ? nz : chunks;
      prm->planes = (int)((nz + chunks - 1) / chunks);
      gx = (long long)prm->ncol * ((nz + prm->planes - 1) / prm->planes);
    } else {
      const long long tiles = (prm->code_len + prm->T - 1) / prm->T;
      gx = per_part > tiles ? tiles : per_part;
    }
    prm->grid_x = gx < 1 ? 1 : (int)gx;
  }
  dim3 grid((unsigned int)prm->grid_x, (unsigned int)prm->P);
  kern<<<grid, PA_SPMM_THREADS, prm->smem_bytes, (cudaStream_t)stream>>>(
      *prm, (const T*)cb, (const int32_t*)no, (const uint8_t*)codes, (const T*)x, (const T*)pprev, (const T*)beta,
      (const T*)minv, (T*)y, (T*)pout);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, int KB>
static int launch_staged(PaSpmmParams* prm, const void* cb, const void* no, const void* codes, const void* x,
                         const void* pprev, const void* beta, const void* minv, void* y, void* pout, void* stream) {
  if (prm->G < 1 || (prm->G & (prm->G - 1)) != 0 || PA_SPMM_THREADS % prm->G != 0 ||
      prm->T * prm->G > spmm_items<T, KB>() * PA_SPMM_THREADS)
    return (int)cudaErrorInvalidValue;
  // vectors of min(16, KB * sizeof(T)) bytes, wider than one value
  constexpr bool CAN_VEC = KB * sizeof(T) >= 8 && KB > 1;
  if (prm->vec && !CAN_VEC) return (int)cudaErrorInvalidValue;
  // the unrolled two-slot sum of the 7-diagonal operators: plain mode at the
  // s-step and LOBPCG widths (ops/dia.py:spmm_nd)
  if constexpr (MODE == 0 && (KB == 2 || KB == 4)) {
    if (prm->nd_spec == 7) {
      if (prm->vec) {
        if (prm->one_code)
          return launch_staged_kernel<T, MODE, KB, CAN_VEC, 7, true>(prm, cb, no, codes, x, pprev, beta, minv, y,
                                                                     pout, stream);
        return launch_staged_kernel<T, MODE, KB, CAN_VEC, 7, false>(prm, cb, no, codes, x, pprev, beta, minv, y,
                                                                    pout, stream);
      }
      if (prm->one_code)
        return launch_staged_kernel<T, MODE, KB, false, 7, true>(prm, cb, no, codes, x, pprev, beta, minv, y, pout,
                                                                 stream);
      return launch_staged_kernel<T, MODE, KB, false, 7, false>(prm, cb, no, codes, x, pprev, beta, minv, y, pout,
                                                                stream);
    }
  }
  if (prm->nd_spec != 0) return (int)cudaErrorInvalidValue;
  if (prm->vec)
    return launch_staged_kernel<T, MODE, KB, CAN_VEC, 0, false>(prm, cb, no, codes, x, pprev, beta, minv, y, pout,
                                                                stream);
  return launch_staged_kernel<T, MODE, KB, false, 0, false>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
}

template <typename T, int MODE>
static int launch_mode(PaSpmmParams* prm, const void* cb, const void* no, const void* codes, const void* x,
                       const void* pprev, const void* beta, const void* minv, void* y, void* pout, void* stream) {
  if (prm->form == 1) {
    switch (prm->KB) {
      case 1: return launch_staged<T, MODE, 1>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
      case 2: return launch_staged<T, MODE, 2>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
      case 4: return launch_staged<T, MODE, 4>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
      case 8: return launch_staged<T, MODE, 8>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (prm->form != 0) return (int)cudaErrorInvalidValue;
  switch (prm->KB) {
    case 1: return launch_kb<T, MODE, 1>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    case 2: return launch_kb<T, MODE, 2>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    case 4: return launch_kb<T, MODE, 4>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    case 8: return launch_kb<T, MODE, 8>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch(PaSpmmParams* prm, const void* cb, const void* no, const void* codes, const void* x,
                  const void* pprev, const void* beta, const void* minv, void* y, void* pout, void* stream) {
  if (prm->D < 1 || prm->D > PA_MAX_DIAGS || prm->K < 1) return (int)cudaErrorInvalidValue;
  switch (prm->mode) {
    case 0: return launch_mode<T, 0>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    case 1: return launch_mode<T, 1>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    case 2: return launch_mode<T, 2>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int pa_dia_coded_spmm_f32(PaSpmmParams* prm, const void* cb, const void* no, const void* codes, const void* x,
                          const void* pprev, const void* beta, const void* minv, void* y, void* pout, void* stream) {
  return launch<float>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
}

int pa_dia_coded_spmm_f64(PaSpmmParams* prm, const void* cb, const void* no, const void* codes, const void* x,
                          const void* pprev, const void* beta, const void* minv, void* y, void* pout, void* stream) {
  return launch<double>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
}

}  // extern "C"
