// Coded-diagonal (coded-DIA) SpMV for Hopper (sm_90a), with its CG
// direction-fold and lagged-axpy variants.
//
// Replaces the TPU kernel `_padded_kernel` (partitionedarrays_jl_tpu/ops/
// pallas_dia.py:195): its plain call (`dia_coded_padded_pallas`,
// pallas_call at :523), its `has_pfold` call (pallas_call at :500) and its
// `has_axpy` call (pallas_call at :535). Both decode modes are here: the
// select-chain decode (pallas_dia.py:329-350) and the row-class decode
// (:300-328).
//
// What it computes, per part p (blockIdx.y) and owned row i < no[p]:
//   y[p, o0 + i] = sum_d v_d(i) * x[p, o0 + i + off_d]   (ascending d)
//   every other slot of y is exactly 0. A read at i + off_d outside
//   [0, no[p]) is 0 (the compact frame has no zero pads).
//   v_d(i) is cb[p, d, 0] for a constant diagonal (kk[d] == 1), else
//   cb[p, d, c] with c the 4-bit code of diagonal d (two diagonals per
//   byte, low nibble = even coded index; a code >= kk[d] reads slot 0).
//   Row-class mode (n_cls > 0): c is the low nibble of stream 0, the row's
//   class (>= n_cls reads class 0). The sum skips the diagonals that no
//   class takes (coefficient zero in every class and part, cls_mask); a
//   row whose class has a zero coefficient on a diagonal another class
//   takes adds that exact zero times x, as the plain version does (the TPU
//   kernel's per-class sums leave such terms out: the same value for a
//   finite x, up to the sign of a zero).
//   pfold (PA_PFOLD): the operand is p = r + beta * pprev; the kernel also
//   writes p on the owned band and 0 elsewhere. pfold with minv
//   (PA_PFOLDM, Jacobi PCG): p = minv * r + beta * pprev, the product
//   minv * r rounded first, then beta * pprev, then the add (the fold of
//   the JAX package's jnp branch, `z = mvv * rv; pnew = z + beta * pv`,
//   parallel/tpu.py:3284-3286, which runs beside its Pallas kernel there).
//   axpy (PA_AXPY, pipelined CG): y as above from x, and in the same pass
//   xacc[p, o0 + i] = xacc[p, o0 + i] + alpha * pprev[p, o0 + i] for
//   i < no[p], in place; every other slot of xacc is left untouched. With
//   a device flag `live` (int32, may be null) that reads 0, xacc is not
//   written at all (y still is): a frozen iteration of the device-resident
//   pipelined loop (parallel/gpu.py) leaves the solution as it is.
//
// Rounding: every product and sum is __fmul_rn / __fadd_rn (no FMA
// contraction), in ascending-offset order, so the result equals the plain
// PyTorch version in ops/dia.py value for value (up to the sign of a zero
// sum: the sum starts from -0, and the row-class decode skips diagonals).
//
// Bound: memory. At 192^3 f32, one part, the row-class SpMV moves x (4 B),
// one code byte and y (4 B) per row: 9 B/row, 63.7 MB, about 19.0 us at
// 3.35 TB/s; the pfold variant moves r, pprev, the code byte, y and p:
// 17 B/row, 120.3 MB, about 35.9 us (with minv 21 B/row, 148.6 MB, about
// 44.4 us); the axpy variant moves x, the code
// byte, y, pprev and xacc read and written: 21 B/row, 148.6 MB, about
// 44.4 us. 2 flops per stored coefficient are far below any compute limit.
//
// Design. The first version (one thread per row, a loop over diagonals with
// a run-time trip count and a bounds branch on every operand read) waited
// on its 7 shifted loads one after another and reached 18-38% of the bound.
// This one stages the operand in shared memory and keeps the band sum to a
// few instructions a term. Times below are back-to-back launches at 192^3
// f32 in row-class decode (tools/time_coded_kernels.py, loop_ms, on an
// NVIDIA H100 80GB HBM3 at 700 W); the forms they compare were not kept.
//
// * Tiles and windows. A CTA sums tiles of T rows of one part. The host
//   planner (ops/dia.py:plan_coded_windows) groups the ascending offsets
//   (and 0) into read windows: offsets closer than T share one. For the
//   7-point stencil at n^2 > T that is {-n^2}, {-n..n}, {+n^2}; for the
//   27-point stencils three windows 2n+2 wide. Operand values are staged in
//   shared-memory buffers; a value outside [0, no[p]) is staged as exact 0,
//   so the band sum reads shared memory only, with no branch on bounds.
// * Marching along the plane stride. Where the windows are translates of
//   one another by a stride M (n^2 for both stencils), a CTA owns one
//   column of T rows of a plane and walks it through consecutive planes:
//   a step stages one window, the union U of the windows moved onto one
//   plane (T + 2n + 2 values for the 27-point stencil), for plane z+1, into
//   a ring of K + 1 buffers (K = 3 planes read, one being filled). The -n^2
//   and +n^2 reads of plane z come from the buffers of planes z-1 and z+1,
//   staged (and, in pfold, folded) once. Staging the three windows for
//   every tile instead took pfold 106 us against 62: twice the L2 traffic
//   and three folds of each value. The CTAs of one column split its planes
//   into chunks so that one wave fills the card; a chunk stages K - 1
//   planes ahead of its first. The L2, not DRAM, serves the halo of a
//   plane's window (the +-n rows it shares with the neighbouring columns,
//   read by their CTAs at about the same time) and the planes a chunk
//   re-stages: the reuse distance is at most 2n^2 rows, ~0.6 MB of r and
//   pprev at 192^3 f32, far under the 50 MB L2, so each operand value
//   comes from DRAM once. Operators without such a stride (a single
//   window, or windows that are not translates) stage every window for
//   every tile, and CTAs walk the part's tiles by the grid stride.
// * Copies in flight. The copies of step k+1 are issued with cp.async
//   before step k is summed. A window lands in shared memory with the
//   source's 16-byte phase, so its body moves in 16-byte copies whatever
//   its start (-n-1 is not aligned, and at odd n^2 nor are the planes); the
//   tail past no[p] is zero-filled by the copy's source size, and a chunk
//   that straddles row 0 is copied value by value. The code bytes and, for
//   axpy, the pprev and xacc rows of the tile are staged the same way, in
//   two stages. At 192^3 f32 a pfold step holds ~12 KB of copies and four
//   CTAs fit an SM, so ~48 KB of loads are outstanding per SM. With the
//   band sum taken out, the staging alone ran at K1 24, pfold 42 and axpy
//   44 us, near the bounds: the sum, not memory, sets the pace.
// * The fold once. pfold stages r and pprev and builds
//   p = __fadd_rn(r, __fmul_rn(beta, pprev)) once per staged value (the
//   TPU kernel's `comb_ref`, pallas_dia.py:280-283), 16 bytes at a time
//   where r and pprev share a phase, then writes the offset-0 slots of its
//   tile out as p. With minv a third copy of each buffer holds minv
//   (2 * pp_shift bytes after it), staged and folded the same way.
// * A short band sum. A thread sums 4 rows a tile apart by 256
//   (i, i + 256, ...): each term is one 4- or 8-byte shared load at a fixed
//   offset from the diagonal's slot, a warp's 32 threads on consecutive
//   values (no bank conflict), and y, p and xacc go out as coalesced 4- or
//   8-byte stores. Row-class coefficients come from a table of the taken
//   diagonals' class coefficients (4 per diagonal: one 16-byte shared
//   load, a row's picked by a select). Two other forms were slower: 4
//   consecutive rows a thread, read and stored as 16-byte vectors with a
//   branch on the run's alignment, cost ~60 instructions a diagonal (K1 63
//   us, pfold 86); and a per-thread test of each diagonal against the rows'
//   class masks kept the compiler from overlapping one diagonal's loads
//   with the last one's arithmetic (K1 57 and pfold 80 us with it, 41 and
//   61 without).
// * The select-chain sums on the GMG operators. Multigrid-preconditioned
//   CG runs the select-chain decode 13 times an iteration: level 0's A (7
//   diagonals, each coded with kk = 2, 4 code bytes a row) and the
//   interpolation stencils S (27 diagonals, the centre constant, 26 coded
//   with kk = 2, 13 code bytes a row; bound at 192^3 f32 rows x (4 + 13 +
//   4) B over 3.35 TB/s = 44.4 us). The run-time loop over D loads per
//   (row, diagonal) the diagonal's slot, the code byte (again for its
//   other nibble), the codebook entry it picks (a gathered load) and the
//   operand, one after another, with a branch on kk: S at 192^3 took 198
//   us. select_sum is that loop specialised at compile time for the two
//   shapes (SelectShape; the launcher takes the instance ops/dia.py's
//   select_chain_instance names): it unrolls, loads each code byte once a
//   row and decodes both nibbles from it, keeps each diagonal's two
//   codebook slots in registers and selects between them, and reads the
//   slots four at a time. stage_codes deals the code streams' 16-byte
//   copies out over the CTA's threads, so a step no longer runs a copy
//   prologue per stream on every thread.
//
// The plan travels in PaDiaParams. The kernel may take up to the card's
// 227 KB of shared memory a CTA; the planner's budget keeps a plan within
// 96 KB, so at least two CTAs fit an SM.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#define PA_MAX_DIAGS 64
#define PA_MAX_CLASSES 16
#define PA_MAX_WINDOWS (PA_MAX_DIAGS + 1)
#define PA_MAX_BUFS (2 * PA_MAX_WINDOWS)
#define PA_ROWS 4
#define PA_THREADS 256

struct PaDiaParams {
  int P;          // stacked parts
  int D;          // diagonals
  int kmax;       // codebook slots per diagonal
  int n_streams;  // packed code byte streams
  long long code_len;  // bytes per stream per part (>= max no)
  long long wx;   // operand frame width
  long long wy;   // result frame width
  long long o0;   // owned offset in both frames
  int n_cls;      // row classes (0: select-chain decode)
  int off[PA_MAX_DIAGS];
  int kk[PA_MAX_DIAGS];
  int code_row[PA_MAX_DIAGS];
  unsigned long long cls_mask[PA_MAX_CLASSES];
  // the window plan (ops/dia.py:plan_coded_windows); byte offsets in
  // shared memory. Step k of a CTA sums the tile at row ts(k) = ts0 + k * tstep.
  long long stride;  // marching plane stride M (0: tiles walk the part)
  int T;             // rows per tile
  int ncol;          // marching: tiles per plane, ceil(M / T)
  int planes;        // marching: planes per CTA (set at the plan's first launch)
  int lead;          // steps staged before the first (K - 1 marching, else 0)
  int n_buf;         // operand buffers
  int step_bufs;     // buffer index advance per step
  // grid_x: CTAs per part, 0 until the plan's first launch sets it. The
  // field order matters to ptxas: with the arrays below 4 bytes earlier
  // (a field fewer here) nvcc 12.9 capped four of the six instantiations
  // at 64 registers with spills. chip_smoke.py fails on any spill.
  int grid_x;
  int n_new;         // windows staged per step
  int zero_win;      // the read window that holds offset 0
  int ccf_at;        // head (codebook at 0): class coefficients, n_cls rounded up to 4 per diagonal
  int sidx_at;       // head: per-step slot of each diagonal (and of offset 0)
  int pp_shift;      // pfold: a buffer's pprev lies pp_shift bytes after it
  int stage_at;      // two stages of the tile's own rows from here
  int stage_bytes;
  int code_at;       // code streams in a stage
  int code_stride;   // bytes per code stream in a stage
  int ax_pp_at;      // axpy: pprev rows of the tile in a stage
  int ax_xa_at;      // axpy: xacc rows of the tile in a stage
  int smem_bytes;
  // read window c of step k starts at row ts(k) + win_src[c] of buffer
  // (k * step_bufs + win_buf[c]) mod n_buf; new window s of step k, staged
  // one step ahead, holds new_len[s] values from ts(k) + new_src[s] in
  // buffer (k * step_bufs + new_buf[s]) mod n_buf
  int win_src[PA_MAX_WINDOWS];
  int win_buf[PA_MAX_WINDOWS];
  int new_src[PA_MAX_WINDOWS];
  int new_buf[PA_MAX_WINDOWS];
  int new_len[PA_MAX_WINDOWS];
  int buf_at[PA_MAX_BUFS];
  int diag_win[PA_MAX_DIAGS];  // read window of diagonal d
  // plain mode, select chain: the diagonal count of the specialised band
  // sum (SelectShape) the operator matches, else 0 (ops/dia.py:
  // select_chain_instance). Last, so that no other field moves.
  int nd_spec;
};

enum { PA_PLAIN = 0, PA_PFOLD = 1, PA_AXPY = 2, PA_PFOLDM = 3 };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ void unpack(float* b, float4 c) { b[0] = c.x; b[1] = c.y; b[2] = c.z; b[3] = c.w; }
__device__ __forceinline__ void unpack(double* b, double2 c) { b[0] = c.x; b[1] = c.y; }
__device__ __forceinline__ float4 pack(const float* b) { return make_float4(b[0], b[1], b[2], b[3]); }
__device__ __forceinline__ double2 pack(const double* b) { return make_double2(b[0], b[1]); }

// ---------------------------------------------------------------------------
// cp.async staging
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
                                             int len, long long lim) {
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
// zero-filled past no, the head chunk copied as it lies (the 16-byte chunk
// around a valid byte lies in its allocation, and rows before the tile are
// never read). The (stream, chunk) pairs of all streams are dealt out over
// the CTA's threads, so a thread works out the addresses of its own ~3
// chunks a step (13 streams of 1024 rows), not a prologue per stream.
__device__ __forceinline__ void stage_codes(const PaDiaParams& prm, unsigned char* dst, const uint8_t* cpart,
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

// The byte offset of the buffer that index rel names at step k.
__device__ __forceinline__ int buffer_at(const PaDiaParams& prm, int k, int rel) {
  int b = (k * prm.step_bufs + rel) % prm.n_buf;
  return prm.buf_at[b < 0 ? b + prm.n_buf : b];
}

// Issue the copies of step k (tile at row ts): its new operand windows
// and, with `rows`, the tile's code bytes (and axpy rows) into stage k & 1.
template <typename T, int MODE>
__device__ __forceinline__ void stage_step(const PaDiaParams& prm, unsigned char* smem, int k,
                                           long long ts, bool rows, long long no, const T* xp,
                                           const T* pp, const T* xa, const uint8_t* cpart,
                                           const T* mp) {
  for (int s = 0; s < prm.n_new; ++s) {
    unsigned char* b = smem + buffer_at(prm, k, prm.new_buf[s]);
    const long long g = ts + prm.new_src[s];
    stage_window<T>(b, xp, g, prm.new_len[s], no);
    if (MODE == PA_PFOLD || MODE == PA_PFOLDM) stage_window<T>(b + prm.pp_shift, pp, g, prm.new_len[s], no);
    if (MODE == PA_PFOLDM) stage_window<T>(b + 2 * prm.pp_shift, mp, g, prm.new_len[s], no);
  }
  if (!rows) return;
  unsigned char* st = smem + prm.stage_at + (k & 1) * prm.stage_bytes;
  if (MODE == PA_AXPY) {
    stage_window<T>(st + prm.ax_pp_at, pp, ts, prm.T, no);
    stage_window<T>(st + prm.ax_xa_at, xa, ts, prm.T, no);
  }
  stage_codes(prm, st + prm.code_at, cpart, ts, no);
}

// The 4 values at p (16-byte aligned) of shared memory.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&c)[4]) {
  using V = typename Vec16<T>::type;
  constexpr int NV = 16 / (int)sizeof(T);
#pragma unroll
  for (int q = 0; q < 4 / NV; ++q) unpack(c + q * NV, reinterpret_cast<const V*>(p)[q]);
}

// The row-class band sum of a thread's rows over the ntake diagonals some
// class takes, with at most 2 classes: the class coefficients of a
// diagonal in one shared load, a row's picked by a select.
template <typename T>
__device__ __forceinline__ void class_sum2(int ntake, const T* sop, const int* sidx, const T* sccf,
                                           const int (&cls)[PA_ROWS], const int (&row)[PA_ROWS],
                                           T (&acc)[PA_ROWS]) {
  for (int j = 0; j < ntake; ++j) {
    const T* xs = sop + sidx[j];
    T c4[4];
    load4(sccf + 4 * j, c4);
#pragma unroll
    for (int r = 0; r < PA_ROWS; ++r)
      acc[r] = add_rn(acc[r], mul_rn(cls[r] & 1 ? c4[1] : c4[0], xs[row[r]]));
  }
}

// ---------------------------------------------------------------------------
// the select-chain band sum, specialised at compile time
// ---------------------------------------------------------------------------

// The select-chain operators the band sum is specialised for, by diagonal
// count ND: `consts` marks the constant diagonals (kk 1); every other one
// is coded with kk 2, coded index = its rank among the coded diagonals (the
// staging's order). ops/dia.py:SELECT_SHAPES mirrors this table.
template <int ND> struct SelectShape;
// the 7-point operator (GMG level 0): every diagonal coded, 4 code bytes
template <> struct SelectShape<7> { static constexpr unsigned long long consts = 0; };
// the 27-point interpolation stencil S: its centre constant, 13 code bytes
template <> struct SelectShape<27> { static constexpr unsigned long long consts = 1ULL << 13; };

template <int ND>
__host__ __device__ constexpr bool is_const(int d) { return (SelectShape<ND>::consts >> d) & 1ULL; }

template <int ND>
__host__ __device__ constexpr int coded_index(int d) {
  int c = 0;
  for (int e = 0; e < d; ++e) c += is_const<ND>(e) ? 0 : 1;
  return c;
}

// f(integral_constant<int, D>) for D = I, ..., N - 1, in order
template <int I, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// A diagonal's two codebook slots, kept in registers where they fit (the
// whole table at most 256 bytes: f32 at 7 and 27 diagonals, f64 at 7), else
// read from the shared codebook once per step, one pair a diagonal.
template <typename T, int ND>
struct SelectCoefs {
  static constexpr bool in_regs = 2 * ND * sizeof(T) <= 256;
  T c0[in_regs ? ND : 1], c1[in_regs ? ND : 1];

  __device__ __forceinline__ void load(const T* cbp, int kmax) {
    if constexpr (in_regs) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        c0[d] = cbp[d * kmax];
        c1[d] = is_const<ND>(d) ? c0[d] : cbp[d * kmax + 1];
      }
    }
  }
  template <int D>
  __device__ __forceinline__ void get(const T* scb, int kmax, T& a, T& b) const {
    if constexpr (in_regs) {
      a = c0[D];
      b = c1[D];
    } else {
      a = scb[D * kmax];
      b = is_const<ND>(D) ? a : scb[D * kmax + 1];
    }
  }
};

// The select-chain band sum of a thread's rows (row[r] = threadIdx.x +
// r * PA_THREADS) over the ND diagonals of SelectShape<ND>, in ascending
// order. Per coded byte of a row one shared load, both nibbles decoded from
// it; per term one shared load of the operand, a select between the
// diagonal's two coefficients (a code other than 1, 1 past kk = 2 included,
// reads slot 0), a product and a sum. sidx: the diagonals' operand slots
// (16-byte aligned, read four at a time); sc0: the tile's code stage,
// `stride` bytes a stream; stream s of the tile's rows starts at byte
// cg + s * code_len of device memory (its 16-byte phase in the stage).
template <typename T, int ND>
__device__ __forceinline__ void select_sum(const SelectCoefs<T, ND>& cf, const T* scb, int kmax,
                                           const T* sop, const int* sidx, const unsigned char* sc0,
                                           int stride, long long cg, long long code_len,
                                           T (&acc)[PA_ROWS]) {
  int4 q;
  unsigned t[PA_ROWS];
  static_for<0, ND>([&](auto dc) {
    constexpr int d = decltype(dc)::value;
    if constexpr (d % 4 == 0) q = reinterpret_cast<const int4*>(sidx)[d / 4];
    const int s_at = d % 4 == 0 ? q.x : d % 4 == 1 ? q.y : d % 4 == 2 ? q.z : q.w;
    const T* xs = sop + s_at + threadIdx.x;
    T a, b;
    cf.template get<d>(scb, kmax, a, b);
    if constexpr (is_const<ND>(d)) {
#pragma unroll
      for (int r = 0; r < PA_ROWS; ++r) acc[r] = add_rn(acc[r], mul_rn(a, xs[r * PA_THREADS]));
    } else {
      constexpr int ci = coded_index<ND>(d);
      constexpr int s = ci >> 1;
      if constexpr ((ci & 1) == 0) {
        // the byte of this diagonal and the next coded one, once a row;
        // t's nibble is 0 where the code is 1
        const unsigned char* sc = sc0 + s * stride + (int)((cg + s * code_len) & 15) + threadIdx.x;
#pragma unroll
        for (int r = 0; r < PA_ROWS; ++r) t[r] = (unsigned)sc[r * PA_THREADS] ^ 0x11u;
      }
      constexpr unsigned nib = (ci & 1) ? 0xF0u : 0x0Fu;
#pragma unroll
      for (int r = 0; r < PA_ROWS; ++r)
        acc[r] = add_rn(acc[r], mul_rn((t[r] & nib) == 0u ? b : a, xs[r * PA_THREADS]));
    }
  });
}

// p = r + beta * pprev over `len` values of a buffer (r at sr, pprev at sq,
// each from its own 16-byte phase), in place at sr.
template <typename T>
__device__ __forceinline__ void fold(T* sr, const T* sq, int ph_r, int ph_q, int len, T beta) {
  using V = typename Vec16<T>::type;
  constexpr int NV = 16 / (int)sizeof(T);
  if (ph_r == ph_q) {
    // the same phase: whole 16-byte chunks (the phase in front and the
    // tail past len are folded too and never read)
    V* vr = reinterpret_cast<V*>(sr);
    const V* vq = reinterpret_cast<const V*>(sq);
    for (int e = threadIdx.x; e < (ph_r + len + NV - 1) / NV; e += blockDim.x) {
      T a[NV], q[NV];
      unpack(a, vr[e]);
      unpack(q, vq[e]);
#pragma unroll
      for (int j = 0; j < NV; ++j) a[j] = add_rn(a[j], mul_rn(beta, q[j]));
      vr[e] = pack(a);
    }
  } else {
    for (int e = threadIdx.x; e < len; e += blockDim.x)
      sr[ph_r + e] = add_rn(sr[ph_r + e], mul_rn(beta, sq[ph_q + e]));
  }
}

// p = minv * r + beta * pprev over `len` values of a buffer (r at sr, pprev
// at sq, minv at sm, each from its own 16-byte phase), in place at sr.
template <typename T>
__device__ __forceinline__ void fold_minv(T* sr, const T* sq, const T* sm, int ph_r, int ph_q, int ph_m,
                                          int len, T beta) {
  using V = typename Vec16<T>::type;
  constexpr int NV = 16 / (int)sizeof(T);
  if (ph_r == ph_q && ph_r == ph_m) {
    V* vr = reinterpret_cast<V*>(sr);
    const V* vq = reinterpret_cast<const V*>(sq);
    const V* vm = reinterpret_cast<const V*>(sm);
    for (int e = threadIdx.x; e < (ph_r + len + NV - 1) / NV; e += blockDim.x) {
      T a[NV], q[NV], m[NV];
      unpack(a, vr[e]);
      unpack(q, vq[e]);
      unpack(m, vm[e]);
#pragma unroll
      for (int j = 0; j < NV; ++j) a[j] = add_rn(mul_rn(m[j], a[j]), mul_rn(beta, q[j]));
      vr[e] = pack(a);
    }
  } else {
    for (int e = threadIdx.x; e < len; e += blockDim.x)
      sr[ph_r + e] = add_rn(mul_rn(sm[ph_m + e], sr[ph_r + e]), mul_rn(beta, sq[ph_q + e]));
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// MODE: PA_PLAIN, PA_PFOLD (scal = beta, vout = p), PA_PFOLDM (the same
// with minv) or PA_AXPY (scal = alpha, vout = xacc updated in place). ND > 0 (plain mode only):
// a select-chain operator of SelectShape<ND>, summed by select_sum; ND 0:
// any operator, the row-class sums or the run-time select-chain loop.
template <typename T, int MODE, int ND>
__global__ void __launch_bounds__(PA_THREADS)
dia_coded_kernel(const PaDiaParams prm, const T* __restrict__ cb, const int32_t* __restrict__ no_arr,
                 const uint8_t* __restrict__ codes, const T* __restrict__ x,
                 const T* __restrict__ pprev, const T* __restrict__ scal_ptr,
                 T* __restrict__ y, T* __restrict__ vout, const int32_t* __restrict__ live,
                 const T* __restrict__ minv) {
  constexpr bool PFOLD = MODE == PA_PFOLD || MODE == PA_PFOLDM;
  constexpr bool AXPY = MODE == PA_AXPY;
  extern __shared__ __align__(16) unsigned char smem[];
  T* scb = reinterpret_cast<T*>(smem);
  T* sccf = reinterpret_cast<T*>(smem + prm.ccf_at);
  int* sidx = reinterpret_cast<int*>(smem + prm.sidx_at);
  const T* sop = reinterpret_cast<const T*>(smem);

  const int p = blockIdx.y;
  const long long no = no_arr[p];
  const T* xp = x + (long long)p * prm.wx + prm.o0;
  const T* pp = MODE != PA_PLAIN ? pprev + (long long)p * prm.wx + prm.o0 : nullptr;
  T* yp = y + (long long)p * prm.wy + prm.o0;
  T* vp = MODE != PA_PLAIN ? vout + (long long)p * prm.wx + prm.o0 : nullptr;
  const T* mp = MODE == PA_PFOLDM ? minv + (long long)p * prm.wx + prm.o0 : nullptr;
  const uint8_t* cpart = codes + (long long)p * prm.n_streams * prm.code_len;
  const T scal = MODE != PA_PLAIN ? scal_ptr[0] : T(0);
  // axpy: the lagged update is written only while the flag is set
  const bool armed = !AXPY || live == nullptr || live[0] != 0;
  const int TR = prm.T;
  static_assert(ND == 0 || MODE == PA_PLAIN, "the specialised select-chain sum is plain mode's");
  SelectCoefs<T, ND == 0 ? 1 : ND> coefs;
  if constexpr (ND > 0) coefs.load(cb + (long long)p * prm.D * prm.kmax, prm.kmax);

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
    for (int k = -prm.lead; k <= 0; ++k)
      stage_step<T, MODE>(prm, smem, k, ts0 + k * tstep, k == 0, no, xp, pp, vp, cpart, mp);
  cp_async_commit();

  // the head: the codebook; for the row-class decode, the coefficient of
  // class c on the j-th diagonal that some class takes at sccf[nc * j + c]
  const int ncb = prm.D * prm.kmax;
  for (int k = threadIdx.x; k < ncb; k += blockDim.x) scb[k] = cb[(long long)p * ncb + k];
  unsigned long long take = 0;
  for (int c = 0; c < prm.n_cls; ++c) take |= prm.cls_mask[c];
  const int ntake = __popcll(take);
  const int nc = (prm.n_cls + 3) & ~3;
  for (int k = threadIdx.x; k < nc * prm.D; k += blockDim.x) {
    const int d = k / nc, c = k % nc, top = prm.kk[d] - 1;
    if ((take >> d) & 1ULL)
      sccf[nc * __popcll(take & ((1ULL << d) - 1)) + c] = cb[(long long)p * ncb + d * prm.kmax + (c < top ? c : top)];
  }
  // every slot outside the owned band: y (and p) 0
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < prm.wy - no; e += stride)
    y[(long long)p * prm.wy + (e < prm.o0 ? e : e + no)] = T(0);
  if (PFOLD)
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < prm.wx - no; e += stride)
      vout[(long long)p * prm.wx + (e < prm.o0 ? e : e + no)] = T(0);

  for (int k = 0; k < steps; ++k) {
    const long long ts = ts0 + k * tstep;
    // the slot of row 0 of the tile for each diagonal (row-class decode:
    // for the j-th diagonal some class takes), and for offset 0 at D
    for (int d = threadIdx.x; d <= prm.D; d += blockDim.x) {
      int at = d;
      if (prm.n_cls > 0 && d < prm.D) {
        if (!((take >> d) & 1ULL)) continue;
        at = __popcll(take & ((1ULL << d) - 1));
      }
      const int c = d < prm.D ? prm.diag_win[d] : prm.zero_win;
      const int o = d < prm.D ? prm.off[d] : 0;
      sidx[at] = buffer_at(prm, k, prm.win_buf[c]) / (int)sizeof(T) + phase(xp, ts + prm.win_src[c]) + o -
                prm.win_src[c];
    }
    if (k + 1 < steps)
      stage_step<T, MODE>(prm, smem, k + 1, ts + tstep, true, no, xp, pp, vp, cpart, mp);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    if (PFOLD) {
      // p = r + beta * pprev, once per staged value: the windows that
      // arrived for this step (at the first, those staged ahead of it too)
      for (int j = k == 0 ? -prm.lead : k; j <= k; ++j) {
        const long long tj = ts0 + j * tstep;
        for (int s = 0; s < prm.n_new; ++s) {
          const int b = buffer_at(prm, j, prm.new_buf[s]);
          const long long g = tj + prm.new_src[s];
          if constexpr (MODE == PA_PFOLDM)
            fold_minv(reinterpret_cast<T*>(smem + b), reinterpret_cast<const T*>(smem + b + prm.pp_shift),
                      reinterpret_cast<const T*>(smem + b + 2 * prm.pp_shift), phase(xp, g), phase(pp, g),
                      phase(mp, g), prm.new_len[s], scal);
          else
            fold(reinterpret_cast<T*>(smem + b), reinterpret_cast<const T*>(smem + b + prm.pp_shift),
                 phase(xp, g), phase(pp, g), prm.new_len[s], scal);
        }
      }
      __syncthreads();
    }

    const unsigned char* st = smem + prm.stage_at + (k & 1) * prm.stage_bytes;
    const long long left = no - ts;
    const int nrow = left < rowcap ? (int)left : rowcap;
    if (threadIdx.x < nrow) {
      // this thread's rows i0 + r * PA_THREADS (T <= PA_ROWS * PA_THREADS):
      // each read below is one 4- or 8-byte shared load at a fixed offset,
      // a warp's 32 threads on consecutive values. A row past the tile is
      // read (the plan leaves room past every region) but not stored.
      const int i0 = threadIdx.x;
      int row[PA_ROWS];
#pragma unroll
      for (int r = 0; r < PA_ROWS; ++r) row[r] = i0 + r * PA_THREADS;
      T acc[PA_ROWS];
#pragma unroll
      for (int r = 0; r < PA_ROWS; ++r) acc[r] = T(-0.0);

      if constexpr (ND > 0) {
        select_sum<T, ND>(coefs, scb, prm.kmax, sop, sidx, st + prm.code_at, prm.code_stride,
                          (long long)(uintptr_t)cpart + ts, prm.code_len, acc);
      } else if (prm.n_cls > 0) {
        const unsigned char* sc = st + prm.code_at + phase(cpart, ts);
        int cls[PA_ROWS];
#pragma unroll
        for (int r = 0; r < PA_ROWS; ++r) {
          const int c = sc[row[r]] & 15;
          cls[r] = c < prm.n_cls ? c : 0;
        }
        // a diagonal that no class takes (zero in every part) is skipped; a
        // row whose class has a zero coefficient on a diagonal that another
        // class takes adds that exact zero times x, as the plain version does
        if (prm.n_cls <= 2) {
          class_sum2(ntake, sop, sidx, sccf, cls, row, acc);
        } else {
          for (int j = 0; j < ntake; ++j) {
            const T* xs = sop + sidx[j];
#pragma unroll
            for (int r = 0; r < PA_ROWS; ++r)
              acc[r] = add_rn(acc[r], mul_rn(sccf[nc * j + cls[r]], xs[row[r]]));
          }
        }
      } else {
        for (int d = 0; d < prm.D; ++d) {
          const T* cbd = scb + d * prm.kmax;
          const T* xs = sop + sidx[d];
          T v[PA_ROWS];
          if (prm.kk[d] == 1) {
#pragma unroll
            for (int r = 0; r < PA_ROWS; ++r) v[r] = cbd[0];
          } else {
            const int ci = prm.code_row[d];
            const int s = ci >> 1;
            const unsigned char* sc = st + prm.code_at + s * prm.code_stride + phase(cpart + s * prm.code_len, ts);
            const int sh = 4 * (ci & 1);
#pragma unroll
            for (int r = 0; r < PA_ROWS; ++r) {
              const int c = (sc[row[r]] >> sh) & 15;
              v[r] = cbd[c < prm.kk[d] ? c : 0];
            }
          }
#pragma unroll
          for (int r = 0; r < PA_ROWS; ++r) acc[r] = add_rn(acc[r], mul_rn(v[r], xs[row[r]]));
        }
      }

      const T* zs = sop + sidx[prm.D];
      const T* spp = reinterpret_cast<const T*>(st + prm.ax_pp_at) + (AXPY ? phase(pp, ts) : 0);
      const T* sxa = reinterpret_cast<const T*>(st + prm.ax_xa_at) + (AXPY ? phase(vp, ts) : 0);
#pragma unroll
      for (int r = 0; r < PA_ROWS; ++r) {
        const int i = i0 + r * PA_THREADS;
        if (i < nrow) {
          yp[ts + i] = acc[r];
          if (PFOLD) vp[ts + i] = zs[i];
          if (AXPY && armed) vp[ts + i] = add_rn(sxa[i], mul_rn(scal, spp[i]));
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait_all();
}

template <typename T, int MODE, int ND>
static int launch_kernel(PaDiaParams* prm, const void* cb, const void* no,
                         const void* codes, const void* x, const void* pprev,
                         const void* scal, void* y, void* vout, const void* live, const void* minv,
                         void* stream) {
  auto kern = dia_coded_kernel<T, MODE, ND>;
  static int n_sm = 0;
  cudaError_t e;
  if (n_sm == 0) {
    int dev, optin;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess) return (int)e;
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) != cudaSuccess)
      return (int)e;
  }
  if (prm->grid_x == 0) {
    // once per plan (ops/dia.py keeps an operator's parameters per frame
    // widths, mode and dtype): one wave of CTAs that fills every SM
    // (code_len >= every no)
    int occ;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, PA_THREADS, prm->smem_bytes)) != cudaSuccess)
      return (int)e;
    occ = occ < 1 ? 1 : occ;
    const long long per_part = ((long long)occ * n_sm + prm->P - 1) / prm->P;
    long long gx;
    if (prm->stride > 0) {
      // marching: ncol columns, their planes split into chunks
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
  kern<<<grid, PA_THREADS, prm->smem_bytes, (cudaStream_t)stream>>>(
      *prm, (const T*)cb, (const int32_t*)no, (const uint8_t*)codes,
      (const T*)x, (const T*)pprev, (const T*)scal, (T*)y, (T*)vout, (const int32_t*)live, (const T*)minv);
  return (int)cudaGetLastError();
}

// The instance for prm: plain mode takes the specialised select-chain sum
// its operator matches (prm->nd_spec, set by the host), every other launch
// the general kernel.
template <typename T, int MODE>
static int launch(PaDiaParams* prm, const void* cb, const void* no,
                  const void* codes, const void* x, const void* pprev,
                  const void* scal, void* y, void* vout, const void* live, void* stream,
                  const void* minv = nullptr) {
  if constexpr (MODE == PA_PLAIN) {
    if (prm->nd_spec == 7)
      return launch_kernel<T, MODE, 7>(prm, cb, no, codes, x, pprev, scal, y, vout, live, minv, stream);
    if (prm->nd_spec == 27)
      return launch_kernel<T, MODE, 27>(prm, cb, no, codes, x, pprev, scal, y, vout, live, minv, stream);
  }
  if (prm->nd_spec != 0) return (int)cudaErrorInvalidValue;
  if (MODE == PA_PFOLDM && minv == nullptr) return (int)cudaErrorInvalidValue;
  return launch_kernel<T, MODE, 0>(prm, cb, no, codes, x, pprev, scal, y, vout, live, minv, stream);
}

// Empty kernels, the launch floor the coded kernel's times are read
// against: one warp with no parameters, and one launched as the coded
// kernel is (its grid, threads, shared memory and parameter block).
__global__ void dia_null_kernel() {}
__global__ void __launch_bounds__(PA_THREADS) dia_null_plan_kernel(const PaDiaParams prm) {}

extern "C" {

// prm null: the bare empty kernel; else the one launched as prm's plan
// (prm->grid_x set by the plan's first launch of the coded kernel).
int pa_dia_null(const PaDiaParams* prm, void* stream) {
  if (prm == nullptr) {
    dia_null_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
  }
  static bool init = false;
  cudaError_t e;
  if (!init) {
    int dev, optin;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess) return (int)e;
    if ((e = cudaFuncSetAttribute(dia_null_plan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) != cudaSuccess)
      return (int)e;
    init = true;
  }
  dim3 grid((unsigned int)prm->grid_x, (unsigned int)prm->P);
  dia_null_plan_kernel<<<grid, PA_THREADS, prm->smem_bytes, (cudaStream_t)stream>>>(*prm);
  return (int)cudaGetLastError();
}

int pa_dia_coded_f32(PaDiaParams* prm, const void* cb, const void* no,
                     const void* codes, const void* x, void* y, void* stream) {
  return launch<float, PA_PLAIN>(prm, cb, no, codes, x, nullptr, nullptr, y, nullptr, nullptr, stream);
}

int pa_dia_coded_f64(PaDiaParams* prm, const void* cb, const void* no,
                     const void* codes, const void* x, void* y, void* stream) {
  return launch<double, PA_PLAIN>(prm, cb, no, codes, x, nullptr, nullptr, y, nullptr, nullptr, stream);
}

int pa_dia_coded_pfold_f32(PaDiaParams* prm, const void* cb, const void* no,
                           const void* codes, const void* r, const void* pprev,
                           const void* beta, void* y, void* pout, void* stream) {
  return launch<float, PA_PFOLD>(prm, cb, no, codes, r, pprev, beta, y, pout, nullptr, stream);
}

int pa_dia_coded_pfold_f64(PaDiaParams* prm, const void* cb, const void* no,
                           const void* codes, const void* r, const void* pprev,
                           const void* beta, void* y, void* pout, void* stream) {
  return launch<double, PA_PFOLD>(prm, cb, no, codes, r, pprev, beta, y, pout, nullptr, stream);
}

int pa_dia_coded_pfold_minv_f32(PaDiaParams* prm, const void* cb, const void* no,
                                const void* codes, const void* r, const void* pprev,
                                const void* beta, void* y, void* pout, const void* minv, void* stream) {
  return launch<float, PA_PFOLDM>(prm, cb, no, codes, r, pprev, beta, y, pout, nullptr, stream, minv);
}

int pa_dia_coded_pfold_minv_f64(PaDiaParams* prm, const void* cb, const void* no,
                                const void* codes, const void* r, const void* pprev,
                                const void* beta, void* y, void* pout, const void* minv, void* stream) {
  return launch<double, PA_PFOLDM>(prm, cb, no, codes, r, pprev, beta, y, pout, nullptr, stream, minv);
}

int pa_dia_coded_axpy_f32(PaDiaParams* prm, const void* cb, const void* no,
                          const void* codes, const void* x, const void* pprev,
                          const void* alpha, void* y, void* xacc, const void* live, void* stream) {
  return launch<float, PA_AXPY>(prm, cb, no, codes, x, pprev, alpha, y, xacc, live, stream);
}

int pa_dia_coded_axpy_f64(PaDiaParams* prm, const void* cb, const void* no,
                          const void* codes, const void* x, const void* pprev,
                          const void* alpha, void* y, void* xacc, const void* live, void* stream) {
  return launch<double, PA_AXPY>(prm, cb, no, codes, x, pprev, alpha, y, xacc, live, stream);
}

}  // extern "C"
