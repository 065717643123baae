// Node-block (BSR) SpMV for Hopper (sm_90a), E2: the owned block A_oo of
// the BSR lowering and the node-block boundary block A_oh of the BSR and
// supernode-dense (SD) lowerings.
//
// Replaces no TPU kernel: it stands for the XLA gather plus
// einsum("nlij,nlj->ni") of the JAX package's BSR path
// (partitionedarrays_jl_tpu/parallel/tpu.py:3143-3160) and the bucketed
// node-block finish of `_finish` (:3201-3229), as cg_sweep.cu stands for
// the fused CG body's XLA sweep.
//
// What it computes, bs in {2, 3, 4} a template parameter, each product
// rounded before its add (__fmul_rn / __fadd_rn, __dmul_rn / __dadd_rn; no
// FMA), the terms added in ascending (l, j) order from the first, which
// the plain version (ops/irregular.py:bsr_spmv_plain) repeats, so the two
// agree bit for bit (the JAX einsum sums in XLA's order: equal to rounding):
//   mode 0 (A_oo), operands slot-major: vals (P, Lb, bs, bs, nn) and cols
//     (P, Lb, nn), the transpose of the JAX package's (P, nn, Lb, bs, bs)
//     and (P, nn, Lb) (ops/irregular.py:bsr_row_major gives that form
//     back); for every slot s of the (P, wy) result frame, with
//     r = s - yo0, node = r / bs, i = r % bs, when 0 <= r < nn * bs:
//     y[p, s] = sum_l sum_j vals[p, l, i, j, node] * x[p, xo0 + cols[p, l, node] * bs + j]
//     and 0 elsewhere; the node's first counts[p, node] blocks are real,
//     the rest pads (value +0.0, node 0);
//   mode 1 (boundary, every width bucket in one launch): bucket c holds
//     nb_c staged boundary nodes a part, each of Lb_c blocks, as arrays
//     rows_c (P, nb_c, bs), cols_c (P, nb_c, Lb_c) and vals_c (P, nb_c,
//     Lb_c, bs, bs) at element offsets roff_c, coff_c and voff_c of three
//     flat buffers; for every node n < nb_c of part p and i < bs whose
//     target row = rows_c[p, n, i] is not the trash slot,
//     y[p, row, k] = y[p, row, k] + sum_l sum_j vals_c[p, n, l, i, j] * x[p, g0 + cols_c[p, n, l] * bs + j, k]
//     in place (xo0 = g0: the ghost-node frame), the row's sum rounded once
//     into y. x and y are (P, W) frames (K = 1) or (P, W, K) slabs of K
//     columns (column k at the innermost axis), column k summed as a frame.
//     The bucket table (at most PA_BSR_MAX_BUCKETS entries) rides in the
//     parameter block: no device table, no copy before a launch;
//   mode 2 (`bsr_spmm`): mode 0 for each column k of (P, W, K) slabs x and
//     y, column k summed as mode 0 sums a frame, its one round of pad
//     terms included, so it equals mode 0 on column k bit for bit.
// Node columns are int32 in every mode. Pad rows of mode 1 point at the
// trash slot and are skipped, so no two threads write one slot (a part's
// boundary nodes are distinct across its buckets): one launch over all
// buckets writes what the per-bucket launches wrote, bit for bit.
//
// Pad blocks in mode 0. A pad's terms are 0 * x[xo0 + j]: +0.0, -0.0 or NaN
// (x infinite or NaN), added after the real terms. They decide the sign of
// a row that sums to -0.0 and carry a NaN, so they stay in the sum, but
// they are not read: the kernel adds mul_rn(0, x[xo0 + j]) itself, bitwise
// what the stored pad gives. One round of them (j = 0 .. bs-1) is enough:
// a round maps -0.0 to +0.0 at most, keeps a NaN and leaves any other sum
// alone, so a second round changes nothing.
//
// Bound: memory. Mode 0 reads the real blocks' values (bs^2 each), their
// int32 node columns and the counts once, gathers x a block at a time and
// writes y: the elasticity operator at 64^3 (262,144 nodes, bs = 3, 19
// blocks a node, ~11.85 real) moves ~250 MB in f64 (75 us at 3.35 TB/s) and
// ~131 MB in f32 (39 us); its CSR would move 351 MB in f64. The node-block
// boundary at 32^3 f64 on 4 parts moves 2.7 MB (its staged arrays 2.5 MB,
// the ghost columns of x, the touched rows of y), ~0.8 us of bytes, less
// than the 4.9 us an empty kernel takes on an H100 (CUDA events): its cost
// is the launch count, hence one launch for all buckets.
//
// Design of mode 0: one thread a node, its bs rows as bs chains of
// rounded adds side by side, so that a block's column and its bs values of
// x are loaded once for all bs rows. The operands are slot-major: at block
// l, entry (i, j), the threads of a warp (neighbouring nodes) read
// neighbouring addresses, so every value load is coalesced without
// staging (a node-major row of Lb * bs^2 values, 1,368 B in f64 at Lb =
// 19, put 32 threads' loads 1,368 B apart; staging such rows in shared
// memory by cp.async was slower than this on an H100: each CTA waits on
// its copies, then on its x gathers, in turn, and shared memory caps the
// CTAs an SM). A thread stops at its node's count, so no pad block is
// read (at most the 32-byte sectors a pad shares with a neighbour's real
// block); the loads of PA_BSR_LB blocks (column, bs x values, bs^2 values)
// issue before their products. Then one round of pad terms where the node
// has pads, then its bs results.
// Threads past the nodes write the zeros outside the band. No tensor
// cores: their fused accumulation would not round every product.
//
// Design of mode 1: one thread a (result row, column) pair, blockIdx.y the
// part and blockIdx.z the column; the thread walks its node's blocks in
// order and reads its row i of each (bs values). The grid covers every
// bucket's rows (the buckets' nb_c * bs rows laid end to end); a thread
// finds its bucket by a scan of the table's first rows (uniform across a
// warp but at a bucket edge). A frame is K = 1, so one kernel serves both.
// A frame runs its own instance, K = 1 a constant. (A thread keeping 8
// columns in registers, as mode 2's first form did, ran a frame at 20.0 us
// against the frame kernel's 12.9 on an H100, and this kernel with K read
// at run time at 14.6 us, the columns along blockIdx.x or blockIdx.z alike.)
//
// Design of mode 2, for the H100 (its first form, a thread a node keeping
// bs x 8 sums, 96 registers, and walking its blocks one at a time, ran at
// 25% of its bound: its chain column -> x -> products held few loads in
// flight, and 24 scalar x loads a block each touched 32 sectors a warp):
// G lanes a node, lane g keeping CL adjacent columns, 32 bytes of them (16
// for 4x4 blocks, whose registers would spill) where K and the alignment of
// x and y allow 16-byte vectors, else the widest narrower vector, else
// scalars, in the same kernel; the K / CL lanes of a node spread evenly
// over the fewest chunks (blockIdx.z) of at most PA_BSR_SLAB_GMAX, so K =
// 3, 5 and 11 idle 2 lanes of 32 a warp. A node's G lanes read its count,
// its blocks' values and node columns at one address (one broadcast load:
// DRAM sees each value once); each lane reads and writes its own columns,
// a coalesced run of CL columns a node row of x and of y. One register
// set: row j of block l + 1 (its x row and its bs values) loads as soon
// as row j of block l has its products, so block l + 1's loads run under
// block l's later products and the loop's turn; node columns load two
// blocks ahead, so a gather never waits on its column. 114 registers at
// f64 3x3 blocks, CL = 4: two CTAs of 256 an SM, no spill.
// Bound at the elasticity operator's 64^3 f64, K = 8: the real blocks,
// their columns and the counts once (~238 MB) and the x and y slabs (50 MB
// each), ~339 MB, ~101 us at 3.35 TB/s. The staging's node order costs
// more: the tet mesh interleaves nodes of 7 and of 19 blocks, so at block
// slots 7-18 a 32-byte sector of a value stream carries real values of
// about half its nodes, and the card reads ~472 MB (~141 us). Measured on
// an H100 (PERF.md §6): 397 -> 209 us; on a copy of the operator with its
// nodes sorted by count, 165. Slower on the card (sources not kept): 16-byte
// lanes one block at a time (235 us), values through a shared-memory ring of
// 3-4 blocks by cp.async (226-232), two register sets (209, spilling).
//
// Every mode launches on the caller's stream and allocates nothing, so a
// CUDA graph captures it.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_BSR_THREADS 256  // mode 1: threads a CTA
#define PA_BSR_MAX_BUCKETS 8
#define PA_BSR_OO_THREADS 256  // mode 0: threads (nodes) a CTA
#define PA_BSR_LB 2            // mode 0: blocks whose loads issue before their products
#define PA_BSR_SLAB_THREADS 256  // mode 2: threads a CTA
#define PA_BSR_SLAB_MIN_CTAS 2   // mode 2: CTAs an SM its registers must allow (at most 128 registers)
#define PA_BSR_SLAB_GMAX 8       // mode 2: most lanes a node

enum { PA_BSR_OO = 0, PA_BSR_BOUNDARY = 1, PA_BSR_OO_SLAB = 2 };

struct PaBsrParams {
  int P;            // stacked parts
  int Lb;           // blocks a node row (>= 1)
  int bs;           // block size: 2, 3 or 4
  int mode;         // PA_BSR_OO, PA_BSR_BOUNDARY or PA_BSR_OO_SLAB
  long long nn;     // staged node rows a part
  long long wx;     // frame width of x
  long long wy;     // frame width of y
  long long xo0;    // offset of x's node frame (mode 0: the owned band; mode 1: g0)
  long long yo0;    // band offset of y (mode 0)
  long long trash;  // y's trash slot (mode 1): rows pointing there are skipped
  int nbk;          // buckets (mode 1)
  int bk_Lb[PA_BSR_MAX_BUCKETS];            // blocks a node of bucket c
  long long bk_row0[PA_BSR_MAX_BUCKETS + 1];  // first row of bucket c in the launch (row0[nbk] = all rows)
  long long bk_nb[PA_BSR_MAX_BUCKETS];      // nodes a part of bucket c
  long long bk_roff[PA_BSR_MAX_BUCKETS];    // element offset of rows_c in the rows buffer
  long long bk_coff[PA_BSR_MAX_BUCKETS];    // of cols_c in the cols buffer
  long long bk_voff[PA_BSR_MAX_BUCKETS];    // of vals_c in the vals buffer
  int K;            // columns of the slabs (modes 1, 2; 1 for a frame)
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// ---------------------------------------------------------------------------
// mode 0: the owned block
// ---------------------------------------------------------------------------

// the CTAs an SM its registers must allow: 3 (at most 85 registers a
// thread), 2 for f64 4x4 blocks, whose loads would spill under that cap
template <typename T, int BS>
__global__ void __launch_bounds__(PA_BSR_OO_THREADS, (BS == 4 && sizeof(T) == 8) ? 2 : 3)
bsr_oo_kernel(const PaBsrParams prm, const T* __restrict__ vals, const int* __restrict__ cols,
              const int* __restrict__ counts, const T* __restrict__ x, T* __restrict__ y) {
  constexpr int BB = BS * BS, LB = PA_BSR_LB;
  const int p = blockIdx.y;
  const long long nn = prm.nn, Lb = prm.Lb;
  const long long node = (long long)blockIdx.x * PA_BSR_OO_THREADS + threadIdx.x;
  T* yp = y + (long long)p * prm.wy;
  if (node >= nn) {
    // the zeros outside the band [yo0, yo0 + nn * bs)
    const long long z = node - nn, band = nn * BS;
    if (z < prm.wy - band) yp[z < prm.yo0 ? z : z + band] = T(0);
    return;
  }
  const int c = __ldg(counts + (long long)p * nn + node);
  const T* vp = vals + (long long)p * Lb * BB * nn + node;  // block l, entry (i, j) at ((l * BS + i) * BS + j) * nn
  const int* cp = cols + (long long)p * Lb * nn + node;     // block l at l * nn
  const T* xp = x + (long long)p * prm.wx + prm.xo0;
  T acc[BS];
#pragma unroll
  for (int i = 0; i < BS; ++i) acc[i] = T(-0.0);  // the identity of a rounded add: the fold from the first product
  for (int l0 = 0; l0 < c; l0 += LB) {
    T xv[LB][BS], vv[LB][BS][BS];
#pragma unroll
    for (int k = 0; k < LB; ++k) {
      const bool on = l0 + k < c;
      const long long col = on ? __ldcs(cp + (long long)(l0 + k) * nn) : 0;
#pragma unroll
      for (int j = 0; j < BS; ++j) xv[k][j] = __ldg(xp + col * BS + j);
#pragma unroll
      for (int i = 0; i < BS; ++i)
#pragma unroll
        for (int j = 0; j < BS; ++j) vv[k][i][j] = on ? __ldcs(vp + ((long long)(l0 + k) * BB + i * BS + j) * nn) : T(0);
    }
#pragma unroll
    for (int k = 0; k < LB; ++k) {
      if (l0 + k < c) {
#pragma unroll
        for (int j = 0; j < BS; ++j)
#pragma unroll
          for (int i = 0; i < BS; ++i) acc[i] = add_rn(acc[i], mul_rn(vv[k][i][j], xv[k][j]));
      }
    }
  }
  if (c < Lb) {
    // the pads' terms, one round (see the note at the top)
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      const T z = mul_rn(T(0), __ldg(xp + j));
#pragma unroll
      for (int i = 0; i < BS; ++i) acc[i] = add_rn(acc[i], z);
    }
  }
  T* yo = yp + prm.yo0 + node * BS;
#pragma unroll
  for (int i = 0; i < BS; ++i) yo[i] = acc[i];
}

// ---------------------------------------------------------------------------
// mode 2: the owned block on (P, W, K) slabs
// ---------------------------------------------------------------------------

// CL adjacent columns of x at p into o (ldx), and of v into y at p (stx):
// 16-byte vectors, or one 8-byte float2 (CL = 2 in f32); the launch takes
// CL > 1 only where every such address is aligned to its vector
template <int CL>
__device__ __forceinline__ void ldx(const double* p, double (&o)[CL]) {
  if constexpr (CL == 1) {
    o[0] = __ldg(p);
  } else {
#pragma unroll
    for (int h = 0; h < CL; h += 2) {
      const double2 t = __ldg(reinterpret_cast<const double2*>(p + h));
      o[h] = t.x, o[h + 1] = t.y;
    }
  }
}
template <int CL>
__device__ __forceinline__ void ldx(const float* p, float (&o)[CL]) {
  if constexpr (CL == 1) {
    o[0] = __ldg(p);
  } else if constexpr (CL == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = t.x, o[1] = t.y;
  } else {
#pragma unroll
    for (int h = 0; h < CL; h += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + h));
      o[h] = t.x, o[h + 1] = t.y, o[h + 2] = t.z, o[h + 3] = t.w;
    }
  }
}
template <int CL>
__device__ __forceinline__ void stx(double* p, const double (&v)[CL]) {
  if constexpr (CL == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int h = 0; h < CL; h += 2) *reinterpret_cast<double2*>(p + h) = make_double2(v[h], v[h + 1]);
  }
}
template <int CL>
__device__ __forceinline__ void stx(float* p, const float (&v)[CL]) {
  if constexpr (CL == 1) {
    *p = v[0];
  } else if constexpr (CL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int h = 0; h < CL; h += 4) *reinterpret_cast<float4*>(p + h) = make_float4(v[h], v[h + 1], v[h + 2], v[h + 3]);
  }
}

// G lanes a node (32 / G nodes a warp, the lanes past them idle), lane g
// of chunk blockIdx.z keeping the CL columns from k = (blockIdx.z * G + g)
// * CL, each column summed as mode 0 sums a frame
template <typename T, int BS, int CL>
__global__ void __launch_bounds__(PA_BSR_SLAB_THREADS, PA_BSR_SLAB_MIN_CTAS)
bsr_oo_slab_kernel(const PaBsrParams prm, const int G, const T* __restrict__ vals, const int* __restrict__ cols,
                   const int* __restrict__ counts, const T* __restrict__ x, T* __restrict__ y) {
  constexpr int BB = BS * BS;
  const int lane = threadIdx.x & 31, npw = 32 / G, w = lane / G;
  const int K = prm.K, k0 = (blockIdx.z * G + (lane - w * G)) * CL;
  if (w >= npw || k0 >= K) return;  // a lane past the warp's nodes or past the columns
  const long long t = ((long long)blockIdx.x * (PA_BSR_SLAB_THREADS / 32) + (threadIdx.x >> 5)) * npw + w;
  const int p = blockIdx.y;
  const long long nn = prm.nn;
  if (t >= nn) {
    // the zeros outside the band [yo0, yo0 + nn * bs)
    const long long z = t - nn, band = nn * BS;
    if (z < prm.wy - band) {
      T zero[CL];
#pragma unroll
      for (int q = 0; q < CL; ++q) zero[q] = T(0);
      stx(y + ((long long)p * prm.wy + (z < prm.yo0 ? z : z + band)) * K + k0, zero);
    }
    return;
  }
  // the node's count, block values and columns: one address for its G lanes
  const int c = __ldg(counts + (long long)p * nn + t);
  const T* vp = vals + (long long)p * prm.Lb * BB * nn + t;  // block l, entry e = i * BS + j at (l * BB + e) * nn
  const int* cp = cols + (long long)p * prm.Lb * nn + t;     // block l at l * nn
  const T* xp = x + ((long long)p * prm.wx + prm.xo0) * K + k0;
  T acc[BS][CL];
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int q = 0; q < CL; ++q) acc[i][q] = T(-0.0);  // the identity of a rounded add
  // one register set: block l's row j of values and x rows is replaced by
  // block l + 1's as soon as its products are done, so block l + 1's loads
  // run under block l's later products and the loop's turn; node columns
  // two blocks ahead
  T v[BB], xr[BS][CL];
  int c1 = 0 < c ? __ldcs(cp) : 0;
  if (0 < c) {
#pragma unroll
    for (int j = 0; j < BS; ++j) ldx(xp + (long long)c1 * (BS * K) + j * K, xr[j]);
#pragma unroll
    for (int e = 0; e < BB; ++e) v[e] = __ldcs(vp + (long long)e * nn);
  }
  c1 = 1 < c ? __ldcs(cp + nn) : 0;
  int c2 = 2 < c ? __ldcs(cp + 2 * nn) : 0;
  for (int l = 0; l < c; ++l) {
    const bool more = l + 1 < c;
    const T* vq = vp + (long long)(l + 1) * BB * nn;
    const T* xq = xp + (long long)c1 * (BS * K);
#pragma unroll
    for (int j = 0; j < BS; ++j) {
#pragma unroll
      for (int i = 0; i < BS; ++i)
#pragma unroll
        for (int q = 0; q < CL; ++q) acc[i][q] = add_rn(acc[i][q], mul_rn(v[i * BS + j], xr[j][q]));
      if (more) {
        ldx(xq + j * K, xr[j]);
#pragma unroll
        for (int i = 0; i < BS; ++i) v[i * BS + j] = __ldcs(vq + (long long)(i * BS + j) * nn);
      }
    }
    c1 = c2;
    c2 = l + 3 < c ? __ldcs(cp + (long long)(l + 3) * nn) : 0;
  }
  if (c < prm.Lb) {
    // the pads' terms, one round a column (see the note at the top)
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      T xz[CL];
      ldx(xp + j * K, xz);
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        const T z = mul_rn(T(0), xz[q]);
#pragma unroll
        for (int i = 0; i < BS; ++i) acc[i][q] = add_rn(acc[i][q], z);
      }
    }
  }
  T* yo = y + ((long long)p * prm.wy + prm.yo0 + t * BS) * K + k0;
#pragma unroll
  for (int i = 0; i < BS; ++i) stx(yo + i * K, acc[i]);
}

// ---------------------------------------------------------------------------
// mode 1: the node-block boundary, on frames and slabs
// ---------------------------------------------------------------------------

// row i of node `node` of part p in a block row of Lb blocks (nb nodes a
// part), against column k of x (K columns; a frame is K = 1): the first
// product, then the others in ascending (l, j)
template <typename T, int BS>
__device__ __forceinline__ T block_row(const PaBsrParams& prm, int p, long long nb, int Lb, long long node, int i,
                                       const T* __restrict__ vals, const int* __restrict__ cols,
                                       const T* __restrict__ x, int K, int k) {
  const long long at = (long long)p * nb + node;
  const T* v = vals + at * Lb * (BS * BS) + i * BS;
  const int* c = cols + at * Lb;
  const T* xp = x + ((long long)p * prm.wx + prm.xo0) * K + k;
  const T* xb = xp + (long long)c[0] * BS * K;
  T acc = mul_rn(v[0], xb[0]);
#pragma unroll
  for (int j = 1; j < BS; ++j) acc = add_rn(acc, mul_rn(v[j], xb[j * K]));
  for (int l = 1; l < Lb; ++l) {
    const T* vl = v + l * (BS * BS);
    xb = xp + (long long)c[l] * BS * K;
#pragma unroll
    for (int j = 0; j < BS; ++j) acc = add_rn(acc, mul_rn(vl[j], xb[j * K]));
  }
  return acc;
}

// FRAME: K = 1 known at compile time, so a frame's addresses take no
// multiply by K
template <typename T, int BS, bool FRAME>
__global__ void __launch_bounds__(PA_BSR_THREADS)
bsr_boundary_kernel(const PaBsrParams prm, const long long* __restrict__ rows, const T* __restrict__ vals,
                    const int* __restrict__ cols, const T* __restrict__ x, T* __restrict__ y) {
  const int p = blockIdx.y, K = FRAME ? 1 : prm.K, k = FRAME ? 0 : blockIdx.z;
  const long long t = (long long)blockIdx.x * PA_BSR_THREADS + threadIdx.x;
  if (t >= prm.bk_row0[prm.nbk]) return;
  int c = 0;
  while (c + 1 < prm.nbk && t >= prm.bk_row0[c + 1]) ++c;
  const long long r = t - prm.bk_row0[c];  // row of bucket c, part p
  const long long nb = prm.bk_nb[c];
  const long long row = rows[prm.bk_roff[c] + (long long)p * nb * BS + r];
  if (row == prm.trash) return;
  const T acc = block_row<T, BS>(prm, p, nb, prm.bk_Lb[c], r / BS, (int)(r % BS), vals + prm.bk_voff[c],
                                 cols + prm.bk_coff[c], x, K, k);
  T* yp = y + ((long long)p * prm.wy + row) * K + k;
  *yp = add_rn(*yp, acc);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int BS>
static int launch_oo(const PaBsrParams* prm, const void* counts, const void* vals, const void* cols, const void* x,
                     void* y, cudaStream_t s) {
  // a thread a node, then the slots outside the band
  const long long work = prm->nn + (prm->wy - prm->nn * BS);
  long long gx = (work + PA_BSR_OO_THREADS - 1) / PA_BSR_OO_THREADS;
  if (gx < 1) gx = 1;
  if (gx > 0x7fffffffLL || prm->P > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P);
  bsr_oo_kernel<T, BS><<<grid, PA_BSR_OO_THREADS, 0, s>>>(*prm, (const T*)vals, (const int*)cols, (const int*)counts,
                                                          (const T*)x, (T*)y);
  return (int)cudaGetLastError();
}

template <typename T, int BS, int CL>
static int launch_oo_slab_cl(const PaBsrParams* prm, int G, const void* counts, const void* vals, const void* cols,
                             const void* x, void* y, cudaStream_t s) {
  // 32 / G nodes a warp, then the slots outside the band; blockIdx.z the chunk of G * CL columns
  const long long per_cta = (PA_BSR_SLAB_THREADS / 32) * (32 / G);
  const long long work = prm->nn + (prm->wy - prm->nn * BS);
  long long gx = (work + per_cta - 1) / per_cta;
  if (gx < 1) gx = 1;
  const int chunks = (prm->K / CL + G - 1) / G;
  if (gx > 0x7fffffffLL || prm->P > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P, (unsigned int)chunks);
  bsr_oo_slab_kernel<T, BS, CL><<<grid, PA_BSR_SLAB_THREADS, 0, s>>>(*prm, G, (const T*)vals, (const int*)cols,
                                                                     (const int*)counts, (const T*)x, (T*)y);
  return (int)cudaGetLastError();
}

template <typename T, int BS>
static int launch_oo_slab(const PaBsrParams* prm, const void* counts, const void* vals, const void* cols,
                          const void* x, void* y, cudaStream_t s) {
  const int K = prm->K;
  if (K < 1) return (int)cudaErrorInvalidValue;
  // CL: 32 bytes of columns a lane (16 for 4x4 blocks, whose registers
  // would spill), else the widest narrower vector, as K and the alignment
  // of x and y allow; scalar lanes else
  constexpr int clmax = (BS == 4 ? 16 : 32) / (int)sizeof(T), v16 = 16 / (int)sizeof(T);
  const unsigned long long a = (unsigned long long)(uintptr_t)x | (unsigned long long)(uintptr_t)y;
  int cl = 1;
  for (int v = clmax; v > 1 && cl == 1; v /= 2)
    if (K % v == 0 && a % ((v < v16 ? v : v16) * sizeof(T)) == 0) cl = v;
  // G: the K / CL lanes a node in the fewest chunks of at most PA_BSR_SLAB_GMAX, spread evenly
  const int lanes = K / cl, chunks = (lanes + PA_BSR_SLAB_GMAX - 1) / PA_BSR_SLAB_GMAX;
  const int G = (lanes + chunks - 1) / chunks;
  if (cl == 1) return launch_oo_slab_cl<T, BS, 1>(prm, G, counts, vals, cols, x, y, s);
  if (cl == 2) return launch_oo_slab_cl<T, BS, 2>(prm, G, counts, vals, cols, x, y, s);
  if constexpr (clmax >= 4)
    if (cl == 4) return launch_oo_slab_cl<T, BS, 4>(prm, G, counts, vals, cols, x, y, s);
  if constexpr (clmax >= 8)
    if (cl == 8) return launch_oo_slab_cl<T, BS, 8>(prm, G, counts, vals, cols, x, y, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int BS>
static int launch_boundary(const PaBsrParams* prm, const void* rows, const void* vals, const void* cols,
                           const void* x, void* y, cudaStream_t s) {
  // a thread a (boundary row, column) pair, blockIdx.z the column
  long long gx = (prm->bk_row0[prm->nbk] + PA_BSR_THREADS - 1) / PA_BSR_THREADS;
  if (gx < 1) gx = 1;
  if (prm->K < 1 || prm->K > 65535 || gx > 0x7fffffffLL || prm->P > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P, (unsigned int)prm->K);
  if (prm->K == 1) {
    bsr_boundary_kernel<T, BS, true><<<grid, PA_BSR_THREADS, 0, s>>>(*prm, (const long long*)rows, (const T*)vals,
                                                                     (const int*)cols, (const T*)x, (T*)y);
  } else {
    bsr_boundary_kernel<T, BS, false><<<grid, PA_BSR_THREADS, 0, s>>>(*prm, (const long long*)rows, (const T*)vals,
                                                                      (const int*)cols, (const T*)x, (T*)y);
  }
  return (int)cudaGetLastError();
}

template <typename T, int BS>
static int launch_bs(const PaBsrParams* prm, const void* rows, const void* counts, const void* vals, const void* cols,
                     const void* x, void* y, cudaStream_t s) {
  if (prm->mode == PA_BSR_OO) return launch_oo<T, BS>(prm, counts, vals, cols, x, y, s);
  if (prm->mode == PA_BSR_OO_SLAB) return launch_oo_slab<T, BS>(prm, counts, vals, cols, x, y, s);
  if (prm->mode == PA_BSR_BOUNDARY) return launch_boundary<T, BS>(prm, rows, vals, cols, x, y, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch(const PaBsrParams* prm, const void* rows, const void* counts, const void* vals, const void* cols,
                  const void* x, void* y, void* stream) {
  if (prm->Lb < 1 || prm->P < 1) return (int)cudaErrorInvalidValue;
  if (prm->mode == PA_BSR_BOUNDARY) {
    if (prm->nbk < 1 || prm->nbk > PA_BSR_MAX_BUCKETS || prm->bk_row0[0] != 0) return (int)cudaErrorInvalidValue;
    for (int c = 0; c < prm->nbk; ++c)
      if (prm->bk_Lb[c] < 1 || prm->bk_row0[c + 1] != prm->bk_row0[c] + prm->bk_nb[c] * prm->bs)
        return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (prm->bs) {
    case 2: return launch_bs<T, 2>(prm, rows, counts, vals, cols, x, y, s);
    case 3: return launch_bs<T, 3>(prm, rows, counts, vals, cols, x, y, s);
    case 4: return launch_bs<T, 4>(prm, rows, counts, vals, cols, x, y, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// modes 0 and 2: vals (P, Lb, bs, bs, nn), int32 node columns cols (P, Lb,
// nn), slot-major, int32 counts (P, nn) of real blocks a node (the rest
// pads: value 0, node 0), rows null; mode 1: the flat buffers of the
// buckets' rows (int64), cols (int32) and vals (the table in prm gives each
// bucket's offsets), counts null; x: the operand frame (mode 0), slab
// (mode 2) or either (mode 1, prm->K its columns); y: the result (written
// whole in modes 0 and 2, updated on the boundary rows in mode 1).
int pa_bsr_spmv_f32(const PaBsrParams* prm, const void* rows, const void* counts, const void* vals,
                    const void* cols, const void* x, void* y, void* stream) {
  return launch<float>(prm, rows, counts, vals, cols, x, y, stream);
}

int pa_bsr_spmv_f64(const PaBsrParams* prm, const void* rows, const void* counts, const void* vals,
                    const void* cols, const void* x, void* y, void* stream) {
  return launch<double>(prm, rows, counts, vals, cols, x, y, stream);
}

}  // extern "C"
