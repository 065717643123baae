// Matrix-free interpolation stencil of the multigrid transfers, for Hopper
// (sm_90a): y = S x over the stacked parts of a box layout.
//
// No TPU kernel stands behind it: it is the counterpart of the XLA fusion of
// `_stencil_apply` in partitionedarrays_jl_tpu/parallel/tpu_gmg.py:292-319,
// about 60 slice ops that XLA fuses into a few loops over each part's
// extended box. Run eagerly they would be about 60 launches per apply.
//
// What it computes, per part p and owned point c of its box fb:
//   the part's owned box (C order, at o0 of the operand frame) and the ghost
//   segments of the box exchange (at g0 + off of the same frame) form the
//   zero-padded extended box ext, (fb + 2)^d; then
//     y[p, c] = sum over delta in {-1,0,1}^d (ascending, the first dimension
//               slowest, as np.ndindex) of 0.5^|delta|_0 * ext[c + delta]
//   A level of fewer dimensions runs as a 3-D box with leading extents 1:
//   its table has no segment in a direction along a padded axis, so the
//   extra terms are exact zeros and the sum equals the d-dimensional one
//   (up to the sign of a zero). An ext cell outside the box in
//   direction e (a face, edge or corner) is segment e's value at its
//   position in the segment's C-order shape (1 along e's nonzero axes, fb
//   elsewhere); a direction the plan has no segment for reads 0 (the zero
//   pad beyond the global boundary); with a mask (periodic partitions) the
//   value is multiplied by the part's mask of e (0 for a wrapped segment).
//   Slots past the part's owned count, up to the result width n, are 0.
//
// Table, per part (PA_STENCIL_TABLE ints): fb[3] (padded with leading 1s to
// three dimensions), the owned count, then the segment offset of each of the
// 27 three-dimensional directions (index (e0+1)*9 + (e1+1)*3 + (e2+1)), -1
// where the plan has none.
//
// Rounding: every product and sum is __fmul_rn / __fadd_rn (no FMA
// contraction) in the plain version's order (ops/stencil.py), so the two
// agree value for value; the weights are powers of 2, the products exact.
//
// Bound: memory. At 192^3 f32 on one part it reads x's owned box (28.3 MB)
// and writes y (28.3 MB): 56.6 MB, about 17 us at 3.35 TB/s. The
// arithmetic is 26 adds and about 14 products a point (some 10 us of an
// H100's FP32 issue rate at 192^3, and the rounding order rules out fusing
// a product into its add), so the kernel has to keep its other
// instructions per point few. A march that summed each output's 27 terms
// from shared memory (27 reads a point), with the next plane fetched into
// registers through a per-cell resolver, reached 23% of the bound.
//
// Where it stands (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): the
// tiled form sums the 192^3 box in 42 us, 40% of the bound. A thread's
// plane step is some 160 instructions for its 2 points, 80 of them the sum
// (cuobjdump -sass of the built library), so the SMs issue at about half
// their rate; the step's barrier and each output's chain of dependent adds
// are the likely stalls (a reading of the code: no profiler runs on that
// machine). The coarse levels sit 2-5 us above an empty kernel's launch.
//
// * The column along the march stays in registers. Output c0 takes its
//   terms from ext planes c0-1, c0, c0+1 in that order, so a thread that
//   marches along the first axis keeps three accumulators a point: when
//   plane n arrives, output n+1 starts with its d0 = -1 terms, output n
//   takes its d0 = 0 terms and output n-1 its d0 = +1 terms and is stored.
//   Each plane's 3x3 neighbourhood is read once, and each accumulator adds
//   its nine terms in (d1, d2) order, so every output sums its 27 terms in
//   np.ndindex order, term for term the plain version's. The d0 = -1 and
//   d0 = +1 terms of one value are one product.
// * Tiled form (the wide levels). A CTA of 256 threads owns a tile of
//   PA_TY = 16 rows by PA_TX = 32 points (a warp along the last axis, two
//   rows a thread: 12 shared reads for 2 outputs a plane) and marches
//   through tz planes. The ext planes, each with its one-cell rim, land in a
//   ring of PA_RING shared-memory slots by cp.async, PA_AHEAD planes ahead
//   of the one summed, so one __syncthreads a plane and no register
//   staging. A thread stages fixed copy ops of the slot (a row's 16-byte
//   chunks and its two rim cells): an op whose cells lie inside the owned
//   box (every op of an interior tile, on every plane but the box's first
//   and last faces) copies from an address fixed per op plus the plane's
//   offset, in one 16-byte copy where the source is aligned; only the ops
//   on a face resolve their cells through the table (segment, absent
//   direction as a zero-fill copy, the mask as a load and a product).
// * Slab form (the narrow coarse levels, whose cross-section a 32-wide
//   tile would leave mostly idle). A CTA takes a band of whole rows and tz
//   planes, lanes over the flattened rows x points of the band: it issues
//   every cell of its tz + 2 extended planes (the band with its rim) as
//   copies at once, waits once, syncs once and then sums, so a launch is
//   one memory latency rather than a chain of them.
// * The launch. ops/stencil.py:plan_launch picks the form from the box
//   shape, and the planes a CTA takes from the CUDA occupancy API
//   (pa_box_stencil_query_*) and the SM count, so that one wave of CTAs
//   fills the card, once per operand and dtype; the parameters carry the
//   grid.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_STENCIL_TABLE 32
#define PA_THREADS 256
// Tiled form: PA_RT rows a thread, PA_AHEAD planes in flight ahead of the
// one summed (ops/stencil.py mirrors both and the tile; launch() refuses a
// tiled launch whose rows or threads differ from the tile built here)
#define PA_RT 2
#define PA_AHEAD 4
// the tile: PA_TX points (a warp's row) by PA_TY rows (PA_RT a thread)
#define PA_TX 32
#define PA_TY (PA_THREADS / PA_TX * PA_RT)
// ring slots of staged planes (PA_RING - 1 = PA_AHEAD: a slot is refilled
// right after the barrier that follows its last read)
#define PA_RING (PA_AHEAD + 1)
#define PA_FORM_TILED 0
#define PA_FORM_SLAB 1

struct PaStencilParams {
  int P;          // stacked parts
  long long wx;   // operand frame width
  long long n;    // result width (the owned band, >= every owned count)
  long long o0;   // owned offset in the operand frame
  long long g0;   // ghost-region offset in the operand frame
  int fmax[3];    // the largest box extent over the parts, per axis
  int form;       // PA_FORM_TILED or PA_FORM_SLAB
  int tz;         // planes a CTA sums
  int rows;       // box rows a CTA sums (tiled: PA_TY)
  int threads;    // threads a CTA
  int smem;       // dynamic shared memory a CTA (slab form), bytes
  int grid[3];    // x: tiles along the last axis (slab: row bands), y: tile
                  // rows (slab: 1), z: parts x plane chunks
  int uniform;    // 1: every part's box is fmax (the kernel then reads its
                  // extents from here, not from the table, so the owned
                  // cells' copies wait on no table load)
  int segs;       // 0: the table has no segment (one part: every cell off
                  // the box is the zero pad, staged without the table)
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ int side(int c, int f) { return c < 0 ? -1 : (c >= f ? 1 : 0); }

// 0.5^nz for nz = 1, 2, 3 nonzero offsets (nz = 0 takes no product)
template <typename T>
__device__ __forceinline__ T weight(int nz) { return nz == 1 ? T(0.5) : (nz == 2 ? T(0.25) : T(0.125)); }

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// one element (4 or 8 bytes); src_bytes 0 zero-fills it and reads nothing
template <typename T>
__device__ __forceinline__ void cp_async_el(T* dst, const T* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_addr(dst)), "l"(src), "n"((int)sizeof(T)), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Stage ext[n0, n1, n2] of one part (each n_j in [-1, f_j]) at sp: an owned
// cell or an unmasked segment cell is copied, an absent direction is a
// zero-fill copy; a segment cell under a mask is loaded, multiplied by the
// mask of its direction and stored (the product is no copy).
template <typename T>
__device__ __forceinline__ void stage_cell(T* sp, const PaStencilParams& prm, const int32_t* tb, const T* xp,
                                           const T* mp, int f0, int f1, int f2, int n0, int n1, int n2) {
  const int e0 = side(n0, f0), e1 = side(n1, f1), e2 = side(n2, f2);
  if ((e0 | e1 | e2) == 0) {
    cp_async_el<T>(sp, xp + prm.o0 + ((long long)n0 * f1 + n1) * f2 + n2, (int)sizeof(T));
    return;
  }
  const int k = (e0 + 1) * 9 + (e1 + 1) * 3 + (e2 + 1);
  const int off = prm.segs ? __ldg(tb + 4 + k) : -1;
  if (off < 0) {
    cp_async_el<T>(sp, xp, 0);
    return;
  }
  const int s1 = e1 ? 1 : f1, s2 = e2 ? 1 : f2;
  const int q0 = e0 ? 0 : n0, q1 = e1 ? 0 : n1, q2 = e2 ? 0 : n2;
  const T* src = xp + prm.g0 + off + ((long long)q0 * s1 + q1) * s2 + q2;
  if (mp != nullptr)
    *sp = mul_rn(__ldg(src), __ldg(mp + k));
  else
    cp_async_el<T>(sp, src, (int)sizeof(T));
}

// ---------------------------------------------------------------------------
// the sum along the march
// ---------------------------------------------------------------------------

// One ext plane's terms for one output column: v[d1][d2] its 3x3
// neighbourhood in that plane. fin (the output below the plane) takes its
// d0 = +1 terms, mid (the output in the plane) its d0 = 0 terms, nw (the
// output above) starts with its d0 = -1 terms; each in (d1, d2) order.
template <typename T>
__device__ __forceinline__ void plane_terms(T (*v)[3], T& fin, T& mid, T& nw) {
#pragma unroll
  for (int d1 = 0; d1 < 3; ++d1) {
#pragma unroll
    for (int d2 = 0; d2 < 3; ++d2) {
      const T a = v[d1][d2];
      const int nz = (d1 != 1) + (d2 != 1);
      const T t0 = nz == 0 ? a : mul_rn(weight<T>(nz), a);  // d0 = 0
      const T t1 = mul_rn(weight<T>(nz + 1), a);            // d0 = -1 and +1
      nw = (d1 == 0 && d2 == 0) ? t1 : add_rn(nw, t1);
      mid = add_rn(mid, t0);
      fin = add_rn(fin, t1);
    }
  }
}

// The part's box extents (its table row, or fmax for uniform boxes).
__device__ __forceinline__ void box_of(const PaStencilParams& prm, const int32_t* tb, int& f0, int& f1, int& f2) {
  if (prm.uniform) {
    f0 = prm.fmax[0];
    f1 = prm.fmax[1];
    f2 = prm.fmax[2];
  } else {
    f0 = __ldg(tb);
    f1 = __ldg(tb + 1);
    f2 = __ldg(tb + 2);
  }
}

// The part's CTAs share the zero tail [owned count, n) of its result row:
// nb CTAs, this one the b-th.
template <typename T>
__device__ __forceinline__ void zero_tail(T* yp, long long cnt, long long n, long long nb, long long b) {
  for (long long t = cnt + b * blockDim.x + threadIdx.x; t < n; t += nb * blockDim.x) yp[t] = T(0);
}

// ---------------------------------------------------------------------------
// tiled form
// ---------------------------------------------------------------------------

template <typename T>
struct Tiled {
  static constexpr int V = 16 / (int)sizeof(T);       // elements of a 16-byte copy
  static constexpr int NCH = PA_TX / V;               // 16-byte chunks of a tile row
  static constexpr int OPR = NCH + 2;                 // copy ops a staged row: its chunks, its two rim cells
  static constexpr int ROWS = PA_TY + 2;              // staged rows: the tile's and its rim
  static constexpr int NOPS = ROWS * OPR;
  static constexpr int OPT = (NOPS + PA_THREADS - 1) / PA_THREADS;  // ops a thread
  static constexpr int SX = PA_TX + 2 * V;            // slot row stride: point x0 at column V, 16-byte aligned
  static constexpr int SLOT = ROWS * SX;
  // CTAs an SM must hold: 4 caps registers at 64 a thread in f32, with no
  // spill (on an H100, 4 CTAs an SM summed the 192^3 box in 44.5 us against
  // 47.5 with 3); 2 caps them at 128 in f64
  static constexpr int MIN_CTAS = sizeof(T) == 4 ? 4 : 2;
};

template <typename T>
__global__ void __launch_bounds__(PA_THREADS, Tiled<T>::MIN_CTAS)
box_stencil_tiled_kernel(const PaStencilParams prm, const int32_t* __restrict__ table,
                         const T* __restrict__ mask, const T* __restrict__ x, T* __restrict__ y) {
  using G = Tiled<T>;
  __shared__ __align__(16) T ring[PA_RING * G::SLOT];
  const int nzb = gridDim.z / prm.P;
  const int p = blockIdx.z / nzb, zb = blockIdx.z - p * nzb;
  const int tid = threadIdx.x;
  const int32_t* tb = table + (long long)p * PA_STENCIL_TABLE;
  int f0, f1, f2;
  box_of(prm, tb, f0, f1, f2);
  T* yp = y + (long long)p * prm.n;
  zero_tail<T>(yp, (long long)f0 * f1 * f2, prm.n, (long long)gridDim.x * gridDim.y * nzb,
               ((long long)zb * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
  const int x0 = blockIdx.x * PA_TX, y0 = blockIdx.y * PA_TY, z0 = zb * prm.tz;
  if (x0 >= f2 || y0 >= f1 || z0 >= f0) return;  // the whole CTA: past this part's box
  const int z1 = min(z0 + prm.tz, f0);
  const T* xp = x + (long long)p * prm.wx;
  const T* mp = mask == nullptr ? nullptr : mask + (long long)p * 27;
  const long long plane = (long long)f1 * f2;

  // this thread's copy ops of a slot, the same on every plane: op e is
  // cell run k of staged row ly (n1 = y0 - 1 + ly); runs k < NCH are the
  // 16-byte chunks of points x0 + k V ..., run NCH the rim cell x0 - 1,
  // run NCH + 1 the rim cell x0 + PA_TX
  // (the fields a plane's copies need are kept: the shared offset, the
  // frame offset, and the cells to take, the run's length and whether it
  // lies inside the owned box, packed; a face op recomputes its position)
  auto op_at = [&](int e, int& n1, int& n2, int& cnt) {
    const int ly = e / G::OPR, k = e - ly * G::OPR;
    n1 = y0 - 1 + ly;
    n2 = k < G::NCH ? x0 + k * G::V : (k == G::NCH ? x0 - 1 : x0 + PA_TX);
    cnt = k < G::NCH ? G::V : 1;
    return ly * G::SX + (n2 - x0) + G::V;
  };
  // op_src: the op's first cell in the plane staged next (owned ops)
  int op_sh[G::OPT], op_bits[G::OPT];
  const T* op_src[G::OPT];
#pragma unroll
  for (int j = 0; j < G::OPT; ++j) {
    const int e = tid + j * PA_THREADS;
    int n1, n2, cnt;
    op_sh[j] = op_at(e, n1, n2, cnt);
    // cells past the box's far rim (n1 > f1 or n2 > f2) are never read
    const int take = (e < G::NOPS && n1 <= f1) ? max(0, min(cnt, f2 + 1 - n2)) : 0;
    const bool core = n1 >= 0 && n1 < f1 && n2 >= 0 && n2 + cnt <= f2;
    op_bits[j] = take | cnt << 8 | (core ? 1 << 16 : 0);
    op_src[j] = xp + prm.o0 + ((long long)(z0 - 1) * f1 + n1) * f2 + n2;
  }
  // stage ext plane n0 (the one after the last staged) into ring slot sl
  auto stage = [&](int n0, int sl) {
    T* sb = ring + sl * G::SLOT;
#pragma unroll
    for (int j = 0; j < G::OPT; ++j) {
      const int take = op_bits[j] & 255, cnt = (op_bits[j] >> 8) & 255;
      const T* g = op_src[j];
      op_src[j] += plane;
      if (take == 0) continue;
      T* sp = sb + op_sh[j];
      if ((op_bits[j] >> 16) && n0 >= 0 && n0 < f0) {
        if (cnt == G::V && ((uintptr_t)g & 15) == 0) {
          cp_async_16(sp, g);
        } else {
#pragma unroll
          for (int c = 0; c < G::V; ++c)
            if (c < cnt) cp_async_el<T>(sp + c, g + c, (int)sizeof(T));
        }
      } else {
        int n1, n2, c_;
        op_at(tid + j * PA_THREADS, n1, n2, c_);
#pragma unroll
        for (int c = 0; c < G::V; ++c)
          if (c < take) stage_cell<T>(sp + c, prm, tb, xp, mp, f0, f1, f2, n0, n1, n2 + c);
      }
    }
  };

  // the march: ext planes n = z0 - 1 .. z1, each its own copy group; plane
  // n in ring slot (n - z0 + 1) mod PA_RING
#pragma unroll
  for (int i = 0; i < PA_AHEAD; ++i) {
    if (z0 - 1 + i <= z1) stage(z0 - 1 + i, i);
    cp_async_commit();
  }
  // thread (tx, ty) sums points x0 + tx of rows y0 + PA_RT ty + r
  const int tx = tid & 31, ty = tid >> 5;
  const int c2 = x0 + tx, c1 = y0 + PA_RT * ty;
  T fin[PA_RT], mid[PA_RT], nw[PA_RT];
#pragma unroll
  for (int r = 0; r < PA_RT; ++r) fin[r] = mid[r] = nw[r] = T(0);
  const T* rd = ring + (PA_RT * ty) * G::SX + G::V - 1 + tx;  // this thread's 3x3 windows in slot 0
  long long yo = ((long long)(z0 - 2) * f1 + c1) * f2 + c2;       // output n - 1 of row c1
  for (int n = z0 - 1, sl = 0; n <= z1; ++n, yo += plane) {
    cp_async_wait<PA_AHEAD - 1>();  // this thread's copies of plane n have landed
    __syncthreads();                // everyone's have; plane n - 1's slot is read
    // plane n + PA_AHEAD takes the slot of plane n - 1
    if (n + PA_AHEAD <= z1) stage(n + PA_AHEAD, sl == 0 ? PA_RING - 1 : sl - 1);
    cp_async_commit();
    const T* sb = rd + sl * G::SLOT;
    sl = sl == PA_RING - 1 ? 0 : sl + 1;
    T v[PA_RT + 2][3];
#pragma unroll
    for (int r = 0; r < PA_RT + 2; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d) v[r][d] = sb[r * G::SX + d];
#pragma unroll
    for (int r = 0; r < PA_RT; ++r) plane_terms<T>(v + r, fin[r], mid[r], nw[r]);
    if (n > z0 && c2 < f2) {
#pragma unroll
      for (int r = 0; r < PA_RT; ++r)
        if (c1 + r < f1) yp[yo + r * f2] = fin[r];
    }
#pragma unroll
    for (int r = 0; r < PA_RT; ++r) {
      fin[r] = mid[r];
      mid[r] = nw[r];
    }
  }
}

// ---------------------------------------------------------------------------
// slab form
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
box_stencil_slab_kernel(const PaStencilParams prm, const int32_t* __restrict__ table,
                        const T* __restrict__ mask, const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char slab_raw[];
  T* sl = reinterpret_cast<T*>(slab_raw);
  const int nzb = gridDim.z / prm.P;
  const int p = blockIdx.z / nzb, zb = blockIdx.z - p * nzb;
  const int32_t* tb = table + (long long)p * PA_STENCIL_TABLE;
  int f0, f1, f2;
  box_of(prm, tb, f0, f1, f2);
  T* yp = y + (long long)p * prm.n;
  zero_tail<T>(yp, (long long)f0 * f1 * f2, prm.n, (long long)gridDim.x * nzb, (long long)zb * gridDim.x + blockIdx.x);
  const int r0 = blockIdx.x * prm.rows, z0 = zb * prm.tz;
  if (r0 >= f1 || z0 >= f0) return;  // the whole CTA: past this part's box
  const int r1 = min(r0 + prm.rows, f1), z1 = min(z0 + prm.tz, f0);
  const T* xp = x + (long long)p * prm.wx;
  const T* mp = mask == nullptr ? nullptr : mask + (long long)p * 27;
  // the slab: ext planes z0 - 1 .. z1, rows r0 - 1 .. r1, points -1 .. f2
  const int W = f2 + 2, H = r1 - r0 + 2, L = z1 - z0 + 2;
  const int pl = H * W, cells = L * pl;
  for (int e = threadIdx.x; e < cells; e += blockDim.x) {
    const int lz = e / pl, rem = e - lz * pl, ly = rem / W, lx = rem - ly * W;
    stage_cell<T>(sl + e, prm, tb, xp, mp, f0, f1, f2, z0 - 1 + lz, r0 - 1 + ly, lx - 1);
  }
  cp_async_wait_all();
  __syncthreads();
  const int np = (r1 - r0) * f2;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const int r = i / f2, c = i - r * f2;
    const T* base = sl + r * W + c;
    T fin = T(0), mid = T(0), nw = T(0);
    for (int lz = 0; lz < L; ++lz) {
      T v[3][3];
#pragma unroll
      for (int d1 = 0; d1 < 3; ++d1)
#pragma unroll
        for (int d2 = 0; d2 < 3; ++d2) v[d1][d2] = base[lz * pl + d1 * W + d2];
      plane_terms<T>(v, fin, mid, nw);
      if (lz >= 2) yp[((long long)(z0 + lz - 2) * f1 + r0 + r) * f2 + c] = fin;
      fin = mid;
      mid = nw;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
static const void* kernel_of(int form) {
  return form == PA_FORM_TILED ? (const void*)box_stencil_tiled_kernel<T> : (const void*)box_stencil_slab_kernel<T>;
}

// out[0]: CTAs of the form resident on an SM at `threads` threads and
// `smem` bytes of dynamic shared memory (the occupancy API); out[1] its
// registers a thread, out[2] its static shared memory, out[3] its local
// memory a thread (spills), bytes
template <typename T>
static int query(int form, int threads, int smem, int* out) {
  const void* fn = kernel_of<T>(form);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, threads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

template <typename T>
static int launch(const PaStencilParams* prm, const void* table, const void* mask,
                  const void* x, void* y, void* stream) {
  const dim3 grid((unsigned int)prm->grid[0], (unsigned int)prm->grid[1], (unsigned int)prm->grid[2]);
  // the grid was planned for the tile built here: a plan for another would
  // leave rows of y unwritten
  if (prm->form == PA_FORM_TILED && (prm->rows != PA_TY || prm->threads != PA_THREADS || prm->smem != 0))
    return (int)cudaErrorInvalidValue;
  if (prm->form == PA_FORM_TILED)
    box_stencil_tiled_kernel<T><<<grid, PA_THREADS, 0, (cudaStream_t)stream>>>(
        *prm, (const int32_t*)table, (const T*)mask, (const T*)x, (T*)y);
  else
    box_stencil_slab_kernel<T><<<grid, prm->threads, prm->smem, (cudaStream_t)stream>>>(
        *prm, (const int32_t*)table, (const T*)mask, (const T*)x, (T*)y);
  return (int)cudaGetLastError();
}

extern "C" {

int pa_box_stencil_f32(const PaStencilParams* prm, const void* table, const void* mask,
                       const void* x, void* y, void* stream) {
  return launch<float>(prm, table, mask, x, y, stream);
}

int pa_box_stencil_f64(const PaStencilParams* prm, const void* table, const void* mask,
                       const void* x, void* y, void* stream) {
  return launch<double>(prm, table, mask, x, y, stream);
}

int pa_box_stencil_query_f32(int form, int threads, int smem, int* out) { return query<float>(form, threads, smem, out); }

int pa_box_stencil_query_f64(int form, int threads, int smem, int* out) { return query<double>(form, threads, smem, out); }

}  // extern "C"
