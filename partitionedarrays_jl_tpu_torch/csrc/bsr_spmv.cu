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
//   mode 0 (A_oo): for every slot s of the (P, wy) result frame, with
//     r = s - yo0, node = r / bs, i = r % bs, when 0 <= r < nn * bs:
//     y[p, s] = sum_l sum_j vals[p, node, l, i, j] * x[p, xo0 + cols[p, node, l] * bs + j]
//     and 0 elsewhere;
//   mode 1 (boundary, every width bucket in one launch): bucket c holds
//     nb_c staged boundary nodes a part, each of Lb_c blocks, as arrays
//     rows_c (P, nb_c, bs), cols_c (P, nb_c, Lb_c) and vals_c (P, nb_c,
//     Lb_c, bs, bs) at element offsets roff_c, coff_c and voff_c of three
//     flat buffers; for every node n < nb_c of part p and i < bs whose
//     target row = rows_c[p, n, i] is not the trash slot,
//     y[p, row] = y[p, row] + sum_l sum_j vals_c[p, n, l, i, j] * x[p, g0 + cols_c[p, n, l] * bs + j]
//     in place (xo0 = g0: the ghost-node frame), the row's sum rounded once
//     into y. The bucket table (at most PA_BSR_MAX_BUCKETS entries) rides in
//     the parameter block: no device table, no copy before a launch.
// Pad blocks carry value 0 and node 0; pad rows point at the trash slot
// and are skipped, so no two threads write one slot (a part's boundary
// nodes are distinct across its buckets): one launch over all buckets
// writes what the per-bucket launches wrote, bit for bit.
//
// Bound: memory. The blocks (bs^2 values each) and their int64 node
// columns are read once, x gathered a node at a time, y written. At the
// elasticity operator's 64^3 mesh in f32 (bs = 3, 262,144 node rows padded
// to 19 blocks) the staged blocks and the frames are 225 MB a product,
// 67 us at 3.35 TB/s.
//
// The node-block boundary at 32^3 f64 on 4 parts is 3.64 MB, 1.09 us of
// bytes, less than the 4.9 us an empty kernel takes on an H100 (CUDA
// events): its cost is the launch count, hence one launch for all buckets.
//
// Design: one thread a result row, blockIdx.y the part; the thread walks
// its node's blocks in order and reads its row i of each (bs values).
// Threads of one node read neighbouring rows of the same blocks. In mode 1
// the grid covers every bucket's rows (the buckets' nb_c * bs rows laid
// end to end); a thread finds its bucket by a scan of the table's first
// rows (uniform across a warp but at a bucket edge). It launches on the
// caller's stream and allocates nothing, so a CUDA graph captures it.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_BSR_THREADS 256
#define PA_BSR_MAX_BUCKETS 8

enum { PA_BSR_OO = 0, PA_BSR_BOUNDARY = 1 };

struct PaBsrParams {
  int P;            // stacked parts
  int Lb;           // blocks a node row (>= 1)
  int bs;           // block size: 2, 3 or 4
  int mode;         // PA_BSR_OO or PA_BSR_BOUNDARY
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
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// row i of node `node` of part p in a block row of Lb blocks (nn nodes a
// part): sum over its Lb blocks and their bs columns
template <typename T, int BS>
__device__ __forceinline__ T block_row(const PaBsrParams& prm, int p, long long nn, int Lb, long long node, int i,
                                       const T* __restrict__ vals, const long long* __restrict__ cols,
                                       const T* __restrict__ x) {
  const long long at = (long long)p * nn + node;
  const T* v = vals + at * Lb * (BS * BS) + i * BS;
  const long long* c = cols + at * Lb;
  const T* xp = x + (long long)p * prm.wx + prm.xo0;
  const T* xb = xp + c[0] * BS;
  T acc = mul_rn(v[0], xb[0]);
#pragma unroll
  for (int j = 1; j < BS; ++j) acc = add_rn(acc, mul_rn(v[j], xb[j]));
  for (int l = 1; l < Lb; ++l) {
    const T* vl = v + l * (BS * BS);
    xb = xp + c[l] * BS;
#pragma unroll
    for (int j = 0; j < BS; ++j) acc = add_rn(acc, mul_rn(vl[j], xb[j]));
  }
  return acc;
}

template <typename T, int BS>
__global__ void __launch_bounds__(PA_BSR_THREADS)
bsr_oo_kernel(const PaBsrParams prm, const T* __restrict__ vals, const long long* __restrict__ cols,
              const T* __restrict__ x, T* __restrict__ y) {
  const int p = blockIdx.y;
  const long long s = (long long)blockIdx.x * PA_BSR_THREADS + threadIdx.x;
  if (s >= prm.wy) return;
  const long long r = s - prm.yo0;
  T acc = T(0);
  if (r >= 0 && r < prm.nn * BS) acc = block_row<T, BS>(prm, p, prm.nn, prm.Lb, r / BS, (int)(r % BS), vals, cols, x);
  y[(long long)p * prm.wy + s] = acc;
}

template <typename T, int BS>
__global__ void __launch_bounds__(PA_BSR_THREADS)
bsr_boundary_kernel(const PaBsrParams prm, const long long* __restrict__ rows, const T* __restrict__ vals,
                    const long long* __restrict__ cols, const T* __restrict__ x, T* __restrict__ y) {
  const int p = blockIdx.y;
  const long long t = (long long)blockIdx.x * PA_BSR_THREADS + threadIdx.x;
  if (t >= prm.bk_row0[prm.nbk]) return;
  int c = 0;
  while (c + 1 < prm.nbk && t >= prm.bk_row0[c + 1]) ++c;
  const long long r = t - prm.bk_row0[c];  // row of bucket c, part p
  const long long nb = prm.bk_nb[c];
  const long long row = rows[prm.bk_roff[c] + (long long)p * nb * BS + r];
  if (row == prm.trash) return;
  const T acc = block_row<T, BS>(prm, p, nb, prm.bk_Lb[c], r / BS, (int)(r % BS), vals + prm.bk_voff[c],
                                 cols + prm.bk_coff[c], x);
  T* yp = y + (long long)p * prm.wy + row;
  *yp = add_rn(*yp, acc);
}

template <typename T, int BS>
static int launch_bs(const PaBsrParams* prm, const void* rows, const void* vals, const void* cols, const void* x,
                     void* y, cudaStream_t s) {
  const long long work = prm->mode == PA_BSR_OO ? prm->wy : prm->bk_row0[prm->nbk];
  long long gx = (work + PA_BSR_THREADS - 1) / PA_BSR_THREADS;
  if (gx < 1) gx = 1;
  if (gx > 0x7fffffffLL || prm->P > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P);
  if (prm->mode == PA_BSR_OO) {
    bsr_oo_kernel<T, BS><<<grid, PA_BSR_THREADS, 0, s>>>(*prm, (const T*)vals, (const long long*)cols,
                                                         (const T*)x, (T*)y);
  } else if (prm->mode == PA_BSR_BOUNDARY) {
    bsr_boundary_kernel<T, BS><<<grid, PA_BSR_THREADS, 0, s>>>(*prm, (const long long*)rows, (const T*)vals,
                                                               (const long long*)cols, (const T*)x, (T*)y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const PaBsrParams* prm, const void* rows, const void* vals, const void* cols, const void* x,
                  void* y, void* stream) {
  if (prm->Lb < 1 || prm->P < 1) return (int)cudaErrorInvalidValue;
  if (prm->mode == PA_BSR_BOUNDARY) {
    if (prm->nbk < 1 || prm->nbk > PA_BSR_MAX_BUCKETS || prm->bk_row0[0] != 0) return (int)cudaErrorInvalidValue;
    for (int c = 0; c < prm->nbk; ++c)
      if (prm->bk_Lb[c] < 1 || prm->bk_row0[c + 1] != prm->bk_row0[c] + prm->bk_nb[c] * prm->bs)
        return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (prm->bs) {
    case 2: return launch_bs<T, 2>(prm, rows, vals, cols, x, y, s);
    case 3: return launch_bs<T, 3>(prm, rows, vals, cols, x, y, s);
    case 4: return launch_bs<T, 4>(prm, rows, vals, cols, x, y, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// mode 0: vals (P, nn, Lb, bs, bs), cols (P, nn, Lb) node columns, rows
// null; mode 1: the flat buffers of the buckets' rows, cols and vals (the
// table in prm gives each bucket's offsets); x: the operand frame; y: the
// result (written whole in mode 0, updated on the boundary rows in mode 1).
int pa_bsr_spmv_f32(const PaBsrParams* prm, const void* rows, const void* vals, const void* cols,
                    const void* x, void* y, void* stream) {
  return launch<float>(prm, rows, vals, cols, x, y, stream);
}

int pa_bsr_spmv_f64(const PaBsrParams* prm, const void* rows, const void* vals, const void* cols,
                    const void* x, void* y, void* stream) {
  return launch<double>(prm, rows, vals, cols, x, y, stream);
}

}  // extern "C"
