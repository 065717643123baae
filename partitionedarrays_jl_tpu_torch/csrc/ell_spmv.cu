// Padded-ELL SpMV for Hopper (sm_90a), E1: the owned block A_oo of an
// irregular operator and the boundary block A_oh of every lowering.
//
// Replaces no TPU kernel: it stands for the XLA gather-and-fold of the JAX
// package's `_ell_rowsum` (partitionedarrays_jl_tpu/parallel/tpu.py:2916-
// 2924), which its pure-ELL lowering (:1460-1487) runs for A_oo and every
// lowering without node blocks runs for A_oh (`_finish`, :3230-3233), as
// cg_sweep.cu stands for the fused CG body's XLA sweep.
//
// Layout: slot-major. The staged values vals and the int32 slot columns
// cols are (P, L, n): slot l of row i of part p at (p * L + l) * n + i, so
// at each slot neighbouring rows lie at neighbouring addresses (the JAX
// package stages (P, n, L); `ops/irregular.py` documents the transpose).
//
// What it computes, with each product rounded before its add (__fmul_rn /
// __fadd_rn, __dmul_rn / __dadd_rn; no FMA) and the row slots folded left
// to right from slot 0, the order of the host's strict csr_spmv
// (partitionedarrays_jl_tpu_torch/ops/sparse.py) and of the plain version
// (ops/irregular.py:ell_spmv_plain), so the kernel equals both bit for bit:
//   mode 0 (A_oo): for every slot j of the (P, wy) result frame,
//     y[p, j] = sum_l vals[p, l, i] * x[p, cols[p, l, i]]   with i = j - o0,
//     where 0 <= i < n (n rows a part, the padded owned count), else 0;
//   mode 1 (boundary): for every staged boundary row b < n of part p whose
//     target row = rows[p, b] is not the trash slot,
//     y[p, row, k] = y[p, row, k] + sum_l vals[p, l, b] * x[p, cols[p, l, b], k]
//     in place, the row's sum rounded once into y (the host's two-phase
//     A_oo fold, then `+=` of the A_oh fold). x and y are (P, W) frames
//     (K = 1) or (P, W, K) slabs of K columns, column k summed as a frame;
//   mode 2 (A_oo on slabs, `ell_spmm`): mode 0 for each column k of
//     (P, W, K) slabs x and y (column k at the innermost axis), column k
//     folded as mode 0 folds a frame, so it equals mode 0 on column k.
// The fold starts from -0.0, the identity of a rounded add (-0.0 + t = t
// for every t, -0.0 included), so it equals the fold from the first product.
// Pad slots of a row carry value 0 and a real column; pad rows point at the
// trash slot and are skipped, so no two threads ever write one slot (the
// staged boundary rows of a part are distinct).
//
// Bound: memory. vals (T) and the int32 slot columns are read once, x
// gathered (it stays in L2: 3 MB at 64^3 f32), y written (mode 1: read and
// written on the boundary rows). At the elasticity operator's 64^3 mesh
// (786,432 rows padded to 57 slots, f32) the staged arrays and the frames
// are 365 MB a product, 109 us at 3.35 TB/s; the CSR's own bytes (values
// and int32 columns of 27.96M entries) 224 MB, 67 us.
//
// Design: one thread a row (mode 0) or a (row, column) pair (mode 1, the
// rows of one column k neighbouring), blockIdx.y the part. A thread walks
// its row's slots in batches of PA_ELL_BATCH: it issues the batch's value
// and column loads (a warp's are two 128-byte lines at each slot, read
// with the streaming hint, so the operator does not evict x from L2), then
// the x gathers through the read-only path, then folds the batch in slot
// order. Rows are not trimmed to shorter slice widths (SELL): on the
// Morton-ordered elasticity operator nearly every 32-row slice holds a
// row of the longest width, so slices would save almost nothing.
//
// Mode 2 exists to read the operator once for K right-hand sides: a thread
// takes a row and up to PA_ELL_KC columns (blockIdx.z the chunk of
// columns), keeps their sums in registers and folds each slot's value into
// all of them, so vals and cols stream once for K <= PA_ELL_KC; a gathered
// row of x is its K adjacent values. Its bound: vals and cols once, x and
// y (K values a row each) once; on the strict 192^3 f32 lowering (7 slots)
// at K = 8, 850 MB, 253 us at 3.35 TB/s.
//
// Every mode launches on the caller's stream and allocates nothing, so a
// CUDA graph captures it.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_ELL_THREADS 256
#define PA_ELL_BATCH 8
#define PA_ELL_KC 8         // mode 2: columns a thread keeps in registers

enum { PA_ELL_OO = 0, PA_ELL_BOUNDARY = 1, PA_ELL_OO_SLAB = 2 };

struct PaEllParams {
  int P;            // stacked parts
  int L;            // slots a row (>= 1)
  int K;            // columns of the slabs (modes 1, 2), 1 for frames
  int mode;         // PA_ELL_OO or PA_ELL_BOUNDARY
  long long n;      // staged rows a part
  long long wx;     // frame width of x
  long long wy;     // frame width of y
  long long o0;     // band offset of y (mode 0)
  long long trash;  // y's trash slot (mode 1): rows pointing there are skipped
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// the left-to-right fold of one row: slot l at v[l * n], c[l * n]; x column
// k of a K-column slab (K = 1: a frame)
template <typename T>
__device__ __forceinline__ T row_fold(const T* __restrict__ v, const int* __restrict__ c, long long n,
                                      const T* __restrict__ xp, int L, int K, int k) {
  T acc = T(-0.0);
  int l = 0;
  for (; l + PA_ELL_BATCH <= L; l += PA_ELL_BATCH) {
    T vb[PA_ELL_BATCH], xb[PA_ELL_BATCH];
    int cb[PA_ELL_BATCH];
#pragma unroll
    for (int u = 0; u < PA_ELL_BATCH; ++u) {
      vb[u] = __ldcs(v + (long long)(l + u) * n);
      cb[u] = __ldcs(c + (long long)(l + u) * n);
    }
#pragma unroll
    for (int u = 0; u < PA_ELL_BATCH; ++u) xb[u] = __ldg(xp + (long long)cb[u] * K + k);
#pragma unroll
    for (int u = 0; u < PA_ELL_BATCH; ++u) acc = add_rn(acc, mul_rn(vb[u], xb[u]));
  }
  for (; l < L; ++l) {
    const T vl = __ldcs(v + (long long)l * n);
    const int cl = __ldcs(c + (long long)l * n);
    acc = add_rn(acc, mul_rn(vl, __ldg(xp + (long long)cl * K + k)));
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(PA_ELL_THREADS)
ell_oo_kernel(const PaEllParams prm, const T* __restrict__ vals, const int* __restrict__ cols,
              const T* __restrict__ x, T* __restrict__ y) {
  const int p = blockIdx.y;
  const long long j = (long long)blockIdx.x * PA_ELL_THREADS + threadIdx.x;
  if (j >= prm.wy) return;
  const long long i = j - prm.o0;
  T acc = T(0);
  if (i >= 0 && i < prm.n) {
    const long long at = (long long)p * prm.L * prm.n + i;
    acc = row_fold(vals + at, cols + at, prm.n, x + (long long)p * prm.wx, prm.L, 1, 0);
  }
  y[(long long)p * prm.wy + j] = acc;
}

template <typename T>
__global__ void __launch_bounds__(PA_ELL_THREADS)
ell_boundary_kernel(const PaEllParams prm, const long long* __restrict__ rows, const T* __restrict__ vals,
                    const int* __restrict__ cols, const T* __restrict__ x, T* __restrict__ y) {
  const int p = blockIdx.y;
  const long long t = (long long)blockIdx.x * PA_ELL_THREADS + threadIdx.x;
  const int K = prm.K;
  const int k = (int)(t / prm.n);
  const long long b = t - (long long)k * prm.n;
  if (k >= K) return;
  const long long row = rows[(long long)p * prm.n + b];
  if (row == prm.trash) return;
  const long long at = (long long)p * prm.L * prm.n + b;
  const T acc = row_fold(vals + at, cols + at, prm.n, x + (long long)p * prm.wx * K, prm.L, K, k);
  T* yp = y + ((long long)p * prm.wy + row) * K + k;
  *yp = add_rn(*yp, acc);
}

// mode 2: row j of part p for the columns [k0, k0 + kn) of the chunk
// blockIdx.z; rows outside the band write 0 (+0.0)
template <typename T>
__global__ void __launch_bounds__(PA_ELL_THREADS)
ell_oo_slab_kernel(const PaEllParams prm, const T* __restrict__ vals, const int* __restrict__ cols,
                   const T* __restrict__ x, T* __restrict__ y) {
  constexpr int KC = PA_ELL_KC;
  const int p = blockIdx.y;
  const long long j = (long long)blockIdx.x * PA_ELL_THREADS + threadIdx.x;
  if (j >= prm.wy) return;
  const int K = prm.K, k0 = blockIdx.z * KC;
  const int kn = K - k0 < KC ? K - k0 : KC;
  const long long n = prm.n, i = j - prm.o0;
  T acc[KC];
#pragma unroll
  for (int q = 0; q < KC; ++q) acc[q] = T(0);
  if (i >= 0 && i < n) {
#pragma unroll
    for (int q = 0; q < KC; ++q) acc[q] = T(-0.0);  // the identity of a rounded add
    const long long at = (long long)p * prm.L * n + i;
    const T* v = vals + at;
    const int* c = cols + at;
    const T* xp = x + (long long)p * prm.wx * K + k0;  // slot s, column k0 + q at xp[s * K + q]
    for (int l = 0; l < prm.L; ++l) {
      const T vl = __ldcs(v + (long long)l * n);
      const T* xr = xp + (long long)__ldcs(c + (long long)l * n) * K;
#pragma unroll
      for (int q = 0; q < KC; ++q)
        if (q < kn) acc[q] = add_rn(acc[q], mul_rn(vl, __ldg(xr + q)));
    }
  }
  T* yp = y + ((long long)p * prm.wy + j) * K + k0;
#pragma unroll
  for (int q = 0; q < KC; ++q)
    if (q < kn) yp[q] = acc[q];
}

template <typename T>
static int launch(const PaEllParams* prm, const void* rows, const void* vals, const void* cols, const void* x,
                  void* y, void* stream) {
  if (prm->L < 1 || prm->K < 1 || prm->P < 1 || prm->n < 0) return (int)cudaErrorInvalidValue;
  if (prm->mode == PA_ELL_BOUNDARY && prm->n < 1) return (int)cudaErrorInvalidValue;
  const long long work = prm->mode == PA_ELL_BOUNDARY ? prm->n * prm->K : prm->wy;
  long long gx = (work + PA_ELL_THREADS - 1) / PA_ELL_THREADS;
  if (gx < 1) gx = 1;
  const int chunks = prm->mode == PA_ELL_OO_SLAB ? (prm->K + PA_ELL_KC - 1) / PA_ELL_KC : 1;
  if (gx > 0x7fffffffLL || prm->P > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P, (unsigned int)chunks);
  cudaStream_t s = (cudaStream_t)stream;
  if (prm->mode == PA_ELL_OO_SLAB) {
    ell_oo_slab_kernel<T><<<grid, PA_ELL_THREADS, 0, s>>>(*prm, (const T*)vals, (const int*)cols, (const T*)x,
                                                          (T*)y);
  } else if (prm->mode == PA_ELL_OO) {
    ell_oo_kernel<T><<<grid, PA_ELL_THREADS, 0, s>>>(*prm, (const T*)vals, (const int*)cols, (const T*)x, (T*)y);
  } else if (prm->mode == PA_ELL_BOUNDARY) {
    ell_boundary_kernel<T><<<grid, PA_ELL_THREADS, 0, s>>>(*prm, (const long long*)rows, (const T*)vals,
                                                           (const int*)cols, (const T*)x, (T*)y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" {

// rows: the boundary rows (P, n) (mode 1; null in modes 0 and 2); vals,
// cols: (P, L, n), cols int32; x: the operand frame or slab; y: the result
// (written whole in modes 0 and 2, updated on the boundary rows in mode 1).
int pa_ell_spmv_f32(const PaEllParams* prm, const void* rows, const void* vals, const void* cols,
                    const void* x, void* y, void* stream) {
  return launch<float>(prm, rows, vals, cols, x, y, stream);
}

int pa_ell_spmv_f64(const PaEllParams* prm, const void* rows, const void* vals, const void* cols,
                    const void* x, void* y, void* stream) {
  return launch<double>(prm, rows, vals, cols, x, y, stream);
}

}  // extern "C"
