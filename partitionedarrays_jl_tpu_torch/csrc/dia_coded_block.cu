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
// make_block_cg_fn).
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
// Bound: memory. At 192^3 f32, one part, K = 8, row-class Poisson: x and y
// (8 columns, 32 B each a row) and one code byte: 65 B a row, 460 MB,
// 137 us at 3.35 TB/s; the pfold form reads r and pprev and writes y and p:
// 129 B a row (133 with minv).
//
// Design (a simple kernel): one thread a row and a group of KB columns
// (KB = 1, 2, 4 or 8, the smallest power of two at least min(K, 8);
// blockIdx.z the group), KB accumulators in registers. A thread decodes a
// diagonal's coefficient once for its KB columns and reads the operand row
// j = i + off_d as one run of KB values: 16-byte vector loads where K and
// KB are multiples of the vector and the slabs are aligned (`vec`), else
// one load a column. A warp's 32 rows are consecutive, so its loads and
// stores cover whole lines. The pfold form folds each operand row it reads
// (the D rows of its band: L1/L2 hits past the first), so p is never
// re-read from memory. The first form, one thread per (row, column)
// element with a decode each, read 1151 us at 192^3 f32, K = 8, on an H100
// SXM at 700 W (12% of the bound; this form 242 us, 57%). Staging the
// operand planes in shared memory as K1 does is later work.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_MAX_DIAGS 64
#define PA_SPMM_THREADS 256

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
  int vec;             // rows moved as 16-byte vectors
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
__device__ __forceinline__ float4 pack(const float* b) { return make_float4(b[0], b[1], b[2], b[3]); }
__device__ __forceinline__ double2 pack(const double* b) { return make_double2(b[0], b[1]); }

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

template <typename T, int MODE>
static int launch_mode(const PaSpmmParams* prm, const void* cb, const void* no, const void* codes, const void* x,
                       const void* pprev, const void* beta, const void* minv, void* y, void* pout, void* stream) {
  switch (prm->KB) {
    case 1: return launch_kb<T, MODE, 1>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    case 2: return launch_kb<T, MODE, 2>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    case 4: return launch_kb<T, MODE, 4>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    case 8: return launch_kb<T, MODE, 8>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch(const PaSpmmParams* prm, const void* cb, const void* no, const void* codes, const void* x,
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

int pa_dia_coded_spmm_f32(const PaSpmmParams* prm, const void* cb, const void* no, const void* codes,
                          const void* x, const void* pprev, const void* beta, const void* minv, void* y,
                          void* pout, void* stream) {
  return launch<float>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
}

int pa_dia_coded_spmm_f64(const PaSpmmParams* prm, const void* cb, const void* no, const void* codes,
                          const void* x, const void* pprev, const void* beta, const void* minv, void* y,
                          void* pout, void* stream) {
  return launch<double>(prm, cb, no, codes, x, pprev, beta, minv, y, pout, stream);
}

}  // extern "C"
