// Streaming-DIA SpMM for Hopper (sm_90a): the band product of
// csrc/dia_stream.cu (dense per-diagonal values of a variable-coefficient
// band) over K right-hand sides at once.
//
// Replaces no Pallas kernel of its own: on a block operand the JAX
// package's `_spmv_body` takes the jnp form `_dia_rowsum`
// (partitionedarrays_jl_tpu/parallel/tpu.py:2960-2978), since the Pallas
// kernel `_kernel` / `dia_spmv_pallas` of ops/pallas_dia.py (:110) is
// K = 1 only. This kernel stands for that form in the port's block CG and
// PCG (parallel/gpu.py:make_block_cg_fn) on a streaming operator.
//
// Layout: (P, W, K) slabs, the K columns of a row contiguous; values
// (P, D, N), diagonal-major, as K4 takes them.
//
// What it computes, per part p (blockIdx.y), owned row i < no[p] and
// column k < K:
//   y[p, o0 + i, k] = sum_d vals[p, d, i] * x[p, o0 + i + off_d, k]   (ascending d)
// a read at i + off_d outside [0, no[p]) taken as 0; every other slot of y
// (rows [0, o0), [o0 + no[p], wy)) is exactly 0.
//
// Rounding: __fmul_rn / __fadd_rn in ascending-offset order from -0, the
// order of the plain PyTorch version (ops/dia.py:dia_stream_spmm_plain), so
// the two agree value for value, and column k equals K4's plain version on
// column k.
//
// Bound: memory. At 192^3 f32, one part, K = 8, on the 7-diagonal
// variable-coefficient operator: the values (28 B a row, read once for all
// columns), x and y (32 B each a row): 92 B a row, 651 MB, 194 us at
// 3.35 TB/s, about 24 us a column against 76 us for K4 on one column.
//
// Design (a simple kernel): one thread a row and a group of KB columns
// (KB = 1, 2, 4 or 8, the smallest power of two at least min(K, 8);
// blockIdx.z the group), KB accumulators in registers: a diagonal's value
// is loaded once for the KB columns, and the operand row i + off_d is read
// as one run of KB values (16-byte vector loads where K and KB are
// multiples of the vector and the slab is aligned, `vec`; else one load a
// column). A warp's 32 rows are consecutive, so its loads and stores cover
// whole lines. The first form, one thread per (row, column) element, read
// 836 us at 192^3 f32, K = 8, on an H100 SXM at 700 W (23% of the bound). Several rows a thread,
// 128-bit value loads and staged operand planes are later work.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_MAX_DIAGS 64
#define PA_SPMM_THREADS 256

struct PaStreamSpmmParams {
  int P;         // stacked parts
  int D;         // diagonals
  long long n;   // band length (values per diagonal)
  long long wx;  // operand frame width (rows)
  long long wy;  // result frame width (rows)
  long long o0;  // owned offset in both frames
  int K;         // columns
  int off[PA_MAX_DIAGS];
  int KB;        // columns a thread (1, 2, 4 or 8)
  int vec;       // rows moved as 16-byte vectors
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

template <typename T, int KB, bool VEC>
__global__ void __launch_bounds__(PA_SPMM_THREADS)
dia_stream_spmm_kernel(const PaStreamSpmmParams prm, const T* __restrict__ vals, const int32_t* __restrict__ no_arr,
                       const T* __restrict__ x, T* __restrict__ y) {
  const int p = blockIdx.y;
  const int K = prm.K, c0 = blockIdx.z * KB;
  const int nv = K - c0 < KB ? K - c0 : KB;
  const long long no = no_arr[p];
  const long long n = prm.n;
  const T* vp = vals + (long long)p * prm.D * n;
  const T* xp = x + ((long long)p * prm.wx + prm.o0) * K + c0;
  T* yp = y + ((long long)p * prm.wy + prm.o0) * K + c0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    T acc[KB];
    if (i >= no) {
#pragma unroll
      for (int c = 0; c < KB; ++c) acc[c] = T(0);
      store_row<T, KB, VEC>(yp + i * K, nv, acc);
      continue;
    }
#pragma unroll
    for (int c = 0; c < KB; ++c) acc[c] = T(-0.0);
    for (int d = 0; d < prm.D; ++d) {
      const long long j = i + prm.off[d];
      const T v = vp[(long long)d * n + i];
      T u[KB];
      if (j >= 0 && j < no) {
        load_row<T, KB, VEC>(xp + j * K, nv, u);
      } else {
#pragma unroll
        for (int c = 0; c < KB; ++c) u[c] = T(0);
      }
#pragma unroll
      for (int c = 0; c < KB; ++c) acc[c] = add_rn(acc[c], mul_rn(v, u[c]));
    }
    store_row<T, KB, VEC>(yp + i * K, nv, acc);
  }
  // the rows outside the band: [0, o0) and [o0 + n, wy) of y
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < prm.wy - n; row += stride)
    for (int c = 0; c < nv; ++c) y[((long long)p * prm.wy + (row < prm.o0 ? row : row + n)) * K + c0 + c] = T(0);
}

template <typename T, int KB>
static int launch_kb(const PaStreamSpmmParams* prm, const void* vals, const void* no, const void* x, void* y,
                     void* stream) {
  long long gx = (prm->n + PA_SPMM_THREADS - 1) / PA_SPMM_THREADS;
  gx = gx < 1 ? 1 : gx > 65535 * 16 ? 65535 * 16 : gx;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P, (unsigned int)((prm->K + KB - 1) / KB));
  constexpr int NV = 16 / (int)sizeof(T);
  if (prm->vec) {
    if constexpr (KB % NV == 0) {
      if (prm->K % NV != 0) return (int)cudaErrorInvalidValue;
      dia_stream_spmm_kernel<T, KB, true><<<grid, PA_SPMM_THREADS, 0, (cudaStream_t)stream>>>(
          *prm, (const T*)vals, (const int32_t*)no, (const T*)x, (T*)y);
      return (int)cudaGetLastError();
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  dia_stream_spmm_kernel<T, KB, false><<<grid, PA_SPMM_THREADS, 0, (cudaStream_t)stream>>>(
      *prm, (const T*)vals, (const int32_t*)no, (const T*)x, (T*)y);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const PaStreamSpmmParams* prm, const void* vals, const void* no, const void* x, void* y,
                  void* stream) {
  if (prm->D < 1 || prm->D > PA_MAX_DIAGS || prm->K < 1) return (int)cudaErrorInvalidValue;
  switch (prm->KB) {
    case 1: return launch_kb<T, 1>(prm, vals, no, x, y, stream);
    case 2: return launch_kb<T, 2>(prm, vals, no, x, y, stream);
    case 4: return launch_kb<T, 4>(prm, vals, no, x, y, stream);
    case 8: return launch_kb<T, 8>(prm, vals, no, x, y, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int pa_dia_stream_spmm_f32(const PaStreamSpmmParams* prm, const void* vals, const void* no, const void* x,
                           void* y, void* stream) {
  return launch<float>(prm, vals, no, x, y, stream);
}

int pa_dia_stream_spmm_f64(const PaStreamSpmmParams* prm, const void* vals, const void* no, const void* x,
                           void* y, void* stream) {
  return launch<double>(prm, vals, no, x, y, stream);
}

}  // extern "C"
