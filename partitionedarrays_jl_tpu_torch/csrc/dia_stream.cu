// Streaming-DIA SpMV for Hopper (sm_90a): a banded operator with
// variable coefficients, one dense value per (part, diagonal, row).
//
// Replaces the TPU kernel `_kernel` of
// partitionedarrays_jl_tpu/ops/pallas_dia.py, reached through
// `dia_spmv_pallas` (pallas_call at :110). The TPU form stages the values
// lane-tiled as (D, R, 128) with zero halo rows around x; this port's frame
// is compact, so the values are (P, D, N) and every shifted read is
// predicated instead.
//
// What it computes, per part p (blockIdx.y) and owned row i:
//   for 0 <= i < no[p]:
//     y[p, o0 + i] = sum_d vals[p, d, i] * x[p, o0 + i + off_d]   (ascending d)
//   every other slot of y (width wy) is exactly 0. A read at i + off_d
//   outside [0, no[p]) is predicated to 0.
//
// Rounding: every product and sum is __fmul_rn / __fadd_rn (no FMA
// contraction) in ascending-offset order, the first term taken as it is,
// the order of the plain PyTorch version in ops/dia.py, so the two agree
// value for value in every form.
//
// Bound: memory. At GMG level 1 of the 192^3 hierarchy (96^3 = 884,736
// rows, 27 diagonals, f32) it moves the values (108 B), x (4 B) and y
// (4 B) per row: 116 B/row, 102.6 MB, about 30.6 us at 3.35 TB/s; 2 flops
// per stored value are far below any compute limit. The coarse levels
// (48^3 and below, 12.8 MB down to 0.2 MB) are bound by latency: one
// round trip to memory and the launch.
//
// Design. The sum is a template on the diagonal count ND, fully unrolled
// with the offsets read from the parameter block by constant index: ND =
// 27 (the Galerkin operators of every GMG level past the first) and ND = 7;
// ND = 0 is the run-time loop over any D <= 64, which still issues its
// loads eight diagonals at a time. The loads of a batch of diagonals (all
// of them in the small form) are issued before its first multiply. Two
// forms, chosen by shape in ops/dia.py:stream_form:
//
// * stream (PA_STREAM_THREADS threads, R = 16 / sizeof(T) rows a thread):
//   for the large levels. A thread's rows are consecutive, so where n is
//   a multiple of R and the values are 16-byte aligned (ops/dia.py sets
//   `vec`) each diagonal's R values come in one 128-bit load; otherwise
//   the rows of a thread are PA_STREAM_THREADS apart and every load is a
//   coalesced scalar one. The values are read with the evict-first hint
//   (__ldcs): they are read once, and x (3.5 MB at 96^3) keeps L1 and L2
//   for its 27 shifted reads: the +-1 and +-n reads of a CTA hit the lines
//   its neighbouring offsets brought into L1, the +-n^2 planes come from
//   L2. Batches of 9 diagonals bound the registers (no spill in f64 at
//   two CTAs an SM).
// * small (PA_SMALL_THREADS threads, one row a thread): for the levels
//   whose rows cannot fill the card in the stream form. Every value and x
//   load of a row is issued at once, so a row waits one memory round trip,
//   not D of them.
//
// The slots of y outside the band ([0, o0) and [o0 + n, wy)) are zeroed by
// the same grid, a grid-stride loop per part.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_MAX_DIAGS 64
#define PA_STREAM_THREADS 256
#define PA_SMALL_THREADS 128
// diagonals a batch of the run-time loop
#define PA_LOOP_BATCH 8

struct PaStreamParams {
  int P;          // stacked parts
  int D;          // diagonals
  long long n;    // values per diagonal per part (>= max no)
  long long wx;   // operand frame width
  long long wy;   // result frame width
  long long o0;   // owned offset in both frames
  int off[PA_MAX_DIAGS];
  int form;       // 0: stream, 1: small
  int vec;        // stream form: 128-bit value loads (n % R == 0, values 16-byte aligned)
  int nd;         // the unrolled sum's diagonal count (27, 7), or 0: the run-time loop
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// R values of one diagonal at consecutive rows i0 .. i0 + R - 1, one
// 128-bit evict-first load (R = 4 in f32, 2 in f64)
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const double* p, double* v) {
  const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = q.x; v[1] = q.y;
}

// diagonals a batch: all of them in the small form (R == 1), 9 of the 27
// or all 7 in the stream form, PA_LOOP_BATCH in the run-time loop
template <int ND, int R>
struct Batch {
  static constexpr int B = ND == 0 ? PA_LOOP_BATCH : (R == 1 || ND % 9 != 0) ? ND : 9;
};

// two CTAs an SM for the vector form (at most 128 registers a thread); the
// scalar stream form (R rows, each with its own addresses) and the small
// form (every load of a row at once) may take up to 255
template <typename T, int ND, int R, bool VEC, int THREADS>
__global__ void __launch_bounds__(THREADS, VEC ? 2 : 1)
dia_stream_kernel(const PaStreamParams prm, const T* __restrict__ vals,
                  const int32_t* __restrict__ no_arr, const T* __restrict__ x,
                  T* __restrict__ y) {
  constexpr int B = Batch<ND, R>::B;
  const int p = blockIdx.y;
  const int D = ND > 0 ? ND : prm.D;
  const long long n = prm.n;
  const long long no = no_arr[p];
  const long long base = (long long)blockIdx.x * (THREADS * R);
  long long row[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    row[r] = VEC ? base + (long long)threadIdx.x * R + r : base + (long long)r * THREADS + threadIdx.x;
  const T* vp = vals + (long long)p * D * n;
  const T* xp = x + (long long)p * prm.wx + prm.o0;
  T* yp = y + (long long)p * prm.wy;

  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
  // one batch of B diagonals from d0: every load first, then the sums
  auto batch = [&](int d0) {
    T v[B][R], xv[B][R];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int d = d0 + b;
      if (ND > 0 || d < D) {
        const long long off = prm.off[d];
        const T* vd = vp + (long long)d * n;
        if constexpr (VEC) {
          load_vec(vd + row[0], v[b]);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) v[b][r] = row[r] < n ? __ldcs(vd + row[r]) : T(0);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const long long k = row[r] + off;
          xv[b][r] = (k >= 0 && k < no) ? xp[k] : T(0);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int d = d0 + b;
      if (ND > 0 || d < D) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T term = mul_rn(v[b][r], xv[b][r]);
          acc[r] = d == 0 ? term : add_rn(acc[r], term);
        }
      }
    }
  };
  if (row[0] < no) {
    if constexpr (ND > 0) {
#pragma unroll
      for (int d0 = 0; d0 < ND; d0 += B) batch(d0);
    } else {
#pragma unroll 1
      for (int d0 = 0; d0 < D; d0 += B) batch(d0);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (row[r] < n) yp[prm.o0 + row[r]] = row[r] < no ? acc[r] : T(0);

  // the frame outside the band: [0, o0) and [o0 + n, wy)
  const long long pads = prm.wy - n;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < pads; j += stride)
    yp[j < prm.o0 ? j : j + n] = T(0);
}

template <typename T, int ND, int R, bool VEC, int THREADS>
static int launch_form(const PaStreamParams* prm, const void* vals, const void* no,
                       const void* x, void* y, void* stream) {
  const long long rows = (long long)THREADS * R;
  long long gx = (prm->n + rows - 1) / rows;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P);
  dia_stream_kernel<T, ND, R, VEC, THREADS><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      *prm, (const T*)vals, (const int32_t*)no, (const T*)x, (T*)y);
  return (int)cudaGetLastError();
}

template <typename T, int ND>
static int launch_nd(const PaStreamParams* prm, const void* vals, const void* no,
                     const void* x, void* y, void* stream) {
  constexpr int R = 16 / sizeof(T);
  if (prm->form == 1)
    return launch_form<T, ND, 1, false, PA_SMALL_THREADS>(prm, vals, no, x, y, stream);
  if (prm->form != 0) return (int)cudaErrorInvalidValue;
  if (prm->vec) {
    if (prm->n % R != 0 || (uintptr_t)vals % 16 != 0) return (int)cudaErrorInvalidValue;
    return launch_form<T, ND, R, true, PA_STREAM_THREADS>(prm, vals, no, x, y, stream);
  }
  return launch_form<T, ND, R, false, PA_STREAM_THREADS>(prm, vals, no, x, y, stream);
}

template <typename T>
static int launch(const PaStreamParams* prm, const void* vals, const void* no,
                  const void* x, void* y, void* stream) {
  if (prm->D < 1 || prm->D > PA_MAX_DIAGS || (prm->nd != 0 && prm->nd != prm->D))
    return (int)cudaErrorInvalidValue;
  switch (prm->nd) {
    case 27: return launch_nd<T, 27>(prm, vals, no, x, y, stream);
    case 7: return launch_nd<T, 7>(prm, vals, no, x, y, stream);
    case 0: return launch_nd<T, 0>(prm, vals, no, x, y, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int pa_dia_stream_f32(const PaStreamParams* prm, const void* vals, const void* no,
                      const void* x, void* y, void* stream) {
  return launch<float>(prm, vals, no, x, y, stream);
}

int pa_dia_stream_f64(const PaStreamParams* prm, const void* vals, const void* no,
                      const void* x, void* y, void* stream) {
  return launch<double>(prm, vals, no, x, y, stream);
}

}  // extern "C"
