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
// What it computes, per part p (blockIdx.y) and row slot j (one thread):
//   i = j - o0; for 0 <= i < no[p]:
//     y[p, j] = sum_d vals[p, d, i] * x[p, o0 + i + off_d]   (ascending d)
//   every other slot of y (width wy) is exactly 0. A read at i + off_d
//   outside [0, no[p]) is predicated to 0.
//
// Rounding: every product and sum is __fmul_rn / __fadd_rn (no FMA
// contraction) in ascending-offset order, the order of the plain PyTorch
// version in ops/dia.py, so the two agree value for value.
//
// Bound: memory. At GMG level 1 of the 192^3 hierarchy (96^3 = 884,736
// rows, 27 diagonals, f32) it moves the values (108 B), x (4 B) and y
// (4 B) per row: 116 B/row, 102.6 MB, about 30.6 us at 3.35 TB/s; 2 flops
// per stored value are far below any compute limit.
//
// Design (a first, simple kernel): one thread per row, blocks over rows,
// blockIdx.y over the stacked parts. The values are laid out
// diagonal-major, so for every diagonal neighbouring threads read
// neighbouring values (one coalesced stream per diagonal); the shifted x
// reads hit the same lines for nearby offsets and L2 for the far planes.
// Shared-memory x windows and vector loads are later work.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_MAX_DIAGS 64

struct PaStreamParams {
  int P;          // stacked parts
  int D;          // diagonals
  long long n;    // values per diagonal per part (>= max no)
  long long wx;   // operand frame width
  long long wy;   // result frame width
  long long o0;   // owned offset in both frames
  int off[PA_MAX_DIAGS];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void dia_stream_kernel(const PaStreamParams prm,
                                  const T* __restrict__ vals,
                                  const int32_t* __restrict__ no_arr,
                                  const T* __restrict__ x,
                                  T* __restrict__ y) {
  const int p = blockIdx.y;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= prm.wy) return;
  const long long no = no_arr[p];
  const long long i = j - prm.o0;
  if (i < 0 || i >= no) {
    y[(long long)p * prm.wy + j] = T(0);
    return;
  }
  const T* xp = x + (long long)p * prm.wx + prm.o0;
  const T* vp = vals + (long long)p * prm.D * prm.n + i;
  T acc = T(0);
  for (int d = 0; d < prm.D; ++d) {
    const long long k = i + prm.off[d];
    const T xv = (k >= 0 && k < no) ? xp[k] : T(0);
    const T term = mul_rn(vp[(long long)d * prm.n], xv);
    acc = d == 0 ? term : add_rn(acc, term);
  }
  y[(long long)p * prm.wy + j] = acc;
}

template <typename T>
static int launch(const PaStreamParams* prm, const void* vals, const void* no,
                  const void* x, void* y, void* stream) {
  const int threads = 256;
  dim3 grid((unsigned int)((prm->wy + threads - 1) / threads), (unsigned int)prm->P);
  dia_stream_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      *prm, (const T*)vals, (const int32_t*)no, (const T*)x, (T*)y);
  return (int)cudaGetLastError();
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
