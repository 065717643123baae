// The V-cycle's smoother and residual epilogue for Hopper (sm_90a): one
// pass after a level's SpMV, in three modes.
//
// Replaces no TPU kernel: it stands for the XLA fusions of the JAX
// package's V-cycle (partitionedarrays_jl_tpu/parallel/tpu_gmg.py), as
// cg_sweep.cu stands for the fused CG body's update sweep:
//   init      x = omega * dinv * b                          (tpu_gmg.py:596)
//   residual  r = b - A x, in the transfer's frame          (:616, :686)
//   smooth    x += omega * dinv * (b - A x)                 (:603-604, :798-799)
// It serves every level and transfer route of parallel/gpu_gmg.py:
// make_vcycle alike, after the SpMV's own finish (the A_oh terms of a
// multi-part level added): it reads the product y = A x where the SpMV
// wrote it, in the operator's row frame, so the product is never copied
// into a zeroed column frame first.
//
// What it computes, per part p (blockIdx.y), over the band i in [0, n)
// (n = the level's largest owned count, for every part, as the eager
// sequence does; b, dinv and x in the level's column frame with the band
// at o0, y in the product's frame with its band at yo0):
//   mode 0 (init):     out[p, oo0 + i] = (w * dinv[p, o0 + i]) * b[p, o0 + i]
//   mode 1 (residual): out[p, oo0 + i] = b[p, o0 + i] - y[p, yo0 + i]
//       and every other slot of out (width wo) exactly 0;
//   mode 2 (smooth):   x[p, o0 + i] = x[p, o0 + i]
//                        + (w * dinv[p, o0 + i]) * (b[p, o0 + i] - y[p, yo0 + i])
//       in place, no other slot of x touched.
// w is omega rounded to T, as PyTorch rounds a Python scalar for a CUDA
// tensor of type T. Each product, difference and sum is rounded on its
// own (__fmul_rn, __fsub_rn, __fadd_rn; the __d*_rn in f64; no FMA), in
// the order of the eager expressions, so the kernel equals its plain
// version (ops/epilogue.py:vcycle_epilogue_plain) bit for bit.
//
// Bound: memory. At 192^3 f32, level 0 (7,077,888 rows): init reads dinv
// and b and writes the frame, residual reads b and y and writes the frame:
// 12 B a row, 84.9 MB, 25.3 us at 3.35 TB/s; smooth reads x, dinv, b, y
// and writes x: 20 B a row, 141.6 MB, 42.3 us. A few flops an element.
//
// Design: a CTA of PA_EPI_THREADS threads takes one chunk of
// PA_EPI_THREADS * PA_EPI_ITEMS slots of one part; a thread loads its
// PA_EPI_ITEMS slots of every operand first (scalar loads, neighbouring
// threads on neighbouring slots: a part's band need not be 16-byte aligned
// in a stacked frame), then computes and stores. It launches on the
// caller's stream and allocates nothing, so a CUDA graph captures it.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_EPI_THREADS 256
#define PA_EPI_ITEMS 8

enum { PA_EPI_INIT = 0, PA_EPI_RESIDUAL = 1, PA_EPI_SMOOTH = 2 };

struct PaEpilogueParams {
  int P;          // stacked parts
  int mode;       // PA_EPI_INIT, PA_EPI_RESIDUAL, PA_EPI_SMOOTH
  long long n;    // band length
  long long o0;   // band offset of b, dinv and x
  long long wc;   // frame width of b, dinv and x
  long long yo0;  // band offset of y
  long long wy;   // frame width of y
  long long oo0;  // band offset of out (init, residual)
  long long wo;   // frame width of out (init, residual)
  double omega;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T, int MODE>
__global__ void __launch_bounds__(PA_EPI_THREADS)
vcycle_epilogue_kernel(const PaEpilogueParams prm, const T* __restrict__ b,
                       const T* __restrict__ dinv, const T* __restrict__ y,
                       T* __restrict__ x, T* __restrict__ out) {
  const int p = blockIdx.y;
  const long long n = prm.n;
  // slots of this thread: of the band (smooth) or of the whole output frame
  const long long len = MODE == PA_EPI_SMOOTH ? n : prm.wo;
  const long long start = (long long)blockIdx.x * (PA_EPI_THREADS * PA_EPI_ITEMS) + threadIdx.x;
  const long long band0 = MODE == PA_EPI_SMOOTH ? 0 : prm.oo0;
  const T w = (T)prm.omega;
  const T* bp = b + (long long)p * prm.wc + prm.o0;
  const T* dp = dinv + (long long)p * prm.wc + prm.o0;
  const T* yp = y + (long long)p * prm.wy + prm.yo0;
  T* xp = x + (long long)p * prm.wc + prm.o0;

  T bv[PA_EPI_ITEMS], dv[PA_EPI_ITEMS], yv[PA_EPI_ITEMS], xv[PA_EPI_ITEMS];
  bool in[PA_EPI_ITEMS];
#pragma unroll
  for (int k = 0; k < PA_EPI_ITEMS; ++k) {
    const long long j = start + (long long)k * PA_EPI_THREADS;
    const long long i = j - band0;
    in[k] = j < len && i >= 0 && i < n;
    bv[k] = in[k] ? bp[i] : T(0);
    if (MODE != PA_EPI_RESIDUAL) dv[k] = in[k] ? dp[i] : T(0);
    if (MODE != PA_EPI_INIT) yv[k] = in[k] ? yp[i] : T(0);
    if (MODE == PA_EPI_SMOOTH) xv[k] = in[k] ? xp[i] : T(0);
  }
#pragma unroll
  for (int k = 0; k < PA_EPI_ITEMS; ++k) {
    const long long j = start + (long long)k * PA_EPI_THREADS;
    if (MODE == PA_EPI_SMOOTH) {
      if (in[k]) xp[j] = add_rn(xv[k], mul_rn(mul_rn(w, dv[k]), sub_rn(bv[k], yv[k])));
    } else if (j < len) {
      T v = T(0);
      if (in[k]) v = MODE == PA_EPI_INIT ? mul_rn(mul_rn(w, dv[k]), bv[k]) : sub_rn(bv[k], yv[k]);
      out[(long long)p * prm.wo + j] = v;
    }
  }
}

template <typename T, int MODE>
static int launch_mode(const PaEpilogueParams* prm, const void* b, const void* dinv, const void* y,
                       void* x, void* out, void* stream) {
  const long long chunk = (long long)PA_EPI_THREADS * PA_EPI_ITEMS;
  const long long len = MODE == PA_EPI_SMOOTH ? prm->n : prm->wo;
  long long gx = (len + chunk - 1) / chunk;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P);
  vcycle_epilogue_kernel<T, MODE><<<grid, PA_EPI_THREADS, 0, (cudaStream_t)stream>>>(
      *prm, (const T*)b, (const T*)dinv, (const T*)y, (T*)x, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const PaEpilogueParams* prm, const void* b, const void* dinv, const void* y,
                  void* x, void* out, void* stream) {
  switch (prm->mode) {
    case PA_EPI_INIT: return launch_mode<T, PA_EPI_INIT>(prm, b, dinv, y, x, out, stream);
    case PA_EPI_RESIDUAL: return launch_mode<T, PA_EPI_RESIDUAL>(prm, b, dinv, y, x, out, stream);
    case PA_EPI_SMOOTH: return launch_mode<T, PA_EPI_SMOOTH>(prm, b, dinv, y, x, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

// b, dinv, x: the level's column frames; y: the SpMV product; out: the
// output frame of init and residual. A pointer a mode does not read or
// write may be null.
int pa_vcycle_epilogue_f32(const PaEpilogueParams* prm, const void* b, const void* dinv,
                           const void* y, void* x, void* out, void* stream) {
  return launch<float>(prm, b, dinv, y, x, out, stream);
}

int pa_vcycle_epilogue_f64(const PaEpilogueParams* prm, const void* b, const void* dinv,
                           const void* y, void* x, void* out, void* stream) {
  return launch<double>(prm, b, dinv, y, x, out, stream);
}

}  // extern "C"
