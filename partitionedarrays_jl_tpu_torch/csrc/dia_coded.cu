// Coded-diagonal (coded-DIA) SpMV for Hopper (sm_90a), with its CG
// direction-fold and lagged-axpy variants.
//
// Replaces the TPU kernel `_padded_kernel` of
// partitionedarrays_jl_tpu/ops/pallas_dia.py: its plain call
// (`dia_coded_padded_pallas`, pallas_call at :523), its `has_pfold` call
// (pallas_call at :500) and its `has_axpy` call (pallas_call at :535).
// Both decode modes are here: the select-chain decode
// (pallas_dia.py:329-350) and the row-class decode (:300-328).
//
// What it computes, per part p (blockIdx.y) and row slot j (one thread):
//   i = j - o0; for 0 <= i < no[p]:
//     y[p, j] = sum_d v_d(i) * x[p, o0 + i + off_d]   (ascending d)
//   every other slot of y is exactly 0. A read at i + off_d outside
//   [0, no[p]) is predicated to 0 (the compact frame has no zero pads).
//   v_d(i) is cb[p, d, 0] for a constant diagonal (kk[d] == 1), else
//   cb[p, d, c] with c the 4-bit code of diagonal d (two diagonals per
//   byte, low nibble = even coded index; a code >= kk[d] reads slot 0).
//   Row-class mode (n_cls > 0): c is the low nibble of stream 0, the row's
//   class (>= n_cls reads class 0), and the sum skips the diagonals whose
//   coefficient is zero in every part (cls_mask).
//   pfold: the operand is p = r + beta * pprev, formed per read; the
//   kernel also writes p on the owned band and 0 elsewhere.
//   axpy (pipelined CG): y as above from x, and in the same pass
//   xacc[p, o0 + i] = xacc[p, o0 + i] + alpha * pprev[p, o0 + i] for
//   0 <= i < no[p], in place; every other slot of xacc is left untouched.
//
// Rounding: every product and sum is __fmul_rn / __fadd_rn (no FMA
// contraction), so the result equals the plain PyTorch version in
// ops/dia.py value for value (up to the sign of a zero sum).
//
// Bound: memory. At 192^3 f32, one part, the row-class SpMV moves x (4 B),
// one code byte and y (4 B) per row: 9 B/row, 63.7 MB, about 19.0 us at
// 3.35 TB/s; the pfold variant moves r, pprev, the code byte, y and p:
// 17 B/row, 120.3 MB, about 35.9 us; the axpy variant moves x, the code
// byte, y, pprev and xacc read and written: 21 B/row, 148.6 MB, about
// 44.4 us. 2 nnz flops per SpMV are far below any compute limit.
//
// Design (a first, simple kernel): one thread per row, blocks over rows,
// blockIdx.y over the stacked parts; neighbouring threads read
// neighbouring addresses for every diagonal, the far +-n^2 planes are
// served from L2. The part's codebook sits in shared memory. The axpy
// variant's x update is an independent streaming read-modify-write on the
// same thread, so it adds bytes but no dependence to the band sum.
// Shared-memory plane windows, vector loads or TMA are later work.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_MAX_DIAGS 64
#define PA_MAX_CLASSES 16

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
};

enum { PA_PLAIN = 0, PA_PFOLD = 1, PA_AXPY = 2 };

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T, bool PFOLD>
__device__ __forceinline__ T operand(const T* __restrict__ x,
                                     const T* __restrict__ pprev, T beta,
                                     long long k, long long no) {
  if (k < 0 || k >= no) return T(0);
  if (PFOLD) return add_rn(x[k], mul_rn(beta, pprev[k]));
  return x[k];
}

// MODE: PA_PLAIN, PA_PFOLD (scal = beta, vout = p) or PA_AXPY
// (scal = alpha, vout = xacc updated in place).
template <typename T, int MODE>
__global__ void dia_coded_kernel(const PaDiaParams prm,
                                 const T* __restrict__ cb,
                                 const int32_t* __restrict__ no_arr,
                                 const uint8_t* __restrict__ codes,
                                 const T* __restrict__ x,
                                 const T* __restrict__ pprev,
                                 const T* __restrict__ scal_ptr,
                                 T* __restrict__ y,
                                 T* __restrict__ vout) {
  constexpr bool PFOLD = MODE == PA_PFOLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* scb = reinterpret_cast<T*>(smem_raw);
  const int p = blockIdx.y;
  const int ncb = prm.D * prm.kmax;
  for (int t = threadIdx.x; t < ncb; t += blockDim.x)
    scb[t] = cb[(long long)p * ncb + t];
  __syncthreads();

  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long wmax = prm.wx > prm.wy ? prm.wx : prm.wy;
  if (j >= wmax) return;
  const long long no = no_arr[p];
  const long long i = j - prm.o0;
  const bool owned = i >= 0 && i < no;
  const T* xp = x + (long long)p * prm.wx + prm.o0;
  const T* pp = MODE != PA_PLAIN ? pprev + (long long)p * prm.wx + prm.o0 : nullptr;
  const T scal = MODE != PA_PLAIN ? scal_ptr[0] : T(0);

  if (PFOLD && j < prm.wx)
    vout[(long long)p * prm.wx + j] = owned ? operand<T, true>(xp, pp, scal, i, no) : T(0);
  if (MODE == PA_AXPY && owned) {
    const long long k = (long long)p * prm.wx + j;
    vout[k] = add_rn(vout[k], mul_rn(scal, pp[i]));
  }
  if (j >= prm.wy) return;
  if (!owned) {
    y[(long long)p * prm.wy + j] = T(0);
    return;
  }

  const uint8_t* cp = codes + (long long)p * prm.n_streams * prm.code_len + i;
  T acc = T(0);
  bool first = true;
  if (prm.n_cls > 0) {
    int c = cp[0] & 15;
    if (c >= prm.n_cls) c = 0;
    const unsigned long long mask = prm.cls_mask[c];
    for (int d = 0; d < prm.D; ++d) {
      if (!((mask >> d) & 1ULL)) continue;
      const int slot = c < prm.kk[d] - 1 ? c : prm.kk[d] - 1;
      const T term = mul_rn(scb[d * prm.kmax + slot],
                            operand<T, PFOLD>(xp, pp, scal, i + prm.off[d], no));
      acc = first ? term : add_rn(acc, term);
      first = false;
    }
  } else {
    for (int d = 0; d < prm.D; ++d) {
      T v;
      if (prm.kk[d] == 1) {
        v = scb[d * prm.kmax];
      } else {
        const int ci = prm.code_row[d];
        const unsigned int byte = cp[(long long)(ci >> 1) * prm.code_len];
        const int c = (byte >> (4 * (ci & 1))) & 15;
        v = scb[d * prm.kmax + (c < prm.kk[d] ? c : 0)];
      }
      const T term = mul_rn(v, operand<T, PFOLD>(xp, pp, scal, i + prm.off[d], no));
      acc = first ? term : add_rn(acc, term);
      first = false;
    }
  }
  y[(long long)p * prm.wy + j] = acc;
}

template <typename T, int MODE>
static int launch(const PaDiaParams* prm, const void* cb, const void* no,
                  const void* codes, const void* x, const void* pprev,
                  const void* scal, void* y, void* vout, void* stream) {
  const int threads = 256;
  const long long wmax = prm->wx > prm->wy ? prm->wx : prm->wy;
  dim3 grid((unsigned int)((wmax + threads - 1) / threads), (unsigned int)prm->P);
  const size_t smem = sizeof(T) * (size_t)prm->D * (size_t)prm->kmax;
  dia_coded_kernel<T, MODE><<<grid, threads, smem, (cudaStream_t)stream>>>(
      *prm, (const T*)cb, (const int32_t*)no, (const uint8_t*)codes,
      (const T*)x, (const T*)pprev, (const T*)scal, (T*)y, (T*)vout);
  return (int)cudaGetLastError();
}

extern "C" {

int pa_dia_coded_f32(const PaDiaParams* prm, const void* cb, const void* no,
                     const void* codes, const void* x, void* y, void* stream) {
  return launch<float, PA_PLAIN>(prm, cb, no, codes, x, nullptr, nullptr, y, nullptr, stream);
}

int pa_dia_coded_f64(const PaDiaParams* prm, const void* cb, const void* no,
                     const void* codes, const void* x, void* y, void* stream) {
  return launch<double, PA_PLAIN>(prm, cb, no, codes, x, nullptr, nullptr, y, nullptr, stream);
}

int pa_dia_coded_pfold_f32(const PaDiaParams* prm, const void* cb, const void* no,
                           const void* codes, const void* r, const void* pprev,
                           const void* beta, void* y, void* pout, void* stream) {
  return launch<float, PA_PFOLD>(prm, cb, no, codes, r, pprev, beta, y, pout, stream);
}

int pa_dia_coded_pfold_f64(const PaDiaParams* prm, const void* cb, const void* no,
                           const void* codes, const void* r, const void* pprev,
                           const void* beta, void* y, void* pout, void* stream) {
  return launch<double, PA_PFOLD>(prm, cb, no, codes, r, pprev, beta, y, pout, stream);
}

int pa_dia_coded_axpy_f32(const PaDiaParams* prm, const void* cb, const void* no,
                          const void* codes, const void* x, const void* pprev,
                          const void* alpha, void* y, void* xacc, void* stream) {
  return launch<float, PA_AXPY>(prm, cb, no, codes, x, pprev, alpha, y, xacc, stream);
}

int pa_dia_coded_axpy_f64(const PaDiaParams* prm, const void* cb, const void* no,
                          const void* codes, const void* x, const void* pprev,
                          const void* alpha, void* y, void* xacc, void* stream) {
  return launch<double, PA_AXPY>(prm, cb, no, codes, x, pprev, alpha, y, xacc, stream);
}

}  // extern "C"
