// The CG update sweep for Hopper (sm_90a): x += alpha*p, r += (-alpha)*q
// and the r.r partial in one pass, guarded by a device flag.
//
// Replaces no TPU kernel: it stands for the XLA fusion of the fused CG
// body's update sweep, `step_fused` in partitionedarrays_jl_tpu/parallel/
// tpu.py:4090-4101 (x and r updated and the r.r partial taken in one
// sweep), as box_stencil.cu stands for `_stencil_apply`'s. The port's
// device-resident loops (parallel/gpu_loop.py) run it in every CG body and
// in GMG-PCG's level-0 update.
//
// What it computes, over the band [o0, o0 + n) of every part p of (P, W)
// frames, when live[0] != 0:
//   x[p, i] = x[p, i] + alpha * p[p, i]        (mode 0 only)
//   r[p, i] = r[p, i] + (-alpha) * q[p, i]
//   part[p, g] = the sum of r[p, i]^2 over chunk g of the band
// each product rounded before its add (__fmul_rn / __fadd_rn, no FMA), as
// the eager update in PyTorch rounds. With live[0] == 0 the sweep writes
// nothing: no x, no r, no partial. Then the fold below, which always runs,
// gives back the sum of the unchanged partials, and a frozen iteration of
// the loop leaves the state bit for bit as it was.
//   rs[0] = the partials of each part folded, then the parts summed left to
//   right (part 0 first), as parallel/gpu.py:_pdot_factory folds parts.
// Mode 1 (pipelined CG, whose x update rides the SpMV kernel) leaves x and
// p out.
//
// Order of the partial (ops/sweep.py:cg_sweep_plain repeats it, so the
// two agree bit for bit): chunk g of a part holds elements
// g*C .. g*C + C - 1 of its band, C = PA_SWEEP_THREADS * PA_SWEEP_ITEMS;
// thread t of its CTA sums the squares of elements g*C + k*PA_SWEEP_THREADS
// + t, k = 0 .. PA_SWEEP_ITEMS - 1, in order from 0; the CTA's sums are
// then added in a halving tree (t + h into t, h = 128, 64, .., 1). The fold
// takes a part's partials the same way: thread t sums partials t, t +
// PA_FOLD_THREADS, .. in order from 0, then the halving tree.
//
// Bound: memory. At 192^3 f32 (7,077,888 rows, mode 0) it reads x, p, r, q
// and writes x and r: 24 B a row, 169.9 MB, 50.7 us at 3.35 TB/s; mode 1
// reads r and q and writes r: 12 B a row. Three flops an element.
//
// Design (a first, simple kernel): a CTA of 256 threads takes one chunk of
// 2048 elements of one part (blockIdx.y); a thread loads its 8 elements of
// every operand first, so 16 or 32 loads are in flight before the first
// store, then computes and stores. Neighbouring threads touch neighbouring
// elements (scalar loads: a part's band need not be 16-byte aligned in a
// stacked frame). The fold is one CTA. The flag is read once a thread.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_SWEEP_THREADS 256
#define PA_SWEEP_ITEMS 8
#define PA_FOLD_THREADS 256

struct PaSweepParams {
  int P;          // stacked parts
  int G;          // chunks (CTAs) a part: ceil(n / (PA_SWEEP_THREADS * PA_SWEEP_ITEMS))
  long long n;    // band length
  long long o0;   // band offset in every frame
  long long wv;   // frame width of x, r and p
  long long wq;   // frame width of q
  int mode;       // 0: x and r; 1: r only
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// the halving tree over a CTA's per-thread sums (t + h into t); returns the
// sum in thread 0. s holds THREADS values.
template <typename T, int THREADS>
__device__ __forceinline__ T tree_sum(T v, T* s) {
  const int t = threadIdx.x;
  s[t] = v;
  __syncthreads();
#pragma unroll
  for (int h = THREADS / 2; h >= 32; h >>= 1) {
    if (t < h) s[t] = add_rn(s[t], s[t + h]);
    __syncthreads();
  }
  if (t < 32) {
    v = s[t];
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) v = add_rn(v, __shfl_down_sync(0xffffffffu, v, h));
  }
  return v;
}

template <typename T, bool XMODE>
__global__ void __launch_bounds__(PA_SWEEP_THREADS)
cg_sweep_kernel(const PaSweepParams prm, T* __restrict__ x, T* __restrict__ r,
                const T* __restrict__ p, const T* __restrict__ q,
                const T* __restrict__ alpha_ptr, const int32_t* __restrict__ live,
                T* __restrict__ part) {
  __shared__ T s[PA_SWEEP_THREADS];
  if (live[0] == 0) return;  // uniform over the grid: no barrier is skipped by some
  const int g = blockIdx.x, pp = blockIdx.y, t = threadIdx.x;
  const long long C = (long long)PA_SWEEP_THREADS * PA_SWEEP_ITEMS;
  const long long i0 = (long long)g * C + t;
  T* rp = r + (long long)pp * prm.wv + prm.o0;
  const T* qp = q + (long long)pp * prm.wq + prm.o0;
  T* xp = XMODE ? x + (long long)pp * prm.wv + prm.o0 : nullptr;
  const T* pv = XMODE ? p + (long long)pp * prm.wv + prm.o0 : nullptr;
  const T a = alpha_ptr[0];
  const T na = -a;
  T rv[PA_SWEEP_ITEMS], qv[PA_SWEEP_ITEMS], xv[PA_SWEEP_ITEMS], pw[PA_SWEEP_ITEMS];
  const bool full = (long long)(g + 1) * C <= prm.n;
#pragma unroll
  for (int k = 0; k < PA_SWEEP_ITEMS; ++k) {
    const long long i = i0 + (long long)k * PA_SWEEP_THREADS;
    if (full || i < prm.n) {
      rv[k] = rp[i];
      qv[k] = qp[i];
      if (XMODE) {
        xv[k] = xp[i];
        pw[k] = pv[i];
      }
    }
  }
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < PA_SWEEP_ITEMS; ++k) {
    const long long i = i0 + (long long)k * PA_SWEEP_THREADS;
    if (full || i < prm.n) {
      const T rn = add_rn(rv[k], mul_rn(na, qv[k]));
      rp[i] = rn;
      acc = add_rn(acc, mul_rn(rn, rn));
      if (XMODE) xp[i] = add_rn(xv[k], mul_rn(a, pw[k]));
    }
  }
  acc = tree_sum<T, PA_SWEEP_THREADS>(acc, s);
  if (t == 0) part[(long long)pp * prm.G + g] = acc;
}

template <typename T>
__global__ void __launch_bounds__(PA_FOLD_THREADS)
cg_fold_kernel(const PaSweepParams prm, const T* __restrict__ part, T* __restrict__ rs) {
  __shared__ T s[PA_FOLD_THREADS];
  const int t = threadIdx.x;
  T total = T(0);
  for (int pp = 0; pp < prm.P; ++pp) {
    const T* pt = part + (long long)pp * prm.G;
    T acc = T(0);
    for (int j = t; j < prm.G; j += PA_FOLD_THREADS) acc = add_rn(acc, pt[j]);
    acc = tree_sum<T, PA_FOLD_THREADS>(acc, s);
    if (t == 0) total = pp == 0 ? acc : add_rn(total, acc);
    __syncthreads();  // s is reused by the next part's tree
  }
  if (t == 0) rs[0] = total;
}

template <typename T>
static int launch(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                  const void* alpha, const void* live, void* part, void* rs, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned int)prm->G, (unsigned int)prm->P);
  if (prm->mode == 0) {
    cg_sweep_kernel<T, true><<<grid, PA_SWEEP_THREADS, 0, st>>>(
        *prm, (T*)x, (T*)r, (const T*)p, (const T*)q, (const T*)alpha, (const int32_t*)live, (T*)part);
  } else {
    cg_sweep_kernel<T, false><<<grid, PA_SWEEP_THREADS, 0, st>>>(
        *prm, nullptr, (T*)r, nullptr, (const T*)q, (const T*)alpha, (const int32_t*)live, (T*)part);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cg_fold_kernel<T><<<1, PA_FOLD_THREADS, 0, st>>>(*prm, (const T*)part, (T*)rs);
  return (int)cudaGetLastError();
}

extern "C" {

int pa_cg_sweep_f32(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                    const void* alpha, const void* live, void* part, void* rs, void* stream) {
  return launch<float>(prm, x, r, p, q, alpha, live, part, rs, stream);
}

int pa_cg_sweep_f64(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                    const void* alpha, const void* live, void* part, void* rs, void* stream) {
  return launch<double>(prm, x, r, p, q, alpha, live, part, rs, stream);
}

}  // extern "C"
