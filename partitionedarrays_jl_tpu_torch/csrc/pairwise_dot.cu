// The strict-bits dot for Hopper (sm_90a), E3: products rounded one by
// one, a part's products summed in the fixed pairwise tree, the parts
// added left to right.
//
// Replaces no TPU kernel: it stands for the XLA reduction of the JAX
// package's strict dot, `_strict_pairwise_partial` / `_strict_partial_any`
// and `_pdot_factory`'s strict branch (partitionedarrays_jl_tpu/parallel/
// tpu.py:2486-2515, :2538-2551), whose tree the host's
// `utils/helpers.py:pairwise_sum` runs in NumPy.
//
// What it computes, over the band [o0, o0 + n) of each part p of (P, W)
// frames a and b:
//   t[p, i] = a[p, o0 + i] * b[p, o0 + i]      (__fmul_rn / __dmul_rn)
//   padded with +0.0 to m = the next power of two >= n (1 for n <= 1);
//   s[p] = the perfect binary tree over t[p, :m]: v[0::2] + v[1::2], level
//          by level, until one element (__fadd_rn / __dadd_rn);
//   out = s[0] + s[1] + ... + s[P - 1], left to right from part 0.
// The tree is the NumPy tree: every add pairs the neighbours (2i, 2i + 1)
// of the level below. A subtree over an aligned block of 2^k elements is
// that block's own tree, so a CTA reduces one aligned block of
// PA_PW_BLOCK elements (or all m, if fewer) in shared memory, pairing
// neighbours level by level (never a warp-shuffle butterfly, whose
// pairing differs), and the next pass reduces the CTAs' results with the
// same code, until one value a part is left; a last one-thread pass adds
// the parts. IEEE adds of the same operands in the same tree give the
// same bits, the sign of an exact zero included, so the result equals
// numpy's pairwise sum of the rounded products bit for bit.
//
// Bound: memory. It reads a and b once (2 x 4 B a row in f32, 2 x 8 B in
// f64) and writes one partial a CTA: at 192^3 f32 on one part, 56.6 MB,
// 16.9 us at 3.35 TB/s.
//
// Design (a first, simple kernel): 256 threads a CTA, blocks of 2048
// elements; a thread first adds its pairs of rounded products (4 pairs,
// neighbouring threads on neighbouring pairs), then the CTA halves the
// block in two shared-memory buffers, one barrier a level. The passes and
// the fold launch on the caller's stream; the wrapper allocates the
// partials, so a CUDA graph captures the whole dot.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_PW_THREADS 256
#define PA_PW_BLOCK 2048  // elements one CTA reduces (a power of two)

struct PaPairwiseParams {
  int P;          // stacked parts
  int pad_;
  long long n;    // band length (real elements a part)
  long long m;    // padded length: a power of two >= n
  long long wa;   // frame width of a
  long long wb;   // frame width of b
  long long o0;   // band offset of a and b
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// element j of part p's level: a rounded product (PRODUCTS) or a partial
// of the pass below, +0.0 past the real elements
template <typename T, bool PRODUCTS>
__device__ __forceinline__ T element(const PaPairwiseParams& prm, int p, long long j, long long real,
                                     const T* __restrict__ a, const T* __restrict__ b) {
  if (j >= real) return T(0);
  if (PRODUCTS) return mul_rn(a[(long long)p * prm.wa + prm.o0 + j], b[(long long)p * prm.wb + prm.o0 + j]);
  return a[(long long)p * real + j];
}

// one CTA: the tree over elements [blk * e, blk * e + e) of part p's level
// (count elements a part, `real` of them real), into out[p, blk]
template <typename T, bool PRODUCTS>
__global__ void __launch_bounds__(PA_PW_THREADS)
pairwise_tree_kernel(const PaPairwiseParams prm, long long real, long long e, const T* __restrict__ a,
                     const T* __restrict__ b, T* __restrict__ out) {
  __shared__ T buf[2][PA_PW_BLOCK / 2];
  const int p = blockIdx.y;
  const long long base = (long long)blockIdx.x * e;
  if (e == 1) {
    if (threadIdx.x == 0) out[(long long)p * gridDim.x + blockIdx.x] = element<T, PRODUCTS>(prm, p, base, real, a, b);
    return;
  }
  const int half = (int)(e / 2);
  for (int i = threadIdx.x; i < half; i += PA_PW_THREADS) {
    const long long j = base + 2LL * i;
    buf[0][i] = add_rn(element<T, PRODUCTS>(prm, p, j, real, a, b), element<T, PRODUCTS>(prm, p, j + 1, real, a, b));
  }
  __syncthreads();
  int src = 0;
  for (int h = half / 2; h >= 1; h >>= 1) {
    for (int i = threadIdx.x; i < h; i += PA_PW_THREADS) buf[src ^ 1][i] = add_rn(buf[src][2 * i], buf[src][2 * i + 1]);
    __syncthreads();
    src ^= 1;
  }
  if (threadIdx.x == 0) out[(long long)p * gridDim.x + blockIdx.x] = buf[src][0];
}

// the parts' sums added left to right
template <typename T>
__global__ void pairwise_fold_kernel(int P, const T* __restrict__ s, T* __restrict__ out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  T acc = s[0];
  for (int i = 1; i < P; ++i) acc = add_rn(acc, s[i]);
  out[0] = acc;
}

// the partials the passes write, a part: m / e, then that / e, .. down to 1
static long long scratch_len(long long m) {
  long long total = 0, count = m;
  do {
    const long long e = count < PA_PW_BLOCK ? count : PA_PW_BLOCK;
    count /= e;
    total += count;
  } while (count > 1);
  return total;
}

template <typename T>
static int launch(const PaPairwiseParams* prm, const void* a, const void* b, void* scratch,
                  long long scratch_elems, void* out, void* stream) {
  const long long m = prm->m;
  if (prm->P < 1 || prm->P > 65535 || m < 1 || (m & (m - 1)) != 0 || m < prm->n || prm->n < 0)
    return (int)cudaErrorInvalidValue;
  if (scratch_elems < prm->P * scratch_len(m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  T* dst = (T*)scratch;
  const T* src = nullptr;
  long long count = m;
  bool first = true;
  do {
    const long long e = count < PA_PW_BLOCK ? count : PA_PW_BLOCK;
    const long long nblk = count / e;
    if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned int)nblk, (unsigned int)prm->P);
    if (first) {
      pairwise_tree_kernel<T, true><<<grid, PA_PW_THREADS, 0, s>>>(*prm, prm->n, e, (const T*)a, (const T*)b, dst);
    } else {
      pairwise_tree_kernel<T, false><<<grid, PA_PW_THREADS, 0, s>>>(*prm, count, e, src, nullptr, dst);
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    first = false;
    src = dst;
    dst += prm->P * nblk;
    count = nblk;
  } while (count > 1);
  pairwise_fold_kernel<T><<<1, 32, 0, s>>>(prm->P, src, (T*)out);
  return (int)cudaGetLastError();
}

extern "C" {

// a, b: (P, W) frames; scratch: the partials, at least P * scratch_len(m)
// elements; out: one element, the dot.
int pa_pairwise_dot_f32(const PaPairwiseParams* prm, const void* a, const void* b, void* scratch,
                        long long scratch_elems, void* out, void* stream) {
  return launch<float>(prm, a, b, scratch, scratch_elems, out, stream);
}

int pa_pairwise_dot_f64(const PaPairwiseParams* prm, const void* a, const void* b, void* scratch,
                        long long scratch_elems, void* out, void* stream) {
  return launch<double>(prm, a, b, scratch, scratch_elems, out, stream);
}

}  // extern "C"
