// The CG update sweep for Hopper (sm_90a): x += alpha*p, r += (-alpha)*q
// and the r.r partial in one pass, guarded by a device flag; its Jacobi
// (precond) form, which also takes the r.z partial with z = minv*r; and its
// block form over K right-hand sides.
//
// Replaces no TPU kernel: it stands for the XLA fusion of the fused CG
// body's update sweep, `step_fused` in partitionedarrays_jl_tpu/parallel/
// tpu.py:4090-4101 (x and r updated and the r.r partial taken in one
// sweep; with a preconditioner the pair `odot2(ro, zo, ro, ro)` of
// :4094-4096, whose two reductions share one gather), and for the block
// program's per-column sweep (`make_block_cg_fn`'s step_f, tpu.py:4881-4888),
// as box_stencil.cu stands for `_stencil_apply`'s. The port's
// device-resident loops (parallel/gpu_loop.py) run it in every CG body and
// in GMG-PCG's level-0 update.
//
// What it computes, over the band [o0, o0 + n) of every part p of (P, W)
// frames, when live[0] != 0:
//   x[p, i] = x[p, i] + alpha * p[p, i]        (modes 0 and 2)
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
// p out. Mode 2 (Jacobi PCG) is mode 0 with a second series of partials:
// series 0 sums r[p, i] * z with z = minv[p, i] * r[p, i] (rounded, never
// stored), series 1 sums r[p, i]^2; part is (P, 2, G) and the fold gives
// rs[0] = r.z, rs[1] = r.r.
//
// The block form (cg_sweep_block_kernel) takes (P, W, K) slabs, K columns
// contiguous, a per-column alpha[k] and a per-column flag act[k] in place
// of live: column k is updated as the solo sweep updates a frame, and a
// column whose flag reads 0 writes nothing (no x, no r, no partial). Its
// partials are (P, S, G) with S = K series (r.r of column k) or 2K (r.z,
// r.r of column k at 2k, 2k + 1), and the fold, one CTA a series, gives
// rs[s]. Every series is summed in the solo order below, so column k of a
// block follows the solo sweep of that column bit for bit.
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
// reads r and q and writes r: 12 B a row; mode 2 reads minv too: 28 B a
// row, 198.2 MB, 59.2 us. The block form at K = 8 moves 24 B a row and
// column: 1.36 GB, 406 us (minv, 4 B a row, read once for all columns).
// Three flops an element (six with minv).
//
// Design (a first, simple kernel): a CTA of 256 threads takes one chunk of
// 2048 elements of one part (blockIdx.y); a thread loads its 8 elements of
// every operand first, so 16 or 32 loads are in flight before the first
// store, then computes and stores. Neighbouring threads touch neighbouring
// elements (scalar loads: a part's band need not be 16-byte aligned in a
// stacked frame). The fold is one CTA a series. The flag is read once a
// thread. The block form keeps that schedule: a thread takes the same 8
// rows, and for each row the KB columns of its column group (blockIdx.z)
// as consecutive scalar loads, so a warp's loads of one row and column
// group cover whole sectors (one 32-byte sector a row at K = 8 f32, the
// first load bringing it into L1 for the other seven); it keeps KB
// accumulators (KB = 1, 2, 4 or 8, the smallest power of two at least
// min(K, 8)) and runs one halving tree a column. Where K and KB are
// multiples of a 16-byte vector and the slabs are aligned (`vec`), a row's
// values move as 16-byte loads and stores: with one scalar access a column,
// each warp instruction touched a sector a lane for 4 useful bytes, and
// the stores reached L2 as K partial writes of each sector (the first form,
// scalar only, read 1.24 ms at 192^3 f32, K = 8, on an H100 SXM at 700 W: 33% of the
// bound; 0.46 ms, 88%, with 16-byte rows).

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
  long long wv;   // frame width of x, r and p (and minv)
  long long wq;   // frame width of q
  int mode;       // 0: x and r; 1: r only; 2: x and r, with minv (two series)
  int S;          // series of partials: 1 (modes 0, 1), 2 (mode 2), K or 2K (block)
  int K;          // block form: columns of the slabs (0: the solo form)
  int KB;         // block form: columns a CTA (1, 2, 4 or 8)
  int vec;        // block form: rows moved as 16-byte vectors (K and KB multiples of 16 / sizeof(T), slabs aligned)
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

template <typename T, bool XMODE, bool MINV>
__global__ void __launch_bounds__(PA_SWEEP_THREADS)
cg_sweep_kernel(const PaSweepParams prm, T* __restrict__ x, T* __restrict__ r,
                const T* __restrict__ p, const T* __restrict__ q,
                const T* __restrict__ alpha_ptr, const int32_t* __restrict__ live,
                T* __restrict__ part, const T* __restrict__ minv) {
  __shared__ T s[PA_SWEEP_THREADS];
  if (live[0] == 0) return;  // uniform over the grid: no barrier is skipped by some
  const int g = blockIdx.x, pp = blockIdx.y, t = threadIdx.x;
  const long long C = (long long)PA_SWEEP_THREADS * PA_SWEEP_ITEMS;
  const long long i0 = (long long)g * C + t;
  T* rp = r + (long long)pp * prm.wv + prm.o0;
  const T* qp = q + (long long)pp * prm.wq + prm.o0;
  T* xp = XMODE ? x + (long long)pp * prm.wv + prm.o0 : nullptr;
  const T* pv = XMODE ? p + (long long)pp * prm.wv + prm.o0 : nullptr;
  const T* mp = MINV ? minv + (long long)pp * prm.wv + prm.o0 : nullptr;
  const T a = alpha_ptr[0];
  const T na = -a;
  T rv[PA_SWEEP_ITEMS], qv[PA_SWEEP_ITEMS], xv[PA_SWEEP_ITEMS], pw[PA_SWEEP_ITEMS], mv[PA_SWEEP_ITEMS];
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
      if (MINV) mv[k] = mp[i];
    }
  }
  T acc = T(0), acc_z = T(0);
#pragma unroll
  for (int k = 0; k < PA_SWEEP_ITEMS; ++k) {
    const long long i = i0 + (long long)k * PA_SWEEP_THREADS;
    if (full || i < prm.n) {
      const T rn = add_rn(rv[k], mul_rn(na, qv[k]));
      rp[i] = rn;
      acc = add_rn(acc, mul_rn(rn, rn));
      if (MINV) acc_z = add_rn(acc_z, mul_rn(rn, mul_rn(mv[k], rn)));
      if (XMODE) xp[i] = add_rn(xv[k], mul_rn(a, pw[k]));
    }
  }
  if (MINV) {
    acc_z = tree_sum<T, PA_SWEEP_THREADS>(acc_z, s);
    if (t == 0) part[((long long)pp * prm.S) * prm.G + g] = acc_z;
    __syncthreads();  // s is reused by the next tree
  }
  acc = tree_sum<T, PA_SWEEP_THREADS>(acc, s);
  if (t == 0) part[((long long)pp * prm.S + (MINV ? 1 : 0)) * prm.G + g] = acc;
}

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
    static_assert(KB % NV == 0, "a vector row holds whole vectors");
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

// The block form: column group blockIdx.z (columns c0 .. c0 + KB - 1 of K,
// those < K taken), the rows of the solo schedule; act[k] guards column k.
// A row's KB values move as 16-byte vectors with VEC (a frozen column's
// value is then written back as it was read), else one by one (a frozen
// column is not written).
template <typename T, bool MINV, int KB, bool VEC>
__global__ void __launch_bounds__(PA_SWEEP_THREADS, 1)
cg_sweep_block_kernel(const PaSweepParams prm, T* __restrict__ x, T* __restrict__ r,
                      const T* __restrict__ p, const T* __restrict__ q,
                      const T* __restrict__ alpha, const int32_t* __restrict__ act,
                      T* __restrict__ part, const T* __restrict__ minv) {
  __shared__ T s[PA_SWEEP_THREADS];
  const int g = blockIdx.x, pp = blockIdx.y, t = threadIdx.x;
  const int K = prm.K, c0 = blockIdx.z * KB;
  const long long C = (long long)PA_SWEEP_THREADS * PA_SWEEP_ITEMS;
  const long long i0 = (long long)g * C + t;
  T* rp = r + ((long long)pp * prm.wv + prm.o0) * K + c0;
  const T* qp = q + ((long long)pp * prm.wq + prm.o0) * K + c0;
  T* xp = x + ((long long)pp * prm.wv + prm.o0) * K + c0;
  const T* pv = p + ((long long)pp * prm.wv + prm.o0) * K + c0;
  const T* mp = MINV ? minv + (long long)pp * prm.wv + prm.o0 : nullptr;
  bool on[KB];
  T a[KB], acc[KB], acc_z[KB];
#pragma unroll
  for (int c = 0; c < KB; ++c) {
    const bool in = c0 + c < K;
    on[c] = in && act[c0 + c] != 0;
    a[c] = in ? alpha[c0 + c] : T(0);
    acc[c] = T(0);
    acc_z[c] = T(0);
  }
  const int nvalid = K - c0 < KB ? K - c0 : KB;
  const bool full = (long long)(g + 1) * C <= prm.n;
#pragma unroll 1
  for (int k = 0; k < PA_SWEEP_ITEMS; ++k) {
    const long long i = i0 + (long long)k * PA_SWEEP_THREADS;
    if (!(full || i < prm.n)) continue;
    const long long e = i * K;
    T rv[KB], qv[KB], xv[KB], pw[KB];
    load_row<T, KB, VEC>(rp + e, nvalid, rv);
    load_row<T, KB, VEC>(qp + e, nvalid, qv);
    load_row<T, KB, VEC>(xp + e, nvalid, xv);
    load_row<T, KB, VEC>(pv + e, nvalid, pw);
    const T m = MINV ? mp[i] : T(0);
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      if (on[c]) {
        const T rn = add_rn(rv[c], mul_rn(-a[c], qv[c]));
        acc[c] = add_rn(acc[c], mul_rn(rn, rn));
        if (MINV) acc_z[c] = add_rn(acc_z[c], mul_rn(rn, mul_rn(m, rn)));
        rv[c] = rn;
        xv[c] = add_rn(xv[c], mul_rn(a[c], pw[c]));
        if (!VEC) {
          rp[e + c] = rv[c];
          xp[e + c] = xv[c];
        }
      }
    }
    if (VEC) {
      store_row<T, KB, VEC>(rp + e, nvalid, rv);
      store_row<T, KB, VEC>(xp + e, nvalid, xv);
    }
  }
#pragma unroll
  for (int c = 0; c < KB; ++c) {
    if (c0 + c >= K) break;  // uniform over the CTA
    const long long base = (long long)pp * prm.S;
    if (MINV) {
      const T vz = tree_sum<T, PA_SWEEP_THREADS>(acc_z[c], s);
      if (t == 0 && on[c]) part[(base + 2 * (c0 + c)) * prm.G + g] = vz;
      __syncthreads();
    }
    const T v = tree_sum<T, PA_SWEEP_THREADS>(acc[c], s);
    if (t == 0 && on[c]) part[(base + (MINV ? 2 * (c0 + c) + 1 : c0 + c)) * prm.G + g] = v;
    __syncthreads();
  }
}

// The block dot's products, column by column (block_products): out[k * S +
// p * n + i] = a[p, o0 + i, k] * b[p, o0 + i, k] (rounded) over the band of
// every part, i.e. column k's (P, n) product block at k * S, each block laid
// out as a fresh contiguous product of the solo dot is, so the block dot
// sums it in the solo order (parallel/gpu.py:_block_pdot_factory). A
// thread takes a row and its column group's KB values (16-byte loads with
// VEC) and writes KB column streams, each store coalesced over the warp's
// 32 consecutive rows. It stands for the transposing product
// `torch.mul(a.permute(2, 0, 1), b.permute(2, 0, 1), out=...)`, which
// walks the slabs once per column (K reads of each; at K = 8, 192^3 f32,
// 1.26 ms on an H100 SXM at 700 W against a 0.20 ms bound for the pair
// read and the products written once; this kernel 0.23 ms).
template <typename T, int KB, bool VEC>
__global__ void __launch_bounds__(PA_SWEEP_THREADS)
block_products_kernel(const PaSweepParams prm, const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ out) {
  const int pp = blockIdx.y, K = prm.K, c0 = blockIdx.z * KB;
  const int nvalid = K - c0 < KB ? K - c0 : KB;
  const T* ap = a + ((long long)pp * prm.wv + prm.o0) * K + c0;
  const T* bp = b + ((long long)pp * prm.wq + prm.o0) * K + c0;
  T* op = out + (long long)c0 * prm.G + (long long)pp * prm.n;  // G: the column stride S
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < prm.n; i += stride) {
    T u[KB], v[KB];
    load_row<T, KB, VEC>(ap + i * K, nvalid, u);
    load_row<T, KB, VEC>(bp + i * K, nvalid, v);
#pragma unroll
    for (int c = 0; c < KB; ++c)
      if (c < nvalid) op[(long long)c * prm.G + i] = mul_rn(u[c], v[c]);
  }
}

// CTA s folds series s: its partials in each part the solo way, then the
// parts left to right.
template <typename T>
__global__ void __launch_bounds__(PA_FOLD_THREADS)
cg_fold_kernel(const PaSweepParams prm, const T* __restrict__ part, T* __restrict__ rs) {
  __shared__ T s[PA_FOLD_THREADS];
  const int t = threadIdx.x, ser = blockIdx.x;
  T total = T(0);
  for (int pp = 0; pp < prm.P; ++pp) {
    const T* pt = part + ((long long)pp * prm.S + ser) * prm.G;
    T acc = T(0);
    for (int j = t; j < prm.G; j += PA_FOLD_THREADS) acc = add_rn(acc, pt[j]);
    acc = tree_sum<T, PA_FOLD_THREADS>(acc, s);
    if (t == 0) total = pp == 0 ? acc : add_rn(total, acc);
    __syncthreads();  // s is reused by the next part's tree
  }
  if (t == 0) rs[ser] = total;
}

template <typename T>
static int fold(const PaSweepParams* prm, const void* part, void* rs, cudaStream_t st) {
  cg_fold_kernel<T><<<(unsigned int)prm->S, PA_FOLD_THREADS, 0, st>>>(*prm, (const T*)part, (T*)rs);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                  const void* alpha, const void* live, void* part, void* rs, const void* minv,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned int)prm->G, (unsigned int)prm->P);
  if (prm->mode == 0 && prm->S == 1) {
    cg_sweep_kernel<T, true, false><<<grid, PA_SWEEP_THREADS, 0, st>>>(
        *prm, (T*)x, (T*)r, (const T*)p, (const T*)q, (const T*)alpha, (const int32_t*)live, (T*)part, nullptr);
  } else if (prm->mode == 1 && prm->S == 1) {
    cg_sweep_kernel<T, false, false><<<grid, PA_SWEEP_THREADS, 0, st>>>(
        *prm, nullptr, (T*)r, nullptr, (const T*)q, (const T*)alpha, (const int32_t*)live, (T*)part, nullptr);
  } else if (prm->mode == 2 && prm->S == 2 && minv != nullptr) {
    cg_sweep_kernel<T, true, true><<<grid, PA_SWEEP_THREADS, 0, st>>>(
        *prm, (T*)x, (T*)r, (const T*)p, (const T*)q, (const T*)alpha, (const int32_t*)live, (T*)part,
        (const T*)minv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return fold<T>(prm, part, rs, st);
}

template <typename T, bool MINV, int KB>
static int launch_block_kb(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                           const void* alpha, const void* act, void* part, const void* minv, cudaStream_t st) {
  dim3 grid((unsigned int)prm->G, (unsigned int)prm->P, (unsigned int)((prm->K + KB - 1) / KB));
  constexpr int NV = 16 / (int)sizeof(T);
  if (prm->vec) {
    if constexpr (KB % NV == 0) {
      if (prm->K % NV != 0) return (int)cudaErrorInvalidValue;
      cg_sweep_block_kernel<T, MINV, KB, true><<<grid, PA_SWEEP_THREADS, 0, st>>>(
          *prm, (T*)x, (T*)r, (const T*)p, (const T*)q, (const T*)alpha, (const int32_t*)act, (T*)part,
          (const T*)minv);
      return 0;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  cg_sweep_block_kernel<T, MINV, KB, false><<<grid, PA_SWEEP_THREADS, 0, st>>>(
      *prm, (T*)x, (T*)r, (const T*)p, (const T*)q, (const T*)alpha, (const int32_t*)act, (T*)part,
      (const T*)minv);
  return 0;
}

template <typename T, bool MINV>
static int launch_block_minv(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                             const void* alpha, const void* act, void* part, const void* minv, cudaStream_t st) {
  int e;
  switch (prm->KB) {
    case 1: e = launch_block_kb<T, MINV, 1>(prm, x, r, p, q, alpha, act, part, minv, st); break;
    case 2: e = launch_block_kb<T, MINV, 2>(prm, x, r, p, q, alpha, act, part, minv, st); break;
    case 4: e = launch_block_kb<T, MINV, 4>(prm, x, r, p, q, alpha, act, part, minv, st); break;
    case 8: e = launch_block_kb<T, MINV, 8>(prm, x, r, p, q, alpha, act, part, minv, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return e != 0 ? e : (int)cudaGetLastError();
}

template <typename T>
static int launch_block(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                        const void* alpha, const void* act, void* part, void* rs, const void* minv,
                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool with_minv = minv != nullptr;
  if (prm->K < 1 || prm->S != (with_minv ? 2 * prm->K : prm->K)) return (int)cudaErrorInvalidValue;
  const int e = with_minv ? launch_block_minv<T, true>(prm, x, r, p, q, alpha, act, part, minv, st)
                          : launch_block_minv<T, false>(prm, x, r, p, q, alpha, act, part, minv, st);
  if (e != 0) return e;
  return fold<T>(prm, part, rs, st);
}

template <typename T, int KB>
static int launch_products_kb(const PaSweepParams* prm, const void* a, const void* b, void* out, cudaStream_t st) {
  long long gx = (prm->n + PA_SWEEP_THREADS - 1) / PA_SWEEP_THREADS;
  gx = gx < 1 ? 1 : gx > 65535 * 16 ? 65535 * 16 : gx;
  dim3 grid((unsigned int)gx, (unsigned int)prm->P, (unsigned int)((prm->K + KB - 1) / KB));
  constexpr int NV = 16 / (int)sizeof(T);
  if (prm->vec) {
    if constexpr (KB % NV == 0) {
      if (prm->K % NV != 0) return (int)cudaErrorInvalidValue;
      block_products_kernel<T, KB, true><<<grid, PA_SWEEP_THREADS, 0, st>>>(*prm, (const T*)a, (const T*)b, (T*)out);
      return (int)cudaGetLastError();
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  block_products_kernel<T, KB, false><<<grid, PA_SWEEP_THREADS, 0, st>>>(*prm, (const T*)a, (const T*)b, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_products(const PaSweepParams* prm, const void* a, const void* b, void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (prm->K < 1) return (int)cudaErrorInvalidValue;
  switch (prm->KB) {
    case 1: return launch_products_kb<T, 1>(prm, a, b, out, st);
    case 2: return launch_products_kb<T, 2>(prm, a, b, out, st);
    case 4: return launch_products_kb<T, 4>(prm, a, b, out, st);
    case 8: return launch_products_kb<T, 8>(prm, a, b, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int pa_block_products_f32(const PaSweepParams* prm, const void* a, const void* b, void* out, void* stream) {
  return launch_products<float>(prm, a, b, out, stream);
}

int pa_block_products_f64(const PaSweepParams* prm, const void* a, const void* b, void* out, void* stream) {
  return launch_products<double>(prm, a, b, out, stream);
}

int pa_cg_sweep_f32(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                    const void* alpha, const void* live, void* part, void* rs, const void* minv,
                    void* stream) {
  return launch<float>(prm, x, r, p, q, alpha, live, part, rs, minv, stream);
}

int pa_cg_sweep_f64(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                    const void* alpha, const void* live, void* part, void* rs, const void* minv,
                    void* stream) {
  return launch<double>(prm, x, r, p, q, alpha, live, part, rs, minv, stream);
}

int pa_cg_sweep_block_f32(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                          const void* alpha, const void* act, void* part, void* rs, const void* minv,
                          void* stream) {
  return launch_block<float>(prm, x, r, p, q, alpha, act, part, rs, minv, stream);
}

int pa_cg_sweep_block_f64(const PaSweepParams* prm, void* x, void* r, const void* p, const void* q,
                          const void* alpha, const void* act, void* part, void* rs, const void* minv,
                          void* stream) {
  return launch_block<double>(prm, x, r, p, q, alpha, act, part, rs, minv, stream);
}

}  // extern "C"
