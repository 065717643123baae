// The strict-bits dot for Hopper (sm_90a), E3: products rounded one by
// one, a part's products summed in the fixed pairwise tree, the parts
// added left to right, in one launch.
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
// The block form (`pairwise_dot_block`, one launch) takes (P, W, K) slabs
// a and b (column k at the innermost axis) and computes out[k], the dot
// of column k as above, for every k: column k's tree is the solo tree.
// The tree is the NumPy tree: every add pairs the neighbours (2i, 2i + 1)
// of the level below, the left one the first operand. A subtree over an
// aligned block of 2^k elements is that block's own tree, so any aligned
// block can be reduced on its own and its root used as a node of the
// level 2^k. IEEE adds of the same operands in the same tree give the same
// bits, the sign of an exact zero included, so the result equals numpy's
// pairwise sum of the rounded products bit for bit. An add whose span (the
// elements under its result) exceeds m is never made: with m below a
// thread's run or a CTA's block the root is the node of span m, not that
// node plus padding (+0.0 would turn a -0.0 root into +0.0).
//
// Bound: memory. It reads a and b once (2 x 4 B an element in f32, 2 x 8 B
// in f64) and writes one partial a CTA: at 192^3 f32 on one part, 56.6 MB,
// 16.9 us at 3.35 TB/s.
//
// Design: one launch a dot, grid (m / E CTAs a part, P), E = 256 threads x
// R elements (R = 16 in f32, 8 in f64: 4096 and 2048 elements a CTA).
// * A warp takes 32 R consecutive elements as Q = 4 rows of 32 16-byte
//   vectors (VW = 4 f32 or 2 f64 elements each): vector q of lane L holds
//   elements (q * 32 + L) * VW + e, so that each load instruction of the
//   warp reads 512 contiguous bytes of a or b. A vector is loaded whole
//   where it lies inside the band and both frames' bands start 16-byte
//   aligned, else element by element; elements past n are +0.0 and are not
//   loaded. The products are rounded and each vector reduced by its own
//   tree in registers.
// * Per row q the warp's 32 vectors meet by shuffles at ascending offsets
//   1, 2, 4, 8, 16: lane L holds vector L, and at offset 2^k the lanes
//   that are multiples of 2^(k+1) add the value 2^k lanes up as the right
//   operand, the tree's neighbour pairing (a butterfly at descending
//   offsets would pair lanes 16 apart first: another tree, other bits).
//   Lane 0 then joins its Q row roots pairwise, q = 0 with 1 and 2 with 3,
//   then the two, and the 8 warps' roots meet the same way in warp 0,
//   through shared memory and one barrier.
// * The cross-CTA stage and the part fold ride the same launch: each CTA
//   writes its root to scratch[p, blk], fences, and takes a ticket (an
//   atomic counter); the CTA that takes the last one reduces each part's
//   m / E partials (a power of two) by the same tree (up to 32 of them: a
//   warp a part, a lane a partial, eight parts at once; more: the whole
//   CTA a part, a thread a run of consecutive partials, loaded 8 at a
//   time, the chunks joined by a binary-counter stack), adds the parts
//   left to right from part 0,
//   writes out and resets the ticket to 0. The ticket is zero at every
//   launch (the wrapper's buffer is zeroed once and each launch leaves it
//   so) and is one a stream, so a CUDA graph replays the dot unchanged and
//   two dots in flight at once never share one.
//
// Design of the block form: grid (m / E CTAs a part, P, column chunks),
// E = 256 threads x RB elements (RB = 4 in f32, 2 in f64, one 16-byte
// vector: 1024 and 512 elements a CTA), up to PA_PWB_KC columns a CTA
// (blockIdx.z the chunk). The CTA first rounds the products of its E
// elements and kn columns into a shared-memory tile, column by column: a
// slab holds an element's K columns side by side, so the tile's values
// are read in address order, 32 neighbouring values a warp. (The first
// forms on an H100 at 192^3 f32, K = 8: each thread loading its own run of
// elements for every column, lanes 256 B apart, 2.7 ms; a thread an
// element and its kn columns, lanes 32 B apart, 0.98 ms: both re-read
// each sector from L2 a column at a time.) Then, column
// by column, thread t reduces its RB products (one vector of the tile) by
// their tree, the warp's lanes at ascending offsets, and the 8 warps'
// roots in shared memory (warp k takes column k), and writes one partial a
// column to
// scratch[(k * P + p) * nblk + blk]. The last CTA (the same ticket)
// reduces, for each column, each part's partials as the frame form's last
// CTA does and adds the parts left to right. Its bound: a and b read
// once, 2 x K x 4 B an element in f32.

#include <cstdint>
#include <cuda_runtime.h>

#define PA_PW_THREADS 256
#define PA_PW_WARPS (PA_PW_THREADS / 32)
#define PA_PWB_KC 8  // the block form: columns a CTA takes

struct PaPairwiseParams {
  int P;          // stacked parts
  int K;          // columns of the slabs (the block form)
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

// elements a thread reduces in registers, and the 16-byte vector of T
template <typename T> struct Run;
template <> struct Run<float> { static constexpr int R = 16; using V = float4; };
template <> struct Run<double> { static constexpr int R = 8; using V = double2; };

// elements one CTA reduces
template <typename T>
__host__ __device__ constexpr long long cta_elems() { return (long long)Run<T>::R * PA_PW_THREADS; }

__device__ __forceinline__ void put(float* v, const float4& a, const float4& b) {
  v[0] = mul_rn(a.x, b.x); v[1] = mul_rn(a.y, b.y); v[2] = mul_rn(a.z, b.z); v[3] = mul_rn(a.w, b.w);
}
__device__ __forceinline__ void put(double* v, const double2& a, const double2& b) {
  v[0] = mul_rn(a.x, b.x); v[1] = mul_rn(a.y, b.y);
}

// the warp's lanes, each holding the root of a node of span `span`, meet
// at ascending offsets while the result's span stays within m; lane 0
// ends with the root of the warp's node (all lanes take part)
template <typename T>
__device__ __forceinline__ T warp_tree(T v, long long span, long long m, int lanes) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const T u = __shfl_down_sync(0xffffffffu, v, off);
    if (off < lanes && span * 2 * off <= m && (lane & (2 * off - 1)) == 0) v = add_rn(v, u);
  }
  return v;
}

// the tree over src[0, r), r a power of two, read in order: chunks of up
// to 8 loaded at once, each chunk's tree in registers, the chunks joined
// by a binary counter of partial roots (chunk c closes the subtrees its
// trailing one bits end)
template <typename T>
__device__ __forceinline__ T run_tree(const T* src, long long r) {
  constexpr int C = 8;
  const int chunk = r < C ? (int)r : C;
  T st[40];  // r / C <= 2^39
  int top = 0;
  for (long long c = 0; c * chunk < r; ++c) {
    T v[C];
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = k < chunk ? __ldcg(src + c * chunk + k) : T(0);
#pragma unroll
    for (int lv = 1; (1 << lv) <= C; ++lv) {
      if ((1 << lv) <= chunk) {
#pragma unroll
        for (int i = 0; i < C; i += 1 << lv) v[i] = add_rn(v[i], v[i + (1 << (lv - 1))]);
      }
    }
    T u = v[0];
    int k = 0;
    while ((c >> k) & 1) u = add_rn(st[k++], u);
    st[k] = u;
    top = k;
  }
  return st[top];
}

// the tree over src[0, count), count a power of two, by the whole CTA;
// thread 0 returns the root
template <typename T>
__device__ __forceinline__ T cta_tree(const T* src, long long count, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = count > PA_PW_THREADS ? count / PA_PW_THREADS : 1;
  T v = T(0);
  if ((long long)threadIdx.x * r < count) v = run_tree(src + threadIdx.x * r, r);
  v = warp_tree(v, r, count, 32);
  __syncthreads();  // `red` may still be read from the last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_tree(lane < PA_PW_WARPS ? red[lane] : T(0), r * 32, count, PA_PW_WARPS);
  return v;
}

// the last CTA's stage over the partials at src + q * nblk of parts q < P
// (nblk a power of two): each part's tree, then the parts' roots added
// left to right from part 0; thread 0 returns the sum (every thread takes
// part)
template <typename T>
__device__ __forceinline__ T fold_parts(const T* src, int P, long long nblk, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T fold = T(0);
  if (nblk <= 32) {
    // a warp a part, a lane a partial, 8 parts at a time
    for (int q0 = 0; q0 < P; q0 += PA_PW_WARPS) {
      const int q = q0 + warp;
      T v = q < P && lane < nblk ? __ldcg(src + (long long)q * nblk + lane) : T(0);
      v = warp_tree(v, 1, nblk, 32);
      __syncthreads();  // `red` may still be read from the last chunk
      if (lane == 0) red[warp] = v;
      __syncthreads();
      if (threadIdx.x == 0)
        for (int w = 0; w < PA_PW_WARPS && q0 + w < P; ++w) fold = q0 + w == 0 ? red[w] : add_rn(fold, red[w]);
    }
  } else {
    for (int q = 0; q < P; ++q) {
      const T root = cta_tree(src + (long long)q * nblk, nblk, red);
      if (threadIdx.x == 0) fold = q == 0 ? root : add_rn(fold, root);
    }
  }
  return fold;
}

template <typename T>
__global__ void __launch_bounds__(PA_PW_THREADS)
pairwise_dot_kernel(const PaPairwiseParams prm, const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ scratch, unsigned int* __restrict__ ticket, T* __restrict__ out) {
  constexpr int R = Run<T>::R;
  constexpr int VW = 16 / (int)sizeof(T);  // elements a 16-byte vector
  constexpr int Q = R / VW;                // vectors a thread
  using V = typename Run<T>::V;
  __shared__ T red[PA_PW_WARPS];
  __shared__ int last;
  const int p = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = prm.n, m = prm.m, nblk = gridDim.x;
  const T* ap = a + (long long)p * prm.wa + prm.o0;
  const T* bp = b + (long long)p * prm.wb + prm.o0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(ap) | reinterpret_cast<uintptr_t>(bp)) & 15) == 0;
  // the warp's 32 * R elements: vector q of lane L holds elements
  // (q * 32 + L) * VW + e, so that each load instruction of the warp reads
  // 512 contiguous bytes
  const long long jw = (long long)blockIdx.x * cta_elems<T>() + (long long)warp * 32 * R;
  T v[Q][VW];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const long long j = jw + (long long)(q * 32 + lane) * VW;
    if (aligned && j + VW <= n) {
      put(v[q], __ldcs(reinterpret_cast<const V*>(ap + j)), __ldcs(reinterpret_cast<const V*>(bp + j)));
    } else {
#pragma unroll
      for (int e = 0; e < VW; ++e) v[q][e] = j + e < n ? mul_rn(__ldcs(ap + j + e), __ldcs(bp + j + e)) : T(0);
    }
  }
  // each vector's own tree (spans 2 .. VW), then the warp's lanes per
  // vector (spans 2 VW .. 32 VW), then lane 0's Q nodes (spans up to 32 R);
  // no add past m
  T acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int lv = 1; (1 << lv) <= VW; ++lv) {
      if ((1 << lv) <= m) {
#pragma unroll
        for (int i = 0; i < VW; i += 1 << lv) v[q][i] = add_rn(v[q][i], v[q][i + (1 << (lv - 1))]);
      }
    }
    acc[q] = warp_tree(v[q][0], VW, m, 32);
  }
#pragma unroll
  for (int lv = 1; (1 << lv) <= Q; ++lv) {
    if ((long long)VW * 32 * (1 << lv) <= m) {
#pragma unroll
      for (int i = 0; i < Q; i += 1 << lv) acc[i] = add_rn(acc[i], acc[i + (1 << (lv - 1))]);
    }
  }
  if (lane == 0) red[warp] = acc[0];
  __syncthreads();
  if (warp == 0) {
    const T w = warp_tree(lane < PA_PW_WARPS ? red[lane] : T(0), (long long)R * 32, m, PA_PW_WARPS);
    if (lane == 0) {
      scratch[(long long)p * nblk + blockIdx.x] = w;
      __threadfence();
      last = atomicAdd(ticket, 1u) == (unsigned int)(nblk * prm.P) - 1u;
    }
  }
  __syncthreads();
  if (!last) return;
  // the last CTA: every other CTA's partial is written and fenced
  __threadfence();
  const T fold = fold_parts(scratch, prm.P, nblk, red);
  if (threadIdx.x == 0) {
    out[0] = fold;
    *ticket = 0u;
  }
}

// ---------------------------------------------------------------------------
// the block form
// ---------------------------------------------------------------------------

// elements a thread of the block form reduces, for each of its columns: one
// 16-byte vector of the CTA's product tile
template <typename T>
__host__ __device__ constexpr int run_block() { return 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ constexpr long long cta_elems_block() { return (long long)run_block<T>() * PA_PW_THREADS; }

template <typename T>
__global__ void __launch_bounds__(PA_PW_THREADS)
pairwise_dot_block_kernel(const PaPairwiseParams prm, const T* __restrict__ a, const T* __restrict__ b,
                          T* __restrict__ scratch, unsigned int* __restrict__ ticket, T* __restrict__ out) {
  constexpr int R = run_block<T>(), KC = PA_PWB_KC, E = (int)cta_elems_block<T>();
  using V = typename Run<T>::V;
  // the CTA's rounded products, column by column (~32 KB); a row is padded
  // by one vector so that a warp's stores of neighbouring (element, column)
  // pairs fall in distinct banks
  __shared__ __align__(16) T prod[KC][E + R];
  __shared__ T red[PA_PW_WARPS * KC];
  __shared__ int last;
  const int p = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = prm.K, k0 = blockIdx.z * KC, kn = K - k0 < KC ? K - k0 : KC;
  const long long n = prm.n, m = prm.m, nblk = gridDim.x;
  const long long jb = (long long)blockIdx.x * E;
  // the tile: element jb + e, column k0 + q at at[e * K + q]. A slab holds an
  // element's K columns side by side, so the tile's kn columns of E
  // elements are E runs of kn values K apart, one contiguous range of E K
  // values when kn = K: the CTA's threads read it value by value in order
  // (value i: element i / kn, column i % kn), each warp 32 neighbouring
  // values
  const T* at = a + ((long long)p * prm.wa + prm.o0 + jb) * K + k0;
  const T* bt = b + ((long long)p * prm.wb + prm.o0 + jb) * K + k0;
  const int ne = n - jb < E ? (int)(n - jb) : E;  // the tile's elements inside the band
  for (int i = threadIdx.x; i < E * kn; i += PA_PW_THREADS) {
    const int e = i / kn, q = i - e * kn;
    prod[q][e] = e < ne ? mul_rn(__ldcs(at + e * K + q), __ldcs(bt + e * K + q)) : T(0);
  }
  __syncthreads();
  // per column: thread t's R products (elements t R .. t R + R - 1, one
  // vector), their tree (spans 2 .. R), then the warp's lanes (spans 2 R ..
  // 32 R); no add past m
#pragma unroll 1
  for (int q = 0; q < kn; ++q) {
    T v[R];
    *reinterpret_cast<V*>(v) = *reinterpret_cast<const V*>(&prod[q][threadIdx.x * R]);
#pragma unroll
    for (int lv = 1; (1 << lv) <= R; ++lv) {
      if ((1 << lv) <= m) {
#pragma unroll
        for (int i = 0; i < R; i += 1 << lv) v[i] = add_rn(v[i], v[i + (1 << (lv - 1))]);
      }
    }
    const T w = warp_tree(v[0], R, m, 32);
    if (lane == 0) red[warp * KC + q] = w;
  }
  __syncthreads();
  // warp q joins the 8 warps' roots of column q (spans up to 256 R)
  if (warp < kn) {
    const T w = warp_tree(lane < PA_PW_WARPS ? red[lane * KC + warp] : T(0), (long long)R * 32, m, PA_PW_WARPS);
    if (lane == 0) {
      scratch[((long long)(k0 + warp) * prm.P + p) * nblk + blockIdx.x] = w;
      __threadfence();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == (unsigned int)(nblk * prm.P * gridDim.z) - 1u;
  __syncthreads();
  if (!last) return;
  // the last CTA: every other CTA's partials are written and fenced
  __threadfence();
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const T fold = fold_parts(scratch + (long long)k * prm.P * nblk, prm.P, nblk, red);
    if (threadIdx.x == 0) out[k] = fold;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T>
static int launch(const PaPairwiseParams* prm, const void* a, const void* b, void* scratch,
                  long long scratch_elems, void* ticket, void* out, void* stream) {
  const long long m = prm->m;
  if (prm->P < 1 || prm->P > 65535 || m < 1 || (m & (m - 1)) != 0 || m < prm->n || prm->n < 0)
    return (int)cudaErrorInvalidValue;
  const long long nblk = m > cta_elems<T>() ? m / cta_elems<T>() : 1;
  if (nblk > 0x7fffffffLL || nblk * prm->P >= 0xffffffffLL || scratch_elems < prm->P * nblk || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)nblk, (unsigned int)prm->P);
  pairwise_dot_kernel<T><<<grid, PA_PW_THREADS, 0, (cudaStream_t)stream>>>(
      *prm, (const T*)a, (const T*)b, (T*)scratch, (unsigned int*)ticket, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_block(const PaPairwiseParams* prm, const void* a, const void* b, void* scratch,
                        long long scratch_elems, void* ticket, void* out, void* stream) {
  const long long m = prm->m;
  if (prm->P < 1 || prm->P > 65535 || prm->K < 1 || m < 1 || (m & (m - 1)) != 0 || m < prm->n || prm->n < 0)
    return (int)cudaErrorInvalidValue;
  const long long nblk = m > cta_elems_block<T>() ? m / cta_elems_block<T>() : 1;
  const long long chunks = (prm->K + PA_PWB_KC - 1) / PA_PWB_KC;
  if (nblk > 0x7fffffffLL || chunks > 65535 || nblk * prm->P * chunks >= 0xffffffffLL ||
      scratch_elems < (long long)prm->K * prm->P * nblk || ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)nblk, (unsigned int)prm->P, (unsigned int)chunks);
  pairwise_dot_block_kernel<T><<<grid, PA_PW_THREADS, 0, (cudaStream_t)stream>>>(
      *prm, (const T*)a, (const T*)b, (T*)scratch, (unsigned int*)ticket, (T*)out);
  return (int)cudaGetLastError();
}

extern "C" {

// a, b: (P, W) frames; scratch: the partials, at least P * max(1, m / E)
// elements (E = 4096 in f32, 2048 in f64); ticket: one uint32, zero at the launch
// and left zero, used by no dot in flight at the same time; out: one
// element, the dot.
int pa_pairwise_dot_f32(const PaPairwiseParams* prm, const void* a, const void* b, void* scratch,
                        long long scratch_elems, void* ticket, void* out, void* stream) {
  return launch<float>(prm, a, b, scratch, scratch_elems, ticket, out, stream);
}

int pa_pairwise_dot_f64(const PaPairwiseParams* prm, const void* a, const void* b, void* scratch,
                        long long scratch_elems, void* ticket, void* out, void* stream) {
  return launch<double>(prm, a, b, scratch, scratch_elems, ticket, out, stream);
}

// the block form: a, b: (P, W, K) slabs; scratch: at least K * P * max(1,
// m / E) elements (E = 1024 in f32, 512 in f64: 256 threads of one 16-byte
// vector, cta_elems_block); ticket as above; out: K elements, the dot of
// each column.
int pa_pairwise_dot_block_f32(const PaPairwiseParams* prm, const void* a, const void* b, void* scratch,
                              long long scratch_elems, void* ticket, void* out, void* stream) {
  return launch_block<float>(prm, a, b, scratch, scratch_elems, ticket, out, stream);
}

int pa_pairwise_dot_block_f64(const PaPairwiseParams* prm, const void* a, const void* b, void* scratch,
                              long long scratch_elems, void* ticket, void* out, void* stream) {
  return launch_block<double>(prm, a, b, scratch, scratch_elems, ticket, out, stream);
}

}  // extern "C"
