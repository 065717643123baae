// Matrix-free interpolation stencil of the multigrid transfers, for Hopper
// (sm_90a): y = S x over the stacked parts of a box layout.
//
// No TPU kernel stands behind it: it is the counterpart of the XLA fusion of
// `_stencil_apply` in partitionedarrays_jl_tpu/parallel/tpu_gmg.py:292-319,
// about 60 slice ops that XLA fuses into a few loops over each part's
// extended box. Run eagerly they would be about 60 launches per apply.
//
// What it computes, per part p and owned point c of its box fb:
//   the part's owned box (C order, at o0 of the operand frame) and the ghost
//   segments of the box exchange (at g0 + off of the same frame) form the
//   zero-padded extended box ext, (fb + 2)^d; then
//     y[p, c] = sum over delta in {-1,0,1}^d (ascending, the first dimension
//               slowest, as np.ndindex) of 0.5^|delta|_0 * ext[c + delta]
//   A level of fewer dimensions runs as a 3-D box with leading extents 1:
//   its table has no segment in a direction along a padded axis, so the
//   extra terms are exact zeros and the sum equals the d-dimensional one
//   (up to the sign of a zero). An ext cell outside the box in
//   direction e (a face, edge or corner) is segment e's value at its
//   position in the segment's C-order shape (1 along e's nonzero axes, fb
//   elsewhere); a direction the plan has no segment for reads 0 (the zero
//   pad beyond the global boundary); with a mask (periodic partitions) the
//   value is multiplied by the part's mask of e (0 for a wrapped segment).
//   Slots past the part's owned count, up to the result width n, are 0.
//
// Table, per part (PA_STENCIL_TABLE ints): fb[3] (padded with leading 1s to
// three dimensions), the owned count, then the segment offset of each of the
// 27 three-dimensional directions (index (e0+1)*9 + (e1+1)*3 + (e2+1)), -1
// where the plan has none.
//
// Rounding: every product and sum is __fmul_rn / __fadd_rn (no FMA
// contraction) in the plain version's order (ops/stencil.py), so the two
// agree value for value; the weights are powers of 2, the products exact.
//
// Bound: memory. At 192^3 f32 on one part it reads x's owned box (28.3 MB)
// and writes y (28.3 MB): 56.6 MB, about 17 us at 3.35 TB/s; 52 flops a
// point are far below the f32 rate.
//
// Design. A CTA owns a tile of TY rows by
// TX points of one part's box (a warp along the last axis) and marches along
// the first axis over tz planes, keeping the three ext planes it needs, each
// with its one-cell rim, in a shared-memory ring; each step sums a plane's 27
// terms a thread from shared memory while the plane after next is fetched
// into registers (every ext cell resolved as above, the rim from the
// segments), then stores it into the ring. Global reads per output point:
// about 1.5 at tz = 16 (the rim, and the planes above and below a chunk).
// The wrapper takes tz = 16 where that fills the card with CTAs and 4 on
// the small coarse levels. A first form, one thread per 3-D point reading its 27 terms
// through the read-only cache, ran at 6-9% of the bound at 192^3 f32 on an
// H100 (L1 did not hold the reuse).

#include <cstdint>
#include <cuda_runtime.h>

#define PA_STENCIL_TABLE 32
#define PA_TX 32
#define PA_TY 8
// cells of a staged plane (the tile and its rim) and how many each thread
// stages
#define PA_CELLS ((PA_TY + 2) * (PA_TX + 2))
#define PA_PER_THREAD ((PA_CELLS + PA_TX * PA_TY - 1) / (PA_TX * PA_TY))

struct PaStencilParams {
  int P;          // stacked parts
  long long wx;   // operand frame width
  long long n;    // result width (the owned band, >= every owned count)
  long long o0;   // owned offset in the operand frame
  long long g0;   // ghost-region offset in the operand frame
  int fmax[3];    // the largest box extent over the parts, per axis
  int tz;         // planes a CTA of the tiled kernel marches through
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ int side(int c, int f) { return c < 0 ? -1 : (c >= f ? 1 : 0); }

// 0.5^nz for nz = 1, 2, 3 nonzero offsets (nz = 0 takes no product)
template <typename T>
__device__ __forceinline__ T weight(int nz) { return nz == 1 ? T(0.5) : (nz == 2 ? T(0.25) : T(0.125)); }

// ext[n0, n1, n2] of one part, each n_j in [-1, f_j]
template <typename T>
__device__ __forceinline__ T ext_value(const PaStencilParams& prm, const int32_t* tb, const T* xp,
                                       const T* mp, int f0, int f1, int f2, int n0, int n1, int n2) {
  const int e0 = side(n0, f0), e1 = side(n1, f1), e2 = side(n2, f2);
  if ((e0 | e1 | e2) == 0) return __ldg(xp + prm.o0 + ((long long)n0 * f1 + n1) * f2 + n2);
  const int k = (e0 + 1) * 9 + (e1 + 1) * 3 + (e2 + 1);
  const int off = tb[4 + k];
  if (off < 0) return T(0);
  const int s1 = e1 ? 1 : f1, s2 = e2 ? 1 : f2;
  const int q0 = e0 ? 0 : n0, q1 = e1 ? 0 : n1, q2 = e2 ? 0 : n2;
  T v = __ldg(xp + prm.g0 + off + ((long long)q0 * s1 + q1) * s2 + q2);
  if (mp != nullptr) v = mul_rn(v, __ldg(mp + k));
  return v;
}

// ring slot of plane n0 >= -1
__device__ __forceinline__ int slot(int n0) { return (n0 + 3) % 3; }

// this thread's cells of ext plane n0 of the tile at (y0, x0) with its rim
// into registers; cells past the box's far rim are not read
template <typename T>
__device__ __forceinline__ void fetch_plane(T* pre, const PaStencilParams& prm, const int32_t* tb,
                                            const T* xp, const T* mp, int f0, int f1, int f2, int n0,
                                            int y0, int x0, int tid) {
#pragma unroll
  for (int j = 0; j < PA_PER_THREAD; ++j) {
    const int e = tid + j * PA_TX * PA_TY;
    if (e < PA_CELLS) {
      const int ly = e / (PA_TX + 2), lx = e - ly * (PA_TX + 2);
      const int n1 = y0 + ly - 1, n2 = x0 + lx - 1;
      pre[j] = (n1 <= f1 && n2 <= f2) ? ext_value<T>(prm, tb, xp, mp, f0, f1, f2, n0, n1, n2) : T(0);
    }
  }
}

template <typename T>
__device__ __forceinline__ void put_plane(T (*plane)[PA_TX + 2], const T* pre, int tid) {
#pragma unroll
  for (int j = 0; j < PA_PER_THREAD; ++j) {
    const int e = tid + j * PA_TX * PA_TY;
    if (e < PA_CELLS) plane[e / (PA_TX + 2)][e % (PA_TX + 2)] = pre[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(PA_TX * PA_TY)
box_stencil_tiled_kernel(const PaStencilParams prm, const int32_t* __restrict__ table,
                         const T* __restrict__ mask, const T* __restrict__ x, T* __restrict__ y) {
  __shared__ T ring[3][PA_TY + 2][PA_TX + 2];
  const int nzb = (prm.fmax[0] + prm.tz - 1) / prm.tz;
  const int p = blockIdx.z / nzb, zb = blockIdx.z % nzb;
  const int tid = threadIdx.y * PA_TX + threadIdx.x;
  const int32_t* tb = table + (long long)p * PA_STENCIL_TABLE;
  const int f0 = tb[0], f1 = tb[1], f2 = tb[2];
  T* yp = y + (long long)p * prm.n;
  {
    // the part's CTAs share the zero tail [owned count, n)
    const long long nb = (long long)gridDim.x * gridDim.y * nzb;
    const long long b = ((long long)zb * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    for (long long t = tb[3] + b * (PA_TX * PA_TY) + tid; t < prm.n; t += nb * (PA_TX * PA_TY)) yp[t] = T(0);
  }
  const int x0 = blockIdx.x * PA_TX, y0 = blockIdx.y * PA_TY, z0 = zb * prm.tz;
  if (x0 >= f2 || y0 >= f1 || z0 >= f0) return;  // the whole CTA: past this part's box
  const int z1 = min(z0 + prm.tz, f0);
  const T* xp = x + (long long)p * prm.wx;
  const T* mp = mask == nullptr ? nullptr : mask + (long long)p * 27;
  const int c1 = y0 + threadIdx.y, c2 = x0 + threadIdx.x;
  T pre[PA_PER_THREAD];
  for (int n0 = z0 - 1; n0 <= z0 + 1; ++n0) {
    fetch_plane<T>(pre, prm, tb, xp, mp, f0, f1, f2, n0, y0, x0, tid);
    put_plane<T>(ring[slot(n0)], pre, tid);
  }
  __syncthreads();
  for (int c0 = z0; c0 < z1; ++c0) {
    // the plane after next is fetched while this one is summed
    const bool more = c0 + 1 < z1;
    if (more) fetch_plane<T>(pre, prm, tb, xp, mp, f0, f1, f2, c0 + 2, y0, x0, tid);
    if (c1 < f1 && c2 < f2) {
      T acc = T(0);
#pragma unroll
      for (int d0 = -1; d0 <= 1; ++d0) {
        T(*plane)[PA_TX + 2] = ring[slot(c0 + d0)];
#pragma unroll
        for (int d1 = -1; d1 <= 1; ++d1) {
#pragma unroll
          for (int d2 = -1; d2 <= 1; ++d2) {
            const T v = plane[threadIdx.y + 1 + d1][threadIdx.x + 1 + d2];
            const int nz = (d0 != 0) + (d1 != 0) + (d2 != 0);
            const T term = nz == 0 ? v : mul_rn(weight<T>(nz), v);
            acc = (d0 == -1 && d1 == -1 && d2 == -1) ? term : add_rn(acc, term);
          }
        }
      }
      yp[((long long)c0 * f1 + c1) * f2 + c2] = acc;
    }
    if (more) {
      __syncthreads();  // plane c0 - 1 is read: its slot takes plane c0 + 2
      put_plane<T>(ring[slot(c0 + 2)], pre, tid);
      __syncthreads();
    }
  }
}

template <typename T>
static int launch(const PaStencilParams* prm, const void* table, const void* mask,
                  const void* x, void* y, void* stream) {
  const int nzb = (prm->fmax[0] + prm->tz - 1) / prm->tz;
  dim3 grid((unsigned int)((prm->fmax[2] + PA_TX - 1) / PA_TX),
            (unsigned int)((prm->fmax[1] + PA_TY - 1) / PA_TY), (unsigned int)(nzb * prm->P));
  box_stencil_tiled_kernel<T><<<grid, dim3(PA_TX, PA_TY), 0, (cudaStream_t)stream>>>(
      *prm, (const int32_t*)table, (const T*)mask, (const T*)x, (T*)y);
  return (int)cudaGetLastError();
}

extern "C" {

int pa_box_stencil_f32(const PaStencilParams* prm, const void* table, const void* mask,
                       const void* x, void* y, void* stream) {
  return launch<float>(prm, table, mask, x, y, stream);
}

int pa_box_stencil_f64(const PaStencilParams* prm, const void* table, const void* mask,
                       const void* x, void* y, void* stream) {
  return launch<double>(prm, table, mask, x, y, stream);
}

}  // extern "C"
