// Native planning kernels: the hot host-side loops of the planning phase.
//
// The reference is pure Julia — its compiled loops make index planning
// cheap by construction. Python/NumPy planning pays one full array
// temporary per operator, which dominates assembly at 1e7+ DOFs; these
// fused single-pass loops restore compiled-language planning cost. The
// compute path (the CUDA kernels) is unaffected: this is host metadata work
// only, the analog of the reference's in-process index arithmetic
// (reference: src/IndexSets.jl:109-213, src/SparseUtils.jl:44-88).
//
// Contract notes:
// * gids are int64, lids int32 (INDEX_DTYPE), -1 = absent.
// * All functions are single-threaded (planning runs per part on one
//   controller core) and allocation-free: callers pass NumPy buffers.
#include <cmath>
#include <cstdint>
#include <algorithm>
#include <numeric>
#include <utility>
#include <vector>

// COO -> CSR with column-sorted rows and +-combined duplicates, one
// counting pass + one scatter + per-row small sorts — replaces the NumPy
// argsort + three 1e8-element gathers. `cursor` is caller scratch (m
// int32). Returns the compacted nnz. Stability: the scatter preserves
// arrival order per row; the per-row sort is stable; duplicate groups
// accumulate left-to-right — bit-identical to the reduceat fallback.
template <typename TI, typename T>
static int64_t coo_to_csr_impl(const TI* I, const TI* J,
                               const T* V, int64_t nnz, int64_t m,
                               int32_t* indptr, int32_t* cols_out,
                               T* vals_out, int32_t* cursor) {
    for (int64_t r = 0; r <= m; ++r) indptr[r] = 0;
    for (int64_t k = 0; k < nnz; ++k) ++indptr[I[k] + 1];
    for (int64_t r = 0; r < m; ++r) indptr[r + 1] += indptr[r];
    for (int64_t r = 0; r < m; ++r) cursor[r] = indptr[r];
    for (int64_t k = 0; k < nnz; ++k) {
        int32_t p = cursor[I[k]]++;
        cols_out[p] = (int32_t)J[k];  // caller guarantees n < 2^31
        vals_out[p] = V[k];
    }
    int64_t w = 0;
    for (int64_t r = 0; r < m; ++r) {
        int64_t s = indptr[r], e = cursor[r];
        if (e - s > 64) {  // long row: stable comparison sort on (col, pos)
            std::vector<std::pair<int32_t, int64_t>> tmp;
            tmp.reserve(e - s);
            for (int64_t a = s; a < e; ++a) tmp.emplace_back(cols_out[a], a);
            std::stable_sort(tmp.begin(), tmp.end(),
                             [](const auto& x, const auto& y) {
                                 return x.first < y.first;
                             });
            std::vector<T> vtmp(e - s);
            for (int64_t a = s; a < e; ++a) vtmp[a - s] = vals_out[a];
            for (int64_t a = s; a < e; ++a) {
                cols_out[a] = tmp[a - s].first;
                vals_out[a] = vtmp[tmp[a - s].second - s];
            }
        } else {
            for (int64_t a = s + 1; a < e; ++a) {  // stable insertion sort
                int32_t c = cols_out[a];
                T v = vals_out[a];
                int64_t b = a;
                while (b > s && cols_out[b - 1] > c) {
                    cols_out[b] = cols_out[b - 1];
                    vals_out[b] = vals_out[b - 1];
                    --b;
                }
                cols_out[b] = c;
                vals_out[b] = v;
            }
        }
        int64_t row_w = w;  // compact + merge duplicates (w <= a always)
        for (int64_t a = s; a < e; ++a) {
            if (w > row_w && cols_out[w - 1] == cols_out[a]) {
                vals_out[w - 1] += vals_out[a];
            } else {
                cols_out[w] = cols_out[a];
                vals_out[w] = vals_out[a];
                ++w;
            }
        }
        indptr[r] = (int32_t)row_w;
    }
    indptr[m] = (int32_t)w;
    return w;
}


// Split a full-row CSR by a column threshold into (cols < thr) and
// (cols >= thr, remapped by -thr) halves in one routing pass — the
// materialized owned|ghost block views. Caller sizes the outputs from a
// NumPy count; indptrs are written here.
template <typename T>
static void csr_split_impl(const int32_t* indptr, const int32_t* cols,
                           const T* vals, int64_t m, int32_t thr,
                           int32_t* ip_lo, int32_t* c_lo, T* v_lo,
                           int32_t* ip_hi, int32_t* c_hi, T* v_hi) {
    int64_t wl = 0, wh = 0;
    ip_lo[0] = ip_hi[0] = 0;
    for (int64_t r = 0; r < m; ++r) {
        for (int32_t a = indptr[r]; a < indptr[r + 1]; ++a) {
            if (cols[a] < thr) {
                c_lo[wl] = cols[a];
                v_lo[wl++] = vals[a];
            } else {
                c_hi[wh] = cols[a] - thr;
                v_hi[wh++] = vals[a];
            }
        }
        ip_lo[r + 1] = (int32_t)wl;
        ip_hi[r + 1] = (int32_t)wh;
    }
}


// Fused N-D "box" gid -> lid: decompose gid in the global grid, test the
// owned box [lo, hi), emit the C-order local id or -1 — one pass, no
// temporaries. ndim <= 8. Templated on the gid width so int32 COO
// batches (any grid < 2^31 cells) avoid an n-sized conversion copy.
template <typename TG>
static void box_gids_to_lids_impl(const TG* gids, int64_t n,
                                  const int64_t* grid, const int64_t* lo,
                                  const int64_t* hi, int32_t ndim,
                                  int32_t* out) {
    int64_t stride[8];   // global-grid C-order strides
    int64_t bstride[8];  // box C-order strides
    int64_t total = 1;
    for (int32_t d = ndim - 1; d >= 0; --d) {
        stride[d] = total;
        total *= grid[d];
    }
    int64_t btotal = 1;
    for (int32_t d = ndim - 1; d >= 0; --d) {
        bstride[d] = btotal;
        btotal *= hi[d] - lo[d];
    }
    for (int64_t i = 0; i < n; ++i) {
        int64_t g = (int64_t)gids[i];
        if (g < 0 || g >= total) {
            out[i] = -1;
            continue;
        }
        int64_t lid = 0;
        bool owned = true;
        for (int32_t d = 0; d < ndim; ++d) {
            int64_t c = g / stride[d];
            g -= c * stride[d];
            if (c < lo[d] || c >= hi[d]) {
                owned = false;
                break;
            }
            lid += (c - lo[d]) * bstride[d];
        }
        out[i] = owned ? (int32_t)lid : -1;
    }
}

// Binary-search gid -> lid over a sorted ghost table (see the extern
// wrapper below), templated like the box kernel.
template <typename TG>
static int64_t lookup_sorted_impl(const TG* gids, int64_t n,
                                  const int64_t* sorted_gids,
                                  const int32_t* lid_of, int64_t m,
                                  int32_t* out) {
    int64_t misses = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (out[i] >= 0) continue;
        const int64_t g = (int64_t)gids[i];
        const int64_t* p = std::lower_bound(sorted_gids, sorted_gids + m, g);
        if (p != sorted_gids + m && *p == g) {
            out[i] = lid_of[p - sorted_gids];
        } else {
            ++misses;
        }
    }
    return misses;
}

extern "C" {

void pa_box_gids_to_lids(const int64_t* gids, int64_t n,
                         const int64_t* grid, const int64_t* lo,
                         const int64_t* hi, int32_t ndim, int32_t* out) {
    box_gids_to_lids_impl<int64_t>(gids, n, grid, lo, hi, ndim, out);
}

void pa_box_gids_to_lids_i32(const int32_t* gids, int64_t n,
                             const int64_t* grid, const int64_t* lo,
                             const int64_t* hi, int32_t ndim,
                             int32_t* out) {
    box_gids_to_lids_impl<int32_t>(gids, n, grid, lo, hi, ndim, out);
}

// Binary-search gid -> lid over a sorted ghost table, writing lid_of[pos]
// on hit; entries already >= 0 in `out` (resolved by a cheaper path) are
// left untouched. Returns the number of misses remaining.
int64_t pa_lookup_sorted(const int64_t* gids, int64_t n,
                         const int64_t* sorted_gids, const int32_t* lid_of,
                         int64_t m, int32_t* out) {
    return lookup_sorted_impl<int64_t>(gids, n, sorted_gids, lid_of, m, out);
}

int64_t pa_lookup_sorted_i32(const int32_t* gids, int64_t n,
                             const int64_t* sorted_gids,
                             const int32_t* lid_of, int64_t m,
                             int32_t* out) {
    return lookup_sorted_impl<int32_t>(gids, n, sorted_gids, lid_of, m, out);
}

int64_t pa_coo_to_csr_f64(const int32_t* I, const int32_t* J,
                          const double* V, int64_t nnz, int64_t m,
                          int32_t* indptr, int32_t* cols_out,
                          double* vals_out, int32_t* cursor) {
    return coo_to_csr_impl(I, J, V, nnz, m, indptr, cols_out, vals_out,
                           cursor);
}

int64_t pa_coo_to_csr_f32(const int32_t* I, const int32_t* J,
                          const float* V, int64_t nnz, int64_t m,
                          int32_t* indptr, int32_t* cols_out,
                          float* vals_out, int32_t* cursor) {
    return coo_to_csr_impl(I, J, V, nnz, m, indptr, cols_out, vals_out,
                           cursor);
}

int64_t pa_coo_to_csr_i64_f64(const int64_t* I, const int64_t* J,
                              const double* V, int64_t nnz, int64_t m,
                              int32_t* indptr, int32_t* cols_out,
                              double* vals_out, int32_t* cursor) {
    return coo_to_csr_impl(I, J, V, nnz, m, indptr, cols_out, vals_out,
                           cursor);
}

int64_t pa_coo_to_csr_i64_f32(const int64_t* I, const int64_t* J,
                              const float* V, int64_t nnz, int64_t m,
                              int32_t* indptr, int32_t* cols_out,
                              float* vals_out, int32_t* cursor) {
    return coo_to_csr_impl(I, J, V, nnz, m, indptr, cols_out, vals_out,
                           cursor);
}

void pa_csr_split_f64(const int32_t* indptr, const int32_t* cols,
                      const double* vals, int64_t m, int32_t thr,
                      int32_t* ip_lo, int32_t* c_lo, double* v_lo,
                      int32_t* ip_hi, int32_t* c_hi, double* v_hi) {
    csr_split_impl(indptr, cols, vals, m, thr, ip_lo, c_lo, v_lo, ip_hi,
                   c_hi, v_hi);
}

void pa_csr_split_f32(const int32_t* indptr, const int32_t* cols,
                      const float* vals, int64_t m, int32_t thr,
                      int32_t* ip_lo, int32_t* c_lo, float* v_lo,
                      int32_t* ip_hi, int32_t* c_hi, float* v_hi) {
    csr_split_impl(indptr, cols, vals, m, thr, ip_lo, c_lo, v_lo, ip_hi,
                   c_hi, v_hi);
}

// Distinct values of a double array when there are at most K of them:
// one linear pass against a tiny table — replaces an O(n log n)
// np.unique sort over 1e8-element stencil diagonals. Returns the count,
// or -1 as soon as a (K+1)-th distinct value appears. The table is
// written UNSORTED (caller sorts the <= K values).
int64_t pa_unique_small_f64(const double* vals, int64_t n, int64_t K,
                            double* table) {
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; ++i) {
        double v = vals[i];
        bool found = false;
        for (int64_t k = 0; k < cnt; ++k) {
            if (table[k] == v) {
                found = true;
                break;
            }
        }
        if (!found) {
            if (cnt == K) return -1;
            table[cnt++] = v;
        }
    }
    return cnt;
}

// Row classes of a (D, n) C-order diagonal-value matrix: distinct
// D-tuples across rows, at most K of them. Emits codes[r] = class id
// (first-touch order) and class_table (K x D, row-major). Tiled so the
// strided per-diagonal reads stay cache-resident. Returns the class
// count or -1 when a (K+1)-th class appears.
int64_t pa_row_classes_f64(const double* dia, int64_t D, int64_t n,
                           int64_t stride, int64_t K, double* class_table,
                           uint8_t* codes) {
    const int64_t TILE = 4096;
    std::vector<double> buf(TILE * D);
    int64_t cnt = 0;
    for (int64_t r0 = 0; r0 < n; r0 += TILE) {
        int64_t len = std::min(TILE, n - r0);
        for (int64_t d = 0; d < D; ++d)  // sequential reads per diagonal
            for (int64_t i = 0; i < len; ++i)
                buf[i * D + d] = dia[d * stride + r0 + i];
        for (int64_t i = 0; i < len; ++i) {
            const double* row = &buf[i * D];
            int64_t hit = -1;
            for (int64_t k = 0; k < cnt; ++k) {
                const double* c = &class_table[k * D];
                bool eq = true;
                for (int64_t d = 0; d < D; ++d) {
                    if (c[d] != row[d]) {
                        eq = false;
                        break;
                    }
                }
                if (eq) {
                    hit = k;
                    break;
                }
            }
            if (hit < 0) {
                if (cnt == K) return -1;
                for (int64_t d = 0; d < D; ++d)
                    class_table[cnt * D + d] = row[d];
                hit = cnt++;
            }
            codes[r0 + i] = (uint8_t)hit;
        }
    }
    return cnt;
}


// Zero-fill incomplete Cholesky IC(0) of a symmetric matrix given as its
// LOWER triangle (diagonal included) in CSR with column-sorted rows.
// a_vals in, l_vals out (same pattern). The intersection sum per entry is
// a two-pointer merge over the column-sorted rows. Returns 0 on success,
// -(i+1) when row i's pivot is non-positive (caller shifts or falls back).
int64_t pa_ic0_f64(const int32_t* indptr, const int32_t* cols,
                   const double* a_vals, int64_t n, double* l_vals) {
    for (int64_t i = 0; i < n; ++i) {
        const int32_t s_i = indptr[i], e_i = indptr[i + 1];
        if (e_i == s_i || cols[e_i - 1] != (int32_t)i) return -(i + 1);
        for (int32_t idx = s_i; idx < e_i; ++idx) {
            const int32_t j = cols[idx];
            // sum_{k in pattern(i) cap pattern(j), k < j} L[i,k]*L[j,k]
            double s = a_vals[idx];
            int32_t pi = s_i, pj = indptr[j];
            const int32_t ej = indptr[j + 1];
            while (pi < idx && pj < ej - 1) {  // strictly below j
                const int32_t ci = cols[pi], cj = cols[pj];
                if (ci == cj) {
                    if (ci >= j) break;
                    s -= l_vals[pi] * l_vals[pj];
                    ++pi;
                    ++pj;
                } else if (ci < cj) {
                    ++pi;
                } else {
                    ++pj;
                }
            }
            if (j < (int32_t)i) {
                const double d = l_vals[ej - 1];  // L[j,j], already done
                l_vals[idx] = s / d;
            } else {
                if (s <= 0.0) return -(i + 1);
                l_vals[idx] = sqrt(s);
            }
        }
    }
    return 0;
}

}  // extern "C"

// Extract the (cols >= thr) side of a column-sorted full-row CSR as its
// own CSR (columns remapped by -thr) WITHOUT materializing the lo side
// — see pa_count_ge above for the sizing pass.
template <typename T>
static void csr_extract_hi_impl(const int32_t* indptr, const int32_t* cols,
                                const T* vals, int64_t m, int32_t thr,
                                int32_t* ip_hi, int32_t* c_hi, T* v_hi) {
    int64_t w = 0;
    ip_hi[0] = 0;
    for (int64_t r = 0; r < m; ++r) {
        for (int32_t a = indptr[r]; a < indptr[r + 1]; ++a) {
            if (cols[a] >= thr) {
                c_hi[w] = cols[a] - thr;
                v_hi[w++] = vals[a];
            }
        }
        ip_hi[r + 1] = (int32_t)w;
    }
}

// Fused host CSR SpMV y = A x: one pass over (cols, vals), no nnz-sized
// product temporary (the NumPy form materializes x[cols], multiplies,
// then reduceat-scans — three volume passes and ~2 nnz-sized
// temporaries; at 7e8 nnz that is >10 GB of traffic this loop never
// touches). Row accumulation is left-to-right in stored (column-sorted)
// order — the same order reduceat contracts, to rounding.
template <typename T>
static void csr_spmv_impl(const int32_t* indptr, const int32_t* cols,
                          const T* vals, int64_t m, const T* x, T* y) {
    for (int64_t i = 0; i < m; ++i) {
        T acc = 0;
        for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k)
            acc += vals[k] * x[cols[k]];
        y[i] = acc;
    }
}

// Fused dense-diagonal fill for the DIA detection/staging pass: for each
// stored entry (i, j, v) of a CSR block, dia[lookup(j - i) * stride + i]
// = v. Offsets are few (<=64) and sorted; a branchless linear probe from
// the previous hit beats binary search (stencil entries arrive in
// ascending per-row column order). Returns 0, or -1 when some j - i is
// not in `offsets` (caller falls back).
template <typename T>
static int64_t dia_fill_impl(const int32_t* indptr, const int32_t* cols,
                             const T* vals, int64_t m,
                             const int64_t* offsets, int64_t D,
                             int64_t stride, double* dia) {
    for (int64_t i = 0; i < m; ++i) {
        int64_t d = 0;
        for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            const int64_t off = (int64_t)cols[k] - i;
            if (offsets[d] != off) {
                // re-seek (rows visit offsets in ascending order, so
                // this loop usually advances 0 or 1 step)
                d = 0;
                while (d < D && offsets[d] < off) ++d;
                if (d >= D || offsets[d] != off) return -1;
            }
            dia[d * stride + i] = (double)vals[k];
            if (d + 1 < D) ++d;
        }
    }
    return 0;
}

// Distinct band offsets (j - i) of a column-sorted CSR in one pass —
// replaces the astype + row_of_nz repeat + np.unique sort over nnz
// entries that dominated the band-detection phase of device lowering.
// The tiny sorted table is probed from the previous hit first (rows of
// a stencil operator visit offsets in the same ascending order, so
// steady state is a sequential hit per entry); misses binary-search +
// insert. Returns the count, or -1 as soon as a (K+1)-th distinct
// offset appears.
static int64_t band_offsets_impl(const int32_t* indptr, const int32_t* cols,
                                 int64_t m, int64_t K, int64_t* out,
                                 int64_t col_limit) {
    int64_t cnt = 0;
    for (int64_t i = 0; i < m; ++i) {
        int64_t d = 0;
        for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            if (cols[k] >= col_limit) break;  // sorted: ghost tail starts
            const int64_t off = (int64_t)cols[k] - i;
            if (d < cnt && out[d] == off) {
                ++d;
                continue;
            }
            int64_t lo = 0, hi = cnt;
            while (lo < hi) {
                const int64_t mid = (lo + hi) >> 1;
                if (out[mid] < off) lo = mid + 1; else hi = mid;
            }
            if (lo < cnt && out[lo] == off) {
                d = lo + 1;
                continue;
            }
            if (cnt == K) return -1;
            for (int64_t t = cnt; t > lo; --t) out[t] = out[t - 1];
            out[lo] = off;
            ++cnt;
            d = lo + 1;
        }
    }
    return cnt;
}

// Fused row-class detection for the coded-DIA lowering, WITHOUT the
// dense (D, n) diagonal matrix: one pass over the CSR builds each row's
// D-tuple of diagonal values (absent diagonals 0) in a stack buffer and
// matches it against a first-touch class table — the same classes, in
// the same first-touch order, as dia_fill + pa_row_classes_f64, minus
// the O(D * n) materialization + refill traffic (5.6 GB at 1e8 DOFs).
// Returns the class count; -1 when an entry's offset is missing from
// `offsets` (caller's offset set must be the union it just computed);
// -2 when a (K+1)-th class appears (caller falls back to the dense
// path, which also serves the streaming-DIA staging).
template <typename T>
static int64_t dia_classify_impl(const int32_t* indptr, const int32_t* cols,
                                 const T* vals, int64_t m,
                                 const int64_t* offsets, int64_t D,
                                 int64_t K, double* class_table,
                                 uint8_t* codes, int64_t col_limit) {
    double row[64];  // D <= DIA_MAX_OFFSETS = 64
    if (D > 64) return -1;
    int64_t cnt = 0, last = 0;
    auto match = [&](int64_t c) {
        const double* t = &class_table[c * D];
        for (int64_t q = 0; q < D; ++q)
            if (t[q] != row[q]) return false;
        return true;
    };
    for (int64_t i = 0; i < m; ++i) {
        for (int64_t d = 0; d < D; ++d) row[d] = 0.0;
        int64_t d = 0;
        for (int32_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            if (cols[k] >= col_limit) break;  // sorted: ghost tail starts
            const int64_t off = (int64_t)cols[k] - i;
            if (!(d < D && offsets[d] == off)) {
                d = 0;
                while (d < D && offsets[d] < off) ++d;
                if (d >= D || offsets[d] != off) return -1;
            }
            row[d] = (double)vals[k];
            if (d + 1 < D) ++d;
        }
        // consecutive rows usually share a class (C-order runs), so the
        // previous hit is probed first; the table scan only runs on
        // class-change rows, keeping the pass O(n) even near the cap
        int64_t hit = -1;
        if (last < cnt && match(last)) {
            hit = last;
        } else {
            for (int64_t c = 0; c < cnt; ++c) {
                if (c != last && match(c)) {
                    hit = c;
                    break;
                }
            }
        }
        if (hit < 0) {
            if (cnt == K) return -2;
            for (int64_t q = 0; q < D; ++q)
                class_table[cnt * D + q] = row[q];
            hit = cnt++;
        }
        codes[i] = (uint8_t)hit;
        last = hit;
    }
    return cnt;
}

// Per-part Galerkin triple product A_c = P^T A P for the d-linear
// Cartesian interpolation (d <= 3), as a direct stencil collapse: for
// every OWNED fine row i, for every stored entry A[i, j], scatter
// w(i->c1) * A_ij * w(j->c2) into the dense 3^d-diagonal accumulator at
// coarse point c1, diagonal e = c2 - c1. The 3^d closure is exact: the
// d-linear P moves any fine offset with |o_d| <= 1 into |e_d| <= 1, and
// Galerkin coarse operators stay within the 3^d cube forever. Weights
// follow the same per-dimension rule as the Python _interp_1d (even
// fine points coincide with coarse f/2; odd average their neighbors;
// the trailing odd point of an even-sized dim DROPS the out-of-range
// weight). Contributions to coarse rows outside [elo, ehi) cannot
// happen by construction (ext box sized by the caller); entries whose
// fine column offset leaves the +-1 cube return -1 (caller falls back
// to the generic sparse product).
// The accumulator is POS-MAJOR — out[pos * 3^d + e] — so each fine
// row's scatters land in <= 8 contiguous 3^d-double blocks and the
// downstream emission reads each coarse row's diagonals as one
// contiguous block (the e-major layout made both a 27-plane strided
// scatter/gather, ~3x slower end-to-end at 1e8 DOFs).
// DIM is a compile-time parameter so the per-entry loops fully unroll
// (the runtime-dim version measured ~8.6 ns per weight pair; the
// specialized one removes the dim>k ternaries and bounds the loops).
template <typename T, int DIM>
static int64_t galerkin3_dim(const int32_t* indptr, const int32_t* cols,
                             const T* vals, int64_t no,
                             const int64_t* lid_gid, const int64_t* fdims,
                             const int64_t* flo, const int64_t* fhi,
                             const int64_t* cdims, const int64_t* elo,
                             const int64_t* ehi, double* out,
                             const int64_t* sub_coords = nullptr,
                             const int64_t* sub_counts = nullptr) {
    int64_t fstride[DIM], estride[DIM], ebox[DIM], fbox[DIM], bstride[DIM];
    for (int d = 0; d < DIM; ++d) ebox[d] = ehi[d] - elo[d];
    fstride[DIM - 1] = 1;
    estride[DIM - 1] = 1;
    for (int d = DIM - 2; d >= 0; --d) {
        fstride[d] = fstride[d + 1] * fdims[d + 1];
        estride[d] = estride[d + 1] * ebox[d + 1];
    }
    int64_t esize = 1;
    for (int d = 0; d < DIM; ++d) esize *= ebox[d];
    (void)esize;
    for (int d = 0; d < DIM; ++d) fbox[d] = fhi[d] - flo[d];
    bstride[DIM - 1] = 1;
    for (int d = DIM - 2; d >= 0; --d)
        bstride[d] = bstride[d + 1] * fbox[d + 1];
    auto interp1 = [&](int64_t f, int64_t nc, int64_t* k, double* w) {
        if ((f & 1) == 0) {
            k[0] = f >> 1;
            w[0] = 1.0;
            return 1;
        }
        int n = 0;
        k[n] = (f - 1) >> 1;
        w[n++] = 0.5;
        if (((f + 1) >> 1) <= nc - 1) {
            k[n] = (f + 1) >> 1;
            w[n++] = 0.5;
        }
        return n;
    };
    // per-row P entries, hoisted: flat ext position + coords + weight
    int64_t rpos[1 << DIM];
    int64_t rc[1 << DIM][DIM];
    double rw[1 << DIM];
    // row iteration: all owned rows (sub_counts null), or the product
    // of per-dim fine-coordinate lists (the rep-support subset of the
    // classed collapse — see pa_galerkin3_sub)
    const int64_t* sub_list[DIM > 0 ? DIM : 1];
    int64_t sub_idx[DIM] = {0};
    int64_t n_sub = 0;
    if (sub_counts) {
        const int64_t* p = sub_coords;
        n_sub = 1;
        for (int d = 0; d < DIM; ++d) {
            sub_list[d] = p;
            p += sub_counts[d];
            n_sub *= sub_counts[d];
        }
        if (n_sub == 0) return 0;
    }
    const int64_t n_iter = sub_counts ? n_sub : no;
    for (int64_t it = 0; it < n_iter; ++it) {
        int64_t fc[DIM], r;
        if (sub_counts) {
            r = 0;
            for (int d = 0; d < DIM; ++d) {
                fc[d] = sub_list[d][sub_idx[d]];
                r += (fc[d] - flo[d]) * bstride[d];
            }
            int d = DIM - 1;
            while (d >= 0 && ++sub_idx[d] >= sub_counts[d])
                sub_idx[d--] = 0;
        } else {
            r = it;
            int64_t rem = r;
            for (int d = DIM - 1; d >= 0; --d) {
                fc[d] = flo[d] + rem % fbox[d];
                rem /= fbox[d];
            }
        }
        int64_t ki[DIM][2];
        double wi[DIM][2];
        int ni[DIM];
        for (int d = 0; d < DIM; ++d)
            ni[d] = interp1(fc[d], cdims[d], ki[d], wi[d]);
        int nr = 0;
        int idx[DIM] = {0};
        for (;;) {
            int64_t pos = 0;
            double w = 1.0;
            bool ok = true;
            for (int d = 0; d < DIM; ++d) {
                const int64_t c = ki[d][idx[d]];
                const int64_t p = c - elo[d];
                if (p < 0 || p >= ebox[d]) { ok = false; break; }
                pos += p * estride[d];
                w *= wi[d][idx[d]];
                rc[nr][d] = c;
            }
            if (!ok) return -2;
            rpos[nr] = pos;
            rw[nr] = w;
            ++nr;
            int d = DIM - 1;
            while (d >= 0 && ++idx[d] >= ni[d]) idx[d--] = 0;
            if (d < 0) break;
        }
        for (int32_t a = indptr[r]; a < indptr[r + 1]; ++a) {
            const double av = (double)vals[a];
            int64_t g = lid_gid[cols[a]];
            int64_t jc[DIM];
            for (int d = 0; d < DIM; ++d) {
                jc[d] = g / fstride[d];
                g -= jc[d] * fstride[d];
            }
            for (int d = 0; d < DIM; ++d) {
                const int64_t o = jc[d] - fc[d];
                if (o < -1 || o > 1) return -1;
            }
            int64_t kj[DIM][2];
            double wj[DIM][2];
            int nj[DIM];
            for (int d = 0; d < DIM; ++d)
                nj[d] = interp1(jc[d], cdims[d], kj[d], wj[d]);
            // enumerate the col's P entries once, then scatter against
            // the hoisted row list
            int64_t cc2[1 << DIM][DIM];
            double w2s[1 << DIM];
            int nc2 = 0;
            int jdx[DIM] = {0};
            for (;;) {
                double w = av;
                for (int d = 0; d < DIM; ++d) {
                    cc2[nc2][d] = kj[d][jdx[d]];
                    w *= wj[d][jdx[d]];
                }
                w2s[nc2++] = w;
                int d = DIM - 1;
                while (d >= 0 && ++jdx[d] >= nj[d]) jdx[d--] = 0;
                if (d < 0) break;
            }
            constexpr int64_t NE = DIM == 1 ? 3 : (DIM == 2 ? 9 : 27);
            for (int i1 = 0; i1 < nr; ++i1) {
                const double w1 = rw[i1];
                double* base = out + rpos[i1] * NE;  // pos-major block
                for (int i2 = 0; i2 < nc2; ++i2) {
                    int64_t e = 0;
                    for (int d = 0; d < DIM; ++d) {
                        const int64_t de = cc2[i2][d] - rc[i1][d];
                        if (de < -1 || de > 1) return -3;
                        e = e * 3 + (de + 1);
                    }
                    base[e] += w1 * w2s[i2];
                }
            }
        }
    }
    return 0;
}

template <typename T>
static int64_t galerkin3_impl(const int32_t* indptr, const int32_t* cols,
                              const T* vals, int64_t no,
                              const int64_t* lid_gid, const int64_t* fdims,
                              const int64_t* flo, const int64_t* fhi,
                              const int64_t* cdims, const int64_t* elo,
                              const int64_t* ehi, int32_t dim,
                              double* out,
                              const int64_t* sub_coords = nullptr,
                              const int64_t* sub_counts = nullptr) {
    if (dim == 3)
        return galerkin3_dim<T, 3>(indptr, cols, vals, no, lid_gid, fdims,
                                   flo, fhi, cdims, elo, ehi, out,
                                   sub_coords, sub_counts);
    if (dim == 2)
        return galerkin3_dim<T, 2>(indptr, cols, vals, no, lid_gid, fdims,
                                   flo, fhi, cdims, elo, ehi, out,
                                   sub_coords, sub_counts);
    if (dim == 1)
        return galerkin3_dim<T, 1>(indptr, cols, vals, no, lid_gid, fdims,
                                   flo, fhi, cdims, elo, ehi, out,
                                   sub_coords, sub_counts);
    return -1;  // unsupported dim: the Python wrapper guards dim <= 3
}

// Row classes of a part's fine operator keyed by its GRID-OFFSET value
// signature: per owned row, the 3^d-tuple of stored values by coarse...
// fine coordinate offset (absent offsets 0), matched against a
// first-touch class table — the precondition check of the classed
// Galerkin collapse (models/gmg.py). Unlike dia_classify (lid offsets),
// the grid-offset signature is translation-invariant across part
// boundaries: rows whose -x neighbor is a ghost lid get the same
// signature as interior rows with equal values. Column coords: owned
// lids decode arithmetically from the box; ghost lids read the caller's
// (nh, d) box-relative coordinate table. Returns the class count; -1
// when an offset leaves the +-1 cube (not 3^d-closed — the collapse
// declines these anyway); -2 on table overflow.
template <typename T, int DIM>
static int64_t galerkin_classify_dim(const int32_t* indptr,
                                     const int32_t* cols, const T* vals,
                                     int64_t no, const int64_t* fbox,
                                     const int64_t* ghost_rel, int64_t K,
                                     double* table, uint8_t* codes) {
    constexpr int64_t NE = DIM == 1 ? 3 : (DIM == 2 ? 9 : 27);
    int64_t bstride[DIM];
    bstride[DIM - 1] = 1;
    for (int d = DIM - 2; d >= 0; --d)
        bstride[d] = bstride[d + 1] * fbox[d + 1];
    double sig[NE];
    int64_t cnt = 0, last = 0;
    auto match = [&](int64_t c) {
        const double* t = &table[c * NE];
        for (int64_t q = 0; q < NE; ++q)
            if (t[q] != sig[q]) return false;
        return true;
    };
    int64_t rc[DIM] = {0};
    for (int64_t r = 0; r < no; ++r) {
        for (int64_t q = 0; q < NE; ++q) sig[q] = 0.0;
        for (int32_t k = indptr[r]; k < indptr[r + 1]; ++k) {
            const int32_t j = cols[k];
            int64_t e = 0;
            if (j < no) {
                int64_t rem = j;
                for (int d = 0; d < DIM; ++d) {
                    const int64_t jc = rem / bstride[d];
                    rem -= jc * bstride[d];
                    const int64_t off = jc - rc[d];
                    if (off < -1 || off > 1) return -1;
                    e = e * 3 + (off + 1);
                }
            } else {
                const int64_t* gc = &ghost_rel[(int64_t)(j - no) * DIM];
                for (int d = 0; d < DIM; ++d) {
                    const int64_t off = gc[d] - rc[d];
                    if (off < -1 || off > 1) return -1;
                    e = e * 3 + (off + 1);
                }
            }
            sig[e] = (double)vals[k];
        }
        int64_t hit = -1;
        if (last < cnt && match(last)) {
            hit = last;
        } else {
            for (int64_t c = 0; c < cnt; ++c) {
                if (c != last && match(c)) {
                    hit = c;
                    break;
                }
            }
        }
        if (hit < 0) {
            if (cnt == K) return -2;
            for (int64_t q = 0; q < NE; ++q) table[cnt * NE + q] = sig[q];
            hit = cnt++;
        }
        codes[r] = (uint8_t)hit;
        last = hit;
        for (int d = DIM - 1; d >= 0; --d) {  // advance box coords
            if (++rc[d] < fbox[d]) break;
            rc[d] = 0;
        }
    }
    return cnt;
}

template <typename T>
static int64_t galerkin_classify_impl(const int32_t* indptr,
                                      const int32_t* cols, const T* vals,
                                      int64_t no, const int64_t* fbox,
                                      const int64_t* ghost_rel, int32_t dim,
                                      int64_t K, double* table,
                                      uint8_t* codes) {
    if (dim == 3)
        return galerkin_classify_dim<T, 3>(indptr, cols, vals, no, fbox,
                                           ghost_rel, K, table, codes);
    if (dim == 2)
        return galerkin_classify_dim<T, 2>(indptr, cols, vals, no, fbox,
                                           ghost_rel, K, table, codes);
    if (dim == 1)
        return galerkin_classify_dim<T, 1>(indptr, cols, vals, no, fbox,
                                           ghost_rel, K, table, codes);
    return -1;
}

// Emit the owned-rows CSR of a collapsed coarse operator DIRECTLY from
// the galerkin3 accumulator — the fusion that kills the COO
// round trip (extract 3^d*n_c triplets -> migrate -> dedup -> add_gids
// -> to_lids -> compresscoo) that dominated hierarchy setup at 1e8 DOFs
// (SCALE_BENCH r3: 398 s, kernel itself ~8 s). The accumulator stores
// A_c[c1, c1+de] at acc[e * esize + pos(c1)] (e = base-3 encoding of
// de+1, most-significant dim first), so one pass over the OWNED coarse
// box emits column-sorted CSR rows with LOCAL column ids:
//   * owned columns first (owned-box C-order lids are monotone in gid:
//     both orders are lexicographic in the coords), in ascending global
//     gid-delta order of the 3^d offsets,
//   * then ghost columns via binary search over the caller's SORTED
//     geometric-shell gid table (lid = n_owned + rank — matching
//     add_gids's append order for a sorted input list).
// Structural zeros are dropped (same convention as the COO path's
// nonzero() extraction). Returns nnz, or -1 when a nonzero entry's
// column is missing from the ghost table (caller falls back).
template <typename T, int DIM>
static int64_t galerkin_emit_dim(const double* acc, const int64_t* cdims,
                                 const int64_t* elo, const int64_t* ehi,
                                 const int64_t* clo, const int64_t* chi,
                                 const int64_t* ghost_gids, int64_t n_ghost,
                                 int32_t* indptr, int32_t* cols, T* vals) {
    int64_t ebox[DIM], obox[DIM], estride[DIM], ostride[DIM], cstride[DIM];
    for (int d = 0; d < DIM; ++d) {
        ebox[d] = ehi[d] - elo[d];
        obox[d] = chi[d] - clo[d];
    }
    estride[DIM - 1] = ostride[DIM - 1] = cstride[DIM - 1] = 1;
    for (int d = DIM - 2; d >= 0; --d) {
        estride[d] = estride[d + 1] * ebox[d + 1];
        ostride[d] = ostride[d + 1] * obox[d + 1];
        cstride[d] = cstride[d + 1] * cdims[d + 1];
    }
    int64_t esize = 1, no = 1;
    for (int d = 0; d < DIM; ++d) {
        esize *= ebox[d];
        no *= obox[d];
    }
    int ne = 1;
    for (int d = 0; d < DIM; ++d) ne *= 3;
    // offsets sorted by global gid delta (ties impossible: strides differ)
    int64_t de[81][DIM];  // ne <= 27 for DIM <= 3; 81 headroom
    int64_t gdelta[81];
    int ord[81];
    for (int e = 0; e < ne; ++e) {
        int m = e;
        for (int d = DIM - 1; d >= 0; --d) {
            de[e][d] = m % 3 - 1;
            m /= 3;
        }
        int64_t gd = 0;
        for (int d = 0; d < DIM; ++d) gd += de[e][d] * cstride[d];
        gdelta[e] = gd;
        ord[e] = e;
    }
    std::sort(ord, ord + ne, [&](int a, int b) {
        return gdelta[a] < gdelta[b];
    });
    int64_t w = 0;
    indptr[0] = 0;
    int64_t c1[DIM];
    for (int d = 0; d < DIM; ++d) c1[d] = clo[d];
    for (int64_t r = 0; r < no; ++r) {
        // pos of c1 in the extended box (owned box is inside it)
        int64_t pos1 = 0;
        for (int d = 0; d < DIM; ++d) pos1 += (c1[d] - elo[d]) * estride[d];
        const double* arow = acc + pos1 * ne;  // pos-major: one block
        // pass 1: owned columns (ascending gid => ascending owned lid)
        for (int k = 0; k < ne; ++k) {
            const int e = ord[k];
            const double v = arow[e];
            if (v == 0.0) continue;
            int64_t lid = 0;
            bool owned = true, ingrid = true;
            for (int d = 0; d < DIM; ++d) {
                const int64_t c2 = c1[d] + de[e][d];
                if (c2 < 0 || c2 >= cdims[d]) { ingrid = false; break; }
                if (c2 < clo[d] || c2 >= chi[d]) { owned = false; break; }
                lid += (c2 - clo[d]) * ostride[d];
            }
            if (!ingrid || !owned) continue;
            cols[w] = (int32_t)lid;
            vals[w++] = (T)v;
        }
        // pass 2: ghost columns (ascending gid => ascending table rank)
        for (int k = 0; k < ne; ++k) {
            const int e = ord[k];
            const double v = arow[e];
            if (v == 0.0) continue;
            int64_t gid2 = 0;
            bool owned = true, ingrid = true;
            for (int d = 0; d < DIM; ++d) {
                const int64_t c2 = c1[d] + de[e][d];
                if (c2 < 0 || c2 >= cdims[d]) { ingrid = false; break; }
                if (c2 < clo[d] || c2 >= chi[d]) owned = false;
                gid2 += c2 * cstride[d];
            }
            if (!ingrid || owned) continue;
            const int64_t* p =
                std::lower_bound(ghost_gids, ghost_gids + n_ghost, gid2);
            if (p == ghost_gids + n_ghost || *p != gid2) return -1;
            cols[w] = (int32_t)(no + (p - ghost_gids));
            vals[w++] = (T)v;
        }
        indptr[r + 1] = (int32_t)w;
        // advance c1 in C-order over the owned box
        for (int d = DIM - 1; d >= 0; --d) {
            if (++c1[d] < chi[d]) break;
            c1[d] = clo[d];
        }
    }
    return w;
}

template <typename T>
static int64_t galerkin_emit_impl(const double* acc, const int64_t* cdims,
                                  const int64_t* elo, const int64_t* ehi,
                                  const int64_t* clo, const int64_t* chi,
                                  const int64_t* ghost_gids, int64_t n_ghost,
                                  int32_t dim, int32_t* indptr,
                                  int32_t* cols, T* vals) {
    if (dim == 3)
        return galerkin_emit_dim<T, 3>(acc, cdims, elo, ehi, clo, chi,
                                       ghost_gids, n_ghost, indptr, cols,
                                       vals);
    if (dim == 2)
        return galerkin_emit_dim<T, 2>(acc, cdims, elo, ehi, clo, chi,
                                       ghost_gids, n_ghost, indptr, cols,
                                       vals);
    if (dim == 1)
        return galerkin_emit_dim<T, 1>(acc, cdims, elo, ehi, clo, chi,
                                       ghost_gids, n_ghost, indptr, cols,
                                       vals);
    return -2;  // unsupported dim: the Python wrapper guards dim <= 3
}

// Emit the owned-rows CSR of a Dirichlet-identity Cartesian stencil
// operator DIRECTLY from box geometry — the fusion that removes
// the whole COO pipeline from structured assembly (generate 2d+1
// volume-sized triplet arrays -> add_gids -> to_lids -> compresscoo:
// ~70% of the 276 s assembly_s at 1e8 DOFs, SCALE_BENCH r3). Rows are
// the owned box in C-order; grid-boundary cells are identity rows;
// interior cells carry `center` on the diagonal and arm_vals[2d + s]
// on the -+1 neighbor in dim d. Columns are LOCAL ids: owned-box
// C-order first, then `ghost_gids` (the caller's SORTED geometric face
// slabs) at n_owned + rank — matching add_gids's append order for a
// sorted input, exactly like galerkin_emit_dim. Rows come out
// column-sorted by the same two-pass trick: owned columns in ascending
// gid-delta order (box C-order lids are monotone in gid), then ghost
// columns (sorted table ranks are monotone in gid).
// `decouple` = 1 zeroes the VALUE of interior->boundary couplings
// (pattern preserved), emitting the decouple_dirichlet'd operator in
// place — for identity-row systems the decoupled RHS is then exactly
// b^ = A^ @ x^, so the separate np.add.at classification passes never
// run. Returns nnz, or -1 when an out-of-box neighbor is missing from
// the ghost table (caller falls back to the COO path).
// With `bout` non-null the kernel ALSO computes b = A @ x^ in the same
// pass, where x^(c) = (T)(xtab_0[c_0] + ... + xtab_{d-1}[c_{d-1}])
// (per-dim f64 tables summed left-to-right then cast — exactly the
// manufactured-solution evaluation). The accumulation replicates the
// host mul_into phases bit-for-bit: owned-column products summed
// left-to-right in emitted (column) order, ghost-column products in a
// SEPARATE accumulator added once at the end — and only when the part
// has any ghosts at all (phase 2 is skipped part-wide otherwise, which
// matters for -0.0). This removes the only consumer that forced the
// owned/ghost block split during assembly.
template <typename T, int DIM>
static int64_t stencil_emit_dim(const int64_t* dims, const int64_t* lo,
                                const int64_t* hi, double center,
                                const double* arm_vals,
                                const int64_t* ghost_gids, int64_t n_ghost,
                                int32_t decouple, int32_t* indptr,
                                int32_t* cols, T* vals,
                                const double* xtab, T* bout,
                                int64_t row0, int64_t row1) {
    int64_t gstride[DIM], bstride[DIM], box[DIM];
    gstride[DIM - 1] = bstride[DIM - 1] = 1;
    for (int d = 0; d < DIM; ++d) box[d] = hi[d] - lo[d];
    for (int d = DIM - 2; d >= 0; --d) {
        gstride[d] = gstride[d + 1] * dims[d + 1];
        bstride[d] = bstride[d + 1] * box[d + 1];
    }
    int64_t no = 1;
    for (int d = 0; d < DIM; ++d) no *= box[d];
    // arms in ascending global gid-delta order:
    // -s0, -s1, ..., -s_{DIM-1}, center, +s_{DIM-1}, ..., +s0
    struct Arm {
        int d;        // dimension of the offset (-1 = center)
        int64_t off;  // -1 / +1 coordinate offset
        int64_t ld;   // owned-box lid delta
        double coef;
    };
    Arm arms[2 * DIM + 1];
    for (int d = 0; d < DIM; ++d) {
        arms[d] = {d, -1, -bstride[d], arm_vals[2 * d]};
        arms[2 * DIM - d] = {d, +1, bstride[d], arm_vals[2 * d + 1]};
    }
    arms[DIM] = {-1, 0, 0, center};
    // per-dim table base offsets into the concatenated xtab
    const double* tab[DIM];
    if (xtab) {
        const double* p = xtab;
        for (int d = 0; d < DIM; ++d) {
            tab[d] = p;
            p += dims[d];
        }
    }
    const bool has_ghosts = n_ghost > 0;
    auto xhat = [&](const int64_t* cc, int d_off, int64_t off) -> T {
        // x^ at cc with coordinate d_off shifted by off: per-dim table
        // values summed left-to-right in f64, then cast — the exact
        // evaluation order of the manufactured-solution tables
        double s = 0.0;
        for (int d = 0; d < DIM; ++d)
            s += tab[d][cc[d] + (d == d_off ? off : 0)];
        return (T)s;
    };
    // row-range form: emit rows [row0, row1) of
    // the SAME box — column ids, ghost ranks and gids all stay in the
    // FULL part's numbering, so K workers over disjoint ranges write
    // byte-identical slices of the one-shot emission. Outputs are
    // RELATIVE to row0 (indptr[0]=0, cols/vals from slot 0, bout[0] is
    // row row0); owned column ids remain absolute box lids.
    if (row1 < 0) row1 = no;  // full range
    int64_t w = 0;
    indptr[0] = 0;
    int64_t c[DIM];
    {  // decompose row0 into box coords (C-order)
        int64_t rr = row0;
        for (int d = 0; d < DIM; ++d) {
            c[d] = lo[d] + (bstride[d] ? rr / bstride[d] : 0);
            rr = bstride[d] ? rr % bstride[d] : rr;
        }
    }
    for (int64_t r = row0; r < row1; ++r) {
        bool bnd = false;
        for (int d = 0; d < DIM; ++d)
            bnd |= (c[d] == 0) | (c[d] == dims[d] - 1);
        T acc_o = 0, acc_h = 0;
        if (bnd) {  // Dirichlet identity row
            cols[w] = (int32_t)r;
            vals[w++] = (T)1.0;
            if (bout) acc_o = (T)1.0 * xhat(c, -1, 0);
        } else {
            // pass 1: in-box columns (ascending lid == ascending gid)
            for (int k = 0; k < 2 * DIM + 1; ++k) {
                const Arm& a = arms[k];
                if (a.d < 0) {
                    cols[w] = (int32_t)r;
                    vals[w++] = (T)a.coef;
                    if (bout) acc_o += (T)a.coef * xhat(c, -1, 0);
                    continue;
                }
                const int64_t c2 = c[a.d] + a.off;
                if (c2 < lo[a.d] || c2 >= hi[a.d]) continue;
                // the neighbor differs from an interior cell only in dim
                // a.d, so it is a boundary cell iff c2 hits that dim's edge
                double v = a.coef;
                if (decouple && (c2 == 0 || c2 == dims[a.d] - 1)) v = 0.0;
                cols[w] = (int32_t)(r + a.ld);
                vals[w++] = (T)v;
                if (bout) acc_o += (T)v * xhat(c, a.d, a.off);
            }
            // pass 2: ghost columns (sorted-table ranks ascend with gid)
            int64_t gid = 0;
            for (int d = 0; d < DIM; ++d) gid += c[d] * gstride[d];
            for (int k = 0; k < 2 * DIM + 1; ++k) {
                const Arm& a = arms[k];
                if (a.d < 0) continue;
                const int64_t c2 = c[a.d] + a.off;
                if (c2 >= lo[a.d] && c2 < hi[a.d]) continue;
                const int64_t gid2 = gid + a.off * gstride[a.d];
                const int64_t* p =
                    std::lower_bound(ghost_gids, ghost_gids + n_ghost, gid2);
                if (p == ghost_gids + n_ghost || *p != gid2) return -1;
                double v = a.coef;
                if (decouple && (c2 == 0 || c2 == dims[a.d] - 1)) v = 0.0;
                cols[w] = (int32_t)(no + (p - ghost_gids));
                vals[w++] = (T)v;
                if (bout) acc_h += (T)v * xhat(c, a.d, a.off);
            }
        }
        if (bout) {
            // phase-1 writes into a zeroed c (0 + acc: flips any -0.0
            // partial to +0.0, as the host does), phase 2 adds
            const T b0 = (T)0 + acc_o;
            bout[r - row0] = has_ghosts ? b0 + acc_h : b0;
        }
        indptr[r - row0 + 1] = (int32_t)w;
        for (int d = DIM - 1; d >= 0; --d) {  // advance c in C-order
            if (++c[d] < hi[d]) break;
            c[d] = lo[d];
        }
    }
    return w;
}

template <typename T>
static int64_t stencil_emit_impl(const int64_t* dims, const int64_t* lo,
                                 const int64_t* hi, int32_t dim,
                                 double center, const double* arm_vals,
                                 const int64_t* ghost_gids, int64_t n_ghost,
                                 int32_t decouple, int32_t* indptr,
                                 int32_t* cols, T* vals,
                                 const double* xtab, T* bout,
                                 int64_t row0 = 0, int64_t row1 = -1) {
    if (dim == 3)
        return stencil_emit_dim<T, 3>(dims, lo, hi, center, arm_vals,
                                      ghost_gids, n_ghost, decouple, indptr,
                                      cols, vals, xtab, bout, row0, row1);
    if (dim == 2)
        return stencil_emit_dim<T, 2>(dims, lo, hi, center, arm_vals,
                                      ghost_gids, n_ghost, decouple, indptr,
                                      cols, vals, xtab, bout, row0, row1);
    if (dim == 1)
        return stencil_emit_dim<T, 1>(dims, lo, hi, center, arm_vals,
                                      ghost_gids, n_ghost, decouple, indptr,
                                      cols, vals, xtab, bout, row0, row1);
    return -2;  // unsupported dim: the Python wrapper guards dim <= 3
}

// Diagonal of a CSR block: one pass, binary search per (column-sorted)
// row — replaces a row_of_nz expansion + full-nnz compare + nonzero
// triple pass.
template <typename T>
static void csr_diag_impl(const int32_t* indptr, const int32_t* cols,
                          const T* vals, int64_t m, T* d) {
    for (int64_t i = 0; i < m; ++i) {
        const int32_t* b = cols + indptr[i];
        const int32_t* e = cols + indptr[i + 1];
        const int32_t* p = std::lower_bound(b, e, (int32_t)i);
        d[i] = (p != e && *p == (int32_t)i) ? vals[p - cols] : (T)0;
    }
}

extern "C" {

void pa_csr_diag_f64(const int32_t* indptr, const int32_t* cols,
                     const double* vals, int64_t m, double* d) {
    csr_diag_impl<double>(indptr, cols, vals, m, d);
}

void pa_csr_diag_f32(const int32_t* indptr, const int32_t* cols,
                     const float* vals, int64_t m, float* d) {
    csr_diag_impl<float>(indptr, cols, vals, m, d);
}

int64_t pa_galerkin3_f64(const int32_t* indptr, const int32_t* cols,
                         const double* vals, int64_t no,
                         const int64_t* lid_gid, const int64_t* fdims,
                         const int64_t* flo, const int64_t* fhi,
                         const int64_t* cdims, const int64_t* elo,
                         const int64_t* ehi, int32_t dim, double* out) {
    return galerkin3_impl<double>(indptr, cols, vals, no, lid_gid, fdims,
                                  flo, fhi, cdims, elo, ehi, dim, out);
}

int64_t pa_galerkin3_f32(const int32_t* indptr, const int32_t* cols,
                         const float* vals, int64_t no,
                         const int64_t* lid_gid, const int64_t* fdims,
                         const int64_t* flo, const int64_t* fhi,
                         const int64_t* cdims, const int64_t* elo,
                         const int64_t* ehi, int32_t dim, double* out) {
    return galerkin3_impl<float>(indptr, cols, vals, no, lid_gid, fdims,
                                 flo, fhi, cdims, elo, ehi, dim, out);
}

int64_t pa_galerkin3_sub_f64(const int32_t* indptr, const int32_t* cols,
                             const double* vals, int64_t no,
                             const int64_t* lid_gid, const int64_t* fdims,
                             const int64_t* flo, const int64_t* fhi,
                             const int64_t* cdims, const int64_t* elo,
                             const int64_t* ehi, int32_t dim, double* out,
                             const int64_t* sub_coords,
                             const int64_t* sub_counts) {
    return galerkin3_impl<double>(indptr, cols, vals, no, lid_gid, fdims,
                                  flo, fhi, cdims, elo, ehi, dim, out,
                                  sub_coords, sub_counts);
}

int64_t pa_galerkin3_sub_f32(const int32_t* indptr, const int32_t* cols,
                             const float* vals, int64_t no,
                             const int64_t* lid_gid, const int64_t* fdims,
                             const int64_t* flo, const int64_t* fhi,
                             const int64_t* cdims, const int64_t* elo,
                             const int64_t* ehi, int32_t dim, double* out,
                             const int64_t* sub_coords,
                             const int64_t* sub_counts) {
    return galerkin3_impl<float>(indptr, cols, vals, no, lid_gid, fdims,
                                 flo, fhi, cdims, elo, ehi, dim, out,
                                 sub_coords, sub_counts);
}

int64_t pa_galerkin_classify_f64(const int32_t* indptr, const int32_t* cols,
                                 const double* vals, int64_t no,
                                 const int64_t* fbox,
                                 const int64_t* ghost_rel, int32_t dim,
                                 int64_t K, double* table, uint8_t* codes) {
    return galerkin_classify_impl<double>(indptr, cols, vals, no, fbox,
                                          ghost_rel, dim, K, table, codes);
}

int64_t pa_galerkin_classify_f32(const int32_t* indptr, const int32_t* cols,
                                 const float* vals, int64_t no,
                                 const int64_t* fbox,
                                 const int64_t* ghost_rel, int32_t dim,
                                 int64_t K, double* table, uint8_t* codes) {
    return galerkin_classify_impl<float>(indptr, cols, vals, no, fbox,
                                         ghost_rel, dim, K, table, codes);
}

int64_t pa_galerkin_emit_f64(const double* acc, const int64_t* cdims,
                             const int64_t* elo, const int64_t* ehi,
                             const int64_t* clo, const int64_t* chi,
                             const int64_t* ghost_gids, int64_t n_ghost,
                             int32_t dim, int32_t* indptr, int32_t* cols,
                             double* vals) {
    return galerkin_emit_impl<double>(acc, cdims, elo, ehi, clo, chi,
                                      ghost_gids, n_ghost, dim, indptr,
                                      cols, vals);
}

int64_t pa_galerkin_emit_f32(const double* acc, const int64_t* cdims,
                             const int64_t* elo, const int64_t* ehi,
                             const int64_t* clo, const int64_t* chi,
                             const int64_t* ghost_gids, int64_t n_ghost,
                             int32_t dim, int32_t* indptr, int32_t* cols,
                             float* vals) {
    return galerkin_emit_impl<float>(acc, cdims, elo, ehi, clo, chi,
                                     ghost_gids, n_ghost, dim, indptr,
                                     cols, vals);
}

int64_t pa_band_offsets(const int32_t* indptr, const int32_t* cols,
                        int64_t m, int64_t K, int64_t* out,
                        int64_t col_limit) {
    return band_offsets_impl(indptr, cols, m, K, out, col_limit);
}

int64_t pa_dia_classify_f64(const int32_t* indptr, const int32_t* cols,
                            const double* vals, int64_t m,
                            const int64_t* offsets, int64_t D, int64_t K,
                            double* class_table, uint8_t* codes,
                            int64_t col_limit) {
    return dia_classify_impl<double>(indptr, cols, vals, m, offsets, D, K,
                                     class_table, codes, col_limit);
}

int64_t pa_dia_classify_f32(const int32_t* indptr, const int32_t* cols,
                            const float* vals, int64_t m,
                            const int64_t* offsets, int64_t D, int64_t K,
                            double* class_table, uint8_t* codes,
                            int64_t col_limit) {
    return dia_classify_impl<float>(indptr, cols, vals, m, offsets, D, K,
                                    class_table, codes, col_limit);
}

// Count entries with column >= thr (the A_oh side of a column-sorted
// full-row CSR) without a bool temp, then extract ONLY that side —
// the no-split lowering's surface-sized boundary block (the full+halves
// materialization it replaces cost ~2x the operator in fresh pages).
int64_t pa_count_ge(const int32_t* cols, int64_t nnz, int32_t thr) {
    int64_t c = 0;
    for (int64_t k = 0; k < nnz; ++k) c += cols[k] >= thr;
    return c;
}

void pa_csr_extract_hi_f64(const int32_t* indptr, const int32_t* cols,
                           const double* vals, int64_t m, int32_t thr,
                           int32_t* ip_hi, int32_t* c_hi, double* v_hi);
void pa_csr_extract_hi_f32(const int32_t* indptr, const int32_t* cols,
                           const float* vals, int64_t m, int32_t thr,
                           int32_t* ip_hi, int32_t* c_hi, float* v_hi);

int64_t pa_stencil_emit_f64(const int64_t* dims, const int64_t* lo,
                            const int64_t* hi, int32_t dim, double center,
                            const double* arm_vals,
                            const int64_t* ghost_gids, int64_t n_ghost,
                            int32_t decouple, int32_t* indptr,
                            int32_t* cols, double* vals, const double* xtab,
                            double* bout, int32_t with_b) {
    return stencil_emit_impl<double>(dims, lo, hi, dim, center, arm_vals,
                                     ghost_gids, n_ghost, decouple, indptr,
                                     cols, vals, with_b ? xtab : nullptr,
                                     with_b ? bout : nullptr);
}

int64_t pa_stencil_emit_f32(const int64_t* dims, const int64_t* lo,
                            const int64_t* hi, int32_t dim, double center,
                            const double* arm_vals,
                            const int64_t* ghost_gids, int64_t n_ghost,
                            int32_t decouple, int32_t* indptr,
                            int32_t* cols, float* vals, const double* xtab,
                            float* bout, int32_t with_b) {
    return stencil_emit_impl<float>(dims, lo, hi, dim, center, arm_vals,
                                    ghost_gids, n_ghost, decouple, indptr,
                                    cols, vals, with_b ? xtab : nullptr,
                                    with_b ? bout : nullptr);
}

// Row-range variants: emit rows [row0, row1) of
// the box with outputs relative to row0 and column ids in the FULL
// part's numbering — the K-worker parallel-emission building block.
int64_t pa_stencil_emit_range_f64(
    const int64_t* dims, const int64_t* lo, const int64_t* hi, int32_t dim,
    double center, const double* arm_vals, const int64_t* ghost_gids,
    int64_t n_ghost, int32_t decouple, int32_t* indptr, int32_t* cols,
    double* vals, const double* xtab, double* bout, int32_t with_b,
    int64_t row0, int64_t row1) {
    return stencil_emit_impl<double>(dims, lo, hi, dim, center, arm_vals,
                                     ghost_gids, n_ghost, decouple, indptr,
                                     cols, vals, with_b ? xtab : nullptr,
                                     with_b ? bout : nullptr, row0, row1);
}

int64_t pa_stencil_emit_range_f32(
    const int64_t* dims, const int64_t* lo, const int64_t* hi, int32_t dim,
    double center, const double* arm_vals, const int64_t* ghost_gids,
    int64_t n_ghost, int32_t decouple, int32_t* indptr, int32_t* cols,
    float* vals, const double* xtab, float* bout, int32_t with_b,
    int64_t row0, int64_t row1) {
    return stencil_emit_impl<float>(dims, lo, hi, dim, center, arm_vals,
                                    ghost_gids, n_ghost, decouple, indptr,
                                    cols, vals, with_b ? xtab : nullptr,
                                    with_b ? bout : nullptr, row0, row1);
}

void pa_csr_extract_hi_f64(const int32_t* indptr, const int32_t* cols,
                           const double* vals, int64_t m, int32_t thr,
                           int32_t* ip_hi, int32_t* c_hi, double* v_hi) {
    csr_extract_hi_impl<double>(indptr, cols, vals, m, thr, ip_hi, c_hi,
                                v_hi);
}

void pa_csr_extract_hi_f32(const int32_t* indptr, const int32_t* cols,
                           const float* vals, int64_t m, int32_t thr,
                           int32_t* ip_hi, int32_t* c_hi, float* v_hi) {
    csr_extract_hi_impl<float>(indptr, cols, vals, m, thr, ip_hi, c_hi,
                               v_hi);
}

void pa_csr_spmv_f64(const int32_t* indptr, const int32_t* cols,
                     const double* vals, int64_t m, const double* x,
                     double* y) {
    csr_spmv_impl<double>(indptr, cols, vals, m, x, y);
}

void pa_csr_spmv_f32(const int32_t* indptr, const int32_t* cols,
                     const float* vals, int64_t m, const float* x,
                     float* y) {
    csr_spmv_impl<float>(indptr, cols, vals, m, x, y);
}

int64_t pa_dia_fill_f64(const int32_t* indptr, const int32_t* cols,
                        const double* vals, int64_t m,
                        const int64_t* offsets, int64_t D, int64_t stride,
                        double* dia) {
    return dia_fill_impl<double>(indptr, cols, vals, m, offsets, D, stride,
                                 dia);
}

int64_t pa_dia_fill_f32(const int32_t* indptr, const int32_t* cols,
                        const float* vals, int64_t m,
                        const int64_t* offsets, int64_t D, int64_t stride,
                        double* dia) {
    return dia_fill_impl<float>(indptr, cols, vals, m, offsets, D, stride,
                                dia);
}

}  // extern "C"
