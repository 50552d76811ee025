// cfs_native — native host-side runtime for cfs_spmv.
//
// The host-side scans that stay scalar in NumPy terms, implemented as a
// small C ABI shared library loaded via ctypes: MatrixMarket body
// tokenization (ref src/mmf.cpp:6-44), the symmetric triangle split with
// dense-diagonal (SDIA) fill, its distributed per-shard variant, and the
// symmetrized adjacency used by RCM. Every routine has a NumPy fallback
// in its caller that produces bit-identical output.
//
// SDIA value planes are (D, n): plane j holds diagonal offsets[j] at the
// diagonal's row index, so slot (j, g) = j * n + g.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC cfs_native.cpp -o libcfs_native.so

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// MMF body parser.
//
// Parses `nnz` coordinate records of `width` whitespace-separated fields
// (2 = pattern, 3 = real/integer) from buf[0:len). Rows/cols are written
// 1-based-as-stored (caller rebases), values only when width == 3.
// A '%' anywhere between tokens comments to end of line — the same
// "comments are whitespace" contract as the NumPy fallback's strip pass,
// so both paths accept/reject the same bodies bit-identically.
// Returns the number of records parsed, or -(byte offset + 1) of the first
// malformed token.
static inline const char *cfs_skip_ws(const char *p, const char *end) {
  for (;;) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p < end && *p == '%') {
      while (p < end && *p != '\n') ++p;
      continue;
    }
    return p;
  }
}

int64_t cfs_parse_mmf_body(const char *buf, int64_t len, int64_t nnz,
                           int32_t width, int64_t *row, int64_t *col,
                           double *val) {
  const char *p = buf;
  const char *end = buf + len;
  for (int64_t k = 0; k < nnz; ++k) {
    p = cfs_skip_ws(p, end);
    if (p >= end) return -(int64_t)(p - buf) - 1;
    char *q;
    long long r = strtoll(p, &q, 10);
    if (q == p) return -(int64_t)(p - buf) - 1;
    p = cfs_skip_ws(q, end);
    long long c = strtoll(p, &q, 10);
    if (q == p) return -(int64_t)(p - buf) - 1;
    p = q;
    row[k] = (int64_t)r;
    col[k] = (int64_t)c;
    if (width == 3) {
      p = cfs_skip_ws(p, end);
      double v = strtod(p, &q);
      if (q == p) return -(int64_t)(p - buf) - 1;
      p = q;
      val[k] = v;
    }
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// Symmetric split + SDIA extraction (formats/plan.py build_symmetric_plan).
//
// The NumPy formulation of "separate the diagonal, select dense
// sub-diagonals, scatter them into the SDIA planes, emit the residual
// triples" costs ~18 full passes over the entry set in temporaries;
// these two routines do it in one counting pass + one fill pass over
// the raw CSR arrays.

// Pass A: per-offset entry counts of the strict lower triangle
// (cnt[d] for d = i - col in [1, n)) plus the structural diagonal
// count. Returns -1 if any strict-UPPER entry exists (SSS storage
// must be lower-triangle — mirrors the Python assert).
int64_t cfs_sym_off_counts(const int64_t *indptr, const int32_t *indices,
                           int64_t n, int64_t *cnt, int64_t *ndiag_out) {
  int64_t ndiag = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t d = i - (int64_t)indices[k];
      if (d == 0) {
        ++ndiag;
      } else if (d > 0) {
        ++cnt[d];
      } else {
        return -1;
      }
    }
  }
  *ndiag_out = ndiag;
  return 0;
}

// Pass B: route every entry — diagonal values to diag[i], entries on
// selected sub-diagonals (dmap[d] >= 0) into the (D, n) SDIA value
// planes at (dmap[d], i), everything else appended to the residual
// triple arrays. `data` must already be in the plan's value dtype
// (es bytes/elem). Returns the residual count.
int64_t cfs_sym_split_fill(const int64_t *indptr, const int32_t *indices,
                           const char *data, int64_t es, int64_t n,
                           const int32_t *dmap, char *vals, char *diag,
                           int32_t *rrow, int32_t *rcol, char *rval) {
  int64_t r = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t c = (int64_t)indices[k];
      const int64_t d = i - c;
      if (d == 0) {
        memcpy(diag + i * es, data + k * es, es);
      } else if (dmap[d] >= 0) {
        memcpy(vals + ((int64_t)dmap[d] * n + i) * es, data + k * es, es);
      } else {
        rrow[r] = (int32_t)i;
        rcol[r] = (int32_t)c;
        memcpy(rval + r * es, data + k * es, es);
        ++r;
      }
    }
  }
  return r;
}

// ---------------------------------------------------------------------------
// Distributed symmetric shard split (parallel/dist.py _init_symmetric).
//
// Rows are sharded in contiguous ranges [r_start[d], r_end[d]). An entry
// is NEAR when its column lives on the same shard as its row: it stays
// in the shard's local symmetric streams (dense-diagonal planes or the
// local strict-lower residual). A FAR entry feeds two one-sided streams:
// (local row, global col) on the row's shard and its mirror image
// (owner-local col, global row) on the column's shard.

static inline int64_t cfs_owner_of(int64_t x, const int64_t *r_end,
                                   int64_t ndev) {
  int64_t lo = 0, hi = ndev - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (x < r_end[mid]) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Pass A: per-shard near-offset histograms (off_cnt, for the dense-
// diagonal union selection), near/far/mirror counts. Returns the
// cross-shard entry count. Rows are CSR-ordered, so the row owner
// advances monotonically.
int64_t cfs_dist_sym_count(const int64_t *indptr, const int32_t *indices,
                           int64_t n, int64_t ndev, const int64_t *r_end,
                           int64_t shard_rows, int64_t *off_cnt,
                           int64_t *cnt_near, int64_t *cnt_far,
                           int64_t *cnt_mirror) {
  int64_t cross = 0;
  int64_t d_own = 0;
  for (int64_t i = 0; i < n; ++i) {
    while (d_own < ndev - 1 && i >= r_end[d_own]) ++d_own;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t c = (int64_t)indices[k];
      const int64_t co = cfs_owner_of(c, r_end, ndev);
      if (co == d_own) {
        ++cnt_near[d_own];
        ++off_cnt[d_own * shard_rows + (i - c)];
      } else {
        ++cnt_far[d_own];
        ++cnt_mirror[co];
        ++cross;
      }
    }
  }
  return cross;
}

// Pass B: route every entry. Near entries on selected dense diagonals
// (dmap[off] >= 0) scatter into the stacked (ndev, D, shard_rows) value
// planes; other near entries append local-coordinate residual triples;
// far entries append (local row, global col) own triples AND
// (owner-local col, global row) mirror triples bucketed by column
// owner. Cursor bases come from pass A's exclusive prefix sums.
void cfs_dist_sym_fill(
    const int64_t *indptr, const int32_t *indices, const char *data,
    int64_t es, int64_t n, int64_t ndev, const int64_t *r_start,
    const int64_t *r_end, int64_t shard_rows, const int32_t *dmap,
    int64_t dmap_len, int64_t D, const int64_t *near_base,
    const int64_t *far_base, const int64_t *mir_base, int32_t *near_r,
    int32_t *near_c, char *near_v, int32_t *far_r, int32_t *far_c,
    char *far_v, int32_t *mir_r, int32_t *mir_c, char *mir_v,
    char *dia_vals) {
  int64_t *cur_n = new int64_t[3 * ndev];
  int64_t *cur_f = cur_n + ndev;
  int64_t *cur_m = cur_n + 2 * ndev;
  memcpy(cur_n, near_base, ndev * sizeof(int64_t));
  memcpy(cur_f, far_base, ndev * sizeof(int64_t));
  memcpy(cur_m, mir_base, ndev * sizeof(int64_t));
  int64_t d_own = 0;
  for (int64_t i = 0; i < n; ++i) {
    while (d_own < ndev - 1 && i >= r_end[d_own]) ++d_own;
    const int64_t r0 = r_start[d_own];
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t c = (int64_t)indices[k];
      const int64_t co = cfs_owner_of(c, r_end, ndev);
      if (co == d_own) {
        const int64_t off = i - c;
        const int32_t j = off < dmap_len ? dmap[off] : -1;
        if (j >= 0 && dia_vals) {
          const int64_t slot = (d_own * D + j) * shard_rows + (i - r0);
          memcpy(dia_vals + slot * es, data + k * es, es);
        } else {
          const int64_t p = cur_n[d_own]++;
          near_r[p] = (int32_t)(i - r0);
          near_c[p] = (int32_t)(c - r0);
          memcpy(near_v + p * es, data + k * es, es);
        }
      } else {
        int64_t p = cur_f[d_own]++;
        far_r[p] = (int32_t)(i - r0);
        far_c[p] = (int32_t)c;
        memcpy(far_v + p * es, data + k * es, es);
        p = cur_m[co]++;
        mir_r[p] = (int32_t)(c - r_start[co]);
        mir_c[p] = (int32_t)i;
        memcpy(mir_v + p * es, data + k * es, es);
      }
    }
  }
  delete[] cur_n;
}

// ---------------------------------------------------------------------------
// Symmetrized adjacency from lower-triangle CSR (tuning/reorder.py
// _sym_pattern): both directions of every strict-lower edge, self-loops
// dropped — two passes instead of the mirrored-concatenate + argsort
// over 2*nnz int64 keys. Neighbor order within a row is arbitrary
// (RCM's level ordering sorts by (parent, degree, index) itself).
void cfs_sym_adjacency(const int64_t *indptr, const int32_t *indices,
                       int64_t n, int64_t *adj_indptr,
                       int32_t *adj_indices) {
  // pass 1: degrees into adj_indptr[1..n] (caller supplies zeros)
  for (int64_t i = 0; i < n; ++i)
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t c = (int64_t)indices[k];
      if (c != i) {
        ++adj_indptr[i + 1];
        ++adj_indptr[c + 1];
      }
    }
  for (int64_t i = 0; i < n; ++i) adj_indptr[i + 1] += adj_indptr[i];
  int64_t *cur = new int64_t[n];
  memcpy(cur, adj_indptr, n * sizeof(int64_t));
  // pass 2: fill both directions
  for (int64_t i = 0; i < n; ++i)
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int64_t c = (int64_t)indices[k];
      if (c != i) {
        adj_indices[cur[i]++] = (int32_t)c;
        adj_indices[cur[c]++] = (int32_t)i;
      }
    }
  delete[] cur;
}

// ---------------------------------------------------------------------------
// SDIA value fill (formats/sdia.py extract_sdia): val[i] lands in plane
// j[i] at row g[i] of the (D, n) layout. One pass replaces NumPy's
// fancy-index scatter and its full-size index temporaries.
void cfs_assemble_sdia(const int64_t *g, const int32_t *j, int64_t m,
                       int64_t n, const char *val, int64_t es,
                       char *vals) {
  for (int64_t i = 0; i < m; ++i)
    memcpy(vals + ((int64_t)j[i] * n + g[i]) * es, val + i * es, es);
}

}  // extern "C"
