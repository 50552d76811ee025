"""The tuned host plan: dense diagonals + indexed residual.

Every tuned matrix is at most three streams:

- ``diag`` — the main diagonal of a symmetric matrix;
- ``dia`` — dense exact diagonals as index-free planes
  (:mod:`.sdia`); strict-lower offsets for a symmetric matrix, applied
  to both triangles, signed offsets for a general one;
- ``resid`` — everything else as ELL + COO tail (:mod:`.ell`), one-sided.
  For a symmetric matrix it holds both mirror images of the strict-lower
  residual: on the H100 that beat reading the triangle once with either
  atomic or scatter-add transpose updates (PERF.md, "Kernel
  decisions"). The diagonal planes keep the one-read symmetric form.

This is the reference's structure (symmetric storage with the
diagonal apart, ``csr_matrix.hpp:221-277``; HYB bandwidth split,
``csr_matrix.tpp:313-401``) in the two layouts a GPU streams well.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native as _native
from ..utils.logging import info
from .csr import CSR
from .ell import EllPlan, build_ell
from .sdia import (
    SDIA_FILL,
    SDIA_MIN_COUNT,
    SDiaPlan,
    extract_sdia,
    select_offsets,
)

__all__ = [
    "MatrixPlan",
    "build_symmetric_plan",
    "build_general_plan",
    "SDIA_PEEL_MIN_FRAC",
]

#: a general-matrix peel must absorb this fraction of the entries: the
#: diagonal pass reads all of x and y however few diagonals it holds
SDIA_PEEL_MIN_FRAC = 0.25


@dataclasses.dataclass
class MatrixPlan:
    nrows: int
    ncols: int
    symmetric: bool
    nnz_full: int  # logical nonzeros (both triangles)
    diag: np.ndarray | None  # (n,) symmetric main diagonal
    dia: SDiaPlan | None
    resid: EllPlan | None

    @property
    def resid_fraction(self) -> float:
        """Fraction of logical nonzeros on the indexed residual."""
        if self.resid is None:
            return 0.0
        return self.resid.nnz / max(self.nnz_full, 1)

    @property
    def padding_ratio(self) -> float:
        """Stored slots per logical nonzero (< 1 for symmetric plans)."""
        slots = 0 if self.diag is None else len(self.diag)
        if self.dia is not None:
            slots += self.dia.vals.size
        if self.resid is not None:
            slots += self.resid.cols.size + len(self.resid.tail_row)
        return slots / max(self.nnz_full, 1)

    def stream_bytes(self) -> int:
        return sum(
            p.stream_bytes() if hasattr(p, "stream_bytes") else p.nbytes
            for p in (self.diag, self.dia, self.resid) if p is not None
        )


def _split_symmetric(csr: CSR, dtype, dia: bool):
    """(diag, SDiaPlan | None, strict-lower residual triples) of a
    lower-triangle CSR; residual triples stay in CSR (row-major)
    order."""
    n = csr.nrows
    counts = _native.sym_off_counts(csr.indptr, csr.indices, n)
    if counts is not None:
        cnt_by_off, ndiag = counts
        offsets = None
        if dia and csr.nnz:
            uniq = np.flatnonzero(cnt_by_off)
            offsets = select_offsets(uniq, cnt_by_off[uniq], n)
        dmap = np.full(n, -1, np.int32)
        if offsets is not None:
            dmap[offsets] = np.arange(len(offsets), dtype=np.int32)
            vals = np.zeros((len(offsets), n), dtype)
            nnz_dia = int(cnt_by_off[offsets].sum())
        else:
            vals = np.zeros((0, n), dtype)
            nnz_dia = 0
        n_res = csr.nnz - ndiag - nnz_dia
        diag = np.zeros(n, dtype)
        rrow = np.empty(max(n_res, 1), np.int32)
        rcol = np.empty(max(n_res, 1), np.int32)
        rval = np.empty(max(n_res, 1), dtype)
        got = _native.sym_split_fill(
            csr.indptr, csr.indices, np.asarray(csr.data, dtype), n, dmap,
            vals, diag, rrow, rcol, rval,
        )
        assert got == n_res, (got, n_res)
        dplan = None
        if offsets is not None:
            dplan = SDiaPlan(n, tuple(int(d) for d in offsets), vals, nnz_dia)
        return diag, dplan, (rrow[:n_res], rcol[:n_res], rval[:n_res])
    # NumPy fallback (no toolchain, or strict-upper entries: the assert
    # below reports those)
    row = np.repeat(np.arange(n, dtype=np.int32), np.diff(csr.indptr))
    col = np.asarray(csr.indices, np.int32)
    data = np.asarray(csr.data, dtype)
    on = row == col
    diag = np.zeros(n, dtype)
    diag[row[on]] = data[on]
    row, col, data = row[~on], col[~on], data[~on]
    assert not np.any(row < col), "SSS storage must be lower-triangle"
    dplan = None
    if dia and len(row):
        dplan, resid = extract_sdia(row, col, data, n, dtype=dtype)
        if dplan is not None:
            row, col, data = row[resid], col[resid], data[resid]
    return diag, dplan, (row, col, data)


def build_symmetric_plan(csr: CSR, *, dtype=np.float32,
                         dia: bool = True) -> MatrixPlan:
    """Plan for a symmetric matrix in lower-triangle CSR storage: the
    diagonal, dense strict-lower diagonals (applied to both triangles),
    and both mirror images of the strict-lower residual."""
    assert csr.symmetric, "symmetric plan requires lower-triangle CSR"
    n = csr.nrows
    diag, dplan, (row, col, val) = _split_symmetric(csr, dtype, dia)
    nnz_strict = len(row) + (0 if dplan is None else dplan.nnz)
    resid = None
    if len(row):
        resid = build_ell(
            np.concatenate([row, col]), np.concatenate([col, row]),
            np.concatenate([val, val]), n, n, dtype=dtype,
        )
    plan = MatrixPlan(
        n, n, True, 2 * nnz_strict + int(np.count_nonzero(diag)),
        diag, dplan, resid,
    )
    info(
        "plan: sym n=%d diagonals=%d resid=%d (L=%d, tail=%d)",
        n, 0 if dplan is None else len(dplan.offsets), 2 * len(row),
        0 if resid is None else resid.width,
        0 if resid is None else len(resid.tail_row),
    )
    return plan


def build_general_plan(csr: CSR, *, dtype=np.float32,
                       dia: bool = True) -> MatrixPlan:
    """Plan for a general (or expanded symmetric) matrix: dense signed
    diagonals when they carry at least ``SDIA_PEEL_MIN_FRAC`` of the
    entries (square matrices), the rest one-sided."""
    row = np.repeat(np.arange(csr.nrows, dtype=np.int32), np.diff(csr.indptr))
    col = np.asarray(csr.indices, np.int32)
    val = np.asarray(csr.data)
    dplan = None
    if dia and csr.nrows == csr.ncols and csr.nnz:
        dplan, keep = extract_sdia(
            row, col, val, csr.nrows, dtype=dtype, signed=True,
            fill=SDIA_FILL, min_count=SDIA_MIN_COUNT,
            min_frac=SDIA_PEEL_MIN_FRAC,
        )
        if dplan is not None:
            row, col, val = row[keep], col[keep], val[keep]
    resid = None
    if len(row):
        resid = build_ell(row, col, val, csr.nrows, csr.ncols, dtype=dtype)
    return MatrixPlan(
        csr.nrows, csr.ncols, False, csr.nnz, None, dplan, resid,
    )
