"""SDIA dense-diagonal stream: extraction + applier correctness.

Differential oracle pattern of the reference test harness
(``test_spmv_mmf.cpp:85-89``): tuned path vs fp64 host CSR kernel.
"""

import numpy as np

from cfs_spmv.formats.coo import COO
from cfs_spmv.formats.csr import CSR
from cfs_spmv.formats.plan import build_symmetric_plan
from cfs_spmv.formats.sdia import extract_sdia
from cfs_spmv.ops import spmv as ops
from cfs_spmv.utils.platform import allclose_spmv

from conftest import random_x


def banded_sym(n, half_bw, seed=0, holes=0.0, dtype=np.float64):
    """Symmetric banded matrix with optional random holes."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    if holes:
        keep &= rng.uniform(size=len(rows)) > holes
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1.0, 1.0, len(rows)).astype(dtype)
    diag = np.arange(n, dtype=np.int64)
    r = np.concatenate([rows, diag])
    c = np.concatenate([cols, diag])
    v = np.concatenate([vals, rng.uniform(1.0, 2.0, n).astype(dtype)])
    return CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32), v,
            symmetric=True).canonicalize()
    )


def _check(csr, *, dtype=np.float32):
    plan = build_symmetric_plan(csr, dtype=dtype)
    dev = ops.to_device(plan)
    x = random_x(csr.nrows, dtype)
    y = np.asarray(ops.matrix_apply(dev, x))
    xd = x.astype(np.float64)
    ref = csr.spmv_host(xd)
    assert allclose_spmv(
        y, ref, dtype,
        nnz_per_row=plan.nnz_full / csr.nrows,
        scale=csr.spmv_host(xd, absolute=True),
    )
    return plan


def test_extract_sdia_selects_dense_diagonals():
    csr = banded_sym(2000, 12, seed=3)
    lower, _, _ = csr.split_triangle()
    row = np.repeat(np.arange(csr.nrows), np.diff(lower.indptr))
    plan, resid = extract_sdia(
        row, lower.indices.astype(np.int64), np.asarray(lower.data),
        csr.nrows, min_count=8, fill=0.3,
    )
    assert plan is not None
    assert plan.offsets == tuple(range(1, 13))
    assert plan.nnz == lower.nnz
    assert not resid.any()
    # value placement round-trip: plane j holds diagonal offsets[j] at
    # the diagonal's row index
    assert plan.vals.shape == (12, csr.nrows)
    g = 1234
    d = 5
    got = plan.vals[plan.offsets.index(d), g]
    m = (np.repeat(np.arange(csr.nrows), np.diff(csr.indptr)) == g) & (
        csr.indices == g - d
    )
    assert got == np.asarray(csr.data)[m][0].astype(np.float32)


def test_pure_banded_uses_dia_only():
    csr = banded_sym(3000, 10, seed=1)
    plan = _check(csr)
    assert plan.dia is not None
    assert plan.resid is None


def test_banded_with_holes_splits_streams():
    csr = banded_sym(3000, 10, seed=2, holes=0.45)
    plan = _check(csr)
    assert plan.dia is not None  # fill 0.55 clears SDIA_FILL


def test_large_offsets_cross_sublane_groups():
    """Stencil-like: short and long offsets in one plane set."""
    n = 4000
    rng = np.random.default_rng(9)
    parts = []
    for d in (1, 2, 127, 128, 129, 300, 1025, 1153, 2600):
        g = np.arange(d, n, dtype=np.int64)
        parts.append((g, g - d))
    r = np.concatenate([p[0] for p in parts])
    c = np.concatenate([p[1] for p in parts])
    v = rng.uniform(-1, 1, len(r))
    diag = np.arange(n, dtype=np.int64)
    r = np.concatenate([r, diag])
    c = np.concatenate([c, diag])
    v = np.concatenate([v, rng.uniform(1, 2, n)])
    csr = CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32), v,
            symmetric=True).canonicalize()
    )
    plan = _check(csr)
    assert plan.dia is not None
    assert 1025 in plan.dia.offsets and 2600 in plan.dia.offsets


def test_mixed_dia_paired_far():
    """Dense diagonals + scattered residual: diagonal, planes and the
    ELL residual all active."""
    n = 2500
    base = banded_sym(n, 6, seed=5).to_coo()
    scat = COO.random(n, n, 2.0, symmetric=True, seed=6, dtype=np.float64)
    coo = COO(
        n, n,
        np.concatenate([base.row, scat.row]),
        np.concatenate([base.col, scat.col]),
        np.concatenate([base.val, scat.val]),
        symmetric=True,
    ).canonicalize()
    csr = CSR.from_coo(coo)
    plan = _check(csr)
    assert plan.dia is not None
    assert plan.resid is not None


def test_sdia_spmm():
    csr = banded_sym(2000, 9, seed=7)
    plan = build_symmetric_plan(csr, dtype=np.float32)
    assert plan.dia is not None
    dev = ops.to_device(plan)
    X = np.random.default_rng(8).uniform(1, 2, (csr.nrows, 4)).astype(
        np.float32
    )
    Y = np.asarray(ops.matrix_apply(dev, X))
    for b in range(4):
        ref = csr.spmv_host(X[:, b].astype(np.float64))
        assert allclose_spmv(
            Y[:, b], ref, np.float32,
            nnz_per_row=plan.nnz_full / csr.nrows,
            scale=csr.spmv_host(X[:, b].astype(np.float64), absolute=True),
        )


def test_fp64_dia():
    csr = banded_sym(1500, 7, seed=10)
    _check(csr, dtype=np.float64)
