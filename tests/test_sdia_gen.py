"""Signed-offset (general) SDIA stream tests.

Covers the one-sided diagonal applier (``ops/spmv.dia_apply`` with
``sym=False``): the general-matrix diagonal peel, its acceptance gate,
and agreement with the symmetric two-sided form."""

import numpy as np
import pytest

from cfs_spmv import COO, CSR, Format, SparseMatrix, SpDMV, Tuning
from cfs_spmv.utils.platform import allclose_spmv
from conftest import random_x


def _banded_general(n=3000, offs=(-700, -3, -1, 2, 128, 601), seed=0,
                    frac=0.9):
    """General (asymmetric) matrix with dense diagonals + noise."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for d in offs:
        g = np.arange(max(0, d), min(n, n + d))
        keep = rng.random(len(g)) < frac
        g = g[keep]
        rows.append(g)
        cols.append(g - d)
        vals.append(rng.uniform(-1, 1, len(g)))
    scat = COO.random(n, n, 1.5, seed=seed + 1)
    rows.append(scat.row.astype(np.int64))
    cols.append(scat.col.astype(np.int64))
    vals.append(scat.val)
    d = np.arange(n)
    rows.append(d)
    cols.append(d)
    vals.append(rng.uniform(1, 2, n))
    coo = COO(
        n, n, np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals).astype(np.float64),
    ).canonicalize()
    return CSR.from_coo(coo)


def test_general_dia_peel_correct():
    csr = _banded_general()
    from cfs_spmv.formats.plan import build_general_plan

    plan = build_general_plan(csr, dtype=np.float64)
    assert plan.dia is not None
    assert any(d < 0 for d in plan.dia.offsets)  # super-diagonals peeled
    assert any(d > 0 for d in plan.dia.offsets)
    from cfs_spmv.ops import spmv as ops

    dev = ops.to_device(plan)
    x = random_x(csr.ncols, np.float64)
    y = np.asarray(ops.matrix_apply(dev, x))
    ref = csr.spmv_host(x)
    assert allclose_spmv(
        y, ref, np.float64, nnz_per_row=csr.nnz / csr.nrows,
        scale=csr.spmv_host(x, absolute=True),
    )
    # SpMM path
    X = np.random.default_rng(3).uniform(1, 2, (csr.ncols, 3))
    Y = np.asarray(ops.matrix_apply(dev, X))
    for b in range(3):
        assert allclose_spmv(
            Y[:, b], csr.spmv_host(X[:, b]), np.float64,
            nnz_per_row=csr.nnz / csr.nrows,
            scale=csr.spmv_host(X[:, b], absolute=True),
        )


def test_general_tune_uses_dia():
    """tune() on a general banded matrix routes diagonals to SDIA under
    aggressive tuning and stays on the plain path for the oracle."""
    csr = _banded_general(n=2000)
    A = SparseMatrix.create(csr, Format.CSR)
    sp = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float64)
    assert getattr(A.tuned.plan, "dia", None) is not None
    x = random_x(2000, np.float64)
    y = np.asarray(sp(x))
    assert allclose_spmv(
        y, csr.spmv_host(x), np.float64,
        nnz_per_row=csr.nnz / 2000,
        scale=csr.spmv_host(x, absolute=True),
    )


@pytest.mark.parametrize("mirror", [False, True])
def test_sym_mirror_matches(mirror):
    """The symmetric two-sided planes (one value per pair) and the
    mirrored form (the expanded matrix's signed ±d planes, one-sided)
    must both equal the host oracle."""
    n, half_bw = 4096, 5
    rng = np.random.default_rng(11)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    v = np.concatenate(
        [rng.uniform(-1, 1, keep.sum()), rng.uniform(1, 2, n)]
    )
    csr = CSR.from_coo(
        COO(n, n, r, c, v, symmetric=True).canonicalize()
    )
    from cfs_spmv.formats.plan import (
        build_general_plan,
        build_symmetric_plan,
    )
    from cfs_spmv.ops import spmv as ops

    if mirror:
        plan = build_general_plan(
            CSR.from_coo(csr.to_coo().expand_symmetric()), dtype=np.float64
        )
    else:
        plan = build_symmetric_plan(csr, dtype=np.float64)
    assert plan.dia is not None
    assert any(d < 0 for d in plan.dia.offsets) == mirror
    dev = ops.to_device(plan)
    x = random_x(n, np.float64)
    y = np.asarray(ops.matrix_apply(dev, x))
    ref = csr.spmv_host(x)
    assert allclose_spmv(
        y, ref, np.float64, nnz_per_row=2 * half_bw + 1,
        scale=csr.spmv_host(x, absolute=True),
    )
    X = np.random.default_rng(4).uniform(1, 2, (n, 2))
    Y = np.asarray(ops.matrix_apply(dev, X))
    for b in range(2):
        assert allclose_spmv(
            Y[:, b], csr.spmv_host(X[:, b]), np.float64,
            nnz_per_row=2 * half_bw + 1,
            scale=csr.spmv_host(X[:, b], absolute=True),
        )


def test_thin_peel_rejected():
    """A general matrix whose only dense diagonal carries ~2% of nnz
    must NOT peel: the diagonal pass reads all of x and y however few
    diagonals it holds, while the folded-back main diagonal costs the
    residual only its own slots. The gate is ``SDIA_PEEL_MIN_FRAC`` in
    ``build_general_plan``."""
    from cfs_spmv.formats.plan import build_general_plan
    from cfs_spmv.ops import spmv as ops

    n = 3000
    rng = np.random.default_rng(3)
    # ~50 scattered entries per row + a full main diagonal (~2%)
    row = np.repeat(np.arange(n, dtype=np.int64), 50)
    col = rng.integers(0, n, n * 50)
    d = np.arange(n, dtype=np.int64)
    coo = COO(
        n, n,
        np.concatenate([row, d]),
        np.concatenate([col, d]),
        rng.uniform(-1, 1, n * 51).astype(np.float64),
    ).canonicalize()
    csr = CSR.from_coo(coo)
    plan = build_general_plan(csr, dtype=np.float64)
    assert plan.dia is None  # thin peel rejected by the gate
    dev = ops.to_device(plan)
    x = random_x(n, np.float64)
    y = np.asarray(ops.matrix_apply(dev, x))
    ref = csr.spmv_host(x)
    assert allclose_spmv(
        y, ref, np.float64, nnz_per_row=csr.nnz / n,
        scale=csr.spmv_host(x, absolute=True),
    )
