"""Edge-case battery: degenerate shapes the reference never exercises
(its inputs are SuiteSparse files) but a framework must survive."""

import numpy as np
import pytest

from cfs_spmv import COO, CSR, Format, SparseMatrix, SpDMV, Tuning
from cfs_spmv.tuning.tune import tune
from cfs_spmv.utils.platform import allclose_spmv

from conftest import random_x


def _check(csr, fmt, dtype=np.float32):
    t = tune(csr, fmt=fmt, dtype=dtype)
    x = random_x(csr.ncols, dtype)
    y = np.asarray(t.matvec(x))
    xd = x.astype(np.float64)
    ref = csr.spmv_host(xd)
    assert y.shape == (csr.nrows,)
    assert allclose_spmv(
        y, ref, dtype,
        nnz_per_row=max(csr.nnz, 1) / max(csr.nrows, 1),
        scale=csr.spmv_host(xd, absolute=True),
    )
    return y


def test_one_by_one():
    csr = CSR.from_coo(
        COO(1, 1, np.array([0]), np.array([0]), np.array([2.5]),
            symmetric=True)
    )
    y = _check(csr, Format.SSS)
    assert y.shape == (1,)


def test_empty_matrix():
    csr = CSR(40, 40, np.zeros(41, np.int64), np.zeros(0, np.int32),
              np.zeros(0, np.float64), symmetric=True)
    t = tune(csr, fmt=Format.SSS)
    y = np.asarray(t.matvec(np.ones(40, np.float32)))
    np.testing.assert_array_equal(y, np.zeros(40))


def test_empty_rows_and_cols():
    """Rows with no entries and untouched columns."""
    rng = np.random.default_rng(0)
    n = 700
    r = rng.integers(0, n // 3, 900)  # only the first third of rows
    c = rng.integers(0, n, 900)
    keep = r >= c
    coo = COO(n, n, r[keep], c[keep],
              rng.uniform(1, 2, keep.sum()), symmetric=True)
    _check(CSR.from_coo(coo.canonicalize()), Format.SSS)


def test_rectangular_general():
    coo = COO.random(300, 1000, 4.0, seed=1, dtype=np.float64)
    _check(CSR.from_coo(coo), Format.CSR)
    coo2 = COO.random(1000, 130, 3.0, seed=2, dtype=np.float64)
    _check(CSR.from_coo(coo2), Format.CSR)


def test_odd_sizes():
    """Dimensions straddling tile boundaries."""
    for n in (127, 128, 129, 1023, 1025):
        coo = COO.random(n, n, 3.0, symmetric=True, bandwidth=20,
                         seed=n, dtype=np.float64)
        _check(CSR.from_coo(coo), Format.SSS)


def test_single_dense_row():
    """One fully dense row (stresses window capacity)."""
    n = 600
    r = np.full(n, n - 1, np.int64)
    c = np.arange(n, dtype=np.int64)
    v = np.random.default_rng(3).uniform(1, 2, n)
    coo = COO(n, n, r, c, v, symmetric=True).canonicalize()
    _check(CSR.from_coo(coo), Format.SSS)


def test_spmm_single_rhs_column():
    coo = COO.random(400, 400, 4.0, symmetric=True, bandwidth=30,
                     seed=4, dtype=np.float64)
    A = SparseMatrix.create(coo, Format.SSS)
    sp = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float32)
    X = random_x(400, np.float32)[:, None]  # (n, 1)
    Y = np.asarray(sp(X))
    assert Y.shape == (400, 1)
    y1 = np.asarray(sp(X[:, 0]))
    # mm and mv kernels sum in different orders: fp32 rounding only
    np.testing.assert_allclose(Y[:, 0], y1, rtol=1e-5, atol=1e-5)


def test_duplicate_coordinates_summed():
    r = np.array([0, 0, 1, 1, 1])
    c = np.array([0, 0, 0, 1, 1])
    v = np.array([1.0, 2.0, 5.0, 3.0, 4.0])
    coo = COO(2, 2, r, c, v, symmetric=True).canonicalize()
    csr = CSR.from_coo(coo)
    assert csr.nnz == 3
    y = _check(csr, Format.SSS)
    # A = [[3, 5], [5, 7]]
    np.testing.assert_allclose(
        np.asarray(y),
        np.array([[3.0, 5.0], [5.0, 7.0]]) @ np.asarray(
            random_x(2, np.float32), np.float64
        ),
        rtol=1e-5,
    )
