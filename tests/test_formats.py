"""Host format tests: COO/CSR containers and conversions."""

import numpy as np

from cfs_spmv.formats.coo import COO
from cfs_spmv.formats.csr import CSR


def test_coo_canonicalize_dedups():
    coo = COO(
        3, 3,
        np.array([2, 0, 2, 0], np.int32),
        np.array([1, 0, 1, 0], np.int32),
        np.array([1.0, 2.0, 3.0, 4.0]),
    ).canonicalize()
    assert coo.nnz == 2
    assert coo.val.tolist() == [6.0, 4.0]


def test_csr_from_coo_empty_rows():
    # ref csr_matrix.tpp:91-103 empty-row fill
    coo = COO(
        4, 4,
        np.array([0, 3], np.int32),
        np.array([1, 2], np.int32),
        np.array([1.0, 2.0]),
    )
    csr = CSR.from_coo(coo)
    assert csr.indptr.tolist() == [0, 1, 1, 1, 2]
    assert csr.row_lengths.tolist() == [1, 0, 0, 1]


def test_csr_transpose():
    coo = COO.random(50, 30, 4.0, seed=5, dtype=np.float64)
    csr = CSR.from_coo(coo)
    t = csr.transpose()
    assert (t.nrows, t.ncols) == (30, 50)
    assert np.allclose(t.to_coo().to_dense(), coo.to_dense().T)


def test_split_triangle():
    coo = COO.random(40, 40, 5.0, symmetric=True, seed=6, dtype=np.float64)
    full = CSR.from_coo(coo.expand_symmetric())
    lo, diag, up = full.split_triangle()
    dense = coo.to_dense()
    assert np.allclose(np.diag(dense), diag)
    assert np.allclose(
        lo.to_coo().to_dense() + np.diag(diag) + up.to_coo().to_dense(),
        dense,
    )
    # symmetric: upper == lowerᵀ
    assert np.allclose(up.to_coo().to_dense(), lo.to_coo().to_dense().T)


def test_symmetric_nnz_full():
    coo = COO.random(30, 30, 3.0, symmetric=True, seed=7)
    ndiag = int(np.count_nonzero(coo.row == coo.col))
    assert coo.nnz_full == 2 * coo.nnz - ndiag


def test_spmv_host_oracle_symmetric():
    coo = COO.random(64, 64, 4.0, symmetric=True, seed=8, dtype=np.float64)
    csr_sym = CSR.from_coo(coo)  # lower-triangle storage
    x = np.random.default_rng(0).uniform(10.01, 20.42, 64)
    y = csr_sym.spmv_host(x)
    y_dense = coo.to_dense() @ x
    assert np.allclose(y, y_dense, rtol=1e-12)


def test_csr_validate():
    import pytest

    from cfs_spmv.formats.coo import COO
    from cfs_spmv.formats.csr import CSR

    good = CSR.from_coo(COO.random(100, 100, 3.0, seed=0))
    assert good.validate() is good

    bad = CSR(100, 100, good.indptr, good.indices.copy(), good.data)
    bad.indices[0] = 105  # out of range
    with pytest.raises(ValueError):
        bad.validate()

    bad2 = CSR(100, 100, good.indptr[:-2], good.indices, good.data)
    with pytest.raises(ValueError):
        bad2.validate()

    sym = CSR.from_coo(
        COO.random(100, 100, 3.0, seed=1, symmetric=True)
    )
    assert sym.validate() is sym
    notlower = CSR(sym.nrows, sym.ncols, sym.indptr, sym.indices,
                   sym.data, symmetric=True)
    notlower.indices = notlower.indices.copy()
    if notlower.nnz:
        notlower.indices[0] = 99  # above the diagonal for row 0
        with pytest.raises(ValueError):
            notlower.validate()


def test_scipy_interop():
    import pytest

    scipy = pytest.importorskip("scipy")
    import scipy.sparse as sp

    from cfs_spmv import Format, SparseMatrix
    from cfs_spmv.formats.csr import CSR
    from conftest import random_x

    rng = np.random.default_rng(0)
    d = sp.random(300, 300, density=0.02, random_state=1, format="csr")
    m = (d + d.T).tocsr()  # symmetric
    csr = CSR.from_scipy(m, symmetric=True)
    assert csr.symmetric
    x = rng.uniform(1, 2, 300)
    np.testing.assert_allclose(
        csr.spmv_host(x), m @ x, rtol=1e-12, atol=1e-12
    )
    # round-trip
    back = csr.to_scipy()
    assert (back != m).nnz == 0

    # factory accepts scipy directly
    A = SparseMatrix.create(m, Format.SSS)
    y = np.asarray(A.dense_vector_multiply(x.astype(np.float64)))
    np.testing.assert_allclose(y, m @ x, rtol=1e-8)

    with pytest.raises(ValueError):
        CSR.from_scipy(d, symmetric=True)  # not symmetric
