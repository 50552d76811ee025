"""The ELL + COO-tail residual and the native fp64 path.

Every tuned matrix runs its indexed part as an ELL slab plus a COO tail
(``formats/ell.py``, ``ops/spmv.ell_apply``); fp64 runs the same
streams in float64 (``jax_enable_x64``). The reference runs all kernels
in double under ``--enable-dp`` (``configure.ac``); these tests pin the
split and the appliers on the CPU backend.
"""

import jax.numpy as jnp
import numpy as np

from cfs_spmv.formats.coo import COO
from cfs_spmv.formats.csr import CSR
from cfs_spmv.formats.ell import build_ell, choose_width
from cfs_spmv.ops.spmv import ell_apply, ell_to_device
from cfs_spmv.utils.platform import Format


def _coo(n=700, per_row=5, dense_rows=(3, 77), dense_len=200, seed=0):
    """Skewed: background rows of ~5 nnz plus two dense rows that must
    overflow the chosen ELL width into the COO tail."""
    rng = np.random.default_rng(seed)
    row = np.repeat(np.arange(n, dtype=np.int64), per_row)
    col = rng.integers(0, n, n * per_row)
    for r in dense_rows:
        row = np.concatenate([row, np.full(dense_len, r)])
        col = np.concatenate([col, rng.choice(n, dense_len, replace=False)])
    val = rng.uniform(0.5, 1.5, len(row))
    return COO(n, n, row.astype(np.int64), col.astype(np.int64),
               val).canonicalize()


def _ell(coo):
    return build_ell(coo.row, coo.col, coo.val, coo.nrows, coo.ncols,
                     dtype=np.float64)


def test_build_ell_hyb_partition():
    coo = _coo()
    n = coo.nrows
    e = _ell(coo)
    counts = np.bincount(coo.row, minlength=n)
    L = e.width
    assert L == choose_width(counts) and L < counts.max()  # dense rows overflow
    # every entry lands exactly once: slab nonzeros + tail == nnz
    assert (e.vals != 0).sum() + len(e.tail_val) == coo.nnz
    # tail rows are exactly the overflowing ones
    assert set(np.unique(e.tail_row)) == set(np.where(counts > L)[0])
    x = np.random.default_rng(1).uniform(1, 2, n)
    y = np.asarray(ell_apply(ell_to_device(e), jnp.asarray(x)))
    np.testing.assert_allclose(y, CSR.from_coo(coo).spmv_host(x), rtol=1e-13)


def test_ell_spmm_matches_spmv():
    coo = _coo(seed=2)
    s = ell_to_device(_ell(coo))
    X = np.random.default_rng(3).uniform(1, 2, (coo.nrows, 3))
    Y = np.asarray(ell_apply(s, jnp.asarray(X)))
    for b in range(3):
        np.testing.assert_allclose(
            Y[:, b], np.asarray(ell_apply(s, jnp.asarray(X[:, b]))),
            rtol=1e-13,
        )


def test_tune_fp64_xla_applier():
    """fp64 tune on a skewed general matrix: float64 streams end to
    end."""
    from cfs_spmv.tuning.tune import tune

    coo = _coo(seed=4)
    csr = CSR.from_coo(coo)
    tuned = tune(csr, fmt=Format.CSR, dtype=np.float64)
    assert tuned.plan.resid.vals.dtype == np.float64
    x = np.random.default_rng(5).uniform(1, 2, csr.ncols)
    y = np.asarray(tuned.matvec(x))
    assert y.dtype == np.float64
    np.testing.assert_allclose(y, csr.spmv_host(x), rtol=1e-13)
    X = np.random.default_rng(6).uniform(1, 2, (csr.ncols, 2))
    Y = np.asarray(tuned.matmat(X))
    np.testing.assert_allclose(Y[:, 0], csr.spmv_host(X[:, 0]), rtol=1e-13)


def test_tune_fp64_xla_symmetric_no_remainder():
    """Banded symmetric (uniform degree): the diagonals land on the
    planes, no residual tail remains, and fp64 matches exactly."""
    from cfs_spmv.tuning.tune import tune

    rng = np.random.default_rng(7)
    n, hb = 512, 6
    rows = np.repeat(np.arange(n, dtype=np.int64), hb)
    offs = np.tile(np.arange(1, hb + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    v = rng.uniform(0.5, 1.5, len(r))
    csr = CSR.from_coo(COO(n, n, r, c, v, symmetric=True).canonicalize())
    tuned = tune(csr, fmt=Format.SSS, dtype=np.float64)
    assert tuned.plan.dia is not None and tuned.plan.dia.offsets == tuple(
        range(1, hb + 1)
    )
    assert tuned.operands.resid is None  # uniform band: planes only
    x = rng.uniform(1, 2, n)
    np.testing.assert_allclose(
        np.asarray(tuned.matvec(x)), csr.spmv_host(x), rtol=1e-13
    )
