"""Differential SpMV/SpMM correctness tests.

Replicates the reference harness pattern (``test_spmv_mmf.cpp:31-120``):
load → tune → run the tuned kernel TWICE (catches cross-call state
corruption) → compare element-wise against the untuned serial oracle
under the reference tolerances, on the CPU backend.
"""

import numpy as np
import pytest

from cfs_spmv import COO, CSR, Format, SpDMM, SpDMV, SparseMatrix, Tuning
from cfs_spmv.utils.platform import allclose_spmv
from conftest import random_x


def _check(A: SparseMatrix, x, dtype):
    spdmv = SpDMV(A, Tuning.AGGRESSIVE, dtype=dtype)
    y1 = np.asarray(spdmv(x))
    y2 = np.asarray(spdmv(x))  # twice, ref test_spmv_mmf.cpp:82-83
    np.testing.assert_array_equal(y1, y2)
    xd = np.asarray(x, dtype=np.float64)
    y_ref = A.csr.spmv_host(xd)
    scale = A.csr.spmv_host(xd, absolute=True)
    nnz_per_row = A.nnz_full / max(A.nrows, 1)
    assert allclose_spmv(
        y1, y_ref, dtype=dtype, nnz_per_row=nnz_per_row, scale=scale
    ), np.max(np.abs(y1 - y_ref) / np.maximum(scale, 1e-30))
    return y1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_general_banded(medium_general_coo, dtype):
    A = SparseMatrix.create(medium_general_coo, Format.CSR)
    x = random_x(A.ncols, dtype)
    _check(A, x, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_symmetric_sss(small_sym_coo, dtype):
    A = SparseMatrix.create(small_sym_coo, Format.SSS)
    assert A.symmetric
    x = random_x(A.ncols, dtype)
    _check(A, x, dtype)


def test_symmetric_as_general_csr_matches_sss(small_sym_coo):
    """csr vs sss on the same matrix must agree (differential between
    formats, the reference's central test idea)."""
    A_sss = SparseMatrix.create(small_sym_coo, Format.SSS)
    A_csr = SparseMatrix.create(small_sym_coo, Format.CSR)
    x = random_x(A_sss.ncols, np.float64)
    y_s = np.asarray(SpDMV(A_sss, dtype=np.float64)(x))
    y_c = np.asarray(SpDMV(A_csr, dtype=np.float64)(x))
    assert allclose_spmv(y_s, y_c, dtype=np.float64, nnz_per_row=8)


def test_scattered_spill_path(scattered_coo):
    """Unbanded matrix: a real spill fraction must still be exact."""
    A = SparseMatrix.create(scattered_coo, Format.CSR)
    x = random_x(A.ncols, np.float64)
    _check(A, x, np.float64)
    assert A.tuned.spill_fraction >= 0  # path exercised


def test_hyb_format(small_sym_coo):
    A = SparseMatrix.create(small_sym_coo, Format.HYB)
    x = random_x(A.ncols, np.float64)
    _check(A, x, np.float64)


def test_mmf_end_to_end(tmp_path, small_sym_coo):
    """Full reference flow: write .mtx → create(sss) → tune → spmv →
    compare vs oracle (BASELINE config 1 shape)."""
    from cfs_spmv.io.mmf import write_mmf

    p = tmp_path / "m.mtx"
    write_mmf(
        p, small_sym_coo.nrows, small_sym_coo.ncols,
        small_sym_coo.row, small_sym_coo.col, small_sym_coo.val,
        symmetric=True,
    )
    A = SparseMatrix.create(str(p), Format.SSS)
    x = random_x(A.ncols, np.float64)
    _check(A, x, np.float64)


def test_spmm_multi_rhs(medium_general_coo):
    A = SparseMatrix.create(medium_general_coo, Format.CSR)
    B = 4
    x = np.stack(
        [random_x(A.ncols, np.float64, seed=s) for s in range(B)], axis=1
    )
    Y = np.asarray(SpDMM(A, dtype=np.float64)(x))
    assert Y.shape == (A.nrows, B)
    for k in range(B):
        y_ref = A.csr.spmv_host(x[:, k])
        assert allclose_spmv(Y[:, k], y_ref, dtype=np.float64, nnz_per_row=9)


def test_spmm_symmetric(small_sym_coo):
    A = SparseMatrix.create(small_sym_coo, Format.SSS)
    B = 3
    x = np.stack(
        [random_x(A.ncols, np.float64, seed=s) for s in range(B)], axis=1
    )
    Y = np.asarray(SpDMM(A, dtype=np.float64)(x))
    for k in range(B):
        y_ref = A.csr.spmv_host(x[:, k])
        assert allclose_spmv(Y[:, k], y_ref, dtype=np.float64, nnz_per_row=8)


def test_dimension_check(small_sym_coo):
    A = SparseMatrix.create(small_sym_coo, Format.SSS)
    spdmv = SpDMV(A, dtype=np.float64)
    with pytest.raises(ValueError):
        spdmv(np.ones(A.ncols + 1))


def test_property_random_matrices():
    """Property test over random shapes/densities (reference lacks this;
    SURVEY §4 asks us to add it)."""
    rng = np.random.default_rng(0)
    for trial in range(6):
        n = int(rng.integers(1, 400))
        m = int(rng.integers(1, 400))
        density = rng.uniform(0.5, 6.0)
        bw = None if trial % 2 else int(rng.integers(1, 100))
        coo = COO.random(n, m, density, bandwidth=bw, seed=trial,
                         dtype=np.float64)
        A = SparseMatrix.create(coo, Format.CSR)
        x = random_x(m, np.float64, seed=trial)
        _check(A, x, np.float64)


def test_bfloat16_value_storage(small_sym_coo=None):
    """values='bfloat16' halves stream bytes; f32 accumulate, bf16
    tolerances."""
    import jax.numpy as jnp

    from cfs_spmv.formats.coo import COO
    from cfs_spmv.formats.csr import CSR
    from cfs_spmv.tuning.tune import tune
    from cfs_spmv.utils.platform import Format, allclose_spmv
    from conftest import random_x

    coo = COO.random(2000, 2000, 6.0, symmetric=True, bandwidth=50,
                     seed=21, dtype=np.float64)
    csr = CSR.from_coo(coo)
    t32 = tune(csr, fmt=Format.SSS)
    tbf = tune(csr, fmt=Format.SSS, values="bfloat16")
    assert tbf.plan.resid.vals.dtype == jnp.bfloat16
    assert tbf.stream_bytes() < t32.stream_bytes()
    x = random_x(csr.nrows, np.float32)
    y = np.asarray(tbf.matvec(x))
    assert y.dtype == np.float32
    xd = x.astype(np.float64)
    assert allclose_spmv(
        y, csr.spmv_host(xd), jnp.bfloat16,
        nnz_per_row=tbf.nnz_full / csr.nrows,
        scale=csr.spmv_host(xd, absolute=True),
    )


def test_bfloat16_plan_cache(tmp_path):
    import jax.numpy as jnp

    from cfs_spmv.formats.coo import COO
    from cfs_spmv.formats.csr import CSR
    from cfs_spmv.tuning.tune import tune
    from cfs_spmv.utils.platform import Format

    coo = COO.random(800, 800, 4.0, symmetric=True, bandwidth=40,
                     seed=22, dtype=np.float64)
    csr = CSR.from_coo(coo)
    d = str(tmp_path)
    t1 = tune(csr, fmt=Format.SSS, values="bfloat16", cache_dir=d)
    t2 = tune(csr, fmt=Format.SSS, values="bfloat16", cache_dir=d)
    assert t2.plan.resid.vals.dtype == jnp.bfloat16
    x = np.random.default_rng(0).uniform(1, 2, csr.nrows).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(t1.matvec(x)), np.asarray(t2.matvec(x))
    )


def test_spdmv_retunes_on_config_change(small_sym_coo):
    """A second SpDMV on the same matrix with a different configuration
    must retune, not silently reuse the cached plan (round-4 verify
    drive: SpDMV(A, dtype=np.float64) after a float32 SpDMV fed fp64 x
    into the float32 plan)."""
    A = SparseMatrix.create(small_sym_coo, Format.SSS)
    x32 = random_x(A.ncols, np.float32)
    y32 = np.asarray(SpDMV(A, dtype=np.float32)(x32))
    plan32 = A.tuned

    xd = x32.astype(np.float64)
    yd = np.asarray(SpDMV(A, dtype=np.float64)(xd))
    assert A.tuned is not plan32  # retuned
    assert yd.dtype == np.float64
    y_ref = A.csr.spmv_host(xd)
    scale = A.csr.spmv_host(xd, absolute=True)
    assert allclose_spmv(
        yd, y_ref, dtype=np.float64,
        nnz_per_row=A.nnz_full / A.nrows, scale=scale,
    )
    # same config again -> plan reused, result unchanged
    tuned_64 = A.tuned
    SpDMV(A, dtype=np.float64)
    assert A.tuned is tuned_64
    np.testing.assert_array_equal(
        y32, np.asarray(SpDMV(A, dtype=np.float32)(x32))
    )


def test_spdmv_respects_explicit_user_tune(small_sym_coo):
    """An explicit A.tune(...) with non-default preference kwargs is
    authoritative: a following default SpDMV(A) must NOT silently
    re-run preprocessing over it (review r4). dtype mismatches still
    force a retune (correctness)."""
    A = SparseMatrix.create(small_sym_coo, Format.SSS)
    A.tune(dtype=np.float32, reorder=False)
    plan = A.tuned
    SpDMV(A)  # defaults (reorder="auto") — must reuse
    assert A.tuned is plan
    SpDMV(A, dtype=np.float64)  # dtype change — must retune
    assert A.tuned is not plan
