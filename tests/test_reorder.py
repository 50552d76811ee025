"""RCM reordering: permutation validity, bandwidth gain, tuned-path
correctness under P A Pᵀ (locality analog of the reference's METIS
partitioner, ``csr_matrix.tpp:543-639``)."""

import numpy as np

from cfs_spmv.formats.coo import COO
from cfs_spmv.formats.csr import CSR
from cfs_spmv.tuning.reorder import choose_reorder, rcm_permutation
from cfs_spmv.tuning.tune import tune
from cfs_spmv.utils.platform import Format, allclose_spmv

from conftest import random_x


def shuffled_band(n=3000, half_bw=9, seed=0):
    """A banded matrix hidden behind a random row/col shuffle — RCM
    should (largely) recover the band."""
    rng = np.random.default_rng(seed)
    base_rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    base_cols = base_rows - offs
    keep = base_cols >= 0
    shuf = rng.permutation(n)
    r = shuf[base_rows[keep]]
    c = shuf[base_cols[keep]]
    swap = c > r
    r[swap], c[swap] = c[swap], r[swap].copy()
    diag = np.arange(n)
    r = np.concatenate([r, diag])
    c = np.concatenate([c, diag])
    v = np.concatenate(
        [rng.uniform(-1, 1, keep.sum()), rng.uniform(1, 2, n)]
    )
    return CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32), v,
            symmetric=True).canonicalize()
    )


def test_rcm_is_a_permutation():
    csr = shuffled_band()
    perm = rcm_permutation(csr)
    assert sorted(perm) == list(range(csr.nrows))


def test_rcm_recovers_band():
    csr = shuffled_band()
    res, bw0, bw1 = choose_reorder(csr)
    assert res is not None
    assert bw1 < bw0 / 10  # shuffle destroyed locality; RCM restores it


def test_tuned_correct_under_reorder():
    csr = shuffled_band(seed=3)
    t = tune(csr, fmt=Format.SSS, reorder=True)
    assert t.perm is not None
    x = random_x(csr.nrows, np.float32)
    xd = x.astype(np.float64)
    y = np.asarray(t.matvec(x))
    assert allclose_spmv(
        y, csr.spmv_host(xd), np.float32,
        nnz_per_row=t.nnz_full / csr.nrows,
        scale=csr.spmv_host(xd, absolute=True),
    )
    # SpMM under permutation
    X = np.stack([x, 2 * x], axis=1)
    Y = np.asarray(t.matmat(X))
    np.testing.assert_allclose(Y[:, 1], 2 * Y[:, 0], rtol=1e-6)


def test_auto_reorder_skips_banded():
    """Already-local matrices must not pay the gather cost."""
    coo = COO.random(
        2000, 2000, 5.0, symmetric=True, bandwidth=30, seed=1
    )
    t = tune(CSR.from_coo(coo), fmt=Format.SSS, reorder="auto")
    assert t.perm is None


def test_disconnected_components():
    """RCM must cover every component (the BFS restarts)."""
    n = 600
    half = n // 2
    rng = np.random.default_rng(5)
    r1 = rng.integers(0, half, 800)
    c1 = rng.integers(0, half, 800)
    r2 = rng.integers(half, n, 800)
    c2 = rng.integers(half, n, 800)
    r = np.concatenate([np.maximum(r1, c1), np.maximum(r2, c2), np.arange(n)])
    c = np.concatenate([np.minimum(r1, c1), np.minimum(r2, c2), np.arange(n)])
    v = rng.uniform(1, 2, len(r))
    csr = CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32), v,
            symmetric=True).canonicalize()
    )
    perm = rcm_permutation(csr)
    assert sorted(perm) == list(range(n))


def test_sampled_gate_banded_early_exit():
    """Above 4M nnz the block-local early exit runs on a 1M sample:
    a plain band must still be rejected without RCM."""
    n, half_bw = 600_000, 8
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r = np.concatenate([rows[keep], np.arange(n, dtype=np.int64)])
    c = np.concatenate([cols[keep], np.arange(n, dtype=np.int64)])
    v = np.ones(len(r), np.float32)
    csr = CSR.from_coo(COO(n, n, r, c, v, symmetric=True))
    assert csr.nnz > 4_000_000
    res, bw0, bw1 = choose_reorder(csr)
    assert res is None and bw0 <= 1.8 * 128


def test_sampled_gate_hidden_band_still_reordered():
    """A shuffled band above the sampling threshold must still reach
    the full RCM evaluation (sampled bandwidth is far above the gate)."""
    csr = shuffled_band(n=300_000, half_bw=14, seed=3)
    assert csr.nnz > 4_000_000
    res, bw0, bw1 = choose_reorder(csr)
    assert res is not None and bw1 * 2.0 <= bw0
