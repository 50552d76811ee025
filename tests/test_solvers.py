"""Iterative solver models on tuned operators (CG, BiCGSTAB, Jacobi,
Chebyshev, power iteration, Lanczos): convergence against dense solves."""

import jax.numpy as jnp
import numpy as np
import pytest

from cfs_spmv import COO, CSR, Format
from cfs_spmv.models import solvers
from cfs_spmv.tuning.tune import tune


def spd_system(n=700, half_bw=5, seed=0):
    """Diagonally dominant symmetric (hence SPD) banded system."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    offv = rng.uniform(-1, 1, keep.sum())
    v = np.concatenate([offv, np.full(n, 2.0 * half_bw + 1.0)])
    csr = CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32),
            v.astype(np.float64), symmetric=True).canonicalize()
    )
    x_true = rng.uniform(-1, 1, n).astype(np.float32)
    b = csr.spmv_host(x_true.astype(np.float64)).astype(np.float32)
    return csr, x_true, b


@pytest.fixture(scope="module")
def spd():
    return spd_system()


def test_cg_converges(spd):
    csr, x_true, b = spd
    t = tune(csr, fmt=Format.SSS)
    x, resid, hist = solvers.cg(t.matvec, jnp.asarray(b), iters=80)
    assert float(resid) < 1e-3 * np.linalg.norm(b)
    assert np.allclose(np.asarray(x), x_true, atol=5e-3)
    assert hist[-1] < hist[0]


def test_cg_under_reorder():
    """Solver in permuted space must decode back to user ordering."""
    csr0, x_true, b = spd_system(n=2500, seed=2)
    # shuffle to force RCM (needs bw > the 2-tile block-local early-out)
    n = csr0.nrows
    rng = np.random.default_rng(3)
    shuf = rng.permutation(n)
    coo = csr0.to_coo()
    r, c = shuf[coo.row], shuf[coo.col]
    swap = c > r
    r[swap], c[swap] = c[swap], r[swap].copy()
    csr = CSR.from_coo(
        COO(n, n, r, c, coo.val.copy(), symmetric=True).canonicalize()
    )
    t = tune(csr, fmt=Format.SSS, reorder=True)
    assert t.perm is not None
    x_ref = np.linalg.solve(csr.to_coo().to_dense(), np.ones(n))
    x, resid, _ = solvers.cg(
        t.matvec, jnp.ones(n, jnp.float32), iters=100
    )
    assert np.allclose(np.asarray(x), x_ref, atol=5e-3)


def test_bicgstab_general():
    """Nonsymmetric diagonally dominant system."""
    rng = np.random.default_rng(1)
    n = 500
    r = rng.integers(0, n, 2500)
    c = rng.integers(0, n, 2500)
    v = rng.uniform(-0.2, 0.2, 2500)
    r = np.concatenate([r, np.arange(n)])
    c = np.concatenate([c, np.arange(n)])
    v = np.concatenate([v, np.full(n, 8.0)])
    coo = COO(n, n, r.astype(np.int32), c.astype(np.int32),
              v.astype(np.float64)).canonicalize()
    csr = CSR.from_coo(coo)
    t = tune(csr, fmt=Format.CSR, reorder=False)
    x_true = rng.uniform(-1, 1, n).astype(np.float32)
    b = csr.spmv_host(x_true.astype(np.float64)).astype(np.float32)
    x, resid, _ = solvers.bicgstab(t.matvec, jnp.asarray(b), iters=60)
    assert np.allclose(np.asarray(x), x_true, atol=5e-3)


def test_jacobi_and_chebyshev(spd):
    csr, x_true, b = spd
    t = tune(csr, fmt=Format.SSS)
    _, diag, _ = csr.split_triangle()
    xj, hist = solvers.jacobi(
        t.matvec, jnp.asarray(diag.astype(np.float32)),
        jnp.asarray(b), iters=200, omega=0.9,
    )
    assert hist[-1] < 1e-2 * hist[0]
    # spectral bounds from Gershgorin (diag dominant)
    lam_max = float(2 * (2 * 5 + 1))
    lam_min = 1.0
    xc, hist_c = solvers.chebyshev(
        t.matvec, jnp.asarray(b), lam_min, lam_max, iters=200
    )
    assert hist_c[-1] < 1e-2 * hist_c[0]
    assert np.allclose(np.asarray(xc), x_true, atol=2e-2)


def test_power_and_lanczos(spd):
    csr, _, _ = spd
    t = tune(csr, fmt=Format.SSS)
    dense = csr.to_coo().to_dense()
    lam_true = np.max(np.abs(np.linalg.eigvalsh(dense)))
    _, lam = solvers.power_iteration(t.matvec, csr.nrows, iters=200)
    assert abs(float(lam) - lam_true) / lam_true < 5e-2
    alphas, betas = solvers.lanczos(t.matvec, csr.nrows, iters=60)
    T = np.diag(np.asarray(alphas)) + np.diag(
        np.asarray(betas)[:-1], 1
    ) + np.diag(np.asarray(betas)[:-1], -1)
    ev = np.linalg.eigvalsh(T)
    assert abs(ev.max() - lam_true) / lam_true < 5e-2


def test_gmres_general():
    rng = np.random.default_rng(6)
    n = 400
    r = rng.integers(0, n, 1600)
    c = rng.integers(0, n, 1600)
    v = rng.uniform(-0.3, 0.3, 1600)
    r = np.concatenate([r, np.arange(n)])
    c = np.concatenate([c, np.arange(n)])
    v = np.concatenate([v, np.full(n, 6.0)])
    csr = CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32),
            v.astype(np.float64)).canonicalize()
    )
    t = tune(csr, fmt=Format.CSR, reorder=False)
    x_true = rng.uniform(-1, 1, n).astype(np.float32)
    b = csr.spmv_host(x_true.astype(np.float64)).astype(np.float32)
    x, resid, betas = solvers.gmres(
        t.matvec, jnp.asarray(b), restart=25, outer=4
    )
    assert float(resid) < 1e-3 * np.linalg.norm(b)
    assert np.allclose(np.asarray(x), x_true, atol=5e-3)
    assert betas[-1] < betas[0]


def test_pcg_jacobi_beats_cg_on_illconditioned():
    """Jacobi-PCG on a badly scaled SPD system converges faster."""
    rng = np.random.default_rng(11)
    n = 800
    scale = 10.0 ** rng.uniform(-2, 2, n)  # wild row scaling
    rows = np.repeat(np.arange(n, dtype=np.int64), 3)
    offs = np.tile(np.arange(1, 4, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    off_v = rng.uniform(-0.5, 0.5, keep.sum()) * np.sqrt(
        scale[rows[keep]] * scale[cols[keep]]
    )
    v = np.concatenate([off_v, 7.0 * scale])
    csr = CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32),
            v.astype(np.float64), symmetric=True).canonicalize()
    )
    t = tune(csr, fmt=Format.SSS)
    _, diag, _ = csr.split_triangle()
    x_true = rng.uniform(-1, 1, n).astype(np.float32)
    b = csr.spmv_host(x_true.astype(np.float64)).astype(np.float32)
    _, r_plain, _ = solvers.cg(t.matvec, jnp.asarray(b), iters=40)
    xp, r_pcg, _ = solvers.cg(
        t.matvec, jnp.asarray(b), iters=40,
        diag_precond=jnp.asarray(diag.astype(np.float32)),
    )
    assert float(r_pcg) < float(r_plain)
    assert np.allclose(np.asarray(xp), x_true, atol=1e-2)
