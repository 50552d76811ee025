"""Differential test: structure × value type × apply against the host
oracle (``CSR.spmv_host``, the analog of the reference's serial kernel,
``test_spmv_mmf.cpp:85-89``).

Every case runs the normal path (``tune`` → ``matvec``/``matmat``) on the
CPU backend; the same appliers run compiled on a GPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from cfs_spmv import COO, CSR
from cfs_spmv.tuning.tune import tune
from cfs_spmv.utils import proxies
from cfs_spmv.utils.platform import Format, allclose_spmv


def _empty_rows():
    """General matrix whose rows are mostly empty (and one empty
    column block)."""
    rng = np.random.default_rng(1)
    n = 500
    row = rng.choice(np.arange(0, n, 7), 900)
    col = rng.integers(0, n - 100, 900)
    return CSR.from_coo(
        COO(n, n, row, col, rng.uniform(-1, 1, 900)).canonicalize()
    )


def _one_by_one():
    return CSR.from_coo(
        COO(1, 1, np.array([0]), np.array([0]), np.array([2.5]))
    )


def _non_square():
    return CSR.from_coo(
        COO.random(700, 450, 6.0, bandwidth=120, seed=5, dtype=np.float64)
    )


def _scattered_sym():
    return CSR.from_coo(
        COO.random(900, 900, 8.0, symmetric=True, seed=3, dtype=np.float64)
    )


STRUCTURES = {
    "cant": lambda: proxies.cant_proxy(n=3000, half_bw=8),
    "stencil27": lambda: proxies.stencil27(g=12),
    "audikw_proxy": lambda: proxies.audikw_proxy(nb=700),
    "general_asym": lambda: proxies.general_asym(g=12),
    "random_band": lambda: proxies.random_band(n=2000, per_row=8,
                                               half_bw=200),
    "near_band_paired": lambda: proxies.near_band_paired(
        n=3000, n_diags=24, max_off=300
    ),
    "scattered": _scattered_sym,
    "empty_rows": _empty_rows,
    "one_by_one": _one_by_one,
    "non_square": _non_square,
}

#: value type -> (tune dtype, stored values, tolerance dtype)
DTYPES = {
    "fp32": (np.float32, "same", np.float32),
    "bf16": (np.float32, "bfloat16", jnp.bfloat16),
    "fp64": (np.float64, "same", np.float64),
}


@functools.lru_cache(maxsize=None)
def _csr(structure):
    return STRUCTURES[structure]()


@functools.lru_cache(maxsize=None)
def _tuned(structure, dtype):
    csr = _csr(structure)
    dt, values, _ = DTYPES[dtype]
    fmt = Format.SSS if csr.symmetric else Format.CSR
    return tune(csr, fmt=fmt, dtype=dt, values=values)


@pytest.mark.parametrize("apply", ["spmv", "spmm1", "spmm3", "spmm8"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_matches_host_oracle(structure, dtype, apply):
    csr = _csr(structure)
    t = _tuned(structure, dtype)
    dt, _, tol = DTYPES[dtype]
    rng = np.random.default_rng(11)
    npr = max(t.nnz_full / max(csr.nrows, 1), 1.0)
    if apply == "spmv":
        x = rng.uniform(-1, 1, csr.ncols).astype(dt)
        y = np.asarray(t.matvec(x))
        assert y.shape == (csr.nrows,) and y.dtype == dt
        cols = [(y, x)]
    else:
        B = int(apply[4:])
        X = rng.uniform(-1, 1, (csr.ncols, B)).astype(dt)
        Y = np.asarray(t.matmat(X))
        assert Y.shape == (csr.nrows, B) and Y.dtype == dt
        cols = [(Y[:, b], X[:, b]) for b in range(B)]
    for y, x in cols:
        xd = x.astype(np.float64)
        assert allclose_spmv(
            y, csr.spmv_host(xd), tol, nnz_per_row=npr,
            scale=csr.spmv_host(xd, absolute=True),
        )
