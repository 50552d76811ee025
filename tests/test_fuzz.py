"""Property sweep: randomized structure x format x dtype against the
fp64 host oracle (the differential pattern of the reference harness,
scaled out — SURVEY §4 calls for property tests it lacks)."""

import numpy as np
import pytest

from cfs_spmv import COO, CSR, Format
from cfs_spmv.tuning.tune import tune
from cfs_spmv.utils.platform import allclose_spmv

from conftest import random_x

CASES = []
for seed in range(6):
    rng = np.random.default_rng(1000 + seed)
    CASES.append(
        dict(
            n=int(rng.integers(80, 2500)),
            deg=float(rng.uniform(1.5, 10.0)),
            bandwidth=(
                None if rng.uniform() < 0.3
                else int(rng.integers(4, 400))
            ),
            symmetric=bool(rng.uniform() < 0.6),
            seed=seed,
        )
    )


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c['seed']}")
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_fuzz_matvec(case, dtype):
    coo = COO.random(
        case["n"], case["n"], case["deg"], symmetric=case["symmetric"],
        bandwidth=case["bandwidth"], seed=case["seed"], dtype=np.float64,
    )
    csr = CSR.from_coo(coo)
    fmt = Format.SSS if case["symmetric"] else Format.CSR
    t = tune(csr, fmt=fmt, dtype=dtype)
    x = random_x(csr.ncols, dtype, seed=case["seed"])
    y = np.asarray(t.matvec(x))
    xd = x.astype(np.float64)
    assert allclose_spmv(
        y, csr.spmv_host(xd), dtype,
        nnz_per_row=t.nnz_full / max(csr.nrows, 1),
        scale=csr.spmv_host(xd, absolute=True),
    ), f"case {case} dtype {dtype}"


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: f"s{c['seed']}")
def test_fuzz_spmm(case):
    coo = COO.random(
        case["n"], case["n"], case["deg"], symmetric=case["symmetric"],
        bandwidth=case["bandwidth"], seed=case["seed"], dtype=np.float64,
    )
    csr = CSR.from_coo(coo)
    fmt = Format.SSS if case["symmetric"] else Format.CSR
    t = tune(csr, fmt=fmt)
    B = 3
    X = np.stack(
        [random_x(csr.ncols, np.float32, seed=b) for b in range(B)], 1
    )
    Y = np.asarray(t.matmat(X))
    for b in range(B):
        xd = X[:, b].astype(np.float64)
        assert allclose_spmv(
            Y[:, b], csr.spmv_host(xd), np.float32,
            nnz_per_row=t.nnz_full / max(csr.nrows, 1),
            scale=csr.spmv_host(xd, absolute=True),
        )
