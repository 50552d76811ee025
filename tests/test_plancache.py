"""Plan serialization + content-addressed cache (checkpoint analog).

The reference never persists its tuned format (SURVEY §5); this is the
designed improvement: round-trip equality, cache hits, and invalidation.
"""

import os

import numpy as np
import pytest

from cfs_spmv.formats.coo import COO
from cfs_spmv.formats.csr import CSR
from cfs_spmv.formats.plan import build_general_plan, build_symmetric_plan
from cfs_spmv.io import plancache
from cfs_spmv.tuning.tune import tune
from cfs_spmv.utils.platform import Format, allclose_spmv

from conftest import random_x


def _plans_equal(a, b):
    import dataclasses

    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        elif hasattr(va, "__dataclass_fields__"):
            _plans_equal(va, vb)
        else:
            assert va == vb, f.name


@pytest.fixture
def sym_csr(small_sym_coo):
    return CSR.from_coo(small_sym_coo)


def test_roundtrip_sbell(tmp_path, sym_csr):
    plan = build_symmetric_plan(sym_csr, dtype=np.float32)
    p = tmp_path / "plan.npz"
    plancache.save_plan(p, plan)
    _plans_equal(plan, plancache.load_plan(p))


def test_roundtrip_bell2(tmp_path):
    coo = COO.random(700, 650, 5.0, bandwidth=200, seed=4)
    plan = build_general_plan(CSR.from_coo(coo))
    p = tmp_path / "plan.npz"
    plancache.save_plan(p, plan)
    _plans_equal(plan, plancache.load_plan(p))


def test_version_invalidation(tmp_path, sym_csr, monkeypatch):
    plan = build_symmetric_plan(sym_csr, dtype=np.float32)
    p = tmp_path / "plan.npz"
    plancache.save_plan(p, plan)
    monkeypatch.setattr(plancache, "PLAN_VERSION", plancache.PLAN_VERSION + 1)
    with pytest.raises(ValueError):
        plancache.load_plan(p)


def test_cache_key_sensitivity(sym_csr):
    k1 = plancache.cache_key(sym_csr, np.float32, fmt="sym")
    k2 = plancache.cache_key(sym_csr, np.float64, fmt="sym")
    k3 = plancache.cache_key(sym_csr, np.float32, fmt="general")
    assert len({k1, k2, k3}) == 3
    bumped = CSR(
        sym_csr.nrows, sym_csr.ncols, sym_csr.indptr, sym_csr.indices,
        sym_csr.data * 2, sym_csr.symmetric,
    )
    assert plancache.cache_key(bumped, np.float32, fmt="sym") != k1


def test_tune_uses_cache(tmp_path, sym_csr):
    d = str(tmp_path / "cache")
    t1 = tune(sym_csr, fmt=Format.SSS, cache_dir=d)
    files = os.listdir(d)
    assert len(files) == 1
    # second tune loads the same plan and computes the same result
    t2 = tune(sym_csr, fmt=Format.SSS, cache_dir=d)
    assert os.listdir(d) == files
    x = random_x(sym_csr.nrows, np.float32)
    y1, y2 = np.asarray(t1.matvec(x)), np.asarray(t2.matvec(x))
    np.testing.assert_array_equal(y1, y2)
    xd = x.astype(np.float64)
    assert allclose_spmv(
        y2, sym_csr.spmv_host(xd), np.float32,
        nnz_per_row=t2.nnz_full / sym_csr.nrows,
        scale=sym_csr.spmv_host(xd, absolute=True),
    )


def test_corrupt_cache_rebuilds(tmp_path, sym_csr):
    d = str(tmp_path / "cache")
    tune(sym_csr, fmt=Format.SSS, cache_dir=d)
    (f,) = os.listdir(d)
    with open(os.path.join(d, f), "wb") as fh:
        fh.write(b"garbage")
    t = tune(sym_csr, fmt=Format.SSS, cache_dir=d)
    x = random_x(sym_csr.nrows, np.float32)
    xd = x.astype(np.float64)
    assert allclose_spmv(
        np.asarray(t.matvec(x)), sym_csr.spmv_host(xd), np.float32,
        nnz_per_row=t.nnz_full / sym_csr.nrows,
        scale=sym_csr.spmv_host(xd, absolute=True),
    )
