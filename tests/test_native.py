"""Native C++ runtime vs NumPy fallback equivalence.

The native library (csrc/cfs_native.cpp) must produce bit-identical
results to the Python fallbacks: same MMF parse, same diagonal planes
and residual streams, same shard split, same RCM order.
"""

import io

import numpy as np
import pytest

from cfs_spmv import COO, CSR, native
from cfs_spmv.io.mmf import read_mmf


requires_native = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


@pytest.fixture
def no_native(monkeypatch):
    """Force the NumPy fallback paths."""
    monkeypatch.setattr(native, "parse_mmf_body", lambda *a, **k: None)


def _mmf_text():
    rng = np.random.default_rng(3)
    n, nnz = 57, 301
    r = rng.integers(1, n + 1, nnz)
    c = rng.integers(1, n + 1, nnz)
    v = rng.standard_normal(nnz)
    lines = [
        "%%MatrixMarket matrix coordinate real general",
        "% comment line",
        f"{n} {n} {nnz}",
    ]
    lines += [f"{ri} {ci} {vi:.17g}" for ri, ci, vi in zip(r, c, v)]
    # per-entry comment lines are legal and must be skipped
    lines.insert(10, "% mid-body comment")
    return "\n".join(lines) + "\n"


@requires_native
def test_parse_matches_python(no_native_request=None):
    text = _mmf_text()
    hdr_n, rn, cn, vn = read_mmf(io.StringIO(text))
    # force fallback by monkeypatching inline
    orig = native.parse_mmf_body
    try:
        native.parse_mmf_body = lambda *a, **k: None
        hdr_p, rp, cp, vp = read_mmf(io.StringIO(text))
    finally:
        native.parse_mmf_body = orig
    assert hdr_n == hdr_p
    np.testing.assert_array_equal(rn, rp)
    np.testing.assert_array_equal(cn, cp)
    np.testing.assert_array_equal(vn, vp)


@requires_native
def test_parse_pattern_and_malformed():
    text = (
        "%%MatrixMarket matrix coordinate pattern general\n"
        "3 3 2\n1 2\n3 1\n"
    )
    hdr, r, c, v = read_mmf(io.StringIO(text))
    np.testing.assert_array_equal(r, [0, 2])
    np.testing.assert_array_equal(c, [1, 0])
    assert np.all(v == 0.42)

    bad = "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 0.5\n"
    with pytest.raises(ValueError):
        read_mmf(io.StringIO(bad))  # truncated body


def test_native_disabled_env(monkeypatch):
    """CFS_NATIVE=0 must force the fallback without error."""
    import cfs_spmv.native as nat

    monkeypatch.setattr(nat, "_tried", False)
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setenv("CFS_NATIVE", "0")
    assert nat.parse_mmf_body(b"1 1 1.0", 1, 3) is None
    assert not nat.available()
    # restore for other tests
    monkeypatch.setattr(nat, "_tried", False)


def _block_coo(n_blocks=500, b=3, nbr=6, seed=5):
    rng = np.random.default_rng(seed)
    br = np.repeat(np.arange(n_blocks), nbr)
    bc = rng.integers(0, n_blocks, n_blocks * nbr)
    ri, ci = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    row = (br[:, None] * b + ri.ravel()[None, :]).ravel()
    col = (bc[:, None] * b + ci.ravel()[None, :]).ravel()
    val = rng.uniform(0.5, 1.5, len(row))
    n = n_blocks * b
    return COO(n, n, row.astype(np.int64), col.astype(np.int64),
               val.astype(np.float32)).canonicalize()


def test_slot_packed_spmv_correct():
    """Block-structured matrix (3x3 blocks at random columns) through
    the ELL residual matches the host oracle."""
    from cfs_spmv.formats.plan import build_general_plan
    from cfs_spmv.ops import spmv as ops
    from cfs_spmv.utils.platform import allclose_spmv

    coo = _block_coo(n_blocks=800, nbr=8, seed=6)
    csr = CSR.from_coo(coo)
    plan = build_general_plan(csr, dtype=np.float32)
    dev = ops.to_device(plan)
    x = np.random.default_rng(0).uniform(1, 2, csr.ncols).astype(np.float32)
    y = np.asarray(ops.matrix_apply(dev, x))
    xd = x.astype(np.float64)
    assert allclose_spmv(
        y, csr.spmv_host(xd), np.float32,
        nnz_per_row=csr.nnz / csr.nrows,
        scale=csr.spmv_host(xd, absolute=True),
    )


@requires_native
def test_assemble_sdia_matches_numpy_scatter():
    from cfs_spmv.native import assemble_sdia

    rng = np.random.default_rng(4)
    rows, D = 7000, 5
    m = 3000
    g = rng.integers(0, rows, m).astype(np.int64)
    j = rng.integers(0, D, m).astype(np.int32)
    # unique (j, g) slots: the scatter's precondition
    _, first = np.unique(j.astype(np.int64) * rows + g, return_index=True)
    g, j = g[first], j[first]
    val = rng.standard_normal(len(g)).astype(np.float32)
    ref = np.zeros((D, rows), np.float32)
    ref[j, g] = val
    out = np.zeros((D, rows), np.float32)
    assert assemble_sdia(g, j, val, out)
    np.testing.assert_array_equal(ref, out)


@requires_native
@pytest.mark.parametrize("dia", [False, True])
def test_sym_split_fill_matches_numpy_path(dia, monkeypatch):
    """The one-pass native symmetric split + SDIA fill must produce the
    same plan as the NumPy formulation (diag, diagonal planes, residual
    stream), with and without the diagonal peel."""
    from cfs_spmv.formats.plan import build_symmetric_plan

    rng = np.random.default_rng(5)
    n = 4000
    # dense band (absorbed by SDIA) + scattered residual + partial diag
    rows = [np.arange(1, n, dtype=np.int64), np.arange(3, n, dtype=np.int64)]
    cols = [np.arange(1, n, dtype=np.int64) - 1,
            np.arange(3, n, dtype=np.int64) - 3]
    sr = rng.integers(1, n, 3000)
    sc = (sr - rng.integers(1, 900, 3000)).clip(0)
    m = sr > sc
    rows.append(sr[m]); cols.append(sc[m])
    d = rng.choice(n, n // 2, replace=False)
    rows.append(d); cols.append(d)
    row = np.concatenate(rows); col = np.concatenate(cols)
    val = rng.standard_normal(len(row))
    coo = COO(n, n, row, col, val, symmetric=True).canonicalize()
    csr = CSR.from_coo(coo)

    plan_nat = build_symmetric_plan(csr, dtype=np.float32, dia=dia)
    monkeypatch.setattr(native, "sym_off_counts", lambda *a, **k: None)
    monkeypatch.setattr(native, "assemble_sdia", lambda *a, **k: False)
    plan_np = build_symmetric_plan(csr, dtype=np.float32, dia=dia)

    np.testing.assert_array_equal(
        plan_nat.diag.astype(np.float32), plan_np.diag.astype(np.float32)
    )
    assert (plan_nat.dia is None) == (plan_np.dia is None) == (not dia)
    if plan_nat.dia is not None:
        assert plan_nat.dia.offsets == plan_np.dia.offsets
        np.testing.assert_array_equal(plan_nat.dia.vals, plan_np.dia.vals)
    for f in ("cols", "vals", "tail_row", "tail_col", "tail_val"):
        np.testing.assert_array_equal(
            getattr(plan_nat.resid, f), getattr(plan_np.resid, f), f
        )
    assert plan_nat.nnz_full == plan_np.nnz_full


@requires_native
def test_sym_adjacency_same_rcm_perm(monkeypatch):
    """Native adjacency (arbitrary neighbor order) must yield the same
    RCM permutation as the sorted NumPy edge list."""
    from cfs_spmv.tuning import reorder as ro

    rng = np.random.default_rng(9)
    n = 3000
    r = rng.integers(1, n, 8000)
    c = (r - rng.integers(1, 200, 8000)).clip(0)
    m = r > c
    d = np.arange(n)
    row = np.concatenate([r[m], d]); col = np.concatenate([c[m], d])
    csr = CSR.from_coo(COO(n, n, row, col,
                           np.ones(len(row), np.float32),
                           symmetric=True).canonicalize())
    p_nat = ro.rcm_permutation(csr)
    monkeypatch.setattr(native, "sym_adjacency", lambda *a, **k: None)
    p_np = ro.rcm_permutation(csr)
    np.testing.assert_array_equal(p_nat, p_np)


@requires_native
def test_dist_sym_split_native_matches_numpy():
    """The native two-pass distributed shard split (cfs_dist_sym_count/
    _fill) produces bit-identical streams to the NumPy fallback."""
    import cfs_spmv.native as nat
    from cfs_spmv.parallel.dist import DistSpDMV
    from cfs_spmv.parallel.mesh import make_mesh
    import jax

    from cfs_spmv.utils.proxies import cant_proxy, near_band_paired

    for csr, nd in [(cant_proxy(n=20000, half_bw=16), 4),
                    (near_band_paired(n=12000, n_diags=32, max_off=300),
                     4)]:
        mesh = make_mesh(nd)
        d1 = DistSpDMV(csr, mesh)
        old_lib, old_tried = nat._lib, nat._tried
        nat._lib, nat._tried = None, True
        try:
            d2 = DistSpDMV(csr, mesh)
        finally:
            nat._lib, nat._tried = old_lib, old_tried
        assert d1.far_nnz == d2.far_nnz > 0
        assert d1.dia_offsets == d2.dia_offsets
        for t1, t2 in ((d1._near, d2._near), (d1._far, d2._far)):
            l1, s1 = jax.tree_util.tree_flatten(t1)
            l2, s2 = jax.tree_util.tree_flatten(t2)
            assert s1 == s2
            for a, b in zip(l1, l2):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
