"""Multi-chip tests on the 8-device virtual CPU mesh (SURVEY §4: emulate
multi-host with xla_force_host_platform_device_count).

Differential: distributed result must match the serial host oracle and
the single-chip path bit-for-bit-tolerance-wise."""

import numpy as np
import pytest

from cfs_spmv import COO, CSR, Format, SparseMatrix
from cfs_spmv.parallel.dist import DistSpDMV, shard_csr_rows
from cfs_spmv.parallel.mesh import make_mesh
from cfs_spmv.utils.platform import allclose_spmv
from conftest import random_x


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8)


def test_shard_balance():
    coo = COO.random(2000, 2000, 8.0, bandwidth=100, seed=0)
    csr = CSR.from_coo(coo)
    bounds = shard_csr_rows(csr, 4)
    assert len(bounds) == 5 and bounds[0] == 0
    T = -(-csr.nrows // 128)
    assert bounds[-1] == T
    from cfs_spmv.tuning.partition import tile_nnz_histogram

    hist = tile_nnz_histogram(csr.indptr, T)
    work = np.array(
        [hist[bounds[d] : bounds[d + 1]].sum() for d in range(4)]
    )
    assert work.max() / work.mean() < 1.5  # tile-aligned balance


@pytest.mark.parametrize("ndev", [2, 8])
def test_dist_general(ndev):
    mesh = make_mesh(ndev)
    coo = COO.random(2100, 2100, 7.0, bandwidth=200, seed=1,
                     dtype=np.float64)
    csr = CSR.from_coo(coo)
    dsp = DistSpDMV(csr, mesh, dtype=np.float64)
    x = random_x(2100, np.float64)
    y = np.asarray(dsp(x))
    y_ref = csr.spmv_host(x)
    scale = csr.spmv_host(x, absolute=True)
    assert allclose_spmv(y, y_ref, dtype=np.float64, nnz_per_row=7,
                         scale=scale)


def test_dist_symmetric(mesh8):
    coo = COO.random(1500, 1500, 6.0, symmetric=True, bandwidth=120,
                     seed=2, dtype=np.float64)
    csr = CSR.from_coo(coo)  # lower-triangle storage
    assert csr.symmetric
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64)
    x = random_x(1500, np.float64)
    y = np.asarray(dsp(x))
    y_ref = csr.spmv_host(x)
    scale = csr.spmv_host(x, absolute=True)
    assert allclose_spmv(y, y_ref, dtype=np.float64, nnz_per_row=12,
                         scale=scale)


def test_dist_matches_single_chip(mesh8):
    """Differential: 8-way sharded vs single-device tuned result."""
    from cfs_spmv import SpDMV, Tuning

    coo = COO.random(1200, 1200, 5.0, symmetric=True, bandwidth=90,
                     seed=3, dtype=np.float64)
    A = SparseMatrix.create(coo, Format.SSS)
    x = random_x(1200, np.float64)
    y1 = np.asarray(SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float64)(x))
    dsp = DistSpDMV(A.csr, mesh8, dtype=np.float64)
    y8 = np.asarray(dsp(x))
    scale = A.csr.spmv_host(x, absolute=True)
    assert allclose_spmv(y8, y1, dtype=np.float64, nnz_per_row=10,
                         scale=scale)


def test_dist_uneven_rows(mesh8):
    """Row count not divisible by tiles*devices; empty shards allowed."""
    coo = COO.random(530, 530, 4.0, bandwidth=60, seed=4, dtype=np.float64)
    csr = CSR.from_coo(coo)
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64)
    x = random_x(530, np.float64)
    y = np.asarray(dsp(x))
    assert allclose_spmv(
        y, csr.spmv_host(x), dtype=np.float64, nnz_per_row=4,
        scale=csr.spmv_host(x, absolute=True),
    )


def test_dist_dim_check(mesh8):
    coo = COO.random(300, 300, 3.0, seed=5, dtype=np.float64)
    dsp = DistSpDMV(CSR.from_coo(coo), mesh8, dtype=np.float64)
    with pytest.raises(ValueError):
        dsp(np.ones(299))


def test_dist_symmetric_with_dia(mesh8):
    """Banded symmetric matrix: the sharded path peels union-offset
    dense diagonals into per-shard SDIA streams."""
    n, half_bw = 4096, 6
    rng = np.random.default_rng(7)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    v = np.concatenate(
        [rng.uniform(-1, 1, keep.sum()), rng.uniform(1, 2, n)]
    )
    csr = CSR.from_coo(
        COO(n, n, r.astype(np.int32), c.astype(np.int32), v,
            symmetric=True).canonicalize()
    )
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64, dia_min_count=8)
    assert len(dsp.dia_offsets) >= half_bw  # diagonals reached SDIA
    x = random_x(n, np.float64)
    y = np.asarray(dsp(x))
    assert allclose_spmv(
        y, csr.spmv_host(x), dtype=np.float64,
        nnz_per_row=2 * half_bw + 1,
        scale=csr.spmv_host(x, absolute=True),
    )


def test_dist_mixed_dia_residual(mesh8):
    """Band + scattered noise: SDIA, paired residual and far streams all
    active across shards."""
    n = 3000
    rng = np.random.default_rng(8)
    rows = np.repeat(np.arange(n, dtype=np.int64), 4)
    offs = np.tile(np.arange(1, 5, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    scat = COO.random(n, n, 2.0, symmetric=True, seed=9, dtype=np.float64)
    r = np.concatenate([rows[keep], scat.row, np.arange(n)])
    c = np.concatenate([cols[keep], scat.col, np.arange(n)])
    v = np.concatenate(
        [rng.uniform(-1, 1, keep.sum()), scat.val, rng.uniform(1, 2, n)]
    )
    csr = CSR.from_coo(
        COO(n, n, r.astype(np.int64), c.astype(np.int64), v,
            symmetric=True).canonicalize()
    )
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64, dia_min_count=8)
    x = random_x(n, np.float64)
    y = np.asarray(dsp(x))
    assert allclose_spmv(
        y, csr.spmv_host(x), dtype=np.float64,
        nnz_per_row=csr.to_coo().nnz_full / n,
        scale=csr.spmv_host(x, absolute=True),
    )


@pytest.mark.parametrize("sym", [False, True])
def test_dist_ring_matches_gather(mesh8, sym):
    """Ring halo exchange (ppermute rotation) must equal the all-gather
    path and the host oracle."""
    coo = COO.random(
        1700, 1700, 6.0, symmetric=sym, bandwidth=400, seed=11,
        dtype=np.float64,
    )
    csr = CSR.from_coo(coo)
    x = random_x(1700, np.float64)
    yg = np.asarray(DistSpDMV(csr, mesh8, dtype=np.float64)(x))
    yr = np.asarray(
        DistSpDMV(csr, mesh8, dtype=np.float64, comm="ring")(x)
    )
    ref = csr.spmv_host(x)
    scale = csr.spmv_host(x, absolute=True)
    assert allclose_spmv(yr, ref, dtype=np.float64, nnz_per_row=12,
                         scale=scale)
    np.testing.assert_allclose(yr, yg, rtol=1e-12, atol=1e-9)


def test_dist_ring_with_dia(mesh8):
    """Ring mode composes with the sharded SDIA stream."""
    n, half_bw = 4096, 5
    rng = np.random.default_rng(13)
    rows = np.repeat(np.arange(n, dtype=np.int64), half_bw)
    offs = np.tile(np.arange(1, half_bw + 1, dtype=np.int64), n)
    cols = rows - offs
    keep = cols >= 0
    scat = COO.random(n, n, 1.0, symmetric=True, seed=14, dtype=np.float64)
    r = np.concatenate([rows[keep], scat.row, np.arange(n)])
    c = np.concatenate([cols[keep], scat.col, np.arange(n)])
    v = np.concatenate(
        [rng.uniform(-1, 1, keep.sum()), scat.val, rng.uniform(1, 2, n)]
    )
    csr = CSR.from_coo(
        COO(n, n, r, c, v, symmetric=True).canonicalize()
    )
    dsp = DistSpDMV(
        csr, mesh8, dtype=np.float64, dia_min_count=8, comm="ring"
    )
    x = random_x(n, np.float64)
    y = np.asarray(dsp(x))
    assert allclose_spmv(
        y, csr.spmv_host(x), dtype=np.float64,
        nnz_per_row=csr.to_coo().nnz_full / n,
        scale=csr.spmv_host(x, absolute=True),
    )


def test_dist_comm_validation(mesh8):
    coo = COO.random(300, 300, 3.0, seed=5, dtype=np.float64)
    with pytest.raises(ValueError):
        DistSpDMV(CSR.from_coo(coo), mesh8, comm="nope")


@pytest.mark.parametrize("comm", ["gather", "ring"])
def test_dist_spmm(mesh8, comm):
    """Distributed multi-RHS SpDMM (capability beyond the reference)."""
    coo = COO.random(1300, 1300, 5.0, symmetric=True, bandwidth=150,
                     seed=17, dtype=np.float64)
    csr = CSR.from_coo(coo)
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64, comm=comm,
                    dia_min_count=8)
    B = 3
    X = np.random.default_rng(18).uniform(1, 2, (1300, B))
    Y = np.asarray(dsp(X))
    assert Y.shape == (1300, B)
    for b in range(B):
        ref = csr.spmv_host(X[:, b])
        assert allclose_spmv(
            Y[:, b], ref, dtype=np.float64, nnz_per_row=10,
            scale=csr.spmv_host(X[:, b], absolute=True),
        )


def test_dist_pure_apply_mm(mesh8):
    """The pure-apply form of the distributed operator takes a 2-D X:
    one program serves SpMV and SpMM."""
    from cfs_spmv.utils.timing import as_pure

    coo = COO.random(800, 800, 4.0, symmetric=True, bandwidth=100,
                     seed=21, dtype=np.float64)
    csr = CSR.from_coo(coo)
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64)
    X = np.random.default_rng(22).uniform(1, 2, (800, 2))
    fn, ops, encode, decode = as_pure(dsp)
    Y = np.asarray(decode(fn(ops, encode(X))))
    assert Y.shape == (800, 2)
    for b in range(2):
        assert allclose_spmv(
            Y[:, b], csr.spmv_host(X[:, b]), dtype=np.float64,
            nnz_per_row=8, scale=csr.spmv_host(X[:, b], absolute=True),
        )


def test_dist_spmm_general(mesh8):
    coo = COO.random(900, 900, 4.0, bandwidth=200, seed=19,
                     dtype=np.float64)
    csr = CSR.from_coo(coo)
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64)
    X = np.random.default_rng(20).uniform(1, 2, (900, 2))
    Y = np.asarray(dsp.matmat(X))
    for b in range(2):
        assert allclose_spmv(
            Y[:, b], csr.spmv_host(X[:, b]), dtype=np.float64,
            nnz_per_row=4, scale=csr.spmv_host(X[:, b], absolute=True),
        )


def test_cluster_assignment_reduces_far():
    """Locality-aware assignment (METIS analog): interleaved communities
    that a contiguous split cuts everywhere must cluster onto devices,
    dropping the far fraction, with results unchanged."""
    mesh = make_mesh(2)
    # two communities whose tiles interleave: tile t belongs to
    # community t % 2; edges stay within a community
    Tt, n = 16, 16 * 128
    rng = np.random.default_rng(30)
    rows, cols = [], []
    for t in range(Tt):
        comm_tiles = np.arange(t % 2, Tt, 2)
        r = t * 128 + rng.integers(0, 128, 600)
        ct = comm_tiles[rng.integers(0, len(comm_tiles), 600)]
        c = ct * 128 + rng.integers(0, 128, 600)
        rows.append(r)
        cols.append(c)
    r = np.concatenate(rows + [np.arange(n)])
    c = np.concatenate(cols + [np.arange(n)])
    keep = r >= c
    r, c = r[keep], c[keep]
    v = rng.uniform(0.5, 1.5, len(r))
    csr = CSR.from_coo(
        COO(n, n, r, c, v, symmetric=True).canonicalize()
    )
    x = random_x(n, np.float64)
    d0 = DistSpDMV(csr, mesh, dtype=np.float64)
    d1 = DistSpDMV(csr, mesh, dtype=np.float64, assign="cluster")
    assert d1.perm is not None
    assert d1.far_fraction < 0.5 * d0.far_fraction
    ref = csr.spmv_host(x)
    scale = csr.spmv_host(x, absolute=True)
    npr = csr.to_coo().nnz_full / n
    assert allclose_spmv(np.asarray(d0(x)), ref, dtype=np.float64,
                         nnz_per_row=npr, scale=scale)
    assert allclose_spmv(np.asarray(d1(x)), ref, dtype=np.float64,
                         nnz_per_row=npr, scale=scale)
    # pure-apply protocol exposes the permuted space via encode/decode
    from cfs_spmv.utils.timing import as_pure

    fn, ops, encode, decode = as_pure(d1)
    y = np.asarray(decode(fn(ops, encode(np.asarray(x)))))
    assert allclose_spmv(y, ref, dtype=np.float64, nnz_per_row=npr,
                         scale=scale)


def test_multihost_noop_single_process():
    from cfs_spmv.parallel import multihost

    assert not multihost.is_multiprocess()
    multihost.initialize()  # must be a harmless no-op here


def test_halo_comm_banded(mesh8):
    """Banded matrix on 8 devices: auto comm must pick the halo
    exchange (2H boundary rows instead of full x), match the host
    oracle, and agree with gather."""
    coo = COO.random(4096, 4096, 6.0, bandwidth=150, seed=21,
                     dtype=np.float64)
    csr = CSR.from_coo(coo)
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64)
    assert dsp.comm == "halo", dsp.comm
    assert 0 < dsp.halo_rows <= dsp.shard_rows
    x = random_x(4096, np.float64)
    y = np.asarray(dsp(x))
    y_ref = csr.spmv_host(x)
    assert allclose_spmv(
        y, y_ref, dtype=np.float64, nnz_per_row=6,
        scale=csr.spmv_host(x, absolute=True),
    )
    yg = np.asarray(DistSpDMV(csr, mesh8, dtype=np.float64,
                              comm="gather")(x))
    assert allclose_spmv(
        y, yg, dtype=np.float64, nnz_per_row=6,
        scale=csr.spmv_host(x, absolute=True),
    )


def test_halo_comm_symmetric_mm(mesh8):
    """Symmetric banded + multi-RHS through the halo exchange."""
    coo = COO.random(3072, 3072, 5.0, symmetric=True, bandwidth=120,
                     seed=22, dtype=np.float64)
    csr = CSR.from_coo(coo)
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64)
    assert dsp.comm == "halo"
    X = np.random.default_rng(23).uniform(1, 2, (3072, 3))
    Y = np.asarray(dsp.matmat(X))
    for b in range(3):
        ref = csr.spmv_host(X[:, b])
        assert allclose_spmv(
            Y[:, b], ref, dtype=np.float64,
            nnz_per_row=csr.nnz * 2 / csr.nrows,
            scale=csr.spmv_host(X[:, b], absolute=True),
        )


def test_halo_falls_back_on_scattered(mesh8):
    """Full-bandwidth structure: the halo window cannot fit one
    neighbor segment — auto must fall back to gather and stay
    correct."""
    rng = np.random.default_rng(24)
    n = 2048
    row = np.repeat(np.arange(n, dtype=np.int64), 4)
    col = rng.integers(0, n, 4 * n)
    coo = COO(n, n, row, col,
              rng.uniform(-1, 1, 4 * n)).canonicalize()
    csr = CSR.from_coo(coo)
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64)
    assert dsp.comm == "gather"
    x = random_x(n, np.float64)
    assert allclose_spmv(
        np.asarray(dsp(x)), csr.spmv_host(x), dtype=np.float64,
        nnz_per_row=4, scale=csr.spmv_host(x, absolute=True),
    )


def test_halo_explicit_request_unviable_warns(mesh8):
    """comm='halo' on an unviable structure falls back instead of
    producing a wrong program."""
    rng = np.random.default_rng(25)
    n = 1024
    row = np.repeat(np.arange(n, dtype=np.int64), 3)
    col = rng.integers(0, n, 3 * n)
    csr = CSR.from_coo(COO(n, n, row, col,
                           rng.uniform(-1, 1, 3 * n)).canonicalize())
    dsp = DistSpDMV(csr, mesh8, dtype=np.float64, comm="halo")
    assert dsp.comm == "gather"
    x = random_x(n, np.float64)
    assert allclose_spmv(
        np.asarray(dsp(x)), csr.spmv_host(x), dtype=np.float64,
        nnz_per_row=3, scale=csr.spmv_host(x, absolute=True),
    )


def test_cg_over_dist_operator():
    """Iterative solvers compose with the distributed operator: CG over
    a 4-device mesh converges on an SPD system (the mesh-scale analog
    of the reference's parallel solver usage — every matvec inside the
    scan is the full shard_map program with its collectives)."""
    import numpy as np

    from cfs_spmv.formats.coo import COO
    from cfs_spmv.formats.csr import CSR
    from cfs_spmv.models import solvers
    from cfs_spmv.parallel.dist import DistSpDMV
    from cfs_spmv.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    n = 4096
    rows = np.repeat(np.arange(n, dtype=np.int64), 6)
    cols = np.clip(rows - rng.integers(1, 40, n * 6), 0, n - 1)
    keep = cols < rows
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols[keep], np.arange(n)])
    v = np.concatenate([
        rng.uniform(-1, 1, keep.sum()), np.full(n, 15.0)
    ]).astype(np.float32)
    csr = CSR.from_coo(COO(n, n, r, c, v, symmetric=True).canonicalize())
    dsp = DistSpDMV(csr, make_mesh(4))
    b = rng.uniform(1, 2, n).astype(np.float32)
    x, rnorm, hist = solvers.cg(dsp, b, iters=40)
    res = b - np.asarray(dsp(np.asarray(x)))
    assert np.linalg.norm(res) / np.linalg.norm(b) < 1e-5


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(4)


def _dist_case(sym):
    """Banded with scattered noise: near, far and (symmetric) diagonal
    streams all active, and a halo that fits one neighbor segment."""
    n = 2048
    rng = np.random.default_rng(40 + sym)
    rows = np.repeat(np.arange(n, dtype=np.int64), 5)
    cols = np.clip(rows - rng.integers(-150 * (not sym), 150, 5 * n), 0,
                   n - 1)
    band = np.repeat(np.arange(3, n, dtype=np.int64), 1)
    r = np.concatenate([rows, band, np.arange(n)])
    c = np.concatenate([cols, band - 3, np.arange(n)])
    if sym:
        r, c = np.maximum(r, c), np.minimum(r, c)
    v = rng.uniform(-1, 1, len(r))
    return CSR.from_coo(COO(n, n, r, c, v, symmetric=sym).canonicalize())


@pytest.mark.parametrize("rhs", [0, 3])
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("comm", ["halo", "gather", "ring"])
def test_dist_four_devices_each_comm(mesh4, comm, sym, rhs):
    """Four virtual devices, each exchange: the distributed result
    equals the single-device tuned result and the host oracle."""
    from cfs_spmv import SpDMV, Tuning

    csr = _dist_case(sym)
    n = csr.nrows
    dsp = DistSpDMV(csr, mesh4, dtype=np.float64, comm=comm,
                    dia_min_count=8)
    assert dsp.comm == comm
    if comm == "halo":
        assert 0 < dsp.halo_rows <= dsp.shard_rows
    A = SparseMatrix.create(csr, Format.SSS if sym else Format.CSR)
    single = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float64)
    rng = np.random.default_rng(7)
    X = rng.uniform(-1, 1, (n, rhs) if rhs else n)
    Y = np.asarray(dsp(X))
    Y1 = np.asarray(single(X))
    assert Y.shape == X.shape
    npr = dsp.nnz_full / n
    for y, y1, x in (
        [(Y, Y1, X)] if not rhs
        else [(Y[:, b], Y1[:, b], X[:, b]) for b in range(rhs)]
    ):
        scale = csr.spmv_host(x, absolute=True)
        assert allclose_spmv(y, csr.spmv_host(x), dtype=np.float64,
                             nnz_per_row=npr, scale=scale)
        assert allclose_spmv(y, y1, dtype=np.float64, nnz_per_row=npr,
                             scale=scale)
