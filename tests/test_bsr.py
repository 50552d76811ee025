"""BSR block format: detection, round-trip, tuned execution, and the
index-traffic saving the format exists for (BASELINE config 3)."""

import numpy as np

from cfs_spmv import COO, CSR, Format
from cfs_spmv.formats.bsr import BSR, detect_block_size
from cfs_spmv.tuning.tune import tune
from cfs_spmv.utils.platform import allclose_spmv

from conftest import random_x


def block_matrix(nb=120, b=4, blocks_per_row=5, seed=0, symmetric=False):
    """Random block-structured matrix (audikw_1-like shape)."""
    rng = np.random.default_rng(seed)
    br = np.repeat(np.arange(nb), blocks_per_row)
    bc = rng.integers(0, nb, nb * blocks_per_row)
    if symmetric:
        keep = bc <= br
        br, bc = br[keep], bc[keep]
        br = np.concatenate([br, np.arange(nb)])
        bc = np.concatenate([bc, np.arange(nb)])
    # expand blocks to dense b*b elements
    ri, ci = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    row = (br[:, None] * b + ri.ravel()[None, :]).ravel()
    col = (bc[:, None] * b + ci.ravel()[None, :]).ravel()
    val = rng.uniform(0.5, 1.5, len(row))
    if symmetric:
        keep = row >= col
        row, col, val = row[keep], col[keep], val[keep]
    coo = COO(nb * b, nb * b, row.astype(np.int64), col.astype(np.int64),
              val, symmetric=symmetric).canonicalize()
    return CSR.from_coo(coo)


def test_detect_block_size():
    csr = block_matrix(b=4)
    assert detect_block_size(csr) == 4
    scattered = CSR.from_coo(COO.random(500, 500, 3.0, seed=1))
    assert detect_block_size(scattered) == 1


def test_bsr_roundtrip():
    csr = block_matrix(b=3, seed=2)
    bsr = BSR.from_csr(csr, 3)
    back = bsr.to_csr()
    np.testing.assert_array_equal(back.indptr, csr.indptr)
    np.testing.assert_array_equal(back.indices, csr.indices)
    np.testing.assert_allclose(back.data, csr.data)
    # index traffic shrinks ~b^2 vs element CSR
    assert bsr.indices.nbytes * 4 < csr.indices.nbytes


def test_tuned_bsr_matches_oracle():
    csr = block_matrix(b=4, seed=3)
    t = tune(csr, fmt=Format.BSR, reorder=False)
    assert t.format == Format.BSR
    assert t.bsr is not None and t.bsr.b == 4
    x = random_x(csr.ncols, np.float32)
    xd = x.astype(np.float64)
    y = np.asarray(t.matvec(x))
    assert allclose_spmv(
        y, csr.spmv_host(xd), np.float32,
        nnz_per_row=csr.nnz / csr.nrows,
        scale=csr.spmv_host(xd, absolute=True),
    )


def test_tuned_bsr_symmetric():
    csr = block_matrix(b=4, seed=4, symmetric=True)
    t = tune(csr, fmt=Format.BSR, reorder=False)
    assert t.format == Format.BSR
    x = random_x(csr.ncols, np.float32)
    xd = x.astype(np.float64)
    y = np.asarray(t.matvec(x))
    assert allclose_spmv(
        y, csr.spmv_host(xd), np.float32,
        nnz_per_row=t.nnz_full / csr.nrows,
        scale=csr.spmv_host(xd, absolute=True),
    )
