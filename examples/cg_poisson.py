"""End-to-end example: solve a 2-D Poisson problem with CG on the device.

Builds the standard 5-point Laplacian (SPD, symmetric storage), tunes it
into the dense-diagonal stream, and runs Conjugate Gradient entirely
on-device. Run: python examples/cg_poisson.py [grid_side]
"""

import sys

import jax.numpy as jnp
import numpy as np

from cfs_spmv import COO, CSR, Format, SparseMatrix, SpDMV, Tuning
from cfs_spmv.models.solvers import cg


def laplacian_2d(g: int) -> CSR:
    """5-point stencil on a g x g grid, lower triangle + diagonal."""
    n = g * g
    i = np.arange(n, dtype=np.int64)
    rows = [i]
    cols = [i]
    vals = [np.full(n, 4.0)]
    # left neighbor (d = 1), skipping row starts
    m = i % g != 0
    rows.append(i[m]), cols.append(i[m] - 1), vals.append(np.full(m.sum(), -1.0))
    # down neighbor (d = g)
    m = i >= g
    rows.append(i[m]), cols.append(i[m] - g), vals.append(np.full(m.sum(), -1.0))
    coo = COO(
        n, n,
        np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals).astype(np.float32),
        symmetric=True,
    ).canonicalize()
    return CSR.from_coo(coo)


def main() -> int:
    g = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    A = SparseMatrix.create(laplacian_2d(g), Format.SSS)
    spmv = SpDMV(A, Tuning.AGGRESSIVE, dtype=np.float32)

    # manufactured solution: x* random, b = A x*
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(A.nrows).astype(np.float32)
    b = jnp.asarray(spmv(jnp.asarray(x_true)))

    x, resid, hist = cg(spmv, b, iters=4 * g)
    err = float(jnp.max(jnp.abs(x - x_true)))
    print(
        f"grid {g}x{g} (n={A.nrows}, nnz={A.nnz_full}): "
        f"CG residual {float(resid):.3e}, max error {err:.3e}, "
        f"first->last residual {float(hist[0]):.3e} -> {float(hist[-1]):.3e}"
    )
    return 0 if err < 1e-2 else 1


if __name__ == "__main__":
    sys.exit(main())
