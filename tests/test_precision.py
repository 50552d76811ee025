"""Contractions ask for full float32 precision.

On a GPU a float32 ``dot``/``einsum``/``@`` may run in TF32 (about
three decimal digits) unless the call asks for
``lax.Precision.HIGHEST``. These tests walk the traced programs and
require that every ``dot_general`` carries that precision — or that
there is none (the SpMM applier is written as multiply and sum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfs_spmv import COO, CSR, Format
from cfs_spmv.models import solvers
from cfs_spmv.ops import spmv as ops
from cfs_spmv.tuning.tune import tune

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a (closed) jaxpr,
    descending into nested jaxprs (jit, scan, while, cond)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dot_precisions(inner))
    return out


def _spd(n=300):
    coo = COO.random(n, n, 5.0, symmetric=True, bandwidth=30, seed=0,
                     dtype=np.float32)
    d = np.arange(n)
    coo = COO(n, n, np.concatenate([coo.row, d]),
              np.concatenate([coo.col, d]),
              np.concatenate([coo.val, np.full(n, 20.0, np.float32)]),
              symmetric=True).canonicalize()
    return tune(CSR.from_coo(coo), fmt=Format.SSS, reorder=False)


SOLVERS = {
    "cg": lambda A, b: solvers.cg(A, b, iters=3),
    "bicgstab": lambda A, b: solvers.bicgstab(A, b, iters=3),
    "gmres": lambda A, b: solvers.gmres(A, b, restart=3, outer=1),
    "lanczos": lambda A, b: solvers.lanczos(A, b.shape[0], iters=3),
    "power_iteration": lambda A, b: solvers.power_iteration(
        A, b.shape[0], iters=3
    ),
}


@pytest.mark.parametrize("name", list(SOLVERS))
def test_solver_contractions_highest(name):
    A = _spd()
    b = jnp.ones(A.nrows, jnp.float32)
    closed = jax.make_jaxpr(lambda b: SOLVERS[name](A, b))(b)
    precs = _dot_precisions(closed.jaxpr)
    if name in ("cg", "bicgstab", "gmres", "lanczos"):
        assert precs, "expected Krylov inner products"
    for p in precs:
        assert p == (HIGHEST, HIGHEST), p


@pytest.mark.parametrize("rhs", [1, 8])
def test_spmm_has_no_reduced_precision_contraction(rhs):
    A = _spd()
    X = jnp.ones((A.nrows, rhs), jnp.float32)
    closed = jax.make_jaxpr(ops.matrix_apply)(A.operands, X)
    for p in _dot_precisions(closed.jaxpr):
        assert p == (HIGHEST, HIGHEST), p
