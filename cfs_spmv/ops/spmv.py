"""Op-level SpMV/SpMM: one applier per stream.

This layer is the analog of the reference's ``dense_vector_multiply`` →
``spmv_fn`` dispatch (``csr_matrix.hpp:67-70,124``). A tuned matrix is
at most three device streams (``formats/plan.py``) and each has one
applier, shared by the single-device path (``tuning/tune.py``) and the
per-shard programs of ``parallel/dist.py``. Every applier takes ``x``
of shape ``(n,)`` (SpMV) or ``(n, B)`` (SpMM).

- :func:`dia_apply` — dense diagonals as shifted slices. The row side
  is ``y[g] += v_d[g]·x[g−d]``, the symmetric transpose side
  ``y[h] += v_d[h+d]·x[h+d]``; XLA fuses the whole sum, with the main
  diagonal, into one loop kernel.
- :func:`ell_apply` — one-sided ELL gather + row reduction, plus the
  COO tail's gather + scatter-add.

A symmetric matrix's indexed residual is stored with both mirror images
(``formats/plan.py``): on the H100 that one-sided stream beat both a
one-pass Triton kernel with atomic transpose updates and a plain
gather-reduce + scatter-add pass over the lower triangle alone
(PERF.md, "Kernel decisions").
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..formats.plan import MatrixPlan

__all__ = [
    "DiaStream",
    "EllStream",
    "DeviceMatrix",
    "ell_to_device",
    "to_device",
    "dia_apply",
    "ell_apply",
    "matrix_apply",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DiaStream:
    vals: Any  # (D, n)
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    #: strict-lower offsets applied to both triangles
    sym: bool = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EllStream:
    cols: Any  # (nrows, L) int32
    vals: Any  # (nrows, L)
    tail_row: Any  # (m,) int32 or None
    tail_col: Any
    tail_val: Any
    nrows: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceMatrix:
    diag: Any  # (n,) or None
    dia: DiaStream | None
    resid: EllStream | None
    nrows: int = dataclasses.field(metadata=dict(static=True))
    ncols: int = dataclasses.field(metadata=dict(static=True))


def ell_to_device(e) -> EllStream:
    has_tail = len(e.tail_row) > 0
    return EllStream(
        cols=jnp.asarray(e.cols),
        vals=jnp.asarray(e.vals),
        tail_row=jnp.asarray(e.tail_row) if has_tail else None,
        tail_col=jnp.asarray(e.tail_col) if has_tail else None,
        tail_val=jnp.asarray(e.tail_val) if has_tail else None,
        nrows=e.nrows,
    )


def to_device(plan: MatrixPlan) -> DeviceMatrix:
    dia = None
    if plan.dia is not None:
        dia = DiaStream(
            jnp.asarray(plan.dia.vals), tuple(plan.dia.offsets),
            plan.symmetric,
        )
    return DeviceMatrix(
        diag=None if plan.diag is None else jnp.asarray(plan.diag),
        dia=dia,
        resid=None if plan.resid is None else ell_to_device(plan.resid),
        nrows=plan.nrows,
        ncols=plan.ncols,
    )


def _col(v, x):
    """Broadcast a per-row vector against x of shape (n,) or (n, B)."""
    return v if x.ndim == 1 else v[:, None]


def _shift(a, s, n, pad):
    """``a[g + s]`` for g in [0, n) with zeros outside ``a``; ``pad``
    is the zero padding on each side (>= |s|)."""
    widths = ((pad, pad),) + ((0, 0),) * (a.ndim - 1)
    return jax.lax.slice_in_dim(jnp.pad(a, widths), pad + s, pad + s + n)


def dia_apply(s: DiaStream, x, y=None):
    """``y + A_dia x``: row side ``v_d[g]·x[g−d]`` for every stored
    offset; a symmetric stream adds the transpose side
    ``(v_d·x)[g+d]``."""
    n = s.vals.shape[1]
    pad = max(abs(d) for d in s.offsets)
    xs = x[:n]
    acc = jnp.zeros((n,) + x.shape[1:], x.dtype) if y is None else y
    for j, d in enumerate(s.offsets):
        v = _col(s.vals[j].astype(x.dtype), x)
        acc = acc + v * _shift(xs, -d, n, pad)
        if s.sym:
            acc = acc + _shift(v * xs, d, n, pad)
    return acc


def ell_apply(s: EllStream, x, y=None):
    """``y + A x`` for a one-sided residual; x may be longer than the
    stream's rows (a halo window or a gathered x)."""
    if s.cols.shape[1]:
        g = jnp.take(x, s.cols, axis=0)  # (n, L) or (n, L, B)
        v = s.vals.astype(x.dtype)
        r = jnp.sum((v if x.ndim == 1 else v[..., None]) * g, axis=1)
    else:
        r = jnp.zeros((s.nrows,) + x.shape[1:], x.dtype)
    y = r if y is None else y + r
    if s.tail_row is not None:
        prod = _col(s.tail_val.astype(x.dtype), x) * jnp.take(
            x, s.tail_col, axis=0
        )
        y = y.at[s.tail_row].add(prod)
    return y


def matrix_apply(dev: DeviceMatrix, x):
    """``A x`` for x of shape (ncols,) or (ncols, B)."""
    y = None
    if dev.diag is not None:
        y = _col(dev.diag.astype(x.dtype), x) * x
    if dev.dia is not None:
        y = dia_apply(dev.dia, x, y)
    if y is None:
        y = jnp.zeros((dev.nrows,) + x.shape[1:], x.dtype)
    if dev.resid is not None:
        y = ell_apply(dev.resid, x, y)
    return y
