"""ELL + COO-tail residual stream.

The indexed stream holds what the dense diagonals do not: an ELL slab
of ``L`` slots per row (absolute int32 columns) for the regular part
and COO triples for the rows longer than ``L``. A GPU gathers
``x[col]`` straight from L2/HBM, and XLA fuses gather, multiply and
row reduction into one kernel, so the slab needs no window or lane
packing — the HYB split of the reference (``csr_matrix.tpp:313-401``)
in its simplest form.

Padding slots hold value 0 and the slot's own row as column (clipped
to the x length), so the gather reads a nearby x value and adds
exactly 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EllPlan", "build_ell", "choose_width", "TAIL_WEIGHT"]

#: modeled cost of one COO tail entry in ELL slots: value + row + col
#: bytes and a scatter-add, against value + col bytes of a slot
TAIL_WEIGHT = 4


@dataclasses.dataclass
class EllPlan:
    nrows: int
    ncols: int  # length of the x vector the columns index
    cols: np.ndarray  # (nrows, L) int32
    vals: np.ndarray  # (nrows, L)
    tail_row: np.ndarray  # (m,) int32
    tail_col: np.ndarray  # (m,) int32
    tail_val: np.ndarray  # (m,)
    nnz: int

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def padding_ratio(self) -> float:
        return (self.cols.size + len(self.tail_row)) / max(self.nnz, 1)

    def stream_bytes(self) -> int:
        return sum(
            a.nbytes for a in (self.cols, self.vals, self.tail_row,
                               self.tail_col, self.tail_val)
        )


def choose_width(counts: np.ndarray, tail_weight: float = TAIL_WEIGHT) -> int:
    """Slab width minimizing ``nrows * L + tail_weight * tail(L)``.

    Widening by one slot costs ``nrows`` slots and moves every row
    longer than ``L`` out of the tail, so the optimum is the smallest
    ``L`` at which at most ``nrows / tail_weight`` rows are longer."""
    n = len(counts)
    if n == 0 or counts.max(initial=0) == 0:
        return 0
    hist = np.bincount(counts)
    longer = n - np.cumsum(hist)  # longer[L] = rows with count > L
    return int(np.argmax(longer * tail_weight <= n))


def build_ell(row, col, val, nrows: int, ncols: int, *, dtype,
              width: int | None = None) -> EllPlan:
    """ELL slab + COO tail from triples in any order (entries of a row
    keep their input order). ``width`` fixes the slab width (shards of
    one distributed program share it); by default
    :func:`choose_width` picks it."""
    row = np.asarray(row)
    col = np.asarray(col)
    val = np.asarray(val)
    m = len(row)
    counts = np.bincount(row, minlength=nrows) if m else np.zeros(
        nrows, np.int64
    )
    L = choose_width(counts) if width is None else width
    if m > 1 and np.any(row[1:] < row[:-1]):
        order = np.argsort(row, kind="stable")
        row, col, val = row[order], col[order], val[order]
    starts = np.zeros(nrows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(m, dtype=np.int64) - starts[row]
    in_ell = rank < L
    pad_col = np.minimum(np.arange(nrows, dtype=np.int32), max(ncols - 1, 0))
    cols = np.repeat(pad_col[:, None], L, axis=1)
    vals = np.zeros((nrows, L), dtype)
    flat = row[in_ell].astype(np.int64) * L + rank[in_ell]
    cols.reshape(-1)[flat] = col[in_ell]
    vals.reshape(-1)[flat] = val[in_ell]
    rem = ~in_ell
    return EllPlan(
        nrows, ncols, cols, vals,
        row[rem].astype(np.int32), col[rem].astype(np.int32),
        val[rem].astype(dtype), m,
    )
