"""SDIA plan — dense-diagonal extraction.

Finds the exact diagonals dense enough to pay for contiguous
(index-free) storage and lays their values out as one contiguous plane
per diagonal: ``vals[j, g] = A[g, g - offsets[j]]`` for the diagonal's
rows, zero elsewhere. The remaining entries stay on the indexed
residual stream — the same structure-driven decomposition idea as the
reference's bandwidth split (``csr_matrix.tpp:313-401``), keyed on
diagonal fill instead of span.

A symmetric plan stores strict-lower offsets (all > 0) and is applied
to both triangles (``ops/spmv.dia_apply(..., sym=True)``); a general
plan stores signed offsets and is applied to its own rows only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native as _native
from ..utils.logging import info

__all__ = [
    "SDiaPlan",
    "extract_sdia",
    "select_offsets",
    "SDIA_FILL",
    "SDIA_MIN_COUNT",
    "SDIA_MAX_D",
]

#: minimum fill (entries / diagonal length) for dense storage: a
#: plane slot costs its value bytes whether filled or not, an indexed
#: residual slot costs value + 4 index bytes, so plane storage moves
#: fewer bytes from fill ~0.5 (fp32) and keeps a margin for the
#: residual's gather cost below that
SDIA_FILL = 0.2
#: absolute minimum entries per diagonal (avoids trace bloat on tiny
#: dense-ish diagonals)
SDIA_MIN_COUNT = 256
#: maximum number of stored diagonals (each is one term of the unrolled
#: shifted-slice sum, so this bounds the traced program's size)
SDIA_MAX_D = 192


@dataclasses.dataclass
class SDiaPlan:
    nrows: int
    #: diagonal offsets d = row - col (all > 0 for a symmetric plan,
    #: signed for a general one)
    offsets: tuple[int, ...]
    vals: np.ndarray  # (D, nrows)
    nnz: int  # stored entries

    @property
    def padding_ratio(self) -> float:
        return self.vals.size / max(self.nnz, 1)

    def stream_bytes(self) -> int:
        return self.vals.nbytes


def select_offsets(uniq, cnt, n, *, fill=SDIA_FILL, min_count=SDIA_MIN_COUNT,
                   max_d=SDIA_MAX_D, signed=False):
    """Dense-diagonal selection shared by the NumPy and native
    extraction paths: offsets whose count clears both the absolute and
    the fill-fraction threshold, heaviest-first truncated to the plane
    budget. Unsigned selection keeps strict-lower offsets only. Returns
    the selected offsets (ascending) or None."""
    uniq = np.asarray(uniq)
    cnt = np.asarray(cnt)
    length = np.maximum(n - np.abs(uniq), 1)
    ok = (cnt >= min_count) & (cnt >= fill * length)
    if not signed:
        ok &= uniq > 0
    if ok.sum() > max_d:
        order = np.argsort(cnt[ok], kind="stable")[::-1][:max_d]
        keep_ids = np.flatnonzero(ok)[order]
        ok = np.zeros_like(ok)
        ok[keep_ids] = True
    if not ok.any():
        return None
    return uniq[ok]


def extract_sdia(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    n: int,
    *,
    dtype=np.float32,
    fill: float = SDIA_FILL,
    min_count: int = SDIA_MIN_COUNT,
    max_d: int = SDIA_MAX_D,
    signed: bool = False,
    min_frac: float = 0.0,
):
    """Split COO entries into (SDiaPlan | None, residual mask).

    The mask is True for entries NOT absorbed into the diagonal stream.
    ``signed`` admits super-diagonals and the main diagonal (general
    matrices). ``min_frac`` rejects peels that would absorb less than
    this fraction of the entries, before the planes are allocated: a
    thin peel adds a full pass over x and y for little work.
    """
    if len(row) == 0:
        return None, np.ones(0, bool)
    off = np.asarray(row, np.int64) - np.asarray(col, np.int64)
    # offsets live in [-(n-1), n-1]: one bincount over the shifted key
    # space replaces np.unique's full sort
    shift = n - 1
    key = off + shift
    cnt_full = np.bincount(key, minlength=2 * n - 1)
    uniq = np.flatnonzero(cnt_full) - shift
    cnt = cnt_full[uniq + shift]
    offsets = select_offsets(
        uniq, cnt, n, fill=fill, min_count=min_count, max_d=max_d,
        signed=signed,
    )
    if offsets is None:
        return None, np.ones(len(row), bool)
    peeled = int(cnt_full[offsets + shift].sum())
    if peeled < min_frac * len(row):
        info(
            "sdia: peel rejected (%.1f%% of entries < %.0f%% gate)",
            100 * peeled / len(row), 100 * min_frac,
        )
        return None, np.ones(len(row), bool)
    dmap_full = np.full(2 * n - 1, -1, np.int32)
    dmap_full[offsets + shift] = np.arange(len(offsets), dtype=np.int32)
    j_all = dmap_full[key]
    sel = j_all >= 0
    vals = np.zeros((len(offsets), n), dtype)
    g, j = np.asarray(row)[sel], j_all[sel]
    v = np.ascontiguousarray(np.asarray(val)[sel], dtype)
    if not _native.assemble_sdia(g, j, v, vals):
        vals[j, g] = v
    plan = SDiaPlan(n, tuple(int(d) for d in offsets), vals, peeled)
    info(
        "sdia: %d diagonals, nnz=%d (%.1f%% of entries), pad=%.2fx",
        len(offsets), plan.nnz, 100 * sel.mean(), plan.padding_ratio,
    )
    return plan, ~sel
