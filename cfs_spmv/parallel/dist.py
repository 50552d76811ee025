"""Distributed SpMV over a device mesh.

Replacement for the reference's shared-memory thread parallelism
(OpenMP row ranges + conflict-free coloring, ``csr_matrix.tpp:403-541,
1204-1639``): matrix rows are sharded across devices in contiguous
128-row-tile ranges balanced by nonzero count (``partition_by_nnz``
analog, ``tpp:437-541``), and every shard runs the same per-stream
appliers as the single-device path (``ops/spmv.py``) on its own plan.

Communication mirrors the reference's HYB low/high-bandwidth split
(``split_by_bandwidth``, ``tpp:313-401``) at mesh scale:

- the *near* streams (entries whose row and column live on the same
  shard: the main diagonal, dense diagonals with union offsets applied
  to both triangles, the local residual) read only the device's own x
  segment — no communication;
- only the *far* stream (both mirror images of cross-shard entries,
  and every entry of a general matrix) needs remote x: a neighbor halo
  exchange of the boundary rows (comm="halo"), one ``all_gather``
  (comm="gather"), or a ``ppermute`` ring that overlaps each rotation
  with the partial SpMV against the arriving segment (comm="ring").

Each device produces exactly its own y rows, so there is no
cross-device scatter or psum: conflict-freedom by partition, as in the
paper, enforced by layout instead of coloring. Shard plans are padded
to one shape (one ELL width, one tail length, one set of diagonal
offsets), so the program stays SPMD.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..formats.csr import CSR
from ..formats.ell import build_ell, choose_width
from ..formats.sdia import SDIA_FILL, SDIA_MAX_D, SDIA_MIN_COUNT
from ..ops.spmv import (
    DeviceMatrix,
    DiaStream,
    EllStream,
    ell_apply,
    matrix_apply,
)
from ..tuning.partition import (
    estimate_imbalance,
    partition_tiles_by_nnz,
    tile_nnz_histogram,
)
from ..utils.logging import info, warn
from .mesh import ROWS_AXIS

__all__ = ["DistSpDMV", "shard_csr_rows"]

#: shard bounds are multiples of this many rows
ROW_TILE = 128


def shard_csr_rows(csr: CSR, ndev: int):
    """Equal-nnz contiguous row-tile shard bounds (ref ``tpp:437-541``)."""
    T = max(1, -(-csr.nrows // ROW_TILE))
    hist = tile_nnz_histogram(csr.indptr, T)
    bounds = partition_tiles_by_nnz(hist, ndev)
    work = [
        int(hist[bounds[d] : bounds[d + 1]].sum()) for d in range(ndev)
    ]
    info(
        "shard: %d devices, nnz/dev %s, imbalance %.3f",
        ndev, work, estimate_imbalance(np.maximum(work, 1)),
    )
    return bounds


def _stack_ell(parts, nrows, ncols, dtype) -> EllStream | None:
    """One ELL stream per shard from ``parts[d] = (row, col, val)``,
    padded to a shared width and tail length and stacked on a leading
    device axis. None when no shard has an entry."""
    if not any(len(p[0]) for p in parts):
        return None
    width = max(
        choose_width(np.bincount(np.asarray(r), minlength=nrows))
        for r, _, _ in parts if len(r)
    )
    plans = [
        build_ell(r, c, v, nrows, ncols, dtype=dtype, width=width)
        for r, c, v in parts
    ]
    tmax = max(len(p.tail_row) for p in plans)

    def tail(a, fill_dtype):
        return np.stack([
            np.pad(getattr(p, a), (0, tmax - len(getattr(p, a))))
            .astype(fill_dtype) for p in plans
        ])

    return EllStream(
        cols=np.stack([p.cols for p in plans]),
        vals=np.stack([p.vals for p in plans]),
        # padding tail entries (row 0, col 0, value 0) add exact zeros
        tail_row=tail("tail_row", np.int32) if tmax else None,
        tail_col=tail("tail_col", np.int32) if tmax else None,
        tail_val=tail("tail_val", dtype) if tmax else None,
        nrows=nrows,
    )


def _local(tree):
    """This device's slice of a stacked (leading device axis) pytree."""
    return jax.tree_util.tree_map(lambda a: a[0], tree)


class DistSpDMV:
    """Mesh-parallel SpDMV functor (the multi-device ``SpDMV`` analog).

    Construction = preprocessing (partition + per-shard planning +
    device placement), call = y = A @ x for x of shape (n,) or (n, B),
    mirroring the reference kernel API (``sparse_kernel.hpp:17-27``).
    """

    def __init__(self, A, mesh, *, dtype=np.float32, dia_min_count=None,
                 comm: str = "auto", assign: str = "contiguous"):
        from ..matrix import SparseMatrix

        csr = A.csr if isinstance(A, SparseMatrix) else A
        self.dia_min_count = (
            SDIA_MIN_COUNT if dia_min_count is None else dia_min_count
        )
        if comm not in ("auto", "gather", "ring", "halo"):
            raise ValueError(
                "comm must be 'auto', 'gather', 'ring' or 'halo', "
                f"got {comm}"
            )
        if assign not in ("contiguous", "cluster"):
            raise ValueError(
                f"assign must be 'contiguous' or 'cluster', got {assign}"
            )
        if csr.ncols != csr.nrows:
            # x is distributed by the ROW partition; a rectangular x has
            # no owner for columns beyond nrows
            raise NotImplementedError(
                "DistSpDMV requires a square matrix (row-partitioned x); "
                f"got {csr.nrows}x{csr.ncols}"
            )
        #: far-stream x exchange:
        #: - "halo": two neighbor ppermutes move only the H boundary
        #:   rows each side (H = max column overhang of any shard's far
        #:   entries); the far streams index a window [r0-H, r0+S+H).
        #:   Needs the uniform row partition;
        #: - "gather": one all_gather of the whole x;
        #: - "ring": ndev ppermute rotations of the local x segment,
        #:   each overlapped with the far sub-stream that consumes it;
        #: - "auto" (default): "halo" when ndev > 1 and H fits within
        #:   one neighbor segment, else "gather".
        self.comm = comm
        self.halo_rows = 0
        self.mesh = mesh
        self.ndev = mesh.shape[ROWS_AXIS]
        self.nrows = csr.nrows
        self.ncols = csr.ncols
        self.symmetric = csr.symmetric
        self.dtype = np.dtype(dtype)
        self.dia_offsets: tuple = ()

        #: locality-aware assignment (METIS analog, tuning/cluster.py):
        #: greedy tile clustering permutes rows so that the contiguous
        #: equal-nnz shards cut fewer edges — shrinking the far stream,
        #: the only stream that communicates
        self.perm = None
        self._iperm = None
        if assign == "cluster" and csr.nnz:
            from ..tuning.cluster import choose_cluster_assignment

            res = choose_cluster_assignment(csr, self.ndev)
            if res is not None:
                self.perm, csr = res
                self._iperm = np.empty_like(self.perm)
                self._iperm[self.perm] = np.arange(len(self.perm))

        if csr.symmetric:
            self._init_symmetric(csr)
        else:
            self._init_general(csr)
        self._place()
        self._fn = self._build()

    # ------------------------------------------------------------------
    def _halo_pregate(self, bw: int, T: int):
        """Uniform row partition for halo comm, or None.

        The halo exchange's static neighbor slices need globally
        contiguous segments: every shard except the last holds exactly
        ``shard_rows`` real rows. Viability is pre-gated on the matrix
        bandwidth: the window overhang never exceeds max|col - row|."""
        if self.comm not in ("auto", "halo") or self.ndev <= 1:
            return None
        Tu = -(-T // self.ndev)
        if -(-bw // ROW_TILE) > Tu:
            return None
        self._halo_ok = True
        return np.minimum(np.arange(self.ndev + 1, dtype=np.int64) * Tu, T)

    def _set_bounds(self, bounds, n):
        self.bounds = bounds
        T_max = max(
            1, max(int(bounds[d + 1] - bounds[d]) for d in range(self.ndev))
        )
        self.shard_rows = T_max * ROW_TILE
        self.real = [
            (min(int(bounds[d]) * ROW_TILE, n),
             min(int(bounds[d + 1]) * ROW_TILE, n)
             - min(int(bounds[d]) * ROW_TILE, n))
            for d in range(self.ndev)
        ]
        self._starts = np.array([r[0] for r in self.real], np.int64)
        self._ends = self._starts + np.array(
            [r[1] for r in self.real], np.int64
        )

    def _resolve_comm(self, H_need: int) -> None:
        """Pick the exchange once the far column overhang is known."""
        if self.comm in ("ring", "gather"):
            return
        H = max(0, -(-int(H_need) // ROW_TILE) * ROW_TILE)
        fits = (
            self.ndev > 1
            and H <= self.shard_rows
            and getattr(self, "_halo_ok", False)
        )
        if self.comm == "halo" and not fits:
            warn(
                "dist: halo comm requested but the far window (%d rows)"
                " exceeds one neighbor segment (%d) or ndev == 1 — "
                "falling back to gather", H, self.shard_rows,
            )
            self.comm = "gather"
            return
        if self.comm == "auto":
            self.comm = "halo" if fits else "gather"
        if self.comm == "halo":
            self.halo_rows = H
            info(
                "dist: halo comm (H=%d rows = %.1f KB/device vs "
                "%.1f KB full-x)", H, 2 * H * self.dtype.itemsize / 1024,
                (self.ndev - 1) * self.shard_rows * self.dtype.itemsize
                / 1024,
            )

    # ------------------------------------------------------------------
    def _build_far(self, far):
        """Far stream(s) from ``far[d] = (local_row, global_col, val)``
        in the coordinates of the chosen exchange."""
        S, ndev = self.shard_rows, self.ndev
        H_need = 0
        for d, (_, gc, _) in enumerate(far):
            if len(gc):
                r0 = self._starts[d]
                H_need = max(H_need, int(r0 - gc.min()),
                             int(gc.max()) + 1 - int(r0 + S))
        self._resolve_comm(H_need)
        owner = [np.searchsorted(self._ends, gc, side="right")
                 for _, gc, _ in far]
        if self.comm == "ring":
            # step k consumes the x segment of device (d + k) % ndev
            steps = []
            for k in range(ndev):
                parts = []
                for d, (lr, gc, v) in enumerate(far):
                    e = (d + k) % ndev
                    m = owner[d] == e
                    parts.append((lr[m], gc[m] - self._starts[e], v[m]))
                steps.append(_stack_ell(parts, S, S, self.dtype))
            return tuple(steps)
        parts = []
        for d, (lr, gc, v) in enumerate(far):
            if self.comm == "halo":
                c = gc - (self._starts[d] - self.halo_rows)
            else:  # gather: position in the concatenated padded shards
                c = owner[d] * S + (gc - self._starts[owner[d]])
            parts.append((lr, c, v))
        width = S + 2 * self.halo_rows if self.comm == "halo" else ndev * S
        return _stack_ell(parts, S, width, self.dtype)

    def _init_general(self, csr: CSR):
        T = max(1, -(-csr.nrows // ROW_TILE))
        row = np.repeat(
            np.arange(csr.nrows, dtype=np.int64), np.diff(csr.indptr)
        )
        col = csr.indices.astype(np.int64)
        bw = int(np.abs(col - row).max()) if len(row) else 0
        bounds = self._halo_pregate(bw, T)
        if bounds is None:
            bounds = shard_csr_rows(csr, self.ndev)
        self._set_bounds(bounds, csr.nrows)
        self.nnz_full = csr.nnz
        own = np.searchsorted(self._ends, row, side="right")
        colo = np.searchsorted(self._ends, col, side="right")
        #: nonzeros whose x column lives on another device — the only
        #: traffic that rides the interconnect
        self.far_nnz = int(np.count_nonzero(own != colo))
        far = []
        val = np.asarray(csr.data, self.dtype)
        for d in range(self.ndev):
            lo, hi = csr.indptr[self._starts[d]], csr.indptr[self._ends[d]]
            far.append((row[lo:hi] - self._starts[d], col[lo:hi], val[lo:hi]))
        self._far = self._build_far(far)
        self._near = DeviceMatrix(
            None, None, None, self.shard_rows, self.shard_rows,
        )

    # ------------------------------------------------------------------
    def _select_union_dia(self, off_cnt):
        """Offsets dense on at least one shard, heaviest-first, shared by
        every shard (the SPMD program has one static offset tuple;
        zero planes cover shards missing a diagonal)."""
        S = self.shard_rows
        union: dict[int, int] = {}
        for cf in off_cnt:
            uniq = np.flatnonzero(cf)
            cnt = cf[uniq]
            ok = (uniq > 0) & (cnt >= self.dia_min_count) & (
                cnt >= SDIA_FILL * np.maximum(S - uniq, 1)
            )
            for o, c in zip(uniq[ok], cnt[ok]):
                union[int(o)] = union.get(int(o), 0) + int(c)
        keep = sorted(union, key=lambda o: (-union[o], o))[:SDIA_MAX_D]
        self.dia_offsets = tuple(sorted(keep))
        dmap = np.full(S, -1, np.int32)
        dmap[list(self.dia_offsets)] = np.arange(
            len(self.dia_offsets), dtype=np.int32
        )
        return dmap

    def _native_sym_split(self, lower):
        """Native two-pass shard split (csrc cfs_dist_sym_count/_fill).
        Returns (near, far, dia) or None when the native library is
        unavailable."""
        from .. import native as _native

        n, S, ndev = lower.nrows, self.shard_rows, self.ndev
        nat = _native.dist_sym_count(
            lower.indptr, lower.indices, n, ndev, self._ends, S,
        )
        if nat is None:
            return None
        off_cnt, cnt_near, cnt_far, cnt_mirror, cross = nat
        self.far_nnz = 2 * cross
        dmap = self._select_union_dia(off_cnt)
        sel = np.array(self.dia_offsets, np.int64)
        n_near = cnt_near - (off_cnt[:, sel].sum(axis=1) if len(sel) else 0)

        def alloc(counts):
            base = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            tot = max(int(base[-1]), 1)
            return base, (np.empty(tot, np.int32), np.empty(tot, np.int32),
                          np.empty(tot, self.dtype))

        near_base, near = alloc(n_near)
        far_base, farb = alloc(cnt_far)
        mir_base, mir = alloc(cnt_mirror)
        dia = (np.zeros((ndev, len(sel), S), self.dtype) if len(sel)
               else None)
        _native.dist_sym_fill(
            lower.indptr, lower.indices,
            np.asarray(lower.data, self.dtype), n, self._starts,
            self._ends, S, dmap, near_base[:-1], far_base[:-1],
            mir_base[:-1], near, farb, mir, dia,
        )

        def cut(base, trip, d):
            s = slice(base[d], base[d + 1])
            return tuple(a[s] for a in trip)

        near_parts = [cut(near_base, near, d) for d in range(ndev)]
        far_parts = []
        for d in range(ndev):
            fr, fc, fv = cut(far_base, farb, d)
            mr, mc, mv = cut(mir_base, mir, d)
            far_parts.append((
                np.concatenate([fr, mr]).astype(np.int64),
                np.concatenate([fc, mc]).astype(np.int64),
                np.concatenate([fv, mv]),
            ))
        return near_parts, far_parts, dia

    def _numpy_sym_split(self, lower):
        """NumPy shard split (fallback when the native library is
        absent; the same outputs as ``_native_sym_split``)."""
        n, S, ndev = lower.nrows, self.shard_rows, self.ndev
        row = np.repeat(np.arange(n, dtype=np.int64), np.diff(lower.indptr))
        col = lower.indices.astype(np.int64)
        val = np.asarray(lower.data, self.dtype)
        ro = np.searchsorted(self._ends, row, side="right")
        co = np.searchsorted(self._ends, col, side="right")
        near = ro == co
        self.far_nnz = 2 * int(np.count_nonzero(~near))
        lr = row - self._starts[ro]
        off = row - col
        off_cnt = np.zeros((ndev, S), np.int64)
        np.add.at(off_cnt, (ro[near], off[near]), 1)
        dmap = self._select_union_dia(off_cnt)
        j = np.where(near, dmap[np.where(near, off, 0)], -1)
        on_dia = j >= 0
        dia = None
        if self.dia_offsets:
            dia = np.zeros((ndev, len(self.dia_offsets), S), self.dtype)
            dia[ro[on_dia], j[on_dia], lr[on_dia]] = val[on_dia]
        resid = near & ~on_dia
        near_parts, far_parts = [], []
        # mirror images of far entries, bucketed by column owner in
        # entry order (stable), as the native fill appends them
        mi = np.flatnonzero(~near)
        mi = mi[np.argsort(co[mi], kind="stable")]
        for d in range(ndev):
            m = resid & (ro == d)
            near_parts.append((lr[m], col[m] - self._starts[d], val[m]))
            f = ~near & (ro == d)
            md = mi[co[mi] == d]
            far_parts.append((
                np.concatenate([lr[f], col[md] - self._starts[d]]),
                np.concatenate([col[f], row[md]]),
                np.concatenate([val[f], val[md]]),
            ))
        return near_parts, far_parts, dia

    def _init_symmetric(self, csr: CSR):
        lower, diag, _ = csr.split_triangle()
        self.nnz_full = 2 * lower.nnz + int(np.count_nonzero(diag))
        T = max(1, -(-csr.nrows // ROW_TILE))
        rows = np.repeat(
            np.arange(csr.nrows, dtype=np.int64), np.diff(lower.indptr)
        )
        bw = int((rows - lower.indices).max()) if lower.nnz else 0
        bounds = self._halo_pregate(bw, T)
        if bounds is None:
            # balance on total work per tile (both triangles)
            hist = tile_nnz_histogram(lower.indptr, T)
            np.add.at(hist, lower.indices // ROW_TILE, 1)
            bounds = partition_tiles_by_nnz(hist, self.ndev)
        del rows
        self._set_bounds(bounds, csr.nrows)
        S = self.shard_rows

        res = self._native_sym_split(lower)
        if res is None:
            res = self._numpy_sym_split(lower)
        near, far, dia = res
        dg = np.zeros((self.ndev, S), self.dtype)
        for d, (r0, nr) in enumerate(self.real):
            dg[d, :nr] = diag[r0:r0 + nr]
        self._far = self._build_far(far)
        self._near = DeviceMatrix(
            diag=dg,
            dia=None if dia is None
            else DiaStream(dia, self.dia_offsets, True),
            # both mirror images, as in formats/plan.py
            resid=_stack_ell(
                [(np.concatenate([r, c]), np.concatenate([c, r]),
                  np.concatenate([v, v])) for r, c, v in near],
                S, S, self.dtype,
            ),
            nrows=S, ncols=S,
        )

    # ------------------------------------------------------------------
    def _place(self):
        # host arrays go straight to their shards (no staging on one
        # device)
        sharded = NamedSharding(self.mesh, P(ROWS_AXIS))
        put = lambda a: jax.device_put(a, sharded)  # noqa: E731
        self._near = jax.tree_util.tree_map(put, self._near)
        self._far = jax.tree_util.tree_map(put, self._far)

    def _build(self):
        """The SPMD program: x of shape (n,) or (n, B) → y."""
        ndev, S, n = self.ndev, self.shard_rows, self.nrows
        real = self.real
        comm, H = self.comm, self.halo_rows

        def shard_fn(local, far, x_sh):
            x_loc = x_sh[0]
            y = matrix_apply(_local(local), x_loc)
            if far is None:
                return y[None]
            if comm == "ring":
                # rotate x segments; each arriving segment feeds the far
                # sub-stream holding the columns it owns, and the next
                # permute overlaps that compute
                xs = x_loc
                for k, step in enumerate(far):
                    if step is not None:
                        y = ell_apply(_local(step), xs, y)
                    if k + 1 < ndev:
                        xs = jax.lax.ppermute(
                            xs, ROWS_AXIS,
                            [(i, (i - 1) % ndev) for i in range(ndev)],
                        )
                return y[None]
            if comm == "halo":
                # only 2H boundary rows move; window positions outside
                # the matrix carry only zero-valued slots
                parts = [x_loc]
                if H:
                    left = jax.lax.ppermute(
                        x_loc[S - H:], ROWS_AXIS,
                        [(i, (i + 1) % ndev) for i in range(ndev)],
                    )
                    right = jax.lax.ppermute(
                        x_loc[:H], ROWS_AXIS,
                        [(i, (i - 1) % ndev) for i in range(ndev)],
                    )
                    parts = [left, x_loc, right]
                xw = jnp.concatenate(parts)
            else:
                xw = jax.lax.all_gather(x_loc, ROWS_AXIS, tiled=True)
            return ell_apply(_local(far), xw, y)[None]

        smapped = shard_map(
            shard_fn, mesh=self.mesh,
            in_specs=(P(ROWS_AXIS), P(ROWS_AXIS), P(ROWS_AXIS)),
            out_specs=P(ROWS_AXIS),
        )

        @jax.jit
        def run(local, far, x):
            xp = jnp.pad(x, ((0, S),) + ((0, 0),) * (x.ndim - 1))
            keep = jnp.arange(S).reshape((S,) + (1,) * (x.ndim - 1))
            segs = [
                jnp.where(keep < nr,
                          jax.lax.dynamic_slice_in_dim(xp, r0, S), 0)
                for r0, nr in real
            ]
            y_sh = smapped(local, far, jnp.stack(segs))
            return jnp.concatenate(
                [y_sh[d, :nr] for d, (_, nr) in enumerate(real)]
            )[:n]

        return run

    def matmat(self, X):
        """Y = A @ X for X of shape (ncols, B)."""
        X = jnp.asarray(X, self.dtype)
        if X.ndim != 2 or X.shape[0] != self.ncols:
            raise ValueError(
                f"X must be ({self.ncols}, B), got {X.shape}"
            )
        return self.decode(self._fn(self._near, self._far, self.encode(X)))

    def __call__(self, x):
        x = jnp.asarray(x, self.dtype)
        if x.ndim == 2:
            return self.matmat(x)
        if x.shape != (self.ncols,):
            raise ValueError(f"x must be ({self.ncols},), got {x.shape}")
        return self.decode(self._fn(self._near, self._far, self.encode(x)))

    # --- pure-apply protocol (see utils.timing.as_pure): operands flow
    # as jit arguments so solver/timing loops never embed the sharded
    # streams as module constants -------------------------------------
    def pure_apply(self):
        inner = self._fn

        def fn(ops, x):
            return inner(*ops, x)

        return fn, (self._near, self._far)

    @property
    def far_fraction(self) -> float:
        """Fraction of logical nonzeros needing a remote x value."""
        return self.far_nnz / max(self.nnz_full, 1)

    def encode(self, x):
        """User space → internal (cluster-permuted) space; identity when
        assign='contiguous' or clustering was rejected."""
        if self.perm is None:
            return x
        return jnp.take(jnp.asarray(x), jnp.asarray(self.perm), axis=0)

    def decode(self, y):
        if self.perm is None:
            return y
        return jnp.take(y, jnp.asarray(self._iperm), axis=0)
