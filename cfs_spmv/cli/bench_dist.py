"""Distributed SpMV benchmark over the device mesh.

Scaling harness for BASELINE configs 4/5 (multi-host row-partitioned
SpMV, weak/strong scaling): runs DistSpDMV on 1..N devices and reports
per-iteration time, Gnnz/s and parallel efficiency, measured on the
devices present. On a CPU backend the timings exercise the code path
and say nothing about accelerator speed.

Usage: python -m cfs_spmv.cli.bench_dist <file.mtx | --gen NAME>
       <iters> [--devices N] [--weak] [--rhs B] [--json FILE]

``--weak`` replicates the matrix block-diagonally per device (weak
scaling: constant work per device) instead of splitting it (strong).
``--gen NAME`` generates a BASELINE-scale proxy structure instead of
reading a file (SuiteSparse matrices are not vendored): ``queen``
(4.15M rows banded), ``nlpkkt`` (8.37M-row stencil), ``audikw``
(943,695 rows scattered), or the small ``cant``/``general``/``band``
shapes (``utils/proxies.py``).
"""

from __future__ import annotations

import sys
import time

import numpy as np


def _block_diag_replicate(csr, k: int):
    """k copies of A on the diagonal (weak-scaling workload)."""
    from ..formats.coo import COO
    from ..formats.csr import CSR

    coo = csr.to_coo()
    n = csr.nrows
    r = np.concatenate([coo.row.astype(np.int64) + i * n for i in range(k)])
    c = np.concatenate([coo.col.astype(np.int64) + i * n for i in range(k)])
    v = np.tile(coo.val, k)
    return CSR.from_coo(
        COO(n * k, csr.ncols * k, r, c, v, csr.symmetric)
    )


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(
            "Usage: python -m cfs_spmv.cli.bench_dist <mmf_file> "
            "<iters> [--devices N] [--weak]",
            file=sys.stderr,
        )
        return 1
    import jax

    from .. import Format, SparseMatrix
    from ..parallel.dist import DistSpDMV
    from ..parallel.mesh import make_mesh
    from ..utils.timing import time_matvec

    if argv[0] == "--gen":
        from ..utils.proxies import GENERATORS

        name = argv[1]
        if name not in GENERATORS:
            raise SystemExit(
                f"unknown --gen {name!r}; one of {sorted(GENERATORS)}"
            )
        gen, gkw = GENERATORS[name]
        mmf_file, loops = None, int(argv[2])
        rest = argv[3:]
    else:
        mmf_file, loops = argv[0], int(argv[1])
        rest = argv[2:]
    ndev_max = (
        int(rest[rest.index("--devices") + 1])
        if "--devices" in rest
        else len(jax.devices())
    )
    weak = "--weak" in rest
    rhs = int(rest[rest.index("--rhs") + 1]) if "--rhs" in rest else 0
    json_file = (
        rest[rest.index("--json") + 1] if "--json" in rest else None
    )

    if mmf_file is None:
        import time as _t

        t0 = _t.perf_counter()
        csr0 = gen(**gkw)
        print(
            f"# --gen {name}: {csr0.nrows} rows, nnz(stored) {csr0.nnz} "
            f"({_t.perf_counter() - t0:.1f}s)", file=sys.stderr,
        )
        A = SparseMatrix.create(
            csr0, Format.SSS if csr0.symmetric else Format.CSR
        )
    else:
        A = SparseMatrix.create(mmf_file, Format.CSR)
    base = None
    rows = []
    ndev = 1
    while ndev <= ndev_max:
        csr = _block_diag_replicate(A.csr, ndev) if weak else A.csr
        mesh = make_mesh(ndev)
        t0 = time.perf_counter()
        dsp = DistSpDMV(csr, mesh)
        preproc = time.perf_counter() - t0
        x = np.random.default_rng(0).uniform(
            0.01, 0.42, csr.ncols
        ).astype(np.float32)
        t_iter = time_matvec(dsp, x, iters=loops)
        nnz = dsp.nnz_full
        if base is None:
            base = t_iter if weak else t_iter * 1.0
        eff = (
            base / t_iter if weak  # weak: flat time = 100%
            else base / (t_iter * ndev)  # strong: linear speedup = 100%
        )
        rows.append((ndev, preproc, t_iter, nnz / t_iter, eff))
        print(
            f"devices: {ndev} preproc(sec): {preproc:.4g} "
            f"t(sec): {t_iter:.4g} nnz/s: {nnz / t_iter:.4g} "
            f"far: {100 * dsp.far_fraction:.2f}% "
            f"efficiency: {100 * eff:.0f}%"
        )
        if rhs:
            X = np.random.default_rng(1).uniform(
                0.01, 0.42, (csr.ncols, rhs)
            ).astype(np.float32)
            t_mm = time_matvec(dsp, X, iters=max(loops // 4, 10))
            print(
                f"devices: {ndev} SpMM({rhs}): t(sec): {t_mm:.4g} "
                f"({t_mm / rhs:.4g}/RHS, {t_mm / t_iter:.1f}x SpMV)"
            )
        ndev *= 2

    if json_file:
        import json as _json

        dev = jax.devices()[0]
        with open(json_file, "a") as f:
            f.write(_json.dumps(dict(
                structure=(name if mmf_file is None else mmf_file),
                device=dict(platform=dev.platform, kind=dev.device_kind,
                            count=len(jax.devices())),
                nrows=int(A.nrows), nnz_stored=int(A.csr.nnz),
                ndev=[r[0] for r in rows],
                preproc_s=[r[1] for r in rows],
                nnz_s=[r[3] for r in rows],
            )) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
