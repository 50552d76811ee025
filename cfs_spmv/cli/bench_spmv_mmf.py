"""Throughput benchmark harness (ref ``bench/bench_spmv_mmf.cpp``).

Reports the reference's line — preprocessing seconds (SpDMV
construction, ref ``:145-148``), per-iteration seconds, GFLOP/s =
2*nnz*iters/t (ref ``:168``) and stream size in MB — plus nnz/s
against the device's memory speed of light (for a device with known
peaks, ``utils/roofline.PEAKS``).

Usage: python -m cfs_spmv.cli.bench_spmv_mmf <file.mtx> <fmt> <iters>
       [--dp] [--rhs B]

``--rhs B`` benchmarks SpDMM with B right-hand sides instead of SpDMV
(a capability the reference lacks; BASELINE config 3).

Rival backends (the reference benches MKL-CSR as code 3 and librsb as
code 4, ``bench_spmv_mmf.cpp:179-300``): code 3 = ``BCOO`` runs stock
``jax.experimental.sparse``; code 4 = ``DENSE`` runs a dense matmul.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import parse_format


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print(
            "Usage: python -m cfs_spmv.cli.bench_spmv_mmf "
            "<mmf_file> <format: 0=csr 1=sss 2=hyb> <iters> [--dp] "
            "[--rhs B]",
            file=sys.stderr,
        )
        return 1
    import jax

    from .. import SparseMatrix, SpDMV
    from ..utils import roofline
    from ..utils.platform import Tuning
    from ..utils.timing import time_matvec

    rival = {"3": "BCOO", "4": "DENSE"}.get(
        argv[1], argv[1].upper() if argv[1].upper() in ("BCOO", "DENSE")
        else None
    )
    mmf_file = argv[0]
    fmt = None if rival else parse_format(argv[1])
    loops = int(argv[2])
    rest = argv[3:]
    dtype = np.float64 if "--dp" in rest else np.float32
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    rhs = int(rest[rest.index("--rhs") + 1]) if "--rhs" in rest else 0

    from ..utils.platform import Format

    A = SparseMatrix.create(mmf_file, Format.CSR if rival else fmt)
    M, N = A.nrows, A.ncols

    t0 = time.perf_counter()
    if rival:
        fn = _rival_fn(A, rival, dtype)
    else:
        fn = SpDMV(A, Tuning.AGGRESSIVE, dtype=dtype)
    preproc = time.perf_counter() - t0

    rng = np.random.default_rng()
    shape = (N, rhs) if rhs else (N,)
    x = rng.uniform(0.01, 0.42, shape).astype(dtype)  # ref :125

    t_iter = time_matvec(fn, x, iters=loops)
    nnz_full = A.nnz_full if rival else A.tuned.nnz_full
    flops_per_apply = 2 * nnz_full * max(rhs, 1)
    gflops = flops_per_apply / t_iter / 1e9
    nnz_s = nnz_full / t_iter

    # a share of the roofline only for a device in the peak table
    kind = jax.devices()[0].device_kind
    share = "n/a"
    if kind in roofline.PEAKS:
        bpn = roofline.spmv_bytes_per_nnz(
            value_bytes=np.dtype(dtype).itemsize, index_bytes=4,
            nnz=nnz_full, nrows=M, ncols=N,
            vector_bytes=np.dtype(dtype).itemsize,
        )
        sol = roofline.speed_of_light_nnz_s(roofline.device_spec(kind), bpn)
        share = f"{100 * nnz_s / sol:.0f}%"

    # reference-format line (bench_spmv_mmf.cpp:169-173) + roofline tail
    print(
        f"matrix: {os.path.basename(mmf_file)} "
        f"format: {rival or fmt.name}"
        f"{f'-MM{rhs}' if rhs else ''} "
        f"preproc(sec): {preproc:.4g} t(sec): {t_iter:.4g} "
        f"gflops/s: {gflops:.4g} devices: {jax.device_count()} "
        f"size(MB): {A.size() / (1024 * 1024):.4g} "
        f"nnz/s: {nnz_s:.4g} roofline: {share} device: {kind}"
    )
    return 0


class _Rival:
    """Rival backend wrapper speaking the pure-apply protocol (so the
    timing loop passes its arrays as jit arguments, not constants)."""

    def __init__(self, fn, operands):
        self._fn = fn
        self._operands = operands

    def pure_apply(self):
        return self._fn, self._operands

    @staticmethod
    def encode(x):
        return x

    @staticmethod
    def decode(y):
        return y

    def __call__(self, x):
        return self._fn(self._operands, x)


def _rival_fn(A, rival: str, dtype) -> _Rival:
    """Stock-JAX baselines standing in for the reference's MKL/librsb
    rivals (``bench_spmv_mmf.cpp:179-300``)."""
    import jax.numpy as jnp

    coo = A.csr.to_coo()
    if A.csr.symmetric:
        coo = coo.expand_symmetric()
    if rival == "BCOO":
        from jax.experimental import sparse as jsparse

        idx = jnp.stack(
            [jnp.asarray(coo.row, jnp.int32),
             jnp.asarray(coo.col, jnp.int32)], axis=1
        )
        mat = jsparse.BCOO(
            (jnp.asarray(np.asarray(coo.val), dtype), idx),
            shape=(A.nrows, A.ncols),
        )
        return _Rival(lambda m, x: m @ x, mat)
    if rival == "DENSE":
        if A.nrows * A.ncols > 64_000_000:
            raise SystemExit(
                "DENSE rival limited to matrices under 64M cells"
            )
        d = jnp.asarray(coo.to_dense().astype(dtype))
        return _Rival(lambda m, x: m @ x, d)
    raise SystemExit(f"unknown rival backend {rival!r}")


if __name__ == "__main__":
    sys.exit(main())
