"""Differential correctness harness (ref ``test/test_spmv_mmf.cpp:31-120``).

Loads the matrix in the requested format, tunes aggressively, runs the
kernel twice (state-reuse check, ref ``:82-83``), re-loads as plain CSR
with ``Tuning.NONE`` as the oracle (ref ``:85-89``), and compares
element-wise within the ``isEqual`` tolerances (``platform.hpp:27-37``).
Prints ``PASSED!`` or ``FAILED!``.

Usage: python -m cfs_spmv.cli.test_spmv_mmf <file.mtx> <fmt> [--dp]

``--dp`` checks in float64 (the reference test binary's pinned VALUE
type; needs ``jax_enable_x64``, which the flag turns on). The default
float32 run additionally verifies against the float64 host oracle with a
componentwise backward-error scale, which is stricter than the
reference's tuned-vs-untuned comparison alone.
"""

from __future__ import annotations

import sys

import numpy as np

from . import parse_format


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(
            "Usage: python -m cfs_spmv.cli.test_spmv_mmf "
            "<mmf_file> <format: 0=csr 1=sss 2=hyb> [--dp]",
            file=sys.stderr,
        )
        return 1
    from .. import SparseMatrix, SpDMV
    from ..utils.logging import info
    from ..utils.platform import Tuning, allclose_spmv

    mmf_file, fmt = argv[0], parse_format(argv[1])
    dtype = np.float64 if "--dp" in argv[2:] else np.float32
    if dtype == np.float64:
        import jax

        jax.config.update("jax_enable_x64", True)

    A = SparseMatrix.create(mmf_file, fmt)
    M, N = A.nrows, A.ncols
    info("sparsity %.4f %%", (1 - A.nnz_full / M / N) * 100)

    x = np.random.default_rng().uniform(10.01, 20.42, N).astype(dtype)

    fn = SpDMV(A, Tuning.AGGRESSIVE, dtype=dtype)
    y = None
    for _ in range(2):  # reuse across calls, ref :82-83
        y = np.asarray(fn(x))

    # oracle: untuned CSR path on the same input (ref :85-89)
    from ..utils.platform import Format

    A_test = SparseMatrix.create(mmf_file, Format.CSR)
    y_test = np.asarray(
        SpDMV(A_test, Tuning.NONE, dtype=dtype)(x)
    )

    xd = x.astype(np.float64)
    scale = A.csr.spmv_host(xd, absolute=True)
    nnz_per_row = A.nnz_full / max(M, 1)
    passed = allclose_spmv(
        y, y_test, dtype, nnz_per_row=nnz_per_row, scale=scale
    ) and allclose_spmv(
        y, A.csr.spmv_host(xd), dtype, nnz_per_row=nnz_per_row, scale=scale
    )

    print("PASSED!" if passed else "FAILED!")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
