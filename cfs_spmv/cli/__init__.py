"""Command-line harnesses mirroring the reference binaries.

``python -m cfs_spmv.cli.test_spmv_mmf <file.mtx> <fmt>`` — the
differential correctness check (ref ``test/test_spmv_mmf.cpp``).
``python -m cfs_spmv.cli.bench_spmv_mmf <file.mtx> <fmt> <iters>`` —
the throughput benchmark (ref ``bench/bench_spmv_mmf.cpp``).

``fmt`` accepts the reference's integer codes (0=CSR, 1=SSS, 2=HYB) or
the format names.
"""

from __future__ import annotations

from ..utils.platform import Format

#: reference integer codes (test_spmv_mmf.cpp:49-61)
FORMAT_CODES = {0: Format.CSR, 1: Format.SSS, 2: Format.HYB}


def parse_format(arg: str) -> Format:
    try:
        return FORMAT_CODES[int(arg)]
    except KeyError:
        raise SystemExit(f"Error in arguments! format code {arg} > 2")
    except ValueError:
        pass
    try:
        return Format(arg.lower())
    except ValueError:
        raise SystemExit(
            f"unknown format {arg!r}; use 0/1/2 or csr/sss/hyb"
        )
