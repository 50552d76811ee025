"""Profiling and per-kernel roofline reporting.

The reference's observability is phase timing behind ``_REPORT_DETAILS``
(``csr_matrix.tpp:1641-1681``, SURVEY §5); the equivalents here are
``jax.profiler`` traces (viewable in XProf/TensorBoard or Perfetto) and
a roofline report per tuned operator.
"""

from __future__ import annotations

import contextlib
import dataclasses


from . import roofline
from .timing import time_matvec

__all__ = ["profile", "RooflineReport", "report_spmv"]


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a device trace of the enclosed block:

    >>> with profile("/tmp/trace"):
    ...     spmv(x).block_until_ready()
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class RooflineReport:
    """Per-operator performance against the memory speed of light."""

    t_iter_s: float
    gflops: float
    nnz_per_s: float
    stream_bytes: int
    achieved_gb_s: float
    sol_nnz_per_s: float  # CSR-equivalent roofline (ref-comparable)
    sol_fraction: float
    device: str

    def __str__(self):
        return (
            f"t/iter={self.t_iter_s * 1e6:.1f}us "
            f"{self.gflops:.1f} GFLOP/s {self.nnz_per_s / 1e9:.2f} Gnnz/s "
            f"| stream {self.stream_bytes / 1e6:.1f} MB @ "
            f"{self.achieved_gb_s:.0f} GB/s | "
            f"{100 * self.sol_fraction:.0f}% of CSR-roofline ({self.device})"
        )


def report_spmv(tuned, x=None, *, t_iter: float | None = None,
                iters: int = 500, spec=None) -> RooflineReport:
    """Measure (or accept) t/iter for a TunedMatrix and place it on the
    roofline of ``spec`` (default: the local device's peaks). ``x`` is
    required when ``t_iter`` is not given."""
    if t_iter is None:
        if x is None:
            raise ValueError("need x to measure t_iter")
        t_iter = time_matvec(tuned.matvec, x, iters=iters)
    nnz = tuned.nnz_full
    spec = spec or roofline.detect_device()
    plan = tuned.plan
    dtype_bytes = next(
        (p.vals.dtype.itemsize for p in (plan.resid, plan.dia)
         if p is not None), 4,
    )
    bpn = roofline.spmv_bytes_per_nnz(
        value_bytes=dtype_bytes, index_bytes=4, nnz=nnz,
        nrows=tuned.nrows, ncols=tuned.ncols, vector_bytes=dtype_bytes,
    )
    sol = roofline.speed_of_light_nnz_s(spec, bpn)
    sb = tuned.stream_bytes()
    return RooflineReport(
        t_iter_s=t_iter,
        gflops=2 * nnz / t_iter / 1e9,
        nnz_per_s=nnz / t_iter,
        stream_bytes=sb,
        achieved_gb_s=sb / t_iter / 1e9,
        sol_nnz_per_s=sol,
        sol_fraction=(nnz / t_iter) / sol,
        device=spec.name,
    )
