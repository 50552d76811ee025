"""The tuning dispatcher: CSR → device-ready tuned plan.

Analog of ``CSRMatrix::tune()`` (``csr_matrix.tpp:230-310``), which
orchestrates partition → HYB split → symmetry compression → kernel
binding. Here the pipeline is: optional RCM reorder → triangle split
(symmetric) → dense-diagonal planes + ELL/COO residual
(``formats/plan.py``) → device upload → applier binding
(``ops/spmv.matrix_apply``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


from ..formats.csr import CSR
from ..formats.plan import build_general_plan, build_symmetric_plan
from ..ops import spmv as spmv_ops
from ..utils.logging import info
from ..utils.platform import Format, Kernel, Tuning

__all__ = ["TunedMatrix", "tune"]


@dataclasses.dataclass
class TunedMatrix:
    """A tuned, device-resident matrix with bound apply functions.

    The analog of a tuned ``CSRMatrix`` with its ``spmv_fn`` pointer bound
    (``csr_matrix.hpp:124``). The appliers are pure functions of
    (operands, x): the device pytree always travels as a jit argument —
    closures over device arrays would be re-embedded as module constants
    by any outer jit.
    """

    format: Format
    nrows: int
    ncols: int
    nnz_full: int
    symmetric: bool
    plan: object
    operands: object  # device pytree threaded through jit as an ARGUMENT
    _apply: Callable  # pure (operands, x) -> y for x of shape (n,) or (n, B)
    spill_fraction: float  # residual fraction of the logical nonzeros
    padding_ratio: float
    perm: np.ndarray | None = None  # RCM row order, if applied
    bsr: object | None = None  # BSR host container when fmt=BSR
    #: un-permuted applier + operands when RCM is applied (the wrapped
    #: matvec pays two 1-D gathers per call — fine for one-shot applies,
    #: a real cost in a solver loop, so solvers work in permuted space
    #: via pure_apply + encode/decode)
    _inner: tuple | None = None

    def matvec(self, x):
        return self._apply(self.operands, x)

    matmat = matvec

    def pure_apply(self):
        """(fn, operands) with fn pure in its arguments — compose THIS
        under outer jits (solvers, timing loops); closing over the bound
        methods instead would inline the whole matrix stream as module
        constants. When RCM reordering is active the returned fn works
        in PERMUTED space: feed it ``encode(x)`` and ``decode`` the
        result (norms are permutation-invariant, so solver scalars need
        no translation)."""
        if self._inner is not None:
            return self._inner
        return self._apply, self.operands

    def encode(self, x):
        """User space → internal (permuted) space."""
        if self.perm is None:
            return x
        return x[self.perm]  # rows of a 2-D X permute the same way

    def decode(self, y):
        """Internal (permuted) space → user space."""
        if self.perm is None:
            return y
        iperm = np.empty_like(self.perm)
        iperm[self.perm] = np.arange(len(self.perm))
        return y[iperm]

    def stream_bytes(self) -> int:
        return self.plan.stream_bytes()


def tune(
    csr: CSR,
    *,
    fmt: Format = Format.NONE,
    kernel: Kernel = Kernel.SpDMV,
    tuning: Tuning = Tuning.AGGRESSIVE,
    dtype=np.float32,
    cache_dir: str | None = None,
    reorder: bool | str = "auto",
    values: str = "same",
) -> TunedMatrix:
    """Select a layout and build the tuned matrix.

    Format selection mirrors the reference factory
    (``sparse_matrix.tpp:14-24``): ``SSS``/``HYB`` require symmetric
    storage; ``NONE`` auto-picks SSS for symmetric matrices under
    aggressive tuning, else the general plan (the tuned-CSR analog).
    ``Tuning.NONE`` on a symmetric matrix expands it and runs the
    one-sided residual alone (the untuned-oracle path of the reference's
    differential tests, ``test_spmv_mmf.cpp:85-89``).

    ``reorder``: bandwidth-reducing RCM permutation (the locality analog
    of the reference's METIS placement, ``csr_matrix.tpp:543-639``).
    ``"auto"`` applies it only when it shrinks the mean bandwidth 2x on a
    scattered square matrix; ``True`` forces, ``False`` disables.

    ``values="bfloat16"`` stores stream values in bfloat16 (halving
    value traffic) while x/y and accumulation stay float32 — an extra
    beyond the reference's float/double pair; results carry bfloat16
    tolerances (~4e-3 relative per value). ``dtype=np.float64`` needs
    ``jax_enable_x64`` and runs the same streams in float64.
    """
    del kernel  # SpDMV/SpDMM share plans and the applier
    from ..io.plancache import cached_build
    from ..utils.config import config as _cfg

    if cache_dir is None:
        cache_dir = _cfg.plan_cache_dir
    if np.dtype(dtype) == np.float64:
        import jax

        if not jax.config.jax_enable_x64:
            raise ValueError(
                "float64 requested but jax_enable_x64 is off; enable it "
                "or use float32"
            )
    if fmt == Format.NONE:
        fmt = (
            Format.SSS
            if (csr.symmetric and tuning == Tuning.AGGRESSIVE)
            else Format.CSR
        )
    bsr = None
    if fmt == Format.BSR:
        # BSR is a host-format contract (block detection + 1/b² index
        # storage, formats/bsr.py); the tuned execution path is shared —
        # dense blocks land on the diagonal planes or the residual.
        from ..formats.bsr import BSR, detect_block_size

        bsr = BSR.from_csr(csr, detect_block_size(csr))
        fmt = Format.SSS if csr.symmetric else Format.CSR

    if fmt in (Format.SSS, Format.HYB) and not csr.symmetric:
        raise ValueError(f"format {fmt} requires a symmetric matrix")

    perm = None
    if (
        reorder
        and tuning == Tuning.AGGRESSIVE
        and csr.nrows == csr.ncols
        and csr.nnz
    ):
        import time as _time

        from .reorder import choose_reorder

        _t0 = _time.perf_counter()
        res, _, _ = choose_reorder(
            csr, min_gain=2.0 if reorder == "auto" else 1.0
        )
        info("tune: reorder decision %.1fs", _time.perf_counter() - _t0)
        if res is not None:
            perm, csr = res

    if fmt in (Format.SSS, Format.HYB) and tuning == Tuning.AGGRESSIVE:
        src = csr
        plan = cached_build(
            lambda: _cast_values(
                build_symmetric_plan(csr, dtype=dtype), values
            ),
            csr, dtype, cache_dir, fmt="sym", values=values,
        )
    elif fmt in (Format.CSR, Format.BELL, Format.COO, Format.SSS, Format.HYB):
        src = (
            CSR.from_coo(csr.to_coo().expand_symmetric())
            if csr.symmetric else csr
        )
        # aggressive tuning peels dense signed-offset diagonals into the
        # index-free stream; Tuning.NONE stays the plain one-sided
        # oracle path
        peel = tuning == Tuning.AGGRESSIVE
        plan = cached_build(
            lambda: _cast_values(
                build_general_plan(src, dtype=dtype, dia=peel), values
            ),
            src, dtype, cache_dir, fmt="general", values=values, dia=peel,
        )
        fmt = Format.CSR
    else:
        raise NotImplementedError(f"format {fmt}")

    tuned = TunedMatrix(
        fmt, src.nrows, src.ncols, plan.nnz_full, csr.symmetric, plan,
        spmv_ops.to_device(plan), spmv_ops.matrix_apply,
        plan.resid_fraction, plan.padding_ratio,
    )
    if perm is not None:
        tuned = _permuted(tuned, perm)
    if bsr is not None:
        tuned = dataclasses.replace(tuned, format=Format.BSR, bsr=bsr)
    if tuned.symmetric and tuned.spill_fraction > _cfg.spill_warn_fraction:
        from ..utils.logging import warn

        warn(
            "tune: %.0f%% of nonzeros fell to the indexed residual "
            "(scattered structure; consider reorder=True)",
            100 * tuned.spill_fraction,
        )
    info(
        "tune: fmt=%s nnz=%d pad=%.2fx resid=%.4f reorder=%s",
        tuned.format, tuned.nnz_full, tuned.padding_ratio,
        tuned.spill_fraction, perm is not None,
    )
    return tuned


def _cast_values(plan, values: str):
    """Cast stream value arrays to the storage dtype (bf16 halves value
    traffic; indices, x, y and the main diagonal are untouched)."""
    if values == "same":
        return plan
    if values != "bfloat16":
        raise ValueError(f"values must be 'same' or 'bfloat16', got {values}")
    import jax.numpy as jnp

    vdt = jnp.bfloat16
    for part in (plan.dia, plan.resid):
        if part is not None:
            part.vals = part.vals.astype(vdt)
    if plan.resid is not None:
        plan.resid.tail_val = plan.resid.tail_val.astype(vdt)
    return plan


def _permuted(tuned: TunedMatrix, perm: np.ndarray) -> TunedMatrix:
    """Wrap the applier with the P A Pᵀ input/output gathers; the
    permutation arrays travel inside the operands pytree."""
    import jax.numpy as jnp

    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    operands = {
        "dev": tuned.operands,
        "p": jnp.asarray(perm),
        "ip": jnp.asarray(iperm),
    }
    inner = tuned._apply

    def apply(ops, x):
        y = inner(ops["dev"], jnp.take(x, ops["p"], axis=0))
        return jnp.take(y, ops["ip"], axis=0)

    return dataclasses.replace(
        tuned, operands=operands, _apply=apply, perm=perm,
        _inner=(inner, tuned.operands),
    )
