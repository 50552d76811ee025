"""SpDMV / SpDMM kernel functors — the user-facing kernel API.

Analog of the reference's ``SpDMV`` functor
(``include/kernel/sparse_kernel.hpp:17-27``, ``.tpp:8-27``): construction
runs preprocessing (``tune()``), the call operator checks dimensions and
dispatches to the bound kernel. Functional style: returns y instead of
writing into a caller buffer.
"""

from __future__ import annotations

import numpy as np

from ..matrix import SparseMatrix
from ..utils.platform import Kernel, Tuning

__all__ = ["SpDMV", "SpDMM"]


class SpDMV:
    """y = A @ x with tuned preprocessing at construction
    (ref ``sparse_kernel.tpp:8-18``)."""

    kernel = Kernel.SpDMV

    def __init__(
        self,
        A: SparseMatrix,
        tuning: Tuning = Tuning.AGGRESSIVE,
        *,
        dtype=np.float32,
        **kwargs,
    ):
        import numpy as _np

        from ..matrix import tune_signature

        self.A = A
        sig = tune_signature(tuning, dtype, **kwargs)
        stored = getattr(A, "_tune_sig", None)
        dtype_differs = (
            stored is not None and stored[1] != _np.dtype(dtype).name
        )
        # retune when: untuned; the plan's dtype differs (a second
        # SpDMV(A, dtype=np.float64) must not feed fp64 x into a
        # float32 plan); or
        # a PREVIOUS SpDMV tuned with a different configuration. An
        # explicit user A.tune(...) with non-default kwargs is
        # authoritative and is NOT silently re-run over preference
        # fields (reorder/values/tuning).
        if (
            A.tuned is None
            or dtype_differs
            or (getattr(A, "_spdmv_sig", None) is not None
                and A._spdmv_sig != sig)
        ):
            A.tune(self.kernel, tuning, dtype=dtype, **kwargs)
        A._spdmv_sig = sig

    def __call__(self, x):
        """Dimension-checked apply (ref ``sparse_kernel.tpp:20-27``)."""
        import jax.numpy as jnp

        x = jnp.asarray(x)
        if x.shape[0] != self.A.ncols:
            raise ValueError(
                f"x has {x.shape[0]} rows, matrix has {self.A.ncols} cols"
            )
        if x.ndim == 1:
            return self.A.tuned.matvec(x)
        return self.A.tuned.matmat(x)


class SpDMM(SpDMV):
    """Y = A @ X for a block of right-hand sides (capability extension;
    the reference offers only single-vector SpDMV)."""

    kernel = Kernel.SpDMM

    def __call__(self, x):
        import jax.numpy as jnp

        x = jnp.asarray(x)
        if x.ndim != 2 or x.shape[0] != self.A.ncols:
            raise ValueError(
                f"X must be ({self.A.ncols}, B), got {x.shape}"
            )
        return self.A.tuned.matmat(x)
