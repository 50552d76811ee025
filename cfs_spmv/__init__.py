"""Sparse linear algebra for GPUs in JAX.

A JAX/XLA framework with the capability set of cfs-spmv (Elafrou,
Goumas, Koziris, SC'19 — conflict-free symmetric SpMV): MatrixMarket
I/O, CSR/COO/SSS/HYB/BSR layouts, an auto-tuning preprocessing runtime,
SpMV/SpMM over dense diagonal planes and an ELL residual, and
multi-device execution over a ``jax.sharding.Mesh``.

Umbrella module — the analog of the reference's ``include/cfs.hpp``.
"""

import os as _os

# NumPy's transparent-hugepage madvise triggers SYNCHRONOUS kernel
# compaction on hosts with THP defrag=madvise: every big fresh
# allocation can stall in-kernel. Preprocessing is allocation-heavy;
# opt out unless the user explicitly opted in. Effective only if numpy
# is not yet imported — harmless otherwise.
_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

from .formats.coo import COO
from .formats.csr import CSR
from .matrix import SparseMatrix
from .models.spdmv import SpDMM, SpDMV
from .utils.config import apply_jax_compile_cache as _cc
from .utils.platform import Format, Kernel, Platform, Tuning, is_equal

_cc()  # persistent compile cache before any backend work

__version__ = "0.1.0"

__all__ = [
    "COO",
    "CSR",
    "SparseMatrix",
    "SpDMV",
    "SpDMM",
    "Format",
    "Kernel",
    "Platform",
    "Tuning",
    "is_equal",
    "__version__",
]
