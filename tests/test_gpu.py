"""Tests that need a CUDA GPU (marker ``gpu``).

They skip elsewhere: the ``gpu_device`` fixture decides at run time.
Run them on the card with

    CFS_TEST_PLATFORM=cuda python -m pytest tests -m gpu
"""

import jax
import numpy as np
import pytest

from cfs_spmv.ops import spmv as ops
from cfs_spmv.tuning.tune import tune
from cfs_spmv.utils import proxies
from cfs_spmv.utils.platform import Format, allclose_spmv

pytestmark = pytest.mark.gpu


def _entry_kernels(compiled) -> int:
    txt = compiled.as_text()
    entry = txt[txt.index("\nENTRY"):]
    return sum(entry.count(f" {op}(") for op in
               ("fusion", "custom-call", "scatter", "gather"))


@pytest.mark.parametrize("name", ["cant", "audikw_proxy", "general"])
def test_compiled_apply_matches_oracle(gpu_device, name):
    csr = {"cant": proxies.cant_proxy, "audikw_proxy": proxies.audikw_proxy,
           "general": proxies.general_asym}[name]()
    t = tune(csr, fmt=Format.SSS if csr.symmetric else Format.CSR,
             reorder=False)
    x = np.random.default_rng(0).uniform(-1, 1, csr.ncols).astype(np.float32)
    y = np.asarray(t.matvec(x))
    xd = x.astype(np.float64)
    assert allclose_spmv(y, csr.spmv_host(xd), np.float32,
                         nnz_per_row=t.nnz_full / csr.nrows,
                         scale=csr.spmv_host(xd, absolute=True))


def test_dia_apply_is_one_kernel(gpu_device):
    """Diagonal planes plus the main diagonal compile to one fusion."""
    t = tune(proxies.cant_proxy(), fmt=Format.SSS, reorder=False)
    assert t.operands.resid is None
    x = jax.device_put(np.ones(t.ncols, np.float32), gpu_device)
    compiled = jax.jit(ops.matrix_apply).lower(t.operands, x).compile()
    assert _entry_kernels(compiled) == 1
