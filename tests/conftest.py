"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices so multi-device
sharding is exercised without accelerator hardware (SURVEY §4
implication: emulate multi-host with
``xla_force_host_platform_device_count``). Tests marked ``gpu`` need a
CUDA GPU: the ``gpu_device`` fixture skips them elsewhere, deciding at
run time, never at import. Run them on the card with
``python -m pytest tests -m gpu`` (with ``CFS_TEST_PLATFORM=cuda``).

fp64 is enabled globally: the reference's correctness harness is pinned to
double (``test_spmv_mmf.cpp:17``); fp32 arrays stay fp32 when created
explicitly.
"""

import os
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")  # THP direct-compaction stalls (see cfs_spmv/__init__)


flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the suite runs on the 8-device virtual CPU mesh; the gpu-marked tests
# run on a card when CFS_TEST_PLATFORM=cuda (works because no backend has
# been initialized yet at conftest import time)
jax.config.update(
    "jax_platforms", os.environ.get("CFS_TEST_PLATFORM") or "cpu"
)

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cfs_spmv.formats.coo import COO  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (running on {dev.platform})")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_x(n, dtype=np.float64, seed=7):
    """Random x in [10.01, 20.42], the reference test's input range
    (``test_spmv_mmf.cpp:73-78``)."""
    r = np.random.default_rng(seed)
    return r.uniform(10.01, 20.42, n).astype(dtype)


@pytest.fixture
def small_sym_coo():
    """~1138_bus-like: small symmetric banded SPD matrix."""
    return COO.random(
        1138, 1138, 3.5, symmetric=True, bandwidth=40, seed=1,
        dtype=np.float64,
    )


@pytest.fixture
def medium_general_coo():
    return COO.random(2000, 1700, 9.0, bandwidth=300, seed=2, dtype=np.float64)


@pytest.fixture
def scattered_coo():
    """No bandwidth limit — exercises the spill (HYB) path heavily."""
    return COO.random(600, 600, 6.0, seed=3, dtype=np.float64)
