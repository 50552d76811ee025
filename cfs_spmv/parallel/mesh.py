"""Device mesh helpers.

The replacement for the reference's thread runtime
(``src/runtime.cpp``): thread count + CPU pinning become mesh
construction over the available devices; ``CFS_NUM_DEVICES`` mirrors
``CFS_NUM_THREADS`` (``src/runtime.cpp:10-21``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from ..utils.config import config

__all__ = ["get_devices", "make_mesh", "ROWS_AXIS", "RHS_AXIS"]

#: mesh axis sharding matrix rows (the analog of the reference's
#: per-thread row ranges, csr_matrix.tpp:403-541)
ROWS_AXIS = "rows"
#: mesh axis sharding SpMM right-hand sides (data-parallel analog)
RHS_AXIS = "rhs"


def get_devices(num: int | None = None):
    """Devices to use; honors CFS_NUM_DEVICES (0 = all)."""
    devs = jax.devices()
    want = num if num is not None else config.num_devices
    if want and want > 0:
        if want > len(devs):
            raise ValueError(
                f"requested {want} devices, only {len(devs)} available"
            )
        devs = devs[:want]
    return devs


def make_mesh(num: int | None = None, *, rhs: int = 1) -> Mesh:
    """1D row mesh, or 2D (rows, rhs) when ``rhs > 1``.

    The cards of one host are joined all to all, so the mesh shape
    follows the algorithm alone.
    """
    devs = get_devices(num)
    n = len(devs)
    if rhs > 1:
        if n % rhs:
            raise ValueError(f"{n} devices not divisible by rhs={rhs}")
        arr = np.array(devs).reshape(n // rhs, rhs)
        return Mesh(arr, (ROWS_AXIS, RHS_AXIS))
    return Mesh(np.array(devs), (ROWS_AXIS,))
