"""Multi-host initialization helpers.

The reference is single-node shared-memory; this framework scales over
several hosts through the same collectives — only the mesh shape
changes. This module is the thin process-bootstrap layer (the moral
analog of the reference's thread runtime setup, ``src/runtime.cpp``).

On several hosts, every host runs the same program:

    from cfs_spmv.parallel import multihost, mesh
    multihost.initialize(coordinator_address="host0:1234",
                         num_processes=2, process_id=rank)
    m = mesh.make_mesh()                # global mesh over all devices
    dsp = DistSpDMV(csr, m)             # identical plan on every host

Single-process (and the CPU test mesh) need no initialization; calling
``initialize()`` there is a no-op.
"""

from __future__ import annotations

import os

from ..utils.logging import info

__all__ = ["initialize", "is_multiprocess"]


def is_multiprocess() -> bool:
    """True when launched with an explicit JAX coordinator address."""
    return bool(
        os.environ.get("COORDINATOR_ADDRESS")
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )


def initialize(**kwargs) -> None:
    """Initialize ``jax.distributed`` when running multi-process.

    kwargs pass through to ``jax.distributed.initialize`` (e.g.
    ``coordinator_address``, ``num_processes``, ``process_id``). A
    no-op for single-process runs unless kwargs force it.
    """
    import jax

    if not kwargs and not is_multiprocess():
        info("multihost: single process, skipping jax.distributed")
        return
    jax.distributed.initialize(**kwargs)
    info(
        "multihost: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
