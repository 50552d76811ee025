"""Benchmark timing protocol.

The reference times a bare host loop of SpMV calls
(``bench_spmv_mmf.cpp:153-167``). Here the iteration loop runs *inside*
one jitted ``fori_loop`` with a data dependency that prevents hoisting,
and a two-point measurement t/iter = (T(2k) - T(k)) / k removes the
fixed per-dispatch cost (launch, host sync) exactly — unlike
subtracting a separately measured empty loop, which can go negative for
short kernels. The trip count is a traced argument so both points share
one compiled executable.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["time_matvec", "as_pure"]


def as_pure(matvec):
    """(fn(operands, x), operands) form of a matvec-like object.

    ``TunedMatrix`` / ``SpDMV`` / ``DistSpDMV`` expose this natively (one
    applier serves x of shape (n,) and (n, B)); bare callables get empty
    operands (any arrays they capture then become jit constants — fine
    for small closures, ruinous for matrix streams).

    Returns (fn, operands, encode, decode); encode/decode map user space
    to the internal (RCM-permuted) space and back — identity when no
    reordering is active.
    """
    ident = lambda v: v  # noqa: E731
    obj = matvec
    if hasattr(obj, "__self__"):  # bound method (e.g. tuned.matvec)
        obj = obj.__self__
    if hasattr(obj, "A"):  # SpDMV functor → its SparseMatrix
        obj = obj.A
    if hasattr(obj, "tuned") and obj.tuned is not None:  # SparseMatrix
        obj = obj.tuned
    if hasattr(obj, "pure_apply"):  # TunedMatrix, DistSpDMV
        fn, ops = obj.pure_apply()
        return fn, ops, obj.encode, obj.decode
    return (lambda ops, x: matvec(x)), (), ident, ident


def time_matvec(matvec, x, iters: int = 500, repeats: int = 5) -> float:
    """Amortized per-iteration seconds with a hoisting-proof dependency."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(x)
    # device streams must flow through the jit as ARGUMENTS — a closure
    # would inline the whole matrix into the module as constants (and
    # closure_convert cannot rescue consts hidden in inner pjits)
    fn, ops, encode, _ = as_pure(matvec)
    x = jnp.asarray(encode(x))  # once, outside the timed loop

    @jax.jit
    def loop(x, n, ops):
        def body(i, carry):
            x, acc = carry
            y = fn(ops, x * (1.0 + 1e-12 * i))
            # the carry depends on every element of y: with only y[0]
            # live, XLA may slice the applier down to one row; the cast
            # keeps the carry type fixed for 2-D / fp64 y
            return (x, acc + jnp.sum(y).astype(jnp.float32))

        return jax.lax.fori_loop(
            0, n, body, (x, jnp.float32(0.0))
        )

    jax.block_until_ready(loop(x, 2 * iters, ops))  # warmup / compile

    def timed(n):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            np.asarray(loop(x, n, ops)[1])
            best = min(best, time.perf_counter() - t0)
        return best

    # host-load spikes can make T(k) exceed T(2k); retry until the pair
    # is sane, then fall back to the amortized upper bound rather than
    # reporting a nonsense (even infinite) rate
    for _ in range(4):
        t1 = timed(iters)
        t2 = timed(2 * iters)
        if t2 > 1.2 * t1:
            return (t2 - t1) / iters
    return t2 / (2 * iters)
