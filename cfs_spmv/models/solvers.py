"""Iterative solvers built on SpDMV — the framework's flagship "models".

The reference is a kernel library; its consumer-facing workload is
repeated SpMV (``bench_spmv_mmf.cpp:153-167``). The natural device-resident
workload with identical inner structure is a Krylov solver, so Conjugate
Gradient is provided as the flagship end-to-end model: the whole iteration
runs inside one ``lax.scan``-style jit with no host round-trips.
"""

from __future__ import annotations

from typing import Callable

import functools

import jax
import jax.numpy as jnp

__all__ = ["cg", "power_iteration", "bicgstab", "gmres", "jacobi", "chebyshev", "lanczos"]

#: every contraction asks for full precision: a float32 product may
#: otherwise run in TF32 (about three decimal digits) on the GPU
_HIGHEST = jax.lax.Precision.HIGHEST
_vdot = functools.partial(jnp.vdot, precision=_HIGHEST)
_matmul = functools.partial(jnp.matmul, precision=_HIGHEST)


def cg(
    matvec: Callable,
    b: jax.Array,
    *,
    iters: int = 50,
    x0: jax.Array | None = None,
    diag_precond: jax.Array | None = None,
):
    """Fixed-iteration (optionally Jacobi-preconditioned) Conjugate
    Gradient for SPD systems.

    Fixed trip count keeps shapes/control flow static under jit (XLA
    requirement); residual norm is returned for convergence checks on the
    host. ``diag_precond`` is the matrix diagonal in USER ordering; when
    given, the iteration solves M^{-1}A x = M^{-1}b with M = diag(A).
    """
    from ..utils.timing import as_pure

    # device streams flow as arguments (closures would embed the whole
    # matrix into the compiled module as constants); with RCM active the
    # whole iteration runs in permuted space (norms are invariant) and
    # only the solution is decoded
    fn, ops, encode, decode = as_pure(matvec)
    b = jnp.asarray(encode(b))
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(encode(x0))
    minv = (
        1.0 / jnp.asarray(encode(diag_precond))
        if diag_precond is not None
        else None
    )
    r = b - fn(ops, x)
    z = r * minv if minv is not None else r
    p = z
    rs = _vdot(r, z)

    eps = jnp.asarray(1e-30, b.dtype)

    def body(carry, _):
        x, r, p, rs = carry
        Ap = fn(ops, p)
        # eps-guarded divides: with a fixed trip count the iteration may
        # run past full convergence, where rs -> 0 gives 0/0
        pAp = _vdot(p, Ap)
        alpha = rs / jnp.where(jnp.abs(pAp) > eps, pAp, eps)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * minv if minv is not None else r
        rs_new = _vdot(r, z)
        p = z + (rs_new / jnp.where(jnp.abs(rs) > eps, rs, eps)) * p
        return (x, r, p, rs_new), _vdot(r, r)

    (x, r, _, rs), hist = jax.lax.scan(
        body, (x, r, p, rs), None, length=iters
    )
    return decode(x), jnp.linalg.norm(r), jnp.sqrt(hist)


def power_iteration(matvec: Callable, n: int, *, iters: int = 100, seed: int = 0):
    """Dominant eigenvalue via power iteration (spectral-norm model)."""
    from ..utils.timing import as_pure

    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32)
    v = v / jnp.linalg.norm(v)
    fn, ops, _, decode = as_pure(matvec)

    def body(v, _):
        w = fn(ops, v)
        nrm = jnp.linalg.norm(w)
        return w / nrm, nrm

    v, nrms = jax.lax.scan(body, v, None, length=iters)
    return decode(v), nrms[-1]


def bicgstab(
    matvec: Callable,
    b: jax.Array,
    *,
    iters: int = 50,
    x0: jax.Array | None = None,
):
    """Fixed-iteration BiCGSTAB for general (non-SPD) systems.

    Complements :func:`cg` the way the reference's general CSR kernels
    complement its symmetric ones. Static trip count; breakdown-guarded
    with jnp.where (no data-dependent branches under jit).
    """
    from ..utils.timing import as_pure

    fn, ops, encode, decode = as_pure(matvec)
    b = jnp.asarray(encode(b))
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(encode(x0))
    eps = jnp.asarray(1e-30, b.dtype)
    r = b - fn(ops, x)
    rhat = r
    rho = _vdot(rhat, r)
    p = r

    def body(carry, _):
        x, r, p, rho = carry
        v = fn(ops, p)
        alpha = rho / jnp.where(
            jnp.abs(_vdot(rhat, v)) > eps, _vdot(rhat, v), eps
        )
        s = r - alpha * v
        t = fn(ops, s)
        tt = _vdot(t, t)
        omega = _vdot(t, s) / jnp.where(tt > eps, tt, eps)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = _vdot(rhat, r)
        beta = (rho_new / jnp.where(jnp.abs(rho) > eps, rho, eps)) * (
            alpha / jnp.where(jnp.abs(omega) > eps, omega, eps)
        )
        p = r + beta * (p - omega * v)
        rn = jnp.sqrt(_vdot(r, r).real)
        return (x, r, p, rho_new), rn

    (x, r, _, _), hist = jax.lax.scan(
        body, (x, r, p, rho), None, length=iters
    )
    return decode(x), jnp.sqrt(_vdot(r, r).real), hist


def jacobi(
    matvec: Callable,
    diag: jax.Array,
    b: jax.Array,
    *,
    iters: int = 100,
    omega: float = 1.0,
):
    """(Weighted) Jacobi relaxation — the classic SpMV-per-step smoother.

    ``diag`` is the matrix diagonal in USER ordering (encoded inside).
    """
    from ..utils.timing import as_pure

    fn, ops, encode, decode = as_pure(matvec)
    b = jnp.asarray(encode(b))
    dinv = omega / jnp.asarray(encode(diag))
    x = jnp.zeros_like(b)

    def body(x, _):
        r = b - fn(ops, x)
        x = x + dinv * r
        return x, jnp.linalg.norm(r)

    x, hist = jax.lax.scan(body, x, None, length=iters)
    return decode(x), hist


def chebyshev(
    matvec: Callable,
    b: jax.Array,
    lam_min: float,
    lam_max: float,
    *,
    iters: int = 50,
):
    """Chebyshev iteration for SPD systems with known spectral bounds —
    inner-product-free (no collectives beyond the SpMV), which makes it
    the preferred distributed smoother."""
    from ..utils.timing import as_pure

    fn, ops, encode, decode = as_pure(matvec)
    b = jnp.asarray(encode(b))
    theta = (lam_max + lam_min) / 2.0
    delta = (lam_max - lam_min) / 2.0
    sigma = theta / delta
    x = jnp.zeros_like(b)
    r = b
    d = r / theta
    rho = 1.0 / sigma

    def body(carry, _):
        x, r, d, rho = carry
        x = x + d
        r = r - fn(ops, d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + 2.0 * rho_new / delta * r
        return (x, r, d, rho_new), jnp.linalg.norm(r)

    (x, r, _, _), hist = jax.lax.scan(
        body, (x, r, d, rho), None, length=iters
    )
    return decode(x), hist


def lanczos(
    matvec: Callable,
    n: int,
    *,
    iters: int = 64,
    seed: int = 0,
):
    """Lanczos tridiagonalization: extremal-eigenvalue estimates of a
    symmetric operator (condition-number model feeding chebyshev/cg).

    Returns (alphas, betas) of the tridiagonal T_k; eigvals(T_k)
    approximate the operator's extremal spectrum.
    """
    from ..utils.timing import as_pure

    fn, ops, _, _ = as_pure(matvec)
    v = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32)
    v = v / jnp.linalg.norm(v)
    v_prev = jnp.zeros_like(v)

    def body(carry, _):
        v_prev, v, beta = carry
        w = fn(ops, v) - beta * v_prev
        alpha = _vdot(v, w)
        w = w - alpha * v
        beta_new = jnp.linalg.norm(w)
        v_new = w / jnp.where(beta_new > 1e-30, beta_new, 1.0)
        return (v, v_new, beta_new), (alpha, beta_new)

    _, (alphas, betas) = jax.lax.scan(
        body, (v_prev, v, jnp.float32(0.0)), None, length=iters
    )
    return alphas, betas


def gmres(
    matvec: Callable,
    b: jax.Array,
    *,
    restart: int = 32,
    outer: int = 8,
    x0: jax.Array | None = None,
):
    """Restarted GMRES(m) for general systems.

    Fixed inner dimension and outer count keep every shape static; the
    Arnoldi recurrence runs as a scan over the Krylov index with the
    basis carried (classical Gram-Schmidt — adequate at the small
    restart sizes used here), and the (m+1, m) least-squares solve stays
    on-device. Returns (x, final residual norm, per-restart residuals).
    """
    from ..utils.timing import as_pure

    fn, ops, encode, decode = as_pure(matvec)
    b = jnp.asarray(encode(b))
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(encode(x0))
    m = restart
    n = b.shape[0]
    eps = jnp.asarray(1e-30, b.dtype)

    def cycle(x, _):
        r = b - fn(ops, x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), b.dtype).at[0].set(
            r / jnp.where(beta > eps, beta, 1.0)
        )
        H = jnp.zeros((m + 1, m), b.dtype)

        def arnoldi(carry, j):
            V, H = carry
            w = fn(ops, V[j])
            hcol = _matmul(V, w)  # rows beyond j are zero: they add 0
            w = w - _matmul(V.T, hcol)
            # CGS2: one re-orthogonalization pass restores the stability
            # classical Gram-Schmidt loses in finite precision ("twice is
            # enough", Giraud et al.) at the cost of one extra GEMV pair
            hcol2 = _matmul(V, w)
            w = w - _matmul(V.T, hcol2)
            hcol = hcol + hcol2
            hj1 = jnp.linalg.norm(w)
            V = V.at[j + 1].set(w / jnp.where(hj1 > eps, hj1, 1.0))
            H = H.at[:, j].set(hcol).at[j + 1, j].set(hj1)
            return (V, H), None

        (V, H), _ = jax.lax.scan(arnoldi, (V, H), jnp.arange(m))
        e1 = jnp.zeros(m + 1, b.dtype).at[0].set(beta)
        y, *_ = jnp.linalg.lstsq(H, e1)
        return x + _matmul(V[:m].T, y), beta

    x, betas = jax.lax.scan(cycle, x, None, length=outer)
    r = b - fn(ops, x)
    return decode(x), jnp.linalg.norm(r), betas
