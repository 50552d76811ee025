"""Benchmark harness — reference-compatible protocol, roofline-reported.

Mirrors the reference bench (``bench/bench_spmv_mmf.cpp``): preprocessing
time (SpDMV construction, :145-148), warmup + timed loops (:153-167),
GFLOP/s = 2*nnz*iters/t (:168) — plus what the reference lacks: nnz/s
against the device's memory speed of light (``utils/roofline.PEAKS``,
keyed by ``device_kind``; a device without peaks stops the run).

Matrices: SuiteSparse files are not vendored and there is no network, so
the bench synthesizes proxies (``cfs_spmv/utils/proxies.py``, shared
with ``cli/bench_dist.py --gen``):

- cant proxy (banded FEM, diagonal planes) — BASELINE config 2;
- 3D 27-point stencil (nlpkkt-like);
- audikw-class proxy (3x3 blocks at random small offsets): scattered
  structure that lands on the indexed residual — the hard case;
- general-asymmetric stencil (signed diagonal planes);
- tracked beside the headline: random columns in a wide band,
  near-banded irregular diagonals, bf16 storage, fp64, SpMM(8), and the
  audikw full-scale matrix (78.5M nnz).

Timing: ``utils/timing.time_matvec`` (loop inside one jit, two-point
difference). Prints ONE JSON line to stdout:

  {"metric": "spmv_worst_nnz_s", "value": <nnz/s of the worst headline
   workload>, "unit": "nnz/s", "vs_baseline": <min over headline
   workloads of nnz_s / (0.8 * roofline_nnz_s)>, "device": {...}, ...}
"""

from __future__ import annotations

import os

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

import json
import subprocess
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    """``nvidia-smi`` name and power limit (a child without JAX)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unavailable"


def bench_one(name, csr, *, iters=2000, dtype=np.float32, values="same",
              reorder="auto", rhs=0):
    import jax
    import jax.numpy as jnp

    from cfs_spmv import Format, SparseMatrix, SpDMV, Tuning
    from cfs_spmv.utils import roofline
    from cfs_spmv.utils.platform import allclose_spmv
    from cfs_spmv.utils.timing import time_matvec

    A = SparseMatrix.create(csr, Format.SSS if csr.symmetric else Format.CSR)
    t0 = time.perf_counter()
    sp = SpDMV(A, Tuning.AGGRESSIVE, dtype=dtype, values=values,
               reorder=reorder)
    t_pre = time.perf_counter() - t0

    n = A.ncols
    x = np.random.default_rng(7).uniform(1.0, 2.0, n).astype(dtype)
    # correctness gate (the bench result is meaningless if wrong)
    y = np.asarray(sp(x))
    xd = x.astype(np.float64)
    ok = allclose_spmv(
        y, A.csr.spmv_host(xd),
        dtype=jnp.bfloat16 if values == "bfloat16" else dtype,
        nnz_per_row=A.tuned.nnz_full / max(A.nrows, 1),
        scale=A.csr.spmv_host(xd, absolute=True),
    )
    t_iter = time_matvec(sp, x, iters=iters)
    nnz_full = A.tuned.nnz_full
    nnz_s = nnz_full / t_iter
    spec = roofline.device_spec(jax.devices()[0].device_kind)
    # reference-equivalent CSR traffic: value + index per nnz, x and y
    bpn = roofline.spmv_bytes_per_nnz(
        value_bytes=np.dtype(dtype).itemsize, index_bytes=4,
        nnz=nnz_full, nrows=A.nrows, ncols=A.ncols,
        vector_bytes=np.dtype(dtype).itemsize,
    )
    sol = roofline.speed_of_light_nnz_s(spec, bpn)
    log(
        f"[{name}] n={A.nrows} nnz={nnz_full} preproc={t_pre}s "
        f"t/iter={t_iter * 1e6}us {2 * nnz_s / 1e9} GFLOP/s "
        f"{nnz_s / 1e9} Gnnz/s | pad={A.tuned.padding_ratio:.3f} "
        f"resid={A.tuned.spill_fraction:.4f} | SOL({spec.name}, "
        f"{bpn:.2f}B/nnz)={sol / 1e9} Gnnz/s -> {nnz_s / sol} "
        f"| correct={ok}"
    )
    if rhs:
        X = np.random.default_rng(8).uniform(1.0, 2.0, (n, rhs)).astype(dtype)
        t_mm = time_matvec(sp, X, iters=max(iters // 4, 100))
        log(f"[{name}] SpMM({rhs}): t/iter={t_mm * 1e6}us "
            f"({t_mm / t_iter}x SpMV)")
    return dict(name=name, ok=bool(ok), nnz_s=nnz_s, sol_nnz_s=sol,
                preproc_s=t_pre, t_iter=t_iter, nnz=int(nnz_full))


def main():
    import jax

    from cfs_spmv.utils import proxies

    dev = jax.devices()[0]
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()), power=power_limit())
    log(f"device={device}")
    jax.config.update("jax_enable_x64", True)

    headline = [
        bench_one("cant_proxy_sym", proxies.cant_proxy(), rhs=8),
        bench_one("stencil27_sym", proxies.stencil27()),
        bench_one("audikw_proxy_scattered", proxies.audikw_proxy(),
                  iters=1000, reorder=False, rhs=8),
        bench_one("general_asym_stencil", proxies.general_asym(),
                  iters=1000, reorder=False),
    ]
    bench_one("random_band_adversarial", proxies.random_band(),
              iters=1000, reorder=False)
    bench_one("near_band_paired", proxies.near_band_paired(), iters=1000,
              reorder=False)
    bench_one("cant_proxy_sym_bf16", proxies.cant_proxy(),
              values="bfloat16")
    bench_one("audikw_scattered_bf16", proxies.audikw_proxy(), iters=1000,
              reorder=False, values="bfloat16")
    bench_one("cant_proxy_sym_fp64",
              proxies.cant_proxy(dtype=np.float64), dtype=np.float64,
              iters=1000, rhs=8)
    full = None
    if os.environ.get("CFS_BENCH_FULL", "1") != "0":
        full = bench_one("audikw_FULL_scattered",
                         proxies.audikw_proxy(nb=314565), iters=200,
                         reorder=False)

    worst = min(
        headline,
        key=lambda r: r["nnz_s"] / (0.8 * r["sol_nnz_s"]) if r["ok"] else 0,
    )
    value = worst["nnz_s"] if worst["ok"] else 0.0
    print(json.dumps(dict(
        metric="spmv_worst_nnz_s", value=value, unit="nnz/s",
        vs_baseline=value / (0.8 * worst["sol_nnz_s"]),
        worst=worst["name"], device=device,
        preproc_s=sum(r["preproc_s"] for r in headline),
        **({"full": dict(nnz=full["nnz"], nnz_s=full["nnz_s"],
                         vs_roofline=full["nnz_s"] / full["sol_nnz_s"],
                         preproc_s=full["preproc_s"], correct=full["ok"])}
           if full else {}),
    )), flush=True)


if __name__ == "__main__":
    main()
