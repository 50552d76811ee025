#!/usr/bin/env python3
"""Smoke test of the normal path on a CUDA GPU.

Runs the user entry points (``SparseMatrix.create`` → ``SpDMV`` /
``SpDMM`` → solvers; ``DistSpDMV`` with ``--four``) at real sizes in one
process and checks every result against the host CSR oracle. Each phase
prints what it compared, the tolerance and the result; any failure
raises and exits non-zero. The last line is one JSON object naming the
device.

    python chip_smoke.py          # one GPU: phases 0-3
    python chip_smoke.py --four   # four GPUs: the distributed phase only

Exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

ROOT = os.path.dirname(os.path.abspath(__file__))


def smi_line() -> str:
    """``nvidia-smi`` name and power limit, from a child that never
    imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"
    return " | ".join(line.strip() for line in out.splitlines() if line)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, phase: str, what: str) -> None:
    if not cond:
        raise AssertionError(f"[{phase}] FAILED: {what}")


def spmv_check(phase, label, y, csr, x, dtype, nnz_full):
    """Compare y (one vector or columns of a block) with the fp64 host
    oracle under the backward-error bound of ``allclose_spmv``."""
    import numpy as np

    from cfs_spmv.utils.platform import allclose_spmv, rel_tolerance

    y = np.asarray(y)
    npr = max(nnz_full / max(csr.nrows, 1), 1.0)
    eps = rel_tolerance(dtype) * max(1.0, float(np.sqrt(npr)))
    cols = [(y, x)] if y.ndim == 1 else [
        (y[:, b], x[:, b]) for b in range(y.shape[1])
    ]
    worst = 0.0
    ok = bool(np.all(np.isfinite(y)))
    for yc, xc in cols:
        xd = np.asarray(xc, np.float64)
        ref = csr.spmv_host(xd)
        scale = np.maximum(csr.spmv_host(xd, absolute=True), np.abs(ref))
        err = np.abs(yc.astype(np.float64) - ref) / np.maximum(
            scale, np.finfo(np.float64).tiny
        )
        worst = max(worst, float(err.max(initial=0.0)))
        ok &= allclose_spmv(yc, ref, dtype, nnz_per_row=npr, scale=scale)
    say(phase, f"{label}: vs host oracle, max |y-ref|/(|A||x|) = "
        f"{worst:.3e}, tolerance {eps:.3e} -> {'ok' if ok else 'FAIL'}")
    require(ok, phase, label)


def measure(phase, label, tuned, x):
    """Compile and time the pure applier (information only)."""
    import jax
    import numpy as np

    from cfs_spmv.utils.timing import as_pure

    fn, ops, encode, _ = as_pure(tuned)
    xd = jax.device_put(encode(x))
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(ops, xd).compile()
    t_compile = time.perf_counter() - t0
    compiled(ops, xd).block_until_ready()
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        compiled(ops, xd).block_until_ready()
        ts.append(time.perf_counter() - t0)
    mem = compiled.memory_analysis()
    mb = (lambda a: -1.0 if mem is None else getattr(mem, a) / 2**20)
    txt = compiled.as_text()
    entry = txt[txt.index("\nENTRY"):]
    kernels = entry.count(" fusion(") + entry.count(" custom-call(") + \
        entry.count(" scatter(") + entry.count(" gather(")
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", -1
    )
    say(phase, f"{label}: compile_s={t_compile:.3f} "
        f"ms_per_call={1e3 * float(np.median(ts)):.4f} "
        f"ms_min={1e3 * min(ts):.4f} kernels={kernels} "
        f"args_MB={mb('argument_size_in_bytes'):.1f} "
        f"temp_MB={mb('temp_size_in_bytes'):.1f} "
        f"out_MB={mb('output_size_in_bytes'):.1f} "
        f"peak_bytes_in_use={peak} (information only)")


def single_case(phase, name, csr, *, dtype, values="same", rhs=0,
                reorder="auto"):
    """tune → SpDMV (and SpDMM) through the user API, checked and
    timed."""
    import jax.numpy as jnp
    import numpy as np

    from cfs_spmv import Format, SparseMatrix, SpDMM, SpDMV, Tuning

    fmt = Format.SSS if csr.symmetric else Format.CSR
    A = SparseMatrix.create(csr, fmt)
    t0 = time.perf_counter()
    sp = SpDMV(A, Tuning.AGGRESSIVE, dtype=dtype, values=values,
               reorder=reorder)
    t_setup = time.perf_counter() - t0
    t = A.tuned
    plan = t.plan
    say(phase, f"{name}: n={csr.nrows} nnz={t.nnz_full} dtype="
        f"{np.dtype(dtype).name} values={values} setup_s={t_setup:.2f} "
        f"diagonals={0 if plan.dia is None else len(plan.dia.offsets)} "
        f"ell_width={0 if plan.resid is None else plan.resid.width} "
        f"tail={0 if plan.resid is None else len(plan.resid.tail_row)} "
        f"reordered={t.perm is not None}")
    tol = jnp.bfloat16 if values == "bfloat16" else dtype
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, csr.ncols).astype(dtype)
    spmv_check(phase, f"{name} SpMV", sp(x), csr, x, tol, t.nnz_full)
    measure(phase, f"{name} SpMV", t, x)
    if rhs:
        X = rng.uniform(-1, 1, (csr.ncols, rhs)).astype(dtype)
        spmv_check(phase, f"{name} SpMM({rhs})", SpDMM(A, dtype=dtype,
                   values=values, reorder=reorder)(X), csr, X, tol,
                   t.nnz_full)
        measure(phase, f"{name} SpMM({rhs})", t, X)


def phase_config1():
    """BASELINE config 1: a 1138_bus-scale SPD matrix through an .mtx
    file, fp64 against dense NumPy, then the reference test harness."""
    import numpy as np

    from cfs_spmv import COO, Format, SparseMatrix, SpDMV
    from cfs_spmv.cli.test_spmv_mmf import main as test_cli
    from cfs_spmv.io import write_mmf
    from cfs_spmv.utils.platform import is_equal, rel_tolerance

    ph = "1 config1"
    n = 1138
    coo = COO.random(n, n, 3.5, symmetric=True, bandwidth=40, seed=1,
                     dtype=np.float64)
    d = np.arange(n)
    # strictly diagonally dominant: SPD
    row = np.concatenate([coo.row[coo.row != coo.col], d])
    col = np.concatenate([coo.col[coo.row != coo.col], d])
    val = np.concatenate([coo.val[coo.row != coo.col], np.full(n, 40.0)])
    spd = COO(n, n, row, col, val, symmetric=True).canonicalize()
    path = os.path.join(ROOT, ".cache", "smoke", "spd_1138.mtx")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_mmf(path, n, n, spd.row, spd.col, spd.val,
              symmetric=True)
    A = SparseMatrix.create(path, Format.SSS)
    x = np.random.default_rng(3).uniform(10.01, 20.42, n)
    y = np.asarray(SpDMV(A, dtype=np.float64)(x))
    dense = spd.to_dense()
    ref = dense @ x
    ok = is_equal(y, ref, np.float64)
    rel = float(np.max(np.abs(y - ref) / np.abs(ref)))
    say(ph, f"SpDMV fp64 on {path} (n={n}, nnz={A.nnz_full}) vs dense "
        f"NumPy: max rel err {rel:.3e}, tolerance "
        f"{rel_tolerance(np.float64):.0e} -> {'ok' if ok else 'FAIL'}")
    require(ok, ph, "fp64 SpDMV vs dense")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = test_cli([path, "1", "--dp"])
    out = buf.getvalue().strip()
    say(ph, f"cli.test_spmv_mmf {os.path.basename(path)} sss --dp: "
        f"printed {out!r}, rc={rc} -> "
        f"{'ok' if out == 'PASSED!' and rc == 0 else 'FAIL'}")
    require(out == "PASSED!" and rc == 0, ph, "test_spmv_mmf")


def phase_single():
    import numpy as np

    from cfs_spmv.utils import proxies

    ph = "2 single"
    single_case(ph, "cant_proxy", proxies.cant_proxy(), dtype=np.float32,
                rhs=8)
    single_case(ph, "stencil27_g100", proxies.stencil27(g=100),
                dtype=np.float32)
    single_case(ph, "general_asym_g80", proxies.general_asym(g=80),
                dtype=np.float32, reorder=False)
    t0 = time.perf_counter()
    aud = proxies.audikw_proxy(nb=314565)
    say(ph, f"audikw full scale generated in "
        f"{time.perf_counter() - t0:.1f}s")
    single_case(ph, "audikw_full", aud, dtype=np.float32, rhs=8,
                reorder=False)
    single_case(ph, "audikw_full", aud, dtype=np.float32,
                values="bfloat16", rhs=8, reorder=False)
    del aud
    t0 = time.perf_counter()
    queen = proxies.cant_proxy(n=4_147_110, half_bw=40)
    say(ph, f"queen-scale band generated in "
        f"{time.perf_counter() - t0:.1f}s")
    single_case(ph, "queen_band", queen, dtype=np.float32)
    single_case(ph, "queen_band", queen, dtype=np.float64)


def spd_stencil(g):
    """stencil27 with its diagonal raised to the absolute row sum + 1:
    symmetric, strictly diagonally dominant, hence SPD."""
    import numpy as np

    from cfs_spmv.utils import proxies

    csr = proxies.stencil27(g=g, dtype=np.float64)
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.indptr))
    on = rows == csr.indices
    absrow = csr.spmv_host(np.ones(csr.nrows), absolute=True)
    csr.data[on] = absrow[rows[on]] - csr.data[on] + 1.0
    return csr


def phase_solver():
    import numpy as np

    from cfs_spmv import Format, SparseMatrix, SpDMV
    from cfs_spmv.models import solvers

    ph = "3 solver"
    csr = spd_stencil(100)
    A = SparseMatrix.create(csr, Format.SSS)
    sp = SpDMV(A, dtype=np.float32)
    b = np.random.default_rng(5).uniform(1, 2, csr.nrows).astype(
        np.float32
    )
    tol, iters = 1e-5, 60
    t0 = time.perf_counter()
    x, _, hist = solvers.cg(sp, b, iters=iters)
    x = np.asarray(x)
    dt = time.perf_counter() - t0
    hist = np.asarray(hist) / np.linalg.norm(b)
    reached = int(np.argmax(hist < tol)) + 1 if (hist < tol).any() else -1
    r = b.astype(np.float64) - csr.spmv_host(x.astype(np.float64))
    rel = float(np.linalg.norm(r) / np.linalg.norm(b))
    ok = rel < tol and bool(np.isfinite(x).all())
    say(ph, f"cg on SPD stencil27 (n={csr.nrows}), {iters} "
        f"iterations in one lax.scan ({dt:.2f}s incl. compile): "
        f"recurrence residual < {tol:.0e} at iteration {reached}; true "
        f"relative residual (fp64 host) {rel:.3e}, tolerance "
        f"{tol:.0e} -> {'ok' if ok else 'FAIL'}")
    require(ok, ph, "cg residual")


def dist_case(ph, name, csr, mesh, *, dtype, comm):
    import numpy as np

    from cfs_spmv import Format, SparseMatrix, SpDMV
    from cfs_spmv.parallel.dist import DistSpDMV
    from cfs_spmv.utils.platform import allclose_spmv, rel_tolerance

    t0 = time.perf_counter()
    dsp = DistSpDMV(csr, mesh, dtype=dtype, comm=comm)
    t_setup = time.perf_counter() - t0
    require(dsp.comm == comm, ph, f"{name}: comm resolved to {dsp.comm}")
    say(ph, f"{name}: n={csr.nrows} nnz={dsp.nnz_full} dtype="
        f"{np.dtype(dtype).name} comm={dsp.comm} halo_rows="
        f"{dsp.halo_rows} far_fraction={dsp.far_fraction:.4f} "
        f"diagonals={len(dsp.dia_offsets)} setup_s={t_setup:.2f}")
    x = np.random.default_rng(9).uniform(-1, 1, csr.nrows).astype(dtype)
    y = np.asarray(dsp(x))
    spmv_check(ph, f"{name} DistSpDMV", y, csr, x, dtype, dsp.nnz_full)
    A = SparseMatrix.create(csr, Format.SSS if csr.symmetric
                            else Format.CSR)
    y1 = np.asarray(SpDMV(A, dtype=dtype, reorder=False)(x))
    xd = x.astype(np.float64)
    npr = dsp.nnz_full / csr.nrows
    ok = allclose_spmv(y, y1, dtype, nnz_per_row=npr,
                       scale=csr.spmv_host(xd, absolute=True))
    eps = rel_tolerance(dtype) * max(1.0, float(np.sqrt(npr)))
    say(ph, f"{name}: DistSpDMV vs single-card SpDMV on card 0: max "
        f"|diff| {float(np.max(np.abs(y - y1))):.3e}, tolerance {eps:.3e}"
        f" x |A||x| -> {'ok' if ok else 'FAIL'}")
    require(ok, ph, f"{name} dist vs single")
    measure(ph, f"{name} DistSpDMV", dsp, x)


def phase_four():
    import jax
    import numpy as np

    from cfs_spmv.parallel.mesh import make_mesh
    from cfs_spmv.utils import proxies

    ph = "4 four"
    require(len(jax.devices()) >= 4, ph,
            f"needs 4 GPUs, found {len(jax.devices())}")
    mesh = make_mesh(4)
    t0 = time.perf_counter()
    nlp = proxies.stencil27(g=203)
    say(ph, f"nlpkkt-scale stencil generated in "
        f"{time.perf_counter() - t0:.1f}s")
    dist_case(ph, "nlpkkt_stencil", nlp, mesh, dtype=np.float32,
              comm="halo")
    del nlp
    queen = proxies.cant_proxy(n=4_147_110, half_bw=40)
    dist_case(ph, "queen_band", queen, mesh, dtype=np.float64, comm="halo")
    del queen
    dist_case(ph, "audikw_proxy", proxies.audikw_proxy(), mesh,
              dtype=np.float32, comm="gather")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU distributed phase")
    args = ap.parse_args()

    smi = smi_line()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[0 device] no GPU: JAX platform is {dev.platform!r}",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    from cfs_spmv import native

    say("0 device", f"device_kind={dev.device_kind!r} count="
        f"{len(jax.devices())} jax={jax.__version__} XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r} native_library="
        f"{native.available()}")
    t_all = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_config1()
        phase_single()
        phase_solver()
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f}s")
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
