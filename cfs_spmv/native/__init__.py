"""Native host-runtime bindings (C++ via ctypes).

The reference is a C++ library end to end; here the device path is
JAX, and this module is the native runtime around it: the inherently
sequential host-side scans — MMF tokenizing (ref ``src/mmf.cpp:6-44``),
the symmetric triangle split with dense-diagonal fill (single-device
and per-shard) and the symmetrized adjacency for RCM — compiled from
``csrc/cfs_native.cpp`` into a C-ABI shared library.

The library is built on first use with the system ``g++`` into
``<checkout>/.cache/native`` (content-addressed) and loaded with ctypes;
every entry point has a NumPy fallback in its caller that produces the
same output, so an environment without a toolchain still works
(``CFS_NATIVE=0`` forces the fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

from ..utils.config import checkout_cache_dir, env_flag
from ..utils.logging import info

__all__ = [
    "available",
    "parse_mmf_body",
    "assemble_sdia",
    "sym_off_counts",
    "sym_split_fill",
    "dist_sym_count",
    "dist_sym_fill",
    "sym_adjacency",
]

_lock = threading.Lock()
_lib = None
_tried = False

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
    "cfs_native.cpp",
)


def _build() -> str | None:
    """Compile csrc/cfs_native.cpp, content-addressed in the cache dir."""
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    d = checkout_cache_dir("native")
    out = os.path.join(d, f"libcfs_native-{tag}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        os.makedirs(d, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as e:
        print(
            f"cfs_spmv: native build failed ({e}); using NumPy "
            "fallbacks",
            file=sys.stderr,
        )
        return None
    info("native: built %s", out)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not env_flag("CFS_NATIVE", True):
            return None
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64, vp = ctypes.c_int64, ctypes.c_void_p

        lib.cfs_parse_mmf_body.restype = i64
        lib.cfs_parse_mmf_body.argtypes = [
            ctypes.c_char_p, i64, i64, ctypes.c_int32, i64p, i64p, f64p,
        ]
        lib.cfs_assemble_sdia.restype = None
        lib.cfs_assemble_sdia.argtypes = [i64p, i32p, i64, i64, vp, i64, vp]
        lib.cfs_dist_sym_count.restype = i64
        lib.cfs_dist_sym_count.argtypes = [
            i64p, i32p, i64, i64, i64p, i64, i64p, i64p, i64p, i64p,
        ]
        lib.cfs_dist_sym_fill.restype = None
        lib.cfs_dist_sym_fill.argtypes = [
            i64p, i32p, vp, i64, i64, i64, i64p, i64p, i64,
            i32p, i64, i64,
            i64p, i64p, i64p,
            i32p, i32p, vp,
            i32p, i32p, vp,
            i32p, i32p, vp,
            vp,
        ]
        lib.cfs_sym_adjacency.restype = None
        lib.cfs_sym_adjacency.argtypes = [i64p, i32p, i64, i64p, i32p]
        lib.cfs_sym_off_counts.restype = i64
        lib.cfs_sym_off_counts.argtypes = [i64p, i32p, i64, i64p, i64p]
        lib.cfs_sym_split_fill.restype = i64
        lib.cfs_sym_split_fill.argtypes = [
            i64p, i32p, vp, i64, i64, i32p, vp, vp, i32p, i32p, vp,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_mmf_body(body: bytes, nnz: int, width: int):
    """Tokenize an MMF coordinate body natively.

    Returns (row, col, val) int64/int64/float64 arrays (val is zeros for
    width == 2 pattern files), or None when the native library is absent
    or the body is malformed (caller falls back to NumPy parsing).
    """
    lib = _load()
    if lib is None:
        return None
    row = np.empty(nnz, np.int64)
    col = np.empty(nnz, np.int64)
    val = np.zeros(nnz, np.float64)
    got = lib.cfs_parse_mmf_body(
        body, len(body), nnz, width, row, col, val
    )
    if got != nnz:
        return None
    return row, col, val


def assemble_sdia(g, j, val, vals):
    """SDIA value fill (csrc cfs_assemble_sdia): val[i] lands in plane
    j[i] at row g[i] of the (D, n) ``vals``. ``val`` must already be in
    the plan's value dtype. Returns False when the native library is
    unavailable (caller scatters with NumPy)."""
    lib = _load()
    if lib is None:
        return False
    val = np.ascontiguousarray(val)
    assert vals.dtype == val.dtype and vals.flags.c_contiguous
    lib.cfs_assemble_sdia(
        np.ascontiguousarray(g, np.int64),
        np.ascontiguousarray(j, np.int32),
        len(g), vals.shape[1], _ptr(val), val.itemsize, _ptr(vals),
    )
    return True


def sym_off_counts(indptr, indices, n):
    """Per-offset strict-lower counts + structural diagonal count in one
    CSR pass (csrc cfs_sym_off_counts). Returns (cnt, ndiag) with cnt of
    length n (cnt[d] = entries on sub-diagonal d), or None when native
    is unavailable or a strict-upper entry exists."""
    lib = _load()
    if lib is None:
        return None
    cnt = np.zeros(n, np.int64)
    nd = np.zeros(1, np.int64)
    rc = lib.cfs_sym_off_counts(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n, cnt, nd,
    )
    if rc < 0:
        return None
    return cnt, int(nd[0])


def sym_split_fill(indptr, indices, data, n, dmap, vals, diag,
                   rrow, rcol, rval):
    """One-pass symmetric split + SDIA fill (csrc cfs_sym_split_fill):
    diagonal values to ``diag``, selected sub-diagonals into the (D, n)
    ``vals``, the rest appended to the residual triples. ``data`` must
    be in the plan value dtype. Returns the residual count, or None when
    native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data)
    assert diag.dtype == data.dtype and rval.dtype == data.dtype
    return int(lib.cfs_sym_split_fill(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        _ptr(data), data.itemsize, n,
        np.ascontiguousarray(dmap, np.int32),
        _ptr(vals), _ptr(diag), rrow, rcol, _ptr(rval),
    ))


def dist_sym_count(indptr, indices, n, ndev, r_end, shard_rows):
    """Pass A of the distributed symmetric shard split (csrc
    cfs_dist_sym_count): per-shard near-offset histograms + near/far/
    mirror counts + cross-shard entry count, one CSR pass. Returns
    (off_cnt (ndev, shard_rows), cnt_near, cnt_far, cnt_mirror, cross)
    or None when native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    off_cnt = np.zeros((ndev, shard_rows), np.int64)
    cnt_near = np.zeros(ndev, np.int64)
    cnt_far = np.zeros(ndev, np.int64)
    cnt_mirror = np.zeros(ndev, np.int64)
    cross = lib.cfs_dist_sym_count(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n, ndev, np.ascontiguousarray(r_end, np.int64),
        shard_rows, off_cnt.reshape(-1), cnt_near, cnt_far, cnt_mirror,
    )
    return off_cnt, cnt_near, cnt_far, cnt_mirror, int(cross)


def dist_sym_fill(indptr, indices, data, n, r_start, r_end, shard_rows,
                  dmap, near_base, far_base, mir_base, near, far, mirror,
                  dia_vals):
    """Pass B (csrc cfs_dist_sym_fill): route every strict-lower entry
    into the (ndev, D, shard_rows) dense-diagonal planes / near residual
    / own-far / mirror streams in one CSR pass. ``data`` must be in the
    plan value dtype; ``near``/``far``/``mirror`` are preallocated
    (row, col, val) triples sized from pass A's counts. Returns False
    when native is unavailable."""
    lib = _load()
    if lib is None:
        return False
    data = np.ascontiguousarray(data)
    ndev = len(r_start)
    D = 0 if dia_vals is None else dia_vals.shape[1]
    lib.cfs_dist_sym_fill(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        _ptr(data), data.itemsize, n, ndev,
        np.ascontiguousarray(r_start, np.int64),
        np.ascontiguousarray(r_end, np.int64),
        shard_rows, np.ascontiguousarray(dmap, np.int32), len(dmap), D,
        np.ascontiguousarray(near_base, np.int64),
        np.ascontiguousarray(far_base, np.int64),
        np.ascontiguousarray(mir_base, np.int64),
        near[0], near[1], _ptr(near[2]),
        far[0], far[1], _ptr(far[2]),
        mirror[0], mirror[1], _ptr(mirror[2]),
        None if dia_vals is None else _ptr(dia_vals),
    )
    return True


def sym_adjacency(indptr, indices, n, nnz_strict):
    """Symmetrized adjacency (indptr, indices) of a lower-triangle CSR
    in two native passes (csrc cfs_sym_adjacency); self-loops dropped.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    adj_indptr = np.zeros(n + 1, np.int64)
    adj_indices = np.empty(max(2 * nnz_strict, 1), np.int32)
    lib.cfs_sym_adjacency(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n, adj_indptr, adj_indices,
    )
    return adj_indptr, adj_indices
