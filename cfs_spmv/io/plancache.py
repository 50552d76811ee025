"""Tuned-plan serialization and content-addressed caching.

The reference re-parses the .mtx and re-runs the whole tuning pipeline
(partition + graph + coloring) on every process start
(``bench_spmv_mmf.cpp:145-148``); SURVEY §5 flags persisting the tuned
format as a designed improvement. Plans serialize to a single ``.npz``
(arrays + a JSON manifest entry) and ``tune()`` consults a
content-addressed cache keyed by the matrix payload and the build
parameters.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from ..formats.ell import EllPlan
from ..formats.plan import MatrixPlan
from ..formats.sdia import SDiaPlan
from ..utils.logging import info

__all__ = ["save_plan", "load_plan", "cache_key", "cached_build"]

#: bump to invalidate every cached plan (layout/kernel contract changes)
PLAN_VERSION = 21  # 21: (D, n) diagonal planes + ELL/COO residual

_PLAN_TYPES = {
    "MatrixPlan": MatrixPlan,
    "EllPlan": EllPlan,
    "SDiaPlan": SDiaPlan,
}


def _flatten(plan, prefix, arrays, manifest):
    cls = type(plan).__name__
    if cls not in _PLAN_TYPES:
        raise TypeError(f"cannot serialize {cls}")
    fields = {}
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        key = f"{prefix}{f.name}"
        if isinstance(v, np.ndarray):
            if str(v.dtype) == "bfloat16":  # npz has no bf16; tag + view
                arrays[key] = v.view(np.uint16)
                fields[f.name] = {"kind": "array", "dtype": "bfloat16"}
            else:
                arrays[key] = v
                fields[f.name] = {"kind": "array"}
        elif isinstance(v, tuple(_PLAN_TYPES.values())):
            fields[f.name] = {"kind": "plan"}
            _flatten(v, key + ".", arrays, manifest)
        elif v is None:
            fields[f.name] = {"kind": "none"}
        elif isinstance(v, tuple):
            fields[f.name] = {"kind": "tuple", "value": list(v)}
        else:
            fields[f.name] = {"kind": "scalar", "value": v}
    manifest[prefix.rstrip(".") or "root"] = {"cls": cls, "fields": fields}


def save_plan(path, plan) -> None:
    """Serialize a plan (MatrixPlan / EllPlan / SDiaPlan) to .npz."""
    arrays: dict = {}
    manifest: dict = {}
    _flatten(plan, "root.", arrays, manifest)
    arrays["__manifest__"] = np.frombuffer(
        json.dumps({"version": PLAN_VERSION, "nodes": manifest}).encode(),
        dtype=np.uint8,
    )
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _rebuild(prefix, nodes, data):
    node = nodes[prefix.rstrip(".") or "root"]
    cls = _PLAN_TYPES[node["cls"]]
    kwargs = {}
    for name, spec in node["fields"].items():
        key = f"{prefix}{name}"
        if spec["kind"] == "array":
            arr = data[key]
            if spec.get("dtype") == "bfloat16":
                import ml_dtypes

                arr = arr.view(ml_dtypes.bfloat16)
            kwargs[name] = arr
        elif spec["kind"] == "plan":
            kwargs[name] = _rebuild(key + ".", nodes, data)
        elif spec["kind"] == "none":
            kwargs[name] = None
        elif spec["kind"] == "tuple":
            kwargs[name] = tuple(spec["value"])
        else:
            kwargs[name] = spec["value"]
    return cls(**kwargs)


def load_plan(path):
    """Load a plan saved by :func:`save_plan`.

    Raises ``ValueError`` on version mismatch (caller rebuilds)."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    m = json.loads(bytes(data.pop("__manifest__")).decode())
    if m["version"] != PLAN_VERSION:
        raise ValueError(
            f"plan version {m['version']} != {PLAN_VERSION}"
        )
    return _rebuild("root.", m["nodes"], data)


def cache_key(csr, dtype, **params) -> str:
    """Content hash of matrix payload + build parameters."""
    h = hashlib.sha256()
    h.update(f"v{PLAN_VERSION};{np.dtype(dtype).name};".encode())
    h.update(json.dumps(params, sort_keys=True).encode())
    h.update(np.int64([csr.nrows, csr.ncols, csr.nnz]).tobytes())
    h.update(np.ascontiguousarray(csr.indptr).tobytes())
    h.update(np.ascontiguousarray(csr.indices).tobytes())
    h.update(np.ascontiguousarray(csr.data).tobytes())
    return h.hexdigest()[:32]


def cached_build(build_fn, csr, dtype, cache_dir, **params):
    """Build via ``build_fn()`` with content-addressed .npz caching.

    ``cache_dir`` empty/None disables caching entirely."""
    if not cache_dir:
        return build_fn()
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(
        cache_dir, f"plan-{cache_key(csr, dtype, **params)}.npz"
    )
    if os.path.exists(path):
        try:
            plan = load_plan(path)
            info("plancache: hit %s", path)
            return plan
        except (ValueError, KeyError, OSError) as e:
            info("plancache: discarding %s (%s)", path, e)
    plan = build_fn()
    save_plan(path, plan)
    info("plancache: saved %s", path)
    return plan
