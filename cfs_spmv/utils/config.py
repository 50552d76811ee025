"""Runtime configuration.

Replacement for the reference's three-layer config system (autoconf
flags + compile-time defines + ``CFS_NUM_THREADS`` env var, see
``configure.ac:48-67``, ``src/Makefile.am:5``, ``src/runtime.cpp:10-21``).
Everything is a runtime setting here; env vars use the same ``CFS_``
prefix. None of them chooses between execution paths: the tuner and
the platform do that.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = [
    "Config",
    "config",
    "env_int",
    "env_flag",
    "checkout_cache_dir",
    "apply_jax_compile_cache",
]

#: root of the checkout that holds this package
_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def checkout_cache_dir(*parts: str) -> str:
    """A directory under ``<checkout>/.cache`` (gitignored): build
    outputs and caches stay inside the checkout."""
    return os.path.join(_ROOT, ".cache", *parts)


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError as e:
        raise ValueError(f"bad integer for ${name}: {v!r}") from e


def env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Config:
    # --- tuning ---
    #: residual fraction above which tune() warns that the symmetric
    #: layout is a bad fit (analog of the HYB threshold decision,
    #: ref csr_matrix.tpp:313-401)
    spill_warn_fraction: float = 0.3

    # --- runtime ---
    #: number of devices to use (0 = all); env CFS_NUM_DEVICES mirrors the
    #: reference's CFS_NUM_THREADS (src/runtime.cpp:10-21)
    num_devices: int = dataclasses.field(
        default_factory=lambda: env_int("CFS_NUM_DEVICES", 0)
    )
    #: plan cache directory ("" disables); improvement over the reference,
    #: which re-parses and re-tunes from scratch every run (SURVEY §5)
    plan_cache_dir: str = dataclasses.field(
        default_factory=lambda: os.environ.get("CFS_PLAN_CACHE", "")
    )
    #: verbose [INFO] logging (runtime flag replacing compile-time
    #: _LOG_INFO, ref configure.ac:64-67)
    log_info: bool = dataclasses.field(
        default_factory=lambda: env_flag("CFS_LOG", False)
    )


def apply_jax_compile_cache() -> None:
    """Enable JAX's persistent compile cache (called at package import;
    safe before backend init). ``JAX_COMPILATION_CACHE_DIR``, when set,
    is left to JAX alone; otherwise the cache lives at a fixed path
    inside the checkout, so a later process finds it again."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    path = checkout_cache_dir("xla")
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:  # read-only checkout: run without a cache
        return
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


#: process-global config instance (mutable; tests may override fields)
config = Config()
