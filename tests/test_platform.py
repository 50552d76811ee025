"""Substrate tests: tolerances, helpers, config env handling."""

import numpy as np

from cfs_spmv.utils import config as config_mod
from cfs_spmv.utils.platform import (
    iceildiv,
    is_equal,
    rel_tolerance,
    round_up,
)


def test_tolerances_match_reference():
    # ref platform.hpp:27-37
    assert rel_tolerance(np.float32) == 1e-4
    assert rel_tolerance(np.float64) == 1e-8


def test_is_equal():
    assert is_equal([1.0, 2.0], [1.0, 2.0])
    assert is_equal(
        np.float32(1.0), np.float32(1.0 + 5e-5), dtype=np.float32
    )
    assert not is_equal(
        np.float32(1.0), np.float32(1.001), dtype=np.float32
    )
    assert is_equal(0.0, 0.0)


def test_iceildiv_roundup():
    assert iceildiv(10, 3) == 4
    assert iceildiv(9, 3) == 3
    assert round_up(1, 128) == 128
    assert round_up(128, 128) == 128
    assert round_up(129, 128) == 256


def test_env_int(monkeypatch):
    monkeypatch.setenv("CFS_NUM_DEVICES", "4")
    assert config_mod.env_int("CFS_NUM_DEVICES", 0) == 4
    monkeypatch.setenv("CFS_NUM_DEVICES", "")
    assert config_mod.env_int("CFS_NUM_DEVICES", 3) == 3


def test_env_flag(monkeypatch):
    monkeypatch.setenv("CFS_LOG", "true")
    assert config_mod.env_flag("CFS_LOG", False)
    monkeypatch.setenv("CFS_LOG", "0")
    assert not config_mod.env_flag("CFS_LOG", True)


def test_roofline_report():
    import numpy as np

    from cfs_spmv import COO, CSR, Format
    from cfs_spmv.tuning.tune import tune
    from cfs_spmv.utils.trace import report_spmv

    from cfs_spmv.utils.roofline import device_spec

    coo = COO.random(800, 800, 5.0, symmetric=True, bandwidth=40, seed=0)
    t = tune(CSR.from_coo(coo), fmt=Format.SSS)
    # a CPU run has no device peak: the share needs a named device
    rep = report_spmv(
        t, t_iter=10e-6, spec=device_spec("NVIDIA H100 80GB HBM3")
    )
    assert rep.nnz_per_s == t.nnz_full / 10e-6
    assert 0 < rep.sol_fraction
    assert "Gnnz/s" in str(rep) and "H100" in str(rep)


def test_roofline_table():
    """Peaks are keyed by device_kind (NVIDIA's H100 SXM data sheet);
    an unknown device raises instead of falling back to a default."""
    import pytest

    from cfs_spmv.utils import roofline

    h100 = roofline.device_spec("NVIDIA H100 80GB HBM3")
    assert h100.hbm_bw_bytes_s == 3.35e12
    assert h100.bf16_flops == 989e12 and h100.f32_flops == 67e12
    assert h100.l2_bytes == 50 * 2**20 and h100.hbm_bytes == 80 * 10**9
    assert "data sheet" in h100.source
    for kind in ("cpu", "Unknown Accelerator", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(ValueError, match="no peak rates"):
            roofline.device_spec(kind)
    with pytest.raises(ValueError):
        roofline.detect_device()  # the test backend is the CPU
    bpn = roofline.spmv_bytes_per_nnz(nnz=1000, nrows=10, ncols=10)
    assert bpn == (8 * 1000 + 4 * 20) / 1000
    assert roofline.speed_of_light_nnz_s(h100, bpn) == 3.35e12 / bpn


def test_compile_cache_follows_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the package sets no cache
    directory of its own; unset, the cache lives at a fixed path inside
    the checkout."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent/elsewhere")
    before = jax.config.jax_compilation_cache_dir
    config_mod.apply_jax_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        config_mod.apply_jax_compile_cache()
        want = config_mod.checkout_cache_dir("xla")
        assert jax.config.jax_compilation_cache_dir == want
        assert want.endswith("/.cache/xla")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_profile_context(tmp_path):
    import jax
    import jax.numpy as jnp

    from cfs_spmv.utils.trace import profile

    try:
        with profile(str(tmp_path)):
            jnp.sum(jnp.ones(16)).block_until_ready()
    except Exception:  # profiler unavailable in some CPU builds
        return
    assert any(tmp_path.iterdir())
