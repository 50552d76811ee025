"""CLI harness tests (ref test/test_spmv_mmf.cpp + bench_spmv_mmf.cpp).

Runs both command-line tools in-process on the CPU backend against a
generated .mtx fixture, covering the reference's integer format codes.
"""

import numpy as np
import pytest

from cfs_spmv.cli import parse_format
from cfs_spmv.cli.bench_spmv_mmf import main as run_bench_cli
from cfs_spmv.cli.test_spmv_mmf import main as run_test_cli
from cfs_spmv.io.mmf import write_mmf
from cfs_spmv.utils.platform import Format


@pytest.fixture(scope="module")
def mtx_path(tmp_path_factory):
    from cfs_spmv.formats.coo import COO

    coo = COO.random(
        500, 500, 4.0, symmetric=True, bandwidth=60, seed=11,
        dtype=np.float64,
    )
    p = tmp_path_factory.mktemp("cli") / "small_sym.mtx"
    write_mmf(p, coo.nrows, coo.ncols, coo.row, coo.col, coo.val,
              symmetric=True)
    return str(p)


def test_parse_format_codes():
    assert parse_format("0") is Format.CSR
    assert parse_format("1") is Format.SSS
    assert parse_format("2") is Format.HYB
    assert parse_format("sss") is Format.SSS
    with pytest.raises(SystemExit):
        parse_format("3")
    with pytest.raises(SystemExit):
        parse_format("nope")


@pytest.mark.parametrize("fmt", ["0", "1", "2"])
def test_cli_test_harness(mtx_path, fmt, capsys):
    assert run_test_cli([mtx_path, fmt]) == 0
    assert "PASSED!" in capsys.readouterr().out


def test_cli_test_harness_dp(mtx_path, capsys):
    assert run_test_cli([mtx_path, "1", "--dp"]) == 0
    assert "PASSED!" in capsys.readouterr().out


def test_cli_test_usage_error(capsys):
    assert run_test_cli([]) == 1


def test_cli_bench_harness(mtx_path, capsys):
    assert run_bench_cli([mtx_path, "1", "6"]) == 0
    out = capsys.readouterr().out
    assert "preproc(sec):" in out and "gflops/s:" in out


def test_cli_bench_spmm(mtx_path, capsys):
    assert run_bench_cli([mtx_path, "1", "4", "--rhs", "8"]) == 0
    assert "SSS-MM8" in capsys.readouterr().out


def test_cli_bench_dist(mtx_path, capsys):
    from cfs_spmv.cli.bench_dist import main as run_dist_cli

    assert run_dist_cli([mtx_path, "4", "--devices", "2"]) == 0
    out = capsys.readouterr().out
    assert "devices: 1" in out and "devices: 2" in out
    assert "efficiency:" in out


def test_cli_bench_dist_weak(mtx_path, capsys):
    from cfs_spmv.cli.bench_dist import main as run_dist_cli

    assert run_dist_cli([mtx_path, "4", "--devices", "2", "--weak"]) == 0
    assert "efficiency:" in capsys.readouterr().out


@pytest.mark.parametrize("rival", ["3", "4"])
def test_cli_bench_rivals(mtx_path, rival, capsys):
    """Rival backends (reference codes 3=MKL/4=RSB → here BCOO/dense)."""
    assert run_bench_cli([mtx_path, rival, "4"]) == 0
    out = capsys.readouterr().out
    assert ("BCOO" if rival == "3" else "DENSE") in out


def test_cli_bench_dist_gen(capsys, tmp_path):
    """--gen runs a generated BASELINE-structure proxy (no .mtx file)
    and reports one row per device count, plus a JSON record naming
    the device."""
    import json

    from cfs_spmv.cli.bench_dist import main as run_dist_cli

    jf = str(tmp_path / "dist.jsonl")
    assert run_dist_cli(
        ["--gen", "band_small", "2", "--devices", "2", "--json", jf]
    ) == 0
    rec = json.loads(open(jf).read().splitlines()[-1])
    out = capsys.readouterr().out
    assert "devices: 1" in out and "devices: 2" in out
    assert rec["ndev"] == [1, 2] and rec["device"]["platform"] == "cpu"
