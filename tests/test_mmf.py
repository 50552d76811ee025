"""MMF loader tests, covering the reference loader semantics
(``io/mmf.hpp``): header parsing, symmetric triangle handling, sorting,
pattern default value, error paths."""

import io

import numpy as np
import pytest

from cfs_spmv.io.mmf import PATTERN_DEFAULT_VALUE, read_mmf, write_mmf


def _file(text: str):
    return io.BytesIO(text.encode())


def test_general_roundtrip(tmp_path):
    p = tmp_path / "g.mtx"
    row = np.array([0, 1, 2, 2])
    col = np.array([1, 0, 2, 0])
    val = np.array([1.5, -2.0, 3.25, 0.5])
    write_mmf(p, 3, 3, row, col, val)
    hdr, r, c, v = read_mmf(p)
    assert (hdr.nrows, hdr.ncols, hdr.nnz_declared) == (3, 3, 4)
    assert not hdr.symmetric
    # sorted by (row, col), ref mmf.hpp:305
    assert list(r) == [0, 1, 2, 2]
    assert list(c) == [1, 0, 0, 2]
    assert v[2] == 0.5 and v[3] == 3.25


def test_symmetric_triangle_kept():
    txt = (
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 4\n"
        "1 1 2.0\n2 1 -1.0\n3 3 4.0\n3 2 0.5\n"
    )
    hdr, r, c, v = read_mmf(_file(txt))
    assert hdr.symmetric
    assert len(r) == 4  # triangle only
    assert np.all(r >= c)  # canonical lower


def test_symmetric_expand():
    txt = (
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 4\n"
        "1 1 2.0\n2 1 -1.0\n3 3 4.0\n3 2 0.5\n"
    )
    hdr, r, c, v = read_mmf(_file(txt), expand_symmetric=True)
    # 2 diag + 2 off-diag mirrored -> 6 entries, ref mmf.hpp:279-293
    assert len(r) == 6
    dense = np.zeros((3, 3))
    dense[r, c] = v
    assert np.allclose(dense, dense.T)


def test_upper_triangle_input_canonicalized():
    txt = (
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "2 2 2\n"
        "1 1 1.0\n1 2 5.0\n"  # stored as upper; must flip to lower
    )
    _, r, c, v = read_mmf(_file(txt))
    assert np.all(r >= c)
    assert v[np.flatnonzero((r == 1) & (c == 0))[0]] == 5.0


def test_pattern_default_value():
    txt = (
        "%%MatrixMarket matrix coordinate pattern general\n"
        "2 2 2\n1 1\n2 2\n"
    )
    _, r, c, v = read_mmf(_file(txt))
    assert np.all(v == PATTERN_DEFAULT_VALUE)  # ref mmf.hpp:334-337


def test_bad_header_rejected():
    with pytest.raises(ValueError):
        read_mmf(_file("%%MatrixMarket matrix array real general\n1 1\n"))
    with pytest.raises(ValueError):
        read_mmf(_file("not a matrix\n"))


def test_out_of_bounds_rejected():
    txt = (
        "%%MatrixMarket matrix coordinate real general\n"
        "2 2 1\n5 1 1.0\n"
    )
    with pytest.raises(ValueError):
        read_mmf(_file(txt))


def test_truncated_body_rejected():
    txt = (
        "%%MatrixMarket matrix coordinate real general\n"
        "2 2 3\n1 1 1.0\n"
    )
    with pytest.raises(ValueError):
        read_mmf(_file(txt))


@pytest.mark.parametrize("token", ["base-0", "0-base"])
def test_zero_based_variant(token):
    """0-based coordinate variant, reference spelling ``base-0``
    (ref mmf.hpp:239-250); ``0-base`` kept as a legacy alias."""
    import io

    text = (
        f"%%MatrixMarket matrix coordinate real general {token}\n"
        "3 3 3\n0 0 1.5\n1 2 2.5\n2 0 3.5\n"
    )
    hdr, r, c, v = read_mmf(io.StringIO(text))
    assert hdr.zero_based
    np.testing.assert_array_equal(r, [0, 1, 2])
    np.testing.assert_array_equal(c, [0, 2, 0])
    np.testing.assert_allclose(v, [1.5, 2.5, 3.5])


def test_base1_and_order_tokens():
    """All four reference variant tokens parse (ref mmf.hpp:239-250):
    base-1 keeps 1-based indexing; column/row only declare entry order
    (we sort unconditionally, mirroring the reference's load-and-sort)."""
    import io

    text = (
        "%%MatrixMarket matrix coordinate real general base-1 column\n"
        "3 3 3\n1 1 1.5\n3 1 3.5\n2 3 2.5\n"
    )
    hdr, r, c, v = read_mmf(io.StringIO(text))
    assert not hdr.zero_based
    assert hdr.col_wise
    np.testing.assert_array_equal(r, [0, 1, 2])
    np.testing.assert_array_equal(c, [0, 2, 0])

    text_row = (
        "%%MatrixMarket matrix coordinate real general base-0 row\n"
        "2 2 2\n0 0 1.0\n1 1 2.0\n"
    )
    hdr2, r2, c2, _ = read_mmf(io.StringIO(text_row))
    assert hdr2.zero_based and not hdr2.col_wise
    np.testing.assert_array_equal(r2, [0, 1])


def test_column_major_file_sorted():
    """Column-wise-listed files land (row, col) sorted regardless
    (ref mmf.hpp:239-250 col-wise variant; here by full sort)."""
    import io

    text = (
        "%%MatrixMarket matrix coordinate real general\n"
        "3 3 4\n3 1 30.0\n1 1 10.0\n3 2 32.0\n2 2 22.0\n"
    )
    _, r, c, v = read_mmf(io.StringIO(text))
    np.testing.assert_array_equal(r, [0, 1, 2, 2])
    np.testing.assert_array_equal(c, [0, 1, 0, 1])
    np.testing.assert_allclose(v, [10.0, 22.0, 30.0, 32.0])


def test_inline_comment_paths_agree(monkeypatch):
    """Native scanner and NumPy fallback accept the same comment forms
    ('%' to EOL is whitespace anywhere between tokens) and produce
    identical arrays — the bit-identical contract for nonstandard but
    tolerated bodies."""
    import io

    from cfs_spmv import native as _nat
    from cfs_spmv.io import mmf as mmf_mod

    text = (
        "%%MatrixMarket matrix coordinate real general\n"
        "3 3 3\n"
        "1 1 1.5  % trailing inline comment\n"
        "% whole-line comment between records\n"
        "2 3 2.5\n"
        "3 1 3.5   \n"
    )
    res_native = read_mmf(io.StringIO(text))
    monkeypatch.setattr(
        mmf_mod._native, "parse_mmf_body", lambda *a, **k: None
    )
    res_py = read_mmf(io.StringIO(text))
    for a, b in zip(res_native[1:], res_py[1:]):
        np.testing.assert_array_equal(a, b)
    if _nat.available():  # both really were exercised
        assert res_native[3].dtype == res_py[3].dtype


def test_integer_field():
    import io

    text = (
        "%%MatrixMarket matrix coordinate integer general\n"
        "2 2 2\n1 1 4\n2 2 -7\n"
    )
    hdr, r, c, v = read_mmf(io.StringIO(text))
    assert hdr.field == "integer"
    np.testing.assert_allclose(v, [4.0, -7.0])
