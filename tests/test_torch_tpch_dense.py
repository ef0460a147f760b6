"""The port's dense-code Q1 (``benchsuite/tpch.py`` ``q1_dense``) against
the JAX package's ``q1_dense`` over the same file, against the port's
sort-based ``q1`` and against the numpy reference.

An SF0.01 lineitem (all ten columns, utf8 flags) is written by the port's
writer, then scanned by each package; each package's ``q1_dense`` runs
over its own scan.  The arrow tables must be equal (``pa.Table.equals``):
the integer sums exactly, the averages (each the float64 quotient of an
exact sum by a count) to the bit.
"""

import numpy as np
import pytest

from strawboat_tpu_torch.benchsuite import tpch
from strawboat_tpu_torch.exec import scan_file

SCALE = 0.01


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    cols = tpch.generate_lineitem(SCALE)
    path = str(tmp_path_factory.mktemp("dense") / "lineitem.str")
    tpch.write_lineitem(path, cols, max_page_size=8192)
    return path, cols


def _close_rows(got: dict, want: dict) -> None:
    """Integer aggregates exact, the averages to rtol 1e-12."""
    assert got.keys() == want.keys()
    for key, aggs in want.items():
        for name, w in aggs.items():
            if isinstance(w, float):
                np.testing.assert_allclose(got[key][name], w, rtol=1e-12, err_msg=f"{key} {name}")
            else:
                assert got[key][name] == w, (key, name)


@pytest.mark.parametrize("delta_days", [tpch.Q1_DEFAULT_DELTA, 1000])
def test_q1_dense_equals_the_jax_q1_dense(lineitem, delta_days):
    from strawboat_tpu.benchsuite.tpch import q1_dense as ref_q1_dense
    from strawboat_tpu.exec.scan import scan_file as ref_scan

    path, cols = lineitem
    got = tpch.q1_dense(scan_file(path, "cpu"), delta_days)
    want = ref_q1_dense(ref_scan(path), delta_days)
    assert got.schema.equals(want.schema), (got.schema, want.schema)
    assert got.equals(want)
    ref = tpch.q1_numpy_reference(cols, delta_days)
    assert got.num_rows == len(ref) > 1
    assert got.column_names == ["l_returnflag", "l_linestatus", *tpch.Q1_AGG_NAMES]
    _close_rows(tpch.q1_table_rows(got), ref)


def test_q1_dense_equals_the_sort_based_q1(lineitem):
    path, cols = lineitem
    dt = scan_file(path, "cpu")
    dense = tpch.q1_table_rows(tpch.q1_dense(dt))
    assert dense == tpch.q1_rows(tpch.q1(dt))
    assert list(dense) == sorted(dense)  # ordered by the two keys
    assert dense == tpch.q1_numpy_reference(cols)


def test_q1_dense_over_an_integer_only_scan_needs_the_flags(lineitem):
    """The dense path reads the two flag columns' dictionaries: a scan
    without them raises, as the reference's does (a missing column)."""
    path, _cols = lineitem
    dt = scan_file(path, "cpu", columns=["l_shipdate", *tpch.MONEY_COLUMNS])
    with pytest.raises(KeyError):
        tpch.q1_dense(dt)
