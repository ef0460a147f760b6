"""Q6 and Q1 through the torch port against the JAX package and numpy.

Q6 runs through ``filter_sum`` and Q1 through the port's ``Query(rt)``;
both are compared with the JAX ``Query`` / ``filter_sum`` over the JAX
resident table (Pallas in interpret mode) and with the numpy references.
Tolerance: exact, except Q1's ``avg_*`` columns — float64 quotients of exact
int64 sums, computed in other orders by numpy: rtol 1e-12.
"""

import importlib
from unittest import mock

import numpy as np
import pyarrow as pa
import pytest
import torch

from strawboat_tpu_torch.errors import NotYetImplementedError, OutOfSpecError
from strawboat_tpu_torch.benchsuite import tpch as port_tpch
from strawboat_tpu_torch.exec import Query, col, dense_group_sum, make_resident

TILE = 512
ROWS = 70_000


@pytest.fixture(scope="module", autouse=True)
def interp_pallas():
    """Every reference pallas_call of this module runs interpreted."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    from strawboat_tpu.kernels import bitunpack_pallas as m

    with mock.patch.object(pl, "pallas_call", patched):
        importlib.reload(m)
        yield
    importlib.reload(m)


@pytest.fixture(scope="module")
def lineitem():
    """(numpy columns, reference arrow table, port table, reference table)."""
    from strawboat_tpu.benchsuite.tpch import generate_lineitem
    from strawboat_tpu.exec.resident import make_resident as ref_make

    cols = {
        k: v for k, v in port_tpch.generate_lineitem(1.0, rows=ROWS).items()
        if k in port_tpch.Q1_Q6_COLUMNS
    }
    table = generate_lineitem(1.0, rows=ROWS).select(list(port_tpch.Q1_Q6_COLUMNS))
    return cols, table, make_resident(cols, "cpu", tile=TILE), ref_make(table, tile=TILE)


def _assert_q1_equal(got, want):
    assert list(got) == list(want)
    for key, aggs in want.items():
        for name, w in aggs.items():
            g = got[key][name]
            if name.startswith("avg_"):
                np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=f"{key} {name}")
            else:
                assert g == w, (key, name, g, w)


def test_q6_matches_jax_and_numpy(lineitem):
    from strawboat_tpu.benchsuite.tpch import q6_numpy_reference

    cols, table, rt, rt_ref = lineitem
    got = port_tpch.q6(rt)
    assert got.dtype == torch.int64 and got.dim() == 0
    want_jax = rt_ref.filter_sum(
        {"l_shipdate": (731, 1096), "l_discount": (5, 8), "l_quantity": (None, 24)},
        value="l_extendedprice",
        product_with="l_discount",
    )
    assert int(got) == int(want_jax) == q6_numpy_reference(table)
    assert port_tpch.q6_numpy_reference(cols) == q6_numpy_reference(table)
    # Q6 through the DSL's ungrouped fused shape gives the same revenue
    res = (
        Query(rt)
        .filter((col("l_shipdate") >= 731) & (col("l_shipdate") < 1096)
                & (col("l_discount") >= 5) & (col("l_discount") <= 7)
                & (col("l_quantity") < 24))
        .agg(rev=("sum", col("l_extendedprice") * col("l_discount")))
        .run()
    )
    assert int(res["rev"]) == int(got)


def test_fused_q1_and_q6_decode_in_one_k1_call(lineitem, monkeypatch):
    """Q1 through ``Query(rt)``'s fused branch and Q6 through ``filter_sum``
    each hand every plane they read to one K1 call, and equal the JAX
    package's answers and numpy's."""
    from strawboat_tpu.benchsuite.tpch import q1_numpy_reference, q6_numpy_reference
    from strawboat_tpu_torch.exec import resident as res_mod

    _cols, table, rt, rt_ref = lineitem
    calls = []
    orig = res_mod.bitunpack_tiled_many

    def counting(planes, seed=0):
        calls.append(len(planes))
        return orig(planes, seed)

    monkeypatch.setattr(res_mod, "bitunpack_tiled_many", counting)
    _assert_q1_equal(port_tpch.q1_rows(port_tpch.q1(rt)), q1_numpy_reference(table))
    assert calls == [7]  # the seven Q1/Q6 columns, one plane each
    calls.clear()
    want = rt_ref.filter_sum(
        {"l_shipdate": (731, 1096), "l_discount": (5, 8), "l_quantity": (None, 24)},
        value="l_extendedprice", product_with="l_discount")
    assert int(port_tpch.q6(rt)) == int(want) == q6_numpy_reference(table)
    assert calls == [4]


def test_q1_matches_jax_and_numpy(lineitem):
    from strawboat_tpu.benchsuite.tpch import q1_numpy_reference
    from strawboat_tpu.exec.expr import col as ref_col
    from strawboat_tpu.exec.query import Query as RefQuery

    cols, table, rt, rt_ref = lineitem
    res = port_tpch.q1(rt)
    got = port_tpch.q1_rows(res)
    _assert_q1_equal(got, q1_numpy_reference(table))
    _assert_q1_equal(got, port_tpch.q1_numpy_reference(cols))
    # the JAX Query over the JAX resident table, same aggregates
    disc_price = ref_col("l_extendedprice") * (100 - ref_col("l_discount"))
    ref_res = (
        RefQuery(rt_ref)
        .filter(ref_col("l_shipdate") <= port_tpch.EPOCH_DAYS - port_tpch.Q1_DEFAULT_DELTA)
        .group_by("l_returnflag", "l_linestatus", num_groups=16)
        .agg(
            sum_qty=("sum", "l_quantity"),
            sum_base_price=("sum", "l_extendedprice"),
            sum_disc_price=("sum", disc_price),
            sum_charge=("sum", disc_price * (100 + ref_col("l_tax"))),
            avg_qty=("avg", "l_quantity"),
            avg_price=("avg", "l_extendedprice"),
            avg_disc=("avg", "l_discount"),
            count_order=("count", "l_quantity"),
        )
        .order_by("key_l_returnflag", "key_l_linestatus")
        .run()
    )
    for k in ("n_groups", "keys", "key_l_returnflag", "key_l_linestatus", "taken_valid"):
        np.testing.assert_array_equal(res[k], ref_res[k], err_msg=k)
    for name in port_tpch.Q1_AGG_NAMES:
        assert res[name].dtype == np.asarray(ref_res[name]).dtype, name
        if name.startswith("avg_"):
            np.testing.assert_allclose(res[name], ref_res[name], rtol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(res[name], ref_res[name], err_msg=name)
    for k in ("l_returnflag", "l_linestatus"):
        assert list(res[f"dict_{k}"]) == ref_res[f"dict_{k}"].to_pylist()


def test_generator_and_references_match_reference():
    from strawboat_tpu.benchsuite import tpch as ref_tpch

    cols = port_tpch.generate_lineitem(1.0, rows=10_000)
    table = ref_tpch.generate_lineitem(1.0, rows=10_000)
    assert list(cols) == table.column_names
    for name in table.column_names:
        want = table.column(name).to_numpy(zero_copy_only=False)
        assert cols[name].dtype.kind == ("U" if want.dtype == object else want.dtype.kind)
        np.testing.assert_array_equal(cols[name], want, err_msg=name)
    assert port_tpch.q6_numpy_reference(cols) == ref_tpch.q6_numpy_reference(table)
    for delta in (90, 1200):
        _assert_q1_equal(
            port_tpch.q1_numpy_reference(cols, delta),
            ref_tpch.q1_numpy_reference(table, delta),
        )


def _small_table(seed=21, n=1000):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 5, n) * 111  # numeric dictionary key
    v = rng.integers(-500, 500, n)
    f = np.round(rng.normal(0, 100, n), 3)
    s = np.array(["x", "yy", "z"])[rng.integers(0, 3, n)]
    nulls = rng.random(n) < 0.2
    return pa.table({
        "g": pa.array(g),
        "v": pa.array(v),
        "f": pa.array(f),
        "s": pa.array(s),
        "nv": pa.array([None if m else int(x) for x, m in zip(v, nulls)], pa.int64()),
    })


def _both(t):
    from strawboat_tpu.exec.resident import make_resident as ref_make

    return make_resident(t, "cpu", tile=TILE), ref_make(t, tile=TILE)


def _run_both(rt, rt_ref, build):
    from strawboat_tpu.exec import expr as ref_expr
    from strawboat_tpu.exec.query import Query as RefQuery
    from strawboat_tpu_torch.exec import expr as port_expr

    return build(Query(rt), port_expr.col).run(), build(RefQuery(rt_ref), ref_expr.col).run()


def _assert_same_result(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("dict_"):
            assert list(got[k]) == w.to_pylist(), k
            continue
        w = np.asarray(w)
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        if w.dtype.kind == "u" and g.dtype.kind == "i" and g.dtype.itemsize == w.dtype.itemsize:
            g = g.view(w.dtype)  # the general path's u64 labels travel as int64
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_grouped_minmax_avg_order_limit_matches_jax():
    rt, rt_ref = _both(_small_table())
    got, want = _run_both(
        rt, rt_ref,
        lambda q, c: q.filter(c("v") > -400)
        .group_by("g", num_groups=16)
        .agg(mn=("min", "v"), mx=("max", "v"), s=("sum", "v"), a=("avg", "v"),
             fs=("sum", "f"), fa=("avg", "f"), fmn=("min", "f"), c=("count", "v"),
             ns=("sum", "nv"), nmx=("max", "nv"))
        .order_by(("s", "desc"))
        .limit(3),
    )
    _assert_same_result(got, want)


def test_string_predicates_and_keys_match_jax():
    rt, rt_ref = _both(_small_table(seed=3))
    for build in (
        lambda q, c: q.filter(c("s") == "yy").group_by("s").agg(n=("count", "v")),
        lambda q, c: q.filter(c("s") != "x").group_by("g", "s").agg(t=("sum", "v")),
        lambda q, c: q.filter(c("s").isin(["x", "z", "nope"])).group_by("s").agg(t=("sum", "v")),
        lambda q, c: q.filter((c("s") < "z") & (c("s") >= "x")).group_by("s").agg(t=("sum", "v")),
        lambda q, c: q.filter((c("s") > "x") | c("nv").is_null()).group_by("g").agg(
            t=("sum", "v"), m=("max", "f")),
        lambda q, c: q.filter(~(c("v") < 0)).group_by("s", "g").agg(
            t=("sum", c("v") * 3 - c("g")), u=("avg", c("f") / 2)).order_by("key_s", ("t", "desc")),
    ):
        _assert_same_result(*_run_both(rt, rt_ref, build))


def test_scalar_aggregates_and_empty_selection_match_jax():
    rt, rt_ref = _both(_small_table(seed=29))
    for build in (
        lambda q, c: q.filter(c("v") < 100).agg(s=("sum", "v"), n=("count", "v"), mx=("max", "f")),
        lambda q, c: q.filter(c("v") < -10_000).agg(
            s=("sum", "v"), n=("count", "v"), a=("avg", "v"), mn=("min", "v")),
    ):
        got, want = _run_both(rt, rt_ref, build)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(np.float64(got[k]), np.float64(want[k]), rtol=1e-12,
                                       equal_nan=True, err_msg=k)


def test_dense_group_sum_matches_reference():
    import jax.numpy as jnp

    from strawboat_tpu.exec.aggregate import dense_group_sum as ref_dgs

    rng = np.random.default_rng(4)
    n = 5000
    codes = rng.integers(-2, 9, n).astype(np.int32)  # negative and >= 7 drop
    vals = rng.integers(-(1 << 40), 1 << 40, n)
    mask = rng.random(n) < 0.7
    got = dense_group_sum(torch.from_numpy(codes), torch.from_numpy(vals), 7,
                          mask=torch.from_numpy(mask))
    want = ref_dgs(jnp.asarray(codes), jnp.asarray(vals), 7, mask=jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unported_query_shapes_raise():
    """What the port lacks raises ``NotYetImplementedError``.  Nested resident
    columns load now (``tests/test_torch_nested_resident.py``), and list
    columns stay out of ``as_device_table``.  The device-direct f64 encode runs now
    (``tests/test_torch_types.py``), and so do the shapes that raised before
    the general path (non-dictionary keys, joins, distinct, projections),
    matching the JAX package (``tests/test_torch_general.py``)."""
    from strawboat_tpu.exec.expr import col as ref_col
    from strawboat_tpu.exec.query import Query as RefQuery
    from strawboat_tpu.exec.resident import make_resident as ref_make

    rt, rt_ref = _both(_small_table(seed=5, n=600))
    # globs and lists of files run as datasets now
    # (``tests/test_torch_dataset.py``); a glob that matches nothing raises,
    # as in the JAX package
    with pytest.raises(OutOfSpecError, match="matched no files"):
        Query("lineitem_*.str", device="cpu").agg(s=("sum", "v")).run()
    nested = make_resident(pa.table({"l": pa.array([[1], [2, 3]])}), "cpu", tile=TILE)
    assert nested["l"].kind == "list" and nested.list_sum("l").tolist() == [1, 5]
    with pytest.raises(NotYetImplementedError, match="list column"):
        nested.as_device_table()
    f_dt = rt.as_device_table(["f"])[0]
    assert f_dt["f"].values.dtype == torch.float64
    assert make_resident(f_dt, "cpu", tile=TILE)["f"].kind == "f64"
    with pytest.raises(ValueError, match="median"):
        Query(rt).group_by("g").agg(s=("median", "v")).run()
    # 20000 distinct ints over an 18-bit span: plain planes, no dictionary
    k = np.arange(20_000) * 7
    plain = make_resident({"k": k}, "cpu", tile=TILE)
    plain_ref = ref_make(pa.table({"k": k}), tile=TILE)
    assert not plain["k"].is_dict
    got = Query(plain).group_by("k", num_groups=32768).agg(s=("sum", "k")).run()
    want = RefQuery(plain_ref).group_by("k", num_groups=32768).agg(s=("sum", "k")).run()
    _assert_same_result(got, want)
    got, mask = Query(rt).filter(col("v") > 0).run()
    want, wmask = RefQuery(rt_ref).filter(ref_col("v") > 0).run()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    for name in ("g", "v", "s"):
        np.testing.assert_array_equal(got[name].values.numpy(), np.asarray(want[name].values))
    _assert_same_result(Query(rt).distinct(num_groups=2048).run(),
                        RefQuery(rt_ref).distinct(num_groups=2048).run())
