"""The general query path of the torch port against the JAX package.

``sort_table`` / ``sort_indices``, ``hash_aggregate``, ``scalar_aggregate``,
``hash_join``, ``q3_like`` and ``Query`` over files, resident tables and
joins run on the CPU in the port and in the JAX package on the same seeded
numpy inputs (files written by the JAX writer with LZ4 pages, which the
port's scan reads).  Grouped results must agree slot for slot over the
whole capacity: the same ``n_groups``, label ``keys`` (the port's int64
bits viewed as uint64), ``rep_rows``, ``key_<col>`` and aggregates.
Integers are exact; float64 outputs to rtol 1e-9 and float32 outputs to
rtol 1e-5 (a float sum adds a group's rows in another order).  The port's u64 sort keys are the reference's keys
with the top bit flipped; the tests undo the flip before comparing bits.
"""

import importlib
from unittest import mock

import numpy as np
import pyarrow as pa
import pytest
import torch

import strawboat_tpu.kernels  # noqa: F401  (JAX x64 on)
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.exec import aggregate as ref_agg
from strawboat_tpu.exec import expr as ref_expr
from strawboat_tpu.exec import join as ref_join
from strawboat_tpu.exec import sort as ref_sort
from strawboat_tpu.exec.query import Query as RefQuery
from strawboat_tpu.exec.scan import scan_file as ref_scan
from strawboat_tpu_torch.benchsuite import tpch
from strawboat_tpu_torch.device import SIGN64
from strawboat_tpu_torch.errors import CapacityError, OutOfSpecError
from strawboat_tpu_torch.exec import (
    DeviceColumn,
    DeviceTable,
    Query,
    col,
    hash_aggregate,
    hash_join,
    make_resident,
    scalar_aggregate,
    scan_file,
    sort_table,
)
from strawboat_tpu_torch.exec import aggregate, sort
from strawboat_tpu_torch.exec.scan import _torch_view, host_values

RTOL = {np.dtype(np.float64): 1e-9, np.dtype(np.float32): 1e-5}
TILE = 512


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


def _opts(page=2048, **kw):
    return RefOptions(default_compression=RefCompression.LZ4, default_compress_ratio=1.0,
                      max_page_size=page, sample_seed=7, **kw)


def _write(path, cols, **kw):
    """numpy columns (``np.ma.MaskedArray`` for nulls) → a file of LZ4
    pages written by the JAX writer."""
    arrays = {}
    for k, v in cols.items():
        if isinstance(v, np.ma.MaskedArray):
            arrays[k] = pa.array(np.ma.getdata(v), mask=np.ma.getmaskarray(v))
        else:
            arrays[k] = pa.array(v)
    ref_write(str(path), pa.table(arrays), options=_opts(**kw))
    return str(path)


def _pair(cols):
    """(port DeviceTable, JAX DeviceTable) over the same numpy columns."""
    import jax.numpy as jnp

    from strawboat_tpu.exec.scan import DeviceColumn as RefColumn
    from strawboat_tpu.exec.scan import DeviceTable as RefTable

    port, ref = {}, {}
    for name, v in cols.items():
        valid = None
        if isinstance(v, np.ma.MaskedArray):
            valid, v = ~np.ma.getmaskarray(v), np.ma.getdata(v)
        port[name] = DeviceColumn(
            name, "bool" if v.dtype == bool else str(v.dtype), torch.from_numpy(_torch_view(v)),
            None if valid is None else torch.from_numpy(valid),
        )
        ref[name] = RefColumn(name, pa.from_numpy_dtype(v.dtype), jnp.asarray(v),
                              None if valid is None else jnp.asarray(valid))
    n = len(next(iter(cols.values())))
    return DeviceTable(port, n), RefTable(ref, n)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_arr(got, want, name=""):
    g, w = _host(got), np.asarray(want)
    if w.dtype.kind == "u" and g.dtype.kind == "i" and g.dtype.itemsize == w.dtype.itemsize:
        g = g.view(w.dtype)  # the port's signed view of unsigned bits
    assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=RTOL[w.dtype], equal_nan=True, err_msg=name)
    else:
        np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("dict_"):
            w = w.to_pylist() if hasattr(w, "to_pylist") else list(w)
            assert [str(x) for x in got[k]] == [str(x) for x in w], k
        else:
            _assert_arr(got[k], w, k)


def _assert_tables(got, want, names=None):
    """A port DeviceTable (+ its mask) equals a JAX one, column by column."""
    (gt, gm), (wt, wm) = got, want
    assert (gm is None) == (wm is None)
    if gm is not None:
        _assert_arr(gm, wm, "mask")
    for k in names or wt.columns:
        _assert_arr(gt[k].values, wt[k].values, k)


def _unflip(key: torch.Tensor) -> np.ndarray:
    """The port's sort key → the reference's u64 key bits."""
    return (key ^ SIGN64).numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# sort (tests/test_sort.py)


def _orderable_inputs():
    rng = np.random.default_rng(0)
    ints = rng.integers(-(10**12), 10**12, 500).astype(np.int64)
    floats = np.concatenate([rng.normal(0, 1e6, 500), [0.0, -0.0, np.inf, -np.inf, np.nan]])
    return {
        "int64": ints,
        "float64": floats,
        "int32": ints.astype(np.int32),
        "float32": floats.astype(np.float32),
        "uint32": rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32),
        "bool": rng.random(500) < 0.5,
    }


@pytest.mark.parametrize("kind", list(_orderable_inputs()))
def test_orderable_u64_matches_jax(kind):
    import jax.numpy as jnp

    arr = _orderable_inputs()[kind]
    t = torch.from_numpy(_torch_view(arr))
    for desc in (False, True):
        key = sort.orderable_u64(t, desc, unsigned=kind == "uint32")
        want = np.asarray(ref_sort.orderable_u64(jnp.asarray(arr), descending=desc))
        np.testing.assert_array_equal(_unflip(key), want)
        order = np.argsort(key.numpy(), kind="stable")
        if kind.startswith("float"):
            arr_ = np.nan_to_num(arr, nan=np.inf)  # NaN sorts above +inf
            assert (np.diff(arr_[order]) <= 0).all() if desc else (np.diff(arr_[order]) >= 0).all()
        else:
            want_order = np.argsort(-arr.astype(np.int64) if desc else arr, kind="stable")
            np.testing.assert_array_equal(arr[order], arr[want_order])


def test_sort_indices_multicol_and_mask_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    a = rng.integers(0, 5, 1000).astype(np.int64)
    b = rng.normal(0, 1, 1000)
    mask = rng.random(1000) > 0.3
    got = sort.sort_indices((torch.from_numpy(a), torch.from_numpy(b)), (False, True),
                            torch.from_numpy(mask))
    want = ref_sort.sort_indices((jnp.asarray(a), jnp.asarray(b)), (False, True), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n_valid = mask.sum()
    exp = np.lexsort((-b[mask], a[mask]))
    np.testing.assert_array_equal(b[got.numpy()[:n_valid]], b[mask][exp])


@pytest.mark.parametrize("desc", [False, True])
def test_topk_tie_order_matches_jax(desc):
    """The single-column LIMIT branch: the reference's ``top_k`` puts the
    lower index first among equal keys; l_extendedprice-like ties."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    v = rng.integers(0, 40, 4096).astype(np.int64) * 1000  # ~100 rows per value
    for limit in (1, 10, 150, 5000):
        got = sort.sort_indices((torch.from_numpy(v),), (desc,), None, limit).numpy()
        want = np.asarray(ref_sort.sort_indices((jnp.asarray(v),), (desc,), None, limit))
        np.testing.assert_array_equal(got, want)
        flipped = np.asarray(ref_sort.orderable_u64(jnp.asarray(v), descending=desc))
        np.testing.assert_array_equal(got, np.argsort(flipped, kind="stable")[:limit])


def test_sort_table_and_take_table_match_jax():
    rng = np.random.default_rng(4)
    n = 700
    cols = {
        "g": rng.integers(0, 4, n).astype(np.int32),
        "x": np.ma.MaskedArray(rng.integers(-50, 50, n), mask=rng.random(n) < 0.2),
        "u": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32),
    }
    pt, rt = _pair(cols)
    for by, lim in (([("g", "desc"), "x"], None), (["u"], 40), ([("x", "desc")], None)):
        m = torch.from_numpy(cols["g"] != 2)
        idx, tv = sort_table(pt, by, m, lim)
        ridx, rtv = ref_sort.sort_table(rt, by, np.asarray(m), lim)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        _assert_arr(tv, rtv, "taken_valid")
        got = sort.take_table(pt, idx)
        want = ref_sort.take_table(rt, ridx)
        for k in cols:
            _assert_arr(got[k].values, want[k].values, k)
            _assert_arr(got[k].validity if got[k].validity is not None else np.ones(len(idx), bool),
                        want[k].validity if want[k].validity is not None else np.ones(len(idx), bool), k)


@pytest.fixture(scope="module")
def sort_file(tmp_path_factory):
    """tests/test_sort.py's file, integer columns only (``f`` becomes an
    int64 column: the port scans integer columns)."""
    rng = np.random.default_rng(11)
    n = 5000
    cols = {
        "i": rng.integers(-(10**9), 10**9, n).astype(np.int64),
        "u": rng.integers(0, 1 << 20, n).astype(np.uint32),
        "f": rng.integers(-(10**4), 10**4, n).astype(np.int64),
        "g": rng.integers(0, 7, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    }
    return _write(tmp_path_factory.mktemp("sort") / "s.str", cols), cols


def _both_queries(path, build):
    return build(Query(path, device="cpu"), col).run(), build(RefQuery(path), ref_expr.col).run()


@pytest.mark.parametrize("case", ["order_by_limit", "select_no_leak", "limit_only_filter"])
def test_query_projection_shapes_match_jax(sort_file, case):
    path, cols = sort_file
    build = {
        "order_by_limit": lambda q, c: q.select("i", "f").filter(c("f") > 0)
        .order_by(("i", "desc")).limit(25),
        "select_no_leak": lambda q, c: q.select("i").order_by("f").limit(10),
        "limit_only_filter": lambda q, c: q.select("u").filter(c("u") < 1000).limit(5),
    }[case]
    (got, gv), (want, wv) = _both_queries(path, build)
    assert set(got.columns) == set(want.columns)
    _assert_tables((got, gv), (want, wv))
    if case == "order_by_limit":
        sel = cols["f"] > 0
        np.testing.assert_array_equal(got["i"].values.numpy(), np.sort(cols["i"][sel])[::-1][:25])
    if case == "limit_only_filter":
        assert gv is None
        np.testing.assert_array_equal(host_values(got["u"]), cols["u"][cols["u"] < 1000][:5])


def test_query_grouped_avg_ordered_matches_jax(sort_file):
    path, cols = sort_file
    got, want = _both_queries(
        path,
        lambda q, c: q.group_by("g", num_groups=64).agg(mean_v=("avg", "v"), total=("sum", "v"))
        .order_by(("total", "desc")).limit(3),
    )
    _assert_same(got, want)
    g, v = cols["g"], cols["v"]
    top = sorted(((v[g == k].sum(), k) for k in np.unique(g)), reverse=True)[:3]
    assert got["key_g"].tolist() == [k for _s, k in top]


def test_query_distinct_and_pushdown_match_jax(sort_file):
    path, cols = sort_file
    got, want = _both_queries(path, lambda q, c: q.select("g").distinct(num_groups=64))
    _assert_same(got, want)
    n = int(got["n_groups"])
    np.testing.assert_array_equal(np.sort(got["key_g"][:n].numpy()), np.unique(cols["g"]))
    q = Query(path, device="cpu").filter(col("v") > 10).group_by("g", num_groups=128).agg(
        total=("sum", "f"))
    assert set(q.scan().columns) == {"g", "f", "v"}
    rq = RefQuery(path).filter(ref_expr.col("v") > 10).group_by("g", num_groups=128).agg(
        total=("sum", "f"))
    _assert_same(q.run(), rq.run())


def test_query_over_a_file_runs_on_cuda_by_default(sort_file):
    path, _cols = sort_file
    q = Query(path).group_by("g").agg(n=("count", "v"))
    if torch.cuda.is_available():
        assert q.run()["keys"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            q.run()
    # a glob and a list of files run as datasets, as in the JAX package
    for p in (path.replace("s.str", "*.str"), [path, path]):
        got = Query(p, device="cpu").agg(n=("count", "v")).run()
        assert int(got["n"]) == int(RefQuery(p).agg(n=("count", "v")).run()["n"])


def test_order_by_string_is_lexical_over_resident_tables():
    """Resident string dictionaries are sorted; ORDER BY a string column and
    ORDER BY key_s of a grouped result are byte order in both packages."""
    from strawboat_tpu.exec.resident import make_resident as ref_make

    rng = np.random.default_rng(13)
    words = ["zeta", "alpha", "mike", "bravo", "yank", "charlie"]
    vals = [words[i] for i in rng.integers(0, len(words), 800)]
    t = pa.table({"s": pa.array(vals, pa.string()), "x": pa.array(np.arange(800, dtype=np.int64))})
    rt, rt_ref = make_resident(t, "cpu", tile=TILE), ref_make(t, tile=TILE)
    (got, gv) = Query(rt).select("s", "x").order_by("s").run()
    (want, wv) = RefQuery(rt_ref).select("s", "x").order_by("s").run()
    _assert_tables((got, gv), (want, wv))
    assert list(got["s"].dictionary[got["s"].values.numpy()]) == sorted(vals)
    # a grouped query over a non-dictionary key takes the general path
    g_got = Query(rt).group_by("s", "x", num_groups=1024).agg(n=("count", "x")).order_by("key_s").run()
    g_want = RefQuery(rt_ref).group_by("s", "x", num_groups=1024).agg(n=("count", "x")).order_by(
        "key_s").run()
    _assert_same(g_got, g_want)


# ---------------------------------------------------------------------------
# aggregate (tests/test_exec.py)


@pytest.fixture(scope="module")
def scan_pair(tmp_path_factory):
    """tests/test_exec.py's scan_table, integer columns, plus negative,
    unsigned and wide keys: (numpy columns, port scan, JAX scan)."""
    rng = np.random.default_rng(3)
    n = 6000
    null = rng.random(n) > 0.7
    cols = {
        "onevalue": np.full(n, 42, dtype=np.int64),
        "lowcard": (rng.integers(0, 6, n) * 1000).astype(np.int64),
        "runs": np.repeat(rng.integers(0, 50, n // 100), 100).astype(np.int64),
        "bp": rng.integers(0, 1 << 14, n, dtype=np.int32),
        "sorted": np.sort(rng.integers(0, 1 << 20, n).astype(np.uint32)),
        "freq": np.where(rng.random(n) < 0.95, 10**6, rng.integers(0, 10**9, n)).astype(np.int64),
        "nullable": np.ma.MaskedArray(rng.integers(0, 100, n), mask=null),
        "neg": rng.integers(-40, 40, n).astype(np.int64) * (1 << 40),
        "u32": (rng.integers(0, 12, n).astype(np.uint32) * np.uint32(400_000_000)),
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "big": rng.integers(-(2**62), 2**62, n).astype(np.int64),
        "u64": rng.integers(0, 2**64 - 1, n, dtype=np.uint64),
    }
    path = _write(tmp_path_factory.mktemp("agg") / "scan.str", cols)
    return cols, scan_file(path, "cpu"), ref_scan(path), path


def test_scan_of_the_jax_file_matches(scan_pair):
    cols, pt, rt, _path = scan_pair
    for k in cols:
        _assert_arr(pt[k].values, rt[k].values, k)


def test_grouped_aggregate_matches_jax(scan_pair):
    cols, pt, rt, _path = scan_pair
    aggs = {"total": ("sum", "freq"), "cnt": ("count", "freq")}
    got = hash_aggregate(pt, keys=["lowcard"], aggs=aggs, num_groups=64)
    want = ref_agg.hash_aggregate(rt, keys=["lowcard"], aggs=aggs, num_groups=64)
    _assert_same(got, want)
    assert int(got["n_groups"]) == 6
    n = 6
    exp = {int(k): (int(cols["freq"][cols["lowcard"] == k].sum()),
                    int((cols["lowcard"] == k).sum())) for k in np.unique(cols["lowcard"])}
    assert {int(k): (int(t), int(c)) for k, t, c in zip(
        got["key_lowcard"][:n], got["total"][:n], got["cnt"][:n])} == exp


def test_hash_aggregate_key_columns_matches_jax(scan_pair):
    _cols, pt, rt, _path = scan_pair
    got = hash_aggregate(pt, keys=["lowcard"], aggs={"total": ("sum", "freq")}, num_groups=64)
    want = ref_agg.hash_aggregate(rt, keys=["lowcard"], aggs={"total": ("sum", "freq")},
                                  num_groups=64)
    _assert_same(got, want)
    n = int(got["n_groups"])
    np.testing.assert_array_equal(np.sort(got["key_lowcard"][:n].numpy().astype(np.uint64)),
                                  np.sort(got["keys"][:n].numpy().view(np.uint64)))


_GROUP_CASES = {
    # negative int64 keys: their u64 images follow every positive key
    "negative_keys": (["neg"], 16, True),
    # unsigned keys at and above 2^31
    "unsigned_keys": (["u32"], 16, False),
    "composite_masked": (["lowcard", "runs"], 512, True),
    "nullable_key": (["nullable"], 128, True),
    "int8_and_onevalue": (["i8", "onevalue"], 64, False),
}


@pytest.mark.parametrize("case", list(_GROUP_CASES))
def test_group_keys_and_aggregates_match_jax(scan_pair, case):
    """Every aggregate over every value kind (int8/int32/int64, nullable,
    unsigned, wider than float64's exact integers), slot for slot over the
    whole capacity."""
    import jax.numpy as jnp

    cols, pt, rt, _path = scan_pair
    keys, cap, masked = _GROUP_CASES[case]
    aggs = {
        "s_bp": ("sum", "bp"), "mn_bp": ("min", "bp"), "mx_i8": ("max", "i8"),
        "mn_u": ("min", "sorted"), "mx_u": ("max", "u32"), "s_u": ("sum", "u32"),
        "a_freq": ("avg", "freq"), "c": ("count", "runs"), "mx_neg": ("max", "neg"),
        "s_expr": ("sum", col("bp") * 3 - col("runs")),
        # beyond float64's exact integers: the scatter fallback
        "mn_big": ("min", "big"), "mx_u64": ("max", "u64"), "s_u64": ("sum", "u64"),
    }
    ref_aggs = {**aggs, "s_expr": ("sum", ref_expr.col("bp") * 3 - ref_expr.col("runs"))}
    m = np.random.default_rng(5).random(len(cols["bp"])) < 0.8 if masked else None
    got = hash_aggregate(pt, keys=keys, aggs=aggs, num_groups=cap,
                         mask=None if m is None else torch.from_numpy(m))
    want = ref_agg.hash_aggregate(rt, keys=keys, aggs=ref_aggs, num_groups=cap,
                                  mask=None if m is None else jnp.asarray(m))
    _assert_same(got, want)


def test_composite_label_at_and_above_2_63_fills_capacity():
    """Masked rows write label 0 into the last slot, which the last real
    group holds when the groups exactly fill the capacity: the label max
    must be unsigned, and masked min/max values neutral there."""
    import jax.numpy as jnp

    G = 8
    a_vals = np.arange(1, G + 1, dtype=np.int64) * 7
    mix = np.uint64(0x9E3779B97F4A7C15)
    for b_last in range(1, 10_000):  # the last group's label ≥ 2^63
        with np.errstate(over="ignore"):
            label = np.uint64(a_vals[-1]) * mix + np.uint64(b_last) + np.uint64(0x85EBCA6B)
        if label >= np.uint64(1 << 63):
            break
    rng = np.random.default_rng(6)
    n = 400
    ai = rng.integers(0, G, n)
    a = a_vals[ai]
    b = np.where(ai == G - 1, b_last, 5).astype(np.int64)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    m = rng.random(n) < 0.7
    m[ai == G - 1] = True
    # masked rows with keys outside every group sort into the last slot too
    a[~m] = 0
    v[~m] = 10**6
    pt, rt = _pair({"a": a, "b": b, "v": v})
    aggs = {"mn": ("min", "v"), "mx": ("max", "v"), "s": ("sum", "v"), "c": ("count", "v")}
    got = hash_aggregate(pt, ["a", "b"], aggs, num_groups=G, mask=torch.from_numpy(m))
    want = ref_agg.hash_aggregate(rt, ["a", "b"], aggs, num_groups=G, mask=jnp.asarray(m))
    _assert_same(got, want)
    assert int(got["n_groups"]) == G
    assert got["keys"].numpy().view(np.uint64)[-1] == label
    last = m & (ai == G - 1)
    assert int(got["mx"][-1]) == int(v[last].max()) and int(got["mn"][-1]) == int(v[last].min())


def test_capacity_grows_or_raises_as_jax():
    import jax.numpy as jnp  # noqa: F401

    from strawboat_tpu.errors import CapacityError as RefCapacityError

    k = np.random.default_rng(7).integers(0, 10, 300).astype(np.int64)
    pt, rt = _pair({"k": k, "v": k * 2})
    aggs = {"s": ("sum", "v")}
    got = hash_aggregate(pt, ["k"], aggs, num_groups=4)
    want = ref_agg.hash_aggregate(rt, ["k"], aggs, num_groups=4)
    _assert_same(got, want)
    assert got["keys"].shape[0] == 16
    with pytest.raises(CapacityError) as e:
        hash_aggregate(pt, ["k"], aggs, num_groups=4, on_overflow="raise")
    with pytest.raises(RefCapacityError) as re_:
        ref_agg.hash_aggregate(rt, ["k"], aggs, num_groups=4, on_overflow="raise")
    assert (e.value.capacity, e.value.required) == (re_.value.capacity, re_.value.required) == (4, 10)


def test_float_keys_and_values_match_jax():
    rng = np.random.default_rng(8)
    n = 2000
    f = np.round(rng.normal(0, 3, n), 1)
    f[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    pt, rt = _pair({"f": f, "f32": f.astype(np.float32), "x": rng.normal(0, 100, n)})
    aggs = {"s": ("sum", "x"), "mn": ("min", "x"), "a": ("avg", "f32"), "mx": ("max", "f32")}
    for keys in (["f"], ["f32"]):
        got = hash_aggregate(pt, keys, aggs, num_groups=256)
        want = ref_agg.hash_aggregate(rt, keys, aggs, num_groups=256)
        _assert_same(got, want)


@pytest.mark.parametrize("fn", ["sum", "min", "max", "count", "avg"])
def test_scalar_aggregate_matches_jax(fn):
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    m = rng.random(1000) < 0.6
    for v in (rng.integers(-500, 500, 1000).astype(np.int32), rng.integers(0, 1 << 40, 1000),
              rng.normal(0, 10, 1000), rng.normal(0, 10, 1000).astype(np.float32)):
        for mask in (None, m):
            got = scalar_aggregate(torch.from_numpy(v), None if mask is None else torch.from_numpy(mask), fn)
            want = ref_agg.scalar_aggregate(jnp.asarray(v), None if mask is None else jnp.asarray(mask), fn)
            assert got.dim() == 0
            _assert_arr(got, want, f"{fn} {v.dtype} {mask is None}")


# ---------------------------------------------------------------------------
# join (tests/test_exec.py)


def _join_same(got, want):
    for g, w, name in zip(got, want, ("probe_idx", "build_idx", "valid")):
        _assert_arr(g, w, name)


def _valid_pairs(sel) -> list:
    pi, bi, valid = (np.asarray(x) for x in sel)
    return list(zip(pi[valid].tolist(), bi[valid].tolist()))


def _join_pairs_same(got, want):
    """The same valid (probe, build) pairs in the same order.  Where the
    build side has invalid rows the port leaves them out of the sort (the
    reference sorts them in), so the slots and the fan-out may differ;
    each probe row's matches keep the reference's order."""
    assert _valid_pairs(got) == _valid_pairs(want)


def _assert_same_groups(got: dict, want: dict):
    """A grouped result equals the reference's in its ``n_groups`` valid
    slots; the unused slots hold what the join's invalid slots carried."""
    assert set(got) == set(want)
    n = int(want["n_groups"])
    assert int(got["n_groups"]) == n
    for k, w in want.items():
        if k != "n_groups":
            _assert_arr(got[k][:n], np.asarray(w)[:n], k)


def test_hash_join_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    n, m = 4000, 64
    fact = {"k": rng.integers(0, m, n).astype(np.int64), "v": rng.integers(0, 1000, n).astype(np.int64)}
    dim = {"id": np.arange(m, dtype=np.int64), "w": rng.integers(0, 10, m).astype(np.int64)}
    fp, dp = _write(tmp_path / "f.str", fact), _write(tmp_path / "d.str", dim)
    ft, dt = scan_file(fp, "cpu"), scan_file(dp, "cpu")
    got = hash_join(ft, dt, on=("k", "id"), max_fanout=1)
    _join_same(got, ref_join.hash_join(ref_scan(fp), ref_scan(dp), on=("k", "id"), max_fanout=1))
    pi, bi, valid = got
    total = int(scalar_aggregate(ft["v"].values[pi] * dt["w"].values[bi], valid, "sum"))
    assert total == int((fact["v"] * dim["w"][fact["k"]]).sum())


def test_hash_join_duplicate_build_keys_matches_jax(tmp_path):
    from strawboat_tpu.errors import CapacityError as RefCapacityError

    rng = np.random.default_rng(13)
    n, m = 2000, 300
    probe = {"k": rng.integers(0, 50, n).astype(np.int64)}
    build_keys = rng.integers(0, 50, m).astype(np.int64)  # duplicates
    build = {"k": build_keys, "w": rng.integers(1, 5, m).astype(np.int64)}
    pp, bp = _write(tmp_path / "p.str", probe), _write(tmp_path / "b.str", build)
    pt, bt, rpt, rbt = scan_file(pp, "cpu"), scan_file(bp, "cpu"), ref_scan(pp), ref_scan(bp)
    fan = int(np.bincount(build_keys).max())
    for f in (fan, 1):  # 1 grows to the next power of two
        got = hash_join(pt, bt, on=("k", "k"), max_fanout=f)
        _join_same(got, ref_join.hash_join(rpt, rbt, on=("k", "k"), max_fanout=f))
        pi, bi, valid = got
        total = int(scalar_aggregate(bt["w"].values[bi], valid, "sum"))
        assert total == sum(int(build["w"][build_keys == k].sum()) for k in probe["k"])
    with pytest.raises(CapacityError) as e:
        hash_join(pt, bt, on=("k", "k"), max_fanout=1, on_overflow="raise")
    with pytest.raises(RefCapacityError) as re_:
        ref_join.hash_join(rpt, rbt, on=("k", "k"), max_fanout=1, on_overflow="raise")
    assert (e.value.capacity, e.value.required) == (re_.value.capacity, re_.value.required)


def test_int32_probe_against_int64_build_and_null_build_keys():
    """Key dtypes promote before the search (unsigned views by value); null
    build keys and masked probe rows never match."""
    import jax.numpy as jnp

    rng = np.random.default_rng(10)
    probe = rng.integers(-20, 300, 1500).astype(np.int32)
    bkeys = np.concatenate([rng.permutation(200), [1 << 40]]).astype(np.int64)
    null = rng.random(len(bkeys)) < 0.25
    pt, rpt = _pair({"k": probe})
    bt, rbt = _pair({"id": np.ma.MaskedArray(bkeys, mask=null)})
    pm = rng.random(len(probe)) < 0.9
    got = hash_join(pt, bt, on=("k", "id"), probe_mask=torch.from_numpy(pm))
    want = ref_join.hash_join(rpt, rbt, on=("k", "id"), probe_mask=jnp.asarray(pm))
    _join_pairs_same(got, want)
    pi, bi, valid = (x.numpy() for x in got)
    assert len(valid) == len(probe)  # the null keys no longer widen the fan-out
    exp = pm & np.isin(probe, bkeys[~null])
    np.testing.assert_array_equal(valid, exp)
    assert (probe[pi[valid]] == bkeys[bi[valid]]).all()
    # uint32 probe keys at and above 2^31 (the port's int32 view) match by value
    up = (rng.integers(0, 300, 1500) + (1 << 31)).astype(np.uint32)
    ub = (rng.permutation(300) + (1 << 31)).astype(np.int64)
    (pt, rpt), (bt, rbt) = _pair({"k": up}), _pair({"id": ub})
    got = hash_join(pt, bt, on=("k", "id"))
    _join_same(got, ref_join.hash_join(rpt, rbt, on=("k", "id")))
    assert bool(got[2].all())


def test_resident_build_side_padding_never_matches():
    """Probe and build are resident tables (tiled, padded): padding slots
    decode to one value (0 here), and must match nothing on either side.
    They also form one run of equal build keys, so the fan-out grows to
    the padding count, in the reference too: the build side fills its
    tiles nearly, to keep that run short."""
    from strawboat_tpu.exec.resident import make_resident as ref_make

    rng = np.random.default_rng(12)
    n, m = 1500, 16000
    probe = {"pk": rng.integers(0, m + 100, n).astype(np.int64),
             "v": rng.integers(0, 100, n).astype(np.int64)}
    build = {"bk": rng.permutation(m).astype(np.int64),
             "w": rng.integers(1, 9, m).astype(np.int64)}
    prt, brt = make_resident(probe, "cpu", tile=TILE), make_resident(build, "cpu", tile=TILE)
    ref_prt, ref_brt = ref_make(pa.table(probe), tile=TILE), ref_make(pa.table(build), tile=TILE)
    assert brt.tiled_slots > m and prt.tiled_slots > n
    aggs = {"rev": ("sum", col("v") * col("w")), "c": ("count", "v")}
    ref_aggs = {"rev": ("sum", ref_expr.col("v") * ref_expr.col("w")), "c": ("count", "v")}
    got = Query(prt).join(Query(brt), on=("pk", "bk")).group_by("w", num_groups=16).agg(**aggs).run()
    want = RefQuery(ref_prt).join(RefQuery(ref_brt), on=("pk", "bk")).group_by(
        "w", num_groups=16).agg(**ref_aggs).run()
    _assert_same(got, want)
    pos = np.full(m, -1)
    pos[build["bk"]] = np.arange(m)
    hit = probe["pk"] < m
    w = build["w"][pos[probe["pk"][hit]]]
    assert int(got["c"].sum()) == int(hit.sum())
    assert int(got["rev"].sum()) == int((probe["v"][hit] * w).sum())


def test_small_resident_build_side_joins_at_fan_out_one():
    """A 300-row resident build side in one tile (``tile=16384``: 32 rows
    of 16384 lanes), probed with keys that include the value its padding
    slots decode to: only
    the valid build rows enter the join's sort, so ``hash_join`` runs at
    fan-out 1 (the reference grows it to the padding count), and the
    joined aggregates equal numpy's."""
    from strawboat_tpu_torch.exec.query import _with_key_validity

    rng = np.random.default_rng(31)
    m, n = 300, 2000
    build = {"bk": rng.permutation(m).astype(np.int64) + 5,
             "w": rng.integers(1, 9, m).astype(np.int64)}
    brt = make_resident(build, "cpu", tile=16384)
    assert brt.tiled_slots == 32 * 16384  # one tile
    bq = Query(brt)
    bt = bq.scan(device="cpu")
    pad = np.unique(bt["bk"].values.numpy()[~bq._base_mask.numpy()])
    assert len(pad) == 1
    probe = {"pk": np.concatenate([np.full(n // 4, pad[0]),
                                   rng.integers(0, m + 50, n - n // 4)]).astype(np.int64),
             "v": rng.integers(0, 100, n).astype(np.int64)}
    pt = Query(make_resident(probe, "cpu", tile=TILE)).scan(device="cpu")
    keyed = _with_key_validity(bt, "bk", bq._base_mask)
    pi, bi, valid = hash_join(pt, keyed, on=("pk", "bk"), max_fanout=1, on_overflow="raise")
    assert len(valid) == pt.num_rows  # fan-out 1
    pos = np.full(m + 60, -1)
    pos[build["bk"]] = np.arange(m)
    hit = pos[probe["pk"]] >= 0
    pairs = sorted((int(a), int(b)) for a, b in zip(
        pt["pk"].values.numpy()[pi[valid].numpy()], bt["bk"].values.numpy()[bi[valid].numpy()]))
    assert pairs == sorted((int(k), int(k)) for k in probe["pk"][hit])
    got = Query(make_resident(probe, "cpu", tile=TILE)).join(Query(brt), on=("pk", "bk")).agg(
        rev=("sum", col("v") * col("w")), c=("count", "v")).run()
    assert int(got["c"]) == int(hit.sum())
    assert int(got["rev"]) == int((probe["v"][hit] * build["w"][pos[probe["pk"][hit]]]).sum())


# ---------------------------------------------------------------------------
# Query over files and joins (tests/test_exec.py, tests/test_tpch.py)


def _q_api_cols():
    rng = np.random.default_rng(21)
    n = 8192
    return {
        "k": rng.integers(0, 5, n).astype(np.int64),
        "v": rng.integers(0, 1000, n).astype(np.int64),
        "d": np.sort(rng.integers(0, 1000, n)).astype(np.int64),
    }


def test_query_api_matches_jax(tmp_path):
    cols = _q_api_cols()
    path = _write(tmp_path / "q.str", cols)

    def grouped(q, c):
        return q.filter((c("d") >= 300) & (c("d") < 600)).group_by("k", num_groups=32).agg(
            total=("sum", "v"), cnt=("count", "v"))

    got, want = _both_queries(path, grouped)
    _assert_same(got, want)
    k, v, d = cols["k"], cols["v"], cols["d"]
    sel = (d >= 300) & (d < 600)
    n = int(got["n_groups"])
    assert {int(a): (int(b), int(c)) for a, b, c in zip(got["keys"][:n], got["total"][:n],
                                                         got["cnt"][:n])} == {
        int(kk): (int(v[sel & (k == kk)].sum()), int((sel & (k == kk)).sum())) for kk in np.unique(k[sel])}
    got, want = _both_queries(path, lambda q, c: q.filter((c("d") >= 300) & (c("d") < 600)).agg(
        s=("sum", "v"), a=("avg", "v"), mn=("min", "d")))
    assert set(got) == set(want)
    for name in want:
        _assert_arr(got[name], want[name], name)
    assert int(got["s"]) == int(v[sel].sum())


def test_file_with_zone_block_raises_under_a_filter(tmp_path):
    """A file with zone maps under a filter: the port prunes pages as the
    reference does (it used to raise here) and answers alike; a predicate
    it cannot use raises rather than scan unpruned.  Without a filter, or
    on a file without a zone block, it scans whole with the reference's
    answers."""
    from strawboat_tpu_torch.exec.pruning import Comparison, read_zones

    cols = _q_api_cols()
    zpath = _write(tmp_path / "z.str", cols, zone_maps=True)
    plain = _write(tmp_path / "p.str", cols)
    assert read_zones(zpath) is not None and read_zones(plain) is None
    got, want = _both_queries(zpath, lambda q, c: q.filter(c("d") < 600).agg(s=("sum", "v")))
    assert set(got) == set(want) and int(got["s"]) == int(want["s"])
    pruned = scan_file(zpath, "cpu", predicates=[Comparison("d", "lt", 600)])
    assert pruned.num_rows < len(cols["d"])
    with pytest.raises(TypeError):
        scan_file(zpath, "cpu", predicates=["d < 600"])
    got, want = _both_queries(zpath, lambda q, c: q.group_by("k", num_groups=8).agg(s=("sum", "v")))
    _assert_same(got, want)
    # predicates on a file without zone maps prune nothing, as in the reference
    t = scan_file(plain, "cpu", predicates=[Comparison("d", "lt", 600)])
    np.testing.assert_array_equal(t["d"].values.numpy(), cols["d"])


def _q3_files(tmp_path, scale=0.001, li_rows=None, o_rows=None):
    """lineitem and orders (integer columns) as LZ4 files of the JAX writer."""
    li = tpch.generate_lineitem(scale, rows=li_rows)
    li = {k: li[k] for k in tpch.INT_COLUMNS}
    orders = tpch.generate_orders(scale, rows=o_rows)
    lp = _write(tmp_path / "li.str", li, page=1024)
    op = _write(tmp_path / "o.str", orders, page=1024)
    return li, orders, lp, op


def test_query_join_group_by_matches_jax(tmp_path):
    """Q3-shaped query through the Query API: lineitem ⋈ orders, build-side
    date filter, revenue by order priority — vs JAX and numpy."""
    li, orders, lp, op = _q3_files(tmp_path)
    got = tpch.q3_query(lp, op, "cpu")
    want = (
        RefQuery(lp)
        .join(RefQuery(op).filter(ref_expr.col("o_orderdate") < 1000), on=("l_orderkey", "o_orderkey"))
        .group_by("o_orderpriority", num_groups=64)
        .agg(revenue=("sum", ref_expr.col("l_extendedprice") * (100 - ref_expr.col("l_discount"))))
        .run()
    )
    _assert_same_groups(got, want)
    ref = tpch.q3_numpy_reference(li, orders)
    assert tpch.q3_rows(got["key_o_orderpriority"], got["n_groups"], got["revenue"]) == ref
    from strawboat_tpu.benchsuite import tpch as ref_tpch

    assert ref_tpch.generate_orders(0.001).column("o_orderdate").to_numpy().tolist() == \
        orders["o_orderdate"].tolist()


def test_query_join_name_conflict_raises(tmp_path):
    p1 = _write(tmp_path / "a.str", {"k": np.array([1, 2, 3], dtype=np.int64)})
    p2 = _write(tmp_path / "b.str", {"k": np.array([1, 2, 3], dtype=np.int64)})
    with pytest.raises(OutOfSpecError):
        Query(p1, device="cpu").join(p2, on=("k", "k")).group_by("k").agg(c=("count", "k")).run()


def test_q3_like_join_matches_jax(tmp_path):
    from strawboat_tpu.benchsuite.tpch import q3_like as ref_q3_like

    li, orders, lp, op = _q3_files(tmp_path, scale=0.01, li_rows=40_000, o_rows=10_000)
    lt, ot = scan_file(lp, "cpu"), scan_file(op, "cpu")
    got = tpch.q3_like(lt, ot, date_cut=1000, num_groups=16)
    want = ref_q3_like(ref_scan(lp), ref_scan(op), date_cut=1000, num_groups=16)
    for g, w, name in zip(got, want, ("keys", "n_groups", "revenue")):
        _assert_arr(g, w, name)
    assert tpch.q3_rows(got[0], got[1], got[2]) == tpch.q3_numpy_reference(li, orders)


# ---------------------------------------------------------------------------
# resident sources through the general path


@pytest.fixture(scope="module")
def resident_pair():
    from strawboat_tpu.benchsuite.tpch import generate_lineitem as ref_generate
    from strawboat_tpu.exec.resident import make_resident as ref_make

    rows = 5000
    cols = {k: v for k, v in tpch.generate_lineitem(1.0, rows=rows).items()
            if k in tpch.Q1_Q6_COLUMNS + ("l_suppkey",)}
    table = ref_generate(1.0, rows=rows).select(list(cols))
    return cols, make_resident(cols, "cpu", tile=TILE), ref_make(table, tile=TILE)


def test_resident_group_by_a_plain_column_matches_jax(resident_pair):
    cols, rt, rt_ref = resident_pair
    assert not rt["l_quantity"].is_dict

    def build(q, c):
        return q.filter(c("l_shipdate") <= 2467).group_by("l_quantity", num_groups=16).agg(
            rev=("sum", c("l_extendedprice") * (100 - c("l_discount"))), n=("count", "l_tax"),
            mx=("max", "l_extendedprice"), a=("avg", "l_discount")).order_by(("rev", "desc"))

    got, want = build(Query(rt), col).run(), build(RefQuery(rt_ref), ref_expr.col).run()
    _assert_same(got, want)
    assert got["keys"].shape[0] == 64  # 50 groups: the capacity grew
    m = cols["l_shipdate"] <= 2467
    q = cols["l_quantity"]
    assert int(got["n"][:50].sum()) == int(m.sum())
    assert int(got["mx"][0]) == int(cols["l_extendedprice"][m & (q == int(got["key_l_quantity"][0]))].max())


def test_resident_projection_with_limit_is_natural_order(resident_pair):
    cols, rt, rt_ref = resident_pair
    got = Query(rt).select("l_suppkey", "l_tax").filter(col("l_discount") > 7).limit(40).run()
    want = RefQuery(rt_ref).select("l_suppkey", "l_tax").filter(ref_expr.col("l_discount") > 7).limit(
        40).run()
    _assert_tables(got, want)
    sel = np.flatnonzero(cols["l_discount"] > 7)[:40]
    np.testing.assert_array_equal(got[0]["l_suppkey"].values.numpy(), cols["l_suppkey"][sel])


def test_q1_through_hash_aggregate_equals_the_fused_q1(resident_pair):
    """Q1's aggregates through the sort-based hash_aggregate over the
    decoded table equal the fused branch and numpy."""
    cols, rt, _rt_ref = resident_pair
    fused = tpch.q1(rt)
    table, pad = rt.as_device_table(list(tpch.Q1_Q6_COLUMNS))
    mask = pad & (col("l_shipdate") <= tpch.EPOCH_DAYS - tpch.Q1_DEFAULT_DELTA).mask(table)
    res = hash_aggregate(table, ["l_returnflag", "l_linestatus"], tpch.q1_aggs(), num_groups=16,
                         mask=mask)
    n = int(res["n_groups"])
    assert n == int(fused["n_groups"])
    for name in tpch.Q1_AGG_NAMES:
        _assert_arr(res[name][:n], fused[name], name)
    for k in ("l_returnflag", "l_linestatus"):
        np.testing.assert_array_equal(res[f"key_{k}"][:n].numpy(), fused[f"key_{k}"])
