"""Zone maps and page pruning of the torch port against the JAX package.

The port's writer puts the JAX writer's zone block in the file; the port
reads zone blocks of either writer; ``prune_pages`` gives the JAX
package's keep mask over int64, uint64, date32 and float64 zones for int
and float literals (NaN, ±inf, non-integral, beyond 2^53); a pruned
``scan_file`` keeps exactly the pages the JAX scan keeps, for every
column.  The first seven tests mirror ``tests/test_pruning.py``.
"""

import os

import numpy as np
import pyarrow as pa
import pytest

from strawboat_tpu.api import read_table as ref_read_table
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.exec import expr as ref_expr
from strawboat_tpu.exec import pruning as ref
from strawboat_tpu.exec.scan import scan_file as ref_scan
from strawboat_tpu.util.env import _ALL as FLAG_NAMES
from strawboat_tpu_torch.codecs import WriteOptions
from strawboat_tpu_torch.exec import Query, col, pruning, scan_file
from strawboat_tpu_torch.exec.pruning import Comparison, read_zones
from strawboat_tpu_torch.exec.scan import _open, host_values, page_keep_mask
from strawboat_tpu_torch.write import write_file


@pytest.fixture(autouse=True)
def no_flags(monkeypatch):
    for n in FLAG_NAMES:
        monkeypatch.delenv(n, raising=False)


def _plain(zones):
    """Zones of either package as plain tuples."""
    return {k: (z.kind, [(p.min, p.max, p.null_count, p.num_values) for p in z.pages])
            for k, z in zones.items()}


def _write_sorted(tmp_path):
    """8192 sorted keys in pages of 1024, through the port's writer."""
    n = 8192
    path = str(tmp_path / "z.str")
    cols = {"k": np.arange(n, dtype=np.int64), "v": np.arange(n, dtype=np.int64) * 3}
    write_file(path, cols, options=WriteOptions(max_page_size=1024, zone_maps=True))
    return path, cols


def test_zones_written(tmp_path):
    path, _ = _write_sorted(tmp_path)
    zones = read_zones(path)
    assert zones is not None and "k" in zones
    assert len(zones["k"].pages) == 8
    assert zones["k"].pages[0].min == 0
    assert zones["k"].pages[0].max == 1023
    assert zones["k"].pages[-1].max == 8191
    assert _plain(ref.read_zones(path)) == _plain(zones)


def test_pruned_scan_exact(tmp_path):
    path, _ = _write_sorted(tmp_path)
    # pages 5..7 survive (page 5 spans 5120..6143 and holds rows > 6000)
    dt = scan_file(path, "cpu", predicates=[Comparison("k", "gt", 6000)])
    k, v = dt["k"].values.numpy(), dt["v"].values.numpy()
    assert len(k) == 3072 and dt.num_rows == 3072
    sel = k > 6000
    assert sel.sum() == 8191 - 6000
    np.testing.assert_array_equal(v[sel], k[sel] * 3)


def test_prune_none_matches(tmp_path):
    path, _ = _write_sorted(tmp_path)
    dt = scan_file(path, "cpu", predicates=[Comparison("k", "gt", 10**9)])
    assert len(dt["k"]) == 0 and dt["v"].values.dtype == dt["k"].values.dtype


def test_prune_eq(tmp_path):
    path, _ = _write_sorted(tmp_path)
    dt = scan_file(path, "cpu", predicates=[Comparison("k", "eq", 5000)])
    assert len(dt["k"]) == 1024  # a single page
    assert 5000 in dt["k"].values.numpy()


def test_zones_are_in_band(tmp_path):
    """No sidecar file: zones live between the page data and the schema,
    and a reader that knows only the footer (the JAX host reader) reads
    the file unchanged."""
    path = str(tmp_path / "inband.str")
    write_file(path, {"k": np.arange(4096, dtype=np.int64)},
               options=WriteOptions(max_page_size=1024, zone_maps=True))
    assert not os.path.exists(path + ".zm.json")
    zones = read_zones(path)
    assert zones is not None and len(zones["k"].pages) == 4
    assert ref_read_table(path).column("k").to_pylist() == list(range(4096))


def test_zone_serializer_preserves_width():
    """i64 beyond 2^53, u64 beyond i64, floats and all-null pages round
    trip exactly, in the JAX package's bytes."""
    big = (1 << 62) + 12345
    ubig = (1 << 63) + 7
    specs = {
        "i": [(-big, big, 0, 10), (None, None, 10, 10)],
        "u": [(0, ubig, 1, 8)],
        "f": [(-0.5, 2.25, 2, 4)],
    }
    zones = {k: pruning.ColumnZones(k, [pruning.PageZone(*p) for p in v]) for k, v in specs.items()}
    ref_zones = {k: ref.ColumnZones(k, [ref.PageZone(*p) for p in v]) for k, v in specs.items()}
    payload = pruning.serialize_zones(zones)
    assert payload == ref.serialize_zones(ref_zones)
    assert pruning.zone_trailer(zones) == ref.zone_trailer(ref_zones)
    got = pruning.deserialize_zones(payload)
    assert got["i"].pages[0].min == -big and got["i"].pages[0].max == big
    assert got["i"].pages[1].min is None
    assert got["u"].pages[0].max == ubig and got["u"].kind == "u"
    assert got["f"].pages[0].min == -0.5 and got["f"].pages[0].max == 2.25
    with pytest.raises(ValueError):
        pruning.deserialize_zones(payload + b"\0")


def test_string_columns_emit_no_byte_zones(tmp_path):
    """utf8 pages publish no zone (byte-level min/max is no row bound),
    nulls or not; the integer column's zones equal the JAX writer's."""
    cols = {
        "a": np.array([1, 2, 3], dtype=np.int64),
        "s": np.array(["x", None, "z"], dtype=object),
        "s2": np.array(["p", "q", "r"]),
    }
    path = str(tmp_path / "z.str")
    write_file(path, cols, options=WriteOptions(max_page_size=2, zone_maps=True))
    zones = read_zones(path)
    assert zones is not None and "a" in zones
    assert "s" not in zones and "s2" not in zones
    ref_path = str(tmp_path / "r.str")
    ref_write(ref_path, pa.table({"a": cols["a"], "s": ["x", None, "z"], "s2": ["p", "q", "r"]}),
              options=RefOptions(max_page_size=2, zone_maps=True))
    assert open(path, "rb").read() == open(ref_path, "rb").read()


# ---------------------------------------------------------------------------
# prune_pages against the JAX package's


def _zone_pages(kind):
    """Zones of six pages of one kind, one all-null, bounds past 2^53."""
    if kind == "u64":
        lo = [0, 5, 2**53 + 1, 2**63 - 2, 2**63 + 10, 0]
        hi = [4, 2**53, 2**53 + 3, 2**63 + 1, 2**64 - 1, 0]
    elif kind == "f64":
        lo = [-5.5, -0.0, 1.0, 2.0**53, -np.inf, 0.0]
        hi = [-1.0, 0.0, 3.5, 2.0**60, np.inf, 0.0]
    else:  # int64 and date32 days
        lo = [-(2**62), -7, 0, 2**53 - 1, 2**53 + 1, 0]
        hi = [-(2**53), -1, 6, 2**53 + 1, 2**62, 0]
    has = [True] * 5 + [False]
    return [(a if h else None, b if h else None, 0 if h else 9, 9) for a, b, h in zip(lo, hi, has)]


LITERALS = [0, -1, 6, 7, 3.5, -7.0, 2**53, 2**53 + 1, 2**63 + 5, -(2**63) - 5, 2.0**53 + 0.5,
            9007199254740993.0, float("nan"), float("inf"), float("-inf"), 1e300, -0.0, True]


@pytest.mark.parametrize("kind", ["int64", "u64", "date32", "f64"])
def test_prune_pages_equals_jax(kind):
    pages = _zone_pages(kind)
    zkind = {"u64": "u", "f64": "f"}.get(kind, "i")
    zones = {"c": pruning.ColumnZones("c", [pruning.PageZone(*p) for p in pages], zkind)}
    ref_zones = {"c": ref.ColumnZones("c", [ref.PageZone(*p) for p in pages], zkind)}
    for v in LITERALS:
        for op in pruning.OPS:
            got = pruning.prune_pages(zones, [Comparison("c", op, v)], len(pages))
            want = ref.prune_pages(ref_zones, [ref.Comparison("c", op, v)], len(pages))
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} {op} {v!r}")
    # a conjunction is the AND of its atoms; another grid or column keeps all
    preds = [Comparison("c", "ge", 0), Comparison("c", "lt", 7)]
    np.testing.assert_array_equal(
        pruning.prune_pages(zones, preds, len(pages)),
        ref.prune_pages(ref_zones, [ref.Comparison(p.column, p.op, p.value) for p in preds], len(pages)))
    assert pruning.prune_pages(zones, [Comparison("c", "gt", 10**30)], 7).all()
    assert pruning.prune_pages(zones, [Comparison("other", "eq", 3)], len(pages)).all()


def test_float_literal_never_prunes_a_matching_int_page():
    """Against int64 zones beyond 2^53 a float literal takes an exact
    integer bound: a page holding a matching row is kept."""
    z = {"c": pruning.ColumnZones("c", [pruning.PageZone(2**53 + 1, 2**53 + 1, 0, 1)], "i")}
    assert pruning.prune_pages(z, [Comparison("c", "gt", 2.0**53)], 1).all()
    assert not pruning.prune_pages(z, [Comparison("c", "eq", 2.0**53)], 1).any()
    assert pruning.prune_pages(z, [Comparison("c", "eq", 2**53 + 1)], 1).all()


def test_predicates_the_port_cannot_use_raise(tmp_path):
    path, _ = _write_sorted(tmp_path)
    for bad in (["k < 3"], [("k", "lt", 3)], [Comparison("k", "between", 3)],
                [Comparison("k", "lt", "3")]):
        with pytest.raises((TypeError, ValueError)):
            scan_file(path, "cpu", predicates=bad)


# ---------------------------------------------------------------------------
# files of either writer, pruned scans, Query atoms


def _mixed_table(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.1
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "d": pa.array(np.sort(rng.integers(0, 3000, n)).astype(np.int32), pa.date32()),
        "u": pa.array(np.sort(rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64))),
        "n": pa.array(rng.integers(-100, 100, n), mask=null),
        "f": pa.array(rng.normal(0, 1, n)),
        "s": pa.array(np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)]),
    })


def test_zones_of_jax_file_with_floats_equal_jax(tmp_path):
    """A JAX file with a float column has ``f`` zones; the port reads every
    zone the JAX package reads, at its width."""
    path = str(tmp_path / "f.str")
    ref_write(path, _mixed_table(), options=RefOptions(
        default_compression=RefCompression.LZ4, max_page_size=512, zone_maps=True))
    got, want = read_zones(path), ref.read_zones(path)
    assert list(got) == list(want) == ["k", "d", "u", "n", "f"]
    assert got["f"].kind == "f" and got["u"].kind == "u"
    assert _plain(got) == _plain(want)
    write_file(str(tmp_path / "plain.str"), {"k": np.arange(10)})
    assert read_zones(str(tmp_path / "plain.str")) is None


@pytest.mark.parametrize("preds", [
    [("d", "ge", 1000), ("d", "lt", 1400)],
    [("u", "gt", 2**63 + 2**62)],
    [("n", "eq", 5), ("k", "le", 4000.5)],
    [("f", "gt", 2.5)],
    [("k", "ne", 3)],
    [("s", "eq", 1)],
])
def test_pruned_scan_equals_jax(tmp_path, preds):
    """Same keep mask, same rows in every column, over a JAX file."""
    path = str(tmp_path / "m.str")
    ref_write(path, _mixed_table(), options=RefOptions(
        default_compression=RefCompression.LZ4, max_page_size=512, zone_maps=True))
    mine = [Comparison(*p) for p in preds]
    theirs = [ref.Comparison(*p) for p in preds]
    want_keep = ref.prune_pages(ref.read_zones(path), theirs, 12)
    keep = page_keep_mask(path, _open(path)[1], mine)
    np.testing.assert_array_equal(np.ones(12, bool) if keep is None else keep, want_keep)
    cols = ["k", "d", "u", "n", "s"]
    got = scan_file(path, "cpu", columns=cols, predicates=mine)
    want = ref_scan(path, columns=cols, predicates=theirs)
    page_rows = np.array([512] * 11 + [6000 - 11 * 512])
    assert got.num_rows == want.num_rows == int(page_rows[want_keep].sum())
    for c in cols:
        g = host_values(got[c])
        np.testing.assert_array_equal(g, np.asarray(want[c].values).astype(g.dtype), err_msg=c)


def test_expr_atoms_equal_jax():
    """Column-vs-number comparisons make atoms, ``&`` concatenates them,
    ``|``, ``~``, arithmetic and string literals make none."""
    for make in (
        lambda c: (c("a") <= 3) & (c("b") > 2.5) & (c("s") == "x"),
        lambda c: (5 < c("a")) & ((c("b") == 1) | (c("b") == 2)),
        lambda c: ~(c("a") != 7),
        lambda c: (c("a") + 1 > 3) & (c("a") >= 2**60),
    ):
        got = [(a.column, a.op, a.value) for a in make(col).atoms]
        want = [(a.column, a.op, a.value) for a in make(ref_expr.col).atoms]
        assert got == want


def test_query_filter_prunes_pages_like_jax(tmp_path, monkeypatch):
    """``Query(path)`` hands its filter's atoms to the scan: the scan drops
    the pages the JAX Query drops, and the answers agree."""
    from strawboat_tpu.exec.query import Query as RefQuery
    from strawboat_tpu_torch.exec import scan as port_scan

    path = str(tmp_path / "q.str")
    ref_write(path, _mixed_table(), options=RefOptions(
        default_compression=RefCompression.LZ4, max_page_size=512, zone_maps=True))
    rows = []
    inner = port_scan._scan
    monkeypatch.setattr(port_scan, "_scan", lambda *a: rows.append(a[-1]) or inner(*a))
    got = (Query(path, device="cpu").filter((col("d") >= 1000) & (col("d") < 1400))
           .agg(s=("sum", "n"), c=("count", "k")).run())
    want = (RefQuery(path).filter((ref_expr.col("d") >= 1000) & (ref_expr.col("d") < 1400))
            .agg(s=("sum", "n"), c=("count", "k")).run())
    assert int(got["s"]) == int(want["s"]) and int(got["c"]) == int(want["c"])
    (keep,) = rows
    assert keep is not None and 0 < keep.sum() < len(keep)
