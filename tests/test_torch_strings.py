"""String columns of the torch port against the JAX package.

The port scans utf8 / binary columns into int32 dictionary codes on the
device plus a host dictionary of ``bytes``: over files of the JAX writer
(no flag, LZ4, Zstd, the DICT and FREQ flags, DICT with bit-packed codes, and
the adaptive chooser with zone maps) it gives the JAX ``scan_file``'s
codes, dictionary in the same order, and validity, exactly; pruned scans
and ``scan_chunks`` too.  The port's writer writes the JAX writer's file,
byte for byte.  Over the 10-column TPC-H lineitem file, ``Query`` Q1 equals
the JAX ``q1_query`` slot for slot, Q6 over a pruned scan equals the JAX
``q6`` and numpy, and ``load_resident`` equals the JAX ``load_resident``
word for word.  The first four tests mirror ``tests/test_device_strings.py``.
Everything runs on the CPU (K3 through its plain version).
"""

import importlib
from unittest import mock

import numpy as np
import pyarrow as pa
import pytest
import torch

import strawboat_tpu.kernels  # noqa: F401  (JAX x64 on)
from strawboat_tpu import schema as ref_schema
from strawboat_tpu.api import read_table as ref_read_table
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.exec import pruning as ref_pruning
from strawboat_tpu.exec.scan import scan_chunks as ref_scan_chunks
from strawboat_tpu.exec.scan import scan_file as ref_scan
from strawboat_tpu.util.env import _ALL as FLAG_NAMES
from strawboat_tpu_torch import schema
from strawboat_tpu_torch.benchsuite import tpch
from strawboat_tpu_torch.codecs import WriteOptions, read_header
from strawboat_tpu_torch.constants import Compression
from strawboat_tpu_torch.errors import NotYetImplementedError
from strawboat_tpu_torch.exec import load_resident, make_resident, scan_file
from strawboat_tpu_torch.exec import scan as port_scan
from strawboat_tpu_torch.exec.pruning import Comparison
from strawboat_tpu_torch.write import write_file

DICT, BP = "STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION"
FREQ = "STRAWBOAT_FREQ_COMPRESSION"
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


@pytest.fixture
def flags(monkeypatch):
    def set_flags(names):
        for n in FLAG_NAMES:
            monkeypatch.delenv(n, raising=False)
        for n in names:
            monkeypatch.setenv(n, "1")

    set_flags(())
    return set_flags


def _ref_write(path, table, **kw):
    """The JAX writer, LZ4 pages of 1024 rows unless told otherwise."""
    kw.setdefault("default_compression", RefCompression.LZ4)
    kw.setdefault("max_page_size", 1024)
    ref_write(str(path), table, options=RefOptions(**kw))
    return str(path)


def _decoded(col):
    """A scanned string column as Python values (None for null)."""
    vals = col.dictionary[col.values.numpy()] if len(col.values) else []
    valid = np.ones(len(col.values), bool) if col.validity is None else col.validity.numpy()
    return [v.decode() if ok else None for v, ok in zip(vals, valid)]


# ---------------------------------------------------------------------------
# tests/test_device_strings.py, as port cases


@pytest.fixture
def dict_string_file(tmp_path, flags):
    rng = np.random.default_rng(5)
    n = 5000
    words = [f"word-{i}" for i in range(40)]
    vals = [words[i] for i in rng.integers(0, len(words), n)]
    flags((DICT,))
    path = _ref_write(tmp_path / "dict_str.str", pa.table({"s": pa.array(vals, pa.string())}))
    flags(())
    return path, vals


def test_dict_string_pages_never_reencode(dict_string_file, monkeypatch):
    """Every page DICT-coded → no per-row encode during the scan."""
    path, vals = dict_string_file

    def boom(offsets, values):
        raise AssertionError("per-row encode called on the DICT page path")

    monkeypatch.setattr(port_scan, "_dictionary_encode", boom)
    got = scan_file(path, "cpu")
    assert got.to_arrow().column("s").to_pylist() == vals
    assert _decoded(got["s"]) == vals


def test_dict_string_multi_page_dictionary_merge(dict_string_file):
    """Page dictionaries differ and merge, by base-offset remap, into one
    global dictionary without duplicates, in the JAX scan's order."""
    path, vals = dict_string_file
    c = scan_file(path, "cpu")["s"]
    d = list(c.dictionary)
    assert len(set(d)) == len(d)
    assert d == ref_scan(path)["s"].dictionary.to_pylist()
    assert [d[i].decode() for i in c.values.numpy()] == vals


def test_mixed_raw_and_dict_string_pages(tmp_path, flags, monkeypatch):
    """Raw pages (high cardinality) encode per row, DICT pages do not; rows
    still share one dictionary."""
    n = 3000
    vals = [f"k-{i % 12}" for i in range(2048)] + [f"unique-{i}" for i in range(n - 2048)]
    path = _ref_write(tmp_path / "mixed.str", pa.table({"s": pa.array(vals, pa.string())}),
                      default_compress_ratio=1.0)
    calls = []
    orig = port_scan._dictionary_encode
    monkeypatch.setattr(port_scan, "_dictionary_encode",
                        lambda o, v: calls.append(len(o) - 1) or orig(o, v))
    got = scan_file(path, "cpu")
    assert _decoded(got["s"]) == vals
    assert 0 < sum(calls) < len(vals)
    assert list(got["s"].dictionary) == ref_scan(path)["s"].dictionary.to_pylist()


def test_raw_string_pages_encode_page_by_page(tmp_path, flags, monkeypatch):
    """Raw pages encode one page at a time, so host memory stays bounded
    by a page; their dictionaries, pooled in page order, keep the JAX
    scan's first appearances over the rows, values first seen on later
    pages and nulls included."""
    rng = np.random.default_rng(11)
    n, page = 5000, 1024
    vals = [None if rng.random() < 0.1 else f"p{i // page}-{int(v)}"
            for i, v in enumerate(rng.integers(0, 6, n))]
    vals[3000:3010] = ["p0-1"] * 10  # a value of page 0 again on page 2
    path = _ref_write(tmp_path / "raw.str", pa.table({"s": pa.array(vals, pa.string())}),
                      default_compression=RefCompression.NONE, max_page_size=page)
    calls = []
    orig = port_scan._dictionary_encode
    monkeypatch.setattr(port_scan, "_dictionary_encode",
                        lambda o, v: calls.append(len(o) - 1) or orig(o, v))
    got = scan_file(path, "cpu")
    assert calls == [page] * 4 + [n - 4 * page]
    assert _decoded(got["s"]) == vals
    _assert_scan_equal(got, ref_scan(path), ["s"])


def test_slice_keys_hold_the_bytes_and_the_length():
    """A slice's u64 key: its bytes little-endian in the low 7 bytes, its
    length in the top byte."""
    from strawboat_tpu_torch.codecs.binary import key_bytes, slice_keys

    rng = np.random.default_rng(2)
    lens = rng.integers(0, 8, 3000)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    values = rng.integers(0, 256, int(offsets[-1])).astype(np.uint8)
    keys = slice_keys(offsets[:-1], lens, values)
    want = [values[s : s + ln].tobytes() for s, ln in zip(offsets[:-1], lens)]
    assert keys.dtype == np.uint64
    assert [key_bytes(k) for k in keys.tolist()] == want
    assert keys.tolist() == [int.from_bytes(w.ljust(7, b"\0") + bytes([len(w)]), "little") for w in want]


def test_nullable_dict_string_roundtrip(tmp_path, flags):
    rng = np.random.default_rng(9)
    n = 4000
    vals = [None if rng.random() < 0.2 else f"v{int(i)}" for i in rng.integers(0, 30, n)]
    flags((DICT,))
    path = _ref_write(tmp_path / "nullable.str", pa.table({"s": pa.array(vals, pa.string())}))
    got = scan_file(path, "cpu")
    assert got.to_arrow().column("s").to_pylist() == vals
    assert _decoded(got["s"]) == vals


# ---------------------------------------------------------------------------
# files of the JAX writer: the port's scan == the JAX scan


def _string_table(n=6000, seed=0):
    """Every string case: few values, nulls with an all-null page and a
    leading null, empty strings and non-ASCII, unique values, a dominant
    value, a constant, large_string, binary with NUL bytes; int keys for
    pruning."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(40)] + ["", "é✓"])
    null = rng.random(n) < 0.2
    null[0] = True
    null[1024:2048] = True  # one page of nulls only
    return pa.table({
        "flag": pa.array(np.array(["A", "N", "R"])[rng.integers(0, 3, n)]),
        "word": pa.array(words[rng.integers(0, len(words), n)], mask=null),
        "uniq": pa.array([f"u{i}" for i in range(n)]),
        "top": pa.array(np.where(rng.random(n) < 0.95, "top", words[rng.integers(0, 40, n)])),
        "const": pa.array(np.full(n, "same")),
        "large": pa.array(words[rng.integers(0, len(words), n)], pa.large_string(),
                          mask=rng.random(n) < 0.1),
        "bin": pa.array([bytes([i % 7, 0, i % 3]) for i in range(n)], pa.binary()),
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "day": pa.array(np.sort(rng.integers(0, 4000, n)).astype(np.int32), pa.date32()),
    })


READS = {
    # name: (forcing flags, writer options)
    "none": ((), dict(default_compression=RefCompression.NONE)),
    "lz4": ((), {}),
    "zstd": ((), dict(default_compression=RefCompression.ZSTD)),
    "dict": ((DICT,), dict(default_compression=RefCompression.NONE)),
    "dict_bitpack": ((DICT, BP), dict(default_compression=RefCompression.NONE, zone_maps=True)),
    "freq": ((FREQ,), {}),
    "adaptive": ((), dict(default_compress_ratio=1.0, sample_seed=3, zone_maps=True)),
}


def _string_page_kinds(path, names):
    """{(codec, index codec or None)} over the pages of the string columns."""
    sch, metas, file_bytes = port_scan._open(path)
    out = set()
    for meta, field in port_scan._selected(sch, metas, names):
        for length, _v, buf, p in port_scan._plan_pages(file_bytes, meta, field.nullable):
            codec, _c, _u, body = read_header(buf, p)
            out.add((codec, read_header(buf, body)[0] if codec == Compression.DICT else None))
    return out


def _assert_scan_equal(got, want, names):
    assert got.num_rows == want.num_rows
    for k in names:
        g, w = got[k], want[k]
        np.testing.assert_array_equal(port_scan.host_values(g), np.asarray(w.values), err_msg=k)
        assert (g.validity is None) == (w.validity is None), k
        if w.validity is not None:
            np.testing.assert_array_equal(g.validity.numpy(), np.asarray(w.validity), err_msg=k)
        if w.dictionary is not None or g.dictionary is not None:
            assert g.values.dtype == torch.int32, k
            want_d = [] if w.dictionary is None else w.dictionary.to_pylist()
            assert list(g.dictionary) == want_d, k
            assert all(type(v) is bytes for v in g.dictionary), k


STRINGS = ["flag", "word", "uniq", "top", "const", "large", "bin"]


@pytest.mark.parametrize("name", list(READS))
def test_scan_of_jax_string_file_equals_jax(tmp_path, flags, name):
    names, opts = READS[name]
    flags(names)
    table = _string_table()
    path = _ref_write(tmp_path / "s.str", table, **opts)
    flags(())
    got = scan_file(path, "cpu")
    _assert_scan_equal(got, ref_scan(path), table.column_names)
    assert got.to_arrow().equals(ref_read_table(path))
    kinds = _string_page_kinds(path, STRINGS)
    expect = {
        "none": {(Compression.NONE, None)},
        "lz4": {(Compression.LZ4, None)},
        "zstd": {(Compression.ZSTD, None)},
        "dict": {(Compression.DICT, Compression.NONE)},
        # the 880-row tail page is no multiple of 128: its codes stay raw
        "dict_bitpack": {(Compression.DICT, Compression.BITPACKING),
                         (Compression.DICT, Compression.NONE)},
        "freq": {(Compression.FREQ, None)},
    }.get(name)
    if expect is None:  # the chooser reaches every binary codec
        assert {c for c, _i in kinds} == {Compression.LZ4, Compression.DICT, Compression.FREQ,
                                          Compression.ONE_VALUE}, kinds
    else:
        assert kinds == expect, kinds
    if name == "dict_bitpack":
        # K3 (one width), all-zero and raw codes on the host, mixed widths
        # on the device
        sch, metas, file_bytes = port_scan._open(path)
        jobs = {j[0] for meta, f in port_scan._selected(sch, metas, STRINGS)
                for j in port_scan._binary_page_jobs(
                    port_scan._plan_pages(file_bytes, meta, f.nullable), f.dtype == "large_string")}
        assert jobs == {"k3", "host", "dev"}, jobs


@pytest.mark.parametrize("name", ["dict_bitpack", "adaptive"])
def test_pruned_string_scan_and_chunks_equal_jax(tmp_path, flags, name):
    """The same keep mask drops the same pages of every column; chunked
    scans match the JAX chunks one for one."""
    names, opts = READS[name]
    flags(names)
    path = _ref_write(tmp_path / "s.str", _string_table(), **opts)
    flags(())
    preds = [("k", "ge", 1500), ("day", "lt", 3000)]
    mine, theirs = [Comparison(*p) for p in preds], [ref_pruning.Comparison(*p) for p in preds]
    keep = port_scan.page_keep_mask(path, port_scan._open(path)[1], mine)
    want_keep = ref_pruning.prune_pages(ref_pruning.read_zones(path), theirs, 6)
    np.testing.assert_array_equal(keep, want_keep)
    assert 0 < keep.sum() < len(keep)
    _assert_scan_equal(scan_file(path, "cpu", predicates=mine),
                       ref_scan(path, predicates=theirs), STRINGS + ["k", "day"])
    for p_mine, p_ref in ((None, None), (mine, theirs)):
        got = list(port_scan.scan_chunks(path, 2, "cpu", predicates=p_mine))
        want = list(ref_scan_chunks(path, 2, predicates=p_ref))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            _assert_scan_equal(g, w, STRINGS + ["k"])


def test_scan_chunks_columns_and_refusals(tmp_path, flags):
    path = _ref_write(tmp_path / "s.str", _string_table(n=3000))
    chunks = list(port_scan.scan_chunks(path, 1, "cpu", columns=["flag", "k"]))
    assert len(chunks) == 3 and all(list(c.columns) == ["flag", "k"] for c in chunks)
    assert np.concatenate([c["k"].values.numpy() for c in chunks]).tolist() == list(range(3000))
    with pytest.raises(ValueError):
        next(port_scan.scan_chunks(path, 0, "cpu"))
    nested = _ref_write(tmp_path / "n.str", pa.table({"l": pa.array([["a"], ["b", "a"]])}))
    (chunk,) = port_scan.scan_chunks(nested, 1, "cpu")  # nested columns chunk now
    assert [chunk["l"].dictionary[c] for c in chunk["l"].values.tolist()] == [b"a", b"b", b"a"]
    assert chunk["l"].offsets.tolist() == [0, 1, 3]
    with pytest.raises(TypeError):  # a predicate that is not a Comparison
        next(port_scan.scan_chunks(path, 1, "cpu", columns=["flag"], predicates=[("k", "lt", 1)]))


# ---------------------------------------------------------------------------
# files of the port's writer == files of the JAX writer


def _numpy_strings(n=5000, seed=1):
    """numpy string columns of each input kind, and their arrow tables."""
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.2
    null[0] = True
    null[2048:3072] = True
    cols = {
        "flag": np.array(["A", "N", "R"])[rng.integers(0, 3, n)],
        "mode": np.ma.MaskedArray(
            np.array(["AIR", "REG AIR", "TRUCK", "", "naïve"])[rng.integers(0, 5, n)], mask=null),
        "obj": np.array(["x", None, "longer than eight bytes", "y"], dtype=object)[rng.integers(0, 4, n)],
        "raw": np.array([b"\x00a", b"bb", b"c\x00d"], dtype=object)[rng.integers(0, 3, n)],
        "fixed": np.array([b"ab", b"c", b"zz"])[rng.integers(0, 3, n)],
        "k": np.arange(n, dtype=np.int64) * 3,
        "day": np.sort(rng.integers(0, 4000, n)).astype("datetime64[D]"),
    }
    table = pa.table({
        "flag": pa.array(cols["flag"]),
        "mode": pa.array(np.ma.getdata(cols["mode"]), mask=null),
        "obj": pa.array(list(cols["obj"]), pa.string()),
        "raw": pa.array(list(cols["raw"]), pa.binary()),
        "fixed": pa.array(list(cols["fixed"]), pa.binary()),
        "k": pa.array(cols["k"]),
        "day": pa.array(cols["day"]),
    })
    return cols, table


@pytest.mark.parametrize("names", [(), (DICT,), (DICT, BP)])
@pytest.mark.parametrize("zone_maps", [False, True])
def test_port_writer_file_equals_jax_writer(tmp_path, flags, names, zone_maps):
    """Page bytes, zone block, schema bytes and metas: the whole file."""
    flags(names)
    cols, table = _numpy_strings()
    port_path, ref_path = str(tmp_path / "port.str"), str(tmp_path / "ref.str")
    metas = write_file(port_path, cols, options=WriteOptions(max_page_size=1024, zone_maps=zone_maps))
    ref_write(ref_path, table, options=RefOptions(max_page_size=1024, zone_maps=zone_maps))
    got, want = open(port_path, "rb").read(), open(ref_path, "rb").read()
    assert got == want
    assert len(metas) == 7
    assert (ref_pruning.read_zones(port_path) is not None) == zone_maps
    _assert_scan_equal(scan_file(port_path, "cpu"), ref_scan(ref_path), list(cols))


def test_schema_bytes_equal_pyarrow():
    fields = [
        schema.Field("s", "string"), schema.Field("b", "binary", False),
        schema.Field("ls", "large_string"), schema.Field("lb", "large_binary", False),
        schema.Field("u", "uint16", False), schema.Field("d", "date32"),
        schema.Field("naïve ✓", "int64"),
    ]
    want = ref_schema.schema_to_bytes(pa.schema(
        [pa.field(f.name, pa.type_for_alias(f.dtype), f.nullable) for f in fields]))
    assert schema.schema_to_bytes(fields) == want
    assert schema.deserialize_schema(want) == fields
    assert [f.is_flat_string for f in fields] == [True] * 4 + [False] * 3


def test_writer_string_options(tmp_path, flags):
    """A schema overrides utf8 → large_string; the writer refuses what it
    does not write yet and nulls in a non-nullable field."""
    cols = {"s": np.array(["a", "bb", "a"])}
    path = str(tmp_path / "w.str")
    write_file(path, cols, schema=[schema.Field("s", "large_string")])
    want = pa.table({"s": pa.array(["a", "bb", "a"], pa.large_string())})
    assert ref_read_table(path).equals(want)
    ref_path = _ref_write(tmp_path / "r.str", want, default_compression=RefCompression.NONE,
                          max_page_size=None)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    with pytest.raises(NotYetImplementedError):
        write_file(path, cols, options=WriteOptions(default_compress_ratio=1.0))
    flags((FREQ,))
    with pytest.raises(NotYetImplementedError, match="FREQ"):
        write_file(path, cols)
    flags(())
    with pytest.raises(Exception, match="not nullable"):
        write_file(path, {"s": np.array(["a", None], dtype=object)},
                   schema=[schema.Field("s", "string", False)])
    # zone maps are decided once: in the options, or beside none
    with pytest.raises(ValueError, match="zone_maps"):
        tpch.write_lineitem(path, tpch.generate_lineitem(1.0, seed=0, rows=64),
                            options=WriteOptions(), zone_maps=True)


# ---------------------------------------------------------------------------
# the slice as a whole: the 10-column lineitem file


def _lineitem(tmp_path, flags, writer):
    """A 10-column lineitem file of 20 000 rows with zone maps: the port's
    writer under the dict flags, or the JAX writer with the tpch_bench
    options (LZ4, the adaptive chooser)."""
    cols = tpch.generate_lineitem(1.0, seed=0, rows=20_000)
    path = str(tmp_path / f"lineitem_{writer}.str")
    if writer == "port":
        flags((DICT, BP))
        tpch.write_lineitem(path, cols, max_page_size=2048, zone_maps=True)
        flags(())
    else:
        from strawboat_tpu.benchsuite.tpch import generate_lineitem as ref_generate

        _ref_write(path, ref_generate(1.0, seed=0, rows=20_000), default_compress_ratio=1.0,
                   sample_seed=0, zone_maps=True, max_page_size=2048)
    return cols, path


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lineitem_q1_query_equals_jax(tmp_path, flags, writer):
    """Q1 with its l_shipdate filter, grouped and ordered by the string
    flags: the JAX ``q1_query`` slot for slot (keys, labels, ``dict_*``,
    every aggregate and its dtype), and numpy."""
    from strawboat_tpu.benchsuite import tpch as ref_tpch

    cols, path = _lineitem(tmp_path, flags, writer)
    got = tpch.q1_query(path, "cpu")
    want = ref_tpch.q1_query(path)
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("dict_"):
            assert list(got[k]) == w.to_pylist(), k
            continue
        g, w = got[k].numpy(), np.asarray(w)
        if w.dtype.kind == "u":
            g = g.view(w.dtype)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.startswith("avg_"):
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    rows = tpch.q1_rows(got)
    want_rows = tpch.q1_numpy_reference(cols)
    assert list(rows) == list(want_rows)
    for key, aggs in want_rows.items():
        for name, w in aggs.items():
            if name.startswith("avg_"):
                np.testing.assert_allclose(rows[key][name], w, rtol=1e-12)
            else:
                assert rows[key][name] == w, (key, name)
    assert tpch.q1_rows(tpch.q1(scan_file(path, "cpu"))) == rows


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lineitem_q6_over_pruned_scan_equals_jax(tmp_path, flags, writer):
    from strawboat_tpu.benchsuite import tpch as ref_tpch

    cols, path = _lineitem(tmp_path, flags, writer)
    got = scan_file(path, "cpu", predicates=tpch.q6_pruning_predicates())
    want = ref_scan(path, predicates=ref_tpch.q6_pruning_predicates())
    assert 0 < got.num_rows < 20_000
    _assert_scan_equal(got, want, list(tpch.LINEITEM_COLUMNS))
    assert int(tpch.q6(got)) == int(ref_tpch.q6(want)) == tpch.q6_numpy_reference(cols)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lineitem_load_resident_equals_jax(tmp_path, flags, writer):
    """``load_resident`` of the ten columns: the JAX planes word for word,
    the sorted ``str`` dictionaries; the fused Q1 and Q6 equal numpy.
    ``make_resident`` of the scan equals the JAX device-direct encode."""
    from strawboat_tpu.exec.resident import load_resident as ref_load
    from strawboat_tpu.exec.resident import make_resident as ref_make

    cols, path = _lineitem(tmp_path, flags, writer)
    for rt, rt_ref in ((load_resident(path, "cpu", tile=TILE), ref_load(path, tile=TILE)),
                       (make_resident(scan_file(path, "cpu"), "cpu", tile=TILE),
                        ref_make(ref_scan(path), tile=TILE))):
        assert list(rt.columns) == list(tpch.LINEITEM_COLUMNS)
        for n, r in rt_ref.columns.items():
            c = rt.columns[n]
            assert (c.kind, c.length, tuple(c.shifts), c.offset) == (r.kind, r.length, tuple(r.shifts), r.offset), n
            assert [b for _w, b in c.planes] == [b for _w, b in r.planes], n
            for (w, _b), (rw, _rb) in zip(c.planes, r.planes):
                np.testing.assert_array_equal(w.numpy().view(np.uint32), np.asarray(rw), err_msg=n)
            assert c.is_dict == r.is_dict, n
            if c.kind == "str":
                assert list(c.dictionary_host) == list(r.dictionary_host), n
                assert [type(v) for v in c.dictionary_host] == [type(v) for v in r.dictionary_host], n
        rows = tpch.q1_rows(tpch.q1(rt))
        assert list(rows) == list(tpch.q1_numpy_reference(cols))
        assert int(tpch.q6(rt)) == tpch.q6_numpy_reference(cols)


def test_q1_rows_decodes_bytes_dictionaries():
    """A scanned dictionary holds ``bytes``: keys read ``("A", "F")``, not
    ``("b'A'", "b'F'")``."""
    res = {"n_groups": 2, "key_l_returnflag": torch.tensor([1, 0]),
           "key_l_linestatus": torch.tensor([0, 1]),
           "dict_l_returnflag": np.array([b"N", b"A"], dtype=object),
           "dict_l_linestatus": np.array(["F", "O"], dtype=object)}
    for i, name in enumerate(tpch.Q1_AGG_NAMES):
        res[name] = torch.tensor([i, i + 1])
    assert list(tpch.q1_rows(res)) == [("A", "F"), ("N", "O")]


def test_string_filters_and_order_over_a_file_equal_jax(tmp_path, flags):
    """String literals compare through the scanned ``bytes`` dictionary
    (eq, isin, lexical ranges) and ORDER BY a string key ranks it
    lexically, as the JAX Query does over the same file."""
    from strawboat_tpu.exec import expr as ref_expr
    from strawboat_tpu.exec.query import Query as RefQuery
    from strawboat_tpu_torch.exec import Query, col

    cols, path = _lineitem(tmp_path, flags, "port")

    def build(q, c):
        return (q.filter((c("l_shipmode") != "AIR") & (c("l_returnflag") >= "B")
                         & (c("l_shipdate") < 2000))
                .group_by("l_shipmode", "l_linestatus", num_groups=64)
                .agg(n=("count", "l_quantity"), s=("sum", "l_extendedprice"))
                .order_by(("key_l_shipmode", "desc"), "key_l_linestatus"))

    got = build(Query(path, device="cpu"), col).run()
    want = build(RefQuery(path), ref_expr.col).run()
    n = int(want["n_groups"])
    assert int(got["n_groups"]) == n == 6  # six modes; every row before day 2000 is "F"
    for k in ("key_l_shipmode", "key_l_linestatus", "n", "s"):
        np.testing.assert_array_equal(got[k][:n].numpy(), np.asarray(want[k])[:n], err_msg=k)
    modes = [got["dict_l_shipmode"][i].decode() for i in got["key_l_shipmode"][:n].tolist()]
    assert modes == sorted(modes, reverse=True) and "AIR" not in modes
    m = ((cols["l_shipmode"] != "AIR") & (cols["l_returnflag"] >= "B")
         & (cols["l_shipdate"] < 2000))
    assert int(got["n"][:n].sum()) == int(m.sum())
