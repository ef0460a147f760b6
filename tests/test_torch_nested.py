"""Nested columns of the torch port against the JAX package: schema bytes,
the level codec, files written byte for byte, and scans of JAX-written
files (offsets, validities at every level, leaf values bit for bit).

Inputs are made from numpy seeds; the JAX side runs on the CPU.  The port
takes nested columns as ``strawboat_tpu_torch.columns`` objects under a
nested ``schema.Field``; ``_port_inputs`` builds them from the same arrow
table the JAX writer takes.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from strawboat_tpu import schema as ref_schema
from strawboat_tpu.api import read_table as ref_read
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.errors import NotYetImplementedError as RefNotYet
from strawboat_tpu.exec import scan_file as ref_scan
from strawboat_tpu.exec.aggregate import list_segment_sum as ref_list_sum
from strawboat_tpu.util import hybrid_rle as ref_rle
from strawboat_tpu_torch import columns as cm
from strawboat_tpu_torch import schema as port_schema
from strawboat_tpu_torch.codecs import WriteOptions
from strawboat_tpu_torch.exec import scan as port_scan
from strawboat_tpu_torch.exec.aggregate import list_segment_sum
from strawboat_tpu_torch.exec.pruning import Comparison
from strawboat_tpu_torch.exec.scan import DeviceListColumn, host_values, scan_chunks, scan_file
from strawboat_tpu_torch.util import hybrid_rle as port_rle
from strawboat_tpu_torch.write import write_file

FLAGS = ("STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION")
FLAG_SETS = {"none": (), "dict": FLAGS[:1], "dict_bitpack": FLAGS}


@pytest.fixture
def flags(monkeypatch):
    def set_flags(names):
        for k in FLAGS:
            monkeypatch.delenv(k, raising=False)
        for k in names:
            monkeypatch.setenv(k, "1")

    set_flags(())
    return set_flags


def _ragged(rng, n, inner, p_null=0.1, max_len=5):
    return [None if rng.random() < p_null else [inner() for _ in range(int(rng.integers(0, max_len)))]
            for _ in range(n)]


def _struct_rows(rng, n):
    return pa.StructArray.from_arrays(
        [pa.array(rng.integers(-50, 50, n)),
         pa.array(_ragged(rng, n, lambda: float(rng.random())), pa.list_(pa.float64()))],
        names=["a", "l"], mask=pa.array(rng.random(n) < 0.2))


def _table(layout: str, n: int = 600, seed: int = 0) -> pa.Table:
    """One arrow table per nested layout (and the flat column beside it)."""
    rng = np.random.default_rng(seed)
    word = lambda: ["", "a", "bb", "ccc", "lorem"][int(rng.integers(0, 5))]  # noqa: E731
    if layout == "list_int64":
        arr = pa.array(_ragged(rng, n, lambda: int(rng.integers(-100, 1000))), pa.list_(pa.int64()))
    elif layout == "list_int32_nullable_leaves":
        arr = pa.array(_ragged(rng, n, lambda: None if rng.random() < 0.2 else int(rng.integers(0, 99))),
                       pa.list_(pa.int32()))
    elif layout == "large_list":
        arr = pa.array(_ragged(rng, n, lambda: int(rng.integers(0, 1 << 20))), pa.large_list(pa.int64()))
    elif layout == "fixed_size_list":
        arr = pa.array([None if i % 5 == 0 else [int(v) for v in rng.integers(0, 9, 3)]
                        for i in range(n)], pa.list_(pa.int64(), 3))
    elif layout == "list_utf8":
        arr = pa.array(_ragged(rng, n, word), pa.list_(pa.string()))
    elif layout == "list_struct":
        arr = pa.array(_ragged(rng, n, lambda: None if rng.random() < 0.1 else {
            "x": int(rng.integers(0, 50)), "y": word()}), pa.list_(pa.struct([("x", pa.int64()),
                                                                             ("y", pa.string())])))
    elif layout == "map":
        arr = pa.array(_ragged(rng, n, lambda: (word(), None if rng.random() < 0.1 else
                                                int(rng.integers(0, 100)))), pa.map_(pa.string(), pa.int64()))
    elif layout == "struct":
        arr = _struct_rows(rng, n)
    elif layout == "list_of_list":
        arr = pa.array(_ragged(rng, n, lambda: None if rng.random() < 0.1 else [
            int(v) for v in rng.integers(0, 9, int(rng.integers(0, 3)))]), pa.list_(pa.list_(pa.int64())))
    elif layout == "list_typed_leaves":
        return pa.table({
            "f": pa.array(_ragged(rng, n, lambda: float(rng.standard_normal())), pa.list_(pa.float32())),
            "b": pa.array(_ragged(rng, n, lambda: bool(rng.random() < 0.5)), pa.list_(pa.bool_())),
            "d": pa.array(_ragged(rng, n, lambda: decimal.Decimal(int(rng.integers(-10**6, 10**6))) / 100),
                          pa.list_(pa.decimal128(12, 2))),
            "t": pa.array(_ragged(rng, n, lambda: int(rng.integers(0, 10**15))),
                          pa.list_(pa.int64())).cast(pa.list_(pa.timestamp("us"))),
        })
    else:
        raise KeyError(layout)
    return pa.table({"c": arr, "k": pa.array(np.arange(n, dtype=np.int64))})


LAYOUTS = ("list_int64", "list_int32_nullable_leaves", "large_list", "fixed_size_list",
           "list_utf8", "list_struct", "map", "struct", "list_of_list", "list_typed_leaves")


def _port_inputs(table: pa.Table):
    """The port writer's inputs for an arrow table: column-model columns
    and their fields."""
    fields = [cm.field_from_arrow(f) for f in table.schema]
    cols = {f.name: cm.from_arrow(table.column(f.name).combine_chunks()) for f in table.schema}
    return cols, fields


def _write_port(path, table, options):
    cols, fields = _port_inputs(table)
    return write_file(path, cols, schema=fields, options=options)


def _bits(a: np.ndarray) -> list:
    a = np.asarray(a)
    return a.view(f"u{a.itemsize}").tolist() if a.dtype.kind == "f" else a.tolist()


def _ones(v, n):
    return np.ones(n, bool) if v is None else np.asarray(v)


def _assert_scan_matches(got, want):
    """A port scan against the JAX scan: the same columns; offsets (int64
    in the port), stacked offsets and the validity of every level equal;
    valid leaves equal bit for bit (strings through their dictionaries)."""
    assert list(got.columns) == list(want.columns)
    for name, w in want.columns.items():
        g = got[name]
        lst = getattr(w, "offsets", None) is not None
        assert isinstance(g, DeviceListColumn) == lst, name
        if lst:
            assert g.offsets.dtype == torch.int64
            assert g.offsets.tolist() == np.asarray(w.offsets).tolist(), name
            for go, wo in zip(g.offsets_stack, w.offsets_stack, strict=True):
                assert go.dtype == torch.int64 and go.tolist() == np.asarray(wo).tolist(), name
            n_rows = [len(o) - 1 for o in w.offsets_stack]
            for gv, wv, k in zip(g.list_validities, w.list_validities, n_rows, strict=True):
                assert np.array_equal(_ones(None if gv is None else gv.numpy(), k), _ones(wv, k)), name
            valid = _ones(None if w.child_validity is None else np.asarray(w.child_validity),
                          len(w.values))
            gvalid = g.child_validity
        else:
            valid = _ones(None if w.validity is None else np.asarray(w.validity), len(w.values))
            gvalid = g.validity
        assert np.array_equal(_ones(None if gvalid is None else gvalid.numpy(), len(valid)), valid)
        wv = np.asarray(w.host_exact if w.host_exact is not None else w.values)[valid]
        gv = host_values(g)[valid]
        if w.dictionary is not None:
            words = np.array(w.dictionary.to_pylist(), dtype=object)
            assert [g.dictionary[c] for c in gv.tolist()] == [
                x.encode() if isinstance(x, str) else x for x in words[wv].tolist()], name
        else:
            assert _bits(gv) == _bits(wv), name


# ---------------------------------------------------------------------------
# schema bytes


def _f(name, t, nullable=True):
    return pa.field(name, t, nullable=nullable)


NESTED_SCHEMAS = {
    "list": pa.list_(pa.int64()),
    "list_not_null_item": pa.list_(_f("item", pa.int32(), False)),
    "large_list": pa.large_list(pa.string()),
    "fixed_size_list": pa.list_(pa.float64(), 4),
    "map": pa.map_(pa.string(), pa.int64()),
    "map_sorted": pa.map_(pa.int32(), pa.list_(pa.int8()), keys_sorted=True),
    "struct": pa.struct([("a", pa.int64()), ("b", pa.string()), ("c", pa.bool_())]),
    "list_struct": pa.list_(pa.struct([("a", pa.int64()), ("b", pa.decimal128(12, 2))])),
    "three_deep_list": pa.list_(pa.list_(pa.list_(pa.timestamp("ms", tz="UTC")))),
    "three_deep_mixed": pa.struct([_f("s", pa.list_(pa.map_(pa.string(), pa.list_(pa.date64()))),
                                      False), ("t", pa.time64("ns"))]),
}


@pytest.mark.parametrize("name", sorted(NESTED_SCHEMAS))
@pytest.mark.parametrize("nullable", [True, False])
def test_schema_bytes_of_nested_layouts(name, nullable):
    schema = pa.schema([_f("n", NESTED_SCHEMAS[name], nullable), _f("k", pa.int32())])
    fields = [cm.field_from_arrow(f) for f in schema]
    want = ref_schema.schema_to_bytes(schema)
    assert port_schema.schema_to_bytes(fields) == want
    assert port_schema.deserialize_schema(want) == fields
    assert pa.schema([cm.pa_field(f) for f in fields]).equals(schema)
    assert fields[0].n_leaves == ref_schema.n_leaf_columns(schema.field("n").type)


def test_schema_builders_name_children_as_pyarrow():
    F = port_schema.Field
    fields = [port_schema.list_of("l", F("item", "int64")),
              port_schema.map_of("m", "string", F("value", "float64"), keys_sorted=True),
              F("s", "struct", False, (F("a", "int8"), port_schema.list_of("b", F("item", "string"),
                                                                          large=True)))]
    want = pa.schema([pa.field("l", pa.list_(pa.int64())),
                      pa.field("m", pa.map_(pa.string(), pa.float64(), keys_sorted=True)),
                      pa.field("s", pa.struct([("a", pa.int8()), ("b", pa.large_list(pa.string()))]),
                               nullable=False)])
    assert port_schema.schema_to_bytes(fields) == ref_schema.schema_to_bytes(want)


# ---------------------------------------------------------------------------
# the level codec


def _level_streams():
    rng = np.random.default_rng(7)
    out = []
    for n in (0, 1, 7, 8, 9, 15, 16, 17, 23, 24, 25, 31, 33, 100, 1000, 4099):
        for w in (1, 2, 3):
            hi = (1 << w) - 1
            out += [
                (f"random_{n}_{w}", rng.integers(0, hi + 1, n), w),
                (f"constant_{n}_{w}", np.full(n, hi), w),
                (f"alternating_{n}_{w}", np.arange(n) % 2, w),
                (f"two_group_run_{n}_{w}", np.r_[np.arange(n) % 2, np.zeros(16, int), [1] * 3][:n], w),
                (f"runs_{n}_{w}", np.repeat(rng.integers(0, hi + 1, n // 11 + 1), 11)[:n], w),
            ]
    return out


@pytest.mark.parametrize("label,values,width", _level_streams()[::3])
def test_encode_levels_matches_jax(label, values, width):
    got = port_rle.encode_levels(values, width)
    assert got == ref_rle.encode_levels(values, width), label
    assert port_rle.decode_levels(got, width, len(values)).tolist() == list(values)


def test_level_codec_matches_jax_on_every_stream():
    for label, values, width in _level_streams():
        got = port_rle.encode_levels(values, width)
        assert got == ref_rle.encode_levels(values, width), label
        assert np.array_equal(port_rle.decode_levels(got, width, len(values)),
                              ref_rle.decode_levels(got, width, len(values))), label
    assert port_rle.get_bit_width(5) == ref_rle.get_bit_width(5) == 3


# ---------------------------------------------------------------------------
# files: the port's bytes == the JAX writer's


@pytest.mark.parametrize("flag_set", sorted(FLAG_SETS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_file_equals_jax_file(tmp_path, flags, layout, flag_set):
    flags(FLAG_SETS[flag_set])
    table = _table(layout, n=500, seed=hash(layout) % 1000)
    for zone_maps in (False, True):
        a, b = str(tmp_path / "jax.str"), str(tmp_path / "port.str")
        ref_write(a, table, options=RefOptions(max_page_size=128, zone_maps=zone_maps))
        metas = _write_port(b, table, WriteOptions(max_page_size=128, zone_maps=zone_maps))
        assert open(a, "rb").read() == open(b, "rb").read(), (layout, zone_maps)
    assert len(metas) == sum(ref_schema.n_leaf_columns(f.type) for f in table.schema)
    back = ref_read(b)
    for c in table.column_names:
        assert back.column(c).combine_chunks().equals(table.column(c).combine_chunks()), c


def test_nested_page_prelude_layout(tmp_path):
    """Mirror of tests/test_golden.py:410: a nested page is [u32 rows]
    [u32 rep_len][u32 def_len][rep][def][leaf page], the levels Dremel's."""
    from strawboat_tpu_torch.read.reader import read_meta

    path = str(tmp_path / "l.str")
    F = port_schema.Field
    col = cm.ListColumn("list", None, np.array([0, 2, 2, 3], np.int32),
                        cm.PrimitiveColumn("int64", None, np.array([1, 2, 3], np.int64)))
    write_file(path, {"l": col}, schema=[port_schema.list_of("l", F("item", "int64"))])
    raw = open(path, "rb").read()
    with open(path, "rb") as f:
        metas = read_meta(f)
    page = raw[metas[0].offset : metas[0].offset + metas[0].pages[0].length]
    assert metas[0].pages[0].num_values == 4  # level records, not rows
    rep, deff = bytes([3, 0b00000010]), bytes([3, 0b11011111, 0x00])
    prelude = (np.array([3, len(rep), len(deff)], "<u4").tobytes() + rep + deff)
    assert page[: len(prelude)] == prelude
    ref_path = str(tmp_path / "ref.str")
    ref_write(ref_path, pa.table({"l": pa.array([[1, 2], [], [3]], pa.list_(pa.int64()))}),
              options=RefOptions())
    assert open(ref_path, "rb").read() == raw


# ---------------------------------------------------------------------------
# scans of JAX-written files


CODECS = {
    "lz4": dict(default_compression=RefCompression.LZ4),
    "none": {},
    "chooser": dict(default_compress_ratio=1.0, sample_seed=3),
}


@pytest.mark.parametrize("codec", sorted(CODECS) + ["dict", "dict_bitpack"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_scan_of_jax_file(tmp_path, flags, layout, codec):
    if codec in FLAG_SETS:
        flags(FLAG_SETS[codec])
    table = _table(layout, n=700, seed=3)
    path = str(tmp_path / "x.str")
    ref_write(path, table, options=RefOptions(max_page_size=128, **CODECS.get(codec, {})))
    got = scan_file(path, "cpu")
    try:
        want = ref_scan(path)
    except RefNotYet:  # the JAX scan has no device layout for bool leaves
        want = None
    if want is not None:
        _assert_scan_matches(got, want)
    assert got.num_rows == 700
    back = got.to_arrow()
    # lists of structs and maps come back as lists of their leaves, as in
    # the reference; the other layouts come back as written
    for c in set(table.column_names) & set(back.column_names):
        assert back.column(c).combine_chunks().equals(table.column(c).combine_chunks()), c
    if want is not None:
        assert back.equals(want.to_arrow())


def _lz4(path, table, page=256):
    ref_write(path, table, options=RefOptions(default_compression=RefCompression.LZ4,
                                              max_page_size=page))
    return path


def _ragged_nd(rng, n, inner):
    return [inner(int(rng.integers(0, 5))) for _ in range(n)]


def test_nested_device_list_of_list_int(tmp_path):
    """Mirror of tests/test_nested_device.py (7 tests, these and below):
    stacked offsets reach the device and to_arrow rebuilds the array."""
    rng = np.random.default_rng(0)
    data = _ragged_nd(rng, 800, lambda k: [[int(x) for x in rng.integers(0, 100, int(rng.integers(0, 4)))]
                                           for _ in range(k)])
    path = _lz4(str(tmp_path / "ll.str"), pa.table({"ll": pa.array(data, pa.list_(pa.list_(pa.int64())))}))
    dt = scan_file(path, "cpu")
    assert len(dt["ll"].offsets_stack) == 2
    assert dt.to_arrow().column("ll").to_pylist() == data


def test_nested_device_list_of_list_composed_segment_sum(tmp_path):
    data = [[[1, 2], [3]], [], [[4, 5, 6]], [[], [7]]]
    path = _lz4(str(tmp_path / "ll2.str"), pa.table({"ll": pa.array(data, pa.list_(pa.list_(pa.int64())))}))
    c = scan_file(path, "cpu")["ll"]
    assert list_segment_sum(c.values, c.offsets, len(c)).tolist() == [6, 0, 15, 7]


def test_nested_device_list_of_struct(tmp_path):
    rng = np.random.default_rng(1)
    data = _ragged_nd(rng, 600, lambda k: [{"a": int(rng.integers(0, 50)), "b": float(rng.random())}
                                           for _ in range(k)])
    typ = pa.list_(pa.struct([("a", pa.int64()), ("b", pa.float64())]))
    path = _lz4(str(tmp_path / "ls.str"), pa.table({"ls": pa.array(data, typ)}))
    dt = scan_file(path, "cpu")
    ca, cb = dt["ls.a"], dt["ls.b"]
    assert torch.equal(ca.offsets, cb.offsets)
    assert ca.values.tolist() == [d["a"] for row in data for d in row]
    assert cb.values.tolist() == [d["b"] for row in data for d in row]  # exact float64
    sums = list_segment_sum(ca.values, ca.offsets, len(ca))
    assert sums.tolist() == [sum(d["a"] for d in row) for row in data]


def test_nested_device_map_column(tmp_path):
    rng = np.random.default_rng(2)
    data = _ragged_nd(rng, 400, lambda k: [(int(i), float(rng.random())) for i in range(k)])
    path = _lz4(str(tmp_path / "m.str"), pa.table({"m": pa.array(data, pa.map_(pa.int64(), pa.float64()))}))
    dt = scan_file(path, "cpu")
    ck, cv = dt["m.key"], dt["m.value"]
    assert ck.values.tolist() == [k for row in data for (k, _v) in row]
    assert cv.values.tolist() == [v for row in data for (_k, v) in row]
    assert torch.equal(ck.offsets, cv.offsets)


def test_nested_device_fixed_size_list(tmp_path):
    rng = np.random.default_rng(3)
    n = 300
    data = [[int(x) for x in rng.integers(0, 9, 3)] for _ in range(n)]
    path = _lz4(str(tmp_path / "f.str"), pa.table({"f": pa.array(data, pa.list_(pa.int64(), 3))}))
    c = scan_file(path, "cpu")["f"]
    assert c.values.reshape(n, 3).tolist() == data
    assert c.offsets.tolist() == (np.arange(n + 1) * 3).tolist()


def test_nested_device_list_of_string_dict_codes(tmp_path):
    rng = np.random.default_rng(4)
    words = ["ab", "cd", "ef", "gh"]
    data = _ragged_nd(rng, 500, lambda k: [words[int(rng.integers(0, 4))] for _ in range(k)])
    path = _lz4(str(tmp_path / "lstr.str"), pa.table({"ls": pa.array(data, pa.list_(pa.string()))}))
    dt = scan_file(path, "cpu")
    assert dt["ls"].dictionary is not None
    assert dt.to_arrow().column("ls").to_pylist() == data


def test_nested_device_nullable_list_of_list_roundtrip(tmp_path):
    data = [[[1, None], None, [2]], None, [], [[], [None, 3]]]
    path = _lz4(str(tmp_path / "lln.str"), pa.table({"ll": pa.array(data, pa.list_(pa.list_(pa.int64())))}))
    assert scan_file(path, "cpu").to_arrow().column("ll").to_pylist() == data


def test_nested_column_device_scan(tmp_path):
    """Mirror of tests/test_exec.py:178: a list column and a struct column."""
    n = 2000
    table = pa.table({
        "l": pa.array([[i, i + 1] if i % 3 else None for i in range(n)], pa.list_(pa.int64())),
        "s": pa.array([{"a": i, "b": float(i) * 0.5} for i in range(n)],
                      pa.struct([("a", pa.int64()), ("b", pa.float64())])),
    })
    path = str(tmp_path / "n.str")
    ref_write(path, table, options=RefOptions(max_page_size=512))
    dt = scan_file(path, "cpu")
    assert isinstance(dt["l"], DeviceListColumn)
    flat = [v for i in range(n) if i % 3 for v in (i, i + 1)]
    assert dt["l"].values.tolist() == flat
    assert dt["l"].validity.tolist() == [bool(i % 3) for i in range(n)]
    assert dt["s.a"].values.tolist() == list(range(n))
    assert dt["s.b"].values.tolist() == [i * 0.5 for i in range(n)]
    assert dt.num_rows == n
    _assert_scan_matches(dt, ref_scan(path))


def test_list_segment_sum(tmp_path):
    """Mirror of tests/test_exec.py:331, against the JAX function too."""
    n = 500
    data = [[i, i + 1, i + 2] if i % 4 else ([] if i % 2 else None) for i in range(n)]
    path = str(tmp_path / "ls.str")
    ref_write(path, pa.table({"l": pa.array(data, pa.list_(pa.int64()))}), options=RefOptions())
    lc = scan_file(path, "cpu")["l"]
    sums = list_segment_sum(lc.values, lc.offsets, len(lc))
    assert sums.tolist() == [sum(x) if x else 0 for x in (d or [] for d in data)]
    rc = ref_scan(path)["l"]
    assert sums.tolist() == np.asarray(ref_list_sum(rc.values, rc.offsets, len(rc))).tolist()
    f = torch.tensor(np.random.default_rng(0).standard_normal(40))
    offs = torch.tensor([0, 3, 3, 10, 40])
    np.testing.assert_allclose(list_segment_sum(f, offs, 5).numpy(),
                               np.asarray(ref_list_sum(f.numpy(), offs.numpy(), 5)), rtol=1e-12)


def _io_roundtrip(tmp_path, table, page=2048, compression=RefCompression.LZ4):
    """The JAX writer's file scanned by the port, and the port's file read
    by the JAX reader, both equal to the table."""
    a, b = str(tmp_path / "a.str"), str(tmp_path / "b.str")
    ref_write(a, table, options=RefOptions(default_compression=compression, max_page_size=page))
    back = scan_file(a, "cpu").to_arrow()
    for c in table.column_names:
        assert back.column(c).combine_chunks().equals(table.column(c).combine_chunks()), c
    _write_port(b, table, WriteOptions(max_page_size=page))
    got = ref_read(b)
    for c in table.column_names:
        assert got.column(c).combine_chunks().equals(table.column(c).combine_chunks()), c


def _nested_io_table(size):
    r = np.random.default_rng(42)
    return pa.table({
        "l": pa.array([[int(x) for x in r.integers(0, 100, int(r.integers(0, 6)))]
                       if r.random() > 0.1 else None for _ in range(size)], pa.list_(pa.int64())),
        "ls": pa.array([[f"s{int(x)}" for x in r.integers(0, 20, int(r.integers(0, 4)))]
                        for _ in range(size)], pa.list_(pa.string())),
    })


@pytest.mark.parametrize("compression", [RefCompression.LZ4, RefCompression.ZSTD, RefCompression.NONE])
def test_nested(tmp_path, compression):
    """Mirror of tests/test_io.py:178."""
    _io_roundtrip(tmp_path, _nested_io_table(2048 + 77), compression=compression)


def test_nested_multi_page(tmp_path):
    """Mirror of tests/test_io.py:182."""
    _io_roundtrip(tmp_path, _nested_io_table(2048 * 3 + 5))


def test_page_slicing_offsets(tmp_path):
    """Mirror of tests/test_io.py:186: page edges cut through list runs."""
    r = np.random.default_rng(42)
    size = 2048 * 2 + 333
    table = pa.table({"l": pa.array(
        [[int(x) for x in r.integers(0, 1000, int(r.integers(0, 9)))] if r.random() > 0.15 else None
         for _ in range(size)], pa.list_(pa.int64()))})
    _io_roundtrip(tmp_path, table, compression=RefCompression.ZSTD)


def test_fixed_size_list(tmp_path):
    """Mirror of tests/test_io.py:211: null rows drop and regain their slots."""
    size = 2048 + 3
    table = pa.table({"fsl": pa.array([[i, i + 1] if i % 4 else None for i in range(size)],
                                      pa.list_(pa.int32(), 2))})
    _io_roundtrip(tmp_path, table)
    dt = scan_file(str(tmp_path / "a.str"), "cpu")
    c = dt["fsl"]
    assert c.offsets.tolist() == (np.arange(size + 1) * 2).tolist()
    valid = c.child_validity.numpy()
    assert valid.tolist() == [bool(i // 2 % 4) for i in range(2 * size)]
    assert c.values.numpy()[~valid].tolist() == [0] * int((~valid).sum())


def test_list_f64_leaf_keeps_exact_bytes(tmp_path):
    """Mirror of tests/test_f64_exact.py:77: float64 leaves are exact on
    the device (the port keeps no host copy)."""
    rng = np.random.default_rng(3)
    data = [[float(x) for x in rng.random(int(rng.integers(0, 4)))] for _ in range(500)]
    path = _lz4(str(tmp_path / "lf.str"), pa.table({"lf": pa.array(data, pa.list_(pa.float64()))}), 2048)
    dt = scan_file(path, "cpu")
    assert dt["lf"].values.dtype == torch.float64 and not hasattr(dt["lf"], "host_exact")
    assert dt.to_arrow().column("lf").to_pylist() == data


def test_scan_chunks_carries_nested_columns(tmp_path):
    """Mirror of tests/test_correctness_r3.py:166."""
    n = 64
    lists = [list(range(i % 4)) for i in range(n)]
    path = _lz4(str(tmp_path / "nested.str"),
                pa.table({"x": pa.array(np.arange(n, dtype=np.int64)),
                          "l": pa.array(lists, pa.list_(pa.int64()))}), 16)
    got_rows, leaves, sums = 0, [], []
    for chunk in scan_chunks(path, 2, "cpu"):
        assert "l" in chunk.columns and "x" in chunk.columns
        assert chunk.num_rows == len(chunk["x"]) == len(chunk["l"])
        got_rows += len(chunk["x"])
        leaves.append(chunk["l"].values.numpy())
        sums.append(list_segment_sum(chunk["l"].values, chunk["l"].offsets, len(chunk["l"])))
    assert got_rows == n
    np.testing.assert_array_equal(np.concatenate(leaves),
                                  np.concatenate([np.asarray(x, np.int64) for x in lists if x]))
    assert torch.cat(sums).tolist() == [sum(x) for x in lists]


def test_scan_file_pruned_nested_stays_row_aligned(tmp_path):
    """Mirror of tests/test_correctness_r3.py:196: pruning drops the same
    pages of every column, nested ones included."""
    n = 64
    path = str(tmp_path / "nested_pruned.str")
    ref_write(path, pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                              "l": pa.array([[i, i] for i in range(n)], pa.list_(pa.int64()))}),
              options=RefOptions(default_compression=RefCompression.LZ4, max_page_size=16,
                                 zone_maps=True))
    dt = scan_file(path, "cpu", predicates=[Comparison("k", "ge", 32)])
    k = dt["k"].values.numpy()
    assert len(k) == 32 and dt.num_rows == 32
    lcol = dt["l"]
    assert len(lcol.offsets) - 1 == len(k)
    np.testing.assert_array_equal(lcol.values.numpy().reshape(-1, 2)[:, 0], k)
    from strawboat_tpu.exec.pruning import Comparison as RefComparison

    _assert_scan_matches(dt, ref_scan(path, predicates=[RefComparison("k", "ge", 32)]))


# ---------------------------------------------------------------------------
# int64 offsets (the reference casts composed offsets to int32)


def test_offsets_beyond_int32_stay_int64():
    """Offsets an int32 array cannot hold, without 2^31 elements: pages
    whose levels rebase past 2^31, and a composition through them."""
    from strawboat_tpu_torch.read.levels import LIST, PRIMITIVE, InitNested, NestedLevel

    big = 2**31 - 3
    page = lambda k: [NestedLevel(LIST, True, 2, None, np.array([0, big, k], np.int64)),  # noqa: E731
                      NestedLevel(PRIMITIVE, True, k, None, None)]
    init = [InitNested(LIST, True), InitNested(PRIMITIVE, True)]
    levels = port_scan._concat_levels([page(big + 1), page(big + 7)], init)
    assert levels[0].offsets.dtype == np.int64
    assert levels[0].offsets.tolist() == [0, big, big + 1, 2 * big + 1, 2 * big + 8]
    outer = np.array([0, 2, 4], np.int64)
    comp = port_scan._compose_offsets([outer, levels[0].offsets])
    assert comp.dtype == np.int64 and comp.tolist() == [0, big + 1, 2 * big + 8]
    assert comp.astype(np.int32).tolist() != comp.tolist()  # what an int32 cast loses
