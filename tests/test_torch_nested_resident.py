"""Nested resident columns of the torch port against the JAX package:
``load_resident`` of list, map and struct columns (planes word for word),
``list_sum`` through K1 (the JAX side runs its Pallas kernel interpreted),
``to_arrow``, the ``pa.Table``, column-model and ``DeviceTable`` fronts of
``make_resident``, and the nested round-trip fuzz."""

import importlib
from unittest import mock

import numpy as np
import pyarrow as pa
import pytest
import torch

from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu_torch import columns as cm
from strawboat_tpu_torch.errors import NotYetImplementedError, OutOfSpecError
from strawboat_tpu_torch.exec import resident as port
from strawboat_tpu_torch.exec.scan import scan_file
from strawboat_tpu_torch.schema import Field, list_of

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


def _words(t) -> np.ndarray:
    return np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t).view(np.uint32)


def _assert_same_column(got, want, path):
    """Port and reference resident columns, planes word for word, children
    and struct members included."""
    assert got.kind == want.kind, path
    assert [b for _w, b in got.planes] == [b for _w, b in want.planes], path
    for (w, _b), (rw, _rb) in zip(got.planes, want.planes):
        assert np.array_equal(_words(w), _words(rw)), path
    assert (got.offset, got.bit_shift, got.wide, got.length, tuple(got.shifts)) == (
        want.offset, want.bit_shift, bool(want.wide), want.length, tuple(want.shifts)), path
    assert got.is_dict == (want.dictionary_host is not None), path
    if got.is_dict:
        assert list(got.dictionary_host) == list(want.dictionary_host), path
    assert (got.validity_plane is None) == (want.validity_plane is None), path
    if got.validity_plane is not None:
        assert np.array_equal(_words(got.validity_plane), _words(want.validity_plane)), path
    assert (got.child is None) == (want.child is None), path
    if want.child is not None:
        _assert_same_column(got.child, want.child, path + ".child")
    assert (got.children is None) == (want.children is None), path
    if want.children is not None:
        assert list(got.children) == list(want.children), path
        for k in want.children:
            _assert_same_column(got.children[k], want.children[k], f"{path}.{k}")


def _assert_same_table(got, want):
    assert list(got.columns) == list(want.columns)
    assert got.num_rows == want.num_rows
    for k in want.columns:
        _assert_same_column(got.columns[k], want.columns[k], k)
    assert sorted(got.struct_specs or {}) == sorted(want.struct_specs or {})
    for k, (names, vplane, _t) in (want.struct_specs or {}).items():
        g_names, g_vplane, _gt = got.struct_specs[k]
        assert list(g_names) == list(names)
        assert (g_vplane is None) == (vplane is None)
        if vplane is not None:
            assert np.array_equal(_words(g_vplane), _words(vplane))


def _float_bits_equal(exp, got) -> bool:
    ok_e, ok_g = ~np.asarray(exp.is_null()), ~np.asarray(got.is_null())
    if not np.array_equal(ok_e, ok_g):
        return False
    udt = np.uint32 if exp.type.bit_width == 32 else np.uint64
    npdt = np.float32 if exp.type.bit_width == 32 else np.float64

    def bits(a):
        return np.frombuffer(a.buffers()[1], npdt, len(a) + a.offset)[a.offset:].view(udt)

    return np.array_equal(bits(exp)[ok_e], bits(got)[ok_g])


def _roundtrip(tmp_path, table: pa.Table, name="rt.str", page=512):
    """Mirror of the JAX ``_roundtrip`` (tests/test_resident.py:147): the
    JAX writer's LZ4 file, loaded resident by both packages — planes word
    for word — and the port's table back to arrow equal to the input."""
    from strawboat_tpu.exec.resident import load_resident as ref_load

    p = str(tmp_path / name)
    ref_write(p, table, options=RefOptions(default_compression=RefCompression.LZ4,
                                           max_page_size=page))
    rt = port.load_resident(p, "cpu", tile=TILE)
    ref = ref_load(p, tile=TILE)
    _assert_same_table(rt, ref)
    back = rt.to_arrow()
    assert back.num_rows == table.num_rows
    for f in table.schema:
        exp = table.column(f.name).combine_chunks()
        got = back.column(f.name).combine_chunks()
        if got.type != exp.type:
            got = got.cast(exp.type)
        if pa.types.is_floating(exp.type):
            assert _float_bits_equal(exp, got), f.name
        else:
            assert got.equals(exp), f.name
    return rt, ref


def _assert_list_sum_equal(rt, ref, name):
    got = rt.list_sum(name)
    want = np.asarray(ref.list_sum(name))
    if got.is_floating_point():
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    else:
        assert got.tolist() == want.astype(np.int64).tolist()
    return got


def test_resident_map_and_list_struct(tmp_path):
    """Mirror of tests/test_resident.py:466."""
    mt = pa.map_(pa.string(), pa.int64())
    lt = pa.list_(pa.struct([("x", pa.int64()), ("y", pa.string())]))
    maps = [[("a", 1)], None, [("b", 2), ("c", 3)], [], [("d", 4)]] * 60
    lists = [[{"x": 1, "y": "p"}], [], [{"x": 2, "y": "q"}, {"x": 3, "y": "r"}], None] * 75
    t = pa.table({"m": pa.array(maps, mt), "ls": pa.array(lists, lt)})
    rt, _ref = _roundtrip(tmp_path, t, "maplist.str")
    assert rt["m"].child.kind == "struct" and list(rt["m"].child.children) == ["key", "value"]
    with pytest.raises(NotYetImplementedError, match="list<struct>"):
        rt.list_sum("ls")


def test_resident_list_int_roundtrip_and_sum(tmp_path):
    """Mirror of tests/test_resident.py:1128."""
    rng = np.random.default_rng(21)
    n = 700
    lists = [list(map(int, rng.integers(-50, 1000, k))) for k in rng.integers(0, 6, n)]
    t = pa.table({"l": pa.array(lists, pa.list_(pa.int64()))},
                 schema=pa.schema([pa.field("l", pa.list_(pa.int64()), nullable=False)]))
    rt, ref = _roundtrip(tmp_path, t, "listint.str")
    sums = _assert_list_sum_equal(rt, ref, "l")
    assert sums.tolist() == [sum(x) for x in lists]


def test_resident_list_utf8_roundtrip(tmp_path):
    """Mirror of tests/test_resident.py:1145."""
    rng = np.random.default_rng(22)
    words = ["alpha", "bb", "", "cc", "dddd"]
    lists = [[words[int(i)] for i in rng.integers(0, len(words), int(k))]
             for k in rng.integers(0, 4, 500)]
    t = pa.table({"ls": pa.array(lists, pa.list_(pa.string()))},
                 schema=pa.schema([pa.field("ls", pa.list_(pa.string()), nullable=False)]))
    rt, _ref = _roundtrip(tmp_path, t, "listutf8.str")
    with pytest.raises(NotYetImplementedError, match="list<str>"):
        rt.list_sum("ls")


def test_resident_list_nullable_rows_and_leaves(tmp_path):
    """Mirror of tests/test_resident.py:1162: null rows and null leaves
    survive; list_sum counts both as 0."""
    rng = np.random.default_rng(23)
    lists = []
    for _ in range(400):
        if rng.random() < 0.2:
            lists.append(None)
        else:
            lists.append([None if rng.random() < 0.3 else round(float(v), 2)
                          for v in rng.uniform(-10, 10, int(rng.integers(0, 5)))])
    t = pa.table({"lf": pa.array(lists, pa.list_(pa.float64()))})
    rt, ref = _roundtrip(tmp_path, t, "listnull.str")
    sums = _assert_list_sum_equal(rt, ref, "lf")
    exp = [0.0 if x is None else sum(v for v in x if v is not None) for x in lists]
    np.testing.assert_allclose(sums.numpy(), exp, rtol=1e-12)


def test_resident_list_of_list(tmp_path):
    """Mirror of tests/test_resident.py:1195."""
    lists = [[[1, 2], [3]], [], [[4], [], [5, 6, 7]], [[8]]] * 60
    t = pa.table({"ll": pa.array(lists, pa.list_(pa.list_(pa.int64())))},
                 schema=pa.schema([pa.field("ll", pa.list_(pa.list_(pa.int64())), nullable=False)]))
    rt, _ref = _roundtrip(tmp_path, t, "listlist.str")
    assert rt["ll"].child.kind == "list"


def test_resident_struct_roundtrip_and_query(tmp_path):
    """Mirror of tests/test_resident.py:1223: a struct unnests to
    ``parent.field`` columns; queries run over them."""
    from strawboat_tpu_torch.exec import Query, col

    rng = np.random.default_rng(31)
    n = 900
    a = rng.integers(0, 1000, n)
    b = np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)]
    c = np.round(rng.uniform(-5, 5, n), 2)
    st = pa.struct([pa.field("a", pa.int64()), pa.field("b", pa.string()), pa.field("c", pa.float64())])
    nulls = rng.random(n) < 0.15
    arr = pa.StructArray.from_arrays([pa.array(a), pa.array(b), pa.array(c)], fields=list(st),
                                     mask=pa.array(nulls))
    t = pa.table({"s": arr, "k": pa.array(rng.integers(0, 5, n))},
                 schema=pa.schema([pa.field("s", st), pa.field("k", pa.int64(), nullable=False)]))
    rt, _ref = _roundtrip(tmp_path, t, "struct.str")
    assert "s.a" in rt.columns and "s.b" in rt.columns
    got = int(rt.filter_sum({"s.a": (200, 800)}, value="s.a"))
    assert got == int(a[(a >= 200) & (a < 800) & ~nulls].sum())
    res = Query(rt).filter(col("s.b") == "yy").agg(n=("count", "s.a")).run()
    assert int(res["n"]) == int(((b == "yy") & ~nulls).sum())


def test_resident_struct_nested_struct(tmp_path):
    """Mirror of tests/test_resident.py:1272."""
    inner = pa.struct([pa.field("x", pa.int64())])
    outer = pa.struct([pa.field("i", inner), pa.field("y", pa.int64())])
    t = pa.table({"o": pa.array([{"i": {"x": v}, "y": v * 2} for v in range(400)], outer)},
                 schema=pa.schema([pa.field("o", outer, nullable=False)]))
    rt, _ref = _roundtrip(tmp_path, t, "structnest.str")
    assert "o.i.x" in rt.columns
    assert int(rt.filter_sum({}, value="o.i.x")) == sum(range(400))


def test_make_resident_device_list_falls_back_to_host(tmp_path):
    """Mirror of tests/test_resident.py:1286: a DeviceTable with a list
    column encodes on the host, as the reference's (planes equal)."""
    from strawboat_tpu.exec.resident import make_resident as ref_make
    from strawboat_tpu.exec.scan import scan_file as ref_scan

    lists = [[1, 2], [], [3, 4, 5], [6]] * 100
    t = pa.table({"l": pa.array(lists, pa.list_(pa.int64())), "v": pa.array(np.arange(400))},
                 schema=pa.schema([pa.field("l", pa.list_(pa.int64()), nullable=False),
                                   pa.field("v", pa.int64(), nullable=False)]))
    p = str(tmp_path / "devlist.str")
    ref_write(p, t, options=RefOptions(max_page_size=128))
    with mock.patch.object(port.DeviceTable, "to_arrow",
                           side_effect=AssertionError("encodes from the columns' arrays")):
        rt = port.make_resident(scan_file(p, "cpu"), "cpu", tile=TILE)
    ref = ref_make(ref_scan(p), tile=TILE)
    _assert_same_table(rt, ref)
    assert _assert_list_sum_equal(rt, ref, "l").tolist() == [sum(x) for x in lists]
    assert int(rt.filter_sum({}, value="v")) == int(np.arange(400).sum())


def test_resident_struct_to_arrow_selection(tmp_path):
    """Mirror of tests/test_resident.py:1343."""
    st = pa.struct([pa.field("a", pa.int64()), pa.field("b", pa.string())])
    t = pa.table({"s": pa.array([{"a": i, "b": f"s{i % 3}"} for i in range(300)], st),
                  "v": pa.array(np.arange(300, dtype=np.int64))},
                 schema=pa.schema([pa.field("s", st, nullable=False),
                                   pa.field("v", pa.int64(), nullable=False)]))
    rt, _ref = _roundtrip(tmp_path, t, "structsel.str")
    just_s = rt.to_arrow(columns=["s"])
    assert just_s.schema.names == ["s"]
    assert just_s.column("s").combine_chunks().equals(t.column("s").combine_chunks())
    assert np.array_equal(np.asarray(rt.to_arrow(columns=["s.a"]).column("s.a")), np.arange(300))


# ---------------------------------------------------------------------------
# fronts and layouts the reference does not load


def _lineitems(n_orders=300, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 8, n_orders)
    offsets = np.zeros(n_orders + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    m = int(offsets[-1])
    qty = rng.integers(1, 51, m)
    price = qty * rng.integers(900, 1100, m)
    flag = np.array(["A", "N", "R"])[rng.integers(0, 3, m)]
    return offsets, qty, price, flag


def _order_fields():
    item = Field("item", "struct", True, (Field("l_quantity", "int64"),
                                         Field("l_extendedprice", "int64"),
                                         Field("l_returnflag", "string")))
    return [Field("o_orderkey", "int64"), list_of("o_lineitems", item),
            list_of("o_lineprices", Field("item", "int64"))]


def _order_columns(offsets, qty, price, flag):
    from strawboat_tpu_torch.write.writer import _binary_column

    b = _binary_column(flag, None)
    n = len(offsets) - 1
    items = cm.StructColumn("struct", None, [
        cm.PrimitiveColumn("int64", None, qty), cm.PrimitiveColumn("int64", None, price),
        cm.BinaryColumn("string", None, b.offsets, b.values)], len(qty))
    return {"o_orderkey": np.arange(n, dtype=np.int64),
            "o_lineitems": cm.ListColumn("list", None, offsets, items),
            "o_lineprices": cm.ListColumn("list", None, offsets,
                                          cm.PrimitiveColumn("int64", None, price))}


@pytest.mark.parametrize("front", ["columns", "pa_table", "file", "device_table"])
def test_list_sum_of_orders_lineitems_every_front(tmp_path, front):
    """Orders with their lineitems nested (the chip phase's layout, small):
    list_sum equal to numpy from every front; planes equal across the
    column-model, pa.Table and file fronts."""
    offsets, qty, price, flag = _lineitems()
    cols, fields = _order_columns(offsets, qty, price, flag), _order_fields()
    path = str(tmp_path / "orders.str")
    from strawboat_tpu_torch.codecs import WriteOptions
    from strawboat_tpu_torch.write import write_file

    write_file(path, cols, schema=fields, options=WriteOptions(max_page_size=64))
    if front == "columns":
        rt = port.make_resident(cols, "cpu", tile=TILE, schema=fields)
    elif front == "pa_table":
        rt = port.make_resident(pa.table({f.name: cm.to_arrow(
            cm.PrimitiveColumn("int64", None, cols[f.name]) if f.name == "o_orderkey" else cols[f.name], f)
            for f in fields}), "cpu", tile=TILE)
    elif front == "file":
        rt = port.load_resident(path, "cpu", tile=TILE)
    else:
        rt = port.make_resident(scan_file(path, "cpu"), "cpu", tile=TILE)
    want = np.add.reduceat(price, offsets[:-1])
    assert rt.list_sum("o_lineprices").tolist() == want.tolist()
    if front == "device_table":  # flattened as the scan names them
        assert rt.list_sum("o_lineitems.l_extendedprice").tolist() == want.tolist()
        return
    assert "o_lineitems" in rt.columns and rt["o_lineitems"].child.kind == "struct"
    item = rt["o_lineitems"].child.children
    assert rt._natural(item["l_quantity"]).tolist() == qty.tolist()
    codes = rt._natural(item["l_returnflag"]).numpy()
    assert item["l_returnflag"].dictionary_host[codes].tolist() == flag.tolist()
    if front != "columns":
        _assert_same_table(rt, port.make_resident(cols, "cpu", tile=TILE, schema=fields))


def test_fixed_size_list_and_large_list_load(tmp_path):
    """Fixed-size lists (which the reference's loaders refuse) keep every
    row's slots; large lists load as lists; both round-trip and sum."""
    n = 500
    fsl = [None if i % 7 == 0 else [i, -i, 2 * i] for i in range(n)]
    large = [list(range(i % 5)) if i % 9 else None for i in range(n)]
    t = pa.table({"f": pa.array(fsl, pa.list_(pa.int64(), 3)),
                  "g": pa.array(large, pa.large_list(pa.int32()))})
    p = str(tmp_path / "fsl.str")
    ref_write(p, t, options=RefOptions(max_page_size=64))
    for rt in (port.load_resident(p, "cpu", tile=TILE), port.make_resident(t, "cpu", tile=TILE)):
        back = rt.to_arrow()
        assert back.column("f").combine_chunks().equals(t.column("f").combine_chunks())
        assert back.column("g").combine_chunks().equals(t.column("g").combine_chunks())
        assert rt.list_sum("f").tolist() == [0 if x is None else sum(x) for x in fsl]
        assert rt.list_sum("g").tolist() == [0 if x is None else sum(x) for x in large]


def test_list_sum_offsets_are_int64(monkeypatch):
    """list_sum builds int64 offsets (the reference's cumsum is int32)."""
    seen = []
    inner = port.list_segment_sum
    monkeypatch.setattr(port, "list_segment_sum",
                        lambda v, o, n: seen.append(o.dtype) or inner(v, o, n))
    rt = port.make_resident(pa.table({"l": pa.array([[1, 2], None, [3]])}), "cpu", tile=TILE)
    assert rt.list_sum("l").tolist() == [3, 0, 3]
    assert seen == [torch.int64]


def test_nested_from_reference_and_refusals(tmp_path):
    """from_reference takes list and struct columns; list_sum and the
    column-model front refuse what they cannot do."""
    from strawboat_tpu.exec.resident import make_resident as ref_make

    t = pa.table({"l": pa.array([[1.5, 2.0], [], None], pa.list_(pa.float64())),
                  "s": pa.array([{"a": 1}, None, {"a": 3}], pa.struct([("a", pa.int32())]))})
    ref = ref_make(t, tile=TILE)
    rt = port.ResidentTable.from_reference(ref, "cpu")
    _assert_same_table(rt, ref)
    assert rt.list_sum("l").tolist() == [3.5, 0.0, 0.0]
    assert rt.to_arrow().equals(ref.to_arrow())
    with pytest.raises(OutOfSpecError):
        rt.list_sum("s.a")
    with pytest.raises(OutOfSpecError):
        port.make_resident({"l": cm.ListColumn("list", None, np.array([0, 1], np.int32),
                                               cm.PrimitiveColumn("int64", None, np.ones(1, np.int64)))},
                           "cpu", tile=TILE)


# ---------------------------------------------------------------------------
# the nested fuzz (tests/test_fuzz_nested.py, 6 seeds)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_nested_fuzz_roundtrip(tmp_path, seed):
    """Random schemas mixing list / struct / map (depth <= 2) over every
    flat kind (NaN / inf / -0.0 doubles, decimals, timestamps), random page
    sizes and nulls at every level: the port's scan and resident table
    round-trip the JAX writer's file, with the planes of the JAX loader."""
    from strawboat_tpu.exec.resident import load_resident as ref_load
    from test_fuzz_nested import _cols_equal, _rand_col

    rng = np.random.default_rng(9000 + seed)
    n = int(rng.integers(200, 3000))
    cols, fields = {}, []
    for ci in range(int(rng.integers(1, 5))):
        t, g = _rand_col(rng)
        arr = g(n)
        if not pa.types.is_nested(t) and rng.random() < 0.4:
            arr = pa.array(arr.to_pylist(), t, mask=rng.random(n) < 0.2)
        fields.append(pa.field(f"c{ci}", t))
        cols[f"c{ci}"] = arr
    table = pa.table(cols, schema=pa.schema(fields))
    p = str(tmp_path / "nf.str")
    ref_write(p, table, options=RefOptions(max_page_size=int(rng.choice([128, 512, 65536]))))
    rt = port.load_resident(p, "cpu", tile=TILE)
    rb = rt.to_arrow()
    for f in table.schema:
        assert _cols_equal(table.column(f.name).combine_chunks(),
                           rb.column(f.name).combine_chunks()), f"resident {f.name} seed {seed}"
    try:
        ref = ref_load(p, tile=TILE)
    except Exception:  # the reference's loader refuses some layouts (date64 and friends)
        ref = None
    if ref is not None:
        _assert_same_table(rt, ref)
    scan_file(p, "cpu")  # every layout scans
