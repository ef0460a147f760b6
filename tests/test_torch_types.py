"""Float, bool and decimal columns of the torch port against the JAX package.

The port writes float16 / float32 / float64, bool and decimal128 /
decimal256 columns with pyarrow's schema bytes and the JAX writer's page
bytes (no flag, DICT, DICT with bit-packed codes, PATAS, zone maps).  Over
files of the JAX writer under every codec it emits for these types (raw
NONE / LZ4 / Zstd, RLE, DICT with bit-packed and delta-coded index
subpages, FREQ, ONE_VALUE, PATAS) the port's scan gives the JAX scan's
values bit for bit (NaN payloads, -0.0 and ±inf included) and its
validity; pruned scans and ``scan_chunks`` too.  Filters and aggregates
over float and decimal columns equal the JAX ``Query`` (exact; float sums
to rtol 1e-12), and the resident loaders give the JAX planes word for
word, except the null slots of a device-direct f64 encode, which the port
fills (a divergence pinned here).  The last tests mirror
``tests/test_f64_exact.py`` and ``tests/test_decimal.py``.  Everything runs
on the CPU: K3 and K1 through their plain versions, the reference's Pallas
kernels interpreted.
"""

import decimal
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
from strawboat_tpu.errors import NotYetImplementedError as RefNotYetImplemented
from strawboat_tpu.exec import pruning as ref_pruning
from strawboat_tpu.exec.scan import scan_chunks as ref_scan_chunks
from strawboat_tpu.exec.scan import scan_file as ref_scan
from strawboat_tpu.util.env import _ALL as FLAG_NAMES
from strawboat_tpu_torch import schema
from strawboat_tpu_torch.benchsuite import tpch
from strawboat_tpu_torch.codecs import WriteOptions, read_header
from strawboat_tpu_torch.codecs.decimal import from_int64
from strawboat_tpu_torch.constants import Compression
from strawboat_tpu_torch.errors import NotYetImplementedError
from strawboat_tpu_torch.exec import load_resident, make_resident, scan_file
from strawboat_tpu_torch.exec import scan as port_scan
from strawboat_tpu_torch.exec.pruning import Comparison
from strawboat_tpu_torch.kernels import bitunpack as bu
from strawboat_tpu_torch.write import write_file

DICT, BP = "STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION"
RLE, FREQ, PATAS = "STRAWBOAT_RLE_COMPRESSION", "STRAWBOAT_FREQ_COMPRESSION", "STRAWBOAT_PATAS_COMPRESSION"
TILE = 512
NAN_PAYLOAD = np.uint64(0x7FF8_0000_0000_0123).view(np.float64)
SPECIALS = np.array([np.nan, NAN_PAYLOAD, -0.0, 0.0, np.inf, -np.inf])


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


def _pa_decimal(values, typ, null=None) -> pa.Array:
    """Unscaled int64 values (or an (n, W) byte matrix) → a decimal array
    whose buffer holds exactly those bytes, null slots included."""
    mat = values if values.ndim == 2 else from_int64(values, typ.bit_width // 8)
    bitmap = None if null is None else pa.py_buffer(np.packbits(~null, bitorder="little").tobytes())
    return pa.Array.from_buffers(typ, len(mat), [bitmap, pa.py_buffer(mat.tobytes())],
                                 null_count=-1)


def _pa_type(alias):
    dec = schema.decimal_params(alias)
    if dec is None:
        return pa.type_for_alias(alias)
    return (pa.decimal128 if dec[0] == 128 else pa.decimal256)(dec[1], dec[2])


def _with_specials(rng, vals):
    out = vals.copy()
    out[rng.choice(len(out), 40, replace=False)] = np.resize(SPECIALS, 40).astype(out.dtype)
    return out


def _typed_columns(n=6000, seed=0):
    """numpy columns of every new type (nulls with a leading null and one
    all-null page, NaN payloads, ±0.0, ±inf), and their arrow table."""
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.2
    null[0] = True
    null[1024:2048] = True
    f64 = _with_specials(rng, np.round(rng.normal(0, 1000, n), 2))
    low = _with_specials(rng, rng.integers(0, 12, n) * 0.25)
    cols = {
        "f64": f64,
        "f64n": np.ma.MaskedArray(f64[::-1].copy(), mask=null),
        "f32": _with_specials(rng, rng.random(n).astype(np.float32) * 100),
        "f16": rng.integers(-40, 40, n).astype(np.float16) / np.float16(4),
        "low": low,
        "lowf32": low.astype(np.float32),
        "const": np.full(n, 2.5),
        "dom": np.where(rng.random(n) < 0.97, 1.5, rng.random(n)),
        "steps": np.repeat(np.arange(n // 4 + 1) * 0.5, 4)[:n],
        "b": np.ma.MaskedArray(rng.random(n) < 0.3, mask=null),
        "btrue": np.ones(n, dtype=bool),
        "bruns": np.repeat(rng.random(n // 64 + 1) < 0.5, 64)[:n],
        "d": np.ma.MaskedArray(rng.integers(-10**9, 10**9, n), mask=null),
        "dlow": rng.integers(0, 7, n) * 1250,
        "d256": rng.integers(-10**15, 10**15, n),
        "k": np.arange(n, dtype=np.int64),
    }
    fields = [schema.Field(k, {"d": "decimal128(15, 2)", "dlow": "decimal128(9, 3)",
                               "d256": "decimal256(18, 0)"}.get(k, port_alias(v)))
              for k, v in cols.items()]
    arrays = {}
    for f in fields:
        v = cols[f.name]
        mask = np.ma.getmaskarray(v) if isinstance(v, np.ma.MaskedArray) else None
        data = np.ma.getdata(v)
        if f.is_flat_decimal:
            arrays[f.name] = _pa_decimal(data, _pa_type(f.dtype), mask)
        else:
            arrays[f.name] = pa.array(data, mask=mask)
    return cols, fields, pa.table(arrays)


def port_alias(v) -> str:
    from strawboat_tpu_torch.write.writer import _numpy_alias

    return _numpy_alias(np.ma.getdata(v))


def _assert_scan_equal(got, want, names):
    """Values bit for bit (the reference's exact host f64 where it keeps
    one), dtypes and validity."""
    assert got.num_rows == want.num_rows
    for k in names:
        g, w = got[k], want[k]
        wv = np.asarray(w.host_exact if w.host_exact is not None else w.values)
        gv = port_scan.host_values(g)
        assert gv.dtype == wv.dtype, (k, gv.dtype, wv.dtype)
        assert gv.tobytes() == wv.tobytes(), k
        assert (g.validity is None) == (w.validity is None), k
        if w.validity is not None:
            np.testing.assert_array_equal(g.validity.numpy(), np.asarray(w.validity), err_msg=k)


def _page_kinds(path, names):
    """{(codec, index codec or None)} over the pages of ``names``."""
    sch, metas, file_bytes = port_scan._open(path)
    out = set()
    for meta, field in port_scan._selected(sch, metas, names):
        for _l, _v, buf, p in port_scan._plan_pages(file_bytes, meta, field.nullable):
            codec, _c, _u, body = read_header(buf, p)
            out.add((codec, read_header(buf, body)[0] if codec == Compression.DICT else None))
    return out


# ---------------------------------------------------------------------------
# schema bytes


TYPES = ["float16", "float32", "float64", "bool", "decimal128(1, 0)", "decimal128(9, 3)",
         "decimal128(15, 2)", "decimal128(18, 18)", "decimal128(38, 10)", "decimal256(18, 0)",
         "decimal256(40, 5)", "decimal256(76, 38)"]


@pytest.mark.parametrize("alias", TYPES)
@pytest.mark.parametrize("nullable", [True, False])
def test_schema_bytes_equal_pyarrow(alias, nullable):
    fields = [schema.Field("a", alias, nullable), schema.Field("k", "int64")]
    want = ref_schema.schema_to_bytes(pa.schema(
        [pa.field(f.name, _pa_type(f.dtype), f.nullable) for f in fields]))
    assert schema.schema_to_bytes(fields) == want
    assert schema.deserialize_schema(want) == fields
    f = fields[0]
    assert (f.is_flat_float, f.is_flat_bool, f.is_flat_decimal) == (
        alias.startswith("float"), alias == "bool", alias.startswith("decimal"))


# ---------------------------------------------------------------------------
# files of the port's writer == files of the JAX writer


@pytest.mark.parametrize("names", [(), (DICT,), (DICT, BP), (PATAS,)])
@pytest.mark.parametrize("zone_maps", [False, True])
def test_port_writer_file_equals_jax_writer(tmp_path, flags, names, zone_maps):
    """Page bytes, zone block (``f`` zones for floats, none for bool and
    decimal), schema bytes and metas: the whole file."""
    cols, fields, table = _typed_columns(n=5000)
    if PATAS in names:  # PATAS is a codec of f32 and f64 pages
        keep = [f.name for f in fields if f.dtype != "float16"]
        cols, fields, table = {k: cols[k] for k in keep}, [f for f in fields if f.name in keep], table.select(keep)
    flags(names)
    port_path, ref_path = str(tmp_path / "port.str"), str(tmp_path / "ref.str")
    write_file(port_path, cols, schema=fields, options=WriteOptions(max_page_size=1024, zone_maps=zone_maps))
    ref_write(ref_path, table, options=RefOptions(max_page_size=1024, zone_maps=zone_maps))
    assert open(port_path, "rb").read() == open(ref_path, "rb").read()
    zones = ref_pruning.read_zones(port_path)
    if zone_maps:
        assert set(zones) == {f.name for f in fields if f.is_flat_float or f.is_flat_int}
        assert zones["f64"].kind == "f"
    flags(())
    _assert_scan_equal(scan_file(port_path, "cpu"), ref_scan(ref_path), list(cols))
    if PATAS in names:
        assert {c for c, _i in _page_kinds(port_path, ["f64", "f32"])} == {Compression.PATAS}


def test_writer_takes_decimal_matrices_and_refuses_what_it_lacks(tmp_path, flags):
    """A decimal beyond int64 goes in as its (n, W) byte matrix; the RLE and
    FREQ flags and the ratio options raise for the new types."""
    wide = from_int64(np.arange(300, dtype=np.int64), 16)
    wide[7, 8:] = 0x11  # one value beyond int64
    path, ref_path = str(tmp_path / "w.str"), str(tmp_path / "r.str")
    field = schema.Field("d", "decimal128(38, 0)")
    write_file(path, {"d": wide}, schema=[field])
    ref_write(ref_path, pa.table({"d": _pa_decimal(wide, pa.decimal128(38, 0))}),
              options=RefOptions(max_page_size=None))
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    for col, f in (({"x": np.zeros(256)}, None), ({"b": np.zeros(256, bool)}, None),
                   ({"d": np.arange(256)}, [schema.Field("d", "decimal128(15, 2)")])):
        for flag in (RLE, FREQ):
            if flag == FREQ and "b" in col:
                continue  # bool pages have no FREQ codec: the flag does not apply
            flags((flag,))
            with pytest.raises(NotYetImplementedError):
                write_file(path, col, schema=f)
        flags(())
        with pytest.raises(NotYetImplementedError):
            write_file(path, col, schema=f, options=WriteOptions(default_compress_ratio=1.0))
    with pytest.raises(Exception, match="decimal"):
        write_file(path, {"d": np.zeros(3)}, schema=[schema.Field("d", "decimal128(15, 2)")])


# ---------------------------------------------------------------------------
# files of the JAX writer: the port's scan == the JAX scan

READS = {
    # name: (forcing flags, writer options)
    "none": ((), dict(default_compression=RefCompression.NONE)),
    "lz4": ((), {}),
    "zstd": ((), dict(default_compression=RefCompression.ZSTD)),
    "rle": ((RLE,), {}),
    "dict": ((DICT,), dict(default_compression=RefCompression.NONE)),
    "dict_bitpack": ((DICT, BP), dict(default_compression=RefCompression.NONE, zone_maps=True)),
    "freq": ((FREQ,), {}),
    "patas": ((PATAS,), {}),
    "adaptive": ((), dict(default_compress_ratio=1.0, sample_seed=3, zone_maps=True)),
}


@pytest.mark.parametrize("name", list(READS))
def test_scan_of_jax_typed_file_equals_jax(tmp_path, flags, name):
    names, opts = READS[name]
    flags(names)
    _cols, _fields, table = _typed_columns()
    if name == "patas":
        table = table.drop(["f16"])
    path = _ref_write(tmp_path / "t.str", table, **opts)
    flags(())
    k3_before = bu.bitunpack_natural.launches
    got = scan_file(path, "cpu")
    assert bu.bitunpack_natural.launches == k3_before  # CPU tensors run the plain version
    _assert_scan_equal(got, ref_scan(path), table.column_names)
    floats = ["f64", "f64n", "f32", "low", "lowf32", "const", "dom", "steps"]
    kinds = _page_kinds(path, floats)
    codecs = {c for c, _i in kinds}
    expect = {"none": {Compression.NONE}, "lz4": {Compression.LZ4}, "zstd": {Compression.ZSTD},
              "rle": {Compression.RLE}, "dict": {Compression.DICT}, "dict_bitpack": {Compression.DICT},
              "freq": {Compression.FREQ}, "patas": {Compression.PATAS}}.get(name)
    if expect is not None:
        assert codecs == expect, kinds
    else:  # the chooser reaches every float codec but RLE
        assert {Compression.LZ4, Compression.DICT, Compression.ONE_VALUE, Compression.FREQ,
                Compression.PATAS} <= codecs, kinds
        index = {i for c, i in _page_kinds(path, list(table.column_names)) if c == Compression.DICT}
        assert {Compression.BITPACKING, Compression.DELTA_BITPACKING} & index, index
    if name == "dict_bitpack":
        assert (Compression.DICT, Compression.BITPACKING) in kinds
        # float and decimal DICT pages whose codes pack at one width take
        # K3 (those of the high-cardinality columns mix widths)
        groups = port_scan.k3_launch_groups(path, floats + ["d", "dlow", "d256"])
        assert {c for c, _g, _p, _w in groups} == {"low", "lowf32", "dlow"}
        assert {g for _c, g, _p, _w in groups} == {(Compression.DICT, 4), (Compression.DICT, 3)}


def test_bool_pages_of_every_kind_equal_jax(tmp_path, flags):
    """Raw bitmaps whose pages hold a multiple of 8 rows go up as they are;
    a page of another length, RLE and ONE_VALUE pages decode on the host."""
    rng = np.random.default_rng(4)
    n = 3001
    null = rng.random(n) < 0.1
    table = pa.table({"b": pa.array(rng.random(n) < 0.5, mask=null),
                      "t": pa.array(np.ones(n, bool)),
                      "r": pa.array(np.repeat(rng.random(n // 100 + 1) < 0.5, 100)[:n])})
    for page, names, opts in ((1024, (), {}), (1000, (), {}), (1001, (), {}), (1024, (RLE,), {}),
                              (1024, (), dict(default_compress_ratio=1.0, sample_seed=1))):
        flags(names)
        path = _ref_write(tmp_path / f"b{page}{names}.str", table, max_page_size=page, **opts)
        flags(())
        got = scan_file(path, "cpu")
        _assert_scan_equal(got, ref_scan(path), ["b", "t", "r"])
        assert got["b"].values.dtype == torch.bool
        assert got.to_arrow().equals(ref_read_table(path))
    assert {c for c, _i in _page_kinds(path, ["t", "r"])} == {Compression.ONE_VALUE, Compression.RLE}


@pytest.mark.parametrize("name", ["dict_bitpack", "adaptive"])
def test_pruned_scan_on_float_zones_and_chunks_equal_jax(tmp_path, flags, name):
    """``f`` zones prune float predicates (float and int literals) as the
    JAX pruning does; chunked scans match the JAX chunks one for one."""
    names, opts = READS[name]
    flags(names)
    cols, _fields, table = _typed_columns()
    sorted_f = np.sort(np.round(np.random.default_rng(1).random(6000) * 600, 3))
    table = table.append_column("sf", pa.array(sorted_f))
    path = _ref_write(tmp_path / "t.str", table, **opts)
    flags(())
    for preds in ([("sf", "ge", 150.5), ("sf", "lt", 420)], [("sf", "le", 100)],
                  [("sf", "gt", 599.0), ("k", "ge", 10)], [("sf", "eq", float(sorted_f[3000]))]):
        mine = [Comparison(*p) for p in preds]
        theirs = [ref_pruning.Comparison(*p) for p in preds]
        keep = port_scan.page_keep_mask(path, port_scan._open(path)[1], mine)
        want_keep = ref_pruning.prune_pages(ref_pruning.read_zones(path), theirs, 6)
        np.testing.assert_array_equal(keep, want_keep)
        assert 0 < keep.sum() < len(keep)
        _assert_scan_equal(scan_file(path, "cpu", predicates=mine),
                           ref_scan(path, predicates=theirs), table.column_names)
    for p_mine, p_ref in ((None, None), (mine, theirs)):
        got = list(port_scan.scan_chunks(path, 2, "cpu", predicates=p_mine))
        want = list(ref_scan_chunks(path, 2, predicates=p_ref))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_scan_equal(g, w, table.column_names)


# ---------------------------------------------------------------------------
# queries over float and decimal columns


def test_query_over_float_and_decimal_columns_equals_jax(tmp_path, flags):
    """Filters on float and decimal columns (decimal literals are unscaled
    ints), grouped sum / min / max / avg / count and ORDER BY a float
    aggregate: slot for slot the JAX ``Query`` over the same file."""
    from strawboat_tpu.exec import expr as ref_expr
    from strawboat_tpu.exec.query import Query as RefQuery
    from strawboat_tpu_torch.exec import Query, col

    rng = np.random.default_rng(8)
    n = 6000
    price = np.round(rng.random(n) * 1000, 2)
    amount = rng.integers(-50_000, 50_000, n)
    table = pa.table({
        "g": pa.array(rng.integers(0, 9, n).astype(np.int32)),
        "price": pa.array(price),
        "w": pa.array((rng.random(n) * 10).astype(np.float32)),
        "amount": _pa_decimal(amount, pa.decimal128(12, 2)),
    })
    flags((DICT, BP))
    path = _ref_write(tmp_path / "q.str", table, default_compression=RefCompression.NONE)
    flags(())

    def build(q, c):
        return (q.filter((c("price") > 100.5) & (c("amount") >= -20_000) & (c("w") < 9.5))
                .group_by("g", num_groups=16)
                .agg(s=("sum", "price"), sa=("sum", "amount"), mn=("min", "price"),
                     mx=("max", "amount"), av=("avg", "w"), n=("count", "price"),
                     rev=("sum", c("price") * c("w")))
                .order_by(("s", "desc")))

    got = build(Query(path, device="cpu"), col).run()
    want = build(RefQuery(path), ref_expr.col).run()
    k = int(want["n_groups"])
    assert int(got["n_groups"]) == k == 9
    for name in ("key_g", "sa", "mx", "n", "mn"):
        np.testing.assert_array_equal(got[name][:k].numpy(), np.asarray(want[name])[:k], err_msg=name)
    for name in ("s", "av", "rev"):
        np.testing.assert_allclose(got[name][:k].numpy(), np.asarray(want[name])[:k], rtol=1e-12,
                                   err_msg=name)
    m = (price > 100.5) & (amount >= -20_000) & (np.asarray(table["w"]) < 9.5)
    assert int(got["n"][:k].sum()) == int(m.sum())
    total = (Query(path, device="cpu").filter(col("amount") < 0)
             .agg(t=("sum", "amount"), p=("sum", "price")).run())
    assert int(total["t"]) == int(amount[amount < 0].sum())
    np.testing.assert_allclose(float(total["p"]), price[amount < 0].sum(), rtol=1e-12)


@pytest.mark.parametrize("money", ["decimal", "float64"])
def test_lineitem_with_typed_money_equals_numpy_and_jax(tmp_path, flags, money):
    """The ten lineitem columns, money as ``decimal128(15, 2)`` under the
    dict flags or as float64 under none, with zone maps: the file equals
    the JAX writer's, Q6 over a pruned scan, Q1 through ``Query`` and the
    fused Q1 / Q6 over ``load_resident`` and ``make_resident(scan)`` equal
    numpy (decimals exactly, floats to rtol 1e-12)."""
    from strawboat_tpu.exec.resident import load_resident as ref_load

    cols = tpch.generate_lineitem(1.0, seed=0, rows=20_000)
    flags((DICT, BP) if money == "decimal" else ())
    path = str(tmp_path / f"lineitem_{money}.str")
    tpch.write_lineitem(path, cols, max_page_size=2048, zone_maps=True, money=money)
    typed = tpch.typed_money(cols, money)
    arrays = {k: (_pa_decimal(typed[k], pa.decimal128(15, 2)) if money == "decimal"
                  and k in tpch.MONEY_COLUMNS else pa.array(typed[k]))
              for k in tpch.LINEITEM_COLUMNS}
    ref_path = _ref_write(tmp_path / "ref.str", pa.table(arrays), default_compression=RefCompression.NONE,
                          max_page_size=2048, zone_maps=True)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    flags(())

    def close(got, want):
        if money == "decimal" and not isinstance(want, float):
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12)

    def rows_close(got, want):
        assert list(got) == list(want)
        for key, aggs in want.items():
            for name, w in aggs.items():
                close(got[key][name], w)

    want6 = tpch.q6_numpy_reference(cols, money)
    pruned = scan_file(path, "cpu", predicates=tpch.q6_pruning_predicates())
    assert 0 < pruned.num_rows < 20_000
    close(tpch.q6(pruned, money).item(), want6)
    want1 = tpch.q1_numpy_reference(cols, money=money)
    rows_close(tpch.q1_rows(tpch.q1_query(path, "cpu", money=money)), want1)
    scanned = scan_file(path, "cpu")
    for k in tpch.MONEY_COLUMNS:
        np.testing.assert_array_equal(scanned[k].values.numpy(), typed[k], err_msg=k)
    rt_ref = ref_load(path, tile=TILE)
    for rt in (load_resident(path, "cpu", tile=TILE), make_resident(scanned, "cpu", tile=TILE)):
        rows_close(tpch.q1_rows(tpch.q1(rt, money=money)), want1)
        close(tpch.q6(rt, money).item(), want6)
    _assert_planes_equal(load_resident(path, "cpu", tile=TILE), rt_ref)


# ---------------------------------------------------------------------------
# resident loaders


def _assert_planes_equal(rt, rt_ref, skip=()):
    assert list(rt.columns) == list(rt_ref.columns)
    for n, r in rt_ref.columns.items():
        if n in skip:
            continue
        c = rt.columns[n]
        assert (c.kind, c.length, tuple(c.shifts), c.offset, c.bit_shift, c.wide, c.is_dict) == (
            r.kind, r.length, tuple(r.shifts), r.offset, r.bit_shift, r.wide, r.is_dict), n
        assert [b for _w, b in c.planes] == [b for _w, b in r.planes], n
        for (w, _b), (rw, _rb) in zip(c.planes, r.planes):
            np.testing.assert_array_equal(w.numpy().view(np.uint32), np.asarray(rw), err_msg=n)
        assert (c.validity_plane is None) == (r.validity_plane is None), n
        if c.validity_plane is not None:
            np.testing.assert_array_equal(c.validity_plane.numpy().view(np.uint32),
                                          np.asarray(r.validity_plane), err_msg=n)
        if c.is_dict:
            np.testing.assert_array_equal(c.dictionary_host, r.dictionary_host, err_msg=n)


RESIDENT = ["f64", "f64n", "f32", "low", "lowf32", "const", "dom", "b", "btrue", "bruns", "d", "dlow", "k"]


@pytest.mark.parametrize("name", ["dict_bitpack", "lz4"])
def test_load_resident_of_typed_columns_equals_jax(tmp_path, flags, name):
    from strawboat_tpu.exec.resident import load_resident as ref_load

    names, opts = READS[name]
    flags(names)
    _cols, _fields, table = _typed_columns()
    path = _ref_write(tmp_path / "t.str", table.select(RESIDENT), **opts)
    flags(())
    rt = load_resident(path, "cpu", tile=TILE)
    rt_ref = ref_load(path, tile=TILE)
    _assert_planes_equal(rt, rt_ref)
    for k in RESIDENT:
        np.testing.assert_array_equal(rt.decode_natural(k).numpy().view(np.uint8),
                                      np.asarray(rt_ref.decode_natural(k)).view(np.uint8), err_msg=k)
    # float16 and decimal256 (which the JAX loader refuses)
    f16 = _ref_write(tmp_path / "h.str", table.select(["f16"]))
    with pytest.raises(NotYetImplementedError, match="float16"):
        load_resident(f16, "cpu", tile=TILE)
    wide = _ref_write(tmp_path / "w.str", table.select(["d256"]))
    got = load_resident(wide, "cpu", tile=TILE)
    np.testing.assert_array_equal(got.decode_natural("d256").numpy(), _cols["d256"])
    assert got.to_arrow().column("d256").equals(table.column("d256"))


def test_make_resident_of_a_typed_scan_equals_jax_but_null_slots(tmp_path, flags):
    """The device-direct encode: planes equal the JAX encode of its scan
    word for word, except f64 columns with nulls, whose null slots the
    port fills with the first valid value before the float encode (the
    reference leaves them, ROADMAP.md queue 3): the decoded valid rows
    still agree, and the null slots hold that value."""
    from strawboat_tpu.exec.resident import make_resident as ref_make

    flags((DICT, BP))
    _cols, _fields, table = _typed_columns()
    path = _ref_write(tmp_path / "t.str", table.select(RESIDENT), default_compression=RefCompression.NONE)
    flags(())
    rt = make_resident(scan_file(path, "cpu"), "cpu", tile=TILE)
    rt_ref = ref_make(ref_scan(path), tile=TILE)
    _assert_planes_equal(rt, rt_ref, skip=("f64n",))
    valid = rt.validity_natural("f64n").numpy()
    mine = rt.decode_natural("f64n").numpy()
    theirs = np.asarray(rt_ref.decode_natural("f64n"))
    assert mine[valid].tobytes() == theirs[valid].tobytes()
    assert (mine[~valid] == mine[valid][0]).all()
    assert mine[~valid].tobytes() != theirs[~valid].tobytes()
    mine_a, theirs_a = (t.to_arrow().column("f64n").combine_chunks() for t in (rt, rt_ref))
    assert mine_a.is_null().equals(theirs_a.is_null())
    assert mine_a.fill_null(0.0).to_numpy().tobytes() == theirs_a.fill_null(0.0).to_numpy().tobytes()


# ---------------------------------------------------------------------------
# wider decimals raise where the reference raises


def test_decimal_wider_than_int64_raises_where_jax_raises(tmp_path, flags):
    """The JAX scan checks every decoded row, null slots included; the
    port checks the rows of host-decoded pages and, for DICT pages, the
    dictionary entries, which are exactly the pushed rows: a wide value at
    a null slot of a DICT (or RLE) page is never stored, one at a null
    slot of a raw page is a row.  Pruning the page away scans in both."""
    from strawboat_tpu.exec.pruning import Comparison as RefComparison

    n = 3000
    mat = from_int64(np.arange(n, dtype=np.int64) * 7, 16)
    mat[2500, 8:] = 1  # row 2500 holds 2^64 + 17500: beyond int64
    null = np.zeros(n, bool)
    for wide_is_null in (False, True):
        null[2500] = wide_is_null
        table = pa.table({"d": _pa_decimal(mat, pa.decimal128(18, 0), null),
                          "k": pa.array(np.arange(n, dtype=np.int64))})
        for names in ((), (DICT, BP), (DICT,), (RLE,)):
            flags(names)
            path = _ref_write(tmp_path / "w.str", table, zone_maps=True)
            flags(())
            try:
                ref_scan(path)
                ref_raised = False
            except RefNotYetImplemented:
                ref_raised = True
            # raw pages store null slots; DICT and RLE pages fold them away
            assert ref_raised == (not wide_is_null or not names), (names, wide_is_null)
            if ref_raised:
                with pytest.raises(NotYetImplementedError, match="wider than int64"):
                    scan_file(path, "cpu")
            else:
                _assert_scan_equal(scan_file(path, "cpu"), ref_scan(path), ["d", "k"])
            lt = [("k", "lt", 2048)]
            _assert_scan_equal(scan_file(path, "cpu", predicates=[Comparison(*lt[0])]),
                               ref_scan(path, predicates=[RefComparison(*lt[0])]), ["d", "k"])
    # precision beyond 18 raises whatever the values, as there
    path = _ref_write(tmp_path / "p.str", pa.table({"d": _pa_decimal(np.arange(5), pa.decimal128(19, 0))}))
    with pytest.raises(RefNotYetImplemented):
        ref_scan(path)
    with pytest.raises(NotYetImplementedError, match="wider than int64"):
        scan_file(path, "cpu")


# ---------------------------------------------------------------------------
# tests/test_f64_exact.py, as port cases: float64 is native on the GPU, so
# the device column IS the exact data (no host copy)


def _f64_file(path, src, **kw):
    ref_write(str(path), pa.table({"a": pa.array(src)}),
              options=RefOptions(default_compression=RefCompression.LZ4, max_page_size=1024, **kw))
    return str(path)


def test_f64_streamed_path_keeps_exact_bytes(tmp_path):
    rng = np.random.default_rng(0)
    src = np.cumsum(rng.random(5000)) * 0.001
    path = _f64_file(tmp_path / "f.str", src)
    dt = scan_file(path, "cpu")
    assert dt["a"].values.numpy().tobytes() == src.tobytes()
    assert np.asarray(dt.to_arrow().column("a")).tobytes() == src.tobytes()


def test_f64_patas_path_keeps_exact_bytes(tmp_path, flags):
    rng = np.random.default_rng(1)
    src = np.cumsum(rng.random(4096)) * 0.001
    flags((PATAS,))
    path = _f64_file(tmp_path / "p.str", src)
    flags(())
    dt = scan_file(path, "cpu")
    assert np.asarray(dt.to_arrow().column("a")).tobytes() == src.tobytes()
    assert np.asarray(ref_read_table(path).column("a")).tobytes() == src.tobytes()


def test_f64_exact_device_values_are_the_data(tmp_path):
    """The reference keeps exact host bytes because its device copy is
    lossy; the port keeps none: ``to_arrow`` reads the device values, so
    they must be, and are, the file's exact bytes (a changed device value
    shows in ``to_arrow``)."""
    rng = np.random.default_rng(2)
    src = np.cumsum(rng.random(2000)) * 0.001
    dt = scan_file(_f64_file(tmp_path / "g.str", src), "cpu")
    assert not hasattr(dt["a"], "host_exact")
    assert np.asarray(dt.to_arrow().column("a")).tobytes() == src.tobytes()
    dt["a"].values.view(torch.int64)[5] |= 3
    assert np.asarray(dt.to_arrow().column("a"))[5] != src[5]


def test_f64_reencode_exact(tmp_path):
    """scan → the port's writer → the JAX reader is bit-exact for f64."""
    rng = np.random.default_rng(4)
    src = np.cumsum(rng.random(3000)) * 0.001
    src[[3, 4, 5]] = [np.nan, -0.0, np.inf]
    dt = scan_file(_f64_file(tmp_path / "a.str", src), "cpu")
    p2 = str(tmp_path / "b.str")
    write_file(p2, {"a": dt["a"].values.numpy()}, options=WriteOptions(max_page_size=1024))
    assert np.asarray(ref_read_table(p2).column("a")).tobytes() == src.tobytes()


# ---------------------------------------------------------------------------
# tests/test_decimal.py, as port cases: the JAX package's decimal files,
# through the chooser's codecs, scan in the port as the JAX scan and the
# JAX reader hold them; precisions beyond 18 raise in both scans


def _dec(v, scale=2):
    return decimal.Decimal(int(v)).scaleb(-scale)


def _decimal_roundtrip(tmp_path, table, **kw):
    """The JAX writer's file (chooser, LZ4) scanned by the port: unscaled
    values equal the JAX reader's, nulls equal; a precision beyond 18
    raises in the port and in the JAX scan."""
    path = _ref_write(tmp_path / "d.str", table, default_compress_ratio=1.0, **kw)
    want = ref_read_table(path)
    assert want.to_pylist() == table.to_pylist()
    for name in table.column_names:
        t = table.schema.field(name).type
        if t.precision > 18:
            with pytest.raises(RefNotYetImplemented):
                ref_scan(path, columns=[name])
            with pytest.raises(NotYetImplementedError, match="wider than int64"):
                scan_file(path, "cpu", columns=[name])
            continue
        got = scan_file(path, "cpu", columns=[name])
        _assert_scan_equal(got, ref_scan(path, columns=[name]), [name])
        assert got.to_arrow().column(name).to_pylist() == want.column(name).to_pylist()
    return path


def _narrow(table, precision=18):
    """The same values under a precision of 18, which the device scan takes."""
    return pa.table({n: c.cast(pa.decimal128(precision, c.type.scale)) for n, c in
                     zip(table.column_names, table.columns)})


def test_decimal128_mixed(tmp_path):
    rng = np.random.default_rng(5)
    n = 3000
    vals = [_dec(v) if m else None
            for v, m in zip(rng.integers(-(10**12), 10**12, n), rng.random(n) > 0.2)]
    table = pa.table({"d": pa.array(vals, type=pa.decimal128(30, 2))})
    _decimal_roundtrip(tmp_path, table)
    _decimal_roundtrip(tmp_path, _narrow(table))


def test_decimal128_low_cardinality_dict(tmp_path):
    table = pa.table({"d": pa.array([_dec((i % 5) * 12345) for i in range(4000)],
                                    type=pa.decimal128(18, 2))})
    path = _decimal_roundtrip(tmp_path, table)
    assert Compression.DICT in {c for c, _i in _page_kinds(path, ["d"])}


def test_decimal128_onevalue_and_freq(tmp_path):
    n = 4000
    table = pa.table({"c": pa.array([_dec(777)] * n, type=pa.decimal128(10, 2))})
    path = _decimal_roundtrip(tmp_path, table)
    assert {c for c, _i in _page_kinds(path, ["c"])} == {Compression.ONE_VALUE}
    vals2 = [_dec(10**10)] * n
    for i in range(0, n, 100):
        vals2[i] = _dec(i)
    table2 = pa.table({"f": pa.array(vals2, type=pa.decimal128(18, 2))})
    path = _decimal_roundtrip(tmp_path, table2)
    assert {c for c, _i in _page_kinds(path, ["f"])} == {Compression.FREQ}


def test_decimal256(tmp_path):
    rng = np.random.default_rng(6)
    n = 2000
    vals = [decimal.Decimal(int(v)) * (10**20) if m else None
            for v, m in zip(rng.integers(0, 10**9, n), rng.random(n) > 0.3)]
    _decimal_roundtrip(tmp_path, pa.table({"d": pa.array(vals, type=pa.decimal256(60, 0))}))
    small = [None if v is None else v.scaleb(-20) for v in vals]
    _decimal_roundtrip(tmp_path, pa.table({"d": pa.array(small, type=pa.decimal256(18, 0))}))


def test_decimal_forced_codecs(tmp_path, flags):
    n = 3000
    vals = [_dec((i % 7) * 1000) if i % 9 else None for i in range(n)]
    table = pa.table({"d": pa.array(vals, type=pa.decimal128(25, 2))})
    for names in ((DICT,), (RLE,), (FREQ,), (DICT, BP)):
        flags(names)
        path = _ref_write(tmp_path / "f.str", table)
        narrow = _ref_write(tmp_path / "n.str", _narrow(table))
        flags(())
        assert ref_read_table(path).to_pylist() == table.to_pylist()
        with pytest.raises(NotYetImplementedError, match="wider than int64"):
            scan_file(path, "cpu")
        _assert_scan_equal(scan_file(narrow, "cpu"), ref_scan(narrow), ["d"])
