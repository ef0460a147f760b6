"""The port's file-format API (``strawboat_tpu_torch/api.py``,
``read/``, ``NativeWriter``) against the JAX package's.

The same seeded tables go through the JAX writer and the port's writer
(the files must be equal byte for byte, every codec option the JAX tests
use), then each file through the JAX reader and the port's: ``read_table``
(with and without ``columns=`` and ``arena=``) and ``iter_batches`` must
give equal tables, floats compared by their bits.  Mirrors
``tests/test_io.py``, ``tests/test_read_meta.py``, the fast-path tests of
``tests/test_correctness_r4.py`` and ``tests/test_fuzz.py``'s roundtrip,
at smaller sizes, then the null type through every path that takes a
file, and the port's examples.
"""

import asyncio
import os
import random
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

from conftest import (
    create_random_bool,
    create_random_double,
    create_random_i64,
    create_random_index,
    create_random_string,
    rng,
)
from test_fuzz import rand_type, rand_value
from test_io import _nested_table
from strawboat_tpu import api as ref_api
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu_torch import api
from strawboat_tpu_torch.codecs import WriteOptions
from strawboat_tpu_torch.columns import pa_field
from strawboat_tpu_torch.constants import Compression
from strawboat_tpu_torch.errors import NotYetImplementedError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE = 512
COMMONS = ["LZ4", "ZSTD", "SNAPPY", "NONE"]


def options(codec="LZ4", ratio=1.0, page=PAGE, seed=None, zone_maps=False):
    """(JAX options, port options) alike."""
    kw = dict(default_compress_ratio=ratio, max_page_size=page, sample_seed=seed,
              zone_maps=zone_maps)
    return (RefOptions(default_compression=RefCompression[codec], **kw),
            WriteOptions(default_compression=Compression[codec], **kw))


def _int_type(t):
    """``t`` with every float replaced by the int of its width."""
    if pa.types.is_floating(t):
        return {16: pa.int16(), 32: pa.int32(), 64: pa.int64()}[t.bit_width]

    def fld(f):
        return f.with_type(_int_type(f.type))

    if pa.types.is_map(t):
        return pa.map_(fld(t.key_field), fld(t.item_field), keys_sorted=t.keys_sorted)
    if pa.types.is_fixed_size_list(t):
        return pa.list_(fld(t.value_field), t.list_size)
    if pa.types.is_large_list(t):
        return pa.large_list(fld(t.value_field))
    if pa.types.is_list(t):
        return pa.list_(fld(t.value_field))
    if pa.types.is_struct(t):
        return pa.struct([fld(t.field(i)) for i in range(t.num_fields)])
    return t


def assert_same(got: pa.Table, want: pa.Table) -> None:
    """Equal schemas, and equal columns with floats compared by bits."""
    assert got.schema.equals(want.schema), (got.schema, want.schema)
    for name in want.column_names:
        a, b = got[name].combine_chunks(), want[name].combine_chunks()
        t = _int_type(b.type)
        assert a.view(t).equals(b.view(t)), name


def write_both(tmp_path, table, ref_opts, opts, name="t"):
    """The table through both writers → the JAX file's path; the files
    and the metas must be equal."""
    jpath, ppath = str(tmp_path / f"{name}.jax.str"), str(tmp_path / f"{name}.port.str")
    ref_metas = ref_api.write_file(jpath, table, options=ref_opts)
    metas = api.write_file(ppath, table, options=opts)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read(), "the port's file differs from the JAX writer's"
    assert [(m.offset, [(p.length, p.num_values) for p in m.pages]) for m in metas] == \
        [(m.offset, [(p.length, p.num_values) for p in m.pages]) for m in ref_metas]
    return jpath, ppath


def read_both(jpath, ppath, source=None):
    """Each file through each reader: the port's ``read_table`` and
    ``iter_batches`` equal the JAX ones (and the source's values)."""
    want = ref_api.read_table(jpath)
    assert_same(api.read_table(jpath), want)
    assert_same(ref_api.read_table(ppath), want)
    ref_batches = list(ref_api.iter_batches(jpath))
    batches = list(api.iter_batches(ppath))
    assert len(batches) == len(ref_batches)
    for b, rb in zip(batches, ref_batches):
        assert_same(pa.Table.from_batches([b]), pa.Table.from_batches([rb]))
    if source is not None:
        assert api.read_table(ppath).to_pylist() == source.to_pylist()
    return want


def roundtrip(tmp_path, table, codec="LZ4", ratio=1.0, page=PAGE, seed=None):
    jpath, ppath = write_both(tmp_path, table, *options(codec, ratio, page, seed))
    return read_both(jpath, ppath, table)


# ---------------------------------------------------------------------------
# tests/test_io.py, at pages of 512 rows


@pytest.mark.parametrize("compression", COMMONS)
@pytest.mark.parametrize("size", [PAGE, PAGE + 10, PAGE * 2 + 5])
def test_basic_mixed(tmp_path, compression, size):
    table = pa.table({
        "int32": create_random_index(size, 0.2, 100),
        "int64": create_random_i64(size, 0.0),
        "f64": create_random_double(size, 0.1),
        "bool": create_random_bool(size, 0.3),
        "utf8": create_random_string(size, 0.2, 50),
    })
    roundtrip(tmp_path, table, compression)


def test_dict(tmp_path):
    roundtrip(tmp_path, pa.table({"c": create_random_index(PAGE * 2, 0.1, 8)}))


def test_freq(tmp_path):
    r = rng()
    vals = np.full(PAGE * 2, 1000, dtype=np.int64)
    idx = r.integers(0, len(vals), len(vals) // 20)
    vals[idx] = r.integers(0, 1 << 40, len(idx))
    roundtrip(tmp_path, pa.table({"c": pa.array(vals)}))


def test_bitpacking(tmp_path):
    vals = rng().integers(0, 1 << 12, PAGE * 2, dtype=np.int32)
    roundtrip(tmp_path, pa.table({"c": pa.array(vals)}))


def test_delta_bitpacking(tmp_path):
    vals = np.sort(rng().integers(0, 1 << 20, PAGE * 2).astype(np.uint32))
    roundtrip(tmp_path, pa.table({"c": pa.array(vals, type=pa.uint32())}))


def test_onevalue(tmp_path):
    roundtrip(tmp_path, pa.table({
        "i": pa.array(np.full(PAGE, 7, dtype=np.int64)),
        "s": pa.array(["x"] * PAGE),
        "b": pa.array([True] * PAGE),
    }))


def test_patas(tmp_path):
    roundtrip(tmp_path, pa.table({"f": pa.array(np.cumsum(rng().normal(0, 1, PAGE * 2)))}))


def test_boolean_rle(tmp_path):
    vals = np.repeat(rng().random(PAGE // 64) > 0.5, 128)
    roundtrip(tmp_path, pa.table({"b": pa.array(vals)}))


@pytest.mark.parametrize("compression", COMMONS)
def test_nested(tmp_path, compression):
    roundtrip(tmp_path, _nested_table(PAGE + 77), compression)


def test_nested_multi_page(tmp_path):
    roundtrip(tmp_path, _nested_table(PAGE * 3 + 5))


def test_page_slicing_offsets(tmp_path):
    r = rng()
    size = PAGE * 2 + 333
    table = pa.table({"l": pa.array(
        [[int(x) for x in r.integers(0, 1000, int(r.integers(0, 9)))]
         if r.random() > 0.15 else None for _ in range(size)],
        type=pa.list_(pa.int64()))})
    roundtrip(tmp_path, table, "ZSTD")


def test_empty_and_single_row(tmp_path):
    roundtrip(tmp_path, pa.table({"a": pa.array([1], type=pa.int64()), "s": pa.array(["x"])}))


def test_fixed_size_list(tmp_path):
    size = PAGE + 3
    table = pa.table({"fsl": pa.array([[i, i + 1] if i % 4 else None for i in range(size)],
                                      type=pa.list_(pa.int32(), 2))})
    roundtrip(tmp_path, table)


def test_non_nullable_fields(tmp_path):
    schema = pa.schema([
        pa.field("a", pa.int64(), nullable=False),
        pa.field("l", pa.list_(pa.field("item", pa.int32(), nullable=False)), nullable=False),
    ])
    n = PAGE + 9
    table = pa.table({"a": pa.array(range(n), type=pa.int64()),
                      "l": pa.array([[i, i + 1] if i % 2 else [] for i in range(n)],
                                    type=schema.field("l").type)}, schema=schema)
    roundtrip(tmp_path, table)


def test_zero_row_table(tmp_path):
    roundtrip(tmp_path, pa.table({
        "a": pa.array([], type=pa.int64()),
        "s": pa.array([], type=pa.string()),
        "l": pa.array([], type=pa.list_(pa.int32())),
    }))


def test_read_arena_recycles_buffers(tmp_path):
    """``ReadArena``: the same tables as a fresh read and the JAX read, the
    second read's values buffers the first's, and a file of another size
    through the same arena still right."""
    from strawboat_tpu.read.fast import ReadArena as RefArena
    from strawboat_tpu_torch.read.fast import ReadArena

    n = PAGE * 3 + 17
    table = pa.table({
        "a": pa.array(create_random_i64(n, 0.0)),
        "f": pa.array(np.random.default_rng(7).normal(size=n), type=pa.float64()),
        "s": pa.array(create_random_string(n, 0.0, 8)),
    })
    jpath, ppath = write_both(tmp_path, table, *options(ratio=None))
    want = ref_api.read_table(jpath, arena=RefArena())
    arena = ReadArena()
    assert_same(api.read_table(ppath), want)
    got1 = api.read_table(ppath, arena=arena)
    assert_same(got1, want)
    addrs1 = {got1.column(c).chunk(0).buffers()[1].address for c in ("a", "f")}
    assert arena._lent  # the integer and float columns took the fast path
    got2 = api.read_table(ppath, arena=arena)
    assert_same(got2, want)
    assert {got2.column(c).chunk(0).buffers()[1].address for c in ("a", "f")} == addrs1
    small = pa.table({"a": pa.array(create_random_i64(PAGE, 0.0))})
    jp2, pp2 = write_both(tmp_path, small, *options(ratio=None), name="small")
    assert_same(api.read_table(pp2, arena=arena), ref_api.read_table(jp2))


@pytest.mark.parametrize("columns", [["int64"], ["utf8", "f64"], []])
def test_read_table_columns(tmp_path, columns):
    table = pa.table({"int64": create_random_i64(PAGE + 3, 0.1),
                      "f64": create_random_double(PAGE + 3, 0.1),
                      "utf8": create_random_string(PAGE + 3, 0.2, 9)})
    jpath, ppath = write_both(tmp_path, table, *options())
    assert_same(api.read_table(ppath, columns=columns), ref_api.read_table(jpath, columns=columns))


# ---------------------------------------------------------------------------
# tests/test_read_meta.py


class _AsyncFile:
    def __init__(self, path):
        self.path = path

    async def size(self):
        return os.path.getsize(self.path)

    async def read_at(self, offset, length):
        with open(self.path, "rb") as f:
            f.seek(offset)
            return f.read(length)


def _meta_file(tmp_path):
    table = pa.table({"a": create_random_i64(5000, 0.1), "b": create_random_i64(5000, 0.0)})
    jpath, _ = write_both(tmp_path, table, *options(ratio=None, page=1024))
    return table, jpath


def _metas(metas):
    return [(m.offset, [(p.length, p.num_values) for p in m.pages]) for m in metas]


def test_read_meta_sync(tmp_path):
    from strawboat_tpu.read import reader as ref_reader
    from strawboat_tpu_torch.read import reader

    table, path = _meta_file(tmp_path)
    with open(path, "rb") as f:
        got = reader.read_meta(f)
        schema = reader.infer_schema(f)
    with open(path, "rb") as f:
        assert _metas(got) == _metas(ref_reader.read_meta(f))
    assert pa.schema([pa_field(x) for x in schema]).equals(table.schema)


@pytest.mark.parametrize("with_len", [True, False])
def test_read_meta_async(tmp_path, with_len):
    from strawboat_tpu.read import reader as ref_reader
    from strawboat_tpu_torch.read import reader

    _, path = _meta_file(tmp_path)
    total = os.path.getsize(path) if with_len else None
    got = asyncio.run(reader.read_meta_async(_AsyncFile(path), total))
    want = asyncio.run(ref_reader.read_meta_async(_AsyncFile(path), total))
    assert _metas(got) == _metas(want)


def test_infer_schema_async(tmp_path):
    from strawboat_tpu_torch.read import reader

    table, path = _meta_file(tmp_path)
    schema = asyncio.run(reader.infer_schema_async(_AsyncFile(path)))
    assert pa.schema([pa_field(x) for x in schema]).equals(table.schema)


def test_meta_slicing(tmp_path):
    from strawboat_tpu.read import reader as ref_reader
    from strawboat_tpu_torch.read import reader

    _, path = _meta_file(tmp_path)
    with open(path, "rb") as f:
        m = reader.read_meta(f)[0]
        rm = ref_reader.read_meta(f)[0]
    for got, want in ((m.slice(1, len(m.pages)), rm.slice(1, len(rm.pages))),
                      (m.skip_one_page(), rm.skip_one_page()), (m.slice(2, 3), rm.slice(2, 3))):
        assert _metas([got]) == _metas([want])
    assert m.total_len() == rm.total_len() and m.num_values() == rm.num_values()
    with pytest.raises(IndexError):
        m.slice(len(m.pages), len(m.pages))


def test_page_iterator_nth_and_skip(tmp_path):
    """``nth`` and ``skip_page`` seek past pages without reading them; the
    page read after equals the JAX reader's."""
    from strawboat_tpu.read.deserialize import decode_simple_page as ref_decode
    from strawboat_tpu.read.reader import open_readers as ref_open, read_meta as ref_meta
    from strawboat_tpu_torch.columns import field_from_arrow, to_arrow
    from strawboat_tpu_torch.read.deserialize import decode_simple_page
    from strawboat_tpu_torch.read.reader import open_readers

    table, path = _meta_file(tmp_path)
    with open(path, "rb") as f:
        metas = ref_meta(f)
    field = field_from_arrow(table.schema.field(0))
    r, rr = open_readers(path, metas[:1])[0], ref_open(path, metas[:1])[0]
    (nv, buf), (rnv, rbuf) = r.nth(2), rr.nth(2)
    assert nv == rnv and buf.tobytes() == rbuf.tobytes()
    got = to_arrow(decode_simple_page(field, int(nv), buf), field)
    assert got.equals(ref_decode(table.schema.field(0), int(rnv), rbuf).to_arrow())
    assert got.to_pylist() == table.column(0).to_pylist()[2 * 1024 : 2 * 1024 + int(nv)]
    r.skip_page()
    rr.skip_page()
    assert r.current_page == rr.current_page == 4
    assert next(r)[1].tobytes() == next(rr)[1].tobytes()
    with pytest.raises(StopIteration):
        r.nth(len(metas[0].pages))
    r.page_reader.close()
    rr.page_reader.close()


# ---------------------------------------------------------------------------
# the planned fast path (tests/test_correctness_r4.py:75, :139, :172, :235,
# :302): the port's fast readers take the column, equal to the JAX ones


def _fast_file(tmp_path, table, page):
    jpath, ppath = write_both(tmp_path, table, *options(ratio=1.0, page=page))
    return jpath, ppath


def _fast(path, name, binary=False):
    from strawboat_tpu_torch.read.fast import read_binary_column_fast, read_column_fast
    from strawboat_tpu_torch.read.reader import infer_schema, read_meta

    with open(path, "rb") as f:
        schema, metas = infer_schema(f), read_meta(f)
    i = [f.name for f in schema].index(name)
    fb = np.memmap(path, dtype=np.uint8, mode="r").view(np.ndarray)
    meta = api.split_metas_by_field(schema, metas)[i][0]
    fn = read_binary_column_fast if binary else read_column_fast
    return fn(fb, meta, schema[i])


def _page_codecs(path, i=0):
    from strawboat_tpu_torch.codecs import read_header
    from strawboat_tpu_torch.read.reader import read_meta

    with open(path, "rb") as f:
        meta = read_meta(f)[i]
    fb = np.memmap(path, dtype=np.uint8, mode="r")
    out, pos = set(), meta.offset
    for pg in meta.pages:
        out.add(read_header(fb[pos : pos + pg.length], 0)[0].name)
        pos += pg.length
    return out


def test_mixed_codec_column_fast_path(tmp_path):
    r = np.random.default_rng(0)
    page = 512
    v = np.concatenate([r.integers(0, 4, page) * 1_000_003, np.full(page, 77),
                        r.integers(-(1 << 62), 1 << 62, page), r.integers(0, 3, page) * 999_999_999])
    t = pa.table({"m": pa.array(v)}, schema=pa.schema([pa.field("m", pa.int64(), nullable=False)]))
    jpath, ppath = _fast_file(tmp_path, t, page)
    assert len(_page_codecs(ppath)) > 1
    arr = _fast(ppath, "m")
    assert arr is not None and arr.to_pylist() == v.tolist()
    read_both(jpath, ppath, t)


def test_bp_int32_column_fast_path(tmp_path):
    v = np.random.default_rng(1).integers(0, 1 << 14, 4096).astype(np.int32)
    t = pa.table({"b": pa.array(v)}, schema=pa.schema([pa.field("b", pa.int32(), nullable=False)]))
    jpath, ppath = _fast_file(tmp_path, t, 1024)
    assert "BITPACKING" in _page_codecs(ppath)
    assert _fast(ppath, "b").to_pylist() == v.tolist()
    read_both(jpath, ppath, t)


def test_raw_string_column_fast_path(tmp_path):
    r = np.random.default_rng(5)
    n = 1500
    vals = [f"{r.integers(0, 1 << 60):x}-{'x' * int(r.integers(0, 20))}" for _ in range(n)]
    nulls = r.random(n) < 0.15
    t = pa.table({"s": pa.array(vals, pa.string()),
                  "sn": pa.array([None if nu else v for v, nu in zip(vals, nulls)], pa.string())},
                 schema=pa.schema([pa.field("s", pa.string(), nullable=False),
                                   pa.field("sn", pa.string(), nullable=True)]))
    jpath, ppath = _fast_file(tmp_path, t, 512)
    for name in ("s", "sn"):
        arr = _fast(ppath, name, binary=True)
        assert arr is not None and arr.to_pylist() == t[name].to_pylist()
    read_both(jpath, ppath, t)


def test_onevalue_string_pages_fast_path(tmp_path):
    r = np.random.default_rng(7)
    page = 256
    a = np.concatenate([np.repeat("CONSTVAL", page),
                        np.array([f"u{r.integers(0, 1 << 50):x}" for _ in range(page)]),
                        np.repeat("OTHERCONST", page)])
    b = np.concatenate([np.repeat("zzz", page), np.array(["aa", "bb", "cc"])[r.integers(0, 3, page)],
                        np.repeat("yyy", page)])
    c = np.repeat("ONLYONE", page * 3)
    t = pa.table({"a": pa.array(a), "b": pa.array(b), "c": pa.array(c)},
                 schema=pa.schema([pa.field(n, pa.string(), nullable=False) for n in "abc"]))
    jpath, ppath = _fast_file(tmp_path, t, page)
    for name, src in (("a", a), ("b", b), ("c", c)):
        arr = _fast(ppath, name, binary=True)
        assert arr is not None and arr.to_pylist() == src.tolist(), name
    read_both(jpath, ppath, t)


def test_freq_string_pages_fast_path(tmp_path):
    r = np.random.default_rng(17)
    page = 256
    v = np.concatenate([np.where(r.random(page) < 0.95, "DOM", "rareX").astype(object),
                        np.repeat("CONST", page).astype(object),
                        np.array(["aa", "bb", "cc"], dtype=object)[r.integers(0, 3, page)]])
    t = pa.table({"s": pa.array(list(v), pa.string())},
                 schema=pa.schema([pa.field("s", pa.string(), nullable=False)]))
    jpath, ppath = _fast_file(tmp_path, t, page)
    assert "FREQ" in _page_codecs(ppath)
    assert _fast(ppath, "s", binary=True).to_pylist() == list(v)
    read_both(jpath, ppath, t)


def test_fast_path_falls_back_without_the_native_library(tmp_path, monkeypatch):
    """Without the native library the fast readers give None and the
    general reader's numpy routes give the same table."""
    from strawboat_tpu_torch import native

    table = pa.table({"i": pa.array(np.arange(3000, dtype=np.int32) % 700),
                      "s": create_random_string(3000, 0.1, 5)})
    jpath, ppath = write_both(tmp_path, table, *options("NONE", ratio=1.0))
    want = ref_api.read_table(jpath)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert _fast(ppath, "i") is None and _fast(ppath, "s", binary=True) is None
    assert_same(api.read_table(ppath), want)


# ---------------------------------------------------------------------------
# tests/test_fuzz.py's roundtrip: random schemas, data and codecs


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_roundtrip(tmp_path, seed):
    r = random.Random(1000 + seed)
    n_cols = r.randint(1, 4)
    n_rows = r.choice([1, 7, 100, 1000, 2049])
    null_p = r.choice([0.0, 0.1, 0.5])
    arrays = {}
    for ci in range(n_cols):
        t = rand_type(r, depth=2)
        arrays[f"c{ci}"] = pa.array([rand_value(r, t, null_p) for _ in range(n_rows)], type=t)
    table = pa.table(arrays)
    codec = r.choice(["LZ4", "ZSTD", "SNAPPY", "NONE"])
    ratio = r.choice([None, 1.0, 2.0])
    page = r.choice([64, 333, 1024, None])
    roundtrip(tmp_path, table, codec, ratio, page, seed)


# ---------------------------------------------------------------------------
# NativeWriter and write_file's fronts


def test_native_writer_writes_the_jax_writers_file(tmp_path):
    """A table written through ``NativeWriter`` (a ``pa.Schema``, a
    ``RecordBatch``) or ``write_file`` of numpy columns: the JAX writer's
    bytes."""
    import io

    from strawboat_tpu.write.writer import NativeWriter as RefWriter
    from strawboat_tpu_torch.write import NativeWriter

    table = pa.table({"a": create_random_i64(2000, 0.1), "s": create_random_string(2000, 0.0, 30),
                      "n": pa.nulls(2000)})
    ref_opts, opts = options(ratio=1.0, seed=1, zone_maps=True)
    a, b = io.BytesIO(), io.BytesIO()
    rw, w = RefWriter(a, table.schema, ref_opts), NativeWriter(b, table.schema, opts)
    for x in (rw, w):
        x.start()
        x.write(table.to_batches()[0])
        x.finish()
    assert a.getvalue() == b.getvalue() and w.total_size() == len(b.getvalue())
    assert set(w.zones) == set(rw.zones) == {"a"}
    plain = pa.table({"a": np.arange(1000), "f": np.linspace(0, 1, 1000)})
    c, d = io.BytesIO(), io.BytesIO()
    ref_api.write_file(c, plain, options=ref_opts)
    api.write_file(d, {"a": np.arange(1000), "f": np.linspace(0, 1, 1000)}, options=opts)
    assert c.getvalue() == d.getvalue()


# ---------------------------------------------------------------------------
# the null type through write, scan, Query, datasets, read and resident


def _null_table(n=3000):
    r = np.random.default_rng(3)
    return pa.table({"a": pa.array(r.integers(-1000, 1000, n)), "n": pa.nulls(n),
                     "s": create_random_string(n, 0.1, 6)})


@pytest.mark.parametrize("ratio", [None, 1.0])
def test_null_column_writes_and_reads_as_the_jax_package(tmp_path, ratio):
    table = _null_table()
    jpath, ppath = write_both(tmp_path, table, *options(ratio=ratio, page=1000))
    want = read_both(jpath, ppath, table)
    got = api.read_table(ppath)
    assert got.schema.field("n").type == pa.null() and got["n"].null_count == len(table)
    assert want.schema.field("n").type == pa.null()
    # the numpy front takes a null field of any column of its length
    from strawboat_tpu_torch.schema import Field

    npath = str(tmp_path / "numpy.str")
    api.write_file(npath, {"a": table["a"].to_numpy(), "n": np.zeros(len(table), np.int8)},
                   schema=[Field("a", "int64"), Field("n", "null")],
                   options=options(ratio=ratio, page=1000)[1])
    ref = str(tmp_path / "ref.str")
    ref_api.write_file(ref, table.select(["a", "n"]), options=options(ratio=ratio, page=1000)[0])
    with open(npath, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_null_column_scans_as_the_jax_scan(tmp_path):
    """``scan_file``, ``scan_chunks``, pruned scans and ``scan_dataset``
    give the null column as the JAX scan does: int32 zeros, validity all
    False; ``DeviceTable.to_arrow`` gives int32 nulls, as the reference
    does (not ``null``)."""
    import torch

    from strawboat_tpu.exec import pruning as ref_pruning
    from strawboat_tpu.exec.dataset import scan_dataset as ref_scan_dataset
    from strawboat_tpu.exec.scan import scan_chunks as ref_chunks, scan_file as ref_scan
    from strawboat_tpu_torch.exec import pruning, scan_dataset, scan_file
    from strawboat_tpu_torch.exec.scan import scan_chunks

    table = _null_table()
    jpath, ppath = write_both(tmp_path, table, *options(ratio=1.0, page=1000, zone_maps=True))
    got = scan_file(ppath, "cpu")
    n = got["n"]
    assert n.values.dtype == torch.int32 and not n.values.any() and not n.validity.any()
    assert len(n) == got.num_rows == len(table)
    arrow = got.to_arrow()
    assert arrow.schema.field("n").type == pa.int32() and arrow["n"].null_count == len(table)
    assert_same(arrow, ref_scan(jpath).to_arrow())
    for x, y in zip(scan_chunks(ppath, 2, "cpu"), ref_chunks(jpath, 2)):
        assert x.num_rows == y.num_rows
        assert_same(x.to_arrow(), y.to_arrow())
    preds = [pruning.Comparison("a", "lt", -500)]
    ref_preds = [ref_pruning.Comparison("a", "lt", -500)]
    assert_same(scan_file(ppath, "cpu", predicates=preds).to_arrow(),
                ref_scan(jpath, predicates=ref_preds).to_arrow())
    assert_same(scan_dataset([ppath, ppath], "cpu").to_arrow(),
                ref_scan_dataset([jpath, jpath]).to_arrow())


def test_null_column_through_query_and_datasets(tmp_path):
    from strawboat_tpu.exec import Query as RefQuery, col as ref_col
    from strawboat_tpu_torch.exec import Query, col
    from strawboat_tpu_torch.exec.dataset import write_dataset

    table = _null_table()
    jpath, ppath = write_both(tmp_path, table, *options(ratio=1.0, page=1000))
    for q, rq in ((Query(ppath, device="cpu"), RefQuery(jpath)),
                  (Query(ppath, device="cpu").filter(col("a") > 0).select("a", "n"),
                   RefQuery(jpath).filter(ref_col("a") > 0).select("a", "n"))):
        (got, mask), (want, ref_mask) = q.run(), rq.run()
        assert_same(got.to_arrow(mask), want.to_arrow(ref_mask))
    parts = write_dataset(str(tmp_path / "ds"), table, 1000, options=options(ratio=1.0)[1])
    assert len(parts) == 3
    got, _ = Query(parts, device="cpu").run()
    assert got.to_arrow()["n"].null_count == len(table)


def test_null_column_load_resident_raises_as_the_jax_one(tmp_path):
    from strawboat_tpu.exec.resident import load_resident as ref_load
    from strawboat_tpu_torch.exec import load_resident

    jpath, ppath = write_both(tmp_path, _null_table(500), *options(ratio=None))
    msg = "resident load of column 'n' type null"
    with pytest.raises(NotYetImplementedError, match=msg):
        load_resident(ppath, "cpu")
    with pytest.raises(Exception, match=msg):
        ref_load(jpath)
    assert load_resident(ppath, "cpu", columns=["a"]).num_rows == 500


def test_null_column_cuda_scan_needs_a_card(tmp_path):
    import torch

    from strawboat_tpu_torch.exec import scan_file

    _, ppath = write_both(tmp_path, _null_table(100), *options(ratio=None))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception, match="(?i)cuda"):
        scan_file(ppath, "cuda", columns=["n"])


# ---------------------------------------------------------------------------
# the examples, on the CPU at a tiny size


def test_examples_write_read_batch_read(tmp_path):
    path = str(tmp_path / "example.str")
    env = {**os.environ, "PYTHONPATH": ROOT}
    outs = []
    for script, args in (("torch_strawboat_write.py", ["--rows", "3000", path]),
                         ("torch_strawboat_read.py", [path]),
                         ("torch_strawboat_batch_read.py", [path])):
        run = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), *args],
                             cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr[-2000:]
        outs.append(run.stdout)
    assert "3000 rows" in outs[0] and "read 3000 rows" in outs[1] and "read 3000 rows" in outs[2]
    assert os.path.exists(path + ".meta.json")
    assert api.read_table(path).num_rows == 3000


@pytest.mark.parametrize("flag", ["DICT_ENV", "FREQ_ENV", "RLE_ENV", "PATAS_ENV", "BITPACK_ENV"])
def test_forced_codecs_roundtrip(tmp_path, monkeypatch, flag):
    """Every structured page the forcing flags make, through both writers
    and both readers (the host page decoders of ``codecs/``)."""
    from strawboat_tpu.util import env as ref_env

    monkeypatch.setenv(getattr(ref_env, flag), "1")
    n = 2048 + 37
    r = np.random.default_rng(11)
    table = pa.table({
        "i32": pa.array(r.integers(0, 300, n).astype(np.int32)),
        "u32": pa.array(np.sort(r.integers(0, 1 << 20, n)).astype(np.uint32)),
        "i64": create_random_i64(n, 0.1),
        "f64": create_random_double(n, 0.1),
        "f32": pa.array(np.round(r.normal(size=n), 2).astype(np.float32)),
        "b": create_random_bool(n, 0.2),
        "s": create_random_string(n, 0.1, 40),
        "ls": pa.array([f"v{i % 7}" * (i % 3) for i in range(n)], type=pa.large_string()),
        "d": pa.array([None if i % 9 == 0 else i % 50 for i in range(n)], type=pa.decimal128(10, 2)),
        "t": pa.array(r.integers(0, 10**12, n), type=pa.timestamp("us")),
        "n": pa.nulls(n),
        "l": pa.array([[i % 5, None] if i % 4 else None for i in range(n)], type=pa.list_(pa.int32())),
    })
    roundtrip(tmp_path, table, "LZ4", None, 1024)
