"""The file scan path of the torch port against the JAX package.

Files written by the JAX ``write_file`` (default options, each forcing
flag, the tpch_bench options, raw LZ4 / Zstd / Snappy pages) scan in the
port exactly as the JAX ``scan_file`` reads them and as numpy holds them,
nullable columns included.  Files written by the port's ``write_file``
have the JAX writer's page bytes and metas under the same flags, and the
JAX reader reads them back.  Everything runs on the CPU, where K3 and the
other device decoders run their plain torch versions.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.codecs import read_header as ref_read_header
from strawboat_tpu.exec.scan import scan_file as ref_scan
from strawboat_tpu.meta import serialize_metas as ref_serialize_metas
from strawboat_tpu.read.reader import read_meta as ref_read_meta
from strawboat_tpu.util.env import _ALL as FLAG_NAMES
from strawboat_tpu.write.writer import write_file as ref_write
from strawboat_tpu_torch import native
from strawboat_tpu_torch.benchsuite import tpch
from strawboat_tpu_torch.codecs import WriteOptions
from strawboat_tpu_torch.constants import Compression
from strawboat_tpu_torch.errors import NotYetImplementedError, OutOfSpecError, StrawboatError
from strawboat_tpu_torch.exec import scan_file
from strawboat_tpu_torch.exec import scan as port_scan
from strawboat_tpu_torch.exec.scan import host_values
from strawboat_tpu_torch.kernels import bitunpack as bu
from strawboat_tpu_torch.meta import serialize_metas
from strawboat_tpu_torch.read.reader import infer_schema, read_meta
from strawboat_tpu_torch.write import write_file

DICT, BP = "STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION"
RLE, FREQ = "STRAWBOAT_RLE_COMPRESSION", "STRAWBOAT_FREQ_COMPRESSION"
WRITER_FLAGS = {  # what the port's writer takes
    "default": (),
    "dict": (DICT,),
    "bitpack": (BP,),
    "dict_bitpack": (DICT, BP),
}
READ_FLAGS = {**WRITER_FLAGS, "rle": (RLE,), "freq": (FREQ,), "freq_bitpack": (FREQ, BP)}


@pytest.fixture
def flags(monkeypatch):
    def set_flags(names):
        for n in FLAG_NAMES:
            monkeypatch.delenv(n, raising=False)
        for n in names:
            monkeypatch.setenv(n, "1")

    set_flags(())
    return set_flags


def _columns(rows=3000, seed=0):
    """numpy columns of every flat integer type; ``i32n`` has nulls."""
    rng = np.random.default_rng(seed)
    null = rng.random(rows) < 0.2
    null[:3] = [True, False, True]  # a leading null takes the dict's null rule
    return {
        "i8": rng.integers(-100, 100, rows).astype(np.int8),
        "u8": rng.integers(0, 256, rows).astype(np.uint8),
        "i16": rng.integers(-30000, 30000, rows).astype(np.int16),
        "u16": rng.integers(0, 1 << 16, rows).astype(np.uint16),
        "i32": rng.integers(0, 1000, rows).astype(np.int32),
        "i32n": np.ma.MaskedArray(rng.integers(-50, 50, rows).astype(np.int32), mask=null),
        "u32": rng.integers(0, 1 << 32, rows, dtype=np.uint64).astype(np.uint32),
        "i64": rng.integers(-(2**62), 2**62, rows).astype(np.int64),
        "u64": rng.integers(0, 2**64 - 1, rows, dtype=np.uint64),
        "d32": np.sort(rng.integers(8000, 12000, rows)).astype("datetime64[D]"),
        "const": np.full(rows, 123456789, dtype=np.int64),
        "runs": np.repeat(rng.integers(0, 1 << 20, rows // 8 + 1), 8)[:rows].astype(np.int32),
        "freq": np.where(rng.random(rows) < 0.97, 1000, rng.integers(0, 1 << 40, rows)).astype(np.int64),
        "sorted": (np.arange(rows) * 3).astype(np.int32),
        "okey": np.repeat(np.arange(rows // 4 + 1), 4)[:rows].astype(np.int64),
    }


def _arrow(cols):
    arrays = {}
    for k, v in cols.items():
        if isinstance(v, np.ma.MaskedArray):
            arrays[k] = pa.array(np.ma.getdata(v), mask=np.ma.getmaskarray(v))
        else:
            arrays[k] = pa.array(v)
    return pa.table(arrays)


def _expected(col):
    """(storage values, validity or None) as the scan must return them."""
    validity = None
    if isinstance(col, np.ma.MaskedArray):
        validity = ~np.ma.getmaskarray(col)
        col = np.ma.getdata(col)
    if col.dtype.kind == "M":
        col = col.view(np.int64).astype(np.int32)
    return col, validity


def _footer_only(schema) -> bytes:
    """A file of ``schema`` whose columns have no pages: the magic, then
    the footer the JAX writer would write for it."""
    from strawboat_tpu.meta import ColumnMeta
    from strawboat_tpu.schema import n_leaf_columns, schema_to_bytes

    sb = schema_to_bytes(schema)
    mb = ref_serialize_metas([ColumnMeta(8, []) for f in schema
                              for _ in range(n_leaf_columns(f.type))])
    return (b"ARROW2\0\0" + sb + mb + len(sb).to_bytes(4, "little")
            + len(mb).to_bytes(4, "little") + b"\xff\xff\xff\xff\0\0\0\0")


def _check_scan(path, cols, columns=None):
    """The port's scan == numpy (valid slots) and == the JAX scan (all
    slots, so null slots decode alike)."""
    got = scan_file(path, "cpu", columns=columns)
    ref = ref_scan(path, columns=columns)
    names = columns or list(cols)
    assert list(got.columns) == list(names)
    for k in names:
        want, validity = _expected(cols[k])
        vals = host_values(got[k])
        assert vals.dtype == want.dtype, k
        assert got.num_rows == len(want)
        ref_vals = np.asarray(ref[k].values)
        np.testing.assert_array_equal(vals, ref_vals.astype(want.dtype), err_msg=k)
        if validity is None:
            assert got[k].validity is None, k
            np.testing.assert_array_equal(vals, want, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].validity.numpy(), validity, err_msg=k)
            np.testing.assert_array_equal(vals[validity], want[validity], err_msg=k)
    return got


def _page_codecs(path):
    """{(codec, inner codec or None)} over every page of the file."""
    out = set()
    with open(path, "rb") as f:
        metas = ref_read_meta(f)
        data = f.seek(0) or f.read()
    schema_nullable = True  # every field written here is nullable
    for m in metas:
        pos = m.offset
        for page in m.pages:
            buf = np.frombuffer(data, np.uint8, page.length, pos)
            p = 4 + int(np.frombuffer(buf, "<u4", 1, 0)[0]) if schema_nullable else 0
            codec, _c, _u, body = ref_read_header(buf, p)
            inner = None
            if codec == Compression.DICT:
                inner = ref_read_header(buf, body)[0]
            out.add((codec, inner))
            pos += page.length
    return out


# ---------------------------------------------------------------------------
# files from the JAX writer


@pytest.mark.parametrize("name", list(READ_FLAGS))
def test_scan_of_reference_file_under_forcing(tmp_path, flags, name):
    flags(READ_FLAGS[name])
    cols = _columns()
    path = str(tmp_path / "ref.str")
    ref_write(path, _arrow(cols), options=RefOptions(max_page_size=1024))
    _check_scan(path, cols)


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_of_reference_file_with_ratio_competition(tmp_path, flags, seed):
    """ratio 1.0 lets every integer codec win somewhere: RLE, DICT (with
    BP, ΔBP and raw codes), FREQ, ONE_VALUE, BP, ΔBP."""
    cols = _columns(rows=5000, seed=seed)
    path = str(tmp_path / "ratio.str")
    ref_write(
        path,
        _arrow(cols),
        options=RefOptions(default_compress_ratio=1.0, max_page_size=2048, sample_seed=seed),
    )
    codecs = _page_codecs(path)
    for c in (Compression.RLE, Compression.DICT, Compression.FREQ, Compression.ONE_VALUE,
              Compression.BITPACKING, Compression.DELTA_BITPACKING):
        assert any(c == k for k, _i in codecs), (c, codecs)
    _check_scan(path, cols)


@pytest.mark.parametrize("codec", [Compression.LZ4, Compression.ZSTD, Compression.SNAPPY])
def test_scan_of_compressed_raw_pages(tmp_path, flags, codec):
    cols = _columns()
    path = str(tmp_path / "raw.str")
    ref_write(path, _arrow(cols), options=RefOptions(default_compression=codec, max_page_size=1024))
    assert {c for c, _i in _page_codecs(path)} == {codec}
    _check_scan(path, cols)


def test_scan_of_tpch_bench_file(tmp_path, flags):
    """The options of examples/tpch_bench.py: LZ4, ratio 1.0, pages of
    65536, sample seed 0, zone maps (an in-band block the scan skips)."""
    from strawboat_tpu.benchsuite.tpch import generate_lineitem as ref_generate

    table = ref_generate(1.0, seed=0, rows=140_000)
    path = str(tmp_path / "lineitem.str")
    ref_write(
        path,
        table,
        options=RefOptions(
            default_compression=Compression.LZ4, default_compress_ratio=1.0,
            max_page_size=65536, sample_seed=0, zone_maps=True,
        ),
    )
    cols = tpch.generate_lineitem(1.0, seed=0, rows=140_000)
    got = _check_scan(path, cols, columns=list(tpch.INT_COLUMNS))
    assert int(tpch.q6(got)) == tpch.q6_numpy_reference(cols)
    # the string columns scan as dictionary codes, as in the JAX scan
    whole = scan_file(path, "cpu")
    ref = ref_scan(path)
    for k in ("l_returnflag", "l_linestatus", "l_shipmode"):
        np.testing.assert_array_equal(whole[k].values.numpy(), np.asarray(ref[k].values))
        assert list(whole[k].dictionary) == ref[k].dictionary.to_pylist()
        d = np.array([v.decode() for v in whole[k].dictionary])
        np.testing.assert_array_equal(d[whole[k].values.numpy()], cols[k])


# ---------------------------------------------------------------------------
# files from the port's writer


def _page_region(path):
    with open(path, "rb") as f:
        metas = ref_read_meta(f)
        f.seek(0)
        data = f.read()
    end = metas[-1].offset + metas[-1].total_len()
    return metas, data[:end]


@pytest.mark.parametrize("name", list(WRITER_FLAGS))
def test_port_writer_matches_reference_writer(tmp_path, flags, name):
    flags(WRITER_FLAGS[name])
    cols = _columns()
    port_path, ref_path = str(tmp_path / "port.str"), str(tmp_path / "ref.str")
    metas = write_file(port_path, cols, options=WriteOptions(max_page_size=1024))
    ref_metas = ref_write(ref_path, _arrow(cols), options=RefOptions(max_page_size=1024))
    assert serialize_metas(metas) == ref_serialize_metas(ref_metas)
    got_metas, got_pages = _page_region(port_path)
    want_metas, want_pages = _page_region(ref_path)
    assert got_metas == want_metas
    assert got_pages == want_pages
    # the JAX reader reads the port's file, and so does the port
    _check_scan(port_path, cols)
    with open(port_path, "rb") as f:
        assert [fl.name for fl in infer_schema(f)] == list(cols)
        assert read_meta(f) == metas


def test_bitpack_gate_leaves_short_tail_page_raw(tmp_path, flags):
    """Forced BITPACKING needs 4-byte values and a multiple of 128 rows:
    the 488-row tail page and every int64 page stay NONE."""
    flags((BP,))
    cols = {"a": np.arange(1000, dtype=np.int32) * 7, "b": np.arange(1000, dtype=np.int64)}
    port_path, ref_path = str(tmp_path / "port.str"), str(tmp_path / "ref.str")
    write_file(port_path, cols, options=WriteOptions(max_page_size=512))
    ref_write(ref_path, _arrow(cols), options=RefOptions(max_page_size=512))
    assert _page_region(port_path) == _page_region(ref_path)
    assert _page_codecs(port_path) == {(Compression.BITPACKING, None), (Compression.NONE, None)}
    _check_scan(port_path, cols)


@pytest.mark.parametrize("native_lib", [True, False])
def test_block_widths_of_a_truncated_page_raise(monkeypatch, native_lib):
    """Mixed block widths walk the headers (C, or Python without the
    native library); a page cut inside its last block or short of its
    block count raises either way."""
    if not native_lib:
        monkeypatch.setattr(native, "_load", lambda: None)
    buf = np.frombuffer(bytes([5]) + bytes(80) + bytes([7]) + bytes(112), np.uint8)
    assert list(port_scan._block_widths(buf, 0, 2)) == [5, 7]
    for cut, n_blocks in ((buf[:-1], 2), (buf, 3)):
        with pytest.raises(OutOfSpecError):
            port_scan._block_widths(cut, 0, n_blocks)


def test_writer_raises_for_what_it_does_not_have(tmp_path, flags):
    cols = {"a": np.arange(256, dtype=np.int32)}
    path = str(tmp_path / "x.str")
    for opts in (WriteOptions(default_compress_ratio=1.0),
                 WriteOptions(default_compression=Compression.LZ4)):
        with pytest.raises(NotYetImplementedError):
            write_file(path, cols, options=opts)
    for flag in (FREQ, RLE):
        flags((flag,))
        with pytest.raises(NotYetImplementedError):
            write_file(path, cols)
    flags(())
    with pytest.raises(NotYetImplementedError):  # floats write now; complex never
        write_file(path, {"f": np.zeros(4, np.complex128)})


def test_scan_raises_for_what_it_does_not_have(tmp_path, flags):
    """Predicates prune a file with a zone block and leave a file without
    one whole, as the reference does; a predicate the port cannot use
    raises rather than scan unpruned; float, timestamp and nested columns
    (in ``scan_chunks`` too) scan now, while unions and intervals raise."""
    from strawboat_tpu_torch.exec.pruning import Comparison

    path = str(tmp_path / "x.str")
    write_file(path, {"a": np.arange(256, dtype=np.int32)})
    lt3 = [Comparison("a", "lt", 3)]
    np.testing.assert_array_equal(scan_file(path, "cpu", predicates=lt3)["a"].values.numpy(),
                                  np.arange(256))
    zpath = str(tmp_path / "z.str")
    ref_write(zpath, _arrow({"a": np.arange(256, dtype=np.int32)}),
              options=RefOptions(zone_maps=True, max_page_size=64))
    np.testing.assert_array_equal(scan_file(zpath, "cpu", predicates=lt3)["a"].values.numpy(),
                                  np.arange(64))
    with pytest.raises(TypeError):
        scan_file(zpath, "cpu", predicates=[("a", "lt", 3)])
    fpath = str(tmp_path / "f.str")
    ref_write(fpath, pa.table({"f": pa.array([1.5, 2.5])}))
    assert scan_file(fpath, "cpu")["f"].values.tolist() == [1.5, 2.5]
    tpath = str(tmp_path / "t.str")
    ref_write(tpath, pa.table({"t": pa.array([1, 2], pa.timestamp("us"))}))
    assert scan_file(tpath, "cpu")["t"].values.tolist() == [1, 2]
    npath = str(tmp_path / "n.str")
    ref_write(npath, pa.table({"l": pa.array([[1], [2, 3]])}))
    assert next(port_scan.scan_chunks(npath, 1, "cpu"))["l"].values.tolist() == [1, 2, 3]
    for arr in (pa.UnionArray.from_sparse(pa.array([0, 1], pa.int8()),
                                          [pa.array([1, 2]), pa.array([0.5, 1.5])]),
                pa.array([pa.MonthDayNano([1, 2, 3])], pa.month_day_nano_interval())):
        upath = str(tmp_path / "u.str")
        with open(upath, "wb") as fh:  # the schema of such a column, no pages
            fh.write(_footer_only(pa.schema([pa.field("u", arr.type)])))
        with pytest.raises(NotYetImplementedError):
            scan_file(upath, "cpu")
    with pytest.raises(ValueError):
        scan_file(path, None)


def test_scan_of_empty_and_one_page_files(tmp_path, flags):
    flags((DICT, BP))
    path = str(tmp_path / "x.str")
    cols = {"a": np.arange(640, dtype=np.int32) % 5, "n": np.ma.MaskedArray(
        np.arange(640, dtype=np.int64), mask=np.arange(640) % 3 == 0)}
    write_file(path, cols)
    _check_scan(path, cols)
    write_file(path, {"a": np.zeros(0, np.int32)})
    got = scan_file(path, "cpu")
    assert got.num_rows == 0 and got["a"].values.dtype == torch.int32


def test_lineitem_scan_q6_and_k3_groups(tmp_path, flags):
    """The slice at a small size: both files of the chip run, Q6 over each
    scan, the K3 groups as the chip run sees them (no launch on the CPU)."""
    # 8 full pages and a tail of 34 blocks, as SF10 has 915 and 270
    cols = tpch.generate_lineitem(1.0, seed=0, rows=8 * 8192 + 34 * 128)
    for names in ((DICT, BP), (BP,)):
        flags(names)
        path = str(tmp_path / f"lineitem_{len(names)}.str")
        tpch.write_lineitem(path, cols, max_page_size=8192, columns=tpch.INT_COLUMNS)
        before = bu.bitunpack_natural.launches
        got = _check_scan(path, {k: cols[k] for k in tpch.INT_COLUMNS})
        assert bu.bitunpack_natural.launches == before
        assert int(tpch.q6(got)) == tpch.q6_numpy_reference(cols)
        jobs = {}
        schema, metas, file_bytes = port_scan._open(path)
        for meta, field in port_scan._selected(schema, metas, None):
            plans = port_scan._plan_pages(file_bytes, meta, field.nullable)
            storage = np.dtype(port_scan.FLAT_INT_TYPES[field.dtype])
            _raw, k3, bpv = port_scan._sort_jobs(plans, storage)
            dj = sum(j[1] == Compression.DICT for j in k3)
            jobs[field.name] = (len(k3) - dj, dj, len(bpv))
        # (uniform BP pages, uniform dict pages, mixed-width pages)
        if names == (BP,):
            assert sum(jobs["l_shipdate"]) == 9 and jobs["l_shipdate"][0] > 0
            assert jobs["l_orderkey"] == (0, 0, 0)  # int64 stays raw
        else:
            assert jobs["l_quantity"][1] > 0 and sum(jobs["l_quantity"]) == 9
            assert jobs["l_orderkey"][2] > 0
        # one launch group per (codec, b), covering every K3 page once
        groups = port_scan.k3_launch_groups(path)
        assert len({(c, g) for c, g, _p, _w in groups}) == len(groups)
        for col, (codec, b), pages, words in groups:
            assert words.shape == (sum(64 if i < 8 else 34 for i in pages), 4 * b)
            assert codec == (Compression.BITPACKING if names == (BP,) else Compression.DICT)
        assert sum(len(p) for _c, _g, p, _w in groups) == sum(
            j[0] + j[1] for j in jobs.values())


@pytest.mark.parametrize("name", ["default", "dict_bitpack"])
def test_scanned_table_to_arrow_equals_reference_host_read(tmp_path, flags, name):
    """``to_arrow`` of a scan (unsigned and date32 types, nulls) equals the
    JAX package's host reader on the same file."""
    from strawboat_tpu.api import read_table

    flags(WRITER_FLAGS[name])
    cols = _columns(rows=1500)
    path = str(tmp_path / "x.str")
    write_file(path, cols, options=WriteOptions(max_page_size=512))
    got = scan_file(path, "cpu").to_arrow()
    want = read_table(path)
    assert got.schema.equals(want.schema)
    assert got.equals(want)


def test_without_the_native_library(tmp_path, flags, monkeypatch):
    """Where the port's ``native`` library does not load: the writer packs
    and factorizes in numpy, the scan walks block headers in Python, and
    both agree with the reference; a raw LZ4 page raises instead of falling
    back."""
    lz4_path = str(tmp_path / "lz4.str")
    cols = _columns(rows=2000)
    ref_write(lz4_path, _arrow(cols), options=RefOptions(default_compression=Compression.LZ4))
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    flags((DICT, BP))
    port_path, ref_path = str(tmp_path / "port.str"), str(tmp_path / "ref.str")
    write_file(port_path, cols, options=WriteOptions(max_page_size=1024))
    ref_write(ref_path, _arrow(cols), options=RefOptions(max_page_size=1024))
    assert _page_region(port_path) == _page_region(ref_path)
    assert any(k == Compression.DICT and i == Compression.BITPACKING
               for k, i in _page_codecs(port_path))
    _check_scan(port_path, cols)
    with pytest.raises(StrawboatError):
        scan_file(lz4_path, "cpu")
