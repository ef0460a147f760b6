"""The device writer of the torch port against the JAX package.

``write_device_table`` over the port's scan of a file gives the JAX
``write_device_table``'s bytes over the JAX scan of the same file, under
the same options (``tests/test_device_write.py``'s 16 cases, each also
read back by the JAX reader and checked for its codecs through the JAX
``stat`` layer).  A table of list columns alone gets the row count of its
rows on both sides: the JAX scan counts 0 rows for it, and the JAX writer
takes its page grid from that count.  ``paged_stats_device`` and
``paged_bool_stats_device`` equal the JAX reductions field for field on
signed, unsigned (values at and above 2^31 and 2^63), float and nullable
columns with tail pages; ``unique_est`` is exact here (float32 log on
both sides).  Everything runs on the CPU.
"""

import dataclasses
import os
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import strawboat_tpu.kernels  # noqa: F401  (JAX x64 on)
from strawboat_tpu.api import read_table as ref_read_table
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.exec.pruning import read_zones as ref_read_zones
from strawboat_tpu.exec.scan import scan_file as ref_scan
from strawboat_tpu.kernels import encode as ref_encode
from strawboat_tpu.read.reader import infer_schema, open_readers, read_meta
from strawboat_tpu.stat import stat_simple
from strawboat_tpu.util.env import _ALL as FLAG_NAMES
from strawboat_tpu.write.device import write_device_table as ref_write_device_table
from strawboat_tpu_torch.codecs import WriteOptions
from strawboat_tpu_torch.constants import Compression
from strawboat_tpu_torch.exec import scan_file
from strawboat_tpu_torch.exec.pruning import Comparison
from strawboat_tpu_torch.exec.scan import DeviceColumn, DeviceTable, host_values
from strawboat_tpu_torch.kernels import encode
from strawboat_tpu_torch.write.device import write_device_table

DICT = "STRAWBOAT_DICT_COMPRESSION"


@pytest.fixture(autouse=True)
def _no_flags(monkeypatch):
    for n in FLAG_NAMES:
        monkeypatch.delenv(n, raising=False)


def _page_kinds(path):
    """column name → the set of its page body kinds (the JAX stat layer)."""
    with open(path, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    out = {}
    for i, field in enumerate(schema):
        readers = open_readers(path, [metas[i]])
        info = stat_simple(readers[0], field)
        for r in readers:
            r.page_reader.close()
        out[field.name] = {p.body.kind for p in info.pages}
    return out


def _opts(**kw):
    """The port's and the JAX package's WriteOptions: LZ4, pages of 1024."""
    kw.setdefault("max_page_size", 1024)
    port = WriteOptions(default_compression=Compression.LZ4, **kw)
    ref = RefOptions(default_compression=RefCompression.LZ4, **kw)
    return port, ref


def _rows(table) -> int:
    return max((len(c) for c in table.columns.values()), default=0)


def _device_write(tmp_path, port_table, ref_table, **kw):
    """Both device writers over their scans of one file; their bytes are
    equal → the port's file's path."""
    port_opts, ref_opts = _opts(**kw)
    dst, ref_dst = str(tmp_path / "dst.str"), str(tmp_path / "ref_dst.str")
    if ref_table.num_rows == 0:  # the JAX scan of list columns alone counts 0 rows
        ref_table = dataclasses.replace(ref_table, num_rows=_rows(ref_table))
    write_device_table(dst, port_table, port_opts)
    ref_write_device_table(ref_dst, ref_table, ref_opts)
    assert open(dst, "rb").read() == open(ref_dst, "rb").read()
    return dst


def _roundtrip(tmp_path, table, flags=(), **kw):
    """arrow → file (the JAX writer) → both scans → both device writers →
    the JAX reader."""
    src = str(tmp_path / "src.str")
    for n in flags:
        os.environ[n] = "1"
    try:
        ref_write(src, table, options=_opts()[1])
    finally:
        for n in flags:
            del os.environ[n]
    dst = _device_write(tmp_path, scan_file(src, "cpu"), ref_scan(src), **kw)
    return ref_read_table(dst), dst


def test_numeric_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    n = 5000
    table = pa.table({
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int64)),
        "f": pa.array(rng.random(n)),
        "u": pa.array(rng.integers(0, 1 << 20, n).astype(np.uint32)),
        "u64": pa.array(rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64)),
        "f32": pa.array(rng.integers(0, 9, n).astype(np.float32)),
    })
    got, _ = _roundtrip(tmp_path, table)
    assert got.equals(table.cast(got.schema))


def test_adaptive_choices_from_device_stats(tmp_path):
    n = 2048
    table = pa.table({
        "const": pa.array(np.full(n, 7, dtype=np.int64)),
        "sorted_u32": pa.array(np.arange(n, dtype=np.uint32) * 3, pa.uint32()),
        "lowcard": pa.array(np.random.default_rng(1).integers(0, 4, n).astype(np.int64)),
    })
    got, dst = _roundtrip(tmp_path, table, default_compress_ratio=1.0)
    assert got.equals(table.cast(got.schema))
    kinds = _page_kinds(dst)
    assert kinds["const"] == {"one_value"}
    assert kinds["sorted_u32"] <= {"delta_bitpack", "bitpack"}
    assert kinds["lowcard"] == {"dict"}


def test_nullable_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    n = 4000
    table = pa.table({"x": pa.array(rng.integers(0, 100, n).astype(np.int64), mask=rng.random(n) < 0.25),
                      "y": pa.array(rng.random(n))})
    got, _ = _roundtrip(tmp_path, table, default_compress_ratio=1.0, sample_seed=3)
    assert got.column("x").to_pylist() == table.column("x").to_pylist()
    assert got.column("y").to_pylist() == table.column("y").to_pylist()


def test_string_dict_direct_roundtrip(tmp_path, monkeypatch):
    """String columns become DICT pages straight from the device codes: no
    row of a string is built (the row encoders must not run)."""
    from strawboat_tpu_torch.codecs import binary as port_binary
    from strawboat_tpu_torch.write import device as port_device

    rng = np.random.default_rng(3)
    words = [f"city-{i}" for i in range(23)]
    vals = [words[i] for i in rng.integers(0, len(words), 4000)]
    src = str(tmp_path / "src.str")
    os.environ[DICT] = "1"
    try:
        ref_write(src, pa.table({"s": pa.array(vals, pa.string())}), options=_opts()[1])
    finally:
        del os.environ[DICT]
    table, ref_table = scan_file(src, "cpu"), ref_scan(src)

    def boom(*a, **k):
        raise AssertionError("a row-wise string encoder ran on the device path")

    for mod, name in ((port_binary, "dict_encode"), (port_binary, "factorize_slices"),
                      (port_binary, "compress_binary"), (port_device, "_leaf_model")):
        monkeypatch.setattr(mod, name, boom)
    dst = _device_write(tmp_path, table, ref_table)
    assert ref_read_table(dst).column("s").to_pylist() == vals
    assert _page_kinds(dst)["s"] == {"dict"}


def test_nullable_string_roundtrip(tmp_path):
    rng = np.random.default_rng(7)
    vals = [None if rng.random() < 0.2 else f"w{int(i)}" for i in rng.integers(0, 30, 3000)]
    got, _ = _roundtrip(tmp_path, pa.table({"s": pa.array(vals, pa.string())}), flags=(DICT,),
                        default_compress_ratio=1.0)
    assert got.column("s").to_pylist() == vals


def test_shuffle_then_device_encode(tmp_path):
    """Rows re-ordered on the device (sorted by key, a stand-in for an
    exchange), then re-encoded: the same permutation on both sides gives
    the same bytes, and the sorted key compresses structurally."""
    rng = np.random.default_rng(4)
    n = 6000
    table = pa.table({"k": pa.array(rng.integers(0, 64, n).astype(np.int64)),
                      "v": pa.array(rng.integers(0, 1 << 30, n).astype(np.int64))})
    src = str(tmp_path / "src.str")
    ref_write(src, table, options=_opts(max_page_size=2048)[1])
    dt, rdt = scan_file(src, "cpu"), ref_scan(src)
    order = torch.argsort(dt["k"].values, stable=True)
    shuffled = DeviceTable({name: DeviceColumn(name, c.dtype, c.values[order], None)
                            for name, c in dt.columns.items()}, dt.num_rows)
    from strawboat_tpu.exec.scan import DeviceColumn as RefColumn, DeviceTable as RefTable

    rorder = jnp.argsort(rdt["k"].values)
    assert np.array_equal(np.asarray(rorder), order.numpy())
    ref_shuffled = RefTable({name: RefColumn(name, c.dtype, c.values[rorder], None)
                             for name, c in rdt.columns.items()}, rdt.num_rows)
    dst = _device_write(tmp_path, shuffled, ref_shuffled, max_page_size=2048,
                        default_compress_ratio=1.0)
    got = ref_read_table(dst)
    got_k = np.asarray(got.column("k"))
    assert (np.diff(got_k) >= 0).all()
    assert sorted(zip(got_k.tolist(), np.asarray(got.column("v")).tolist())) == sorted(
        zip(np.asarray(table.column("k")).tolist(), np.asarray(table.column("v")).tolist()))
    assert _page_kinds(dst)["k"] & {"rle", "dict", "delta_bitpack", "bitpack", "one_value"}


def test_empty_table(tmp_path):
    got, _ = _roundtrip(tmp_path, pa.table({"a": pa.array([], pa.int64())}))
    assert got.num_rows == 0


def test_decimal_roundtrip(tmp_path):
    vals = [Decimal("1.23"), Decimal("-45.10"), None, Decimal("999.99")] * 300
    got, _ = _roundtrip(tmp_path, pa.table({"d": pa.array(vals, pa.decimal128(12, 2))}),
                        default_compress_ratio=1.0)
    assert got.column("d").to_pylist() == vals


def test_device_write_emits_zone_maps(tmp_path):
    n = 8192
    table = pa.table({"k": pa.array(np.arange(n, dtype=np.int64)),
                      "f": pa.array(np.arange(n, dtype=np.float64) / 8)})
    src = str(tmp_path / "zsrc.str")
    ref_write(src, table, options=_opts(zone_maps=True)[1])
    dst = _device_write(tmp_path, scan_file(src, "cpu"), ref_scan(src), zone_maps=True)
    zones = ref_read_zones(dst)
    assert len(zones["k"].pages) == 8
    assert zones["k"].pages[0].min == 0 and zones["k"].pages[0].max == 1023
    assert zones["f"].pages[-1].max == (n - 1) / 8
    pruned = scan_file(dst, "cpu", predicates=[Comparison("k", "ge", 7168)])
    np.testing.assert_array_equal(pruned["k"].values.numpy(), np.arange(7168, 8192))


def test_device_write_zone_maps_nullable_and_bool(tmp_path):
    n = 4096
    rng = np.random.default_rng(5)
    vals = np.arange(n, dtype=np.int64)
    mask = rng.random(n) < 0.25
    table = pa.table({"nv": pa.array(vals, mask=mask), "b": pa.array(vals >= n // 2)})
    src = str(tmp_path / "nbsrc.str")
    ref_write(src, table, options=_opts(max_page_size=512, zone_maps=True)[1])
    dst = _device_write(tmp_path, scan_file(src, "cpu"), ref_scan(src), max_page_size=512,
                        zone_maps=True)
    zones = ref_read_zones(dst)
    assert sum(p.null_count for p in zones["nv"].pages) == int(mask.sum())
    assert len(scan_file(dst, "cpu", predicates=[Comparison("b", "eq", True)])["b"]) == n // 2


def test_decimal_zones_never_misprune(tmp_path):
    n = 2048
    table = pa.table({"dec": pa.array([300 + i for i in range(n)], pa.decimal128(10, 2))})
    src = str(tmp_path / "dsrc.str")
    ref_write(src, table, options=_opts(max_page_size=256, zone_maps=True)[1])
    assert len(scan_file(src, "cpu", predicates=[Comparison("dec", "gt", 100)])["dec"]) == n
    dst = _device_write(tmp_path, scan_file(src, "cpu"), ref_scan(src), max_page_size=256,
                        zone_maps=True)
    zones = ref_read_zones(dst)
    assert zones["dec"].pages[0].min == 30000  # the unscaled domain
    pruned = scan_file(dst, "cpu", predicates=[Comparison("dec", "ge", (300 + n - 256) * 100)])
    assert len(pruned["dec"]) == 256


def test_device_bool_packed_path_roundtrip(tmp_path):
    rng = np.random.default_rng(8)
    n = 4096
    mixed = rng.integers(0, 2, n).astype(bool)
    table = pa.table({"mixed": pa.array(mixed),
                      "runs": pa.array(np.repeat(rng.integers(0, 2, 16).astype(bool), n // 16)),
                      "ones": pa.array(np.ones(n, dtype=bool)),
                      "nb": pa.array(mixed, mask=rng.random(n) < 0.2)})
    got, dst = _roundtrip(tmp_path, table, default_compress_ratio=1.0)
    assert got.to_pydict() == table.to_pydict()
    kinds = _page_kinds(dst)
    assert "one_value" in kinds["ones"] and "rle" in kinds["runs"]
    # a page grid that is not byte-aligned takes the host boolean family
    got, dst = _roundtrip(tmp_path, table, default_compress_ratio=1.0, max_page_size=1000,
                          zone_maps=True)
    assert got.to_pydict() == table.to_pydict()


def test_device_writer_freq_exact_fallback(tmp_path):
    vals = np.full(4096, 7_777, dtype=np.int64)
    vals[::20] = 1_234_567
    table = pa.table({"topheavy": pa.array(vals)})
    got, dst = _roundtrip(tmp_path, table, default_compress_ratio=1.0)
    assert got.to_pydict() == table.to_pydict()
    assert "freq" in _page_kinds(dst)["topheavy"]


def test_list_int_device_write_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    vals = [rng.integers(0, 1000, k).tolist() for k in rng.integers(0, 6, 600)]
    table = pa.table({"l": pa.array(vals, pa.list_(pa.int64()))},
                     schema=pa.schema([pa.field("l", pa.list_(pa.int64()), nullable=False)]))
    got, _ = _roundtrip(tmp_path, table, default_compress_ratio=1.0)
    assert got.column("l").to_pylist() == vals


def test_list_utf8_device_write_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    words = np.array(["alpha", "beta", "gamma", "delta", ""])
    vals = [words[rng.integers(0, len(words), k)].tolist() for k in rng.integers(0, 5, 400)]
    table = pa.table({"s": pa.array(vals, pa.list_(pa.string()))},
                     schema=pa.schema([pa.field("s", pa.list_(pa.string()), nullable=False)]))
    got, _ = _roundtrip(tmp_path, table)
    assert got.column("s").to_pylist() == vals


def test_list_nullable_device_write_roundtrip(tmp_path):
    vals = [[1, 2], None, [], [3], None, [4, 5, 6]] * 50
    got, _ = _roundtrip(tmp_path, pa.table({"ln": pa.array(vals, pa.list_(pa.int64()))}),
                        default_compress_ratio=1.0)
    assert got.column("ln").to_pylist() == vals


def test_saturated_estimate_picks_dict_as_the_reference_does(tmp_path):
    """On a page of far more distinct values than the estimate's 1024
    buckets, every bucket fills and the estimate stops near 21 220
    (``-1024·ln(1e-9)``): under a third of 65 536 rows, so DICT wins the
    ratio where the exact count would refuse it.  The port keeps the
    reference's choice (the same bytes)."""
    rng = np.random.default_rng(12)
    n = 2 * 65536
    table = pa.table({"v": pa.array(rng.integers(0, 1 << 40, n).astype(np.int64))})
    src = str(tmp_path / "src.str")
    ref_write(src, table, options=_opts(max_page_size=65536)[1])
    d = encode.paged_stats_device(scan_file(src, "cpu")["v"].values, None, 65536)
    assert int(d["unique_est"][0]) == 21220
    dst = _device_write(tmp_path, scan_file(src, "cpu"), ref_scan(src), max_page_size=65536,
                        default_compress_ratio=1.0)
    assert _page_kinds(dst)["v"] == {"dict"}
    assert ref_read_table(dst).column("v").to_pylist() == table.column("v").to_pylist()


def test_multi_leaf_nested_column_raises(tmp_path):
    from strawboat_tpu_torch.errors import NotYetImplementedError

    table = pa.table({"ls": pa.array([[{"a": 1, "b": "x"}], []], pa.list_(
        pa.struct([("a", pa.int64()), ("b", pa.string())])))})
    src = str(tmp_path / "src.str")
    ref_write(src, table, options=_opts()[1])
    with pytest.raises(NotYetImplementedError, match="multi-leaf"):
        write_device_table(str(tmp_path / "dst.str"), scan_file(src, "cpu"), _opts()[0])
    # one leaf under a struct level inside a list raises too
    table = pa.table({"ls": pa.array([[{"a": 1}], []], pa.list_(pa.struct([("a", pa.int64())])))})
    ref_write(src, table, options=_opts()[1])
    with pytest.raises(NotYetImplementedError, match="struct level"):
        write_device_table(str(tmp_path / "dst.str"), scan_file(src, "cpu"), _opts()[0])


@pytest.mark.parametrize("nulls", [False, True])
def test_fixed_size_list_column_equals_jax(tmp_path, nulls):
    """A fixed-size list level rebuilds from the scan's offsets: the file
    equals the JAX ``write_device_table``'s, null rows' slots dropped from
    the levels as there, and scans back equal."""
    rng = np.random.default_rng(21)
    n = 1500
    valid = rng.random(n) > 0.2 if nulls else np.ones(n, bool)
    fsl = pa.FixedSizeListArray.from_arrays(pa.array(rng.integers(0, 300, n * 3)), 3,
                                            mask=pa.array(~valid) if nulls else None)
    table = pa.table({"f": fsl, "k": pa.array(np.arange(n, dtype=np.int64))})
    src = str(tmp_path / "src.str")
    ref_write(src, table, options=_opts()[1])
    for cols in (["f"], ["f", "k"]):
        dst = _device_write(tmp_path, scan_file(src, "cpu", columns=cols),
                            ref_scan(src, columns=cols), default_compress_ratio=1.0, sample_seed=3,
                            max_page_size=256)
        assert scan_file(dst, "cpu").to_arrow().column("f").to_pylist() == \
            table.column("f").to_pylist()
        assert ref_read_table(dst).column("f").to_pylist() == table.column("f").to_pylist()


def test_map_column_writes_the_jax_writers_file(tmp_path):
    """A map rebuilds from its ``.key`` and ``.value`` columns and is
    written as one map column of two leaves: the file equals the JAX
    ``write_file``'s of the same column, byte for byte, and scans back
    equal.  The JAX ``write_device_table`` writes each leaf as a column of
    the map's type, a file its own scan cannot read (pinned here); a table
    that holds only one of the leaves raises in the port."""
    from strawboat_tpu_torch.errors import NotYetImplementedError

    n = 700
    m = pa.array([None if i % 9 == 0 else [(f"k{i % 5}", i), ("x", None if i % 4 else -i)]
                  for i in range(n)], type=pa.map_(pa.utf8(), pa.int64()))
    table = pa.table({"a": pa.array(np.arange(n, dtype=np.int64)), "m": m})
    port_opts, ref_opts = _opts(default_compress_ratio=1.0, sample_seed=3, max_page_size=256)
    src, want = str(tmp_path / "src.str"), str(tmp_path / "want.str")
    ref_write(src, table, options=ref_opts)
    ref_write(want, table.select(["m"]), options=ref_opts)
    dst = str(tmp_path / "dst.str")
    write_device_table(dst, scan_file(src, "cpu", columns=["m"]), port_opts)
    assert open(dst, "rb").read() == open(want, "rb").read()
    # beside a flat column: the scan's columns come back
    scanned = scan_file(src, "cpu")
    assert list(scanned.columns) == ["a", "m.key", "m.value"]
    write_device_table(dst, scanned, port_opts)
    back = scan_file(dst, "cpu")
    assert list(back.columns) == list(scanned.columns)
    for name in scanned.columns:
        assert back.to_arrow().column(name).to_pylist() == scanned.to_arrow().column(name).to_pylist()
    assert ref_read_table(dst).column("m").to_pylist() == table.column("m").to_pylist()
    ref_dst = str(tmp_path / "ref_dst.str")
    ref_write_device_table(ref_dst, ref_scan(src), ref_opts)
    with pytest.raises(IndexError):
        ref_scan(ref_dst)
    with pytest.raises(NotYetImplementedError, match="multi-leaf"):
        write_device_table(str(tmp_path / "x.str"), DeviceTable({"m.key": scanned["m.key"]}, n),
                           port_opts)


# ---------------------------------------------------------------------------
# the page stats against the JAX reductions


def _stats_column(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "int64":
        return np.repeat(rng.integers(-50, 50, n // 4 + 1), 4)[:n].astype(np.int64)
    if kind == "int32_sorted":
        return np.sort(rng.integers(-(2**31), 2**31 - 1, n)).astype(np.int32)
    if kind == "int16":
        return rng.integers(-(2**15), 2**15, n).astype(np.int16)
    if kind == "uint8":
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == "uint16":
        return rng.integers(0, 1 << 16, n).astype(np.uint16)
    if kind == "uint32":  # values at and above 2^31
        return rng.integers(2**31 - 5, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "uint64":  # values at and above 2^63
        return np.sort(rng.integers(2**63 - 5, 2**64 - 1, n, dtype=np.uint64))
    if kind == "float32":
        return rng.integers(0, 20, n).astype(np.float32)
    v = np.round(rng.normal(size=n), 1)
    v[3:7] = [np.nan, -0.0, np.inf, -np.inf]
    return v


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("n,page_size", [(5000, 1024), (4096, 512), (700, 1024)])
@pytest.mark.parametrize("kind", ["int64", "int32_sorted", "int16", "uint8", "uint16", "uint32",
                                  "uint64", "float32", "float64"])
def test_paged_stats_device_matches_jax(kind, n, page_size, nulls):
    values = _stats_column(kind, n, n)
    validity = (np.random.default_rng(1).random(n) > 0.3) if nulls else None
    want = ref_encode.paged_stats_device(jnp.asarray(values),
                                         None if validity is None else jnp.asarray(validity), page_size)
    tv = torch.from_numpy(values.view(f"<i{values.itemsize}") if values.dtype.kind == "u"
                          and values.itemsize > 1 else values)
    got = encode.paged_stats_device(tv, None if validity is None else torch.from_numpy(validity),
                                    page_size, unsigned=values.dtype.kind == "u")
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        if k in ("min", "max"):
            g = g.view(values.dtype)
            assert g.tobytes() == w.astype(values.dtype).tobytes(), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("n,page_size", [(5000, 1024), (4096, 512), (13, 8)])
def test_paged_bool_stats_device_matches_jax(n, page_size, nulls):
    rng = np.random.default_rng(n)
    values = np.repeat(rng.random(n // 7 + 1) < 0.5, 7)[:n]
    validity = (rng.random(n) > 0.3) if nulls else None
    packed_w, want = ref_encode.paged_bool_stats_device(
        jnp.asarray(values), None if validity is None else jnp.asarray(validity), page_size)
    packed, got = encode.paged_bool_stats_device(
        torch.from_numpy(values), None if validity is None else torch.from_numpy(validity), page_size)
    assert packed.numpy().tobytes() == np.asarray(packed_w).tobytes()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["int64", "uint32", "float64"])
def test_stats_device_matches_jax(kind):
    values = _stats_column(kind, 3000, 5)
    validity = np.random.default_rng(2).random(3000) > 0.2
    want = ref_encode.stats_device(jnp.asarray(values), jnp.asarray(validity))
    tv = torch.from_numpy(values.view(np.int32) if kind == "uint32" else values)
    got = encode.stats_device(tv, torch.from_numpy(validity), unsigned=kind == "uint32")
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        if k in ("min", "max"):
            g = g.view(values.dtype)
        assert g.tobytes() == np.asarray(want[k]).astype(g.dtype).tobytes(), k


def test_block_widths_and_distinct_estimate_match_jax():
    rng = np.random.default_rng(9)
    words = (rng.integers(0, 1 << 32, 128 * 40, dtype=np.uint64) >> rng.integers(0, 33, 128 * 40)
             .astype(np.uint64)).astype(np.uint32)
    words[:128] = 0
    tw = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(encode.block_bit_widths(tw).numpy(),
                                  np.asarray(ref_encode.block_bit_widths(jnp.asarray(words))))
    assert int(encode.bitpacked_size_bytes(tw)) == int(ref_encode.bitpacked_size_bytes(jnp.asarray(words)))
    for vals in (rng.integers(-(2**40), 2**40, 20000), rng.integers(0, 300, 20000)):
        assert int(encode.distinct_estimate(torch.from_numpy(vals))) == \
            int(ref_encode.distinct_estimate(jnp.asarray(vals)))


def test_device_write_of_resident_utf8_dictionary(tmp_path):
    """A table whose string dictionary holds ``str`` (as a resident table's
    does) writes the bytes of the scanned table's ``bytes`` dictionary."""
    src = str(tmp_path / "src.str")
    os.environ[DICT] = "1"
    try:
        ref_write(src, pa.table({"s": pa.array(["b", "a", "b", "c"] * 500)}), options=_opts()[1])
    finally:
        del os.environ[DICT]
    t = scan_file(src, "cpu")
    a, b = str(tmp_path / "a.str"), str(tmp_path / "b.str")
    write_device_table(a, t, _opts()[0])
    c = t["s"]
    words = np.array([v.decode() for v in c.dictionary], dtype=object)
    write_device_table(b, DeviceTable({"s": DeviceColumn("s", c.dtype, c.values, None, words)},
                                      t.num_rows), _opts()[0])
    assert open(a, "rb").read() == open(b, "rb").read()
    assert host_values(scan_file(b, "cpu")["s"]).tolist() == host_values(c).tolist()
