"""The port's resident loaders against the JAX package's, plane for plane.

``load_resident(path, device)`` scans the file, brings the columns to the
host and takes the host encoder; its planes must equal the JAX
``load_resident``'s word for word, on files of DICT, BITPACK, NONE and LZ4
pages.  ``make_resident(DeviceTable, device)`` encodes on the device; over
the port's scan of a file its planes must equal the JAX
``make_resident(JAX scan_file(...))``'s word for word: nullable columns
(validity plane), negative values (offset), spans that need two planes,
unsigned and date32 columns, and tables decoded from resident ones (string
codes, f32, bool).  Q6 over a loaded table equals numpy exactly.
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
from strawboat_tpu.exec.resident import load_resident as ref_load
from strawboat_tpu.exec.resident import make_resident as ref_make
from strawboat_tpu.exec.scan import scan_file as ref_scan
from strawboat_tpu.util.env import _ALL as FLAG_NAMES
from strawboat_tpu_torch.benchsuite import tpch
from strawboat_tpu_torch.errors import NotYetImplementedError
from strawboat_tpu_torch.exec import load_resident, make_resident, scan_file
from strawboat_tpu_torch.exec.scan import DeviceColumn, DeviceTable, host_values

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


def _columns(rows=70_000, seed=0):
    """Integer columns that take every encode decision: dictionary (small
    value sets, and a large one that halves the planes), plain planes with
    and without an offset, nulls, unsigned and date32."""
    rng = np.random.default_rng(seed)
    null = rng.random(rows) < 0.15
    return {
        "lowcard": (rng.integers(0, 9, rows) * 1000).astype(np.int64),
        "qty": rng.integers(1, 51, rows).astype(np.int64),
        "neg": rng.integers(-(1 << 20), 1 << 20, rows).astype(np.int64),
        "wide": rng.integers(-(1 << 45), 1 << 45, rows).astype(np.int64),
        "nullable": np.ma.MaskedArray(rng.integers(-500, 3000, rows).astype(np.int64), mask=null),
        "i32": rng.integers(0, 1 << 30, rows).astype(np.int32),
        "u32": rng.integers(0, 1 << 32, rows, dtype=np.uint64).astype(np.uint32),
        "i8": rng.integers(-100, 100, rows).astype(np.int8),
        "day": np.sort(rng.integers(8000, 12000, rows)).astype("datetime64[D]"),
    }


def _arrow(cols):
    arrays = {}
    for k, v in cols.items():
        if isinstance(v, np.ma.MaskedArray):
            arrays[k] = pa.array(np.ma.getdata(v), mask=np.ma.getmaskarray(v))
        else:
            arrays[k] = pa.array(v)
    return pa.table(arrays)


def _words(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.cpu().numpy().view(np.uint32)
    return np.asarray(w)


def _assert_same_planes(rt, rt_ref, names=None):
    """Every column of the port's table equals the JAX table's, word for
    word, with the same encode decisions."""
    names = list(names or rt_ref.columns)
    assert list(rt.columns) == names
    assert (rt.num_rows, rt.tile, rt.tiled_slots) == (rt_ref.num_rows, rt_ref.tile, rt_ref.tiled_slots)
    for n in names:
        c, r = rt.columns[n], rt_ref.columns[n]
        assert (c.kind, c.length, tuple(c.shifts), c.offset, c.bit_shift, c.wide) == (
            r.kind, r.length, tuple(r.shifts), r.offset, r.bit_shift, r.wide), n
        assert [b for _w, b in c.planes] == [b for _w, b in r.planes], n
        for (w, _b), (rw, _rb) in zip(c.planes, r.planes):
            np.testing.assert_array_equal(_words(w), _words(rw), err_msg=n)
        assert (c.validity_plane is None) == (r.validity_plane is None), n
        if c.validity_plane is not None:
            np.testing.assert_array_equal(_words(c.validity_plane), _words(r.validity_plane), err_msg=n)
        assert c.is_dict == r.is_dict, n
        if c.is_dict:
            assert [str(x) for x in c.dictionary_host] == [str(x) for x in r.dictionary_host], n


def _assert_decodes_to(rt, cols):
    for k, want in cols.items():
        valid = None
        if isinstance(want, np.ma.MaskedArray):
            valid, want = ~np.ma.getmaskarray(want), np.ma.getdata(want)
        got = rt.decode_natural(k).numpy()
        if want.dtype.kind == "M":
            want = want.view(np.int64)
        if want.dtype.kind == "u":
            got = got.view(want.dtype) if got.dtype.itemsize == want.dtype.itemsize else got
        if valid is not None:
            np.testing.assert_array_equal(rt.validity_natural(k).numpy(), valid, err_msg=k)
            got, want = got[valid], want[valid]
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64), err_msg=k)


_FILES = {
    # name: (forcing flags, default compression)
    "dict": (("STRAWBOAT_DICT_COMPRESSION",), RefCompression.NONE),
    "bitpack": (("STRAWBOAT_BITPACK_COMPRESSION",), RefCompression.NONE),
    "none": ((), RefCompression.NONE),
    "lz4": ((), RefCompression.LZ4),
}


@pytest.mark.parametrize("kind", list(_FILES))
def test_load_resident_planes_equal_jax(tmp_path, flags, kind):
    names, codec = _FILES[kind]
    flags(names)
    cols = _columns()
    path = str(tmp_path / f"{kind}.str")
    ref_write(path, _arrow(cols), options=RefOptions(
        default_compression=codec, default_compress_ratio=1.0 if codec else None,
        max_page_size=8192, sample_seed=3))
    flags(())
    rt = load_resident(path, "cpu", tile=TILE)
    _assert_same_planes(rt, ref_load(path, tile=TILE))
    _assert_decodes_to(rt, cols)
    assert rt["lowcard"].is_dict and not rt["neg"].is_dict and rt["neg"].offset != 0
    assert rt["day"].arrow_type == "date32"


def test_load_resident_columns_pick_and_order_as_jax(tmp_path):
    cols = _columns(rows=5000, seed=1)
    path = str(tmp_path / "c.str")
    ref_write(path, _arrow(cols), options=RefOptions(default_compression=RefCompression.LZ4))
    want = ["u32", "nosuch", "neg", "nullable"]
    rt = load_resident(path, "cpu", columns=want, tile=TILE)
    _assert_same_planes(rt, ref_load(path, columns=want, tile=TILE))
    assert list(rt.columns) == ["u32", "neg", "nullable"]
    # a glob and a list of files load as datasets, as in the JAX package
    for p in (str(tmp_path / "*.str"), [path, path]):
        _assert_same_planes(load_resident(p, "cpu", columns=want, tile=TILE),
                            ref_load(p, columns=want, tile=TILE))


def test_natural_slot_index_equals_jax(tmp_path):
    cols = _columns(rows=3000, seed=5)
    path = str(tmp_path / "n.str")
    ref_write(path, _arrow(cols), options=RefOptions(default_compression=RefCompression.LZ4))
    got = load_resident(path, "cpu", tile=TILE).natural_slot_index()
    want = np.asarray(ref_load(path, tile=TILE).natural_slot_index())
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_resident_of_the_port_scan_equals_jax(tmp_path):
    """Device-direct encode over a scan: offset-stripped planes (no
    dictionary), the validity plane, two planes for a wide span."""
    cols = _columns(rows=40_000, seed=2)
    path = str(tmp_path / "s.str")
    ref_write(path, _arrow(cols), options=RefOptions(default_compression=RefCompression.LZ4,
                                                      max_page_size=4096))
    dt = scan_file(path, "cpu")
    rt = make_resident(dt, "cpu", tile=TILE)
    rt_ref = ref_make(ref_scan(path), tile=TILE)
    _assert_same_planes(rt, rt_ref)
    _assert_decodes_to(rt, cols)
    assert rt["neg"].offset != 0 and len(rt["wide"].planes) == 2
    assert rt["nullable"].validity_plane is not None and not rt["lowcard"].is_dict


def test_make_resident_of_decoded_resident_tables_equals_jax():
    """A DeviceTable of string codes, f32, bool and int columns (a resident
    table decoded, padding included) encodes on the device as in JAX."""
    rng = np.random.default_rng(4)
    n = 3000
    null = rng.random(n) < 0.2
    t = pa.table({
        "s": pa.array(np.array(["zulu", "alpha", "mike", "x"])[rng.integers(0, 4, n)], pa.string()),
        "f": pa.array(rng.normal(0, 5, n).astype(np.float32), mask=null),
        "b": pa.array(rng.random(n) < 0.3, mask=rng.random(n) < 0.1),
        "k": pa.array(rng.integers(-7, 7, n).astype(np.int64), mask=null),
    })
    dt, _pad = make_resident(t, "cpu", tile=TILE).as_device_table()
    rdt, _rpad = ref_make(t, tile=TILE).as_device_table()
    rt = make_resident(dt, "cpu", tile=TILE)
    _assert_same_planes(rt, ref_make(rdt, tile=TILE))
    assert rt["s"].kind == "str" and rt["f"].kind == "f32" and rt["b"].kind == "bool"
    vals = rt.decode_natural("s").numpy()[:n]
    assert list(rt["s"].dictionary_host[vals]) == t.column("s").to_pylist()


def test_make_resident_of_f64_device_column_raises():
    """An f64 device column encodes now, as the host encoder encodes its
    values (``tests/test_torch_types.py`` holds it against the JAX
    package); a float16 one still raises, as in the reference."""
    x = torch.arange(10, dtype=torch.float64) / 4
    rt = make_resident(DeviceTable({"x": DeviceColumn("x", "double", x)}, 10), "cpu", tile=TILE)
    assert rt["x"].kind == "f64"
    assert torch.equal(rt.decode_natural("x"), x)
    _assert_same_planes(rt, make_resident({"x": x.numpy()}, "cpu", tile=TILE))
    dt = DeviceTable({"x": DeviceColumn("x", "halffloat", x.to(torch.float16))}, 10)
    with pytest.raises(NotYetImplementedError, match="float16"):
        make_resident(dt, "cpu", tile=TILE)


@pytest.mark.parametrize("kind", ["dict", "bitpack"])
def test_q6_over_both_loaders_equals_numpy(tmp_path, flags, kind):
    """chip_smoke.py's loaders at a small size: ``load_resident`` of the
    dict file equals ``make_resident`` of the same numpy columns plane for
    plane; ``make_resident(scan_file(...))`` decodes to the generated
    columns; Q6 over either equals numpy."""
    flags({"dict": ("STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION"),
           "bitpack": ("STRAWBOAT_BITPACK_COMPRESSION",)}[kind])
    cols = tpch.generate_lineitem(1.0, rows=30_000)
    path = str(tmp_path / "li.str")
    tpch.write_lineitem(path, cols, max_page_size=4096, columns=tpch.INT_COLUMNS)
    ints = {k: cols[k] for k in tpch.INT_COLUMNS}
    if kind == "dict":
        rt = load_resident(path, "cpu", tile=TILE)
        _assert_same_planes(rt, make_resident(ints, "cpu", tile=TILE))
    else:
        rt = make_resident(scan_file(path, "cpu"), "cpu", tile=TILE)
        for k in tpch.INT_COLUMNS:
            np.testing.assert_array_equal(host_values(DeviceColumn(
                k, rt[k].arrow_type, rt.decode_natural(k))), ints[k], err_msg=k)
    assert int(tpch.q6(rt)) == tpch.q6_numpy_reference(cols)
