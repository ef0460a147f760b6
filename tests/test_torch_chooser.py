"""The adaptive writer of the torch port against the JAX package.

With the same options and ``sample_seed``, the port's ``write_file`` writes
the JAX ``write_file``'s bytes: every flat type and a nested layout, under
``default_compress_ratio=1.0`` with each default codec (NONE, LZ4, Zstd,
Snappy), seeds 0 and 3, page sizes on each side of the stats gates (1024,
5000: not a multiple of 128, 65536), and under every forcing flag.  Page
by page, ``gen_stats`` and each family's ``choose_compressor`` give the
JAX answers.  The last tests mirror the codec cases of ``tests/test_io.py``,
``tests/test_env_forcing.py``, ``tests/test_golden.py``'s chooser layouts
and ``tests/test_decimal.py``: the port writes, the JAX reader reads, and
the port scans the JAX writer's file.  Everything runs on the CPU.
Tolerance: bytes equal, values exact, floats bit for bit.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest

from conftest import (
    PAGE_SIZE,
    create_random_bool,
    create_random_double,
    create_random_i64,
    create_random_index,
    create_random_string,
    rng as conf_rng,
)
from strawboat_tpu.api import read_table as ref_read_table
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.codecs import _family as ref_family
from strawboat_tpu.codecs import binary as ref_binary
from strawboat_tpu.codecs import boolean as ref_boolean
from strawboat_tpu.codecs import decimal as ref_decimal
from strawboat_tpu.codecs import double as ref_double
from strawboat_tpu.codecs import integer as ref_integer
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.util.env import _ALL as FLAG_NAMES
from strawboat_tpu_torch import columns as cm
from strawboat_tpu_torch import native
from strawboat_tpu_torch.codecs import WriteOptions, _family, binary, boolean, double, integer
from strawboat_tpu_torch.codecs import decimal as port_decimal
from strawboat_tpu_torch.codecs.binary import BinaryColumn, slice_keys
from strawboat_tpu_torch.constants import Compression
from strawboat_tpu_torch.errors import NotYetImplementedError
from strawboat_tpu_torch.exec import scan_file
from strawboat_tpu_torch.util import roaring
from strawboat_tpu_torch.write import write_file

DICT, BP = "STRAWBOAT_DICT_COMPRESSION", "STRAWBOAT_BITPACK_COMPRESSION"
RLE, FREQ, PATAS = "STRAWBOAT_RLE_COMPRESSION", "STRAWBOAT_FREQ_COMPRESSION", "STRAWBOAT_PATAS_COMPRESSION"
NAN_PAYLOAD = np.uint64(0x7FF8_0000_0000_0123).view(np.float64)


@pytest.fixture
def flags(monkeypatch):
    def set_flags(names):
        for n in FLAG_NAMES:
            monkeypatch.delenv(n, raising=False)
        for n in names:
            monkeypatch.setenv(n, "1")

    set_flags(())
    return set_flags


def _port_write(path, table: pa.Table, **kw):
    """The port's writer over an arrow table (its columns through the
    column model, its fields as the port's)."""
    write_file(str(path), {f.name: cm.from_arrow(table.column(f.name).combine_chunks())
                           for f in table.schema},
               schema=[cm.field_from_arrow(f) for f in table.schema], options=WriteOptions(**kw))
    return str(path)


def _ref_write(path, table: pa.Table, **kw):
    kw = {k: (RefCompression(int(v)) if k == "default_compression" else v) for k, v in kw.items()}
    ref_write(str(path), table, options=RefOptions(**kw))
    return str(path)


def _same_file(tmp_path, table, **kw):
    """Both writers over ``table`` with the same options → the port's
    file's path, after checking the two files' bytes are equal."""
    port = _port_write(tmp_path / "port.str", table, **kw)
    ref = _ref_write(tmp_path / "ref.str", table, **kw)
    assert open(port, "rb").read() == open(ref, "rb").read()
    return port, ref


def _both_ways(tmp_path, table, scan=True, **kw):
    """Equal bytes; the JAX reader reads the port's file as ``table``; the
    port scans the JAX writer's file as ``table``."""
    port, ref = _same_file(tmp_path, table, **kw)
    assert ref_read_table(port).to_pylist() == table.to_pylist()
    if scan:
        assert scan_file(ref, "cpu").to_arrow().to_pylist() == table.to_pylist()
    return port


def _flat_table(rows: int, seed: int) -> pa.Table:
    """Every flat type the writer takes; nulls, a leading null, NaN
    payloads, ±0.0 and ±inf among the floats."""
    rng = np.random.default_rng(seed)
    null = rng.random(rows) < 0.2
    null[0] = True
    f64 = np.round(rng.normal(size=rows), 2)
    f64[5:11] = [np.nan, NAN_PAYLOAD, -0.0, 0.0, np.inf, -np.inf]
    dec = rng.integers(-10**9, 10**9, rows)
    return pa.table({
        "i8": pa.array(rng.integers(-100, 100, rows).astype(np.int8)),
        "u8": pa.array(rng.integers(0, 4, rows).astype(np.uint8)),
        "i16": pa.array(np.repeat(rng.integers(-300, 300, rows // 16 + 1), 16)[:rows].astype(np.int16)),
        "u16": pa.array(rng.integers(0, 1 << 16, rows).astype(np.uint16)),
        "i32": pa.array(rng.integers(0, 1000, rows).astype(np.int32), mask=null),
        "u32": pa.array(rng.integers(0, 1 << 32, rows, dtype=np.uint64).astype(np.uint32)),
        "sorted": pa.array((np.arange(rows) * 3).astype(np.uint32)),
        "i64": pa.array(rng.integers(-(2**62), 2**62, rows).astype(np.int64)),
        "u64": pa.array(rng.integers(0, 2**64 - 1, rows, dtype=np.uint64)),
        "const": pa.array(np.full(rows, 123456789, dtype=np.int64)),
        "freq": pa.array(np.where(rng.random(rows) < 0.97, 1000, rng.integers(0, 1 << 40, rows))),
        "d32": pa.array(np.sort(rng.integers(8000, 12000, rows)).astype(np.int32), pa.date32()),
        "ts": pa.array(rng.integers(0, 10, rows) * 1000, pa.timestamp("ms")),
        "f64": pa.array(f64, mask=null),
        "f32": pa.array(rng.integers(0, 10, rows).astype(np.float32)),
        "f16": pa.array(rng.integers(0, 4, rows).astype(np.float16)),
        "b": pa.array(rng.random(rows) < 0.1),
        "bn": pa.array(rng.random(rows) < 0.5, mask=null),
        "s": pa.array(np.array(["ab", "cde", "", "zz"])[rng.integers(0, 4, rows)]),
        "sn": pa.array([None if m else f"w{i}" for m, i in zip(null, rng.integers(0, 5000, rows))]),
        "ls": pa.array(np.array(["x", "yy"])[rng.integers(0, 2, rows)], pa.large_string()),
        "bin": pa.array([b"k" * int(i) for i in rng.integers(0, 12, rows)], pa.binary()),
        "d128": pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in dec], pa.decimal128(15, 2)),
        "d256": pa.array([decimal.Decimal(int(v) % 7) for v in dec], pa.decimal256(40, 0)),
    })


def _nested_table(rows: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    lists = [None if rng.random() < 0.1 else rng.integers(0, 4, int(rng.integers(0, 5))).tolist()
             for _ in range(rows)]
    return pa.table({"l": pa.array(lists, pa.list_(pa.int64()))})


@pytest.mark.parametrize("page_size", [1024, 5000, 65536])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("codec", [Compression.NONE, Compression.LZ4, Compression.ZSTD,
                                   Compression.SNAPPY])
def test_adaptive_file_equals_jax_write_file(tmp_path, flags, codec, seed, page_size):
    if codec == Compression.SNAPPY and not native._load().sb_has_snappy():
        pytest.skip("libsnappy.so.1 is absent here")
    kw = dict(default_compression=codec, default_compress_ratio=1.0, sample_seed=seed,
              max_page_size=page_size)
    _same_file(tmp_path, _flat_table(12000, seed), **kw)
    _same_file(tmp_path, _nested_table(6000, seed), **kw)


@pytest.mark.parametrize("names", [(FREQ,), (RLE,), (PATAS,), (BP,), (FREQ, BP), (DICT, BP),
                                   (RLE, PATAS)])
@pytest.mark.parametrize("ratio", [None, 1.0])
def test_forcing_flags_file_equals_jax_write_file(tmp_path, flags, names, ratio):
    flags(names)
    _same_file(tmp_path, _flat_table(3000, 1), default_compression=Compression.LZ4,
               default_compress_ratio=ratio, sample_seed=0, max_page_size=1024)


# ---------------------------------------------------------------------------
# page by page: stats and choices


def _page(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "f64":
        v = np.round(rng.normal(size=n), 1)
        v[:6] = [np.nan, NAN_PAYLOAD, -0.0, 0.0, np.inf, -np.inf]
        return v
    if kind == "f32":
        return rng.integers(0, 50, n).astype(np.float32)
    if kind == "u64":
        return rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64)
    if kind == "u32":
        return rng.integers(2**31, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "lowcard":
        return rng.integers(-3, 3, n).astype(np.int64)
    if kind == "top":
        return np.where(rng.random(n) < 0.95, 7, rng.integers(0, 1 << 20, n)).astype(np.int32)
    return rng.integers(-(2**30), 2**30, n).astype(np.dtype(kind))


def _validity(nulls: str, n: int, seed: int):
    if nulls == "none":
        return None
    v = np.random.default_rng(seed + 100).random(n) > 0.3
    v[0] = nulls != "leading"
    return v


def _stats_fields(s):
    return {k: getattr(s, k) for k in ("tuple_count", "total_bytes", "null_count", "average_run_length",
                                        "is_sorted", "unique_count", "max_count", "set_count")}


def _same_value(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("nulls", ["none", "some", "leading"])
@pytest.mark.parametrize("n", [4095, 4096, 8192, 8193])
@pytest.mark.parametrize("kind", ["int8", "int16", "int32", "u32", "int64", "u64", "lowcard", "top",
                                  "f32", "f64"])
def test_gen_stats_matches_jax(kind, n, nulls):
    """Each side of the 4096 / 8192 gates, by dtype kind, with and without
    nulls: every stats field, min / max / top bit for bit, and the
    factorize the stats hand to DICT."""
    values = _page(kind, n, n)
    validity = _validity(nulls, n, n)
    got, want = _family.gen_stats(values, validity), ref_family.gen_stats(values, validity)
    assert _stats_fields(got) == _stats_fields(want)
    for k in ("min", "max", "top_value"):
        assert _same_value(getattr(got, k), getattr(want, k)), k
    assert (got.dict_codes is None) == (want.dict_codes is None)
    if got.dict_codes is not None:
        np.testing.assert_array_equal(got.dict_codes, want.dict_codes)
        assert got.dict_sets.tobytes() == want.dict_sets.tobytes()


@pytest.mark.parametrize("seed", [0, 3, None])
@pytest.mark.parametrize("kind", ["int32", "u32", "lowcard", "top", "int64", "f32", "f64"])
def test_choose_compressor_matches_jax(kind, seed):
    """The integer and float choosers over the same stats and options pick
    the JAX codec, page sizes on each side of the sampling gate and of
    BitPacker's 128-value blocks; the encoded bodies are equal."""
    for n in (600, 640, 5000, 5120, 20000):
        values = _page(kind, n, n)
        if kind in ("u32",):
            values = np.sort(values)
        opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                            sample_seed=seed)
        ropts = RefOptions(default_compression=RefCompression.LZ4, default_compress_ratio=1.0,
                           sample_seed=seed)
        mod, ref = (double, ref_double) if values.dtype.kind == "f" else (integer, ref_integer)
        if seed is None:  # unseeded: the choice must not depend on a draw
            values = np.full(n, 5, values.dtype)
        got = mod.choose_compressor(_family.gen_stats(values, None), opts)
        want = ref.choose_compressor(ref_family.gen_stats(values, None), ropts)
        assert int(got) == int(want), (kind, n)
        if not got.raw_mode:
            assert (mod._codec_compress(got, values, None, _family.gen_stats(values, None), opts)
                    == ref._codec_compress(want, values, None, ref_family.gen_stats(values, None),
                                           ropts))


def _binary_page(seed: int, n: int, card: int):
    rng = np.random.default_rng(seed)
    words = np.array([f"v{i}" * (i % 3) for i in range(card)])
    vals = words[rng.integers(0, card, n)]
    vals[: n // 2] = words[0] if card == 2 else vals[: n // 2]
    arr = pa.array(vals.tolist())
    offsets = np.frombuffer(arr.buffers()[1], np.int32, n + 1, arr.offset).astype(np.int64)
    values = np.frombuffer(arr.buffers()[2], np.uint8)
    lens = np.diff(offsets)
    keys = slice_keys(offsets[:-1], lens, values) if lens.max() <= 7 else None
    return arr, BinaryColumn(offsets, values, keys)


@pytest.mark.parametrize("card", [1, 2, 40, 3000])
@pytest.mark.parametrize("nulls", ["none", "some"])
def test_binary_stats_and_choice_match_jax(card, nulls):
    n = 4000
    arr, col = _binary_page(card, n, card)
    validity = _validity(nulls, n, card)
    got = binary.gen_stats(col, validity, large=False)
    ref_offsets = col.offsets.astype(np.int32)
    want = ref_binary.gen_stats(ref_offsets, col.values, validity)
    for k in ("tuple_count", "total_bytes", "unique_count", "total_unique_size", "null_count",
              "max_count", "top_value"):
        assert getattr(got, k) == getattr(want, k), k
    for ratio in (None, 1.0, 30.0):
        opts = WriteOptions(default_compression=Compression.ZSTD, default_compress_ratio=ratio)
        ropts = RefOptions(default_compression=RefCompression.ZSTD, default_compress_ratio=ratio)
        assert int(binary.choose_compressor(got, opts)) == int(ref_binary.choose_compressor(want, ropts))
        assert (binary.compress_binary(col, validity, opts, large=False)
                == ref_binary.compress_binary(ref_offsets, col.values, validity, ropts))


@pytest.mark.parametrize("shape", ["mixed", "runs", "ones", "nullable"])
@pytest.mark.parametrize("n", [600, 641, 4096])
def test_boolean_stats_and_choice_match_jax(shape, n):
    rng = np.random.default_rng(n)
    values = {"mixed": rng.random(n) < 0.5, "runs": np.repeat(rng.random(n // 64 + 1) < 0.5, 64)[:n],
              "ones": np.ones(n, bool), "nullable": rng.random(n) < 0.5}[shape]
    validity = _validity("some" if shape == "nullable" else "none", n, n)
    got, want = boolean.gen_stats(values, validity), ref_boolean.gen_stats(values, validity)
    for k in ("rows", "total_bytes", "null_count", "false_count", "true_count", "average_run_length"):
        assert getattr(got, k) == getattr(want, k), k
    for seed in (0, 3):
        opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=1.0,
                            sample_seed=seed)
        ropts = RefOptions(default_compression=RefCompression.LZ4, default_compress_ratio=1.0,
                           sample_seed=seed)
        assert int(boolean.choose_compressor(got, opts)) == int(ref_boolean.choose_compressor(want, ropts))
        assert (boolean.compress_boolean(values, validity, opts)
                == ref_boolean.compress_boolean(values, validity, ropts))


@pytest.mark.parametrize("shape", ["one", "freq", "dict", "runs", "wide", "nullable"])
def test_decimal_choice_matches_jax(shape):
    n, width = 3000, 16
    rng = np.random.default_rng(7)
    unscaled = {"one": np.full(n, 777), "freq": np.where(np.arange(n) % 100, 10**10, np.arange(n)),
                "dict": (np.arange(n) % 5) * 12345, "runs": np.repeat(np.arange(n // 50), 50),
                "wide": rng.integers(-(10**12), 10**12, n),
                "nullable": rng.integers(0, 3, n)}[shape]
    mat = port_decimal.from_int64(unscaled.astype(np.int64), width)
    if shape == "wide":
        mat[::7, 9] = 0x5A  # values beyond int64
    validity = _validity("some" if shape == "nullable" else "none", n, 1)
    # both sides seed their trial samples: unseeded, each draws its own
    # and a page near a ratio can take another codec on either side
    for ratio, seed in ((None, 0), (1.0, 0), (1.0, 3)):
        opts = WriteOptions(default_compression=Compression.LZ4, default_compress_ratio=ratio,
                            sample_seed=seed)
        ropts = RefOptions(default_compression=RefCompression.LZ4, default_compress_ratio=ratio,
                           sample_seed=seed)
        assert (int(port_decimal.choose_compressor(mat, validity, opts))
                == int(ref_decimal.choose_compressor(mat, validity, ropts)))
        assert (port_decimal.compress_decimal(mat, validity, opts)
                == ref_decimal.compress_decimal(mat, validity, ropts, width))


def test_one_trial_sample_per_page():
    """Only the first draw advances the page's RNG: every candidate is
    measured on the first candidate's sample (the JAX writer's rule; the
    reference draws anew per candidate)."""
    values = np.random.default_rng(0).integers(0, 1 << 12, 20480).astype(np.int32)
    stats = _family.gen_stats(values, None)
    rng = np.random.default_rng(3)
    first = _family.sample_stats(stats, rng)
    after_first = rng.bit_generator.state
    again = _family.sample_stats(stats, rng)
    assert again is first and rng.bit_generator.state == after_first
    ref_stats = ref_family.gen_stats(values, None)
    ref_first = ref_family.sample_stats(ref_stats, np.random.default_rng(3))
    np.testing.assert_array_equal(first.values, ref_first.values)
    # every candidate's trial ratio comes from that one sample
    ratios = [integer._ratio(c, stats, rng) for c in (Compression.RLE, Compression.BITPACKING)]
    assert ratios == [first.total_bytes / len(_family.rle_encode(first.values, None)),
                      first.total_bytes / len(integer.bitpack_encode(first.values))]
    assert rng.bit_generator.state == after_first
    small = _family.gen_stats(values[:640], None)  # 640 values: the page is its own sample
    assert _family.sample_stats(small, rng) is small


def test_stats_without_native_library_take_numpy(monkeypatch):
    """Without the native library the stats take the numpy route, as the
    JAX package's do."""
    values = _page("lowcard", 9000, 1)
    want = _family.gen_stats(values[:4000], None)
    monkeypatch.setattr(native, "_load", lambda: None)
    got = _family.gen_stats(values, None)
    assert got.unique_count == 6 and got.dict_codes is None
    assert _stats_fields(_family.gen_stats(values[:4000], None)) == _stats_fields(want)


# ---------------------------------------------------------------------------
# tests/test_io.py (ratio and codec cases), as port cases


@pytest.mark.parametrize("compression", [Compression.LZ4, Compression.ZSTD, Compression.SNAPPY,
                                         Compression.NONE])
@pytest.mark.parametrize("size", [PAGE_SIZE, PAGE_SIZE + 10, PAGE_SIZE * 2 + 5])
def test_basic_mixed(tmp_path, flags, compression, size):
    if compression == Compression.SNAPPY and not native._load().sb_has_snappy():
        pytest.skip("libsnappy.so.1 is absent here")
    table = pa.table({
        "int32": create_random_index(size, 0.2, 100),
        "int64": create_random_i64(size, 0.0),
        "f64": create_random_double(size, 0.1),
        "bool": create_random_bool(size, 0.3),
        "utf8": create_random_string(size, 0.2, 50),
    })
    _both_ways(tmp_path, table, default_compression=compression, default_compress_ratio=1.0,
               max_page_size=PAGE_SIZE)


def _io_case(tmp_path, table):
    return _both_ways(tmp_path, table, default_compression=Compression.LZ4,
                      default_compress_ratio=1.0, max_page_size=PAGE_SIZE)


def _codecs(path):
    """The codec of each page of each (flat) column of a port file."""
    from strawboat_tpu_torch.codecs import read_header
    from strawboat_tpu_torch.exec.scan import _open, _plan_pages

    schema, metas, buf = _open(path)
    return {f.name: {read_header(b, p)[0] for _l, _v, b, p in _plan_pages(buf, m, f.nullable)}
            for f, m in zip(schema, metas)}


def test_dict(tmp_path, flags):
    path = _io_case(tmp_path, pa.table({"c": create_random_index(PAGE_SIZE * 2, 0.1, 8)}))
    assert _codecs(path)["c"] == {Compression.DICT}


def test_freq(tmp_path, flags):
    r = conf_rng()
    vals = np.full(PAGE_SIZE * 2, 1000, dtype=np.int64)
    idx = r.integers(0, len(vals), len(vals) // 20)
    vals[idx] = r.integers(0, 1 << 40, len(idx))
    path = _io_case(tmp_path, pa.table({"c": pa.array(vals)}))
    assert _codecs(path)["c"] == {Compression.FREQ}


def test_bitpacking(tmp_path, flags):
    vals = conf_rng().integers(0, 1 << 12, PAGE_SIZE * 2, dtype=np.int32)
    path = _io_case(tmp_path, pa.table({"c": pa.array(vals)}))
    assert _codecs(path)["c"] == {Compression.BITPACKING}


def test_delta_bitpacking(tmp_path, flags):
    vals = np.sort(conf_rng().integers(0, 1 << 20, PAGE_SIZE * 2).astype(np.uint32))
    path = _io_case(tmp_path, pa.table({"c": pa.array(vals, type=pa.uint32())}))
    assert _codecs(path)["c"] == {Compression.DELTA_BITPACKING}


def test_onevalue(tmp_path, flags):
    path = _io_case(tmp_path, pa.table({"i": pa.array(np.full(PAGE_SIZE, 7, dtype=np.int64)),
                                        "s": pa.array(["x"] * PAGE_SIZE),
                                        "b": pa.array([True] * PAGE_SIZE)}))
    assert set().union(*_codecs(path).values()) == {Compression.ONE_VALUE}


def test_patas(tmp_path, flags):
    path = _io_case(tmp_path, pa.table({"f": pa.array(np.cumsum(conf_rng().normal(0, 1, PAGE_SIZE * 2)))}))
    assert _codecs(path)["f"] <= {Compression.PATAS, Compression.LZ4}


def test_boolean_rle(tmp_path, flags):
    vals = np.repeat(conf_rng().random(PAGE_SIZE // 64) > 0.5, 128)
    path = _io_case(tmp_path, pa.table({"b": pa.array(vals)}))
    assert _codecs(path)["b"] == {Compression.RLE}


# ---------------------------------------------------------------------------
# tests/test_env_forcing.py, as port cases


def _forcing_table(size=3000):
    return pa.table({
        "i32": create_random_index(size, 0.2, 16),
        "f64": create_random_double(size, 0.1),
        "bool": create_random_bool(size, 0.2),
        "utf8": create_random_string(size, 0.1, 10),
        "list": pa.array([[i, None, i + 1] if i % 5 else None for i in range(size)],
                         type=pa.list_(pa.int64())),
    })


@pytest.mark.parametrize("var", [DICT, RLE, FREQ, BP, PATAS])
def test_forced_roundtrip(tmp_path, flags, var):
    flags((var,))
    _both_ways(tmp_path, _forcing_table(), default_compression=Compression.LZ4, max_page_size=1024)


def test_forced_codec_actually_used(flags):
    flags((DICT,))
    buf = integer.compress_integer(np.arange(100, dtype=np.int64), None, WriteOptions())
    assert buf[0] == Compression.DICT
    assert buf == ref_integer.compress_integer(np.arange(100, dtype=np.int64), None, RefOptions())


# ---------------------------------------------------------------------------
# tests/test_golden.py's chooser layouts, as port cases (pages equal to the
# JAX encoders', and the layout bytes the reference's own tests pin)


def test_one_value_layout():
    page = integer.compress_integer(np.full(1000, 42, dtype=np.int32), None,
                                    WriteOptions(default_compress_ratio=1.0))
    assert page[0] == Compression.ONE_VALUE and page[9:] == np.int32(42).tobytes()
    assert page == ref_integer.compress_integer(np.full(1000, 42, dtype=np.int32), None,
                                                RefOptions(default_compress_ratio=1.0))


def test_rle_layout():
    vals = np.array([5, 5, 5, 9, 9], dtype=np.int64)
    body = _family.rle_encode(vals, None)
    assert body == (np.uint32(3).tobytes() + np.int64(5).tobytes()
                    + np.uint32(2).tobytes() + np.int64(9).tobytes())
    validity = np.array([False, True, True, False, True])
    assert _family.rle_encode(vals, validity) == ref_family.rle_encode(vals, validity)


def test_delta_bitpack_num_bits_from_raw():
    vals = np.arange(1000, 1128, dtype=np.uint32)
    body = integer.delta_bitpack_encode(vals)
    assert body[0] == 11  # widths from the raw values (1127 needs 11 bits), not the deltas
    assert body == ref_integer.delta_bitpack_encode(vals)


def test_integer_freq_layout():
    vals = np.full(1024, 300, dtype=np.int32)
    vals[[3, 700]] = [1, 2]
    opts = WriteOptions(default_compress_ratio=1.0)
    page = integer.compress_integer(vals, None, opts)
    assert page[0] == Compression.FREQ
    body = page[9:]
    assert body[:4] == np.int32(300).tobytes()
    size = int(np.frombuffer(body[4:8], "<u4")[0])
    np.testing.assert_array_equal(roaring.deserialize(body[8 : 8 + size]), [3, 700])
    assert page == ref_integer.compress_integer(vals, None, RefOptions(default_compress_ratio=1.0))


def _str_col(words):
    arr = pa.array(words)
    offsets = np.frombuffer(arr.buffers()[1], np.int32, len(arr) + 1).astype(np.int64)
    return arr, BinaryColumn(offsets, np.frombuffer(arr.buffers()[2], np.uint8))


def test_binary_freq_layout():
    words = ["top"] * 200
    words[5], words[150] = "a", "bc"
    _arr, col = _str_col(words)
    opts = WriteOptions(default_compress_ratio=1.0)
    page = binary.compress_binary(col, None, opts, large=False)
    assert page[0] == Compression.FREQ
    body = page[9:]
    assert body[:8] == np.uint64(3).tobytes() and body[8:11] == b"top"
    assert page == ref_binary.compress_binary(col.offsets.astype(np.int32), col.values, None,
                                              RefOptions(default_compress_ratio=1.0))


def test_binary_one_value_layout():
    _arr, col = _str_col(["same"] * 300)
    page = binary.compress_binary(col, None, WriteOptions(default_compress_ratio=1.0), large=False)
    assert page[0] == Compression.ONE_VALUE and page[9:] == np.uint32(4).tobytes() + b"same"
    assert page == ref_binary.compress_binary(col.offsets.astype(np.int32), col.values, None,
                                              RefOptions(default_compress_ratio=1.0))


def test_boolean_rle_layout():
    vals = np.repeat([True, False, True], [700, 500, 300])
    page = boolean.compress_boolean(vals, None, WriteOptions(default_compress_ratio=1.0, sample_seed=0))
    assert page[0] == Compression.RLE
    assert page[9:] == (np.uint32(700).tobytes() + b"\x01" + np.uint32(500).tobytes() + b"\x00"
                        + np.uint32(300).tobytes() + b"\x01")
    assert page == ref_boolean.compress_boolean(vals, None, RefOptions(default_compress_ratio=1.0,
                                                                       sample_seed=0))


def test_boolean_one_value_layout():
    vals = np.zeros(1000, bool)
    validity = np.ones(1000, bool)
    validity[0] = False
    page = boolean.compress_boolean(vals, validity, WriteOptions(default_compress_ratio=1.0))
    assert page[0] == Compression.ONE_VALUE and page[9:] == b"\x00"
    assert page == ref_boolean.compress_boolean(vals, validity, RefOptions(default_compress_ratio=1.0))


# ---------------------------------------------------------------------------
# tests/test_decimal.py, as port cases (precision over 18 does not scan on
# the device, as in the reference: those files are held by their bytes)


def _dec(v, scale=2):
    return decimal.Decimal(v).scaleb(-scale)


def _decimal_case(tmp_path, table):
    scan = all(t.precision <= 18 for t in table.schema.types)
    port = _both_ways(tmp_path, table, scan=scan, default_compression=Compression.LZ4,
                      default_compress_ratio=1.0, max_page_size=1024)
    if not scan:
        with pytest.raises(NotYetImplementedError):
            scan_file(port, "cpu")


def test_decimal128_mixed(tmp_path, flags):
    rng = np.random.default_rng(5)
    n = 3000
    vals = [_dec(int(v)) if m else None
            for v, m in zip(rng.integers(-(10**12), 10**12, n), rng.random(n) > 0.2)]
    _decimal_case(tmp_path, pa.table({"d": pa.array(vals, type=pa.decimal128(30, 2))}))
    _decimal_case(tmp_path, pa.table({"d": pa.array(vals, type=pa.decimal128(18, 2))}))


def test_decimal128_low_cardinality_dict(tmp_path, flags):
    vals = [_dec((i % 5) * 12345) for i in range(4000)]
    _decimal_case(tmp_path, pa.table({"d": pa.array(vals, type=pa.decimal128(20, 2))}))
    _decimal_case(tmp_path, pa.table({"d": pa.array(vals, type=pa.decimal128(12, 2))}))


def test_decimal128_onevalue_and_freq(tmp_path, flags):
    n = 4000
    _decimal_case(tmp_path, pa.table({"c": pa.array([_dec(777)] * n, type=pa.decimal128(10, 2))}))
    vals2 = [_dec(10**10)] * n
    for i in range(0, n, 100):
        vals2[i] = _dec(i)
    _decimal_case(tmp_path, pa.table({"f": pa.array(vals2, type=pa.decimal128(20, 2))}))
    _decimal_case(tmp_path, pa.table({"f": pa.array(vals2, type=pa.decimal128(15, 2))}))


def test_decimal256(tmp_path, flags):
    rng = np.random.default_rng(6)
    n = 2000
    vals = [decimal.Decimal(int(v)) * (10**20) if m else None
            for v, m in zip(rng.integers(0, 10**9, n), rng.random(n) > 0.3)]
    _decimal_case(tmp_path, pa.table({"d": pa.array(vals, type=pa.decimal256(60, 0))}))


def test_decimal_forced_codecs(tmp_path, flags):
    vals = [_dec((i % 7) * 1000) if i % 9 else None for i in range(3000)]
    for var in (DICT, RLE, FREQ):
        flags((var,))
        _decimal_case(tmp_path, pa.table({"d": pa.array(vals, type=pa.decimal128(25, 2))}))
        _decimal_case(tmp_path, pa.table({"d": pa.array(vals, type=pa.decimal128(16, 2))}))
