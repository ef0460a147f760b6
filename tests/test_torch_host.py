"""The port's own host modules against their counterparts in the JAX package.

``strawboat_tpu_torch`` keeps its own copies of the host modules it needs
(``errors``, ``constants``, ``meta``, ``util/``, ``native/``).  Each is
held against the JAX package's module of the same name on the same numpy
inputs, made from a seed: equal bytes, equal arrays, equal answers.
"""

import ctypes
import os
import pathlib

import numpy as np
import pytest

from strawboat_tpu import constants as ref_constants
from strawboat_tpu import meta as ref_meta
from strawboat_tpu import native as ref_native
from strawboat_tpu.util import bits as ref_bits
from strawboat_tpu.util import env as ref_env
from strawboat_tpu.util import hybrid_rle as ref_rle
from strawboat_tpu.util import roaring as ref_roaring
from strawboat_tpu_torch import constants, meta, native
from strawboat_tpu_torch.errors import OutOfSpecError, StrawboatError
from strawboat_tpu_torch.util import bits, env, hybrid_rle, roaring

PORT = pathlib.Path(__file__).resolve().parents[1] / "strawboat_tpu_torch"


# ---------------------------------------------------------------------------
# errors, constants, meta


@pytest.mark.parametrize("what,capacity,required", [("aggregate groups", 4, 10),
                                                    ("join fan-out", 1, 7)])
def test_capacity_error_matches_reference(what, capacity, required):
    from strawboat_tpu import errors as ref_errors
    from strawboat_tpu_torch import errors

    got = errors.CapacityError(what, capacity, required)
    want = ref_errors.CapacityError(what, capacity, required)
    assert isinstance(got, errors.StrawboatError)
    assert str(got) == str(want)
    assert (got.what, got.capacity, got.required) == (want.what, want.capacity, want.required)


def test_constants_match_reference():
    assert constants.ARROW_MAGIC == ref_constants.ARROW_MAGIC
    assert constants.CONTINUATION_MARKER == ref_constants.CONTINUATION_MARKER
    assert {c.name: int(c) for c in constants.Compression} == {
        c.name: int(c) for c in ref_constants.Compression}
    for c in constants.Compression:
        assert c.raw_mode == ref_constants.Compression(int(c)).raw_mode
        assert constants.Compression.from_codec(int(c)) is c
    with pytest.raises(OutOfSpecError):
        constants.Compression.from_codec(9)


def _random_metas(seed):
    rng = np.random.default_rng(seed)
    return [
        (int(rng.integers(0, 1 << 40)),
         [(int(rng.integers(1, 1 << 33)), int(rng.integers(0, 1 << 20)))
          for _ in range(int(rng.integers(0, 6)))])
        for _ in range(int(rng.integers(0, 9)))
    ]


@pytest.mark.parametrize("seed", range(4))
def test_meta_block_bytes_match_reference_both_ways(seed):
    raw = _random_metas(seed)
    port = [meta.ColumnMeta(o, [meta.PageMeta(*p) for p in pages]) for o, pages in raw]
    ref = [ref_meta.ColumnMeta(o, [ref_meta.PageMeta(*p) for p in pages]) for o, pages in raw]
    buf = meta.serialize_metas(port)
    assert buf == ref_meta.serialize_metas(ref)
    # each reads the other's bytes back to the same directory
    assert meta.serialize_metas(meta.deserialize_metas(ref_meta.serialize_metas(ref))) == buf
    assert ref_meta.serialize_metas(ref_meta.deserialize_metas(buf)) == buf
    assert [(m.offset, [(p.length, p.num_values) for p in m.pages])
            for m in meta.deserialize_metas(buf)] == raw
    if len(buf) > 8:
        with pytest.raises(OutOfSpecError):
            meta.deserialize_metas(buf[:-1])


# ---------------------------------------------------------------------------
# util: bits, env, hybrid_rle, roaring


@pytest.mark.parametrize("b", range(0, 33))
def test_pack_blocks_matches_reference(b):
    rng = np.random.default_rng(b)
    vals = rng.integers(0, 1 << b, (37, 128), dtype=np.uint64).astype(np.uint32)
    got = bits.pack_blocks(vals, b)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref_bits.pack_blocks(vals, b))
    assert bits.BLOCK_LEN == ref_bits.BLOCK_LEN


@pytest.mark.parametrize("value", [None, "1", "0", "true"])
def test_env_flags_match_reference(monkeypatch, value):
    pairs = [(env.check_dict_env, ref_env.check_dict_env, env.DICT_ENV),
             (env.check_rle_env, ref_env.check_rle_env, env.RLE_ENV),
             (env.check_freq_env, ref_env.check_freq_env, env.FREQ_ENV),
             (env.check_bitpack_env, ref_env.check_bitpack_env, env.BITPACK_ENV),
             (env.check_patas_env, ref_env.check_patas_env, env.PATAS_ENV)]
    for _port, _ref, name in pairs:
        monkeypatch.delenv(name, raising=False)
    for port_fn, ref_fn, name in pairs:
        if value is not None:
            monkeypatch.setenv(name, value)
        assert port_fn() == ref_fn() == (value == "1"), name
        monkeypatch.delenv(name, raising=False)
        assert not port_fn() and not ref_fn()


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 4099])
def test_validity_levels_match_reference(n):
    rng = np.random.default_rng(n)
    validity = rng.random(n) < 0.7
    buf = hybrid_rle.encode_validity_bitpacked(validity)
    assert buf == ref_rle.encode_validity_bitpacked(validity)
    np.testing.assert_array_equal(hybrid_rle.decode_validity(buf, n), validity)
    np.testing.assert_array_equal(hybrid_rle.decode_validity(buf, n),
                                  ref_rle.decode_validity(buf, n))


def test_validity_levels_refuse_rle_runs_and_read_several_runs():
    rng = np.random.default_rng(5)
    # long constant stretches make the reference encoder emit RLE runs
    levels = np.repeat(rng.random(40) < 0.5, 24)
    buf = ref_rle.encode_levels(levels.astype(np.uint32), 1)
    with pytest.raises(OutOfSpecError):
        hybrid_rle.decode_validity(buf, len(levels))
    # two bit-packed runs back to back
    a, b = rng.random(16) < 0.5, rng.random(40) < 0.5
    two = ref_rle.encode_bitpacked(a.astype(np.uint32), 1) + ref_rle.encode_bitpacked(
        b.astype(np.uint32), 1)
    np.testing.assert_array_equal(hybrid_rle.decode_validity(two, 56), np.concatenate([a, b]))
    np.testing.assert_array_equal(hybrid_rle.decode_validity(two, 56),
                                  ref_rle.decode_validity(two, 56))
    with pytest.raises(OutOfSpecError):
        hybrid_rle.decode_validity(b"\x80", 8)  # a varint cut short


def _roaring_positions(kind, rng):
    if kind == "empty":
        return np.empty(0, np.uint32)
    if kind == "sparse":
        return np.unique(rng.integers(0, 1 << 32, 300, dtype=np.uint64)).astype(np.uint32)
    if kind == "dense":  # one container above 4096 entries: a bitset
        return np.unique(rng.integers(0, 1 << 16, 20000)).astype(np.uint32)
    # several containers, array and bitset, keys 0..5
    return np.unique(np.concatenate([
        rng.integers(k << 16, (k + 1) << 16, 6000 if k % 2 else 50) for k in range(6)
    ])).astype(np.uint32)


@pytest.mark.parametrize("kind", ["empty", "sparse", "dense", "mixed"])
def test_roaring_deserialize_matches_reference(kind):
    positions = _roaring_positions(kind, np.random.default_rng(11))
    buf = ref_roaring.serialize(positions)
    got = roaring.deserialize(buf)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref_roaring.deserialize(buf))
    np.testing.assert_array_equal(got, positions)


def test_roaring_run_containers_match_reference():
    """The run form (cookie 12347), which the writer never emits but a
    reader must take: container 0 holds runs, container 1 an array."""
    n = 2
    head = np.uint32(ref_roaring.SERIAL_COOKIE | ((n - 1) << 16)).tobytes()
    flags = bytes([0b01])  # container 0 is a run container
    runs = np.array([3, 4, 100, 0, 65000, 9], "<u2")  # [start, len-1] pairs
    array = np.array([1, 7, 9], "<u2")
    desc = np.array([0, 16 - 1, 2, len(array) - 1], "<u2")  # [key, card-1] pairs
    body = np.uint16(len(runs) // 2).tobytes() + runs.tobytes() + array.tobytes()
    buf = head + flags + desc.tobytes() + body  # n < 4: no offsets
    want = np.concatenate([np.arange(3, 8), [100], np.arange(65000, 65010),
                           (2 << 16) + array.astype(np.uint32)]).astype(np.uint32)
    np.testing.assert_array_equal(roaring.deserialize(buf), want)
    np.testing.assert_array_equal(ref_roaring.deserialize(buf), want)
    for bad in (b"\x01\x00", np.uint32(777).tobytes() + bytes(8)):
        with pytest.raises(OutOfSpecError):
            roaring.deserialize(bad)


# ---------------------------------------------------------------------------
# native


@pytest.fixture(scope="module")
def both_native():
    if not native.available():
        pytest.skip(f"the port's native library does not build here: {native.load_error()}")
    if not ref_native.available():
        pytest.skip("the JAX package's native library does not build here")
    return native, ref_native


def test_native_library_builds_under_the_port(both_native):
    path = pathlib.Path(native.library_path()).resolve()
    assert PORT.resolve() in path.parents
    assert path.parent == (PORT / "native" / "build").resolve()
    assert path.exists()
    assert native.load_error() is None


def _bp_page(rng, n_blocks):
    widths = rng.integers(0, 33, n_blocks)
    widths[::5] = 0
    blocks = np.zeros((n_blocks, 128), np.uint32)
    for i, w in enumerate(widths):
        if w:
            blocks[i] = rng.integers(0, 1 << int(w), 128, dtype=np.uint64).astype(np.uint32)
            blocks[i, 0] |= np.uint32(1 << (int(w) - 1))  # the block is exactly w wide
    return blocks, widths


@pytest.mark.parametrize("seed", range(3))
def test_native_bp_encode_and_walk_match_reference(both_native, seed):
    rng = np.random.default_rng(seed)
    blocks, widths = _bp_page(rng, 300)
    page = native.bp_encode(blocks, blocks)
    assert page == ref_native.bp_encode(blocks, blocks)
    buf = np.frombuffer(b"xyz" + page, np.uint8)
    nbs, end = native.bp_walk(buf, 3, len(blocks))
    ref_nbs, ref_end = ref_native.bp_walk(buf, 3, len(blocks))
    np.testing.assert_array_equal(nbs, widths)
    np.testing.assert_array_equal(nbs, ref_nbs)
    assert end == ref_end == len(buf)
    with pytest.raises(OutOfSpecError):
        native.bp_walk(buf[:-1], 3, len(blocks))
    # a block's width comes from the OR of its width row, which may be
    # wider than the payload (delta pages)
    low = blocks & np.uint32(0xF)
    assert native.bp_encode(low, blocks) == ref_native.bp_encode(low, blocks)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_native_factorize_matches_reference(both_native, dtype):
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 5000, 50_000).astype(dtype)
    codes, uniq = native.factorize(vals)
    ref_codes, ref_uniq = ref_native.factorize(vals)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_array_equal(uniq, ref_uniq)
    np.testing.assert_array_equal(uniq[codes], vals)
    assert native.factorize(vals, max_uniq=100) is None
    assert ref_native.factorize(vals, max_uniq=100) is None
    with pytest.raises(TypeError):
        native.factorize(vals.astype(np.int64))


def _ref_compress(codec, data: bytes) -> bytes:
    lib = ref_native._load()
    cap = lib.sb_compress_bound(int(codec), len(data))
    out = np.empty(cap, np.uint8)
    src = np.frombuffer(data, np.uint8)
    n = lib.sb_compress(int(codec), src.ctypes.data, len(src), out.ctypes.data, cap)
    assert n > 0
    return out[:n].tobytes()


@pytest.mark.parametrize("codec", [constants.Compression.LZ4, constants.Compression.ZSTD,
                                   constants.Compression.SNAPPY])
def test_native_decompress_batch_matches_reference(both_native, codec):
    if codec == constants.Compression.SNAPPY and not native._load().sb_has_snappy():
        pytest.skip("libsnappy.so.1 is absent here")
    rng = np.random.default_rng(int(codec))
    pages = [np.repeat(rng.integers(0, 50, n // 8 + 1), 8)[:n].astype(np.int32).tobytes()
             for n in (0, 1, 1000, 65536)]
    comp = [_ref_compress(codec, p) for p in pages]
    got = native.decompress_batch(int(codec), comp, [len(p) for p in pages])
    ref = ref_native.decompress_batch(int(codec), comp, [len(p) for p in pages])
    assert [g.tobytes() for g in got] == pages == [r.tobytes() for r in ref]
    with pytest.raises(OutOfSpecError):  # a size that does not match the page
        native.decompress_batch(int(codec), comp[2:3], [len(pages[2]) + 1])


def test_native_without_snappy_raises_on_snappy_pages(both_native, monkeypatch):
    """The build of a host without libsnappy: LZ4 works, a Snappy page
    raises an error that names the missing library."""
    out = os.path.join(native.BUILD, f"libstrawboat_native_test_{os.getpid()}.so")
    try:
        native._build(out, snappy=False)
        lib = ctypes.CDLL(out)
        native._bind(lib)
        assert lib.sb_has_snappy() == 0
        monkeypatch.setitem(native._state, "lib", lib)
        page = np.arange(512, dtype=np.int32).tobytes()
        lz4 = _ref_compress(constants.Compression.LZ4, page)
        assert native.decompress_batch(int(constants.Compression.LZ4), [lz4], [len(page)])[0].tobytes() == page
        with pytest.raises(StrawboatError, match="libsnappy"):
            native.decompress_batch(int(constants.Compression.SNAPPY), [b"\x00"], [0])
    finally:
        if os.path.exists(out):
            os.unlink(out)


def test_native_unavailable_is_loud(monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    for call in (lambda: native.bp_walk(np.zeros(4, np.uint8), 0, 1),
                 lambda: native.factorize(np.zeros(4, np.uint32)),
                 lambda: native.decompress_batch(1, [b""], [0])):
        with pytest.raises(StrawboatError, match="native library"):
            call()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_native_patas_matches_reference(both_native, dtype):
    """PATAS streams: the native and Python encoders give the reference's
    bytes (repeats within and beyond the 128-value window, NaN payloads,
    ±0.0, ±inf), and both decoders give the values back bit for bit."""
    from strawboat_tpu.codecs import double as ref_double
    from strawboat_tpu_torch.codecs import double

    rng = np.random.default_rng(9)
    v = np.round(np.cumsum(rng.normal(size=3000)), 3).astype(dtype)
    v[100:110] = v[99]
    v[500] = v[300]  # beyond the window: refers to the previous value
    v[700:706] = np.array([np.nan, np.uint64(0x7FF8000000000123).view(np.float64), -0.0, 0.0,
                           np.inf, -np.inf]).astype(dtype)
    enc = native.patas_encode_native(v)
    assert enc == ref_native.patas_encode_native(v)
    short = v[:200]
    assert double._patas_encode_py(short) == ref_double._patas_encode_py(short)
    buf = np.frombuffer(b"pad" + enc, np.uint8)
    got = native.patas_decode_native(buf, 3, len(v), dtype)
    assert got.dtype == dtype and got.tobytes() == v.tobytes()
    assert ref_native.patas_decode_native(buf, 3, len(v), dtype).tobytes() == v.tobytes()
    sbuf = np.frombuffer(double._patas_encode_py(short), np.uint8)
    assert double._patas_decode_py(sbuf, 0, len(short), np.dtype(dtype)).tobytes() == short.tobytes()
    with pytest.raises(OutOfSpecError):
        native.patas_decode_native(buf[:100], 3, len(v), dtype)


def test_native_decompress_batch_into_matches_reference(both_native):
    """Pages decompress straight into their slices of one buffer, as the
    reference's ``decompress_batch_into`` puts them; a slice outside the
    buffer is refused before any native call."""
    rng = np.random.default_rng(5)
    pages = [rng.integers(0, 9, n).astype(np.int32).tobytes() for n in (1, 1000, 0, 4096)]
    codec = constants.Compression.LZ4
    comp = [_ref_compress(codec, p) for p in pages]
    lens = np.array([len(p) for p in pages])
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]) + 16
    out = np.zeros(int(lens.sum()) + 16, np.uint8)
    ref = np.zeros_like(out)
    native.decompress_batch_into(int(codec), comp, out, offs, lens)
    ref_native.decompress_batch_into(int(codec), comp, ref, offs, lens)
    assert out.tobytes() == ref.tobytes() == bytes(16) + b"".join(pages)
    with pytest.raises(ValueError):
        native.decompress_batch_into(int(codec), comp, out[:-1], offs, lens)
    with pytest.raises(OutOfSpecError):
        native.decompress_batch_into(int(codec), comp[1:2], out, [0], [lens[1] - 4])


@pytest.mark.parametrize("n", [0, 1, 4096, 4097, 70000])
def test_roaring_serialize_matches_jax(n):
    rng = np.random.default_rng(n)
    for positions in (np.unique(rng.integers(0, 1 << 20, n)).astype(np.uint32),
                      np.arange(n, dtype=np.uint32)):
        buf = roaring.serialize(positions)
        assert buf == ref_roaring.serialize(positions)
        np.testing.assert_array_equal(roaring.deserialize(buf), positions)


@pytest.mark.parametrize("codec", [constants.Compression.LZ4, constants.Compression.ZSTD,
                                   constants.Compression.SNAPPY])
def test_native_compress_matches_jax(codec):
    from strawboat_tpu.codecs import common as ref_common

    if codec == constants.Compression.SNAPPY and not native._load().sb_has_snappy():
        pytest.skip("libsnappy.so.1 is absent here")
    rng = np.random.default_rng(int(codec))
    pages = [b"", b"x", np.repeat(rng.integers(0, 50, 9000), 8).astype(np.int32).tobytes(),
             rng.integers(0, 256, 100_000).astype(np.uint8).tobytes()]
    want = [ref_common.compress(ref_constants.Compression(int(codec)), p) for p in pages]
    assert native.compress_batch(int(codec), pages) == want
    assert [native.compress_batch(int(codec), [p])[0] for p in pages] == want


def test_native_int_stats_matches_jax():
    """The one-pass page stats (``_family.int_stats_native`` over
    ``native.int_stats``) give the JAX package's, top value included."""
    from strawboat_tpu_torch.codecs import _family

    fields = ("tuple_count", "total_bytes", "null_count", "average_run_length", "is_sorted",
              "unique_count", "max_count", "set_count", "min", "max", "top_value")
    rng = np.random.default_rng(4)
    for dtype in (np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.int64, np.uint64):
        v = rng.integers(0, 100, 10_000).astype(dtype)
        v[::3] = np.iinfo(dtype).max
        valid = rng.random(len(v)) > 0.1
        for mask in (None, valid):
            got = _family.int_stats_native(v, mask)
            want = ref_native.int_stats_native(v, mask)
            for k in fields:
                g, w = getattr(got, k), getattr(want, k)
                assert type(g) is type(w) and g == w, (dtype, k)


# ---------------------------------------------------------------------------
# nested columns: the column model, the nest chains and level expansion


def _nested_arrays(seed):
    import pyarrow as pa

    rng = np.random.default_rng(seed)
    n = 300

    def ragged(inner):
        return [None if rng.random() < 0.15 else [inner() for _ in range(int(rng.integers(0, 4)))]
                for _ in range(n)]

    return {
        "list": pa.array(ragged(lambda: int(rng.integers(0, 9))), pa.list_(pa.int64())),
        "large_list_utf8": pa.array(ragged(lambda: "xy"[: int(rng.integers(0, 3))]),
                                    pa.large_list(pa.string())),
        "fixed_size_list": pa.array([None if i % 3 == 0 else [i, i + 1] for i in range(n)],
                                    pa.list_(pa.int32(), 2)),
        "map": pa.array(ragged(lambda: (f"k{int(rng.integers(0, 5))}", float(rng.random()))),
                        pa.map_(pa.string(), pa.float64())),
        "list_struct": pa.array(ragged(lambda: None if rng.random() < 0.2 else {
            "a": int(rng.integers(0, 9)), "b": bool(rng.random() < 0.5)}),
            pa.list_(pa.struct([("a", pa.int16()), ("b", pa.bool_())]))),
        "struct_list": pa.StructArray.from_arrays(
            [pa.array(ragged(lambda: int(rng.integers(0, 9))), pa.list_(pa.int8())),
             pa.array(rng.integers(0, 9, n))], names=["l", "v"], mask=pa.array(rng.random(n) < 0.2)),
    }


@pytest.mark.parametrize("layout", ["list", "large_list_utf8", "fixed_size_list", "map",
                                    "list_struct", "struct_list"])
def test_nest_chains_and_levels_match_reference(layout):
    """``columns.from_arrow`` / ``to_arrow``, ``write.nested.to_nested`` +
    ``slice_nested`` + ``write_levels`` and ``read.levels.expand_levels``
    against the JAX package's, page by page, for every leaf."""
    import pyarrow as pa

    from strawboat_tpu import columns as ref_columns
    from strawboat_tpu.read import levels as ref_levels
    from strawboat_tpu.write import nested as ref_nested
    from strawboat_tpu_torch import columns as cm
    from strawboat_tpu_torch.read import levels
    from strawboat_tpu_torch.write import nested

    arr = _nested_arrays(11)[layout]
    pf = pa.field("c", arr.type)
    f = cm.field_from_arrow(pf)
    col = cm.from_arrow(arr)
    assert cm.to_arrow(col, f).equals(arr)
    assert cm.to_arrow(col.slice(7, 50), f).equals(arr.slice(7, 50))
    assert cm.to_arrow(col.take(np.array([5, 0, 9])), f).equals(arr.take([5, 0, 9]))
    ref_leaves = ref_nested.to_nested(ref_columns.from_arrow(arr), pf)
    leaves = nested.to_nested(col, f)
    assert len(leaves) == len(ref_leaves) == f.n_leaves
    inits = levels.field_inits(f)
    for (nests, leaf), (rnests, rleaf), init in zip(leaves, ref_leaves, inits):
        assert [(n.kind, n.nullable) for n in nests] == [(n.kind, n.nullable) for n in rnests]
        assert levels.nests_to_init(nests) == init
        for off, ln in ((0, 100), (100, 100), (200, 100)):
            s_n, _s_l = nested.slice_nested(nests, leaf, off, ln)
            r_n, _r_l = ref_nested.slice_nested(rnests, rleaf, off, ln)
            got = nested.write_levels(s_n)
            want = ref_nested.write_levels(r_n)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
            state, leaf_valid = levels.expand_levels(got[0].astype(np.int64),
                                                     got[1].astype(np.int64), init)
            r_state, r_valid = ref_levels.expand_levels(
                want[0].astype(np.int64), want[1].astype(np.int64),
                ref_levels.nests_to_init(r_n))
            assert (leaf_valid is None) == (r_valid is None)
            if leaf_valid is not None:
                assert np.array_equal(leaf_valid, r_valid)
            for a, b in zip(state.levels, r_state.levels):
                assert (a.kind, a.nullable, a.length) == (b.kind, b.nullable, b.length)
                for x, y in ((a.validity, b.validity), (a.offsets, b.offsets)):
                    assert (x is None) == (y is None) and (x is None or np.array_equal(x, y))
    assert [lf.dtype for lf in levels.leaf_fields(f)] == [str(t) for t in
                                                          _leaf_types(pf.type)]


def _leaf_types(t):
    import pyarrow as pa

    from strawboat_tpu_torch import columns as cm

    if pa.types.is_struct(t):
        return [x for i in range(t.num_fields) for x in _leaf_types(t.field(i).type)]
    if pa.types.is_map(t):
        return _leaf_types(t.key_type) + _leaf_types(t.item_type)
    if pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_fixed_size_list(t):
        return _leaf_types(t.value_type)
    return [cm.field_from_arrow(pa.field("x", t)).dtype]


@pytest.mark.parametrize("seed", range(3))
def test_native_bp_decode_matches_reference(both_native, seed, monkeypatch):
    """A page of mixed widths decodes to its blocks through the native
    call of either package, and through the port's numpy route when the
    library is missing (``codecs.integer.bitpack_decode``)."""
    from strawboat_tpu_torch.codecs import integer

    rng = np.random.default_rng(seed)
    blocks, _ = _bp_page(rng, 200)
    buf = np.frombuffer(b"xyz" + ref_native.bp_encode(blocks, blocks), np.uint8)
    vals, end = native.bp_decode(buf, 3, len(blocks))
    ref_vals, ref_end = ref_native.bp_decode(buf, 3, len(blocks))
    np.testing.assert_array_equal(vals, ref_vals)
    np.testing.assert_array_equal(vals, blocks.reshape(-1))
    assert end == ref_end == len(buf)
    with pytest.raises(OutOfSpecError):
        native.bp_decode(buf[:-1], 3, len(blocks))
    n = len(blocks) * 128 - 77
    got, got_end = integer.bitpack_decode(buf, 3, n, np.dtype(np.int32))
    monkeypatch.setattr(native, "_load", lambda: None)
    plain, plain_end = integer.bitpack_decode(buf, 3, n, np.dtype(np.int32))
    assert got.tobytes() == plain.tobytes() == blocks.reshape(-1)[:n].tobytes()
    assert got_end == plain_end == len(buf)
    with pytest.raises(OutOfSpecError):
        integer.bitpack_decode(buf[:-1], 3, n, np.dtype(np.int32))


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_native_dict_column_decode_matches_reference(both_native, width):
    """Pages of bit-packed, raw and delta codes gather from one
    concatenated dictionary into their rows, as the reference's call does;
    a code beyond the dictionary raises."""
    from strawboat_tpu.codecs.integer import bitpack_encode, delta_bitpack_encode

    rng = np.random.default_rng(width)
    dtype = np.dtype(f"<u{width}")
    dicts = [rng.integers(0, 1 << (8 * width - 1), k, dtype=np.uint64).astype(dtype)
             for k in (5, 100, 1)]
    sizes = (640, 300, 128)
    codes = [rng.integers(0, len(d), n).astype(np.uint32) for d, n in zip(dicts, sizes)]
    codes[2] = np.zeros(128, np.uint32)
    pad = -len(codes[0]) % 128  # bit-packed pages are whole blocks
    bp_page = np.frombuffer(b"ab" + bitpack_encode(np.concatenate([codes[0], np.zeros(pad, np.uint32)])),
                            np.uint8)
    delta_page = np.frombuffer(delta_bitpack_encode(np.sort(codes[2])), np.uint8)
    bases = np.concatenate([[0], np.cumsum([len(d) for d in dicts])[:-1]])
    rows = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pages = [(bp_page, 2, sizes[0], rows[0], bases[0], 0),
             (codes[1].view(np.uint8), None, sizes[1], rows[1], bases[1], 1),
             (delta_page, 0, sizes[2], rows[2], bases[2], 2)]
    all_dict = np.concatenate(dicts)
    out = np.zeros(sum(sizes), dtype)
    ref_out = np.zeros_like(out)
    native.dict_column_decode(pages, all_dict, out)
    ref_native.dict_column_decode(pages, all_dict, ref_out)
    assert out.tobytes() == ref_out.tobytes()
    want = np.concatenate([d[c] for d, c in zip(dicts, (codes[0], codes[1], np.sort(codes[2])))])
    np.testing.assert_array_equal(out, want)
    with pytest.raises(OutOfSpecError):
        native.dict_column_decode(pages[1:2], all_dict[:50], out)
