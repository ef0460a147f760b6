"""Resident tables in the torch port against the JAX reference.

The port's ``make_resident`` and the reference's run on the same inputs at
``tile=512``; the planes must match word for word, with the same encode
metadata and dictionaries, and every decode and query must give the same
answer.  The reference's Pallas unpack runs in interpret mode; the port runs
its plain torch versions on the CPU.  Tolerance: exact, except float sums
(the two frameworks add in different orders: rtol 1e-12).
"""

import importlib
from unittest import mock

import numpy as np
import pyarrow as pa
import pytest
import torch

from strawboat_tpu_torch.errors import NotYetImplementedError, OutOfSpecError
from strawboat_tpu_torch.exec import resident as port

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


def _ref_make(t):
    from strawboat_tpu.exec.resident import make_resident

    return make_resident(t, tile=TILE)


def _nullable(values, valid, typ):
    return pa.array([v if ok else None for v, ok in zip(values.tolist(), valid)], typ)


def _table(case: str) -> pa.Table:
    rng = np.random.default_rng(abs(hash(case)) % (1 << 32))
    n = 3000
    if case == "lineitem":
        from strawboat_tpu.benchsuite.tpch import generate_lineitem

        return generate_lineitem(1.0, rows=70_000)  # past the device-pack cut
    if case == "nullable_ints":
        valid = rng.random(n) < 0.8
        return pa.table({
            "i32": _nullable(rng.integers(-5000, 5000, n), valid, pa.int32()),
            "i64": _nullable(rng.integers(0, 1 << 40, n), valid, pa.int64()),
            "g": pa.array(rng.integers(0, 6, n).astype(np.int32)),
        })
    if case == "int64_extremes":
        big = np.iinfo(np.int64)
        v = rng.integers(-(1 << 62), 1 << 62, n)
        v[:4] = [big.min, big.max, big.min + 1, big.max - 1]
        return pa.table({
            "x": pa.array(v),
            "pos": pa.array(rng.integers(big.max - 1000, big.max, n, endpoint=True)),
            "g": pa.array(rng.integers(0, 4, n)),
        })
    if case == "floats":
        specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5, -2.25])
        f64 = rng.normal(0, 1e6, n)
        f64[: len(specials)] = specials
        f32 = rng.standard_normal(n).astype(np.float32)
        f32[: len(specials)] = specials.astype(np.float32)
        valid = rng.random(n) < 0.9
        return pa.table({
            "f64": pa.array(f64),
            "f32": pa.array(f32),
            "f64_dict": pa.array(rng.integers(0, 40, n) * 0.25),
            "f32_nullable": _nullable(np.round(f32, 2), valid, pa.float32()),
            "g": pa.array(rng.integers(0, 5, n)),
        })
    if case == "strings":
        words = np.array(["delta", "alpha", "", "échelle", "charlie", "bravo"])
        valid = rng.random(n) < 0.85
        return pa.table({
            "s": _nullable(words[rng.integers(0, 6, n)], valid, pa.string()),
            "flag": pa.array(np.array(["R", "A", "N"])[rng.integers(0, 3, n)]),
            "v": pa.array(rng.integers(0, 100, n)),
        })
    if case == "bools":
        valid = rng.random(n) < 0.7
        return pa.table({
            "b": pa.array(rng.random(n) < 0.5),
            "nb": _nullable(rng.random(n) < 0.3, valid, pa.bool_()),
            "v": pa.array(rng.integers(0, 1000, n).astype(np.int32)),
        })
    if case == "wide_groups":  # keys up to 6000: those past 5000 drop out
        n = 20_000
        valid = rng.random(n) < 0.9
        return pa.table({
            "k": pa.array(rng.integers(0, 6000, n)),
            "p": pa.array(rng.integers(0, 100, n).astype(np.int32)),
            "v": _nullable(rng.integers(-(1 << 40), 1 << 40, n), valid, pa.int64()),
        })
    if case == "decimal":
        from decimal import Decimal

        unscaled = rng.integers(-(10**17), 10**17, n)
        valid = rng.random(n) < 0.9
        return pa.table({
            "d": pa.array(
                [Decimal(int(u)).scaleb(-2) if ok else None for u, ok in zip(unscaled, valid)],
                pa.decimal128(18, 2),
            ),
            "g": pa.array(rng.integers(0, 3, n)),
        })
    raise KeyError(case)


CASES = ("lineitem", "nullable_ints", "int64_extremes", "floats", "strings", "bools", "decimal")
# (filter column, bounds, value column, product column, group key, num_groups)
QUERIES = {
    "lineitem": ("l_shipdate", (731, 1096), "l_extendedprice", "l_discount", "l_returnflag", 3),
    "nullable_ints": ("i32", (-1000, 3000), "i64", None, "g", 6),
    "int64_extremes": ("x", (0, None), "x", None, "g", 4),
    "floats": ("f64_dict", (2.0, 7.5), "f64", "f32_nullable", "g", 5),
    "strings": ("s", ("bravo", "delta"), "v", None, "s", 6),
    "bools": ("v", (100, 900), "v", None, "v", 1000),
    "decimal": ("d", (None, 10**15), "d", None, "g", 3),
    # group_sum past K6_MAX_GROUPS: the scatter route of dense_group_sum
    "wide_groups": ("p", (10, 90), "v", None, "k", 5000),
}


@pytest.fixture(scope="module")
def tables():
    built = {}

    def get(case):
        if case not in built:
            t = _table(case)
            built[case] = (t, _ref_make(t), port.make_resident(t, "cpu", tile=TILE))
        return built[case]

    return get


@pytest.fixture(scope="module")
def ref_decoded(tables):
    """The reference's natural-order decode of (case, column, with_dict),
    computed once: interpreted Pallas is the slow part of this module."""
    memo = {}

    def get(case, name, with_dict=True):
        key = (case, name, with_dict)
        if key not in memo:
            memo[key] = np.asarray(tables(case)[1].decode_natural(name, with_dict))
        return memo[key]

    return get


def _np(x):
    return np.asarray(x)


def _u32(words):
    """Plane words (port int32 view or reference uint32) as uint32."""
    return np.asarray(words).view(np.uint32)


def _dtype_name(d) -> str:
    return str(d).split(".")[-1] if isinstance(d, torch.dtype) else str(np.dtype(d))


def _assert_same_column(name, pc, rc):
    assert (pc.kind, pc.shifts, pc.length, pc.offset, pc.bit_shift, pc.wide) == (
        rc.kind, tuple(rc.shifts), rc.length, rc.offset, rc.bit_shift, rc.wide
    ), name
    assert [b for _w, b in pc.planes] == [b for _w, b in rc.planes], name
    for (pw, _b), (rw, _rb) in zip(pc.planes, rc.planes):
        assert tuple(pw.shape) == _np(rw).shape, name
        np.testing.assert_array_equal(_u32(pw), _u32(rw), err_msg=name)
    assert (pc.validity_plane is None) == (rc.validity_plane is None), name
    if pc.validity_plane is not None:
        np.testing.assert_array_equal(
            _u32(pc.validity_plane), _u32(rc.validity_plane), err_msg=name
        )
    assert (pc.dictionary_host is None) == (rc.dictionary_host is None), name
    if pc.dictionary_host is not None:
        assert pc.dictionary_host.dtype == rc.dictionary_host.dtype, name
        assert list(pc.dictionary_host) == list(rc.dictionary_host), name
    assert (pc.dictionary is None) == (rc.dictionary is None), name
    if pc.dictionary is not None:
        np.testing.assert_array_equal(_np(pc.dictionary), _np(rc.dictionary), err_msg=name)
        assert _np(pc.dictionary).dtype == _np(rc.dictionary).dtype, name
    assert _dtype_name(pc.decoded_dtype()) == _dtype_name(rc.decoded_dtype()), name


@pytest.mark.parametrize("case", CASES)
def test_planes_match_reference(tables, case):
    _t, rt_ref, rt = tables(case)
    assert (rt.num_rows, rt.tile, rt.tiled_slots) == (rt_ref.num_rows, rt_ref.tile, rt_ref.tiled_slots)
    assert list(rt.columns) == list(rt_ref.columns)
    for name in rt.columns:
        _assert_same_column(name, rt[name], rt_ref[name])


def _same_values(got: torch.Tensor, want, name):
    want = _np(want)
    g = got.numpy()
    assert g.dtype == want.dtype, (name, g.dtype, want.dtype)
    if g.dtype.kind == "f":  # bit-exact: NaN payloads, ±inf, -0.0
        g, want = g.view(f"u{g.itemsize}"), want.view(f"u{want.itemsize}")
    np.testing.assert_array_equal(g, want, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_decode_and_to_arrow_match_reference(tables, ref_decoded, case):
    t, rt_ref, rt = tables(case)
    for name in rt.columns:
        _same_values(rt.decode_natural(name), ref_decoded(case, name), name)
        if rt[name].dictionary is not None:  # code space differs from values
            _same_values(
                rt.decode_natural(name, with_dict=False),
                ref_decoded(case, name, with_dict=False),
                name,
            )
        vp, vr = rt.validity_natural(name), rt_ref.validity_natural(name)
        assert (vp is None) == (vr is None), name
        if vp is not None:
            _same_values(vp, vr, name)
    got = rt.to_arrow()
    _assert_same_table(got, rt_ref.to_arrow())
    _assert_same_table(got, t)
    # the decoded tiled view: padding slots masked off, natural row order
    dt, mask = rt.as_device_table()
    assert dt.num_rows == rt.tiled_slots and int(mask.sum()) == rt.num_rows
    _assert_same_table(dt.to_arrow(mask), t)


def _assert_same_table(got: pa.Table, want: pa.Table):
    """Table equality with floats compared by bit pattern (NaN != NaN in
    ``pa.Table.equals``)."""
    assert got.schema == want.schema
    for name in want.column_names:
        g, w = got.column(name).combine_chunks(), want.column(name).combine_chunks()
        if not pa.types.is_floating(w.type):
            assert g.equals(w), name
            continue
        ok = ~np.asarray(w.is_null())
        np.testing.assert_array_equal(~np.asarray(g.is_null()), ok, err_msg=name)
        u = f"u{w.type.bit_width // 8}"
        gb = np.frombuffer(g.buffers()[1], w.type.to_pandas_dtype(), len(g), g.offset * (w.type.bit_width // 8))
        wb = np.frombuffer(w.buffers()[1], w.type.to_pandas_dtype(), len(w), w.offset * (w.type.bit_width // 8))
        np.testing.assert_array_equal(gb.view(u)[ok], wb.view(u)[ok], err_msg=name)


def _queries(rt, case):
    fcol, bounds, value, prod, key, ng = QUERIES[case]
    fs = rt.filter_sum({fcol: bounds}, value=value, product_with=prod)
    (sums,), cnt = rt.group_sum(key, [value], num_groups=ng, predicates={fcol: bounds})
    return _np(fs), _np(sums), _np(cnt)


def _assert_same_answers(got, want, case):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, case
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=case)
        else:
            np.testing.assert_array_equal(g, w, err_msg=case)


@pytest.mark.parametrize("case", CASES + ("wide_groups",))
def test_queries_match_reference(tables, ref_decoded, case):
    """filter_sum and group_sum, over the port's own encode and over the
    reference's planes carried across with ``from_reference``."""
    _t, rt_ref, rt = tables(case)
    want = _queries(rt_ref, case)
    _assert_same_answers([x.numpy() for x in map(torch.as_tensor, _queries(rt, case))], want, case)
    carried = port.ResidentTable.from_reference(rt_ref, "cpu")
    _assert_same_answers(list(_queries(carried, case)), want, case)
    for name in rt.columns:
        _same_values(carried.decode_natural(name), ref_decoded(case, name), name)


@pytest.mark.parametrize("case", CASES)
def test_fused_queries_decode_in_one_k1_call(tables, case, monkeypatch):
    """filter_sum and group_sum hand every plane and validity plane of the
    columns they read to one K1 call, and give the reference's answers."""
    _t, rt_ref, rt = tables(case)
    want = _queries(rt_ref, case)
    calls = []
    orig = port.bitunpack_tiled_many

    def counting(planes, seed=0):
        calls.append(len(planes))
        return orig(planes, seed)

    monkeypatch.setattr(port, "bitunpack_tiled_many", counting)
    got = [x.numpy() for x in map(torch.as_tensor, _queries(rt, case))]

    def planes(*names):
        cs = [rt.columns[n] for n in dict.fromkeys(n for n in names if n)]
        return sum(len(c.planes) + (c.validity_plane is not None) for c in cs)

    fcol, _bounds, value, prod, key, _ng = QUERIES[case]
    assert calls == [planes(fcol, value, prod), planes(key, value, fcol)]
    _assert_same_answers(got, want, case)


def _masked(arr: pa.Array):
    """pa column → numpy (a MaskedArray where it has nulls)."""
    t = arr.type
    if pa.types.is_string(t):
        vals = np.array([v if v is not None else "" for v in arr.to_pylist()])
    elif pa.types.is_floating(t):
        vals = np.frombuffer(arr.buffers()[1], dtype=t.to_pandas_dtype(), count=len(arr)).copy()
    else:
        vals = np.asarray(arr.fill_null(False if pa.types.is_boolean(t) else 0))
    if arr.null_count:
        return np.ma.MaskedArray(vals, mask=np.asarray(arr.is_null()))
    return vals


@pytest.mark.parametrize("case", ("lineitem", "nullable_ints", "floats", "strings", "bools"))
def test_numpy_front_matches_pa_front(tables, case):
    t, _rt_ref, rt = tables(case)
    cols = {f.name: _masked(t.column(f.name).combine_chunks()) for f in t.schema}
    rt_np = port.make_resident(cols, "cpu", tile=TILE)
    for name in rt.columns:
        _assert_same_column(name, rt_np[name], rt[name])
    _assert_same_table(rt_np.to_arrow(), t)


def test_numpy_lineitem_generator_front(tables):
    """The port's own numpy generator + numpy front == the reference's
    arrow generator + make_resident, word for word."""
    from strawboat_tpu_torch.benchsuite.tpch import generate_lineitem

    _t, rt_ref, _rt = tables("lineitem")
    rt_np = port.make_resident(generate_lineitem(1.0, rows=70_000), "cpu", tile=TILE)
    for name in rt_ref.columns:
        _assert_same_column(name, rt_np[name], rt_ref[name])


def test_pack_plane_device_matches_host_and_reference():
    from strawboat_tpu.exec.resident import _pack_plane as ref_pack

    rng = np.random.default_rng(7)
    for bits in (1, 3, 5, 7, 8, 12, 16, 17, 20, 24, 31, 32):
        n = int(rng.integers(100, 5000))
        vals = rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)
        host = port._pack_plane(vals, bits, TILE, torch.device("cpu"))
        dev = port._pack_plane_device(torch.from_numpy(vals.view(np.int32)), bits, TILE)
        assert torch.equal(host, dev), bits
        np.testing.assert_array_equal(host.numpy().view(np.uint32), _np(ref_pack(vals, bits, TILE)))


def test_slot_order_is_natural_order():
    """Packed then unpacked, tiled slot s holds row s."""
    from strawboat_tpu.exec.resident import _slot_source_index

    np.testing.assert_array_equal(port._slot_source_index(2, TILE), _slot_source_index(2, TILE))
    vals = np.arange(40_000, dtype=np.uint32)
    wt3 = port._pack_plane(vals, 16, TILE, torch.device("cpu"))
    flat = port._unpack_plane_tiled(wt3, 16).numpy()
    np.testing.assert_array_equal(flat[: len(vals)], vals)


def test_nested_and_device_table_inputs_raise():
    # nested columns load now; list_sum over strings raises, as in the
    # reference (resident.py:636-637)
    t = pa.table({"l": pa.array([[1, 2], [3]], pa.list_(pa.int64())),
                  "s": pa.array([["a"], []], pa.list_(pa.string()))})
    rt = port.make_resident(t, "cpu", tile=TILE)
    assert rt.list_sum("l").tolist() == [3, 3]
    with pytest.raises(NotYetImplementedError, match="list<str>"):
        rt.list_sum("s")
    # a DeviceTable encodes on the device now (f64 columns too); float16
    # raises, as in the reference, and a table without columns is refused
    f16 = port.DeviceColumn("x", "float16", torch.zeros(4, dtype=torch.float16))
    with pytest.raises(NotYetImplementedError, match="float16"):
        port.make_resident(port.DeviceTable({"x": f16}, 4), "cpu", tile=TILE)
    with pytest.raises(OutOfSpecError):
        port.make_resident(port.DeviceTable({}, 0), "cpu", tile=TILE)
    with pytest.raises(ValueError):
        port.make_resident({"x": np.arange(3)}, None)
