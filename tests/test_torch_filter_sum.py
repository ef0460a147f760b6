"""K7 (``kernels/filter_sum.py``) on the CPU: its plain version against
``ResidentTable.filter_sum``'s torch route and numpy, bit for bit, and the
choice between the two routes.

Tables are built plane by plane (``_pack_plane``), so each column has the
width and the encoding a case asks for.  The torch route is forced by
patching ``ResidentTable._k7_takes``.  The numpy reference casts each bound
as the port does (``torch.tensor(bound, dtype=<decoded dtype>)``: toward
zero) and sums in uint64, which wraps mod 2^64.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from strawboat_tpu_torch.exec import resident
from strawboat_tpu_torch.kernels import filter_sum as k7
from strawboat_tpu_torch.util import obs

TILE = 512
N = 5_000  # not a multiple of 128: the planes end in padding slots


def _column(name, vals, bits, valid=None, wide=False):
    """A narrow integer column: one ``bits``-wide plane of ``vals`` (each
    below 2^bits), no offset."""
    plane = resident._pack_plane(np.asarray(vals, dtype=np.uint32), bits, TILE, "cpu")
    vp = None if valid is None else resident._pack_plane(
        np.asarray(valid, dtype=np.uint32), 1, TILE, "cpu")
    return resident.ResidentColumn(name, ((plane, bits),), (0,), len(vals), "int", wide=wide,
                                   validity_plane=vp, arrow_type="int64" if wide else "int32")


def _table(*cols):
    return resident.ResidentTable({c.name: c for c in cols}, cols[0].length, TILE)


def _torch_route(rt, *args):
    with mock.patch.object(resident.ResidentTable, "_k7_takes", lambda *a: False):
        return rt.filter_sum(*args)


def _k7_route(rt, *args):
    """filter_sum through K7 (its plain version on the CPU); fails if the
    call took the torch route."""
    before = obs.counter("k7.torch_routes")
    with mock.patch.object(resident, "k7_filter_sum", wraps=k7.filter_sum) as spy:
        got = rt.filter_sum(*args)
    assert spy.call_count == 1 and obs.counter("k7.torch_routes") == before
    return got


def _cast(bound, wide):
    """The bound as the port casts it for a column of decoded dtype int32
    (or int64 where ``wide``): toward zero, raising past the dtype."""
    return int(torch.tensor(bound, dtype=torch.int64 if wide else torch.int32))


def _numpy(data, valid, predicates, value, product=None, wide=()):
    """sum(value [* product]) over rows every predicate keeps and the
    validity of every column read marks, mod 2^64, as int64."""
    keep = np.ones(len(data[value]), dtype=bool)
    read = {*predicates, value, product}
    for name, (lo, hi) in predicates.items():
        x = data[name].astype(np.int64)
        if lo is not None:
            keep &= x >= _cast(lo, name in wide)
        if hi is not None:
            keep &= x < _cast(hi, name in wide)
    for name, v in valid.items():
        if name in read:
            keep &= v
    acc = data[value].astype(np.uint64)
    if product is not None:
        acc = acc * data[product].astype(np.uint64)
    return int(acc[keep].sum(dtype=np.uint64).astype(np.int64))


def _same(rt, data, valid, predicates, value, product=None, wide=()):
    """K7's route, the torch route and numpy agree bit for bit; → the sum."""
    args = (predicates, value, product)
    got, ref = _k7_route(rt, *args), _torch_route(rt, *args)
    assert got.dtype == ref.dtype == torch.int64 and got.dim() == 0
    want = _numpy(data, valid, predicates, value, product, wide)
    assert int(got) == int(ref) == want
    return want


@pytest.mark.parametrize("bits", range(1, 32))
def test_k7_matches_torch_route_and_numpy_at_each_width(bits):
    """Value, product and predicate columns of every plane width 1..31, a
    nullable predicate column, wide and narrow decoded dtypes."""
    rng = np.random.default_rng(bits)
    top = (1 << bits) - 1
    data = {"v": rng.integers(0, top, N, endpoint=True),
            "p": rng.integers(0, 1 << min(31, 32 - bits), N),
            "f": rng.integers(0, top, N, endpoint=True)}
    data["v"][:2] = [0, top]
    pbits = max(int(data["p"].max()).bit_length(), 1)
    ok = rng.random(N) < 0.9
    rt = _table(_column("v", data["v"], bits, wide=bits % 2 == 0),
                _column("p", data["p"], pbits, wide=True),
                _column("f", data["f"], bits, valid=ok))
    mid = top // 2
    for predicates, product in (({"f": (mid // 2, mid + 1)}, "p"), ({"v": (1, None)}, None),
                                ({"f": (None, top), "v": (0, mid + 1)}, "p")):
        _same(rt, data, {"f": ok}, predicates, "v", product, wide={"v"} if bits % 2 == 0 else ())


PREDICATES = {
    "none": {},
    "lo_open_hi": {"a": (100, None)},
    "hi_open_lo": {"a": (None, 7_000)},
    "fractional": {"a": (99.5, 7_000.99), "b": (-2.5, 40.2)},
    "out_of_range": {"a": (-(10**9), 2**31 - 1), "w": (-(2**40), 2**40)},
    "three": {"a": (10, 60_000.5), "b": (3, 9), "w": (None, 2**20)},
    "empty_range": {"a": (500, 500)},
    "inverted": {"b": (9, 3)},
}


@pytest.mark.parametrize("case", PREDICATES)
def test_k7_predicates(case):
    """0–3 predicate columns, ends open, fractional, beyond the values, and
    ranges that keep no row."""
    rng = np.random.default_rng(len(case))
    data = {"a": rng.integers(0, 1 << 16, N), "b": rng.integers(0, 11, N),
            "w": rng.integers(0, 1 << 21, N), "v": rng.integers(0, 1 << 24, N)}
    rt = _table(_column("a", data["a"], 16), _column("b", data["b"], 4),
                _column("w", data["w"], 21, wide=True), _column("v", data["v"], 24))
    got = _same(rt, data, {}, PREDICATES[case], "v", "b", wide={"w"})
    if case in ("empty_range", "inverted"):
        assert got == 0


def test_k7_bound_past_int32_raises_as_the_torch_route_does():
    data = {"a": np.arange(N) % 1000, "v": np.arange(N)}
    rt = _table(_column("a", data["a"], 10), _column("v", data["v"], 13))
    for route in (_torch_route, rt.filter_sum.__func__):
        with pytest.raises(RuntimeError, match="overflow"):
            route(rt, {"a": (0, 3e9)}, "v")


@pytest.mark.parametrize("product", ["none", "other", "itself", "predicate"])
def test_k7_product(product):
    """Without a product, with another column, the value times itself, and
    a product column that is also a predicate column (Q6's discount)."""
    rng = np.random.default_rng(7)
    data = {"v": rng.integers(0, 1 << 24, N), "d": rng.integers(0, 11, N),
            "q": rng.integers(1, 51, N)}
    rt = _table(_column("v", data["v"], 24, wide=True), _column("d", data["d"], 4, wide=True),
                _column("q", data["q"], 6))
    prod = {"none": None, "other": "q", "itself": "v", "predicate": "d"}[product]
    _same(rt, data, {}, {"d": (4, 8), "q": (None, 24)}, "v", prod)


@pytest.mark.parametrize("nullable", [("v",), ("p",), ("f",), ("v", "p", "f")])
def test_k7_validity_planes(nullable):
    """Nulls of the value, the product and a predicate column never count."""
    rng = np.random.default_rng(len(nullable))
    data = {k: rng.integers(0, 1 << 12, N) for k in ("v", "p", "f")}
    valid = {k: rng.random(N) < 0.7 for k in nullable}
    rt = _table(*(_column(k, data[k], 12, valid=valid.get(k)) for k in data))
    _same(rt, data, valid, {"f": (100, 4000)}, "v", "p")


@pytest.mark.parametrize("rows", [1, 127, 129, 4 * 128 * 32 - 3])
def test_k7_padding_tail_never_counts(rows):
    """Slots at or past ``num_rows`` never count, whatever they hold."""
    rng = np.random.default_rng(rows)
    slots = resident._slots_for(rows, TILE)
    cols = [torch.from_numpy(rng.integers(1, 1 << 20, slots).astype(np.int32)) for _ in range(3)]
    v, p, f = cols
    got = k7.filter_sum(v, rows, p, [(f, 0, None)], [f])
    want = (v[:rows].long() * p[:rows].long()).sum()
    assert int(got) == int(want)
    assert int(k7.filter_sum(v, 0, p)) == 0
    rt = _table(_column("v", v[:rows].numpy(), 20), _column("f", f[:rows].numpy(), 20))
    assert rt.tiled_slots == slots
    _same(rt, {"v": v[:rows].numpy(), "f": f[:rows].numpy()}, {}, {"f": (0, None)}, "v")


@pytest.mark.parametrize("live", [0, 1, 129, N // 2])
def test_k7_reads_the_padding_mask(monkeypatch, live):
    """Both routes take which slots are real from ``mask_tiled``: a mask
    that marks fewer rows real moves K7's answer as it moves the torch
    route's."""
    data = {"v": np.arange(N) % 1000 + 1, "f": np.arange(N) % 100}
    rt = _table(_column("v", data["v"], 10), _column("f", data["f"], 7))
    mask = torch.arange(rt.tiled_slots) < live
    monkeypatch.setattr(resident.ResidentTable, "mask_tiled", lambda self: mask)
    cut = {k: v[:live] for k, v in data.items()}
    assert _same(rt, cut, {}, {"f": (10, 90)}, "v") == int(cut["v"][(cut["f"] >= 10) & (cut["f"] < 90)].sum())


def test_k7_no_row_kept():
    data = {"v": np.full(N, 5), "f": np.arange(N) % 100}
    rt = _table(_column("v", data["v"], 3), _column("f", data["f"], 7))
    assert _same(rt, data, {}, {"f": (100, None)}, "v") == 0


@pytest.mark.parametrize("rows", [N, 40_000])
def test_k7_sum_wraps_mod_2_64(rows):
    """Products near 2^62 a row: the sum wraps mod 2^64 as torch.sum's."""
    rng = np.random.default_rng(rows)
    data = {"v": rng.integers((1 << 31) - 1000, 1 << 31, rows),
            "p": rng.integers((1 << 31) - 1000, 1 << 31, rows)}
    rt = _table(_column("v", data["v"], 31, wide=True), _column("p", data["p"], 31))
    got = _same(rt, data, {}, {}, "v", "p")
    exact = sum(int(a) * int(b) for a, b in zip(data["v"], data["p"]))
    assert exact >= 1 << 64 and got == (exact + (1 << 63)) % (1 << 64) - (1 << 63)


# ---------------------------------------------------------------------------
# which filter_sums take K7


def test_resident_q6_takes_k7(monkeypatch):
    from strawboat_tpu_torch.benchsuite import tpch
    from strawboat_tpu_torch.exec import make_resident

    cols = tpch.generate_lineitem(1.0, seed=5, rows=20_000)
    rt = make_resident({k: cols[k] for k in tpch.Q1_Q6_COLUMNS}, "cpu", tile=TILE)
    planes = []
    many = resident.bitunpack_tiled_many
    monkeypatch.setattr(resident, "bitunpack_tiled_many",
                        lambda ps, seed=0: planes.append(len(ps)) or many(ps, seed))
    before = obs.counter("k7.torch_routes")
    with mock.patch.object(resident, "k7_filter_sum", wraps=k7.filter_sum) as spy:
        got = int(tpch.q6(rt))
    assert got == tpch.q6_numpy_reference(cols)
    assert spy.call_count == 1 and planes == [4] and obs.counter("k7.torch_routes") == before


def _device_table(**cols):
    """``make_resident`` of a ``DeviceTable`` of int64 columns: integers take
    offset-stripped planes there, never a dictionary."""
    from strawboat_tpu_torch.exec import DeviceColumn, DeviceTable, make_resident

    n = len(next(iter(cols.values())))
    return make_resident(DeviceTable({k: DeviceColumn(k, "int64", torch.from_numpy(v))
                                      for k, v in cols.items()}, n), "cpu", tile=TILE)


def _torch_routed_tables():
    """Columns K7 does not take: float, offset, two-plane, a dictionary
    value, a float predicate."""
    from strawboat_tpu_torch.exec import make_resident

    rng = np.random.default_rng(11)
    n = 3_000
    return {
        "float": (make_resident({"v": rng.normal(0, 1e3, n), "f": rng.integers(0, 100, n)},
                                "cpu", tile=TILE), {"f": (10, 60)}, "v"),
        "offset": (_device_table(v=rng.integers(-(10**6), 10**6, n), f=rng.integers(0, 100, n)),
                   {"f": (10, 60)}, "v"),
        "two_plane": (_device_table(v=rng.integers(0, 1 << 40, n), f=rng.integers(0, 100, n)),
                      {"f": (10, 60)}, "v"),
        "dict_value": (make_resident({"v": rng.choice([10**5, 3 * 10**7], n),
                                      "f": rng.integers(0, 1 << 20, n)}, "cpu", tile=TILE),
                       {"f": (10, 1 << 19)}, "v"),
        "float_predicate": (make_resident({"v": rng.integers(0, 1000, n),
                                           "f": rng.normal(0, 1, n)}, "cpu", tile=TILE),
                            {"f": (-0.5, 0.5)}, "v"),
    }


@pytest.mark.parametrize("case", ["float", "offset", "two_plane", "dict_value",
                                  "float_predicate"])
def test_other_columns_keep_the_torch_route(case):
    rt, predicates, value = _torch_routed_tables()[case]
    c = rt.columns[value]
    shape = {"float": c.kind == "f64", "offset": c.offset != 0, "two_plane": len(c.planes) == 2,
             "dict_value": c.is_dict, "float_predicate": rt.columns["f"].kind == "f64"}
    assert shape[case], case
    before = obs.counter("k7.torch_routes")
    with mock.patch.object(resident, "k7_filter_sum") as spy:
        got = rt.filter_sum(predicates, value)
    assert spy.call_count == 0 and obs.counter("k7.torch_routes") == before + 1
    assert torch.equal(got, _torch_route(rt, predicates, value))


def test_more_than_eight_planes_keep_the_torch_route():
    rng = np.random.default_rng(2)
    cols = [_column(f"c{i}", rng.integers(0, 100, N), 7, valid=rng.random(N) < 0.9)
            for i in range(5)]
    rt = _table(*cols)
    before = obs.counter("k7.torch_routes")
    got = rt.filter_sum({f"c{i}": (5, 90) for i in range(1, 5)}, "c0")
    assert obs.counter("k7.torch_routes") == before + 1
    assert torch.equal(got, _torch_route(rt, {f"c{i}": (5, 90) for i in range(1, 5)}, "c0"))


# ---------------------------------------------------------------------------
# the wrapper's checks, before either version runs


def _ints(n=1024):
    return torch.arange(n, dtype=torch.int32)


@pytest.mark.parametrize("fault", ["nine_inputs", "int64", "non_contiguous", "two_dims",
                                   "length", "num_rows", "bound"])
def test_k7_raises_on_what_the_kernel_does_not_take(fault):
    v = _ints()
    call = {
        "nine_inputs": lambda: k7.filter_sum(v, 1024, bounds=[(_ints(), 0, 9) for _ in range(8)]),
        "int64": lambda: k7.filter_sum(v.long(), 1024),
        "non_contiguous": lambda: k7.filter_sum(_ints(2048)[::2], 1024),
        "two_dims": lambda: k7.filter_sum(v, 1024, product=v.view(32, 32)),
        "length": lambda: k7.filter_sum(v, 1024, nonzero=[_ints(1000)]),
        "num_rows": lambda: k7.filter_sum(v, 1025),
        "bound": lambda: k7.filter_sum(v, 1024, bounds=[(v, 1 << 63, None)]),
    }[fault]
    with pytest.raises((TypeError, ValueError)):
        call()
    assert int(k7.filter_sum(v, 1024, bounds=[(_ints(), 0, 9) for _ in range(7)])) == 36
