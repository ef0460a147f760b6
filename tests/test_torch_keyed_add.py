"""K9 (``kernels/keyed_add.py``) on the CPU: its plain version against the
dense keyed aggregate's torch route (``_dense_stages`` + ``dist_agg.
dense_partials``), payload for payload and ``where`` for ``where``, and
against numpy; the route's choice between the two; and ``Expr``'s node
descriptions, which the route reads.

Tables are sharded resident tables of two shards of different lengths on a
single-process CPU mesh (``load_sharded_resident``), so the planes end in
padding past each shard's rows and every column takes the encoding its
values give it.  The torch route is forced by patching
``dist_resident._k9_terms``.
"""

import operator
from unittest import mock

import numpy as np
import pytest
import torch

from strawboat_tpu_torch import parallel as par
from strawboat_tpu_torch.exec import col, lit
from strawboat_tpu_torch.exec.expr import product_factors
from strawboat_tpu_torch.kernels import keyed_add as k9
from strawboat_tpu_torch.parallel import dist_resident as dr
from strawboat_tpu_torch.util import obs

TILE = 512
# not multiples of 128, so the planes end in padding; enough rows that a
# column of values in [0, 2^b) has too many distinct values for a
# dictionary to save a bit, so it takes a plain plane as lineitem's do
LENGTHS = (3100, 4700)
PLAIN = ("k", "ep", "ep32", "disc", "sd", "nv")


def _parts(seed=3):
    rng = np.random.default_rng(seed)
    parts = []
    for n in LENGTHS:
        parts.append({
            "k": rng.integers(100, 256, n),  # plain key, 8 bits, lowest 100
            "kd": np.array([7, 10**6, 5 * 10**6, 9 * 10**6])[rng.integers(0, 4, n)],  # coded
            "ks": np.array(["A", "B", "C"])[rng.integers(0, 3, n)],  # a string key
            "ep": rng.integers(0, 1 << 11, n),  # int64: wide
            "ep32": rng.integers(0, 1 << 11, n).astype(np.int32),  # int32: narrow
            "disc": rng.integers(0, 11, n),
            "sd": rng.integers(0, 300, n).astype(np.int32),
            "nv": np.ma.MaskedArray(rng.integers(0, 1 << 10, n), mask=rng.random(n) < 0.2),
            "f": rng.random(n),
            "neg": rng.integers(-500, 500, n),  # an offset: not K9's
        })
    return parts


@pytest.fixture(scope="module")
def srt():
    srt = par.load_sharded_resident(_parts(), par.make_mesh(len(LENGTHS), "cpu"), tile=TILE)
    for name in PLAIN:
        assert all(c.kind == "int" and not c.is_dict and c._narrow_int
                   for c in srt.columns[name].local), name
    assert all(c.is_dict for c in srt.columns["kd"].local)
    assert all(c.offset for c in srt.columns["neg"].local)
    return srt


def _revenue():
    return col("ep") * (100 - col("disc"))


# name → (key, {out: (fn, value)}, predicates, lowest, slots)
CASES = {
    "plain_key_lowest": ("k", {"r": ("sum", _revenue()), "n": ("count", "ep")},
                         {"sd": (100, 190)}, 100, 156),
    "dict_key": ("kd", {"s": ("sum", "ep"), "n": ("count", "ep")}, {"sd": (None, 150)}, 0, 4),
    "string_key_code_bounds": ("ks", {"s": ("sum", col("ep32") + 7)},
                               {"sd": (None, 200), "ks": ("B", None)}, 0, 3),
    "validity_open_high": ("k", {"s": ("sum", "nv"), "n": ("count", "nv")},
                           {"sd": (50, None)}, 0, 256),
    "nothing_selected": ("k", {"r": ("sum", _revenue())}, {"sd": (5000, None)}, 0, 256),
    "wide_and_narrow": ("k", {"a": ("sum", col("ep32") * col("disc")),
                              "b": ("sum", col("ep32") * col("sd")),
                              "c": ("sum", 5 - col("ep32")), "d": ("sum", lit(3) + col("sd"))},
                        {}, 0, 256),
    # ((2^31 - 100) + ep32) passes 2^31 and wraps in int32, then the int32
    # product wraps again; widened after, as torch's route widens it
    "int32_product_wraps": ("k", {"w": ("sum", (((1 << 31) - 100) + col("ep32")) * col("sd"))},
                            {"kd": (10**6, None)}, 0, 256),
}


def _plan(srt, key, values, predicates):
    """What ``sharded_keyed_aggregate`` reads for a call: (names, reads,
    specs, bounds)."""
    pcols = tuple(sorted(predicates))
    reads = tuple(dict.fromkeys((key,) + tuple(r for _fn, v in values.values()
                                               for r in dr._refs(v))))
    names = list(dict.fromkeys(reads + pcols))
    return names, reads, pcols, list(values.values()), dr._bounds(srt, predicates, pcols)


@pytest.mark.parametrize("case", list(CASES))
def test_k9_payloads_equal_the_torch_routes(srt, case):
    """Each local shard's K9 payload and ``where`` equal ``_dense_stages``'
    (``dense_partials``) over the same decoded planes."""
    key, values, predicates, lowest, slots = CASES[case]
    names, reads, pcols, specs, bounds = _plan(srt, key, values, predicates)
    terms = dr._k9_terms(srt, key, names, pcols, bounds, specs)
    assert terms is not None
    torch_dec = dr._decode_shards(srt, names)
    k9_dec = dr._decode_shards(srt, names, validity_words=True)
    kept_any = False
    for s in range(len(LENGTHS)):
        n, m = dr._kept_mask(srt, s, names, bounds, torch_dec[s])
        want, want_where = dr._dense_stages(srt, s, key, lowest, slots, reads, specs,
                                            torch_dec[s][0], n, m)
        on_words = [(k9_dec[s][0][names.index(c)][0], lo, hi) for c, lo, hi in bounds]
        got, where = dr._k9_stages(srt, s, key, lowest, slots, names, terms, on_words, k9_dec[s])
        assert where == want_where
        assert len(got) == len(want) == 1
        assert got[0].dtype == want[0].dtype == torch.int64
        assert torch.equal(got[0], want[0]), case
        kept_any |= bool(got[0][-1].any())
    assert kept_any == (case != "nothing_selected")


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][3] == 0])
def test_keyed_aggregate_through_k9_answers_as_the_torch_route(srt, case):
    key, values, predicates, _lowest, _slots = CASES[case]
    before = [obs.counter("k9.torch_routes")]
    with mock.patch.object(dr, "keyed_add", wraps=k9.keyed_add) as spy:
        got = par.sharded_keyed_aggregate(srt, key, values, predicates)
    assert spy.call_count == len(LENGTHS)  # one a local shard
    assert obs.counter("k9.torch_routes") == before[0]
    with mock.patch.object(dr, "_k9_terms", lambda *a: None):
        want = par.sharded_keyed_aggregate(srt, key, values, predicates)
    assert obs.counter("k9.torch_routes") == before[0] + 1
    assert set(got) == set(want)
    for name in want:
        for g, w in zip(got[name].shards, want[name].shards):
            assert torch.equal(g, w), (case, name)


@pytest.mark.parametrize("value", ["float", "offset", "three_factors",
                                   "dictionary_values", "column_times_literal",
                                   "literal_past_int32"])
def test_other_values_keep_the_torch_route(srt, value):
    """A float or offset column, a dictionary-coded summed column, or a
    value that is no product of K9's factors keeps the torch
    passes and counts ``k9.torch_routes``."""
    v = {"float": "f", "offset": "neg",
         "three_factors": col("ep") * col("disc") * col("sd"), "dictionary_values": "kd",
         "column_times_literal": col("ep") * 3,
         "literal_past_int32": (1 << 40) - col("ep32")}[value]
    before = obs.counter("k9.torch_routes")
    with mock.patch.object(dr, "keyed_add", wraps=k9.keyed_add) as spy:
        got = par.sharded_keyed_aggregate(srt, "k", {"s": ("sum", v), "n": ("count", "sd")},
                                          {"sd": (10, 250)})
    assert spy.call_count == 0
    assert obs.counter("k9.torch_routes") == before + 1
    sorted_route = par.sharded_keyed_aggregate(srt, "k", {"n": ("count", "sd")},
                                               {"sd": (10, 250)}, num_groups=256)
    counts = {int(k): int(c) for ks, vs, cs in zip(got["keys"].shards, got["valid"].shards,
                                                   got["n"].shards)
              for k, c in zip(ks[vs].tolist(), cs[vs].tolist())}
    assert counts == {int(k): int(c) for ks, vs, cs in zip(
        sorted_route["keys"].shards, sorted_route["valid"].shards, sorted_route["n"].shards)
        for k, c in zip(ks[vs].tolist(), cs[vs].tolist())}


def test_a_bound_past_the_column_dtype_keeps_the_torch_route(srt):
    before = obs.counter("k9.torch_routes")
    par.sharded_keyed_aggregate(srt, "k", {"s": ("sum", "ep")}, {"sd": (1 << 40, None)})
    par.sharded_keyed_aggregate(srt, "k", {"s": ("sum", "ep")}, {"sd": (10.5, None)})
    assert obs.counter("k9.torch_routes") == before + 2


@pytest.mark.parametrize("tie", [False, True])
def test_q15_takes_k9_once_a_local_shard(tie):
    import _torch_sharded_world as sw

    parts = sw.make_parts(11, tie=tie, narrow=True)
    srt = par.load_sharded_resident(parts, par.make_mesh(sw.SHARDS, "cpu"), tile=sw.TILE)
    before = obs.counter("k9.torch_routes")
    with mock.patch.object(dr, "keyed_add", wraps=k9.keyed_add) as spy:
        res = par.sharded_keyed_aggregate(srt, "k", {"revenue": ("sum", sw.revenue())},
                                          {"sd": sw.QUARTER}, max_of="revenue")
    assert spy.call_count == sw.SHARDS and obs.counter("k9.torch_routes") == before
    by_key, best, holders = sw.numpy_q15(parts)
    assert res["max"] == {"value": best, "keys": holders}
    assert sw.union(sw.groups(res, "revenue")) == by_key
    assert len(holders) == (2 if tie else 1)


def _groups(res, name):
    """A keyed aggregate's valid groups over every shard: {key: value}."""
    return {int(k): int(a) for ks, vs, xs in zip(res["keys"].shards, res["valid"].shards,
                                                 res[name].shards)
            for k, a in zip(ks[vs].tolist(), xs[vs].tolist())}


@pytest.mark.parametrize("case", ["predicate_and_summed", "key_and_summed"])
def test_a_summed_dictionary_column_sums_its_values(srt, case):
    """A dictionary-coded column's words are codes: summed, it keeps the
    torch route even where it is also a predicate or the key, and the sums
    are of its values, as numpy's and the forced torch route's."""
    key, pred = ("k", {"kd": (10**6, None)}) if case == "predicate_and_summed" else ("kd", {})
    values = {"s": ("sum", "kd"), "n": ("count", "kd")}
    before = obs.counter("k9.torch_routes")
    with mock.patch.object(dr, "keyed_add", wraps=k9.keyed_add) as spy:
        got = par.sharded_keyed_aggregate(srt, key, values, pred)
    assert spy.call_count == 0 and obs.counter("k9.torch_routes") == before + 1
    with mock.patch.object(dr, "_k9_terms", lambda *a: None):
        forced = par.sharded_keyed_aggregate(srt, key, values, pred)
    parts = _parts()
    keys = np.concatenate([p[key] for p in parts])
    kd = np.concatenate([p["kd"] for p in parts])
    m = kd >= 10**6 if pred else np.ones(len(kd), bool)
    want = {int(k): int(kd[m & (keys == k)].sum()) for k in np.unique(keys[m])}
    assert _groups(got, "s") == _groups(forced, "s") == want
    assert _groups(got, "n") == {k: int((m & (keys == k)).sum()) for k in want}
    assert max(want.values()) > 10**6  # values, not codes (0..3)


# --- the plain version against numpy, on words of any value ---------------


def _numpy_keyed_add(key, n, slots, terms, lowest, clamp, bounds, nonzero):
    keep = np.arange(len(key)) < n
    for t, lo, hi in bounds:
        if lo is not None:
            keep &= t.astype(np.int64) >= lo
        if hi is not None:
            keep &= t.astype(np.int64) < hi
    for t in nonzero:
        keep &= t != 0
    rows = np.flatnonzero(keep)
    slot = key[rows].astype(np.int64)
    slot = np.clip(slot, 0, slots - 1) if clamp else slot - lowest
    out = np.zeros((len(terms) + 1, slots), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for i, term in enumerate(terms):
            acc = None
            for column, wide, op, literal in term:
                x = column[rows].astype(np.int64 if wide else np.int32)
                lit_ = (np.int64 if wide else np.int32)(literal)
                x = {"col": x, "sub": lit_ - x, "add": lit_ + x}[op]
                acc = x if acc is None else acc * x
            np.add.at(out[i], slot, acc.astype(np.int64).astype(np.uint64))
    np.add.at(out[-1], slot, np.uint64(1))
    return out.astype(np.int64)


@pytest.mark.parametrize("shape", ["rows_past_n", "clamped_codes", "negative_words_lowest",
                                   "int32_wrap", "no_bounds", "every_input"])
def test_k9_plain_matches_numpy(shape):
    rng = np.random.default_rng(len(shape))
    n_all = 4099
    cols = {c: rng.integers(0, 1 << 20, n_all).astype(np.int32) for c in "abcdefg"}
    key = rng.integers(0, 64, n_all).astype(np.int32)
    n, slots, lowest, clamp = 4001, 64, 0, False
    bounds = [("a", 1 << 18, None)]
    nonzero = []
    terms = [[("b", True, "col", 0), ("c", True, "sub", 100)], [("d", False, "add", -7)]]
    if shape == "rows_past_n":
        key[n:] = 3  # every padding row would land in slot 3
        cols["a"][n:] = 1 << 19
    elif shape == "clamped_codes":
        key = rng.integers(-5, 80, n_all).astype(np.int32)
        clamp = True
    elif shape == "negative_words_lowest":
        key = rng.integers(-40, 24, n_all).astype(np.int32)
        lowest = -40
        cols["b"] = rng.integers(-(1 << 31), 1 << 31, n_all).astype(np.int32)
        bounds = [("a", None, 1 << 19), ("e", -5, 1 << 20)]
    elif shape == "int32_wrap":
        cols["b"] = rng.integers((1 << 30) - 99, 1 << 30, n_all).astype(np.int32)
        terms = [[("b", False, "col", 0), ("c", False, "add", (1 << 31) - 1)]]
    elif shape == "no_bounds":
        bounds = []
    else:  # every input: the key, 2 bounded, 2 validity, 3 more summed
        bounds = [("a", 1 << 10, None), ("e", 3, 1 << 19), ("a", None, (1 << 20) - 3)]
        nonzero = ["g", "h"]
        cols["g"] = (rng.random(n_all) < 0.9).astype(np.int32)
        cols["h"] = (rng.random(n_all) < 0.7).astype(np.int32)
        terms = [[("b", True, "col", 0), ("c", False, "sub", 11)], [("d", False, "col", 0)],
                 [("b", False, "add", 5), ("d", True, "col", 0)], [("c", True, "col", 0)]]
    t = {c: torch.from_numpy(v) for c, v in cols.items()}
    tkey = torch.from_numpy(key)
    got = k9.keyed_add(tkey, n, slots, [[k9.Factor(t[c], w, op, lit_) for c, w, op, lit_ in term]
                                        for term in terms],
                       lowest=lowest, clamp=clamp,
                       bounds=[(t[c], lo, hi) for c, lo, hi in bounds],
                       nonzero=[t[c] for c in nonzero])
    want = _numpy_keyed_add(key, n, slots, [[(cols[c], w, op, lit_) for c, w, op, lit_ in term]
                                            for term in terms],
                            lowest, clamp, [(cols[c], lo, hi) for c, lo, hi in bounds],
                            [cols[c] for c in nonzero])
    assert got.shape == (len(terms) + 1, slots) and got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want), shape
    assert int(got[-1].sum()) > 0


def test_plan_adds_by_the_slots_a_block_holds():
    assert k9.plan_adds(1, 1) == "shared"
    assert k9.plan_adds(k9.K9_SHARED_BYTES // 16, 1) == "shared"
    assert k9.plan_adds(k9.K9_SHARED_BYTES // 16 + 1, 1) == "global"
    assert k9.plan_adds(1 << 20, 1) == "global"  # Q15's supplier slots


@pytest.mark.parametrize("fault", ["int64_key", "short_column", "not_contiguous", "nine_inputs",
                                   "no_terms", "three_factors", "literal_past_int32", "op",
                                   "rows_past_the_column", "bound_past_int64"])
def test_k9_raises_on_what_the_kernel_does_not_take(fault):
    v = torch.arange(1024, dtype=torch.int32)
    f = k9.Factor(v)
    kw = dict(key=v, num_rows=1024, slots=1024, terms=[[f]])
    if fault == "int64_key":
        kw["key"] = v.long()
    elif fault == "short_column":
        kw["terms"] = [[k9.Factor(v[:9])]]
    elif fault == "not_contiguous":
        kw["terms"] = [[k9.Factor(torch.arange(2048, dtype=torch.int32)[::2])]]
    elif fault == "nine_inputs":
        kw["bounds"] = [(v.clone(), 0, None) for _ in range(8)]
    elif fault == "no_terms":
        kw["terms"] = []
    elif fault == "three_factors":
        kw["terms"] = [[f, f, f]]
    elif fault == "literal_past_int32":
        kw["terms"] = [[k9.Factor(v, False, "sub", 1 << 31)]]
    elif fault == "op":
        kw["terms"] = [[k9.Factor(v, False, "mul", 2)]]
    elif fault == "rows_past_the_column":
        kw["num_rows"] = 1025
    else:
        kw["bounds"] = [(v, 1 << 63, None)]
    with pytest.raises((TypeError, ValueError)):
        k9.keyed_add(**kw)


# --- Expr's node descriptions ------------------------------------------------


class _Col:
    def __init__(self, values, validity=None):
        self.values, self.validity, self.dictionary = values, validity, None


def _evaluate(node, table):
    """A node description evaluated by its own operators (torch's)."""
    kind = node[0]
    if kind == "col":
        return table[node[1]].values
    if kind == "lit":
        return node[1]
    ops = {"gt": operator.gt, "ge": operator.ge, "lt": operator.lt, "le": operator.le,
           "eq": operator.eq, "ne": operator.ne, "add": operator.add, "sub": operator.sub,
           "mul": operator.mul, "truediv": operator.truediv,
           "and": lambda a, b: torch.logical_and(torch.as_tensor(a), torch.as_tensor(b)),
           "or": lambda a, b: torch.logical_or(torch.as_tensor(a), torch.as_tensor(b))}
    return ops[kind](_evaluate(node[1], table), _evaluate(node[2], table))


_EXPRS = {
    "gt": lambda: col("a") > 3, "ge": lambda: col("a") >= col("b"), "lt": lambda: col("a") < 7,
    "le": lambda: col("a") <= col("b"), "eq": lambda: col("a") == 4, "ne": lambda: col("a") != 4,
    "add": lambda: col("a") + col("b"), "radd": lambda: 5 + col("a"),
    "sub": lambda: col("a") - 2, "rsub": lambda: 100 - col("b"), "mul": lambda: col("a") * 3,
    "rmul": lambda: 3 * col("b"), "truediv": lambda: col("a") / 4, "rtruediv": lambda: 8 / col("b"),
    "and": lambda: (col("a") > 2) & (col("b") < 9), "or": lambda: (col("a") > 7) | (col("b") < 2),
    "nested": lambda: col("a") * (100 - col("b")) + lit(7) * col("a"),
}


@pytest.mark.parametrize("name", list(_EXPRS))
def test_each_operators_node_evaluates_as_its_closure(name):
    table = {"a": _Col(torch.arange(-4, 12, dtype=torch.int32)),
             "b": _Col(torch.arange(1, 17, dtype=torch.int64))}
    e = _EXPRS[name]()
    got, want = torch.as_tensor(_evaluate(e.node, table)), torch.as_tensor(e.evaluate(table))
    assert got.dtype == want.dtype and torch.equal(got, want), name


@pytest.mark.parametrize("expr,factors", [
    (lambda: col("x"), (("col", 0, "x"),)),
    (lambda: 100 - col("d"), (("sub", 100, "d"),)),
    (lambda: col("d") + 5, (("add", 5, "d"),)),
    (lambda: lit(-3) + col("d"), (("add", -3, "d"),)),
    (lambda: col("p") * (100 - col("d")), (("col", 0, "p"), ("sub", 100, "d"))),
    (lambda: (1 + col("t")) * (100 - col("d")), (("add", 1, "t"), ("sub", 100, "d"))),
    (lambda: col("p") * col("q"), (("col", 0, "p"), ("col", 0, "q"))),
    (lambda: col("p") * col("q") * col("r"), None),
    (lambda: col("p") - 1, None),
    (lambda: col("p") * 3, None),
    (lambda: 1.5 - col("p"), None),
    (lambda: True + col("p"), None),
    (lambda: col("p") / col("q"), None),
    (lambda: col("p") > 3, None),
    (lambda: ~(col("p") > 3), None),
    (lambda: col("s") == "x", None),
])
def test_product_factors_maps_k9s_shapes_alone(expr, factors):
    assert product_factors(expr().node) == factors
