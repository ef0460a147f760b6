"""The plain reference: its generator follows TPC-H's rules (clause
4.2.3), its Q1 and Q6 answers equal a direct NumPy computation, and its
int32 control differs."""

import numpy as np
import pytest

from benchmark.reference import compare, text
from benchmark.reference import lineitem as L
from benchmark.reference.tpch import Q1_CUT, Q1Reference, Q6Reference, exact_bincount, year_start

SEEDS = [0, 1, 7, 2**31 + 5, 2**33 + 123]
POOL = L.text_pool(1 << 20)


def _table(seed, orders=4000, slices=(0, 3)):
    return L.generate_lineitem(seed, 10.0, orders, slices,
                               [c for c in L.COLUMNS if c != "l_comment"])


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_follows_clause_4_2_3(seed):
    s = L.generate_slice(seed, 10.0, 5, 3000, L.COLUMNS, POOL)
    c = s.ints
    assert s.names == list(L.COLUMNS)
    # orders: 1 to 7 lines, numbered from 1, sparse keys in order
    key, line = c["l_orderkey"], c["l_linenumber"]
    first = np.flatnonzero(np.diff(key, prepend=-1) != 0)
    lines = np.diff(np.append(first, len(key)))
    assert lines.min() >= 1 and lines.max() <= 7 and len(first) == 3000
    assert np.array_equal(line, np.arange(len(key)) - np.repeat(first, lines) + 1)
    assert np.array_equal(key[first], L.order_keys(5 * 3000, 3000))
    assert np.all((key[first] & 31) < 8) and np.all(np.diff(key[first]) > 0)
    # parts, suppliers and prices
    p, sup, q = c["l_partkey"], c["l_suppkey"], c["l_quantity"]
    assert p.min() >= 1 and p.max() <= 2_000_000 and sup.min() >= 1 and sup.max() <= 100_000
    cands = [(p + i * (100_000 // 4 + (p - 1) // 100_000)) % 100_000 + 1 for i in range(4)]
    assert np.all(np.any([sup == x for x in cands], axis=0))
    assert q.min() >= 1 and q.max() <= 50
    assert np.array_equal(c["l_extendedprice"], q * (90000 + (p // 10) % 20001 + 100 * (p % 1000)))
    assert c["l_discount"].min() >= 0 and c["l_discount"].max() <= 10
    assert c["l_tax"].min() >= 0 and c["l_tax"].max() <= 8
    # dates: from one order date an order, receipt after ship
    ship, commit, receipt = c["l_shipdate"], c["l_commitdate"], c["l_receiptdate"]
    d = receipt - ship
    assert d.min() >= 1 and d.max() <= 30
    od_lo = np.maximum.reduceat(np.maximum(ship - 121, commit - 90), first)
    od_hi = np.minimum.reduceat(np.minimum(ship - 1, commit - 30), first)
    assert np.all(np.maximum(od_lo, 0) <= np.minimum(od_hi, L.ORDERDATE_LAST))
    # flags from CURRENTDATE
    flag, status = s.column("l_returnflag"), s.column("l_linestatus")
    assert np.array_equal(flag == "N", receipt > L.CURRENTDATE)
    assert set(flag[receipt <= L.CURRENTDATE]) == {"A", "R"}
    assert np.array_equal(status == "O", ship > L.CURRENTDATE)
    assert set(s.column("l_shipinstruct")) <= set(L.SHIPINSTRUCTS)
    assert set(s.column("l_shipmode")) == set(L.SHIPMODES)
    off, vals = s.strings("l_comment")
    lens = np.diff(off)
    assert off[0] == 0 and lens.min() >= 10 and lens.max() <= 43 and len(vals) == off[-1]


def test_slices_and_columns_are_drawn_apart():
    whole = L.generate_slice(3, 10.0, 2, 2000, L.COLUMNS, POOL)
    part = L.generate_slice(3, 10.0, 2, 2000, ("l_quantity", "l_shipdate", "l_returnflag"))
    assert part.names == ["l_quantity", "l_returnflag", "l_shipdate"]
    for n in part.names:
        assert np.array_equal(part.column(n), whole.column(n))
    both = _table(3, 2000, (1, 2))
    one = L.generate_slice(3, 10.0, 1, 2000, both.names)
    assert both.rows == one.rows + whole.rows
    for n in both.names:
        assert np.array_equal(both.column(n), np.concatenate([one.column(n), whole.column(n)]))


def test_strings_of_coded_columns():
    s = L.generate_slice(9, 10.0, 0, 500, ("l_shipinstruct",))
    off, vals = s.strings("l_shipinstruct")
    got = [bytes(vals[off[i]:off[i + 1]]).decode() for i in range(s.rows)]
    assert got == list(s.column("l_shipinstruct"))


def test_text_pool_follows_the_grammar():
    words = {w for cls in (text.NOUNS, text.VERBS, text.ADJECTIVES, text.ADVERBS,
                           text.PREPOSITIONS, text.AUXILIARIES) for e, _n in cls for w in e.split()}
    pool = bytes(text.text_pool([4], 200_000)).decode()
    assert len(pool) == 200_000 and pool.startswith(" ")
    sentences = [x for x in pool.replace("--", ".").replace(";", ".").replace(":", ".")
                 .replace("?", ".").replace("!", ".").split(".")[:-1]]
    assert len(sentences) > 1000
    for sent in sentences:
        toks = sent.replace(",", "").split()
        assert 2 <= len(toks) and set(toks) <= words | {"the"}, sent
    assert np.array_equal(text.text_pool([4], 5000), text.text_pool([4], 5000))


def _q1_direct(li, delta):
    cols = li.columns()
    m = cols["l_shipdate"] <= Q1_CUT - delta
    out = {}
    for f in "ANR":
        for s in "FO":
            g = m & (cols["l_returnflag"] == f) & (cols["l_linestatus"] == s)
            n = int(g.sum())
            if not n:
                continue
            q, e = cols["l_quantity"][g], cols["l_extendedprice"][g]
            d, t = cols["l_discount"][g], cols["l_tax"][g]
            dp = e * (100 - d)
            out[(f, s)] = {"sum_qty": int(q.sum()), "sum_base_price": int(e.sum()),
                           "sum_disc_price": int(dp.sum()), "sum_charge": int((dp * (100 + t)).sum()),
                           "avg_qty": int(q.sum()) / n, "avg_price": int(e.sum()) / n,
                           "avg_disc": int(d.sum()) / n, "count_order": n}
    return out


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_q1_reference_equals_direct(seed):
    li = _table(seed)
    ref = Q1Reference(li)
    for delta in (60, 90, 120, 2526, 3000):
        want = _q1_direct(li, delta)
        got = ref.answer(delta)
        assert compare.q1_gaps([(got, want)]) == {"groups_wrong": 0, "int_gap": 0, "avg_rel_gap": 0.0}


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_q6_reference_equals_direct(seed):
    li = _table(seed)
    ref = Q6Reference(li)
    c = li.ints
    for year in range(1992, 1999):
        for d in (0, 2, 9, 10):
            for q in (24, 25, 51):
                m = ((c["l_shipdate"] >= year_start(year)) & (c["l_shipdate"] < year_start(year + 1))
                     & (c["l_discount"] >= d - 1) & (c["l_discount"] <= d + 1) & (c["l_quantity"] < q))
                want = int((c["l_extendedprice"][m] * c["l_discount"][m]).sum())
                assert ref.answer(year, d, q) == want


def test_q1_has_tpch_s_four_groups():
    li = _table(11, 20_000)
    assert sorted(Q1Reference(li).answer(90)) == [("A", "F"), ("N", "F"), ("N", "O"), ("R", "F")]


def test_year_start():
    assert [year_start(y) for y in (1992, 1993, 1994, 1995, 1997, 1998)] == [0, 366, 731, 1096, 1827, 2192]


def test_exact_bincount_is_exact_above_float_precision():
    v = np.array([2**52 + 1, 2**52 + 3, 5, 2**40 + 7], dtype=np.int64)
    b = np.array([0, 0, 1, 1])
    assert exact_bincount(b, v, 2).tolist() == [2**53 + 4, 2**40 + 12]


def test_int32_control_differs():
    li = _table(4, 25_000)
    q1, q1c = Q1Reference(li), Q1Reference(li, dtype="int32")
    gaps = compare.q1_gaps([(q1c.answer(90), q1.answer(90))])
    assert gaps["int_gap"] > 0
    q6, q6c = Q6Reference(li), Q6Reference(li, dtype="int32")
    assert compare.scalar_gap([(q6c.answer(1994, 6, 24), q6.answer(1994, 6, 24))]) > 0


def test_column_mismatches():
    a = np.arange(10)
    assert compare.column_mismatches(a, a) == 0
    b = a.copy()
    b[3] = -1
    assert compare.column_mismatches(b, a) == 1
    assert compare.column_mismatches(a[:7], a) == 3
