"""K6 (``kernels/group_agg.py``) on the CPU: the plain version and its
de-duplication against the scatter-add route (``segment_reduce``) that the
grouped sums took before K6, ``dense_group_sum``'s two forms, the launch
plan, the checks, and the fused resident Q1 through it, bit for bit.

Exact throughout: every sum and count is an int64 that wraps mod 2^64, and
an average is one float64 division of two such integers on both sides.
The kernel itself against this plain version: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from strawboat_tpu_torch.benchsuite import tpch
from strawboat_tpu_torch.exec import Query, col, make_resident
from strawboat_tpu_torch.exec import query as query_mod
from strawboat_tpu_torch.exec.aggregate import dense_group_count, dense_group_sum, segment_reduce
from strawboat_tpu_torch.kernels import group_agg as ga
from strawboat_tpu_torch.util import obs

ROWS = 3001  # not a multiple of the kernel's 4 rows a step


def _keys(rng, cap: int, n_keys: int):
    """Key columns (int32, then int64) with strides whose composite codes
    cover ``[0, cap)`` and fall outside it on both sides."""
    if n_keys == 1:
        return [(torch.from_numpy(rng.integers(-2, cap + 3, ROWS).astype(np.int32)), 1)]
    inner = 3 if cap % 3 == 0 else 1
    outer = cap // inner
    k0 = rng.integers(-1, outer + 1, ROWS).astype(np.int32)
    k1 = rng.integers(0, inner, ROWS).astype(np.int64)
    return [(torch.from_numpy(k0), inner), (torch.from_numpy(k1), 1)]


def _values(rng, dtype: torch.dtype) -> torch.Tensor:
    """Values whose sums wrap: int64 near ±2^63, int32 over its range."""
    if dtype == torch.int64:
        edge = rng.integers(2**63 - 2**40, 2**63 - 1, ROWS, dtype=np.int64)
        v = np.where(rng.random(ROWS) < 0.5, edge, -edge)
    else:
        v = rng.integers(-(2**31), 2**31 - 1, ROWS).astype(np.int32)
    return torch.from_numpy(v)


def _segment_reference(keys, cap, mask, outputs):
    """Each output through ``segment_reduce``, as the grouped sums ran
    before K6: composite code, routed by the mask and the validity."""
    code = sum(k.long() * s for k, s in keys)
    if mask is not None:
        code = torch.where(mask, code, -1)
    rows = []
    for v, valid in outputs:
        seg = code if valid is None else torch.where(valid, code, -1)
        src = torch.ones(ROWS, dtype=torch.int64) if v is None else v.to(torch.int64)
        rows.append(segment_reduce(src, seg, cap))
    return torch.stack(rows)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_keys", [1, 2])
@pytest.mark.parametrize("cap", [1, 6, 64, 4096])
def test_group_agg_equals_the_scatter_add_route(cap, n_keys, dtype):
    rng = np.random.default_rng(cap * 10 + n_keys)
    keys = _keys(rng, cap, n_keys)
    mask = torch.from_numpy(rng.random(ROWS) < 0.8)
    valid = torch.from_numpy(rng.random(ROWS) < 0.6)
    v, w = _values(rng, dtype), _values(rng, torch.int64)
    # repeated pairs of tensors: computed once, returned in every place
    outputs = [(v, None), (v, valid), (None, None), (None, valid), (w, None), (v, None),
               (None, None)]
    got = ga.group_agg(keys, cap, mask, outputs)
    want = _segment_reference(keys, cap, mask, outputs)
    assert got.shape == (len(outputs), cap) and got.dtype == torch.int64
    assert torch.equal(got, want)
    assert torch.equal(ga.group_agg_plain(keys, cap, mask, outputs), want)
    # no mask: every row whose code lies in [0, cap)
    assert torch.equal(ga.group_agg(keys, cap, None, outputs[:3]),
                       _segment_reference(keys, cap, None, outputs[:3]))


def test_group_agg_sums_wrap_mod_2_64():
    big = torch.full((ROWS,), 2**62, dtype=torch.int64)
    codes = torch.zeros(ROWS, dtype=torch.int32)
    got = ga.group_agg([(codes, 1)], 1, None, [(big, None)])
    want = (ROWS * 2**62) % 2**64
    assert int(got[0, 0]) == (want - 2**64 if want >= 2**63 else want)


def test_group_agg_without_keys_is_one_group():
    rng = np.random.default_rng(3)
    v = _values(rng, torch.int32)
    mask = torch.from_numpy(rng.random(ROWS) < 0.5)
    got = ga.group_agg([], 1, mask, [(v, None), (None, None)])
    assert int(got[0, 0]) == int(v.long()[mask].sum())
    assert int(got[1, 0]) == int(mask.sum())


def test_dense_group_sum_forms_agree_and_route_past_the_kernel_bound():
    rng = np.random.default_rng(5)
    for cap in (7, ga.K6_MAX_GROUPS, ga.K6_MAX_GROUPS + 904):
        codes = torch.from_numpy(rng.integers(-2, cap + 2, ROWS).astype(np.int32))
        vals = torch.from_numpy(rng.integers(-(2**40), 2**40, ROWS))
        small = torch.from_numpy(rng.integers(-100, 100, ROWS).astype(np.int16))
        mask = torch.from_numpy(rng.random(ROWS) < 0.7)
        valid = torch.from_numpy(rng.random(ROWS) < 0.5)
        s, c = dense_group_sum(codes, vals, cap, mask=mask)
        sums, counts = dense_group_sum([(codes, 1)], [(vals, None), (small, valid), (None, None)],
                                       cap, mask=mask)
        want = _segment_reference([(codes, 1)], cap, mask,
                                  [(vals, None), (small, valid), (None, None)])
        ones = _segment_reference([(codes, 1)], cap, mask,
                                  [(None, None), (None, valid), (None, None)])
        assert torch.equal(s, want[0]) and torch.equal(c, ones[0])
        assert torch.equal(sums, want) and torch.equal(counts, ones)
        assert torch.equal(dense_group_count(codes, cap, mask), ones[0])


def test_plan_launches_by_cap_and_outputs():
    assert ga.plan_launches(6, 6) == [(0, 6, 8)]
    assert ga.plan_launches(1, 1) == [(0, 1, 8)]
    assert ga.plan_launches(8, 10) == [(0, 8, 8), (8, 10, 8)]
    assert ga.plan_launches(9, 3) == [(0, 2, 32), (2, 3, 32)]
    assert ga.plan_launches(64, 16) == [(0, 16, 0)]
    assert ga.plan_launches(64, 17) == [(0, 16, 0), (16, 17, 0)]
    # 96 KB of int64 sums a block: 3 outputs of 4096 groups a launch
    assert ga.plan_launches(4096, 7) == [(0, 3, 0), (3, 6, 0), (6, 7, 0)]
    for cap in (0, ga.K6_MAX_GROUPS + 1):
        with pytest.raises(ValueError, match="cap"):
            ga.plan_launches(cap, 1)


def test_group_agg_refuses_what_the_kernel_does_not_take():
    codes = torch.zeros(10, dtype=torch.int32)
    v = torch.arange(10)
    with pytest.raises(ValueError, match="cap"):
        ga.group_agg([(codes, 1)], ga.K6_MAX_GROUPS + 1, None, [(v, None)])
    with pytest.raises(TypeError, match="values 0"):
        ga.group_agg([(codes, 1)], 4, None, [(v.double(), None)])
    with pytest.raises(TypeError, match="mask"):
        ga.group_agg([(codes, 1)], 4, v, [(v, None)])
    with pytest.raises(ValueError, match="shape"):
        ga.group_agg([(codes, 1)], 4, None, [(v[:5], None)])
    with pytest.raises(ValueError, match="contiguous"):
        ga.group_agg([(codes, 1)], 4, None, [(torch.arange(20)[::2], None)])
    with pytest.raises(ValueError, match="key columns"):
        ga.group_agg([(codes, 1)] * (ga.K6_MAX_KEYS + 1), 4, None, [(v, None)])
    with pytest.raises(ValueError, match="no outputs"):
        ga.group_agg([(codes, 1)], 4, None, [])


@pytest.fixture(scope="module")
def lineitem():
    cols = {k: v for k, v in tpch.generate_lineitem(1.0, rows=40_000).items()
            if k in tpch.Q1_Q6_COLUMNS}
    return cols, make_resident(cols, "cpu", tile=512)


def test_fused_q1_is_one_dense_group_sum_and_unchanged_bit_for_bit(lineitem, monkeypatch):
    """The fused Q1's every integer sum, average and count come from one
    ``dense_group_sum`` call, no aggregate takes the torch route, and the
    answer is what the scatter-add route gave: exact sums, each average
    ``float64(sum) / float64(count)``."""
    cols, rt = lineitem
    calls = []
    orig = query_mod.dense_group_sum

    def counting(*a, **k):
        calls.append(a[2])
        return orig(*a, **k)

    monkeypatch.setattr(query_mod, "dense_group_sum", counting)
    before = obs.counter("k6.torch_aggs")
    res = tpch.q1(rt)
    assert calls == [6] and obs.counter("k6.torch_aggs") == before

    _rf_vals, rf = tpch.dictionary_codes(cols["l_returnflag"])
    ls_vals, ls = tpch.dictionary_codes(cols["l_linestatus"])
    m = cols["l_shipdate"] <= tpch.EPOCH_DAYS - tpch.Q1_DEFAULT_DELTA
    group = (rf * len(ls_vals) + ls)[m]
    live = np.unique(group)
    qty, ep = cols["l_quantity"][m], cols["l_extendedprice"][m]
    disc, tax = cols["l_discount"][m], cols["l_tax"][m]
    dp = ep * (100 - disc)
    sums = {n: np.array([x[group == g].sum(dtype=np.int64) for g in live])
            for n, x in {"qty": qty, "ep": ep, "dp": dp, "ch": dp * (100 + tax),
                         "disc": disc}.items()}
    cnt = np.array([(group == g).sum() for g in live], dtype=np.int64)
    want = {"sum_qty": sums["qty"], "sum_base_price": sums["ep"],
            "sum_disc_price": sums["dp"], "sum_charge": sums["ch"],
            "avg_qty": sums["qty"].astype(np.float64) / cnt.astype(np.float64),
            "avg_price": sums["ep"].astype(np.float64) / cnt.astype(np.float64),
            "avg_disc": sums["disc"].astype(np.float64) / cnt.astype(np.float64),
            "count_order": cnt}
    assert int(res["n_groups"]) == len(live)
    assert list(res["key_l_returnflag"]) == list(live // len(ls_vals))  # string keys: codes
    assert list(res["key_l_linestatus"]) == list(live % len(ls_vals))
    for name, w in want.items():
        assert res[name].dtype == w.dtype, name
        np.testing.assert_array_equal(res[name], w, err_msg=name)


def test_fused_query_with_nulls_floats_min_and_max():
    """Integer sums and averages over a nullable column count the rows its
    validity keeps; a float sum, a min and a max take the torch route and
    count in ``k6.torch_aggs``."""
    rng = np.random.default_rng(8)
    n = 5000
    g = rng.integers(0, 5, n) * 111
    v = rng.integers(-(2**40), 2**40, n)
    f = np.round(rng.normal(0, 100, n), 3)
    nulls = rng.random(n) < 0.2
    rt = make_resident({"g": g, "v": v, "f": f, "nv": np.ma.masked_array(v, nulls)}, "cpu",
                       tile=512)
    before = obs.counter("k6.torch_aggs")
    res = (Query(rt).filter(col("v") < 2**39).group_by("g", num_groups=16)
           .agg(s=("sum", "v"), a=("avg", "nv"), sn=("sum", "nv"), fs=("sum", "f"),
                mn=("min", "v"), mx=("max", "nv"), c=("count", "v"))
           .run())
    assert obs.counter("k6.torch_aggs") == before + 3
    keys = np.unique(g)
    m = v < 2**39
    assert list(res["key_g"]) == list(keys)
    for i, k in enumerate(keys):
        r = m & (g == k)
        rn = r & ~nulls
        assert res["s"][i] == v[r].sum() and res["sn"][i] == v[rn].sum()
        assert res["a"][i] == np.float64(v[rn].sum()) / np.float64(rn.sum())
        assert res["c"][i] == r.sum() and res["mn"][i] == v[r].min()
        assert res["mx"][i] == v[rn].max()
        np.testing.assert_allclose(res["fs"][i], f[r].sum(), rtol=1e-12)
