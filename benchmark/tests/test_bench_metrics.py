"""The window's arithmetic and the metric readers on made-up runs."""

from types import SimpleNamespace

import pytest

from benchmark.lib import manifest as mf
from benchmark.lib import roofline, stats
from benchmark.lib import traffic as tl


def _ctx(**kw):
    base = dict(cell="c", setup_s=12.5, window_s=10.0, done=[], trace=None,
                stretch_ops=0, facts={})
    base.update(kw)
    return SimpleNamespace(**base)


def read(name, ctx):
    return mf.plugin("metrics", name).read(ctx)


def test_rates_over_the_whole_window():
    done = [({}, {"rows": 1000, "bytes": 15000, "column_bytes": {"l_comment": 6000}})] * 4
    ctx = _ctx(done=done, window_s=2.0)
    assert read("queries_per_s", ctx) == 2.0
    assert read("stored_bytes_per_row", ctx) == 15.0
    assert read("comment_bytes_per_row", ctx) == 6.0
    assert read("setup_s", ctx) == 12.5


def test_readers_with_nothing_to_read_give_nothing():
    ctx = _ctx()
    for name in ("queries_per_s", "stored_bytes_per_row", "k1_roofline",
                 "resident_hbm_share", "device_idle_share", "comment_bytes_per_row"):
        assert read(name, ctx) is None, name


def test_rooflines():
    planes = [(115, 6, 16384), (115, 23, 16384)]
    t = SimpleNamespace(window_s=1.0, busy_s=0.002, idle_share=0.25,
                        kernel_seconds=lambda s: 0.001 if "bitunpack" in s else 0.0)
    ctx = _ctx(trace=t, stretch_ops=4, facts={"k1_planes_per_op": planes})
    k1 = roofline.k1_bytes(planes) * 4
    assert k1 == 4 * 115 * 16384 * (6 + 32 + 23 + 32) * 4
    assert read("k1_roofline", ctx) == pytest.approx(100 * k1 / 3.35e12 / 0.001)
    pb = roofline.plane_bytes(planes) * 4
    assert read("resident_hbm_share", ctx) == pytest.approx(100 * pb / 3.35e12 / 0.002)
    assert read("device_idle_share", ctx) == 25.0
    # resident planes of an SF10 table (widths 6/23/4/4/2/1/12): 391,905,280 bytes
    sf10 = [(115, b, 16384) for b in (6, 23, 4, 4, 2, 1, 12)]
    assert roofline.plane_bytes(sf10) == 391_905_280


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, _m, q3 = __import__("statistics").quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / 10.0)
    assert stats.spread_without_farthest(v + [20.0]) == pytest.approx(stats.spread(v))


def test_traffic_cycles_every_combination_in_a_seeded_order():
    traffic = {"params": {"a": {"range": [1, 3]}, "b": {"values": [10, 20]}}}
    s = tl.stream(traffic, 2**31 + 9)
    first = [next(s) for _ in range(6)]
    assert sorted((p["a"], p["b"]) for p in first) == [(a, b) for a in (1, 2, 3) for b in (10, 20)]
    again = [next(tl.stream(traffic, 2**31 + 9)) for _ in range(1)]
    assert again[0] == first[0]
    other = [next(s) for _ in range(6)]
    assert sorted(map(str, other)) == sorted(map(str, first))


def test_spread_tool(tmp_path, capsys):
    import json

    from benchmark import spread as tool

    def write(name, values):
        p = tmp_path / name
        p.write_text("\n".join(json.dumps({"metrics": {"q": {"value": v, "unit": "x"}}})
                               for v in values))
        return str(p)
    a = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    b = [10.0, 10.4, 9.6, 10.2, 9.8, 10.0]
    assert tool.main([write("a", a), write("b", b)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["spreads"] == [pytest.approx(stats.spread(a)), pytest.approx(stats.spread(b))]
    assert out["five_times_wider"] == pytest.approx(5 * stats.spread(b))
