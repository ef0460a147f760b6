"""The four-card cell's set-up, operation and reference on the CPU: a world
of 2 gloo processes (the run's own and one child) over a tiny table, run
through ``run_cell``'s overrides.  A sound run reads ``correct`` true;
each fault the cell can have, planted in rank 0's process, reads it
false: rank 0's partial groups dropped before the exchange, one
destination bin lost in the exchange, one answer's revenue off by one
hundredth; and so does the int32 control.  Each test has its own time
limit (an alarm after ``LIMIT_S``)."""

import signal

import pytest

from bench_helpers import tiny_run

from benchmark.control import control_numbers

CELL = "dist_sf100_agg_4card"
# 60 slices of 100 orders (some 24,000 rows), 100 suppliers, two ranks
TINY = {"config": {"scale": 0.01, "orders": 6000, "orders_per_slice": 100, "world": 2,
                   "tile": 512}}
LIMIT_S = 180


@pytest.fixture(autouse=True)
def time_limit():
    def stop(*_a):
        raise TimeoutError(f"over its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, stop)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def run(trace=0, seconds=2.0):
    return tiny_run(CELL, trace=trace, seconds=seconds, overrides=TINY)


def test_sound_traced_run_is_correct():
    res = run(trace=1)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"] == {"revenue_gap": {"value": 0, "limit": 0},
                             "suppliers_wrong": {"value": 0, "limit": 0}}
    # 100 suppliers: every slot of the key's span sent, some of them filled
    assert 0 < res["metrics"]["exchange_fill_share"]["value"] <= 100


def test_rank_partials_dropped_before_the_exchange(monkeypatch):
    from strawboat_tpu_torch.parallel import dist_resident

    orig = dist_resident.exchange_dense

    def dropped(devs, payloads_by_shard, n_parts):
        return orig(devs, [[p * 0 for p in pays] for pays in payloads_by_shard], n_parts)
    monkeypatch.setattr(dist_resident, "exchange_dense", dropped)
    res = run()
    assert res["correct"] is False and res["checks"]["revenue_gap"]["value"] > 0


def test_one_destination_bin_lost(monkeypatch):
    from strawboat_tpu_torch.parallel import dist_agg

    orig = dist_agg.all_to_all

    def lost(bins, devices):
        out = orig(bins, devices)
        owned = bins[0].shape[1]
        out[0] = out[0].clone()
        out[0][owned : 2 * owned] = 0  # the range rank 1 sent rank 0
        return out
    monkeypatch.setattr(dist_agg, "all_to_all", lost)
    assert run()["correct"] is False


def test_answer_off_by_one_hundredth(monkeypatch):
    from strawboat_tpu_torch import parallel

    orig, calls = parallel.sharded_keyed_aggregate, []

    def off(*a, **k):
        res = orig(*a, **k)
        calls.append(1)
        if len(calls) == 5:  # one answer of the window
            res["max"]["value"] += 100
        return res
    monkeypatch.setattr(parallel, "sharded_keyed_aggregate", off)
    res = run()
    assert res["correct"] is False and res["checks"]["revenue_gap"]["value"] == 100


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_int32_control_fails(seed):
    numbers, limits = control_numbers(CELL, seed, device_name="cpu", overrides=TINY)
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_reference_answers_as_the_rows():
    """The reference's table answers every DATE as a direct sum over the
    generated rows does; every sum here is far below 2**63."""
    import numpy as np

    from benchmark.reference import lineitem as li
    from benchmark.reference.q15 import COLUMNS, MONTH_OF_DAY, Q15Reference, quarter

    cfg = dict(TINY["config"], orders_per_slice=100)
    ref = Q15Reference(cfg, 77)
    rows = li.generate_lineitem(77, cfg["scale"], 100, range(60), COLUMNS)
    sd, sk = rows.ints["l_shipdate"], rows.ints["l_suppkey"]
    rev = rows.ints["l_extendedprice"] * (100 - rows.ints["l_discount"])
    for month in range(12, 70):
        lo, hi = quarter(month)
        assert MONTH_OF_DAY[lo] == month and MONTH_OF_DAY[hi] == month + 3
        m = (sd >= lo) & (sd < hi)
        by = np.zeros(int(sk.max()) + 1, np.int64)
        np.add.at(by, sk[m], rev[m])
        best = int(by.max())
        assert ref.answer(month) == {"revenue": best,
                                     "suppliers": np.flatnonzero(by == best).tolist()}
