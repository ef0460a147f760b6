"""The per-process loader (``load_sharded_resident``) and the keyed
aggregate (``sharded_keyed_aggregate``) over sharded resident tables.

On the CPU: a single-process mesh of 4 shards and a world of 2 gloo
processes (``tests/_torch_world.py``, two shards a process) over the same
rows of ``tests/_torch_sharded_world.py``.  The loader's table answers as
``shard_resident`` of the whole table does (Q6's shape with code-space
bounds, sums by a string key, the keyed aggregates), the keyed aggregate's
Q15 answer is numpy's (a tie included), and a capacity below the groups
raises ``CapacityError`` on every process.  Each test has its own time
limit: a world is killed after ``WORLD_S`` seconds, a test in this process
is stopped by an alarm after ``LIMIT_S``.
"""

import signal

import numpy as np
import pytest
import torch

import _torch_sharded_world as sw
from _torch_world import run_world
from strawboat_tpu_torch import parallel as par
from strawboat_tpu_torch.errors import CapacityError
from strawboat_tpu_torch.exec import make_resident

LIMIT_S = 120
WORLD_S = 150.0


@pytest.fixture(autouse=True)
def time_limit():
    def stop(*_a):
        raise TimeoutError(f"over its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, stop)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _single(parts, **kw):
    mesh = par.make_mesh(sw.SHARDS, "cpu")
    return par.load_sharded_resident(parts, mesh, tile=sw.TILE, **kw)


def _whole_table(parts):
    rt = make_resident(sw.whole(parts), "cpu", tile=sw.TILE)
    return par.shard_resident(rt, par.make_mesh(sw.SHARDS, "cpu"), "shards")


def _same(a, b):
    """Two query results of :func:`sw.queries` alike: tensors equal, the
    groups of the keyed aggregates the same dicts."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a.cpu(), b.cpu())
    elif hasattr(a, "value") or (isinstance(a, list) and a and isinstance(a[0], dict)):
        assert sw.union(a) == sw.union(b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.fixture(scope="module")
def parts():
    return sw.make_parts(7)


def test_loader_answers_as_shard_resident_of_the_whole_table(parts):
    srt = _single(parts)
    assert srt.shard_rows == sw.LENGTHS and srt.num_rows == sum(sw.LENGTHS)
    # one agreed sorted dictionary a coded column, on every shard
    for name, want in (("flag", ["A", "N", "R"]), ("dk", [7, 10**6, 5 * 10**6])):
        for c in srt.columns[name].local:
            assert list(c.dictionary_host) == want
    # the column some shards coded and others did not is plain everywhere
    assert not any(c.is_dict for c in srt.columns["mixed"].local)
    _same(sw.queries(srt), sw.queries(_whole_table(parts)))


@pytest.mark.parametrize("tie", [False, True])
def test_keyed_aggregate_q15_answer_as_numpy(tie):
    parts = sw.make_parts(11, tie=tie)
    by_key, best, holders = sw.numpy_q15(parts)
    srt = _single(parts)
    res = par.sharded_keyed_aggregate(srt, "k", {"revenue": ("sum", sw.revenue())},
                                      {"sd": sw.QUARTER}, max_of="revenue")
    assert res["max"] == {"value": best, "keys": holders}
    assert len(holders) == (2 if tie else 1)
    assert sw.union(sw.groups(res, "revenue")) == by_key
    # dense slots over the key's span (keys 1..300: 9 bits from 0), shard
    # g owning the g-th quarter of it, each slot its key
    assert srt.spans["k"] == (0, 512)
    for g, k in enumerate(res["keys"].shards):
        assert torch.equal(k, torch.arange(128 * g, 128 * (g + 1)))


@pytest.mark.parametrize("tie", [False, True])
def test_keyed_aggregate_sorted_path_answers_as_the_dense(tie):
    parts = sw.make_parts(11, tie=tie)
    by_key, best, holders = sw.numpy_q15(parts)
    res = par.sharded_keyed_aggregate(_single(parts), "k", {"revenue": ("sum", sw.revenue())},
                                      {"sd": sw.QUARTER}, num_groups=512, max_of="revenue")
    assert res["max"] == {"value": best, "keys": holders}
    assert sw.union(sw.groups(res, "revenue")) == by_key
    # every key on the shard its hash names, in slots of the given capacity
    assert all(len(k) == 512 for k in res["keys"].shards)
    for g, (k, v) in enumerate(zip(res["keys"].shards, res["valid"].shards)):
        assert bool((par.hash_partition_ids(k[v], sw.SHARDS) == g).all())


def test_dense_dictionary_key_sums_and_counts_as_numpy(parts):
    """A dictionary-coded key takes the dense stages over its codes: the
    sums and counts equal numpy's and the sorted stages'."""
    t = sw.whole(parts)
    srt = _single(parts)
    assert srt.spans["dk"] == (0, 3)
    spec = {"s": ("sum", "ep"), "n": ("count", "ep")}
    dense = par.sharded_keyed_aggregate(srt, "dk", spec, max_of="s")
    want = {int(k): int(t["ep"][t["dk"] == k].sum()) for k in np.unique(t["dk"])}
    assert sw.union(sw.groups(dense, "s")) == want
    assert sw.union(sw.groups(dense, "n")) == {k: int((t["dk"] == k).sum()) for k in want}
    top = max(want.values())
    assert dense["max"] == {"value": top, "keys": [k for k, v in want.items() if v == top]}
    for name in spec:
        _same(sw.groups(dense, name), sw.groups(
            par.sharded_keyed_aggregate(srt, "dk", spec, num_groups=4), name))


def test_more_ties_than_the_fixed_gather_gathers_them_whole(monkeypatch):
    from strawboat_tpu_torch.parallel import dist_resident

    parts = sw.make_parts(11, tie=True)
    _, best, holders = sw.numpy_q15(parts)
    monkeypatch.setattr(dist_resident, "TOP_KEYS", 1)
    res = par.sharded_keyed_aggregate(_single(parts), "k", {"revenue": ("sum", sw.revenue())},
                                      {"sd": sw.QUARTER}, max_of="revenue")
    assert res["max"] == {"value": best, "keys": holders} and len(holders) == 2


def test_keyed_aggregate_with_nothing_selected(parts):
    res = par.sharded_keyed_aggregate(_single(parts), "k", {"revenue": ("sum", sw.revenue())},
                                      {"sd": (5000, None)}, max_of="revenue")
    assert res["max"] == {"value": None, "keys": []}
    assert not any(bool(v.any()) for v in res["valid"].shards)


def test_capacity_below_the_groups_raises(parts):
    with pytest.raises(CapacityError) as e:
        par.sharded_keyed_aggregate(_single(parts), "k", {"r": ("sum", "ep")}, num_groups=64)
    assert e.value.capacity == 64 and e.value.required > 64


def test_loader_takes_one_part_a_local_shard(parts):
    with pytest.raises(ValueError, match="local shards"):
        _single(parts[:3])


@pytest.fixture(scope="module")
def world2(parts, tmp_path_factory):
    """A world of 2 gloo processes running the cases once."""
    names = ["_torch_sharded_world:case_loader", "_torch_sharded_world:case_capacity"]
    return run_world(2, {"parts": parts, "narrow": sw.make_parts(7, tie=True, narrow=True)},
                     names, str(tmp_path_factory.mktemp("sharded2")), limit_s=WORLD_S)


def test_world_of_two_answers_as_one_process(world2, parts):
    got = world2["_torch_sharded_world:case_loader"]
    assert got["shard_rows"] == sw.LENGTHS
    single = _single(parts)
    assert got["spans"] == single.spans
    _same({k: got[k] for k in ("filter_sum", "group_sum", "q15", "nullable")},
          sw.queries(single))
    _, best, holders = sw.numpy_q15(parts)
    assert got["q15"]["max"] == {"value": best, "keys": holders}
    # a dictionary-coded money column keeps torch's passes on every rank;
    # narrow plain planes take K9 (its plain version on the CPU: no launch)
    assert got["q15_k9"] == [(0, 1), (0, 1)]
    narrow = sw.make_parts(7, tie=True, narrow=True)
    by_key, best, holders = sw.numpy_q15(narrow)
    assert got["narrow_q15"]["max"] == {"value": best, "keys": holders} and len(holders) == 2
    assert sw.union(got["narrow_q15"]["groups"]) == by_key
    assert got["narrow_q15"]["k9"] == [(0, 0), (0, 0)]


def test_world_of_two_raises_capacity_on_every_process(world2):
    got = world2["_torch_sharded_world:case_capacity"]
    assert got["capacity"] == 64 and got["required"] > 64
