"""Worlds of processes over the port's multi-process mesh, for the tests.

``run_world(size, inputs, cases, workdir)`` spawns ``size`` processes
(``torch.multiprocessing.start_processes``, the spawn method), each of
which joins a gloo world through a ``file://`` store, builds an 8-shard
mesh (its ``8 / size`` shards, on the CPU or a card) and runs every named case of
:data:`CASES` on it.  Each rank keeps its results on the host, its local
shards as :class:`Shards`; :func:`merge` puts the ranks' shards together
in global shard order, so a world's result compares with the
single-process mesh's (``run_case`` with no world) shard for shard.

``make_inputs`` makes every case's inputs from fixed seeds, with files
written by the writer it is given.  This module imports only torch,
numpy and the port (and pyarrow inside ``make_inputs``): the spawned
ranks import it, and they must not import JAX.  A world that outlives its time
limit is killed and raises ``TimeoutError``; a rank that raises fails the
world.
"""

from __future__ import annotations

import importlib
import os
import pickle
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

N = 8  # shards of every mesh: the JAX package's 8-device CPU mesh
WORLD_LIMIT_S = 150.0  # a world's hard time limit
COLLECTIVE_TIMEOUT_S = 60.0  # gloo's limit on one collective


@dataclass
class Shards:
    """A ``ShardedTensor``'s shards, on the host."""

    shards: List[torch.Tensor]


@dataclass
class PerRank:
    """A value each rank holds for itself (merged into a list by rank)."""

    value: Any


Q6_PREDS = {"sd": (731, 1096), "disc": (5, 8), "qty": (None, 24)}


def to_host(x):
    """A case's result with every tensor on the host and every
    ``ShardedTensor`` / ``DeviceTable`` as plain containers."""
    from strawboat_tpu_torch.exec.scan import DeviceTable
    from strawboat_tpu_torch.parallel import ShardedTensor

    if isinstance(x, ShardedTensor):
        return Shards([s.cpu() for s in x.shards])
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, DeviceTable):
        return {"num_rows": x.num_rows, "columns": {
            name: {"values": to_host(c.values), "validity": to_host(c.validity),
                   "dictionary": None if c.dictionary is None else [bytes(v) for v in c.dictionary]}
            for name, c in x.columns.items()}}
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    return x


def merge(per_rank: Sequence):
    """The ranks' host results as one: shards concatenated in rank order,
    :class:`PerRank` values listed by rank, and every other value equal on
    every rank (checked) taken once."""
    first = per_rank[0]
    if isinstance(first, Shards):
        return Shards([s for r in per_rank for s in r.shards])
    if isinstance(first, PerRank):
        return [r.value for r in per_rank]
    if isinstance(first, dict):
        assert all(set(r) == set(first) for r in per_rank)
        return {k: merge([r[k] for r in per_rank]) for k in first}
    if isinstance(first, (tuple, list)):
        assert all(len(r) == len(first) for r in per_rank)
        return type(first)(merge([r[i] for r in per_rank]) for i in range(len(first)))
    for r in per_rank[1:]:
        same = torch.equal(r, first) if isinstance(first, torch.Tensor) else r == first
        assert same, f"ranks disagree: {first!r} against {r!r}"
    return first


def _hashing_to_zero(candidates: np.ndarray, count: int) -> np.ndarray:
    """The first ``count`` candidate keys whose destination among N shards
    is shard 0."""
    from strawboat_tpu_torch.parallel.shuffle import hash_partition_ids

    dest = hash_partition_ids(torch.from_numpy(candidates), N).numpy()
    return candidates[dest == 0][:count]


def make_inputs(d, write) -> Dict:
    """Every case's inputs from fixed seeds: numpy arrays, and files that
    ``write(path, pa.Table, page rows, **WriteOptions fields)`` writes
    into the directory ``d`` (a ``pathlib.Path``)."""
    import pyarrow as pa

    rng = np.random.default_rng(0)
    inp = {"bins": rng.integers(-(10**9), 10**9, (N * N, 5)).astype(np.int64)}
    inp["shuffle_key"] = rng.integers(0, 50, N * 512).astype(np.int64)
    inp["shuffle_val"] = rng.integers(0, 1000, N * 512).astype(np.int64)
    inp["agg_key"] = rng.integers(-5, 60, N * 300).astype(np.int64)
    inp["agg_val"] = rng.integers(-(10**9), 10**9, N * 300).astype(np.int64)
    inp["agg_mask"] = rng.random(N * 300) < 0.7
    # shard 0's rows: 200 groups, all owned by shard 0; the others: 5 groups
    hot = _hashing_to_zero(np.arange(10**6, 10**6 + 5000, dtype=np.int64), 200)
    assert len(hot) == 200
    skew = rng.integers(0, 5, N * 1024).astype(np.int64)
    skew[:1024] = hot[rng.integers(0, 200, 1024)]
    skew[:200] = hot
    inp["skew_key"], inp["skew_val"] = skew, rng.integers(0, 10**5, N * 1024).astype(np.int64)
    inp["chunks"] = [(rng.integers(0, 25, N * 512).astype(np.int64),
                      rng.integers(0, 10**5, N * 512).astype(np.int64)) for _ in range(3)]
    inp["big_chunks"] = [(rng.integers(0, 500, N * 256).astype(np.int64),
                          rng.integers(0, 100, N * 256).astype(np.int64)) for _ in range(2)]
    inp["join_pk"] = rng.integers(0, 200, N * 512).astype(np.int64)
    inp["join_pv"] = rng.integers(0, 1000, N * 512).astype(np.int64)
    inp["join_bk"] = rng.permutation(512)[: N * 64].astype(np.int64)
    inp["join_bw"] = rng.integers(1, 10, N * 64).astype(np.int64)
    inp["dup_pk"] = rng.integers(0, 40, N * 128).astype(np.int64)
    inp["dup_pv"] = rng.integers(0, 1000, N * 128).astype(np.int64)
    inp["dup_bk"] = rng.integers(0, 40, N * 32).astype(np.int64)
    inp["dup_bw"] = rng.integers(1, 10, N * 32).astype(np.int64)

    n = N * 600
    cats = np.array(["alpha", "beta", "gamma", "delta"])
    inp["scan_path"] = write(d / "scan.str", pa.table({
        "s": pa.array(cats[rng.integers(0, 4, n)].tolist(), pa.string()),
        "b": pa.array(rng.integers(0, 2, n).astype(bool)),
        "v": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
        "nv": pa.array(rng.integers(0, 50, n).astype(np.int64), mask=rng.random(n) < 0.1)}), 256)
    n = N * 800
    inp["q1_path"] = write(d / "q1.str", pa.table({
        "rf": np.array(["A", "N", "R"])[rng.integers(0, 3, n)].tolist(),
        "ls": np.array(["F", "O"])[rng.integers(0, 2, n)].tolist(),
        "qty": rng.integers(1, 51, n).astype(np.int64),
        "price": rng.integers(100, 10**5, n).astype(np.int64),
        "disc": rng.integers(0, 11, n).astype(np.int64)}), 400)
    inp["dataset_paths"] = [
        write(d / f"part-{i}.str", pa.table({
            "k": rng.integers(0, 5, m).astype(np.int64), "v": rng.integers(0, 1000, m),
            "s": np.array([f"f{i}", "shared"])[rng.integers(0, 2, m)].tolist()}), 32)
        for i, m in enumerate([96, 224, 64])]  # uneven: the greedy balance decides
    inp["stream_paths"] = [
        write(d / f"stream-{i}.str", pa.table({
            "g": rng.integers(0, 7, m).astype(np.int64), "v": rng.integers(0, 1000, m),
            "d": np.full(m, i * 100, dtype=np.int64)}), 64, zone_maps=True)
        for i, m in enumerate([300, 340, 380])]
    cols = {nm: rng.integers(0, hi, 4096).astype(np.int32)
            for nm, hi in (("sd", 2557), ("qty", 51), ("disc", 11), ("ep", 60000), ("grp", 6))}
    inp["resident_path"] = write(d / "res.str", pa.table(cols, schema=pa.schema(
        [pa.field(nm, pa.int32(), nullable=False) for nm in cols])), 512,
        default_compress_ratio=1.0)
    n = 6000
    inp["nullable_path"] = write(d / "nullable.str", pa.table({
        "k": rng.integers(0, 5000, n).astype(np.int64),
        "v": pa.array(rng.integers(0, 1000, n).astype(np.int64), mask=rng.random(n) < 0.2),
        "w": np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)].tolist()}), 512)
    inp["q6_preds"] = Q6_PREDS
    return inp


def assert_same(got, single) -> None:
    """A world's merged result against the single-process mesh's: the same
    structure, every shard alike; integers exactly, floats to rtol 1e-12
    (a world's psum adds in another order).  A ``PerRank`` value differs
    with the world by design: the tests check those."""
    if isinstance(single, PerRank):
        return
    if isinstance(single, Shards):
        assert isinstance(got, Shards) and len(got.shards) == len(single.shards) == N
        for g, s in zip(got.shards, single.shards):
            assert_same(g, s)
    elif isinstance(single, torch.Tensor):
        assert got.dtype == single.dtype and got.shape == single.shape
        if single.is_floating_point():
            np.testing.assert_allclose(got.cpu().numpy(), single.cpu().numpy(), rtol=1e-12)
        else:
            assert torch.equal(got.cpu(), single.cpu())
    elif isinstance(single, dict):
        assert set(got) == set(single)
        for k in single:
            assert_same(got[k], single[k])
    elif isinstance(single, (tuple, list)):
        assert len(got) == len(single)
        for g, s in zip(got, single):
            assert_same(g, s)
    else:
        assert got == single


# ---------------------------------------------------------------------------
# cases: each runs one function of the port on ``mesh`` over ``inp`` (numpy
# arrays and file paths made by the test from seeds)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def case_collectives(mesh, inp):
    from strawboat_tpu_torch import parallel as par

    devs = mesh.axis_devices("shards")
    shards = list(par.shard(mesh, "shards", _t(inp["bins"])).shards)
    flags = list(par.shard(mesh, "shards", _t(inp["bins"] % 3 == 0)).shards)
    return {"a2a": Shards(par.all_to_all(shards, devs)),
            "a2a_bool": Shards(par.all_to_all(flags, devs)),
            "psum": Shards(par.psum(shards, devs)),
            "psum_f64": Shards(par.psum([s.double() / 7 for s in shards], devs))}


def case_shuffle(mesh, inp):
    from strawboat_tpu_torch import parallel as par

    return par.shuffle_by_key(mesh, "shards", _t(inp["shuffle_key"]), (_t(inp["shuffle_val"]),),
                              capacity=512)


def case_shuffle_salted(mesh, inp):
    from strawboat_tpu_torch import parallel as par

    hot = np.zeros(N * 64, dtype=np.int64)
    return par.shuffle_by_key(mesh, "shards", _t(hot), (_t(np.arange(N * 64)),), capacity=64,
                              salt=N)


def case_aggregate(mesh, inp):
    from strawboat_tpu_torch import parallel as par

    key, val = _t(inp["agg_key"]), _t(inp["agg_val"])
    return {
        "sum_max": par.distributed_aggregate(
            mesh, "shards", key, {"total": ("sum", val), "mx": ("max", val)}, num_groups=256),
        "masked": par.distributed_aggregate(
            mesh, "shards", key, {"lo": ("min", val), "c": ("count", val), "s": ("sum", val)},
            mask=_t(inp["agg_mask"]), num_groups=128)}


def case_aggregate_one_rank_grows(mesh, inp):
    """Only the first shard's rows hold many groups, and they all hash to
    shard 0: only rank 0's shards overflow, and every rank grows."""
    from strawboat_tpu_torch import parallel as par

    return par.distributed_aggregate(mesh, "shards", _t(inp["skew_key"]),
                                     {"total": ("sum", _t(inp["skew_val"]))}, num_groups=32)


def case_aggregate_raises(mesh, inp):
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.errors import CapacityError

    try:
        par.distributed_aggregate(mesh, "shards", _t(inp["skew_key"]),
                                  {"total": ("sum", _t(inp["skew_val"]))}, num_groups=32,
                                  on_overflow="raise")
    except CapacityError as e:
        return {"what": e.what, "capacity": e.capacity, "required": e.required}
    return None


def _chunks(inp, name):
    return [(_t(k), {"total": ("sum", _t(v))}, None) for k, v in inp[name]]


def case_pipelined(mesh, inp):
    from strawboat_tpu_torch import parallel as par

    return par.pipelined_distributed_aggregate(mesh, "shards", _chunks(inp, "chunks"),
                                               num_groups=128)


def case_pipelined_raises(mesh, inp):
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.errors import CapacityError

    try:
        par.pipelined_distributed_aggregate(mesh, "shards", _chunks(inp, "big_chunks"),
                                            num_groups=32)
    except CapacityError as e:
        return {"what": e.what, "capacity": e.capacity, "required": e.required}
    return None


def _join(mesh, inp, prefix, **kw):
    from strawboat_tpu_torch import parallel as par

    return par.distributed_join(mesh, "shards", _t(inp[prefix + "pk"]), (_t(inp[prefix + "pv"]),),
                                _t(inp[prefix + "bk"]), (_t(inp[prefix + "bw"]),), **kw)


def case_join(mesh, inp):
    return _join(mesh, inp, "join_", capacity_per_shard=512)


def case_join_grows(mesh, inp):
    """The default bin capacity (from the sides' global row counts) and a
    fan-out that grows over duplicate build keys."""
    return _join(mesh, inp, "dup_", max_fanout=1)


def case_scan(mesh, inp):
    from strawboat_tpu_torch import parallel as par

    return par.distributed_scan(inp["scan_path"], mesh)


def case_scan_q1(mesh, inp):
    """Q1's shape over a distributed scan: utf8 group keys through the
    global dictionaries, then ``distributed_aggregate``."""
    from strawboat_tpu_torch import parallel as par

    t = par.distributed_scan(inp["q1_path"], mesh)
    combined = t["rf"].values.long() * len(t["ls"].dictionary) + t["ls"].values.long()
    q, p, d = t["qty"].values, t["price"].values, t["disc"].values
    res = par.distributed_aggregate(mesh, "shards", combined, {
        "sum_qty": ("sum", q), "sum_disc_price": ("sum", p * (100 - d)), "min_qty": ("min", q),
        "cnt": ("count", q)}, mask=t["__valid__"].values, num_groups=64)
    return {"table": t, "q1": res}


def case_scan_dataset(mesh, inp):
    from strawboat_tpu_torch import parallel as par

    t = par.distributed_scan_dataset(inp["dataset_paths"], mesh)
    res = par.distributed_aggregate(mesh, "shards", t["k"].values, {"total": ("sum", t["v"].values)},
                                    mask=t["__valid__"].values, num_groups=32)
    return {"table": t, "by_k": res}


def case_streamed(mesh, inp):
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.exec.pruning import Comparison

    return par.streamed_dataset_aggregate(
        mesh, "shards", inp["stream_paths"], key="g",
        aggs={"total": ("sum", "v"), "cnt": ("count", "v")}, chunk_pages=2, num_groups=64,
        predicates=[Comparison("d", "lt", 150)])


def _sharded_resident(mesh, path):
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.exec import load_resident

    rt = load_resident(path, mesh.axis_devices("shards")[0], tile=512)
    return par.shard_resident(rt, mesh, "shards")


def _counting_k1():
    """A K1 call counter around ``exec/resident.py``'s many-plane entry
    (the rank's process is its own: nothing to restore)."""
    from strawboat_tpu_torch.exec import resident

    calls = []
    orig = resident.bitunpack_tiled_many

    def counting(planes, seed=0):
        calls.append(len(planes))
        return orig(planes, seed)

    resident.bitunpack_tiled_many = counting
    return calls, orig


def _restore_k1(orig):
    from strawboat_tpu_torch.exec import resident

    resident.bitunpack_tiled_many = orig


def case_resident(mesh, inp):
    """Q6's shape and the grouped sums over a sharded resident table, each
    one K1 call a process over its shards' planes (and Q6's K1 launches:
    none on the CPU, where the wrapper runs the plain version)."""
    from strawboat_tpu_torch import parallel as par
    from strawboat_tpu_torch.util import obs

    srt = _sharded_resident(mesh, inp["resident_path"])
    calls, orig = _counting_k1()
    try:
        launches = obs.counter("k1.launches")
        q6 = par.sharded_filter_sum(srt, inp["q6_preds"], value="ep", product_with="disc")
        launches = obs.counter("k1.launches") - launches
        q6_calls = list(calls)
        calls.clear()
        group = par.sharded_group_sum(srt, "grp", ["ep"], num_groups=6,
                                      predicates={"sd": (400, 2000)})
    finally:
        _restore_k1(orig)
    return {"rows_per_shard": srt.rows_per_shard, "q6": q6, "group": group,
            "k1_calls": PerRank((q6_calls, list(calls))), "q6_k1_launches": PerRank(launches)}


def case_resident_nullable_dict(mesh, inp):
    """Validity planes, a dictionary column and more than 4096 groups."""
    from strawboat_tpu_torch import parallel as par

    srt = _sharded_resident(mesh, inp["nullable_path"])
    return {"v": par.sharded_group_sum(srt, "k", ["v"], num_groups=5000),
            "k": par.sharded_group_sum(srt, "k", ["k"], num_groups=5000),
            "w": par.sharded_filter_sum(srt, {"w": ("yy", "zzz")}, value="v")}


def case_refusals(mesh, inp):
    """``make_mesh`` inside the world: a shard count the world does not
    divide, and ``"cuda:all"``, both refused."""
    from strawboat_tpu_torch import parallel as par

    size = torch.distributed.get_world_size()
    out = {}
    for what, args in (("indivisible", (size + 1, "cpu")), ("cuda_all", (size, "cuda:all"))):
        try:
            par.make_mesh(*args)
        except ValueError as e:
            out[what] = str(e)
    out["shape"] = mesh.shape
    out["first_shard"] = PerRank(mesh.first_shard)
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def run_case(name: str, mesh, inp):
    """Case ``name`` of :data:`CASES`, or ``"<module>:<function>"``: a case
    another test module keeps (a module of ``tests/`` that imports no JAX)."""
    if ":" in name:
        module, fn = name.split(":")
        return to_host(getattr(importlib.import_module(module), fn)(mesh, inp))
    return to_host(CASES[name](mesh, inp))


# ---------------------------------------------------------------------------
# the world


def rank_main(rank: int, size: int, store: str, inp: Dict, names: Sequence[str],
              workdir: str, device: str, backend) -> None:
    """One rank: join the world, run every case on its 8-shard mesh on
    ``device`` (``"cuda"``: card ``rank``, one card a rank), save its
    results (pickled, for :func:`run_world`)."""
    torch.set_num_threads(1)
    from strawboat_tpu_torch import parallel as par

    if device == "cuda":
        device = f"cuda:{rank}"

    par.distributed_init(store, size, rank, device, backend=backend,
                         timeout=COLLECTIVE_TIMEOUT_S)
    try:
        mesh = par.make_mesh(N, device)
        out = {name: run_case(name, mesh, inp) for name in names}
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(size: int, inp: Dict, names: Sequence[str], workdir: str, device: str = "cpu",
              backend=None, limit_s: float = WORLD_LIMIT_S) -> Dict:
    """Spawn a world of ``size`` ranks on ``device`` (``backend`` as
    ``distributed_init`` takes it: gloo on the CPU), run ``names`` on
    every rank, and return each case's merged result.  A rank that raises
    fails the world (``ProcessRaisedException``); a world still running
    after ``limit_s`` seconds is killed (``TimeoutError``)."""
    os.makedirs(workdir, exist_ok=True)
    store = f"file://{os.path.join(workdir, 'store')}"
    ctx = torch.multiprocessing.start_processes(
        rank_main, args=(size, store, inp, list(names), workdir, device, backend), nprocs=size,
        join=False, start_method="spawn")
    deadline = time.monotonic() + limit_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {size} processes outlived {limit_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    per_rank = []
    for r in range(size):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            per_rank.append(pickle.load(f))
    return {name: merge([r[name] for r in per_rank]) for name in names}
