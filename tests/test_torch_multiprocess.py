"""The port's mesh across processes against the JAX package's 8-device mesh.

Worlds of 2 and 4 gloo processes on the CPU (``tests/_torch_world.py``,
spawned once per world for the whole module) each build an 8-shard mesh
(``make_mesh(8, "cpu")``: ``8 / W`` shards a process) and run every case;
each rank keeps its own shards, and the test puts them together in global
shard order.  Every case's merged result equals the port's single-process
8-shard mesh's shard for shard (integers exactly, float64 sums to rtol
1e-12) and the JAX package's on its 8-device CPU mesh
(``tests/conftest.py``), on the same numpy inputs from one seed and the
same files (written by the JAX writer).  Capacity growth and
``CapacityError`` come out alike on every rank (``_torch_world.merge``
checks that the ranks agree on every value that is not a shard).
"""

import collections
import importlib
import traceback
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from _torch_world import (
    CASES, N, PerRank, Q6_PREDS, Shards, assert_same, make_inputs, run_case, run_world)
from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.errors import CapacityError as RefCapacityError
from strawboat_tpu import parallel as ref_par
from strawboat_tpu.parallel import dist_scan as ref_scan
from strawboat_tpu_torch import parallel as par

WORLDS = (2, 4)


def _write(path, table: pa.Table, page: int, **opts) -> str:
    ref_write(str(path), table, options=RefOptions(default_compression=RefCompression.LZ4,
                                                  max_page_size=page, **opts))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every case's numpy inputs and files (written by the JAX writer),
    from fixed seeds."""
    return make_inputs(tmp_path_factory.mktemp("world_inputs"), _write)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request, inputs, tmp_path_factory):
    """Every case's result merged over the ranks of one world, run once,
    or the failure of the world as text."""
    size = request.param
    try:
        res = run_world(size, inputs, list(CASES), str(tmp_path_factory.mktemp(f"world{size}")))
    except Exception:  # noqa: BLE001 - each test reports the world's failure
        return size, None, traceback.format_exc()
    return size, res, None


_SINGLE, _REF = {}, {}


def _single(name, inputs):
    """The port's single-process 8-shard mesh on the same case (no world
    in this process), run once."""
    if name not in _SINGLE:
        _SINGLE[name] = run_case(name, par.make_mesh(N, "cpu"), inputs)
    return _SINGLE[name]


def _ref(name, fn):
    """The JAX package's result of a case, computed once for both worlds."""
    if name not in _REF:
        _REF[name] = fn()
    return _REF[name]


def _got(world, name):
    size, res, err = world
    if err is not None:
        pytest.fail(f"the world of {size} failed:\n{err}")
    return size, res[name]


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() >= N, "expected 8 virtual CPU devices"
    return ref_par.make_mesh(N)


@pytest.fixture()
def interp_pallas():
    from jax.experimental import pallas as pl

    from strawboat_tpu.kernels import bitunpack_pallas as m

    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        importlib.reload(m)
        yield
    importlib.reload(m)


def _jshard(mesh, arr):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("shards")))


def _np(x) -> np.ndarray:
    if isinstance(x, Shards):
        return torch.cat(x.shards).numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(g, w), np.flatnonzero(g != w)[:10]


def _check(world, inputs, name):
    """The world's merged result, held equal to the single-process mesh's."""
    size, got = _got(world, name)
    assert_same(got, _single(name, inputs))
    return size, got


def _same_result(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])


def _groups(res, value: str) -> dict:
    ok = _np(res["valid"])
    return dict(zip(_np(res["keys"])[ok].tolist(), _np(res[value])[ok].tolist()))


def _same_scan(got: dict, want, dictionaries=()):
    assert set(got["columns"]) == set(want.columns)
    assert got["num_rows"] == want.num_rows
    for name, c in want.columns.items():
        g = got["columns"][name]
        _same(g["values"], c.values)
        assert (g["validity"] is None) == (c.validity is None), name
        if c.validity is not None:
            _same(g["validity"], c.validity)
        if name in dictionaries:
            assert g["dictionary"] == [x.as_py() for x in c.dictionary], name


def _ref_agg(jmesh, key, aggs, **kw):
    return ref_par.distributed_aggregate(jmesh, "shards", _jshard(jmesh, key),
                                         {k: (fn, _jshard(jmesh, v)) for k, (fn, v) in aggs.items()},
                                         **kw)


# -- the collectives and the shuffle ------------------------------------------


def test_all_to_all_and_psum_as_jax(world, inputs, jmesh):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    _size, got = _check(world, inputs, "collectives")
    bins = inputs["bins"]

    def body(b, f):
        return (jax.lax.all_to_all(b, "shards", split_axis=0, concat_axis=0, tiled=True),
                jax.lax.all_to_all(f, "shards", split_axis=0, concat_axis=0, tiled=True),
                jax.lax.psum(b, "shards"), jax.lax.psum(b.astype(jnp.float64) / 7, "shards"))

    a2a, a2a_bool, s, sf = _ref("collectives", lambda: jax.jit(shard_map(
        body, mesh=jmesh, in_specs=(P("shards"), P("shards")),
        out_specs=(P("shards"), P("shards"), P(), P()), check_vma=False))(
        _jshard(jmesh, bins), _jshard(jmesh, bins % 3 == 0)))
    _same(got["a2a"], np.asarray(a2a).reshape(-1))
    _same(got["a2a_bool"], np.asarray(a2a_bool).reshape(-1))
    for shard_sum in got["psum"].shards:
        _same(shard_sum, np.asarray(s))
    for shard_sum in got["psum_f64"].shards:
        np.testing.assert_allclose(shard_sum.numpy(), np.asarray(sf), rtol=1e-12)


@pytest.mark.parametrize("name, salt, capacity", [("shuffle", 0, 512), ("shuffle_salted", N, 64)])
def test_shuffle_by_key_as_jax(world, inputs, jmesh, name, salt, capacity):
    _size, got = _check(world, inputs, name)
    if name == "shuffle":
        key, val = inputs["shuffle_key"], inputs["shuffle_val"]
    else:
        key, val = np.zeros(N * 64, dtype=np.int64), np.arange(N * 64)
    want = _ref(name, lambda: ref_par.shuffle_by_key(
        jmesh, "shards", _jshard(jmesh, key), (_jshard(jmesh, val),), capacity=capacity,
        salt=salt))
    _same(got[0], want[0])
    _same(got[1][0], want[1][0])
    _same(got[2], want[2])
    v = _np(got[2])
    assert int(v.sum()) == len(key) and sorted(_np(got[1][0])[v].tolist()) == sorted(val.tolist())


# -- aggregates -------------------------------------------------------------------


def test_distributed_aggregate_as_jax(world, inputs, jmesh):
    _size, got = _check(world, inputs, "aggregate")
    key, val, mask = inputs["agg_key"], inputs["agg_val"], inputs["agg_mask"]
    _same_result(got["sum_max"], _ref_agg(jmesh, key, {"total": ("sum", val), "mx": ("max", val)},
                                          num_groups=256))
    _same_result(got["masked"], _ref_agg(
        jmesh, key, {"lo": ("min", val), "c": ("count", val), "s": ("sum", val)},
        mask=_jshard(jmesh, mask), num_groups=128))
    assert _groups(got["sum_max"], "total") == {int(k): int(val[key == k].sum())
                                                for k in np.unique(key)}


def test_aggregate_grows_on_every_rank_when_one_overflows(world, inputs, jmesh):
    """Only rank 0's shards hold more groups than the capacity (32); every
    rank grows to 256 slots, as the JAX package's retry does."""
    size, got = _check(world, inputs, "aggregate_one_rank_grows")
    key, val = inputs["skew_key"], inputs["skew_val"]
    want = _ref_agg(jmesh, key, {"total": ("sum", val)}, num_groups=32)
    _same_result(got, want)
    assert [len(s) for s in got["keys"].shards] == [256] * N
    per_shard = [len(np.unique(key[i * 1024 : (i + 1) * 1024])) for i in range(N)]
    assert per_shard[0] > 32 and max(per_shard[N // size :]) <= 32  # other ranks fit
    assert _groups(got, "total") == {int(k): int(val[key == k].sum()) for k in np.unique(key)}


def test_aggregate_capacity_error_on_every_rank(world, inputs, jmesh):
    _size, got = _check(world, inputs, "aggregate_raises")
    key, val = inputs["skew_key"], inputs["skew_val"]
    with pytest.raises(RefCapacityError) as ref_err:
        _ref_agg(jmesh, key, {"total": ("sum", val)}, num_groups=32, on_overflow="raise")
    assert got is not None, "no CapacityError"
    assert (got["capacity"], got["required"]) == (ref_err.value.capacity, ref_err.value.required)


def _ref_chunks(jmesh, chunks):
    return [(_jshard(jmesh, k), {"total": ("sum", _jshard(jmesh, v))}, None) for k, v in chunks]


def test_pipelined_aggregate_as_jax(world, inputs, jmesh):
    _size, got = _check(world, inputs, "pipelined")
    want = ref_par.pipelined_distributed_aggregate(jmesh, "shards",
                                                   _ref_chunks(jmesh, inputs["chunks"]),
                                                   num_groups=128)
    _same_result(got, want)
    key = np.concatenate([k for k, _v in inputs["chunks"]])
    val = np.concatenate([v for _k, v in inputs["chunks"]])
    assert _groups(got, "total") == {int(k): int(val[key == k].sum()) for k in np.unique(key)}


def test_pipelined_capacity_error_on_every_rank(world, inputs, jmesh):
    _size, got = _check(world, inputs, "pipelined_raises")
    with pytest.raises(RefCapacityError) as ref_err:
        ref_par.pipelined_distributed_aggregate(jmesh, "shards",
                                                _ref_chunks(jmesh, inputs["big_chunks"]),
                                                num_groups=32)
    assert got is not None and got["required"] == ref_err.value.required


# -- joins ------------------------------------------------------------------------


def _joined_rows(key, p, b, valid):
    """Each shard's valid joined rows as a sorted list of (key, probe
    payload, build payload)."""
    out = []
    for ks, ps, bs, vs in zip(*(np.split(_np(x), N) for x in (key, p, b, valid))):
        out.append(sorted(zip(ks[vs].tolist(), ps[vs].tolist(), bs[vs].tolist())))
    return out


@pytest.mark.parametrize("name, prefix, kw", [
    ("join", "join_", {"capacity_per_shard": 512}), ("join_grows", "dup_", {"max_fanout": 1})])
def test_distributed_join_as_jax(world, inputs, jmesh, name, prefix, kw):
    """The same joined rows on every shard as the JAX package's (the slots
    within a probe row's fan-out may differ: the port leaves empty bin
    slots out of the local sort)."""
    _size, got = _check(world, inputs, name)
    pk, pv, bk, bw = (inputs[prefix + s] for s in ("pk", "pv", "bk", "bw"))
    want = _ref(name, lambda: ref_par.distributed_join(
        jmesh, "shards", _jshard(jmesh, pk), (_jshard(jmesh, pv),), _jshard(jmesh, bk),
        (_jshard(jmesh, bw),), **kw))
    rows = _joined_rows(got[0], got[1][0], got[2][0], got[3])
    assert rows == _joined_rows(want[0], want[1][0], want[2][0], want[3])
    assert sum(len(r) for r in rows) == sum(int((bk == k).sum()) for k in pk)


# -- scans ------------------------------------------------------------------------


def test_distributed_scan_utf8_columns_as_jax(world, inputs, jmesh):
    """Strings, bools and nulls: every rank holds the same global
    dictionary, equal to the JAX one."""
    _size, got = _check(world, inputs, "scan")
    want = ref_scan.distributed_scan(inputs["scan_path"], jmesh)
    _same_scan(got, want, dictionaries=("s",))
    valid = _np(got["columns"]["__valid__"]["values"])
    codes = _np(got["columns"]["s"]["values"])[valid]
    assert collections.Counter(codes.tolist()).keys() <= set(range(4))


def test_distributed_q1_over_scan_as_jax(world, inputs, jmesh):
    _size, got = _check(world, inputs, "scan_q1")
    want_t = ref_scan.distributed_scan(inputs["q1_path"], jmesh)
    _same_scan(got["table"], want_t, dictionaries=("rf", "ls"))
    n_ls = len(want_t["ls"].dictionary)
    combined = want_t["rf"].values.astype(jnp.int64) * n_ls + want_t["ls"].values.astype(jnp.int64)
    q, p, d = want_t["qty"].values, want_t["price"].values, want_t["disc"].values
    want = ref_par.distributed_aggregate(jmesh, "shards", combined, {
        "sum_qty": ("sum", q), "sum_disc_price": ("sum", p * (100 - d)), "min_qty": ("min", q),
        "cnt": ("count", q)}, mask=want_t["__valid__"].values, num_groups=64)
    _same_result(got["q1"], want)


def test_distributed_scan_dataset_as_jax(world, inputs, jmesh):
    _size, got = _check(world, inputs, "scan_dataset")
    want_t = ref_par.distributed_scan_dataset(inputs["dataset_paths"], jmesh)
    _same_scan(got["table"], want_t, dictionaries=("s",))
    _same_result(got["by_k"], ref_par.distributed_aggregate(
        jmesh, "shards", want_t["k"].values, {"total": ("sum", want_t["v"].values)},
        mask=want_t["__valid__"].values, num_groups=32))


def test_streamed_dataset_aggregate_as_jax(world, inputs, jmesh):
    from strawboat_tpu.exec.pruning import Comparison as RefComparison
    from strawboat_tpu.parallel.pipeline import streamed_dataset_aggregate as ref_streamed

    _size, got = _check(world, inputs, "streamed")
    want = ref_streamed(jmesh, "shards", inputs["stream_paths"], key="g",
                        aggs={"total": ("sum", "v"), "cnt": ("count", "v")}, chunk_pages=2,
                        num_groups=64, predicates=[RefComparison("d", "lt", 150)])
    _same_result(got, want)


# -- sharded resident tables ----------------------------------------------------------


def test_sharded_resident_as_jax(world, inputs, jmesh, interp_pallas):
    """Q6's shape and the grouped sums: each rank decodes its shards'
    planes in one K1 call (one plane a column a shard)."""
    from strawboat_tpu.exec.resident import load_resident as ref_load
    from strawboat_tpu.parallel.dist_resident import shard_resident as ref_shard
    from strawboat_tpu.parallel.dist_resident import sharded_filter_sum as ref_filter_sum
    from strawboat_tpu.parallel.dist_resident import sharded_group_sum as ref_group_sum

    size, got = _check(world, inputs, "resident")

    def reference():
        jsrt = ref_shard(ref_load(inputs["resident_path"], tile=512), jmesh, "shards")
        return (jsrt.rows_per_shard,
                int(ref_filter_sum(jsrt, Q6_PREDS, value="ep", product_with="disc")),
                ref_group_sum(jsrt, "grp", ["ep"], num_groups=6, predicates={"sd": (400, 2000)}))

    rows_per_shard, q6, ((wsums,), wcnt) = _ref("resident", reference)
    assert got["rows_per_shard"] == rows_per_shard
    assert int(got["q6"]) == q6
    (sums,), cnt = got["group"]
    _same(sums, np.asarray(wsums))
    _same(cnt, np.asarray(wcnt))
    k = N // size
    assert got["k1_calls"] == [([k * 4], [k * 3])] * size
    assert got["q6_k1_launches"] == [0] * size  # the plain version on the CPU


def test_sharded_resident_nullable_and_dict_as_jax(world, inputs, jmesh, interp_pallas):
    from strawboat_tpu.exec.resident import load_resident as ref_load
    from strawboat_tpu.parallel.dist_resident import shard_resident as ref_shard
    from strawboat_tpu.parallel.dist_resident import sharded_filter_sum as ref_filter_sum
    from strawboat_tpu.parallel.dist_resident import sharded_group_sum as ref_group_sum

    _size, got = _check(world, inputs, "resident_nullable_dict")

    def reference():
        jsrt = ref_shard(ref_load(inputs["nullable_path"], tile=512), jmesh, "shards")
        return ({value: ref_group_sum(jsrt, "k", [value], num_groups=5000) for value in ("v", "k")},
                int(ref_filter_sum(jsrt, {"w": ("yy", "zzz")}, value="v")))

    groups, w = _ref("resident_nullable_dict", reference)
    for value in ("v", "k"):
        (sums,), cnt = got[value]
        (wsums,), wcnt = groups[value]
        _same(sums, np.asarray(wsums).astype(np.int64))
        _same(cnt, np.asarray(wcnt))
    assert int(got["w"]) == w


# -- the mesh inside a world ---------------------------------------------------------


def test_make_mesh_inside_a_world(world):
    size, got = _got(world, "refusals")
    assert "do not split" in got["indivisible"] and str(size) in got["indivisible"]
    assert "own card" in got["cuda_all"]
    assert got["shape"] == {"shards": N}
    assert got["first_shard"] == [r * (N // size) for r in range(size)]


def test_world_results_are_per_rank():
    """``merge`` lists ``PerRank`` values and refuses ranks that disagree."""
    from _torch_world import merge

    assert merge([PerRank(1), PerRank(2)]) == [1, 2]
    assert merge([{"a": Shards([torch.ones(1)])}, {"a": Shards([torch.zeros(1)])}])["a"].shards \
        == [torch.ones(1), torch.zeros(1)]
    with pytest.raises(AssertionError, match="disagree"):
        merge([3, 4])
