"""The torch port's multi-device layer against the JAX package's.

The port's single-process mesh of 8 shards on the CPU and the JAX
package's 8-device CPU mesh (``tests/conftest.py``) get the same numpy
inputs from one seed; the files are written by the JAX writer and read by
both.  Every result is compared shard for shard, in shard order (a JAX
array sharded over the mesh reads back as its shards concatenated, a
``ShardedTensor`` through ``concat_shards``): integers exactly, float64
sums to rtol 1e-12.  The tests of ``tests/test_parallel.py``, the
distributed cases of ``tests/test_overflow.py`` and the sharded resident
tests of ``tests/test_resident.py`` each have a counterpart here (Pallas
interpreted, as there).
"""

import collections
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from strawboat_tpu.api import write_file as ref_write
from strawboat_tpu.codecs import WriteOptions as RefOptions
from strawboat_tpu.constants import Compression as RefCompression
from strawboat_tpu.errors import CapacityError as RefCapacityError
from strawboat_tpu import parallel as ref_par
from strawboat_tpu.parallel import dist_scan as ref_scan
from strawboat_tpu.parallel import shuffle as ref_shuffle
from strawboat_tpu_torch.errors import CapacityError, NotYetImplementedError
from strawboat_tpu_torch.exec.resident import ResidentTable
from strawboat_tpu_torch import parallel as par
from strawboat_tpu_torch.parallel import ShardedTensor, concat_shards
from strawboat_tpu_torch.parallel import dist_scan, shuffle

N = 8


@pytest.fixture(scope="module")
def meshes():
    assert jax.device_count() >= N, "expected 8 virtual CPU devices"
    return ref_par.make_mesh(N), par.make_mesh(N, "cpu")


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
    if isinstance(x, ShardedTensor):
        return concat_shards(x, "cpu").numpy()
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _same(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(g, w), np.flatnonzero(g != w)[:10]


def _same_result(got: dict, want: dict):
    """A distributed aggregate's result, every slot of every shard."""
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])


def _groups(res, value: str) -> dict:
    ok = _np(res["valid"])
    return dict(zip(_np(res["keys"])[ok].tolist(), _np(res[value])[ok].tolist()))


def _write(path, table: pa.Table, page: int, **opts) -> str:
    ref_write(str(path), table, options=RefOptions(default_compression=RefCompression.LZ4,
                                                  max_page_size=page, **opts))
    return str(path)


def _same_scan(got, want, dictionaries=()):
    """Two distributed scans: every column (padding, validity and the
    global dictionaries included) equal shard for shard."""
    assert set(got.columns) == set(want.columns)
    assert got.num_rows == want.num_rows
    for name, c in want.columns.items():
        _same(got[name].values, c.values)
        assert (got[name].validity is None) == (c.validity is None), name
        if c.validity is not None:
            _same(got[name].validity, c.validity)
        if name in dictionaries:
            assert list(got[name].dictionary) == [x.as_py() for x in c.dictionary], name


# -- the mesh and the collectives --------------------------------------------


@pytest.mark.parametrize("axes", [("shards",), ("a", "b"), ("a", "b", "c")])
def test_make_mesh_shapes_as_jax(axes):
    ref = ref_par.make_mesh(N, axis_names=axes)
    mesh = par.make_mesh(N, "cpu", axis_names=axes)
    assert mesh.devices.shape == ref.devices.shape
    assert mesh.shape == dict(ref.shape)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert len(mesh.axis_devices(axes[0])) == ref.shape[axes[0]]


def test_distributed_init_gloo_world_of_one(tmp_path):
    import torch.distributed as dist

    par.distributed_init(f"file://{tmp_path / 'store'}", 1, 0, "cpu")
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert par.make_mesh(2, "cpu").shape == {"shards": 2}
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_all_to_all_and_psum_as_jax(meshes):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jmesh, mesh = meshes
    rng = np.random.default_rng(0)
    bins = rng.integers(-(10**9), 10**9, (N * N, 5)).astype(np.int64)  # (P, cap) a shard

    def body(b):
        return (jax.lax.all_to_all(b, "shards", split_axis=0, concat_axis=0, tiled=True),
                jax.lax.psum(b, "shards"))

    ref_a2a, ref_sum = jax.jit(shard_map(body, mesh=jmesh, in_specs=P("shards"),
                                         out_specs=(P("shards"), P()), check_vma=False))(
        _jshard(jmesh, bins))
    devs = mesh.axis_devices("shards")
    shards = par.shard(mesh, "shards", torch.from_numpy(bins)).shards
    got = par.all_to_all(list(shards), devs)
    _same(torch.cat(got), np.asarray(ref_a2a).reshape(-1))  # (P·cap,) a shard
    summed = par.psum(list(shards), devs)
    assert len(summed) == N
    for s in summed:
        _same(s, np.asarray(ref_sum))


def test_sharded_tensor_arithmetic_shard_by_shard(meshes):
    _jmesh, mesh = meshes
    a = par.shard(mesh, "shards", torch.arange(16))
    b = par.shard(mesh, "shards", torch.arange(16) * 3)
    _same((a * (100 - b)) % 7 + 1, (np.arange(16) * (100 - 3 * np.arange(16))) % 7 + 1)
    _same(~(a < 5) & (b != 9), ~(np.arange(16) < 5) & (3 * np.arange(16) != 9))
    assert a.shape == (16,) and len(a.shards) == N
    with pytest.raises(ValueError):
        par.shard(mesh, "shards", torch.arange(10))


# -- shuffle -------------------------------------------------------------------

EDGE_KEYS = np.array([0, 1, -1, 2**63 - 1, -(2**63), 2**32, 2**32 - 1, -(2**31), 12345678901234,
                      -987654321, 7, 2**62 + 3], dtype=np.int64)


@pytest.mark.parametrize("salt", [0, 3, 8])
@pytest.mark.parametrize("n_parts", [2, 3, 7, 8])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_hash_partition_ids_edge_keys(n_parts, salt, dtype):
    keys = np.concatenate([EDGE_KEYS, np.random.default_rng(n_parts).integers(
        -(2**63), 2**63 - 1, 500, dtype=np.int64)])
    keys = keys.astype(dtype) if dtype == np.int64 else (keys & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    want = ref_shuffle.hash_partition_ids(jnp.asarray(keys), n_parts, salt=salt)
    got = shuffle.hash_partition_ids(torch.from_numpy(keys), n_parts, salt=salt)
    assert got.dtype == torch.int32
    _same(got, np.asarray(want))
    salt_key = np.arange(len(keys), dtype=np.uint64)[::-1].copy()
    if salt:
        want = ref_shuffle.hash_partition_ids(jnp.asarray(keys), n_parts, salt=salt,
                                              salt_key=jnp.asarray(salt_key))
        got = shuffle.hash_partition_ids(torch.from_numpy(keys), n_parts, salt=salt,
                                         salt_key=torch.from_numpy(salt_key.view(np.int64)))
        _same(got, np.asarray(want))


@pytest.mark.parametrize("capacity", [4, 64, 300])
def test_send_bins_keep_row_order_as_jax(capacity):
    rng = np.random.default_rng(capacity)
    parts = rng.integers(0, 5, 1000).astype(np.int32)  # many rows a bin: order within matters
    pay = rng.integers(-(10**6), 10**6, 1000).astype(np.int64)
    flag = rng.random(1000) < 0.5
    (jb, jf), jvalid, jcounts = ref_shuffle.build_send_bins(
        jnp.asarray(parts), (jnp.asarray(pay), jnp.asarray(flag)), 5, capacity)
    (tb, tf), tvalid, tcounts = shuffle.build_send_bins(
        torch.from_numpy(parts), (torch.from_numpy(pay), torch.from_numpy(flag)), 5, capacity)
    _same(tcounts, np.asarray(jcounts))
    if capacity >= int(np.asarray(jcounts).max()):  # an overflowing try is never used
        _same(tb, np.asarray(jb))
        _same(tf, np.asarray(jf))
        _same(tvalid, np.asarray(jvalid))
    else:  # the reference's overflow rows collide in an overflowing bin's last slot
        ok = _np(tvalid).copy()
        ok[np.asarray(jcounts) > capacity, capacity - 1] = False
        _same(_np(tb)[ok], np.asarray(jb)[ok])


def test_shuffle_brings_equal_keys_together(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(0)
    n = N * 512
    key = rng.integers(0, 50, n).astype(np.int64)
    val = rng.integers(0, 1000, n).astype(np.int64)
    want = ref_par.shuffle_by_key(jmesh, "shards", _jshard(jmesh, key), (_jshard(jmesh, val),),
                                  capacity=512)
    out_key, (out_val,), valid = par.shuffle_by_key(
        mesh, "shards", torch.from_numpy(key), (torch.from_numpy(val),), capacity=512)
    _same(out_key, want[0])
    _same(out_val, want[1][0])
    _same(valid, want[2])
    ok, ov, om = _np(out_key), _np(out_val), _np(valid)
    assert om.sum() == n
    owner = {}
    for s, (ks, ms) in enumerate(zip(ok.reshape(N, -1), om.reshape(N, -1))):
        for kk in np.unique(ks[ms]):
            assert owner.setdefault(int(kk), s) == s
    assert sorted(zip(ok[om].tolist(), ov[om].tolist())) == sorted(zip(key.tolist(), val.tolist()))


def test_skew_salting_spreads_hot_key():
    key = np.zeros(N * 256, dtype=np.int64)
    for salt, spread in ((0, 1), (N, N)):
        got = shuffle.hash_partition_ids(torch.from_numpy(key), N, salt=salt)
        _same(got, np.asarray(ref_shuffle.hash_partition_ids(jnp.asarray(key), N, salt=salt)))
        assert len(np.unique(_np(got))) == spread


def test_salted_shuffle_as_jax(meshes):
    jmesh, mesh = meshes
    n = N * 64
    key = np.zeros(n, dtype=np.int64)  # one hot key
    val = np.arange(n, dtype=np.int64)
    want = ref_par.shuffle_by_key(jmesh, "shards", _jshard(jmesh, key), (_jshard(jmesh, val),),
                                  capacity=64, salt=N)
    got = par.shuffle_by_key(mesh, "shards", torch.from_numpy(key), (torch.from_numpy(val),),
                             capacity=64, salt=N)
    _same(got[0], want[0])
    _same(got[1][0], want[1][0])
    _same(got[2], want[2])
    per_shard = _np(got[2]).reshape(N, -1).sum(axis=1)
    assert (per_shard > 0).all() and per_shard.sum() == n


def test_shuffle_overflow_grows(meshes):
    jmesh, mesh = meshes
    n = N * 64
    key = np.zeros(n, dtype=np.int64)
    val = np.arange(n, dtype=np.int64)
    want = ref_par.shuffle_by_key(jmesh, "shards", _jshard(jmesh, key), (_jshard(jmesh, val),),
                                  capacity=8)
    out_key, (out_val,), valid = par.shuffle_by_key(
        mesh, "shards", torch.from_numpy(key), (torch.from_numpy(val),), capacity=8)
    _same(out_key, want[0])
    _same(out_val, want[1][0])
    _same(valid, want[2])
    v = _np(valid)
    assert int(v.sum()) == n
    assert sorted(_np(out_val)[v].tolist()) == list(range(n))


def test_shuffle_overflow_raises(meshes):
    jmesh, mesh = meshes
    n = N * 64
    key = np.zeros(n, dtype=np.int64)
    val = np.arange(n, dtype=np.int64)
    with pytest.raises(RefCapacityError) as ref_err:
        ref_par.shuffle_by_key(jmesh, "shards", _jshard(jmesh, key), (_jshard(jmesh, val),),
                               capacity=8, on_overflow="raise")
    with pytest.raises(CapacityError) as err:
        par.shuffle_by_key(mesh, "shards", torch.from_numpy(key), (torch.from_numpy(val),),
                           capacity=8, on_overflow="raise")
    assert (err.value.capacity, err.value.required) == (ref_err.value.capacity,
                                                        ref_err.value.required)


# -- aggregate ----------------------------------------------------------------


def test_distributed_aggregate_matches_single_device(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(1)
    n = N * 1024
    key = rng.integers(0, 40, n).astype(np.int64)
    val = rng.integers(0, 10**6, n).astype(np.int64)
    want = ref_par.distributed_aggregate(
        jmesh, "shards", _jshard(jmesh, key),
        {"total": ("sum", _jshard(jmesh, val)), "mx": ("max", _jshard(jmesh, val))}, num_groups=256)
    res = par.distributed_aggregate(
        mesh, "shards", torch.from_numpy(key),
        {"total": ("sum", torch.from_numpy(val)), "mx": ("max", torch.from_numpy(val))},
        num_groups=256)
    _same_result(res, want)
    got = {}
    for kk, t, m, ok in zip(_np(res["keys"]), _np(res["total"]), _np(res["mx"]), _np(res["valid"])):
        if ok:
            assert int(kk) not in got, "key appears on two shards"
            got[int(kk)] = (int(t), int(m))
    assert got == {int(k): (int(val[key == k].sum()), int(val[key == k].max()))
                   for k in np.unique(key)}


def test_distributed_aggregate_overflow_grows(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(23)
    n = N * 512
    key = rng.integers(0, 600, n).astype(np.int64)  # 600 groups > capacity 32
    val = rng.integers(0, 10**5, n).astype(np.int64)
    want = ref_par.distributed_aggregate(jmesh, "shards", _jshard(jmesh, key),
                                         {"total": ("sum", _jshard(jmesh, val))}, num_groups=32)
    res = par.distributed_aggregate(mesh, "shards", torch.from_numpy(key),
                                    {"total": ("sum", torch.from_numpy(val))}, num_groups=32)
    _same_result(res, want)
    assert len(res["keys"]) == len(np.asarray(want["keys"])) > N * 32
    assert _groups(res, "total") == {int(k): int(val[key == k].sum()) for k in np.unique(key)}
    with pytest.raises(CapacityError):
        par.distributed_aggregate(mesh, "shards", torch.from_numpy(key),
                                  {"total": ("sum", torch.from_numpy(val))}, num_groups=32,
                                  on_overflow="raise")


def test_distributed_aggregate_with_mask_min_count(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(3)
    n = N * 300
    key = rng.integers(-5, 60, n).astype(np.int64)
    val = rng.integers(-(10**9), 10**9, n).astype(np.int64)
    mask = rng.random(n) < 0.7
    aggs = {"lo": "min", "c": "count", "s": "sum"}
    want = ref_par.distributed_aggregate(
        jmesh, "shards", _jshard(jmesh, key),
        {k: (fn, _jshard(jmesh, val)) for k, fn in aggs.items()}, mask=_jshard(jmesh, mask),
        num_groups=128)
    res = par.distributed_aggregate(
        mesh, "shards", torch.from_numpy(key),
        {k: (fn, torch.from_numpy(val)) for k, fn in aggs.items()}, mask=torch.from_numpy(mask),
        num_groups=128)
    _same_result(res, want)


def test_pipelined_aggregate_matches(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(7)
    chunks, ref_chunks, keys, vals = [], [], [], []
    for _ in range(3):
        k = rng.integers(0, 25, N * 512).astype(np.int64)
        v = rng.integers(0, 10**5, N * 512).astype(np.int64)
        keys.append(k), vals.append(v)
        ref_chunks.append((_jshard(jmesh, k), {"total": ("sum", _jshard(jmesh, v))}, None))
        chunks.append((torch.from_numpy(k), {"total": ("sum", torch.from_numpy(v))}, None))
    want = ref_par.pipelined_distributed_aggregate(jmesh, "shards", ref_chunks, num_groups=128)
    res = par.pipelined_distributed_aggregate(mesh, "shards", chunks, num_groups=128)
    _same_result(res, want)
    key, val = np.concatenate(keys), np.concatenate(vals)
    assert _groups(res, "total") == {int(k): int(val[key == k].sum()) for k in np.unique(key)}
    assert par.pipelined_distributed_aggregate(mesh, "shards", [], num_groups=8) is None


def test_pipelined_aggregate_overflow_raises(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(31)
    chunks, ref_chunks = [], []
    for _ in range(2):
        k = rng.integers(0, 500, N * 256).astype(np.int64)  # 500 > 32 groups
        v = rng.integers(0, 100, N * 256).astype(np.int64)
        ref_chunks.append((_jshard(jmesh, k), {"total": ("sum", _jshard(jmesh, v))}, None))
        chunks.append((torch.from_numpy(k), {"total": ("sum", torch.from_numpy(v))}, None))
    with pytest.raises(RefCapacityError) as ref_err:
        ref_par.pipelined_distributed_aggregate(jmesh, "shards", ref_chunks, num_groups=32)
    with pytest.raises(CapacityError) as err:
        par.pipelined_distributed_aggregate(mesh, "shards", chunks, num_groups=32)
    assert err.value.required == ref_err.value.required


# -- join ----------------------------------------------------------------------


def _joined_rows(key, p, b, valid):
    """Each shard's valid joined rows as a sorted list of (key, probe
    payload, build payload)."""
    out = []
    for ks, ps, bs, vs in zip(*(np.split(_np(x), N) for x in (key, p, b, valid))):
        out.append(sorted(zip(ks[vs].tolist(), ps[vs].tolist(), bs[vs].tolist())))
    return out


def _join_both(meshes, pk, pv, bk, bw, **kw):
    """The port's and the JAX join on the same rows: the same joined rows
    on every shard (the slots within a probe row's fan-out may differ: the
    port leaves empty bin slots out of the local sort)."""
    jmesh, mesh = meshes
    want = ref_par.distributed_join(jmesh, "shards", _jshard(jmesh, pk), (_jshard(jmesh, pv),),
                                    _jshard(jmesh, bk), (_jshard(jmesh, bw),), **kw)
    got = par.distributed_join(mesh, "shards", torch.from_numpy(pk), (torch.from_numpy(pv),),
                               torch.from_numpy(bk), (torch.from_numpy(bw),), **kw)
    assert _joined_rows(got[0], got[1][0], got[2][0], got[3]) == \
        _joined_rows(want[0], want[1][0], want[2][0], want[3])
    return got, want


def test_distributed_join_matches(meshes):
    rng = np.random.default_rng(17)
    n, m = N * 512, N * 64
    pk = rng.integers(0, 200, n).astype(np.int64)
    pv = rng.integers(0, 1000, n).astype(np.int64)
    bk = rng.permutation(512)[:m].astype(np.int64)
    bw = rng.integers(1, 10, m).astype(np.int64)
    (_k, (op,), (ob,), valid), _want = _join_both(meshes, pk, pv, bk, bw, capacity_per_shard=512)
    v = _np(valid)
    wmap = {int(k): int(w) for k, w in zip(bk, bw)}
    assert int((_np(op)[v] * _np(ob)[v]).sum()) == sum(
        int(x) * wmap[int(k)] for k, x in zip(pk, pv) if int(k) in wmap)
    assert int(v.sum()) == sum(1 for k in pk if int(k) in wmap)


def test_distributed_join_fanout_grows(meshes):
    rng = np.random.default_rng(29)
    n, m = N * 128, N * 32
    pk = rng.integers(0, 40, n).astype(np.int64)
    pv = rng.integers(0, 1000, n).astype(np.int64)
    bk = rng.integers(0, 40, m).astype(np.int64)  # duplicate build keys
    bw = rng.integers(1, 10, m).astype(np.int64)
    (_k, (op,), (ob,), valid), _want = _join_both(meshes, pk, pv, bk, bw, capacity_per_shard=256,
                                                  max_fanout=1)
    v = _np(valid)
    exp = sum(int(x) * int(bw[bk == k].sum()) for k, x in zip(pk, pv))
    assert int(v.sum()) == sum(int((bk == k).sum()) for k in pk)
    assert int((_np(op)[v] * _np(ob)[v]).sum()) == exp


def test_distributed_join_bins_grow_and_raise(meshes):
    jmesh, mesh = meshes
    rng = np.random.default_rng(37)
    pk = np.full(N * 64, 3, dtype=np.int64)  # one hot probe key: one bin takes every row
    pv = rng.integers(0, 1000, N * 64).astype(np.int64)
    bk = np.arange(N * 8, dtype=np.int64)
    bw = rng.integers(1, 10, N * 8).astype(np.int64)
    (_k, (op,), (ob,), valid), _want = _join_both(meshes, pk, pv, bk, bw, capacity_per_shard=16)
    v = _np(valid)
    assert int(v.sum()) == len(pk) and int(_np(op)[v].sum()) == int(pv.sum())
    for args in ((pk, pv, bk, bw), (bk, bw, pk, pv)):
        with pytest.raises(RefCapacityError) as ref_err:
            ref_par.distributed_join(jmesh, "shards", *[_jshard(jmesh, a) if i % 2 == 0 else
                                                        (_jshard(jmesh, a),)
                                                        for i, a in enumerate(args)],
                                     capacity_per_shard=16, max_fanout=4, on_overflow="raise")
        with pytest.raises(CapacityError) as err:
            par.distributed_join(mesh, "shards", *[torch.from_numpy(a) if i % 2 == 0 else
                                                   (torch.from_numpy(a),)
                                                   for i, a in enumerate(args)],
                                 capacity_per_shard=16, max_fanout=4, on_overflow="raise")
        assert (err.value.what, err.value.capacity, err.value.required) == (
            ref_err.value.what, ref_err.value.capacity, ref_err.value.required)


def test_join_fanout_counts_valid_build_rows_only(meshes):
    """Probe key 0 meets the empty bin slots (key 0, invalid) on its shard:
    the reference grows the fan-out to their count, the port keeps 1; the
    joined rows are the same (ROADMAP queue 3)."""
    rng = np.random.default_rng(43)
    pk = rng.integers(0, 100, N * 64).astype(np.int64)
    pk[:N] = 0
    pv = rng.integers(0, 1000, N * 64).astype(np.int64)
    bk = rng.permutation(100)[: N * 8].astype(np.int64)
    bw = rng.integers(1, 10, N * 8).astype(np.int64)
    got, want = _join_both(meshes, pk, pv, bk, bw, capacity_per_shard=64)
    assert len(got[3]) == N * N * 64  # P · capacity · fan-out 1 a shard
    assert len(np.asarray(want[3])) > 8 * len(got[3])


# -- scans ---------------------------------------------------------------------


def test_distributed_scan_aggregate_end_to_end(meshes, tmp_path):
    jmesh, mesh = meshes
    rng = np.random.default_rng(4)
    n = N * 1500
    key = rng.integers(0, 30, n).astype(np.int64)
    val = rng.integers(0, 10**6, n).astype(np.int64)
    path = _write(tmp_path / "dist.str", pa.table({"k": key, "v": val}), 512,
                  default_compress_ratio=1.0)
    want_t = ref_scan.distributed_scan(path, jmesh)
    dt = par.distributed_scan(path, mesh)
    _same_scan(dt, want_t)
    want = ref_par.distributed_aggregate(jmesh, "shards", want_t["k"].values,
                                         {"total": ("sum", want_t["v"].values)},
                                         mask=want_t["__valid__"].values, num_groups=128)
    res = par.distributed_aggregate(mesh, "shards", dt["k"].values,
                                    {"total": ("sum", dt["v"].values)},
                                    mask=dt["__valid__"].values, num_groups=128)
    _same_result(res, want)
    assert _groups(res, "total") == {int(k): int(val[key == k].sum()) for k in np.unique(key)}


def test_distributed_scan_string_and_bool_columns(meshes, tmp_path):
    jmesh, mesh = meshes
    rng = np.random.default_rng(7)
    n = N * 600
    cats = np.array(["alpha", "beta", "gamma", "delta"])
    sidx = rng.integers(0, 4, n)
    null_mask = rng.random(n) < 0.1
    table = pa.table({"s": pa.array(cats[sidx].tolist(), pa.string()),
                      "b": pa.array(rng.integers(0, 2, n).astype(bool)),
                      "v": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
                      "nv": pa.array(rng.integers(0, 50, n).astype(np.int64), mask=null_mask)})
    path = _write(tmp_path / "dist_str.str", table, 256)
    want = ref_scan.distributed_scan(path, jmesh)
    dt = par.distributed_scan(path, mesh)
    valid = _np(dt["__valid__"].values)
    assert int(valid.sum()) == n
    # codes on valid non-null rows, validity, the global dictionary in order
    _same_scan(dt, want, dictionaries=("s",))
    codes = _np(dt["s"].values)[valid]
    assert collections.Counter(dt["s"].dictionary[c].decode() for c in codes) == \
        collections.Counter(cats[sidx].tolist())
    assert _np(dt["b"].values)[valid].sum() == np.asarray(table["b"]).sum()
    assert _np(dt["nv"].validity)[valid].sum() == (~null_mask).sum()


def test_distributed_q1_utf8_keys(meshes, tmp_path):
    jmesh, mesh = meshes
    rng = np.random.default_rng(11)
    n = N * 800
    rf = np.array(["A", "N", "R"])[rng.integers(0, 3, n)]
    ls = np.array(["F", "O"])[rng.integers(0, 2, n)]
    qty = rng.integers(1, 51, n).astype(np.int64)
    price = rng.integers(100, 10**5, n).astype(np.int64)
    disc = rng.integers(0, 11, n).astype(np.int64)
    table = pa.table({"rf": rf.tolist(), "ls": ls.tolist(), "qty": qty, "price": price,
                      "disc": disc})
    path = _write(tmp_path / "q1.str", table, 400)

    def q1(t, mesh, aggregate):
        n_ls = len(t["ls"].dictionary)
        combined = t["rf"].values.astype(jnp.int64) * n_ls + t["ls"].values.astype(jnp.int64) \
            if aggregate is ref_par.distributed_aggregate else \
            t["rf"].values.long() * n_ls + t["ls"].values.long()
        q, p, d = t["qty"].values, t["price"].values, t["disc"].values
        return aggregate(mesh, "shards", combined, {
            "sum_qty": ("sum", q), "sum_price": ("sum", p), "sum_disc_price": ("sum", p * (100 - d)),
            "sum_disc": ("sum", d), "min_qty": ("min", q), "max_qty": ("max", q),
            "cnt": ("count", q), "max_price": ("max", p)},
            mask=t["__valid__"].values, num_groups=64)

    want_t = ref_scan.distributed_scan(path, jmesh)
    dt = par.distributed_scan(path, mesh)
    _same_scan(dt, want_t, dictionaries=("rf", "ls"))
    res = q1(dt, mesh, par.distributed_aggregate)
    _same_result(res, q1(want_t, jmesh, ref_par.distributed_aggregate))
    n_ls = len(dt["ls"].dictionary)
    got = {}
    for i in np.flatnonzero(_np(res["valid"])):
        kk = int(_np(res["keys"])[i])
        got[(dt["rf"].dictionary[kk // n_ls].decode(), dt["ls"].dictionary[kk % n_ls].decode())] = (
            int(_np(res["sum_qty"])[i]), int(_np(res["sum_disc_price"])[i]), int(_np(res["cnt"])[i]))
    exp = {}
    for a in np.unique(rf):
        for b in np.unique(ls):
            sel = (rf == a) & (ls == b)
            if sel.any():
                exp[(str(a), str(b))] = (int(qty[sel].sum()), int((price[sel] * (100 - disc[sel])).sum()),
                                         int(sel.sum()))
    assert got == exp


@pytest.mark.parametrize("rank", range(4))
def test_local_shard_table_for_every_rank(tmp_path, rank):
    rng = np.random.default_rng(3)
    n = 4 * 700
    s = np.array(["x", "y", "z"])[rng.integers(0, 3, n)]
    v = rng.integers(0, 99, n).astype(np.int64)
    path = _write(tmp_path / "shards.str", pa.table({"s": s.tolist(), "v": v}), 350)
    want, want_dicts = ref_scan.local_shard_table(path, rank, 4)
    got, dicts = par.local_shard_table(path, rank, 4, "cpu")
    assert got.num_rows == want.num_rows
    _same(got["v"].values, want["v"].values)
    _same(got["s"].values, want["s"].values)
    assert list(dicts["s"]) == [x.as_py() for x in want_dicts["s"]]
    lo = sum(ref_scan.local_shard_table(path, r, 4)[0].num_rows for r in range(rank))
    assert np.array_equal(_np(got["v"].values), v[lo : lo + got.num_rows])


def test_local_shards_cover_file(tmp_path):
    from strawboat_tpu_torch.exec.dataset import _merge_dictionaries

    rng = np.random.default_rng(3)
    n = 4 * 700
    s = np.array(["x", "y", "z"])[rng.integers(0, 3, n)]
    v = rng.integers(0, 99, n).astype(np.int64)
    path = _write(tmp_path / "shards.str", pa.table({"s": s.tolist(), "v": v}), 350)
    parts = [par.local_shard_table(path, p, 4, "cpu") for p in range(4)]
    assert np.array_equal(np.concatenate([_np(t["v"].values) for t, _d in parts]), v)
    gdict, tables = _merge_dictionaries([d["s"] for _t, d in parts])
    texts = np.concatenate([gdict[tab[_np(t["s"].values)]] for (t, _d), tab in zip(parts, tables)])
    assert np.array_equal(texts, np.array([x.encode() for x in s], dtype=object))


def _dataset(tmp_path):
    paths, ks, vs, ss = [], [], [], []
    for i, n in enumerate([96, 224, 64]):  # uneven: the greedy balance decides
        rng = np.random.default_rng(i + 1)
        k = rng.integers(0, 5, n).astype(np.int64)
        v = rng.integers(0, 1000, n).astype(np.int64)
        s = np.array([f"f{i}", "shared"])[rng.integers(0, 2, n)]
        paths.append(_write(tmp_path / f"part-{i}.str", pa.table({"k": k, "v": v, "s": s.tolist()}),
                            32))
        ks.append(k), vs.append(v), ss.append(s)
    return paths, np.concatenate(ks), np.concatenate(vs), np.concatenate(ss)


def test_dataset_units_and_assignment_as_jax(tmp_path):
    paths, *_ = _dataset(tmp_path)
    for n_shards in (2, 8, 20):
        want_units, _m, _s = ref_scan._dataset_units(paths, n_shards)
        units, opened, _schema = dist_scan._dataset_units(paths, n_shards)
        assert units == want_units
        assign = dist_scan._assign_units(units, opened, n_shards)
        assert sorted(i for a in assign for i in a) == list(range(len(units)))


def test_distributed_scan_dataset(meshes, tmp_path):
    jmesh, mesh = meshes
    paths, k, v, s = _dataset(tmp_path)
    want_t = ref_par.distributed_scan_dataset(paths, jmesh)
    dt = par.distributed_scan_dataset(paths, mesh)
    _same_scan(dt, want_t, dictionaries=("s",))
    valid = _np(dt["__valid__"].values)
    assert int(valid.sum()) == len(k)
    assert np.array_equal(np.sort(_np(dt["v"].values)[valid]), np.sort(v))
    res = par.distributed_aggregate(mesh, "shards", dt["k"].values,
                                    {"total": ("sum", dt["v"].values)},
                                    mask=dt["__valid__"].values, num_groups=32)
    _same_result(res, ref_par.distributed_aggregate(
        jmesh, "shards", want_t["k"].values, {"total": ("sum", want_t["v"].values)},
        mask=want_t["__valid__"].values, num_groups=32))
    assert _groups(res, "total") == {int(g): int(v[k == g].sum()) for g in np.unique(k)}
    res2 = par.distributed_aggregate(mesh, "shards", dt["s"].values.long(),
                                     {"cnt": ("count", dt["v"].values)},
                                     mask=dt["__valid__"].values, num_groups=32)
    got2 = {dt["s"].dictionary[c].decode(): n for c, n in _groups(res2, "cnt").items()}
    assert got2 == dict(collections.Counter(s.tolist()))


def test_streamed_dataset_aggregate(meshes, tmp_path):
    from strawboat_tpu.exec.pruning import Comparison as RefComparison
    from strawboat_tpu.parallel.pipeline import streamed_dataset_aggregate as ref_streamed
    from strawboat_tpu_torch.exec.pruning import Comparison

    jmesh, mesh = meshes
    paths, gs, vs = [], [], []
    for i in range(3):
        rng = np.random.default_rng(10 + i)
        n = 300 + 40 * i
        g = rng.integers(0, 7, n).astype(np.int64)
        v = rng.integers(0, 1000, n).astype(np.int64)
        d = np.full(n, i * 100, dtype=np.int64)  # a date band a file
        paths.append(_write(tmp_path / f"s-{i}.str", pa.table({"g": g, "v": v, "d": d}), 64,
                            zone_maps=True))
        gs.append(g), vs.append(v)
    aggs = {"total": ("sum", "v"), "cnt": ("count", "v")}
    want = ref_streamed(jmesh, "shards", paths, key="g", aggs=aggs, chunk_pages=2, num_groups=64,
                        predicates=[RefComparison("d", "lt", 150)])
    res = par.streamed_dataset_aggregate(mesh, "shards", paths, key="g", aggs=aggs, chunk_pages=2,
                                         num_groups=64, predicates=[Comparison("d", "lt", 150)])
    _same_result(res, want)
    g, v = np.concatenate(gs[:2]), np.concatenate(vs[:2])  # file 2 pruned by its footer
    assert _groups(res, "total") == {int(x): int(v[g == x].sum()) for x in np.unique(g)}


def test_streamed_dictionary_keys_raise(tmp_path):
    path = _write(tmp_path / "s.str", pa.table({"s": ["a", "b"] * 50, "v": np.arange(100)}), 32)
    with pytest.raises(NotYetImplementedError):
        par.streamed_dataset_aggregate(par.make_mesh(2, "cpu"), "shards", [path], key="s",
                                       aggs={"t": ("sum", "v")})


def test_distributed_scan_refuses_nested_columns(tmp_path):
    path = str(tmp_path / "n.str")
    ref_write(path, pa.table({"l": pa.array([[1], [2, 3]], pa.list_(pa.int64())),
                              "v": np.arange(2)}))
    mesh = par.make_mesh(2, "cpu")
    with pytest.raises(NotYetImplementedError):
        par.distributed_scan(path, mesh)
    t = par.distributed_scan(path, mesh, columns=["v"])  # one page: shard 1 is padding
    assert t.num_rows == 4 and _np(t["__valid__"].values).tolist() == [True, True, False, False]


# -- sharded resident tables ------------------------------------------------------


def _resident(tmp_path, n, seed):
    from strawboat_tpu.exec.resident import load_resident as ref_load

    rng = np.random.default_rng(seed)
    cols = {nm: rng.integers(0, hi, n).astype(np.int32)
            for nm, hi in (("sd", 2557), ("qty", 51), ("disc", 11), ("ep", 60000), ("grp", 6))}
    t = pa.table(cols, schema=pa.schema([pa.field(nm, pa.int32(), nullable=False) for nm in cols]))
    p = _write(tmp_path / "res.str", t, 512, default_compress_ratio=1.0)
    ref = ref_load(p, tile=512)
    return ref, ResidentTable.from_reference(ref, "cpu"), cols


def test_sharded_resident_group_sum(meshes, tmp_path, interp_pallas):
    from strawboat_tpu.parallel.dist_resident import shard_resident as ref_shard
    from strawboat_tpu.parallel.dist_resident import sharded_group_sum as ref_group_sum

    jmesh, mesh = meshes
    ref, rt, cols = _resident(tmp_path, 4096, 17)
    want = ref_group_sum(ref_shard(ref, jmesh, "shards"), "grp", ["ep"], num_groups=6,
                         predicates={"sd": (400, 2000)})
    srt = par.shard_resident(rt, mesh, "shards")
    assert srt.rows_per_shard == ref_shard(ref, jmesh, "shards").rows_per_shard
    (sums,), cnt = par.sharded_group_sum(srt, "grp", ["ep"], num_groups=6,
                                         predicates={"sd": (400, 2000)})
    _same(sums, np.asarray(want[0][0]))
    _same(cnt, np.asarray(want[1]))
    sel = (cols["sd"] >= 400) & (cols["sd"] < 2000)
    for g in range(6):
        mg = sel & (cols["grp"] == g)
        assert int(sums[g]) == int(cols["ep"][mg].astype(np.int64).sum()) and int(cnt[g]) == mg.sum()
    single = rt.group_sum("grp", ["ep"], 6, predicates={"sd": (400, 2000)})
    _same(sums, single[0][0])
    _same(cnt, single[1])


def test_sharded_resident_filter_sum(meshes, tmp_path, interp_pallas):
    from strawboat_tpu.parallel.dist_resident import shard_resident as ref_shard
    from strawboat_tpu.parallel.dist_resident import sharded_filter_sum as ref_filter_sum

    jmesh, mesh = meshes
    ref, rt, cols = _resident(tmp_path, 4096, 23)
    preds = {"sd": (731, 1096), "disc": (5, 8), "qty": (None, 24)}
    want = int(ref_filter_sum(ref_shard(ref, jmesh, "shards"), preds, value="ep",
                              product_with="disc"))
    got = par.sharded_filter_sum(par.shard_resident(rt, mesh, "shards"), preds, value="ep",
                                 product_with="disc")
    assert got.dtype == torch.int64 and int(got) == want
    m = ((cols["sd"] >= 731) & (cols["sd"] < 1096) & (cols["disc"] >= 5) & (cols["disc"] < 8)
         & (cols["qty"] < 24))
    assert want == int((cols["ep"][m].astype(np.int64) * cols["disc"][m]).sum())
    assert int(rt.filter_sum(preds, value="ep", product_with="disc")) == want


def test_sharded_resident_float_sums(meshes, interp_pallas):
    from strawboat_tpu.exec.resident import make_resident as ref_make
    from strawboat_tpu.parallel.dist_resident import shard_resident as ref_shard
    from strawboat_tpu.parallel.dist_resident import sharded_group_sum as ref_group_sum

    jmesh, mesh = meshes
    rng = np.random.default_rng(31)
    n = 2000
    g = rng.integers(0, 4, n)
    f = np.round(rng.uniform(0, 100, n), 2)
    t = pa.table({"g": g, "f": f}, schema=pa.schema([pa.field("g", pa.int64(), nullable=False),
                                                       pa.field("f", pa.float64(), nullable=False)]))
    ref = ref_make(t, tile=512)
    (wsums,), wcnt = ref_group_sum(ref_shard(ref, jmesh, "shards"), "g", ["f"], num_groups=4)
    (sums,), cnt = par.sharded_group_sum(
        par.shard_resident(ResidentTable.from_reference(ref, "cpu"), mesh, "shards"), "g", ["f"],
        num_groups=4)
    assert sums.dtype == torch.float64
    np.testing.assert_allclose(_np(sums), np.asarray(wsums), rtol=1e-12)
    _same(cnt, np.asarray(wcnt))
    for k in range(4):
        assert float(sums[k]) == pytest.approx(float(f[g == k].sum()), rel=1e-12)


def test_sharded_resident_nullable_and_dict_columns(meshes, interp_pallas):
    """Validity planes and dictionary columns over the shards, and more
    than 4096 groups (the segment branch), against the JAX package and the
    single-device resident table."""
    from strawboat_tpu.exec.resident import make_resident as ref_make
    from strawboat_tpu.parallel.dist_resident import shard_resident as ref_shard
    from strawboat_tpu.parallel.dist_resident import sharded_filter_sum as ref_filter_sum
    from strawboat_tpu.parallel.dist_resident import sharded_group_sum as ref_group_sum

    jmesh, mesh = meshes
    rng = np.random.default_rng(41)
    n = 6000
    key = rng.integers(0, 5000, n).astype(np.int64)
    val = rng.integers(0, 1000, n).astype(np.int64)
    nulls = rng.random(n) < 0.2
    word = np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)]
    t = pa.table({"k": key, "v": pa.array(val, mask=nulls), "w": word.tolist()})
    ref = ref_make(t, tile=512)
    rt = ResidentTable.from_reference(ref, "cpu")
    srt = par.shard_resident(rt, mesh, "shards")
    jsrt = ref_shard(ref, jmesh, "shards")
    for value in ("v", "k"):
        (sums,), cnt = par.sharded_group_sum(srt, "k", [value], num_groups=5000)
        (wsums,), wcnt = ref_group_sum(jsrt, "k", [value], num_groups=5000)
        _same(sums, np.asarray(wsums).astype(np.int64))
        _same(cnt, np.asarray(wcnt))
    preds = {"w": ("yy", "zzz")}
    got = par.sharded_filter_sum(srt, preds, value="v")
    assert int(got) == int(ref_filter_sum(jsrt, preds, value="v")) == int(rt.filter_sum(preds, "v"))
    assert int(got) == int(val[(word == "yy") & ~nulls].sum())


def test_shard_resident_refuses_list_columns():
    from strawboat_tpu_torch import columns as cm
    from strawboat_tpu_torch.exec import make_resident
    from strawboat_tpu_torch.schema import Field, list_of

    rt = make_resident({"l": cm.ListColumn("list", None, np.array([0, 1, 3]),
                                           cm.PrimitiveColumn("int64", None, np.arange(3)))},
                       "cpu", tile=512, schema=[list_of("l", Field("item", "int64"))])
    with pytest.raises(NotYetImplementedError):
        par.shard_resident(rt, par.make_mesh(2, "cpu"), "shards")


# -- the whole layer ---------------------------------------------------------------


def test_dryrun_multidevice_on_the_cpu():
    from strawboat_tpu_torch.parallel.dryrun import dryrun_multidevice

    out = dryrun_multidevice(N, "cpu")
    assert out["shuffle_rows"] == N * 2048
    assert out["join_agg_groups"] == [0, 1, 2, 3, 4]
    assert out["q1_groups"] == 6 and out["resident_groups"] == 6
    assert out["per_shard_rows"] == [1200] * N
    assert out["scan_total"] == out["device_write_total"]
