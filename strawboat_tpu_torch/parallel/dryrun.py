"""One pass over the whole multi-device layer at tiny shapes.

``dryrun_multidevice(n_shards, device)`` is the port's counterpart of the
JAX package's ``dryrun_multichip`` (``__graft_entry__.py``): on a mesh of
``n_shards`` shards on ``device`` it runs, in the reference's order, a
sharded decode (K3 on each shard's blocks), distributed scans of a fact
and a dimension file, a keyed shuffle, the join and the aggregate of its
rows, a distributed Q1 with utf8 keys, the sharded scan of a three-part
dataset, a resident table with the ``Query`` DSL, the sharded resident
psum aggregate and ``filter_sum``, a resident ``list_sum`` and the
device-write rescan.  Every stage is held against numpy and the function
returns one dict of the stages' results; a mismatch raises
``AssertionError``.

    python -c "from strawboat_tpu_torch.parallel.dryrun import dryrun_multidevice as d; print(d(8, 'cpu'))"
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .collectives import concat_shards, shard
from .dist_agg import distributed_aggregate
from .dist_join import distributed_join
from .dist_resident import shard_resident, sharded_filter_sum, sharded_group_sum
from .dist_scan import distributed_scan, distributed_scan_dataset
from .mesh import make_mesh
from .shuffle import shuffle_by_key


def _unpack_blocks(words: np.ndarray, b: int) -> np.ndarray:
    """BitPacker4x blocks ``(n, 4b)`` u32 → ``(n·128,)`` values, in numpy:
    lane ``l`` holds values ``4t + l`` at bit ``t·b`` of its word stream."""
    n = words.shape[0]
    w = words.reshape(n, b, 4).astype(np.uint64)
    bits = (w[:, :, None, :] >> np.arange(32, dtype=np.uint64)[None, None, :, None]) & 1
    stream = bits.reshape(n, 32, b, 4)  # bit t·b + k of each lane's stream
    vals = (stream << np.arange(b, dtype=np.uint64)[None, None, :, None]).sum(axis=2)
    return vals.reshape(n, 128).reshape(-1)


def _host(x) -> np.ndarray:
    return concat_shards(x, "cpu").numpy()


def _groups(res, value: str) -> dict:
    ok = _host(res["valid"])
    return dict(zip(_host(res["keys"])[ok].tolist(), _host(res[value])[ok].tolist()))


def dryrun_multidevice(n_shards: int, device) -> dict:
    from ..codecs import WriteOptions
    from ..constants import Compression
    from ..columns import ListColumn, PrimitiveColumn
    from ..exec import Query, load_resident, scan_file
    from ..kernels.decode import bitunpack_natural_device
    from ..schema import Field, list_of
    from ..write import write_file
    from ..write.device import write_device_table

    mesh = make_mesh(n_shards, device)
    out = {}

    def lz4(page: int) -> WriteOptions:
        return WriteOptions(default_compression=Compression.LZ4, max_page_size=page)

    # ---- stage 0: sharded decode (K3 on each shard's blocks)
    b = 8
    rng = np.random.default_rng(1)
    words_np = rng.integers(0, 1 << 32, (n_shards * 2, b * 4), dtype=np.uint64).astype(np.uint32)
    words = shard(mesh, "shards", torch.from_numpy(words_np.view(np.int32)))
    dec = words.map(lambda w: bitunpack_natural_device(w, b))
    assert np.array_equal(_host(dec).view(np.uint32), _unpack_blocks(words_np, b)), "decode"
    out["decode_values"] = int(len(dec))

    # ---- stage 1: a fact and a dimension file, scanned distributed
    rng = np.random.default_rng(2)
    n_fact, n_dim = n_shards * 2048, 64
    k = rng.integers(0, n_dim, n_fact).astype(np.int64)
    v = rng.integers(0, 1000, n_fact).astype(np.int64)
    grp_np = (np.arange(n_dim) % 5).astype(np.int64)
    with tempfile.TemporaryDirectory(prefix="sb_dryrun_") as td:
        fpath, dpath = os.path.join(td, "fact.str"), os.path.join(td, "dim.str")
        write_file(fpath, {"k": k, "v": v}, options=lz4(max(n_fact // (2 * n_shards), 16)))
        write_file(dpath, {"dk": np.arange(n_dim, dtype=np.int64), "grp": grp_np},
                   options=lz4(16))
        ft = distributed_scan(fpath, mesh)
        dt = distributed_scan(dpath, mesh)
    fvalid, dvalid = ft["__valid__"].values, dt["__valid__"].values

    # ---- stage 2: keyed shuffle (every row once)
    _sk, (sv,), s_valid = shuffle_by_key(mesh, "shards", ft["k"].values, (ft["v"].values,),
                                         capacity=n_fact)
    sm = _host(s_valid)
    out["shuffle_rows"] = int(sm.sum())

    # ---- stages 3 and 4: join fact.k = dim.dk, aggregate by dim group
    _jk, (jv,), (jgrp,), jvalid = distributed_join(
        mesh, "shards", ft["k"].values, (ft["v"].values,), dt["dk"].values, (dt["grp"].values,),
        probe_valid=fvalid, build_valid=dvalid)
    res = distributed_aggregate(mesh, "shards", jgrp, {"total": ("sum", jv), "cnt": ("count", jv)},
                                mask=jvalid, num_groups=32)
    got = _groups(res, "total")
    grp = grp_np[k]
    ref = {int(g): int(v[grp == g].sum()) for g in np.unique(grp)}
    assert got == ref, ("join + aggregate", got, ref)
    scan_total = int(_host(ft["v"].values)[_host(fvalid)].sum())
    assert scan_total == int(v.sum()), ("scan total", scan_total, int(v.sum()))
    assert out["shuffle_rows"] == n_fact and sorted(_host(sv)[sm].tolist()) == sorted(v.tolist())
    out.update(scan_total=scan_total, join_agg_groups=sorted(got))

    # ---- stage 5: distributed Q1, utf8 group keys as global-dictionary codes
    rng = np.random.default_rng(5)
    n_li = n_shards * 1200
    rf_np = np.array(["A", "N", "R"])[rng.integers(0, 3, n_li)]
    ls_np = np.array(["F", "O"])[rng.integers(0, 2, n_li)]
    qty_np = rng.integers(1, 51, n_li).astype(np.int64)
    price_np = rng.integers(100, 10**5, n_li).astype(np.int64)
    disc_np = rng.integers(0, 11, n_li).astype(np.int64)
    lineitem = {"rf": rf_np, "ls": ls_np, "qty": qty_np, "price": price_np, "disc": disc_np}
    with tempfile.TemporaryDirectory(prefix="sb_dryrun_q1_") as td:
        lpath = os.path.join(td, "lineitem.str")
        write_file(lpath, lineitem, options=lz4(max(n_li // (2 * n_shards), 16)))
        lt = distributed_scan(lpath, mesh)
    n_ls = len(lt["ls"].dictionary)
    combined = lt["rf"].values.long() * n_ls + lt["ls"].values.long()
    disc_price = lt["price"].values * (100 - lt["disc"].values)
    charge = disc_price * (100 + (lt["disc"].values % 5))
    qty = lt["qty"].values
    q1 = distributed_aggregate(mesh, "shards", combined, {
        "sum_qty": ("sum", qty), "sum_price": ("sum", lt["price"].values),
        "sum_disc_price": ("sum", disc_price), "sum_charge": ("sum", charge),
        "sum_disc": ("sum", lt["disc"].values), "cnt": ("count", qty),
        "min_qty": ("min", qty), "max_qty": ("max", qty)},
        mask=lt["__valid__"].values, num_groups=32)
    rf_dict, ls_dict = lt["rf"].dictionary, lt["ls"].dictionary
    ok = _host(q1["valid"])
    cols = {n: _host(q1[n]) for n in ("keys", "sum_qty", "sum_disc_price", "sum_charge", "cnt")}
    q1_got = {}
    for i in np.flatnonzero(ok):
        kk = int(cols["keys"][i])
        q1_got[(rf_dict[kk // n_ls].decode(), ls_dict[kk % n_ls].decode())] = tuple(
            int(cols[n][i]) for n in ("sum_qty", "sum_disc_price", "sum_charge", "cnt"))
    dp_np = price_np * (100 - disc_np)
    ch_np = dp_np * (100 + (disc_np % 5))
    q1_exp = {}
    for g_rf in np.unique(rf_np):
        for g_ls in np.unique(ls_np):
            sel = (rf_np == g_rf) & (ls_np == g_ls)
            if sel.any():
                q1_exp[(str(g_rf), str(g_ls))] = (int(qty_np[sel].sum()), int(dp_np[sel].sum()),
                                                  int(ch_np[sel].sum()), int(sel.sum()))
    assert q1_got == q1_exp, ("distributed Q1", q1_got, q1_exp)
    out["q1_groups"] = len(q1_got)

    # ---- stage 6: a three-part dataset, sharded scan + keyed aggregate
    with tempfile.TemporaryDirectory(prefix="sb_dryrun_ds_") as td:
        parts = []
        third = max(n_fact // 3, 1)
        for pi in range(3):
            sl = slice(pi * third, (pi + 1) * third if pi < 2 else n_fact)
            pp = os.path.join(td, f"part-{pi}.str")
            write_file(pp, {"k": k[sl], "v": v[sl]}, options=lz4(max(third // n_shards, 8)))
            parts.append(pp)
        ds = distributed_scan_dataset(parts, mesh)
    assert int(_host(ds["__valid__"].values).sum()) == n_fact
    ds_res = distributed_aggregate(mesh, "shards", ds["k"].values, {"total": ("sum", ds["v"].values)},
                                   mask=ds["__valid__"].values, num_groups=128)
    assert _groups(ds_res, "total") == {int(g): int(v[k == g].sum()) for g in np.unique(k)}, \
        "dataset sharded scan aggregate"
    out["dataset_files"] = len(parts)
    out["per_shard_rows"] = [int(s.sum()) for s in lt["__valid__"].values.shards]

    # ---- stage 7: resident table + Query DSL, then sharded over the mesh
    dev = mesh.axis_devices("shards")[0]
    with tempfile.TemporaryDirectory(prefix="sb_dryrun_res_") as td:
        rpath = os.path.join(td, "res.str")
        write_file(rpath, lineitem, options=lz4(256))
        rt = load_resident(rpath, dev, tile=512)
    res_q = (Query(rt).group_by("rf", "ls", num_groups=16)
             .agg(sum_qty=("sum", "qty"), n=("count", "qty")).run())
    res_got = {}
    for i in range(int(res_q["n_groups"])):
        f = str(res_q["dict_rf"][int(res_q["key_rf"][i])])
        s = str(res_q["dict_ls"][int(res_q["key_ls"][i])])
        res_got[(f, s)] = int(res_q["sum_qty"][i])
    assert res_got == {k2: v2[0] for k2, v2 in q1_exp.items()}, ("resident + DSL", res_got)
    out["resident_groups"] = len(res_got)

    srt = shard_resident(rt, mesh, "shards")
    (sq,), scnt = sharded_group_sum(srt, "qty", ["price"], num_groups=64)
    sq, scnt = sq.cpu().numpy(), scnt.cpu().numpy()
    qdh = srt.columns["qty"].dictionary_host
    for qv in np.unique(qty_np):
        g = int(np.searchsorted(qdh, qv)) if qdh is not None else int(qv)
        sel = qty_np == qv
        assert sq[g] == int(price_np[sel].sum()) and scnt[g] == int(sel.sum()), ("group sum", qv)
    out["sharded_group_sum_groups"] = int((scnt > 0).sum())
    qlo, qhi = 10, 40
    sfs = int(sharded_filter_sum(srt, {"qty": (qlo, qhi)}, value="price"))
    sel = (qty_np >= qlo) & (qty_np < qhi)
    assert sfs == int(price_np[sel].sum()), ("sharded filter_sum", sfs)
    out["sharded_filter_sum"] = sfs

    # ---- stage 7d: a resident list<int64> column, list_sum
    lists = [[1, 2], [], [3, 4, 5], [6]] * 64
    offsets = np.zeros(len(lists) + 1, dtype=np.int32)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    flat = np.array([x for row in lists for x in row], dtype=np.int64)
    with tempfile.TemporaryDirectory(prefix="sb_dryrun_ls_") as td:
        lpath = os.path.join(td, "ls.str")
        write_file(lpath, {"l": ListColumn("list", None, offsets,
                                           PrimitiveColumn("int64", None, flat))},
                   schema=[list_of("l", Field("item", "int64"), nullable=False)],
                   options=WriteOptions(max_page_size=64))
        lrt = load_resident(lpath, dev, tile=512)
    lsums = lrt.list_sum("l").cpu().numpy()[: len(lists)]
    assert lsums.tolist() == [sum(x) for x in lists], "list_sum"
    out["list_sum_rows"] = len(lists)

    # ---- stage 8: device re-encode → rescan
    with tempfile.TemporaryDirectory(prefix="sb_dryrun_dw_") as td:
        src, dst = os.path.join(td, "src.str"), os.path.join(td, "dev.str")
        write_file(src, {"k": k, "v": v}, options=lz4(64))
        write_device_table(dst, scan_file(src, dev), options=lz4(64))
        dw_total = int(scan_file(dst, dev)["v"].values.sum())
    assert dw_total == int(v.sum()), ("device-write rescan", dw_total)
    out["device_write_total"] = dw_total
    return out
