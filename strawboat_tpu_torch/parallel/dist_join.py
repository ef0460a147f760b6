"""Distributed equi-join: co-shuffle both sides by key hash, join locally.

Counterpart of ``strawboat_tpu/parallel/dist_join.py``.  Both tables
repartition with the same key hash (one all_to_all a payload), so matching
keys land on the same shard; each shard then runs the port's sort +
searchsorted join (``exec/join.py`` ``_join_indices``) on what it holds.
The output stays sharded for downstream aggregation.

One departure from the reference: the local join leaves the invalid build
rows (empty bin slots, key 0, and padding) out of the sort
(``_join_indices`` with ``build_valid``), where the reference sorts them
with the real rows and grows the fan-out to their count (``P · capacity``
a shard) whenever a probe key equals theirs.  The joined rows are the
same; their slots within a probe row's fan-out, and the fan-out itself,
can differ.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..errors import CapacityError
from ..exec.join import _join_indices
from .collectives import ShardedTensor, max_to_host, shard, sum_to_host
from .shuffle import exchange, grown, hash_partition_ids, largest_bin


def _all_valid(keys: ShardedTensor) -> ShardedTensor:
    return keys.map(lambda t: torch.ones(t.shape, dtype=torch.bool, device=t.device))


def distributed_join(
    mesh,
    axis: str,
    probe_key,
    probe_payloads: Tuple,
    build_key,
    build_payloads: Tuple,
    probe_valid=None,
    build_valid=None,
    capacity_per_shard: int = 0,
    max_fanout: int = 1,
    on_overflow: str = "grow",
):
    """Inner equi-join of two tables sharded over ``axis``.

    Returns ``(key, probe_payloads', build_payloads', valid)`` as
    ``ShardedTensor``s of ``P · capacity · max_fanout`` rows a shard.
    ``capacity_per_shard`` bounds the rows one shard sends another
    (default: the side's rows / P² · 2, at least 64).  The bins' fill is
    read before the exchange and the fan-out after the local join: an
    overflow grows the capacity, or the fan-out, to the next power of two
    at or above the need and runs again (``"grow"``, the default; the
    reference's retries end at the same bin capacities), or raises
    :class:`CapacityError` (``"raise"``: probe bins, then build bins, then
    the fan-out, in the reference's order).  No row is lost silently; in a
    world every process grows or raises alike."""
    devs = mesh.axis_devices(axis)
    n_parts = mesh.axis_size(axis)
    pk = shard(mesh, axis, probe_key)
    bk = shard(mesh, axis, build_key)

    def default_cap(keys):  # the side's global rows / P² · 2
        return max((sum_to_host(len(keys), devs[0]) // n_parts // n_parts) * 2, 64)

    pcap = capacity_per_shard or default_cap(pk)
    bcap = capacity_per_shard or default_cap(bk)
    pv = _all_valid(pk) if probe_valid is None else shard(mesh, axis, probe_valid)
    bv = _all_valid(bk) if build_valid is None else shard(mesh, axis, build_valid)
    p_pays = [shard(mesh, axis, p).shards for p in probe_payloads]
    b_pays = [shard(mesh, axis, p).shards for p in build_payloads]
    p_parts = [hash_partition_ids(k, n_parts) for k in pk.shards]
    b_parts = [hash_partition_ids(k, n_parts) for k in bk.shards]
    pneed, bneed = largest_bin(devs, p_parts, n_parts), largest_bin(devs, b_parts, n_parts)
    if on_overflow == "raise":
        if pneed > pcap:
            raise CapacityError("join probe shuffle bin", pcap, pneed)
        if bneed > bcap:
            raise CapacityError("join build shuffle bin", bcap, bneed)
    pcap, bcap = grown(pneed, pcap), grown(bneed, bcap)

    def side(keys, pays, valid, parts, cap):
        per_shard, recv_valid = exchange(
            devs, [(k,) + tuple(p[s] for p in pays) + (valid.shards[s],)
                   for s, k in enumerate(keys.shards)], parts, n_parts, cap)
        return [(r[0], r[1:-1], rv & r[-1]) for r, rv in zip(per_shard, recv_valid)]

    probe = side(pk, p_pays, pv, p_parts, pcap)
    build = side(bk, b_pays, bv, b_parts, bcap)
    fanout = max_fanout
    while True:
        joined = [_join_indices(b[0], p[0], fanout, b[2]) for p, b in zip(probe, build)]
        frun = max_to_host([j[3] for j in joined], devs[0])
        if frun <= fanout:
            break
        if on_overflow == "raise":
            raise CapacityError("join fan-out", fanout, frun)
        fanout = grown(frun, fanout)
    keys, p_out, b_out, valid = [], [], [], []
    for (pk2, pp, pv2), (_bk2, bp, _bv2), (pi, bi, jvalid, _run) in zip(probe, build, joined):
        pi = pi.long()
        keys.append(pk2[pi])
        p_out.append(tuple(c[pi] for c in pp))
        b_out.append(tuple(c[bi] for c in bp))
        valid.append(jvalid & torch.repeat_interleave(pv2, fanout))
    return (ShardedTensor(keys),
            tuple(ShardedTensor(o[i] for o in p_out) for i in range(len(probe_payloads))),
            tuple(ShardedTensor(o[i] for o in b_out) for i in range(len(build_payloads))),
            ShardedTensor(valid))
