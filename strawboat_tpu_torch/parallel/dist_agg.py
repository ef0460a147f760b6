"""Distributed hash aggregate: local partials → keyed exchange → final.

Counterpart of ``strawboat_tpu/parallel/dist_agg.py`` (BASELINE config 5:
hash-partitioned scan → shuffle → hash aggregate).  Each shard
pre-aggregates its rows with the port's ``grouped_aggregate``, the
``num_groups`` partial slots of every shard are repartitioned by key hash
(one all_to_all a payload), and each shard combines the partials it owns.
The exchange moves ``P · num_groups`` slots a shard, not the rows.

Where the key is a dense slot id of a known span (an integer column's
value less its lowest, or a dictionary code), the stages take no sort
(:func:`dense_partials`, :func:`exchange_dense`, :func:`combine_dense`):
each shard adds its rows into every slot of the span, shard ``d`` owns
the ``d``-th contiguous range of slots, and combining is an elementwise
sum of the ranges it receives; nothing in them waits on the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..errors import CapacityError
from ..exec.aggregate import grouped_aggregate
from .collectives import ShardedTensor, all_to_all, max_to_host, shard
from .shuffle import exchange, grown, hash_partition_ids

_COMBINE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def _slot_keys(key: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """Each slot's key, read at its representative row (clipped, as the
    reference reads it)."""
    return key[rep.long().clamp(0, max(key.shape[0] - 1, 0))]


def local_partials(key, cols, mask, num_groups: int, fns: Tuple[str, ...], n_parts: int):
    """One shard's stage 1: its partial groups as exchange payloads
    ``(slot keys, aggregates..., slot valid)``, each slot's destination
    and the shard's group count (a 0-d tensor)."""
    specs = tuple((fn, i) for i, fn in enumerate(fns))
    _u, n_grp, rep, outs = grouped_aggregate((key,), cols, mask, num_groups, specs)
    pvalid = torch.arange(num_groups, device=key.device) < n_grp
    pkeys = _slot_keys(key, rep)
    return (pkeys,) + tuple(outs) + (pvalid,), hash_partition_ids(pkeys, n_parts), n_grp


def combine(keys, partials, valid, num_groups: int, fns: Tuple[str, ...]):
    """One shard's final stage over the partials it received: ``(keys,
    aggregates, valid, group count)``."""
    specs = tuple((_COMBINE[fn], i) for i, fn in enumerate(fns))
    _u, n2, rep, outs = grouped_aggregate((keys,), partials, valid, num_groups, specs)
    fvalid = torch.arange(num_groups, device=keys.device) < n2
    return _slot_keys(keys, rep), tuple(outs), fvalid, n2


def exchange_partials(devs, staged, num_groups: int, n_parts: int):
    """Stage 2: every shard's partial slots to their owners among the
    ``n_parts`` shards; per local shard ``(keys, partials, valid)`` of
    ``P · num_groups`` slots."""
    per_shard, recv_valid = exchange(devs, [s[0] for s in staged], [s[1] for s in staged],
                                     n_parts, num_groups)
    out = []
    for r, rv in zip(per_shard, recv_valid):
        out.append((r[0], r[1:-1], rv & r[-1]))
    return out


def dense_partials(slot, cols, mask, slots: int):
    """One shard's stage 1 over dense slot ids ``slot`` (int32 or int64,
    every id in ``[0, slots)``; fewer than 2^31 rows): each slot's sum of each of ``cols`` over the rows
    ``mask`` keeps (all where None; int64, float64 for float values, the
    float ones added in arrival order) and its row count, by one
    ``index_add_`` each.  Returns the payloads, one ``(columns, slots)``
    tensor a dtype, and where each of ``cols`` and the count landed: a
    ``(payload, row)`` pair each, the count's last."""
    dev = slot.device
    sums = []
    for v in cols:
        v = v.to(torch.float64 if v.is_floating_point() else torch.int64)
        if mask is not None:
            v = torch.where(mask, v, torch.zeros((), dtype=v.dtype, device=dev))
        sums.append(torch.zeros(slots, dtype=v.dtype, device=dev).index_add_(0, slot, v))
    # a shard's rows count in int32 (half the bytes of a row's 1), widened a slot
    ones = (torch.ones(slot.shape, dtype=torch.int32, device=dev) if mask is None
            else mask.to(torch.int32))
    sums.append(torch.zeros(slots, dtype=torch.int32, device=dev).index_add_(0, slot, ones)
                .to(torch.int64))
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(sums):
        by_dtype.setdefault(t.dtype, []).append(i)
    where = [None] * len(sums)
    for p, idx in enumerate(by_dtype.values()):
        for r, i in enumerate(idx):
            where[i] = (p, r)
    return [torch.stack([sums[i] for i in idx]) for idx in by_dtype.values()], where


def exchange_dense(devs, payloads_by_shard, n_parts: int):
    """Stage 2 of the dense stages: shard ``d`` receives the ``d``-th of
    ``n_parts`` equal ranges of every shard's slots, one all_to_all a
    payload.  Per local shard, each payload's ``(n_parts, slots /
    n_parts, columns)`` ranges in source order."""
    out = [[] for _ in payloads_by_shard]
    for j in range(len(payloads_by_shard[0])):
        bins = []
        for pays in payloads_by_shard:
            k, slots = pays[j].shape
            bins.append(pays[j].view(k, n_parts, slots // n_parts).permute(1, 2, 0).contiguous())
        for s, r in enumerate(all_to_all(bins, devs)):
            out[s].append(r.view((n_parts, -1) + tuple(r.shape[1:])))
    return out


def combine_dense(received, where):
    """One shard's final stage over its received ranges: the sums of the
    columns and the count of every slot it owns, in the order of
    :func:`dense_partials`' ``where`` (the count last)."""
    tot = [r.sum(0) for r in received]
    return [tot[p][:, r] for p, r in where]


def distributed_aggregate(
    mesh,
    axis: str,
    key,
    values: Dict[str, Tuple[str, object]],
    mask=None,
    num_groups: int = 4096,
    on_overflow: str = "grow",
):
    """Group ``key`` rows sharded over ``axis``; returns per-shard final
    ``{"keys", "valid", <name>...}`` as ``ShardedTensor``s of
    ``num_groups`` slots a shard, globally partitioned by key hash.

    ``values``: out_name → (fn, sharded values), fn in {sum, count, min,
    max}.  More groups than ``num_groups`` on any shard, before or after
    the exchange, never pass silently: ``"grow"`` (default) re-runs at the
    next power of two at or above the need, ``"raise"`` raises
    :class:`CapacityError`; in a world every process grows or raises
    alike."""
    devs = mesh.axis_devices(axis)
    n_parts = mesh.axis_size(axis)
    names = tuple(values)
    fns = tuple(values[n][0] for n in names)
    keys = shard(mesh, axis, key).shards
    cols = [shard(mesh, axis, values[n][1]).shards for n in names]
    masks = None if mask is None else shard(mesh, axis, mask).shards
    cap = num_groups
    while True:
        staged = [local_partials(k, tuple(c[s] for c in cols), None if masks is None else masks[s],
                                 cap, fns, n_parts)
                  for s, k in enumerate(keys)]
        final = [combine(k2, parts, valid, cap, fns)
                 for k2, parts, valid in exchange_partials(devs, staged, cap, n_parts)]
        need = max_to_host([s[2] for s in staged] + [f[3] for f in final], devs[0])
        if need <= cap:
            break
        if on_overflow == "raise":
            raise CapacityError("distributed aggregate groups", cap, need)
        cap = grown(need, cap)
    result = {"keys": ShardedTensor(f[0] for f in final),
              "valid": ShardedTensor(f[2] for f in final)}
    for i, name in enumerate(names):
        result[name] = ShardedTensor(f[1][i] for f in final)
    return result


