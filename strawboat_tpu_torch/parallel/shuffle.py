"""Distributed shuffle: keyed repartition over the mesh by all_to_all.

Counterpart of ``strawboat_tpu/parallel/shuffle.py``.  Rows are bucketed
by ``hash(key) % P`` into fixed-capacity per-destination bins, exchanged
with :func:`collectives.all_to_all` and masked on arrival.  Skew handling:
``salt`` spreads a hot key over ``salt`` destination buckets.

The reference hashes in uint64; torch has no unsigned 64-bit arithmetic,
so the hash runs on int64 holding the same bits (``device.py``): the
multiplies and the salt add wrap mod 2^64 alike, right shifts are masked
to be logical, and the modulo is taken as unsigned through the word's
32-bit halves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import u64_to_i64
from ..errors import CapacityError
from .collectives import ShardedTensor, all_to_all, max_to_host, shard

_M1 = u64_to_i64(0xBF58476D1CE4E5B9)
_M2 = u64_to_i64(0x94D049BB133111EB)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer of the key's 64-bit image (sign-extended, as
    the reference's ``astype(uint64)``), as int64 bits."""
    x = x.to(torch.int64)
    x = (x ^ ((x >> 30) & ((1 << 34) - 1))) * _M1
    x = (x ^ ((x >> 27) & ((1 << 37) - 1))) * _M2
    return x ^ ((x >> 31) & ((1 << 33) - 1))


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h mod n`` of int64-held u64 words: ``(hi·2^32 + lo) mod n`` from
    the halves, with every step below 2^63."""
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo) % n


def hash_partition_ids(
    key: torch.Tensor, n_parts: int, salt: int = 0, salt_key: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Destination shard per row (int32); ``salt > 0`` spreads each key
    over ``salt`` buckets by a per-row salt stream: ``salt_key``, or the
    row's index within the shard."""
    h = _mix64(key)
    if salt > 0:
        s = salt_key if salt_key is not None else torch.arange(
            key.shape[0], dtype=torch.int64, device=key.device)
        h = h + _umod(s.to(torch.int64), salt)
    return _umod(h, n_parts).to(torch.int32)


def largest_bin(devices, part_by_shard, n_parts: int) -> int:
    """The most rows any shard sends any of the ``n_parts`` destinations,
    read before a bin is built (agreed over the world's processes)."""
    counts = []
    for part in part_by_shard:
        c = torch.zeros(n_parts, dtype=torch.int64, device=part.device)
        counts.append(c.index_add_(0, part.long(), torch.ones_like(part, dtype=torch.int64)).max())
    return max_to_host(counts, devices[0])


def build_send_bins(
    part_ids: torch.Tensor, payloads: Tuple[torch.Tensor, ...], n_parts: int, capacity: int
):
    """Pack rows into ``(n_parts, capacity)`` bins + per-bin counts.

    Rows keep their order within a bin (a stable sort by destination, as
    the reference's ``jnp.argsort``).  Rows beyond a bin's capacity go to
    a trash slot past the bins instead of colliding in the last one;
    ``counts`` report the true totals, so the caller sees the overflow
    and grows or raises before it uses a bin."""
    n = part_ids.shape[0]
    dev = part_ids.device
    order = torch.argsort(part_ids, stable=True)
    sorted_parts = part_ids[order].long()
    bounds = torch.searchsorted(sorted_parts, torch.arange(n_parts + 1, device=dev))
    counts = bounds[1:] - bounds[:-1]
    slot = torch.arange(n, device=dev) - bounds[:-1][sorted_parts]
    ok = slot < capacity
    flat = torch.where(ok, sorted_parts * capacity + slot, n_parts * capacity)
    bins = []
    for p in payloads:
        buf = torch.zeros(n_parts * capacity + 1, dtype=p.dtype, device=dev)
        buf[flat] = p[order]
        bins.append(buf[:-1].view(n_parts, capacity))
    valid = torch.zeros(n_parts * capacity + 1, dtype=torch.bool, device=dev)
    valid[flat] = ok
    return bins, valid[:-1].view(n_parts, capacity), counts


def grown(required: int, capacity: int) -> int:
    """The capacity a retry takes: the next power of two at or above
    ``required`` (the reference's growth rule)."""
    return capacity if required <= capacity else 1 << (required - 1).bit_length()


def exchange(devices, payloads_by_shard, part_by_shard, n_parts: int, capacity: int):
    """Bin every local shard's payloads by destination and run one
    all_to_all a payload: ``(received payloads per local shard, received
    bin validity per local shard)``, each flat ``(n_parts * capacity,)``."""
    sent = [build_send_bins(part, pays, n_parts, capacity)
            for part, pays in zip(part_by_shard, payloads_by_shard)]
    n_pay = len(payloads_by_shard[0])
    recv = [all_to_all([b[0][i] for b in sent], devices) for i in range(n_pay)]
    recv_valid = all_to_all([b[1] for b in sent], devices)
    per_shard = [tuple(recv[i][d] for i in range(n_pay)) for d in range(len(devices))]
    return per_shard, recv_valid


def shuffle_by_key(
    mesh,
    axis: str,
    key,
    payloads: Tuple,
    capacity: int,
    salt: int = 0,
    on_overflow: str = "grow",
):
    """All-to-all repartition of rows by key hash across ``axis``.

    ``key`` and ``payloads`` are sharded over ``axis`` (a
    ``ShardedTensor``, or a global tensor cut into equal shards).  Returns
    ``(key', payloads', valid')`` as ``ShardedTensor``s of ``P * capacity``
    rows a shard, so that equal keys land on the same shard.

    The bins' fill is known before they are built: a bin overflow (more
    rows to one destination than ``capacity``) grows the capacity to the
    next power of two at or above the largest bin (``"grow"``, the
    default; the reference's retry ends at the same capacity) or raises
    :class:`CapacityError` with the required capacity (``"raise"``)."""
    devs = mesh.axis_devices(axis)
    n_parts = mesh.axis_size(axis)
    keys = shard(mesh, axis, key).shards
    pays = [shard(mesh, axis, p).shards for p in payloads]
    parts = [hash_partition_ids(k, n_parts, salt=salt) for k in keys]
    required = largest_bin(devs, parts, n_parts)
    if required > capacity and on_overflow == "raise":
        raise CapacityError("shuffle bin", capacity, required)
    cap = grown(required, capacity)
    per_shard, valid = exchange(
        devs, [(k,) + tuple(p[s] for p in pays) for s, k in enumerate(keys)], parts, n_parts, cap)
    out_key = ShardedTensor(r[0] for r in per_shard)
    outs = tuple(ShardedTensor(r[i] for r in per_shard) for i in range(1, 1 + len(payloads)))
    return out_key, outs, ShardedTensor(valid)
