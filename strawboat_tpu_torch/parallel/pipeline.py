"""Chunked pipelined distributed aggregation.

Counterpart of ``strawboat_tpu/parallel/pipeline.py``.  The table streams
through in chunks; each chunk's local partial aggregate and keyed
exchange are issued before any result is read back, so on the card the
chunks queue one behind another as the reference's asynchronous
dispatches do (the required capacities stay device tensors until the end:
no host sync inside the chunk loop).  The partials land pre-partitioned by
key hash, so the final combine is one local grouped aggregate a shard over
the chunks' concatenated partials.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from ..errors import CapacityError, NotYetImplementedError
from .collectives import ShardedTensor, max_to_host, shard
from .dist_agg import combine, exchange_partials, local_partials


def pipelined_distributed_aggregate(
    mesh,
    axis: str,
    chunks: Iterable[Tuple[object, Dict[str, Tuple[str, object]], Optional[object]]],
    num_groups: int = 4096,
):
    """Aggregate a stream of ``(key, values, mask)`` chunks across the
    mesh (``values`` as in ``distributed_aggregate``; ``mask`` None keeps
    every row).  Every chunk is issued before any result is read.

    Chunks stream through once, so a capacity overflow cannot be retried:
    it raises :class:`CapacityError` (re-run with a larger
    ``num_groups``), in a world on every process alike.  An empty stream
    returns None."""
    devs = mesh.axis_devices(axis)
    n_parts = mesh.axis_size(axis)
    names = fns = None
    exchanged, needs = [], []
    for key, values, mask in chunks:
        if names is None:
            names = tuple(values)
            fns = tuple(values[n][0] for n in names)
        keys = shard(mesh, axis, key).shards
        cols = [shard(mesh, axis, values[n][1]).shards for n in names]
        masks = [torch.ones(k.shape, dtype=torch.bool, device=k.device) for k in keys] \
            if mask is None else shard(mesh, axis, mask).shards
        staged = [local_partials(k, tuple(c[s] for c in cols), masks[s], num_groups, fns,
                                 n_parts)
                  for s, k in enumerate(keys)]
        needs += [s[2] for s in staged]
        exchanged.append(exchange_partials(devs, staged, num_groups, n_parts))
    if names is None:
        return None
    final = []
    for d in range(len(devs)):
        keys = torch.cat([c[d][0] for c in exchanged])
        parts = tuple(torch.cat([c[d][1][i] for c in exchanged]) for i in range(len(names)))
        valid = torch.cat([c[d][2] for c in exchanged])
        final.append(combine(keys, parts, valid, num_groups, fns))
    need = max_to_host(needs + [f[3] for f in final], devs[0])
    if need > num_groups:
        raise CapacityError("pipelined aggregate groups", num_groups, need)
    result = {"keys": ShardedTensor(f[0] for f in final),
              "valid": ShardedTensor(f[2] for f in final)}
    for i, name in enumerate(names):
        result[name] = ShardedTensor(f[1][i] for f in final)
    return result


def streamed_dataset_aggregate(
    mesh,
    axis: str,
    paths,
    key: str,
    aggs: Dict[str, Tuple[str, str]],
    chunk_pages: int = 64,
    num_groups: int = 4096,
    predicates: Optional[Sequence] = None,
):
    """A (multi-file) dataset streamed through the pipelined distributed
    aggregate without holding the whole table: ``aggs`` is {out_name:
    (fn, column)} over numeric columns, ``key`` a numeric column; parts
    and pages that ``predicates`` rule out by their zones are skipped
    (the predicates prune; they filter no row).  Chunks decode on the
    mesh's first device; in a world every process decodes every chunk and
    keeps its shards of it."""
    return pipelined_distributed_aggregate(
        mesh, axis,
        prepared_dataset_chunks(mesh, axis, paths, key, aggs, chunk_pages, predicates),
        num_groups,
    )


def prepared_dataset_chunks(
    mesh,
    axis: str,
    paths,
    key: str,
    aggs: Dict[str, Tuple[str, str]],
    chunk_pages: int = 64,
    predicates: Optional[Sequence] = None,
):
    """The feed of :func:`streamed_dataset_aggregate` on its own: each
    chunk of ``iter_dataset_chunks`` padded to a multiple of the shard
    count and split over the mesh, as ``(key, values, mask)`` ready for
    :func:`pipelined_distributed_aggregate` (the mask drops the padding
    and null rows).  A dictionary-coded key raises: chunks' dictionaries
    are not comparable."""
    from ..exec.dataset import iter_dataset_chunks

    devs = mesh.axis_devices(axis)
    n_shards = mesh.axis_size(axis)
    cols = sorted({key} | {c for (_fn, c) in aggs.values()})
    for chunk in iter_dataset_chunks(paths, chunk_pages, devs[0], columns=cols,
                                     predicates=predicates):
        kc = chunk[key]
        if kc.dictionary is not None:
            raise NotYetImplementedError(
                "streamed aggregate over dictionary-coded keys "
                "(per-chunk dictionaries are not comparable)")
        n = chunk.num_rows
        padded = -(-max(n, 1) // n_shards) * n_shards

        def put(c):
            v = c.values
            if padded != v.shape[0]:
                v = torch.cat([v, v.new_zeros(padded - v.shape[0])])
            return shard(mesh, axis, v)

        mask = torch.arange(padded, device=devs[0]) < n
        for c in cols:
            if chunk[c].validity is not None:
                mask[:n] &= chunk[c].validity
        yield (put(kc), {name: (fn, put(chunk[c])) for name, (fn, c) in aggs.items()},
               shard(mesh, axis, mask))
