"""Sharded resident tables: the resident serving layer over the mesh.

Counterpart of ``strawboat_tpu/parallel/dist_resident.py``.  A resident
table's planes are packed so that tiled slot ``s`` holds row ``s``, so the
tile axis is a row axis: cutting every plane's leading (tile) dimension
into equal blocks gives each shard a contiguous row range, aligned across
columns and validity planes.  A query decodes every shard's planes through
kernel K1 at local shapes, one launch for all the shards on a device
(``ResidentTable._combine``: K1's output is already in slot order, so the
reference's ``_rows_to_t_major`` has no counterpart), reduces locally and
combines with one ``psum``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import NotYetImplementedError
from ..exec.aggregate import dense_group_sum, segment_reduce
from ..exec.resident import ResidentColumn, ResidentTable, _unpack_columns
from .collectives import psum

Bounds = Dict[str, Tuple[Optional[float], Optional[float]]]


@dataclass
class ShardedResidentColumn:
    """A resident column cut into shards: ``local[s]`` is shard ``s``'s
    ``ResidentColumn`` (its block of every plane and of the validity
    plane, and the dictionary on its device)."""

    name: str
    local: Tuple[ResidentColumn, ...]

    @property
    def dictionary_host(self):
        return self.local[0].dictionary_host


@dataclass
class ShardedResidentTable:
    columns: Dict[str, ShardedResidentColumn]
    num_rows: int
    tile: int
    mesh: object
    axis: str
    rows_per_shard: int  # slots a shard (whole tiles)

    def __getitem__(self, name: str) -> ShardedResidentColumn:
        return self.columns[name]


def shard_resident(rt: ResidentTable, mesh, axis: str) -> ShardedResidentTable:
    """Distribute a resident table's planes over ``mesh[axis]``: each plane
    pads with zero tiles to a multiple of the shard count (the padding
    rows fall past the row count) and shard ``s`` takes the ``s``-th block
    of tiles, on its device; dictionaries are copied to every shard's
    device.  A list column raises (its leaves lie on their own grid)."""
    devs = mesh.axis_devices(axis)
    n = len(devs)

    def blocks(wt3: torch.Tensor):
        pad = (-wt3.shape[0]) % n
        if pad:
            wt3 = torch.cat([wt3, wt3.new_zeros((pad,) + tuple(wt3.shape[1:]))])
        return [b.to(d) for b, d in zip(torch.chunk(wt3, n), devs)], wt3.shape[0]

    cols: Dict[str, ShardedResidentColumn] = {}
    total_tiles = 0
    for name, c in rt.columns.items():
        if c.kind == "list":
            raise NotYetImplementedError(
                f"shard_resident: list column {name!r} (leaf grid differs "
                "from the row grid; shard the flat columns)")
        planes = []
        for wt3, bits in c.planes:
            shards, total_tiles = blocks(wt3)
            planes.append([(w, bits) for w in shards])
        vp = [None] * n if c.validity_plane is None else blocks(c.validity_plane)[0]
        local = []
        for s, d in enumerate(devs):
            local.append(replace(
                c,
                planes=tuple(p[s] for p in planes),
                validity_plane=vp[s],
                dictionary=None if c.dictionary is None else c.dictionary.to(d),
            ))
        cols[name] = ShardedResidentColumn(name, tuple(local))
    rows_per_shard = (total_tiles // n) * 32 * rt.tile
    return ShardedResidentTable(cols, rt.num_rows, rt.tile, mesh, axis, rows_per_shard)


def _decode_shards(srt: ShardedResidentTable, names):
    """Every shard's planes and validity planes of ``names`` through K1 at
    local shapes, one call a device (the reference's per-shard Pallas
    calls): per shard, (each column's unpacked planes, each column's
    validity or None), as ``_unpack_columns`` gives them."""
    n_shards = len(srt.mesh.axis_devices(srt.axis))
    vals, valid = _unpack_columns(
        [srt.columns[n].local[s] for s in range(n_shards) for n in names])
    k = len(names)
    return [(vals[s * k : (s + 1) * k], valid[s * k : (s + 1) * k]) for s in range(n_shards)]


def _code_bounds(srt: ShardedResidentTable, predicates: Bounds, pcols):
    """Bound literals in code space for sorted-dictionary columns (host
    side, once a query), as plain numbers."""
    out = []
    for cname in pcols:
        lo, hi = predicates[cname]
        dh = srt.columns[cname].dictionary_host
        if dh is not None:
            lo = None if lo is None else int(np.searchsorted(dh, lo, "left"))
            hi = None if hi is None else int(np.searchsorted(dh, hi, "left"))
        out.append((cname, lo, hi))
    return out


def _local_inputs(srt, s: int, names, value_cols, code_cols, bounds, decoded):
    """Shard ``s``'s values (``value_cols``), codes (``code_cols``) and
    row mask from its ``decoded`` planes (``_decode_shards``): real rows
    (global slot below the row count), non-null in every read column,
    inside every bound."""
    dev = srt.mesh.axis_devices(srt.axis)[s]
    rows = s * srt.rows_per_shard + torch.arange(srt.rows_per_shard, dtype=torch.int64, device=dev)
    m = rows < srt.num_rows
    cols, codes = {}, {}
    for n, vals, valid in zip(names, *decoded):
        c = srt.columns[n].local[s]
        if n in value_cols:
            cols[n] = ResidentTable._combine(c, vals, True)
        if n in code_cols:
            codes[n] = ResidentTable._combine(c, vals, False)
        if valid is not None:
            m = m & valid
    for cname, lo, hi in bounds:
        if lo is not None:
            m = m & (codes[cname] >= lo)
        if hi is not None:
            m = m & (codes[cname] < hi)
    return cols, codes, m


def sharded_filter_sum(
    srt: ShardedResidentTable,
    predicates: Bounds,
    value: str,
    product_with: Optional[str] = None,
) -> torch.Tensor:
    """The Q6 shape over a sharded resident table: per shard, decode +
    code-space predicates + local sum, then one ``psum``.  Returns a 0-d
    int64 (float64 for float values) tensor on the first shard's
    device."""
    predicates = predicates or {}
    pcols = tuple(sorted(predicates))
    extra = (product_with,) if product_with else ()
    names = list(dict.fromkeys(pcols + (value,) + extra))
    bounds = _code_bounds(srt, predicates, pcols)
    devs = srt.mesh.axis_devices(srt.axis)
    partial = []
    decoded = _decode_shards(srt, names)
    for s in range(len(devs)):
        cols, _codes, m = _local_inputs(srt, s, names, {value, *extra}, set(pcols), bounds,
                                        decoded[s])
        acc = cols[value]
        if product_with is not None:
            acc = (acc if acc.is_floating_point() else acc.long()) * cols[product_with]
        dt = torch.float64 if acc.is_floating_point() else torch.int64
        partial.append(torch.where(m, acc, 0).sum(dtype=dt))
    return psum(partial, devs)[0]


def sharded_group_sum(
    srt: ShardedResidentTable,
    key: str,
    values: Sequence[str],
    num_groups: int,
    predicates: Optional[Bounds] = None,
):
    """Per-group sums + counts over a sharded resident table: each shard
    decodes its planes, groups by the key's codes (a sorted global
    dictionary is shared, so codes compare across shards), sums locally
    (``dense_group_sum``; float values and more than 4096 groups through
    ``segment_reduce``, as the reference switches) and one ``psum`` a
    result combines.  Integer sums are int64 (the reference's segment
    branch keeps a 32-bit column's width).  Returns ``((sums per value),
    counts)`` on the first shard's device."""
    predicates = predicates or {}
    pcols = tuple(sorted(predicates))
    names = list(dict.fromkeys((key,) + tuple(values) + pcols))
    bounds = _code_bounds(srt, predicates, pcols)
    devs = srt.mesh.axis_devices(srt.axis)
    sums = [[] for _ in values]
    counts = []
    decoded = _decode_shards(srt, names)
    for s in range(len(devs)):
        cols, codes, m = _local_inputs(srt, s, names, set(values), {key, *pcols}, bounds,
                                       decoded[s])
        k = codes[key].to(torch.int32)
        for i, vname in enumerate(values):
            vv = cols[vname]
            if vv.is_floating_point() or num_groups > 4096:
                if not vv.is_floating_point():
                    vv = vv.long()
                seg = torch.where(m, k, num_groups)
                part = segment_reduce(torch.where(m, vv, 0), seg, num_groups)
                cnt = segment_reduce(m.long(), seg, num_groups)
            else:
                part, cnt = dense_group_sum(k, vv.long(), num_groups, mask=m)
            sums[i].append(part)
            if i == 0:
                counts.append(cnt)
    outs = tuple(psum(p, devs)[0] for p in sums)
    return outs, (psum(counts, devs)[0] if counts else None)
