"""Distributed partitioned file scan (BASELINE config 5's front half).

Counterpart of ``strawboat_tpu/parallel/dist_scan.py``.  Each shard owns
a contiguous page range of the row-aligned page grid and decodes only its
pages, onto its own device, through the port's scan (the page-keep mask of
``decode_column_pages_device``: kernel K3 on BITPACK and DICT pages).
Rows are padded to the largest shard, and a ``__valid__`` column marks the
real ones.

String columns ride as dictionary codes against ONE global dictionary:
the shards' small dictionaries merge on the host, each value once in
order of first appearance (``exec/dataset.py`` ``_merge_dictionaries``, the
counterpart of the reference's ``pyarrow.compute`` merge), and each
shard's codes remap through one gather on its device.  Rows never move
to the host.  Nested columns raise, as in the reference.

In a world of processes (``mesh.py``) each process decodes only its own
shards' pages, and one ``all_gather_object`` a scan brings every shard's
row count and dictionaries to every process (the reference's "host-level
allgather of dictionaries at plan time"), so each process pads to the
same length and holds the same global dictionaries.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_device
from ..errors import NotYetImplementedError, OutOfSpecError
from ..exec.dataset import _merge_dictionaries, _remap_codes
from ..exec.scan import DeviceColumn, DeviceTable, _open, decode_column_pages_device
from .collectives import ShardedTensor, gather_objects


def shard_page_ranges(n_pages: int, n_shards: int) -> List[range]:
    """Contiguous page ranges per shard (balanced)."""
    base = n_pages // n_shards
    extra = n_pages % n_shards
    out = []
    start = 0
    for s in range(n_shards):
        ln = base + (1 if s < extra else 0)
        out.append(range(start, start + ln))
        start += ln
    return out


def _flat_fields(schema, columns):
    """(index of the first leaf, field) of each selected column; a nested
    one raises."""
    i = 0
    for field in schema:
        first = i
        i += field.n_leaves
        if columns is not None and field.name not in columns:
            continue
        if field.is_nested:
            raise NotYetImplementedError(
                f"distributed scan of nested column {field.name!r}; "
                "select columns=... to exclude it")
        yield first, field


def _keep(n_pages: int, rng: range) -> np.ndarray:
    keep = np.zeros(n_pages, dtype=bool)
    keep[rng.start : rng.stop] = True
    return keep


def _sharded_table(decoded: Dict[str, Tuple], mesh, devs) -> DeviceTable:
    """Decoded pieces → a DeviceTable of ShardedTensor columns.

    ``decoded``: name → (field, per local shard the list of its decoded
    ``DeviceColumn`` pieces).  Each shard's pieces concatenate; string
    pieces' codes remap into the global dictionary of every piece of every
    shard in shard order; every shard pads to the largest, and
    ``__valid__`` marks the real rows.  One :func:`gather_objects` brings
    the other processes' row counts, dictionaries and dtypes."""
    first = next(iter(decoded.values()), (None, [[] for _ in devs]))[1]
    rows = [sum(len(c) for c in cols) for cols in first]
    meta = {name: (next((c.values.dtype for cols in pieces for c in cols), None),
                   any(c.validity is not None for cols in pieces for c in cols),
                   [np.array([], dtype=object) if c.dictionary is None else c.dictionary
                    for cols in pieces for c in cols] if field.is_flat_string else None)
            for name, (field, pieces) in decoded.items()}
    everyone = gather_objects((rows, meta))
    rank = mesh.first_shard // len(devs)
    all_rows = [r for e in everyone for r in e[0]]
    max_rows = max(all_rows) if all_rows else 0

    def pad(t: torch.Tensor, fill) -> torch.Tensor:
        if t.shape[0] == max_rows:
            return t
        return torch.cat([t, torch.full((max_rows - t.shape[0],), fill, dtype=t.dtype,
                                         device=t.device)])

    out: Dict[str, DeviceColumn] = {}
    for name, (field, pieces) in decoded.items():
        flat = [c for cols in pieces for c in cols]
        dictionary, flat_vals = None, [c.values for c in flat]
        dtype = next((e[1][name][0] for e in everyone if e[1][name][0] is not None), torch.int64)
        if field.is_flat_string:
            dicts = [e[1][name][2] for e in everyone]
            dictionary, tables = _merge_dictionaries([d for ds in dicts for d in ds])
            base = sum(len(ds) for ds in dicts[:rank])
            flat_vals = [_remap_codes(c.values, t)
                         for c, t in zip(flat, tables[base : base + len(flat)])]
            dtype = torch.int32  # the translation tables' type
        vals, valid, k = [], [], 0
        for d, cols in zip(devs, pieces):
            mine = flat_vals[k : k + len(cols)]
            k += len(cols)
            v = torch.cat(mine) if mine else torch.zeros(0, dtype=dtype, device=d)
            vals.append(pad(v, 0))
            if any(e[1][name][1] for e in everyone):  # some shard of the mesh has nulls
                valid.append(pad(torch.cat([
                    torch.ones(len(c), dtype=torch.bool, device=d) if c.validity is None
                    else c.validity for c in cols]) if cols
                    else torch.zeros(0, dtype=torch.bool, device=d), False))
        out[name] = DeviceColumn(name, field.dtype, ShardedTensor(vals),
                                 ShardedTensor(valid) if valid else None, dictionary=dictionary)
    out["__valid__"] = DeviceColumn("__valid__", "bool", ShardedTensor(
        torch.arange(max_rows, device=d) < r for d, r in zip(devs, rows)))
    return DeviceTable(out, len(all_rows) * max_rows)


def distributed_scan(
    path: str,
    mesh,
    axis: str = "shards",
    columns: Optional[Sequence[str]] = None,
) -> DeviceTable:
    """Scan a file with its pages partitioned across the mesh axis: shard
    ``s`` decodes its page range onto its device (in a world, only this
    process's shards).  Columns are ``ShardedTensor``s padded to the
    largest shard; ``__valid__`` marks the real rows, nullable columns
    carry their validity alike.  ``num_rows`` counts every shard's padded
    rows."""
    devs = mesh.axis_devices(axis)
    schema, metas, file_bytes = _open(path)
    n_pages = max(len(m.pages) for m in metas)
    first = mesh.first_shard
    ranges = shard_page_ranges(n_pages, mesh.axis_size(axis))[first : first + len(devs)]
    decoded: Dict[str, Tuple] = {}
    for leaf, field in _flat_fields(schema, columns):
        meta = metas[leaf]
        decoded[field.name] = (field, [
            [decode_column_pages_device(file_bytes, meta, field, d, _keep(len(meta.pages), r))]
            for d, r in zip(devs, ranges)])
    return _sharded_table(decoded, mesh, devs)


def local_shard_table(
    path: str,
    process_index: int,
    process_count: int,
    device,
    columns: Optional[Sequence[str]] = None,
):
    """One process's share of a file: decode ONLY its page range onto
    ``device``.  Returns ``(DeviceTable, {string column: local
    dictionary})``; the dictionaries merge with ``_merge_dictionaries``
    before any keyed exchange."""
    dev = as_device(device)
    schema, metas, file_bytes = _open(path)
    n_pages = max(len(m.pages) for m in metas)
    rng = shard_page_ranges(n_pages, process_count)[process_index]
    out: Dict[str, DeviceColumn] = {}
    local_dicts = {}
    num_rows = 0
    for leaf, field in _flat_fields(schema, columns):
        meta = metas[leaf]
        col = decode_column_pages_device(file_bytes, meta, field, dev, _keep(len(meta.pages), rng))
        if col.dictionary is not None:
            local_dicts[field.name] = col.dictionary
        out[field.name] = col
        num_rows = len(col)
    return DeviceTable(out, num_rows), local_dicts


def _dataset_units(paths: Sequence[str], n_shards: int):
    """A dataset split into at least ``n_shards`` (path, page range) work
    units: whole files when there are enough, otherwise each file cut
    into contiguous page ranges.  Returns (units, {path: (schema, metas,
    file bytes)}, schema)."""
    opened = {}
    schema = None
    for p in paths:
        opened[p] = _open(p)
        s = opened[p][0]
        if schema is None:
            schema = s
        elif [f.name for f in s] != [f.name for f in schema]:
            raise OutOfSpecError(f"dataset files disagree on schema: {p} vs {paths[0]}")
    per_file = max(1, -(-n_shards // len(paths)))
    units = []
    for p in paths:
        n_pages = max(len(m.pages) for m in opened[p][1])
        for r in shard_page_ranges(n_pages, min(per_file, n_pages) or 1):
            if r.stop > r.start:
                units.append((p, r))
    return units, opened, schema


def _assign_units(units, opened, n_shards: int) -> List[List[int]]:
    """Greedy balance: the next-largest unit onto the least-loaded shard;
    each shard keeps its units in file and page order."""
    unit_rows = [sum(pg.num_values for pg in opened[p][1][0].pages[r.start : r.stop])
                 for p, r in units]
    heap = [(0, s) for s in range(n_shards)]
    heapq.heapify(heap)
    assign: List[List[int]] = [[] for _ in range(n_shards)]
    for i in sorted(range(len(units)), key=lambda i: -unit_rows[i]):
        load, s = heapq.heappop(heap)
        assign[s].append(i)
        heapq.heappush(heap, (load + unit_rows[i], s))
    for lst in assign:
        lst.sort()
    return assign


def distributed_scan_dataset(
    paths: Sequence[str],
    mesh,
    axis: str = "shards",
    columns: Optional[Sequence[str]] = None,
) -> DeviceTable:
    """A multi-file dataset scanned with (path, page range) units
    partitioned over the mesh: units pack greedily onto shards by row
    count, each shard decodes and concatenates its units on its device
    (in a world, only this process's shards), and string dictionaries
    merge over every unit, so codes compare across the whole dataset.  The
    output is :func:`distributed_scan`'s."""
    paths = list(paths)
    devs = mesh.axis_devices(axis)
    n_shards = mesh.axis_size(axis)
    units, opened, schema = _dataset_units(paths, n_shards)
    assign = _assign_units(units, opened, n_shards)[mesh.first_shard : mesh.first_shard
                                                     + len(devs)]
    decoded: Dict[str, Tuple] = {}
    for leaf, field in _flat_fields(schema, columns):
        pieces = []  # per local shard: its units' columns
        for d, unit_ids in zip(devs, assign):
            cols = []
            for ui in unit_ids:
                p, r = units[ui]
                _s, metas, file_bytes = opened[p]
                meta = metas[leaf]
                cols.append(decode_column_pages_device(file_bytes, meta, field, d,
                                                       _keep(len(meta.pages), r)))
            pieces.append(cols)
        decoded[field.name] = (field, pieces)
    return _sharded_table(decoded, mesh, devs)
