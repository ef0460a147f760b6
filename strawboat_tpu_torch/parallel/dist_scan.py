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
from .collectives import ShardedTensor


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


def _global_codes(pieces: List[DeviceColumn]):
    """The pieces' dictionaries merged into one, and each piece's codes
    remapped into it on its device."""
    gdict, tables = _merge_dictionaries(
        [np.array([], dtype=object) if c.dictionary is None else c.dictionary for c in pieces])
    return gdict, [_remap_codes(c.values, t) for c, t in zip(pieces, tables)]


def _padded_table(per_shard: Dict[str, Tuple], rows_per_shard: List[int], devs) -> DeviceTable:
    """Per-shard column values → a DeviceTable of ShardedTensor columns,
    every shard padded to the largest, plus ``__valid__``.

    ``per_shard``: name → (field, values per shard, validity per shard or
    None, dictionary or None)."""
    max_rows = max(rows_per_shard) if rows_per_shard else 0

    def pad(t: torch.Tensor, fill) -> torch.Tensor:
        if t.shape[0] == max_rows:
            return t
        return torch.cat([t, torch.full((max_rows - t.shape[0],), fill, dtype=t.dtype,
                                         device=t.device)])

    out: Dict[str, DeviceColumn] = {}
    for name, (field, vals, valid, dictionary) in per_shard.items():
        validity = None
        if any(v is not None for v in valid):
            validity = ShardedTensor(
                pad(torch.ones(len(x), dtype=torch.bool, device=x.device) if v is None else v,
                    False) for x, v in zip(vals, valid))
        out[name] = DeviceColumn(name, field.dtype, ShardedTensor(pad(v, 0) for v in vals),
                                 validity, dictionary=dictionary)
    out["__valid__"] = DeviceColumn("__valid__", "bool", ShardedTensor(
        torch.arange(max_rows, device=d) < r for d, r in zip(devs, rows_per_shard)))
    return DeviceTable(out, len(devs) * max_rows)


def distributed_scan(
    path: str,
    mesh,
    axis: str = "shards",
    columns: Optional[Sequence[str]] = None,
) -> DeviceTable:
    """Scan a file with its pages partitioned across the mesh axis: shard
    ``s`` decodes its page range onto its device.  Columns are
    ``ShardedTensor``s padded to the largest shard; ``__valid__`` marks the
    real rows, nullable columns carry their validity alike."""
    devs = mesh.axis_devices(axis)
    schema, metas, file_bytes = _open(path)
    n_pages = max(len(m.pages) for m in metas)
    ranges = shard_page_ranges(n_pages, len(devs))
    per_shard: Dict[str, Tuple] = {}
    rows: List[int] = []
    for leaf, field in _flat_fields(schema, columns):
        meta = metas[leaf]
        pieces = [decode_column_pages_device(file_bytes, meta, field, d, _keep(len(meta.pages), r))
                  for d, r in zip(devs, ranges)]
        rows = rows or [len(c) for c in pieces]
        dictionary, vals = None, [c.values for c in pieces]
        if field.is_flat_string:
            dictionary, vals = _global_codes(pieces)
        per_shard[field.name] = (field, vals, [c.validity for c in pieces], dictionary)
    return _padded_table(per_shard, rows, devs)


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
    count, each shard decodes and concatenates its units on its device,
    and string dictionaries merge over every unit, so codes compare across
    the whole dataset.  The output is :func:`distributed_scan`'s."""
    paths = list(paths)
    devs = mesh.axis_devices(axis)
    units, opened, schema = _dataset_units(paths, len(devs))
    assign = _assign_units(units, opened, len(devs))
    per_shard: Dict[str, Tuple] = {}
    rows: List[int] = []
    for leaf, field in _flat_fields(schema, columns):
        pieces = []  # per shard: its units' columns
        for d, unit_ids in zip(devs, assign):
            cols = []
            for ui in unit_ids:
                p, r = units[ui]
                _s, metas, file_bytes = opened[p]
                meta = metas[leaf]
                cols.append(decode_column_pages_device(file_bytes, meta, field, d,
                                                       _keep(len(meta.pages), r)))
            pieces.append(cols)
        flat = [c for cols in pieces for c in cols]
        dictionary, flat_vals = None, [c.values for c in flat]
        if field.is_flat_string:
            dictionary, flat_vals = _global_codes(flat)
        empty_dtype = flat_vals[0].dtype if flat_vals else torch.int64
        vals, valid, k = [], [], 0
        for d, cols in zip(devs, pieces):
            mine = flat_vals[k : k + len(cols)]
            k += len(cols)
            vals.append(torch.cat(mine) if mine else torch.zeros(0, dtype=empty_dtype, device=d))
            valid.append(torch.cat([
                torch.ones(len(c), dtype=torch.bool, device=d) if c.validity is None
                else c.validity for c in cols])
                if any(c.validity is not None for c in cols) else None)
        rows = rows or [len(v) for v in vals]
        per_shard[field.name] = (field, vals, valid, dictionary)
    return _padded_table(per_shard, rows, devs)
