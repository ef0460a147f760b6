"""Multi-file datasets: many strawboat files scanned as one device table.

Counterpart of ``strawboat_tpu/exec/dataset.py``.  A table is many
immutable part files (Databend's layout); this module scans, streams,
plans, writes and compacts them together:

* file-level pruning reads only a part's footer and zone block
  (:func:`file_may_match`, through ``pruning.read_zones`` /
  ``prune_pages``): a part whose zones show no page can match is skipped
  whole;
* the surviving parts scan with page pruning (``scan_file``) and each
  column concatenates on the device, one ``torch.cat`` a column;
* dictionary columns merge their parts' dictionaries on the host (the
  pooled dictionaries, each distinct value once in order of first
  appearance: :func:`_merge_dictionaries`) and remap each part's codes
  with one device gather;
* a manifest (:func:`dataset_manifest`) keeps each part's row count and
  file-level zone fold, so a planner prunes parts with no file read.
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import as_device
from ..errors import NotYetImplementedError, OutOfSpecError
from .pruning import check_predicates, prune_pages, read_zones
from .scan import DeviceColumn, DeviceListColumn, DeviceTable, scan_chunks, scan_file
from .scan import _merge_dictionaries as merge_page_dictionaries

Paths = Union[str, Sequence[str]]


def resolve_paths(paths: Paths) -> List[str]:
    """A glob → its matches, sorted; an explicit list keeps its order.  An
    empty match or list raises."""
    if isinstance(paths, str):
        out = sorted(_glob.glob(paths))
        if not out:
            raise OutOfSpecError(f"dataset glob matched no files: {paths!r}")
        return out
    out = list(paths)
    if not out:
        raise OutOfSpecError("dataset file list is empty")
    return out


def file_may_match(path: str, predicates: Optional[Sequence]) -> bool:
    """Whether any page of ``path`` may satisfy ``predicates``, from the
    footer and the zone block alone; a file without zones may."""
    if not predicates:
        return True
    predicates = check_predicates(predicates)
    zones = read_zones(path)
    if not zones:
        return True
    n_pages = max(len(z.pages) for z in zones.values())
    return bool(prune_pages(zones, predicates, n_pages).any())


def _merge_dictionaries(dicts: Sequence[np.ndarray]) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The global dictionary of the parts' dictionaries and each part's
    int32 code translation table into it.

    The pool is the parts' dictionaries in order, as ``bytes`` (a resident
    table's utf8 dictionary holds ``str``: its utf8 bytes); the global
    dictionary keeps each distinct value once, in order of first
    appearance in the pool, as the reference's ``pc.unique`` over its
    binary pool does (JAX ``parallel/dist_scan.py:79``), and as the scan
    merges its pages' dictionaries.  Only the dictionaries are touched,
    never the rows."""
    gdict, remap, bases = merge_page_dictionaries(
        [[v.encode() if isinstance(v, str) else bytes(v) for v in d] for d in dicts])
    remap = remap.astype(np.int32)
    return gdict, [remap[bases[i] : bases[i + 1]] for i in range(len(dicts))]


def _concat_validity(parts: List[DeviceColumn]) -> Optional[torch.Tensor]:
    """The parts' validities concatenated, or None when every part is all
    valid."""
    if all(p.validity is None for p in parts):
        return None
    return torch.cat([
        p.validity if p.validity is not None
        else torch.ones(len(p), dtype=torch.bool, device=p.values.device)
        for p in parts])


def _remap_codes(codes: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """A part's codes through its translation table, one gather on their
    device (a part whose dictionary is empty holds only null slots)."""
    if len(table) == 0:
        return torch.zeros(len(codes), dtype=torch.int32, device=codes.device)
    return torch.from_numpy(table).to(codes.device)[codes.long()]


def concat_device_columns(name: str, parts: List[DeviceColumn]) -> DeviceColumn:
    """One column's parts concatenated on their device.  A list column
    raises (``scan_dataset`` refuses it, as the reference does); so do
    dtypes that differ across the parts and a mix of dictionary and plain
    parts."""
    if len(parts) == 1:
        return parts[0]
    if any(isinstance(p, DeviceListColumn) for p in parts):
        raise NotYetImplementedError(
            f"dataset concat of list column {name!r} (scan files separately)")
    dtypes = {str(p.dtype) for p in parts}
    if len(dtypes) > 1:
        raise OutOfSpecError(f"column {name!r} type differs across files: {sorted(dtypes)}")
    validity = _concat_validity(parts)
    if any(p.dictionary is not None for p in parts):
        if not all(p.dictionary is not None for p in parts):
            raise OutOfSpecError(
                f"column {name!r} mixes dictionary and plain encodings across dataset parts")
        gdict, tables = _merge_dictionaries([p.dictionary for p in parts])
        codes = torch.cat([_remap_codes(p.values, t) for p, t in zip(parts, tables)])
        return DeviceColumn(name, parts[0].dtype, codes, validity, dictionary=gdict)
    return DeviceColumn(name, parts[0].dtype, torch.cat([p.values for p in parts]), validity)


def concat_device_tables(tables: List[DeviceTable]) -> DeviceTable:
    """Row-wise concatenation of the parts' device tables, whose column
    lists must agree."""
    if not tables:
        return DeviceTable({}, 0)
    names = list(tables[0].columns)
    for t in tables[1:]:
        if list(t.columns) != names:
            raise OutOfSpecError(
                f"dataset files disagree on columns: {names} vs {list(t.columns)}")
    out = {n: concat_device_columns(n, [t.columns[n] for t in tables]) for n in names}
    return DeviceTable(out, sum(t.num_rows for t in tables))


def scan_dataset(paths: Paths, device, columns: Optional[Sequence[str]] = None,
                 predicates: Optional[Sequence] = None) -> DeviceTable:
    """A dataset (a glob or a list of part files) as one table on
    ``device``: parts whose zone blocks show no match are skipped from
    their footers, the rest scan with page pruning (``scan_file``) and
    concatenate on the device.  When everything prunes away the result is
    the 0-row table of the first part's columns."""
    dev = as_device(device)
    concrete = resolve_paths(paths)
    survivors = [p for p in concrete if file_may_match(p, predicates)]
    parts = [scan_file(p, dev, columns=columns, predicates=predicates) for p in survivors]
    parts = [t for t in parts if t.num_rows > 0]
    if not parts:
        # every page of the first part prunes, so no data page decodes:
        # the 0-row table with its columns
        return scan_file(concrete[0], dev, columns=columns, predicates=predicates)
    return concat_device_tables(parts)


def write_dataset(directory: str, data, rows_per_file: int, options=None,
                  prefix: str = "part") -> List[str]:
    """Split ``data`` into part files of ``rows_per_file`` rows under
    ``directory`` (``part-00000.str``, ...), each written by ``write_file``
    with ``options``, so each is a standalone file with its own footer and
    zone block; returns their paths.  ``data`` is a ``pa.Table`` or a
    mapping ``{name: numpy column}`` as ``write_file`` takes it."""
    from ..write.writer import write_file

    if rows_per_file <= 0:
        raise OutOfSpecError("rows_per_file must be positive")
    arrow = not isinstance(data, Mapping)
    n = data.num_rows if arrow else len(next(iter(data.values()), ()))
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, off in enumerate(range(0, max(n, 1), rows_per_file)):
        ln = min(rows_per_file, n - off)
        part = data.slice(off, ln) if arrow else {name: c[off : off + ln] for name, c in data.items()}
        p = os.path.join(directory, f"{prefix}-{i:05d}.str")
        write_file(p, part, options=options)
        paths.append(p)
    return paths


def iter_dataset_chunks(paths: Paths, chunk_pages: int, device,
                        columns: Optional[Sequence[str]] = None,
                        predicates: Optional[Sequence] = None):
    """The dataset as a stream of device tables: parts in order, each in
    chunks of ``chunk_pages`` pages (``scan_chunks``), parts pruned from
    their footers first."""
    dev = as_device(device)
    for p in resolve_paths(paths):
        if file_may_match(p, predicates):
            yield from scan_chunks(p, chunk_pages, dev, columns=columns, predicates=predicates)


# ---------------------------------------------------------------------------
# manifests: each part's row count and file-level zone fold, so a planner
# prunes parts without opening them; parts the manifest does not prune
# still prune their pages from their own zones.


def dataset_manifest(paths: Paths) -> dict:
    """``{"version": 1, "parts": [{"path", "num_rows", "columns": {name:
    {"min", "max", "null_count", "kind"}}}]}``, from each part's footer
    and zone block."""
    from ..read.reader import read_meta

    parts = []
    for p in resolve_paths(paths):
        with open(p, "rb") as f:
            metas = read_meta(f)
        n_rows = int(sum(pg.num_values for pg in metas[0].pages))
        cols = {}
        for name, cz in (read_zones(p) or {}).items():
            mins = [z.min for z in cz.pages if z.min is not None]
            maxs = [z.max for z in cz.pages if z.max is not None]
            if mins:
                cols[name] = {"min": min(mins), "max": max(maxs),
                              "null_count": int(sum(z.null_count for z in cz.pages)),
                              "kind": cz.kind or "i"}
        parts.append({"path": p, "num_rows": n_rows, "columns": cols})
    return {"version": 1, "parts": parts}


def write_manifest(manifest: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, default=int)


def load_manifest(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _part_may_match(entry: dict, predicates: Optional[Sequence]) -> bool:
    """Whether a manifest entry's min / max leave room for every predicate
    (a column the entry lacks, and ``ne``, decide nothing)."""
    for pred in predicates or ():
        c = entry.get("columns", {}).get(pred.column)
        if c is None:
            continue
        lo, hi, v, op = c["min"], c["max"], pred.value, pred.op
        if ((op == "eq" and (v < lo or v > hi)) or (op == "lt" and not lo < v)
                or (op == "le" and not lo <= v) or (op == "gt" and not hi > v)
                or (op == "ge" and not hi >= v)):
            return False
    return True


def scan_dataset_with_manifest(manifest: dict, device, columns: Optional[Sequence[str]] = None,
                               predicates: Optional[Sequence] = None) -> DeviceTable:
    """:func:`scan_dataset` over the parts the manifest keeps, pruned with
    no read of the others."""
    survivors = [e["path"] for e in manifest["parts"] if _part_may_match(e, predicates)]
    if not survivors:
        # the first part's own pruning gives the 0-row table of its columns
        survivors = [manifest["parts"][0]["path"]]
    return scan_dataset(survivors, device, columns=columns, predicates=predicates)


def compact_dataset(paths: Paths, out_dir: str, rows_per_file: int, device, options=None,
                    prefix: str = "part") -> List[str]:
    """Rewrite a dataset's parts as parts of ``rows_per_file`` rows: the
    whole dataset scans onto ``device``, comes back as an arrow table and
    is written again, each part with a fresh zone block."""
    table = scan_dataset(paths, device).to_arrow()
    return write_dataset(out_dir, table, rows_per_file, options=options, prefix=prefix)
