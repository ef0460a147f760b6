"""Fluent query API over resident tables and files.

Counterpart of ``strawboat_tpu/exec/query.py``:

    res = (Query("/data/lineitem.str", device="cuda")
           .filter(col("l_shipdate") <= 2467)
           .group_by("l_suppkey", num_groups=4096)
           .agg(revenue=("sum", col("l_extendedprice") * (100 - col("l_discount"))))
           .order_by(("revenue", "desc"))
           .limit(10)
           .run())

A grouped aggregate over a resident table whose keys are all dictionary
columns (dense sorted codes, at most 4096 composite groups) takes the fused
branch first: the composite key ``Σ code_i · stride_i`` is a direct segment
id, and the result comes back as host numpy.  Every other shape takes the
general path, on the source's device: scan (a file through ``scan_file``,
its pages pruned by the filter's atoms; a glob or a list of part files
through ``scan_dataset``, whole parts pruned first; a resident table
decoded with its padding mask; a ``DeviceTable`` as it is), join, filter,
then the sort-based ``hash_aggregate``, ``scalar_aggregate``,
``sort_table`` or a projection; results are device tensors, and
``(DeviceTable, mask)`` for projections.  File sources run on ``device`` (default ``"cuda"``, which
raises without a card); a build-side query runs on its probe's device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import as_device
from ..errors import OutOfSpecError
from ..kernels.group_agg import composite_code
from ..util import obs
from .aggregate import (
    dense_group_count,
    dense_group_sum,
    hash_aggregate,
    scalar_aggregate,
    segment_reduce,
)
from .dataset import scan_dataset
from .expr import Expr
from .join import hash_join
from .resident import ResidentTable, _unpack_columns
from .scan import DeviceColumn, DeviceTable, scan_file, unsigned_view
from .sort import _by_items, _dictionary_rank, head_table, sort_indices, sort_table, take_table

_FUSED_FNS = ("sum", "count", "min", "max", "avg", "mean")
_MAX_FUSED_GROUPS = 4096


@dataclass
class Query:
    path: Any  # a file path, a glob, a list of files, a ResidentTable or a DeviceTable
    # file sources: the device the scan and the query run on (a resident
    # source runs on its table's device)
    device: Any = "cuda"
    _columns: Optional[List[str]] = None
    # resident sources: padding mask over the tiled table (True = real row)
    _base_mask: Optional[torch.Tensor] = None
    _filter: Optional[Expr] = None
    _keys: List[str] = field(default_factory=list)
    _aggs: Dict[str, Tuple[str, Any]] = field(default_factory=dict)
    _num_groups: int = 65536
    _order: List = field(default_factory=list)
    _limit: Optional[int] = None
    _distinct: bool = False
    _join: Optional[Tuple] = None  # (build Query, (probe_col, build_col), max_fanout)

    def select(self, *columns: str) -> "Query":
        self._columns = list(columns)
        return self

    def filter(self, predicate: Expr) -> "Query":
        self._filter = predicate if self._filter is None else (self._filter & predicate)
        return self

    def group_by(self, *keys: str, num_groups: int = 65536) -> "Query":
        self._keys = list(keys)
        self._num_groups = num_groups
        return self

    def agg(self, **aggs: Tuple[str, Any]) -> "Query":
        self._aggs.update(aggs)
        return self

    def join(self, other, on: Tuple[str, str], max_fanout: int = 1) -> "Query":
        """Inner equi-join against another file, resident table or query
        (the build side).  ``on`` = (probe_column, build_column).
        ``max_fanout`` bounds duplicate build keys; a longer run grows it
        and re-runs.  Filters and aggregates after the join see both
        sides' columns; a filter on the build query masks build rows."""
        self._join = (other if isinstance(other, Query) else Query(other), tuple(on), max_fanout)
        return self

    def order_by(self, *items) -> "Query":
        """items: column name or (name, "desc"); on grouped queries the names
        refer to aggregate outputs / ``key_<col>`` columns."""
        self._order = list(items)
        return self

    def limit(self, n: int) -> "Query":
        self._limit = int(n)
        return self

    def distinct(self, num_groups: int = 65536) -> "Query":
        self._distinct = True
        self._num_groups = num_groups
        return self

    # -- execution ------------------------------------------------------

    def scan(self, device=None) -> DeviceTable:
        """The source as a DeviceTable: a DeviceTable as it is, a resident
        table's decoded tiled columns (its padding mask in ``_base_mask``),
        or a file scanned on
        ``device`` (default: the query's), its pages pruned by the filter's
        atoms.  Only referenced columns are decoded."""
        if isinstance(self.path, DeviceTable):
            return self.path
        cols = self._referenced_columns()
        if isinstance(self.path, ResidentTable):
            # tiled order is a pure permutation: every order-invariant
            # stage sees exactly the natural-order table
            table, self._base_mask = self.path.as_device_table(cols)
            return table
        # the filter's column-vs-literal atoms prune files and pages by
        # zone maps
        predicates = list(self._filter.atoms) if self._filter is not None else None
        dev = as_device(device or self.device)
        if not isinstance(self.path, str) or any(c in self.path for c in "*?["):
            # a glob or a list of part files: a dataset scan
            return scan_dataset(self.path, dev, columns=cols, predicates=predicates)
        return scan_file(self.path, dev, columns=cols, predicates=predicates)

    def run(self):
        """Grouped: a dict (``n_groups``, ``keys``, ``key_<col>``,
        ``dict_<col>`` for string keys, one entry per aggregate, and
        ``taken_valid`` after ORDER BY / LIMIT).  Ungrouped aggregates:
        ``{name: scalar}``.  Projections: ``(DeviceTable, mask)``."""
        if (
            isinstance(self.path, ResidentTable)
            and self._join is None
            and not self._distinct
            and self._aggs
        ):
            # keys=[] runs as a single dense group (cap 1)
            fused = self._try_run_resident_fused()
            if fused is not None:
                if self._keys:
                    return fused
                if int(fused["n_groups"]) == 1:
                    return {name: fused[name][0] for name in self._aggs}
                # zero surviving rows: the general path defines the
                # empty-aggregate semantics
        table = self.scan()
        base_mask = self._base_mask
        row_order_sensitive = (
            not self._keys and not self._aggs and not self._distinct and self._join is None
        )
        if base_mask is not None and row_order_sensitive:
            # projection / limit / order-by over a resident source: natural
            # row order up front (the packing keeps it), the padding slots
            # cut from the tail
            table = head_table(table, self.path.num_rows)
            base_mask = None
        join_valid = None
        if self._join is not None:
            # padding slots are excluded as a probe mask so they never match
            table, join_valid = self._apply_join(table, probe_mask=base_mask)
            base_mask = None  # folded into join_valid
        mask = self._filter.mask(table) if self._filter is not None else None
        if base_mask is not None:
            mask = base_mask if mask is None else (mask & base_mask)
        if join_valid is not None:
            mask = join_valid if mask is None else (mask & join_valid)
        keys, aggs = self._keys, self._aggs
        if self._distinct and not keys:
            cols = self._columns or list(table.columns.keys())
            keys = cols
            aggs = aggs or {"count": ("count", cols[0])}
        if keys:
            res = hash_aggregate(table, keys=keys, aggs=aggs, num_groups=self._num_groups, mask=mask)
            # key codes are meaningful against the dictionary of this scan
            for k in keys:
                d = table[k].dictionary
                if d is not None:
                    res[f"dict_{k}"] = d
            if self._order or self._limit is not None:
                res = _order_grouped(res, self._order, self._limit, table)
            return res
        if aggs:
            def _vals(c):
                return c.evaluate(table) if isinstance(c, Expr) else table[c].values

            return {name: scalar_aggregate(_vals(c), mask, fn) for name, (fn, c) in aggs.items()}
        if self._order:
            idx, taken_valid = sort_table(table, self._order, mask, self._limit)
            return take_table(self._projected(table), idx), taken_valid
        if self._limit is not None:
            out_t = self._projected(table)
            if mask is not None:
                # the first _limit surviving rows, compacted: no padded
                # duplicate rows leak out
                idx = torch.nonzero(mask).reshape(-1)[: self._limit]
                return take_table(out_t, idx), None
            return head_table(out_t, self._limit), None
        return self._projected(table), mask

    def _try_run_resident_fused(self):
        """Grouped aggregate over a resident source, or None when the query
        shape does not fit (a key that is not a dictionary column, more than
        4096 composite groups, another aggregate function).  A
        ``strawboat.query`` root span (``path="fused"``) with ``.plan``,
        ``.decode`` (K1 and the planes combined into values), ``.filter``,
        ``.aggregate`` (the aggregates' expressions and the grouped sums:
        one K6 call, :func:`_fused_aggregates`), ``.fetch`` (the
        two stacks to the host) and ``.finish`` (the host's result and
        order-by)."""
        rt = self.path
        with obs.span("strawboat.query", path="fused"):
            with obs.span("strawboat.query.plan"):
                plan = self._fused_plan()
            if plan is None:
                return None
            keys, cap, strides, names = plan
            agg_items = list(self._aggs.items())
            with obs.span("strawboat.query.decode", device=rt.device):
                table, key_codes = _fused_decode(rt, names, keys)
            with obs.span("strawboat.query.filter"):
                m = rt.mask_tiled()
                if self._filter is not None:
                    m = m & self._filter.mask(table)
            with obs.span("strawboat.query.aggregate", device=rt.device):
                cnt, outs = _fused_aggregates(agg_items, table, key_codes, keys, strides, cap, m)
            with obs.span("strawboat.query.fetch"):
                # two host copies: one int64 stack, one float64 stack
                int_rows, flt_rows, out_slot = [cnt], [], []
                for o in outs:
                    if o.is_floating_point():
                        out_slot.append(("f", len(flt_rows)))
                        flt_rows.append(o.double())
                    else:
                        out_slot.append(("i", len(int_rows)))
                        int_rows.append(o.long())
                ints = torch.stack(int_rows).cpu().numpy()
                flts = torch.stack(flt_rows).cpu().numpy() if flt_rows else np.zeros((0, cap))
            with obs.span("strawboat.query.finish"):
                live = np.flatnonzero(ints[0] > 0)
                # the ungrouped shape keeps its one group even when it is empty
                valid = live if keys else np.arange(1)
                res = {"n_groups": np.int64(len(live)), "keys": valid.astype(np.uint64)}
                # composite codes → per-key values (codes are ranks in the
                # SORTED dictionary, so code order == value order)
                rem = valid.copy()
                for k, st in zip(keys, strides):
                    codes = rem // int(st)
                    rem = rem - codes * int(st)
                    c = rt.columns[k]
                    if c.kind == "str":
                        res[f"key_{k}"] = codes.astype(np.int64)
                        res[f"dict_{k}"] = c.dictionary_host
                    else:
                        res[f"key_{k}"] = c.dictionary_host[codes]
                for (name, _fc), (kind_s, slot) in zip(agg_items, out_slot):
                    row = flts[slot] if kind_s == "f" else ints[slot]
                    res[name] = row[valid]
                if keys and (self._order or self._limit is not None):
                    res = _order_grouped_host(res, self._order, self._limit)
                return res

    def _fused_plan(self):
        """(keys, group count, key strides, the columns read) of the fused
        branch, or None when the query's shape does not fit it."""
        rt = self.path
        keys = self._keys
        for k in keys:
            c = rt.columns.get(k)
            if c is None or not c.is_dict:
                return None
        sizes = [len(rt.columns[k].dictionary_host) for k in keys]
        cap = int(np.prod(sizes, dtype=np.int64)) if keys else 1
        if cap == 0 or cap > _MAX_FUSED_GROUPS:
            return None
        if any(fn not in _FUSED_FNS for fn, _c in self._aggs.values()):
            return None
        filt = self._filter
        strides = np.ones(len(keys), dtype=np.int64)
        for i in range(len(keys) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        names = sorted(
            set(keys)
            | set(filt.refs if filt is not None else ())
            | {r for _f, c in self._aggs.values() for r in (c.refs if isinstance(c, Expr) else (c,))}
        )
        return keys, cap, strides, names

    def _projected(self, table: DeviceTable) -> DeviceTable:
        """Restrict to the select() projection (the scan may carry columns
        referenced only by the filter or ORDER BY)."""
        if self._columns is None:
            return table
        return DeviceTable({n: table.columns[n] for n in self._columns}, table.num_rows)

    def _apply_join(self, table: DeviceTable, probe_mask=None):
        """Materialize the inner join: gather both sides by the match
        indices; returns (joined table, row-valid mask)."""
        other_q, on, max_fanout = self._join
        build = other_q.scan(device=_table_device(table))
        if other_q._base_mask is not None:
            # resident build side: padding slots must never match
            build = _with_key_validity(build, on[1], other_q._base_mask)
        if other_q._filter is not None:
            # build-side filter: rows failing it must never match
            build = _with_key_validity(build, on[1], other_q._filter.mask(build))
        pi, bi, valid = hash_join(table, build, on=on, max_fanout=max_fanout, probe_mask=probe_mask)

        def _gather(c, idx):
            return DeviceColumn(
                c.name, c.dtype, c.values[idx],
                None if c.validity is None else c.validity[idx], c.dictionary,
            )

        cols = {name: _gather(c, pi) for name, c in table.columns.items()}
        for name, c in build.columns.items():
            if name in cols:
                raise OutOfSpecError(f"join: column name {name!r} exists on both sides")
            cols[name] = _gather(c, bi)
        return DeviceTable(cols, int(pi.shape[0])), valid

    def _referenced_columns(self) -> Optional[List[str]]:
        if self._join is not None:
            # probe-side refs cannot be split from build-side refs without a
            # catalog; scan everything (the build side scans via its Query)
            return None
        filter_refs = list(self._filter.refs) if self._filter is not None else []
        if self._filter is not None and not filter_refs:
            # an Expr built outside the tracked constructors: scan everything
            # rather than risk a missing column
            return None
        if self._columns is not None:
            cols = list(self._columns)
            for name in filter_refs:
                if name not in cols:
                    cols.append(name)
            if self._order and not self._keys:
                for item in self._order:
                    name = item[0] if isinstance(item, tuple) else item
                    if name not in cols:
                        cols.append(name)
            return cols
        if not self._keys and not self._aggs:
            return None
        cols = set(self._keys) | set(filter_refs)
        for _fn, c in self._aggs.values():
            if isinstance(c, Expr):
                cols.update(c.refs)
            else:
                cols.add(c)
        return sorted(cols)


def _fused_decode(rt: ResidentTable, names, keys):
    """The fused branch's columns ``names`` decoded (every read column's
    planes and validity planes in one K1 launch) → (table, key codes)."""
    cols, key_codes = {}, {}
    read = [rt.columns[n] for n in names]
    for n, c, vals, valid in zip(names, read, *_unpack_columns(read)):
        cols[n] = DeviceColumn(
            n,
            c.arrow_type,
            c.combine(vals, True),
            valid,
            dictionary=c.dictionary_host if c.kind == "str" else None,
        )
        if n in keys:
            key_codes[n] = c.combine(vals, False)
    return DeviceTable(cols, rt.tiled_slots), key_codes


def _fused_aggregates(agg_items, table: DeviceTable, key_codes, keys, strides, cap: int,
                      m: torch.Tensor):
    """The fused branch's aggregates over the composite groups of the rows
    ``m`` keeps → (each group's rows, one ``(cap,)`` tensor an aggregate).
    The count and every integer sum, avg and mean are one
    ``dense_group_sum`` call (K6: each distinct input read once, one count
    a distinct validity); the rest (floats, min, max) take
    :func:`_fused_agg` and count in ``k6.torch_aggs``."""
    items = [(None, None)]  # item 0 counts the rows m keeps
    routes = []  # an item's index, "count", or (values, validity) for the torch route
    for _name, (fn, c) in agg_items:
        if fn == "count":
            routes.append("count")
            continue
        if isinstance(c, Expr):
            v, vm = c.fn(table)
        else:
            v, vm = table.columns[c].values, table.columns[c].validity
        if fn in ("sum", "avg", "mean") and not v.is_floating_point():
            routes.append(len(items))
            items.append((v, vm))
        else:
            routes.append((v, vm))
    key_cols = [(key_codes[k], int(st)) for k, st in zip(keys, strides)]
    sums, counts = dense_group_sum(key_cols, items, cap, mask=m)
    cnt, outs, code = sums[0], [], None
    for (_name, (fn, _c)), r in zip(agg_items, routes):
        if r == "count":
            outs.append(cnt)
        elif isinstance(r, int):
            s = sums[r]
            outs.append(s if fn == "sum" else s.double() / counts[r].clamp(min=1).double())
        else:
            obs.count("k6.torch_aggs")
            if code is None:
                code = composite_code(key_cols, m.shape[0], m.device)
            outs.append(_fused_agg(fn, *r, code, cap, m))
    return cnt, outs


def _fused_agg(fn: str, v: torch.Tensor, vm: Optional[torch.Tensor], code: torch.Tensor,
               cap: int, m: torch.Tensor) -> torch.Tensor:
    """A float sum / avg / mean, or a min / max, of ``v`` (validity ``vm``)
    over the composite group ``code``s (int64) of the rows ``m`` keeps."""
    mm = m if vm is None else (m & vm)
    seg = torch.where(mm, code, cap)
    if fn in ("sum", "avg", "mean"):
        s = segment_reduce(torch.where(mm, v, 0), seg, cap)
        if fn == "sum":
            return s
        c2 = dense_group_count(seg, cap)
        return s / c2.clamp(min=1).to(v.dtype)
    # min / max
    if v.is_floating_point():
        neutral = float("inf") if fn == "min" else float("-inf")
    else:
        info = torch.iinfo(v.dtype)
        neutral = info.max if fn == "min" else info.min
    op = "amin" if fn == "min" else "amax"
    return segment_reduce(torch.where(mm, v, neutral), seg, cap, op)


def _table_device(table: DeviceTable) -> torch.device:
    return next(iter(table.columns.values())).values.device


def _with_key_validity(table: DeviceTable, name: str, valid: torch.Tensor) -> DeviceTable:
    """The table with ``valid`` folded into column ``name``'s validity:
    rows it clears never match as build rows (null keys cannot match)."""
    c = table.columns[name]
    v = valid if c.validity is None else (c.validity & valid)
    return DeviceTable({**table.columns, name: dataclasses.replace(c, validity=v)}, table.num_rows)


def _order_grouped_host(res: Dict, order: List, limit: Optional[int]):
    """ORDER BY / LIMIT over a fused grouped result (host numpy: group
    counts are tiny).  String keys sort by their codes: resident
    dictionaries are sorted."""
    n = int(res["n_groups"])
    idx = np.arange(n)
    if order:
        # successive stable sorts, least-significant key first
        for item in reversed(order):
            name, desc = (
                (item[0], str(item[1]).lower().startswith("desc"))
                if isinstance(item, tuple)
                else (item, False)
            )
            sv = np.asarray(res[name])[:n][idx]
            o = np.argsort(sv, kind="stable")
            if desc:
                o = o[::-1]
            idx = idx[o]
    if limit is not None:
        idx = idx[:limit]
    out = {}
    for k, v in res.items():
        if k == "n_groups":
            out[k] = np.int64(len(idx))
            continue
        if k.startswith("dict_"):
            out[k] = v  # the dictionary itself, not per-group data
            continue
        arr = np.asarray(v)
        out[k] = arr[idx] if arr.ndim >= 1 and arr.shape[0] == n else v
    out["taken_valid"] = np.ones(len(idx), dtype=bool)
    return out


def _order_grouped(res: Dict, order: List, limit: Optional[int], table: Optional[DeviceTable] = None):
    """Sort a grouped-aggregate result by output columns (+ LIMIT), on the
    device.  Only the first ``n_groups`` slots are real groups; the rest
    sort last.  ``key_<col>`` columns holding a string column's codes
    order lexically (codes remap through the dictionary's rank)."""
    keys = res["keys"]
    cap = keys.shape[0]
    valid = torch.arange(cap, device=keys.device) < res["n_groups"]

    def _sort_col(name):
        v = res[name]
        if table is not None and name.startswith("key_"):
            src = table.columns.get(name[4:])
            if src is not None and src.dictionary is not None:
                rank = torch.from_numpy(_dictionary_rank(src.dictionary)).to(v.device)
                return rank[v.long().clamp(0, max(len(rank) - 1, 0))], False
            if src is not None:
                return v, unsigned_view(src)
        # the u64 labels order unsigned
        return v, name == "keys"

    if order:
        names, desc = _by_items(order)
        cols = [_sort_col(n) for n in names]
        idx = sort_indices(
            tuple(c for c, _u in cols), desc, valid, limit, tuple(u for _c, u in cols)
        )
    else:
        idx = torch.arange(cap if limit is None else min(limit, cap), device=keys.device)
    out = {}
    for k, v in res.items():
        if k == "n_groups":
            out[k] = torch.clamp(v, max=idx.shape[0])
        elif not k.startswith("dict_") and isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == cap:
            out[k] = v[idx]
        else:
            out[k] = v
    out["taken_valid"] = valid[idx]
    return out
