"""Fluent query API over a resident table.

Counterpart of ``strawboat_tpu/exec/query.py``, resident fused branch:

    res = (Query(rt)
           .filter(col("l_shipdate") <= 2467)
           .group_by("l_returnflag", "l_linestatus", num_groups=16)
           .agg(sum_qty=("sum", "l_quantity"), n=("count", "l_quantity"))
           .order_by("key_l_returnflag", "key_l_linestatus")
           .run())

Every group key must be a dictionary column (dense sorted codes), so the
composite key ``Σ code_i · stride_i`` is a direct segment id: decode,
filter and every aggregate run without a sort.  Other shapes (file
sources, the general hash-aggregate / sort / join path, more than 4096
composite groups) raise ``NotYetImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..errors import NotYetImplementedError
from .aggregate import dense_group_count, dense_group_sum, segment_reduce
from .expr import Expr
from .resident import ResidentTable, _unpack_plane_tiled
from .scan import DeviceColumn, DeviceTable

_GENERAL = "ROADMAP.md 'Modules to port': the Query general path (aggregate, sort, join)"
_FUSED_FNS = ("sum", "count", "min", "max", "avg", "mean")
_MAX_FUSED_GROUPS = 4096


@dataclass
class Query:
    path: Any  # a ResidentTable (file sources are not ported yet)
    _columns: Optional[List[str]] = None
    _filter: Optional[Expr] = None
    _keys: List[str] = field(default_factory=list)
    _aggs: Dict[str, Tuple[str, Any]] = field(default_factory=dict)
    _num_groups: int = 65536
    _order: List = field(default_factory=list)
    _limit: Optional[int] = None
    _distinct: bool = False
    _join: Optional[Tuple] = None

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

    def run(self):
        """Grouped: a dict of host numpy arrays (``n_groups``, ``keys``,
        ``key_<col>``, ``dict_<col>`` for string keys, one entry per
        aggregate).  Ungrouped: ``{name: scalar}``."""
        if not isinstance(self.path, ResidentTable):
            raise NotYetImplementedError(f"Query over {type(self.path).__name__} ({_GENERAL})")
        if self._join is not None or self._distinct or not self._aggs:
            raise NotYetImplementedError(f"join / distinct / projection queries ({_GENERAL})")
        res = self._try_run_resident_fused()
        if res is None:
            raise NotYetImplementedError(
                f"grouping by non-dictionary keys, over {_MAX_FUSED_GROUPS} "
                f"composite groups, or aggregates outside {_FUSED_FNS} ({_GENERAL})"
            )
        if self._keys:
            return res
        # one dense group; with no surviving row the empty-aggregate
        # semantics apply (sum/count 0, min/max the identity, avg NaN)
        empty = int(res["n_groups"]) == 0
        return {
            name: (np.float64("nan") if empty and fn in ("avg", "mean") else res[name][0])
            for name, (fn, _c) in self._aggs.items()
        }

    def _try_run_resident_fused(self):
        """Grouped aggregate over a resident source, or None when the query
        shape does not fit (a key that is not a dictionary column, more than
        4096 composite groups, another aggregate function)."""
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
        agg_items = list(self._aggs.items())
        filt = self._filter
        strides = np.ones(len(keys), dtype=np.int64)
        for i in range(len(keys) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        names = sorted(
            set(keys)
            | set(filt.refs if filt is not None else ())
            | {r for _n, (_f, c) in agg_items for r in (c.refs if isinstance(c, Expr) else (c,))}
        )

        cols, key_codes = {}, {}
        for n in names:
            c = rt.columns[n]
            vals = [_unpack_plane_tiled(w, b) for w, b in c.planes]
            cols[n] = DeviceColumn(
                n,
                c.arrow_type,
                rt._combine(c, vals, True),
                rt.validity_tiled(n),
                dictionary=c.dictionary_host if c.kind == "str" else None,
            )
            if n in keys:
                key_codes[n] = rt._combine(c, vals, False)
        table = DeviceTable(cols, rt.tiled_slots)
        m = rt.mask_tiled()
        if filt is not None:
            m = m & filt.mask(table)
        code = torch.zeros(rt.tiled_slots, dtype=torch.int64, device=rt.device)
        for k, st in zip(keys, strides):
            code = code + key_codes[k].long() * int(st)
        code32 = code.to(torch.int32)

        cnt = dense_group_count(code32, cap, m)
        outs = []
        for _name, (fn, c) in agg_items:
            if fn == "count":
                outs.append(cnt)
                continue
            if isinstance(c, Expr):
                v, vm = c.fn(table)
                mm = m if vm is None else (m & vm)
            else:
                v, vv = cols[c].values, cols[c].validity
                mm = m if vv is None else (m & vv)
            if fn in ("sum", "avg", "mean") and not v.is_floating_point():
                s, c2 = dense_group_sum(code32, v, cap, mask=mm)
                outs.append(s if fn == "sum" else s.double() / c2.clamp(min=1).double())
                continue
            seg = torch.where(mm, code, cap)
            if fn in ("sum", "avg", "mean"):
                s = segment_reduce(torch.where(mm, v, 0), seg, cap)
                if fn == "sum":
                    outs.append(s)
                else:
                    c2 = dense_group_count(seg, cap)
                    outs.append(s / c2.clamp(min=1).to(v.dtype))
            else:  # min / max
                if v.is_floating_point():
                    neutral = float("inf") if fn == "min" else float("-inf")
                else:
                    info = torch.iinfo(v.dtype)
                    neutral = info.max if fn == "min" else info.min
                op = "amin" if fn == "min" else "amax"
                outs.append(segment_reduce(torch.where(mm, v, neutral), seg, cap, op))

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
        live = np.flatnonzero(ints[0] > 0)
        # the ungrouped shape keeps its one group even when it is empty
        valid = live if keys else np.arange(1)
        res = {"n_groups": np.int64(len(live)), "keys": valid.astype(np.uint64)}
        # composite codes → per-key values (codes are ranks in the SORTED
        # dictionary, so code order == value order)
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


def _order_grouped_host(res: Dict, order: List, limit: Optional[int]):
    """ORDER BY / LIMIT over a grouped result (host numpy: group counts are
    tiny).  String keys sort by their codes: resident dictionaries are
    sorted."""
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
