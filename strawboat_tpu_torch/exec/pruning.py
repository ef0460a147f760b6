"""Zone maps: per-page min / max / null counts, and page pruning.

Counterpart of ``strawboat_tpu/exec/pruning.py``.  The writer puts an
in-band zone block between the page data and the schema bytes, ended by
``[u32 payload_len][u32 ZONE_MAGIC]`` right at the schema's start, so a
reader that knows only the footer parses the file unchanged.  Integer and
date32 pages get a zone; string pages get none.  Pages lie on one row grid
across columns (one ``max_page_size``), so a pruned page drops for every
column.

Zones keep the column's native width, ``i`` (int64), ``u`` (uint64) or
``f`` (float64), and pruning compares at that width: an integer literal
exactly, a float literal against integer zones through an exact integer
bound (:func:`_prune_float_vs_int`), never through a float64 of an int64.
"""

from __future__ import annotations

import math
import numbers
import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ZONE_MAGIC = 0x314D4E5A  # b"ZNM1" little-endian
OPS = ("gt", "ge", "lt", "le", "eq", "ne")
_FMT = {"i": "<q", "u": "<Q", "f": "<d"}
_NP = {"i": np.int64, "u": np.uint64, "f": np.float64}


@dataclass
class PageZone:
    min: Optional[float]
    max: Optional[float]
    null_count: int
    num_values: int


@dataclass
class ColumnZones:
    name: str
    pages: List[PageZone]
    # "i" | "u" | "f": the width min / max are stored at (set on read,
    # derived from the values on write)
    kind: Optional[str] = None


def compute_zones(
    values: np.ndarray, validity: Optional[np.ndarray]
) -> Tuple[Optional[float], Optional[float], int]:
    """(min, max, null count) over the valid values; (None, None, n) when
    every value is null."""
    nulls = 0
    if validity is not None:
        nulls = int(len(validity) - np.count_nonzero(validity))
        values = values[validity]
    if len(values) == 0:
        return None, None, nulls
    return _py(values.min()), _py(values.max()), nulls


def _py(v):
    return float(v) if isinstance(v, (np.floating, float)) else int(v)


def _column_kind(cz: ColumnZones) -> str:
    if cz.kind in _FMT:
        return cz.kind
    for p in cz.pages:
        if p.min is None:
            continue
        if isinstance(p.min, float) or isinstance(p.max, float):
            return "f"
        if p.min < 0 or p.max < 0:
            return "i"
        if p.max > np.iinfo(np.int64).max:
            return "u"
    return "i"


def serialize_zones(zones: Dict[str, ColumnZones]) -> bytes:
    """``u32 n_columns``, then per column ``u16 name_len``, the name,
    ``u8 kind``, ``u32 n_pages``, then per page ``u8 has_stats``, 8-byte
    min, 8-byte max, ``u32 nulls``, ``u32 num_values``."""
    out = [struct.pack("<I", len(zones))]
    for name, cz in zones.items():
        nb = name.encode()
        kind = _column_kind(cz)
        out.append(struct.pack("<H", len(nb)) + nb + kind.encode() + struct.pack("<I", len(cz.pages)))
        rec = struct.Struct("<B" + _FMT[kind][1] * 2 + "II")
        for p in cz.pages:
            has = p.min is not None
            out.append(rec.pack(int(has), p.min if has else 0, p.max if has else 0,
                                p.null_count, p.num_values))
    return b"".join(out)


def deserialize_zones(payload: bytes) -> Dict[str, ColumnZones]:
    """The inverse of :func:`serialize_zones`; raises ``ValueError`` or
    ``struct.error`` on bytes that are not a zone payload."""
    (n_cols,) = struct.unpack_from("<I", payload, 0)
    pos = 4
    zones: Dict[str, ColumnZones] = {}
    for _ in range(n_cols):
        (nlen,) = struct.unpack_from("<H", payload, pos)
        name = payload[pos + 2 : pos + 2 + nlen].decode()
        kind = payload[pos + 2 + nlen : pos + 3 + nlen].decode()
        if kind not in _FMT:
            raise ValueError("bad zone column kind")
        (n_pages,) = struct.unpack_from("<I", payload, pos + 3 + nlen)
        pos += 7 + nlen
        rec = struct.Struct("<B" + _FMT[kind][1] * 2 + "II")
        pages = []
        for _p in range(n_pages):
            has, mn, mx, nulls, n = rec.unpack_from(payload, pos)
            pos += rec.size
            pages.append(PageZone(mn if has else None, mx if has else None, nulls, n))
        zones[name] = ColumnZones(name, pages, kind)
    if pos != len(payload):
        raise ValueError("trailing zone bytes")
    return zones


def zone_trailer(zones: Dict[str, ColumnZones]) -> bytes:
    """The payload, then ``[u32 len][u32 ZONE_MAGIC]``: written just before
    the schema."""
    payload = serialize_zones(zones)
    return payload + struct.pack("<II", len(payload), ZONE_MAGIC)


def read_zones(path: str) -> Optional[Dict[str, ColumnZones]]:
    """The file's zone block, or None when it has none: the block ends
    ``[u32 payload_len][u32 ZONE_MAGIC]`` right before the schema bytes,
    and bytes there that only look like one do not parse."""
    size = os.path.getsize(path)
    if size < 32:
        return None
    with open(path, "rb") as f:
        f.seek(size - 16)
        schema_size, meta_size = struct.unpack("<II", f.read(8))
        schema_start = size - 16 - meta_size - schema_size
        if schema_start < 16:
            return None
        f.seek(schema_start - 8)
        plen, magic = struct.unpack("<II", f.read(8))
        if magic != ZONE_MAGIC or plen > schema_start - 16:
            return None
        f.seek(schema_start - 8 - plen)
        payload = f.read(plen)
    try:
        return deserialize_zones(payload)
    except (ValueError, struct.error, UnicodeDecodeError):
        return None


# ---------------------------------------------------------------------------
# conjunctive predicate pruning


@dataclass(frozen=True)
class Comparison:
    """``column <op> value``, a prunable atom of a conjunction.  ``value``
    keeps the caller's type: an int literal compares exactly."""

    column: str
    op: str  # gt ge lt le eq ne
    value: "float | int"


def _cmp(a: np.ndarray, op: str, v) -> np.ndarray:
    """``a <op> v`` for one bound: an int literal against integer zones
    compares exactly whatever numpy's promotion rules (out of the dtype's
    range it is decided without a compare); floats compare as float64."""
    if a.dtype.kind in "iu" and isinstance(v, int):
        info = np.iinfo(a.dtype)
        if v > info.max or v < info.min:
            above = v > info.max  # every zone value lies below v
            res = {"gt": not above, "ge": not above, "lt": above, "le": above,
                   "eq": False, "ne": True}[op]
            return np.full(a.shape, res)
        v = a.dtype.type(v)
    return {"gt": np.greater, "ge": np.greater_equal, "lt": np.less,
            "le": np.less_equal, "eq": np.equal, "ne": np.not_equal}[op](a, v)


def _prune_float_vs_int(lo: np.ndarray, hi: np.ndarray, op: str, v: float, n_pages: int) -> np.ndarray:
    """May-match mask of a float literal over integer zone bounds, in exact
    integer arithmetic (``math.floor`` of a finite float is an exact int)."""
    all_ = np.ones(n_pages, dtype=bool)
    none = np.zeros(n_pages, dtype=bool)
    if math.isnan(v):
        # x <op> NaN is false for every row; ne is true for every row
        return all_ if op == "ne" else none
    if math.isinf(v):
        if op in ("gt", "ge", "eq"):
            return none if (v > 0 or op == "eq") else all_
        if op in ("lt", "le"):
            return all_ if v > 0 else none
        return all_  # ne
    fv = math.floor(v)
    is_int = v == fv
    if op == "gt":
        return _cmp(hi, "ge", fv + 1)
    if op == "ge":
        return _cmp(hi, "ge", fv if is_int else fv + 1)
    if op == "lt":
        return _cmp(lo, "le", fv - 1 if is_int else fv)
    if op == "le":
        return _cmp(lo, "le", fv)
    if op == "eq":
        return (_cmp(lo, "le", fv) & _cmp(hi, "ge", fv)) if is_int else none
    return ~(_cmp(lo, "eq", fv) & _cmp(hi, "eq", fv)) if is_int else all_  # ne


def check_predicates(predicates: Sequence) -> List[Comparison]:
    """Predicates as pruning atoms; anything else raises, so that a scan
    never runs unpruned where the caller asked for pruning."""
    out = []
    for p in predicates:
        if not isinstance(p, Comparison):
            raise TypeError(f"a pruning predicate must be a Comparison, got {p!r}")
        if p.op not in OPS:
            raise ValueError(f"unknown comparison {p.op!r} (one of {', '.join(OPS)})")
        if not isinstance(p.value, numbers.Real):
            raise TypeError(f"a pruning literal must be a number, got {p.value!r}")
        out.append(p)
    return out


def prune_pages(
    zones: Dict[str, ColumnZones], predicates: Sequence[Comparison], n_pages: int
) -> np.ndarray:
    """Boolean keep mask over the row-aligned page grid: a page stays
    unless some atom's zone shows no row of it can match.  An atom on a
    column without zones (a string column) or on another grid keeps every
    page."""
    keep = np.ones(n_pages, dtype=bool)
    for pred in check_predicates(predicates):
        cz = zones.get(pred.column)
        if cz is None or len(cz.pages) != n_pages:
            continue
        kind = _column_kind(cz)
        has = np.array([p.min is not None for p in cz.pages], dtype=bool)
        lo = np.array([0 if p.min is None else p.min for p in cz.pages], dtype=_NP[kind])
        hi = np.array([0 if p.max is None else p.max for p in cz.pages], dtype=_NP[kind])
        v = pred.value
        v = int(v) if isinstance(v, numbers.Integral) else float(v)
        op = pred.op
        if kind != "f" and isinstance(v, float):
            may = _prune_float_vs_int(lo, hi, op, v, n_pages)
        elif op == "eq":
            may = _cmp(lo, "le", v) & _cmp(hi, "ge", v)
        elif op == "ne":
            may = ~(_cmp(lo, "eq", v) & _cmp(hi, "eq", v))
        else:
            may = _cmp(hi if op in ("gt", "ge") else lo, op, v)
        keep &= may & has
    return keep
