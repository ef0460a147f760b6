"""ORDER BY / top-k over torch tensors.

Counterpart of ``strawboat_tpu/exec/sort.py``.  Each sort column maps to an
order-preserving 64-bit key, multi-column orders compose as successive
stable sorts (least significant key first), and a LIMIT over one column
takes the head of one stable sort.

torch has no usable uint64 sort, so the reference's u64 key ``K`` travels
as the int64 holding ``K ^ (1 << 63)``: signed comparison of those equals
unsigned comparison of ``K``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import SIGN64, widen_i64
from .scan import DeviceColumn, DeviceTable, unsigned_view


def orderable_u64(
    values: torch.Tensor, descending: bool = False, unsigned: bool = False
) -> torch.Tensor:
    """Values → int64 keys whose signed order is the column's order: the
    reference's u64 key with its top bit flipped.

    int: the value itself (the reference flips the sign bit, this
    representation flips it back).  float: IEEE total order — negative
    values flip all bits, positive ones the sign bit (NaN above +inf, -NaN
    below -inf).  bool, uint8 and unsigned views (``unsigned``):
    zero-extended.  ``descending`` complements the key."""
    dt = values.dtype
    if dt.is_floating_point:
        nbits = values.element_size() * 8
        if nbits == 64:
            u = values.view(torch.int64)
            key = torch.where(u < 0, ~u, u | SIGN64)
        else:
            ity = {32: torch.int32, 16: torch.int16}[nbits]
            mask = (1 << nbits) - 1
            u = values.view(ity).to(torch.int64) & mask
            top = 1 << (nbits - 1)
            key = torch.where(u >= top, ~u & mask, u | top) << (64 - nbits)
        key = key ^ SIGN64
    elif dt == torch.bool or dt == torch.uint8 or unsigned:
        key = widen_i64(values, unsigned=True) ^ SIGN64
    elif not dt.is_complex:
        key = values.to(torch.int64)
    else:
        raise TypeError(f"unorderable dtype {dt}")
    if descending:
        key = ~key
    return key


def _stable_order(key: torch.Tensor, order: Optional[torch.Tensor]) -> torch.Tensor:
    """Row indices after one stable ascending sort by ``key`` of the rows
    in ``order`` (None = natural order)."""
    if order is None:
        return torch.sort(key, stable=True).indices
    return order[torch.sort(key[order], stable=True).indices]


def sort_indices(
    cols: Tuple[torch.Tensor, ...],
    descending: Tuple[bool, ...],
    mask: Optional[torch.Tensor] = None,
    limit: Optional[int] = None,
    unsigned: Optional[Tuple[bool, ...]] = None,
) -> torch.Tensor:
    """int64 row indices ordering by ``cols`` (first column most
    significant).  Invalid rows (mask False) sort after every valid row;
    equal keys keep row order.  With ``limit`` and one column (no mask),
    the reference's ``top_k`` puts the lower index first among equal keys:
    the head of a stable sort gives the same rows in the same order."""
    n = cols[0].shape[0]
    unsigned = unsigned or (False,) * len(cols)
    keys = [orderable_u64(c, d, u) for c, d, u in zip(cols, descending, unsigned)]
    if mask is not None:
        # invalid rows lose every comparison: their keys become the least
        # key, and a most-significant validity key (valid 0, invalid 1)
        keys = [torch.where(mask, k, SIGN64) for k in keys]
        keys.insert(0, (~mask).to(torch.int64))
    order = None
    for k in reversed(keys):  # least significant first
        order = _stable_order(k, order)
    if limit is not None:
        order = order[: min(limit, n)]
    return order


def _dictionary_rank(dictionary: np.ndarray) -> np.ndarray:
    """int32 rank of each dictionary entry in byte order (numpy orders str
    by code point, which is UTF-8 byte order, and bytes by byte)."""
    order = np.argsort(dictionary, kind="stable")
    rank = np.empty(len(dictionary), dtype=np.int32)
    rank[order] = np.arange(len(dictionary), dtype=np.int32)
    return rank


def dictionary_rank_values(col: DeviceColumn) -> torch.Tensor:
    """Sortable values for a column: dictionary-coded (string) columns map
    codes → lexical rank, so ORDER BY is byte order whatever order the
    dictionary was built in.  One host argsort of the (small) dictionary,
    one device gather over the codes."""
    if col.dictionary is None:
        return col.values
    rank = torch.from_numpy(_dictionary_rank(col.dictionary)).to(col.values.device)
    return rank[col.values.long().clamp(0, max(len(rank) - 1, 0))]


def _by_items(by: Sequence):
    names, desc = [], []
    for item in by:
        if isinstance(item, tuple):
            names.append(item[0])
            desc.append(str(item[1]).lower().startswith("desc"))
        else:
            names.append(item)
            desc.append(False)
    return names, tuple(desc)


def sort_table(
    table: DeviceTable,
    by: Sequence,
    mask: Optional[torch.Tensor] = None,
    limit: Optional[int] = None,
):
    """Order a DeviceTable; returns (row indices, taken-valid mask or None).

    ``by`` items are column names or ``(name, "desc"|"asc")`` pairs.
    String (dictionary-coded) columns order lexically; rows null in any
    sort column sort last."""
    names, desc = _by_items(by)
    cols = tuple(dictionary_rank_values(table[n]) for n in names)
    unsigned = tuple(unsigned_view(table[n]) for n in names)
    row_mask = mask
    for n in names:
        v = table[n].validity
        if v is not None:
            row_mask = v if row_mask is None else (row_mask & v)
    idx = sort_indices(cols, desc, row_mask, limit, unsigned)
    taken_valid = None if row_mask is None else row_mask[idx]
    return idx, taken_valid


def head_table(table: DeviceTable, n: int) -> DeviceTable:
    """The first ``n`` rows as a new DeviceTable of views (no copy)."""
    out = {
        name: DeviceColumn(name, c.dtype, c.values[:n],
                           None if c.validity is None else c.validity[:n], c.dictionary)
        for name, c in table.columns.items()
    }
    return DeviceTable(out, min(n, table.num_rows))


def take_table(table: DeviceTable, indices: torch.Tensor) -> DeviceTable:
    """Materialize a row gather as a new DeviceTable (same column kinds)."""
    out = {
        name: DeviceColumn(
            name,
            c.dtype,
            c.values[indices],
            None if c.validity is None else c.validity[indices],
            c.dictionary,
        )
        for name, c in table.columns.items()
    }
    return DeviceTable(out, int(indices.shape[0]))
