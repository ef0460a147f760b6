"""Grouped and scalar reductions.

Counterpart of ``strawboat_tpu/exec/aggregate.py``:

- dense keys (``dense_group_sum`` and the ``jax.ops.segment_*`` calls of
  the resident path): the reference groups with a one-hot matmul on the MXU
  because scatters serialize on the TPU.  Here integer sums and counts over
  up to ``K6_MAX_GROUPS`` groups are one call of the hand-written kernel K6
  (``kernels/group_agg.py``): every sum and count of a query in one pass,
  with no per-row atomic.  Beyond, and for floats, min and max,
  ``segment_reduce`` scatters in two levels: rows are cut into chunks of
  ``CHUNK``, each chunk scatters into its own row of partials, and the
  partials are reduced over chunks (with few groups a single-level scatter
  sends every row's atomic to the same handful of addresses);
- any keys (``grouped_aggregate`` / ``hash_aggregate``): sort by the key
  columns' 64-bit images, cut segments where a neighbour differs, and
  reduce over each slot's range of sorted rows: integer sums as
  prefix-sum differences, min / max and float sums through
  ``torch.segment_reduce``, labels and representative rows gathered at
  the range ends; only integer min / max beyond 2^53 scatter;
- no keys (``scalar_aggregate``);
- list rows (``list_segment_sum``): the same range reduction over a list
  column's row → leaf offsets.

u64 key images and labels travel as int64 holding the same bits
(``device.py``); to order them the sign bit is flipped first.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..device import SIGN64, u64_to_i64, widen_i64
from ..errors import CapacityError, NotYetImplementedError
from ..kernels.group_agg import K6_MAX_GROUPS, composite_code, group_agg
from .expr import Expr
from .scan import unsigned_view

CHUNK = 1024


def _route(segments: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 segment ids with every id outside [0, num_segments) sent to
    the trash segment ``num_segments``."""
    seg = segments.long()
    return torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)


def segment_reduce(
    values: torch.Tensor,
    segments: torch.Tensor,
    num_segments: int,
    reduce: str = "sum",
) -> torch.Tensor:
    """Per-segment ``sum`` / ``amin`` / ``amax`` of ``values``.

    Segment ids outside ``[0, num_segments)`` are dropped, as in
    ``jax.ops.segment_*``.  Empty segments hold the reduction's identity
    (0, the dtype's max, the dtype's min; ±inf for floats)."""
    n = values.shape[0]
    dev = values.device
    seg = _route(segments, num_segments)
    width = num_segments + 1
    if reduce == "sum":
        fill = 0
    elif values.dtype.is_floating_point:
        fill = float("inf") if reduce == "amin" else float("-inf")
    else:
        info = torch.iinfo(values.dtype)
        fill = info.max if reduce == "amin" else info.min
    pad = (-n) % CHUNK
    if pad:
        values = torch.cat([values, torch.full((pad,), fill, dtype=values.dtype, device=dev)])
        seg = torch.cat([seg, torch.full((pad,), num_segments, dtype=torch.long, device=dev)])
    n_chunks = (n + pad) // CHUNK
    part = torch.full((n_chunks, width), fill, dtype=values.dtype, device=dev)
    part.scatter_reduce_(
        1, seg.view(n_chunks, CHUNK), values.view(n_chunks, CHUNK), reduce, include_self=True
    )
    if reduce == "sum":
        out = part.sum(0)
    elif reduce == "amin":
        out = part.amin(0)
    else:
        out = part.amax(0)
    return out[:num_segments]


def _k6_int(t: torch.Tensor, memo: Dict[int, torch.Tensor]) -> torch.Tensor:
    """``t`` as K6 takes it: int32 or int64 and contiguous (any other dtype
    through ``.to(torch.int64)``, as the scatter-add route takes it); one
    tensor a distinct input (``memo``), so repeated inputs stay one."""
    got = memo.get(id(t))
    if got is None:
        got = t if t.dtype in (torch.int32, torch.int64) else t.to(torch.int64)
        got = memo[id(t)] = got.contiguous()
    return got


def dense_group_sum(
    codes,
    values,
    num_groups: int,
    mask: Optional[torch.Tensor] = None,
):
    """Exact int64 per-group sums and counts for dense keys in
    ``[0, num_groups)``.  Rows with ``mask`` False, negative codes or codes
    ``>= num_groups`` are dropped.  Sums wrap mod 2^64, as the reference's.

    ``codes`` is one tensor of group codes, or ``[(codes, stride)]`` key
    columns whose composite code ``Σ codes · stride`` is the group;
    ``values`` one integer tensor, or ``[(values, validity)]``: each summed
    over the rows ``mask & validity`` keeps (``values`` None: a count,
    ``validity`` None: every row).  Returns ``(sums, counts)``: for one
    tensor both ``(num_groups,)``, the count of the rows ``mask`` keeps;
    for a list both ``(len(values), num_groups)``, ``counts[i]`` the rows
    that ``sums[i]`` adds.

    Up to ``K6_MAX_GROUPS`` groups this is one call of K6 (every distinct
    input read once, on CUDA one launch where the outputs fit one);
    beyond, the two-level scatter-add of :func:`segment_reduce`."""
    single = isinstance(values, torch.Tensor)
    keys = [(codes, 1)] if isinstance(codes, torch.Tensor) else list(codes)
    items = [(values, None)] if single else list(values)
    if num_groups > K6_MAX_GROUPS:
        sums, counts = _segment_sums(keys, items, num_groups, mask)
    else:
        memo: Dict[int, torch.Tensor] = {}
        keys = [(_k6_int(k, memo), int(st)) for k, st in keys]
        items = [(None if v is None else _k6_int(v, memo),
                  None if m is None else m.contiguous()) for v, m in items]
        n = len(items)
        out = group_agg(keys, num_groups, None if mask is None else mask.contiguous(),
                        items + [(None, m) for _v, m in items])
        sums, counts = out[:n], out[n:]
    return (sums[0], counts[0]) if single else (sums, counts)


def _segment_sums(keys, items, num_groups: int, mask: Optional[torch.Tensor]):
    """:func:`dense_group_sum` beyond ``K6_MAX_GROUPS`` groups: the composite
    code on the host's side, then :func:`segment_reduce` an output."""
    code = composite_code(keys, keys[0][0].shape[0], keys[0][0].device)
    if mask is not None:
        code = torch.where(mask, code, -1)
    ones = torch.ones(code.shape, dtype=torch.int64, device=code.device)
    counted: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}  # one count a distinct validity
    sums, counts = [], []
    for v, valid in items:
        if id(valid) not in counted:
            seg = code if valid is None else torch.where(valid, code, -1)
            counted[id(valid)] = seg, segment_reduce(ones, seg, num_groups)
        seg, cnt = counted[id(valid)]
        counts.append(cnt)
        sums.append(cnt if v is None else segment_reduce(v.to(torch.int64), seg, num_groups))
    return torch.stack(sums), torch.stack(counts)


def group_sums(key: torch.Tensor, values: Sequence[torch.Tensor], num_groups: int,
               mask: Optional[torch.Tensor] = None):
    """Per-group sums of each of ``values`` and the rows per group, over
    the rows ``mask`` keeps (None: every row) whose ``key`` lies in
    ``[0, num_groups)``: the resident ``group_sum``'s.  The count and every
    integer sum (exact int64) are one :func:`dense_group_sum` call, which
    alone chooses K6 or the scatter; a float sum keeps its dtype through
    :func:`segment_reduce`.  Returns ``([sums per value], counts)``."""
    ints = [v for v in values if not v.is_floating_point()]
    sums, _counts = dense_group_sum(key, [(None, None)] + [(v, None) for v in ints],
                                    num_groups, mask=mask)
    int_sums, seg, outs = iter(sums[1:]), None, []
    for v in values:
        if not v.is_floating_point():
            outs.append(next(int_sums))
            continue
        if seg is None:
            seg = key if mask is None else torch.where(mask, key, num_groups)
        outs.append(segment_reduce(v if mask is None else torch.where(mask, v, 0), seg, num_groups))
    return outs, sums[0]


def dense_group_count(
    codes: torch.Tensor, num_groups: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """int64 rows per group, with ``dense_group_sum``'s dropping rules: a
    one-output K6 call up to ``K6_MAX_GROUPS`` groups, a scatter-add of
    ones beyond."""
    if num_groups > K6_MAX_GROUPS:
        return _segment_sums([(codes, 1)], [(None, None)], num_groups, mask)[0][0]
    return group_agg([(_k6_int(codes, {}), 1)], num_groups,
                     None if mask is None else mask.contiguous(), [(None, None)])[0]


# ---------------------------------------------------------------------------
# grouping by any keys: sort + segment reduce (reference aggregate.py:24-229)

_MIX = u64_to_i64(0x9E3779B97F4A7C15)
_MIX_ADD = 0x85EBCA6B
_REDUCE = {"min": "amin", "max": "amax"}


def _col_u64(c: torch.Tensor, unsigned: bool = False) -> torch.Tensor:
    """Bijective 64-bit image of one key column, as int64 bits: ints and
    bools by two's-complement widening (``unsigned`` views zero-extend),
    floats by their bit pattern.  Two rows share an image iff their stored
    key bits are equal, so grouping on images is exact."""
    if c.dtype.is_floating_point:
        if c.dtype == torch.float64:
            return c.view(torch.int64)
        return c.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return widen_i64(c, unsigned)


def _key_u64(cols: Sequence[torch.Tensor], unsigned: Sequence[bool]) -> torch.Tensor:
    """One 64-bit reporting key: the image of a single key column, a mix of
    the images otherwise (``acc * 0x9E3779B97F4A7C15 + c + 0x85EBCA6B`` mod
    2^64, int64 wrap).  Grouping never relies on it."""
    acc = _col_u64(cols[0], unsigned[0])
    for c, u in zip(cols[1:], unsigned[1:]):
        acc = acc * _MIX + _col_u64(c, u) + _MIX_ADD
    return acc


def _identity(fn: str, dtype: torch.dtype):
    """What ``jax.ops.segment_min`` / ``segment_max`` leave in an empty
    segment."""
    if dtype.is_floating_point:
        return float("inf") if fn == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if fn == "min" else info.min


def _range_reduce(v: torch.Tensor, off: torch.Tensor, count: torch.Tensor, fn: str) -> torch.Tensor:
    """``fn`` (sum / min / max) of ``v`` over each range [off[g], off[g+1])
    of consecutive rows from ``v``'s start (rows past ``off[-1]`` count in
    none); an empty range holds the reduction's identity.

    Integer sums are prefix-sum differences, exact mod 2^64.  Floats take
    ``torch.segment_reduce``; integers whose values float64 holds exactly
    take it too and cast back; wider integers scatter."""
    identity = 0 if fn == "sum" else _identity(fn, v.dtype)
    if fn == "sum" and not v.is_floating_point():
        prefix = torch.zeros(v.shape[0] + 1, dtype=torch.int64, device=v.device)
        torch.cumsum(v, 0, out=prefix[1:])
        return prefix[off[1:]] - prefix[off[:-1]]
    # rows past off[-1] (a grouped aggregate's masked rows) form one more
    # range, dropped from the result
    tail = torch.cat([off, off.new_full((1,), v.shape[0])])
    if v.is_floating_point():
        return torch.segment_reduce(v, fn, offsets=tail, initial=identity)[:-1]
    lo, hi = torch.aminmax(v) if v.numel() else (torch.zeros(()), torch.zeros(()))
    if -(1 << 53) <= int(lo) and int(hi) <= (1 << 53):
        r = torch.segment_reduce(v.to(torch.float64), fn, offsets=tail,
                                 initial=_identity(fn, torch.float64))[:-1]
        r = torch.where(count > 0, r, 0.0).to(v.dtype)  # ±inf has no integer cast
        return torch.where(count > 0, r, identity)
    lengths = tail[1:] - tail[:-1]
    seg = torch.repeat_interleave(torch.arange(lengths.shape[0], device=v.device), lengths,
                                  output_size=v.shape[0])
    out = torch.full(lengths.shape, identity, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, seg, v, _REDUCE[fn], include_self=True)[:-1]


def grouped_aggregate(
    key_cols: Tuple[torch.Tensor, ...],
    value_cols: Tuple[torch.Tensor, ...],
    mask: Optional[torch.Tensor],
    num_groups: int,
    agg_specs: Tuple[Tuple[str, int], ...],  # (fn_name, value_col_index)
    key_unsigned: Optional[Tuple[bool, ...]] = None,
    value_unsigned: Optional[Tuple[bool, ...]] = None,
):
    """Group rows by composite key; returns (unique_keys, n_groups,
    rep_rows, aggs).

    Rows sort lexicographically over the key columns' 64-bit images (masked
    rows last), in the reference's unsigned order, so groups come out in
    the reference's slot order: an int64 key's image is its
    two's-complement, so negative keys follow every positive one.  Grouping
    is exact; ``unique_keys`` (int64 bits of the reference's u64) is a
    label, a mix for composite keys.  Capacity overflow collapses into the
    last slot, as in the reference; masked rows land there too, adding
    nothing to the aggregates, key 0 under a u64 max and their row ids to
    ``rep_rows``.  ``key_unsigned`` / ``value_unsigned`` mark signed views
    of unsigned columns."""
    from .sort import _stable_order

    G = num_groups
    key_unsigned = key_unsigned or (False,) * len(key_cols)
    value_unsigned = value_unsigned or (False,) * len(value_cols)
    imgs = [_col_u64(c, u) for c, u in zip(key_cols, key_unsigned)]
    n = imgs[0].shape[0]
    dev = imgs[0].device
    order = None
    for img in reversed(imgs):  # least significant first
        order = _stable_order(img ^ SIGN64, order)
    if mask is not None:
        order = _stable_order((~mask).to(torch.uint8), order)
    skey = _key_u64(key_cols, key_unsigned)[order]
    new_seg = torch.ones(n, dtype=torch.int64, device=dev)
    if n > 1:
        diff = torch.zeros(n - 1, dtype=torch.bool, device=dev)
        for img in imgs:
            si = img[order]
            diff |= si[1:] != si[:-1]
        new_seg[1:] = diff
    msk = None
    if mask is not None:
        msk = mask[order]
        new_seg = torch.where(msk, new_seg, 0)
    seg_ids = (torch.cumsum(new_seg, 0) - 1).clamp(0, G - 1)
    if msk is not None:
        seg_ids = torch.where(msk, seg_ids, G - 1)
    # seg_ids never decrease along the sorted rows, and the valid rows lead
    # (masked ones sort last), so slot g is the row range [off[g],
    # off[g+1]) and its valid part [voff[g], voff[g+1]): every reduction
    # reads ranges, with no atomics (a scatter into a few slots serializes
    # on their addresses).  The valid row count stays on the device (no
    # host sync): the value columns keep every sorted row and the ranges
    # end at the valid ones
    nv = n if msk is None else msk.sum()
    off = torch.searchsorted(seg_ids, torch.arange(G + 1, device=dev))
    voff = off if msk is None else torch.minimum(off, nv)
    count = voff[1:] - voff[:-1]
    outs = []
    for fn, vi in agg_specs:
        if fn == "count":
            outs.append(count)
            continue
        if fn not in ("sum", "min", "max"):
            raise ValueError(f"unknown aggregate {fn}")
        v = value_cols[vi][order]
        flip, narrow = False, None
        if not v.is_floating_point():
            if fn == "sum":
                v = widen_i64(v, value_unsigned[vi])  # SQL SUM is wide
            elif value_unsigned[vi]:
                # unsigned order: 16/32-bit views reduce zero-extended and
                # narrow back (the int64 identities wrap to the unsigned
                # ones), uint64 flips its sign bit around the reduction
                if v.element_size() < 8:
                    narrow, v = v.dtype, widen_i64(v, True)
                else:
                    v, flip = v ^ SIGN64, True
        out = _range_reduce(v, voff, count, fn)
        if flip:
            out = out ^ SIGN64
        outs.append(out if narrow is None else out.to(narrow))
    # labels: every row of slot g < G-1 carries its segment's label; the
    # last slot takes the u64 max of its valid rows' labels (overflowing
    # segments; masked rows add label 0), 0 when it has none
    rows = torch.arange(n, device=dev)
    filled = off[1:] > off[:-1]
    uniq = torch.zeros(G, dtype=torch.int64, device=dev)
    rep_rows = torch.zeros(G, dtype=torch.int64, device=dev)
    if n:
        uniq = torch.where(filled, skey[off[:-1].clamp(max=n - 1)], 0)
        in_tail = (rows >= off[G - 1]) & (rows < nv)
        uniq[G - 1] = torch.where(in_tail, skey ^ SIGN64, SIGN64).max() ^ SIGN64
        # per-group representative row, the slot's largest row id: stable
        # sorts leave a segment's rows ascending, so its last row; the last
        # slot takes its masked rows' ids too, as the reference's scatter max
        rep_rows = torch.where(filled, order[(off[1:] - 1).clamp(min=0)], 0)
        rep_rows[G - 1] = torch.where(rows >= off[G - 1], order, 0).max()
    n_groups = new_seg.sum()
    return uniq, n_groups, rep_rows.to(torch.int32), tuple(outs)  # int32, as the reference's


def hash_aggregate(
    table,
    keys: Sequence[str],
    aggs: Dict[str, Tuple[str, Any]],
    num_groups: int = 65536,
    mask: Optional[torch.Tensor] = None,
    on_overflow: str = "grow",
):
    """Group-by aggregate over a DeviceTable.

    aggs: out_name -> (fn, column); fn in {sum, min, max, count, avg}; the
    column may be a name or an Expr.  Returns a dict of device tensors:
    ``keys`` (int64 bits of the u64 label), ``n_groups``, ``rep_rows``
    (a source row per group), ``key_<col>`` and one entry per aggregate,
    each ``num_groups`` long with the first ``n_groups`` slots real.  More
    distinct keys than ``num_groups`` never pass silently:
    ``on_overflow="grow"`` re-runs at the next power of two at or above the
    group count, ``"raise"`` raises :class:`CapacityError`."""
    key_cols = tuple(table[k].values for k in keys)
    key_unsigned = tuple(unsigned_view(table[k]) for k in keys)
    # avg lowers to sum/count over the same sorted pass
    lowered: Dict[str, Tuple[str, Any]] = {}
    avg_names = []
    for name, (fn, c) in aggs.items():
        if fn in ("avg", "mean"):
            lowered[f"__{name}_sum"] = ("sum", c)
            lowered[f"__{name}_cnt"] = ("count", c)
            avg_names.append(name)
        else:
            lowered[name] = (fn, c)

    def _values(fn, c):
        if isinstance(c, Expr):
            v, m = c.fn(table)
            if m is not None:
                if fn != "sum":
                    raise NotYetImplementedError(
                        f"{fn} over a nullable expression; filter nulls first"
                    )
                v = torch.where(m, v, 0)  # SQL SUM ignores null inputs
            return v, False
        return table[c].values, unsigned_view(table[c])

    inputs = [_values(fn, c) for fn, c in lowered.values()]
    value_cols = tuple(v for v, _u in inputs)
    value_unsigned = tuple(u for _v, u in inputs)
    agg_specs = tuple((fn, i) for i, (fn, _c) in enumerate(lowered.values()))
    cap = num_groups
    while True:
        uniq, n_groups, rep_rows, outs = grouped_aggregate(
            key_cols, value_cols, mask, cap, agg_specs, key_unsigned, value_unsigned
        )
        need = int(n_groups)
        if need <= cap:
            break
        if on_overflow == "raise":
            raise CapacityError("aggregate groups", cap, need)
        cap = 1 << (need - 1).bit_length()
    result = {"keys": uniq, "n_groups": n_groups, "rep_rows": rep_rows}
    # decoded per-key columns via each group's representative source row
    safe_rep = rep_rows.clamp(0, max(len(table[keys[0]]) - 1, 0))
    for k in keys:
        result[f"key_{k}"] = table[k].values[safe_rep]
    for name, o in zip(lowered, outs):
        result[name] = o
    for name in avg_names:
        s = result.pop(f"__{name}_sum")
        c = result.pop(f"__{name}_cnt")
        ftype = s.dtype if s.is_floating_point() else torch.float64
        result[name] = s.to(ftype) / c.clamp(min=1).to(ftype)
    return result


def list_segment_sum(values: torch.Tensor, offsets: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-row sums of a flattened list column: row ``i`` sums
    ``values[offsets[i]:offsets[i + 1]]`` (a ``DeviceListColumn``'s
    composed offsets, any depth); rows past the offsets sum to 0.
    Integer sums are int64, exact mod 2^64; float sums keep the values'
    type (reference ``list_segment_sum``, aggregate.py:307)."""
    off = offsets.to(torch.int64)
    v = values if values.is_floating_point() else values.to(torch.int64)
    if off.shape[0] == 0:
        return torch.zeros(num_segments, dtype=v.dtype, device=v.device)
    out = _range_reduce(v[: int(off[-1])], off, off[1:] - off[:-1], "sum")
    if out.shape[0] < num_segments:
        out = torch.cat([out, out.new_zeros(num_segments - out.shape[0])])
    return out[:num_segments]


def scalar_aggregate(values: torch.Tensor, mask: Optional[torch.Tensor], fn: str):
    """Ungrouped aggregate with a selection mask; a 0-d device tensor."""
    if fn == "count":
        if mask is None:
            return torch.tensor(values.shape[0], dtype=torch.int64, device=values.device)
        return mask.sum(dtype=torch.int64)
    integral = not values.is_floating_point()
    if fn == "sum" and integral and values.element_size() < 8:
        values = values.to(torch.int64)  # SQL SUM is wide
    if mask is not None and fn in ("sum", "min", "max"):
        neutral = 0 if fn == "sum" else (
            _identity(fn, values.dtype) if integral and values.dtype != torch.bool
            else (float("inf") if fn == "min" else float("-inf"))
        )
        values = torch.where(mask, values, neutral)
    if fn == "sum":
        return values.sum()
    if fn == "min":
        return values.min()
    if fn == "max":
        return values.max()
    if fn in ("mean", "avg"):
        ftype = values.dtype if not integral else torch.float64
        if mask is None:
            # jnp.mean's result type: float32 for integers narrower than 64 bits
            out = values.to(ftype).mean()
            return out.to(torch.float32) if integral and values.element_size() < 8 else out
        s = torch.where(mask, values, 0).sum()
        return s.to(ftype) / mask.sum().to(ftype)
    raise ValueError(f"unknown aggregate {fn}")
