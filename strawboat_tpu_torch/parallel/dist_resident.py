"""Sharded resident tables: the resident serving layer over the mesh.

Counterpart of ``strawboat_tpu/parallel/dist_resident.py``.  A resident
table's planes are packed so that tiled slot ``s`` holds row ``s``, so the
tile axis is a row axis: cutting every plane's leading (tile) dimension
into equal blocks gives each shard a contiguous row range, aligned across
columns and validity planes.  A query decodes every shard's planes through
kernel K1 at local shapes, one launch for all the shards on a device
(``ResidentColumn.combine``: K1's output is already in slot order, so the
reference's ``_rows_to_t_major`` has no counterpart), keeps the rows that
``exec/resident.py``'s ``kept_rows`` folds from the validity planes and
the bounds of ``ResidentColumn.compare_bounds`` over the planes cut at
the shard's row count, reduces locally and combines with one ``psum``.
In a world of processes each process keeps only its own shards' tile
blocks and decodes them in one K1 call; the ``psum`` crosses the
processes.

A table can also be loaded shard by shard (:func:`load_sharded_resident`):
each process makes only its own rows resident, the world agrees every
dictionary-coded column's sorted dictionary (local codes are remapped on
the card) and each shard keeps its own row count.  Over either kind,
:func:`sharded_keyed_aggregate` groups by any integer key column (one K1
call a device, then ``dist_agg.py``'s local partials, keyed exchange and
combine: dense slots over the key's span, added by kernel K9 where the
columns allow, or the kept rows compacted and sorted), and fetches the
largest group and its holders when asked (TPC-H Q15's shape).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import CapacityError, NotYetImplementedError
from ..exec.aggregate import group_sums
from ..exec.expr import Expr, product_factors
from ..exec.resident import (
    ResidentColumn,
    ResidentTable,
    _bits_of,
    _encode_int_device,
    _split_planes_device,
    _unpack_columns,
    _unpack_planes,
    kept_rows,
    make_resident,
)
from ..exec.scan import DeviceColumn, DeviceTable
from ..kernels.bitunpack import TILE3D
from ..kernels.keyed_add import K9_MAX_INPUTS, K9_MAX_TERMS, Factor, keyed_add
from ..util import obs
from .collectives import ShardedTensor, all_gather, gather_objects, pmax, psum
from .dist_agg import (
    combine,
    combine_dense,
    dense_partials,
    exchange_dense,
    exchange_partials,
    local_partials,
)
from .mesh import world

Bounds = Dict[str, Tuple[Optional[float], Optional[float]]]


@dataclass
class ShardedResidentColumn:
    """A resident column cut into shards: ``local[s]`` is this process's
    ``s``-th shard's ``ResidentColumn`` (its block of every plane and of
    the validity plane, and the dictionary on its device)."""

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
    # slots a shard (whole tiles) where every shard holds an equal block
    # of the tiles (shard_resident); 0 for a table loaded shard by shard
    rows_per_shard: int
    # rows of every shard of the axis, in global shard order (default:
    # the equal blocks of rows_per_shard, the last ones short)
    shard_rows: Tuple[int, ...] = ()
    # each integer-like column's span over the whole table, (lowest, n):
    # every value (a dictionary column's every code) lies in
    # [lowest, lowest + n), so n bounds its distinct values
    spans: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    def __post_init__(self):
        if not self.shard_rows:
            n, rps = self.mesh.axis_size(self.axis), self.rows_per_shard
            self.shard_rows = tuple(max(0, min(rps, self.num_rows - g * rps)) for g in range(n))

    def __getitem__(self, name: str) -> ShardedResidentColumn:
        return self.columns[name]


def shard_resident(rt: ResidentTable, mesh, axis: str) -> ShardedResidentTable:
    """Distribute a resident table's planes over ``mesh[axis]``: each plane
    pads with zero tiles to a multiple of the shard count (the padding
    rows fall past the row count) and shard ``s`` takes the ``s``-th block
    of tiles, on its device (in a world, this process's shards' blocks
    only); dictionaries are copied to every shard's device.  A list column
    raises (its leaves lie on their own grid)."""
    devs = mesh.axis_devices(axis)
    n, first = mesh.axis_size(axis), mesh.first_shard

    def blocks(wt3: torch.Tensor):
        pad = (-wt3.shape[0]) % n
        if pad:
            wt3 = torch.cat([wt3, wt3.new_zeros((pad,) + tuple(wt3.shape[1:]))])
        mine = torch.chunk(wt3, n)[first : first + len(devs)]
        return [b.to(d) for b, d in zip(mine, devs)], wt3.shape[0]

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
        vp = [None] * len(devs) if c.validity_plane is None else blocks(c.validity_plane)[0]
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
    spans = {name: sp for name, c in rt.columns.items()
             if (sp := _span([_value_range(c)])) is not None}
    return ShardedResidentTable(cols, rt.num_rows, rt.tile, mesh, axis, rows_per_shard,
                                spans=spans)


def _value_range(c: ResidentColumn):
    """What bounds a column's distinct values: ``("dict", entries)``,
    ``("span", lo, hi)`` for integer planes (every value lies in [lo, hi]),
    or None (floats)."""
    if c.is_dict:
        return ("dict", len(c.dictionary_host))
    if c.kind == "bool":
        return ("span", 0, 1)
    if c.kind != "int" or c.bit_shift:
        return None
    bits = sum(b for _w, b in c.planes)
    lo = int(np.uint64(c.offset).astype(np.int64))
    return ("span", lo, lo + (1 << bits) - 1)


def _span(ranges) -> Optional[Tuple[int, int]]:
    """(lowest, n) spanning the union of shards' ``_value_range``s: codes
    of one agreed dictionary from 0, or values (None where one is
    unbounded)."""
    if not ranges or any(r is None for r in ranges):
        return None
    if ranges[0][0] == "dict":
        return 0, max(r[1] for r in ranges)
    lo = min(r[1] for r in ranges)
    return lo, max(r[2] for r in ranges) - lo + 1


def _remap(c: ResidentColumn, codes: torch.Tensor, glob: np.ndarray, tile: int) -> ResidentColumn:
    """A dictionary column's ``codes`` (its unpacked plane) over its own
    sorted dictionary, repacked over the agreed ``glob`` (a superset):
    each code through the rank table, on the column's device."""
    dev = codes.device
    lut = np.searchsorted(glob, c.dictionary_host).astype(np.int32)
    lut_t = torch.from_numpy(np.concatenate([lut, np.zeros(1, np.int32)])).to(dev)
    new = lut_t[codes[: c.length].long().clamp(0, len(lut))]
    planes, shifts = _split_planes_device(new, new, _bits_of(max(len(glob) - 1, 1)), tile)
    dictionary = None
    if c.dictionary is not None:  # int32 values as the encoder keeps them, where they fit
        fits32 = c.dictionary.dtype == torch.int32 and (
            int(glob[0]) >= -(1 << 31) and int(glob[-1]) < (1 << 31))
        dictionary = torch.from_numpy(glob.astype(np.int32 if fits32 else np.int64)).to(dev)
    host = glob if c.kind == "str" else glob.astype(np.int64)
    return replace(c, planes=planes, shifts=shifts, dictionary=dictionary, dictionary_host=host)


def _plain(c: ResidentColumn, vals, tile: int) -> ResidentColumn:
    """A dictionary-coded integer column re-encoded as plain planes on its
    device (where other shards hold the column plain)."""
    v = c.combine(vals, True)[: c.length]
    out = _encode_int_device(DeviceColumn(c.name, c.arrow_type, v), tile, c.length)
    out.validity_plane = c.validity_plane
    return out


def load_sharded_resident(
    parts: Sequence[Mapping[str, np.ndarray]],
    mesh,
    axis: str = "shards",
    tile: Optional[int] = None,
) -> ShardedResidentTable:
    """A sharded resident table from this process's own rows:
    ``parts[s]`` holds the columns of its ``s``-th shard on the mesh axis
    (``{name: numpy column}``, as :func:`make_resident` takes them), one
    entry a local shard: in a single-process mesh every shard's, in a
    world this process's.  Each shard is made resident on its device,
    then the world agrees, with one ``gather_objects``:

    * every shard's row count (each shard keeps its own: its rows are
      masked by it, and shards may differ in length);
    * each dictionary-coded column's sorted dictionary, the union of the
      shards' (local codes are remapped on the card, so codes and
      code-space bounds compare across shards); an integer column that
      some shards hold plain is re-encoded plain on the others;
    * each integer column's span (``srt.spans``: what bounds its
      distinct values, and the slots of :func:`sharded_keyed_aggregate`).

    Every shard must hold the same column names; list columns raise (as
    :func:`shard_resident`).  Answers equal those of ``shard_resident``
    over the same rows in shard order."""
    devs = mesh.axis_devices(axis)
    if len(parts) != len(devs):
        raise ValueError(f"{len(parts)} parts for {len(devs)} local shards")
    tile = tile or TILE3D
    local = [make_resident(p, d, tile=tile) for p, d in zip(parts, devs)]
    names = list(local[0].columns)
    for rt in local:
        for name, c in rt.columns.items():
            if c.kind == "list":
                raise NotYetImplementedError(
                    f"load_sharded_resident: list column {name!r} (leaf grid differs "
                    "from the row grid; shard the flat columns)")
    # per shard: its rows, its column names, and each column's dictionary
    # (None: plain) and value range
    meta = [(rt.num_rows, sorted(rt.columns),
             {n: (c.dictionary_host if c.is_dict else None, _value_range(c))
              for n, c in rt.columns.items()}) for rt in local]
    every = [m for per_process in gather_objects(meta) for m in per_process]
    if any(m[1] != sorted(names) for m in every):
        raise ValueError("load_sharded_resident: the shards hold different columns")
    cols: Dict[str, List[ResidentColumn]] = {n: [rt.columns[n] for rt in local] for n in names}
    spans: Dict[str, Tuple[int, int]] = {}
    for n in names:
        dicts = [m[2][n][0] for m in every]
        if all(d is None for d in dicts):
            span = _span([m[2][n][1] for m in every])
        elif all(d is not None for d in dicts):
            glob = np.unique(np.concatenate(dicts))
            for s, c in enumerate(cols[n]):
                if not np.array_equal(np.asarray(c.dictionary_host), glob):
                    cols[n][s] = _remap(c, _unpack_planes(c.planes)[0], glob, tile)
            span = (0, len(glob))
        elif cols[n][0].kind == "int":
            # the dictionary shards' spans are not gathered: no bound
            for s, c in enumerate(cols[n]):
                if c.is_dict:
                    cols[n][s] = _plain(c, _unpack_planes(c.planes), tile)
            span = None
        else:
            raise NotYetImplementedError(
                f"load_sharded_resident: column {n!r} is dictionary-coded on some shards only")
        if span is not None:
            spans[n] = span
    shard_rows = tuple(int(m[0]) for m in every)
    return ShardedResidentTable(
        {n: ShardedResidentColumn(n, tuple(cs)) for n, cs in cols.items()},
        sum(shard_rows), tile, mesh, axis, 0, shard_rows=shard_rows, spans=spans)


def _decode_shards(srt: ShardedResidentTable, names, validity_words: bool = False):
    """This process's shards' planes and validity planes of ``names``
    through K1 at local shapes, one call a device (the reference's
    per-shard Pallas calls): per local shard, (each column's unpacked
    planes, each column's validity or None), as ``_unpack_columns`` gives
    them."""
    n_shards = len(srt.mesh.axis_devices(srt.axis))
    vals, valid = _unpack_columns(
        [srt.columns[n].local[s] for s in range(n_shards) for n in names], validity_words)
    k = len(names)
    return [(vals[s * k : (s + 1) * k], valid[s * k : (s + 1) * k]) for s in range(n_shards)]


def _bounds(srt: ShardedResidentTable, predicates: Bounds, pcols):
    """``[(column, lo, hi)]``: each predicate in its column's compared
    space, as plain numbers (``ResidentColumn.compare_bounds``; host side,
    once a query)."""
    return [(c,) + srt.columns[c].local[0].compare_bounds(*predicates[c]) for c in pcols]


def _column(srt, s: int, name: str, planes, at, with_dict: bool = True) -> torch.Tensor:
    """Local shard ``s``'s column ``name`` at slots ``at`` (indices, or a
    slice) from its unpacked ``planes``: each plane cut, then combined
    (values, or codes where not ``with_dict``)."""
    return srt.columns[name].local[s].combine([p[at] for p in planes], with_dict)


def _kept_mask(srt, s: int, names, bounds, decoded):
    """Local shard ``s``'s rows and the mask of those a query keeps (None:
    every row; ``kept_rows``): non-null in every read column, inside every
    bound (code space for dictionary columns).  The planes are cut at the
    shard's row count, so padding needs no mask; nothing waits on the
    host."""
    vals, valid = decoded
    n = srt.shard_rows[srt.mesh.first_shard + s]
    codes = {c: _column(srt, s, c, vals[names.index(c)], slice(0, n), False)
             for c, _lo, _hi in bounds}
    return n, kept_rows(None, [None if v is None else v[:n] for v in valid], bounds, codes)


def sharded_filter_sum(
    srt: ShardedResidentTable,
    predicates: Bounds,
    value: str,
    product_with: Optional[str] = None,
) -> torch.Tensor:
    """The Q6 shape over a sharded resident table: per shard, decode +
    code-space predicates + local sum, then one ``psum`` (across the
    world's processes in a world).  Returns a 0-d int64 (float64 for float
    values) tensor on the first shard's device."""
    predicates = predicates or {}
    pcols = tuple(sorted(predicates))
    extra = (product_with,) if product_with else ()
    names = list(dict.fromkeys(pcols + (value,) + extra))
    bounds = _bounds(srt, predicates, pcols)
    devs = srt.mesh.axis_devices(srt.axis)
    partial = []
    decoded = _decode_shards(srt, names)
    for s in range(len(devs)):
        n, m = _kept_mask(srt, s, names, bounds, decoded[s])
        vals = decoded[s][0]
        acc = _column(srt, s, value, vals[names.index(value)], slice(0, n))
        if product_with is not None:
            acc = (acc if acc.is_floating_point() else acc.long()) * _column(
                srt, s, product_with, vals[names.index(product_with)], slice(0, n))
        dt = torch.float64 if acc.is_floating_point() else torch.int64
        partial.append((acc if m is None else torch.where(m, acc, 0)).sum(dtype=dt))
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
    (``aggregate.group_sums``, as the single-table ``group_sum``) and one
    ``psum`` a result combines.  Integer sums are int64 (the reference's
    segment branch keeps a 32-bit column's width).  Returns ``((sums per
    value), counts)`` on the first shard's device; counts None where no
    value is asked for, as the reference's."""
    predicates = predicates or {}
    pcols = tuple(sorted(predicates))
    names = list(dict.fromkeys((key,) + tuple(values) + pcols))
    bounds = _bounds(srt, predicates, pcols)
    devs = srt.mesh.axis_devices(srt.axis)
    sums = [[] for _ in values]
    counts = []
    decoded = _decode_shards(srt, names)
    for s in range(len(devs)):
        n, m = _kept_mask(srt, s, names, bounds, decoded[s])
        vals, at = decoded[s][0], slice(0, n)
        k = _column(srt, s, key, vals[0], at, False).to(torch.int32)
        part, cnt = group_sums(k, [_column(srt, s, v, vals[names.index(v)], at) for v in values],
                               num_groups, m)
        for i, p in enumerate(part):
            sums[i].append(p)
        counts.append(cnt)
    outs = tuple(psum(p, devs)[0] for p in sums)
    return outs, (psum(counts, devs)[0] if values else None)


def _refs(c) -> Tuple[str, ...]:
    return tuple(c.refs) if isinstance(c, Expr) else (c,)


# a dense keyed aggregate takes at most this many slots (a span larger
# than this groups by sorting, as a given ``num_groups`` does)
DENSE_SLOTS = 1 << 24
# the keys holding the largest group each process sends in the finish's
# one fixed-size gather (more ties on one process gather them whole)
TOP_KEYS = 8


def _selected(srt, s: int, names, at, n: int, vals) -> DeviceTable:
    """Local shard ``s``'s columns ``names`` at slots ``at`` (indices, or
    a slice of ``n`` rows) from their unpacked planes ``vals``: each plane
    cut, then combined into values (dictionary columns through the
    dictionary)."""
    cols = {name: DeviceColumn(name, srt.columns[name].local[s].arrow_type,
                               _column(srt, s, name, planes, at))
            for name, planes in zip(names, vals)}
    return DeviceTable(cols, n)


def _finish(final, pos: Optional[int], need, n_valid, devs):
    """The finish of :func:`sharded_keyed_aggregate` over each local
    shard's ``(keys, aggregates, valid)``: one MAX all-reduce of the
    groups any shard needed (``need``, per shard, or None) and of
    aggregate ``pos``'s largest valid value; for ``pos``, the keys holding
    it, the :data:`TOP_KEYS` smallest of each process in one fixed-size
    ``all_gather``; then one fetch, which also reads this process's valid
    partial slots (``n_valid``, per shard).  Returns (need, valid partial
    slots, {"value", "keys"} or None)."""
    dev = devs[0]
    dt = torch.int64 if pos is None else final[0][1][pos].dtype
    low = torch.finfo(dt).min if dt.is_floating_point else torch.iinfo(dt).min
    local = []
    for i, f in enumerate(final):
        d = f[2].device
        mx = torch.full((), low, dtype=dt, device=d)
        if pos is not None and f[1][pos].numel():
            mx = torch.where(f[2], f[1][pos], mx).amax()
        nd = torch.zeros((), dtype=dt, device=d) if need is None else need[i].reshape(()).to(dt)
        local.append(torch.stack([nd, mx]))
    red = pmax(local, devs)
    n_all = torch.stack([n.reshape(()).to(torch.int64).to(dev) for n in n_valid]).sum()
    if pos is None:
        need_h, _best, valid_h = torch.cat([red, n_all.reshape(1).to(dt)]).tolist()
        return int(need_h), int(valid_h), None
    none = torch.iinfo(torch.int64).max
    cands = torch.cat([torch.where(f[2] & (f[1][pos] == red[1].to(f[2].device)), f[0], none).to(dev)
                       for f in final])
    top = torch.topk(cands, min(TOP_KEYS, cands.numel()), largest=False).values
    mine = torch.full((2 + TOP_KEYS,), none, dtype=torch.int64, device=dev)
    mine[0], mine[1] = (cands != none).sum(), n_all
    mine[2 : 2 + top.numel()] = top
    every = all_gather(mine).tolist()  # enqueued before the first fetch: one drain
    need_h, best = red.tolist()
    valid_h = every[world()[0] if world() is not None else 0][1]
    if best == low:
        return int(need_h), valid_h, {"value": None, "keys": []}
    if all(row[0] <= TOP_KEYS for row in every):
        keys = sorted(k for row in every for k in row[2 : 2 + row[0]])
    else:
        mine_h = [k for f in final for k in f[0][f[2] & (f[1][pos] == best)].tolist()]
        keys = sorted(k for per_process in gather_objects(mine_h) for k in per_process)
    return int(need_h), valid_h, {"value": best, "keys": keys}


def _dense_stages(srt, s, key, lowest, slots, reads, values, vals, n, m):
    """Local shard ``s``'s dense partials: every row's slot (its key less
    ``lowest``, or its dictionary code), the values of ``values`` over the
    shard's ``n`` rows, and ``dist_agg.dense_partials`` under mask ``m``
    (``count`` aggregates read the count)."""
    c = srt.columns[key].local[s]
    slot = _column(srt, s, key, vals[0], slice(0, n), False)
    if slot.dtype not in (torch.int32, torch.int64):
        slot = slot.to(torch.int64)
    if c.is_dict:  # a null row's code need not be one
        slot = slot.clamp(0, slots - 1)
    elif lowest:  # planes hold no value outside the span
        slot = slot - lowest
    used = {r for fn, e in values if fn != "count" for r in _refs(e)}
    t = _selected(srt, s, [r for r in reads if r in used], slice(0, n), n,
                  [v for r, v in zip(reads, vals) if r in used])
    cols = tuple(e.evaluate(t) if isinstance(e, Expr) else t[e].values
                 for fn, e in values if fn != "count")
    return dense_partials(slot, cols, m, slots)


def _k9_terms(srt, key, names, pcols, bounds, specs):
    """K9's terms for a dense keyed aggregate, by column: each summed
    value's :func:`product_factors` (a column name is its own one factor),
    or None where K9 does not take the call (``ResidentTable._k7_takes``'
    rule on these columns' ``ResidentColumn.words_are``): a value that is
    no such product, a summed column whose words are not its values (a
    dictionary column's are codes, even where it is also the key or a
    predicate), any other column read whose words are neither values nor
    codes, a literal or bound outside its column's dtype, or more inputs
    or terms than one launch takes."""
    terms = []
    for fn, e in specs:
        if fn == "count":
            continue
        factors = product_factors(e.node if isinstance(e, Expr) else ("col", e))
        if factors is None:
            return None
        terms.append(factors)
    summed = {col for t in terms for _op, _l, col in t}
    for n in names:
        fit = ("values",) if n in summed else ("values", "codes")
        if any(c.words_are not in fit for c in srt.columns[n].local):
            return None

    def fits(name, v) -> bool:
        wide = any(c.wide and not c.is_dict for c in srt.columns[name].local)
        bits = 63 if wide else 31
        return type(v) is int and -(1 << bits) <= v < (1 << bits)

    if not all(fits(col, lit) for t in terms for _op, lit, col in t):
        return None
    if not all(v is None or fits(c, v) for c, lo, hi in bounds for v in (lo, hi)):
        return None
    read = {key, *pcols, *(col for t in terms for _op, _l, col in t)}
    validity = max(sum(srt.columns[n].local[s].validity_plane is not None for n in names)
                   for s in range(len(srt.columns[key].local)))
    if len(read) + validity > K9_MAX_INPUTS or not 0 < len(terms) <= K9_MAX_TERMS:
        return None
    return terms


def _k9_stages(srt, s, key, lowest, slots, names, terms, bounds, decoded):
    """Local shard ``s``'s dense partials through one K9 launch over K1's
    words (``decoded``: validity as words; ``bounds`` on the words): the
    payload and ``where`` of ``dist_agg.dense_partials`` for the same sums
    (one int64 ``(terms + 1, slots)`` payload, the count last)."""
    vals, valid = decoded
    words = {n: v[0] for n, v in zip(names, vals)}
    c = srt.columns[key].local[s]
    factors = [[Factor(words[col], srt.columns[col].local[s].wide, op, lit)
                for op, lit, col in t] for t in terms]
    out = keyed_add(words[key], srt.shard_rows[srt.mesh.first_shard + s], slots, factors,
                    lowest=0 if c.is_dict else lowest, clamp=c.is_dict, bounds=bounds,
                    nonzero=[v for v in valid if v is not None])
    return [out], [(0, i) for i in range(len(terms) + 1)]


def _dense_keys(srt, key: str, s: int, lowest: int, owned: int) -> torch.Tensor:
    """The keys of the ``owned`` slots local shard ``s`` owns in a dense
    keyed aggregate: its range of the span, as values (a dictionary
    column's through its dictionary, clipped past its end)."""
    c = srt.columns[key].local[s]
    g = srt.mesh.first_shard + s
    dev = c.planes[0][0].device
    ids = g * owned + torch.arange(owned, dtype=torch.int64, device=dev)
    if not c.is_dict:
        return ids + lowest
    if c.dictionary is None:
        return ids
    return c.dictionary[ids.clamp(0, len(c.dictionary_host) - 1)].to(torch.int64)


def sharded_keyed_aggregate(
    srt: ShardedResidentTable,
    key: str,
    values: Dict[str, Tuple[str, object]],
    predicates: Optional[Bounds] = None,
    num_groups: Optional[int] = None,
    max_of: Optional[str] = None,
):
    """Group a sharded resident table's rows by the integer column ``key``
    (its groups spread over every shard) and aggregate, across the world.

    ``values``: out_name → (fn, column name or ``Expr``), fn in {sum,
    count, min, max}; integer sums are exact int64.  ``predicates``:
    half-open [lo, hi) value bounds by column, as
    :func:`sharded_filter_sum` takes them (code space for dictionary
    columns).  Rows null in any column read are left out.

    Two ways, one result.  **Dense** (``num_groups`` not given, the key's
    span ``srt.spans[key]`` at most :data:`DENSE_SLOTS`, every fn a sum or
    a count): each row's slot is its key less the span's lowest (a
    dictionary key's code); every shard adds its kept rows into every
    slot of the span, shard ``d`` receives the ``d``-th contiguous range of
    every shard's slots (``exchange_dense``, one all_to_all a payload
    dtype) and sums them (``combine_dense``).  Nothing waits on the host
    until the finish.  **Sorted** (otherwise): the kept rows are compacted
    (one host sync for their count) and go through
    ``dist_agg.local_partials`` / ``exchange_partials`` / ``combine``,
    ``num_groups`` slots a shard partitioned by key hash.  ``num_groups``
    defaults to the next power of two at or above the key's span (the
    table's rows where that is unknown or larger), so no query can
    overflow it; a smaller one that some shard's groups exceed raises
    :class:`CapacityError` on every process alike; there is no retry.

    The dense partials are one K9 launch a local shard over K1's words
    (``kernels/keyed_add.py``: the bounds, validity, products and adds in
    one pass) where :func:`_k9_terms` takes the call, decided once a query
    from the columns' encodings and the values' ``Expr.node``; else torch's
    passes (``_kept_mask``'s mask, the values, ``dist_agg.dense_partials``:
    one ``index_add_`` an aggregate), counted in ``k9.torch_routes``.  Both
    give the same payloads.

    Spans: the root ``strawboat.query`` with ``path="sharded_agg"`` and
    ``.decode`` (one K1 call a device), ``.filter`` (on K9's route the
    bounds alone, on the host; else the masks), ``.partial``,
    ``.exchange``, ``.combine`` and ``.finish`` (one MAX all-reduce; for
    ``max_of`` the keys holding the largest value, in one fixed-size
    gather; one fetch).  Counters ``exchange.slots_sent`` (the slots a
    query sends) and ``exchange.slots_valid`` (the valid partial slots
    among them, read in the finish's fetch).

    Returns per-shard ``{"keys", "valid", <name>...}`` as
    ``ShardedTensor``s, each shard's own groups (a range of the span, or
    ``num_groups`` slots by key hash); with ``max_of``, also ``"max"``:
    ``{"value", "keys"}``, the largest value of that aggregate over every
    group of the world and every key holding it, ascending (TPC-H Q15's
    answer), the same host object on every process.  Every process of a
    world makes the same call."""
    with obs.span("strawboat.query", path="sharded_agg"):
        predicates = predicates or {}
        pcols = tuple(sorted(predicates))
        out_names = tuple(values)
        fns = tuple(values[n][0] for n in out_names)
        reads = tuple(dict.fromkeys((key,) + tuple(r for n in out_names
                                                   for r in _refs(values[n][1]))))
        names = list(dict.fromkeys(reads + pcols))
        devs = srt.mesh.axis_devices(srt.axis)
        n_parts = srt.mesh.axis_size(srt.axis)
        if max_of is not None and max_of not in out_names:
            raise ValueError(f"max_of {max_of!r} is not one of {out_names}")
        span = srt.spans.get(key)
        dense = (num_groups is None and span is not None and 0 < span[1] <= DENSE_SLOTS
                 and set(fns) <= {"sum", "count"})
        cap = num_groups
        if cap is None:
            bound = min(srt.num_rows if span is None else span[1], srt.num_rows)
            cap = 1 << max(bound - 1, 0).bit_length()
        bounds = _bounds(srt, predicates, pcols)
        specs = [values[n] for n in out_names]
        terms = _k9_terms(srt, key, names, pcols, bounds, specs) if dense else None
        if dense and terms is None:
            obs.count("k9.torch_routes")
        with obs.span("strawboat.query.decode", device=devs[0]):
            decoded = _decode_shards(srt, names, validity_words=terms is not None)
        with obs.span("strawboat.query.filter", device=devs[0]):
            if terms is not None:  # K9 tests the rows: each shard's bounds, on the host
                k9_bounds = [[(decoded[s][0][names.index(c)][0], lo, hi) for c, lo, hi in bounds]
                             for s in range(len(devs))]
            else:
                kept = [_kept_mask(srt, s, names, bounds, decoded[s]) for s in range(len(devs))]
            if not dense:
                idx = [torch.arange(n, device=d[0][0][0].device) if m is None
                       else torch.nonzero(m).squeeze(1) for (n, m), d in zip(kept, decoded)]
        if dense:
            if terms is not None:
                def stage(s, lowest, slots):
                    return _k9_stages(srt, s, key, lowest, slots, names, terms, k9_bounds[s],
                                      decoded[s])
            else:
                def stage(s, lowest, slots):
                    return _dense_stages(srt, s, key, lowest, slots, reads, specs,
                                         decoded[s][0], *kept[s])
            final, n_valid, need = _dense(srt, key, span, fns, devs, n_parts, stage)
        else:
            final, n_valid, need = _sorted(srt, key, reads, fns, values, out_names, decoded,
                                           idx, cap, devs, n_parts)
        with obs.span("strawboat.query.finish", device=devs[0]):
            need_h, valid_h, top = _finish(final, None if max_of is None
                                           else out_names.index(max_of), need, n_valid, devs)
            obs.count("exchange.slots_valid", valid_h)
            if not dense and need_h > cap:
                raise CapacityError("sharded keyed aggregate groups", cap, need_h)
        result = {"keys": ShardedTensor(f[0] for f in final),
                  "valid": ShardedTensor(f[2] for f in final)}
        for i, name in enumerate(out_names):
            result[name] = ShardedTensor(f[1][i] for f in final)
        if max_of is not None:
            result["max"] = top
        return result


def _dense(srt, key, span, fns, devs, n_parts, stage):
    """The dense stages of :func:`sharded_keyed_aggregate`, each local
    shard's partials from ``stage(s, lowest, slots)`` (``_k9_stages`` or
    ``_dense_stages``): per local shard ``(keys, aggregates, valid)`` of
    the slots it owns, its valid partial slots, and no group need (a span
    cannot overflow)."""
    lowest, width = span
    owned = -(-width // n_parts)
    slots = owned * n_parts
    with obs.span("strawboat.query.partial", device=devs[0]):
        staged = [stage(s, lowest, slots) for s in range(len(devs))]
    with obs.span("strawboat.query.exchange", device=devs[0]):
        obs.count("exchange.slots_sent", slots * len(devs))
        received = exchange_dense(devs, [pays for pays, _w in staged], n_parts)
    with obs.span("strawboat.query.combine", device=devs[0]):
        final, n_valid = [], []
        for s, ((pays, where), recv) in enumerate(zip(staged, received)):
            sums = combine_dense(recv, where)
            count = sums[-1]
            aggs, it = [], iter(sums[:-1])
            for fn in fns:
                aggs.append(count if fn == "count" else next(it))
            final.append((_dense_keys(srt, key, s, lowest, owned), tuple(aggs), count > 0))
            p, r = where[-1]
            n_valid.append((pays[p][r] > 0).sum())
    return final, n_valid, None


def _sorted(srt, key, reads, fns, values, out_names, decoded, idx, cap, devs, n_parts):
    """The sorted stages of :func:`sharded_keyed_aggregate` over the kept
    slots ``idx``: per local shard ``(keys, aggregates, valid)`` of its
    ``cap`` result slots, its partial groups, and the groups each shard
    needed."""
    with obs.span("strawboat.query.partial", device=devs[0]):
        staged = []
        for s, ix in enumerate(idx):
            mask = None
            if not ix.numel():  # one masked row: the partials stay empty
                ix, mask = ix.new_zeros(1), torch.zeros(1, dtype=torch.bool, device=ix.device)
            t = _selected(srt, s, reads, ix, int(ix.shape[0]), decoded[s][0][: len(reads)])
            cols = tuple(c.evaluate(t) if isinstance(c, Expr) else t[c].values
                         for _fn, c in (values[n] for n in out_names))
            staged.append(local_partials(t[key].values, cols, mask, cap, fns, n_parts))
    with obs.span("strawboat.query.exchange", device=devs[0]):
        obs.count("exchange.slots_sent", n_parts * cap * len(devs))
        received = exchange_partials(devs, staged, cap, n_parts)
    with obs.span("strawboat.query.combine", device=devs[0]):
        final = [combine(k2, parts, valid, cap, fns) for k2, parts, valid in received]
    need = [torch.maximum(st[2].reshape(()), f[3].reshape(()).to(st[2].device))
            for st, f in zip(staged, final)]
    return [f[:3] for f in final], [st[2] for st in staged], need
