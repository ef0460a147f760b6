"""Compressed-in-device-memory resident tables on torch.

Counterpart of ``strawboat_tpu/exec/resident.py``.  A resident table
keeps each column as 1–2 bit-packed PLANES of
``(n_tiles, bits, tile)`` int32 words on the device, plus a small sorted
dictionary for dictionary-coded columns, and decodes on the fly inside each
query through kernel K1 (``kernels/bitunpack.py``).

Row order: packing pre-permutes values so that K1's ``(n_tiles, 32, tile)``
output, flattened, IS natural row order.  Tiled slot ``s`` holds row ``s``
of every plane of every column; padding is the tail.

Payload of a plain column: ``((Σ plane_i << shift_i) + offset) <<
bit_shift`` mod 2^64, then reinterpreted per kind (int / f32 / f64).  The
encode decisions (dictionary or plain, plane widths, offsets, the 8192-entry
dictionary cut, the host/device pack threshold) are the reference's, so the
planes match it word for word.

A list column (list, large_list, fixed-size list, map) keeps a LENGTHS
plane on the row grid and its flattened children as a child column over
their own grid (a map's child is the struct of its keys and values); a
struct column unnests into ``parent.child`` columns on the row grid and
``struct_specs`` reassembles it.  ``list_sum`` sums each row's list
through K1.

Fronts: a ``pa.Table`` (pyarrow, imported lazily), a mapping of numpy
columns or ``columns.py`` columns (for machines without pyarrow), a
``DeviceTable``, and a file (``load_resident``).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import columns as cm
from .. import native
from ..device import U32_MASK, as_device, shr_u32, u64_to_i64, widen_i64, words_u32
from ..errors import NotYetImplementedError, OutOfSpecError
from ..kernels.bitunpack import (
    TILE3D,
    bitunpack_tiled,
    bitunpack_tiled_many,
    transpose_words_host_tiled,
)
from ..kernels.decode import dict_gather_device
from ..kernels.filter_sum import K7_MAX_INPUTS, filter_sum as k7_filter_sum
from ..util import obs
from ..util.bits import pack_blocks
from ..schema import NULL_TYPE, Field, decimal_params, fixed_binary_width, fixed_size, int_storage
from .aggregate import group_sums, list_segment_sum
from .scan import DeviceColumn, DeviceListColumn, DeviceTable, to_pa_array, unsigned_view

_MAX_DICT = 1 << 20  # dictionary entries beyond this: plain planes instead
_DEVICE_PACK_MIN = 1 << 16  # from this many rows the pack runs on the device


@dataclass
class ResidentColumn:
    name: str
    # 1–2 packed planes, LSB-first: ((n_tiles, bits, tile) int32 words, bits)
    planes: Tuple[Tuple[torch.Tensor, int], ...]
    shifts: Tuple[int, ...]  # bit position of each plane in the payload
    length: int  # true row count (tiled slots beyond are padding)
    kind: str  # 'int' | 'f32' | 'f64' | 'bool' | 'str' | 'list' | 'struct'
    offset: int = 0  # unsigned 64-bit two's-complement image
    bit_shift: int = 0
    # int kind: decode to int64 when the arrow storage is 64-bit, even if
    # the packed values are narrow (products must not wrap in int32)
    wide: bool = False
    # dict columns: the GLOBAL SORTED dictionary — device values for value
    # decodes (None for strings), host values for translating value bounds
    # into code bounds (for strings: the object array of str/bytes)
    dictionary: Optional[torch.Tensor] = None
    dictionary_host: Optional[np.ndarray] = None
    validity_plane: Optional[torch.Tensor] = None  # 1-bit plane; None = all valid
    # pa.DataType, or its alias string; a nested column's port Field
    arrow_type: Any = None
    # list kind: the planes hold each row's length; the flattened children
    # are a column over their own grid (a list<list<…>>'s child is a list)
    child: Optional["ResidentColumn"] = None
    # struct kind: {field: column on the parent's grid}; a struct in a
    # table unnests to `parent.field` columns (ResidentTable.struct_specs)
    children: Optional[Dict[str, "ResidentColumn"]] = None

    @property
    def is_dict(self) -> bool:
        return self.dictionary_host is not None

    @property
    def tiled_slots(self) -> int:
        n_tiles, _b, tile = self.planes[0][0].shape
        return n_tiles * tile * 32

    @property
    def _narrow_int(self) -> bool:
        """One ≤31-bit plane, no offset: the values are the int32 words."""
        return (
            len(self.planes) == 1
            and self.offset == 0
            and self.bit_shift == 0
            and self.planes[0][1] <= 31
        )

    @property
    def words_are(self) -> Optional[str]:
        """What K1's int32 words of this column are to a kernel that reads
        them in place of :meth:`combine`'s column (K7, K9): ``"values"``
        for a narrow plain integer (one ≤31-bit plane, no offset),
        ``"codes"`` for a dictionary-coded integer or string column (fit
        for a key or a code-space bound, never for a summed value), else
        None."""
        if self.is_dict:
            return "codes" if self.kind in ("int", "str") else None
        return "values" if self.kind == "int" and self._narrow_int else None

    def decoded_dtype(self) -> torch.dtype:
        if self.is_dict:
            if self.kind == "str":
                return torch.int32  # codes
            return self.dictionary.dtype
        if self.kind == "bool":
            return torch.bool
        if self.kind == "f32":
            return torch.float32
        if self.kind == "f64":
            return torch.float64
        if self._narrow_int and not self.wide:
            return torch.int32
        return torch.int64

    def combine(self, unpacked, with_dict: bool = True) -> torch.Tensor:
        """Unpacked planes (flat int32 u32 bits, as K1 gives them) →
        the column's values (a dictionary column's through its dictionary
        when ``with_dict``, else its codes; strings always codes)."""
        if self.is_dict:
            codes = unpacked[0]
            if with_dict and self.dictionary is not None:
                return dict_gather_device(codes, self.dictionary)
            return codes
        if self.kind == "bool":
            return unpacked[0] != 0
        if self.kind == "f32":
            u = unpacked[0]
            if self.offset or self.bit_shift:
                w = words_u32(u)
                if self.offset:
                    w = (w + (self.offset & U32_MASK)) & U32_MASK
                if self.bit_shift:
                    w = (w << self.bit_shift) & U32_MASK
                u = w.to(torch.int32)
            return u.view(torch.float32)
        if self._narrow_int and self.kind == "int":
            v = unpacked[0]  # values < 2^31
            return v.long() if self.wide else v
        u = None
        for v, sh in zip(unpacked, self.shifts):
            p = words_u32(v) << sh
            u = p if u is None else u | p
        if self.offset:
            u = u + u64_to_i64(self.offset)  # wraps mod 2^64
        if self.bit_shift:
            u = u << self.bit_shift
        if self.kind == "f64":
            return u.view(torch.float64)
        return u

    def compare_bounds(self, lo, hi):
        """A predicate's value bounds ``[lo, hi)`` in the space the column
        is compared in, as plain numbers (None where open): a sorted
        dictionary's codes (``[lo, hi)`` over values is
        ``[searchsorted(lo), searchsorted(hi))`` over codes), else the
        values as given.

        The routes differ past this point on purpose, each as its JAX
        counterpart does: the single-table queries cast each end to the
        column's compared dtype (int32 for codes) and cache it once a
        table (``ResidentTable._bounds``, as JAX ``_bound_scalars``), so a
        fraction on an integer column truncates and an end past the dtype
        raises; the sharded queries compare against the plain numbers (as
        JAX ``_bound_scalars_sharded``).  Tests hold each route against
        its counterpart: keep the two."""
        if not self.is_dict:
            return lo, hi
        d = self.dictionary_host
        return tuple(None if b is None else int(np.searchsorted(d, b, "left")) for b in (lo, hi))


def _slot_source_index(n_tiles: int, tile: int) -> np.ndarray:
    """Input index of the reference's BitPacker4x block stream feeding tiled
    slot s: lane_global = tile_i*tile + lane = 4*blk + l, source = 128*blk +
    4*t + l.  ``_pack_plane`` feeds values through this permutation's
    inverse, so tiled slot s holds row s."""
    shape = (n_tiles, 32, tile)
    ti, t, lane = np.indices(shape, sparse=True)
    lane_g = ti * tile + lane
    nat = 128 * (lane_g // 4) + 4 * t + (lane_g % 4)
    return np.broadcast_to(nat, shape).reshape(-1)


def _pa_of(t):
    """A column's type as a ``pa.DataType`` (from a port Field, an alias
    string or a pa type)."""
    if isinstance(t, Field):
        return cm.pa_type(t)
    return cm.arrow_type(t)


def _unpack_plane_tiled(wt3: torch.Tensor, bits: int) -> torch.Tensor:
    """One packed plane → flat int32 (u32 bits) values in tiled-slot order."""
    return bitunpack_tiled(wt3, 0, bits).reshape(-1)


def _unpack_planes(planes) -> List[torch.Tensor]:
    """Packed planes ``[(words, bits)]`` → flat int32 values each, in
    tiled-slot order, through one K1 call a device
    (``bitunpack_tiled_many``)."""
    by_dev: Dict[torch.device, List[int]] = {}
    for i, (w, _b) in enumerate(planes):
        by_dev.setdefault(w.device, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(planes)
    for idx in by_dev.values():
        for i, o in zip(idx, bitunpack_tiled_many([planes[i] for i in idx])):
            out[i] = o.reshape(-1)
    return out


def _unpack_columns(cols: Sequence["ResidentColumn"], validity_words: bool = False):
    """The planes and validity planes of ``cols`` through one K1 call a
    device → (each column's unpacked planes, each column's validity in
    tiled order or None: bools, or K1's int32 words where
    ``validity_words``)."""
    planes = []
    for c in cols:
        planes.extend(c.planes)
        if c.validity_plane is not None:
            planes.append((c.validity_plane, 1))
    flat = iter(_unpack_planes(planes))
    vals, valid = [], []
    for c in cols:
        vals.append([next(flat) for _ in c.planes])
        if c.validity_plane is None:
            valid.append(None)
        else:
            words = next(flat)
            valid.append(words if validity_words else words != 0)
    return vals, valid


@dataclass
class ResidentTable:
    columns: Dict[str, ResidentColumn]
    num_rows: int
    tile: int
    field_order: Optional[Sequence[str]] = None
    # struct reassembly: {struct name: (((field, column name), ...),
    # validity plane or None, type)}; the children are table columns
    struct_specs: Optional[Dict[str, Any]] = None
    _bounds_cache: Dict = field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _mask: Optional[torch.Tensor] = field(
        default=None, init=False, repr=False, compare=False
    )
    _live: Optional[int] = field(default=None, init=False, repr=False, compare=False)

    def __getitem__(self, name: str) -> ResidentColumn:
        return self.columns[name]

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).planes[0][0].device

    @property
    def tiled_slots(self) -> int:
        return next(iter(self.columns.values())).tiled_slots

    def mask_tiled(self) -> torch.Tensor:
        """Padding mask (True = real row): padding is the tail."""
        if self._mask is None:
            self._mask = (
                torch.arange(self.tiled_slots, dtype=torch.int32, device=self.device)
                < self.num_rows
            )
        return self._mask

    def natural_slot_index(self) -> torch.Tensor:
        """Slot of natural row i: the identity under the pre-permuted
        packing (kept for callers that need an index array; int32, as the
        reference's)."""
        return torch.arange(self.num_rows, dtype=torch.int32, device=self.device)

    @classmethod
    def from_reference(cls, rt_ref, device) -> "ResidentTable":
        """Port table over the arrays of a reference ``ResidentTable`` (or any
        object shaped like one), list and struct columns included.  Each
        plane, validity plane and dictionary is copied out with
        ``np.array``, which takes a JAX array as it is, so no JAX import is
        needed here."""
        dev = as_device(device)

        def words(w):
            return torch.from_numpy(np.array(w, dtype=np.uint32).view(np.int32)).to(dev)

        def column(name, c) -> ResidentColumn:
            return ResidentColumn(
                name,
                tuple((words(w), b) for w, b in c.planes),
                tuple(c.shifts),
                int(c.length),
                c.kind,
                offset=int(c.offset),
                bit_shift=int(c.bit_shift),
                wide=bool(c.wide),
                dictionary=(
                    None if c.dictionary is None
                    else torch.from_numpy(np.array(c.dictionary)).to(dev)
                ),
                dictionary_host=c.dictionary_host,
                validity_plane=(
                    None if c.validity_plane is None else words(c.validity_plane)
                ),
                arrow_type=c.arrow_type,
                child=None if c.child is None else column(c.child.name, c.child),
                children=None if c.children is None else {
                    k: column(v.name, v) for k, v in c.children.items()},
            )

        specs = getattr(rt_ref, "struct_specs", None)
        return cls({name: column(name, c) for name, c in rt_ref.columns.items()},
                   int(rt_ref.num_rows), int(rt_ref.tile),
                   field_order=getattr(rt_ref, "field_order", None),
                   struct_specs=None if specs is None else {
                       k: (tuple(names), None if v is None else words(v), t)
                       for k, (names, v, t) in specs.items()})

    # -- decode --------------------------------------------------------

    def decode_tiled(self, name: str, with_dict: bool = True) -> torch.Tensor:
        """Column values in tiled order, padding slots included.  Dict columns
        decode through the dictionary unless ``with_dict`` is False (code
        space); strings always return codes."""
        c = self.columns[name]
        return c.combine(_unpack_planes(c.planes), with_dict)

    def validity_tiled(self, name: str) -> Optional[torch.Tensor]:
        """Validity (True = non-null) in tiled order, or None (all valid)."""
        c = self.columns[name]
        if c.validity_plane is None:
            return None
        return _unpack_plane_tiled(c.validity_plane, 1) != 0

    def decode_natural(self, name: str, with_dict: bool = True) -> torch.Tensor:
        """Column values in natural row order: tiled order truncated."""
        return self.decode_tiled(name, with_dict)[: self.num_rows]

    def validity_natural(self, name: str) -> Optional[torch.Tensor]:
        v = self.validity_tiled(name)
        return None if v is None else v[: self.num_rows]

    # -- whole-table views ---------------------------------------------

    def as_device_table(self, columns: Optional[Sequence[str]] = None):
        """Decoded tiled columns as a ``DeviceTable`` + padding mask.  A
        list column raises: its leaves lie on their own grid (it serves
        ``list_sum`` and ``to_arrow``)."""
        names = list(columns) if columns is not None else list(self.columns)
        cols = {}
        for n in names:
            c = self.columns[n]
            if c.kind == "list":
                raise NotYetImplementedError(
                    f"list column {n!r} in as_device_table: lists serve list_sum and to_arrow")
            cols[n] = DeviceColumn(
                n,
                c.arrow_type,
                self.decode_tiled(n),
                self.validity_tiled(n),
                dictionary=c.dictionary_host if c.kind == "str" else None,
            )
        return DeviceTable(cols, self.tiled_slots), self.mask_tiled()

    def _natural(self, c: ResidentColumn, with_dict: bool = True) -> torch.Tensor:
        """An explicit column's values (a list's child too) in natural order."""
        return c.combine(_unpack_planes(c.planes), with_dict)[: c.length]

    def _col_validity(self, c: ResidentColumn) -> Optional[np.ndarray]:
        if c.validity_plane is None:
            return None
        return (_unpack_plane_tiled(c.validity_plane, 1) != 0)[: c.length].cpu().numpy()

    def _materialize_pa(self, c: ResidentColumn):
        """One column (or a list's or struct's child) → its natural-order
        ``pa.Array`` (reference ``_materialize_pa``, resident.py:382)."""
        import pyarrow as pa

        valid = self._col_validity(c)
        mask = None if valid is None else ~valid
        t = _pa_of(c.arrow_type)
        if c.kind == "struct":
            children = [self._materialize_pa(cc) for cc in c.children.values()]
            return pa.StructArray.from_arrays(children, fields=list(t),
                                              mask=None if mask is None else pa.array(mask))
        if c.kind == "list":
            lengths = self._natural(c).cpu().numpy().astype(np.int64)
            offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
            np.cumsum(lengths, out=offsets[1:])
            child = self._materialize_pa(c.child)
            bitmap = None if mask is None else pa.py_buffer(np.packbits(~mask, bitorder="little"))
            if pa.types.is_map(t):
                arr = pa.MapArray.from_arrays(pa.array(offsets.astype(np.int32)), child.field(0),
                                              child.field(1),
                                              mask=None if mask is None else pa.array(mask))
            elif pa.types.is_fixed_size_list(t):  # every row keeps its slots
                return pa.Array.from_buffers(t, len(lengths), [bitmap], children=[child])
            else:
                arr = pa.Array.from_buffers(pa.large_list(child.type), len(lengths),
                                            [bitmap, pa.py_buffer(offsets)], children=[child])
            return arr if arr.type == t else arr.cast(t)
        vals = self._natural(c).cpu().numpy()
        return to_pa_array(vals, mask, c.arrow_type,
                           c.dictionary_host if c.kind == "str" else None)

    def _materialize_name(self, n: str):
        import pyarrow as pa

        if self.struct_specs and n in self.struct_specs:
            names, vplane, t = self.struct_specs[n]
            children = [self._materialize_name(cn) for _sub, cn in names]
            mask = None
            if vplane is not None:
                valid = (_unpack_plane_tiled(vplane, 1) != 0)[: self.num_rows].cpu().numpy()
                mask = pa.array(~valid)
            return pa.StructArray.from_arrays(children, fields=list(_pa_of(t)), mask=mask)
        return self._materialize_pa(self.columns[n])

    def to_arrow(self, columns: Optional[Sequence[str]] = None):
        """Natural-order host materialization as a ``pa.Table``; a struct
        reassembles from its ``parent.child`` columns."""
        import pyarrow as pa

        names = list(columns) if columns is not None else list(
            self.field_order or self.columns
        )
        return pa.table({n: self._materialize_name(n) for n in names})

    def list_sum(self, name: str) -> torch.Tensor:
        """Per-row sum of a list column of numbers: the lengths plane
        decodes through K1 into int64 offsets (a cumsum; the reference's is
        int32), the leaf planes through K1, null leaves and null rows
        count 0, then ``list_segment_sum``.  Integer sums are int64, float
        sums keep the leaf type.  A list of strings, bools, lists or
        structs raises, as in the reference (resident.py:620-676)."""
        c = self.columns[name]
        if c.kind != "list":
            raise OutOfSpecError(f"{name!r} is not a list column")
        child = c.child
        if child.kind not in ("int", "f32", "f64"):
            raise NotYetImplementedError(f"list_sum over list<{child.kind}>")
        lengths = self._natural(c).to(torch.int64)
        offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64, device=lengths.device)
        torch.cumsum(lengths, 0, out=offsets[1:])
        vals = self._natural(child)
        if not vals.is_floating_point():
            vals = vals.to(torch.int64)
        if child.validity_plane is not None:
            cv = (_unpack_plane_tiled(child.validity_plane, 1) != 0)[: child.length]
            vals = torch.where(cv, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        sums = list_segment_sum(vals, offsets, self.num_rows)
        valid = self.validity_natural(name)
        if valid is not None:
            sums = torch.where(valid, sums, torch.zeros((), dtype=sums.dtype, device=sums.device))
        return sums

    # -- bound translation ---------------------------------------------

    def _bounds(self, predicates, pcols):
        """``((column, lo, hi), ...)``: each literal in the column's
        compared space (``ResidentColumn.compare_bounds``) cast to its
        compared dtype (int32 for codes) as a host scalar, None where
        open, cached by value.  Both routes of filter_sum compare against
        these."""
        key = tuple((c,) + tuple(predicates[c]) for c in pcols)
        hit = self._bounds_cache.get(key)
        if hit is None:
            hit = []
            for cname in pcols:
                c = self.columns[cname]
                dt = torch.int32 if c.is_dict else c.decoded_dtype()
                hit.append((cname,) + tuple(
                    None if b is None else torch.tensor(b, dtype=dt).item()
                    for b in c.compare_bounds(*predicates[cname])))
            hit = self._bounds_cache[key] = tuple(hit)
        return hit

    def _live_rows(self) -> int:
        """The real rows as ``mask_tiled`` marks them (its True prefix: the
        padding is the tail), the row count K7 takes, so that both routes
        of filter_sum read which slots are real from the one mask.
        Counted once a table."""
        if self._live is None:
            self._live = int(self.mask_tiled().sum())
        return self._live

    def _query_inputs(self, names, value_cols, code_cols, predicates, pcols):
        """Decode what a fused query reads: values (through the dictionary)
        for ``value_cols``, code space for ``code_cols`` (span
        ``strawboat.query.decode``); plus the row mask (padding, nulls of
        every read column, the predicates; span ``.filter``)."""
        cols, codes, valids = {}, {}, []
        read = [self.columns[n] for n in names]
        with obs.span("strawboat.query.decode", device=self.device):
            for n, c, vals, valid in zip(names, read, *_unpack_columns(read)):
                if n in value_cols:
                    cols[n] = c.combine(vals, True)
                if n in code_cols:
                    codes[n] = c.combine(vals, False)
                valids.append(valid)
        with obs.span("strawboat.query.filter"):
            m = kept_rows(self.mask_tiled(), valids, self._bounds(predicates, pcols), codes)
        return cols, codes, m

    # -- order-invariant fused query ops --------------------------------

    def filter_sum(
        self,
        predicates: Dict[str, Tuple[Optional[float], Optional[float]]],
        value: str,
        product_with: Optional[str] = None,
    ) -> torch.Tensor:
        """sum(value [* product_with]) where every predicate column is in
        [lo, hi) — the Q6 shape.  Bounds are half-open, None = unbounded;
        dict predicate columns compare in code space; null rows never count.
        Returns a 0-d int64 (float64 for float values) device tensor.
        Narrow integer columns take K7 (``kernels/filter_sum.py``) over K1's
        words (``_k7_takes``); any other call takes the torch passes and
        counts in ``k7.torch_routes``.  A ``strawboat.query`` root span
        (``path="filter_sum"``) with ``.plan``, ``.decode``, ``.filter``
        and ``.aggregate``."""
        with obs.span("strawboat.query", path="filter_sum"):
            with obs.span("strawboat.query.plan"):
                pcols = tuple(sorted(predicates))
                extra = (product_with,) if product_with else ()
                names = list(dict.fromkeys(pcols + (value,) + extra))
                on_k7 = self._k7_takes(names, pcols, (value,) + extra)
                if not on_k7:
                    obs.count("k7.torch_routes")
            if on_k7:
                return self._filter_sum_k7(names, predicates, pcols, value, product_with)
            cols, _codes, m = self._query_inputs(
                names, {value, *extra}, set(pcols), predicates, pcols
            )
            with obs.span("strawboat.query.aggregate", device=self.device):
                acc = cols[value]
                if product_with is not None:
                    if not acc.is_floating_point():
                        acc = acc.long()
                    acc = acc * cols[product_with]
                if acc.is_floating_point():
                    return torch.where(m, acc, 0).sum(dtype=torch.float64)
                return torch.where(m, acc, 0).sum(dtype=torch.int64)

    def _k7_takes(self, names, pcols, summed) -> bool:
        """Whether K7 takes a filter_sum: the summed columns narrow plain
        integers (one ≤31-bit plane, no offset: the values are K1's words),
        each predicate column such an integer or a dictionary column
        compared in code space (``ResidentColumn.words_are``), no float,
        and at most ``K7_MAX_INPUTS`` planes and validity planes in all."""
        cols = self.columns
        if not all(cols[n].words_are == "values" for n in summed):
            return False
        if not all(cols[n].words_are is not None for n in pcols):
            return False
        inputs = sum(1 + (cols[n].validity_plane is not None) for n in names)
        return inputs <= K7_MAX_INPUTS

    def _filter_sum_k7(self, names, predicates, pcols, value, product_with):
        """filter_sum through K7 over K1's words: ``.decode`` is the one K1
        call, ``.filter`` the bounds and the live rows on the host,
        ``.aggregate`` the K7 launch."""
        read = [self.columns[n] for n in names]
        with obs.span("strawboat.query.decode", device=self.device):
            vals, valid = _unpack_columns(read, validity_words=True)
        words = {n: v[0] for n, v in zip(names, vals)}
        with obs.span("strawboat.query.filter"):
            bounds = [(words[n], lo, hi) for n, lo, hi in self._bounds(predicates, pcols)]
            live = self._live_rows()
        with obs.span("strawboat.query.aggregate", device=self.device):
            return k7_filter_sum(
                words[value], live,
                words[product_with] if product_with else None,
                bounds, [v for v in valid if v is not None])

    def group_sum(
        self,
        key: str,
        values: Sequence[str],
        num_groups: int,
        predicates: Optional[Dict[str, Tuple[Optional[float], Optional[float]]]] = None,
    ):
        """Per-group sums + counts over dense integer keys in [0, num_groups)
        (``aggregate.group_sums``).  Dict key columns group by (sorted)
        code.  Returns ``([sums per value column], counts)``; keys outside
        the range are dropped.  Spans as :meth:`filter_sum`'s, under
        ``path="group_sum"``."""
        with obs.span("strawboat.query", path="group_sum"):
            with obs.span("strawboat.query.plan"):
                predicates = predicates or {}
                pcols = tuple(sorted(predicates))
                names = list(dict.fromkeys((key,) + tuple(values) + pcols))
            cols, codes, m = self._query_inputs(
                names, set(values), set(pcols) | {key}, predicates, pcols
            )
            with obs.span("strawboat.query.aggregate", device=self.device):
                return group_sums(codes[key].to(torch.int32), [cols[v] for v in values],
                                  num_groups, m)


def kept_rows(base, valid, bounds, codes):
    """The mask of the rows a resident query keeps: ``base`` (the real
    slots, or None where the planes are already cut at the real row
    count) and-ed with each read column's validity in ``valid`` (None: no
    nulls) and with each ``(column, lo, hi)`` of ``bounds`` over that
    column's ``codes`` (its compared space; None ends open).  None where
    nothing narrows it: every row is kept."""
    def keeps():
        yield from (v for v in valid if v is not None)
        for cname, lo, hi in bounds:
            if lo is not None:
                yield codes[cname] >= lo
            if hi is not None:
                yield codes[cname] < hi

    m = base
    for keep in keeps():
        m = keep if m is None else m & keep
    return m


# ---------------------------------------------------------------------------
# Loader: host encode decisions → planes packed on the host or the device.
# ---------------------------------------------------------------------------


def _slots_for(n: int, tile: int) -> int:
    """Tiled slot count for n rows — matches ``_pack_plane``'s padding."""
    lanes = (-(-max(n, 1) // 128)) * 4
    lanes_final = -(-lanes // tile) * tile
    return lanes_final * 32


def _pack_plane(vals: np.ndarray, bits: int, tile: int, device: torch.device):
    """(n,) uint32 values (< 2^bits) → (n_tiles, bits, tile) int32 words on
    ``device``, pre-permuted so the tiled unpack emits natural row order.
    Large columns move the raw values and pack on the device."""
    if tile % 512:
        raise ValueError(f"tile must be a multiple of 512, got {tile}")
    bits = max(bits, 1)
    if len(vals) >= _DEVICE_PACK_MIN:
        v = np.ascontiguousarray(vals, dtype=np.uint32).view(np.int32)
        return _pack_plane_device(torch.from_numpy(v).to(device), bits, tile)
    slots = _slots_for(len(vals), tile)
    n_tiles = slots // (32 * tile)
    padded = np.zeros(slots, np.uint32)
    padded[: len(vals)] = vals
    # output slot s reads pack-input position src(s); the inverse
    # permutation is a pure reshape/transpose:
    # feed[ti, B, t, l] = slot_order[ti, t, 4B + l]
    feed = np.ascontiguousarray(
        padded.reshape(n_tiles, 32, tile // 4, 4).transpose(0, 2, 1, 3)
    ).reshape(-1)
    words = pack_blocks(feed.reshape(-1, 128), bits)
    wt3 = transpose_words_host_tiled(words.reshape(-1), bits, tile)
    return torch.from_numpy(wt3.view(np.int32)).to(device)


def _pack_plane_device(vals: torch.Tensor, bits: int, tile: int) -> torch.Tensor:
    """(n,) int32 (u32 bits) device values in natural row order (< 2^bits)
    → (n_tiles, bits, tile) packed words: the bit-level inverse of K1."""
    b = max(bits, 1)
    n = int(vals.shape[0])
    slots = _slots_for(n, tile)
    if n < slots:
        vals = torch.cat([vals, vals.new_zeros(slots - n)])
    v3 = vals.view(slots // (32 * tile), 32, tile)
    if 32 % b == 0:
        P = 32 // b
        # value t = j*P + p lives in word j at bit offset p*b
        v4 = v3.view(v3.shape[0], b, P, tile)
        w = v4[:, :, 0, :].clone()
        for p in range(1, P):
            w |= v4[:, :, p, :] << (p * b)
        return w.contiguous()
    # general widths: value t's bits occupy [t*b, (t+1)*b) of the lane's
    # little-endian word stream (they may straddle two words)
    words = [None] * b
    for t in range(32):
        w0, sh = divmod(t * b, 32)
        v_t = v3[:, t, :]
        lo = (v_t << sh) if sh else v_t
        words[w0] = lo if words[w0] is None else (words[w0] | lo)
        if sh + b > 32:
            hi = shr_u32(v_t, 32 - sh)
            words[w0 + 1] = hi if words[w0 + 1] is None else (words[w0 + 1] | hi)
    return torch.stack(words, dim=1)


def _split_planes_device(lo: torch.Tensor, hi: torch.Tensor, total_bits: int, tile: int):
    """Device u32 lo/hi words (int32 bits) → 1–2 packed planes (LSB first)."""
    if total_bits <= 32:
        return ((_pack_plane_device(lo, total_bits, tile), max(total_bits, 1)),), (0,)
    return (
        (_pack_plane_device(lo, 32, tile), 32),
        (_pack_plane_device(hi, total_bits - 32, tile), total_bits - 32),
    ), (0, 32)


def _split_planes(u: np.ndarray, total_bits: int, tile: int, device):
    """u64 payloads → 1–2 packed ≤32-bit planes (LSB first)."""
    if total_bits <= 32:
        plane = _pack_plane(u.astype(np.uint32), total_bits, tile, device)
        return ((plane, max(total_bits, 1)),), (0,)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return (
        (_pack_plane(lo, 32, tile, device), 32),
        (_pack_plane(hi, total_bits - 32, tile, device), total_bits - 32),
    ), (0, 32)


def _try_dict(vals: np.ndarray):
    """Sorted-unique dictionary + codes, or None when cardinality is high.
    A strided sample gates the full pass; the pass is the native
    first-occurrence intern when available, else ``np.unique``."""
    n = len(vals)
    if n == 0:
        return None
    if n > (1 << 17):
        sample = vals[:: max(1, n // 65536)]
        if np.unique(sample).size > (1 << 14):
            return None
    if vals.dtype.itemsize in (4, 8) and n >= 4096 and native.available():
        kind = np.uint32 if vals.dtype.itemsize == 4 else np.uint64
        r = native.factorize(np.ascontiguousarray(vals).view(kind), max_uniq=_MAX_DICT)
        if r is None:
            return None  # unique count exceeded _MAX_DICT mid-pass
        codes_f, uniq_bits = r
        uniq = uniq_bits.view(vals.dtype)
        order = np.argsort(uniq, kind="stable")
        rank = np.empty(len(order), dtype=np.uint32)
        rank[order.astype(np.intp)] = np.arange(len(order), dtype=np.uint32)
        return uniq[order], rank[codes_f]
    uniq, inv = np.unique(vals, return_inverse=True)
    if uniq.size > _MAX_DICT:
        return None
    return uniq, inv.astype(np.uint32)


def _try_dict_int(vals: np.ndarray, vmin: int, vmax: int):
    """Integer dictionary without a sort when the value span is small:
    presence bitmap over [vmin, vmax] + rank table, one O(n) pass."""
    span = vmax - vmin
    if len(vals) == 0:
        return None
    if span >= (1 << 24):  # rank table would outweigh the win
        return _try_dict(vals)
    offs = (vals - np.int64(vmin)).astype(np.int64)
    presence = np.zeros(span + 1, dtype=bool)
    presence[offs] = True
    uniq_off = np.flatnonzero(presence)
    if uniq_off.size > _MAX_DICT:
        return None
    rank = np.empty(span + 1, dtype=np.uint32)
    rank[uniq_off] = np.arange(uniq_off.size, dtype=np.uint32)
    return (uniq_off + vmin).astype(np.int64), rank[offs]


def _bits_of(x: int) -> int:
    return max(int(x).bit_length(), 1)


def _is_wide(arrow_type) -> bool:
    """Arrow storage is 64-bit (int64 / timestamp / date64 / time64 /
    decimal): decode ints to int64."""
    if arrow_type is None:
        return False
    if isinstance(arrow_type, Field):
        return False
    if isinstance(arrow_type, str):
        # duration too, which the reference does not load
        return (arrow_type in ("int64", "uint64", "date64")
                or arrow_type.startswith(("timestamp", "time64", "duration"))
                or decimal_params(arrow_type) is not None)
    import pyarrow as pa

    t = arrow_type
    return (
        (pa.types.is_integer(t) and t.bit_width == 64)
        or pa.types.is_timestamp(t)
        or pa.types.is_date64(t)
        or pa.types.is_time64(t)
        or pa.types.is_decimal(t)
    )


def _encode_int(name, vals: np.ndarray, tile: int, arrow_type, rows, device):
    """int64 values → dict codes or offset-stripped planes."""
    if len(vals):
        vmin, vmax = int(vals.min()), int(vals.max())
    else:
        vmin = vmax = 0
    span_bits = _bits_of(vmax - vmin)  # python ints: no wrap
    offset = 0 if vmin >= 0 and vmax < (1 << 31) else vmin
    plain_bits = span_bits if offset else _bits_of(vmax)
    wide = _is_wide(arrow_type)
    d = _try_dict_int(vals, vmin, vmax)
    if d is not None:
        uniq, codes = d
        code_bits = _bits_of(max(len(uniq) - 1, 1))
        # the reference's cut (a large dictionary stays only when it at
        # least halves the plane), kept so the planes match it
        if len(uniq) > 8192 and code_bits * 2 > plain_bits:
            d = None
        elif code_bits < plain_bits:
            fits32 = vmin >= -(1 << 31) and vmax < (1 << 31)
            dev = torch.from_numpy(
                uniq.astype(np.int32) if fits32 and not wide else uniq.astype(np.int64)
            ).to(device)
            planes, shifts = _split_planes(codes.astype(np.uint64), code_bits, tile, device)
            return ResidentColumn(
                name, planes, shifts, rows, "int",
                wide=wide,
                dictionary=dev,
                dictionary_host=uniq.astype(np.int64),
                arrow_type=arrow_type,
            )
    u = vals.astype(np.uint64) - np.uint64(np.int64(offset).astype(np.uint64))
    planes, shifts = _split_planes(u, plain_bits, tile, device)
    return ResidentColumn(
        name, planes, shifts, rows, "int",
        wide=wide,
        offset=int(np.int64(offset).astype(np.uint64)),
        arrow_type=arrow_type,
    )


def _encode_float(name, vals: np.ndarray, tile: int, arrow_type, rows, device):
    """f32/f64 → dict codes or trailing-zero-stripped offset bitcast planes."""
    is32 = vals.dtype == np.float32
    kind = "f32" if is32 else "f64"
    udt = np.uint32 if is32 else np.uint64
    u = vals.view(udt)
    if len(u):
        orv = int(np.bitwise_or.reduce(u))
        tz = (orv & -orv).bit_length() - 1 if orv else 0
        us = u >> udt(tz)
        off = int(us.min())
        us = us - udt(off)
        bits = _bits_of(int(us.max())) if us.max() else 1
    else:
        tz, off, bits = 0, 0, 1
        us = u
    # the dict path is value-space: NaN and mixed ±0.0 break it, so those
    # take the bit-exact plane path
    has_nan = bool(np.isnan(vals).any()) if len(vals) else False
    zeros = vals == 0
    mixed_zero = bool(
        zeros.any()
        and np.signbit(vals[zeros]).any()
        and not np.signbit(vals[zeros]).all()
    )
    d = None if has_nan or mixed_zero else _try_dict(vals)
    if d is not None:
        uniq, codes = d
        code_bits = _bits_of(max(len(uniq) - 1, 1))
        if code_bits < bits and (len(uniq) <= 8192 or code_bits * 2 <= bits):
            planes, shifts = _split_planes(codes.astype(np.uint64), code_bits, tile, device)
            return ResidentColumn(
                name, planes, shifts, rows, kind,
                dictionary=torch.from_numpy(np.ascontiguousarray(uniq)).to(device),
                dictionary_host=uniq.astype(np.float64) if is32 else uniq,
                arrow_type=arrow_type,
            )
    planes, shifts = _split_planes(us.astype(np.uint64), bits, tile, device)
    return ResidentColumn(
        name, planes, shifts, rows, kind,
        offset=off, bit_shift=tz, arrow_type=arrow_type,
    )


def _string_column(name, codes, dictionary_host, tile, arrow_type, rows, device):
    code_bits = _bits_of(max(len(dictionary_host) - 1, 1))
    planes, shifts = _split_planes(codes.astype(np.uint64), code_bits, tile, device)
    return ResidentColumn(
        name, planes, shifts, rows, "str",
        dictionary_host=dictionary_host,
        arrow_type=arrow_type,
    )


def _too_many_strings(name):
    return NotYetImplementedError(
        f"resident load: string column {name!r} has more than {_MAX_DICT} "
        f"distinct values"
    )


def _encode_string_np(name, arr: np.ndarray, validity, tile, arrow_type, rows, device):
    """numpy unicode/bytes → packed codes + GLOBAL SORTED dictionary: the
    valid rows factorize into codes over their distinct values, and
    :func:`_encode_string_codes` takes the rank and null decisions."""
    src = arr if validity is None else arr[validity]
    uniq = codes_src = None
    if len(src) and src.dtype.itemsize == 4:
        # one-character unicode / 4-byte strings: an O(n) integer intern
        keys = src.view(np.uint32)
        vmin, vmax = int(keys.min()), int(keys.max())
        if vmax - vmin < (1 << 24):
            d = _try_dict_int(keys.astype(np.int64), vmin, vmax)
            if d is None:
                raise _too_many_strings(name)
            uniq = d[0].astype(np.uint32).view(src.dtype)
            codes_src = d[1]
    if uniq is None:
        uniq, codes_src = np.unique(src, return_inverse=True)
    codes = codes_src.reshape(-1)
    if validity is not None:
        codes = np.zeros(rows, dtype=codes_src.dtype)
        codes[validity] = codes_src
    return _encode_string_codes(name, codes, uniq, validity, tile, arrow_type, device)


def _fill_invalid(vals: np.ndarray, validity) -> np.ndarray:
    """Float null slots take the first valid value (keeps plane stats
    tight; the validity plane masks them)."""
    if validity is not None:
        valid_idx = np.flatnonzero(validity)
        vals[~validity] = vals[valid_idx[0]] if valid_idx.size else 0
    return vals


def _encode_resident_column(f, arr, tile: int, device) -> ResidentColumn:
    """One pyarrow column → a resident column, through the column model.
    A decimal wider than int64 (precision above 18, or decimal256) raises,
    as in the reference's loader."""
    import pyarrow as pa

    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    t = f.type
    if pa.types.is_union(t) or (pa.types.is_decimal(t) and (t.bit_width != 128 or t.precision > 18)):
        raise NotYetImplementedError(f"resident load of column {f.name!r} type {t}")
    return _encode_model(f.name, cm.from_arrow(arr), cm.field_from_arrow(f), tile, device)


def _numpy_arrow_alias(dtype: np.dtype) -> str:
    """The arrow type the reference would see for a numpy column."""
    if dtype.kind == "U":
        return "string"
    if dtype.kind == "S":
        return "binary"
    if dtype.kind == "M":
        unit = np.datetime_data(dtype)[0]
        if unit == "D":
            return "date32"
        if unit in ("s", "ms", "us", "ns"):
            return f"timestamp[{unit}]"
        raise NotYetImplementedError(f"resident load of datetime64[{unit}]")
    if dtype.kind in "iufb" and dtype != np.float16:
        return "bool" if dtype.kind == "b" else str(dtype)
    raise NotYetImplementedError(f"resident load of numpy dtype {dtype}")


def _encode_numpy_column(name: str, arr, tile: int, device, arrow_type=None) -> ResidentColumn:
    """One numpy column (a ``np.ma.MaskedArray`` for nulls: mask True =
    null) → a flat resident column, encoded as its arrow counterpart
    (``arrow_type`` when given: a decimal alias over unscaled int64)."""
    validity = None
    if isinstance(arr, np.ma.MaskedArray):
        null = np.ma.getmaskarray(arr)
        if null.any():
            validity = ~null
        arr = np.ma.getdata(arr)
    arr = np.asarray(arr)
    if arr.ndim != 1:
        raise OutOfSpecError(f"column {name!r} must be 1-D, got shape {arr.shape}")
    rows = len(arr)
    t = _numpy_arrow_alias(arr.dtype) if arrow_type is None else arrow_type
    if t in ("string", "binary"):
        col = _encode_string_np(name, arr, validity, tile, t, rows, device)
    elif t == "bool":
        v01 = arr.astype(np.uint32)
        if validity is not None:
            v01[~validity] = 0
        planes = ((_pack_plane(v01, 1, tile, device), 1),)
        col = ResidentColumn(name, planes, (0,), rows, "bool", arrow_type=t)
    elif arr.dtype.kind == "f":
        vals = _fill_invalid(arr.copy(), validity)
        col = _encode_float(name, np.ascontiguousarray(vals), tile, t, rows, device)
    else:
        vals = (arr.view(np.int64) if arr.dtype.kind == "M" else arr).astype(np.int64)
        if validity is not None:
            vals[~validity] = 0
        col = _encode_int(name, np.ascontiguousarray(vals), tile, t, rows, device)
    if validity is not None:
        col.validity_plane = _pack_plane(validity.astype(np.uint32), 1, tile, device)
    return col


# ---------------------------------------------------------------------------
# Device-direct encode: a DeviceTable (a scan or join result on the device)
# → planes, without a host round trip (reference resident.py:1276-1478).
# Integers (and unscaled decimals) always take offset-stripped planes (no
# dictionary), f32 its bit pattern, string codes remap onto the sorted
# dictionary; f64 takes the host encoder, as in the reference.


def _encode_int_device(c: DeviceColumn, tile: int, rows: int) -> ResidentColumn:
    v = widen_i64(c.values[:rows], unsigned_view(c))
    validity = None if c.validity is None else c.validity[:rows]
    vmin = vmax = 0
    if rows:
        if validity is None:
            vmin, vmax = int(v.min()), int(v.max())
        else:
            big = torch.iinfo(torch.int64).max
            vmin = int(torch.where(validity, v, big).min())
            vmax = int(torch.where(validity, v, -big - 1).max())
            if vmin > vmax:  # all null
                vmin = vmax = 0
    span_bits = _bits_of(vmax - vmin)
    offset = 0 if vmin >= 0 and vmax < (1 << 31) else vmin
    plain_bits = span_bits if offset else _bits_of(vmax)
    if validity is not None:
        v = torch.where(validity, v, vmin)
    u = v - offset  # the u64 payload, int64 wrap
    lo = (u & U32_MASK).to(torch.int32)
    hi = ((u >> 32) & U32_MASK).to(torch.int32)
    planes, shifts = _split_planes_device(lo, hi, plain_bits, tile)
    return ResidentColumn(
        c.name, planes, shifts, rows, "int",
        wide=_is_wide(c.dtype),
        offset=int(np.int64(offset).astype(np.uint64)),
        arrow_type=c.dtype,
    )


def _encode_f32_device(c: DeviceColumn, tile: int, rows: int) -> ResidentColumn:
    u = c.values[:rows].view(torch.int32)
    if c.validity is not None:
        u = torch.where(c.validity[:rows], u, 0)
    planes, shifts = _split_planes_device(u, u, 32, tile)
    return ResidentColumn(c.name, planes, shifts, rows, "f32", arrow_type=c.dtype)


def _encode_dictcol_device(c: DeviceColumn, tile: int, rows: int) -> ResidentColumn:
    """String/binary codes + host dictionary → packed codes over the sorted
    dictionary (one device gather through the rank table)."""
    d = c.dictionary
    if len(d) > _MAX_DICT:
        raise NotYetImplementedError(f"resident encode: column {c.name!r} dictionary too large")
    order = np.argsort(d, kind="stable")
    rank = np.empty(max(len(d), 1), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    codes = c.values[:rows].to(torch.int64)
    if c.validity is not None:
        codes = torch.where(c.validity[:rows], codes, 0)
    rank_t = torch.from_numpy(rank).to(codes.device)
    new_codes = dict_gather_device(codes.clamp(0, max(len(d) - 1, 0)), rank_t)
    code_bits = _bits_of(max(len(d) - 1, 1))
    planes, shifts = _split_planes_device(new_codes, new_codes, code_bits, tile)
    return ResidentColumn(
        c.name, planes, shifts, rows, "str",
        dictionary_host=np.asarray(d[order], dtype=object),
        arrow_type=c.dtype,
    )


def _encode_device_column(c: DeviceColumn, tile: int, rows: int) -> ResidentColumn:
    vdt = c.values.dtype
    if c.dictionary is not None:
        col = _encode_dictcol_device(c, tile, rows)
    elif vdt == torch.bool:
        v = c.values[:rows]
        if c.validity is not None:
            v = v & c.validity[:rows]
        planes = ((_pack_plane_device(v.to(torch.int32), 1, tile), 1),)
        col = ResidentColumn(c.name, planes, (0,), rows, "bool", arrow_type=c.dtype)
    elif vdt == torch.float64:
        # the dictionary decisions of the host encoder, over the device
        # column's values (exact on the GPU); null slots take the first
        # valid value first, where the reference leaves them as they are
        # (ROADMAP.md, reference faults: NaN bits there cost it the
        # dictionary), so the planes differ from its only at null slots
        vals = c.values[:rows].cpu().numpy().copy()
        validity = None if c.validity is None else c.validity[:rows].cpu().numpy()
        vals = _fill_invalid(vals, validity)
        col = _encode_float(c.name, vals, tile, c.dtype, rows, c.values.device)
    elif vdt == torch.float32:
        col = _encode_f32_device(c, tile, rows)
    elif not vdt.is_floating_point and not vdt.is_complex:
        col = _encode_int_device(c, tile, rows)
    else:  # float16, as in the reference's loaders
        raise NotYetImplementedError(
            f"device-direct resident encode of column {c.name!r} dtype {vdt}/{c.dtype}"
        )
    if c.validity is not None:
        col.validity_plane = _pack_plane_device(c.validity[:rows].to(torch.int32), 1, tile)
    return col


# ---------------------------------------------------------------------------
# Nested columns: the host encoder over the column model (``columns.py``),
# the reference's _encode_resident_column list / map / struct branches
# (resident.py:1098-1180) without pyarrow.


@dataclass
class _Codes:
    """A string column as codes into a host dictionary (a scan's)."""

    dtype: str
    validity: Optional[np.ndarray]
    codes: np.ndarray
    dictionary: np.ndarray

    def __len__(self) -> int:
        return len(self.codes)

    def slice(self, offset: int, length: int) -> "_Codes":
        v = None if self.validity is None else self.validity[offset : offset + length]
        return _Codes(self.dtype, v, self.codes[offset : offset + length], self.dictionary)

    def take(self, idx: np.ndarray) -> "_Codes":
        v = None if self.validity is None else self.validity[idx]
        return _Codes(self.dtype, v, self.codes[idx], self.dictionary)


def _flatten_rows(col, offsets: np.ndarray, validity):
    """A list's children in its row window, those under null rows left out
    (arrow's ``list_flatten``)."""
    base, end = int(offsets[0]), int(offsets[-1])
    lens = np.diff(offsets)
    if validity is None or not (lens[~validity] != 0).any():
        return col.slice(base, end - base)
    rows = np.flatnonzero(validity)
    return col.take(cm._ranges(offsets[rows], lens[rows]))


def _encode_model(name: str, col, f: Field, tile: int, device) -> ResidentColumn:
    """One column of the host model (a string column may be ``_Codes``) →
    a resident column.  A list's LENGTHS plane (null rows 0) lies on the
    row grid and its children, flattened, form the child column ``name
    + ".item"``; a map's child is the struct ``name + ".entries"`` of its
    ``.key`` and ``.value`` columns; a struct keeps its children on its
    grid.  A fixed-size list (which the reference does not load) keeps
    every row's slots, so its lengths are all ``size``."""
    rows = len(col)
    validity = col.validity
    if validity is not None and validity.all():
        validity = None
    t = f.dtype
    if t == NULL_TYPE or fixed_binary_width(t) is not None:  # as the reference's loader (:1175)
        raise NotYetImplementedError(f"resident load of column {name!r} type {t}")
    if isinstance(col, (_Codes, cm.BinaryColumn)):
        if isinstance(col, cm.BinaryColumn):
            from ..codecs.binary import factorize_slices

            starts = col.offsets[:-1].astype(np.int64)
            codes, uniq = factorize_slices(starts, np.diff(col.offsets).astype(np.int64), col.values)
            dictionary = np.empty(len(uniq), dtype=object)
            dictionary[:] = uniq
        else:
            codes, dictionary = col.codes.astype(np.int64), col.dictionary
        rc = _encode_string_codes(name, codes, dictionary, validity, tile, t, device)
    elif isinstance(col, cm.BooleanColumn):
        v01 = col.values.astype(np.uint32)
        if validity is not None:
            v01[~validity] = 0
        rc = ResidentColumn(name, ((_pack_plane(v01, 1, tile, device), 1),), (0,), rows, "bool",
                            arrow_type=t)
    elif isinstance(col, cm.PrimitiveColumn) and decimal_params(t) is not None:
        from ..codecs.decimal import int64_rows

        vals = col.values
        if vals.ndim == 2:
            vals, fits = int64_rows(vals)
            if validity is not None:
                fits = fits | ~validity
            if not fits.all():
                raise OutOfSpecError(f"decimal column {name!r}: an unscaled value beyond int64")
        vals = vals.astype(np.int64)
        if validity is not None:
            vals[~validity] = 0
        rc = _encode_int(name, np.ascontiguousarray(vals), tile, t, rows, device)
    elif isinstance(col, cm.PrimitiveColumn) and col.values.dtype.kind == "f":
        if col.values.dtype == np.float16:
            raise NotYetImplementedError("resident load of float16")
        vals = _fill_invalid(col.values.copy(), validity)
        rc = _encode_float(name, np.ascontiguousarray(vals), tile, t, rows, device)
    elif isinstance(col, cm.PrimitiveColumn):
        vals = col.values.astype(np.int64)
        if validity is not None:
            vals[~validity] = 0
        rc = _encode_int(name, np.ascontiguousarray(vals), tile, t, rows, device)
    elif isinstance(col, (cm.ListColumn, cm.FixedSizeListColumn)):
        cf = f.children[0]
        if isinstance(col, cm.FixedSizeListColumn):
            lengths = np.full(rows, col.size, dtype=np.int64)
            child = col.child
        else:
            offsets = col.offsets.astype(np.int64)
            lengths = np.diff(offsets)
            child = _flatten_rows(col.child, offsets, validity)
            if validity is not None:
                lengths[~validity] = 0
        child_rc = _encode_model(f"{name}.item", child,
                                 Field(f"{name}.item", cf.dtype, True, cf.children), tile, device)
        rc = _lengths_column(name, lengths, tile, f, child_rc, device)
    elif isinstance(col, cm.MapColumn):
        offsets = col.offsets.astype(np.int64)
        base, end = int(offsets[0]), int(offsets[-1])
        entries = f.children[0]
        key_f, value_f = entries.children
        children = {
            "key": _encode_model(f"{name}.key", col.keys.slice(base, end - base),
                                 Field(f"{name}.key", key_f.dtype, True, key_f.children),
                                 tile, device),
            "value": _encode_model(f"{name}.value", col.items.slice(base, end - base),
                                   Field(f"{name}.value", value_f.dtype, True, value_f.children),
                                   tile, device),
        }
        ent = ResidentColumn(f"{name}.entries", (), (), end - base, "struct",
                             arrow_type=entries, children=children)
        rc = _lengths_column(name, np.diff(offsets), tile, f, ent, device)
    elif isinstance(col, cm.StructColumn):
        children = {
            cf.name: _encode_model(f"{name}.{cf.name}", c,
                                   Field(f"{name}.{cf.name}", cf.dtype, True, cf.children),
                                   tile, device)
            for c, cf in zip(col.children, f.children)
        }
        rc = ResidentColumn(name, (), (), rows, "struct", arrow_type=f, children=children)
    else:
        raise NotYetImplementedError(f"resident load of column {name!r} type {t}")
    if validity is not None:
        rc.validity_plane = _pack_plane(validity.astype(np.uint32), 1, tile, device)
    return rc


def _lengths_column(name, lengths: np.ndarray, tile, f: Field, child, device) -> ResidentColumn:
    bits = _bits_of(int(lengths.max())) if len(lengths) and lengths.max() else 1
    planes, shifts = _split_planes(lengths.astype(np.uint64), bits, tile, device)
    return ResidentColumn(name, planes, shifts, len(lengths), "list", arrow_type=f, child=child)


def _leaf_model(c: DeviceColumn, validity):
    """A scanned leaf's values back on the host, as the column model."""
    vals = c.values.cpu().numpy()
    if c.dictionary is not None:
        return _Codes(c.dtype, validity, vals, c.dictionary)
    if vals.dtype == np.bool_:
        return cm.BooleanColumn(c.dtype, validity, vals)
    storage = int_storage(c.dtype)
    if storage is not None and vals.dtype.itemsize == np.dtype(storage).itemsize:
        vals = vals.view(storage)
    return cm.PrimitiveColumn(c.dtype, validity, vals)


def _np(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy()


def _list_model(c: DeviceListColumn):
    """A ``DeviceListColumn`` → (its column model: a list per level of its
    offsets stack over the leaf, its field: plain lists, or large lists
    where the scanned level was one)."""
    model = _leaf_model(c, _np(c.child_validity))
    f = Field("item", c.dtype)
    kinds = ["large_list" if lf.dtype == "large_list" else "list" for lf in c.level_fields]
    for offs, valid, kind in reversed(list(zip(c.offsets_stack, c.list_validities, kinds))):
        offs = offs.cpu().numpy()
        model = cm.ListColumn(kind, _np(valid), offs, model)
        f = Field("item", kind, True, (f,))
    return model, Field(c.name, f.dtype, True, f.children)


def _assemble(f: Field, leaves, depth: int = 0):
    """A scanned nested field's leaves ((levels, leaf model) each) → its
    column model (reference ``assemble_column``, read/deserialize.py:142)."""
    if not f.is_nested:
        return leaves[0][1]
    level = leaves[0][0][depth]
    validity = level.validity if level.nullable else None
    if f.dtype == "struct":
        children, i = [], 0
        for cf in f.children:
            children.append(_assemble(cf, leaves[i : i + cf.n_leaves], depth + 1))
            i += cf.n_leaves
        return cm.StructColumn(f.dtype, validity, children, level.length)
    if f.dtype.startswith("map"):
        key_f, value_f = f.children[0].children
        n = key_f.n_leaves
        return cm.MapColumn(f.dtype, validity, level.offsets,
                            _assemble(key_f, leaves[:n], depth + 2),
                            _assemble(value_f, leaves[n:], depth + 2))
    child = _assemble(f.children[0], leaves, depth + 1)
    size = fixed_size(f.dtype)
    if size is not None:
        return cm.FixedSizeListColumn(f.dtype, validity, size, child, level.length)
    return cm.ListColumn(f.dtype, validity, level.offsets, child)


def _host_model(dt: DeviceTable, n: str):
    """A column of a ``DeviceTable`` back on the host as (its column model,
    its field): a flat column by name, a nested field of ``dt.nested`` by
    its name (assembled from its leaves), or a ``DeviceListColumn`` as its
    chain of lists."""
    if n in dt.nested:
        f, leaves = dt.nested[n]
        parts = [(leaf.levels, _leaf_model(dt[leaf.name], _np(
            dt[leaf.name].child_validity if isinstance(dt[leaf.name], DeviceListColumn)
            else dt[leaf.name].validity))) for leaf in leaves]
        return _assemble(f, parts), f
    c = dt[n]
    if isinstance(c, DeviceListColumn):
        return _list_model(c)
    return _leaf_model(c, _np(c.validity)), Field(n, c.dtype)


def _host_encoder(dt: DeviceTable, tile: int, device):
    """Encoding of a ``DeviceTable``'s columns on the host (the reference's
    loaders' decisions, so planes match them word for word) →
    ``encode(name)`` over :func:`_host_model`."""

    def encode(n):
        return _encode_model(n, *_host_model(dt, n), tile, device)

    return encode


def _concat_validity(cols) -> Optional[np.ndarray]:
    if all(c.validity is None for c in cols):
        return None
    return np.concatenate([np.ones(len(c), dtype=bool) if c.validity is None else c.validity
                           for c in cols])


def _concat_offsets(cols):
    """The parts' offsets rebased onto one int64 run, and each part's
    child window (start, length)."""
    out, windows, base = [np.zeros(1, dtype=np.int64)], [], 0
    for c in cols:
        offs = c.offsets.astype(np.int64)
        out.append(offs[1:] - offs[0] + base)
        windows.append((int(offs[0]), int(offs[-1] - offs[0])))
        base += int(offs[-1] - offs[0])
    return np.concatenate(out), windows


def _concat_models(name: str, cols):
    """Column models of one column over several parts → one model (the
    host side of ``pa.concat_tables``): string codes remapped into the
    parts' merged dictionary, list and map offsets rebased in int64,
    children concatenated level by level."""
    first = cols[0]
    if len(cols) == 1:
        return first
    if any(type(c) is not type(first) for c in cols):
        raise OutOfSpecError(f"column {name!r} differs in kind across dataset parts")
    validity = _concat_validity(cols)
    if isinstance(first, _Codes):
        from .dataset import _merge_dictionaries

        gdict, tables = _merge_dictionaries([c.dictionary for c in cols])
        codes = np.concatenate([t[c.codes] if len(t) else np.zeros(len(c), dtype=np.int32)
                                for c, t in zip(cols, tables)])
        return _Codes(first.dtype, validity, codes, gdict)
    if isinstance(first, (cm.PrimitiveColumn, cm.BooleanColumn)):
        return type(first)(first.dtype, validity, np.concatenate([c.values for c in cols]))
    if isinstance(first, cm.ListColumn):
        offsets, windows = _concat_offsets(cols)
        child = _concat_models(name, [c.child.slice(*w) for c, w in zip(cols, windows)])
        return cm.ListColumn(first.dtype, validity, offsets, child)
    if isinstance(first, cm.MapColumn):
        offsets, windows = _concat_offsets(cols)
        keys = _concat_models(name, [c.keys.slice(*w) for c, w in zip(cols, windows)])
        items = _concat_models(name, [c.items.slice(*w) for c, w in zip(cols, windows)])
        return cm.MapColumn(first.dtype, validity, offsets, keys, items)
    if isinstance(first, cm.FixedSizeListColumn):
        child = _concat_models(name, [c.child.slice(0, len(c) * c.size) for c in cols])
        return cm.FixedSizeListColumn(first.dtype, validity, first.size, child,
                                      sum(len(c) for c in cols))
    if isinstance(first, cm.StructColumn):
        children = [_concat_models(name, list(kids)) for kids in zip(*(c.children for c in cols))]
        return cm.StructColumn(first.dtype, validity, children, sum(len(c) for c in cols))
    raise NotYetImplementedError(f"dataset load of column {name!r} ({type(first).__name__})")


def _column_names(dt: DeviceTable, want) -> List[str]:
    """The top-level columns of a scan, a nested field once by its name;
    ``want`` picks and orders them (names the scan lacks are skipped)."""
    present = set(dt.columns) | set(dt.nested)
    owner = {leaf.name: n for n, (_f, leaves) in dt.nested.items() for leaf in leaves}
    if want is not None:
        return [n for n in want if n in present]
    return list(dict.fromkeys(owner.get(n, n) for n in dt.columns))


def _load_parts(paths, dev, want, tile: int) -> ResidentTable:
    """Each part scanned on ``dev`` and brought back as host column models,
    the models concatenated, then the host encoder over the whole table:
    the dictionary decisions see the concatenated column, as the
    reference's ``pa.concat_tables`` + ``make_resident`` do."""
    from .scan import scan_file

    names, fields, parts = None, None, []
    for p in paths:
        dt = scan_file(p, dev, columns=want)
        part_names = _column_names(dt, want)
        models = [_host_model(dt, n) for n in part_names]
        del dt
        if names is None:
            names, fields = part_names, [f for _m, f in models]
        elif part_names != names or [f for _m, f in models] != fields:
            raise OutOfSpecError(f"dataset part {p!r} disagrees on its columns or their types")
        parts.append([m for m, _f in models])
    whole = {n: _concat_models(n, list(cols)) for n, cols in zip(names, zip(*parts))}
    fields = dict(zip(names, fields))
    encoded = _encode_all(lambda n: _encode_model(n, whole[n], fields[n], tile, dev), names)
    return _resident_table(names, encoded, tile)


def _make_resident_device(dt: DeviceTable, tile: int, device: torch.device) -> ResidentTable:
    rows = int(dt.num_rows)
    out: Dict[str, ResidentColumn] = {}
    for name, c in dt.columns.items():
        if c.values.device != device:
            c = DeviceColumn(
                c.name, c.dtype, c.values.to(device),
                None if c.validity is None else c.validity.to(device), c.dictionary,
            )
        out[name] = _encode_device_column(c, tile, rows)
    if not out:
        raise OutOfSpecError("no loadable columns")
    return ResidentTable(out, rows, tile)


def _encode_all(encode, items):
    """Encode columns in threads (numpy and arrow release the GIL in their
    hot loops), like the reference loader."""
    if len(items) <= 1:
        return [encode(it) for it in items]
    with cf.ThreadPoolExecutor(max_workers=min(len(items), os.cpu_count() or 2)) as pool:
        return list(pool.map(encode, items))


def make_resident(table, device, tile: Optional[int] = None,
                  schema: Optional[Sequence[Field]] = None) -> ResidentTable:
    """Build a resident table on ``device`` from a ``pa.Table``, from a
    mapping ``{name: numpy column or columns.py column}``, or from a
    ``DeviceTable``.

    numpy columns encode as the arrow type the reference would see: int64 →
    int64 (decoded wide), int32 → int32, unicode → string, bytes → binary,
    float, bool, datetime64[D] → date32; a ``np.ma.MaskedArray`` carries
    nulls.  A nested ``columns.py`` column (list, large_list, fixed-size
    list, map, struct) needs its field in ``schema``.  A ``DeviceTable`` (a
    scan or join result) encodes on the device itself, as the reference's
    device-direct encoder does: integers take offset-stripped planes and
    never a dictionary; a table with a ``DeviceListColumn`` encodes every
    column on the host from the columns' own arrays, as the reference
    falls back to its host encoder (resident.py:1492-1496)."""
    dev = as_device(device)
    tile = tile or TILE3D
    if isinstance(table, Mapping):
        names = list(table)
        fields = {f.name: f for f in schema or ()}

        def encode(n):
            col = table[n]
            if isinstance(col, cm.Column):
                f = fields.get(n)
                if f is None:
                    if isinstance(col, (cm.ListColumn, cm.FixedSizeListColumn, cm.MapColumn,
                                        cm.StructColumn)):
                        raise OutOfSpecError(f"nested column {n!r} needs its field in schema")
                    f = Field(n, col.dtype)
                return _encode_model(n, col, f, tile, dev)
            return _encode_numpy_column(n, col, tile, dev)

        encoded = _encode_all(encode, names)
    elif isinstance(table, DeviceTable):
        if not any(isinstance(c, DeviceListColumn) for c in table.columns.values()):
            return _make_resident_device(table, tile, dev)
        names = list(table.columns)
        encoded = _encode_all(_host_encoder(DeviceTable(table.columns, table.num_rows), tile, dev),
                              names)
    else:
        import pyarrow as pa

        if not isinstance(table, pa.Table):
            raise TypeError(f"expected a pa.Table or a mapping, got {type(table)}")
        table = table.combine_chunks()
        fields = list(table.schema)
        names = [f.name for f in fields]
        encoded = _encode_all(
            lambda f: _encode_resident_column(f, table.column(f.name), tile, dev),
            fields,
        )
    return _resident_table(names, encoded, tile)


def _resident_table(names, encoded, tile: int) -> ResidentTable:
    """Admit the encoded columns on one row grid; a struct unnests into its
    ``parent.child`` columns (recursively) and is recorded in
    ``struct_specs`` (reference ``make_resident``, resident.py:1521-1559)."""
    if not encoded:
        raise OutOfSpecError("no loadable columns")
    out: Dict[str, ResidentColumn] = {}
    specs: Dict[str, Any] = {}

    def admit(name, col):
        if col.kind == "struct":
            for sub, child in col.children.items():
                admit(f"{name}.{sub}", child)
            specs[name] = (tuple((sub, f"{name}.{sub}") for sub in col.children),
                           col.validity_plane, col.arrow_type)
            return
        first = next(iter(out.values()), None)
        if first is not None and (col.length != first.length
                                  or col.tiled_slots != first.tiled_slots):
            raise OutOfSpecError(f"resident columns disagree on row grid: {name!r}")
        out[name] = col

    for name, col in zip(names, encoded):
        admit(name, col)
    if not out:
        raise OutOfSpecError("no loadable columns")
    rows = next(iter(out.values())).length
    return ResidentTable(out, rows, tile, field_order=list(names), struct_specs=specs or None)


def load_resident(
    path, device, columns: Optional[Sequence[str]] = None, tile: Optional[int] = None
) -> ResidentTable:
    """Load a file's (or a dataset's) columns as a resident table on
    ``device``.

    The file scans onto ``device`` (``scan_file``), the columns come back
    to the host and take the host encoder, so the planes equal the
    reference's ``load_resident`` word for word: the host encoder takes
    the dictionary decisions the device-direct one does not.  A string
    column comes back as its codes and is encoded as ``dictionary[codes]``
    would be (:func:`_encode_string_codes`); a decimal as its unscaled
    int64 (also decimal256, which the reference refuses); float16 raises,
    as there.  A nested column assembles from its scanned leaves and
    levels (lists, maps and structs at any depth; fixed-size lists and
    durations too, which the reference refuses).  ``columns`` picks and
    orders top-level columns; names the file lacks are skipped.

    ``path`` may also be a glob or a list of part files (a dataset): each
    part scans on ``device`` and comes back to the host, the parts'
    columns concatenate there (list columns too, which ``scan_dataset``
    refuses), and the host encoder takes the whole table, as the
    reference's ``load_resident`` concatenates its parts before encoding
    (resident.py:1586-1594)."""
    from .dataset import resolve_paths
    from .scan import scan_file

    dev = as_device(device)
    tile = tile or TILE3D
    want = list(columns) if columns else None
    if not isinstance(path, str) or any(ch in path for ch in "*?["):
        return _load_parts(resolve_paths(path), dev, want, tile)
    dt = scan_file(path, dev, columns=want)
    names = _column_names(dt, want)
    encoded = _encode_all(_host_encoder(dt, tile, dev), names)
    del dt
    return _resident_table(names, encoded, tile)


def _encode_string_codes(name, codes: np.ndarray, dictionary: np.ndarray, validity,
                         tile: int, arrow_type, device) -> ResidentColumn:
    """Codes into ``dictionary`` (numpy unicode or bytes, or the scan's
    object array of ``bytes``) → packed codes over the GLOBAL SORTED
    dictionary, without building the strings: the distinct values of the
    valid rows sorted (lexicographic, arrow's order for utf8 and binary;
    byte order is utf8's code point order), each row their rank, null rows
    the first valid row's, as arrow's ``dictionary_encode`` +
    ``fill_null(0)`` gives them; utf8 values as ``str``."""
    valid = codes if validity is None else codes[validity]
    present = np.flatnonzero(np.bincount(valid, minlength=len(dictionary))) if len(valid) else valid[:0]
    if len(present) > _MAX_DICT:
        raise _too_many_strings(name)
    values = dictionary[present]
    order = np.argsort(values, kind="stable")
    rank = np.zeros(max(len(dictionary), 1), dtype=np.uint32)
    rank[present[order]] = np.arange(len(present), dtype=np.uint32)
    out = rank[codes]
    if validity is not None and len(valid):
        out[~validity] = rank[valid[0]]
    host = values[order].astype(object)
    if str(arrow_type) in ("string", "large_string") and values.dtype.kind != "U":
        host = np.array([v.decode("utf-8") for v in host], dtype=object)
    return _string_column(name, out, host, tile, arrow_type, len(codes), device)
