"""Compressed-in-device-memory resident tables on torch.

Counterpart of ``strawboat_tpu/exec/resident.py`` (flat columns).  A
resident table keeps each column as 1–2 bit-packed PLANES of
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

Two fronts build a table: a ``pa.Table`` (pyarrow, imported lazily) and a
mapping of numpy columns, for machines without pyarrow.  List, map and
struct columns are not ported yet.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..device import U32_MASK, as_device, shr_u32, u64_to_i64, widen_i64, words_u32
from ..errors import NotYetImplementedError, OutOfSpecError
from ..kernels.bitunpack import TILE3D, bitunpack_tiled, transpose_words_host_tiled
from ..kernels.decode import dict_gather_device
from ..util.bits import pack_blocks
from .aggregate import segment_reduce
from ..schema import decimal_params
from .scan import DeviceColumn, DeviceTable, to_pa_array, unsigned_view

_MAX_DICT = 1 << 20  # dictionary entries beyond this: plain planes instead
_DEVICE_PACK_MIN = 1 << 16  # from this many rows the pack runs on the device
_NESTED = "ROADMAP.md 'Modules to port': list_sum and nested resident columns"


@dataclass
class ResidentColumn:
    name: str
    # 1–2 packed planes, LSB-first: ((n_tiles, bits, tile) int32 words, bits)
    planes: Tuple[Tuple[torch.Tensor, int], ...]
    shifts: Tuple[int, ...]  # bit position of each plane in the payload
    length: int  # true row count (tiled slots beyond are padding)
    kind: str  # 'int' | 'f32' | 'f64' | 'bool' | 'str'
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
    arrow_type: Any = None  # pa.DataType, or its alias string

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


def _unpack_plane_tiled(wt3: torch.Tensor, bits: int) -> torch.Tensor:
    """One packed plane → flat int32 (u32 bits) values in tiled-slot order."""
    return bitunpack_tiled(wt3, 0, bits).reshape(-1)


@dataclass
class ResidentTable:
    columns: Dict[str, ResidentColumn]
    num_rows: int
    tile: int
    field_order: Optional[Sequence[str]] = None
    _bounds_cache: Dict = field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    _mask: Optional[torch.Tensor] = field(
        default=None, init=False, repr=False, compare=False
    )

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
        object shaped like one).  Each plane, validity plane and dictionary
        is copied out with ``np.array``, which takes a JAX array as it is, so
        no JAX import is needed here."""
        dev = as_device(device)

        def words(w):
            return torch.from_numpy(np.array(w, dtype=np.uint32).view(np.int32)).to(dev)

        cols = {}
        for name, c in rt_ref.columns.items():
            if c.kind not in ("int", "f32", "f64", "bool", "str"):
                raise NotYetImplementedError(
                    f"{c.kind} column {name!r} ({_NESTED})"
                )
            cols[name] = ResidentColumn(
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
            )
        return cls(cols, int(rt_ref.num_rows), int(rt_ref.tile),
                   field_order=getattr(rt_ref, "field_order", None))

    # -- decode --------------------------------------------------------

    @staticmethod
    def _combine(c: ResidentColumn, vals, with_dict: bool):
        """Unpacked planes (flat int32 u32 bits) → decoded column values
        (dict columns: values when ``with_dict``, else codes)."""
        if c.is_dict:
            codes = vals[0]
            if with_dict and c.dictionary is not None:
                return dict_gather_device(codes, c.dictionary)
            return codes
        if c.kind == "bool":
            return vals[0] != 0
        if c.kind == "f32":
            u = vals[0]
            if c.offset or c.bit_shift:
                w = words_u32(u)
                if c.offset:
                    w = (w + (c.offset & U32_MASK)) & U32_MASK
                if c.bit_shift:
                    w = (w << c.bit_shift) & U32_MASK
                u = w.to(torch.int32)
            return u.view(torch.float32)
        if c._narrow_int and c.kind == "int":
            v = vals[0]  # values < 2^31
            return v.long() if c.wide else v
        u = None
        for v, sh in zip(vals, c.shifts):
            p = words_u32(v) << sh
            u = p if u is None else u | p
        if c.offset:
            u = u + u64_to_i64(c.offset)  # wraps mod 2^64
        if c.bit_shift:
            u = u << c.bit_shift
        if c.kind == "f64":
            return u.view(torch.float64)
        return u

    def _decode_col(self, c: ResidentColumn, with_dict: bool = True):
        vals = [_unpack_plane_tiled(w, b) for w, b in c.planes]
        return self._combine(c, vals, with_dict)

    def decode_tiled(self, name: str, with_dict: bool = True) -> torch.Tensor:
        """Column values in tiled order, padding slots included.  Dict columns
        decode through the dictionary unless ``with_dict`` is False (code
        space); strings always return codes."""
        return self._decode_col(self.columns[name], with_dict)

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
        """Decoded tiled columns as a ``DeviceTable`` + padding mask."""
        names = list(columns) if columns is not None else list(self.columns)
        cols = {}
        for n in names:
            c = self.columns[n]
            cols[n] = DeviceColumn(
                n,
                c.arrow_type,
                self.decode_tiled(n),
                self.validity_tiled(n),
                dictionary=c.dictionary_host if c.kind == "str" else None,
            )
        return DeviceTable(cols, self.tiled_slots), self.mask_tiled()

    def to_arrow(self, columns: Optional[Sequence[str]] = None):
        """Natural-order host materialization as a ``pa.Table``."""
        import pyarrow as pa

        names = list(columns) if columns is not None else list(
            self.field_order or self.columns
        )
        arrays = {}
        for n in names:
            c = self.columns[n]
            vals = self.decode_natural(n).cpu().numpy()
            valid = self.validity_natural(n)
            mask = None if valid is None else ~valid.cpu().numpy()
            arrays[n] = to_pa_array(
                vals, mask, c.arrow_type,
                c.dictionary_host if c.kind == "str" else None,
            )
        return pa.table(arrays)

    # -- bound translation ---------------------------------------------

    def _code_bounds(self, col: str, lo, hi):
        """VALUE bounds → CODE bounds for sorted-dict columns: [lo, hi) over
        values equals [searchsorted(lo), searchsorted(hi)) over codes."""
        c = self.columns[col]
        if c.dictionary_host is None:
            return lo, hi, False
        d = c.dictionary_host
        lo_c = None if lo is None else int(np.searchsorted(d, lo, "left"))
        hi_c = None if hi is None else int(np.searchsorted(d, hi, "left"))
        return lo_c, hi_c, True

    def _bound_scalars(self, predicates, pcols):
        """Device scalars for the lo/hi literals in the column's decoded
        dtype (code space for dict columns), cached by value."""
        key = tuple((c,) + tuple(predicates[c]) for c in pcols)
        hit = self._bounds_cache.get(key)
        if hit is None:
            los, his = [], []
            for cname in pcols:
                lo, hi = predicates[cname]
                lo, hi, is_code = self._code_bounds(cname, lo, hi)
                dt = torch.int32 if is_code else self.columns[cname].decoded_dtype()
                if predicates[cname][0] is not None:
                    los.append(torch.tensor(lo, dtype=dt, device=self.device))
                if predicates[cname][1] is not None:
                    his.append(torch.tensor(hi, dtype=dt, device=self.device))
            hit = (tuple(los), tuple(his))
            self._bounds_cache[key] = hit
        return hit

    def _query_inputs(self, names, value_cols, code_cols, predicates, pcols):
        """Decode what a fused query reads: values (through the dictionary)
        for ``value_cols``, code space for ``code_cols``; plus the row mask
        (padding, nulls of every read column, the predicates)."""
        cols, codes = {}, {}
        for n in names:
            c = self.columns[n]
            vals = [_unpack_plane_tiled(w, b) for w, b in c.planes]
            if n in value_cols:
                cols[n] = self._combine(c, vals, True)
            if n in code_cols:
                codes[n] = self._combine(c, vals, False)
        m = self.mask_tiled()
        for n in names:
            valid = self.validity_tiled(n)
            if valid is not None:
                m = m & valid
        los, his = self._bound_scalars(predicates, pcols)
        li = hi_i = 0
        for cname in pcols:
            lo, hi = predicates[cname]
            if lo is not None:
                m = m & (codes[cname] >= los[li])
                li += 1
            if hi is not None:
                m = m & (codes[cname] < his[hi_i])
                hi_i += 1
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
        Returns a 0-d int64 (float64 for float values) device tensor."""
        pcols = tuple(sorted(predicates))
        extra = (product_with,) if product_with else ()
        names = list(dict.fromkeys(pcols + (value,) + extra))
        cols, _codes, m = self._query_inputs(
            names, {value, *extra}, set(pcols), predicates, pcols
        )
        acc = cols[value]
        if product_with is not None:
            if not acc.is_floating_point():
                acc = acc.long()
            acc = acc * cols[product_with]
        if acc.is_floating_point():
            return torch.where(m, acc, 0).sum(dtype=torch.float64)
        return torch.where(m, acc, 0).sum(dtype=torch.int64)

    def group_sum(
        self,
        key: str,
        values: Sequence[str],
        num_groups: int,
        predicates: Optional[Dict[str, Tuple[Optional[float], Optional[float]]]] = None,
    ):
        """Per-group sums + counts over dense integer keys in [0, num_groups).
        Dict key columns group by (sorted) code.  Returns ``([sums per
        value column], counts)``; keys outside the range are dropped."""
        predicates = predicates or {}
        pcols = tuple(sorted(predicates))
        names = list(dict.fromkeys((key,) + tuple(values) + pcols))
        cols, codes, m = self._query_inputs(
            names, set(values), set(pcols) | {key}, predicates, pcols
        )
        k = torch.where(m, codes[key].to(torch.int32), num_groups)
        outs = []
        for v in values:
            vv = cols[v]
            if not vv.is_floating_point():
                vv = vv.long()
            outs.append(segment_reduce(torch.where(m, vv, 0), k, num_groups))
        cnt = segment_reduce(m.long(), k, num_groups)
        return outs, cnt


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
    if isinstance(arrow_type, str):
        return (arrow_type in ("int64", "uint64") or arrow_type.startswith("timestamp")
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


def _encode_string(name, arr, tile: int, arrow_type, rows, device):
    """pa utf8/binary → packed codes + GLOBAL SORTED dictionary."""
    import pyarrow as pa
    import pyarrow.compute as pc

    denc = arr.dictionary_encode()
    if isinstance(denc, pa.ChunkedArray):
        denc = denc.combine_chunks()
    d = denc.dictionary
    if len(d) > _MAX_DICT:
        raise _too_many_strings(name)
    order = pc.sort_indices(d).to_numpy(zero_copy_only=False)
    rank = np.empty(max(len(d), 1), dtype=np.uint32)
    rank[order] = np.arange(len(order), dtype=np.uint32)
    indices = denc.indices
    if indices.null_count:
        # null indices are pinned to code 0; the validity plane masks them
        indices = indices.fill_null(0)
    codes_raw = indices.to_numpy(zero_copy_only=False).astype(np.int64)
    codes = rank[codes_raw] if len(d) else np.zeros(rows, dtype=np.uint32)
    sorted_pa = d.take(pa.array(order)) if len(d) else d
    host = np.empty(len(sorted_pa), dtype=object)
    host[:] = sorted_pa.to_pylist()
    return _string_column(name, codes, host, tile, arrow_type, rows, device)


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
    """One pyarrow column → a flat resident column."""
    import pyarrow as pa

    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    rows = len(arr)
    t = f.type
    validity = None
    if arr.null_count:
        validity = ~np.asarray(arr.is_null())
    if (
        pa.types.is_string(t) or pa.types.is_binary(t)
        or pa.types.is_large_string(t) or pa.types.is_large_binary(t)
    ):
        col = _encode_string(f.name, arr, tile, t, rows, device)
    elif pa.types.is_boolean(t):
        arr_f = arr.fill_null(False) if arr.null_count else arr
        v01 = arr_f.to_numpy(zero_copy_only=False).astype(np.uint32)
        planes = ((_pack_plane(v01, 1, tile, device), 1),)
        col = ResidentColumn(f.name, planes, (0,), rows, "bool", arrow_type=t)
    elif pa.types.is_floating(t):
        if t.bit_width == 16:
            raise NotYetImplementedError("resident load of float16")
        # raw bit patterns from the values buffer: NaN / ±inf / -0.0 at
        # non-null positions survive bit-exactly
        npdt = np.dtype(np.float32 if t.bit_width == 32 else np.float64)
        buf = arr.buffers()[1]
        if buf is None:  # all-null arrays may carry no values buffer
            vals = np.zeros(len(arr), dtype=npdt)
        else:
            vals = np.frombuffer(
                buf, dtype=npdt, count=len(arr) + arr.offset
            )[arr.offset:].copy()
        vals = _fill_invalid(vals, validity)
        col = _encode_float(f.name, np.ascontiguousarray(vals), tile, t, rows, device)
    elif (
        pa.types.is_integer(t) or pa.types.is_date(t)
        or pa.types.is_timestamp(t) or pa.types.is_time(t)
    ):
        arr_f = arr.fill_null(0) if arr.null_count else arr
        vals = np.ascontiguousarray(
            arr_f.to_numpy(zero_copy_only=False).astype(np.int64)
        )
        col = _encode_int(f.name, vals, tile, t, rows, device)
    elif pa.types.is_decimal(t) and t.bit_width == 128 and t.precision <= 18:
        # unscaled int64 domain (predicates on decimals compare unscaled ints)
        limbs = np.frombuffer(
            arr.buffers()[1], dtype="<i8", count=2 * (len(arr) + arr.offset)
        ).reshape(-1, 2)[arr.offset: arr.offset + len(arr)]
        lo, hi = limbs[:, 0].copy(), limbs[:, 1]
        if validity is not None:
            lo[~validity] = 0
            ok = (hi == (lo >> 63)) | ~validity
        else:
            ok = hi == (lo >> 63)
        if not bool(np.all(ok)):
            raise OutOfSpecError(
                f"decimal column {f.name!r}: unscaled value exceeds int64 "
                f"despite precision {t.precision}"
            )
        col = _encode_int(f.name, np.ascontiguousarray(lo), tile, t, rows, device)
    elif pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_map(t) \
            or pa.types.is_struct(t):
        raise NotYetImplementedError(
            f"resident load of nested column {f.name!r} type {t} ({_NESTED})"
        )
    else:
        raise NotYetImplementedError(f"resident load of column {f.name!r} type {t}")
    if validity is not None:
        col.validity_plane = _pack_plane(validity.astype(np.uint32), 1, tile, device)
    return col


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


def make_resident(table, device, tile: Optional[int] = None) -> ResidentTable:
    """Build a resident table on ``device`` from a ``pa.Table``, from a
    mapping ``{name: numpy column}``, or from a ``DeviceTable``.

    numpy columns encode as the arrow type the reference would see: int64 →
    int64 (decoded wide), int32 → int32, unicode → string, bytes → binary,
    float, bool, datetime64[D] → date32; a ``np.ma.MaskedArray`` carries
    nulls.  A ``DeviceTable`` (a scan or join result) encodes on the device
    itself, as the reference's device-direct encoder does: integers take
    offset-stripped planes and never a dictionary."""
    dev = as_device(device)
    tile = tile or TILE3D
    if isinstance(table, Mapping):
        names = list(table)
        encoded = _encode_all(
            lambda n: _encode_numpy_column(n, table[n], tile, dev), names
        )
    elif isinstance(table, DeviceTable):
        return _make_resident_device(table, tile, dev)
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
    if not encoded:
        raise OutOfSpecError("no loadable columns")
    out: Dict[str, ResidentColumn] = {}
    first = encoded[0]
    for name, col in zip(names, encoded):
        if col.length != first.length or col.tiled_slots != first.tiled_slots:
            raise OutOfSpecError(f"resident columns disagree on row grid: {name!r}")
        out[name] = col
    return ResidentTable(out, first.length, tile, field_order=names)


def load_resident(
    path, device, columns: Optional[Sequence[str]] = None, tile: Optional[int] = None
) -> ResidentTable:
    """Load one file's columns as a resident table on ``device``.

    The file scans onto ``device`` (``scan_file``), the columns come back
    to the host and take the host encoder (``make_resident`` of numpy
    columns), so the planes equal the reference's ``load_resident`` word
    for word: the host encoder takes the dictionary decisions the
    device-direct one does not.  A string column comes back as its codes
    and is encoded as ``dictionary[codes]`` would be
    (:func:`_encode_string_codes`); a decimal as its unscaled int64 (also
    decimal256, which the reference refuses); float16 raises, as there.
    ``columns`` picks and orders columns; names the file lacks are
    skipped.  Globs and lists of files wait for
    the dataset layer."""
    from .scan import host_values, scan_file

    if not isinstance(path, str) or any(ch in path for ch in "*?["):
        raise NotYetImplementedError(
            "load_resident over a glob or a list of files "
            "(ROADMAP.md 'Modules to port': datasets)"
        )
    dev = as_device(device)
    tile = tile or TILE3D
    want = list(columns) if columns else None
    dt = scan_file(path, dev, columns=want)
    names = [n for n in want if n in dt.columns] if want is not None else list(dt.columns)
    host = {}
    for n in names:
        c = dt[n]
        validity = None if c.validity is None else c.validity.cpu().numpy()
        host[n] = (host_values(c), validity, c.dictionary, c.dtype)
    del dt

    def encode(n):
        vals, validity, dictionary, dtype = host[n]
        if dictionary is not None:
            col = _encode_string_codes(n, vals, dictionary, validity, tile, dtype, dev)
            if validity is not None:
                col.validity_plane = _pack_plane(validity.astype(np.uint32), 1, tile, dev)
            return col
        if dtype == "date32":
            vals = vals.astype("datetime64[D]")
        if validity is not None:
            vals = np.ma.MaskedArray(vals, mask=~validity)
        return _encode_numpy_column(n, vals, tile, dev,
                                    dtype if decimal_params(dtype) is not None else None)

    return _resident_table(names, _encode_all(encode, names), tile)


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
