"""Device scan: host page planning, decode on the device.

Counterpart of ``strawboat_tpu/exec/scan.py``: ``DeviceColumn`` /
``DeviceTable`` / ``DeviceListColumn`` and ``scan_file`` (pruned by zone
maps under ``predicates``) and ``scan_chunks`` of flat columns (integers,
temporal types, strings, floats, bool, decimals; a null column reads its
pages through the host batch read, as the reference's scan does, and
is int32 zeros with validity all False) and of nested ones
(list, large_list, fixed-size list, map, struct: leaf by leaf, each leaf
on the flat routes below, its levels expanded on the host).  The reference keeps a host copy of f64 columns
(``host_exact``) because the TPU stores f64 as a float32 pair; float64 is
native on the GPU, so the port's device column is exact and ``to_arrow``
reads it.

``dtype`` is the arrow type the column came from: a ``pa.DataType``, or its
alias string (``"int64"``, ``"date32"``, ``"string"``, ``"float64"``,
``"bool"``, ``"decimal128(15, 2)"``) when the table was built without
pyarrow.  String/binary columns ride as int32 dictionary codes;
``dictionary`` is then the host numpy object array of the dictionary's
values: ``bytes`` for every string type when the column was scanned (the
reference scan's ``pa.binary`` dictionary), ``str`` for a utf8 column of a
resident table.

Scanned values keep the column's width.  Unsigned columns follow
``device.py``: uint8 stays ``torch.uint8``, uint16/32/64 travel as the
signed torch type of the same width holding the same bits
(:func:`host_values` views them back); date32 is int32 days; floats keep
their width and every bit (NaN payloads, -0.0); bool is ``torch.bool``;
a decimal of precision 18 or less is its unscaled int64 (wider ones
raise, as in the reference).

The scan plans pages on the host (headers, block widths, dictionaries) and
decodes on the device with one launch per group: uniform-width bit-packed
pages and dictionary index subpages of one width (of string, float and
decimal columns too) run kernel K3 (``kernels/bitunpack.py``), then a
gather through the pages' dictionaries; pages whose blocks mix widths run
the varwidth decoder; RLE / ONE_VALUE / FREQ / other DICT pages decode
page by page in torch ops; PATAS pages decode on the host.  An integer or
float column whose pages are all raw (NONE, and LZ4 / Zstd / Snappy
through the port's ``native`` library) streams: pages decompress into
pooled page-locked buffers in chunks of about 32 MB, each chunk copied to
the card asynchronously while the next decompresses
(:func:`_decode_raw_column_streamed`, ``exec/arena.py``); other raw pages
decode on the host and upload once per run.

A :func:`scan_file` (each chunk of :func:`scan_chunks`) is a
``strawboat.scan`` root span (``util/obs.py``) with ``.open`` (footer,
metas, zone maps), ``.plan`` (``_plan_pages``), ``.parse`` (headers, block
widths, dictionaries, the host decode of string and bool pages),
``.decompress`` (host LZ4 / Zstd), ``.copy`` (host → device) and
``.decode`` (K3, the other decoders, the gathers and the assembly; copies
nest in it); counters ``scan.pages_planned``, ``scan.pages_kept``,
``scan.h2d_bytes`` and ``scan.h2d_pageable_bytes`` (the copies from
pageable host memory).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field as dataclass_field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..columns import arrow_type, pa_type
from ..codecs import decompress_raw, read_header
from ..codecs import boolean as bool_codec
from ..codecs.binary import decode_binary_page, factorize_slices, parse_len_prefixed
from ..codecs.decimal import decompress_decimal, int64_rows, parse_dict as parse_decimal_dict
from ..codecs.double import patas_decode
from ..codecs.integer import parse_dict_values, parse_freq, parse_one_value, parse_rle
from ..constants import Compression
from ..device import as_device
from ..errors import NotYetImplementedError, OutOfSpecError
from ..kernels.decode import (
    bitunpack_natural_device,
    bitunpack_varwidth_device,
    delta_bitunpack_device,
    dict_gather_device,
    freq_scatter_device,
    one_value_device,
    low32,
    prefix_sum_u32,
    rle_expand_device,
    unpack_validity_device,
)
from ..meta import ColumnMeta
from ..read.levels import (
    LIST, PRIMITIVE, STRUCT, NestedLevel, field_inits, leaf_fields, read_validity,
    read_validity_nested,
)
from ..read.reader import infer_schema, read_meta
from ..schema import (
    FLAT_FLOAT_TYPES, FLAT_INT_TYPES, NULL_TYPE, Field, decimal_params, fixed_size, int_storage,
)
from ..util import obs
from . import arena
from .pruning import check_predicates, prune_pages, read_zones

_SCAN_TODO = "ROADMAP.md queue 1, 'Types and pages still refused'"


@dataclass
class DeviceColumn:
    name: str
    dtype: Any
    values: torch.Tensor
    validity: Optional[torch.Tensor] = None  # bool, True = valid
    dictionary: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.values.shape[0])


@dataclass
class DeviceListColumn(DeviceColumn):
    """A column under list levels (list / large_list / fixed-size list /
    map), on the device: ``values`` are the flattened leaf values (codes
    with ``dictionary`` for strings), ``validity`` the rows' (the
    outermost list level's), ``dtype`` the leaf's alias.

    ``offsets`` is the COMPOSED row → leaf offsets (``n_rows + 1``,
    int64), which segment ops such as ``list_segment_sum`` take at any
    depth; ``offsets_stack`` holds each list level's zero-based int64
    offsets (outer → inner) and ``list_validities`` their validities (None
    where a level is not nullable), so that ``to_arrow`` rebuilds the
    array; ``child_validity`` is the leaf values'.  ``level_fields`` are
    the list levels' fields, outer → inner; ``to_arrow`` casts to the
    outermost one's type.
    Counterpart of the reference's ``DeviceListColumn`` (scan.py:1172),
    whose offsets are int32."""

    offsets: Optional[torch.Tensor] = None
    child_validity: Optional[torch.Tensor] = None
    offsets_stack: Optional[tuple] = None
    list_validities: Optional[tuple] = None
    level_fields: Optional[tuple] = None

    def __len__(self) -> int:
        return int(self.offsets.shape[0]) - 1


@dataclass
class NestedLeaf:
    """One leaf of a scanned nested field: its column's name in the table,
    its levels (host; offsets and validities over the scanned pages, a
    fixed-size list's null rows holding their slots) and each level's
    field.  ``load_resident`` assembles nested columns from these."""

    name: str
    levels: List[NestedLevel]
    fields: List[Field]


@dataclass
class DeviceTable:
    columns: Dict[str, DeviceColumn]
    num_rows: int
    # nested fields scanned: {field name: (field, [NestedLeaf per leaf])}
    nested: Dict[str, Any] = dataclass_field(default_factory=dict)

    def __getitem__(self, name: str) -> DeviceColumn:
        return self.columns[name]

    def to_arrow(self, mask=None):
        """Materialize (optionally mask-compacted) columns to a host table;
        list columns rebuild their nested arrays (a mask over them raises,
        as in the reference)."""
        import pyarrow as pa

        sel = None if mask is None else np.flatnonzero(mask.cpu().numpy())
        arrays = {}
        for name, c in self.columns.items():
            if isinstance(c, DeviceListColumn):
                if sel is not None:
                    raise NotYetImplementedError(f"mask-compacted export of list column {name!r}")
                arrays[name] = _list_column_to_arrow(c)
                continue
            vals = host_values(c)
            validity = None if c.validity is None else c.validity.cpu().numpy()
            if sel is not None:
                vals = vals[sel]
                validity = None if validity is None else validity[sel]
            arrays[name] = to_pa_array(
                vals, None if validity is None else ~validity, c.dtype, c.dictionary
            )
        return pa.table(arrays)


def _list_column_to_arrow(c: DeviceListColumn):
    """A ``DeviceListColumn`` → its nested ``pa.Array``: the leaf, wrapped
    in one list per level of ``offsets_stack`` (int64 offsets), then cast
    to the field's type; where arrow cannot cast (a list of structs, a
    map's key or value column) the result is the chain of plain lists, as
    the reference's ``_list_column_to_arrow`` (:119) gives it."""
    import pyarrow as pa

    child_mask = None if c.child_validity is None else ~c.child_validity.cpu().numpy()
    arr = to_pa_array(host_values(c), child_mask, c.dtype, c.dictionary)
    plain = arr.type
    for offs, valid in reversed(list(zip(c.offsets_stack, c.list_validities))):
        offs = offs.cpu().numpy().astype(np.int64)
        bitmap = None if valid is None else pa.py_buffer(
            np.packbits(valid.cpu().numpy(), bitorder="little"))
        arr = pa.Array.from_buffers(pa.large_list(arr.type), len(offs) - 1,
                                    [bitmap, pa.py_buffer(offs)], children=[arr])
        plain = pa.list_(plain)
    for target in (pa_type(c.level_fields[0]), plain):
        try:
            return arr.cast(target)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            pass
    return arr  # offsets beyond int32: large lists


def to_pa_array(vals: np.ndarray, null_mask, dtype, dictionary=None):
    """Host values (codes for dictionary columns; unscaled ints for
    decimals) + null mask (True = null) → a ``pa.Array`` of ``dtype``."""
    import pyarrow as pa

    t = arrow_type(dtype)
    if t is not None and pa.types.is_null(t):
        # int32 nulls: the reference's ``to_arrow`` cannot cast them to null
        return pa.array(np.asarray(vals, dtype=np.int32), mask=null_mask)
    if dictionary is not None:
        if not len(dictionary):
            return pa.array(np.full(len(vals), None), type=t, mask=null_mask)
        # the dictionary taken by the codes, as the reference builds it:
        # arrow's take gives the result a validity bitmap even without
        # nulls, and the writers write what the bitmap says
        values = [v.encode() if isinstance(v, str) else v for v in dictionary]
        arr = pa.array(values, type=pa.binary()).take(
            pa.array(np.asarray(vals, dtype=np.int64), mask=null_mask))
        return arr.cast(t) if t is not None and arr.type != t else arr
    if t is not None and pa.types.is_decimal(t):
        # unscaled ints → sign-extended 16-byte limbs (an int64→decimal
        # cast would re-scale the value)
        v = np.asarray(vals, dtype=np.int64)
        limbs = np.empty((len(v), t.bit_width // 64), dtype="<i8")
        limbs[:, 0] = v
        limbs[:, 1:] = (v >> 63)[:, None]
        null_bm = None
        if null_mask is not None:
            null_bm = pa.py_buffer(
                np.packbits(~null_mask, bitorder="little").tobytes()
            )
        return pa.Array.from_buffers(
            t, len(v), [null_bm, pa.py_buffer(limbs.tobytes())]
        )
    arr = pa.array(vals, mask=null_mask)
    if t is not None and pa.types.is_fixed_size_binary(t):
        return arr  # the integers, as the reference's cast of them fails
    if t is not None and arr.type != t:
        try:
            arr = arr.cast(t)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            # date32 & friends only cast from their storage width
            storage = pa.int32() if t.bit_width == 32 else pa.int64()
            arr = arr.cast(storage).cast(t)
    return arr


def unsigned_view(c: DeviceColumn) -> bool:
    """True when ``c.values`` holds a uint16/32/64 column in the signed
    torch type of its width (uint8 stays ``torch.uint8``)."""
    return str(c.dtype) in ("uint16", "uint32", "uint64")


def host_values(c: DeviceColumn) -> np.ndarray:
    """A column's values on the host, unsigned alias types viewed back
    from their signed device view."""
    vals = c.values.cpu().numpy()
    storage = int_storage(c.dtype) if isinstance(c.dtype, str) else None
    if storage is not None and vals.dtype.itemsize == np.dtype(storage).itemsize:
        vals = vals.view(storage)
    return vals


# ---------------------------------------------------------------------------
# host → device


def _torch_view(arr: np.ndarray) -> np.ndarray:
    """uint16/32/64 → the signed numpy view torch takes (uint8 stays)."""
    if arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        return arr.view(f"<i{arr.dtype.itemsize}")
    return arr


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = _torch_view(np.ascontiguousarray(arr))
    if not arr.flags.writeable:
        arr = arr.copy()
    with obs.span("strawboat.scan.copy"):
        if device.type == "cuda":
            obs.count("scan.h2d_bytes", arr.nbytes)
            obs.count("scan.h2d_pageable_bytes", arr.nbytes)
        return torch.from_numpy(arr).to(device)


def _decompress(codec: Compression, bodies, nbytes):
    """Host decompression of raw-mode bodies (``decompress_raw``)."""
    with obs.span("strawboat.scan.decompress"):
        return decompress_raw(codec, bodies, nbytes)


def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(_torch_view(np.zeros(0, np_dtype))).dtype


def _from_u32(vals: torch.Tensor, np_dtype: np.dtype) -> torch.Tensor:
    """int32-viewed u32 values of a bit-packed page → the column's type
    (only 4-byte columns are bit-packed: the writer's gate)."""
    if np_dtype.itemsize != 4:
        raise OutOfSpecError(f"bit-packed page in a column of {np_dtype}")
    return vals.view(_torch_dtype(np_dtype))


# ---------------------------------------------------------------------------
# page planning (reference scan.py:329-508)


def _block_widths(buf, body: int, n_blocks: int) -> np.ndarray:
    """The bit width of each block of a bit-packed page.  A page whose
    blocks all share the first block's width is recognized from a strided
    view of the header bytes (if every header at that stride holds the
    same width, the walk would visit exactly those); others walk the
    headers (``native.bp_walk`` in C or, without the native library, a
    Python loop over a bytes copy of the page)."""
    if n_blocks == 0:
        return np.zeros(0, dtype=np.uint8)
    if body >= len(buf):
        raise OutOfSpecError("bitpacked page truncated")
    nb0 = int(buf[body])
    stride = 1 + nb0 * 16
    if body + n_blocks * stride <= len(buf):
        heads = np.frombuffer(buf, np.uint8, n_blocks * stride, body)[::stride]
        if (heads == nb0).all():
            return heads.copy()
    if native.available():
        nbs, end = native.bp_walk(buf, body, n_blocks)
        if end > len(buf):
            raise OutOfSpecError("bitpacked page truncated")
        return nbs
    # bp_walk's Python fallback indexes the ndarray; a loop over a bytes
    # copy walks the dict file's 1.4 M mixed-width blocks in 0.19 s instead
    # of 0.41 s on an H100 machine's host (PERF.md, Findings)
    data = bytes(buf[body:])
    nbs = bytearray(n_blocks)
    p = 0
    try:
        for i in range(n_blocks):
            nbs[i] = data[p]
            p += 1 + data[p] * 16
    except IndexError:
        raise OutOfSpecError("bitpacked page truncated") from None
    if p > len(data):
        raise OutOfSpecError("bitpacked page truncated")
    return np.frombuffer(nbs, dtype=np.uint8)


def _parse_bp_page(buf, body: int, length: int):
    """A bit-packed page (or index subpage) →
    ``("uniform", words (n_blocks, 4b) u32, n_blocks, b)`` when every block
    has one non-zero width, ``("varwidth", words (n, bmax*4) u32
    zero-padded per block, n_blocks, widths (n,) int32, bmax)`` when the
    widths mix, or None when every block is 0 bits wide.  The reference
    takes the varwidth path only with the native header walk; the port
    always does."""
    n_blocks = (length + 127) // 128
    widths = _block_widths(buf, body, n_blocks).astype(np.int32)
    bmax = int(widths.max()) if n_blocks else 0
    if bmax == 0:
        return None
    if bmax > 32:
        raise OutOfSpecError(f"bit-packed block of width {bmax}")
    if (widths == bmax).all():
        stride = 1 + bmax * 16
        body_arr = np.frombuffer(buf, np.uint8, n_blocks * stride, body)
        words = body_arr.reshape(n_blocks, stride)[:, 1:].copy().view(np.uint32)
        return "uniform", words, n_blocks, bmax
    offs = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(1 + widths.astype(np.int64) * 16, out=offs[1:])
    offs += body
    words = np.zeros((n_blocks, bmax * 4), dtype=np.uint32)
    u8 = words.view(np.uint8)
    for w in np.unique(widths):
        w = int(w)
        if w == 0:
            continue
        sel = np.flatnonzero(widths == w)
        u8[sel, : w * 16] = buf[offs[sel][:, None] + 1 + np.arange(w * 16)]
    return "varwidth", words, n_blocks, widths, bmax


def _repeat_per_page(per_page, slot_sizes, total: int, device) -> torch.Tensor:
    """One int64 value per page (a sequence or a tensor) → one per slot
    of the group."""
    return torch.repeat_interleave(
        torch.as_tensor(per_page, dtype=torch.int64, device=device),
        torch.as_tensor(np.asarray(slot_sizes, dtype=np.int64), device=device),
        output_size=total,
    )


def _restart_per_page(dec: torch.Tensor, slot_sizes, device) -> torch.Tensor:
    """Delta pages of a group: a prefix sum mod 2^32 that restarts at each
    page (the delta carries within a page only).  int32 bits out."""
    g = prefix_sum_u32(dec)
    starts = np.cumsum(slot_sizes)[:-1]
    base = torch.zeros(len(slot_sizes), dtype=torch.int64, device=device)
    if len(starts):
        base[1:] = g[torch.as_tensor(starts - 1, device=device)]
    return low32(g - _repeat_per_page(base, slot_sizes, len(dec), device))


def _gather_dicts(codes: torch.Tensor, dicts, slot_sizes, np_dtype, device) -> torch.Tensor:
    """Codes of a group's pages → values, each page through its own
    dictionary: all dictionaries go up concatenated and each page's codes
    are shifted by its dictionary's base.  Codes are checked against their
    page's dictionary size before the gather."""
    total = len(codes)
    sizes = [len(d) for d in dicts]
    bases = np.zeros(len(dicts), dtype=np.int64)
    bases[1:] = np.cumsum(sizes[:-1])
    codes = codes.to(torch.int64) & 0xFFFFFFFF
    if bool((codes >= _repeat_per_page(sizes, slot_sizes, total, device)).any()):
        raise OutOfSpecError("dictionary code out of range")
    all_dict = _to_device(np.concatenate(dicts).astype(np_dtype, copy=False), device)
    return dict_gather_device(codes + _repeat_per_page(bases, slot_sizes, total, device), all_dict)


def _k3_groups(k3_jobs) -> Dict:
    """The scan's K3 launches: uniform-width jobs grouped by (codec, b).
    Bit-packed pages group by codec and width, DICT pages (codec DICT) by
    the width of their index subpage.

    k3_jobs: (idx, codec, words (n_blocks, 4b) u32, n_blocks, b,
    dictionary or None)."""
    groups = defaultdict(list)
    for job in k3_jobs:
        groups[(job[1], job[4])].append(job)
    return groups


def _decode_k3_groups(k3_jobs, np_dtype, device, group_arrays, page_ref) -> None:
    """ONE K3 launch per group over the concatenated words of its pages,
    copied to the device once; delta pages then restart their prefix sum
    per page, DICT pages gather through their own dictionaries.  Fills
    ``group_arrays`` {key: values} and ``page_ref`` {idx: (key, offset,
    slots)}."""
    for gkey, jobs in _k3_groups(k3_jobs).items():
        codec, b = gkey
        words = _to_device(np.concatenate([j[2] for j in jobs]), device)
        dec = bitunpack_natural_device(words, b)
        slot_sizes = [j[3] * 128 for j in jobs]
        if codec == Compression.DELTA_BITPACKING:
            dec = _restart_per_page(dec, slot_sizes, device)
        if codec == Compression.DICT:
            dec = _gather_dicts(dec, [j[5] for j in jobs], slot_sizes, np_dtype, device)
        else:
            dec = _from_u32(dec, np_dtype)
        group_arrays[gkey] = dec
        _index_pages(gkey, [j[0] for j in jobs], slot_sizes, page_ref)


def _decode_varwidth_groups(bpv_jobs, np_dtype, device, group_arrays, page_ref) -> None:
    """Pages whose blocks mix widths: one varwidth decode per (kind,
    delta?) group, the widths riding as data.

    bpv_jobs: (idx, kind, words, n_blocks, widths, bmax, length, is_delta,
    dictionary or None); kind is "bpv" (a bit-packed page) or "dictv" (a
    DICT page's index subpage)."""
    groups = defaultdict(list)
    for job in bpv_jobs:
        groups[(job[1], job[7])].append(job)
    for gkey, jobs in groups.items():
        kind, is_delta = gkey
        bmax = max(j[5] for j in jobs)
        # each page's words at its own widest block, zero-padded to the group's
        words = np.zeros((sum(j[3] for j in jobs), bmax * 4), dtype=np.uint32)
        row = 0
        for j in jobs:
            words[row : row + j[3], : j[2].shape[1]] = j[2]
            row += j[3]
        widths = np.concatenate([j[4] for j in jobs])
        dec = bitunpack_varwidth_device(
            _to_device(words, device), _to_device(widths, device), bmax
        ).reshape(-1)
        slot_sizes = [j[3] * 128 for j in jobs]
        if is_delta:
            dec = _restart_per_page(dec, slot_sizes, device)
        if kind == "dictv":
            dec = _gather_dicts(dec, [j[8] for j in jobs], slot_sizes, np_dtype, device)
        else:
            dec = _from_u32(dec, np_dtype)
        group_arrays[gkey] = dec
        _index_pages(gkey, [j[0] for j in jobs], slot_sizes, page_ref)


def _decode_dict_raw_group(plans, np_dtype, device, group_arrays, page_ref,
                           parse_dict=None) -> None:
    """DICT pages whose index subpage is raw-mode (NONE, LZ4, Zstd,
    Snappy; under the dict flags every page whose value count is not a
    multiple of 128, which the writer cannot bit-pack: most nested leaf
    pages): their codes decompress on the host, go up in one copy and
    gather through each page's dictionary in one launch.  ``parse_dict``
    as in :func:`_sort_jobs`."""
    jobs = []  # (idx, index codec, index bytes, length, dictionary)
    for idx, (length, _v, buf, p) in enumerate(plans):
        if idx in page_ref:
            continue
        codec, _cs, _us, body = read_header(buf, p)
        if codec != Compression.DICT:
            continue
        icodec, icsize, _ius, ibody = read_header(buf, body)
        if not icodec.raw_mode:
            continue
        pos = ibody + icsize
        dvals = parse_dict_values(buf, pos, np_dtype) if parse_dict is None else parse_dict(buf, pos)
        if dvals is not None:
            jobs.append((idx, icodec, buf[ibody:pos], length, dvals))
    if not jobs:
        return
    codes = {}
    for codec in {j[1] for j in jobs}:
        mine = [j for j in jobs if j[1] == codec]
        for j, raw in zip(mine, _decompress(codec, [j[2] for j in mine], [j[3] * 4 for j in mine])):
            codes[j[0]] = np.frombuffer(raw, "<u4", j[3])
    lengths = [j[3] for j in jobs]
    dec = _gather_dicts(_to_device(np.concatenate([codes[j[0]] for j in jobs]), device),
                        [j[4] for j in jobs], lengths, np_dtype, device)
    group_arrays[("dict_raw",)] = dec
    _index_pages(("dict_raw",), [j[0] for j in jobs], lengths, page_ref)


def _index_pages(gkey, idxs, slot_sizes, page_ref) -> None:
    off = 0
    for idx, n in zip(idxs, slot_sizes):
        page_ref[idx] = (gkey, off, n)
        off += n


# ---------------------------------------------------------------------------
# one structured page on the device (reference scan.py:203-326)


def _decode_structured_to_device(buf, pos: int, length: int, np_dtype: np.dtype, device):
    """Decode one integer or float page at ``pos`` → (values on ``device``
    in the column's torch type, end position).  Subpages (DICT indices,
    FREQ exceptions) recurse; PATAS decodes on the host."""
    codec, csize, _usize, body = read_header(buf, pos)
    end = body + csize
    if end > len(buf):
        raise OutOfSpecError("integer page truncated")
    if codec.raw_mode:
        nbytes = length * np_dtype.itemsize
        (raw,) = _decompress(codec, [buf[body:end]], [nbytes])
        return _to_device(np.frombuffer(raw, np_dtype, length), device), end
    if codec == Compression.ONE_VALUE:
        value = _to_device(parse_one_value(buf, body, np_dtype), device)
        return one_value_device(value, length), end
    if codec == Compression.RLE:
        counts, values = parse_rle(buf, body, length, np_dtype)
        return rle_expand_device(
            _to_device(counts.astype(np.int64), device), _to_device(values, device), length
        ), end
    if codec == Compression.DICT:
        codes, ipos = _decode_structured_to_device(buf, body, length, np.dtype(np.uint32), device)
        dvals = parse_dict_values(buf, ipos, np_dtype)
        return _gather_dicts(codes, [dvals], [length], np_dtype, device), end
    if codec == Compression.FREQ:
        top, positions, p = parse_freq(buf, body, np_dtype)
        exceptions, _ = _decode_structured_to_device(buf, p, len(positions), np_dtype, device)
        return freq_scatter_device(
            _to_device(top, device), _to_device(positions.astype(np.int64), device),
            exceptions, length,
        ), end
    if codec in (Compression.BITPACKING, Compression.DELTA_BITPACKING):
        delta = codec == Compression.DELTA_BITPACKING
        parsed = _parse_bp_page(buf, body, length)
        if parsed is None:  # every block 0 bits wide
            out = torch.zeros(((length + 127) // 128) * 128, dtype=torch.int32, device=device)
        elif parsed[0] == "uniform":
            words, b = _to_device(parsed[1], device), parsed[3]
            out = delta_bitunpack_device(words, b) if delta else bitunpack_natural_device(words, b)
        else:
            _kind, words, _n, widths, bmax = parsed
            out = bitunpack_varwidth_device(
                _to_device(words, device), _to_device(widths, device), bmax
            ).reshape(-1)
            if delta:
                out = low32(prefix_sum_u32(out))
        return _from_u32(out[:length], np_dtype), end
    if codec == Compression.PATAS and np_dtype.kind == "f":
        return _to_device(patas_decode(buf, body, length, np_dtype), device), end
    raise NotYetImplementedError(f"device decode of {codec.name} pages of {np_dtype} ({_SCAN_TODO})")


# ---------------------------------------------------------------------------
# one column (reference decode_column_pages_device, scan.py:594)


def _plan_pages(file_bytes: np.ndarray, meta: ColumnMeta, nullable: bool, keep=None):
    """→ [(length, validity or None, page bytes, position after the
    validity prelude)] for every page of the column that ``keep`` (a
    boolean mask over the page grid, None = all) keeps.  Dropped pages are
    skipped unread, as the reference's ``Iterator::nth`` seeks."""
    plans = []
    pos = meta.offset
    for i, page in enumerate(meta.pages):
        if keep is not None and not keep[i]:
            pos += page.length
            continue
        buf = file_bytes[pos : pos + page.length]
        if len(buf) != page.length:
            raise OutOfSpecError("page past the end of the file")
        length = page.num_values
        validity, p = read_validity(buf, 0, length) if nullable else (None, 0)
        plans.append((length, validity, buf, p))
        pos += page.length
    obs.count("scan.pages_planned", len(meta.pages))
    obs.count("scan.pages_kept", len(plans))
    return plans


def _validity(plans, dev) -> Optional[torch.Tensor]:
    """The column's validity on ``dev``, or None when no page has nulls."""
    if all(v is None for _l, v, _b, _p in plans):
        return None
    return _to_device(
        np.concatenate([np.ones(l, bool) if v is None else v for l, v, _b, _p in plans]), dev
    )


def _sort_jobs(plans, np_dtype, parse_dict=None):
    """Split pages into raw pages (decoded on the host), K3 jobs (uniform
    BP pages and DICT pages with a uniform BP index subpage), and
    mixed-width pages; the rest decode one by one.  ``parse_dict(buf,
    pos)``: a DICT page's dictionary in the column's dtype, or None to
    leave the page to its own route (default: ``parse_dict_values``)."""
    raw_jobs = defaultdict(list)  # codec → [(idx, body bytes, nbytes)]
    k3_jobs, bpv_jobs = [], []
    for idx, (length, _v, buf, p) in enumerate(plans):
        codec, csize, _us, body = read_header(buf, p)
        if codec.raw_mode:
            raw_jobs[codec].append((idx, buf[body : body + csize], length * np_dtype.itemsize))
        elif codec in (Compression.BITPACKING, Compression.DELTA_BITPACKING):
            parsed = _parse_bp_page(buf, body, length)
            if parsed is None:
                continue
            if parsed[0] == "uniform":
                k3_jobs.append((idx, codec, *parsed[1:], None))
            else:
                is_delta = codec == Compression.DELTA_BITPACKING
                bpv_jobs.append((idx, "bpv", *parsed[1:], length, is_delta, None))
        elif codec == Compression.DICT:
            icodec, icsize, _ius, ibody = read_header(buf, body)
            if icodec not in (Compression.BITPACKING, Compression.DELTA_BITPACKING):
                continue
            parsed = _parse_bp_page(buf, ibody, length)
            if parsed is None:
                continue
            if parse_dict is None:
                dvals = parse_dict_values(buf, ibody + icsize, np_dtype)
            else:
                dvals = parse_dict(buf, ibody + icsize)
                if dvals is None:
                    continue
            is_delta = icodec == Compression.DELTA_BITPACKING
            if parsed[0] == "uniform" and not is_delta:
                k3_jobs.append((idx, Compression.DICT, *parsed[1:], dvals))
            else:
                # delta codes take the varwidth decoder, as in the reference
                words, n_blocks, bmax = parsed[1], parsed[2], parsed[-1]
                if parsed[0] == "varwidth":
                    widths = parsed[3]
                else:
                    widths = np.full(n_blocks, bmax, np.int32)
                bpv_jobs.append(
                    (idx, "dictv", words, n_blocks, widths, bmax, length, is_delta, dvals)
                )
    return raw_jobs, k3_jobs, bpv_jobs


_UPLOAD_CHUNK = 32 << 20  # decoded bytes per staged host → device copy
_copy_streams: Dict[torch.device, Any] = {}


def _copy_stream(dev: torch.device):
    """The side stream the feed's copies run on (one per device)."""
    if dev not in _copy_streams:
        _copy_streams[dev] = torch.cuda.Stream(dev)
    return _copy_streams[dev]


def chunk_cuts(out_lens: Sequence[int], limit: int) -> List[tuple]:
    """Pages cut into runs of consecutive pages, on page edges: a run takes
    pages while its decoded bytes stay within ``limit``, and at least one
    page → [(first page, end page)]."""
    offsets = np.zeros(len(out_lens) + 1, dtype=np.int64)
    np.cumsum(out_lens, out=offsets[1:])
    cuts, start = [], 0
    while start < len(out_lens):
        end = start + 1
        while end < len(out_lens) and offsets[end + 1] - offsets[start] <= limit:
            end += 1
        cuts.append((start, end))
        start = end
    return cuts


def _decode_raw_column_streamed(plans, np_dtype: np.dtype, dev: torch.device):
    """The values of a column whose pages are ALL raw-mode, or None when a
    page is not (or the native library is missing).

    Pages decompress on native threads straight into host memory, in
    chunks of about ``_UPLOAD_CHUNK`` decoded bytes cut at page edges (one
    native call per run of one codec).  On a CUDA device each chunk lands
    in a page-locked buffer from ``exec/arena.py`` and is copied into its
    slice of the column with ``non_blocking=True`` on a side stream, which
    records an event; the consuming stream waits on every chunk's event,
    and the buffer goes back to the pool with its event, so the next
    chunk's decompression overlaps this chunk's copy and no buffer is
    reused before its copy is done.  On the CPU the chunks decompress
    straight into the column's own memory."""
    if not plans or not native.available():
        return None
    jobs = []  # (codec, body bytes, decoded bytes)
    for length, _v, buf, p in plans:
        codec, csize, _us, body = read_header(buf, p)
        if not codec.raw_mode:
            return None
        if body + csize > len(buf):
            raise OutOfSpecError("raw page truncated")
        jobs.append((int(codec), buf[body : body + csize], length * np_dtype.itemsize))
    out_lens = np.array([j[2] for j in jobs], dtype=np.int64)
    offsets = np.zeros(len(jobs) + 1, dtype=np.int64)
    np.cumsum(out_lens, out=offsets[1:])
    total = int(offsets[-1])
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    on_card = dev.type == "cuda"
    if on_card:
        consumer = torch.cuda.current_stream(dev)
        stream = _copy_stream(dev)
        stream.wait_stream(consumer)  # out's memory may be in use before this
        out.record_stream(stream)
    else:
        host_out = out.numpy()
    for start, end in chunk_cuts(out_lens, _UPLOAD_CHUNK):
        base, stop = int(offsets[start]), int(offsets[end])
        stage = arena.acquire(stop - base, pin=True) if on_card else None
        target = stage.numpy() if on_card else host_out[base:stop]
        i = start
        with obs.span("strawboat.scan.decompress"):
            while i < end:  # one native call per run of one codec
                j = i + 1
                while j < end and jobs[j][0] == jobs[i][0]:
                    j += 1
                native.decompress_batch_into(jobs[i][0], [x[1] for x in jobs[i:j]], target,
                                             offsets[i:j] - base, out_lens[i:j])
                i = j
        if on_card:
            with obs.span("strawboat.scan.copy"):
                obs.count("scan.h2d_bytes", stop - base)
                with torch.cuda.stream(stream):
                    out[base:stop].copy_(stage, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                consumer.wait_event(done)
                arena.release(stage, [done])
    return out.view(_torch_dtype(np_dtype))


def _column_np_dtype(field: Field) -> np.dtype:
    if field.is_flat_int:
        return np.dtype(int_storage(field.dtype))
    return np.dtype(FLAT_FLOAT_TYPES[field.dtype])


def decode_column_pages_device(
    file_bytes: np.ndarray, meta: ColumnMeta, field: Field, device, keep=None
) -> DeviceColumn:
    """Decode the pages ``keep`` keeps (None = all) of a flat column onto
    ``device``."""
    dev = as_device(device)
    _check_flat(field)
    with obs.span("strawboat.scan.plan"):
        plans = _plan_pages(file_bytes, meta, field.nullable, keep)
    return _decode_plans(plans, field, dev)


def _check_flat(field: Field) -> None:
    if not (field.is_flat_string or field.is_flat_bool or field.is_flat_decimal
            or field.is_flat_int or field.is_flat_float):
        raise NotYetImplementedError(
            f"scan of column {field.name!r} of type {field.dtype} ({_SCAN_TODO})"
        )


def _decode_plans(plans, field: Field, dev) -> DeviceColumn:
    """A flat column's (or a nested leaf's) planned pages → its values on
    ``dev``: strings as dictionary codes, bools, decimals, then integers
    and floats (streamed when every page is raw, else K3 groups, the
    varwidth decoder and page-by-page routes)."""
    if field.is_flat_string:
        return _decode_binary_column_device(plans, field, dev)
    if field.is_flat_bool:
        return _decode_boolean_column(plans, field, dev)
    if field.is_flat_decimal:
        return _decode_decimal_column(plans, field, dev)
    np_dtype = _column_np_dtype(field)
    values = _decode_raw_column_streamed(plans, np_dtype, dev)
    if values is not None:
        return DeviceColumn(field.name, field.dtype, values, _validity(plans, dev))
    with obs.span("strawboat.scan.parse"):
        raw_jobs, k3_jobs, bpv_jobs = _sort_jobs(plans, np_dtype)

    raw_host = {}
    for codec, jobs in raw_jobs.items():
        outs = _decompress(codec, [j[1] for j in jobs], [j[2] for j in jobs])
        for (idx, _b, _n), out in zip(jobs, outs):
            raw_host[idx] = np.frombuffer(out, np_dtype)
    with obs.span("strawboat.scan.decode"):
        group_arrays: Dict = {}
        page_ref: Dict = {}
        if k3_jobs:
            _decode_k3_groups(k3_jobs, np_dtype, dev, group_arrays, page_ref)
        if bpv_jobs:
            _decode_varwidth_groups(bpv_jobs, np_dtype, dev, group_arrays, page_ref)
        _decode_dict_raw_group(plans, np_dtype, dev, group_arrays, page_ref)

        # assembly in page order: runs of host pages go up in one copy, group
        # slices that continue each other merge into one slice
        # tensors, or [gkey, offset, n_values, ends on a full page] slices
        parts: List[Any] = []
        host_run: List[np.ndarray] = []

        def flush_host():
            if host_run:
                parts.append(_to_device(np.concatenate(host_run), dev))
                host_run.clear()

        for idx, (length, _v, buf, p) in enumerate(plans):
            if idx in page_ref:
                flush_host()
                gkey, off, slots = page_ref[idx]
                last = parts[-1] if parts else None
                if isinstance(last, list) and last[0] == gkey and last[3] and last[1] + last[2] == off:
                    last[2] += length
                    last[3] = length == slots
                else:
                    parts.append([gkey, off, length, length == slots])
            elif idx in raw_host:
                host_run.append(raw_host[idx])
            else:
                flush_host()
                parts.append(_decode_structured_to_device(buf, p, length, np_dtype, dev)[0])
        flush_host()
        tensors = [
            group_arrays[x[0]][x[1] : x[1] + x[2]] if isinstance(x, list) else x for x in parts
        ]
        if not tensors:
            values = torch.zeros(0, dtype=_torch_dtype(np_dtype), device=dev)
        else:
            values = tensors[0] if len(tensors) == 1 else torch.cat(tensors)
    return DeviceColumn(field.name, field.dtype, values, _validity(plans, dev))


# ---------------------------------------------------------------------------
# bool and decimal columns (reference scan.py:818-920)


def _decode_boolean_column(plans, field: Field, dev) -> DeviceColumn:
    """A bool column → ``torch.bool`` on ``dev``: one upload of packed bits
    and one expand on the device.  When every page is raw and every page
    but the last holds a multiple of 8 rows, the pages' bitmaps are the
    column's bitmap and go up as they are; otherwise RLE / ONE_VALUE pages
    (and raw ones) decode on the host and the bits are packed again."""
    total = sum(length for length, _v, _b, _p in plans)
    with obs.span("strawboat.scan.parse"):
        pages = _boolean_pages(plans)
    if all(x.dtype == np.uint8 for x in pages) and all(l % 8 == 0 for l, _v, _b, _p in plans[:-1]):
        packed = np.concatenate(pages) if pages else np.zeros(0, np.uint8)
    else:
        bits = [x if x.dtype == bool else np.unpackbits(x, count=l, bitorder="little").astype(bool)
                for x, (l, _v, _b, _p) in zip(pages, plans)]
        packed = np.packbits(np.concatenate(bits), bitorder="little")
    with obs.span("strawboat.scan.decode"):
        values = unpack_validity_device(_to_device(packed, dev), total)
    return DeviceColumn(field.name, field.dtype, values, _validity(plans, dev))


def _boolean_pages(plans) -> List[np.ndarray]:
    """Per page of a bool column: its raw bitmap bytes, or its bools."""
    pages = []
    for length, _v, buf, p in plans:
        codec, csize, _us, body = read_header(buf, p)
        if body + csize > len(buf):
            raise OutOfSpecError("boolean page truncated")
        if codec.raw_mode:
            (raw,) = _decompress(codec, [buf[body : body + csize]], [(length + 7) // 8])
            pages.append(np.asarray(raw, dtype=np.uint8))
        elif codec == Compression.RLE:
            pages.append(bool_codec.rle_decode(buf, body, length))
        elif codec == Compression.ONE_VALUE:
            pages.append(bool_codec.one_value_decode(buf, body, length))
        else:
            raise OutOfSpecError(f"unknown boolean codec {codec}")
    return pages


def _decimal_dict(width: int):
    """A DICT page's dictionary of ``width``-byte decimals as unscaled
    int64 (one zero for an all-null page, whose codes are 0), or None
    when an entry is wider than int64."""

    def parse(buf, pos):
        lo, fits = int64_rows(parse_decimal_dict(buf, pos, width))
        if not fits.all():
            return None
        return lo if len(lo) else np.zeros(1, dtype=np.int64)

    return parse


def _decode_decimal_column(plans, field: Field, dev) -> DeviceColumn:
    """A decimal128 / decimal256 column → unscaled int64 on ``dev``
    (precision 18 or less: 10^18 < 2^63).  A DICT page whose dictionary
    holds int64 values only decodes its codes on the device (through K3
    when they pack at one width) and gathers the int64 dictionary there;
    every other page decodes on the host.  A wider decimal raises, as in
    the reference, which checks every decoded row: here the host checks
    the rows of the pages it decodes, and a DICT page goes to the device
    only when every entry of its dictionary is an int64, so every row it
    yields is one."""
    width, precision, _scale = decimal_params(field.dtype)
    width //= 8
    if not plans:
        return DeviceColumn(field.name, field.dtype,
                            torch.zeros(0, dtype=torch.int64, device=dev), None)
    if precision > 18:
        raise NotYetImplementedError(f"device scan of decimal {field.dtype} wider than int64")
    i64 = np.dtype(np.int64)
    parse_dict = _decimal_dict(width)
    with obs.span("strawboat.scan.parse"):
        _raw, k3_jobs, bpv_jobs = _sort_jobs(plans, i64, parse_dict)
    with obs.span("strawboat.scan.decode"):
        group_arrays: Dict = {}
        page_ref: Dict = {}
        if k3_jobs:
            _decode_k3_groups(k3_jobs, i64, dev, group_arrays, page_ref)
        if bpv_jobs:
            _decode_varwidth_groups(bpv_jobs, i64, dev, group_arrays, page_ref)
        _decode_dict_raw_group(plans, i64, dev, group_arrays, page_ref, parse_dict)
        parts: List[torch.Tensor] = []
        host_run: List[np.ndarray] = []

        def flush_host():
            if host_run:
                parts.append(_to_device(np.concatenate(host_run), dev))
                host_run.clear()

        for idx, (length, _v, buf, p) in enumerate(plans):
            if idx in page_ref:
                flush_host()
                gkey, off, _slots = page_ref[idx]
                parts.append(group_arrays[gkey][off : off + length])
                continue
            codec, _cs, _us, body = read_header(buf, p)
            if codec == Compression.DICT:  # another index subpage, on the device
                _ic, icsize, _ius, ibody = read_header(buf, body)
                lo = parse_dict(buf, ibody + icsize)
                if lo is not None:
                    flush_host()
                    codes, _end = _decode_structured_to_device(buf, body, length,
                                                               np.dtype(np.uint32), dev)
                    parts.append(_gather_dicts(codes, [lo], [length], i64, dev))
                    continue
            mat, _end = decompress_decimal(buf, p, length, width)
            lo, fits = int64_rows(mat)
            if not fits.all():
                raise NotYetImplementedError(f"device scan of decimal {field.dtype} wider than int64")
            host_run.append(lo)
        flush_host()
        values = parts[0] if len(parts) == 1 else torch.cat(parts)
    return DeviceColumn(field.name, field.dtype, values, _validity(plans, dev))


# ---------------------------------------------------------------------------
# string columns as dictionary codes (reference scan.py:941-1169)


def _dictionary_encode(offsets: np.ndarray, values: np.ndarray):
    """Per-row encode of the rows of raw-framed pages (raw mode, FREQ,
    ONE_VALUE) → (int64 codes, distinct slices in order of first
    appearance).  A module-level seam: DICT pages never reach it."""
    return factorize_slices(offsets[:-1], np.diff(offsets), values)


def _binary_page_jobs(plans, large: bool):
    """One entry per page: ("k3", words, n_blocks, b, page dictionary) for
    a DICT page whose index subpage is uniform BITPACKING; ("host", codes,
    page dictionary) for one whose codes are all 0 bits wide or raw;
    ("dev", page bytes, index position, page dictionary) for any other
    index subpage; ("raw", codes, page dictionary) for raw-mode, FREQ and
    ONE_VALUE pages, their rows encoded page by page."""
    jobs = []
    for length, _v, buf, p in plans:
        codec, _cs, _us, body = read_header(buf, p)
        if codec != Compression.DICT:
            with obs.span("strawboat.scan.decompress"):
                offsets, values, _end = decode_binary_page(buf, p, length, large)
            jobs.append(("raw", *_dictionary_encode(offsets, values)))
            continue
        icodec, icsize, _ius, ibody = read_header(buf, body)
        vpos = ibody + icsize
        if vpos + 4 > len(buf):
            raise OutOfSpecError("binary dict page truncated")
        count = int(np.frombuffer(buf, "<u4", 1, vpos)[0])
        sets, _end = parse_len_prefixed(buf, vpos + 4, count)
        if not sets:  # an all-null page: its codes are 0, one empty slice
            sets = [b""]
        if icodec == Compression.BITPACKING:
            parsed = _parse_bp_page(buf, ibody, length)
            if parsed is None:  # every block 0 bits wide: every code is 0
                jobs.append(("host", np.zeros(length, dtype=np.int64), sets))
                continue
            if parsed[0] == "uniform":
                jobs.append(("k3", parsed[1], parsed[2], parsed[3], sets))
                continue
        if icodec.raw_mode:
            (raw,) = _decompress(icodec, [buf[ibody:vpos]], [length * 4])
            jobs.append(("host", np.frombuffer(raw, "<u4", length).astype(np.int64), sets))
        else:
            jobs.append(("dev", buf, body, sets))
    return jobs


def _merge_dictionaries(parts: List[List[bytes]]):
    """Page dictionaries pooled in order → (the global dictionary: each
    distinct slice once, in order of first appearance in the pool, as
    arrow's ``unique`` keeps them; the int64 remap of each pool entry into
    it; each part's base in the pool)."""
    pool = [x for part in parts for x in part]
    index: Dict[bytes, int] = {}
    remap = np.fromiter((index.setdefault(x, len(index)) for x in pool), np.int64, len(pool))
    bases = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(part) for part in parts], out=bases[1:])
    return np.array(list(index), dtype=object), remap, bases


def _check_codes(codes: torch.Tensor, limit: torch.Tensor) -> None:
    if bool((codes >= limit).any()):
        raise OutOfSpecError("dictionary code out of range")


def _decode_binary_column_device(plans, field: Field, dev) -> DeviceColumn:
    """A utf8 / binary column → int32 dictionary codes on ``dev`` and the
    host dictionary: an object array of ``bytes`` for every string type
    (the JAX scan's ``pa.binary`` dictionary, in its order).

    DICT pages never re-encode rows: a uniform BITPACKING index subpage
    goes through kernel K3, one launch per width over the group's pages,
    then one gather adds each page's base and remaps into the global
    dictionary; other index subpages decode on the device page by page
    (raw and all-zero ones on the host).  Rows of raw-mode, FREQ and
    ONE_VALUE pages are encoded on the host page by page
    (:func:`_dictionary_encode`), so memory stays bounded by one page.
    The global dictionary pools the page dictionaries in page order, the
    raw pages' last, and keeps first appearances (reference
    scan.py:1068-1083, which encodes the raw pages' rows as one column
    and pools that dictionary last: a first appearance over the rows is
    one over the raw pages' dictionaries in page order).
    ``hash_aggregate`` orders groups by code, so the order is the
    reference's."""
    with obs.span("strawboat.scan.parse"):
        jobs = _binary_page_jobs(plans, field.dtype.startswith("large_"))
    pooled = ([idx for idx, j in enumerate(jobs) if j[0] != "raw"]
              + [idx for idx, j in enumerate(jobs) if j[0] == "raw"])
    dictionary, remap, bases = _merge_dictionaries([jobs[idx][-1] for idx in pooled])
    # (base in the pool, dictionary size) of each page
    page_base = {idx: (int(bases[i]), len(jobs[idx][-1])) for i, idx in enumerate(pooled)}
    on_device = any(j[0] in ("k3", "dev") for j in jobs)
    remap_dev = _to_device(remap.astype(np.int32), dev) if on_device else None

    def remap_device(codes: torch.Tensor, base, limit) -> torch.Tensor:
        """u32 page codes (int32 bits) → global codes, checked against
        their page's dictionary size."""
        codes = codes.to(torch.int64) & 0xFFFFFFFF
        _check_codes(codes, limit)
        return dict_gather_device(codes + base, remap_dev)

    with obs.span("strawboat.scan.decode"):
        # one K3 launch per width; every page's base and size ride per slot
        k3_slices = {}
        for gkey, group in _k3_groups([(idx, Compression.DICT, j[1], j[2], j[3], None)
                                       for idx, j in enumerate(jobs) if j[0] == "k3"]).items():
            words = _to_device(np.concatenate([g[2] for g in group]), dev)
            dec = bitunpack_natural_device(words, gkey[1])
            slot_sizes = [g[3] * 128 for g in group]
            base = _repeat_per_page([page_base[g[0]][0] for g in group], slot_sizes, len(dec), dev)
            limit = _repeat_per_page([page_base[g[0]][1] for g in group], slot_sizes, len(dec), dev)
            codes = remap_device(dec, base, limit)
            off = 0
            for g, n in zip(group, slot_sizes):
                k3_slices[g[0]] = (codes, off)
                off += n

        parts_out: List[Any] = []
        host_run: List[np.ndarray] = []

        def flush_host():
            if host_run:
                parts_out.append(_to_device(np.concatenate(host_run).astype(np.int32), dev))
                host_run.clear()

        for idx, (j, (length, _v, _buf, _p)) in enumerate(zip(jobs, plans)):
            if j[0] in ("raw", "host"):
                base, size = page_base[idx]
                if len(j[1]) and int(j[1].max()) >= size:
                    raise OutOfSpecError("dictionary code out of range")
                host_run.append(remap[j[1] + base])
            else:
                flush_host()
                if j[0] == "k3":
                    codes, off = k3_slices[idx]
                    parts_out.append(codes[off : off + length])
                else:
                    base, size = page_base[idx]
                    dec, _end = _decode_structured_to_device(j[1], j[2], length, np.dtype(np.uint32), dev)
                    parts_out.append(remap_device(dec, base, size))
        flush_host()
        if not parts_out:
            codes = torch.zeros(0, dtype=torch.int32, device=dev)
        else:
            codes = parts_out[0] if len(parts_out) == 1 else torch.cat(parts_out)
    return DeviceColumn(field.name, field.dtype, codes.to(torch.int32), _validity(plans, dev),
                        dictionary=dictionary)


# ---------------------------------------------------------------------------
# nested columns (reference scan.py:1172-1358 and read/batch_read.py:36-54)
#
# A nested field decodes leaf by leaf, page by page.  Each page's levels
# expand on the host (``read_validity_nested``) into per-level offsets and
# validities, concatenated over the pages by rebasing the offsets (the
# reference concatenates assembled arrow arrays instead).  The leaf bodies
# are ordinary codec pages: a nested page's plan is the flat plan
# (leaf count, leaf validity, page bytes, position after the levels), so
# leaf values take the flat device routes (K3 groups, the varwidth
# decoder, the streamed raw feed, string codes), where the reference
# decodes them on the host.


def _level_fields(field: Field) -> List[List[Field]]:
    """Per leaf of ``field``, the field of each of its levels (a map: the
    map, its ``entries`` struct, then the key or the value)."""
    out: List[List[Field]] = []

    def walk(f: Field, parents: List[Field]) -> None:
        if f.dtype == "struct":
            for c in f.children:
                walk(c, parents + [f])
        elif f.dtype.startswith("map"):
            entries = f.children[0]
            for c in entries.children:
                walk(c, parents + [f, entries])
        elif f.is_nested:
            walk(f.children[0], parents + [f])
        else:
            out.append(parents + [f])

    walk(field, [])
    return out


def _leaf_names(field: Field) -> List[str]:
    """The table column of each leaf, as the reference names them: a
    struct's child is ``parent.child``, a list's leaves keep the list's
    name, a map's are ``.key`` and ``.value``."""
    out: List[str] = []

    def walk(f: Field, name: str) -> None:
        if f.dtype == "struct":
            for c in f.children:
                walk(c, f"{name}.{c.name}")
        elif f.dtype.startswith("map"):
            key, value = f.children[0].children
            walk(key, name + ".key")
            walk(value, name + ".value")
        elif f.is_nested:
            walk(f.children[0], name)
        else:
            out.append(name)

    walk(field, field.name)
    return out


def _plan_nested_pages(file_bytes: np.ndarray, meta: ColumnMeta, init, keep=None,
                       cache: Optional[Dict] = None):
    """The kept pages of one nested leaf → (flat plans: (leaf count, leaf
    validity or None, page bytes, position after the levels), the levels
    over those pages).  ``cache`` (one per field) keeps each distinct
    level section's expansion and each distinct run of pages' levels:
    the leaves of one list of structs without nulls share their levels,
    so they expand once."""
    cache = {} if cache is None else cache
    plans, page_keys = [], []
    pos = meta.offset
    for i, page in enumerate(meta.pages):
        if keep is not None and not keep[i]:
            pos += page.length
            continue
        buf = file_bytes[pos : pos + page.length]
        if len(buf) != page.length or len(buf) < 12:
            raise OutOfSpecError("page past the end of the file")
        _rows, rep_len, def_len = (int(x) for x in np.frombuffer(buf, "<u4", 3, 0))
        key = (bytes(buf[: 12 + rep_len + def_len]), page.num_values,
               tuple((x.kind, x.nullable) for x in init))
        if key not in cache:
            state, leaf_validity, _r, p = read_validity_nested(buf, 0, page.num_values, init)
            cache[key] = (state.levels, leaf_validity, p)
        levels, leaf_validity, p = cache[key]
        plans.append((levels[-1].length, leaf_validity, buf, p))
        page_keys.append(key)
        pos += page.length
    obs.count("scan.pages_planned", len(meta.pages))
    obs.count("scan.pages_kept", len(plans))
    run = ("run", tuple(page_keys), tuple((x.kind, x.nullable) for x in init))
    if run not in cache:
        cache[run] = _concat_levels([cache[k][0] for k in page_keys], init)
    return plans, list(cache[run])


def _concat_levels(page_levels, init) -> List[NestedLevel]:
    """Per-page levels → one level per depth: lengths add up, validities
    concatenate, offsets rebase onto the child count before the page."""
    out = []
    for d, lvl in enumerate(init):
        parts = [levels[d] for levels in page_levels]
        length = sum(p.length for p in parts)
        validity = None
        if any(p.validity is not None for p in parts):
            validity = np.concatenate(
                [np.ones(p.length, bool) if p.validity is None else p.validity for p in parts])
        offsets = None
        if lvl.kind == LIST:
            offsets = np.zeros(length + 1, dtype=np.int64)
            row = base = 0
            for p in parts:
                offsets[row + 1 : row + p.length + 1] = p.offsets[1:] + base
                row += p.length
                base += int(p.offsets[-1])
        out.append(NestedLevel(lvl.kind, lvl.nullable, length, validity, offsets))
    return out


def _insert_fixed_size_slots(levels: List[NestedLevel], fields: List[Field],
                             col: DeviceColumn) -> DeviceColumn:
    """A fixed-size list's null rows own their ``size`` child slots in
    arrow, but the writer drops them: put them back, null, at every level
    below (a struct's children share its slots; a list's take empty
    entries; leaf slots take zeros, on the device).  The reference does
    this while assembling (read/deserialize.py:165-195)."""
    for d, f in enumerate(fields):
        size = fixed_size(f.dtype)
        lvl = levels[d]
        if size is None or lvl.validity is None or lvl.validity.all():
            continue
        rows = np.flatnonzero(lvl.validity)
        src = np.full(lvl.length * size, -1, dtype=np.int64)
        src[(rows[:, None] * size + np.arange(size)).reshape(-1)] = np.arange(len(rows) * size)
        levels[d] = NestedLevel(LIST, lvl.nullable, lvl.length, lvl.validity,
                                np.arange(lvl.length + 1, dtype=np.int64) * size)
        kept = src >= 0
        for e in range(d + 1, len(levels)):
            c = levels[e]
            validity = np.zeros(len(src), dtype=bool)
            validity[kept] = True if c.validity is None else c.validity[src[kept]]
            offsets = None
            if c.kind == LIST:
                lens = np.zeros(len(src), dtype=np.int64)
                lens[kept] = np.diff(c.offsets)[src[kept]]
                offsets = np.zeros(len(src) + 1, dtype=np.int64)
                np.cumsum(lens, out=offsets[1:])
            levels[e] = NestedLevel(c.kind, c.nullable, len(src), validity, offsets)
            if c.kind == PRIMITIVE:
                col = _gather_slots(col, src)
            if c.kind != STRUCT:
                break
    return col


def _gather_slots(col: DeviceColumn, src: np.ndarray) -> DeviceColumn:
    """Leaf values at ``src`` (-1: a new null slot holding zero)."""
    dev = col.values.device
    idx = torch.from_numpy(src).to(dev)
    ok = idx >= 0
    if len(col.values):
        values = torch.where(ok, col.values[idx.clamp(min=0)], torch.zeros((), dtype=col.values.dtype,
                                                                            device=dev))
        validity = ok if col.validity is None else ok & col.validity[idx.clamp(min=0)]
    else:
        values = torch.zeros(len(src), dtype=col.values.dtype, device=dev)
        validity = ok
    return DeviceColumn(col.name, col.dtype, values, validity, col.dictionary)


def _compose_offsets(chain: List[np.ndarray]) -> np.ndarray:
    """Per-level offsets, outer → inner, each zero-based → row → leaf
    offsets (int64 throughout: the reference casts them to int32)."""
    comp = chain[0]
    for inner in chain[1:]:
        comp = inner[comp]
    return comp


def _scan_nested(file_bytes, metas, field: Field, dev, keep):
    """A nested field's kept pages → (its table columns, its NestedLeafs,
    its row count)."""
    inits = field_inits(field)
    lfields = leaf_fields(field)
    for lf in lfields:
        _check_flat(lf)
    leaves, cols, cache = [], [], {}
    for meta, init, lf, fields, name in zip(metas, inits, lfields, _level_fields(field),
                                            _leaf_names(field)):
        with obs.span("strawboat.scan.plan"):
            plans, levels = _plan_nested_pages(file_bytes, meta, init, keep, cache)
        col = _decode_plans(plans, Field(name, lf.dtype, lf.nullable), dev)
        col = _insert_fixed_size_slots(levels, fields, col)
        leaves.append(NestedLeaf(name, levels, fields))
        cols.append(col)
    rows = leaves[0].levels[0].length if leaves else 0
    chains: Dict[tuple, tuple] = {}  # list levels → their tensors, shared by leaves
    out = []
    for leaf, col in zip(leaves, cols):
        lists = [(lvl, f) for lvl, f in zip(leaf.levels, leaf.fields) if lvl.kind == LIST]
        if not lists:
            out.append(col)
            continue
        key = tuple(id(f) for _l, f in lists)
        if key not in chains:
            stack = [lvl.offsets for lvl, _f in lists]
            comp = _to_device(_compose_offsets(stack), dev)
            stack_t = tuple(comp if i == 0 and len(stack) == 1 else _to_device(o, dev)
                            for i, o in enumerate(stack))
            valids = tuple(None if not lvl.nullable or lvl.validity is None
                           else _to_device(lvl.validity, dev) for lvl, _f in lists)
            chains[key] = (comp, stack_t, valids)
        comp, stack_t, valids = chains[key]
        out.append(DeviceListColumn(
            col.name, col.dtype, col.values, valids[0], col.dictionary, offsets=comp,
            child_validity=col.validity, offsets_stack=stack_t, list_validities=valids,
            level_fields=tuple(f for _l, f in lists)))
    return out, leaves, rows


# ---------------------------------------------------------------------------
# entry points (reference scan.py:1361-1512)


def _open(path: str):
    """(schema, metas, the file's bytes as a plain ndarray view of a map:
    indexing a np.memmap costs ~20x more)."""
    with open(path, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    return schema, metas, np.memmap(path, dtype=np.uint8, mode="r").view(np.ndarray)


def _selected_leaves(schema, metas, columns: Optional[Sequence[str]]):
    """(leaf metas, field) of each selected top-level column."""
    i = 0
    for field in schema:
        leaf_metas = metas[i : i + field.n_leaves]
        i += field.n_leaves
        if columns is None or field.name in columns:
            yield leaf_metas, field


def _selected(schema, metas, columns: Optional[Sequence[str]]):
    """(first leaf's meta, field) of each selected top-level column."""
    for leaf_metas, field in _selected_leaves(schema, metas, columns):
        yield leaf_metas[0], field


def page_keep_mask(path: str, metas, predicates) -> Optional[np.ndarray]:
    """The zone maps' keep mask over the file's page grid, or None when
    every page stays (no predicates, no zone block, nothing pruned).  A
    predicate that is not a ``pruning.Comparison`` raises."""
    if not predicates:
        return None
    predicates = check_predicates(predicates)
    zones = read_zones(path)
    if not zones:
        return None
    keep = prune_pages(zones, predicates, max((len(m.pages) for m in metas), default=0))
    return None if keep.all() else keep


def _scan(path, file_bytes, schema, metas, columns, dev, keep) -> DeviceTable:
    out: Dict[str, DeviceColumn] = {}
    nested: Dict[str, Any] = {}
    num_rows = 0
    for leaf_metas, field in _selected_leaves(schema, metas, columns):
        if field.is_nested:
            cols, leaves, num_rows = _scan_nested(file_bytes, leaf_metas, field, dev, keep)
            out.update((c.name, c) for c in cols)
            nested[field.name] = (field, leaves)
            continue
        if field.dtype == NULL_TYPE:
            col = _null_column(path, leaf_metas, field, dev, keep)
        else:
            col = decode_column_pages_device(file_bytes, leaf_metas[0], field, dev, keep)
        out[field.name] = col
        num_rows = len(col)
    return DeviceTable(out, num_rows, nested)


def _null_column(path: str, leaf_metas, field: Field, dev, keep) -> DeviceColumn:
    """A null column's kept pages through the host batch read, as the
    reference scan reads it (scan.py:1404, :1477): int32 zeros, validity
    all False, on ``dev``."""
    from ..read.batch_read import batch_read_column
    from ..read.reader import open_readers, open_readers_subset

    readers = (open_readers(path, leaf_metas) if keep is None
               else open_readers_subset(path, leaf_metas, keep))
    try:
        n = len(batch_read_column(readers, field))
    finally:
        for r in readers:
            r.page_reader.close()
    return DeviceColumn(field.name, field.dtype, torch.zeros(n, dtype=torch.int32, device=dev),
                        torch.zeros(n, dtype=torch.bool, device=dev))


def scan_file(
    path: str,
    device,
    columns: Optional[Sequence[str]] = None,
    predicates: Optional[Sequence] = None,
) -> DeviceTable:
    """Scan a strawboat file onto ``device`` (``"cuda"``, ``"cpu"``, a
    ``torch.device``).

    ``columns`` picks top-level columns by name (default: all).  ``predicates`` (a list of
    ``pruning.Comparison``, e.g. ``Expr.atoms``) drop the pages the file's
    zone maps show cannot match, for every column, so the row grid stays
    aligned; a file without zone maps scans whole, as in the reference.
    String columns come back as int32 dictionary codes with the host
    dictionary (``_decode_binary_column_device``), decimals as unscaled
    int64 (``_decode_decimal_column``), temporal types as their int
    storage.  A nested column becomes one column per leaf (``parent.child``
    under a struct, ``.key`` / ``.value`` under a map): a
    ``DeviceListColumn`` under list levels, a ``DeviceColumn`` otherwise;
    ``DeviceTable.nested`` keeps each nested field's levels."""
    dev = as_device(device)
    with obs.span("strawboat.scan"):
        with obs.span("strawboat.scan.open"):
            schema, metas, file_bytes = _open(path)
            keep = page_keep_mask(path, metas, predicates)
        return _scan(path, file_bytes, schema, metas, columns, dev, keep)


def scan_chunks(
    path: str,
    chunk_pages: int,
    device,
    columns: Optional[Sequence[str]] = None,
    predicates: Optional[Sequence] = None,
):
    """The file as a stream of DeviceTables of ``chunk_pages`` pages each
    on ``device``, pruned by ``predicates`` as in :func:`scan_file`; a
    chunk whose pages are all pruned is skipped.  Each chunk decodes on
    its own (dictionary codes index that chunk's dictionary); nested
    columns come in every chunk, as in :func:`scan_file`."""
    dev = as_device(device)
    if chunk_pages < 1:
        raise ValueError(f"chunk_pages must be at least 1, got {chunk_pages}")
    with obs.span("strawboat.scan"), obs.span("strawboat.scan.open"):
        schema, metas, file_bytes = _open(path)
        base = page_keep_mask(path, metas, predicates)
    n_pages = max((len(m.pages) for m in metas), default=0)
    for start in range(0, n_pages, chunk_pages):
        keep = np.zeros(n_pages, dtype=bool)
        keep[start : start + chunk_pages] = True
        if base is not None:
            keep &= base
        if keep.any():
            with obs.span("strawboat.scan"):
                chunk = _scan(path, file_bytes, schema, metas, columns, dev, keep)
            yield chunk


def k3_launch_groups(path: str, columns: Optional[Sequence[str]] = None):
    """What ``scan_file(path, columns=columns)`` hands kernel K3, one
    entry per launch: [(column, (codec, b), page indices, words (n_blocks,
    4b) u32)]; the DICT index pages of string, float and decimal columns
    are ``(DICT, b)``, a nested field's leaves are named as in the scan.
    For timing K3 alone at the scan's shapes."""
    out = []
    schema, metas, file_bytes = _open(path)
    for leaf_metas, field in _selected_leaves(schema, metas, columns):
        if field.is_nested:
            leaves = [(Field(name, lf.dtype, lf.nullable),
                       _plan_nested_pages(file_bytes, meta, init)[0])
                      for meta, init, lf, name in zip(leaf_metas, field_inits(field),
                                                      leaf_fields(field), _leaf_names(field))]
        else:
            leaves = [(field, _plan_pages(file_bytes, leaf_metas[0], field.nullable))]
        for f, plans in leaves:
            if f.is_flat_string:
                k3_jobs = [(idx, Compression.DICT, j[1], j[2], j[3], None)
                           for idx, j in enumerate(_binary_page_jobs(plans, f.dtype.startswith("large_")))
                           if j[0] == "k3"]
            elif f.is_flat_decimal:
                width = decimal_params(f.dtype)[0] // 8
                k3_jobs = _sort_jobs(plans, np.dtype(np.int64), _decimal_dict(width))[1]
            elif f.is_flat_int or f.is_flat_float:
                k3_jobs = _sort_jobs(plans, _column_np_dtype(f))[1]
            else:
                continue
            for gkey, jobs in _k3_groups(k3_jobs).items():
                out.append((f.name, gkey, [j[0] for j in jobs],
                            np.concatenate([j[2] for j in jobs])))
    return out
