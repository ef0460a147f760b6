"""Writing a DeviceTable: codec choices from page stats reduced on the device.

Counterpart of ``strawboat_tpu/write/device.py`` (the re-encode of a table
that already lives on the device, e.g. after a shuffle).  Per numeric
column, one batched stats call over every page on the column's device
(``kernels/encode.paged_stats_device``), one download of the stats and one
of the values; the codec chooser of the integer or float family takes
those stats, and only the chosen codec's bytes are made on the host.  The
device stats carry a distinct ESTIMATE and no mode, so FREQ is offered
only where the estimate is 16 or less and one ``np.unique`` of the page's
valid values gives the exact mode.

- strings go from the scan's int32 codes and host dictionary straight to
  DICT pages (the page's codes in sorted order as its dictionary); a
  string row is never built;
- decimals become the ``(n, W)`` byte matrix of their unscaled int64,
  through the decimal family, with zones in the unscaled domain;
- booleans pack to bitmap bytes on the device when ``page_size % 8 == 0``
  (ONE_VALUE when a page holds one valid value, RLE when its exact run
  encoding beats the ratio, else the raw bitmap slice), and go through the
  host boolean family otherwise;
- list columns (list, large_list and fixed-size list levels) rebuild
  their column model from the ``DeviceListColumn``'s offsets, validities
  and leaf, then take the host writer's nested pages; a map rebuilds from
  its ``.key`` and ``.value`` columns, both of which the table must hold,
  and is written as one map column of two leaves (the reference writes
  each leaf as a column of the map's type, a file that does not scan
  back); any other nested field of several leaves raises, as in the
  reference.

Zones (``options.zone_maps``) come from the device stats for integers and
float32, from the host bytes for float64, from the device counts for
booleans; string and list columns get none.  With the same options the
file's bytes equal the JAX ``write_device_table``'s (a map's, the JAX
``write_file``'s).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from .. import columns as cm
from ..codecs import WriteOptions, compress, write_header
from ..codecs import boolean as boolean_codec
from ..codecs import double as double_codec
from ..codecs import integer as integer_codec
from ..codecs._family import FamilyStats
from ..codecs.binary import _len_prefixed
from ..codecs.decimal import compress_decimal, from_int64
from ..constants import Compression
from ..errors import NotYetImplementedError
from ..exec.pruning import ColumnZones, PageZone, _py, compute_zones
from ..exec.scan import DeviceColumn, DeviceListColumn, host_values, unsigned_view
from ..kernels.encode import paged_bool_stats_device, paged_stats_device
from ..meta import ColumnMeta
from ..read.levels import leaf_fields
from ..schema import Field, decimal_params, fixed_size
from ..util import env
from ..util.hybrid_rle import encode_validity_bitpacked
from ..util.obs import log_codec_choice
from .writer import _write_all, write_nested_page
from .nested import slice_nested, to_nested


def _prelude(pv: Optional[np.ndarray]) -> bytes:
    """A nullable flat page's ``[u32 len][bit-packed validity]``, empty
    when the page has no nulls."""
    if pv is None or pv.all():
        return np.uint32(0).tobytes()
    body = encode_validity_bitpacked(pv)
    return np.uint32(len(body)).tobytes() + body


def _family_stats_from_device(page_vals: np.ndarray, pv: Optional[np.ndarray], d: dict,
                              i: int) -> FamilyStats:
    """A page's FamilyStats from the device reductions: distinct values
    from the estimate (0 on a page of nulls; 1, or 2 with nulls, when min
    equals max), no mode (FREQ stays off)."""
    n = len(page_vals)
    dtype = page_vals.dtype
    null_count, set_count = int(d["null_count"][i]), int(d["set_count"][i])
    run_count = int(d["run_count"][i])
    vmin, vmax = dtype.type(d["min"][i]), dtype.type(d["max"][i])
    if set_count == 0:
        unique = 0
    elif vmin == vmax:
        unique = 1 if null_count == 0 else 2
    else:
        unique = max(2, int(d["unique_est"][i]))
    return FamilyStats(
        values=page_vals, validity=pv, tuple_count=n, total_bytes=n * dtype.itemsize,
        null_count=null_count, average_run_length=(n / run_count) if run_count else float("inf"),
        is_sorted=bool(d["is_sorted"][i]), min=vmin, max=vmax, unique_count=unique,
        top_value=vmin, max_count=0, set_count=set_count,
    )


def _encode_numeric_page(vals: np.ndarray, pv: Optional[np.ndarray], stats: FamilyStats,
                         options: WriteOptions, allow_freq: bool) -> bytes:
    is_float = vals.dtype.kind == "f"
    mod = double_codec if is_float else integer_codec
    opts = options if allow_freq else options.forbid(Compression.FREQ)
    codec = mod.choose_compressor(stats, opts)
    log_codec_choice("double" if is_float else "integer", codec)
    if codec.raw_mode:
        return integer_codec.frame_raw(codec, vals)
    body = mod._codec_compress(codec, vals, pv, stats, opts)
    return write_header(codec, len(body), len(vals) * vals.dtype.itemsize) + body


def _spans(n: int, page_size: int):
    return [(off, min(page_size, n - off)) for off in range(0, n, page_size)]


def _page_validity(validity: Optional[np.ndarray], off: int, ln: int) -> Optional[np.ndarray]:
    return None if validity is None else validity[off : off + ln]


def _numeric_pages(col: DeviceColumn, field: Field, validity, page_size, options):
    """(page bytes, rows, zone) per page of an integer, temporal or float
    column."""
    d = paged_stats_device(col.values, col.validity, page_size, unsigned=unsigned_view(col))
    d = {k: v.cpu().numpy() for k, v in d.items()}
    vals = host_values(col)
    d["min"], d["max"] = d["min"].view(vals.dtype), d["max"].view(vals.dtype)
    out = []
    for i, (off, ln) in enumerate(_spans(len(vals), page_size)):
        pv = _page_validity(validity, off, ln)
        page_vals = vals[off : off + ln]
        stats = _family_stats_from_device(page_vals, pv, d, i)
        # a low estimate: the exact mode from the page's valid values
        # re-enables FREQ
        allow_freq = False
        if stats.set_count > 0 and stats.unique_count <= 16:
            pvals = page_vals if pv is None else page_vals[pv]
            uq, counts = np.unique(pvals, return_counts=True)
            top = int(np.argmax(counts))
            stats.top_value, stats.max_count, stats.unique_count = uq[top], int(counts[top]), len(uq)
            allow_freq = True
        body = _encode_numeric_page(page_vals, pv, stats, options, allow_freq)
        nulls = int(d["null_count"][i])
        if page_vals.dtype == np.float64:
            zone = PageZone(*compute_zones(page_vals, pv), ln)
        elif int(d["set_count"][i]) == 0:
            zone = PageZone(None, None, nulls, ln)
        else:
            zone = PageZone(_py(d["min"][i]), _py(d["max"][i]), nulls, ln)
        out.append(((_prelude(pv) if field.nullable else b"") + body, ln, zone))
    return out


def _bool_pages_device(col: DeviceColumn, field: Field, validity, page_size, options):
    """Boolean pages from the bitmap packed on the device (page_size % 8
    == 0): ONE_VALUE for one valid value, RLE when its exact size (5 bytes
    a run) beats the ratio, else the bitmap slice through the default
    codec; the host unpacks only a ONE_VALUE or RLE page."""
    packed, st = paged_bool_stats_device(col.values, col.validity, page_size)
    packed = packed.cpu().numpy()
    st = {k: v.cpu().numpy() for k, v in st.items()}
    max_ratio = options.default_compress_ratio
    force_rle = env.check_rle_env()
    out = []
    for i, (off, ln) in enumerate(_spans(len(col), page_size)):
        pv = _page_validity(validity, off, ln)
        true_c, set_c, run_c = int(st["true_count"][i]), int(st["set_count"][i]), int(st["run_count"][i])
        nbytes = (ln + 7) // 8
        pslice = packed[off // 8 : off // 8 + nbytes]
        codec = options.default_compression
        if force_rle:
            codec = Compression.RLE
        elif max_ratio is not None:
            if (true_c == 0 or true_c == set_c) and float(ln) > max_ratio:
                codec = Compression.ONE_VALUE
            elif run_c and nbytes / (run_c * 5) > max_ratio:
                codec = Compression.RLE
        log_codec_choice("boolean", codec)
        if codec == Compression.ONE_VALUE:
            body = boolean_codec.one_value_encode(np.unpackbits(pslice, count=ln, bitorder="little"), pv)
        elif codec == Compression.RLE:
            body = boolean_codec.rle_bool_encode(np.unpackbits(pslice, count=ln, bitorder="little"), pv)
        else:
            body = compress(codec, pslice.tobytes())
        nulls = int(st["null_count"][i])
        zone = PageZone(None, None, nulls, ln) if set_c == 0 else PageZone(
            0 if set_c > true_c else 1, 1 if true_c > 0 else 0, nulls, ln)
        out.append(((_prelude(pv) if field.nullable else b"") + write_header(codec, len(body), ln) + body,
                    ln, zone))
    return out


def _flat_pages(col: DeviceColumn, field: Field, validity, page_size, options, encode):
    """(page bytes, rows, zone) per page from ``encode(off, ln, pv)`` →
    (codec page, zone)."""
    out = []
    for off, ln in _spans(len(col), page_size):
        pv = _page_validity(validity, off, ln)
        page, zone = encode(off, ln, pv)
        out.append(((_prelude(pv) if field.nullable else b"") + page, ln, zone))
    return out


def _string_dict_page(codes: np.ndarray, dictionary: np.ndarray, dict_lens: np.ndarray,
                      options: WriteOptions) -> bytes:
    """A DICT page straight from codes: the page's distinct codes in sorted
    order are its dictionary, the index subpage their ranks; the header's
    uncompressed size is the rows' byte count."""
    uniq, inv = np.unique(codes, return_inverse=True)
    body = (integer_codec.compress_integer(inv.reshape(-1).astype(np.uint32), None,
                                           options.forbid(Compression.DICT))
            + np.uint32(len(uniq)).tobytes() + _len_prefixed([dictionary[u] for u in uniq.tolist()]))
    log_codec_choice("binary", Compression.DICT)
    return write_header(Compression.DICT, len(body), int(dict_lens[codes].sum())) + body


def _as_bytes(dictionary) -> np.ndarray:
    """A column's host dictionary as an object array of ``bytes`` (a
    resident table's utf8 dictionary holds ``str``)."""
    return np.array([v.encode() if isinstance(v, str) else bytes(v) for v in dictionary], dtype=object)


def _leaf_model(col: DeviceColumn) -> cm.Column:
    """A scanned list leaf's values as the column model (strings gathered
    from the dictionary in one pass)."""
    validity = None if col.child_validity is None else col.child_validity.cpu().numpy()
    if col.dictionary is not None:
        dictionary = _as_bytes(col.dictionary)
        lens = np.array([len(v) for v in dictionary], dtype=np.int64)
        starts = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        blob = np.frombuffer(b"".join(dictionary), np.uint8)
        codes = col.values.cpu().numpy().astype(np.int64)
        offsets = np.zeros(len(codes) + 1, dtype=np.int64)
        np.cumsum(lens[codes], out=offsets[1:])
        return cm.BinaryColumn(col.dtype, validity, offsets,
                               blob[cm._ranges(starts[codes], lens[codes])])
    vals = host_values(col)
    if vals.dtype == np.bool_:
        return cm.BooleanColumn(col.dtype, validity, vals)
    return cm.PrimitiveColumn(col.dtype, validity, vals)


def _list_model(col: DeviceListColumn, leaf: cm.Column) -> cm.Column:
    """The list levels of ``col`` (outer → inner) over its leaf model.  A
    fixed-size list level's null rows lose their slots, as the reference's
    arrow rebuild and ``to_nested`` leave them: its levels are then those
    of a list whose null rows are empty."""
    model = leaf
    for offs, valid, lf in reversed(list(zip(col.offsets_stack, col.list_validities,
                                             col.level_fields))):
        offs = offs.cpu().numpy().astype(np.int64)
        valid = None if valid is None else valid.cpu().numpy()
        if fixed_size(lf.dtype) is not None and valid is not None and not valid.all():
            lens = np.where(valid, np.diff(offs), 0)
            rows = np.flatnonzero(valid)
            model = model.take(cm._ranges(offs[rows], lens[rows]))
            offs = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=offs[1:])
        model = cm.ListColumn(lf.dtype, valid, offs, model)
    return model


def _map_leaves(table, name: str, col: DeviceColumn):
    """(key column, value column) when ``col`` is the key leaf of a map of
    flat keys and values, outside any other level, whose value leaf the
    table holds too, else None."""
    if not isinstance(col, DeviceListColumn) or len(col.level_fields) != 1:
        return None
    f = col.level_fields[0]
    if (not f.dtype.startswith("map") or name != f"{f.name}.key"
            or any(c.is_nested for c in f.children[0].children)):
        return None
    value = table.columns.get(f"{f.name}.value")
    if not isinstance(value, DeviceListColumn) or value.level_fields[0] != f:
        return None
    return col, value


def _nested_pages(model: cm.Column, field: Field, rows: int, page_size, options):
    """The host writer's nested pages of one nested column model, one list
    of (page bytes, level count, no zone) per leaf."""
    out = []
    for lf, (nests, leaf) in zip(leaf_fields(field), to_nested(model, field)):
        pages = []
        for off, ln in _spans(rows, page_size):
            s_nests, s_leaf = slice_nested(nests, leaf, off, ln)
            body, num_values = write_nested_page(s_nests, s_leaf, lf, options)
            pages.append((body, num_values, None))
        out.append(pages)
    return out


def _list_pages(col: DeviceListColumn, field: Field, page_size, options):
    """The host writer's nested pages of a list column (list, large_list
    and fixed-size list levels) rebuilt from its offsets, validities and
    leaf; no zones."""
    if field.n_leaves != 1:
        raise NotYetImplementedError(f"device write of multi-leaf nested column {col.name!r}")
    f = field
    while f.is_nested:
        if f.dtype not in ("list", "large_list") and fixed_size(f.dtype) is None:
            raise NotYetImplementedError(f"device write of a {f.dtype} level ({col.name!r})")
        f = f.children[0]
    (pages,) = _nested_pages(_list_model(col, _leaf_model(col)), field, len(col), page_size,
                             options)
    return pages


def _map_pages(key: DeviceListColumn, value: DeviceListColumn, field: Field, page_size, options):
    """A map column's two leaves' pages, its key and value leaves rebuilt
    from the scan's ``.key`` and ``.value`` columns over the map's offsets
    and validity."""
    valid = key.list_validities[0]
    model = cm.MapColumn(field.dtype, None if valid is None else valid.cpu().numpy(),
                         key.offsets_stack[0].cpu().numpy().astype(np.int64),
                         _leaf_model(key), _leaf_model(value))
    return _nested_pages(model, field, len(key), page_size, options)


def _field(name: str, col: DeviceColumn) -> Field:
    """The file field of a column: its type, nullable when it has a
    validity (a list column: its outermost list level's field)."""
    nullable = col.validity is not None
    if isinstance(col, DeviceListColumn):
        return dataclasses.replace(col.level_fields[0], name=name, nullable=nullable)
    dtype = col.dtype
    if dtype is None:
        dtype = str(host_values(col).dtype)
    elif not isinstance(dtype, str):
        dtype = cm._alias(dtype)
    return Field(name, dtype, nullable)


def _column_pages(col: DeviceColumn, field: Field, page_size: int, options: WriteOptions):
    """(page bytes, rows or level count, zone or None) per page of one
    column."""
    if len(col) == 0:
        return []
    if isinstance(col, DeviceListColumn):
        return _list_pages(col, field, page_size, options)
    validity = None if col.validity is None else col.validity.cpu().numpy()
    if col.dictionary is not None:
        codes = col.values.cpu().numpy().astype(np.int64)
        dictionary = _as_bytes(col.dictionary)
        dict_lens = np.array([len(v) for v in dictionary], dtype=np.int64)
        return _flat_pages(col, field, validity, page_size, options, lambda off, ln, pv: (
            _string_dict_page(codes[off : off + ln], dictionary, dict_lens, options), None))
    if field.is_flat_decimal:
        v = host_values(col).astype(np.int64)
        mat = from_int64(v, decimal_params(field.dtype)[0] // 8)
        return _flat_pages(col, field, validity, page_size, options, lambda off, ln, pv: (
            compress_decimal(mat[off : off + ln], pv, options),
            PageZone(*compute_zones(v[off : off + ln], pv), ln)))
    if col.values.dtype == torch.bool:
        if page_size % 8 == 0:
            return _bool_pages_device(col, field, validity, page_size, options)
        vals = col.values.cpu().numpy()
        return _flat_pages(col, field, validity, page_size, options, lambda off, ln, pv: (
            boolean_codec.compress_boolean(vals[off : off + ln], pv, options),
            PageZone(*compute_zones(vals[off : off + ln].astype(np.int64), pv), ln)))
    return _numeric_pages(col, field, validity, page_size, options)


def write_device_table(path_or_file, table, options: Optional[WriteOptions] = None) -> List[ColumnMeta]:
    """Write a ``DeviceTable`` (``exec.scan``) as one strawboat file, the
    codecs chosen from page stats reduced on each column's device; returns
    the column metas.  ``scan_file`` of the file gives the table back row
    for row."""
    options = options or WriteOptions()
    rows = max(table.num_rows, 1)
    page_size = max(min(int(options.max_page_size or rows), rows), 1)
    fields, pages, zones = [], [], {}
    written_values = set()
    for name, col in table.columns.items():
        if name in written_values:
            continue
        leaves = _map_leaves(table, name, col)
        if leaves is not None:
            key, value = leaves
            field = dataclasses.replace(key.level_fields[0], nullable=key.validity is not None)
            fields.append(field)
            pages.extend([(body, n) for body, n, _z in leaf_pages]
                         for leaf_pages in _map_pages(key, value, field, page_size, options))
            written_values.add(f"{field.name}.value")
            continue
        field = _field(name, col)
        col_pages = _column_pages(col, field, page_size, options)
        fields.append(field)
        pages.append([(body, n) for body, n, _z in col_pages])
        page_zones = [z for _b, _n, z in col_pages]
        if options.zone_maps and page_zones and all(z is not None for z in page_zones):
            zones[name] = ColumnZones(name, page_zones)
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "wb") if own else path_or_file
    try:
        return _write_all(f, fields, pages, zones)
    finally:
        if own:
            f.close()
