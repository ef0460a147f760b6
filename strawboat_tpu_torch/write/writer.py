"""Writing strawboat files, without pyarrow.

Counterpart of ``NativeWriter`` / ``write_file`` (``strawboat_tpu/write/
writer.py``) and ``write_simple`` / ``write_nested_page`` / ``_take_leaf``
(``strawboat_tpu/write/serialize.py``) for integer, temporal, utf8,
binary, float, bool, decimal and null columns and the nested columns over
them (list, large_list, fixed-size list, map, struct), from numpy, the
column model or a ``pa.Table`` (pyarrow imported only for one).  The
layout is the reference's:

    "ARROW2" + 2 zero bytes
    per leaf column, per page of ``max_page_size`` (top-level) rows:
        [u32 def_len][bit-packed validity]   (a nullable flat field), or
        [u32 rows][u32 rep_len][u32 def_len][rep][def]   (a nested leaf)
        [9-byte header][body]                (``codecs/integer.py``,
                                              ``binary.py``, ``double.py``,
                                              ``boolean.py``, ``decimal.py``;
                                              a null column's pages are empty)
    zone block (``options.zone_maps``: ``exec/pruning.py``; flat integer,
    temporal and float columns only)
    schema (bare flatbuffer), metas, [u32 schema_size][u32 meta_size],
    EOS marker (0xFFFFFFFF, then 0 as u32)

Under the same forcing flags the file's bytes equal the JAX writer's.

A :func:`write_file` is a ``strawboat.write`` root span (``util/obs.py``)
with ``.prepare`` (the columns to storage arrays), one ``.page`` a page
job (in the pool's threads, each counting in ``write.pages``; the codecs'
``.stats``, ``.choose`` and ``.encode`` under it) and ``.io`` (the
file's writes).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import re
from typing import BinaryIO, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .. import columns as cm
from ..codecs import WriteOptions
from ..codecs.binary import BinaryColumn, compress_binary, slice_keys
from ..codecs.boolean import compress_boolean
from ..codecs.decimal import compress_decimal, from_int64
from ..codecs.double import compress_double
from ..codecs.integer import compress_integer
from ..constants import ARROW_MAGIC, CONTINUATION_MARKER
from ..errors import NotYetImplementedError, OutOfSpecError
from ..exec.pruning import ColumnZones, PageZone, compute_zones, zone_trailer
from ..meta import ColumnMeta, PageMeta, serialize_metas
from ..schema import (
    FLAT_FLOAT_TYPES, NULL_TYPE, WRITABLE_TYPES, Field, decimal_params, fixed_binary_width,
    int_storage, schema_to_bytes,
)
from ..util import obs
from ..util.hybrid_rle import encode_levels, encode_validity_bitpacked, get_bit_width
from .nested import cum_sums, slice_nested, to_nested, write_levels


def _numpy_alias(arr: np.ndarray) -> str:
    """The arrow type of a numpy column, as a ``pa.array`` of it has:
    unicode → string, bytes → binary, an object array by its values."""
    dtype = arr.dtype
    if dtype.kind in "Mm":
        unit = np.datetime_data(dtype)[0]
        if dtype.kind == "M" and unit == "D":
            return "date32"
        if unit in ("s", "ms", "us", "ns"):
            return f"{'timestamp' if dtype.kind == 'M' else 'duration'}[{unit}]"
    if dtype.kind in "iuf":
        return str(dtype)
    if dtype.kind == "b":
        return "bool"
    if dtype.kind == "U":
        return "string"
    if dtype.kind == "S":
        return "binary"
    if dtype.kind == "O":
        kinds = {type(v) for v in arr if v is not None}
        if kinds <= {str}:
            return "string"
        if kinds <= {bytes}:
            return "binary"
        raise OutOfSpecError(f"an object column of {sorted(k.__name__ for k in kinds)}")
    raise NotYetImplementedError(
        f"writing numpy dtype {dtype}: the port writes {', '.join(WRITABLE_TYPES)} "
        "and decimals (ROADMAP.md 'Modules to port')"
    )


def _fixed_width_column(mat: np.ndarray, null: Optional[np.ndarray]) -> BinaryColumn:
    """The ``(n, width)`` uint8 rows of an ``S`` array (numpy drops
    trailing NUL bytes, so a value's length is that of its bytes before
    the trailing NULs) → byte slices; null rows take empty slices.  At most
    7 bytes wide, the u64 keys come from the padded rows in one copy."""
    n, width = mat.shape
    nz = mat != 0
    lens = np.where(nz.any(axis=1), width - np.argmax(nz[:, ::-1], axis=1), 0).astype(np.int64)
    if null is not None:
        lens[null] = 0
    inside = np.arange(width) < lens[:, None]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    keys = None
    if width <= 7:
        padded = np.zeros((n, 8), dtype=np.uint8)
        padded[:, :width] = np.where(inside, mat, 0)
        padded[:, 7] = lens
        keys = padded.view("<u8").reshape(n)
    return BinaryColumn(offsets, mat[inside], keys)


def _binary_column(arr: np.ndarray, null: Optional[np.ndarray]) -> BinaryColumn:
    """A unicode, bytes or object column → UTF-8 / raw byte slices."""
    if arr.dtype.kind == "U":
        points = arr.view(np.uint32).reshape(len(arr), -1)
        if not points.size or int(points.max()) < 128:
            # ASCII: each code point is its UTF-8 byte
            return _fixed_width_column(points.astype(np.uint8), null)
        arr = np.char.encode(arr, "utf-8")
    if arr.dtype.kind == "S":
        return _fixed_width_column(arr.view(np.uint8).reshape(len(arr), arr.dtype.itemsize), null)
    items = [b"" if (v is None or (null is not None and null[i])) else
             (v.encode("utf-8") if isinstance(v, str) else bytes(v)) for i, v in enumerate(arr)]
    lens = np.array([len(v) for v in items], dtype=np.int64)
    offsets = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    values = np.frombuffer(b"".join(items), np.uint8)
    keys = slice_keys(offsets[:-1], lens, values) if len(lens) and lens.max() <= 7 else None
    return BinaryColumn(offsets, values, keys)


def _decimal_matrix(name: str, arr: np.ndarray, width: int) -> np.ndarray:
    """A decimal column's values → its ``(n, width)`` byte matrix: unscaled
    integers (int64 at most) sign-extend, a uint8 matrix of that width is
    taken as it is."""
    if arr.ndim == 2 and arr.dtype == np.uint8 and arr.shape[1] == width:
        return np.ascontiguousarray(arr)
    if arr.ndim == 1 and arr.dtype.kind in "iu" and np.can_cast(arr.dtype, np.int64):
        return from_int64(arr.astype(np.int64), width)
    raise OutOfSpecError(
        f"column {name!r}: a decimal takes unscaled integers or an (n, {width}) uint8 "
        f"matrix, not {arr.dtype} of shape {arr.shape}")


def _prepare(columns: Mapping[str, np.ndarray], schema: Optional[Sequence[Field]]):
    """→ (fields, [(storage values, validity or None)], rows).  A
    ``np.ma.MaskedArray`` carries nulls (mask True = null; a decimal
    matrix's row is null where any of its mask is set); without a schema
    every field is nullable, as in a ``pa.table`` of the columns, and a
    decimal needs one."""
    names = list(columns)
    if schema is None:
        schema = [Field(n, _numpy_alias(np.ma.getdata(columns[n]))) for n in names]
    schema = list(schema)
    if [f.name for f in schema] != names:
        raise OutOfSpecError(f"schema names {[f.name for f in schema]} != columns {names}")
    out = []
    rows = None
    for f in schema:
        arr = columns[f.name]
        validity = None
        if f.dtype == NULL_TYPE:  # no values: any column gives its length
            if rows is not None and len(arr) != rows:
                raise OutOfSpecError(f"column {f.name!r} has {len(arr)} rows, not {rows}")
            rows = len(arr)
            out.append((cm.NullColumn(NULL_TYPE, None, rows), None))
            continue
        if f.is_nested or isinstance(arr, cm.Column):
            if not isinstance(arr, cm.Column):
                raise OutOfSpecError(f"column {f.name!r} of type {f.dtype} takes a columns.Column")
            if rows is not None and len(arr) != rows:
                raise OutOfSpecError(f"column {f.name!r} has {len(arr)} rows, not {rows}")
            rows = len(arr)
            if f.is_nested:
                out.append((arr, None))
                continue
            # a model's validity stays as it is, all valid too (an arrow
            # bitmap without nulls): the reference writes what it holds
            validity = arr.validity
            if validity is not None and not f.nullable:
                if not validity.all():
                    raise OutOfSpecError(f"column {f.name!r} has nulls but is not nullable")
                validity = None
            if isinstance(arr, cm.BinaryColumn):
                out.append((_codec_binary(arr), validity))
                continue
            if not isinstance(arr, (cm.PrimitiveColumn, cm.BooleanColumn)):
                raise NotYetImplementedError(f"writing a {type(arr).__name__}")
            arr = arr.values
        if isinstance(arr, np.ma.MaskedArray):
            null = np.ma.getmaskarray(arr)
            if null.ndim == 2:
                null = null.any(axis=1)
            if null.any():
                validity = ~null
            arr = np.ma.getdata(arr)
        arr = np.asarray(arr)
        dec = decimal_params(f.dtype) if f.is_flat_decimal else None
        if arr.ndim != 1 and dec is None:
            raise OutOfSpecError(f"column {f.name!r} must be 1-D, got shape {arr.shape}")
        if arr.dtype.kind == "O":
            none = np.array([v is None for v in arr], dtype=bool)
            if none.any():
                validity = ~none if validity is None else (validity & ~none)
        if validity is not None and not f.nullable:
            raise OutOfSpecError(f"column {f.name!r} has nulls but is not nullable")
        if rows is not None and len(arr) != rows:
            raise OutOfSpecError(f"column {f.name!r} has {len(arr)} rows, not {rows}")
        rows = len(arr)
        if f.is_flat_string and arr.dtype.kind in "USO":
            out.append((_binary_column(arr, None if validity is None else ~validity), validity))
            continue
        if dec is not None:
            out.append((_decimal_matrix(f.name, arr, dec[0] // 8), validity))
            continue
        if f.is_flat_bool and arr.dtype.kind == "b":
            out.append((np.ascontiguousarray(arr), validity))
            continue
        if f.is_flat_float and arr.dtype.kind in "iuf":
            out.append((np.ascontiguousarray(arr.astype(FLAT_FLOAT_TYPES[f.dtype])), validity))
            continue
        if not f.is_flat_int:
            raise NotYetImplementedError(
                f"writing column {f.name!r} of type {f.dtype} from numpy {arr.dtype} "
                "(ROADMAP.md 'Modules to port')"
            )
        if arr.dtype.kind == "M" and f.dtype == "date32":  # days since the epoch
            days = arr.astype("datetime64[D]").view(np.int64)
            if len(days) and (days.min() < -(2**31) or days.max() >= 2**31):
                raise OutOfSpecError(f"column {f.name!r}: a date outside date32")
            arr = days.astype(np.int32)
        elif arr.dtype.kind in "Mm":  # counts of the field's unit
            kind = ("M" if f.dtype.startswith(("timestamp", "date64"))
                    else "m" if f.dtype.startswith("duration") else None)
            if arr.dtype.kind != kind:
                raise OutOfSpecError(f"column {f.name!r}: numpy {arr.dtype} for {f.dtype}")
            unit = "ms" if f.dtype == "date64" else re.match(r"\w+\[(\w+)", f.dtype).group(1)
            arr = arr.astype(f"<{kind}8[{unit}]").view(np.int64)
        storage = np.dtype(int_storage(f.dtype))
        if arr.dtype.kind == "S" and fixed_binary_width(f.dtype) == arr.dtype.itemsize:
            arr = arr.view(storage)  # fixed-size binaries as their little-endian integers
        if arr.dtype != storage:
            if not np.can_cast(arr.dtype, storage):
                raise OutOfSpecError(f"column {f.name!r}: {arr.dtype} does not fit {f.dtype}")
            arr = arr.astype(storage)
        out.append((np.ascontiguousarray(arr), validity))
    return schema, out, rows or 0


def _codec_binary(col: "cm.BinaryColumn") -> BinaryColumn:
    offsets = col.offsets.astype(np.int64)
    lens = np.diff(offsets)
    keys = slice_keys(offsets[:-1], lens, col.values) if len(lens) and lens.max() <= 7 else None
    return BinaryColumn(offsets, col.values, keys)


def write_page(values, validity: Optional[np.ndarray], field: Field,
               options: WriteOptions) -> bytes:
    """One simple page: the validity prelude of a nullable field, then the
    page of the field's codec family (``write_simple``); a null column's
    page is empty."""
    if field.dtype == NULL_TYPE:
        return b""
    out = b""
    if field.nullable:
        if validity is None:
            out = np.uint32(0).tobytes()
        else:
            body = encode_validity_bitpacked(validity)
            out = np.uint32(len(body)).tobytes() + body
    return out + _leaf_body(values, validity, field, options)


def _leaf_body(values, validity: Optional[np.ndarray], field: Field, options: WriteOptions) -> bytes:
    """The codec page (header and body) of a leaf's values."""
    out = b""
    if isinstance(values, BinaryColumn):
        return out + compress_binary(values, validity, options, field.dtype.startswith("large_"))
    if field.is_flat_decimal:
        return out + compress_decimal(values, validity, options)
    if field.is_flat_bool:
        return out + compress_boolean(values, validity, options)
    if field.is_flat_float:
        return out + compress_double(values, validity, options)
    return out + compress_integer(values, validity, options)


def write_nested_page(nests, leaf: "cm.Column", field: Field, options: WriteOptions):
    """One page of a nested leaf → (bytes, level count): the levels of the
    page's rows, then the leaf values the levels reach (slots under null
    ancestors dropped) through the leaf's codec."""
    rep, deff, leaf_elems = write_levels(nests)
    if len(leaf_elems) != len(leaf) or (len(leaf_elems) and (np.diff(leaf_elems) != 1).any()):
        leaf = _take_leaf(leaf, leaf_elems)
    cum_sum, cum_rep = cum_sums(nests)
    rep_bytes = encode_levels(rep, get_bit_width(int(cum_rep[-1])))
    def_bytes = encode_levels(deff, get_bit_width(int(cum_sum[-1])))
    head = np.array([nests[0].length, len(rep_bytes), len(def_bytes)], dtype="<u4").tobytes()
    body = b""
    if not isinstance(leaf, cm.NullColumn):
        if isinstance(leaf, cm.BinaryColumn):
            values = _codec_binary(leaf)
        elif field.is_flat_decimal:
            values = _decimal_matrix(field.name, leaf.values, decimal_params(field.dtype)[0] // 8)
        elif field.is_flat_int:
            values = leaf.values.view(int_storage(field.dtype)) if leaf.values.dtype.kind in "Mm" \
                else leaf.values.astype(int_storage(field.dtype), copy=False)
        else:
            values = leaf.values
        body = _leaf_body(values, leaf.validity, field, options)
    return head + rep_bytes + def_bytes + body, len(rep)


def _take_leaf(leaf: "cm.Column", elems: np.ndarray) -> "cm.Column":
    """Leaf slots by index (the null-ancestor compaction)."""
    if len(elems) == 0:
        return leaf.slice(0, 0)
    if elems[0] >= 0 and (np.diff(elems) == 1).all():
        return leaf.slice(int(elems[0]), len(elems))
    return leaf.take(elems)


def _page_slice(values, off: int, ln: int):
    if isinstance(values, cm.NullColumn):
        return values.slice(off, ln)
    if isinstance(values, BinaryColumn):
        keys = None if values.keys is None else values.keys[off : off + ln]
        return BinaryColumn(values.offsets[off : off + ln + 1], values.values, keys)
    return values[off : off + ln]


def _encode_pages(fields, data, spans, options):
    """Every page of every leaf column, encoded in threads (the codecs'
    numpy and native loops release the GIL) → (pages per leaf column as
    (bytes, num_values), the zone of each page of each flat integer,
    temporal and float column when ``options.zone_maps``: string, bool,
    decimal and nested pages get none, as in the JAX writer).  Every leaf
    of a nested field takes the same top-level row spans."""
    leaves = []  # (field index, leaf field or None, nests, leaf column)
    for ci, f in enumerate(fields):
        if f.is_nested:
            from ..read.levels import leaf_fields

            for lf, (nests, leaf) in zip(leaf_fields(f), to_nested(data[ci][0], f)):
                leaves.append((ci, lf, nests, leaf))
        else:
            leaves.append((ci, None, None, None))
    jobs: List[Tuple[int, int, int]] = [
        (li, off, ln) for li in range(len(leaves)) for off, ln in spans
    ]
    parent = obs.current()  # the write's span, handed to the pool's threads

    def encode(job):
        with obs.span("strawboat.write.page", parent=parent):
            obs.count("write.pages")
            li, off, ln = job
            ci, lf, nests, leaf = leaves[li]
            if lf is not None:
                s_nests, s_leaf = slice_nested(nests, leaf, off, ln)
                return write_nested_page(s_nests, s_leaf, lf, options), None
            values, validity = data[ci]
            page_values = _page_slice(values, off, ln)
            page_validity = None if validity is None else validity[off : off + ln]
            zone = None
            if options.zone_maps and (fields[ci].is_flat_int or fields[ci].is_flat_float):
                zone = PageZone(*compute_zones(page_values, page_validity), ln)
            return (write_page(page_values, page_validity, fields[ci], options), ln), zone

    workers = min(len(jobs), os.cpu_count() or 1)
    if workers <= 1:
        results = [encode(j) for j in jobs]
    else:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(encode, jobs))
    per_col = len(spans)
    pages, zones = [], {}
    for li, (ci, _lf, _n, _l) in enumerate(leaves):
        col = results[li * per_col : (li + 1) * per_col]
        pages.append([p for p, _z in col])
        if col and col[0][1] is not None:
            zones[fields[ci].name] = ColumnZones(fields[ci].name, [z for _p, z in col])
    return pages, zones


def _write_pages(write, offset: int, pages) -> List[ColumnMeta]:
    """Every leaf column's pages through ``write``, from file offset
    ``offset``; returns the column metas."""
    metas = []
    for col_pages in pages:
        metas.append(ColumnMeta(offset, [PageMeta(len(p), n) for p, n in col_pages]))
        for p, _n in col_pages:
            write(p)
            offset += len(p)
    return metas


def _footer(fields, metas, zones) -> bytes:
    """The zone block (when there are zones), the schema, the metas, their
    sizes and the EOS marker."""
    schema_bytes = schema_to_bytes(fields)
    meta_bytes = serialize_metas(metas)
    return b"".join([zone_trailer(zones) if zones else b"", schema_bytes, meta_bytes,
                     np.uint32(len(schema_bytes)).tobytes(),
                     np.uint32(len(meta_bytes)).tobytes(),
                     CONTINUATION_MARKER, (0).to_bytes(4, "little")])


def _write_all(f: BinaryIO, fields, pages, zones) -> List[ColumnMeta]:
    """Magic, pages, then the footer; returns the column metas."""
    f.write(ARROW_MAGIC + b"\x00\x00")
    metas = _write_pages(f.write, len(ARROW_MAGIC) + 2, pages)
    f.write(_footer(fields, metas, zones))
    f.flush()
    return metas


def _as_columns(data, fields: Optional[List[Field]]):
    """What ``write`` takes → ({name: column}, fields or None): a
    ``pa.Table`` or ``pa.RecordBatch`` (each column the one chunk of
    ``combine_chunks()``, a bitmap without nulls kept, its schema's fields
    unless ``fields`` are given), a mapping of numpy columns or column
    models, or a sequence of column models in ``fields``' order."""
    if isinstance(data, Mapping):
        return data, fields
    if isinstance(data, (list, tuple)):
        if fields is None or len(data) != len(fields):
            raise OutOfSpecError("a sequence of columns needs a schema of as many fields")
        return {f.name: c for f, c in zip(fields, data)}, fields
    import pyarrow as pa

    if isinstance(data, pa.RecordBatch):
        data = pa.Table.from_batches([data])
    if not isinstance(data, pa.Table):
        raise OutOfSpecError(f"unsupported chunk type {type(data).__name__}")
    data = data.combine_chunks()
    cols = [cm.from_arrow(c.chunk(0) if c.num_chunks else c.combine_chunks()) for c in data.columns]
    if fields is None:
        fields = [cm.field_from_arrow(f) for f in data.schema]
    if len(cols) != len(fields):
        raise OutOfSpecError("chunk arity does not match schema")
    return {f.name: c for f, c in zip(fields, cols)}, fields


def _as_fields(schema) -> Optional[List[Field]]:
    """A list of ``Field``, a ``pa.Schema`` (converted), or None."""
    if schema is None or isinstance(schema, (list, tuple)):
        return None if schema is None else list(schema)
    return [cm.field_from_arrow(f) for f in schema]


_NONE, _STARTED, _WRITTEN, _FINISHED = range(4)


class NativeWriter:
    """The file writer's state machine (reference src/write/writer.rs:33-200
    and common.rs:49-117): ``start`` writes the magic, ``write`` one chunk
    (the file's one row group) as pages of ``options.max_page_size`` rows,
    ``finish`` the zone block and the footer.  A step out of that order
    raises ``OutOfSpecError``.

    ``schema``: a ``pa.Schema`` or a list of ``Field``; ``write`` takes
    what :func:`write_file` takes."""

    def __init__(self, writer: BinaryIO, schema, options: Optional[WriteOptions] = None):
        self.writer = writer
        self.fields = _as_fields(schema)
        self.options = options or WriteOptions()
        self.metas: List[ColumnMeta] = []
        self.zones = {}
        self._offset = 0
        self._state = _NONE

    def _write(self, data: bytes) -> None:
        self.writer.write(data)
        self._offset += len(data)

    def total_size(self) -> int:
        return self._offset

    def start(self) -> None:
        if self._state != _NONE:
            raise OutOfSpecError("The strawboat file can only be started once")
        with obs.span("strawboat.write.io"):
            self._write(ARROW_MAGIC + b"\x00\x00")
        self._state = _STARTED

    def write(self, chunk) -> None:
        if self._state == _WRITTEN:
            raise OutOfSpecError("The strawboat file can only accept one RowGroup in a single file")
        if self._state != _STARTED:
            raise OutOfSpecError("The strawboat file must be started before it can be written to")
        with obs.span("strawboat.write.prepare"):
            columns, fields = _as_columns(chunk, self.fields)
            fields, data, rows = _prepare(columns, fields)
        self.fields = fields
        step = max(min(self.options.max_page_size or rows, rows), 1)
        spans = [(off, min(step, rows - off)) for off in range(0, rows, step)]
        pages, self.zones = _encode_pages(fields, data, spans, self.options)
        with obs.span("strawboat.write.io"):
            self.metas = _write_pages(self._write, self._offset, pages)
        self._state = _WRITTEN

    def finish(self) -> None:
        if self._state != _WRITTEN:
            raise OutOfSpecError("The strawboat file must be written before it can be finished")
        with obs.span("strawboat.write.io"):
            self._write(_footer(self.fields, self.metas, self.zones))
            self.writer.flush()
        self._state = _FINISHED


def write_file(path_or_file, columns, schema=None,
               options: Optional[WriteOptions] = None) -> List[ColumnMeta]:
    """Write ``columns`` as one strawboat file (one row group, pages of
    ``options.max_page_size`` rows) through :class:`NativeWriter` and
    return the column metas.

    ``columns`` is a ``pa.Table`` or ``pa.RecordBatch`` (written as the
    JAX writer writes it, byte for byte), or ``{name: numpy column}``:
    numpy integer, float and bool columns keep their type,
    ``datetime64[D]`` becomes date32, ``datetime64[unit]`` a timestamp and
    ``timedelta64[unit]`` a duration of that unit, unicode arrays utf8
    (``"string"``) and bytes arrays binary; an object array of ``str`` or
    ``bytes`` takes ``None`` for null.  ``schema`` (a list of
    :class:`~strawboat_tpu_torch.schema.Field`, or a ``pa.Schema``)
    overrides the types (``"large_string"``, ``"float32"``,
    ``"timestamp[ms, tz=UTC]"``, ``"time32[ms]"`` from int storage …) and
    the nullability; a decimal column is an int64 array of unscaled values
    (or an ``(n, W)`` uint8 matrix of W-byte values, for values beyond
    int64) under a decimal field, e.g. ``Field("price", "decimal128(15,
    2)")``; a ``"null"`` field takes any column of its length and writes
    empty pages.  A nested column is a ``columns.ListColumn`` /
    ``FixedSizeListColumn`` / ``MapColumn`` / ``StructColumn`` under a
    nested field (``schema.list_of``, ``schema.map_of``, ``Field(name,
    "struct", children=...)``); a flat ``columns.Column`` is taken too.
    ``options.zone_maps`` writes a zone of every page of the flat integer,
    temporal and float columns."""
    with obs.span("strawboat.write"):
        own = isinstance(path_or_file, (str, os.PathLike))
        f = open(path_or_file, "wb") if own else path_or_file
        try:
            w = NativeWriter(f, schema, options)
            w.start()
            w.write(columns)
            w.finish()
            return w.metas
        finally:
            if own:
                f.close()
