"""Writing flat integer columns to a strawboat file, without pyarrow.

Counterpart of ``NativeWriter`` / ``write_file`` (``strawboat_tpu/write/
writer.py``) and ``write_simple`` / ``_validity_prelude``
(``strawboat_tpu/write/serialize.py``) for flat integer and date32
columns.  The layout is the reference's:

    "ARROW2" + 2 zero bytes
    per column, per page of ``max_page_size`` rows:
        [u32 def_len][bit-packed validity]   (nullable fields only)
        [9-byte header][body]                (``codecs/integer.py``)
    schema (bare flatbuffer), metas, [u32 schema_size][u32 meta_size],
    EOS marker (0xFFFFFFFF, then 0 as u32)

Under the same forcing flags the page bytes and the metas equal the JAX
writer's.  No zone maps.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import BinaryIO, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..codecs import WriteOptions
from ..codecs.integer import compress_integer
from ..constants import ARROW_MAGIC, CONTINUATION_MARKER
from ..errors import NotYetImplementedError, OutOfSpecError
from ..meta import ColumnMeta, PageMeta, serialize_metas
from ..schema import FLAT_INT_TYPES, Field, schema_to_bytes
from ..util.hybrid_rle import encode_validity_bitpacked


def _numpy_alias(dtype: np.dtype) -> str:
    if dtype.kind == "M" and np.datetime_data(dtype)[0] == "D":
        return "date32"
    if dtype.kind in "iu":
        return str(dtype)
    raise NotYetImplementedError(
        f"writing numpy dtype {dtype}: the port writes {', '.join(FLAT_INT_TYPES)} "
        "(ROADMAP.md 'Modules to port': scan_file, further types)"
    )


def _prepare(columns: Mapping[str, np.ndarray], schema: Optional[Sequence[Field]]):
    """→ (fields, [(storage values, validity or None)], rows).  A
    ``np.ma.MaskedArray`` carries nulls (mask True = null); without a
    schema every field is nullable, as in a ``pa.table`` of the columns."""
    names = list(columns)
    if schema is None:
        schema = [
            Field(n, _numpy_alias(np.ma.getdata(columns[n]).dtype)) for n in names
        ]
    schema = list(schema)
    if [f.name for f in schema] != names:
        raise OutOfSpecError(f"schema names {[f.name for f in schema]} != columns {names}")
    out = []
    rows = None
    for f in schema:
        arr = columns[f.name]
        validity = None
        if isinstance(arr, np.ma.MaskedArray):
            null = np.ma.getmaskarray(arr)
            if null.any():
                validity = ~null
            arr = np.ma.getdata(arr)
        arr = np.asarray(arr)
        if arr.ndim != 1:
            raise OutOfSpecError(f"column {f.name!r} must be 1-D, got shape {arr.shape}")
        if not f.is_flat_int:
            raise NotYetImplementedError(
                f"writing column {f.name!r} of type {f.dtype} "
                "(ROADMAP.md 'Modules to port': scan_file, further types)"
            )
        if arr.dtype.kind == "M":  # days since the epoch
            days = arr.astype("datetime64[D]").view(np.int64)
            if len(days) and (days.min() < -(2**31) or days.max() >= 2**31):
                raise OutOfSpecError(f"column {f.name!r}: a date outside date32")
            arr = days.astype(np.int32)
        storage = np.dtype(FLAT_INT_TYPES[f.dtype])
        if arr.dtype != storage:
            if not np.can_cast(arr.dtype, storage):
                raise OutOfSpecError(f"column {f.name!r}: {arr.dtype} does not fit {f.dtype}")
            arr = arr.astype(storage)
        if validity is not None and not f.nullable:
            raise OutOfSpecError(f"column {f.name!r} has nulls but is not nullable")
        if rows is not None and len(arr) != rows:
            raise OutOfSpecError(f"column {f.name!r} has {len(arr)} rows, not {rows}")
        rows = len(arr)
        out.append((np.ascontiguousarray(arr), validity))
    return schema, out, rows or 0


def write_page(values: np.ndarray, validity: Optional[np.ndarray], nullable: bool,
               options: WriteOptions) -> bytes:
    """One simple page: the validity prelude of a nullable field, then the
    integer page (``write_simple``)."""
    out = b""
    if nullable:
        if validity is None:
            out = np.uint32(0).tobytes()
        else:
            body = encode_validity_bitpacked(validity)
            out = np.uint32(len(body)).tobytes() + body
    return out + compress_integer(values, validity, options)


def _encode_pages(fields, data, spans, options) -> List[List[bytes]]:
    """Every page of every column, encoded in threads (the codecs' numpy
    and native loops release the GIL)."""
    jobs: List[Tuple[int, int, int]] = [
        (ci, off, ln) for ci in range(len(fields)) for off, ln in spans
    ]

    def encode(job):
        ci, off, ln = job
        values, validity = data[ci]
        page_validity = None if validity is None else validity[off : off + ln]
        return write_page(values[off : off + ln], page_validity, fields[ci].nullable, options)

    workers = min(len(jobs), os.cpu_count() or 1)
    if workers <= 1:
        pages = [encode(j) for j in jobs]
    else:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            pages = list(pool.map(encode, jobs))
    per_col = len(spans)
    return [pages[ci * per_col : (ci + 1) * per_col] for ci in range(len(fields))]


def _write_all(f: BinaryIO, fields, pages, spans) -> List[ColumnMeta]:
    """Magic, pages, then the footer; returns the column metas."""
    f.write(ARROW_MAGIC + b"\x00\x00")
    offset = len(ARROW_MAGIC) + 2
    metas = []
    for col_pages in pages:
        metas.append(
            ColumnMeta(offset, [PageMeta(len(p), ln) for p, (_o, ln) in zip(col_pages, spans)])
        )
        for p in col_pages:
            f.write(p)
            offset += len(p)
    schema_bytes = schema_to_bytes(fields)
    meta_bytes = serialize_metas(metas)
    f.write(schema_bytes)
    f.write(meta_bytes)
    f.write(np.uint32(len(schema_bytes)).tobytes())
    f.write(np.uint32(len(meta_bytes)).tobytes())
    f.write(CONTINUATION_MARKER + (0).to_bytes(4, "little"))
    f.flush()
    return metas


def write_file(
    path_or_file,
    columns: Mapping[str, np.ndarray],
    schema: Optional[Sequence[Field]] = None,
    options: Optional[WriteOptions] = None,
) -> List[ColumnMeta]:
    """Write ``{name: numpy column}`` as one strawboat file (one row group,
    pages of ``options.max_page_size`` rows) and return the column metas.

    numpy integer columns keep their type and ``datetime64[D]`` becomes
    date32; ``schema`` (a list of :class:`~strawboat_tpu_torch.schema.Field`)
    overrides the types and the nullability."""
    options = options or WriteOptions()
    fields, data, rows = _prepare(columns, schema)
    step = max(min(options.max_page_size or rows, rows), 1)
    spans = [(off, min(step, rows - off)) for off in range(0, rows, step)]
    pages = _encode_pages(fields, data, spans, options)
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "wb") if own else path_or_file
    try:
        return _write_all(f, fields, pages, spans)
    finally:
        if own:
            f.close()
