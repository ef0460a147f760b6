"""The file-format API: a whole file or its pages as arrow, and the writer.

Counterpart of ``strawboat_tpu/api.py`` (the reference's examples:
``strawboat_write.rs``, ``strawboat_read.rs``, ``strawboat_batch_read.rs``):

- :func:`read_table`: the file (or some of its columns) as a
  ``pa.Table``; flat columns take the planned fast path of
  ``read/fast.py`` where it applies, the rest the general reader
  (``read/batch_read.py``), columns decoded on a thread pool;
- :func:`iter_batches`: one ``pa.RecordBatch`` a page;
- :func:`write_file` / :class:`NativeWriter`: the writer.

All of it is host work, as in the reference; the device paths read files
through ``exec.scan_file``.  pyarrow is imported inside the functions.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .columns import pa_field, to_arrow
from .meta import ColumnMeta
from .read.batch_read import batch_read_column
from .read.deserialize import column_iter_to_arrays
from .read.fast import ReadArena, read_binary_column_fast, read_column_fast
from .read.reader import infer_schema, open_readers, read_meta
from .schema import Field
from .write.writer import NativeWriter, write_file  # noqa: F401


def split_metas_by_field(schema: Sequence[Field], metas: List[ColumnMeta]) -> List[List[ColumnMeta]]:
    """The leaf metas of each top-level field."""
    out, i = [], 0
    for field in schema:
        out.append(metas[i : i + field.n_leaves])
        i += field.n_leaves
    return out


def _footer(path: str):
    with open(path, "rb") as f:
        return infer_schema(f), read_meta(f)


def _close(readers) -> None:
    for r in readers:
        r.page_reader.close()


def read_table(path: str, columns: Optional[Sequence[str]] = None,
               arena: Optional[ReadArena] = None):
    """The file as a ``pa.Table`` (``strawboat_batch_read.rs``), or the
    top-level ``columns`` named.

    A flat fixed-width or string column whose pages the fast path covers
    decompresses on native threads into its final buffer; every other
    column reads through the general reader.  Columns decode on a thread
    pool (the native calls and numpy loops release the GIL).  ``arena``
    recycles the values buffers of the fast path across calls: arrays of
    the previous read through the same arena are then invalid."""
    import pyarrow as pa

    schema, metas = _footer(path)
    file_bytes = np.memmap(path, dtype=np.uint8, mode="r").view(np.ndarray)
    if arena is not None:
        arena.recycle()
    work = [(f, m) for f, m in zip(schema, split_metas_by_field(schema, metas))
            if columns is None or f.name in columns]

    def one(field: Field, field_metas: List[ColumnMeta]):
        arr = None
        if len(field_metas) == 1 and not field.is_nested:
            arr = read_column_fast(file_bytes, field_metas[0], field, arena=arena)
            if arr is None:
                arr = read_binary_column_fast(file_bytes, field_metas[0], field)
        if arr is None:
            readers = open_readers(path, field_metas)
            try:
                arr = to_arrow(batch_read_column(readers, field), field)
            finally:
                _close(readers)
        return arr

    if len(work) > 1:
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(max_workers=min(len(work), os.cpu_count() or 2)) as pool:
            arrays = list(pool.map(lambda w: one(*w), work))
    else:
        arrays = [one(f, m) for f, m in work]
    return pa.Table.from_arrays(arrays, schema=pa.schema([pa_field(f) for f, _m in work]))


def iter_batches(path: str) -> Iterator:
    """The file page by page, one ``pa.RecordBatch`` a page
    (``strawboat_read.rs``)."""
    import pyarrow as pa

    schema, metas = _footer(path)
    arrow_schema = pa.schema([pa_field(f) for f in schema])
    iters, readers = [], []
    for field, field_metas in zip(schema, split_metas_by_field(schema, metas)):
        rs = open_readers(path, field_metas)
        readers.extend(rs)
        iters.append((field, column_iter_to_arrays(rs, field)))
    try:
        if not iters:
            return
        while True:
            cols = []
            for field, it in iters:
                col = next(it, None)
                if col is None:
                    return
                cols.append(to_arrow(col, field))
            yield pa.RecordBatch.from_arrays(cols, schema=arrow_schema)
    finally:
        _close(readers)
