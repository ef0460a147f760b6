"""Footer parsing and the page iterator.

Counterpart of ``strawboat_tpu/read/reader.py`` (the reference's
src/read/reader.rs).  The file ends in ``[schema][metas][u32 schema_size]
[u32 meta_size][EOS: 8 bytes]``; the metas parse with the port's
``meta.py`` and the schema with the port's own flatbuffer reader, as a
list of :class:`~strawboat_tpu_torch.schema.Field` (``columns.pa_field``
gives the pyarrow field at the API's edge).

- ``read_meta`` / ``infer_schema``: seek to the tail, read the blocks;
- ``read_meta_async`` / ``infer_schema_async``: the same from one 64 KiB
  tail read, over any object with ``async read_at(offset, length)`` (and
  ``async size()`` when the length is not given), to save round trips to
  an object store (reader.rs:180-241);
- ``NativeReader``: the raw pages ``(num_values, bytes)`` of one leaf
  column, whose ``nth`` / ``skip_page`` seek past pages unread;
  ``SubsetNativeReader`` reads a pruned subset of them.
"""

from __future__ import annotations

import io
import os
from typing import BinaryIO, List, Optional, Tuple

import numpy as np

from ..errors import OutOfSpecError
from ..meta import ColumnMeta, PageMeta, deserialize_metas
from ..schema import Field, deserialize_schema

DEFAULT_FOOTER_SIZE = 64 * 1024


def read_meta(reader: BinaryIO) -> List[ColumnMeta]:
    reader.seek(-12, os.SEEK_END)
    meta_size = int.from_bytes(reader.read(4), "little")
    reader.seek(-16 - meta_size, os.SEEK_END)
    return deserialize_metas(reader.read(meta_size))


def infer_schema(reader: BinaryIO) -> List[Field]:
    reader.seek(-16, os.SEEK_END)
    schema_size = int.from_bytes(reader.read(4), "little")
    meta_size = int.from_bytes(reader.read(4), "little")
    reader.seek(-meta_size - schema_size - 8, os.SEEK_CUR)
    return deserialize_schema(reader.read(schema_size))


async def read_meta_async(reader, total_len: Optional[int] = None) -> List[ColumnMeta]:
    """The metas from one tail read of at most 64 KiB, and a second read
    only when the footer is longer."""
    if total_len is None:
        total_len = await reader.size()
    pre = min(total_len, DEFAULT_FOOTER_SIZE)
    tail = await reader.read_at(total_len - pre, pre)
    meta_size = int.from_bytes(tail[-12:-8], "little")
    if meta_size + 16 <= pre:
        return deserialize_metas(tail[-16 - meta_size : -16])
    buf = await reader.read_at(total_len - meta_size - 16, meta_size + 16)
    return deserialize_metas(buf[:meta_size])


async def infer_schema_async(reader, total_len: Optional[int] = None) -> List[Field]:
    if total_len is None:
        total_len = await reader.size()
    tail = await reader.read_at(max(total_len - DEFAULT_FOOTER_SIZE, 0),
                                min(total_len, DEFAULT_FOOTER_SIZE))
    schema_size = int.from_bytes(tail[-16:-12], "little")
    meta_size = int.from_bytes(tail[-12:-8], "little")
    need = schema_size + meta_size + 16
    if need > len(tail):
        tail = await reader.read_at(total_len - need, need)
    start = len(tail) - 16 - meta_size - schema_size
    return deserialize_schema(tail[start : start + schema_size])


class NativeReader:
    """Iterator of the raw pages ``(num_values, uint8 bytes)`` of one leaf
    column; ``nth(n)`` and ``skip_page`` seek without reading
    (reader.rs:91-147)."""

    def __init__(self, page_reader: BinaryIO, page_metas: List[PageMeta]):
        self.page_reader = page_reader
        self.page_metas = page_metas
        self.current_page = 0

    def has_next(self) -> bool:
        return self.current_page < len(self.page_metas)

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[int, np.ndarray]:
        if self.current_page == len(self.page_metas):
            raise StopIteration
        meta = self.page_metas[self.current_page]
        buf = self.page_reader.read(meta.length)
        if len(buf) != meta.length:
            raise OutOfSpecError("page truncated on read")
        self.current_page += 1
        return meta.num_values, np.frombuffer(buf, dtype=np.uint8)

    def nth(self, n: int) -> Tuple[int, np.ndarray]:
        """Skip ``n`` pages by seeking, then read the next one."""
        skipped = self.page_metas[self.current_page : self.current_page + n]
        if len(skipped) < n:
            self.current_page = len(self.page_metas)
            raise StopIteration
        self.current_page += n
        length = sum(p.length for p in skipped)
        if length:
            self.page_reader.seek(length, os.SEEK_CUR)
        return next(self)

    def skip_page(self) -> None:
        if self.current_page == len(self.page_metas):
            return
        self.page_reader.seek(self.page_metas[self.current_page].length, os.SEEK_CUR)
        self.current_page += 1


def open_readers(path: str, metas: List[ColumnMeta]) -> List[NativeReader]:
    """One positioned ``NativeReader`` per leaf column, each with its own
    file handle (``reader.page_reader``, closed by the caller)."""
    readers = []
    for meta in metas:
        f = open(path, "rb")
        f.seek(meta.offset)
        readers.append(NativeReader(f, list(meta.pages)))
    return readers


class SubsetNativeReader(NativeReader):
    """A ``NativeReader`` over a subset of a column's pages: it seeks to
    each kept page's file offset before reading it (the page grid's
    counterpart of ``nth`` for pages that are not contiguous)."""

    def __init__(self, page_reader: BinaryIO, page_metas: List[PageMeta],
                 page_offsets: List[int]):
        super().__init__(page_reader, page_metas)
        self.page_offsets = page_offsets

    def __next__(self) -> Tuple[int, np.ndarray]:
        if self.current_page == len(self.page_metas):
            raise StopIteration
        self.page_reader.seek(self.page_offsets[self.current_page])
        return super().__next__()


def open_readers_subset(path: str, metas: List[ColumnMeta], keep) -> List[NativeReader]:
    """Per-leaf readers of the pages ``keep`` keeps: a boolean mask over
    the page grid, which every leaf of a nested column shares (pages past
    its end are kept); the other pages are never read."""
    readers = []
    for meta in metas:
        offsets: List[int] = []
        pages: List[PageMeta] = []
        pos = meta.offset
        for i, pm in enumerate(meta.pages):
            if i >= len(keep) or keep[i]:
                offsets.append(pos)
                pages.append(pm)
            pos += pm.length
        readers.append(SubsetNativeReader(open(path, "rb"), pages, offsets))
    return readers


def reader_from_bytes(data: bytes, meta: ColumnMeta) -> NativeReader:
    f = io.BytesIO(data)
    f.seek(meta.offset)
    return NativeReader(f, list(meta.pages))
