"""Column/page metadata and the footer's meta block.

Counterpart of ``strawboat_tpu/meta.py``, with what the port uses.  Byte
layout of the reference:
- ``PageMeta { length: u64, num_values: u64 }`` and
  ``ColumnMeta { offset: u64, pages: Vec<PageMeta> }``  (src/lib.rs:37-80)
- meta block: u64 meta_count, then per column u64 offset, u64 page_count,
  then per page u64 length + u64 num_values (src/write/writer.rs:143-152,
  src/read/reader.rs:135-166)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Sequence

from .errors import OutOfSpecError

_U64 = struct.Struct("<Q")


@dataclass(frozen=True)
class PageMeta:
    """Per-page directory entry (reference src/lib.rs:72-80)."""

    # on-disk size of the page in bytes, validity prelude and the 9-byte
    # compress headers included
    length: int
    num_values: int


@dataclass(frozen=True)
class ColumnMeta:
    """Per-leaf-column directory (reference src/lib.rs:37-70)."""

    offset: int
    pages: List[PageMeta] = field(default_factory=list)

    def slice(self, start_page_index: int, end_page_index: int) -> "ColumnMeta":
        """Pages [start, end), the offset moved to the first (reference
        src/lib.rs:46-61)."""
        if not 0 <= start_page_index < len(self.pages):
            raise IndexError("start_page_index out of range")
        if not start_page_index <= end_page_index <= len(self.pages):
            raise IndexError("end_page_index out of range")
        offset = self.offset + sum(p.length for p in self.pages[:start_page_index])
        return ColumnMeta(offset, list(self.pages[start_page_index:end_page_index]))

    def skip_one_page(self) -> "ColumnMeta":
        return self.slice(1, len(self.pages))

    def total_len(self) -> int:
        return sum(p.length for p in self.pages)

    def num_values(self) -> int:
        return sum(p.num_values for p in self.pages)


def serialize_metas(metas: Sequence[ColumnMeta]) -> bytes:
    """The footer meta block (reference src/write/writer.rs:143-152)."""
    out = bytearray(_U64.pack(len(metas)))
    for meta in metas:
        out += _U64.pack(meta.offset)
        out += _U64.pack(len(meta.pages))
        for page in meta.pages:
            out += _U64.pack(page.length)
            out += _U64.pack(page.num_values)
    return bytes(out)


def deserialize_metas(buf: bytes) -> List[ColumnMeta]:
    """Parse the footer meta block (reference src/read/reader.rs:135-166)."""
    pos = 0

    def u64() -> int:
        nonlocal pos
        if pos + 8 > len(buf):
            raise OutOfSpecError("meta block truncated")
        (v,) = _U64.unpack_from(buf, pos)
        pos += 8
        return v

    metas: List[ColumnMeta] = []
    for _ in range(u64()):
        offset = u64()
        pages = [PageMeta(u64(), u64()) for _ in range(u64())]
        metas.append(ColumnMeta(offset, pages))
    return metas
