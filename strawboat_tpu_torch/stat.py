"""Page introspection: page headers parsed without decoding values.

Counterpart of ``strawboat_tpu/stat.py`` (the reference's src/stat.rs:26-172,
``stat_simple`` / ``stat_body``): per page, the validity block's size and
the codec tree (a DICT page's index subpage and dictionary size, a FREQ
page's bitmap and exceptions subpage), for storage statistics, debugging
and pruning decisions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .constants import Compression
from .read.reader import NativeReader
from .schema import FLAT_FLOAT_TYPES, Field, decimal_params, int_storage


@dataclass
class FreqPageBody:
    exceptions: Optional["PageInfo"]  # None for strings: plain exceptions
    exceptions_bitmap_size: int


@dataclass
class DictPageBody:
    indices: "PageInfo"
    unique_num: int


@dataclass
class PageBody:
    kind: str  # dict | freq | one_value | rle | patas | bitpack | delta_bitpack | common
    common: Optional[Compression] = None
    dict: Optional[DictPageBody] = None
    freq: Optional[FreqPageBody] = None


@dataclass
class PageInfo:
    validity_size: Optional[int]
    compressed_size: int
    uncompressed_size: int
    body: PageBody


@dataclass
class ColumnInfo:
    field: Field
    pages: List[PageInfo]


_KINDS = {Compression.RLE: "rle", Compression.ONE_VALUE: "one_value",
          Compression.BITPACKING: "bitpack", Compression.DELTA_BITPACKING: "delta_bitpack",
          Compression.PATAS: "patas"}
_INDICES = Field("indices", "uint32", False)  # a DICT page's codes are a u32 page


def _u32(buf, pos: int) -> int:
    return int.from_bytes(bytes(buf[pos : pos + 4]), "little")


def _u64(buf, pos: int) -> int:
    return int.from_bytes(bytes(buf[pos : pos + 8]), "little")


def stat_simple(reader: NativeReader, field: Field) -> ColumnInfo:
    """Every page of a flat column (stat.rs:63-84).  The reference reads
    the u32 after the validity block as its size (stat.rs:72-77); this
    reports the block's own size."""
    pages = []
    for _num_values, buf in reader:
        pos, validity_size = 0, None
        if field.nullable:
            validity_size = _u32(buf, pos)
            pos += 4 + validity_size
        pages.append(stat_body(buf, pos, validity_size, field)[0])
    return ColumnInfo(field, pages)


def stat_body(buf, pos: int, validity_size: Optional[int], field: Field):
    """The page whose header is at ``pos`` → (its ``PageInfo``, the
    position past it)."""
    codec = Compression.from_codec(int(buf[pos]))
    compressed_size, uncompressed_size = _u32(buf, pos + 1), _u32(buf, pos + 5)
    pos += 9
    if codec == Compression.DICT:
        indices, end = stat_body(buf, pos, None, _INDICES)
        body = PageBody("dict", dict=DictPageBody(indices, _u32(buf, end)))
    elif codec == Compression.FREQ:
        body = _stat_freq_body(buf, pos, field)
    elif codec in _KINDS:
        body = PageBody(_KINDS[codec])
    else:
        body = PageBody("common", common=codec)
    info = PageInfo(validity_size, compressed_size, uncompressed_size, body)
    return info, pos + compressed_size


def _value_width(field: Field) -> int:
    dec = decimal_params(field.dtype)
    if dec is not None:
        return dec[0] // 8
    return np.dtype(int_storage(field.dtype) or FLAT_FLOAT_TYPES[field.dtype]).itemsize


def _stat_freq_body(buf, pos: int, field: Field) -> PageBody:
    if field.is_flat_string:  # [u64 len][top][u32 bitmap size]...
        bitmap_size = _u32(buf, pos + 8 + _u64(buf, pos))
        return PageBody("freq", freq=FreqPageBody(None, bitmap_size))
    pos += _value_width(field)
    bitmap_size = _u32(buf, pos)
    exceptions, _ = stat_body(buf, pos + 4 + bitmap_size, None, field)
    return PageBody("freq", freq=FreqPageBody(exceptions, bitmap_size))
