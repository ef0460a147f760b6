"""Page framing and write options.

Counterpart of ``strawboat_tpu/codecs/__init__.py``.  Every compressed
page body starts with the 9-byte header ``[codec u8][compressed_size u32
LE][uncompressed_size u32 LE]`` (the reference's
src/compression/integer/mod.rs:49-63).  The general-purpose byte codecs
(LZ4, Zstd, Snappy) compress and decompress through the port's ``native``
library; without it such a page raises, and so does a Snappy page where
the library was built without ``libsnappy.so.1``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .. import native
from ..constants import Compression
from ..errors import OutOfSpecError, StrawboatError

HEADER_SIZE = 9
_HDR = struct.Struct("<BII")


@dataclass
class WriteOptions:
    """The reference's ``WriteOptions`` (src/write/common.rs:37-45).

    ``default_compression`` is the byte codec of a page no structured codec
    beats; ``default_compress_ratio`` (None: no competition) is the ratio
    a codec must beat in the chooser (``choose_compressor`` of each codec
    family); ``sample_seed`` seeds the trial samples, so that the codec
    choices, and the file's bytes, are the same from run to run (the
    reference samples with ``thread_rng``).  ``zone_maps`` writes the
    in-band zone block (``exec/pruning.py``)."""

    default_compression: Compression = Compression.NONE
    default_compress_ratio: Optional[float] = None
    max_page_size: Optional[int] = None
    forbidden_compressions: List[Compression] = field(default_factory=list)
    sample_seed: Optional[int] = None
    zone_maps: bool = False

    def forbid(self, codec: Compression) -> "WriteOptions":
        return WriteOptions(
            self.default_compression,
            self.default_compress_ratio,
            self.max_page_size,
            list(self.forbidden_compressions) + [codec],
            self.sample_seed,
            self.zone_maps,
        )


def native_available() -> bool:
    """Whether the port's ``native`` library built and loaded: LZ4 / Zstd /
    Snappy pages need it, and without it the block-header walk and the
    dictionary factorize run their Python loops."""
    return native.available()


def write_header(codec: Compression, compressed_size: int, uncompressed_size: int) -> bytes:
    return _HDR.pack(int(codec), compressed_size, uncompressed_size)


def read_header(buf, pos: int) -> Tuple[Compression, int, int, int]:
    """(codec, compressed_size, uncompressed_size, body position)."""
    if pos + HEADER_SIZE > len(buf):
        raise OutOfSpecError("page truncated before compress header")
    codec, csize, usize = _HDR.unpack_from(buf, pos)
    return Compression.from_codec(codec), csize, usize, pos + HEADER_SIZE


def _require_native(codec: Compression) -> None:
    if not native.available():
        raise StrawboatError(
            f"{codec.name} pages need the native library (g++, liblz4 and "
            f"libzstd), which did not build or load: {native.load_error()}"
        )


def compress(codec: Compression, data) -> bytes:
    """A raw-mode page body: ``data`` as it is (NONE), or compressed with
    LZ4 (block format), Zstd (a frame at level 0) or raw Snappy through
    the ``native`` library (reference basic.rs:74-86)."""
    if codec == Compression.NONE:
        return bytes(data)
    if not codec.raw_mode:
        raise OutOfSpecError(f"codec {codec} is not a common compression")
    _require_native(codec)
    return native.compress_batch(int(codec), [data])[0]


def decompress_raw(codec: Compression, bodies, nbytes) -> List[np.ndarray]:
    """Raw-mode page bodies of one codec → their uint8 contents.

    ``bodies``: uint8 arrays; ``nbytes``: the decompressed size of each.
    NONE pages are checked and passed through; LZ4 / Zstd / Snappy pages
    decompress in one threaded native call."""
    if codec == Compression.NONE:
        for body, n in zip(bodies, nbytes):
            if len(body) != n:
                raise OutOfSpecError("size mismatch for uncompressed page")
        return list(bodies)
    _require_native(codec)
    return native.decompress_batch(int(codec), list(bodies), list(nbytes))
