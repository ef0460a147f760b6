"""File-format constants and codec identifiers.

Counterpart of ``strawboat_tpu/constants.py``, with what the port uses:
- magic / continuation marker: reference src/lib.rs:34-35
- codec ids:                   reference src/compression/mod.rs:64-82
- sampling constants:          reference src/compression/mod.rs:29-33
"""

from __future__ import annotations

import enum

from .errors import OutOfSpecError

# File magic: 6 bytes "ARROW2" followed by 2 zero pad bytes at file start
# (reference src/write/writer.rs:98-100).
ARROW_MAGIC = b"ARROW2"
# EOS / continuation marker: 4 bytes of 0xFF then i32 length (reference
# src/lib.rs:35, src/write/common.rs:124-128).
CONTINUATION_MARKER = b"\xff\xff\xff\xff"

# A codec's trial ratio is taken over SAMPLE_COUNT runs of SAMPLE_SIZE
# consecutive values of the page.
SAMPLE_COUNT = 10
SAMPLE_SIZE = 64


def get_bits_needed(value: int) -> int:
    """Bits needed to hold ``value`` (reference mod.rs:115-118)."""
    return max(int(value).bit_length(), 0)


class Compression(enum.IntEnum):
    """Page codec ids (reference src/compression/mod.rs:64-82).

    0-3 are "common" byte-stream codecs (raw mode); ids from 10 are the
    structured encodings.
    """

    NONE = 0
    LZ4 = 1
    ZSTD = 2
    SNAPPY = 3

    RLE = 10
    DICT = 11
    ONE_VALUE = 12
    FREQ = 13
    BITPACKING = 14
    DELTA_BITPACKING = 15
    PATAS = 16

    @property
    def raw_mode(self) -> bool:
        """True for general-purpose byte codecs (reference mod.rs:84-89)."""
        return self in (
            Compression.NONE,
            Compression.LZ4,
            Compression.ZSTD,
            Compression.SNAPPY,
        )

    @classmethod
    def from_codec(cls, t: int) -> "Compression":
        try:
            return cls(t)
        except ValueError:
            raise OutOfSpecError(f"Unknown compression codec {t}") from None
