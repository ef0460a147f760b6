"""Validity levels of a simple page: parquet's hybrid RLE / bit-packed runs.

Counterpart of ``encode_validity_bitpacked`` and ``decode_validity`` in
``strawboat_tpu/util/hybrid_rle.py`` (the reference's parquet2
``hybrid_rle`` at src/read/read_basic.rs:36-63 and arrow2's
``write_def_levels``).

Wire format (no length prefix):
    run := header(ULEB128 varint) payload
    header & 1 == 1: bit-packed run; (header >> 1) = number of 8-value
                     groups, payload = groups * bit_width bytes, LSB-first.
    header & 1 == 0: RLE run, which simple validity levels may not hold.
"""

from __future__ import annotations

import numpy as np

from ..errors import OutOfSpecError


def _uleb128(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if not value:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _read_uleb128(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise OutOfSpecError("truncated ULEB128 varint in levels")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def encode_validity_bitpacked(validity: np.ndarray) -> bytes:
    """Simple-page def levels: one bit-packed run of the validity bitmap
    (arrow2 ``write_def_levels`` V2 for a nullable leaf)."""
    n = len(validity)
    if n == 0:
        return b""
    groups = (n + 7) // 8
    bits = np.zeros(groups * 8, dtype=np.uint8)
    bits[:n] = np.asarray(validity, dtype=bool)
    return _uleb128((groups << 1) | 1) + np.packbits(bits, bitorder="little").tobytes()


def decode_validity(buf: bytes, length: int) -> np.ndarray:
    """Simple-page def levels → a bool validity array of ``length``.  Only
    bit-packed runs are legal here (reference read_basic.rs:52-60)."""
    out = np.empty(length, dtype=bool)
    filled = 0
    pos = 0
    while filled < length:
        header, pos = _read_uleb128(buf, pos)
        if not (header & 1):
            raise OutOfSpecError("RLE run in simple validity levels")
        nbytes = header >> 1
        raw = np.frombuffer(buf, dtype=np.uint8, count=nbytes, offset=pos)
        pos += nbytes
        bits = np.unpackbits(raw, bitorder="little")
        take = min(len(bits), length - filled)
        out[filled : filled + take] = bits[:take].astype(bool)
        filled += take
    return out
