"""Levels: parquet's hybrid RLE / bit-packed runs.

Counterpart of ``strawboat_tpu/util/hybrid_rle.py`` (the reference's
parquet2 ``hybrid_rle`` at src/read/read_basic.rs:30-63 and arrow2's
``write_def_levels`` / ``write_rep_and_def``): the validity of a simple
page, and the repetition / definition levels of a nested page.

Wire format (no length prefix):
    run := header(ULEB128 varint) payload
    header & 1 == 1: bit-packed run; (header >> 1) = number of 8-value
                     groups, payload = groups * bit_width bytes, LSB-first.
    header & 1 == 0: RLE run; (header >> 1) = repeat count, payload =
                     ceil(bit_width / 8) bytes (the LE value).  Simple
                     validity levels may not hold one.
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


def get_bit_width(max_level: int) -> int:
    """Bits needed to store ``max_level`` (parquet2 ``get_bit_width``)."""
    return int(max_level).bit_length()


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


def encode_bitpacked(values: np.ndarray, bit_width: int) -> bytes:
    """All values as one bit-packed run (the last group zero-padded)."""
    n = len(values)
    if bit_width == 0 or n == 0:
        return b""
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, dtype=np.uint32)
    padded[:n] = values
    k = np.arange(bit_width, dtype=np.uint32)
    bits = ((padded[:, None] >> k[None, :]) & np.uint32(1)).astype(np.uint8).reshape(-1)
    return _uleb128((groups << 1) | 1) + np.packbits(bits, bitorder="little").tobytes()


def encode_rle_run(value: int, count: int, bit_width: int) -> bytes:
    return _uleb128(count << 1) + int(value).to_bytes((bit_width + 7) // 8, "little")


def encode_levels(values: np.ndarray, bit_width: int) -> bytes:
    """A level stream → runs, with the JAX writer's bytes.  The stream's
    8-value groups that hold one value form runs of equal groups; a run of
    at least 2 groups (16 values) is an RLE run, every other stretch of
    groups one bit-packed run, the last of which takes the tail (a tail
    after an RLE run is a bit-packed run of its own).  The runs are found
    with numpy; only the emitted runs are visited one by one."""
    values = np.asarray(values, dtype=np.uint32)
    n = len(values)
    if n == 0 or bit_width == 0:
        return b""
    n_groups = n // 8
    if n_groups == 0:
        return encode_bitpacked(values, bit_width)
    g = values[: n_groups * 8].reshape(n_groups, 8)
    const = (g == g[:, :1]).all(axis=1)
    gval = g[:, 0]
    # maximal runs of equal constant groups; those of >= 2 groups are RLE
    joins = np.zeros(n_groups, dtype=bool)
    joins[1:] = const[1:] & const[:-1] & (gval[1:] == gval[:-1])
    run_id = np.cumsum(~joins) - 1
    run_len = np.bincount(run_id)
    rle = const & (run_len[run_id] >= 2)
    # segments: each RLE run, and each stretch of bit-packed groups
    starts = np.flatnonzero(np.r_[True, (rle[1:] != rle[:-1]) | (rle[1:] & ~joins[1:])])
    ends = np.r_[starts[1:], n_groups]
    out = bytearray()
    for s, e in zip(starts.tolist(), ends.tolist()):
        if rle[s]:
            out += encode_rle_run(int(gval[s]), (e - s) * 8, bit_width)
        else:
            out += encode_bitpacked(values[s * 8 : (e * 8 if e < n_groups else n)], bit_width)
    if rle[-1] and n > n_groups * 8:
        out += encode_bitpacked(values[n_groups * 8 :], bit_width)
    return bytes(out)


def decode_levels(buf, bit_width: int, num_values: int) -> np.ndarray:
    """``num_values`` levels (uint32) of a run stream (parquet2
    ``HybridRleDecoder``)."""
    if bit_width == 0:
        return np.zeros(num_values, dtype=np.uint32)
    buf = bytes(buf)
    out = np.empty(num_values, dtype=np.uint32)
    weights = np.uint32(1) << np.arange(bit_width, dtype=np.uint32)
    filled = pos = 0
    while filled < num_values:
        header, pos = _read_uleb128(buf, pos)
        if header & 1:
            groups = header >> 1
            nbytes = groups * bit_width
            if pos + nbytes > len(buf):
                raise OutOfSpecError("truncated bit-packed run")
            bits = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes, pos), bitorder="little")
            pos += nbytes
            decoded = (bits.reshape(groups * 8, bit_width).astype(np.uint32) * weights).sum(
                axis=1, dtype=np.uint32)
            take = min(len(decoded), num_values - filled)
            out[filled : filled + take] = decoded[:take]
        else:
            nbytes = (bit_width + 7) // 8
            if pos + nbytes > len(buf):
                raise OutOfSpecError("truncated RLE run")
            value = int.from_bytes(buf[pos : pos + nbytes], "little")
            pos += nbytes
            take = min(header >> 1, num_values - filled)
            out[filled : filled + take] = value
        if take <= 0 and filled < num_values:
            raise OutOfSpecError("an empty run in levels")
        filled += take
    return out


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
