"""Binary and utf8 pages: the writer's codecs and the reader's host parse.

Counterpart of ``strawboat_tpu/codecs/binary.py``.  A column of strings
travels as byte slices: ``offsets`` (int64, ``n + 1``, from 0) into a
uint8 ``values`` buffer.  Page layouts (the reference's
src/compression/binary/):

- raw mode (NONE, LZ4, Zstd, Snappy): two 9-byte-headed blocks, the
  zero-based offsets (int32, int64 for the large types), then the bytes;
- DICT: ``[index subpage][u32 count]`` then ``count`` × ``[u64 len][bytes]``;
  the index subpage is an integer page of u32 codes (``codecs/integer.py``);
- FREQ: ``[u64 len][top][u32 size][roaring bitmap]`` then one
  ``[u64 len][bytes]`` per exception position;
- ONE_VALUE: ``[u32 len][bytes]``.

The writer emits raw NONE pages (the default) and DICT pages (under
``STRAWBOAT_DICT_COMPRESSION``) with the JAX writer's bytes: the DICT
push rule for nulls and the dictionary in order of first appearance.  The
FREQ and ONE_VALUE encoders come with the adaptive chooser.  The reader
parses every page the JAX writer emits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..constants import Compression
from ..errors import NotYetImplementedError, OutOfSpecError
from ..util import env, roaring
from . import WriteOptions, decompress_raw, read_header, write_header
from .integer import compress_integer, factorize_first_occurrence

_CHOOSER = "ROADMAP.md 'Modules to port': the port's adaptive writer chooser"
# slices of at most this many bytes factorize as one u64 key each: the
# bytes little-endian in the low 7 bytes, the length in the top byte
_KEY_BYTES = 7
# above this many matrix bytes, distinct slices are found by a Python dict
_MATRIX_LIMIT = 1 << 28


@dataclass
class BinaryColumn:
    """A string column on the host: slice ``i`` is
    ``values[offsets[i]:offsets[i + 1]]``; ``keys`` holds each row's u64
    key when every slice is at most 7 bytes."""

    offsets: np.ndarray
    values: np.ndarray
    keys: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.offsets) - 1


def slice_keys(starts: np.ndarray, lens: np.ndarray, values: np.ndarray) -> np.ndarray:
    """u64 keys of slices of at most 7 bytes (equal keys ⟺ equal slices),
    one byte position at a time, so temporaries stay one u64 a slice."""
    keys = lens.astype(np.uint64) << np.uint64(8 * _KEY_BYTES)
    if len(lens) and len(values):
        last = len(values) - 1
        for j in range(min(int(lens.max()), _KEY_BYTES)):
            byte = values[np.minimum(starts + j, last)].astype(np.uint64)
            keys |= np.where(lens > j, byte, np.uint64(0)) << np.uint64(8 * j)
    return keys


def key_bytes(key: int) -> bytes:
    return int(key).to_bytes(8, "little")[: int(key) >> 56]


def factorize_slices(
    starts: np.ndarray, lens: np.ndarray, values: np.ndarray, keys: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, List[bytes]]:
    """(int64 code per slice, distinct slices in order of first
    appearance): arrow's ``dictionary_encode`` of a binary array without
    nulls.  ``keys``: the slices' u64 keys, when the caller has them."""
    n = len(lens)
    if n == 0:
        return np.zeros(0, dtype=np.int64), []
    maxlen = int(lens.max())
    if keys is None and maxlen <= _KEY_BYTES:
        keys = slice_keys(starts, lens, values)
    if keys is not None:
        codes, uniq = factorize_first_occurrence(keys)
        return codes, [key_bytes(k) for k in uniq.tolist()]
    width = -(-maxlen // 8) * 8
    if n * (width + 8) <= _MATRIX_LIMIT:
        mat = np.zeros((n, width + 8), dtype=np.uint8)
        idx = starts[:, None] + np.arange(width)
        inside = np.arange(width) < lens[:, None]
        mat[:, :width] = np.where(inside, values[np.minimum(idx, len(values) - 1)], 0)
        mat[:, width:] = lens.astype("<u8")[:, None].view(np.uint8)
        rows = mat.view(np.dtype((np.void, width + 8))).reshape(n)
        _uniq, first, inv = np.unique(rows, return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(first), dtype=np.int64)
        rank[order] = np.arange(len(first))
        return rank[inv.reshape(-1)], [
            values[starts[i] : starts[i] + lens[i]].tobytes() for i in first[order]
        ]
    seen = {}
    codes = np.empty(n, dtype=np.int64)
    for i, (s, ln) in enumerate(zip(starts.tolist(), lens.tolist())):
        codes[i] = seen.setdefault(values[s : s + ln].tobytes(), len(seen))
    return codes, list(seen)


# ---------------------------------------------------------------------------
# writer (reference binary/mod.rs:26-217, binary/dict.rs)


def choose_compressor(options: WriteOptions) -> Compression:
    """The forcing flags in the reference's order, then the default codec;
    raises for what the port's writer does not have yet."""
    if options.default_compress_ratio is not None:
        raise NotYetImplementedError(f"default_compress_ratio ({_CHOOSER})")
    forbidden = options.forbidden_compressions
    if env.check_freq_env() and Compression.FREQ not in forbidden:
        raise NotYetImplementedError(f"the binary FREQ encoder ({_CHOOSER})")
    if env.check_dict_env() and Compression.DICT not in forbidden:
        return Compression.DICT
    if options.default_compression != Compression.NONE:
        raise NotYetImplementedError(
            f"default_compression={options.default_compression.name} "
            "(ROADMAP.md 'Modules to port': LZ4/Zstd compression on write)"
        )
    return Compression.NONE


def dict_encode(col: BinaryColumn, validity: Optional[np.ndarray], options: WriteOptions) -> bytes:
    """``[index subpage][u32 count][u64 len][bytes]...``.  Push rule
    (binary/dict.rs:66-76): a null repeats the previous code, except a
    null at row 0, which pushes its (empty) slice."""
    n = len(col)
    pushed = np.ones(n, dtype=bool) if validity is None else validity.copy()
    if n:
        pushed[0] = True
    starts = col.offsets[:-1][pushed]
    lens = np.diff(col.offsets)[pushed]
    keys = None if col.keys is None else col.keys[pushed]
    codes_pushed, sets = factorize_slices(starts, lens, col.values, keys)
    codes = np.full(n, -1, dtype=np.int64)
    codes[pushed] = codes_pushed
    idx = np.where(codes >= 0, np.arange(n), -1)
    np.maximum.accumulate(idx, out=idx)
    codes = codes[idx] if n else codes
    index = compress_integer(codes.astype(np.uint32), None, options.forbid(Compression.DICT))
    set_lens = np.array([len(s) for s in sets], dtype="<u8")
    return index + np.uint32(len(sets)).tobytes() + b"".join(
        ln.tobytes() + s for ln, s in zip(set_lens, sets)
    )


def compress_binary(
    col: BinaryColumn, validity: Optional[np.ndarray], options: WriteOptions, large: bool
) -> bytes:
    """Header(s) + body of one page; ``large``: int64 offsets."""
    codec = choose_compressor(options)
    if codec == Compression.NONE:
        offs = (col.offsets - col.offsets[0]).astype("<i8" if large else "<i4")
        vals = col.values[col.offsets[0] : col.offsets[-1]].tobytes()
        return (write_header(codec, offs.nbytes, offs.nbytes) + offs.tobytes()
                + write_header(codec, len(vals), len(vals)) + vals)
    body = dict_encode(col, validity, options)
    return write_header(codec, len(body), int(col.offsets[-1] - col.offsets[0])) + body


# ---------------------------------------------------------------------------
# reader: host parse


def _u(buf, fmt: str, pos: int) -> int:
    size = np.dtype(fmt).itemsize
    if pos + size > len(buf):
        raise OutOfSpecError("binary page truncated")
    return int(np.frombuffer(buf, fmt, 1, pos)[0])


def _take_bytes(buf, pos: int, n: int) -> np.ndarray:
    if pos + n > len(buf):
        raise OutOfSpecError(f"data size is less than {n}")
    return np.frombuffer(buf, np.uint8, n, pos)


def parse_len_prefixed(buf, pos: int, count: int) -> Tuple[List[bytes], int]:
    """``count`` × ``[u64 len][bytes]`` → (the slices, end position)."""
    out = []
    for _ in range(count):
        ln = _u(buf, "<u8", pos)
        out.append(_take_bytes(buf, pos + 8, ln).tobytes())
        pos += 8 + ln
    return out, pos


def decode_binary_page(buf, pos: int, length: int, large: bool) -> Tuple[np.ndarray, np.ndarray, int]:
    """A raw-mode, FREQ or ONE_VALUE page at ``pos`` → (int64 offsets,
    uint8 values, end position).  DICT pages decode in the scan."""
    codec, csize, _usize, body = read_header(buf, pos)
    if codec.raw_mode:
        odt = np.dtype("<i8" if large else "<i4")
        (raw,) = decompress_raw(codec, [_take_bytes(buf, body, csize)], [(length + 1) * odt.itemsize])
        offsets = np.frombuffer(raw, odt, length + 1).astype(np.int64)
        codec2, csize2, usize2, body2 = read_header(buf, body + csize)
        (values,) = decompress_raw(codec2, [_take_bytes(buf, body2, csize2)], [usize2])
        if length and (offsets[0] != 0 or offsets[-1] > len(values) or (np.diff(offsets) < 0).any()):
            raise OutOfSpecError("binary page offsets out of range")
        return offsets, np.asarray(values, dtype=np.uint8), body2 + csize2
    end = body + csize
    if codec == Compression.ONE_VALUE:
        ln = _u(buf, "<u4", body)
        value = _take_bytes(buf, body + 4, ln)
        return np.arange(length + 1, dtype=np.int64) * ln, np.tile(value, length), end
    if codec == Compression.FREQ:
        top_len = _u(buf, "<u8", body)
        top = _take_bytes(buf, body + 8, top_len).tobytes()
        p = body + 8 + top_len
        bm_size = _u(buf, "<u4", p)
        positions = roaring.deserialize(_take_bytes(buf, p + 4, bm_size).tobytes()).astype(np.int64)
        if len(positions) and int(positions[-1]) >= length:
            raise OutOfSpecError("FREQ exception position out of range")
        exceptions, _ = parse_len_prefixed(buf, p + 4 + bm_size, len(positions))
        # every row reads the top slice, exceptions their own, from one pool
        lens = np.full(length, top_len, dtype=np.int64)
        lens[positions] = [len(x) for x in exceptions]
        offsets = np.zeros(length + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        src = np.zeros(length, dtype=np.int64)
        src[positions] = top_len + np.cumsum(lens[positions]) - lens[positions]
        pool = np.frombuffer(top + b"".join(exceptions), np.uint8)
        idx = np.repeat(src - offsets[:-1], lens) + np.arange(int(offsets[-1]))
        return offsets, pool[idx], end
    raise OutOfSpecError(f"unknown binary codec {codec}")
