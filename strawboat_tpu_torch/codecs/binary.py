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

The writer chooses as the reference does (``choose_compressor``, analytic
ratios only, binary/mod.rs:293-348): the FREQ or DICT flag, else under
``default_compress_ratio`` the best of ONE_VALUE, FREQ and DICT, else the
default codec (both raw blocks through LZ4 / Zstd / Snappy when it is
one), with the JAX writer's bytes: the DICT push rule for nulls and the
dictionary in order of first appearance.  The page stats count distinct
slices over every slot, null ones too, as arrow's ``dictionary_encode``
of the page does in the reference.  The reader parses every page the JAX
writer emits: the scan takes DICT pages as codes on the device, the host
read decodes them here (``decode_binary_page``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..constants import Compression, get_bits_needed
from ..errors import OutOfSpecError
from ..util import env, roaring
from ..util import obs
from ..util.obs import log_codec_choice
from . import WriteOptions, compress, decompress_raw, read_header, write_header
from ._family import MIN_DICT_RATIO, _top_is_null, factorize_first_occurrence
from .integer import compress_integer, decompress_integer

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


@dataclass
class BinaryStats:
    """reference binary/mod.rs:254-291, with the page's factorize over
    every slot (``codes``, ``sets``), which DICT and FREQ reuse."""

    tuple_count: int
    total_bytes: int
    unique_count: int
    total_unique_size: int  # sum over distinct slices of (length + 8)
    null_count: int
    max_count: int  # the count of the most frequent slice
    top_value: bytes
    top_code: int
    codes: np.ndarray
    sets: List[bytes]


def gen_stats(col: BinaryColumn, validity: Optional[np.ndarray], large: bool) -> BinaryStats:
    n = len(col)
    codes, sets = factorize_slices(col.offsets[:-1], np.diff(col.offsets), col.values, col.keys)
    counts = np.bincount(codes, minlength=len(sets))
    top = int(np.argmax(counts)) if len(counts) else -1
    return BinaryStats(
        tuple_count=n,
        total_bytes=int(col.offsets[-1] - col.offsets[0]) + (n + 1) * (8 if large else 4),
        unique_count=len(sets),
        total_unique_size=sum(len(s) for s in sets) + 8 * len(sets),
        null_count=0 if validity is None else int(n - np.count_nonzero(validity)),
        max_count=int(counts[top]) if len(counts) else 0,
        top_value=sets[top] if len(counts) else b"",
        top_code=top,
        codes=codes,
        sets=sets,
    )


def _len_prefixed(slices: List[bytes]) -> bytes:
    """``[u64 len][bytes]`` per slice."""
    return b"".join(np.uint64(len(s)).tobytes() + s for s in slices)


def _len_prefixed_rows(col: BinaryColumn, rows: np.ndarray) -> bytes:
    """``[u64 len][bytes]`` for each of ``rows``, in one gather."""
    starts = col.offsets[:-1][rows]
    lens = np.diff(col.offsets)[rows]
    rec = 8 + lens
    out_off = np.cumsum(rec) - rec
    out = np.zeros(int(rec.sum()), dtype=np.uint8)
    out[(out_off[:, None] + np.arange(8)).reshape(-1)] = lens.astype("<u8").view(np.uint8)
    total = int(lens.sum())
    if total:
        within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        out[np.repeat(out_off + 8, lens) + within] = col.values[np.repeat(starts, lens) + within]
    return out.tobytes()


def one_value_encode(col: BinaryColumn, validity: Optional[np.ndarray]) -> bytes:
    """``[u32 len][bytes]`` of the first valid slice (empty on a page of
    nulls)."""
    rows = np.arange(len(col)) if validity is None else np.flatnonzero(validity)
    val = b""
    if len(rows):
        i = int(rows[0])
        val = col.values[col.offsets[i] : col.offsets[i + 1]].tobytes()
    return np.uint32(len(val)).tobytes() + val


def freq_encode(col: BinaryColumn, validity: Optional[np.ndarray], stats: BinaryStats) -> bytes:
    """``[u64 len][top][u32 size][roaring bitmap]`` then the exceptions as
    ``[u64 len][bytes]`` (binary/freq.rs:95-99); a page of 90% nulls or
    more takes the empty slice as its top."""
    if _top_is_null(stats):
        top, mask = b"", np.ones(len(col), dtype=bool)
    else:
        top, mask = stats.top_value, stats.codes != stats.top_code
    if validity is not None:
        mask &= validity
    positions = np.flatnonzero(mask)
    bitmap = roaring.serialize(positions.astype(np.uint32))
    return (np.uint64(len(top)).tobytes() + top + np.uint32(len(bitmap)).tobytes() + bitmap
            + _len_prefixed_rows(col, positions))


def dict_encode(col: BinaryColumn, validity: Optional[np.ndarray], options: WriteOptions,
                stats: Optional[BinaryStats] = None) -> bytes:
    """``[index subpage][u32 count][u64 len][bytes]...``.  Push rule
    (binary/dict.rs:66-76): a null repeats the previous code, except a
    null at row 0, which pushes its (empty) slice.  A no-null page reuses
    the stats' factorize."""
    n = len(col)
    if validity is None and stats is not None:
        codes, sets = stats.codes, stats.sets
    else:
        pushed = np.ones(n, dtype=bool) if validity is None else validity.copy()
        if n:
            pushed[0] = True
        keys = None if col.keys is None else col.keys[pushed]
        codes_pushed, sets = factorize_slices(col.offsets[:-1][pushed], np.diff(col.offsets)[pushed],
                                              col.values, keys)
        codes = np.full(n, -1, dtype=np.int64)
        codes[pushed] = codes_pushed
        idx = np.where(codes >= 0, np.arange(n), -1)
        np.maximum.accumulate(idx, out=idx)
        codes = codes[idx] if n else codes
    index = compress_integer(codes.astype(np.uint32), None, options.forbid(Compression.DICT))
    return index + np.uint32(len(sets)).tobytes() + _len_prefixed(sets)


def _dict_ratio(stats: BinaryStats) -> float:
    if stats.unique_count * MIN_DICT_RATIO >= stats.tuple_count:
        return 0.0
    after = stats.total_unique_size + stats.tuple_count * (get_bits_needed(stats.unique_count) // 8)
    after += stats.tuple_count * 2 // 128
    return stats.total_bytes / after if after else 0.0


def _freq_ratio(stats: BinaryStats) -> float:
    if stats.unique_count <= 1:
        return 0.0
    if _top_is_null(stats) or (stats.tuple_count and stats.max_count / stats.tuple_count >= 0.9):
        return float(stats.tuple_count - 1)
    return 0.0


def _one_value_ratio(stats: BinaryStats) -> float:
    return float(stats.tuple_count) if stats.unique_count <= 1 else 0.0


def choose_compressor(stats: BinaryStats, options: WriteOptions) -> Compression:
    """The FREQ and DICT flags, then the ratio competition of ONE_VALUE,
    FREQ and DICT under ``default_compress_ratio``, else the default
    codec."""
    forbidden = options.forbidden_compressions
    if env.check_freq_env() and Compression.FREQ not in forbidden:
        return Compression.FREQ
    if env.check_dict_env() and Compression.DICT not in forbidden:
        return Compression.DICT
    result = options.default_compression
    if options.default_compress_ratio is None:
        return result
    max_ratio = options.default_compress_ratio
    for codec, ratio_fn in ((Compression.ONE_VALUE, _one_value_ratio),
                            (Compression.FREQ, _freq_ratio),
                            (Compression.DICT, _dict_ratio)):
        if codec in forbidden:
            continue
        r = ratio_fn(stats)
        if r > max_ratio:
            max_ratio, result = r, codec
            if r == float(stats.tuple_count):
                break
    return result


def compress_binary(
    col: BinaryColumn, validity: Optional[np.ndarray], options: WriteOptions, large: bool
) -> bytes:
    """Header(s) + body of one page; ``large``: int64 offsets.  Without a
    ratio and a flag the default codec wins and no stats are taken."""
    stats = None
    if options.default_compress_ratio is None and not (env.check_freq_env() or env.check_dict_env()):
        codec = options.default_compression
    else:
        with obs.span("strawboat.write.stats"):
            stats = gen_stats(col, validity, large)
        with obs.span("strawboat.write.choose"):
            codec = choose_compressor(stats, options)
    log_codec_choice("binary", codec)
    with obs.span("strawboat.write.encode"):
        return _encode(codec, col, validity, options, stats, large)


def _encode(codec: Compression, col: BinaryColumn, validity: Optional[np.ndarray],
            options: WriteOptions, stats, large: bool) -> bytes:
    """Header(s) + body of a page under ``codec``."""
    if codec.raw_mode:
        # two blocks: the zero-based offsets, then the page's bytes
        offs = (col.offsets - col.offsets[0]).astype("<i8" if large else "<i4").tobytes()
        vals = col.values[col.offsets[0] : col.offsets[-1]].tobytes()
        out = b""
        for raw in (offs, vals):
            body = compress(codec, raw)
            out += write_header(codec, len(body), len(raw)) + body
        return out
    if codec == Compression.ONE_VALUE:
        body = one_value_encode(col, validity)
    elif codec == Compression.DICT:
        body = dict_encode(col, validity, options, stats)
    elif codec == Compression.FREQ:
        body = freq_encode(col, validity, stats)
    else:
        raise OutOfSpecError(f"unknown binary codec {codec}")
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


def _gather_rows(pool: np.ndarray, src: np.ndarray, lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Row ``i`` as ``pool[src[i] : src[i] + lens[i]]`` → (int64 offsets,
    uint8 values)."""
    offsets = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    idx = np.repeat(src - offsets[:-1], lens) + np.arange(int(offsets[-1]))
    return offsets, pool[idx]


def decode_binary_page(buf, pos: int, length: int, large: bool) -> Tuple[np.ndarray, np.ndarray, int]:
    """One binary page at ``pos``, of any codec, decoded on the host →
    (int64 offsets, uint8 values, end position)."""
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
    if end > len(buf):
        raise OutOfSpecError("binary page truncated")
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
        src = np.zeros(length, dtype=np.int64)
        src[positions] = top_len + np.cumsum(lens[positions]) - lens[positions]
        pool = np.frombuffer(top + b"".join(exceptions), np.uint8)
        return (*_gather_rows(pool, src, lens), end)
    if codec == Compression.DICT:
        codes, p = decompress_integer(buf, body, length, np.dtype(np.uint32))
        sets, _ = parse_len_prefixed(buf, p + 4, _u(buf, "<u4", p))
        if not sets:  # an all-null page: its codes are 0, one empty slice
            sets = [b""]
        codes = codes.astype(np.int64)
        if len(codes) and int(codes.max()) >= len(sets):
            raise OutOfSpecError("dictionary code out of range")
        set_lens = np.array([len(x) for x in sets], dtype=np.int64)
        starts = np.cumsum(set_lens) - set_lens
        pool = np.frombuffer(b"".join(sets), np.uint8)
        return (*_gather_rows(pool, starts[codes], set_lens[codes]), end)
    raise OutOfSpecError(f"unknown binary codec {codec}")
