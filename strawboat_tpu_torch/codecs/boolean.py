"""Boolean pages: the writer's codecs and chooser, the reader's host decoders.

Counterpart of ``strawboat_tpu/codecs/boolean.py`` (the reference's
src/compression/boolean/).  A raw-mode body is the LSB-first bitmap of
the values (through LZ4 / Zstd / Snappy when one is the default codec),
and the header's uncompressed size is the ROW count.  RLE pages hold
``[u32 run length][u8 value]`` runs (nulls fold into the runs) and
ONE_VALUE pages one byte.  The writer chooses as the reference does: the
RLE flag, else under ``default_compress_ratio`` ONE_VALUE for a page of
one valid value, then RLE by its trial ratio on the page's sample, else
the default codec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..constants import SAMPLE_COUNT, SAMPLE_SIZE, Compression
from ..errors import OutOfSpecError
from ..util import env
from ..util.obs import log_codec_choice
from . import WriteOptions, compress, decompress_raw, read_header, write_header
from ._family import one_value_encode as _one_value_encode, rle_encode


@dataclass
class BooleanStats:
    """reference boolean/mod.rs:139-192."""

    values: np.ndarray
    validity: Optional[np.ndarray]
    rows: int
    total_bytes: int
    null_count: int
    false_count: int
    true_count: int
    average_run_length: float


def gen_stats(values: np.ndarray, validity: Optional[np.ndarray]) -> BooleanStats:
    n = len(values)
    valid_vals = values if validity is None else values[validity]
    null_count = n - len(valid_vals)
    true_count = int(np.count_nonzero(valid_vals))
    # runs over the valid values, the first compared with slot 0's value
    # (False when slot 0 is null; boolean/mod.rs:155-180)
    run_count = 0
    if n and len(valid_vals):
        prev = np.empty_like(valid_vals)
        prev[0] = bool(values[0]) if (validity is None or validity[0]) else False
        prev[1:] = valid_vals[:-1]
        run_count = int(np.count_nonzero(valid_vals != prev))
    return BooleanStats(
        values=values, validity=validity, rows=n, total_bytes=n // 8, null_count=null_count,
        false_count=len(valid_vals) - true_count, true_count=true_count,
        average_run_length=(n / 8.0 / run_count) if run_count else float("inf"),
    )


def rle_bool_encode(values: np.ndarray, validity: Optional[np.ndarray]) -> bytes:
    return rle_encode(values.astype(np.uint8), validity)


def one_value_encode(values: np.ndarray, validity: Optional[np.ndarray]) -> bytes:
    """One byte: the first valid value (0 on a page of nulls)."""
    return _one_value_encode(values.astype(np.uint8), validity)


def _rle_ratio(stats: BooleanStats, rng: np.random.Generator) -> float:
    """RLE's trial ratio over the page's sample (the page itself when it
    holds SAMPLE_COUNT × SAMPLE_SIZE rows or fewer)."""
    n = stats.rows
    values, validity = stats.values, stats.validity
    if n // SAMPLE_COUNT > SAMPLE_SIZE:
        separator, remainder = n // SAMPLE_COUNT, n % SAMPLE_COUNT
        begins = []
        for i in range(SAMPLE_COUNT):
            range_end = (separator + remainder if i == SAMPLE_COUNT - 1 else separator) - SAMPLE_SIZE
            begins.append(i * separator + int(rng.integers(0, range_end)))
        values = np.concatenate([values[b : b + SAMPLE_SIZE] for b in begins])
        if validity is not None:
            validity = np.concatenate([validity[b : b + SAMPLE_SIZE] for b in begins])
        total = len(values) // 8
    else:
        total = stats.total_bytes
    size = len(rle_bool_encode(values, validity))
    return total / size if size else float(total)


def choose_compressor(stats: BooleanStats, options: WriteOptions) -> Compression:
    forbidden = options.forbidden_compressions
    if env.check_rle_env() and Compression.RLE not in forbidden:
        return Compression.RLE
    result = options.default_compression
    if options.default_compress_ratio is None:
        return result
    rng = np.random.default_rng(options.sample_seed)
    max_ratio = options.default_compress_ratio
    if Compression.ONE_VALUE not in forbidden:  # OneValue, then RLE (boolean/mod.rs:215-218)
        r = float(stats.rows) if (stats.true_count == 0 or stats.false_count == 0) else 0.0
        if r > max_ratio:
            return Compression.ONE_VALUE
    if Compression.RLE not in forbidden and _rle_ratio(stats, rng) > max_ratio:
        result = Compression.RLE
    return result


def compress_boolean(values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions) -> bytes:
    """Header + body of one boolean page.  Without a ratio and the RLE flag
    the default codec wins and no stats are taken."""
    if options.default_compress_ratio is None and not env.check_rle_env():
        codec = options.default_compression
    else:
        codec = choose_compressor(gen_stats(values, validity), options)
    log_codec_choice("boolean", codec)
    if codec.raw_mode:
        body = compress(codec, np.packbits(values.astype(np.uint8), bitorder="little").tobytes())
    elif codec == Compression.RLE:
        body = rle_bool_encode(values, validity)
    elif codec == Compression.ONE_VALUE:
        body = one_value_encode(values, validity)
    else:
        raise OutOfSpecError(f"unknown boolean codec {codec}")
    return write_header(codec, len(body), len(values)) + body


def rle_decode(buf, body: int, length: int) -> np.ndarray:
    """The bool values of an RLE body covering ``length`` rows."""
    if length == 0:
        return np.zeros(0, dtype=bool)
    rec = np.dtype({"names": ["len", "val"], "formats": ["<u4", "u1"],
                    "offsets": [0, 4], "itemsize": 5})
    avail = (len(buf) - body) // 5
    recs = np.frombuffer(buf, dtype=rec, count=avail, offset=body)
    cum = np.cumsum(recs["len"].astype(np.int64))
    k = int(np.searchsorted(cum, length, side="left")) + 1
    if k > avail or cum[k - 1] < length:
        raise OutOfSpecError("boolean RLE truncated")
    return np.repeat(recs["val"][:k] != 0, recs["len"][:k].astype(np.int64))[:length]


def one_value_decode(buf, body: int, length: int) -> np.ndarray:
    if body >= len(buf):
        raise OutOfSpecError("data size is less than 1")
    return np.full(length, buf[body] > 0, dtype=bool)


def decompress_boolean(buf, pos: int, length: int) -> Tuple[np.ndarray, int]:
    """One boolean page at ``pos`` → (its ``length`` values, the position
    past the header and the compressed body)."""
    codec, csize, _usize, body = read_header(buf, pos)
    end = body + csize
    if end > len(buf):
        raise OutOfSpecError("boolean page truncated")
    if codec.raw_mode:
        (raw,) = decompress_raw(codec, [np.asarray(buf[body:end], dtype=np.uint8)],
                                [(length + 7) // 8])
        bits = np.unpackbits(np.asarray(raw, dtype=np.uint8), count=length, bitorder="little")
        return bits.astype(bool), end
    if codec == Compression.RLE:
        return rle_decode(buf, body, length), end
    if codec == Compression.ONE_VALUE:
        return one_value_decode(buf, body, length), end
    raise OutOfSpecError(f"unknown boolean codec {codec}")
