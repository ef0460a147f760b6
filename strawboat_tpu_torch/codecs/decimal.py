"""decimal128 / decimal256 pages: the writer's codecs and the host decoders.

Counterpart of ``strawboat_tpu/codecs/decimal.py``.  The reference stores
i128 / i256 with the integer family's layouts; numpy has no such
integers, so values travel as ``(n, W)`` little-endian byte matrices (W =
16 or 32, arrow's decimal buffer), and runs, dictionaries and FREQ tops
compare raw bytes, which is integer equality for two's complement.

- raw mode: the matrix's bytes;
- RLE: ``[u32 len][W bytes]`` runs;
- DICT: ``[index subpage][u32 count][count × W bytes]``, the index subpage an
  integer page of u32 codes (``codecs/integer.py``);
- ONE_VALUE: ``W`` bytes;
- FREQ: ``[W bytes top][u32 size][roaring bitmap][exceptions subpage]``.

The writer chooses as the JAX writer does (``choose_compressor``): the
FREQ, DICT or RLE flag, else under ``default_compress_ratio`` ONE_VALUE,
FREQ, DICT (analytic ratios over exact page stats) and RLE (a trial
encode of the whole page, no sampling), else the default codec, with the
JAX writer's bytes.  The reader decodes every page the JAX writer emits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..constants import Compression, get_bits_needed
from ..errors import OutOfSpecError
from ..util import env, roaring
from . import WriteOptions, compress, decompress_raw, read_header, write_header
from ._family import MIN_DICT_RATIO, factorize_first_occurrence
from .integer import compress_integer, decompress_integer, parse_rle


def _void(values: np.ndarray) -> np.ndarray:
    """(n, W) uint8 → (n,) void view for unique / equality."""
    return np.ascontiguousarray(values).view([("b", f"V{values.shape[1]}")])["b"].reshape(-1)


def from_int64(values: np.ndarray, width: int) -> np.ndarray:
    """Unscaled int64 values → the ``(n, width)`` sign-extended byte matrix."""
    v = np.ascontiguousarray(values, dtype="<i8")
    limbs = np.empty((len(v), width // 8), dtype="<i8")
    limbs[:, 0] = v
    limbs[:, 1:] = (v >> 63)[:, None]
    return limbs.view(np.uint8).reshape(len(v), width)


def int64_rows(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A byte matrix's rows → (their low eight bytes as int64, whether each
    row is that int64: its later 8-byte limbs are the sign extension)."""
    limbs = np.ascontiguousarray(mat).view("<i8")
    lo = limbs[:, 0]
    return lo, (limbs[:, 1:] == (lo >> 63)[:, None]).all(axis=1)


# ---------------------------------------------------------------------------
# writer (reference decimal codecs through the integer family)


def dict_encode(values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions) -> bytes:
    """``[index subpage][u32 count][count × W bytes]``: distinct values in
    order of first appearance (int64-sized values interned by their low
    eight bytes, the native factorize's pass); a leading null interns 0,
    every other null repeats the previous code."""
    n = len(values)
    pushed = np.ones(n, dtype=bool) if validity is None else validity.copy()
    eff = values
    if n and not pushed[0]:
        eff = values.copy()
        eff[0] = 0
        pushed[0] = True
    rows = eff[pushed]
    lo, fits = int64_rows(rows)
    if fits.all():
        # every value is its low 8 bytes, sign-extended: intern those
        codes_pushed, uniq = factorize_first_occurrence(np.ascontiguousarray(lo).view("<u8"))
        sets = from_int64(uniq.view("<i8"), values.shape[1])
    else:
        _uniq, first, inv = np.unique(_void(rows), return_index=True, return_inverse=True)
        order = np.argsort(first, kind="stable")
        codes_pushed = np.empty(len(first), dtype=np.int64)
        codes_pushed[order] = np.arange(len(first))
        codes_pushed = codes_pushed[inv.reshape(-1)]
        sets = rows[first[order]]
    codes = np.full(n, -1, dtype=np.int64)
    codes[pushed] = codes_pushed
    idx = np.where(codes >= 0, np.arange(n), -1)
    np.maximum.accumulate(idx, out=idx)
    codes = codes[idx] if n else codes
    return (compress_integer(codes.astype(np.uint32), None, options.forbid(Compression.DICT))
            + np.uint32(len(sets)).tobytes() + sets.tobytes())


def rle_encode(values: np.ndarray, validity: Optional[np.ndarray]) -> bytes:
    """``[u32 len][W bytes]`` runs over the valid rows; nulls fold into the
    run before them (leading ones into the first)."""
    n, width = values.shape
    if n == 0:
        return b""
    valid_idx = np.arange(n) if validity is None else np.flatnonzero(validity)
    vv = values[valid_idx]
    if len(vv) == 0:
        return np.uint32(n).tobytes() + bytes(width)
    keys = _void(vv)
    starts_v = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1])))
    starts_full = valid_idx[starts_v]
    starts_full[0] = 0
    counts = np.append(starts_full[1:], n) - starts_full
    rec = np.zeros((len(counts), 4 + width), dtype=np.uint8)
    rec[:, :4] = counts.astype("<u4").view(np.uint8).reshape(-1, 4)
    rec[:, 4:] = vv[starts_v]
    return rec.tobytes()


def one_value_encode(values: np.ndarray, validity: Optional[np.ndarray]) -> bytes:
    """The first valid row's W bytes (zeros on a page of nulls)."""
    rows = np.arange(len(values)) if validity is None else np.flatnonzero(validity)
    return values[rows[0]].tobytes() if len(rows) else bytes(values.shape[1])


def _top(values: np.ndarray):
    """(the most frequent row as a void scalar: the first in byte order
    among the most frequent, as ``np.unique`` orders them; its count; the
    distinct count), over every row, null ones too."""
    uniq, counts = np.unique(_void(values), return_counts=True)
    if not len(counts):
        return None, 0, 0
    ti = int(np.argmax(counts))
    return uniq[ti], int(counts[ti]), len(uniq)


def freq_encode(values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions) -> bytes:
    """``[W bytes top][u32 size][roaring bitmap][exceptions page]``; a page
    of 90% nulls or more takes zero as its top."""
    n, width = values.shape
    null_count = 0 if validity is None else int(n - np.count_nonzero(validity))
    if n and null_count / n >= 0.9:
        top, mask = bytes(width), np.ones(n, dtype=bool)
    else:
        top_v = _top(values)[0]
        top, mask = top_v.tobytes(), _void(values) != top_v
    if validity is not None:
        mask &= validity
    bitmap = roaring.serialize(np.flatnonzero(mask).astype(np.uint32))
    return (top + np.uint32(len(bitmap)).tobytes() + bitmap
            + compress_decimal(values[mask], None, options.forbid(Compression.FREQ)))


def _max_as_i64(values: np.ndarray) -> int:
    """The largest value's low 64 bits as Rust's ``as i64`` gives them."""
    if len(values) == 0:
        return 0
    key = values.copy()
    key[:, -1] ^= 0x80  # two's complement order: the sign-flipped top byte first
    top = values[int(np.lexsort(key.T)[-1])]
    lo = int.from_bytes(top[:8].tobytes(), "little")
    return ((lo + (1 << 63)) % (1 << 64)) - (1 << 63)


def choose_compressor(values: np.ndarray, validity: Optional[np.ndarray],
                      options: WriteOptions) -> Compression:
    """The FREQ, DICT and RLE flags, then the ratio competition under
    ``default_compress_ratio``, else the default codec (JAX
    codecs/decimal.py:200-242)."""
    forbidden = options.forbidden_compressions
    for flag, codec in ((env.check_freq_env, Compression.FREQ),
                        (env.check_dict_env, Compression.DICT),
                        (env.check_rle_env, Compression.RLE)):
        if flag() and codec not in forbidden:
            return codec
    result = options.default_compression
    if options.default_compress_ratio is None:
        return result
    n, width = values.shape
    _t, max_count, unique = _top(values)
    null_count = 0 if validity is None else int(n - np.count_nonzero(validity))
    max_ratio = options.default_compress_ratio
    if Compression.ONE_VALUE not in forbidden and unique <= 1 and n and float(n) > max_ratio:
        return Compression.ONE_VALUE
    # FREQ, with the integer family's gate max.as_i64() >= 256
    if Compression.FREQ not in forbidden and unique > 1 and n and (
            null_count / n >= 0.9 or (max_count / n >= 0.9 and _max_as_i64(values) >= (1 << 8))):
        if float(n - 1) > max_ratio:
            max_ratio, result = float(n - 1), Compression.FREQ
    if Compression.DICT not in forbidden and unique * MIN_DICT_RATIO < n:
        after = unique * width + n * (get_bits_needed(unique) // 8) + n * 2 // 128
        r = n * width / after if after else 0.0
        if r > max_ratio:
            max_ratio, result = r, Compression.DICT
    if Compression.RLE not in forbidden and n:
        size = len(rle_encode(values, validity))
        r = n * width / size if size else float(n)
        if r > max_ratio:
            result = Compression.RLE
    return result


def compress_decimal(values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions) -> bytes:
    """Header + body of one page of an ``(n, W)`` byte matrix."""
    codec = choose_compressor(values, validity, options)
    if codec.raw_mode:
        body = compress(codec, np.ascontiguousarray(values).tobytes())
    elif codec == Compression.RLE:
        body = rle_encode(values, validity)
    elif codec == Compression.DICT:
        body = dict_encode(values, validity, options)
    elif codec == Compression.ONE_VALUE:
        body = one_value_encode(values, validity)
    elif codec == Compression.FREQ:
        body = freq_encode(values, validity, options)
    else:
        raise OutOfSpecError(f"unknown decimal codec {codec}")
    return write_header(codec, len(body), values.shape[0] * values.shape[1]) + body


# ---------------------------------------------------------------------------
# reader: host decode


def _take(buf, pos: int, n: int) -> np.ndarray:
    if pos < 0 or pos + n > len(buf):
        raise OutOfSpecError("decimal page truncated")
    return np.frombuffer(buf, np.uint8, n, pos)


def parse_dict(buf, pos: int, width: int) -> np.ndarray:
    """The dictionary after a DICT page's index subpage: ``[u32 count]``
    then ``count`` values → an ``(count, W)`` matrix."""
    count = int(_take(buf, pos, 4).view("<u4")[0])
    return _take(buf, pos + 4, count * width).reshape(count, width)


def decompress_decimal(buf, pos: int, length: int, width: int) -> Tuple[np.ndarray, int]:
    """One decimal page at ``pos`` → (its ``(length, W)`` matrix, end).
    A DICT page's index subpage (an integer page of u32 codes) decodes on
    the host."""
    codec, csize, _usize, body = read_header(buf, pos)
    end = body + csize
    if end > len(buf):
        raise OutOfSpecError("decimal page truncated")
    if codec.raw_mode:
        (raw,) = decompress_raw(codec, [np.asarray(buf[body:end], dtype=np.uint8)], [length * width])
        return np.asarray(raw, dtype=np.uint8).reshape(length, width), end
    if codec == Compression.RLE:
        counts, vals = parse_rle(buf, body, length, np.dtype(f"V{width}"))
        mat = np.frombuffer(vals.tobytes(), np.uint8).reshape(-1, width)
        return np.repeat(mat, counts.astype(np.int64), axis=0)[:length], end
    if codec == Compression.ONE_VALUE:
        return np.tile(_take(buf, body, width), (length, 1)), end
    if codec == Compression.DICT:
        codes, ipos = decompress_integer(buf, body, length, np.dtype(np.uint32))
        codes = codes.astype(np.int64)
        data = parse_dict(buf, ipos, width)
        if len(codes) and (not len(data) or int(codes.max()) >= len(data)):
            raise OutOfSpecError("dictionary code out of range")
        return data[codes], end
    if codec == Compression.FREQ:
        top = _take(buf, body, width)
        p = body + width
        bm = int(_take(buf, p, 4).view("<u4")[0])
        positions = roaring.deserialize(_take(buf, p + 4, bm).tobytes()).astype(np.int64)
        if len(positions) and int(positions[-1]) >= length:
            raise OutOfSpecError("FREQ exception position out of range")
        exceptions, _ = decompress_decimal(buf, p + 4 + bm, len(positions), width)
        out = np.tile(top, (length, 1))
        out[positions] = exceptions
        return out, end
    raise OutOfSpecError(f"unknown decimal codec {codec}")
