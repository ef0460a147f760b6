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

The writer emits NONE (the default) and DICT (under
``STRAWBOAT_DICT_COMPRESSION``) with the JAX writer's bytes; the RLE and
FREQ encoders and the ratio competition come with the adaptive chooser.
The reader decodes every page the JAX writer emits.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from ..constants import Compression
from ..errors import NotYetImplementedError, OutOfSpecError
from ..util import env, roaring
from . import WriteOptions, decompress_raw, read_header, write_header
from .integer import compress_integer, factorize_first_occurrence, parse_rle

_CHOOSER = "ROADMAP.md 'Modules to port': the port's adaptive writer chooser"


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


def choose_compressor(options: WriteOptions) -> Compression:
    """The forcing flags in the reference's order (FREQ, DICT, RLE), then
    the default codec; raises for what the port's writer does not have."""
    if options.default_compress_ratio is not None:
        raise NotYetImplementedError(f"default_compress_ratio ({_CHOOSER})")
    forbidden = options.forbidden_compressions
    if env.check_freq_env() and Compression.FREQ not in forbidden:
        raise NotYetImplementedError(f"the decimal FREQ encoder ({_CHOOSER})")
    if env.check_dict_env() and Compression.DICT not in forbidden:
        return Compression.DICT
    if env.check_rle_env() and Compression.RLE not in forbidden:
        raise NotYetImplementedError(f"the decimal RLE encoder ({_CHOOSER})")
    if options.default_compression != Compression.NONE:
        raise NotYetImplementedError(
            f"default_compression={options.default_compression.name} "
            "(ROADMAP.md 'Modules to port': LZ4/Zstd compression on write)"
        )
    return Compression.NONE


def compress_decimal(values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions) -> bytes:
    """Header + body of one page of an ``(n, W)`` byte matrix."""
    codec = choose_compressor(options)
    if codec == Compression.NONE:
        body = np.ascontiguousarray(values).tobytes()
    else:
        body = dict_encode(values, validity, options)
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


def decompress_decimal(buf, pos: int, length: int, width: int,
                       decode_indices: Callable) -> Tuple[np.ndarray, int]:
    """One decimal page at ``pos`` → (its ``(length, W)`` matrix, end).
    ``decode_indices(buf, pos, length)`` decodes a DICT page's index
    subpage (an integer page of u32 codes) → (int64 codes, end)."""
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
        codes, ipos = decode_indices(buf, body, length)
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
        exceptions, _ = decompress_decimal(buf, p + 4 + bm, len(positions), width, decode_indices)
        out = np.tile(top, (length, 1))
        out[positions] = exceptions
        return out, end
    raise OutOfSpecError(f"unknown decimal codec {codec}")
