"""Float pages (float16 / float32 / float64): the writer's codecs and PATAS.

Counterpart of ``strawboat_tpu/codecs/double.py`` and of the float half of
``strawboat_tpu/codecs/_family.py``.  A float page shares the integer
family's layouts (the reference reuses them for doubles): raw mode, RLE
``[u32 len][value]`` runs, DICT ``[index subpage][u32 count][values]``,
ONE_VALUE and FREQ; the scan parses those bodies with
``codecs/integer.py`` and decodes them on the device (``exec/scan.py``),
the host read decodes whole pages here (``decompress_double``).
PATAS is the float codec of its own: each value XORed against a value
among the last 128, stored as the significant bytes of the XOR.

The writer chooses as the reference does (``choose_compressor``): a
forcing flag (FREQ, DICT, RLE, PATAS) wins, else, under
``default_compress_ratio``, the best of ONE_VALUE, FREQ, DICT (analytic
ratios), PATAS and RLE (trial encodes of the page's sample), else
``default_compression``, with the JAX writer's bytes.  DICT interns by bit
pattern, so -0.0 and 0.0 and every NaN payload are distinct entries; its
index subpage is an integer page (``compress_integer``).

f32 PATAS: the reference's unpack turns ``significant_bytes == 0`` into 8
whenever ``trailing_zeros < 63``, which breaks its equal-value marker for
f32 streams.  As in the JAX package, ``trailing_zeros == bit_width - 1``
with no significant bytes is the equal marker for the value's own width:
bit-identical to the reference for f64, and unambiguous for f32 (a real
XOR with 31 trailing zeros has one significant byte).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native
from ..constants import Compression
from ..errors import OutOfSpecError
from ..util import env
from ..util.obs import log_codec_choice
from . import WriteOptions, decompress_raw, read_header, write_header
from ._family import (
    FamilyStats, compress_sample_ratio, dict_decode, dict_encode, dict_ratio, freq_decode,
    freq_encode, freq_ratio, gen_stats, one_value_decode, one_value_encode, rle_decode, rle_encode,
)
from .integer import _compete, compress_integer, decompress_integer, frame_raw

_RING = 128  # a value refers back at most this far
_NATIVE_MIN = 256  # shorter pages take the Python loops, as in the reference


# ---------------------------------------------------------------------------
# PATAS (reference double/patas.rs:34-202)


def patas_encode(values: np.ndarray) -> bytes:
    if len(values) > _NATIVE_MIN and native.available():
        return native.patas_encode_native(values)
    return _patas_encode_py(values)


def _patas_encode_py(values: np.ndarray) -> bytes:
    width = values.dtype.itemsize  # 4 or 8
    wbits = width * 8
    n = len(values)
    if n == 0:
        return b""
    bl = values.view(f"<u{width}").tolist()
    out = bytearray(int(bl[0]).to_bytes(width, "little"))
    indices = {bl[0]: 0}
    mask = (1 << wbits) - 1
    for i in range(1, n):
        val = bl[i]
        ref_idx = indices.get(val, 0)
        if ref_idx > i or (i - ref_idx) >= _RING:
            ref_idx = i - 1
        diff = i - ref_idx
        xor = val ^ bl[ref_idx]
        tz = wbits if xor == 0 else (xor & -xor).bit_length() - 1
        lz = wbits - xor.bit_length() if xor else wbits
        is_equal = 1 if tz == wbits else 0
        sig_bits = 0 if is_equal else wbits - tz - lz
        sig_bytes = (sig_bits >> 3) + (1 if (sig_bits & 7) else 0)
        out += (((diff & 0x7F) << 9) | ((sig_bytes & 7) << 6) | (tz - is_equal)).to_bytes(2, "little")
        if sig_bytes:
            out += ((xor >> (tz - is_equal)) & mask).to_bytes(width, "little")[:sig_bytes]
        indices[val] = i
    return bytes(out)


def patas_decode(buf, pos: int, length: int, dtype: np.dtype) -> np.ndarray:
    """``length`` PATAS values of ``dtype`` (f32 or f64) at ``buf[pos:]``."""
    dtype = np.dtype(dtype)
    if length > _NATIVE_MIN and native.available():
        return native.patas_decode_native(np.asarray(buf, dtype=np.uint8), pos, length, dtype)
    return _patas_decode_py(buf, pos, length, dtype)


def _patas_decode_py(buf, pos: int, length: int, dtype: np.dtype) -> np.ndarray:
    width = dtype.itemsize
    wbits = width * 8
    equal_tz = wbits - 1
    mask = (1 << wbits) - 1
    if pos + width > len(buf):
        raise OutOfSpecError("patas page truncated")
    mv = bytes(buf[pos : pos + length * (width + 2) + width])
    p = width
    out = [0] * length
    if length:
        out[0] = int.from_bytes(mv[:width], "little")
    for i in range(1, length):
        if p + 2 > len(mv):
            raise OutOfSpecError("patas page truncated")
        packed = int.from_bytes(mv[p : p + 2], "little")
        p += 2
        diff = (packed >> 9) & 0x7F
        sig = (packed >> 6) & 0x7
        tz = packed & 0x3F
        if tz < equal_tz and sig == 0:
            sig = 8
        if sig > width and tz < 8:
            sig = width
        val = 0 if sig > width else int.from_bytes(mv[p : p + sig], "little")
        p += sig
        out[i] = ((val << tz) & mask) ^ out[i - diff]
    return np.asarray(out, dtype=np.uint64).astype(f"<u{width}").view(dtype)


# ---------------------------------------------------------------------------
# writer (reference double/mod.rs:32-307)


def _codec_compress(codec: Compression, values: np.ndarray, validity: Optional[np.ndarray],
                    stats: FamilyStats, options: WriteOptions) -> bytes:
    """The body of a structured codec; DICT's index subpage is an integer
    page."""
    if codec == Compression.RLE:
        return rle_encode(values, validity)
    if codec == Compression.DICT:
        return dict_encode(values, validity, options, compress_integer, stats)
    if codec == Compression.ONE_VALUE:
        return one_value_encode(values, validity)
    if codec == Compression.FREQ:
        return freq_encode(values, validity, stats, options, compress_double)
    if codec == Compression.PATAS:
        return patas_encode(values)
    raise OutOfSpecError(f"unknown double codec {codec}")


def _ratio(codec: Compression, stats: FamilyStats, rng: np.random.Generator) -> float:
    if codec == Compression.ONE_VALUE:
        return float(stats.tuple_count) if stats.unique_count <= 1 else 0.0
    if codec == Compression.FREQ:
        return freq_ratio(stats, require_big_max=False)
    if codec == Compression.DICT:
        return dict_ratio(stats)
    if codec == Compression.PATAS:
        return compress_sample_ratio(lambda v, m: patas_encode(v), stats, rng)
    if codec == Compression.RLE:
        return compress_sample_ratio(rle_encode, stats, rng)
    return 0.0


_CHOICE_ORDER = (
    Compression.ONE_VALUE,
    Compression.FREQ,
    Compression.DICT,
    Compression.PATAS,
    Compression.RLE,
)


def _any_flag() -> bool:
    return (env.check_freq_env() or env.check_dict_env() or env.check_rle_env()
            or env.check_patas_env())


def choose_compressor(stats: FamilyStats, options: WriteOptions) -> Compression:
    """The forcing flags in the reference's order (FREQ, DICT, RLE, PATAS),
    then the ratio competition under ``default_compress_ratio``, else the
    default codec (reference double/mod.rs:32-307)."""
    forbidden = options.forbidden_compressions
    for flag, codec in ((env.check_freq_env, Compression.FREQ),
                        (env.check_dict_env, Compression.DICT),
                        (env.check_rle_env, Compression.RLE),
                        (env.check_patas_env, Compression.PATAS)):
        if flag() and codec not in forbidden:
            return codec
    if options.default_compress_ratio is None:
        return options.default_compression
    return _compete(_CHOICE_ORDER, _ratio, stats, options)


def compress_double(
    values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions
) -> bytes:
    """Header + body of one float page.  Without a ratio and a flag the
    default codec wins and no stats are taken."""
    if options.default_compress_ratio is None and not _any_flag():
        stats, codec = None, options.default_compression
    else:
        stats = gen_stats(values, validity)
        codec = choose_compressor(stats, options)
    log_codec_choice("double", codec)
    if codec.raw_mode:
        return frame_raw(codec, values)
    body = _codec_compress(codec, values, validity, stats, options)
    return write_header(codec, len(body), len(values) * values.dtype.itemsize) + body



# ---------------------------------------------------------------------------
# reader: whole-page host decode (reference double/mod.rs), for the
# host read (``read/``)


def decompress_double(buf, pos: int, length: int, dtype: np.dtype) -> Tuple[np.ndarray, int]:
    """One float page at ``pos`` → (its ``length`` values, the position
    past the header and the compressed body); a FREQ page's exceptions are
    a float page, a DICT page's indices an integer page."""
    dtype = np.dtype(dtype)
    codec, csize, _usize, body = read_header(buf, pos)
    end = body + csize
    if end > len(buf):
        raise OutOfSpecError("double page truncated")
    if codec.raw_mode:
        (raw,) = decompress_raw(codec, [np.asarray(buf[body:end], dtype=np.uint8)],
                                [length * dtype.itemsize])
        return np.frombuffer(raw, dtype=dtype), end
    if codec == Compression.RLE:
        out, _ = rle_decode(buf, body, length, dtype)
    elif codec == Compression.DICT:
        out, _ = dict_decode(buf, body, length, dtype, decompress_integer)
    elif codec == Compression.ONE_VALUE:
        out, _ = one_value_decode(buf, body, length, dtype)
    elif codec == Compression.FREQ:
        out, _ = freq_decode(buf, body, length, dtype, decompress_double)
    elif codec == Compression.PATAS:
        out = patas_decode(buf, body, length, dtype)
    else:
        raise OutOfSpecError(f"unknown double codec {codec}")
    return out, end
