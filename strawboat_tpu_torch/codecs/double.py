"""Float pages (float16 / float32 / float64): the writer's codecs and PATAS.

Counterpart of ``strawboat_tpu/codecs/double.py`` and of the float half of
``strawboat_tpu/codecs/_family.py``.  A float page shares the integer
family's layouts (the reference reuses them for doubles): raw mode, RLE
``[u32 len][value]`` runs, DICT ``[index subpage][u32 count][values]``,
ONE_VALUE and FREQ; the reader parses those bodies with
``codecs/integer.py`` and decodes them on the device (``exec/scan.py``).
PATAS is the float codec of its own: each value XORed against a value
among the last 128, stored as the significant bytes of the XOR.

The writer emits NONE (the default) and, under the forcing flags, DICT
(codes interned by bit pattern, so -0.0 and 0.0 and every NaN payload are
distinct entries; the index subpage through ``compress_integer``, so the
BITPACKING flag packs it) and PATAS, with the JAX writer's bytes.  The RLE
and FREQ encoders and the ratio competition come with the adaptive
chooser.

f32 PATAS: the reference's unpack turns ``significant_bytes == 0`` into 8
whenever ``trailing_zeros < 63``, which breaks its equal-value marker for
f32 streams.  As in the JAX package, ``trailing_zeros == bit_width - 1``
with no significant bytes is the equal marker for the value's own width:
bit-identical to the reference for f64, and unambiguous for f32 (a real
XOR with 31 trailing zeros has one significant byte).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import native
from ..constants import Compression
from ..errors import NotYetImplementedError, OutOfSpecError
from ..util import env
from . import WriteOptions, write_header
from .integer import compress_integer, dict_indices

_CHOOSER = "ROADMAP.md 'Modules to port': the port's adaptive writer chooser"
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


def bit_view(values: np.ndarray) -> np.ndarray:
    """The unsigned integers of the same width holding a float's bits."""
    return values.view(f"<u{values.dtype.itemsize}")


def dict_encode(values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions) -> bytes:
    """``[index subpage][u32 count][values LE]``, interned by bit pattern,
    with the integer family's null rule: a leading null interns 0.0, every
    other null repeats the previous code."""
    indices, sets = dict_indices(bit_view(values), validity)
    return (
        compress_integer(indices, None, options.forbid(Compression.DICT))
        + np.uint32(len(sets)).tobytes()
        + sets.astype(sets.dtype.newbyteorder("<")).tobytes()
    )


def choose_compressor(options: WriteOptions) -> Compression:
    """The forcing flags in the reference's order (FREQ, DICT, RLE, PATAS),
    then the default codec; raises for what the port's writer does not have
    yet."""
    if options.default_compress_ratio is not None:
        raise NotYetImplementedError(f"default_compress_ratio ({_CHOOSER})")
    forbidden = options.forbidden_compressions
    if env.check_freq_env() and Compression.FREQ not in forbidden:
        raise NotYetImplementedError(f"the float FREQ encoder ({_CHOOSER})")
    if env.check_dict_env() and Compression.DICT not in forbidden:
        return Compression.DICT
    if env.check_rle_env() and Compression.RLE not in forbidden:
        raise NotYetImplementedError(f"the float RLE encoder ({_CHOOSER})")
    if env.check_patas_env() and Compression.PATAS not in forbidden:
        return Compression.PATAS
    if options.default_compression != Compression.NONE:
        raise NotYetImplementedError(
            f"default_compression={options.default_compression.name} "
            "(ROADMAP.md 'Modules to port': LZ4/Zstd compression on write)"
        )
    return Compression.NONE


def compress_double(
    values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions
) -> bytes:
    """Header + body of one float page."""
    codec = choose_compressor(options)
    if codec == Compression.NONE:
        body = values.astype(values.dtype.newbyteorder("<"), copy=False).tobytes()
    elif codec == Compression.DICT:
        body = dict_encode(values, validity, options)
    else:
        body = patas_encode(values)
    return write_header(codec, len(body), len(values) * values.dtype.itemsize) + body

