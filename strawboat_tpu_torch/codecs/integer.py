"""Integer pages: the writer's codecs and the reader's host parse.

Counterpart of ``strawboat_tpu/codecs/integer.py`` and of the integer half
of ``strawboat_tpu/codecs/_family.py``.  The writer emits the codecs a run
reaches without the ratio competition: NONE (the default), BITPACKING and
DICT under the ``STRAWBOAT_*_COMPRESSION`` forcing flags, chosen in the
reference's order (``choose_compressor``), with the same bytes.
DELTA_BITPACKING is only reached by the ratio competition, so its encoder
comes with the chooser (ROADMAP.md).  The reader side parses the bodies of
structured pages (RLE, DICT, FREQ, ONE_VALUE) on the host; the values are
decoded on the device (``exec/scan.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native
from ..constants import Compression
from ..errors import NotYetImplementedError, OutOfSpecError
from ..util import env, roaring
from ..util.bits import BLOCK_LEN, pack_blocks
from . import WriteOptions, write_header

_CHOOSER = "ROADMAP.md 'Modules to port': the port's adaptive writer chooser"


# ---------------------------------------------------------------------------
# writer: Bitpacking (reference bp.rs)


def _encode_blocks(blocks: np.ndarray) -> bytes:
    """Per block ``[u8 num_bits][BitPacker4x words]``; a block's width is the
    bit length of the OR of its values."""
    if blocks.shape[0] >= 8 and native.available():
        return native.bp_encode(blocks, blocks)
    n_blocks = blocks.shape[0]
    acc = np.bitwise_or.reduce(blocks, axis=1)
    nbs = np.zeros(n_blocks, dtype=np.int64)
    nz = acc != 0
    # float64 log2 of a u32 is exact enough for its floor
    nbs[nz] = np.floor(np.log2(acc[nz].astype(np.float64))).astype(np.int64) + 1
    offsets = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(1 + nbs * 16, out=offsets[1:])
    out = np.empty(int(offsets[-1]), dtype=np.uint8)
    out[offsets[:-1]] = nbs
    for nb in np.unique(nbs):
        nb = int(nb)
        if nb == 0:
            continue
        sel = np.flatnonzero(nbs == nb)
        packed = pack_blocks(blocks[sel], nb).view(np.uint8)
        out[offsets[sel][:, None] + 1 + np.arange(nb * 16)] = packed.reshape(len(sel), nb * 16)
    return out.tobytes()


def bitpack_encode(values: np.ndarray) -> bytes:
    if values.dtype.itemsize != 4:
        raise OutOfSpecError(f"bitpacking requires 4-byte values, got {values.dtype}")
    if len(values) % BLOCK_LEN:
        raise OutOfSpecError("bitpacking requires len % 128 == 0")
    return _encode_blocks(np.ascontiguousarray(values).view(np.uint32).reshape(-1, BLOCK_LEN))


# ---------------------------------------------------------------------------
# writer: Dict (reference integer/dict.rs, _family.py:467)


def factorize_first_occurrence(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(int64 codes, distinct values) in first-occurrence order — the
    reference's DictEncoder interning."""
    if values.dtype.itemsize in (4, 8) and len(values) >= 4096 and native.available():
        kind = np.uint32 if values.dtype.itemsize == 4 else np.uint64
        codes, uniq = native.factorize(np.ascontiguousarray(values).view(kind))
        return codes.astype(np.int64), uniq.view(values.dtype)
    uniq, first_idx, inv = np.unique(values, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    return rank[inv.reshape(-1)], values[first_idx[order]]


def dict_indices(
    values: np.ndarray, validity: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """u32 codes and the dictionary, with the reference's null rule: a
    leading null interns 0, every other null repeats the previous code."""
    n = len(values)
    if n == 0:
        return np.empty(0, dtype=np.uint32), values[:0]
    if validity is None:
        codes, sets = factorize_first_occurrence(values)
        return codes.astype(np.uint32), sets
    pushed = validity.copy()
    eff = values
    if not pushed[0]:
        eff = values.copy()
        eff[0] = 0
        pushed[0] = True
    codes_pushed, sets = factorize_first_occurrence(eff[pushed])
    codes = np.full(n, -1, dtype=np.int64)
    codes[pushed] = codes_pushed
    idx = np.where(codes >= 0, np.arange(n), -1)
    np.maximum.accumulate(idx, out=idx)
    return codes[idx].astype(np.uint32), sets


def dict_encode(values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions) -> bytes:
    """``[index subpage][u32 count][dictionary values LE]``; the index
    subpage is an integer page of its own with DICT forbidden."""
    indices, sets = dict_indices(values, validity)
    return (
        compress_integer(indices, None, options.forbid(Compression.DICT))
        + np.uint32(len(sets)).tobytes()
        + sets.astype(sets.dtype.newbyteorder("<")).tobytes()
    )


# ---------------------------------------------------------------------------
# writer: codec choice and page framing (reference integer/mod.rs:35-70, :250)


def choose_compressor(values: np.ndarray, options: WriteOptions) -> Compression:
    """The forcing flags in the reference's order, then the default codec.

    Raises for what the port's writer does not have yet: the ratio
    competition, a default codec other than NONE, and the FREQ and RLE
    encoders that their flags force."""
    if options.default_compress_ratio is not None:
        raise NotYetImplementedError(f"default_compress_ratio ({_CHOOSER})")
    if options.default_compression != Compression.NONE:
        raise NotYetImplementedError(
            f"default_compression={options.default_compression.name} "
            "(ROADMAP.md 'Modules to port': LZ4/Zstd compression on write)"
        )
    forbidden = options.forbidden_compressions
    if env.check_freq_env() and Compression.FREQ not in forbidden:
        raise NotYetImplementedError(f"the FREQ encoder ({_CHOOSER})")
    if env.check_dict_env() and Compression.DICT not in forbidden:
        return Compression.DICT
    if env.check_rle_env() and Compression.RLE not in forbidden:
        raise NotYetImplementedError(f"the RLE encoder ({_CHOOSER})")
    if (
        env.check_bitpack_env()
        and Compression.BITPACKING not in forbidden
        and values.dtype.itemsize == 4
        and len(values) % BLOCK_LEN == 0
    ):
        # the reference keeps this shape gate under forcing: BitPacker4x
        # blocks exist only for full 128-value u32 blocks
        return Compression.BITPACKING
    return options.default_compression


def compress_integer(
    values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions
) -> bytes:
    """Header + body of one integer page."""
    codec = choose_compressor(values, options)
    if codec == Compression.NONE:
        body = values.astype(values.dtype.newbyteorder("<"), copy=False).tobytes()
    elif codec == Compression.BITPACKING:
        body = bitpack_encode(values)
    else:
        body = dict_encode(values, validity, options)
    return write_header(codec, len(body), len(values) * values.dtype.itemsize) + body


# ---------------------------------------------------------------------------
# reader: host parse of structured bodies (reference scan.py:203-326)


def parse_one_value(buf, body: int, dtype: np.dtype) -> np.ndarray:
    """The page's one value, as a 1-element array."""
    if body + dtype.itemsize > len(buf):
        raise OutOfSpecError("OneValue page truncated")
    return np.frombuffer(buf, dtype, 1, body).copy()


def parse_rle(buf, body: int, length: int, dtype: np.dtype) -> Tuple[np.ndarray, np.ndarray]:
    """(u32 run lengths, run values) of the runs that cover ``length``:
    records of ``[u32 len][value]``."""
    rec = np.dtype(
        {"names": ["len", "val"], "formats": ["<u4", dtype],
         "offsets": [0, 4], "itemsize": 4 + dtype.itemsize}
    )
    avail = (len(buf) - body) // rec.itemsize
    recs = np.frombuffer(buf, dtype=rec, count=avail, offset=body)
    cum = np.cumsum(recs["len"].astype(np.int64))
    k = int(np.searchsorted(cum, length, side="left")) + 1
    if length and (k > avail or cum[k - 1] < length):
        raise OutOfSpecError("RLE page truncated")
    return recs["len"][:k].copy(), recs["val"][:k].copy()


def parse_dict_values(buf, pos: int, dtype: np.dtype) -> np.ndarray:
    """The dictionary after a DICT page's index subpage: ``[u32 count]
    [values]``.  An empty dictionary (an all-null page, whose codes are
    all 0) reads as one zero."""
    if pos + 4 > len(buf):
        raise OutOfSpecError("dict page truncated")
    count = int(np.frombuffer(buf, "<u4", 1, pos)[0])
    if pos + 4 + count * dtype.itemsize > len(buf):
        raise OutOfSpecError("dict page truncated")
    if count == 0:
        return np.zeros(1, dtype=dtype)
    return np.frombuffer(buf, dtype, count, pos + 4).copy()


def parse_freq(buf, body: int, dtype: np.dtype) -> Tuple[np.ndarray, np.ndarray, int]:
    """(top value as a 1-element array, exception positions, position of
    the exceptions subpage): ``[top][u32 bitmap size][roaring bitmap]``."""
    top = np.frombuffer(buf, dtype, 1, body).copy()
    p = body + dtype.itemsize
    bm_size = int(np.frombuffer(buf, "<u4", 1, p)[0])
    p += 4
    positions = roaring.deserialize(bytes(buf[p : p + bm_size]))
    return top, positions, p + bm_size
