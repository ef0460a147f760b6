"""Integer pages: the writer's codecs and chooser, the reader's host parse.

Counterpart of ``strawboat_tpu/codecs/integer.py``.  The writer chooses a
page's codec as the reference does (``choose_compressor``): a forcing flag
(``STRAWBOAT_*_COMPRESSION``: FREQ, DICT, RLE, BITPACK) wins, else, under
``default_compress_ratio``, the codec whose ratio beats it and every
earlier codec's, in the order ONE_VALUE, FREQ, DICT (analytic ratios),
RLE, BITPACKING, DELTA_BITPACKING (trial encodes of a sampled page, ΔBP
counted ×1.5), else ``default_compression`` (NONE, or LZ4 / Zstd / Snappy
over the page's bytes), with the JAX writer's bytes.  The RLE, DICT,
ONE_VALUE and FREQ encoders are shared with the float family
(``_family.py``).  The reader side parses the bodies of structured pages
(RLE, DICT, FREQ, ONE_VALUE) on the host for the scan, which decodes the
values on the device (``exec/scan.py``), and decodes whole pages on the
host for the host read (``decompress_integer``, ``read/``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native
from ..constants import Compression
from ..errors import OutOfSpecError
from ..util import env, roaring
from ..util.bits import BLOCK_LEN, pack_blocks, unpack_blocks
from ..util import obs
from ..util.obs import log_codec_choice
from . import WriteOptions, compress, decompress_raw, read_header, write_header
from ._family import (
    FamilyStats, compress_sample_ratio, dict_decode, dict_encode, dict_ratio, freq_decode,
    freq_encode, freq_ratio, gen_stats, one_value_decode, one_value_encode, rle_decode, rle_encode,
)


# ---------------------------------------------------------------------------
# writer: Bitpacking and DeltaBitpacking (reference bp.rs, delta_bp.rs)


def _encode_blocks(payload: np.ndarray, widths: np.ndarray) -> bytes:
    """Per 128-value block ``[u8 num_bits][BitPacker4x words of the
    payload]``; a block's width is the bit length of the OR of its
    ``widths`` row."""
    if payload.shape[0] >= 8 and native.available():
        return native.bp_encode(payload, widths)
    n_blocks = payload.shape[0]
    acc = np.bitwise_or.reduce(widths, axis=1)
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
        packed = pack_blocks(payload[sel], nb).view(np.uint8)
        out[offsets[sel][:, None] + 1 + np.arange(nb * 16)] = packed.reshape(len(sel), nb * 16)
    return out.tobytes()


def _u32_blocks(values: np.ndarray) -> np.ndarray:
    if values.dtype.itemsize != 4:
        raise OutOfSpecError(f"bitpacking requires 4-byte values, got {values.dtype}")
    if len(values) % BLOCK_LEN:
        raise OutOfSpecError("bitpacking requires len % 128 == 0")
    return np.ascontiguousarray(values).view(np.uint32)


def bitpack_encode(values: np.ndarray) -> bytes:
    blocks = _u32_blocks(values).reshape(-1, BLOCK_LEN)
    return _encode_blocks(blocks, blocks)


def delta_bitpack_encode(values: np.ndarray) -> bytes:
    """The sequential deltas (mod 2^32, from 0), bit-packed at widths taken
    from the RAW values (delta_bp.rs:52)."""
    v = _u32_blocks(values)
    deltas = np.diff(v, prepend=np.uint32(0)).astype(np.uint32)
    return _encode_blocks(deltas.reshape(-1, BLOCK_LEN), v.reshape(-1, BLOCK_LEN))


def _bp_eligible(stats: FamilyStats) -> bool:
    """u32-wide full blocks, and no negative value (bp.rs:93)."""
    if stats.values.dtype.itemsize != 4 or stats.tuple_count % BLOCK_LEN != 0:
        return False
    return not (stats.values.dtype.kind == "i" and int(stats.min) < 0)


# ---------------------------------------------------------------------------
# writer: codec choice and page framing (reference integer/mod.rs:35-70, :231-308)


def _codec_compress(codec: Compression, values: np.ndarray, validity: Optional[np.ndarray],
                    stats: FamilyStats, options: WriteOptions) -> bytes:
    """The body of a structured codec."""
    if codec == Compression.RLE:
        return rle_encode(values, validity)
    if codec == Compression.DICT:
        return dict_encode(values, validity, options, compress_integer, stats)
    if codec == Compression.ONE_VALUE:
        return one_value_encode(values, validity)
    if codec == Compression.FREQ:
        return freq_encode(values, validity, stats, options, compress_integer)
    if codec == Compression.BITPACKING:
        return bitpack_encode(values)
    if codec == Compression.DELTA_BITPACKING:
        return delta_bitpack_encode(values)
    raise OutOfSpecError(f"unknown integer codec {codec}")


def _ratio(codec: Compression, stats: FamilyStats, rng: np.random.Generator) -> float:
    if codec == Compression.ONE_VALUE:
        return float(stats.tuple_count) if stats.unique_count <= 1 else 0.0
    if codec == Compression.FREQ:
        return freq_ratio(stats, require_big_max=True)
    if codec == Compression.DICT:
        return dict_ratio(stats)
    if codec == Compression.RLE:
        return compress_sample_ratio(rle_encode, stats, rng)
    if codec == Compression.BITPACKING:
        if not _bp_eligible(stats):
            return 0.0
        return compress_sample_ratio(lambda v, m: bitpack_encode(v), stats, rng)
    if codec == Compression.DELTA_BITPACKING:
        if not _bp_eligible(stats) or not stats.is_sorted or stats.null_count > 0:
            return 0.0
        # the trial packs the values themselves, as the reference does
        return compress_sample_ratio(lambda v, m: bitpack_encode(v), stats, rng) * 1.5
    return 0.0


_CHOICE_ORDER = (
    Compression.ONE_VALUE,
    Compression.FREQ,
    Compression.DICT,
    Compression.RLE,
    Compression.BITPACKING,
    Compression.DELTA_BITPACKING,
)


def _compete(order, ratio, stats, options: WriteOptions) -> Compression:
    """The ratio competition: the first codec of ``order`` (not forbidden)
    whose ``ratio(codec, stats, rng)`` beats the option's ratio and every
    earlier one's; a ratio equal to the row count ends it.  The page's RNG
    is made anew from ``sample_seed``."""
    result = options.default_compression
    rng = np.random.default_rng(options.sample_seed)
    max_ratio = options.default_compress_ratio
    for codec in order:
        if codec in options.forbidden_compressions:
            continue
        r = ratio(codec, stats, rng)
        if r > max_ratio:
            max_ratio = r
            result = codec
            if r == float(stats.tuple_count):
                break
    return result


def choose_compressor(stats: FamilyStats, options: WriteOptions) -> Compression:
    """The forcing flags in the reference's order, then the ratio
    competition under ``default_compress_ratio``, else the default codec."""
    forbidden = options.forbidden_compressions
    if env.check_freq_env() and Compression.FREQ not in forbidden:
        return Compression.FREQ
    if env.check_dict_env() and Compression.DICT not in forbidden:
        return Compression.DICT
    if env.check_rle_env() and Compression.RLE not in forbidden:
        return Compression.RLE
    if (
        env.check_bitpack_env()
        and Compression.BITPACKING not in forbidden
        and stats.values.dtype.itemsize == 4
        and stats.tuple_count % BLOCK_LEN == 0
    ):
        # the reference keeps this shape gate under forcing: BitPacker4x
        # blocks exist only for full 128-value u32 blocks
        return Compression.BITPACKING
    if options.default_compress_ratio is None:
        return options.default_compression
    return _compete(_CHOICE_ORDER, _ratio, stats, options)


def _any_flag() -> bool:
    return (env.check_freq_env() or env.check_dict_env() or env.check_rle_env()
            or env.check_bitpack_env())


def frame_raw(codec: Compression, values: np.ndarray) -> bytes:
    """Header + body of a raw-mode page of fixed-width values."""
    body = compress(codec, values.astype(values.dtype.newbyteorder("<"), copy=False).tobytes())
    return write_header(codec, len(body), len(values) * values.dtype.itemsize) + body


def compress_integer(
    values: np.ndarray, validity: Optional[np.ndarray], options: WriteOptions
) -> bytes:
    """Header + body of one integer page.  Without a ratio and a flag the
    default codec wins and no stats are taken.  Spans
    ``strawboat.write.stats``, ``.choose`` and ``.encode``."""
    if options.default_compress_ratio is None and not _any_flag():
        stats, codec = None, options.default_compression
    else:
        with obs.span("strawboat.write.stats"):
            stats = gen_stats(values, validity)
        with obs.span("strawboat.write.choose"):
            codec = choose_compressor(stats, options)
    log_codec_choice("integer", codec)
    with obs.span("strawboat.write.encode"):
        if codec.raw_mode:
            return frame_raw(codec, values)
        body = _codec_compress(codec, values, validity, stats, options)
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


# ---------------------------------------------------------------------------
# reader: whole-page host decode (reference integer/mod.rs:72-117), for the
# host read (``read/``)


def bitpack_decode(buf, pos: int, length: int, dtype: np.dtype) -> Tuple[np.ndarray, int]:
    """A bit-packed body (widths may differ by block) → (``length`` values
    viewed as ``dtype``, end position): one native pass, or without the
    native library the numpy unpack of each width's blocks."""
    n_blocks = (length + BLOCK_LEN - 1) // BLOCK_LEN
    buf = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
    if n_blocks and native.available():
        vals, end = native.bp_decode(buf, pos, n_blocks)
        return vals[:length].view(dtype), end
    nbs = np.empty(n_blocks, dtype=np.int64)
    starts = np.empty(n_blocks, dtype=np.int64)
    p = pos
    for b in range(n_blocks):
        if p >= len(buf):
            raise OutOfSpecError("bitpacked page truncated")
        nbs[b], starts[b] = int(buf[p]), p + 1
        p += 1 + int(buf[p]) * 16
    if p > len(buf):
        raise OutOfSpecError("bitpacked page truncated")
    out = np.zeros((n_blocks, BLOCK_LEN), dtype=np.uint32)
    for nb in np.unique(nbs):
        nb = int(nb)
        sel = np.flatnonzero(nbs == nb)
        if nb:
            idx = starts[sel][:, None] + np.arange(nb * 16)
            out[sel] = unpack_blocks(buf[idx].view(np.uint32), nb)
    return out.reshape(-1)[:length].view(dtype), p


def delta_bitpack_decode(buf, pos: int, length: int, dtype: np.dtype) -> Tuple[np.ndarray, int]:
    """The bit-packed deltas, summed from 0 (mod 2^32)."""
    deltas, pos = bitpack_decode(buf, pos, length, np.dtype(np.uint32))
    return np.cumsum(deltas, dtype=np.uint32).view(dtype), pos


def decompress_integer(buf, pos: int, length: int, dtype: np.dtype) -> Tuple[np.ndarray, int]:
    """One integer page at ``pos`` → (its ``length`` values, the position
    past the header and the compressed body)."""
    dtype = np.dtype(dtype)
    codec, csize, _usize, body = read_header(buf, pos)
    end = body + csize
    if end > len(buf):
        raise OutOfSpecError("integer page truncated")
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
        out, _ = freq_decode(buf, body, length, dtype, decompress_integer)
    elif codec == Compression.BITPACKING:
        out, _ = bitpack_decode(buf, body, length, dtype)
    elif codec == Compression.DELTA_BITPACKING:
        out, _ = delta_bitpack_decode(buf, body, length, dtype)
    else:
        raise OutOfSpecError(f"unknown integer codec {codec}")
    return out, end
