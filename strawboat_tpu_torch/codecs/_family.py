"""The writer's codecs shared by the integer and float families.

Counterpart of ``strawboat_tpu/codecs/_family.py`` (the reference's
src/compression/integer/{rle,dict,one_value,freq}.rs, reused for doubles):
page stats (``gen_stats``), the structured encoders, their analytic ratios
and the sampled trial ratio, with the JAX writer's bytes and choices.

- run and FREQ equality follow OrderedFloat for floats (NaN == NaN,
  -0.0 == 0.0) and plain equality for integers;
- DICT interns by bit pattern (reference integer/dict.rs:222-232), so -0.0
  and 0.0, and every NaN payload, are entries of their own.

Stats take one of four routes, as in the reference writer: integer pages of
4096 values or more through the native one-pass stats (above 8192 values
gated by a strided 4096-value sample: only a sample that makes DICT or FREQ
plausible pays the full distinct pass, as a first-occurrence factorize
that ``dict_encode`` reuses); float32 / float64 pages above 8192 values
alike over their bit patterns; every other page through numpy (distinct
values by value).  The trial sample of a page is drawn once, from the
first candidate's draw of the page's RNG, and every later candidate reuses
it (``sample_stats``).  The host read's decoders of the RLE, ONE_VALUE,
DICT and FREQ bodies close the module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np

from .. import native
from ..constants import SAMPLE_COUNT, SAMPLE_SIZE, Compression, get_bits_needed
from ..errors import OutOfSpecError
from ..util import obs, roaring

MIN_DICT_RATIO = 3


def values_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OrderedFloat-style elementwise equality."""
    if a.dtype.kind == "f":
        return (a == b) | (np.isnan(a) & np.isnan(b))
    return a == b


def bit_view(values: np.ndarray) -> np.ndarray:
    """Raw bit-pattern view (uint of the same width) of a float array."""
    if values.dtype.kind == "f":
        return values.view(f"<u{values.dtype.itemsize}")
    return values


# ---------------------------------------------------------------------------
# stats (reference integer/mod.rs:166-229)


@dataclass
class FamilyStats:
    """IntegerStats / DoubleStats."""

    values: np.ndarray
    validity: Optional[np.ndarray]
    tuple_count: int
    total_bytes: int
    null_count: int
    average_run_length: float
    is_sorted: bool
    min: float
    max: float
    unique_count: int  # distinct over ALL slots, null ones too
    top_value: object
    max_count: int
    set_count: int
    # a no-null page's first-occurrence factorize, when the stats made one:
    # dict_encode reuses it
    dict_codes: Optional[np.ndarray] = None
    dict_sets: Optional[np.ndarray] = None


_EXACT_STATS_MAX = 8192  # pages up to this size: always exact one-pass stats
_STATS_SAMPLE = 4096


def int_stats_native(values: np.ndarray, validity: Optional[np.ndarray]) -> Optional[FamilyStats]:
    """One-pass stats of an integer page in C (``native.int_stats``), or
    None without the native library (reference native/__init__.py:404)."""
    if not native.available():
        return None
    out = native.int_stats(values, validity)
    dtype = values.dtype
    n = len(values)
    run_count = int(out[3])
    vmin = out[0] if dtype.kind == "i" else np.uint64(out[0].view(np.uint64))
    vmax = out[1] if dtype.kind == "i" else np.uint64(out[1].view(np.uint64))
    top = np.asarray(out[6]).view(np.uint64)[()] if dtype.kind == "u" else out[6]
    return FamilyStats(
        values=values,
        validity=validity,
        tuple_count=n,
        total_bytes=n * dtype.itemsize,
        null_count=int(out[2]),
        average_run_length=(n / run_count) if run_count else float("inf"),
        is_sorted=bool(out[4]),
        min=dtype.type(vmin),
        max=dtype.type(vmax),
        unique_count=int(out[5]),
        top_value=dtype.type(top),
        max_count=int(out[7]),
        set_count=n - int(out[2]),
    )


def _runs_and_sorted(valid_vals: np.ndarray) -> Tuple[int, bool]:
    """(run count, sortedness) over the valid values, the first compared
    with T::default() == 0 (reference integer/mod.rs:196-216)."""
    if not len(valid_vals):
        return 0, True
    prev = np.empty_like(valid_vals)
    prev[0] = 0
    prev[1:] = valid_vals[:-1]
    run_count = int(np.count_nonzero(~values_equal(valid_vals, prev)))
    with np.errstate(invalid="ignore"):
        is_sorted = bool(np.all(valid_vals >= prev))
    return run_count, is_sorted


def _base_stats(values: np.ndarray, validity: Optional[np.ndarray]) -> dict:
    """The exact fields every route computes alike: counts, runs,
    sortedness, min and max."""
    n = len(values)
    null_count = 0 if validity is None else int(n - np.count_nonzero(validity))
    run_count, is_sorted = _runs_and_sorted(values if validity is None else values[validity])
    return dict(
        values=values,
        validity=validity,
        tuple_count=n,
        total_bytes=n * values.dtype.itemsize,
        null_count=null_count,
        average_run_length=(n / run_count) if run_count else float("inf"),
        is_sorted=is_sorted,
        min=values.min() if n else 0,
        max=values.max() if n else 0,
        set_count=n - null_count,
    )


def _strided_sample(values: np.ndarray) -> np.ndarray:
    stride = max(1, len(values) // _STATS_SAMPLE)
    return np.ascontiguousarray(values[::stride][:_STATS_SAMPLE])


def _plausible(st_s: FamilyStats, m: int) -> bool:
    """Whether a sample's stats make DICT or FREQ plausible."""
    return st_s.unique_count <= m // 2 or st_s.max_count >= 0.85 * m


def _gen_stats_sampled(values: np.ndarray, validity: Optional[np.ndarray]) -> Optional[FamilyStats]:
    """Large integer pages: exact min / max / runs / sortedness; the
    distinct pass only where a strided sample makes DICT or FREQ
    plausible, else ``unique_count = n`` (rejects DICT) and the sample's
    top share scaled (below FREQ's 90%)."""
    n = len(values)
    sample = _strided_sample(values)
    st_s = int_stats_native(sample, None)
    if st_s is None:
        return None
    m = len(sample)
    if _plausible(st_s, m):
        if validity is None and values.dtype.itemsize in (4, 8):
            fs = _gen_stats_factorized(values)
            if fs is not None:
                return fs
        return int_stats_native(values, validity)
    return FamilyStats(
        unique_count=n,
        top_value=st_s.top_value,
        max_count=min(n, int(st_s.max_count) * n // m),
        **_base_stats(values, validity),
    )


def _factorized(values: np.ndarray, bits: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """First-occurrence factorize of a no-null page's bit patterns →
    (u32 codes, distinct values), or None without the native library."""
    if not native.available():
        return None
    codes, uniq_bits = native.factorize(np.ascontiguousarray(bits).view(
        np.uint32 if bits.dtype.itemsize == 4 else np.uint64))
    return codes, uniq_bits.view(values.dtype)


def _top(codes: np.ndarray, sets: np.ndarray) -> Tuple[object, int]:
    """(most frequent value, its count): the first distinct value with the
    highest count."""
    counts = np.bincount(codes, minlength=len(sets))
    if not len(counts):
        return 0, 0
    ti = int(np.argmax(counts))
    return sets[ti], int(counts[ti])


def _gen_stats_factorized(values: np.ndarray) -> Optional[FamilyStats]:
    """Exact stats of a no-null page from one first-occurrence factorize,
    whose codes and sets ride on the stats for ``dict_encode``."""
    r = _factorized(values, bit_view(values))
    if r is None:
        return None
    codes, sets = r
    top_value, max_count = _top(codes, sets)
    return FamilyStats(
        unique_count=len(sets),
        top_value=top_value,
        max_count=max_count,
        dict_codes=codes,
        dict_sets=sets,
        **_base_stats(values, None),
    )


def _gen_stats_float_fast(values: np.ndarray, validity: Optional[np.ndarray]) -> Optional[FamilyStats]:
    """Large float pages: distinct values and the top value over the bit
    patterns (the DICT encoder's interning domain), gated by the strided
    sample as for integers; runs, sortedness, min and max by value."""
    n = len(values)
    bits = bit_view(values)
    sample = _strided_sample(bits)
    st_s = int_stats_native(sample, None)
    if st_s is None:
        return None
    m = len(sample)

    def to_float(b) -> object:
        return np.array([b], dtype=bits.dtype).view(values.dtype)[0]

    base = _base_stats(values, validity)
    if _plausible(st_s, m):
        if validity is None:
            r = _factorized(values, bits)
            if r is not None:
                codes, sets = r
                top_value, max_count = _top(codes, sets)
                return FamilyStats(unique_count=len(sets), top_value=top_value,
                                   max_count=max_count, dict_codes=codes, dict_sets=sets, **base)
        st_f = int_stats_native(np.ascontiguousarray(bits), validity)
        if st_f is None:
            return None
        return FamilyStats(unique_count=st_f.unique_count, top_value=to_float(st_f.top_value),
                           max_count=st_f.max_count, **base)
    return FamilyStats(
        unique_count=n,
        top_value=to_float(st_s.top_value),
        max_count=min(n, int(st_s.max_count) * n // m),
        **base,
    )


def gen_stats(values: np.ndarray, validity: Optional[np.ndarray]) -> FamilyStats:
    """The stats of one integer or float page (reference gen_stats)."""
    n = len(values)
    if n >= 4096 and values.dtype.kind in "iu":
        if n > _EXACT_STATS_MAX:
            fast = _gen_stats_sampled(values, validity)
            if fast is not None:
                return fast
        fast = int_stats_native(values, validity)
        if fast is not None:
            return fast
    if n > _EXACT_STATS_MAX and values.dtype.kind == "f" and values.dtype.itemsize in (4, 8):
        fast = _gen_stats_float_fast(values, validity)
        if fast is not None:
            return fast
    uniq, counts = np.unique(values, return_counts=True)
    if len(counts):
        ti = int(np.argmax(counts))
        top_value, max_count = uniq[ti], int(counts[ti])
    else:
        top_value, max_count = 0, 0
    return FamilyStats(unique_count=len(uniq), top_value=top_value, max_count=max_count,
                       **_base_stats(values, validity))


# ---------------------------------------------------------------------------
# RLE (reference integer/rle.rs:64-134)


def rle_encode(values: np.ndarray, validity: Optional[np.ndarray]) -> bytes:
    """``[u32 run length][value]`` runs over the valid values; a run spans
    the slots up to the next run's first valid value, so leading nulls fold
    into the first run and the others into the run before them."""
    n = len(values)
    if n == 0:
        return b""
    dtype = values.dtype
    if validity is None or bool(validity.all()):
        valid_idx = np.arange(n)
        valid_vals = values
    else:
        valid_idx = np.flatnonzero(validity)
        valid_vals = values[valid_idx]
    if len(valid_vals) == 0:  # a page of nulls: one run of the default value
        return np.uint32(n).tobytes() + np.zeros(1, dtype=dtype).tobytes()
    neq = np.empty(len(valid_vals), dtype=bool)
    neq[0] = True
    neq[1:] = ~values_equal(valid_vals[1:], valid_vals[:-1])
    run_starts_v = np.flatnonzero(neq)
    starts_full = valid_idx[run_starts_v]
    starts_full[0] = 0
    ends_full = np.append(starts_full[1:], n)
    itemsize = dtype.itemsize
    rec = np.zeros((len(starts_full), 4 + itemsize), dtype=np.uint8)
    rec[:, :4] = (ends_full - starts_full).astype("<u4").view(np.uint8).reshape(-1, 4)
    rec[:, 4:] = valid_vals[run_starts_v].astype(dtype.newbyteorder("<")).view(np.uint8).reshape(-1, itemsize)
    return rec.tobytes()


# ---------------------------------------------------------------------------
# OneValue (reference integer/one_value.rs:62-94)


def one_value_encode(values: np.ndarray, validity: Optional[np.ndarray]) -> bytes:
    """The first valid value (the default value on a page of nulls)."""
    dtype = values.dtype
    idx = np.arange(len(values)) if validity is None else np.flatnonzero(validity)
    val = values[idx[0]] if len(idx) else np.zeros(1, dtype=dtype)[0]
    return np.asarray([val], dtype=dtype.newbyteorder("<")).tobytes()


# ---------------------------------------------------------------------------
# Dict (reference integer/dict.rs:33-120)


def factorize_first_occurrence(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(int64 codes, distinct values) in order of first appearance, interned
    by bit pattern: the reference's DictEncoder interning."""
    keys = bit_view(values)
    if keys.dtype.itemsize in (4, 8) and len(keys) >= 4096:
        r = _factorized(values, keys)
        if r is not None:
            return r[0].astype(np.int64), r[1]
    uniq, first_idx, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    return rank[inv.reshape(-1)], values[first_idx[order]]


def dict_indices(values: np.ndarray, validity: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """u32 codes and the dictionary, with the reference's null rule
    (dict.rs:44-49): a leading null interns 0, every other null repeats
    the previous code."""
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


def dict_encode(values: np.ndarray, validity: Optional[np.ndarray], options,
                compress_indices: Callable, stats: Optional[FamilyStats] = None) -> bytes:
    """``[index subpage][u32 count][dictionary values LE]``; the index
    subpage is an integer page of its own with DICT forbidden.  A no-null
    page reuses the stats' factorize."""
    if validity is None and stats is not None and stats.dict_codes is not None:
        indices, sets = stats.dict_codes, stats.dict_sets
    else:
        indices, sets = dict_indices(values, validity)
    return (compress_indices(indices, None, options.forbid(Compression.DICT))
            + np.uint32(len(sets)).tobytes()
            + sets.astype(sets.dtype.newbyteorder("<")).tobytes())


def dict_ratio(stats: FamilyStats) -> float:
    """Analytic DICT size model (reference integer/dict.rs:109-120)."""
    if stats.unique_count * MIN_DICT_RATIO >= stats.tuple_count:
        return 0.0
    after = stats.unique_count * stats.values.dtype.itemsize + stats.tuple_count * (
        get_bits_needed(stats.unique_count) // 8)
    after += stats.tuple_count * 2 // 128
    return stats.total_bytes / after if after else 0.0


# ---------------------------------------------------------------------------
# Freq (reference integer/freq.rs:33-152)


def _top_is_null(stats) -> bool:
    return bool(stats.tuple_count) and stats.null_count / stats.tuple_count >= 0.9


def freq_encode(values: np.ndarray, validity: Optional[np.ndarray], stats: FamilyStats,
                options, compress_exceptions: Callable) -> bytes:
    """``[top][u32 bitmap size][roaring bitmap of the exceptions' positions]
    [exceptions page]``; a page of 90% nulls or more takes the default
    value as its top and every valid value as an exception."""
    dtype = values.dtype
    if _top_is_null(stats):
        top = np.zeros(1, dtype=dtype)[0]
        mask = np.ones(len(values), dtype=bool)
    else:
        top = stats.top_value
        mask = ~values_equal(values, np.full_like(values, top))
    if validity is not None:
        mask &= validity
    bitmap = roaring.serialize(np.flatnonzero(mask).astype(np.uint32))
    return (np.asarray([top], dtype=dtype.newbyteorder("<")).tobytes()
            + np.uint32(len(bitmap)).tobytes() + bitmap
            + compress_exceptions(values[mask], None, options.forbid(Compression.FREQ)))


def freq_ratio(stats: FamilyStats, require_big_max: bool) -> float:
    """reference integer/freq.rs:129-151; integers add the gate
    ``max.as_i64() >= 1 << 8``, with Rust's ``as i64`` wrap."""
    if stats.unique_count <= 1:
        return 0.0
    if _top_is_null(stats):
        return float(stats.tuple_count - 1)
    if stats.tuple_count and stats.max_count / stats.tuple_count >= 0.9:
        if not require_big_max:
            return float(stats.tuple_count - 1)
        max_i64 = ((int(stats.max) + (1 << 63)) % (1 << 64)) - (1 << 63)
        if max_i64 >= (1 << 8):
            return float(stats.tuple_count - 1)
    return 0.0


# ---------------------------------------------------------------------------
# sampling (reference integer/mod.rs:310-347)


def sample_stats(stats: FamilyStats, rng: np.random.Generator) -> FamilyStats:
    """The stats of the page's trial sample: SAMPLE_COUNT runs of
    SAMPLE_SIZE values, one from each stretch of the page at a random
    start.  A page of SAMPLE_COUNT × SAMPLE_SIZE values or fewer is its own
    sample.  The sample is drawn once per page, at its first candidate's
    call, and cached on ``stats``: every later candidate is measured on
    the same sample and ``rng`` does not advance again (the reference
    draws anew for each candidate)."""
    n = stats.tuple_count
    if n // SAMPLE_COUNT <= SAMPLE_SIZE:
        return stats
    cached = getattr(stats, "_trial_sample", None)
    if cached is not None:
        return cached
    separator = n // SAMPLE_COUNT
    remainder = n % SAMPLE_COUNT
    begins = []
    for i in range(SAMPLE_COUNT):
        range_end = (separator + remainder if i == SAMPLE_COUNT - 1 else separator) - SAMPLE_SIZE
        begins.append(i * separator + int(rng.integers(0, range_end)))
    values = np.concatenate([stats.values[b : b + SAMPLE_SIZE] for b in begins])
    mask = None if stats.validity is None else np.concatenate(
        [stats.validity[b : b + SAMPLE_SIZE] for b in begins])
    out = gen_stats(values, mask)
    stats._trial_sample = out
    return out


def compress_sample_ratio(codec_compress: Callable, stats: FamilyStats,
                          rng: np.random.Generator) -> float:
    """The trial ratio of a codec: the sample's bytes over its encoded
    size (the sample's own size when the codec refuses it); counts in
    ``write.trials``."""
    obs.count("write.trials")
    s = sample_stats(stats, rng)
    try:
        size = len(codec_compress(s.values, s.validity))
    except Exception:
        size = s.total_bytes
    if size == 0:
        return float(s.total_bytes)
    return s.total_bytes / size


# ---------------------------------------------------------------------------
# host page decoders (reference integer/{rle,one_value,dict,freq}.rs), for
# the host read (``read/``); the scan decodes these bodies on the device.
# The body parsers live in ``integer.py``, which imports this module.


def rle_decode(buf, pos: int, length: int, dtype: np.dtype) -> Tuple[np.ndarray, int]:
    """An RLE body → (its ``length`` values, end position)."""
    from .integer import parse_rle

    if length == 0:
        return np.empty(0, dtype=dtype), pos
    counts, vals = parse_rle(buf, pos, length, dtype)
    out = np.repeat(vals, counts.astype(np.int64))[:length]
    return out.astype(dtype, copy=False), pos + len(counts) * (4 + dtype.itemsize)


def one_value_decode(buf, pos: int, length: int, dtype: np.dtype) -> Tuple[np.ndarray, int]:
    from .integer import parse_one_value

    val = parse_one_value(buf, pos, dtype)
    return np.full(length, val[0], dtype=dtype), pos + dtype.itemsize


def dict_decode(buf, pos: int, length: int, dtype: np.dtype,
                decompress_indices: Callable) -> Tuple[np.ndarray, int]:
    """A DICT body: the u32 index subpage, then ``[u32 count][values]``."""
    from .integer import parse_dict_values

    indices, pos = decompress_indices(buf, pos, length, np.dtype(np.uint32))
    data = parse_dict_values(buf, pos, dtype)
    count = int(np.frombuffer(buf, "<u4", 1, pos)[0])
    if len(indices) and count == 0:
        raise OutOfSpecError("dict page has indices but no values")
    out = data[indices] if count else np.empty(0, dtype=dtype)
    return out.astype(dtype, copy=False), pos + 4 + count * dtype.itemsize


def freq_decode(buf, pos: int, length: int, dtype: np.dtype,
                decompress_exceptions: Callable) -> Tuple[np.ndarray, int]:
    """A FREQ body: the top value everywhere but at the roaring bitmap's
    positions, which take the exceptions subpage's values."""
    from .integer import parse_freq

    top, positions, pos = parse_freq(buf, pos, dtype)
    out = np.full(length, top[0], dtype=dtype)
    exceptions, pos = decompress_exceptions(buf, pos, len(positions), dtype)
    if len(exceptions) != len(positions):
        raise OutOfSpecError("freq exceptions length mismatch")
    out[positions] = exceptions
    return out, pos
