"""The device writer's page stats as batched torch reductions (K8).

Counterpart of ``strawboat_tpu/kernels/encode.py``, which is jitted XLA
with no Pallas kernel: these are torch ops on the column's own device, one
call for every page of a column.  The writer's first hot loop, the stats
pass over each page (reference integer/mod.rs:179-229), becomes masked row
reductions over a ``(n_pages, page_size)`` view: min, max, null and valid
counts, run counts and sortedness against the previous valid value, and a
distinct estimate from hashed bucket occupancy (linear counting).

Unsigned columns travel as signed views (``device.py``): with
``unsigned=True``, a 16- or 32-bit view compares zero-extended, a 64-bit
view with bit 63 flipped, and min / max come back as the view's bits.  The
hash is the reference's splitmix64 finalizer in int64 arithmetic: a
logical right shift is an arithmetic one and a mask, and products wrap
mod 2^64 as the unsigned ones do.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import SIGN64, u64_to_i64, widen_i64

_M1 = u64_to_i64(0xBF58476D1CE4E5B9)
_M2 = u64_to_i64(0x94D049BB133111EB)
_BUCKETS = 1024


def _keys(values: torch.Tensor, unsigned: bool) -> Tuple[torch.Tensor, object, object, object]:
    """(order-preserving comparison keys of ``values``, the key of 0, the
    largest and the smallest key of the dtype)."""
    if values.dtype.is_floating_point:
        return values, 0.0, float("inf"), float("-inf")
    bits = 8 * values.element_size()
    if unsigned and bits == 64:  # flip bit 63: unsigned order in int64
        return values ^ SIGN64, SIGN64, (1 << 63) - 1, SIGN64
    keys = widen_i64(values, unsigned=unsigned)
    if unsigned or values.dtype == torch.uint8:
        return keys, 0, (1 << bits) - 1, 0
    return keys, 0, (1 << (bits - 1)) - 1, -(1 << (bits - 1))


def _from_keys(keys: torch.Tensor, like: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """Keys back to the values' dtype and bits."""
    if like.dtype.is_floating_point:
        return keys
    if unsigned and like.element_size() == 8:
        keys = keys ^ SIGN64
    return keys.to(like.dtype)


def _hash_bits(values: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """The u64 the reference hashes, as int64 bits: a float's bit pattern
    zero-extended, a signed integer sign-extended, an unsigned one
    zero-extended."""
    if values.dtype.is_floating_point:
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[values.element_size()]
        return widen_i64(values.view(as_int), unsigned=True)
    return widen_i64(values, unsigned=unsigned or values.dtype == torch.uint8)


def splitmix_bucket(h: torch.Tensor, buckets: int) -> torch.Tensor:
    """``splitmix64(h) % buckets`` (a power of two) for int64-held u64."""
    h = (h ^ ((h >> 30) & ((1 << 34) - 1))) * _M1
    h = (h ^ ((h >> 27) & ((1 << 37) - 1))) * _M2
    h = h ^ ((h >> 31) & ((1 << 33) - 1))
    return h & (buckets - 1)


def _prev_valid(m: torch.Tensor) -> torch.Tensor:
    """Per row of ``m`` (pages × slots), the index of the previous valid
    slot of each slot (-1: none)."""
    idx = torch.arange(m.shape[1], device=m.device).expand_as(m)
    last = torch.where(m, idx, torch.full_like(idx, -1)).cummax(dim=1).values
    return torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], dim=1)


def _pages(values: torch.Tensor, validity: Optional[torch.Tensor], page_size: int, fill):
    """(values padded to whole pages as (n_pages, page_size), the validity
    likewise with pad slots invalid, the pad count)."""
    n = values.shape[0]
    n_pages = -(-n // page_size)
    pad = n_pages * page_size - n
    valid = torch.ones(n, dtype=torch.bool, device=values.device) if validity is None else validity
    v = torch.cat([values, torch.full((pad,), fill, dtype=values.dtype, device=values.device)])
    m = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=values.device)])
    return v.view(n_pages, page_size), m.view(n_pages, page_size), pad


def _null_count(set_count: torch.Tensor, page_size: int, pad: int) -> torch.Tensor:
    """Slots per page less valid ones, the tail page's pad slots not
    counted as nulls."""
    nulls = page_size - set_count
    nulls[-1:] -= pad
    return nulls


def paged_stats_device(values: torch.Tensor, validity: Optional[torch.Tensor], page_size: int,
                       unsigned: bool = False) -> Dict[str, torch.Tensor]:
    """Per-page stats of a numeric column in one call on its device → a
    dict of ``(n_pages,)`` tensors: ``min`` / ``max`` over the valid slots
    (the dtype's largest / smallest on a page of nulls) in the values'
    dtype, ``null_count``, ``set_count``, ``run_count`` and ``is_sorted``
    over the valid values (the first compared with 0), and ``unique_est``
    (int32): ``-B·ln(empty buckets / B)`` over B = 1024 hashed buckets, in
    float32 and truncated as the reference does.  The tail page's pad
    slots count neither as nulls nor as values."""
    keys, zero, hi, lo = _keys(values, unsigned)
    k, m, pad = _pages(keys, validity, page_size, zero)
    n_pages = k.shape[0]
    vmin = torch.where(m, k, torch.full_like(k, hi)).amin(dim=1)
    vmax = torch.where(m, k, torch.full_like(k, lo)).amax(dim=1)
    set_count = m.sum(dim=1)
    prev_idx = _prev_valid(m)
    prev = torch.gather(k, 1, prev_idx.clamp(min=0))
    prev = torch.where(prev_idx >= 0, prev, torch.full_like(prev, zero))
    run_count = (m & (k != prev)).sum(dim=1)
    is_sorted = (m & (k < prev)).sum(dim=1) == 0
    # distinct estimate: a bucket is occupied when a valid slot hashes to it
    h, _m, _pad = _pages(_hash_bits(values, unsigned), None, page_size, 0)
    slot = splitmix_bucket(h, _BUCKETS) + torch.arange(n_pages, device=h.device)[:, None] * _BUCKETS
    occ = torch.zeros(n_pages * _BUCKETS, dtype=torch.int32, device=h.device)
    occ.scatter_reduce_(0, slot.reshape(-1), m.reshape(-1).to(torch.int32), reduce="amax")
    occupied = occ.view(n_pages, _BUCKETS).sum(dim=1).to(torch.float32)
    frac = ((_BUCKETS - occupied) / _BUCKETS).clamp(1e-9, 1.0)
    unique_est = (-_BUCKETS * torch.log(frac)).to(torch.int32)
    return {
        "min": _from_keys(vmin, values, unsigned),
        "max": _from_keys(vmax, values, unsigned),
        "null_count": _null_count(set_count, page_size, pad),
        "run_count": run_count,
        "is_sorted": is_sorted,
        "set_count": set_count,
        "unique_est": unique_est,
    }


def stats_device(values: torch.Tensor, validity: Optional[torch.Tensor] = None,
                 unsigned: bool = False) -> Dict[str, torch.Tensor]:
    """The stats of a whole column as one page: ``min``, ``max``,
    ``null_count``, ``run_count``, ``is_sorted``, ``set_count`` (0-d)."""
    d = paged_stats_device(values, validity, max(values.shape[0], 1), unsigned)
    return {k: d[k][0] for k in ("min", "max", "null_count", "run_count", "is_sorted", "set_count")}


def paged_bool_stats_device(values: torch.Tensor, validity: Optional[torch.Tensor],
                            page_size: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A bool column packed into LSB-first bitmap bytes on its device (the
    values of every slot, null ones too; ``np.packbits(bitorder="little")``
    layout), and per-page ``true_count`` / ``set_count`` / ``null_count``
    and ``run_count``: the exact RLE run count over the valid values (a
    null continues its run; reference boolean/rle.rs:31-55).  With
    ``page_size % 8 == 0`` every page starts on a byte of the bitmap."""
    v, m, pad = _pages(values, validity, page_size, False)
    set_count = m.sum(dim=1)
    prev_idx = _prev_valid(m)
    prev = torch.gather(v, 1, prev_idx.clamp(min=0))
    run_count = (m & ((v != prev) | (prev_idx < 0))).sum(dim=1)
    bits = v.reshape(-1)
    bits = torch.cat([bits, bits.new_zeros(-bits.shape[0] % 8)]).view(-1, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    packed = (bits * weights).sum(dim=1).to(torch.uint8)
    return packed, {
        "true_count": (v & m).sum(dim=1),
        "set_count": set_count,
        "run_count": run_count,
        "null_count": _null_count(set_count, page_size, pad),
    }


def block_bit_widths(words: torch.Tensor) -> torch.Tensor:
    """Per 128-value block of int32-viewed u32 words, the bit width of the
    OR of its values (the bit length of its largest) → int32 widths."""
    top = widen_i64(words, unsigned=True).view(-1, 128).amax(dim=1)
    powers = 1 << torch.arange(32, device=words.device, dtype=torch.int64)
    return (top[:, None] >= powers).sum(dim=1).to(torch.int32)


def bitpacked_size_bytes(words: torch.Tensor) -> torch.Tensor:
    """The exact size of the bit-packed page of ``words``: a width byte and
    16 bytes per bit of width, per block."""
    return (block_bit_widths(words).to(torch.int64) * 16 + 1).sum()


def distinct_estimate(values: torch.Tensor, num_buckets: int = 4096,
                      unsigned: bool = False) -> torch.Tensor:
    """A linear-counting distinct estimate of a whole integer column over
    ``num_buckets`` (a power of two) hashed buckets → int32 scalar."""
    slot = splitmix_bucket(_hash_bits(values, unsigned), num_buckets)
    occ = torch.zeros(num_buckets, dtype=torch.int32, device=values.device)
    occ.index_fill_(0, slot, 1)
    occupied = occ.sum().to(torch.float32)
    frac = ((num_buckets - occupied) / num_buckets).clamp(1e-9, 1.0)
    return (-num_buckets * torch.log(frac)).to(torch.int32)
