"""K9: the filtered keyed add of resident integer columns in one pass.

Replaces no Pallas kernel: the JAX package's keyed aggregate
(``strawboat_tpu/parallel/dist_agg.py``, stage 1 of its ``shard_fn``) is
one jit that XLA fuses; the port's dense partials, which it has not, ran as
eager torch passes.  Here the hand-written kernel ``csrc/keyed_add.cu``.
:func:`keyed_add` takes int32 columns of one length
(K1's outputs, in tiled-slot order) by role: the key, range bounds ``[lo,
hi)`` on any columns (``None``: that end open), validity columns (a row
counts only where each is not 0) and the terms to sum.  Rows at or past
``num_rows`` are padding and never count.  A kept row's slot is its key
less ``lowest``, or, where ``clamp``, its key (a dictionary code) clamped
to ``[0, slots)``.

Each term is a product of one or two :class:`Factor`\\ s, each the column,
``literal - column`` or ``literal + column`` in the column's dtype (int32,
or int64 where ``wide``), combined under torch's promotion (an int32-only
product wraps in int32) and widened to int64.  The result is one ``(terms
+ 1, slots)`` int64 tensor: each term's sum a slot, then the slot's count
of kept rows, exact whatever the order of the additions (integer sums mod
2^64).  It is ``parallel/dist_agg.py`` ``dense_partials``' payload for the
same sums.

On a CUDA tensor it launches the kernel (each launch counts in
``k9.launches``) or raises; on a CPU tensor it runs :func:`keyed_add_plain`.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..util import obs
from . import _build
from .filter_sum import check_columns, distinct_inputs

K9_MAX_INPUTS = 8  # kMaxIn of csrc/keyed_add.cu: distinct columns a launch reads
K9_MAX_TERMS = 4  # kMaxTerms: summed terms a launch
K9_SHARED_BYTES = 48 * 1024  # kSharedBytes: a block's slots in shared memory up to this

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_OPS = {"col": 0, "sub": 1, "add": 2}

# one launch's inputs, the kernel's ``Args`` (384 bytes): in, lo, hi,
# factors (literal, input, op | wide << 2), out, n_rows, lowest, slots,
# n_in, n_terms, filt, nonzero, clamp, vec, shared, pad
_ARGS = struct.Struct("<8Q8q8q" + "qii" * 2 * K9_MAX_TERMS + "QqqqiiIIiiii")
assert _ARGS.size == 384
_ENTRY_ARGS = (ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p)


class Factor(NamedTuple):
    """One factor of a term: ``column`` (int32 words), as int64 where
    ``wide`` (else int32), then ``op``: ``"col"`` (the column), ``"sub"``
    (``literal - column``) or ``"add"`` (``literal + column``)."""

    column: torch.Tensor
    wide: bool = False
    op: str = "col"
    literal: int = 0


Bound = Tuple[torch.Tensor, Optional[int], Optional[int]]


def plan_adds(slots: int, n_terms: int) -> str:
    """How a launch adds: ``"shared"`` where a block's ``(n_terms + 1,
    slots)`` table fits ``K9_SHARED_BYTES`` of shared memory (each block
    adds there and flushes once), else ``"global"`` (each kept row adds
    straight into the output)."""
    return "shared" if (n_terms + 1) * slots * 8 <= K9_SHARED_BYTES else "global"


def _check(key, num_rows: int, slots: int, terms, lowest: int, bounds: Sequence[Bound],
           nonzero: Sequence[torch.Tensor]) -> torch.device:
    """The inputs' device; raises on anything the kernel does not take."""
    named = [("key", key)]
    named += [(f"term {i} factor {j}", f.column) for i, t in enumerate(terms)
              for j, f in enumerate(t)]
    named += [(f"bound {i}", t) for i, (t, _lo, _hi) in enumerate(bounds)]
    named += [(f"nonzero {i}", t) for i, t in enumerate(nonzero)]
    n, dev = check_columns(named)
    if not 0 <= num_rows <= n or num_rows > _I32_MAX:
        raise ValueError(f"num_rows must be in 0..{min(n, _I32_MAX)}, got {num_rows}")
    if not 0 < slots <= _I32_MAX:
        raise ValueError(f"slots must be in 1..{_I32_MAX}, got {slots}")
    if not 0 < len(terms) <= K9_MAX_TERMS:
        raise ValueError(f"1 to {K9_MAX_TERMS} terms, got {len(terms)}")
    for i, t in enumerate(terms):
        if not 1 <= len(t) <= 2:
            raise ValueError(f"term {i}: 1 or 2 factors, got {len(t)}")
        for f in t:
            low, high = (_I64_MIN, _I64_MAX) if f.wide else (_I32_MIN, _I32_MAX)
            if f.op not in _OPS or type(f.literal) is not int or not low <= f.literal <= high:
                raise ValueError(f"term {i}: factor ({f.op!r}, {f.literal!r}) is not one "
                                 f"K9 takes")
    if not _I64_MIN <= lowest <= _I64_MAX:
        raise ValueError(f"lowest {lowest} is not an int64")
    for i, (_t, lo, hi) in enumerate(bounds):
        for end in (lo, hi):
            if end is not None and not _I64_MIN <= end <= _I64_MAX:
                raise ValueError(f"bound {i}: {end} is not an int64")
    return dev


def keyed_add_plain(key: torch.Tensor, num_rows: int, slots: int,
                    terms: Sequence[Sequence[Factor]], lowest: int = 0, clamp: bool = False,
                    bounds: Sequence[Bound] = (), nonzero: Sequence[torch.Tensor] = ()
                    ) -> torch.Tensor:
    """Plain torch version of :func:`keyed_add` (the same inputs, the same
    ``(len(terms) + 1, slots)`` int64 result); a kept row's slot outside
    ``[0, slots)`` raises here, where the kernel leaves it out."""
    dev = _check(key, num_rows, slots, terms, lowest, bounds, nonzero)
    keep = torch.arange(key.shape[0], device=dev) < num_rows
    for t, lo, hi in bounds:
        x = t.long()
        if lo is not None:
            keep &= x >= lo
        if hi is not None:
            keep &= x < hi
    for t in nonzero:
        keep &= t != 0
    rows = torch.nonzero(keep).squeeze(1)
    slot = key[rows].long()
    slot = slot.clamp(0, slots - 1) if clamp else slot - lowest
    out = torch.zeros((len(terms) + 1, slots), dtype=torch.int64, device=dev)
    for i, term in enumerate(terms):
        acc = None
        for f in term:
            x = f.column[rows]
            x = x.long() if f.wide else x
            if f.op == "sub":
                x = f.literal - x
            elif f.op == "add":
                x = f.literal + x
            acc = x if acc is None else acc * x
        out[i].index_add_(0, slot, acc.long())
    out[-1].index_add_(0, slot, torch.ones_like(slot))
    return out


def keyed_add(key: torch.Tensor, num_rows: int, slots: int, terms: Sequence[Sequence[Factor]],
              lowest: int = 0, clamp: bool = False, bounds: Sequence[Bound] = (),
              nonzero: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """K9: ``(len(terms) + 1, slots)`` int64, each slot's sum of every term
    and its count over rows ``r < num_rows`` that every bound ``(column,
    lo, hi)`` keeps (``lo <= column[r] < hi``, ``None`` open) and where
    every ``nonzero`` column is not 0, a row's slot ``key[r] - lowest`` (or
    ``key[r]`` clamped to ``[0, slots)`` where ``clamp``).  Every column
    int32, 1-D, of the key's length, on its device, contiguous, at most
    ``K9_MAX_INPUTS`` distinct tensors; 1 to ``K9_MAX_TERMS`` terms of 1 or
    2 factors, each literal in its factor's dtype; bounds Python ints in
    int64; ``num_rows`` and ``slots`` below 2^31; else it raises."""
    terms = [tuple(t) for t in terms]
    bounds, nonzero = list(bounds), list(nonzero)
    dev = _check(key, num_rows, slots, terms, lowest, bounds, nonzero)
    # input 0 is the key (csrc/keyed_add.cu)
    ins, lo, hi, filt, nz = distinct_inputs([key], bounds, nonzero,
                                            [f.column for t in terms for f in t])
    if len(ins) > K9_MAX_INPUTS:
        raise ValueError(f"at most {K9_MAX_INPUTS} distinct columns, got {len(ins)}")
    if dev.type == "cpu":
        return keyed_add_plain(key, num_rows, slots, terms, lowest, clamp, bounds, nonzero)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((len(terms) + 1, slots), dtype=torch.int64, device=dev)
    factors = []
    for i in range(K9_MAX_TERMS):
        term = terms[i] if i < len(terms) else ()
        for j in range(2):
            if j < len(term):
                f = term[j]
                idx = next(k for k, u in enumerate(ins) if u is f.column)
                factors += [f.literal, idx, _OPS[f.op] | (int(f.wide) << 2)]
            else:
                factors += [0, -1, 0]
    pad = K9_MAX_INPUTS - len(ins)
    ptrs = [t.data_ptr() for t in ins]
    args = _ARGS.pack(*ptrs, *[0] * pad, *lo, *[_I64_MIN] * pad, *hi, *[_I64_MAX] * pad,
                      *factors, out.data_ptr(), num_rows, lowest, slots, len(ins), len(terms),
                      filt, nz, int(clamp), int(all(p % 16 == 0 for p in ptrs)),
                      int(plan_adds(slots, len(terms)) == "shared"), 0)
    fn = _build.entry("keyed_add", "sb_keyed_add", _ENTRY_ARGS)
    with torch.cuda.device(dev):
        err = fn(args, _ARGS.size, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"keyed_add kernel launch failed: cudaError {err}")
    obs.count("k9.launches")
    return out
