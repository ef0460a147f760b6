"""K7: the filtered sum of resident integer columns in one pass.

Counterpart of the fusion XLA does inside ``strawboat_tpu/exec/resident.py``
``filter_sum`` (:547); here it is the hand-written kernel
``csrc/filter_sum.cu``.  :func:`filter_sum` takes int32 columns of one
length (K1's outputs, in tiled-slot order) by role: the value, optionally
a product, range bounds ``[lo, hi)`` on any columns (``None``: that end
open) and validity columns (a row counts only where each is not 0).  Rows
at or past ``num_rows`` are padding and never count.  The result is a 0-d
int64 tensor, the sum over kept rows of ``int64(value) [* int64(product)]``
wrapping mod 2^64, as ``torch.sum(dtype=torch.int64)`` wraps.

On a CUDA tensor it launches the kernel (each launch counts in
``k7.launches``) or raises; on a CPU tensor it runs
:func:`filter_sum_plain`.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence, Tuple

import torch

from ..util import obs
from . import _build

K7_MAX_INPUTS = 8  # kMaxIn of csrc/filter_sum.cu: distinct columns a launch reads

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1

# one launch's inputs, the kernel's ``Args`` (224 bytes): in, lo, hi, out,
# n_rows, n_in, nonzero, prod, vec
_ARGS = struct.Struct("<8Q8q8qQqiIii")
assert _ARGS.size == 224
_ENTRY_ARGS = (ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p)

Bound = Tuple[torch.Tensor, Optional[int], Optional[int]]


def check_columns(named: Sequence[Tuple[str, torch.Tensor]]) -> Tuple[int, torch.device]:
    """The length and device of the first of ``named``'s ``(what, column)``
    pairs; raises unless every column is int32, 1-D, contiguous, of that
    length and on that device (what the kernels over K1's words take)."""
    lead, first = named[0]
    n, dev = first.shape[0] if first.dim() == 1 else -1, first.device
    for what, t in named:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: dtype {t.dtype}, expected torch.int32")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected one dimension of "
                             f"the {lead}'s length")
        if t.device != dev:
            raise ValueError(f"{what} on {t.device}, the {lead} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    return n, dev


def _check(value, num_rows: int, product, bounds: Sequence[Bound],
           nonzero: Sequence[torch.Tensor]) -> torch.device:
    """The inputs' device; raises on anything the kernel does not take."""
    named = [("value", value)] + ([("product", product)] if product is not None else [])
    named += [(f"bound {i}", t) for i, (t, _lo, _hi) in enumerate(bounds)]
    named += [(f"nonzero {i}", t) for i, t in enumerate(nonzero)]
    n, dev = check_columns(named)
    if not 0 <= num_rows <= n:
        raise ValueError(f"num_rows must be in 0..{n}, got {num_rows}")
    for i, (_t, lo, hi) in enumerate(bounds):
        for end in (lo, hi):
            if end is not None and not _I64_MIN <= end <= _I64_MAX:
                raise ValueError(f"bound {i}: {end} is not an int64")
    return dev


def filter_sum_plain(value: torch.Tensor, num_rows: int, product: Optional[torch.Tensor] = None,
                     bounds: Sequence[Bound] = (), nonzero: Sequence[torch.Tensor] = ()
                     ) -> torch.Tensor:
    """Plain torch version of :func:`filter_sum` (the same inputs, the same
    0-d int64 result)."""
    dev = _check(value, num_rows, product, bounds, nonzero)
    keep = torch.arange(value.shape[0], device=dev) < num_rows
    for t, lo, hi in bounds:
        x = t.long()
        if lo is not None:
            keep &= x >= lo
        if hi is not None:
            keep &= x < hi
    for t in nonzero:
        keep &= t != 0
    acc = value.long()
    if product is not None:
        acc = acc * product.long()
    return torch.where(keep, acc, 0).sum(dtype=torch.int64)


def distinct_inputs(lead: Sequence[torch.Tensor], bounds: Sequence[Bound], nonzero,
                    rest: Sequence[torch.Tensor] = ()) -> Tuple[List, List, List, int, int]:
    """A kernel's inputs over K1's words: ``lead`` first, as given (a
    tensor twice where it is given twice), then each other distinct tensor
    of ``bounds``, ``nonzero`` and ``rest`` once → (tensors, lo, hi, bits of
    the inputs a bound or nonzero test reads, bits of the nonzero tests).
    Bounds on one tensor intersect."""
    ins = list(lead)
    lo, hi, tested, nz = [_I64_MIN] * len(ins), [_I64_MAX] * len(ins), 0, 0

    def slot(t) -> int:
        for i, u in enumerate(ins):
            if u is t:
                return i
        ins.append(t)
        lo.append(_I64_MIN)
        hi.append(_I64_MAX)
        return len(ins) - 1

    for t, b_lo, b_hi in bounds:
        i = slot(t)
        tested |= 1 << i
        if b_lo is not None:
            lo[i] = max(lo[i], b_lo)
        if b_hi is not None:
            hi[i] = min(hi[i], b_hi)
    for t in nonzero:
        i = slot(t)
        tested |= 1 << i
        nz |= 1 << i
    for t in rest:
        slot(t)
    return ins, lo, hi, tested, nz


def filter_sum(value: torch.Tensor, num_rows: int, product: Optional[torch.Tensor] = None,
               bounds: Sequence[Bound] = (), nonzero: Sequence[torch.Tensor] = ()
               ) -> torch.Tensor:
    """K7: 0-d int64, the sum over rows ``r < num_rows`` that every bound
    ``(column, lo, hi)`` keeps (``lo <= column[r] < hi``, ``None`` open) and
    where every ``nonzero`` column is not 0, of ``int64(value[r]) [*
    int64(product[r])]``, mod 2^64.  Every column int32, 1-D, of the
    value's length, on its device, contiguous, at most ``K7_MAX_INPUTS``
    distinct tensors; bounds Python ints in int64; else it raises."""
    bounds, nonzero = list(bounds), list(nonzero)
    dev = _check(value, num_rows, product, bounds, nonzero)
    # the value first, the product second (the value again where it is its
    # own product)
    lead = [value] + ([product] if product is not None else [])
    ins, lo, hi, _tested, nz = distinct_inputs(lead, bounds, nonzero)
    if len(ins) > K7_MAX_INPUTS:
        raise ValueError(f"at most {K7_MAX_INPUTS} distinct columns, got {len(ins)}")
    if dev.type == "cpu":
        return filter_sum_plain(value, num_rows, product, bounds, nonzero)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((), dtype=torch.int64, device=dev)
    pad = K7_MAX_INPUTS - len(ins)
    ptrs = [t.data_ptr() for t in ins]
    args = _ARGS.pack(*ptrs, *[0] * pad, *lo, *[_I64_MIN] * pad, *hi, *[_I64_MAX] * pad,
                      out.data_ptr(), num_rows, len(ins), nz, int(product is not None),
                      int(all(p % 16 == 0 for p in ptrs)))
    fn = _build.entry("filter_sum", "sb_filter_sum", _ENTRY_ARGS)
    with torch.cuda.device(dev):
        err = fn(args, _ARGS.size, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"filter_sum kernel launch failed: cudaError {err}")
    obs.count("k7.launches")
    return out
