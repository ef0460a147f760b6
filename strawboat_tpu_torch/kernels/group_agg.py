"""K6: dense grouped integer sums and counts in one pass.

Counterpart of ``strawboat_tpu/exec/aggregate.py`` ``dense_group_sum``
(:233), which groups with a one-hot matmul that XLA fuses; here it is the
hand-written kernel ``csrc/group_agg.cu``.  :func:`group_agg` takes key
columns with their strides (a row's group is ``Σ key · stride``, built in
registers), a row mask and a list of outputs ``(values, validity)``, each
the int64 sum of its values (``None``: a count) over the rows of each
group in ``[0, cap)`` that the mask and its validity keep, wrapping mod
2^64.  Outputs that repeat a ``(values, validity)`` pair of tensors are
computed once.

On a CUDA tensor it launches the kernel (:func:`plan_launches` says how
many; each counts in ``k6.launches``) or raises; on a CPU tensor it runs
:func:`group_agg_plain`.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence, Tuple

import torch

from ..util import obs
from . import _build

# groups the kernel takes (the fused resident branch's bound); callers send
# more to the scatter-add route
K6_MAX_GROUPS = 4096
K6_MAX_KEYS = 8  # kMaxKeys of csrc/group_agg.cu
K6_MAX_OUT = 16  # kMaxOut: outputs one launch carries
# a thread's own sums: (cap bound, outputs a launch) of the kernel's
# instantiations
K6_LANE_SHAPES = ((8, 8), (32, 2))
# a block's sums: bytes of its (outputs, cap) int64 sums in shared memory
K6_SMEM_BYTES = 96 * 1024

# one launch's inputs, the kernel's ``Args`` (432 bytes): keys, strides,
# values, validities, mask, out, n_rows, n_keys, n_out, cap, key64, val64, vec
_ARGS = struct.Struct("<8Q8q16Q16QQQqiiiIIi")
assert _ARGS.size == 432
_ENTRY_ARGS = (ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

_INTS = (torch.int32, torch.int64)

Output = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def plan_launches(cap: int, n_out: int) -> List[Tuple[int, int, int]]:
    """The launches of one call: ``[(first output, end, cap bound)]``, a cap
    bound of 0 meaning a block's sums under shared atomics.  A thread's own
    sums where ``cap`` is at most a bound of ``K6_LANE_SHAPES`` (its outputs
    a launch), a block's otherwise (as many outputs as ``K6_SMEM_BYTES``
    holds)."""
    if not 1 <= cap <= K6_MAX_GROUPS:
        raise ValueError(f"cap must be in 1..{K6_MAX_GROUPS}, got {cap}")
    for bound, per in K6_LANE_SHAPES:
        if cap <= bound:
            break
    else:
        bound, per = 0, min(K6_MAX_OUT, K6_SMEM_BYTES // (8 * cap))
    return [(lo, min(lo + per, n_out), bound) for lo in range(0, n_out, per)]


def _check(keys, cap: int, mask, outputs) -> Tuple[int, torch.device]:
    """(rows, device) of valid inputs; raises on anything else."""
    if not 1 <= cap <= K6_MAX_GROUPS:
        raise ValueError(f"cap must be in 1..{K6_MAX_GROUPS}, got {cap}")
    if len(keys) > K6_MAX_KEYS:
        raise ValueError(f"at most {K6_MAX_KEYS} key columns, got {len(keys)}")
    if not outputs:
        raise ValueError("no outputs")
    named = [(f"key {i}", k, _INTS) for i, (k, _s) in enumerate(keys)]
    named.append(("mask", mask, (torch.bool,)))
    for i, (v, valid) in enumerate(outputs):
        named += [(f"values {i}", v, _INTS), (f"validity {i}", valid, (torch.bool,))]
    tensors = [(what, t, dtypes) for what, t, dtypes in named if t is not None]
    if not tensors:
        raise ValueError("no tensor gives the row count")
    n, dev = tensors[0][1].shape[0], tensors[0][1].device
    for what, t, dtypes in tensors:
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: dtype {t.dtype}, expected one of {dtypes}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected ({n},)")
        if t.device != dev:
            raise ValueError(f"{what} on {t.device}, the others on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    return n, dev


def composite_code(keys: Sequence[Tuple[torch.Tensor, int]], n: int,
                   device: torch.device) -> torch.Tensor:
    """The int64 group ``Σ codes · stride`` of ``n`` rows' key columns
    ``[(codes, stride)]`` (no keys: 0)."""
    code = torch.zeros(n, dtype=torch.int64, device=device)
    for k, stride in keys:
        code = code + k.long() * int(stride)
    return code


def group_agg_plain(keys: Sequence[Tuple[torch.Tensor, int]], cap: int,
                    mask: Optional[torch.Tensor], outputs: Sequence[Output]) -> torch.Tensor:
    """Plain torch version of :func:`group_agg` (the same inputs and the
    same ``(len(outputs), cap)`` int64 result), without the de-duplication."""
    n, dev = _check(keys, cap, mask, outputs)
    code = composite_code(keys, n, dev)
    keep = (code >= 0) & (code < cap)
    if mask is not None:
        keep = keep & mask
    seg = torch.where(keep, code, cap)  # cap: the trash group
    out = torch.zeros((len(outputs), cap + 1), dtype=torch.int64, device=dev)
    ones = None
    for row, (v, valid) in zip(out, outputs):
        if v is None:
            if ones is None:
                ones = torch.ones(n, dtype=torch.int64, device=dev)
            v = ones
        row.index_add_(0, seg if valid is None else torch.where(valid, seg, cap), v.long())
    return out[:, :cap].contiguous()


def _launch(keys, cap: int, mask, outputs: Sequence[Output], n: int,
            dev: torch.device) -> torch.Tensor:
    """K6 on CUDA inputs (checked by the caller): the (len(outputs), cap)
    sums."""
    out = torch.zeros((len(outputs), cap), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    ptrs = [t.data_ptr() for t, _s in keys] + [mask.data_ptr() if mask is not None else 0]
    ptrs += [t.data_ptr() for o in outputs for t in o if t is not None]
    vec = int(all(p % 16 == 0 for p in ptrs))
    pad = K6_MAX_KEYS - len(keys)
    key_part = ([t.data_ptr() for t, _s in keys] + [0] * pad
                + [int(s) for _t, s in keys] + [0] * pad)
    key64 = sum(1 << i for i, (t, _s) in enumerate(keys) if t.dtype == torch.int64)
    fn = _build.entry("group_agg", "sb_group_agg", _ENTRY_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi, bound in plan_launches(cap, len(outputs)):
            part = outputs[lo:hi]
            pad = K6_MAX_OUT - len(part)
            vals = [0 if v is None else v.data_ptr() for v, _m in part] + [0] * pad
            valid = [0 if m is None else m.data_ptr() for _v, m in part] + [0] * pad
            val64 = sum(1 << i for i, (v, _m) in enumerate(part)
                        if v is not None and v.dtype == torch.int64)
            args = _ARGS.pack(
                *key_part, *vals, *valid, 0 if mask is None else mask.data_ptr(),
                out[lo].data_ptr(), n, len(keys), len(part), cap, key64, val64, vec)
            err = fn(args, _ARGS.size, 0 if bound else 1, bound, stream)
            if err != 0:
                raise RuntimeError(f"group_agg kernel launch failed: cudaError {err}")
            obs.count("k6.launches")
    return out


def group_agg(keys: Sequence[Tuple[torch.Tensor, int]], cap: int,
              mask: Optional[torch.Tensor], outputs: Sequence[Output]) -> torch.Tensor:
    """K6: ``(len(outputs), cap)`` int64, row ``i`` the per-group sums of
    ``outputs[i]``.  ``keys`` ``[(codes, stride)]``, codes int32 or int64
    (none: every row in group 0); ``mask`` and each validity bool or None;
    each values int32 or int64, or None for a count.  Every tensor 1-D,
    one length, one device, contiguous; ``1 <= cap <= K6_MAX_GROUPS``; else
    it raises.  Outputs whose ``(values, validity)`` are the same tensors
    are computed once."""
    keys, outputs = list(keys), list(outputs)
    n, dev = _check(keys, cap, mask, outputs)
    index, distinct, rows = {}, [], []
    for v, valid in outputs:
        key = (None if v is None else id(v), None if valid is None else id(valid))
        if key not in index:
            index[key] = len(distinct)
            distinct.append((v, valid))
        rows.append(index[key])
    if dev.type == "cpu":
        out = group_agg_plain(keys, cap, mask, distinct)
    else:
        out = _launch(keys, cap, mask, distinct, n, dev)
    if len(distinct) == len(rows):
        return out
    return torch.stack([out[r] for r in rows])
