"""Equi-join: sort the build side, binary-search the probe keys.

Counterpart of ``strawboat_tpu/exec/join.py``.  The build keys are sorted
once (stable), every probe key finds its run of equal build keys with two
``searchsorted`` calls, and runs expand up to a fan-out; a longer run
grows the fan-out and re-runs, never truncating silently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import widen_i64
from ..errors import CapacityError
from .scan import unsigned_view


def _join_indices(
    build_keys: torch.Tensor,
    probe_keys: torch.Tensor,
    max_fanout: int,
    build_valid: Optional[torch.Tensor] = None,
):
    """Inner-join row indices.

    Returns (probe_idx, build_idx, valid, max_run), each array of
    ``n_probe * max_fanout`` (probe_idx int32 and build_idx int64, as the
    reference's): for every probe row, up to ``max_fanout`` matching build
    rows.  ``max_run`` is the largest match
    count of any probe key; above ``max_fanout`` matches were cut and the
    caller re-runs (``hash_join`` does).  Both key columns are cast to
    their promoted dtype first, as the reference's ``searchsorted``
    promotes int32 against int64.  With ``build_valid`` only the valid
    build rows enter the sort (no in-band sentinel), so ``max_run`` counts
    valid rows only: the reference sorts null and padding rows with the
    rest, and a probe key equal to theirs grows its fan-out to their count.
    The valid rows keep their order, so each probe row's matches come in
    the reference's order."""
    if build_valid is not None:
        rows = torch.nonzero(build_valid).squeeze(1)
        pi, bi, valid, run = _join_indices(build_keys[rows], probe_keys, max_fanout)
        return pi, (rows[bi] if rows.numel() else bi), valid, run
    dt = torch.promote_types(build_keys.dtype, probe_keys.dtype)
    build_keys, probe_keys = build_keys.to(dt), probe_keys.to(dt)
    order = torch.sort(build_keys, stable=True).indices
    sk = build_keys[order]
    lo = torch.searchsorted(sk, probe_keys, side="left", out_int32=True)
    hi = torch.searchsorted(sk, probe_keys, side="right", out_int32=True)
    n_probe = probe_keys.shape[0]
    k = torch.arange(max_fanout, dtype=lo.dtype, device=lo.device)
    idx = lo[:, None] + k[None, :]  # (n_probe, max_fanout)
    valid = idx < hi[:, None]
    idx = idx.clamp(0, max(sk.shape[0] - 1, 0))
    build_idx = order[idx] if sk.shape[0] else idx.long()
    probe_idx = torch.arange(n_probe, dtype=lo.dtype, device=lo.device)[:, None].expand(idx.shape)
    max_run = (hi - lo).max() if n_probe else torch.zeros((), dtype=lo.dtype)
    return probe_idx.reshape(-1), build_idx.reshape(-1), valid.reshape(-1), max_run


def hash_join(
    probe_table,
    build_table,
    on: Tuple[str, str],
    max_fanout: int = 1,
    probe_mask: Optional[torch.Tensor] = None,
    on_overflow: str = "grow",
):
    """Inner equi-join; returns the (probe_idx, build_idx, valid) selection.

    ``max_fanout`` bounds duplicate build keys per probe row (1 = unique
    build keys, the dimension join).  Null keys never match.  When a build
    key repeats more than ``max_fanout`` times, ``on_overflow="grow"``
    re-runs at the next power of two at or above the longest run;
    ``"raise"`` raises :class:`CapacityError`."""
    pk = probe_table[on[0]]
    bk = build_table[on[1]]

    def keys(c):
        # an unsigned 16/32-bit view compares by value, as the reference's
        # promotion of uint32 against int64 does
        if unsigned_view(c) and c.values.element_size() < 8:
            return widen_i64(c.values, True)
        return c.values

    fanout = max_fanout
    while True:
        pi, bi, valid, max_run = _join_indices(keys(bk), keys(pk), fanout, bk.validity)
        need = int(max_run)
        if need <= fanout:
            break
        if on_overflow == "raise":
            raise CapacityError("join fan-out", fanout, need)
        fanout = 1 << (need - 1).bit_length()
    pv = pk.validity
    if probe_mask is not None:
        pv = probe_mask if pv is None else (pv & probe_mask)
    if pv is not None:
        valid = valid & torch.repeat_interleave(pv, fanout)
    return pi, bi, valid
