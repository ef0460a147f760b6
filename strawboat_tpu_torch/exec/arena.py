"""Pooled host staging buffers for the raw-page feed of the scan.

Counterpart of ``strawboat_tpu/exec/arena.py``.  Raw pages decompress
straight into a pooled host buffer (page-locked on a CUDA host, so the
copy to the card runs asynchronously), one chunk of about 32 MB at a time
(``exec/scan.py``, ``_decode_raw_column_streamed``); the chunk's copy to
the device is queued on a side stream and records an event.  A buffer goes
back to the pool with the events of the copies that read from it, and is
handed out again only once every one of them has completed (the
reference's ``block_until_ready`` in ``acquire``), so a buffer is never
overwritten while a copy from it is in flight.

While a buffer's copies run, :func:`acquire` hands out another free one or
allocates a new one, up to :data:`MAX_POOLED` buffers; past that it waits
for the oldest copies.  So the next chunk's decompression overlaps the
previous chunk's copy, and page-locked memory stays bounded by the pool.
"""

from __future__ import annotations

import threading
from typing import List, Sequence

import torch

MAX_POOLED = 4  # buffers kept, and at most this many chunks in flight
MIN_BYTES = 1 << 20  # the smallest buffer allocated

_lock = threading.Lock()
_pool: List[list] = []  # [buffer (uint8 tensor), events of copies reading it]


def _drop(entry) -> None:
    """Take ``entry`` out of the pool (by identity: entries hold tensors)."""
    _pool[:] = [e for e in _pool if e is not entry]


def _idle(events) -> bool:
    return all(e.query() for e in events)


def acquire(nbytes: int, pin: bool) -> torch.Tensor:
    """A uint8 host tensor of exactly ``nbytes`` (a view of a pooled buffer
    at least that large), page-locked when ``pin``.  No copy from it is in
    flight: a free pooled buffer first, else a new one while the pool has
    room, else the smallest large enough after waiting for its copies."""
    with _lock:
        fits = [e for e in _pool if e[0].numel() >= nbytes and e[0].is_pinned() == pin]
        free = [e for e in fits if _idle(e[1])]
        if not free and len(_pool) < MAX_POOLED:
            fits = []  # room for one more: allocate rather than wait
        pick = min(free or fits, key=lambda e: e[0].numel(), default=None)
        if pick is not None:
            _drop(pick)
    if pick is None:
        return torch.empty(max(nbytes, MIN_BYTES), dtype=torch.uint8, pin_memory=pin)[:nbytes]
    for e in pick[1]:
        if not e.query():
            e.synchronize()
    return pick[0][:nbytes]


def release(buf: torch.Tensor, events: Sequence) -> None:
    """Return a buffer from :func:`acquire` with the events (``query()`` /
    ``synchronize()``) of every copy that reads from it.  A full pool keeps
    the larger buffers."""
    base = buf._base if buf._base is not None else buf
    with _lock:
        _pool.append([base, list(events)])
        if len(_pool) > MAX_POOLED:
            _drop(min(_pool, key=lambda e: e[0].numel()))


def pooled_bytes() -> int:
    """Host bytes the pool holds."""
    with _lock:
        return sum(e[0].numel() for e in _pool)


def clear() -> None:
    with _lock:
        _pool.clear()
