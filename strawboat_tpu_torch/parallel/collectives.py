"""Sharded tensors and the collectives of the single-process mesh.

The port's stand-in for ``shard_map``'s data model and collectives.  A
:class:`ShardedTensor` is a tensor split along dim 0 into equal shards,
shard ``i`` on the ``i``-th device of the mesh axis; per-shard work runs
as a loop over the shards.  The collectives move whole contiguous bins
with device copies (``Tensor.copy_``, asynchronous on CUDA), never row by
row:

* :func:`all_to_all` — shard ``s``'s bin ``d`` goes to shard ``d``, the
  bins concatenated in source order (``jax.lax.all_to_all(...,
  split_axis=0, concat_axis=0, tiled=True)``);
* :func:`psum` — the shards' values summed on the first shard's device,
  the sum copied to every shard (``jax.lax.psum``).

Inside :func:`record_exchanges` each collective records its bytes and its
time (CUDA events on the first shard's device; the host clock on the
CPU), which :func:`exchange_summary` reads.
"""

from __future__ import annotations

import contextlib
import operator
import time
from typing import List, Optional, Sequence

import torch


class ShardedTensor:
    """A tensor split along dim 0 into shards, one per device of a mesh
    axis, in shard order.  Elementwise arithmetic and comparisons run
    shard by shard (with another ``ShardedTensor`` of the same split or a
    scalar); :func:`concat_shards` puts the shards back together."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = tuple(shards)

    def __len__(self) -> int:
        return sum(int(s.shape[0]) for s in self.shards)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((len(self),) + tuple(self.shards[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def map(self, fn, *others) -> "ShardedTensor":
        """``fn`` applied shard by shard; each of ``others`` is a
        ``ShardedTensor`` (its shard of the same index is passed) or a
        scalar (passed as it is)."""
        n = len(self.shards)
        cols = [o.shards if isinstance(o, ShardedTensor) else (o,) * n for o in others]
        return ShardedTensor(fn(*args) for args in zip(self.shards, *cols))

    def to(self, dtype: torch.dtype) -> "ShardedTensor":
        return self.map(lambda t: t.to(dtype))

    def long(self) -> "ShardedTensor":
        return self.to(torch.int64)

    def __invert__(self) -> "ShardedTensor":
        return self.map(operator.invert)

    def __repr__(self) -> str:
        return f"ShardedTensor({[tuple(s.shape) for s in self.shards]}, {self.dtype})"


def _binary(op, reflected: bool):
    if reflected:
        return lambda self, other: self.map(lambda a, b: op(b, a), other)
    return lambda self, other: self.map(op, other)


for _name, _op in (("add", operator.add), ("sub", operator.sub), ("mul", operator.mul),
                   ("mod", operator.mod), ("floordiv", operator.floordiv),
                   ("truediv", operator.truediv), ("and", operator.and_),
                   ("or", operator.or_), ("xor", operator.xor)):
    setattr(ShardedTensor, f"__{_name}__", _binary(_op, False))
    setattr(ShardedTensor, f"__r{_name}__", _binary(_op, True))
for _name in ("eq", "ne", "lt", "le", "gt", "ge"):
    setattr(ShardedTensor, f"__{_name}__", _binary(getattr(operator, _name), False))
ShardedTensor.__hash__ = None


def shard(mesh, axis: str, x) -> ShardedTensor:
    """``x`` split over ``mesh``'s ``axis``: a ``ShardedTensor`` of that
    many shards stays as it is, a global tensor (or numpy array) is cut
    along dim 0 into equal shards (its length must divide), each moved to
    its shard's device."""
    devs = mesh.axis_devices(axis)
    if isinstance(x, ShardedTensor):
        if len(x.shards) != len(devs):
            raise ValueError(f"{len(x.shards)} shards on a mesh axis of {len(devs)}")
        return x
    t = torch.as_tensor(x)
    n = int(t.shape[0])
    if n % len(devs):
        raise ValueError(f"{n} rows do not split evenly over {len(devs)} shards")
    return ShardedTensor(c.to(d) for c, d in zip(torch.split(t, n // len(devs)), devs))


def concat_shards(x: ShardedTensor, device=None) -> torch.Tensor:
    """The shards concatenated in shard order on ``device`` (default: the
    first shard's)."""
    dev = x.shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in x.shards])


def max_to_host(values: Sequence[torch.Tensor], device: torch.device) -> int:
    """The largest of the shards' 0-d values, read on the host once: the
    one sync a capacity check costs."""
    return int(torch.stack([v.to(device).reshape(()).to(torch.int64) for v in values]).max())


# ---------------------------------------------------------------------------
# exchange records

_records: Optional[list] = None


@contextlib.contextmanager
def record_exchanges():
    """Record every collective run inside: ``with record_exchanges() as
    recs: ...``, then :func:`exchange_summary(recs) <exchange_summary>`."""
    global _records
    outer, _records = _records, []
    try:
        yield _records
    finally:
        _records = outer


class _Span:
    def __init__(self, op: str, device: torch.device, read: int, write: int):
        self.op, self.read_bytes, self.write_bytes = op, read, write
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.current_stream(device)
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        else:
            self.t0 = time.perf_counter()

    def close(self) -> None:
        if self.cuda:
            self.end.record(self.stream)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3
        _records.append(self)


def _span(op: str, device: torch.device, read: int, write: int) -> Optional[_Span]:
    return None if _records is None else _Span(op, device, read, write)


def exchange_summary(records) -> List[dict]:
    """``[{"op", "read_bytes", "write_bytes", "ms"}]`` of recorded
    collectives (CUDA spans are synchronized first)."""
    out = []
    for r in records:
        if r.cuda:
            r.end.synchronize()
            ms = r.start.elapsed_time(r.end)
        else:
            ms = r.ms
        out.append({"op": r.op, "read_bytes": r.read_bytes, "write_bytes": r.write_bytes,
                    "ms": ms})
    return out


# ---------------------------------------------------------------------------
# collectives


def all_to_all(bins: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``bins[s]`` is shard ``s``'s ``(P, cap, ...)`` send buffer on
    ``devices[s]``; shard ``d`` receives ``(P * cap, ...)``: bin ``d`` of
    every shard, in source order.  One copy of each whole bin."""
    n = len(bins)
    total = sum(b.numel() * b.element_size() for b in bins)
    span = _span("all_to_all", devices[0], total, total)
    out = []
    for d in range(n):
        recv = torch.empty((n * bins[0].shape[1],) + tuple(bins[0].shape[2:]),
                           dtype=bins[0].dtype, device=devices[d])
        for s, b in enumerate(bins):
            recv[s * b.shape[1] : (s + 1) * b.shape[1]].copy_(b[d], non_blocking=True)
        out.append(recv)
    if span is not None:
        span.close()
    return out


def psum(values: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of every shard's ``values`` (same shape and dtype), reduced
    on ``devices[0]`` and copied to each shard's device."""
    nbytes = values[0].numel() * values[0].element_size()
    others = len({d for d in devices} - {devices[0]})
    span = _span("psum", devices[0], len(values) * nbytes, (1 + others) * nbytes)
    if len(values) == 1:
        total = values[0]
    else:
        total = torch.stack([v.to(devices[0], non_blocking=True) for v in values]).sum(
            0, dtype=values[0].dtype)
    copies = {devices[0]: total}
    for d in devices:
        if d not in copies:
            copies[d] = total.to(d, non_blocking=True)
    out = [copies[d] for d in devices]
    if span is not None:
        span.close()
    return out
