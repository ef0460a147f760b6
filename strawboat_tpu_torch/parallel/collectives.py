"""Sharded tensors and the collectives of the mesh.

The port's stand-in for ``shard_map``'s data model and collectives.  A
:class:`ShardedTensor` is a tensor split along dim 0 into equal shards,
shard ``i`` on the ``i``-th device of the mesh axis; per-shard work runs
as a loop over the shards this process holds.  The collectives move whole
contiguous bins with device copies (``Tensor.copy_``, asynchronous on
CUDA), never row by row:

* :func:`all_to_all` — shard ``s``'s bin ``d`` goes to shard ``d``, the
  bins concatenated in source order (``jax.lax.all_to_all(...,
  split_axis=0, concat_axis=0, tiled=True)``);
* :func:`psum` — the shards' values summed on the first shard's device,
  the sum copied to every shard (``jax.lax.psum``).

Inside a ``torch.distributed`` world (``mesh.py``) a process holds only
its own shards: bins between them still move by device copy, the bins
for other processes in one ``all_to_all_single`` a call, and a ``psum``
adds one ``all_reduce`` of the local sum.  Every host decision the
layer takes from device values (:func:`max_to_host`, :func:`sum_to_host`,
:func:`gather_objects`) is taken on every process alike.

Each collective is a ``util/obs.py`` span, ``strawboat.exchange.<op>``,
with its bytes as counts (``exchange.read_bytes``, ``.write_bytes``,
``.crossed_bytes``) and CUDA events on the first shard's device (the
host clock on the CPU), and each process-group call one of its own;
:func:`record_exchanges` records them and :func:`exchange_summary` reads
them.
"""

from __future__ import annotations

import contextlib
import operator
from typing import List, Sequence

import torch

from ..util import obs
from .mesh import world


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
    """``x`` split over ``mesh``'s ``axis``: a ``ShardedTensor`` of this
    process's shards stays as it is, a global tensor (or numpy array) is
    cut along dim 0 into equal shards (its length must divide) and this
    process's shards are moved to their devices."""
    devs = mesh.axis_devices(axis)
    if isinstance(x, ShardedTensor):
        if len(x.shards) != len(devs):
            raise ValueError(f"{len(x.shards)} shards on a mesh axis of {len(devs)}")
        return x
    t = torch.as_tensor(x)
    n, n_shards = int(t.shape[0]), mesh.axis_size(axis)
    if n % n_shards:
        raise ValueError(f"{n} rows do not split evenly over {n_shards} shards")
    pieces = torch.split(t, n // n_shards)[mesh.first_shard : mesh.first_shard + len(devs)]
    return ShardedTensor(c.to(d) for c, d in zip(pieces, devs))


def concat_shards(x: ShardedTensor, device=None) -> torch.Tensor:
    """The shards (this process's) concatenated in shard order on
    ``device`` (default: the first shard's)."""
    dev = x.shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(dev) for s in x.shards])


def max_to_host(values: Sequence[torch.Tensor], device: torch.device) -> int:
    """The largest of the shards' 0-d values, read on the host once: the
    one sync a capacity check costs.  In a world it is the largest of
    every process's shards (one ``all_reduce``), so every process takes
    the same decision."""
    m = torch.stack([v.to(device).reshape(()).to(torch.int64) for v in values]).max()
    if world() is not None:
        m = _all_reduce(m, torch.distributed.ReduceOp.MAX)
    return int(m)


def sum_to_host(n: int, device: torch.device) -> int:
    """``n`` summed over the world's processes (``n`` itself outside a
    world)."""
    if world() is None:
        return n
    return int(_all_reduce(torch.tensor(n, dtype=torch.int64, device=device),
                           torch.distributed.ReduceOp.SUM))


def gather_objects(obj) -> list:
    """Every process's ``obj``, in rank order (``[obj]`` outside a world):
    host metadata such as dictionaries and row counts, pickled."""
    w = world()
    if w is None:
        return [obj]
    out = [None] * w[1]
    torch.distributed.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# exchange records: ``util/obs.py`` spans named ``strawboat.exchange.<op>``
# (CUDA events on the device given), their bytes as counts

EXCHANGE = "strawboat.exchange."
_BYTES = ("read_bytes", "write_bytes", "crossed_bytes")


@contextlib.contextmanager
def record_exchanges():
    """Record every collective run inside: ``with record_exchanges() as
    recs: ...``, then :func:`exchange_summary(recs) <exchange_summary>`
    (``recs`` fills when the block ends, in the order the collectives
    finished)."""
    recs: list = []
    with obs.recording() as rec:
        yield recs
    recs.extend(rec.spans(EXCHANGE))


@contextlib.contextmanager
def _exchange(op: str, device: torch.device, read: int, write: int, crossed: int = 0):
    with obs.span(EXCHANGE + op, device=device):
        for name, n in zip(_BYTES, (read, write, crossed)):
            obs.count("exchange." + name, n)
        yield


def exchange_summary(records) -> List[dict]:
    """``[{"op", "read_bytes", "write_bytes", "crossed_bytes", "ms"}]`` of
    recorded collectives (CUDA spans are synchronized first).  A
    collective's record counts the bytes its device copies read and
    write; a process-group call's (``op`` the ``torch.distributed``
    function) counts ``crossed_bytes``: what this process sent to the
    others (``all_to_all_single``) or the buffer it reduced with them
    (``all_reduce``), 0 in a world of one."""
    out = []
    for r in records:
        ms = r.device_ms
        out.append({"op": r.name[len(EXCHANGE):],
                     **{k: r.counts.get("exchange." + k, 0) for k in _BYTES},
                     "ms": r.seconds * 1e3 if ms is None else ms})
    return out


def _all_reduce(t: torch.Tensor, op) -> torch.Tensor:
    """``t`` reduced in place over the world, recorded as a process-group
    call (its event on the current stream after the call returns: the
    backend has made that stream wait on its own)."""
    size = torch.distributed.get_world_size()
    with _exchange("all_reduce", t.device, 0, 0, t.numel() * t.element_size() * (size > 1)):
        torch.distributed.all_reduce(t, op=op)
    return t


# ---------------------------------------------------------------------------
# collectives


def all_to_all(bins: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``bins[s]`` is shard ``s``'s ``(P, cap, ...)`` send buffer on
    ``devices[s]`` (``P`` the mesh's global shard count); shard ``d``
    receives ``(P * cap, ...)``: bin ``d`` of every shard, in source
    order.  One copy of each whole bin between this process's shards; in
    a world, the bins for other processes in one ``all_to_all_single``."""
    n = len(bins)
    total = sum(b.numel() * b.element_size() for b in bins)
    with _exchange("all_to_all", devices[0], total, total):
        w = world()
        if w is None:
            out = []
            for d in range(n):
                recv = torch.empty((n * bins[0].shape[1],) + tuple(bins[0].shape[2:]),
                                   dtype=bins[0].dtype, device=devices[d])
                for s, b in enumerate(bins):
                    recv[s * b.shape[1] : (s + 1) * b.shape[1]].copy_(b[d], non_blocking=True)
                out.append(recv)
        else:
            out = _all_to_all_world(bins, *w)
    return out


def _all_to_all_world(bins, rank: int, size: int) -> List[torch.Tensor]:
    """:func:`all_to_all` in a world: the ``k`` local shards' bins, all on
    this process's device.  Received bins land in ``(k_dst, size, k_src,
    cap, ...)``, which is source order for each destination."""
    k = len(bins)
    cap, rest = bins[0].shape[1], tuple(bins[0].shape[2:])
    stacked = torch.stack(bins)  # (k_src, P, cap, ...)
    if stacked.dtype == torch.bool:  # one byte a flag on every backend
        return [o.bool() for o in _all_to_all_world([b.view(torch.uint8) for b in bins],
                                                   rank, size)]
    recv = torch.empty((k, size, k, cap) + rest, dtype=stacked.dtype, device=stacked.device)
    mine = stacked[:, rank * k : (rank + 1) * k]  # (k_src, k_dst, cap, ...)
    recv[:, rank].copy_(mine.transpose(0, 1), non_blocking=True)
    if size > 1:
        others = [q for q in range(size) if q != rank]
        # the send buffer by destination rank: (size - 1, k_src, k_dst, cap, ...)
        send = stacked.view((k, size, k, cap) + rest).transpose(0, 1)[others].contiguous()
        got = torch.empty_like(send)
        splits = [0 if q == rank else k * k * cap for q in range(size)]
        with _exchange("all_to_all_single", stacked.device, 0, 0,
                       send.numel() * send.element_size()):
            torch.distributed.all_to_all_single(got.view((-1,) + rest), send.view((-1,) + rest),
                                                splits, splits)
        recv[:, others] = got.permute((2, 0, 1) + tuple(range(3, got.dim())))
    return list(recv.view((k, size * k * cap) + rest).unbind(0))


def psum(values: Sequence[torch.Tensor], devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of every shard's ``values`` (same shape and dtype), reduced
    on ``devices[0]`` and copied to each shard's device; in a world, the
    local sum then one ``all_reduce`` over the processes."""
    nbytes = values[0].numel() * values[0].element_size()
    others = len({d for d in devices} - {devices[0]})
    with _exchange("psum", devices[0], len(values) * nbytes, (1 + others) * nbytes):
        if len(values) == 1:
            total = values[0]
        else:
            total = torch.stack([v.to(devices[0], non_blocking=True) for v in values]).sum(
                0, dtype=values[0].dtype)
        if world() is not None:
            total = _all_reduce(total.clone() if len(values) == 1 else total,
                                torch.distributed.ReduceOp.SUM)
        copies = {devices[0]: total}
        for d in devices:
            if d not in copies:
                copies[d] = total.to(d, non_blocking=True)
        out = [copies[d] for d in devices]
    return out
