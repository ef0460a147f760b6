"""Mesh construction and the multi-process bootstrap.

Counterpart of ``strawboat_tpu/parallel/mesh.py``.  A mesh is an ordered
row of shards, one ``torch.device`` each (a device may repeat).  Without
a ``torch.distributed`` world it is a single-process one, the torch
counterpart of JAX's single-controller ``shard_map``: the process holds
every shard, runs each shard's work in a loop and moves data between
shards with device copies (``collectives.py``).  Four shards on one card
run the whole algorithm on that card; with several cards, ``"cuda:all"``
puts shard ``i`` on card ``i % device_count``.

Inside a world of ``W`` processes (:func:`distributed_init`, or
``torchrun``) the mesh spans the processes, as the JAX mesh spans
``jax.devices()`` after ``jax.distributed.initialize``: process ``r``
holds shards ``r·k … r·k+k−1`` (``k = n_shards / W``), all on its own
device, and the collectives cross processes through the process group.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import as_device, require_cuda


def world() -> Optional[Tuple[int, int]]:
    """``(rank, world size)`` of the ``torch.distributed`` world this
    process belongs to, or None outside one."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_rank(), dist.get_world_size()


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``, one per shard
    this process holds, shaped like the JAX mesh; ``axis_names`` names its
    axes.  A mesh over a world of ``processes`` processes has one axis, and
    this process's shards start at global shard ``first_shard``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    first_shard: int = 0
    processes: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        """The global shape: every process's shards."""
        dims = list(self.devices.shape)
        dims[0] *= self.processes
        return dict(zip(self.axis_names, dims))

    def axis_size(self, axis: str) -> int:
        """The global number of shards along ``axis``."""
        return self.shape[axis]

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices of this process's shards along ``axis``, in order
        (the first index of every other axis: data split over ``axis`` is
        the same along the others, as ``PartitionSpec(axis)`` replicates
        it)."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for k in range(self.devices.shape[i]):
            index[i] = k
            out.append(self.devices[tuple(index)])
        return tuple(out)


def _split_dims(n: int, n_axes: int) -> list:
    """The device count split as evenly as possible over the leading axes
    (JAX ``mesh.py:21-32``)."""
    dims = [1] * n_axes
    rem = n
    for i in range(n_axes - 1):
        d = 1
        while rem % 2 == 0 and d * 2 * int(np.prod(dims)) <= n:
            d *= 2
            rem //= 2
        dims[i] = d
    dims[-1] = n // int(np.prod(dims[:-1]))
    return dims


def make_mesh(n_shards: int, device, axis_names: Sequence[str] = ("shards",)) -> Mesh:
    """A mesh of ``n_shards`` shards.  ``device`` is ``"cpu"`` or one card
    (``"cuda"``, ``"cuda:1"``, a ``torch.device``), where every shard
    lives, or ``"cuda:all"``: shard ``i`` on card ``i % device_count``.
    With several ``axis_names`` the shards are reshaped as the JAX
    ``make_mesh`` reshapes its devices.

    Inside a ``torch.distributed`` world of ``W`` processes, ``W`` must
    divide ``n_shards``: this process holds its ``n_shards / W`` shards,
    all on ``device`` (each process names its own card, so ``"cuda:all"``
    raises), on one axis."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be at least 1, got {n_shards}")
    w = world()
    if w is not None:
        rank, size = w
        if n_shards % size:
            raise ValueError(f"{n_shards} shards do not split over a world of {size} processes")
        if device == "cuda:all":
            raise ValueError("inside a torch.distributed world each process names its own card")
        if len(axis_names) > 1:
            raise ValueError("a mesh across processes has one axis")
        k = n_shards // size
        arr = np.empty(k, dtype=object)
        arr[:] = [as_device(device)] * k
        return Mesh(arr, tuple(axis_names), first_shard=rank * k, processes=size)
    if device == "cuda:all":
        require_cuda()
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", i % count) for i in range(n_shards)]
    else:
        devs = [as_device(device)] * n_shards
    arr = np.empty(n_shards, dtype=object)
    arr[:] = devs
    if len(axis_names) > 1:
        arr = arr.reshape(_split_dims(n_shards, len(axis_names)))
    return Mesh(arr, tuple(axis_names))


def distributed_init(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> None:
    """Join a ``torch.distributed`` world, the bootstrap of a deployment
    over processes (the reference's ``jax.distributed.initialize``).

    ``backend`` None takes nccl for a CUDA ``device`` and gloo for the
    CPU; ``"gloo"`` with a CUDA device is allowed (its collectives stage
    CUDA tensors through host memory; NCCL refuses two ranks on one card).
    ``coordinator_address`` is ``host:port`` (taken as ``tcp://host:port``)
    or a full init URL such as ``file:///path`` or ``env://`` (torchrun's
    environment).  ``timeout`` (seconds) bounds each collective, so that a
    rank whose peers are gone fails instead of waiting for ever.  The CUDA
    ``device`` becomes the process's current device."""
    dev = as_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    torch.distributed.init_process_group(backend, init_method=init, world_size=num_processes,
                                         rank=process_id, **kwargs)
