"""Mesh construction and the multi-process bootstrap.

Counterpart of ``strawboat_tpu/parallel/mesh.py``.  The port's mesh is a
single-process one, the torch counterpart of JAX's single-controller
``shard_map``: one process holds an ordered grid of ``torch.device``s, one
per shard (a device may repeat), runs each shard's work in a loop and
moves data between shards with device copies (``collectives.py``).  Four
shards on one card run the whole algorithm on that card; with several
cards, ``"cuda:all"`` puts shard ``i`` on card ``i % device_count``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..device import as_device, require_cuda
from ..errors import NotYetImplementedError

_ACROSS_PROCESSES = (
    "a mesh across processes (ROADMAP.md queue 1, 'Multi-device': the "
    "process-group backend of the collectives)"
)


@dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: a numpy object array of ``torch.device``, one per shard,
    shaped like the JAX mesh; ``axis_names`` names its axes."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices of the shards along ``axis``, in order (the first
        index of every other axis: data split over ``axis`` is the same
        along the others, as ``PartitionSpec(axis)`` replicates it)."""
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
    ``make_mesh`` reshapes its devices.  Inside a ``torch.distributed``
    world of more than one process it raises: each process would hold only
    its own shards."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be at least 1, got {n_shards}")
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotYetImplementedError(_ACROSS_PROCESSES)
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
) -> None:
    """Join a ``torch.distributed`` world, the bootstrap of a deployment
    over processes (the reference's ``jax.distributed.initialize``): nccl
    for a CUDA ``device``, gloo for the CPU; ``coordinator_address`` is
    ``host:port`` (taken as ``tcp://host:port``) or a full init URL such
    as ``file:///path``.  The mesh functions run inside one process: a
    world of more than one makes ``make_mesh`` raise."""
    dev = as_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    torch.distributed.init_process_group(backend, init_method=init, world_size=num_processes,
                                         rank=process_id)

