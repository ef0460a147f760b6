"""Multi-device scale-out over a mesh of shards.

Counterpart of ``strawboat_tpu/parallel/``: tables are hash-partitioned
across the mesh's shards, scans decode locally, repartitioning rides
``all_to_all`` with salted keys for skew, partial aggregates combine
through a second keyed exchange, and resident planes shard by tile.
Without a ``torch.distributed`` world the mesh is the torch counterpart
of JAX's single-controller ``shard_map``: one process, one
``torch.device`` a shard (``mesh.py``), per-shard work in a loop,
collectives as device copies (``collectives.py``).  Inside a world
(``distributed_init``, or ``torchrun``) the mesh spans the processes,
one card each: a process holds and works on its own shards only, the
collectives cross processes through the process group, and every host
decision is agreed by all of them.  ``dryrun.py`` builds its own
single-process mesh.  Every entry takes its mesh or device explicitly.
"""

from .collectives import ShardedTensor, all_to_all, concat_shards, pmax, psum, shard  # noqa: F401
from .mesh import Mesh, distributed_init, make_mesh  # noqa: F401
from .shuffle import hash_partition_ids, shuffle_by_key  # noqa: F401
from .dist_agg import distributed_aggregate  # noqa: F401
from .pipeline import pipelined_distributed_aggregate, streamed_dataset_aggregate  # noqa: F401
from .dist_join import distributed_join  # noqa: F401
from .dist_scan import (  # noqa: F401
    distributed_scan,
    distributed_scan_dataset,
    local_shard_table,
)
from .dist_resident import (  # noqa: F401
    load_sharded_resident,
    shard_resident,
    sharded_filter_sum,
    sharded_group_sum,
    sharded_keyed_aggregate,
)
