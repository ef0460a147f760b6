"""Query execution over resident tables and scanned files on torch tensors."""

from .aggregate import dense_group_sum, hash_aggregate, scalar_aggregate  # noqa: F401
from .expr import col, lit  # noqa: F401
from .join import hash_join  # noqa: F401
from .query import Query  # noqa: F401
from .resident import ResidentTable, load_resident, make_resident  # noqa: F401
from .scan import DeviceColumn, DeviceTable, scan_file  # noqa: F401
from .sort import sort_table, take_table  # noqa: F401
