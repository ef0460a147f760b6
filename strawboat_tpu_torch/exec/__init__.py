"""Query execution over resident tables and scanned files on torch tensors."""

from .aggregate import dense_group_sum  # noqa: F401
from .expr import col, lit  # noqa: F401
from .query import Query  # noqa: F401
from .resident import ResidentTable, make_resident  # noqa: F401
from .scan import DeviceColumn, DeviceTable, scan_file  # noqa: F401
