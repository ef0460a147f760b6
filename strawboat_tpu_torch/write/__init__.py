"""Writing strawboat files from numpy columns, the column model
(``columns.py``) or a ``pa.Table``, flat and nested."""

from .writer import NativeWriter, write_file  # noqa: F401
