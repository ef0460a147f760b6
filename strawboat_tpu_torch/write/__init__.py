"""Writing strawboat files from numpy columns and the column model
(``columns.py``), flat and nested."""

from .writer import write_file  # noqa: F401
