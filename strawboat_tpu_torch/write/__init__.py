"""Writing strawboat files from numpy columns (flat integer types)."""

from .writer import write_file  # noqa: F401
