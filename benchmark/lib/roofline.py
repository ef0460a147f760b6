"""Peaks of the card and the bytes a kernel or a query must move.

NVIDIA's data sheet for the H100 SXM (80 GB HBM3, 700 W): 3.35 TB/s of
HBM bandwidth.  Every share below is taken against that peak.
"""

from __future__ import annotations

from typing import Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12


def k1_bytes(planes: Iterable[Tuple[int, int, int]]) -> int:
    """Bytes K1 must move for planes of ``(n_tiles, bits, tile)`` words:
    each 32 values read as ``bits`` words and written as 32 int32 values,
    ``(bits + 32) * 4`` bytes for each lane of each tile."""
    return sum(n * t * (b + 32) * 4 for n, b, t in planes)


def plane_bytes(planes: Iterable[Tuple[int, int, int]]) -> int:
    """The packed words of planes of ``(n_tiles, bits, tile)``, in bytes:
    what a query over them must read once."""
    return sum(n * b * t * 4 for n, b, t in planes)


def share(byte_count: float, seconds: float):
    """Percent of the HBM peak that moving ``byte_count`` in ``seconds``
    reaches; None when there is no time to divide by."""
    if seconds <= 0:
        return None
    return 100.0 * byte_count / HBM_BYTES_PER_S / seconds
