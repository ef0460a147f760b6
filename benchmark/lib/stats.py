"""Spreads of repeated runs, by which the bounds are set."""

from __future__ import annotations

import statistics
from typing import Sequence


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile, as
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    if len(values) < 2:
        return 0.0
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / abs(med) if med else float("inf")


def spread_without_farthest(values: Sequence[float]) -> float:
    """:func:`spread` once the value farthest from the median is left out."""
    if len(values) < 3:
        return spread(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])
