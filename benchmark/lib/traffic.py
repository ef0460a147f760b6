"""The general traffic generator: a traffic file's parameters → the
operations of a run, drawn from the seed.

A traffic file (``benchmark/traffic/<mix>.json``) names the operation
(``benchmark/ops/<operation>.py``) and gives each parameter's values:
``{"range": [lo, hi]}`` (whole numbers, both ends in) or ``{"values":
[...]}``.  The run sends every combination once in a shuffled order, then
all of them again in another order, and so on: every seed sends the same
set of operations, in its own order.  Warm-up draws from a stream of its
own, so that it leaves the window's order alone.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, List

import numpy as np


def domain(spec) -> List:
    if "range" in spec:
        lo, hi = spec["range"]
        return list(range(int(lo), int(hi) + 1))
    if "values" in spec:
        return list(spec["values"])
    raise ValueError(f"a parameter needs 'range' or 'values', got {spec!r}")


def combinations(traffic: dict) -> List[Dict]:
    params = traffic.get("params", {})
    names = sorted(params)
    return [dict(zip(names, vals)) for vals in itertools.product(*(domain(params[n]) for n in names))]


def stream(traffic: dict, seed: int, purpose: int = 0) -> Iterator[Dict]:
    """Endless operations' parameters: each combination once a cycle, in
    an order drawn from ``seed`` (``purpose`` picks an independent
    stream: 0 for the window, 1 for warm-up)."""
    combos = combinations(traffic)
    rng = np.random.default_rng([int(seed), 0x5EED, int(purpose)])
    while True:
        for i in rng.permutation(len(combos)):
            yield dict(combos[i])
