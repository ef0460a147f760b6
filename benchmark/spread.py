#!/usr/bin/env python3
"""Spreads of a cell's two sets of runs, by which a bound is set.

    python3 benchmark/spread.py SET_A SET_B

Each file holds the result lines of one set's runs (the last line of
standard output of each, one a line; the same seeds in both sets).  For
each metric it prints both sets' medians and spreads (first to third
quartile over the median, ``statistics.quantiles``), the mean of the two
spreads with each set's run farthest from the median left out, the spread
of all the runs, and five times the wider set spread: the bound, before
its floor of 1% and its cap of 25%.
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.lib.stats import spread, spread_without_farthest  # noqa: E402


def _values(path):
    runs = [json.loads(line) for line in open(path) if line.strip()]
    out = {}
    for r in runs:
        for name, m in r["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return out


def main(argv=None) -> int:
    a_path, b_path = (argv if argv is not None else sys.argv[1:])
    a, b = _values(a_path), _values(b_path)
    for name in sorted(set(a) & set(b)):
        va, vb = a[name], b[name]
        sa, sb = spread(va), spread(vb)
        print(json.dumps({
            "metric": name, "medians": [statistics.median(va), statistics.median(vb)],
            "spreads": [sa, sb],
            "trimmed_mean": (spread_without_farthest(va) + spread_without_farthest(vb)) / 2,
            "all_runs": spread(va + vb), "five_times_wider": 5 * max(sa, sb)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
