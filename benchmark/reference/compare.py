"""The comparisons that decide ``correct``: each gives the numbers that
the harness prints beside their limits."""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np

from .tpch import Q1_NAMES

_AVGS = ("avg_qty", "avg_price", "avg_disc")


def q1_gaps(pairs: Iterable[Tuple[Mapping, Mapping]]) -> Dict[str, float]:
    """Over (got, want) Q1 answers ({(flag, status): {aggregate: value}}):
    ``groups_wrong``, the groups one side has and the other lacks;
    ``int_gap``, the widest gap of a sum or a count; ``avg_rel_gap``, the
    widest gap of an average over the reference's value."""
    groups_wrong, int_gap, avg_gap = 0, 0, 0.0
    for got, want in pairs:
        groups_wrong += len(set(got) ^ set(want))
        for key in set(got) & set(want):
            g, w = got[key], want[key]
            for name in Q1_NAMES:
                if name in _AVGS:
                    gap = abs(float(g[name]) - float(w[name])) / max(abs(float(w[name])), 1e-300)
                    avg_gap = max(avg_gap, gap if np.isfinite(gap) else float("inf"))
                else:
                    int_gap = max(int_gap, abs(int(g[name]) - int(w[name])))
    return {"groups_wrong": groups_wrong, "int_gap": int_gap, "avg_rel_gap": avg_gap}


def scalar_gap(pairs: Iterable[Tuple[int, int]]) -> int:
    """The widest gap between got and want integer answers."""
    return max((abs(int(g) - int(w)) for g, w in pairs), default=0)


def column_mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Values of ``want`` that ``got`` lacks or holds otherwise."""
    n = min(len(got), len(want))
    wrong = int(np.count_nonzero(np.asarray(got[:n]) != np.asarray(want[:n])))
    return wrong + abs(len(want) - len(got))


def text_mismatches(codes: np.ndarray, dictionary, offsets: np.ndarray,
                    values: np.ndarray) -> int:
    """Strings of ``want`` (int64 ``offsets`` from 0 into the uint8
    ``values``) that ``got`` (``codes`` into ``dictionary``, an array of
    ``bytes`` or ``str``) lacks or holds otherwise: each compared by its
    length and its bytes."""
    entries = list(dictionary)
    if entries and isinstance(entries[0], str):
        entries = [v.encode() for v in entries]
    dlen = np.fromiter(map(len, entries), dtype=np.int64, count=len(entries))
    lens = np.diff(offsets)
    n = len(lens)
    width = max(int(dlen.max(initial=0)), int(lens.max(initial=0)), 1)
    mat = np.zeros((n, width), dtype=np.uint8)
    rows = np.repeat(np.arange(n), lens)
    mat[rows, np.arange(len(rows)) - np.repeat(offsets[:-1], lens)] = values[: int(offsets[-1])]
    want = mat.view(f"S{width}").ravel()
    table = np.array(entries, dtype=f"S{width}") if entries else np.zeros(1, f"S{width}")
    codes = np.asarray(codes, dtype=np.int64)
    m = min(len(codes), n)
    if m and (int(codes[:m].min()) < 0 or int(codes[:m].max()) >= len(entries)):
        return n  # codes outside the dictionary: nothing reads back
    c = codes[:m]
    wrong = np.count_nonzero((table[c] != want[:m]) | (dlen[c] != lens[:m])) if m else 0
    return int(wrong) + abs(len(codes) - n)
