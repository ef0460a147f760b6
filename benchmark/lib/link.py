"""The link between the cards and the bytes a query sends over it.

NVIDIA's data sheet for the H100 SXM: 18 NVLink 4 links, 900 GB/s between
two cards in both directions together, so 450 GB/s each way.  A card's
keyed exchange sends and receives at once; the share below counts what
it sends, against one direction's peak.
"""

from __future__ import annotations

from typing import Optional

from benchmark.lib.program_spans import QUERY, last_roots

NVLINK_BYTES_PER_S = 450e9
EXCHANGE = f"{QUERY}.exchange"


def exchange_counts(ctx, counter: str) -> Optional[float]:
    """Counter ``counter`` of the program's recorder added inside the
    ``strawboat.query.exchange`` span and every span under it, a mean
    over the traced stretch's query roots; None where a root has no such
    span (a program without it)."""
    roots = last_roots(QUERY, ctx.stretch_ops)
    if not roots:
        return None
    total = 0
    for r in roots:
        spans = [s for s in r.walk() if s.name == EXCHANGE]
        if not spans:
            return None
        total += sum(sub.counts.get(counter, 0) for s in spans for sub in s.walk())
    return total / len(roots)


def root_counts(ctx, counter: str) -> Optional[float]:
    """Counter ``counter`` added anywhere inside the traced stretch's query
    roots, summed over them; None where no root added to it."""
    roots = last_roots(QUERY, ctx.stretch_ops)
    found = [sub.counts[counter] for r in roots for sub in r.walk() if counter in sub.counts]
    return float(sum(found)) if found else None
