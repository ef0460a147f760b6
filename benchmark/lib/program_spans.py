"""What the harness reads of the program's own recorder (the port's
``util/obs.py``): its last finished root spans and its counters.  A
program without that recorder gives nothing to read, and every reader
built on this returns None for it."""

from __future__ import annotations

import importlib
from typing import List, Optional

QUERY = "strawboat.query"
WRITE = "strawboat.write"


def recorder():
    """The program's ``util.obs`` module, or None where it has no
    recorder (no ``last_roots`` and ``counter``)."""
    try:
        obs = importlib.import_module("strawboat_tpu_torch.util.obs")
    except ImportError:
        return None
    if not (hasattr(obs, "last_roots") and hasattr(obs, "counter")):
        return None
    return obs


def last_roots(name: str, n: int) -> List:
    """The program's last ``n`` finished root spans named ``name``,
    oldest first (fewer where it kept fewer; none for ``n`` 0)."""
    obs = recorder()
    if obs is None or n <= 0:
        return []
    return list(obs.last_roots(n, name))


def phase_device_ms(ctx, phase: str) -> Optional[float]:
    """Milliseconds a query of the traced stretch spent, on the device's
    clock, between the CUDA events of its ``strawboat.query.<phase>``
    spans: the mean over the stretch's last ``ctx.stretch_ops`` query
    roots, None where a root has no such span with events."""
    roots = last_roots(QUERY, ctx.stretch_ops)
    if not roots:
        return None
    total = 0.0
    for r in roots:
        ms = [s.device_ms for s in r.walk() if s.name == f"{QUERY}.{phase}"]
        if not ms or any(m is None for m in ms):
            return None
        total += sum(ms)
    return total / len(roots)
