"""Percent of the traced stretch in which the device sat idle while the
host was inside the program's query (its ``strawboat.query`` ranges in
the Chrome trace, on the profiler's clock): the part of
``device_idle_share`` the program's own host work causes; the rest falls
between queries, in the caller.  None where the trace has no such range
(a program without spans)."""


def _union(ranges):
    out = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    queries = _union((a, b) for a, b, name in tr.host if name == "strawboat.query")
    if not queries:
        return None
    idle = sum(max(0.0, min(gb, qb) - max(ga, qa)) for ga, gb in tr.gaps for qa, qb in queries)
    return 100.0 * idle / tr.window_s
