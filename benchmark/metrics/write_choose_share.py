"""Percent of the writer's page time spent choosing codecs: the host
time of the ``strawboat.write.stats`` and ``.choose`` spans over that of
the ``.page`` spans, every pool thread, in the traced stretch's last
writes (read from the program's recorder: the profiler's ranges are per
thread and miss the pool's)."""

from benchmark.lib.program_spans import WRITE, last_roots

CHOOSING = (f"{WRITE}.stats", f"{WRITE}.choose")


def read(ctx):
    page = choosing = 0
    for r in last_roots(WRITE, ctx.stretch_ops):
        for s in r.walk():
            if s.name == f"{WRITE}.page":
                page += s.end_ns - s.start_ns
            elif s.name in CHOOSING:
                choosing += s.end_ns - s.start_ns
    if page <= 0:
        return None
    return 100.0 * choosing / page
