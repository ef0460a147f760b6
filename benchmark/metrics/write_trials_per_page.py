"""Trial compressions the codec chooser makes a page (its sampled
ratio competition; the analytic ratios are no trials): the program's
``write.trials`` counter over ``write.pages``, over the process (one
writer on one mix, so the window's ratio)."""

from benchmark.lib import program_spans


def read(ctx):
    obs = program_spans.recorder()
    if obs is None:
        return None
    pages = obs.counter("write.pages")
    return obs.counter("write.trials") / pages if pages else None
