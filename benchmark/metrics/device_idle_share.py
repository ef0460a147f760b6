"""Percent of the traced stretch of the loop in which the device ran
nothing: one less the union of its kernels, copies and memsets over the
span (the frozen copy of the port's ``trace_busy``)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.trace.idle_share
