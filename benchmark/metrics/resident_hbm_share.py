"""The resident query's share of the HBM peak: the packed plane bytes of
the columns each query reads, read once, times the queries of the traced
stretch, at the HBM peak, over the device's busy time in the stretch.
It counts the work and not the kernels, so it holds whichever kernels
decode the planes."""

from benchmark.lib.roofline import plane_bytes, share


def read(ctx):
    planes = ctx.facts.get("k1_planes_per_op")
    if ctx.trace is None or not planes or not ctx.stretch_ops:
        return None
    return share(plane_bytes(planes) * ctx.stretch_ops, ctx.trace.busy_s)
