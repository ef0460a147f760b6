"""Kernel K1's share of its roofline: the bytes K1 must move for the
planes each query reads (``(bits + 32) * 4`` a lane: the packed words in,
32 int32 values out), times the queries of the traced stretch, at the
HBM peak, over the device time of K1's records in the trace."""

from benchmark.lib.roofline import k1_bytes, share

KERNEL = "bitunpack_tiled_many_kernel"


def read(ctx):
    planes = ctx.facts.get("k1_planes_per_op")
    if ctx.trace is None or not planes or not ctx.stretch_ops:
        return None
    seconds = ctx.trace.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    return share(k1_bytes(planes) * ctx.stretch_ops, seconds)
