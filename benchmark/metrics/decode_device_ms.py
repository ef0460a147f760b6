"""Device milliseconds a query spends decoding its columns (kernel K1
and the planes combined into values): the CUDA-event time of the
program's ``strawboat.query.decode`` spans, a mean over the traced
stretch's queries."""

from benchmark.lib.program_spans import phase_device_ms


def read(ctx):
    return phase_device_ms(ctx, "decode")
