"""Device milliseconds a query spends aggregating (group codes and the
dense grouped sums of Q1, the product and its sum of ``filter_sum``):
the CUDA-event time of the program's ``strawboat.query.aggregate`` spans,
a mean over the traced stretch's queries."""

from benchmark.lib.program_spans import phase_device_ms


def read(ctx):
    return phase_device_ms(ctx, "aggregate")
