"""Device milliseconds a query spends in its keyed exchange on rank 0 (the
partial slots binned by destination, one all_to_all a payload over the
world): the CUDA-event time of the program's ``strawboat.query.exchange``
spans, a mean over the traced stretch's queries."""

from benchmark.lib.program_spans import phase_device_ms


def read(ctx):
    return phase_device_ms(ctx, "exchange")
