"""Percent of the exchange's bin slots that carry a partial group: the
program's ``exchange.slots_valid`` (rank 0's valid partial slots) over
``exchange.slots_sent`` (the slots of every destination bin it sends),
over the traced stretch's queries.  What is left is the bins' padding."""

from benchmark.lib.link import root_counts


def read(ctx):
    sent = root_counts(ctx, "exchange.slots_sent")
    valid = root_counts(ctx, "exchange.slots_valid")
    if not sent or valid is None:
        return None
    return 100.0 * valid / sent
