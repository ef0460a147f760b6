"""The keyed exchange's share of the link's peak on rank 0: the bytes it
sends to the other cards a query (the program's ``exchange.crossed_bytes``
inside ``strawboat.query.exchange``) over that span's device time
(``exchange_device_ms``), against NVLink's 450 GB/s a direction
(``benchmark/lib/link.py``).  The span also holds the binning and the
wait for the slowest rank, so this is a floor of the link's use."""

from benchmark.lib.link import NVLINK_BYTES_PER_S, exchange_counts
from benchmark.lib.program_spans import phase_device_ms


def read(ctx):
    sent = exchange_counts(ctx, "exchange.crossed_bytes")
    ms = phase_device_ms(ctx, "exchange")
    if not sent or not ms:
        return None
    return 100.0 * sent / (ms * 1e-3) / NVLINK_BYTES_PER_S
