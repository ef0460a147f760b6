"""Arithmetic the benchmark shares: the manifest, the traffic generator,
the measured window, statistics, the trace reading and the rooflines."""
