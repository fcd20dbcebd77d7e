"""serve_overhead_s.rate: Median over the window's answered requests of the
round trip less the pipeline call's wall that the response reports
(latency_s)."""

from benchmark.lib import readers

LAYER = "apps.serve (handler, queue, PNG)"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "images_per_min"


def read(run):
    return readers.serve_overhead(run)
