"""setup_s: Seconds from the process's start to the window's first request:
imports, kernel builds or loads, the weights drawn and loaded, the cell's
shapes warmed, the server and clients started."""

LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"
MOVES = None  # an end-to-end metric


def read(run):
    return run.setup_s
