"""images_per_min: Images the server answered in the window per minute:
every answered request counted by the share of its time, from when it was
due to when its answer was read, inside the window."""

from benchmark.lib import readers

LAYER = "end to end"
UNIT = "images/min"
SOURCE = "host_clock"
MOVES = None  # an end-to-end metric


def read(run):
    return readers.images_per_min(run)
