"""dress_images_per_min: Images the folder job wrote in the window per
minute: each chunk's images counted by the share of its time inside the
window."""

from benchmark.lib import readers

LAYER = "end to end"
UNIT = "images/min"
SOURCE = "host_clock"
MOVES = None  # an end-to-end metric


def read(run):
    return readers.images_per_min(run)
