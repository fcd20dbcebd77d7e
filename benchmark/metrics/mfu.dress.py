"""mfu.dress: Model FLOPs of the window's calls (benchmark/lib/flops.py), each
by its share inside the window, over the window at 989 TFLOP/s."""

from benchmark.lib import readers

LAYER = "models (the whole call)"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "dress_images_per_min"


def read(run):
    return readers.mfu(run)
