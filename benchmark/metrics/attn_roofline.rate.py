"""attn_roofline.rate: K1's share of its roofline over the traced calls: the
least time of the launches the program counted, over the flash forward
kernels' device time."""

from benchmark.lib import readers

LAYER = "kernels (K1 flash forward)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "images_per_min"


def read(run):
    return readers.attn_roofline(run)
