"""gnconv_roofline.dress: The GroupNorm family's share of its roofline over the
traced calls: the least time of the counted K2 and K3 launches, over all
their kernels' device time."""

from benchmark.lib import readers

LAYER = "kernels (K2/K4 GN+SiLU+conv3x3, K3 GroupNorm)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "dress_images_per_min"


def read(run):
    return readers.gnconv_roofline(run)
