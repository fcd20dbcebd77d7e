"""device_idle.dress: 1 - the union of device activity intervals over the traced
window, in %."""

from benchmark.lib import readers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "dress_images_per_min"


def read(run):
    return readers.device_idle(run)
