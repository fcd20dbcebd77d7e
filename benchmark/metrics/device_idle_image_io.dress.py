"""device_idle_image_io.dress: The share of the traced window in which the
device is idle while a root image span of the program is open on the
host, in %."""

from benchmark.lib import spans

LAYER = "apps.image_utils"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "dress_images_per_min"


def read(run):
    return spans.device_idle_image_io(run)
