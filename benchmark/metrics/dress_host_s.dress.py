"""dress_host_s.dress: Median over the window's chunks of the chunk's wall less
its pipeline call's wall: PNG decode, preparation, collage encode and write."""

from benchmark.lib import readers

LAYER = "apps.dress (chunk loop)"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "dress_images_per_min"


def read(run):
    return readers.dress_host(run)
