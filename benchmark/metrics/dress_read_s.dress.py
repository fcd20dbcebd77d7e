"""dress_read_s.dress: Median over the traced chunks of the seconds of the
program's root image spans (`image.prepare_garment`, `image.read`,
`image.resize`) between the chunk's start and its call's start."""

from benchmark.lib import spans

LAYER = "apps.image_utils (read, prepare)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "dress_images_per_min"


def read(run):
    return spans.dress_read(run)
