"""dress_write_s.dress: Median over the traced chunks of the seconds of the
program's root image spans (`image.resize`, `image.write`) between the
call's end and the chunk's end: the collages."""

from benchmark.lib import spans

LAYER = "apps.image_utils (collage, write)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "dress_images_per_min"


def read(run):
    return spans.dress_write(run)
