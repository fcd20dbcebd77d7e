"""png_native_share.dress: The share of the traced window's `image.read`
spans of PNG data (`decoder` "native" or "numpy") that unfiltered the rows
in C++ (`decoder` "native"), in %. A program whose reads carry no
`decoder`, or a window with no PNG read, reads nothing."""

from benchmark.lib import spans

LAYER = "apps.image_utils (read, prepare)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "dress_images_per_min"


def read(run):
    found = spans.traced(run)
    if found is None:
        return None
    used = [s["attrs"].get("decoder") for s in found[0]
            if s["name"] == "image.read"]
    png = [d for d in used if d in ("native", "numpy")]
    if not png:
        return None
    return 100.0 * png.count("native") / len(png)
