"""serve_decode_s.rate: Median seconds of the program's `serve.decode` span in
the traced window: the handler's base64 and image decode and the
garment's preparation."""

from benchmark.lib import spans

LAYER = "apps.serve (handler, queue, PNG)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "images_per_min"


def read(run):
    return spans.median_seconds(run, "serve.decode")
