"""serve_queue_s.rate: Median seconds of the program's `serve.queue` span in
the traced window: from a request's put on the worker's queue to the start
of the round that takes it."""

from benchmark.lib import spans

LAYER = "apps.serve (handler, queue, PNG)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "images_per_min"


def read(run):
    return spans.median_seconds(run, "serve.queue")
