"""serve_batch_mean.rate: Images per pipeline call over the window's calls, as
the benchmark's wrapper around the worker's pipe records them."""

from benchmark.lib import readers

LAYER = "apps.serve (InferenceWorker)"
UNIT = "images"
SOURCE = "program_span"
MOVES = "images_per_min"


def read(run):
    return readers.batch_mean(run)
