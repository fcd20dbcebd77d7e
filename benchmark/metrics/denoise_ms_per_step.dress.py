"""denoise_ms_per_step.dress: The pipeline's own stage clock: the denoise stage
over its steps, median over the window's calls at the full batch of 4."""

from benchmark.lib import readers

LAYER = "pipelines.dressing"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "dress_images_per_min"


def read(run):
    return readers.denoise_ms_per_step(run, 4)
