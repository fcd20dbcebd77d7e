"""denoise_enqueue_ms_per_step.dress: Median host duration of the program's
`denoise.step` span, the time to enqueue one CFG step, in the traced calls
at the full batch of 4."""

from benchmark.lib import spans

LAYER = "pipelines.dressing (denoise loop)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "dress_images_per_min"


def read(run):
    return spans.denoise_enqueue_ms_per_step(run, 4)
