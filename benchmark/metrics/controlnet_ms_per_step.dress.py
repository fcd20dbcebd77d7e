"""controlnet_ms_per_step.dress: Median device time of a step's ControlNet
call (the `denoise.step` span's `controlnet_device_s`, from CUDA events) in
the traced calls at the full batch of 4; none without a card."""

from benchmark.lib import spans

LAYER = "models.controlnet"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "dress_images_per_min"


def read(run):
    return spans.controlnet_ms_per_step(run, 4)
