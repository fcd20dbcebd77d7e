"""Model FLOPs of a pipeline call, counted by `FlopCounterMode` (2 per
multiply-add: every linear and convolution, the attention products at
their token counts) over the plain reference run on the meta device at the
call's shapes: the CFG batch, the garment UNet once a call, CLIP, the
Resampler, the VAE encode and decode, and the ControlNet where the
configuration has it. The reference leaves out the garment attention of
rows whose scale is 0, which the inputs make unnecessary. Whatever
implements the call, it is credited with this work."""

from __future__ import annotations

import functools
import json
from typing import Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import pipeline as ref


def _count(config: dict, shapes, batch: int, steps: int) -> float:
    weights = {m: {k: torch.empty(s, device="meta") for k, s in spec.items()}
               for m, spec in shapes.items()}
    h, w = config["height"], config["width"]
    clip = config["vision"]["image_size"]
    ids = np.zeros((batch, 77), np.int64)
    inputs = dict(prompt_ids=ids, negative_ids=ids,
                  ref_image=np.zeros((batch, h, w, 3), np.float32),
                  ref_clip_image=np.zeros((batch, clip, clip, 3), np.float32),
                  noise=torch.empty((batch, h // 8, w // 8, 4),
                                    device="meta"))
    if config.get("controlnet"):
        inputs["pose_image"] = np.zeros((batch, h, w, 3), np.float32)
    with FlopCounterMode(display=False) as counter:
        ref.generate(weights, config, steps=steps, **inputs)
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=16)
def _per_row(config_json: str, shapes_json: str) -> Dict[str, float]:
    config, shapes = json.loads(config_json), json.loads(shapes_json)
    one, two = (_count(config, shapes, 1, n) for n in (1, 2))
    return {"fixed": 2 * one - two, "step": two - one}


def call_flops(config: dict, shapes, batch: int, steps: int) -> float:
    """Model FLOPs of one call of `batch` rows and `steps` DDIM steps (every
    operation's work grows with the rows, so one row is counted)."""
    parts = _per_row(json.dumps(config, sort_keys=True),
                     json.dumps(shapes, sort_keys=True))
    return batch * (parts["fixed"] + steps * parts["step"])
