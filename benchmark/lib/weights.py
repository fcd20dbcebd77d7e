"""Random weights drawn on the device from the run's seed: one uniform draw
per model, in the dtype the cell serves, cut into the model's tensors and
scaled in place. The same seed on the same kind of device gives the same
tensors, so the reference can draw them again after the program's state is
freed.

The scales: a matrix or convolution weight uniform within +-1/sqrt(fan_in)
(PyTorch's default bound); token, position and class embeddings of
standard deviation 0.02; the Resampler's latents dim ** -0.5; norm scales
1 +- 0.1; biases +- 0.05."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Shapes = Dict[str, Dict[str, Tuple[int, ...]]]
EMBEDDINGS = ("token_embedding.weight", "position_embedding.weight",
              "class_embedding")


def init_range(key: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(centre, half width) of the uniform draw of one tensor."""
    if key.endswith(EMBEDDINGS):
        return 0.0, 0.02 * math.sqrt(3.0)
    if key == "latents":
        return 0.0, shape[-1] ** -0.5 * math.sqrt(3.0)
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if key.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.05


def draw(shapes: Shapes, seed: int, device, dtype: torch.dtype
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: state dict} of views into one buffer per model, drawn by
    `torch.Generator(device).manual_seed(seed)` model by model in the
    order of `shapes`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    with torch.no_grad():
        for model, spec in shapes.items():
            total = sum(math.prod(s) for s in spec.values())
            flat = torch.rand(total, generator=gen, device=device,
                              dtype=dtype)
            sd, pos = {}, 0
            for key, shape in spec.items():
                n = math.prod(shape)
                view = flat[pos:pos + n].view(shape)
                centre, half = init_range(key, shape)
                view.mul_(2.0 * half).add_(centre - half)
                sd[key] = view
                pos += n
            out[model] = sd
    return out


def count(shapes: Shapes) -> int:
    """Parameters in the stack."""
    return sum(math.prod(s) for spec in shapes.values() for s in spec.values())
